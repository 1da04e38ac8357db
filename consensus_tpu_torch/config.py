"""Replica configuration, crypto-engine part (torch port of the fields of
``consensus_tpu/config.py`` that the engine layer reads: ``engine_for_config``
and the coalescer's window).

Same names, same defaults and the same ``validate()`` checks as the JAX
``Configuration``; the protocol, pool, timeout and tracing fields come with
the protocol core in a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class Configuration:
    # Minimum number of pending verifications before the engine takes the
    # device path instead of the host path, and the micro-batch coalescing
    # window.
    crypto_tpu_min_batch: int = 16
    crypto_batch_window: float = 0.002
    # Pad verification batches up to the next power of two (a handful of
    # stable shapes across batch sizes).
    crypto_pad_pow2: bool = True
    # Randomized batch verification (one aggregate check per batch).  All
    # replicas in a cluster must agree on it.  Ed25519 only: the engine is
    # Ed25519RandomizedBatchVerifier (models/ed25519.py).
    batch_verify_mode: bool = False
    # Whole-pipeline-on-device verification (host prep moved into the
    # launch).  Changes only where work runs.  Not ported yet: the registry
    # refuses it (ROADMAP.md queue A, item 10).
    device_prep: bool = False
    # Device-mesh width and layout for the batch engine.  1 and () keep the
    # single-device engine; wider meshes are not ported yet (item 12).
    mesh_shards: int = 1
    mesh_topology: tuple = ()
    # Fault-classed supervision of the engine with a degrade ladder to the
    # host (models/supervisor.py), plus a sampled host cross-check every
    # k-th launch (0 = off).
    engine_supervision: bool = False
    engine_crosscheck_interval: int = 0

    def validate(self) -> None:
        """Cross-field checks of the crypto fields (the JAX package's
        checks, same messages)."""
        errs = []
        if self.mesh_shards < 1:
            errs.append("mesh_shards must be >= 1")
        if self.mesh_topology:
            if any(int(a) < 1 for a in self.mesh_topology):
                errs.append("mesh_topology axes must all be >= 1")
            else:
                product = 1
                for a in self.mesh_topology:
                    product *= int(a)
                if self.mesh_shards != 1 and product != self.mesh_shards:
                    errs.append(
                        "mesh_topology axes product must equal mesh_shards "
                        "when both are set"
                    )
        if self.engine_crosscheck_interval < 0:
            errs.append("engine_crosscheck_interval must be >= 0")
        if self.engine_crosscheck_interval and not self.engine_supervision:
            errs.append(
                "engine_crosscheck_interval requires engine_supervision"
            )
        if self.crypto_tpu_min_batch < 1:
            errs.append("crypto_tpu_min_batch must be >= 1")
        if errs:
            raise ValueError("invalid configuration: " + "; ".join(errs))

    def with_(self, **kw) -> "Configuration":
        return replace(self, **kw)


__all__ = ["Configuration"]
