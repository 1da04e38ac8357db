"""Engine registry: ``(curve, mode, topology, device_prep, mxu)`` ->
batch-engine builder (the port's counterpart of
``consensus_tpu/models/registry.py``).

Each engine the port can build is REGISTERED under an :class:`EngineKey`;
a lookup of any other key fails loudly with :class:`UnknownEngineError`,
in the JAX package's words (the Ed25519-only lanes on P-256, the
tensor-core lane on P-256).  The supervisor's degrade ladder is derived by
walking registered keys (:meth:`EngineRegistry.degrade_keys`), as in the
JAX package.

The port registers what the JAX package registers: Ed25519 strict and
randomized, each with host prep and with the fused device prep
(``device_prep``), on the VPU lane and on the tensor-core lane (``mxu``,
``CTPU_MXU_LIMBS=1``), and P-256 strict with host prep on the VPU lane, on
a single device and on a device mesh (the sharded engines of
:mod:`consensus_tpu_torch.parallel.sharding`).  An ``mxu`` builder refuses
to build unless the environment selects the lane, as the JAX package's
does.  Whether an engine runs on the card or the CPU is the ``device``
argument, not a key axis: the plain torch versions serve the CPU and the
tests, never a card's fallback.  A mesh builder takes the config's
``topology`` as well and builds it over the visible devices of ``device``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Callable

from consensus_tpu_torch.models.ecdsa_p256 import EcdsaP256BatchVerifier
from consensus_tpu_torch.models.ed25519 import (
    Ed25519BatchVerifier,
    Ed25519RandomizedBatchVerifier,
)
from consensus_tpu_torch.models.fused import (
    FusedEd25519BatchVerifier,
    FusedEd25519RandomizedBatchVerifier,
)
from consensus_tpu_torch.ops import scan_kernels
from consensus_tpu_torch.parallel.topology import topology_for_config

#: The two verification modes an engine key can select.
MODES = ("strict", "randomized")
#: The two launch topologies: one device, or a device mesh (any shape).
TOPOLOGIES = ("single", "mesh")

class UnknownEngineError(ValueError):
    """No engine is registered under the requested key (the message names
    the reason: unknown curve, an Ed25519-only lane, or plain
    unregistered)."""


@dataclass(frozen=True)
class EngineKey:
    """One cell of the engine matrix (the JAX key's five axes).

    ``topology`` is the coarse launch class (``"single"`` vs ``"mesh"``);
    ``mxu`` mirrors the ``CTPU_MXU_LIMBS`` environment, as in the JAX
    package, so the registry can refuse the cells the lane does not cover
    instead of silently running another lane.
    """

    curve: str = "ed25519"
    mode: str = "strict"
    topology: str = "single"
    device_prep: bool = False
    mxu: bool = False

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.topology not in TOPOLOGIES:
            raise ValueError(
                f"topology must be one of {TOPOLOGIES}, got {self.topology!r}"
            )


class EngineRegistry:
    """Pluggable ``EngineKey`` -> builder map with loud lookup failures.

    A builder is ``fn(**kw) -> engine``; ``kw`` carries the padding knobs
    (``pad_pow2``, ``min_device_batch``) and the ``device``, and for a mesh
    key the ``topology`` (a ``MeshTopology``, a ``DeviceMesh`` or a device
    list; ``None`` builds a 1-D mesh over the visible devices).
    """

    def __init__(self) -> None:
        self._builders: dict[EngineKey, Callable] = {}

    def register(self, key: EngineKey, builder: Callable) -> None:
        if key in self._builders:
            raise ValueError(f"engine already registered under {key}")
        self._builders[key] = builder

    def __contains__(self, key: EngineKey) -> bool:
        return key in self._builders

    def keys(self) -> tuple:
        """Every registered key (stable registration order)."""
        return tuple(self._builders)

    def curves(self) -> tuple:
        seen = []
        for key in self._builders:
            if key.curve not in seen:
                seen.append(key.curve)
        return tuple(seen)

    def builder(self, key: EngineKey) -> Callable:
        b = self._builders.get(key)
        if b is None:
            raise UnknownEngineError(self._missing_reason(key))
        return b

    def _missing_reason(self, key: EngineKey) -> str:
        # The JAX registry's refusals first, in its order and its words.
        if key.curve not in self.curves():
            return f"unknown curve {key.curve!r}"
        if key.mxu and key.curve != "ed25519":
            return (
                "CTPU_MXU_LIMBS engines are Ed25519-only: P-256 has no MXU "
                "Straus/MSM kernel yet, and building a P-256 engine under "
                "an MXU key would silently run a half-MXU lane the A/B "
                "never measured — unset CTPU_MXU_LIMBS for P-256 engines"
            )
        if key.curve == "p256" and key.mode == "randomized":
            return "batch_verify_mode is Ed25519-only (no randomized P-256 lane)"
        if key.curve == "p256" and key.device_prep:
            return "device_prep is Ed25519-only (no fused P-256 front-end)"
        return (
            f"no engine registered under {key} "
            f"(registered: {', '.join(str(k) for k in self.keys())})"
        )

    def build(self, key: EngineKey, **kw):
        return self.builder(key)(**kw)

    def degrade_keys(self, key: EngineKey) -> list:
        """The best-first key ladder supervision degrades down from ``key``:
        mesh -> single device, then fused -> host prep, pruned to keys that
        are actually registered.  (The host twin is not a key -- the
        supervisor appends it as the ladder's floor itself.)"""
        ladder = [key]
        cur = key
        if cur.topology == "mesh":
            cur = replace(cur, topology="single")
            ladder.append(cur)
        if cur.device_prep:
            cur = replace(cur, device_prep=False)
            ladder.append(cur)
        return [ladder[0]] + [k for k in ladder[1:] if k in self]


# --- the port's matrix --------------------------------------------------------


def _with_kernels(engine, *names: str):
    """Build and load the libraries of the kernels ``engine`` launches when
    it runs on the card (and put D2's comb table there), so its first launch
    never waits on nvcc (a
    coalescer's flusher thread would otherwise spend its ``wait_timeout``
    on the build)."""
    if engine.device.type == "cuda":
        for name in names:
            scan_kernels.build(name)
        if "comb25519" in names:
            scan_kernels.comb_niels_table(engine.device)
    return engine


def _require_mxu_lane() -> None:
    """A builder registered under an ``mxu=True`` key promises an engine
    whose field products take the tensor-core lane, which the process takes
    only when the environment selects it: building it without
    ``CTPU_MXU_LIMBS=1`` would hand back a VPU engine under an MXU label.
    The JAX package's refusal, in its words."""
    if os.environ.get("CTPU_MXU_LIMBS", "") != "1":
        raise RuntimeError(
            "EngineKey.mxu=True but CTPU_MXU_LIMBS is not '1': the MXU "
            "lane is selected by the environment at trace time, so this "
            "build would trace the VPU lane under an MXU key — set "
            "CTPU_MXU_LIMBS=1 in the process environment first"
        )


def _ed25519_single(*, randomized: bool, fused: bool, mxu: bool = False, **kw):
    if mxu:
        _require_mxu_lane()
    # Every Ed25519 path decompresses (D1) and runs the comb (D2); the
    # tensor-core lane's products are M1.
    ed_kernels = ("decompress25519", "comb25519") + (("mxu_limbs",) if mxu else ())
    if fused:
        # The fused engines hash on the card (S1); the randomized one's
        # subsets below the randomized floor take the fused strict path.
        if randomized:
            return _with_kernels(
                FusedEd25519RandomizedBatchVerifier(**kw), "sha512", "straus_msm",
                "horner_scan", *ed_kernels,
            )
        return _with_kernels(FusedEd25519BatchVerifier(**kw), "sha512", "horner_scan", *ed_kernels)
    if randomized:
        # Subsets below the randomized floor take the strict device path.
        return _with_kernels(
            Ed25519RandomizedBatchVerifier(**kw), "straus_msm", "horner_scan", *ed_kernels
        )
    return _with_kernels(Ed25519BatchVerifier(**kw), "horner_scan", *ed_kernels)


def _p256_single(**kw):
    return _with_kernels(EcdsaP256BatchVerifier(**kw), "horner_scan_p256")


#: The kernels each Ed25519 mesh engine launches in its shards (and, for
#: the randomized ones, on its strict floor), by (randomized, fused).
_MESH_KERNELS = {
    (False, False): ("horner_scan", "decompress25519", "comb25519"),
    (True, False): ("straus_msm", "horner_scan", "decompress25519", "comb25519"),
    (False, True): ("sha512", "horner_scan", "decompress25519", "comb25519"),
    (True, True): ("sha512", "straus_msm", "horner_scan", "decompress25519", "comb25519"),
}


def _ed25519_mesh(*, randomized: bool, fused: bool, mxu: bool = False, topology=None, **kw):
    if mxu:
        _require_mxu_lane()
    from consensus_tpu_torch.parallel import sharding

    cls = {
        (False, False): sharding.ShardedEd25519Verifier,
        (True, False): sharding.ShardedEd25519RandomizedVerifier,
        (False, True): sharding.ShardedFusedEd25519Verifier,
        (True, True): sharding.ShardedFusedEd25519RandomizedVerifier,
    }[(randomized, fused)]
    lane = ("mxu_limbs",) if mxu else ()
    return _with_kernels(cls(topology, **kw), *_MESH_KERNELS[(randomized, fused)], *lane)


def _p256_mesh(*, topology=None, **kw):
    from consensus_tpu_torch.parallel.sharding import ShardedEcdsaP256Verifier

    return _with_kernels(ShardedEcdsaP256Verifier(topology, **kw), "horner_scan_p256")


def _default_registry() -> EngineRegistry:
    from functools import partial

    reg = EngineRegistry()
    for mode in MODES:
        for fused in (False, True):
            for mxu in (False, True):
                randomized = mode == "randomized"
                reg.register(
                    EngineKey("ed25519", mode, "single", fused, mxu),
                    partial(_ed25519_single, randomized=randomized, fused=fused, mxu=mxu),
                )
                reg.register(
                    EngineKey("ed25519", mode, "mesh", fused, mxu),
                    partial(_ed25519_mesh, randomized=randomized, fused=fused, mxu=mxu),
                )
    # p256 x mxu stays unregistered, as in the JAX package;
    # _missing_reason names the refusal.
    reg.register(EngineKey("p256", "strict", "single", False, False), _p256_single)
    reg.register(EngineKey("p256", "strict", "mesh", False, False), _p256_mesh)
    return reg


#: The process-wide registry ``engine_for_config`` routes through.
#: Embedders may ``register`` additional curves/lanes at startup.
ENGINE_REGISTRY = _default_registry()


def engine_key_for(config, curve: str = "ed25519") -> EngineKey:
    """The registry key a ``Configuration``'s crypto knobs select."""
    return EngineKey(
        curve=curve,
        mode=(
            "randomized"
            if bool(getattr(config, "batch_verify_mode", False))
            else "strict"
        ),
        topology="mesh" if topology_for_config(config).shard_count > 1 else "single",
        device_prep=bool(getattr(config, "device_prep", False)),
        # Env-derived on purpose (no config attr), as in the JAX package.
        mxu=os.environ.get("CTPU_MXU_LIMBS", "") == "1",
    )


__all__ = [
    "ENGINE_REGISTRY",
    "EngineKey",
    "EngineRegistry",
    "MODES",
    "TOPOLOGIES",
    "UnknownEngineError",
    "engine_key_for",
]
