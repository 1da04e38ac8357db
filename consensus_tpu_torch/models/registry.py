"""Engine registry: ``(curve, mode, topology, device_prep, mxu)`` ->
batch-engine builder (the port's counterpart of
``consensus_tpu/models/registry.py``).

Each engine the port can build is REGISTERED under an :class:`EngineKey`;
a lookup of any other key fails loudly with :class:`UnknownEngineError`.
For the cells the JAX registry refuses (the Ed25519-only lanes on P-256)
the message is the JAX package's own; for a lane the JAX package has and
the port does not have yet, it names the lane's ROADMAP.md queue A item.
The supervisor's degrade ladder is derived by walking registered keys
(:meth:`EngineRegistry.degrade_keys`), as in the JAX package.

The port registers Ed25519 strict and randomized, each with host prep and
with the fused device prep (``device_prep``), and P-256 strict with host
prep, on a single device and the CUDA-core field lane.  Whether an
engine runs on the card or the CPU is the ``device`` argument, not a key
axis: the plain torch versions serve the CPU and the tests, never a card's
fallback.
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

#: The two verification modes an engine key can select.
MODES = ("strict", "randomized")
#: The two launch topologies: one device, or a device mesh (any shape).
TOPOLOGIES = ("single", "mesh")

#: The lanes of the JAX registry the port does not have yet, by key axis:
#: (what, ROADMAP.md queue A item).
_NOT_PORTED = {
    "mesh": ("a mesh topology (the sharded engines)", "item 12: multi-GPU"),
    "mxu": ("the MXU field lane (CTPU_MXU_LIMBS=1)", "item 13: tensor-core field lane"),
}


class UnknownEngineError(ValueError):
    """No engine is registered under the requested key (the message names
    the reason: unknown curve, Ed25519-only lane, a lane not ported yet, or
    plain unregistered)."""


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
    (``pad_pow2``, ``min_device_batch``) and the ``device``.
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
        # Lanes the JAX package has and the port does not yet.
        missing = [
            _NOT_PORTED[axis]
            for axis, on in (
                ("mesh", key.topology == "mesh"),
                ("mxu", key.mxu),
            )
            if on
        ]
        if missing:
            return "; ".join(
                f"consensus_tpu_torch: {what} is not ported yet "
                f"(ROADMAP.md queue A, {item})"
                for what, item in missing
            )
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


def _ed25519_single(*, randomized: bool, fused: bool, **kw):
    # Every Ed25519 path decompresses (D1) and runs the comb (D2).
    ed_kernels = ("decompress25519", "comb25519")
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


def _default_registry() -> EngineRegistry:
    from functools import partial

    reg = EngineRegistry()
    for mode in MODES:
        for fused in (False, True):
            reg.register(
                EngineKey("ed25519", mode, "single", fused, False),
                partial(_ed25519_single, randomized=mode == "randomized", fused=fused),
            )
    reg.register(EngineKey("p256", "strict", "single", False, False), _p256_single)
    return reg


#: The process-wide registry ``engine_for_config`` routes through.
#: Embedders may ``register`` additional curves/lanes at startup.
ENGINE_REGISTRY = _default_registry()


def _shard_count(config) -> int:
    """Devices the config's topology spans: the product of
    ``mesh_topology`` when set, else ``mesh_shards`` (the JAX package's
    ``topology_for_config(config).shard_count``)."""
    axes = tuple(int(a) for a in (getattr(config, "mesh_topology", ()) or ()))
    if axes:
        if any(a < 1 for a in axes):
            raise ValueError(
                f"topology axes must be a non-empty tuple of positive device "
                f"counts, got {axes!r}"
            )
        count = 1
        for a in axes:
            count *= a
        return count
    shards = int(getattr(config, "mesh_shards", 1) or 1)
    if shards < 1:
        raise ValueError(f"mesh_shards must be >= 1, got {shards}")
    return shards


def engine_key_for(config, curve: str = "ed25519") -> EngineKey:
    """The registry key a ``Configuration``'s crypto knobs select."""
    return EngineKey(
        curve=curve,
        mode=(
            "randomized"
            if bool(getattr(config, "batch_verify_mode", False))
            else "strict"
        ),
        topology="mesh" if _shard_count(config) > 1 else "single",
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
