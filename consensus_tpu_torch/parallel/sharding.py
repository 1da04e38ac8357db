"""Multi-device sharding of the crypto batch path (torch port of
``consensus_tpu/parallel/sharding.py``).

The verification workload is pure data parallelism: every signature's
double-scalar multiplication is independent, so a mesh splits the batch
axis into ``shard_count`` contiguous slices, in row-major order over the
topology's axes (the order the JAX package's ``_reduce_axes`` and
``all_gather`` use), and reduces once at the edge.

The JAX package runs each body under ``shard_map``: one compiled program on
every device, ``psum`` and ``all_gather`` as collectives.  The port has one
process and no such runtime, so each engine here

1. copies every shard's slice to its shard's device (all copies first: a
   copy from pageable memory waits for the work queued before it),
2. issues every shard's body on its device -- the single-device engine's
   own body, so the hand-written kernels (B1, B2, B3, S1, D1, D2) launch
   once per shard -- before any host sync,
3. reduces once: ``psum`` becomes one sum of the per-shard counts on the
   first shard's device, ``all_gather`` (the fused randomized transcript's
   leaf table) a ``torch.cat`` of the shards' leaf digests in global lane
   order, copied to each shard's device; the verdicts (and the sum) come
   back in one read.

A mesh may repeat a device: ``[cuda:0] * 2`` is two virtual shards on one
card (ROADMAP.md, divergence 21).  The JAX package never runs a Pallas
kernel inside a shard (``suppress_pallas_scan``); the port launches its
kernels in every shard, since on a CUDA tensor a kernel always runs
(divergence 11).  Verdicts are identical.

Body construction rides an in-process ``(kernel, mesh[, shape])`` -> body
memo (:func:`compiled_kernel`), booked in
:data:`~consensus_tpu_torch.obs.kernels.COMPILE_CACHE`: rebuilding an engine
over the same mesh reuses the body and builds no kernel library again (the
libraries are loaded once per process).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
from torch.profiler import record_function

from consensus_tpu_torch.device import DeviceLike
from consensus_tpu_torch.models.ecdsa_p256 import EcdsaP256BatchVerifier
from consensus_tpu_torch.models.ecdsa_p256 import verify_impl as p256_verify_impl
from consensus_tpu_torch.models.ed25519 import (
    _Z_TAG,
    L,
    Ed25519BatchVerifier,
    Ed25519RandomizedBatchVerifier,
    batch_verify_impl,
    verify_impl,
)
from consensus_tpu_torch.models.fused import (
    FusedEd25519BatchVerifier,
    FusedEd25519RandomizedBatchVerifier,
    _byte_rows,
    _to_device,
    aggregate_layout,
    aggregate_leaves,
    aggregate_verdict,
    fused_verify_impl,
    transcript_coefficients,
)
from consensus_tpu_torch.obs.kernels import COMPILE_CACHE, KERNELS, kernel_lane_suffix
from consensus_tpu_torch.parallel.mesh import DeviceMesh
from consensus_tpu_torch.parallel.topology import (
    BATCH_AXIS,
    MeshTopology,
    engine_padded_size,
    mesh_padded_size,
)

#: What a sharded engine takes as its mesh: a built mesh, a topology (built
#: over the visible devices), a list of devices (a 1-D mesh), or None (a 1-D
#: mesh over the visible devices).
MeshLike = Union[DeviceMesh, MeshTopology, Sequence, None]


# --- in-process compiled-kernel memo ----------------------------------------

_COMPILED_KERNELS: dict = {}


def compiled_kernel(
    name: str, mesh: DeviceMesh, builder: Callable[[], Callable], *, extra: tuple = ()
) -> Callable:
    """The in-process ``(kernel, mesh[, shape])`` -> sharded-body memo.

    Two engines over the same mesh run the same body, so it is shared: a
    first build books a miss in
    :data:`~consensus_tpu_torch.obs.kernels.COMPILE_CACHE`, a rebuilt engine
    a hit.  The kernel ledger's ``compiles`` count nvcc builds only, so a
    body books none.  ``extra`` extends the key for shape-specialized bodies
    (the fused aggregate's ``(tag, n, padded)``)."""
    key = (name, mesh.key(), extra)
    fn = _COMPILED_KERNELS.get(key)
    COMPILE_CACHE.record(hit=fn is not None)
    if fn is None:
        fn = _COMPILED_KERNELS[key] = builder()
    return fn


def clear_compiled_kernels() -> None:
    """Drop every memoized body (tests; never needed in production)."""
    _COMPILED_KERNELS.clear()


def make_mesh(devices: Optional[Sequence] = None, *, device: DeviceLike = None) -> DeviceMesh:
    """A 1-D mesh over ``devices`` (default: the visible devices of
    ``device``, every card for ``cuda``)."""
    from consensus_tpu_torch.parallel.mesh import mesh_devices

    devices = mesh_devices(devices, device)
    return DeviceMesh(devices, (len(devices),), (BATCH_AXIS,))


def mesh_for_shards(
    n_shards: int, devices: Optional[Sequence] = None, *, device: DeviceLike = None
) -> DeviceMesh:
    """A 1-D mesh over the first ``n_shards`` devices -- the
    ``Configuration.mesh_shards`` -> engine seam, the 1-D case of
    :meth:`MeshTopology.build_mesh`.  Raises when fewer devices are
    visible than asked for: it never shrinks the mesh."""
    if n_shards < 1:
        raise ValueError(f"mesh_shards must be >= 1, got {n_shards}")
    return MeshTopology((n_shards,)).build_mesh(devices, device=device)


# --- the shard plumbing ------------------------------------------------------


def _shards(mesh: DeviceMesh, arrays: Sequence[np.ndarray]) -> list[tuple[torch.Tensor, ...]]:
    """Every shard's contiguous slice of the trailing batch axis of each of
    ``arrays`` (host arrays whose trailing axis is a multiple of the mesh
    size: the padded lanes, or one column per shard), copied to its shard's
    device -- all copies before any shard's work."""
    devices = mesh.shard_devices()
    n = len(devices)
    if any(a.shape[-1] % n for a in arrays):
        raise ValueError("padded batch must be a multiple of the mesh size")
    pers = [a.shape[-1] // n for a in arrays]
    return [
        _to_device([a[..., s * per:(s + 1) * per] for a, per in zip(arrays, pers)], dev)
        for s, dev in enumerate(devices)
    ]


def _psum(counts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """One int32 sum of per-shard counts, on ``device``."""
    return torch.stack([c.to(device=device, dtype=torch.int32) for c in counts]).sum()


def _gather(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The shards' per-lane outputs in global lane order, on ``device``."""
    return torch.cat([p.to(device) for p in parts], dim=-1)


def _read_back(lanes: torch.Tensor, scalar: torch.Tensor) -> tuple[np.ndarray, int]:
    """One read of a per-lane vector and a scalar from the device."""
    out = torch.cat([lanes.to(torch.int32), scalar.reshape(1).to(torch.int32)]).cpu().numpy()
    return out[:-1], int(out[-1])


def _verdict_body(mesh: DeviceMesh, name: str, impl: Callable) -> Callable:
    """A strict body over ``mesh``: ``run(*layout)`` books one call of
    ``name`` (+ the lane suffix), runs ``impl`` on every shard's slice of the padded host arrays
    and returns the verdicts in global lane order, read back once."""
    dev0 = mesh.shard_devices()[0]

    def run(*arrays):
        KERNELS.record_launch(name + kernel_lane_suffix())
        oks = [impl(*shard) for shard in _shards(mesh, arrays)]
        return _gather(oks, dev0).cpu().numpy()

    return run


class _MeshEngine:
    """Shared mesh plumbing for the sharded engines: the mesh, the memoized
    body, and the wave-sizing surface the coalescers read.

    ``mesh`` is a :data:`MeshLike` (a topology or ``None`` is built over the
    visible devices of ``device``); the engine's own ``device`` (the
    reduction's, and the randomized engines' strict floor's) is the first
    shard's."""

    @staticmethod
    def _mesh_and_device(mesh: MeshLike, device: DeviceLike) -> tuple[DeviceMesh, torch.device]:
        if isinstance(mesh, MeshTopology):
            mesh = mesh.build_mesh(device=device)
        elif not isinstance(mesh, DeviceMesh):
            mesh = make_mesh(mesh, device=device)  # None: the visible devices
        elif device is not None and torch.device(device).type != mesh.device_type:
            raise ValueError(f"device {device} disagrees with the mesh's {mesh.device_type} devices")
        return mesh, mesh.shard_devices()[0]

    def _init_mesh(self, mesh: DeviceMesh, kernel_name: str,
                   builder: Callable[[DeviceMesh], Callable]) -> None:
        self.mesh = mesh
        self._fn = compiled_kernel(kernel_name, mesh, lambda: builder(mesh))
        self._n_shards = mesh.size

    @property
    def shard_count(self) -> int:
        """Devices (shards) this engine spreads a batch across.  The
        supervisor's ladder labels mesh rungs with it."""
        return self._n_shards

    @property
    def preferred_wave_size(self) -> int:
        """The smallest padded wave that saturates the whole topology --
        every shard receives at least ``min_device_batch`` lanes, rounded
        through the engine's padding knobs.  The wave formers
        (models/engine.py) flush early once this many signatures are
        aboard."""
        return engine_padded_size(
            self._n_shards * max(1, self._min_device_batch),
            self._n_shards,
            pad_to=self._pad_to,
            pad_pow2=self._pad_pow2,
        )

    def padded_size(self, n: int) -> int:
        """The device batch a wave of ``n`` signatures is padded to: the
        engine's padding knobs, rounded up to a multiple of the mesh size so
        every shard gets an equal slice."""
        return engine_padded_size(n, self._n_shards, pad_to=self._pad_to, pad_pow2=self._pad_pow2)


class _ShardedWave(_MeshEngine):
    """The strict sharded engines' ``verify_batch``: the single engine's
    checks and host path, then its :meth:`host_layout` (padded to the
    mesh-aligned :meth:`padded_size`) through the sharded body."""

    def verify_batch(self, messages, signatures, public_keys) -> np.ndarray:
        n = len(messages)
        if not (n == len(signatures) == len(public_keys)):
            raise ValueError("batch length mismatch")
        if n == 0:
            return np.zeros(0, dtype=bool)
        if n < self._min_device_batch:
            return self._verify_host(messages, signatures, public_keys)
        return self._fn(*self.host_layout(messages, signatures, public_keys))[:n]


# --- strict Ed25519 -----------------------------------------------------------


def sharded_verify_fn(mesh: DeviceMesh) -> Callable:
    """The strict verify over ``mesh``: each shard runs ``verify_impl`` (D1,
    B1, D2) on its slice of ``to_kernel_layout``'s seven arrays."""
    return _verdict_body(mesh, "ed25519.sharded_verify", verify_impl)


class ShardedEd25519Verifier(_ShardedWave, Ed25519BatchVerifier):
    """Batch verifier that spreads the batch across a device mesh."""

    def __init__(self, mesh: MeshLike = None, *, device: DeviceLike = None, **kw) -> None:
        mesh, device = self._mesh_and_device(mesh, device)
        super().__init__(device=device, **kw)
        self._init_mesh(mesh, "ed25519.sharded_verify", sharded_verify_fn)


# --- ECDSA-P256 -----------------------------------------------------------------


def sharded_p256_verify_fn(mesh: DeviceMesh) -> Callable:
    """The ECDSA-P256 verify over ``mesh``: each shard runs the P-256
    ``verify_impl`` (B2) on its slice."""
    return _verdict_body(mesh, "ecdsa_p256.sharded_verify", p256_verify_impl)


class ShardedEcdsaP256Verifier(_ShardedWave, EcdsaP256BatchVerifier):
    """ECDSA-P256 batch verifier spread across a device mesh (the base
    class's preparation and validation; only the launch differs)."""

    def __init__(self, mesh: MeshLike = None, *, device: DeviceLike = None, **kw) -> None:
        mesh, device = self._mesh_and_device(mesh, device)
        super().__init__(device=device, **kw)
        self._init_mesh(mesh, "ecdsa_p256.sharded_verify", sharded_p256_verify_fn)


# --- randomized Ed25519 -------------------------------------------------------


def sharded_batch_verify_fn(mesh: DeviceMesh) -> Callable:
    """The randomized-aggregate check over ``mesh``.

    Point addition is not componentwise, so the shards' accumulators are
    not summed as coordinates: every shard checks an independent aggregate
    over its own lanes with its own base scalar ``u_s`` (one (32, 1) comb
    column per shard), and one sum of the shards' not-identity counts is
    the verdict.  A padding-only shard has ``u_s = 0`` and every digit
    masked to 8, so its accumulator is the identity and it votes ok.
    ``run`` returns ``(eq_ok, valid)``."""
    dev0 = mesh.shard_devices()[0]

    def run(*arrays):
        KERNELS.record_launch("ed25519.sharded_batch_verify" + kernel_lane_suffix())
        results = [batch_verify_impl(*shard) for shard in _shards(mesh, arrays)]
        bad = _psum([~eq for eq, _ in results], dev0)
        valid, bad = _read_back(_gather([v for _, v in results], dev0), bad)
        return bad == 0, valid.astype(bool)

    return run


class ShardedEd25519RandomizedVerifier(_MeshEngine, Ed25519RandomizedBatchVerifier):
    """Randomized batch verifier whose aggregate check rides the mesh.

    Only the device aggregate changes: the bisection driver, the transcript
    coefficients, the host fallback and the strict floor are inherited, so
    verdicts are exactly the single-device engine's."""

    def __init__(self, mesh: MeshLike = None, *, device: DeviceLike = None, **kw) -> None:
        mesh, device = self._mesh_and_device(mesh, device)
        super().__init__(device=device, **kw)
        self._init_mesh(mesh, "ed25519.sharded_batch_verify", sharded_batch_verify_fn)

    def _base_scalars(self, idx, scalars, zs, padded, u) -> list[int]:
        """One base scalar per shard (one comb column each): lane j lives on
        shard j // per, so u_s sums z s over exactly that shard's live lanes;
        a padding-only shard gets u_s = 0 (the comb's identity)."""
        per = padded // self._n_shards
        return [
            sum(z * scalars[i][0] for z, i in zip(zs[s * per:(s + 1) * per],
                                                  idx[s * per:(s + 1) * per])) % L
            for s in range(self._n_shards)
        ]

    def _aggregate_device(self, idx, signatures, public_keys, scalars, zs):
        eq_ok, valid = self._fn(*self._aggregate_layout(idx, signatures, public_keys, scalars, zs))
        return bool(eq_ok), valid[:len(idx)].tolist()


# --- fused bytes-in -> verdict-out engines ----------------------------------------


def sharded_fused_verify_fn(mesh: DeviceMesh) -> Callable:
    """The fused strict verify over ``mesh``: every shard runs the whole
    front end (S1, the mod-L reduction, the canonical checks, the digit
    recoding) and the strict body (D1, B1, D2) on its slice; the only
    reduction is the valid count."""
    return _verdict_body(mesh, "ed25519.sharded_fused_verify", fused_verify_impl)


class ShardedFusedEd25519Verifier(_ShardedWave, FusedEd25519BatchVerifier):
    """Fused strict verifier that spreads the batch across a device mesh
    (``Configuration.device_prep`` with a multi-device topology); verdicts
    are those of every other strict engine."""

    def __init__(self, mesh: MeshLike = None, *, device: DeviceLike = None, **kw) -> None:
        mesh, device = self._mesh_and_device(mesh, device)
        super().__init__(device=device, **kw)
        self._init_mesh(mesh, "ed25519.sharded_fused_verify", sharded_fused_verify_fn)


def sharded_transcript(
    mesh: DeviceMesh, tag: bytes, n: int, padded: int, leaves: Sequence[torch.Tensor],
) -> list[torch.Tensor]:
    """The fused randomized transcript's cross-shard edge: ``leaves`` are
    the shards' leaf digests ((64, per) each, on their devices); the table
    of all of them in global lane order (the ``all_gather``) is copied to
    every shard's device, and each shard derives the identical root and its
    own lanes' coefficients ``z_i = H(root || i)``.  Returns each shard's
    (16, per) coefficients -- the host twin's, bit for bit."""
    devices = mesh.shard_devices()
    per = padded // len(devices)
    table = _gather(leaves, devices[0])
    return [
        transcript_coefficients(tag, n, table.to(dev), padded, s * per, per)
        for s, dev in enumerate(devices)
    ]


def sharded_fused_aggregate_fn(mesh: DeviceMesh, tag: bytes, n: int, padded: int) -> Callable:
    """The fused randomized-aggregate check over ``mesh``.

    Device Fiat-Shamir with one gather: each shard hashes its own lanes'
    challenges and transcript leaves (S1, :func:`aggregate_leaves`), the
    leaf table is gathered (:func:`sharded_transcript`), each shard hashes
    the one-lane root and its lanes' coefficients, then checks an
    independent aggregate over its lanes with its own base scalar ``u_s =
    sum z_i s_i`` (B3, D1, D2; :func:`aggregate_verdict`); pad lanes carry
    s = 0 and masked digits, so a padding-only shard votes ok.  The stages
    keep the single engine's ``ed25519.fused.*`` ranges.
    Every shard hashes the root, so N shards on one card pay N root hashes.
    Specialized per ``(tag, n, padded)`` like the single engine's bodies."""
    n_shards = mesh.size
    if padded % n_shards:
        raise ValueError("padded batch must be a multiple of the mesh size")
    dev0 = mesh.shard_devices()[0]

    def run(*arrays):
        KERNELS.record_launch("ed25519.sharded_fused_batch_verify" + kernel_lane_suffix())
        shards = _shards(mesh, arrays)
        fronts = [aggregate_leaves(kb, kn, lb, ln) for _, _, _, kb, kn, lb, ln, _ in shards]
        with record_function("ed25519.fused.transcript"):
            zs = sharded_transcript(mesh, tag, n, padded, [leaves for _, leaves in fronts])
        results = [
            aggregate_verdict(z, k_bytes, r, s, key, ok)
            for (r, s, key, _, _, _, _, ok), (k_bytes, _), z in zip(shards, fronts, zs)
        ]
        bad = _psum([~eq for eq, _ in results], dev0)
        valid, bad = _read_back(_gather([v for _, v in results], dev0), bad)
        return bad == 0, valid.astype(bool)

    return run


class ShardedFusedEd25519RandomizedVerifier(
    FusedEd25519RandomizedBatchVerifier, ShardedFusedEd25519Verifier
):
    """Randomized fused verifier whose aggregate check (and strict floor)
    ride the mesh.  The bisection driver, the host fallback and the
    canonical pre-filter are the single-device fused engine's; only the two
    launch seams are re-routed."""

    def __init__(self, mesh: MeshLike = None, *, device: DeviceLike = None, **kw) -> None:
        # The randomized base consumes min_randomized before the strict
        # chain; with the diamond MRO here the strict chain skips it, so it
        # is popped and set explicitly (the base's clamp).
        min_randomized = kw.pop("min_randomized", 2)
        ShardedFusedEd25519Verifier.__init__(self, mesh, device=device, **kw)
        self._min_randomized = max(2, int(min_randomized))

    def _strict_floor(self, messages, signatures, public_keys) -> np.ndarray:
        return ShardedFusedEd25519Verifier.verify_batch(self, messages, signatures, public_keys)

    def _fused_aggregate(self, idx, messages, signatures, public_keys):
        m = len(idx)
        padded = self.padded_size(m)
        layout = aggregate_layout(
            [messages[i] for i in idx], [bytes(signatures[i])[:32] for i in idx],
            [public_keys[i] for i in idx], [signatures[i] for i in idx], padded,
            _byte_rows([bytes(signatures[i])[32:] for i in idx], 32),
        )
        fn = compiled_kernel(
            "ed25519.sharded_fused_batch_verify",
            self.mesh,
            lambda: sharded_fused_aggregate_fn(self.mesh, _Z_TAG, m, padded),
            extra=(_Z_TAG, m, padded),
        )
        eq_ok, valid = fn(*layout)
        return bool(eq_ok), valid[:m].tolist()


__all__ = [
    "make_mesh",
    "mesh_for_shards",
    "compiled_kernel",
    "clear_compiled_kernels",
    "sharded_verify_fn",
    "sharded_batch_verify_fn",
    "sharded_p256_verify_fn",
    "sharded_fused_verify_fn",
    "sharded_fused_aggregate_fn",
    "sharded_transcript",
    "ShardedEd25519Verifier",
    "ShardedEd25519RandomizedVerifier",
    "ShardedEcdsaP256Verifier",
    "ShardedFusedEd25519Verifier",
    "ShardedFusedEd25519RandomizedVerifier",
    "MeshTopology",
    "mesh_padded_size",
    "engine_padded_size",
    "BATCH_AXIS",
]
