"""Device and kernel accounting: the port's kernel ledger (counterpart of
``consensus_tpu/obs/kernels.py``).

The JAX package books every call of an ``instrumented_jit`` entry point.
The port has no jit: what it books, into the process-wide :data:`KERNELS`
registry, is

* each launch of a hand-written CUDA kernel, by its wrapper in
  ``ops/scan_kernels.py`` (``horner_scan``, ``horner_scan_p256``,
  ``straus_msm``, ``decompress25519``, ``comb25519``) or ``ops/sha512.py``
  (``sha512``; the plain versions, run for CPU tensors, are not launches),
  with ``compiles`` counting the kernel library's nvcc builds;
* each device call of an engine, under the JAX package's names
  (``ed25519.verify``, ``ed25519.batch_verify``, ``ecdsa_p256.verify``, the
  sharded engines' ``ed25519.sharded_verify`` and the like: one a wave,
  whose shards each launch the kernels).

:data:`COMPILE_CACHE` counts how each kernel library was obtained (a miss
where nvcc ran, a hit where an existing build in ``csrc/build/`` was
loaded) and how each sharded engine's body was obtained from the
compiled-kernel memo (``parallel/sharding.py::compiled_kernel``: a miss
where it was built, a hit where a rebuilt engine reused it; a body is no
build, so it books no compile).  ``flops`` and ``bytes_accessed`` stay
None: there is no XLA cost analysis to read.
"""

from __future__ import annotations

import os
import threading
from typing import Optional


class KernelStats:
    """Mutable per-kernel counters."""

    __slots__ = ("name", "launches", "compiles", "flops", "bytes_accessed")

    def __init__(self, name: str) -> None:
        self.name = name
        self.launches = 0
        self.compiles = 0
        self.flops: Optional[float] = None
        self.bytes_accessed: Optional[float] = None

    @property
    def retraces(self) -> int:
        return max(0, self.compiles - 1)

    def as_dict(self) -> dict:
        return {
            "launches": self.launches,
            "compiles": self.compiles,
            "retraces": self.retraces,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
        }


class KernelRegistry:
    """Process-wide map of kernel name -> :class:`KernelStats`.

    Kernels launch from several threads (a coalescer's flusher, the callers
    it bypasses), so creating an entry and booking into one hold a lock."""

    def __init__(self) -> None:
        self._stats: dict[str, KernelStats] = {}
        self._lock = threading.Lock()

    def stats(self, name: str) -> KernelStats:
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                st = self._stats[name] = KernelStats(name)
            return st

    def record_launch(self, name: str) -> None:
        """Book one launch of ``name``."""
        st = self.stats(name)
        with self._lock:
            st.launches += 1

    def record_compile(self, name: str) -> None:
        """Book one build of ``name``'s kernel library."""
        st = self.stats(name)
        with self._lock:
            st.compiles += 1

    def snapshot(self) -> dict:
        """``{kernel: {launches, compiles, retraces, flops, bytes_accessed}}``,
        sorted, JSON-ready.  Empty dict when nothing has launched."""
        return {
            name: self._stats[name].as_dict() for name in sorted(self._stats)
        }

    def totals(self) -> dict:
        snap = self.snapshot()
        return {
            "launches": sum(s["launches"] for s in snap.values()),
            "compiles": sum(s["compiles"] for s in snap.values()),
            "retraces": sum(s["retraces"] for s in snap.values()),
        }

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


#: The process-wide kernel ledger.
KERNELS = KernelRegistry()


class TenantAccounting:
    """Per-tenant slice of a shared engine's kernel work: which tenant's
    signatures rode which share of the launches.

    A wave former coalesces many tenants' submissions into one wave, so
    :data:`KERNELS` alone cannot attribute device time to a tenant; the
    former's ``on_wave`` hook reports each launch here instead.  ``waves``
    counts launches the tenant participated in (a shared wave counts once
    per PARTICIPANT, so summing waves over tenants exceeds engine launches
    exactly when coalescing is winning)."""

    def __init__(self) -> None:
        self._tenants: dict[str, dict] = {}

    def record_wave(self, tenant: str, signatures: int) -> None:
        t = self._tenants.get(tenant)
        if t is None:
            t = self._tenants[tenant] = {"waves": 0, "signatures": 0}
        t["waves"] += 1
        t["signatures"] += signatures

    def snapshot(self) -> dict:
        """``{tenant: {waves, signatures}}``, sorted, JSON-ready."""
        return {
            tenant: dict(self._tenants[tenant])
            for tenant in sorted(self._tenants)
        }

    def reset(self) -> None:
        self._tenants.clear()


#: Process-wide tenant accounting.
TENANT_KERNELS = TenantAccounting()


class CompileCacheStats:
    """Hit/miss ledger of the kernel-library builds and of the sharded
    engines' body memo.

    A *miss* is a build: nvcc ran for a source whose library was not in
    ``csrc/build/`` yet, or a sharded body was built for a new ``(kernel,
    mesh[, shape])`` key.  A *hit* is a load of an existing build of the
    same source, or a rebuilt sharded engine reusing the memoized body.
    Surfaced through the metrics bundle as
    ``engine_compile_cache_{hits,misses}_total``."""

    def __init__(self) -> None:
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()  # kernels build side by side

    def record(self, *, hit: bool) -> None:
        with self._lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1

    def snapshot(self) -> dict:
        return {"hits": self.hits, "misses": self.misses}

    def reset(self) -> None:
        self.hits = 0
        self.misses = 0


#: Process-wide build ledger (fed by ops/scan_kernels.py and
#: parallel/sharding.py).
COMPILE_CACHE = CompileCacheStats()


def kernel_lane_suffix() -> str:
    """``"_mxu"`` when the process selects the tensor-core field lane
    (``CTPU_MXU_LIMBS=1``, as in the JAX package), else ``""``.

    The engines book each device call under ``<name>`` + this suffix, read
    at the call, so a lane-on run's calls land under ``ed25519.verify_mxu``
    and the like beside the VPU lane's; the JAX package appends it to its
    ``instrumented_jit`` names at import."""
    return "_mxu" if os.environ.get("CTPU_MXU_LIMBS", "") == "1" else ""


__all__ = [
    "COMPILE_CACHE",
    "CompileCacheStats",
    "KERNELS",
    "KernelRegistry",
    "KernelStats",
    "TENANT_KERNELS",
    "TenantAccounting",
    "kernel_lane_suffix",
]
