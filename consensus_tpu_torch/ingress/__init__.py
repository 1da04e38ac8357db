"""Ingress plane: the demand side of "millions of users".

The verification plane (multi-tenant sidecar, fused on-device engines) is
fast; this package models and hardens the path that feeds it:

* :mod:`consensus_tpu_torch.ingress.workload` — deterministic, seed-pure client
  traces (heavy-tailed sizes, Poisson/bursty arrivals, diurnal ramps,
  hot-tenant skew, duplicate-retry storms) anchored to the sim clock.
* :mod:`consensus_tpu_torch.ingress.admission` — per-client token-bucket rate
  limiting plus a bounded dedup LRU keyed on the full
  :class:`~consensus_tpu_torch.types.RequestInfo`, ahead of pool insertion.
* :mod:`consensus_tpu_torch.ingress.placement` — consistent-hash (rendezvous)
  tenant→sidecar placement over a horizontally scaled verifier fleet,
  with deterministic ~1/N remap on server join/leave.
* :mod:`consensus_tpu_torch.ingress.driver` — an OPEN-LOOP trace replayer
  (arrivals never gated on completions) recording offered vs admitted vs
  committed load and latency percentiles, byte-identical per seed.

Everything runs on the injected scheduler clock — no wall-clock reads
(scripts/check_no_wallclock.py walks this tree; tests/test_no_wallclock.py
pins the coverage).

The PyTorch port's copy of ``consensus_tpu/ingress/__init__.py``, its imports renamed.
"""

from consensus_tpu_torch.ingress.admission import (
    AdmissionController,
    DedupCache,
    TokenBucket,
)
from consensus_tpu_torch.ingress.driver import IngressDriver, SimSidecarFleet
from consensus_tpu_torch.ingress.placement import PlacementRing, SidecarFleet
from consensus_tpu_torch.ingress.workload import (
    TraceEvent,
    WorkloadSpec,
    clean_spec,
    duplicate_storm_spec,
    flood_spec,
    generate_trace,
)

__all__ = [
    "AdmissionController",
    "DedupCache",
    "IngressDriver",
    "PlacementRing",
    "SidecarFleet",
    "SimSidecarFleet",
    "TokenBucket",
    "TraceEvent",
    "WorkloadSpec",
    "clean_spec",
    "duplicate_storm_spec",
    "flood_spec",
    "generate_trace",
]
