"""Cluster observability plane: sim-clock time-series sampling, health
snapshots, anomaly detectors, exporters, a crash/invariant flight recorder,
and device/kernel accounting (the port's counterpart of
``consensus_tpu/obs``).

Always compiled, default off (like consensus_tpu_torch/trace/).  See
sampler.py (the scheduler-driven ring sampler + derived health fields),
detectors.py (commit-stall / view-change storm / leader flap / sync-lag /
verify-collapse), export.py (Prometheus text format v0.0.4, sorted-key
JSONL, terminal sparklines), flightrec.py (atomic failure bundles +
loader): copies of the JAX package's modules.  kernels.py is the port's own
kernel ledger and kernel-library build ledger.  The package exports what
the JAX package's does except ``instrumented_jit``, a wrapper around
``jax.jit`` that has no counterpart here: the port's kernels book their
launches in their wrappers.
"""

from consensus_tpu_torch.obs.detectors import Anomaly, DetectorThresholds
from consensus_tpu_torch.obs.export import (
    sample_to_prometheus,
    series_to_jsonl,
    sparkline,
    write_series_jsonl,
)
from consensus_tpu_torch.obs.flightrec import (
    FlightRecord,
    FlightRecorder,
    load_flight_record,
)
from consensus_tpu_torch.obs.kernels import (
    COMPILE_CACHE,
    KERNELS,
    TENANT_KERNELS,
    CompileCacheStats,
    KernelRegistry,
    TenantAccounting,
    kernel_lane_suffix,
)
from consensus_tpu_torch.obs.sampler import ClusterSampler

__all__ = [
    "Anomaly",
    "COMPILE_CACHE",
    "ClusterSampler",
    "CompileCacheStats",
    "DetectorThresholds",
    "FlightRecord",
    "FlightRecorder",
    "KERNELS",
    "KernelRegistry",
    "TENANT_KERNELS",
    "TenantAccounting",
    "kernel_lane_suffix",
    "load_flight_record",
    "sample_to_prometheus",
    "series_to_jsonl",
    "sparkline",
    "write_series_jsonl",
]
