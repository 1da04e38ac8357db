"""Device and kernel accounting (the port's part of ``consensus_tpu/obs``):
the kernel ledger and the kernel-library build ledger.  The sampler,
detectors, exporters and flight recorder come with the protocol core."""

from consensus_tpu_torch.obs.kernels import (
    COMPILE_CACHE,
    KERNELS,
    TENANT_KERNELS,
    CompileCacheStats,
    KernelRegistry,
    TenantAccounting,
    kernel_lane_suffix,
)

__all__ = [
    "COMPILE_CACHE",
    "CompileCacheStats",
    "KERNELS",
    "KernelRegistry",
    "TENANT_KERNELS",
    "TenantAccounting",
    "kernel_lane_suffix",
]
