"""Numeric kernels of the port: GF(2^255-19) limb arithmetic, edwards25519
formulas, and the hand-written scan kernels with their plain versions."""

from consensus_tpu_torch.ops import ed25519, field25519, field_p256, limbs, p256, scan_kernels

__all__ = ["ed25519", "field25519", "field_p256", "limbs", "p256", "scan_kernels"]
