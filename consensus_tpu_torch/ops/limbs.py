"""Shared limb-vector helpers (torch port of ``consensus_tpu/ops/limbs.py``).

Field elements are limb vectors with the limb axis leading and the batch
trailing.  The field-operation counting shim of the JAX module
(``FieldOpCount``, ``counted_scan``) is not ported yet.
"""

from __future__ import annotations

import torch


def carry_i32(x: torch.Tensor, limb_bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact sequential int32 carry pass over the leading (limb) axis.

    Returns ``(normalized limbs, final carry)``; negative inputs borrow
    correctly through the arithmetic right shift."""
    mask = (1 << limb_bits) - 1
    out = torch.empty_like(x)
    carry = torch.zeros_like(x[0])
    for i in range(x.shape[0]):
        v = x[i] + carry
        out[i] = v & mask
        carry = v >> limb_bits
    return out, carry


def lt_bytes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Little-endian lexicographic ``a < b`` over byte rows.

    ``a`` is ``(n_bytes, batch)``; ``b`` is a ``(n_bytes,)`` constant.
    Equal inputs compare False.  The most significant differing byte is
    read with a gather (the JAX module's one-hot contraction is a TPU
    idiom; the function is the same)."""
    n = a.shape[0]
    b_col = b.to(device=a.device, dtype=a.dtype)[:, None]
    diff = a != b_col  # (n, batch)
    first = torch.argmax(diff.flip(0).to(torch.int32), dim=0)  # MS difference
    idx = (n - 1 - first).unsqueeze(0)
    a_at = torch.gather(a, 0, idx)[0]
    b_at = torch.gather(b_col.expand_as(a), 0, idx)[0]
    return torch.where(diff.any(dim=0), a_at < b_at, torch.zeros_like(a_at, dtype=torch.bool))


__all__ = ["carry_i32", "lt_bytes"]
