"""Scalar arithmetic mod L (the edwards25519 group order) on the device:
the torch port of ``consensus_tpu/ops/scalar25519.py``.

The fused front end (:mod:`consensus_tpu_torch.models.fused`) reduces the
512-bit challenge hash mod L, forms the transcript products ``z_i k_i mod
L`` and the aggregate base scalar ``sum z_i s_i mod L``, and recodes scalars
into the scan kernels' signed window digits, all on the device.  Values are
little-endian byte rows ``(n_bytes, batch)`` with the batch trailing, as in
the JAX module.

Reduction exploits L's sparse form ``L = 2^252 + delta`` (delta < 2^125):

1. **Byte fold**: ``x = sum b_i 2^(8i)`` collapses to 32 columns against
   the ``(2^(8i) mod L)`` byte table; congruent mod L, every column sum
   below 2^23.  The JAX module contracts in float32, exact only because of
   that bound (and wrong under TF32).  CUDA has no integer matrix product,
   so the port sums integer products over the input bytes in int32: exact
   by the same bound, no float rounding to reason about, and no cuBLAS
   call (each thread that runs one keeps a 32 MiB workspace on the card).
2. **Carry** to canonical bytes over two spare top limbs.
3. **Sparse fold** at bit 252: ``x = hi 2^252 + lo == lo - hi delta``,
   signed, then one borrow-driven ``+L``.

Both modules book their byte products into the field-operation counting
shim (``limbs.note_byte_muls``) at the same sites, and the window recoding
runs as a ``limbs.counted_scan``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from consensus_tpu_torch.ops import limbs

#: Group order of edwards25519 (RFC 8032) and its sparse-form tail.
L = 2**252 + 27742317777372353535851937790883648493
_DELTA = L - 2**252

#: L as little-endian bytes (canonical-range checks: S < L).
L_BYTES_LE = np.frombuffer(L.to_bytes(32, "little"), dtype=np.uint8)


def _int_to_bytes_row(value: int, width: int) -> np.ndarray:
    return np.frombuffer(value.to_bytes(width, "little"), dtype=np.uint8)


#: Row i = little-endian bytes of (2^8i mod L): the byte-fold table.
_POW_TABLE = np.stack(
    [_int_to_bytes_row(pow(256, i, L), 32) for i in range(64)]
).astype(np.int32)  # (64, 32)

#: Row j = exact little-endian bytes of (delta << 8j), NOT reduced: the
#: sparse fold subtracts hi * delta exactly.
_DELTA_SHIFT = np.stack(
    [_int_to_bytes_row(_DELTA << (8 * j), 32) for j in range(2)]
).astype(np.int32)  # (2, 32)

_L_LIMBS = _int_to_bytes_row(L, 32).astype(np.int32)

_CONSTANTS = {
    "pow_table": _POW_TABLE,
    "delta_shift": _DELTA_SHIFT,
    "l_limbs": _L_LIMBS,
    "l_bytes": L_BYTES_LE.astype(np.int32),
}


@functools.lru_cache(maxsize=None)
def _constant(name: str, device: torch.device) -> torch.Tensor:
    """One of this module's int32 tables on ``device``, copied once."""
    return torch.from_numpy(_CONSTANTS[name]).to(device)


def _fold(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``sum_i table[i, k] * x[i, b]`` -> (k, b), in int32 (the callers'
    columns stay below 2^23)."""
    return (table[:, :, None] * x[:, None, :]).sum(dim=0, dtype=torch.int32)


def reduce_bytes_mod_l(x_bytes: torch.Tensor) -> torch.Tensor:
    """Little-endian byte rows ``(n_bytes, batch)`` (n_bytes <= 64, each
    byte in [0, 255]) -> canonical bytes ``(32, batch)`` int32 of the value
    mod L.  Handles the full 512-bit SHA-512 digest range."""
    n_bytes, batch = x_bytes.shape
    if n_bytes > 64:
        raise ValueError("byte fold table covers 64 input bytes")
    device = x_bytes.device
    table = _constant("pow_table", device)[:n_bytes]
    limbs.note_byte_muls(n_bytes * 32, batch)
    folded = _fold(table, x_bytes.to(torch.int32))  # columns < 64*255*255 < 2^23
    # Two spare limbs hold the fold's overflow (< 2^267 < 2^272).
    ext = torch.cat([folded, torch.zeros((2, batch), dtype=torch.int32, device=device)])
    canon, top = limbs.carry_i32(ext)  # top carry provably 0

    # Sparse fold at bit 252: hi < 2^15 after the carry above.
    hi = (canon[31] >> 4) + (canon[32] << 4) + (canon[33] << 12) + (top << 20)
    lo = torch.cat([canon[:31], (canon[31] & 0xF)[None]])
    h_bytes = torch.stack([hi & 0xFF, hi >> 8])  # (2, batch)
    limbs.note_byte_muls(2 * 32, batch)
    sub = _fold(_constant("delta_shift", device), h_bytes)
    signed, borrow = limbs.carry_i32(lo - sub)
    # Value in (-2^142, 2^252): negative iff borrow < 0; one +L lands
    # canonical (2^252 < L, so the non-negative branch is already there).
    zero = torch.zeros((), dtype=torch.int32, device=device)
    fixup = torch.where(borrow[None] < 0, _constant("l_limbs", device)[:, None], zero)
    out, _ = limbs.carry_i32(signed + fixup)
    return out


def mul_mod_l(a_bytes: torch.Tensor, b_bytes: torch.Tensor) -> torch.Tensor:
    """Product mod L of little-endian byte rows ``(na, batch)`` x ``(nb,
    batch)``, schoolbook columns in int32 (the pipeline's shapes are 16 x 32
    and 32 x 32: columns <= 32 * 255^2 < 2^22)."""
    na, batch = a_bytes.shape
    nb = b_bytes.shape[0]
    if min(na, nb) > 32:
        raise ValueError("schoolbook columns would overflow the 2^23 column bound")
    a = a_bytes.to(torch.int32)
    b = b_bytes.to(torch.int32)
    limbs.note_byte_muls(na * nb, batch)
    cols = torch.zeros((64, batch), dtype=torch.int32, device=a.device)
    for i in range(na):  # na broadcast multiplies, as the JAX module unrolls them
        cols[i : i + nb] += a[i][None] * b
    canon, _ = limbs.carry_i32(cols)  # < 2^384 << 2^512
    return reduce_bytes_mod_l(canon)


def sum_mod_l(vals_bytes: torch.Tensor) -> torch.Tensor:
    """Sum over the batch axis mod L: canonical byte rows ``(32, batch)``
    -> canonical bytes ``(32, 1)``.  Column sums stay int32-exact up to
    batch 2^23."""
    summed = vals_bytes.to(torch.int32).sum(dim=-1, keepdim=True, dtype=torch.int32)
    ext = torch.cat([summed, torch.zeros((32, 1), dtype=torch.int32, device=summed.device)])
    canon, _ = limbs.carry_i32(ext)  # value < batch * L < 2^280 << 2^512
    return reduce_bytes_mod_l(canon)


def lt_l(s_bytes: torch.Tensor) -> torch.Tensor:
    """The malleability check ``S < L`` (RFC 8032 5.1.7) over ``(32,
    batch)`` little-endian byte rows."""
    return limbs.lt_bytes(s_bytes.to(torch.int32), _constant("l_bytes", s_bytes.device))


def signed_window_digits(k_bytes: torch.Tensor, windows: int = 64) -> torch.Tensor:
    """Canonical little-endian byte rows -> signed 4-bit window digits,
    stored as ``d + 8`` (int32), MSB window first: the device twin of
    ``models.ed25519._signed_digits_int``.  ``windows`` must leave carry
    headroom as the host recoding requires (64 for k < 2^253, 33 for
    128-bit coefficients)."""
    k = k_bytes.to(torch.int32)
    nibbles = torch.stack([k & 0xF, k >> 4], dim=1).reshape(2 * k.shape[0], k.shape[-1])
    if nibbles.shape[0] > windows:
        nibbles = nibbles[:windows]
    elif nibbles.shape[0] < windows:
        pad = torch.zeros((windows - nibbles.shape[0], k.shape[-1]), dtype=torch.int32,
                          device=k.device)
        nibbles = torch.cat([nibbles, pad])

    def step(carry, u):  # LSB window first, as the JAX scan runs
        t = u + carry
        over = (t >= 8).to(torch.int32)
        return over, t - 16 * over

    _, digits = limbs.counted_scan(step, torch.zeros_like(nibbles[0]), nibbles)
    return digits.flip(0) + 8


__all__ = [
    "L",
    "L_BYTES_LE",
    "lt_l",
    "mul_mod_l",
    "reduce_bytes_mod_l",
    "signed_window_digits",
    "sum_mod_l",
]
