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

The fused bodies reach the stage through three wrappers of kernel L1
(``csrc/scalar25519.cu``): :func:`scalar_challenge` (k = H mod L, as digits
or bytes, from kernel S1's state words or a digest's byte rows),
:func:`scalar_challenge_checked` (k's digits and the fused strict body's
canonical checks S < L, y_R < p, y_A < p) and :func:`scalar_aggregate` (the
digits of z k and z, and u = sum z s mod L).  On a CUDA tensor each launches
L1 once or raises; on a CPU tensor it runs its plain version
(:func:`scalar_challenge_reference`,
:func:`scalar_challenge_checked_reference`,
:func:`scalar_aggregate_reference`: the functions above, unchanged, so the
counting shim's notes and the JAX parity stay as they were).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from consensus_tpu_torch.obs.kernels import KERNELS as LEDGER
from consensus_tpu_torch.ops import field25519 as fe
from consensus_tpu_torch.ops import limbs
from consensus_tpu_torch.ops import scan_kernels
from consensus_tpu_torch.ops import sha512 as sh

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


# --- kernel L1: the fused scalar stage -----------------------------------------

#: Windows of the recodings: a scalar below 2^253, a 128-bit coefficient.
K_WINDOWS = 64
Z_WINDOWS = 33
#: L1's lanes a block in challenge mode and in aggregate mode, whose sum's
#: scratch is one row of 8 uint64 a block (csrc/scalar25519.cu).
L1_LANES = 16
L1_SUM_LANES = 64
_L1_SUM_WORDS = 8
_MODE_CHALLENGE, _MODE_AGGREGATE = 0, 1


def _challenge_rows(h: torch.Tensor) -> int:
    """0 where ``h`` is kernel S1's state ``(8, 2, lanes)``, else the byte
    rows of a digest ``(1..64, lanes)``; raises on any other shape."""
    if h.dim() == 3 and tuple(h.shape[:2]) == (8, 2):
        return 0
    rows = h.shape[0] if h.dim() == 2 else 0
    if not 1 <= rows <= 64:
        raise ValueError(f"scalar25519: the digest must be (1..64, lanes) or S1's state "
                         f"(8, 2, lanes), got {tuple(h.shape)}")
    return rows


def _digest(h: torch.Tensor) -> torch.Tensor:
    """The digest's byte rows of ``h`` (a state's through
    :func:`~consensus_tpu_torch.ops.sha512.digest_bytes`)."""
    return sh.digest_bytes(h) if _challenge_rows(h) == 0 else h


def _check_challenge(h: torch.Tensor, checks=None) -> tuple[int, int]:
    """Check the challenge input (int32, contiguous, one device) and the
    canonical checks' rows where given (``(sig_rows (64, lanes), key_rows
    (32, lanes))`` uint8 and ``host_ok (lanes,)`` bool); returns (rows,
    lanes), rows 0 for a state."""
    rows = _challenge_rows(h)
    flat = h
    if rows == 0:
        if not h.is_contiguous():
            raise ValueError("scalar25519: inputs must be contiguous")
        flat = h.view(16, h.shape[2])
    n = scan_kernels._check_inputs(
        "scalar25519", {}, {"digest": (flat, rows or 16)},
        masks=None if checks is None else {"host_ok": checks[2]})
    if checks is not None:
        for label, t, width in (("sig_rows", checks[0], 64), ("key_rows", checks[1], 32)):
            if t.dtype != torch.uint8:
                raise TypeError(f"scalar25519: {label} must be uint8, got {t.dtype}")
            if tuple(t.shape) != (width, n):
                raise ValueError(f"scalar25519: {label} must be ({width}, {n}), got "
                                 f"{tuple(t.shape)}")
            if t.device != h.device:
                raise ValueError("scalar25519: all inputs must be on one device")
            if not t.is_contiguous():
                raise ValueError("scalar25519: inputs must be contiguous")
    return rows, n


def scalar_challenge_reference(digest: torch.Tensor, *, digits: bool = True) -> torch.Tensor:
    """The plain version of L1's challenge mode: k = digest mod L
    (:func:`reduce_bytes_mod_l`; a state's digest from ``digest_bytes``),
    then its :data:`K_WINDOWS` signed window digits
    (:func:`signed_window_digits`), or k's bytes where ``digits`` is
    false."""
    k = reduce_bytes_mod_l(_digest(digest))
    return signed_window_digits(k, K_WINDOWS) if digits else k


def scalar_challenge_checked_reference(
    h: torch.Tensor, sig_rows: torch.Tensor, key_rows: torch.Tensor, host_ok: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of L1's challenge mode with the fused strict body's
    canonical checks: k's digits (:func:`scalar_challenge_reference`) and
    ``ok = host_ok & (S < L) & (y_R < p) & (y_A < p)``, each y with its
    sign bit masked (RFC 8032 5.1.7's malleability check and the canonical
    encodings), by :func:`lt_l` and ``field25519.bytes_lt_p``."""
    k_digits = scalar_challenge_reference(h)
    sig = sig_rows.to(torch.int32)
    key = key_rows.to(torch.int32)
    y_r = torch.cat([sig[:31], (sig[31] & 0x7F)[None]])
    y_a = torch.cat([key[:31], (key[31] & 0x7F)[None]])
    ok = host_ok & lt_l(sig[32:]) & fe.bytes_lt_p(y_r) & fe.bytes_lt_p(y_a)
    return k_digits, ok


def scalar_aggregate_reference(
    z: torch.Tensor, k: torch.Tensor, s: Optional[torch.Tensor] = None
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of L1's aggregate mode: the digits of z k mod L and
    of z, and u = sum z s mod L (None without ``s``), by the functions
    above."""
    zk_digits = signed_window_digits(mul_mod_l(z, k), K_WINDOWS)
    z_digits = signed_window_digits(z, Z_WINDOWS)
    u = None if s is None else sum_mod_l(mul_mod_l(z, s))
    return zk_digits, z_digits, u


def _challenge_launch(h, rows: int, n: int, digits: bool, checks=None):
    """One launch of L1's challenge mode: (k's digits or bytes, ok or None)."""
    device = h.device
    out = torch.empty((K_WINDOWS if digits else 32, n), dtype=torch.int32, device=device)
    ok = None if checks is None else torch.empty(n, dtype=torch.bool, device=device)
    sig, key, host_ok = checks if checks is not None else (None, None, None)
    scan_kernels._launch(
        "scalar25519", (h, None, None, sig, key, host_ok),
        (out if digits else None, None, None if digits else out, ok, None, None),
        n, device, (_MODE_CHALLENGE, rows))
    LEDGER.record_launch("scalar25519")
    return out, ok


def scalar_challenge(h: torch.Tensor, *, digits: bool = True) -> torch.Tensor:
    """The challenge scalars k = H mod L per lane from the SHA-512 digest
    ``h``: kernel S1's state ``(8, 2, lanes)`` int32 as
    ``ops/sha512.py::sha512_blocks`` returns it, or the digest's
    little-endian byte rows ``(n_bytes, lanes)`` int32 (n_bytes <= 64, each a
    byte).  Returns k's ``(64, lanes)`` signed window digits (d + 8, most
    significant window first) or, where ``digits`` is false, its canonical
    ``(32, lanes)`` bytes.  On CUDA one launch of kernel L1 reads the state
    words as they are and writes the plain version's values; on the CPU it
    is the plain version's output (a state's digest from
    ``digest_bytes``)."""
    rows, n = _check_challenge(h)
    if h.device.type == "cpu":
        return scalar_challenge_reference(h, digits=digits)
    return _challenge_launch(h, rows, n, digits)[0]


def scalar_challenge_checked(
    h: torch.Tensor, sig_rows: torch.Tensor, key_rows: torch.Tensor, host_ok: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused strict body's scalar stage: k's ``(64, lanes)`` digits as
    :func:`scalar_challenge` writes them, and the canonical checks ``ok =
    host_ok & (S < L) & (y_R < p) & (y_A < p)`` ``(lanes,)`` bool over the
    signature rows ``(64, lanes)`` and key rows ``(32, lanes)`` (uint8, as
    the engines put them on the device).  On CUDA both come from one launch
    of kernel L1; on the CPU from the plain version
    (:func:`scalar_challenge_checked_reference`)."""
    checks = (sig_rows, key_rows, host_ok)
    rows, n = _check_challenge(h, checks)
    if h.device.type == "cpu":
        return scalar_challenge_checked_reference(h, *checks)
    return _challenge_launch(h, rows, n, True, checks)


def scalar_aggregate(
    z: torch.Tensor, k: torch.Tensor, s: Optional[torch.Tensor] = None
) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The aggregate check's scalars from the coefficients ``z`` ``(16,
    lanes)``, the challenges ``k`` and the S values ``s`` ``(32, lanes)``
    (int32 byte rows): the ``(64, lanes)`` digits of z k mod L, the ``(33,
    lanes)`` digits of z, and u = sum over the lanes of z s mod L as ``(32,
    1)`` bytes; without ``s`` (half-aggregation's certificate scalar) u is
    None.  On CUDA one launch of kernel L1 (its sum a second, one-block
    kernel of the same launch) writes the plain version's values; on the CPU
    it is the plain version's output."""
    rows = {"z": (z, 16), "k": (k, 32)}
    if s is not None:
        rows["s"] = (s, 32)
    n = scan_kernels._check_inputs("scalar25519", {}, rows)
    device = z.device
    if device.type == "cpu":
        return scalar_aggregate_reference(z, k, s)
    new = lambda *shape, dtype=torch.int32: torch.empty(shape, dtype=dtype, device=device)
    zk_digits, z_digits = new(K_WINDOWS, n), new(Z_WINDOWS, n)
    u = partials = None
    if s is not None:
        u = new(32, 1)
        partials = new(-(-n // L1_SUM_LANES) * _L1_SUM_WORDS, dtype=torch.int64)
    scan_kernels._launch("scalar25519", (z, k, s, None, None, None),
                         (zk_digits, z_digits, None, None, u, partials),
                         n, device, (_MODE_AGGREGATE, 16))
    LEDGER.record_launch("scalar25519")
    return zk_digits, z_digits, u


__all__ = [
    "K_WINDOWS",
    "L",
    "L1_LANES",
    "L1_SUM_LANES",
    "L_BYTES_LE",
    "Z_WINDOWS",
    "lt_l",
    "mul_mod_l",
    "reduce_bytes_mod_l",
    "scalar_aggregate",
    "scalar_aggregate_reference",
    "scalar_challenge",
    "scalar_challenge_checked",
    "scalar_challenge_checked_reference",
    "scalar_challenge_reference",
    "signed_window_digits",
    "sum_mod_l",
]
