"""GF(2^255-19) arithmetic as batched torch float32 limb vectors.

Torch port of ``consensus_tpu/ops/field25519.py``, on the same layout so the
two agree limb for limb: a field element is **32 limbs x 8 bits** stored as
``float32`` of shape ``(32, *batch)``, limbs leading and batch trailing.
Every limb is a small integer held exactly in f32 (24-bit integer window),
so all arithmetic here is bit-exact.  That layout exists because the TPU's
vector unit lacks integer multiplies; on the card the hot loop runs in the
hand-written CUDA kernel (:mod:`consensus_tpu_torch.ops.scan_kernels`),
which picks its own radix.  This module is the plain version around it.

Normalization contract (unchanged from the JAX module): public ops take and
return *weakly reduced* elements -- |limb| <= 340 with value within
(-2^250, 2^255 + 2^13), exact mod p.  ``freeze`` produces the canonical
int32 representative in [0, p).

Every constant is float32 (or int32 on the freeze path) and lives on the
operand's device; a float64 constant would silently promote the limbs.

``add``/``sub``, ``mul`` and ``square`` note themselves in the
field-operation counting shim (:mod:`consensus_tpu_torch.ops.limbs`) at the
JAX module's sites, so a counted run reports the JAX module's counts.

``mul`` and ``square`` take the tensor-core lane
(:mod:`consensus_tpu_torch.ops.mxu_limbs`, ``CTPU_MXU_LIMBS=1``) when it is
active, before their note, as the JAX module does: a counted call notes
dots or muls, never both.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from consensus_tpu_torch.ops import limbs, mxu_limbs
from consensus_tpu_torch.ops.limbs import carry_i32, lt_bytes

LIMBS = 32
LIMB_BITS = 8
BASE = 256.0
INV_BASE = 1.0 / 256.0

P = 2**255 - 19
#: 2^256 mod p -- the weight of limb index 32 (used to fold product columns).
FOLD = (2**256) % P  # == 38
#: 2^255 mod p -- the weight of bit 255 (used to fold limb 31's top bit).
TOP_FOLD = 19
#: d of edwards25519: -121665/121666 mod p.
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P
#: sqrt(-1) mod p (for decompression's second root candidate).
SQRT_M1 = pow(2, (P - 1) // 4, P)


def int_to_limbs(value: int) -> np.ndarray:
    """Python int -> one limb vector (numpy, for constants and host prep)."""
    if not 0 <= value < 2**256:
        raise ValueError("value out of limb range")
    return np.array(
        [(value >> (LIMB_BITS * i)) & 0xFF for i in range(LIMBS)], dtype=np.float32
    )


def limbs_to_int(limbs) -> int:
    """Limb vector (limbs axis first) -> Python int (host-side)."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    arr = np.asarray(limbs, dtype=np.int64)
    return sum(int(arr[i]) << (LIMB_BITS * i) for i in range(LIMBS))


#: 2p = 2^256 - 38 fits exactly in 32 limbs (top limb 255).
_TWO_P = np.array(
    [((2 * P) >> (LIMB_BITS * i)) & 0xFF for i in range(LIMBS)], dtype=np.float32
)
#: p as little-endian bytes, for the canonical-encoding check.
P_BYTES_LE = np.frombuffer(P.to_bytes(32, "little"), dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _limb_const(value: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A (32,) constant limb vector for ``0 <= value < 2^256`` (2p
    included), built once per device and dtype."""
    return torch.from_numpy(int_to_limbs(value)).to(device=device, dtype=dtype)


def _cexpand(const: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Reshape a (32,) constant so it broadcasts against (32, *batch)."""
    return const.reshape((LIMBS,) + (1,) * (like.dim() - 1))


def _two_p(like: torch.Tensor) -> torch.Tensor:
    return _cexpand(_limb_const(2 * P, like.device, like.dtype), like)


def constant_like(value: int, like: torch.Tensor) -> torch.Tensor:
    """A constant broadcast to ``like``'s shape and device (a read-only
    expanded view; no op here writes in place)."""
    c = _limb_const(value % P, like.device, torch.float32)
    return _cexpand(c, like).expand(like.shape)


# --- reduction ------------------------------------------------------------


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (x mod 256, floor(x / 256)); exact for |x| < 2^24, floor
    semantics so negative limbs borrow correctly."""
    hi = torch.floor(x * INV_BASE)
    return x - hi * BASE, hi


def _relax(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry-save pass over 32 limbs; the top limb's high part
    folds back at weight 2^256 = 38."""
    lo, hi = _split(x)
    rolled = torch.cat([hi[31:] * FOLD, hi[:31]], dim=0)
    return lo + rolled


def _top_fold(x: torch.Tensor) -> torch.Tensor:
    """Fold bit 255 (limb 31's bit >= 7) back at weight 19."""
    high = torch.floor(x[31] * (1.0 / 128.0))
    return torch.cat(
        [(x[0] + high * TOP_FOLD)[None], x[1:31], (x[31] - high * 128.0)[None]],
        dim=0,
    )


def _weak_reduce(x: torch.Tensor) -> torch.Tensor:
    """Parallel weak reduction for inputs with |limb| < 2^22: three relax
    passes plus a top fold land limbs within |limb| <= 340."""
    x = _relax(x)
    x = _relax(x)
    x = _relax(x)
    return _top_fold(x)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if limbs.counting():
        limbs.note_add(limbs.lanes_of(a, b))
    return _weak_reduce(a + b)


# --- lazy (unreduced) ops -------------------------------------------------
# Exactness budget: mul/square require |a_limb| * |b_limb| * 32 < 2^24,
# i.e. the product of the two operands' limb bounds must stay under 2^19
# (724^2).  Weakly reduced values have |limb| <= 340, so ONE level of
# unreduced add/sub (|limb| <= 680 / 600) can feed a multiplication
# directly.  Never stack two raw levels into a multiply.


def add_raw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b without reduction: |limb| grows to |a| + |b|."""
    return a + b


def sub_raw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b (bias 2p) without reduction: for weakly reduced inputs the
    limbs stay within [-345, 600] -- multiplication-safe."""
    return a + _two_p(a) - b


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # a + 2p - b stays positive for any weakly reduced a, b (< 2p each).
    if limbs.counting():
        limbs.note_add(limbs.lanes_of(a, b))
    return _weak_reduce(a + _two_p(a) - b)


def _reduce_cols(cols: torch.Tensor) -> torch.Tensor:
    """(63, *batch) schoolbook columns (|col| < 2^24) -> weakly reduced."""
    lo, hi = _split(cols)
    c = torch.cat([lo[:1], lo[1:] + hi[:-1], hi[-1:]], dim=0)  # width 64
    r = c[:LIMBS] + c[LIMBS:] * FOLD
    return _weak_reduce(r)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched field multiplication: the 32 x 32 outer product of the limbs,
    summed along its anti-diagonals into 63 columns, then parallel folds.

    The anti-diagonal sum is the skew trick: pad each row of the product to
    64 entries, flatten, and re-read the buffer as rows of 63 -- entry
    (i, j) lands in row i, column i + j.  Every product and every partial
    sum is an integer below 2^24 (the exactness budget above), so the
    column sums are exact in any order and equal the JAX module's
    shifted-add columns bit for bit.

    Under the tensor-core lane it is ``mxu_limbs.mul25519``, bit-identical."""
    if mxu_limbs.lane_active():
        return mxu_limbs.mul25519(a, b)
    if limbs.counting():
        limbs.note_mul(limbs.lanes_of(a, b))
    return _mul(a, b)


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`mul` without its note in the counting shim."""
    a, b = torch.broadcast_tensors(a, b)
    batch_shape = a.shape[1:]
    a2 = a.reshape(LIMBS, -1)
    b2 = b.reshape(LIMBS, -1)
    n = a2.shape[1]
    prod = a2[:, None, :] * b2[None, :, :]  # (32, 32, n)
    skew = F.pad(prod, (0, 0, 0, LIMBS))  # (32, 64, n)
    cols = (
        skew.reshape(2 * LIMBS * LIMBS, n)[: LIMBS * (2 * LIMBS - 1)]
        .reshape(LIMBS, 2 * LIMBS - 1, n)
        .sum(dim=0)
    )
    return _reduce_cols(cols).reshape((LIMBS, *batch_shape))


def square(a: torch.Tensor) -> torch.Tensor:
    """Squaring.  The JAX module sums the doubled upper triangle; the full
    product's columns are the same integers, so ``mul(a, a)`` returns the
    same limbs.  Callers keep the JAX bound (|limb| <= 500).  It notes one
    squaring in the counting shim, as the JAX module does, and no mul.
    Under the tensor-core lane it is ``mxu_limbs.square25519``."""
    if mxu_limbs.lane_active():
        return mxu_limbs.square25519(a)
    if limbs.counting():
        limbs.note_square(limbs.lanes_of(a))
    return _mul(a, a)


def freeze(a: torch.Tensor) -> torch.Tensor:
    """Canonical int32 representative in [0, p).

    Bias by 2p, normalize exactly, fold the top bit, then subtract p while
    the value still exceeds it."""
    x = torch.round(a).to(torch.int32)
    x = x + _cexpand(_limb_const(2 * P, a.device, torch.int32), a)
    x, top = carry_i32(x, LIMB_BITS)  # value in (0, 2^256 + 2^255); top in {0, 1}
    # Fold the carry-out (weight 2^256 = 38) and bit 255 back.
    x[0] += top * FOLD
    high = x[31] >> 7
    x[31] &= 0x7F
    x[0] += high * TOP_FOLD
    x, _ = carry_i32(x, LIMB_BITS)
    p_e = _cexpand(_limb_const(P, a.device, torch.int32), a)
    for _ in range(2):
        d, borrow = carry_i32(x - p_e, LIMB_BITS)
        ge_p = borrow == 0  # no negative carry out => x >= p
        x = torch.where(ge_p[None], d, x)
    return x


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field equality (boolean per batch element)."""
    return torch.all(freeze(a) == freeze(b), dim=0)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(freeze(a) == 0, dim=0)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-batch-element select between limb vectors (cond shape = batch)."""
    return torch.where(cond[None], a, b)


def pow_const(x: torch.Tensor, exponent: int) -> torch.Tensor:
    """x ** exponent for a fixed public exponent, MSB-first square and
    multiply.  The exponent is public, so the branch on each bit is taken
    in Python: the same values as the JAX ladder's select.  The JAX ladder
    multiplies on every bit, so under the counting shim a 0 bit notes the
    multiply it skips, as the active lane would note it."""
    bits = [(exponent >> i) & 1 for i in range(exponent.bit_length())][::-1]
    acc = x  # first bit is always 1
    for bit in bits[1:]:
        acc = square(acc)
        if bit:
            acc = mul(acc, x)
        elif limbs.counting():
            if mxu_limbs.lane_active():
                mxu_limbs.note_skipped_product(limbs.lanes_of(acc, x))
            else:
                limbs.note_mul(limbs.lanes_of(acc, x))
    return acc


def invert(x: torch.Tensor) -> torch.Tensor:
    """Field inverse via Fermat (x^(p-2)); x=0 maps to 0."""
    return pow_const(x, P - 2)


def _square_n(x: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        x = square(x)
    return x


def pow_2_252_m3(x: torch.Tensor) -> torch.Tensor:
    """x^(2^252 - 3) -- the RFC 8032 decompression square-root exponent
    ((p-5)/8) -- via the 2^k-1 addition-chain ladder: 251 squarings + 11
    multiplies, in the JAX module's order."""
    t0 = square(x)            # x^2
    t1 = _square_n(t0, 2)     # x^8
    t1 = mul(x, t1)           # x^9
    t0 = mul(t0, t1)          # x^11
    t0 = square(t0)           # x^22
    t0 = mul(t1, t0)          # x^31   = x^(2^5 - 1)
    t1 = _square_n(t0, 5)
    t0 = mul(t1, t0)          # 2^10 - 1
    t1 = _square_n(t0, 10)
    t1 = mul(t1, t0)          # 2^20 - 1
    t2 = _square_n(t1, 20)
    t1 = mul(t2, t1)          # 2^40 - 1
    t1 = _square_n(t1, 10)
    t0 = mul(t1, t0)          # 2^50 - 1
    t1 = _square_n(t0, 50)
    t1 = mul(t1, t0)          # 2^100 - 1
    t2 = _square_n(t1, 100)
    t1 = mul(t2, t1)          # 2^200 - 1
    t1 = _square_n(t1, 50)
    t0 = mul(t1, t0)          # 2^250 - 1
    t0 = _square_n(t0, 2)     # 2^252 - 4
    return mul(x, t0)         # 2^252 - 3


def bytes_lt_p(y_bytes: torch.Tensor) -> torch.Tensor:
    """Canonical-range check ``y < p`` over ``(32, batch)`` little-endian
    byte rows."""
    return lt_bytes(
        y_bytes.to(torch.int32), torch.from_numpy(P_BYTES_LE.astype(np.int32))
    )


__all__ = [
    "LIMBS",
    "LIMB_BITS",
    "P",
    "P_BYTES_LE",
    "bytes_lt_p",
    "D",
    "D2",
    "SQRT_M1",
    "FOLD",
    "int_to_limbs",
    "limbs_to_int",
    "constant_like",
    "add",
    "add_raw",
    "sub",
    "sub_raw",
    "mul",
    "square",
    "freeze",
    "eq",
    "is_zero",
    "select",
    "pow_const",
    "pow_2_252_m3",
    "invert",
]
