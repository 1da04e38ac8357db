"""GF(p256) arithmetic as batched torch float32 limb vectors, where
p256 = 2^256 - 2^224 + 2^192 + 2^96 - 1 (the NIST P-256 prime).

Torch port of ``consensus_tpu/ops/field_p256.py``, on the same layout so the
two agree limb for limb: 32 x 8-bit limbs in float32, shape ``(32, *batch)``,
limbs leading and batch trailing, every product and column sum an exact
integer inside f32's 24-bit window.  p256 is a Solinas prime, so the high
half of a product folds through FIPS 186-4 D.2.3's word assembly, which is
linear in the limbs and so one constant (32, 64) matrix (``_solinas_matrix``).
On the card the hot loop runs in the hand-written kernel
(``csrc/horner_scan_p256.cu``, its own radix); this module is the plain
version around it.

Normalization contract (unchanged from the JAX module): public ops take and
return *weakly reduced* elements -- |limb| <= 600, value exact mod p and
|value| < 2^262 -- multiplication-safe (600^2 * 32 < 2^24).  ``freeze``
produces the canonical int32 representative in [0, p).

``add``/``sub``, ``mul``, ``square`` and the reduction's Solinas product
note themselves in the field-operation counting shim
(:mod:`consensus_tpu_torch.ops.limbs`) at the JAX module's sites.  ``mul``
and ``square`` take the tensor-core lane
(:mod:`consensus_tpu_torch.ops.mxu_limbs`) when it is active, before their
note, as the JAX module does.

The Solinas product is taken in float64, where its integer sums cannot
round whatever ``torch.backends.cuda.matmul.allow_tf32`` or
``torch.set_float32_matmul_precision`` say (the JAX module forces
``Precision.HIGHEST`` for the same reason).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from consensus_tpu_torch.ops import limbs, mxu_limbs
from consensus_tpu_torch.ops.limbs import carry_i32

LIMBS = 32
LIMB_BITS = 8
BASE = 256.0
INV_BASE = 1.0 / 256.0

P = 2**256 - 2**224 + 2**192 + 2**96 - 1

#: 2^256 mod p as a signed byte pattern: +1 at byte 0, -1 at byte 12,
#: -1 at byte 24, +1 at byte 28.
_FOLD_PATTERN: tuple[tuple[int, int], ...] = ((0, 1), (12, -1), (24, -1), (28, 1))
assert sum(s * (1 << (8 * pos)) for pos, s in _FOLD_PATTERN) == (2**256) % P


def int_to_limbs(value: int) -> np.ndarray:
    """Python int in [0, 2^256) -> one limb vector (numpy)."""
    if not 0 <= value < 2**256:
        raise ValueError("value out of limb range")
    return np.array(
        [(value >> (LIMB_BITS * i)) & 0xFF for i in range(LIMBS)], dtype=np.float32
    )


def limbs_to_int(limbs) -> int:
    """Limb vector (limbs axis first, signed limbs allowed) -> Python int."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    arr = np.asarray(limbs, dtype=np.int64)
    return sum(int(arr[i]) << (LIMB_BITS * i) for i in range(LIMBS))


def _cexpand(const: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Reshape a (32,) constant so it broadcasts against (32, *batch)."""
    return const.reshape((LIMBS,) + (1,) * (like.dim() - 1))


@functools.lru_cache(maxsize=None)
def _limb_const(value: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(int_to_limbs(value)).to(device=device, dtype=dtype)


def constant_like(value: int, like: torch.Tensor) -> torch.Tensor:
    """``value mod p`` broadcast to ``like``'s shape and device (a read-only
    expanded view; no op here writes in place)."""
    c = _limb_const(value % P, like.device, torch.float32)
    return _cexpand(c, like).expand(like.shape)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (x mod 256, floor(x / 256)); exact for |x| < 2^24, floor
    semantics so negative limbs borrow correctly (the JAX module's
    ``x - floor(x / 256) * 256`` as two ops)."""
    return torch.remainder(x, BASE), torch.div(x, BASE, rounding_mode="floor")


def _solinas_matrix() -> np.ndarray:
    """FIPS 186-4 D.2.3's word assembly for P-256, ``s1 + 2 s2 + 2 s3 + s4 +
    s5 - s6 - s7 - s8 - s9``, as one (32, 64) signed matrix over the 64
    8-bit limbs of a double-width value; built from the word-group
    definition, as in the JAX module."""
    x = np.eye(64, dtype=np.float64)

    def word(i):
        return x[4 * i : 4 * i + 4]

    zero4 = np.zeros((4, 64))

    def assemble(words):
        return np.concatenate(words, axis=0)

    s1 = x[:LIMBS]
    s2 = assemble([zero4, zero4, zero4, word(11), word(12), word(13), word(14), word(15)])
    s3 = assemble([zero4, zero4, zero4, word(12), word(13), word(14), word(15), zero4])
    s4 = assemble([word(8), word(9), word(10), zero4, zero4, zero4, word(14), word(15)])
    s5 = assemble([word(9), word(10), word(11), word(13), word(14), word(15), word(13), word(8)])
    s6 = assemble([word(11), word(12), word(13), zero4, zero4, zero4, word(8), word(10)])
    s7 = assemble([word(12), word(13), word(14), word(15), zero4, zero4, word(9), word(11)])
    s8 = assemble([word(13), word(14), word(15), word(8), word(9), word(10), zero4, word(12)])
    s9 = assemble([word(14), word(15), zero4, word(9), word(10), word(11), zero4, word(13)])
    m = s1 + 2.0 * s2 + 2.0 * s3 + s4 + s5 - s6 - s7 - s8 - s9
    assert np.abs(m).max() <= 4
    return m.astype(np.float32)


_SOLINAS_M = _solinas_matrix()


def _solinas_split(width: int) -> np.ndarray:
    """``_SOLINAS_M`` applied to the carry-save split of a ``width``-limb
    value: the low parts sit at limbs 0..width-1 and the high parts one limb
    up, so ``M @ ([lo; 0] + [0; hi]) == [M[:, :width] | M[:, 1:width+1]] @
    [lo; hi]`` -- one product for the JAX module's pad, add and tensordot."""
    return np.concatenate([_SOLINAS_M[:, :width], _SOLINAS_M[:, 1 : width + 1]], axis=1)


#: The fold pattern as a (32, 1) column, so a round adds ``pattern * top``.
_FOLD_VEC = np.zeros((LIMBS, 1), dtype=np.float32)
for _pos, _sign in _FOLD_PATTERN:
    _FOLD_VEC[_pos] = _sign


def _reduce_wide(x: torch.Tensor) -> torch.Tensor:
    """Reduce a wide (<= 63 limb) signed vector to 32 weakly reduced limbs.

    The JAX module's steps: one carry-save pass (|limb| < 2^16.1), the
    Solinas matrix product (|r| < 2^20), then two light rounds of carry-save
    plus a fold of the single overflow limb through the 2^256 pattern.  All
    of it is exact integer arithmetic, so the limbs equal the JAX module's;
    the matrix product runs in float64, where no matmul precision setting
    can round it."""
    width = x.shape[0]
    if width > 2 * LIMBS - 1:
        raise ValueError(f"input too wide: {width}")
    batch_shape = x.shape[1:]
    lo, hi = _split(x.reshape(width, -1))
    split = _const(f"split{width}", x.device, torch.float64)
    r = torch.matmul(split, torch.cat([lo, hi]).to(torch.float64)).to(torch.float32)
    if limbs.counting():
        limbs.note_dot(LIMBS, 1, 2 * LIMBS, limbs.lanes_of(x))
    fold = _const("fold", x.device, torch.float32)
    for _ in range(2):
        lo, hi = _split(r)
        # lo + hi shifted up one limb, and hi[31] (the overflow limb)
        # folded back through the 2^256 pattern.
        r = torch.addcmul(lo + F.pad(hi[:-1], (0, 0, 1, 0)), fold, hi[-1:])
    return r.reshape((LIMBS, *batch_shape))


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if limbs.counting():
        limbs.note_add(limbs.lanes_of(a, b))
    return _reduce_wide(a + b)


def _bias_limbs() -> np.ndarray:
    """128 p, a multiple of p above 2^262, as 32 signed limbs with
    |limb| <= 300 (greedy balanced digits, the top folded through the
    Solinas pattern), exactly as the JAX module builds it."""
    m = 128 * P
    digits = []
    carry = 0
    v = m
    for _ in range(LIMBS):
        d = (v & 0xFF) + carry
        v >>= 8
        carry = 0
        if d > 128:
            d -= 256
            carry = 1
        digits.append(d)
    top = v + carry
    for pos, sign in _FOLD_PATTERN:
        digits[pos] += sign * top
    arr = np.array(digits, dtype=np.float32)
    assert limbs_to_int(arr) % P == 0
    return arr


@functools.lru_cache(maxsize=1)
def _get_bias() -> np.ndarray:
    return _bias_limbs()


_P_LIMBS = int_to_limbs(P)


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A constant array of this module on ``device`` in ``dtype``, built
    once per device and dtype."""
    if name.startswith("split"):
        arr = _solinas_split(int(name[5:]))
    else:
        arr = {"fold": _FOLD_VEC, "bias": _get_bias(), "p": _P_LIMBS}[name]
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b, biased by 128 p so the value stays positive for any weakly
    reduced operands."""
    if limbs.counting():
        limbs.note_add(limbs.lanes_of(a, b))
    return _reduce_wide(a + _cexpand(_const("bias", a.device, torch.float32), a) - b)


def _columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 63 schoolbook columns of a * b, by the skew trick of the
    Ed25519 field: pad each row of the 32 x 32 outer product to 64 entries,
    flatten, and re-read as rows of 63, so entry (i, j) lands in column
    i + j.  Every term and partial sum is an integer below 2^24, so the
    sums equal the JAX module's shifted adds in any order."""
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
    return cols.reshape((2 * LIMBS - 1, *batch_shape))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product, then the Solinas fold (``mxu_limbs.mul_p256``,
    bit-identical, under the tensor-core lane)."""
    if mxu_limbs.lane_active():
        return mxu_limbs.mul_p256(a, b)
    if limbs.counting():
        limbs.note_mul(limbs.lanes_of(a, b))
    return _reduce_wide(_columns(a, b))


def square(a: torch.Tensor) -> torch.Tensor:
    """Squaring.  The JAX module sums the doubled upper triangle; the full
    product's columns are the same integers, so ``mul(a, a)`` returns the
    same limbs.  It notes one squaring in the counting shim, as the JAX
    module does, and no mul.  Under the tensor-core lane it is
    ``mxu_limbs.square_p256``."""
    if mxu_limbs.lane_active():
        return mxu_limbs.square_p256(a)
    if limbs.counting():
        limbs.note_square(limbs.lanes_of(a))
    return _reduce_wide(_columns(a, a))


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * k for small positive k (<= 64)."""
    return _reduce_wide(a * float(k))


def freeze(a: torch.Tensor) -> torch.Tensor:
    """Canonical int32 representative in [0, p).

    Bias by 128 p, carry exactly, fold the top carry through the Solinas
    pattern twice, then subtract p while the value still exceeds it (at
    most three rounds), as the JAX module does."""
    x = torch.round(a).to(torch.int32)
    x = x + _cexpand(_const("bias", a.device, torch.int32), a)
    for _ in range(2):
        x, carry = carry_i32(x, LIMB_BITS)
        for pos, sign in _FOLD_PATTERN:
            x[pos] += sign * carry
    p_e = _cexpand(_const("p", a.device, torch.int32), a)
    for _ in range(3):
        d, carry = carry_i32(x - p_e, LIMB_BITS)
        ge_p = carry == 0
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


__all__ = [
    "LIMBS",
    "P",
    "int_to_limbs",
    "limbs_to_int",
    "constant_like",
    "add",
    "sub",
    "mul",
    "square",
    "mul_small",
    "freeze",
    "eq",
    "is_zero",
    "select",
]
