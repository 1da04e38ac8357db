"""edwards25519 group operations on batched limb vectors (torch port of
``consensus_tpu/ops/ed25519.py``).

Extended homogeneous coordinates (X : Y : Z : T) with x = X/Z, y = Y/Z,
T = XY/Z on the a = -1 twisted Edwards curve -x^2 + y^2 = 1 + d x^2 y^2.
Formulas: add-2008-hwcd-3 (8M) and dbl-2008-hwcd (4M + 4S), complete for
this curve, in the JAX module's exact operation order so both packages
return the same limbs.

Decompression (RFC 8032 section 5.1.3), the fixed-base comb [S]B and the
shared-doubling Straus MSM of the randomized verifier run here as plain
torch; the variable-base Horner scan and the MSM have their hand-written
kernels in :mod:`consensus_tpu_torch.ops.scan_kernels`.  The JAX module's
``lax.scan`` loops are Python loops here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from consensus_tpu_torch.ops import field25519 as fe

# Base point of edwards25519 (RFC 8032).
_BY = (4 * pow(5, fe.P - 2, fe.P)) % fe.P
_BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202


class Point(NamedTuple):
    """Batched point in extended coordinates; each field is (32, *batch) f32."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


def identity_like(ref: torch.Tensor) -> Point:
    """Identity point with ``ref``'s (32, *batch) shape and device."""
    zero = torch.zeros_like(ref, dtype=torch.float32)
    one = fe.constant_like(1, zero)
    return Point(x=zero, y=one, z=one, t=zero)


def negate(p: Point) -> Point:
    zero = torch.zeros_like(p.x)
    return Point(x=fe.sub(zero, p.x), y=p.y, z=p.z, t=fe.sub(zero, p.t))


_D2 = fe.D2


def add(p: Point, q: Point) -> Point:
    """add-2008-hwcd-3: 8M + 1 constant mul, one raw add/sub level feeding
    each multiply (inside the 2^19 operand budget)."""
    a = fe.mul(fe.sub_raw(p.y, p.x), fe.sub_raw(q.y, q.x))
    b = fe.mul(fe.add_raw(p.y, p.x), fe.add_raw(q.y, q.x))
    c = fe.mul(fe.mul(p.t, fe.constant_like(_D2, p.t)), q.t)
    d = fe.mul(fe.add_raw(p.z, p.z), q.z)
    e = fe.sub_raw(b, a)
    f = fe.sub_raw(d, c)
    g = fe.add_raw(d, c)
    h = fe.add_raw(b, a)
    return Point(x=fe.mul(e, f), y=fe.mul(g, h), z=fe.mul(f, g), t=fe.mul(e, h))


def double(p: Point, *, need_t: bool = True) -> Point:
    """dbl-2008-hwcd: 4M + 4S (3M + 4S with ``need_t=False`` -- doubling
    never reads T, so runs of doubles skip producing it)."""
    a = fe.square(p.x)
    b = fe.square(p.y)
    zz = fe.square(p.z)
    c = fe.add_raw(zz, zz)          # <= 680
    h = fe.add_raw(a, b)            # <= 680
    xy = fe.add_raw(p.x, p.y)       # <= 680
    e = fe.sub(h, fe.mul(xy, xy))   # reduced: raw h - weak square
    g = fe.sub_raw(a, b)            # <= 600
    f = fe.add(c, g)                # reduced: 680 + 600 would exceed 724
    t = fe.mul(e, h) if need_t else p.t
    return Point(x=fe.mul(e, f), y=fe.mul(g, h), z=fe.mul(f, g), t=t)


def select(cond: torch.Tensor, p: Point, q: Point) -> Point:
    """Per-element point select (cond shape = batch)."""
    return Point(
        x=fe.select(cond, p.x, q.x),
        y=fe.select(cond, p.y, q.y),
        z=fe.select(cond, p.z, q.z),
        t=fe.select(cond, p.t, q.t),
    )


def decompress(y_limbs: torch.Tensor, sign: torch.Tensor) -> tuple[Point, torch.Tensor]:
    """Recover (x, y) from a compressed point's y limbs + x sign bit.

    Returns (point with Z=1, valid mask).  RFC 8032 section 5.1.3:
    x^2 = (y^2-1) / (d y^2 + 1); candidate root x = u v^3 (u v^7)^((p-5)/8),
    fixed up by sqrt(-1) when v x^2 == -u, rejected when neither matches."""
    one = fe.constant_like(1, y_limbs)
    y2 = fe.square(y_limbs)
    u = fe.sub(y2, one)
    v = fe.add(fe.mul(fe.constant_like(fe.D, y_limbs), y2), one)

    v3 = fe.mul(fe.square(v), v)
    v7 = fe.mul(fe.square(v3), v)
    x = fe.mul(fe.mul(u, v3), fe.pow_2_252_m3(fe.mul(u, v7)))

    vx2 = fe.mul(v, fe.square(x))
    root_ok = fe.eq(vx2, u)
    zero = torch.zeros_like(u)
    neg_u = fe.sub(zero, u)
    root_neg = fe.eq(vx2, neg_u)
    x_fixed = fe.mul(x, fe.constant_like(fe.SQRT_M1, y_limbs))
    x = fe.select(root_neg, x_fixed, x)
    valid = root_ok | root_neg

    x_frozen = fe.freeze(x)
    x_is_zero = torch.all(x_frozen == 0, dim=0)
    # x = 0 with sign bit set is invalid; u = 0 with x = 0 is the valid y=+-1.
    valid = valid & ~(x_is_zero & (sign == 1))
    # Match the requested sign: x and p - x have opposite parities.
    parity = x_frozen[0] & 1
    x = fe.select((parity != sign) & ~x_is_zero, fe.sub(zero, x), x)

    return Point(x=x, y=y_limbs, z=one, t=fe.mul(x, y_limbs)), valid


def equal(p: Point, q: Point) -> torch.Tensor:
    """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
    return fe.eq(fe.mul(p.x, q.z), fe.mul(q.x, p.z)) & fe.eq(
        fe.mul(p.y, q.z), fe.mul(q.y, p.z)
    )


def is_identity(p: Point) -> torch.Tensor:
    """True where p is the neutral element: X = 0 and Y = Z."""
    return fe.is_zero(p.x) & fe.eq(p.y, p.z)


# --- windowed scalar-mult support -----------------------------------------


def _edwards_add_int(p1, p2):
    """Host-side integer point addition (affine) for constant-table gen."""
    x1, y1 = p1
    x2, y2 = p2
    P_, D_ = fe.P, fe.D
    denom_x = (1 + D_ * x1 * x2 * y1 * y2) % P_
    denom_y = (1 - D_ * x1 * x2 * y1 * y2) % P_
    x3 = (x1 * y2 + x2 * y1) * pow(denom_x, P_ - 2, P_) % P_
    y3 = (y1 * y2 + x1 * x2) * pow(denom_y, P_ - 2, P_) % P_
    return x3, y3


_COMB_WINDOWS = 32
_COMB_BITS = 8


@functools.lru_cache(maxsize=1)
def _comb_table_np() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fixed-base comb: affine (x, y, t=xy) limb arrays of shape
    (32 windows, 256 entries, 32 limbs) with ``T[j][d] = d * 2^(8j) * B``.

    Pure integer code from the base point, built once per process: the
    system's one constant table."""
    xs = np.zeros((_COMB_WINDOWS, 1 << _COMB_BITS, fe.LIMBS), dtype=np.float32)
    ys = np.zeros_like(xs)
    ts = np.zeros_like(xs)
    window_base = (_BX, _BY)  # 2^(8j) * B
    for j in range(_COMB_WINDOWS):
        entry = (0, 1)  # identity
        for d in range(1 << _COMB_BITS):
            x, y = entry
            xs[j, d] = fe.int_to_limbs(x)
            ys[j, d] = fe.int_to_limbs(y)
            ts[j, d] = fe.int_to_limbs(x * y % fe.P)
            entry = _edwards_add_int(entry, window_base)
        for _ in range(_COMB_BITS):
            window_base = _edwards_add_int(window_base, window_base)
    return xs, ys, ts


@functools.lru_cache(maxsize=None)
def comb_table(device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The comb table's (x, y, t) coordinates on ``device``, each
    (32 windows, 256 entries, 32 limbs) float32, built once per device."""
    return tuple(
        torch.from_numpy(arr).to(torch.device(device)) for arr in _comb_table_np()
    )


def add_affine(p: Point, q_x: torch.Tensor, q_y: torch.Tensor, q_t: torch.Tensor) -> Point:
    """Mixed addition p + q with q affine (Z=1, T=XY given): madd-2008-hwcd-3,
    7M + 1 constant mul, same lazy-reduction discipline as :func:`add`."""
    a = fe.mul(fe.sub_raw(p.y, p.x), fe.sub_raw(q_y, q_x))
    b = fe.mul(fe.add_raw(p.y, p.x), fe.add_raw(q_y, q_x))
    c = fe.mul(fe.mul(p.t, fe.constant_like(_D2, p.t)), q_t)
    d = fe.add_raw(p.z, p.z)
    e = fe.sub_raw(b, a)
    f = fe.sub_raw(d, c)
    g = fe.add_raw(d, c)
    h = fe.add_raw(b, a)
    return Point(x=fe.mul(e, f), y=fe.mul(g, h), z=fe.mul(f, g), t=fe.mul(e, h))


def fixed_base_mul_comb(s_digits8: torch.Tensor) -> Point:
    """[S]B from 8-bit window digits ``s_digits8`` of shape (32, batch),
    LSB window first: one constant-table lookup + one mixed add per window,
    zero doubles.

    The lookup is an index gather ``table[j][d]``.  The JAX module's
    one-hot contraction over 256 entries is MXU work on the TPU; in eager
    torch it would materialize 256 x 32 x batch floats per window.  The
    gather returns the same exact entries."""
    xs, ys, ts = comb_table(s_digits8.device)
    digits = s_digits8.to(torch.int64)
    acc = identity_like(s_digits8)
    for j in range(_COMB_WINDOWS):
        d = digits[j]

        def pick(tbl: torch.Tensor) -> torch.Tensor:
            return tbl[j].index_select(0, d).T  # (32, batch)

        acc = add_affine(acc, pick(xs), pick(ys), pick(ts))
    return acc


def table_lookup(table: Point, one_hot: torch.Tensor) -> Point:
    """Select table[digit] per batch element via a one-hot contraction.

    ``table`` coords are (W, 32, *batch); ``one_hot`` is (W, *batch)
    float32.  At the Horner table's W = 9 this is cheap, so the plain
    version keeps the JAX module's form."""
    oh = one_hot[:, None]  # (W, 1, *batch)

    def pick(coord: torch.Tensor) -> torch.Tensor:
        return torch.sum(coord * oh, dim=0)

    return Point(x=pick(table.x), y=pick(table.y), z=pick(table.z), t=pick(table.t))


def multiples_table(p: Point, size: int = 16) -> Point:
    """j*p for j = 0..size-1, coords stacked on a leading axis (identity
    first), built by sequential adds of p."""
    entries = [identity_like(p.x), p]
    for _ in range(size - 2):
        entries.append(add(entries[-1], p))
    return Point(*(torch.stack([getattr(q, c) for q in entries]) for c in Point._fields))


def multiples_table9(p: Point) -> Point:
    """j*p for j = 0..8 (the signed-4-bit window table), laid out like
    ``multiples_table(p, 9)`` but built as the JAX module builds it: even
    multiples by doubling (4p and 6p in one double of (2p, 3p) stacked on a
    trailing entry axis), the odd chain 3p, 5p, 7p by adds of 2p."""
    p2 = double(p)
    odd = []
    prev = p
    for _ in range(3):
        prev = add(prev, p2)
        odd.append(prev)
    p3, p5, p7 = odd
    pair = double(Point(*(torch.stack([a, b], dim=-1) for a, b in zip(p2, p3))))
    p4 = Point(*(c[..., 0] for c in pair))
    p6 = Point(*(c[..., 1] for c in pair))
    p8 = double(p4)
    entries = [identity_like(p.x), p, p2, p3, p4, p5, p6, p7, p8]
    return Point(*(torch.stack([getattr(q, c) for q in entries]) for c in Point._fields))


# --- shared-doubling batch multi-scalar multiplication --------------------


def batch_sum(p: Point) -> Point:
    """Sum a point batch down to batch 1 over the trailing axis: a halving
    tree, one vectorized add over half the remaining lanes per level, an odd
    width carrying its last lane up to the next level."""
    n = p.x.shape[-1]
    while n > 1:
        half = n // 2
        head = add(
            Point(*(c[..., :half] for c in p)), Point(*(c[..., half : 2 * half] for c in p))
        )
        if n % 2:
            p = Point(*(torch.cat([hc, c[..., 2 * half :]], dim=-1) for hc, c in zip(head, p)))
        else:
            p = head
        n = half + (n % 2)
    return p


def _signed_window_contribution(table: Point, digits_row: torch.Tensor) -> Point:
    """Per-lane table[|d|] with the sign of d applied, from one row of
    signed 4-bit digits stored as d + 8 (8 means digit 0: the identity)."""
    lanes = torch.arange(table.x.shape[0], dtype=torch.int32, device=digits_row.device)[:, None]
    d = digits_row.to(torch.int32) - 8
    picked = table_lookup(table, (d.abs()[None] == lanes).to(torch.float32))
    return select(d < 0, negate(picked), picked)


def straus_shared_msm(
    a_table: Point, r_table: Point, zk_digits: torch.Tensor, z_digits: torch.Tensor
) -> Point:
    """sum_i [zk_i]A_i' + sum_i [z_i]R_i' with one doubling chain for the
    whole batch.

    ``a_table``/``r_table`` are (9, 32, batch) multiples tables of the
    (already negated) points; ``zk_digits`` is (64, batch) and ``z_digits``
    (n_low, batch), signed 4-bit digits stored as d + 8, MSB window first.
    The accumulator is one (32, 1) lane: each window doubles it 4 times and
    adds the :func:`batch_sum` of every lane's looked-up contribution.  The
    first 64 - n_low windows read only the A table, the last n_low both."""
    n_low = z_digits.shape[0]
    n_high = zk_digits.shape[0] - n_low
    acc = identity_like(a_table.x[0][..., :1])

    def quad_double(acc: Point) -> Point:
        for _ in range(3):
            acc = double(acc, need_t=False)
        return double(acc)  # the final double materializes T for the add

    for w in range(n_high):
        acc = quad_double(acc)
        acc = add(acc, batch_sum(_signed_window_contribution(a_table, zk_digits[w])))
    for w in range(n_low):
        acc = quad_double(acc)
        contrib = add(
            _signed_window_contribution(a_table, zk_digits[n_high + w]),
            _signed_window_contribution(r_table, z_digits[w]),
        )
        acc = add(acc, batch_sum(contrib))
    return acc


__all__ = [
    "Point",
    "identity_like",
    "negate",
    "add",
    "double",
    "select",
    "decompress",
    "equal",
    "is_identity",
    "table_lookup",
    "multiples_table",
    "multiples_table9",
    "batch_sum",
    "straus_shared_msm",
    "add_affine",
    "comb_table",
    "fixed_base_mul_comb",
]
