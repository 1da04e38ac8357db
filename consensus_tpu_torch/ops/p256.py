"""NIST P-256 group operations on batched limb vectors (torch port of
``consensus_tpu/ops/p256.py``).

Short Weierstrass curve y^2 = x^3 - 3x + b over GF(p256), homogeneous
projective coordinates (X : Y : Z), with the *complete* formulas of
Renes-Costello-Batina 2015, Algorithms 4 (addition, 12M + 2mb) and 6
(doubling, 8M + 3S + 2mb) for a = -3: one branch-free code path valid for
every input, the identity (0 : 1 : 0) and P + P included.  The operation
order is the JAX module's, so both packages return the same limbs.

The variable-base Horner scan [u2]Q, the fixed-base comb [u1]G and the
final check with the on-curve test have their hand-written kernels in
:mod:`consensus_tpu_torch.ops.scan_kernels` (B2, P1 and P2); this module's
functions are the plain versions they are held to.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from consensus_tpu_torch.ops import field_p256 as fp

#: Curve constants (FIPS 186-4 / SEC 2).
B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
GX = 0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
GY = 0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5
#: Group order.
N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551


class Point(NamedTuple):
    """Batched projective point; each field is (32, *batch) float32."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def identity_like(ref: torch.Tensor) -> Point:
    """(0 : 1 : 0) with ``ref``'s shape and device."""
    zero = torch.zeros_like(ref, dtype=torch.float32)
    return Point(x=zero, y=fp.constant_like(1, zero), z=zero)


def base_point_like(ref: torch.Tensor) -> Point:
    return Point(
        x=fp.constant_like(GX, ref),
        y=fp.constant_like(GY, ref),
        z=fp.constant_like(1, ref),
    )


def affine_like(x_limbs: torch.Tensor, y_limbs: torch.Tensor) -> Point:
    return Point(x=x_limbs, y=y_limbs, z=fp.constant_like(1, x_limbs))


def add(p: Point, q: Point) -> Point:
    """RCB15 Algorithm 4 (complete addition, a = -3)."""
    b = fp.constant_like(B, p.x)
    t0 = fp.mul(p.x, q.x)
    t1 = fp.mul(p.y, q.y)
    t2 = fp.mul(p.z, q.z)
    t3 = fp.add(p.x, p.y)
    t4 = fp.add(q.x, q.y)
    t3 = fp.mul(t3, t4)
    t4 = fp.add(t0, t1)
    t3 = fp.sub(t3, t4)
    t4 = fp.add(p.y, p.z)
    t5 = fp.add(q.y, q.z)
    t4 = fp.mul(t4, t5)
    t5 = fp.add(t1, t2)
    t4 = fp.sub(t4, t5)
    x3 = fp.add(p.x, p.z)
    y3 = fp.add(q.x, q.z)
    x3 = fp.mul(x3, y3)
    y3 = fp.add(t0, t2)
    y3 = fp.sub(x3, y3)
    z3 = fp.mul(b, t2)
    x3 = fp.sub(y3, z3)
    z3 = fp.add(x3, x3)
    x3 = fp.add(x3, z3)
    z3 = fp.sub(t1, x3)
    x3 = fp.add(t1, x3)
    y3 = fp.mul(b, y3)
    t1 = fp.add(t2, t2)
    t2 = fp.add(t1, t2)
    y3 = fp.sub(y3, t2)
    y3 = fp.sub(y3, t0)
    t1 = fp.add(y3, y3)
    y3 = fp.add(t1, y3)
    t1 = fp.add(t0, t0)
    t0 = fp.add(t1, t0)
    t0 = fp.sub(t0, t2)
    t1 = fp.mul(t4, y3)
    t2 = fp.mul(t0, y3)
    y3 = fp.mul(x3, z3)
    y3 = fp.add(y3, t2)
    x3 = fp.mul(t3, x3)
    x3 = fp.sub(x3, t1)
    z3 = fp.mul(t4, z3)
    t1 = fp.mul(t3, t0)
    z3 = fp.add(z3, t1)
    return Point(x=x3, y=y3, z=z3)


def double(p: Point) -> Point:
    """RCB15 Algorithm 6 (exception-free doubling, a = -3)."""
    b = fp.constant_like(B, p.x)
    t0 = fp.square(p.x)
    t1 = fp.square(p.y)
    t2 = fp.square(p.z)
    t3 = fp.mul(p.x, p.y)
    t3 = fp.add(t3, t3)
    z3 = fp.mul(p.x, p.z)
    z3 = fp.add(z3, z3)
    y3 = fp.mul(b, t2)
    y3 = fp.sub(y3, z3)
    x3 = fp.add(y3, y3)
    y3 = fp.add(x3, y3)
    x3 = fp.sub(t1, y3)
    y3 = fp.add(t1, y3)
    y3 = fp.mul(x3, y3)
    x3 = fp.mul(x3, t3)
    t3 = fp.add(t2, t2)
    t2 = fp.add(t2, t3)
    z3 = fp.mul(b, z3)
    z3 = fp.sub(z3, t2)
    z3 = fp.sub(z3, t0)
    t3 = fp.add(z3, z3)
    z3 = fp.add(z3, t3)
    t3 = fp.add(t0, t0)
    t0 = fp.add(t3, t0)
    t0 = fp.sub(t0, t2)
    t0 = fp.mul(t0, z3)
    y3 = fp.add(y3, t0)
    t0 = fp.mul(p.y, p.z)
    t0 = fp.add(t0, t0)
    z3 = fp.mul(t0, z3)
    x3 = fp.sub(x3, z3)
    z3 = fp.mul(t0, t1)
    z3 = fp.add(z3, z3)
    z3 = fp.add(z3, z3)
    return Point(x=x3, y=y3, z=z3)


def negate(p: Point) -> Point:
    """-(X : Y : Z) = (X : -Y : Z), one field subtraction."""
    return Point(x=p.x, y=fp.sub(torch.zeros_like(p.y), p.y), z=p.z)


def select(cond: torch.Tensor, p: Point, q: Point) -> Point:
    return Point(
        x=fp.select(cond, p.x, q.x),
        y=fp.select(cond, p.y, q.y),
        z=fp.select(cond, p.z, q.z),
    )


def table_lookup(table: Point, one_hot: torch.Tensor) -> Point:
    """table[digit] via a one-hot contraction; coords are (W, 32, *batch),
    ``one_hot`` is (W, *batch) float32.  At the Horner table's W = 9 this
    is cheap, so the plain version keeps the JAX module's form."""
    oh = one_hot[:, None]

    def pick(coord: torch.Tensor) -> torch.Tensor:
        return torch.sum(coord * oh, dim=0)

    return Point(x=pick(table.x), y=pick(table.y), z=pick(table.z))


def multiples_table(p: Point, size: int = 16) -> Point:
    """j*p for j = 0..size-1, coords stacked on a leading axis (identity
    first), built by sequential complete adds of p."""
    entries = [identity_like(p.x), p]
    for _ in range(size - 2):
        entries.append(add(entries[-1], p))
    return Point(*(torch.stack([getattr(q, c) for q in entries]) for c in Point._fields))


def _add_int(p1, p2):
    """Host-side affine integer point add (None = identity) for the constant
    table."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and (y1 + y2) % fp.P == 0:
        return None
    if p1 == p2:
        lam = (3 * x1 * x1 - 3) * pow(2 * y1, fp.P - 2, fp.P) % fp.P
    else:
        lam = (y2 - y1) * pow(x2 - x1, fp.P - 2, fp.P) % fp.P
    x3 = (lam * lam - x1 - x2) % fp.P
    return x3, (lam * (x1 - x3) - y1) % fp.P


_COMB_WINDOWS = 32
_COMB_BITS = 8


@functools.lru_cache(maxsize=1)
def _comb_table_np() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fixed-base comb for G: projective (x, y, z) limb arrays of shape
    (32 windows, 256 entries, 32 limbs) with ``T[j][d] = d * 2^(8j) * G``
    (z = 0 encodes the identity at d = 0).  Pure integer code, built once
    per process, entry for entry the JAX module's table."""
    xs = np.zeros((_COMB_WINDOWS, 1 << _COMB_BITS, fp.LIMBS), dtype=np.float32)
    ys = np.zeros_like(xs)
    zs = np.zeros_like(xs)
    window_base = (GX, GY)  # 2^(8j) * G
    for j in range(_COMB_WINDOWS):
        entry = None
        for d in range(1 << _COMB_BITS):
            if entry is None:
                ys[j, d] = fp.int_to_limbs(1)  # (0 : 1 : 0)
            else:
                xs[j, d] = fp.int_to_limbs(entry[0])
                ys[j, d] = fp.int_to_limbs(entry[1])
                zs[j, d] = fp.int_to_limbs(1)
            entry = _add_int(entry, window_base)
        for _ in range(_COMB_BITS):
            window_base = _add_int(window_base, window_base)
    return xs, ys, zs


@functools.lru_cache(maxsize=None)
def comb_table(device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The comb table's (x, y, z) coordinates on ``device``, each
    (32 windows, 256 entries, 32 limbs) float32, built once per device."""
    return tuple(
        torch.from_numpy(arr).to(torch.device(device)) for arr in _comb_table_np()
    )


def fixed_base_mul_comb(digits8: torch.Tensor) -> Point:
    """[u]G from 8-bit window digits ``digits8`` of shape (32, batch), LSB
    window first: one constant-table lookup and one complete add per
    window, zero doubles.

    The lookup is an index gather ``table[j][d]``.  The JAX module's
    one-hot contraction over 256 entries is MXU work on the TPU; in eager
    torch it would materialize 256 x 32 x batch floats per coordinate and
    window.  The gather returns the same exact entries."""
    xs, ys, zs = comb_table(digits8.device)
    digits = digits8.to(torch.int64)
    acc = identity_like(digits8.to(torch.float32))
    for j in range(_COMB_WINDOWS):
        d = digits[j]

        def pick(tbl: torch.Tensor) -> torch.Tensor:
            return tbl[j].index_select(0, d).T  # (32, batch)

        acc = add(acc, Point(x=pick(xs), y=pick(ys), z=pick(zs)))
    return acc


def on_curve(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y^2 == x^3 - 3x + b (affine check for parsed public keys)."""
    lhs = fp.square(y)
    x3 = fp.mul(fp.square(x), x)
    rhs = fp.add(fp.sub(x3, fp.mul_small(x, 3)), fp.constant_like(B, x))
    return fp.eq(lhs, rhs)


__all__ = [
    "Point",
    "B",
    "GX",
    "GY",
    "N",
    "identity_like",
    "base_point_like",
    "affine_like",
    "add",
    "double",
    "negate",
    "select",
    "table_lookup",
    "multiples_table",
    "comb_table",
    "fixed_base_mul_comb",
    "on_curve",
]
