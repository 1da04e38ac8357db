"""Parity of the port's P-256 point formulas with the JAX package.

The same points -- multiples of G, the identity, an off-curve point and a
point with negative weak limbs -- go through ``consensus_tpu.ops.p256`` (JAX,
on the CPU) and ``consensus_tpu_torch.ops.p256`` (torch, on the CPU); every
coordinate is compared limb for limb (tolerance 0), and the results against
integer affine arithmetic.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from consensus_tpu.ops import field_p256 as jfp
from consensus_tpu.ops import p256 as jp
from consensus_tpu_torch.ops import field_p256 as tfp
from consensus_tpu_torch.ops import p256 as tp

P = jfp.P
LANES = 8


def _multiples(n):
    pts, cur = [], (tp.GX, tp.GY)
    for _ in range(n):
        pts.append(cur)
        cur = tp._add_int(cur, (tp.GX, tp.GY))
    return pts


def _weaken(arr: np.ndarray) -> np.ndarray:
    arr = arr.copy()
    for i in range(31):
        move = (arr[i] >= 172).astype(np.float32)
        arr[i] -= 256 * move
        arr[i + 1] += move
    return arr


def _point_arrays(pts) -> list[np.ndarray]:
    """Affine (x, y) pairs -> (32, n) X, Y, Z limb arrays; None is (0 : 1 : 0)."""
    xs = [0 if p is None else p[0] for p in pts]
    ys = [1 if p is None else p[1] for p in pts]
    zs = [0 if p is None else 1 for p in pts]
    return [np.stack([tfp.int_to_limbs(v) for v in col], axis=1) for col in (xs, ys, zs)]


@pytest.fixture(scope="module")
def points():
    """Two batches of LANES points: P holds kG for k = 1..5, the identity,
    an off-curve point and 3G in negative weak limbs; Q holds the same
    multiples shifted, so P + Q covers P == Q, P == -Q and the identity."""
    g = _multiples(8)
    p = g[:5] + [None, (5, 7), g[2]]
    q = [g[0], g[3], g[2], g[3], g[0], g[1], g[1], None]
    p_arr = _point_arrays(p)
    for c in p_arr:
        c[:, 7:] = _weaken(c[:, 7:])
    q[1] = (g[1][0], P - g[1][1])  # 2G + (-2G): the identity
    q[3] = (g[2][0], P - g[2][1])  # 4G + (-3G)
    q_arr = _point_arrays(q)
    return p, q, p_arr, q_arr


def _torch(arrs) -> list[torch.Tensor]:
    return [torch.from_numpy(a.copy()) for a in arrs]


def _both(arrs):
    return jp.Point(*(jnp.asarray(a) for a in arrs)), tp.Point(*_torch(arrs))


def _same(jpt, tpt):
    for name, j, t in zip("xyz", jpt, tpt):
        j, t = np.asarray(j), t.numpy()
        assert j.shape == t.shape and np.array_equal(j, t), (name, np.argwhere(j != t)[:8])


def _affine(pt: tp.Point, lane: int):
    x, y, z = (tfp.limbs_to_int(tfp.freeze(c[:, lane : lane + 1])[:, 0]) for c in pt)
    if z == 0:
        return None
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


def test_add_double_negate_match_jax(points):
    p, q, p_arr, q_arr = points
    (jpp, tpp), (jqq, tqq) = _both(p_arr), _both(q_arr)
    t_add = tp.add(tpp, tqq)
    _same(jp.add(jpp, jqq), t_add)
    t_dbl = tp.double(tpp)
    _same(jp.double(jpp), t_dbl)
    _same(jp.negate(jpp), tp.negate(tpp))
    for lane in range(LANES):
        if lane == 6:
            continue  # off the curve: the formulas still agree limb for limb
        assert _affine(t_add, lane) == tp._add_int(p[lane], q[lane]), lane
        assert _affine(t_dbl, lane) == tp._add_int(p[lane], p[lane]), lane
    cond = np.arange(LANES) % 2 == 0
    _same(jp.select(jnp.asarray(cond), jpp, jqq), tp.select(torch.from_numpy(cond), tpp, tqq))


def test_constructors_match_jax(points):
    ref_j, ref_t = jnp.zeros((32, LANES), jnp.float32), torch.zeros(32, LANES)
    _same(jp.identity_like(ref_j), tp.identity_like(ref_t))
    _same(jp.base_point_like(ref_j), tuple(c.contiguous() for c in tp.base_point_like(ref_t)))
    _, _, p_arr, _ = points
    _same(
        jp.affine_like(jnp.asarray(p_arr[0]), jnp.asarray(p_arr[1])),
        tuple(c.contiguous() for c in tp.affine_like(*_torch(p_arr[:2]))),
    )
    assert (tp.B, tp.GX, tp.GY, tp.N) == (jp.B, jp.GX, jp.GY, jp.N)


def test_multiples_table_and_lookup_match_jax(points):
    _, _, p_arr, _ = points
    coords = [c[:, :5] for c in p_arr[:2]]
    jq = jp.affine_like(*(jnp.asarray(c) for c in coords))
    tq = tp.affine_like(*_torch(coords))
    jt = jax.jit(lambda x, y: jp.multiples_table(jp.affine_like(x, y), 9))(jq.x, jq.y)
    tt = tp.multiples_table(tq, 9)
    _same(jt, tt)
    digits = np.array([0, 3, 8, 5, 1])
    one_hot = (digits[None] == np.arange(9)[:, None]).astype(np.float32)
    _same(
        jp.table_lookup(jt, jnp.asarray(one_hot)),
        tp.table_lookup(tt, torch.from_numpy(one_hot)),
    )


def test_on_curve_matches_jax(points):
    _, _, p_arr, _ = points
    x, y = p_arr[0], p_arr[1]
    got = tp.on_curve(torch.from_numpy(x.copy()), torch.from_numpy(y.copy()))
    want = np.asarray(jp.on_curve(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(got.numpy(), want)
    # Lanes 5 (the identity's (0, 1)) and 6 are off the curve, the rest on it.
    assert got.tolist() == [True] * 5 + [False, False, True]


def test_comb_table_is_bit_identical():
    for j_arr, t_arr in zip(jp._comb_table_np(), tp._comb_table_np()):
        assert j_arr.dtype == t_arr.dtype and np.array_equal(j_arr, t_arr)


def test_fixed_base_comb_matches_jax_and_bigint():
    rng = np.random.default_rng(5)
    scalars = [0, 1, 255, 256, tp.N - 1] + [
        int.from_bytes(rng.bytes(32), "big") % tp.N for _ in range(3)
    ]
    digits = np.stack(
        [np.frombuffer(s.to_bytes(32, "little"), dtype=np.uint8) for s in scalars], axis=1
    ).astype(np.int32)
    got = tp.fixed_base_mul_comb(torch.from_numpy(digits.copy()))
    _same(jax.jit(jp.fixed_base_mul_comb)(jnp.asarray(digits)), got)
    for lane, k in enumerate(scalars):
        want, base = None, (tp.GX, tp.GY)
        while k:
            if k & 1:
                want = tp._add_int(want, base)
            base = tp._add_int(base, base)
            k >>= 1
        assert _affine(got, lane) == want, lane
