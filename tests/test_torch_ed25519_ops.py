"""Parity of the port's edwards25519 formulas with the JAX package.

Mirrors ``TestPoints`` of tests/test_crypto.py: numpy-seeded points and
scalars go through ``consensus_tpu.ops.ed25519`` (JAX, CPU) and
``consensus_tpu_torch.ops.ed25519`` (torch, CPU).  Both sides use the f32
8-bit-limb layout, so outputs are compared limb for limb (exact).
"""

import numpy as np
import torch

import jax.numpy as jnp

from consensus_tpu.ops import ed25519 as jed
from consensus_tpu.ops import field25519 as jfe
from consensus_tpu_torch.ops import ed25519 as ted
from consensus_tpu_torch.ops import field25519 as tfe

P = jfe.P
N = 8


def _same(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert j.shape == t.shape and j.dtype == t.dtype, (j.shape, t.shape, j.dtype, t.dtype)
    assert np.array_equal(j, t), np.argwhere(j != t)[:8]


def _same_point(jp, tp):
    for j, t in zip(jp, tp):
        _same(j, t)


def _decompressed(seed=3, n=N):
    """Random compressed y's (some off the curve) through both packages."""
    rng = np.random.default_rng(seed)
    ys = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n - 2)] + [ted._BY, 1]
    y = np.stack([jfe.int_to_limbs(v) for v in ys], axis=1)
    sign = rng.integers(0, 2, n).astype(np.int32)
    sign[-2:] = 0
    jp, jok = jed.decompress(jnp.asarray(y), jnp.asarray(sign))
    tp, tok = ted.decompress(torch.from_numpy(y.copy()), torch.from_numpy(sign.copy()))
    return (jp, jok), (tp, tok)


def _valid_points(seed=5, n=N):
    """n on-curve points j*B (j = 1..n) as ((jax Point), (torch Point))."""
    pts, cur = [], (ted._BX, ted._BY)
    for _ in range(n):
        pts.append(cur)
        cur = ted._edwards_add_int(cur, (ted._BX, ted._BY))
    coords = [
        np.stack([jfe.int_to_limbs(c) for c in col], axis=1)
        for col in (
            [x for x, _ in pts], [y for _, y in pts], [1] * n, [x * y % P for x, y in pts]
        )
    ]
    return (
        jed.Point(*(jnp.asarray(c) for c in coords)),
        ted.Point(*(torch.from_numpy(c.copy()) for c in coords)),
    )


class TestPoints:
    def test_decompress_matches_jax_with_validity_mask(self):
        (jp, jok), (tp, tok) = _decompressed()
        _same(jok, tok)
        _same_point(jp, tp)
        assert tok[-2:].all()  # the base point and the identity decode
        assert not tok.all()   # random y's include off-curve ones

    def test_decompress_base_point_and_rejects_non_square(self):
        y = np.stack([jfe.int_to_limbs(v) for v in (ted._BY, 2)], axis=1)
        tp, tok = ted.decompress(torch.from_numpy(y), torch.tensor([0, 0], dtype=torch.int32))
        assert tok.tolist() == [True, False]
        assert tfe.limbs_to_int(tfe.freeze(tp.x)[:, 0]) == ted._BX

    def test_add_double_negate_select_equal(self):
        jp, tp = _valid_points()
        jq, tq = jed.negate(jed.double(jp)), ted.negate(ted.double(tp))
        _same_point(jq, tq)
        _same_point(jed.add(jp, jq), ted.add(tp, tq))
        _same_point(jed.double(jp), ted.double(tp))
        _same_point(jed.double(jp, need_t=False), ted.double(tp, need_t=False))
        cond = np.array([True, False] * (N // 2))
        _same_point(
            jed.select(jnp.asarray(cond), jp, jq),
            ted.select(torch.from_numpy(cond), tp, tq),
        )
        # 2P via double and via add agree projectively; P + (-P) is the identity.
        assert ted.equal(ted.double(tp), ted.add(tp, tp)).all()
        _same(jed.equal(jed.double(jp), jed.add(jp, jp)), ted.equal(ted.double(tp), ted.add(tp, tp)))
        assert ted.is_identity(ted.add(tp, ted.negate(tp))).all()
        assert not ted.is_identity(tp).any()
        _same(jed.is_identity(jed.add(jp, jed.negate(jp))), ted.is_identity(ted.add(tp, ted.negate(tp))))

    def test_identity_is_neutral(self):
        jp, tp = _valid_points()
        _same_point(jed.add(jp, jed.identity_like(jp.x)), ted.add(tp, ted.identity_like(tp.x)))
        assert ted.equal(ted.add(tp, ted.identity_like(tp.x)), tp).all()

    def test_multiples_table_and_table_lookup(self):
        jp, tp = _valid_points(n=4)
        jt, tt = jed.multiples_table(jp, 9), ted.multiples_table(tp, 9)
        _same_point(jt, tt)
        idx = np.array([0, 8, 3, 5])
        one_hot = (np.arange(9)[:, None] == idx[None]).astype(np.float32)
        _same_point(
            jed.table_lookup(jt, jnp.asarray(one_hot)),
            ted.table_lookup(tt, torch.from_numpy(one_hot)),
        )

    def test_comb_table_equals_jax(self):
        for j, t in zip(jed._comb_table_np(), ted.comb_table(torch.device("cpu"))):
            assert t.dtype == torch.float32 and t.shape == (32, 256, 32)
            np.testing.assert_array_equal(j, t.numpy())

    def test_fixed_base_mul_comb_and_add_affine(self):
        rng = np.random.default_rng(11)
        digits = rng.integers(0, 256, size=(32, N)).astype(np.uint8)
        digits[:, 0] = 0  # scalar 0 -> identity
        jc = jed.fixed_base_mul_comb(jnp.asarray(digits.astype(np.int32)))
        tc = ted.fixed_base_mul_comb(torch.from_numpy(digits))
        _same_point(jc, tc)
        assert ted.is_identity(ted.Point(*(c[:, :1] for c in tc))).all()
        # Against big-int scalar multiplication of the base point.
        from consensus_tpu_torch.models.ed25519 import _BASE_POINT, _ref_mul

        for lane in (1, N - 1):
            s = sum(int(digits[w, lane]) << (8 * w) for w in range(32))
            x, y, z, _ = _ref_mul(s, _BASE_POINT)
            zi = pow(z, P - 2, P)
            fz = tfe.freeze(tc.z[:, lane : lane + 1])
            zinv = pow(tfe.limbs_to_int(fz[:, 0]), P - 2, P)
            got_x = tfe.limbs_to_int(tfe.freeze(tc.x[:, lane : lane + 1])[:, 0]) * zinv % P
            got_y = tfe.limbs_to_int(tfe.freeze(tc.y[:, lane : lane + 1])[:, 0]) * zinv % P
            assert (got_x, got_y) == (x * zi % P, y * zi % P)
        jp, tp = _valid_points()
        xs, ys, ts = ted._comb_table_np()
        qx, qy, qt = (np.ascontiguousarray(a[3, 17 : 17 + N].T) for a in (xs, ys, ts))
        _same_point(
            jed.add_affine(jp, jnp.asarray(qx), jnp.asarray(qy), jnp.asarray(qt)),
            ted.add_affine(tp, *(torch.from_numpy(a) for a in (qx, qy, qt))),
        )
