"""Parity of the port's GF(2^255-19) limb arithmetic with the JAX package.

Mirrors ``TestField`` and ``TestPowChain`` of tests/test_crypto.py: the
same numpy-seeded operands go through ``consensus_tpu.ops.field25519`` (JAX,
on the CPU) and ``consensus_tpu_torch.ops.field25519`` (torch, on the CPU).
Tolerance is exact: both sides use the f32 8-bit-limb layout, so every
output is compared limb for limb, and against Python big-int arithmetic
after ``freeze``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consensus_tpu.ops import field25519 as jfe
from consensus_tpu.ops import limbs as jlimbs
from consensus_tpu_torch.ops import field25519 as tfe
from consensus_tpu_torch.ops import limbs as tlimbs

P = jfe.P


def _vals(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _limbs(values) -> np.ndarray:
    return np.stack([jfe.int_to_limbs(v) for v in values], axis=1)


def _both(arr: np.ndarray):
    return jnp.asarray(arr), torch.from_numpy(arr.copy())


def _same(j, t):
    """Limb-for-limb equality of a JAX and a torch output."""
    j = np.asarray(j)
    t = t.numpy()
    assert j.shape == t.shape and j.dtype == t.dtype, (j.shape, t.shape, j.dtype, t.dtype)
    assert np.array_equal(j, t), np.argwhere(j != t)[:8]


def _ints(t) -> list[int]:
    frozen = tfe.freeze(t).numpy()
    return [tfe.limbs_to_int(frozen[:, i]) for i in range(frozen.shape[1])]


class TestField:
    def test_mul_add_sub_match_jax_and_bigint(self):
        rng = np.random.default_rng(7)
        a_vals = _vals(rng, 16) + [0, 1, P - 1, P - 19]
        b_vals = _vals(rng, 16) + [P - 1, 0, P - 1, 2]
        (ja, ta), (jb, tb) = _both(_limbs(a_vals)), _both(_limbs(b_vals))
        for name, op in (
            ("mul", lambda x, y: x * y),
            ("add", lambda x, y: x + y),
            ("sub", lambda x, y: x - y),
        ):
            t = getattr(tfe, name)(ta, tb)
            _same(getattr(jfe, name)(ja, jb), t)
            assert _ints(t) == [op(x, y) % P for x, y in zip(a_vals, b_vals)], name

    def test_deep_mul_chain_stays_exact(self):
        rng = np.random.default_rng(9)
        vals = _vals(rng, 4)
        jx, tx = _both(_limbs(vals))
        for _ in range(50):
            jx, tx = jfe.mul(jx, jx), tfe.mul(tx, tx)
            vals = [v * v % P for v in vals]
        _same(jx, tx)
        assert _ints(tx) == vals

    def test_mixed_op_chains_with_borrows(self):
        rng = np.random.default_rng(11)
        (jx, tx), (jy, ty) = _both(_limbs(_vals(rng, 8))), _both(_limbs(_vals(rng, 8)))
        for step in range(60):
            op = step % 3
            if op == 0:
                jx, tx = jfe.sub(jx, jy), tfe.sub(tx, ty)
            elif op == 1:
                jx, tx = jfe.mul(jx, jy), tfe.mul(tx, ty)
            else:
                jy, ty = jfe.sub(jy, jx), tfe.sub(ty, tx)
        _same(jx, tx)
        _same(jy, ty)
        _same(jfe.freeze(jx), tfe.freeze(tx))

    def test_freeze_handles_borrowed_negatives(self):
        (jz, tz), (js, ts) = _both(_limbs([0, 0, 0])), _both(_limbs([1, 19, P - 1]))
        jd, td = jfe.sub(jz, js), tfe.sub(tz, ts)
        _same(jd, td)
        assert td.min() < 0  # the borrowed representation is exercised
        _same(jfe.freeze(jd), tfe.freeze(td))
        assert _ints(td) == [P - 1, P - 19, 1]

    def test_raw_ops_stay_exact_at_bound(self):
        rng = np.random.default_rng(21)
        (jx, tx), (jy, ty) = _both(_limbs(_vals(rng, 8))), _both(_limbs(_vals(rng, 8)))
        for _ in range(10):
            _same(jfe.add_raw(jx, jy), tfe.add_raw(tx, ty))
            _same(jfe.sub_raw(jx, jy), tfe.sub_raw(tx, ty))
            jp = jfe.mul(jfe.add_raw(jx, jy), jfe.sub_raw(jx, jy))
            tp = tfe.mul(tfe.add_raw(tx, ty), tfe.sub_raw(tx, ty))
            _same(jp, tp)
            jx, tx = jp, tp
            jy, ty = jfe.mul(jy, jy), tfe.mul(ty, ty)

    def test_square_matches_jax_square_and_mul(self):
        rng = np.random.default_rng(23)
        vals = _vals(rng, 8) + [0, 1, P - 1]
        jx, tx = _both(_limbs(vals))
        _same(jfe.square(jx), tfe.square(tx))
        _same(jfe.mul(jx, jx), tfe.square(tx))
        assert _ints(tfe.square(tx)) == [v * v % P for v in vals]

    def test_exactness_at_synthetic_limb_extremes(self):
        def arr(limb_values):
            return np.tile(np.array(limb_values, dtype=np.float32)[:, None], (1, 2))

        hi = arr([680] * 32)             # max add_raw output
        lo = arr([-345, 600] * 16)       # extreme sub_raw output
        sq_in = arr([500, -500] * 16)    # square() bound
        big = arr([2**21] * 32)          # _weak_reduce domain
        _same(jfe.mul(jnp.asarray(hi), jnp.asarray(lo)), tfe.mul(torch.from_numpy(hi), torch.from_numpy(lo)))
        _same(jfe.square(jnp.asarray(sq_in)), tfe.square(torch.from_numpy(sq_in)))
        _same(
            jfe.add(jnp.asarray(big), jnp.asarray(big) * 0),
            tfe.add(torch.from_numpy(big), torch.from_numpy(big) * 0),
        )

        def as_int(a):
            col = a.astype(np.int64)[:, 0]
            return sum(int(col[i]) << (8 * i) for i in range(32))

        got = _ints(tfe.mul(torch.from_numpy(hi), torch.from_numpy(lo)))[0]
        assert got == as_int(hi) * as_int(lo) % P

    def test_invert(self):
        vals = [3, 12345, P - 2, 2**200 + 7]
        jx, tx = _both(_limbs(vals))
        t = tfe.invert(tx)
        _same(jfe.invert(jx), t)
        assert _ints(t) == [pow(v, P - 2, P) for v in vals]

    def test_freeze_canonicalizes(self):
        raw = [P, P + 5, 2 * P - 1, 0, 1]
        jx, tx = _both(_limbs(raw))
        _same(jfe.freeze(jx), tfe.freeze(tx))
        assert tfe.freeze(tx).dtype == torch.int32
        assert _ints(tx) == [v % P for v in raw]

    def test_eq_is_zero_select(self):
        rng = np.random.default_rng(29)
        vals = _vals(rng, 6)
        (ja, ta), (jb, tb) = _both(_limbs(vals)), _both(_limbs(vals[:3] + _vals(rng, 3)))
        # The same value in another representation: x + p - p.
        ja2, ta2 = jfe.sub(jfe.add(ja, ja), ja), tfe.sub(tfe.add(ta, ta), ta)
        _same(jfe.eq(ja, jb), tfe.eq(ta, tb))
        _same(jfe.eq(ja, ja2), tfe.eq(ta, ta2))
        assert tfe.eq(ta, ta2).all()
        jz, tz = _both(_limbs([0, 1, P - 1, 0, 5, 0]))
        _same(jfe.is_zero(jz), tfe.is_zero(tz))
        cond = np.array([True, False, True, False, True, False])
        _same(jfe.select(jnp.asarray(cond), ja, jb), tfe.select(torch.from_numpy(cond), ta, tb))

    def test_bytes_lt_p_and_lt_bytes(self):
        rng = np.random.default_rng(31)
        rows = [P - 1, P, P + 1, 0, 2**255 - 1, P - 256] + _vals(rng, 4)
        y = np.stack(
            [np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8) for v in rows], axis=1
        )
        _same(jfe.bytes_lt_p(jnp.asarray(y)), tfe.bytes_lt_p(torch.from_numpy(y.copy())))
        assert tfe.bytes_lt_p(torch.from_numpy(y.copy())).tolist() == [v < P for v in rows]
        bound = np.frombuffer((P - 256).to_bytes(32, "little"), dtype=np.uint8).astype(np.int32)
        _same(
            jlimbs.lt_bytes(jnp.asarray(y.astype(np.int32)), jnp.asarray(bound)),
            tlimbs.lt_bytes(torch.from_numpy(y.astype(np.int32)), torch.from_numpy(bound)),
        )

    def test_carry_i32(self):
        rng = np.random.default_rng(37)
        x = rng.integers(-700, 700, size=(32, 9)).astype(np.int32)
        jo, jc = jlimbs.carry_i32(jnp.asarray(x))
        to, tc = tlimbs.carry_i32(torch.from_numpy(x))
        _same(jo, to)
        _same(jc, tc)

    def test_limb_conversions_and_constants(self):
        for v in (0, 1, P - 1, 2 * P):
            np.testing.assert_array_equal(tfe.int_to_limbs(v), jfe.int_to_limbs(v))
            assert tfe.limbs_to_int(tfe.int_to_limbs(v)) == v
        with pytest.raises(ValueError):
            tfe.int_to_limbs(2**256)
        for name in ("P", "D", "D2", "SQRT_M1", "FOLD"):
            assert getattr(tfe, name) == getattr(jfe, name)
        like = torch.zeros(32, 3)
        _same(jfe.constant_like(tfe.D, jnp.zeros((32, 3))), tfe.constant_like(tfe.D, like).contiguous())


class TestPowChain:
    def test_addition_chain_matches_jax_and_bigint(self):
        rng = np.random.default_rng(7)
        vals = _vals(rng, 4) + [0, 1, P - 1, jfe.SQRT_M1]
        jx, tx = _both(_limbs(vals))
        t = tfe.pow_2_252_m3(tx)
        _same(jfe.pow_2_252_m3(jx), t)
        assert _ints(t) == [pow(v, (P - 5) // 8, P) for v in vals]
