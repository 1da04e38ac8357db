"""Parity of the port's GF(p256) limb arithmetic with the JAX package.

Mirrors ``TestFieldP256`` of tests/test_ecdsa_p256.py: the same numpy-seeded
operands go through ``consensus_tpu.ops.field_p256`` (JAX, on the CPU) and
``consensus_tpu_torch.ops.field_p256`` (torch, on the CPU).  Tolerance is
exact: both sides use the f32 8-bit-limb layout, so every output is compared
limb for limb, and against Python big-int arithmetic after ``freeze``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consensus_tpu.ops import field_p256 as jfp
from consensus_tpu_torch.ops import field_p256 as tfp

P = jfp.P


def _vals(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _limbs(values) -> np.ndarray:
    return np.stack([jfp.int_to_limbs(v) for v in values], axis=1)


def _weaken(arr: np.ndarray) -> np.ndarray:
    """The same values with negative limbs: borrow 256 from every limb >= 172
    into the next one (|limb| stays well inside the weak contract)."""
    arr = arr.copy()
    for i in range(31):
        move = (arr[i] >= 172).astype(np.float32)
        arr[i] -= 256 * move
        arr[i + 1] += move
    return arr


def _both(arr: np.ndarray):
    return jnp.asarray(arr), torch.from_numpy(arr.copy())


def _same(j, t):
    """Limb-for-limb equality of a JAX and a torch output."""
    j = np.asarray(j)
    t = t.numpy()
    assert j.shape == t.shape and j.dtype == t.dtype, (j.shape, t.shape, j.dtype, t.dtype)
    assert np.array_equal(j, t), np.argwhere(j != t)[:8]


def _ints(t) -> list[int]:
    frozen = tfp.freeze(t).numpy()
    return [tfp.limbs_to_int(frozen[:, i]) for i in range(frozen.shape[1])]


_EDGES_A = [0, 1, P - 1, P - 2, 2**255, 2**224]
_EDGES_B = [P - 1, 0, P - 1, 2, 2**256 - 2**224 - 1, 3]
#: Every case runs at one batch width, so JAX compiles each op once.
LANES = 16


@pytest.mark.parametrize("weak", [False, True], ids=["bytes", "negative-limbs"])
@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_binary_ops_match_jax_and_bigint(name, weak):
    rng = np.random.default_rng(7)
    a_vals = _vals(rng, 10) + _EDGES_A
    b_vals = _vals(rng, 10) + _EDGES_B
    a, b = _limbs(a_vals), _limbs(b_vals)
    if weak:
        a, b = _weaken(a), _weaken(b)
        assert a.min() < 0 and b.min() < 0
    (ja, ta), (jb, tb) = _both(a), _both(b)
    t = getattr(tfp, name)(ta, tb)
    _same(getattr(jfp, name)(ja, jb), t)
    op = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y, "mul": lambda x, y: x * y}[name]
    assert _ints(t) == [op(x, y) % P for x, y in zip(a_vals, b_vals)]


@pytest.mark.parametrize("weak", [False, True], ids=["bytes", "negative-limbs"])
def test_square_and_mul_small_match_jax_and_bigint(weak):
    rng = np.random.default_rng(11)
    vals = _vals(rng, 10) + _EDGES_A
    x = _weaken(_limbs(vals)) if weak else _limbs(vals)
    jx, tx = _both(x)
    sq = tfp.square(tx)
    _same(jfp.square(jx), sq)
    _same(jfp.mul(jx, jx), sq)
    assert _ints(sq) == [v * v % P for v in vals]
    for k in (2, 3, 64):
        t = tfp.mul_small(tx, k)
        _same(jfp.mul_small(jx, k), t)
        assert _ints(t) == [v * k % P for v in vals]


def test_deep_chain_stays_exact():
    """tests/test_ecdsa_p256.py's 45-step mul / sub / square chain, every
    step limb for limb."""
    rng = np.random.default_rng(9)
    vals, other = _vals(rng, LANES), _vals(rng, LANES)
    (jx, tx), (jy, ty) = _both(_limbs(vals)), _both(_limbs(other))
    w = list(vals)
    for i in range(45):
        if i % 3 == 0:
            jx, tx = jfp.mul(jx, jy), tfp.mul(tx, ty)
            w = [(u * v) % P for u, v in zip(w, other)]
        elif i % 3 == 1:
            jx, tx = jfp.sub(jx, jy), tfp.sub(tx, ty)
            w = [(u - v) % P for u, v in zip(w, other)]
        else:
            jx, tx = jfp.square(jx), tfp.square(tx)
            w = [u * u % P for u in w]
        _same(jx, tx)
    assert _ints(tx) == w


def test_exactness_at_the_weak_bound():
    def arr(limb_values):
        return np.tile(np.array(limb_values, dtype=np.float32)[:, None], (1, LANES))

    hi = arr([600] * 32)
    lo = arr([-600, 600] * 16)
    (jh, th), (jl, tl) = _both(hi), _both(lo)
    _same(jfp.mul(jh, jl), tfp.mul(th, tl))
    _same(jfp.square(jl), tfp.square(tl))
    _same(jfp.sub(jh, jl), tfp.sub(th, tl))

    def as_int(a):
        col = a.astype(np.int64)[:, 0]
        return sum(int(col[i]) << (8 * i) for i in range(32))

    assert _ints(tfp.mul(th, tl))[0] == as_int(hi) * as_int(lo) % P


def test_freeze_eq_is_zero_select():
    rng = np.random.default_rng(13)
    raw = [P, P + 5, 2**256 - 1, 0, 1, P - 1] + _vals(rng, LANES - 6)
    jx, tx = _both(_limbs(raw))
    _same(jfp.freeze(jx), tfp.freeze(tx))
    assert tfp.freeze(tx).dtype == torch.int32
    assert _ints(tx) == [v % P for v in raw]
    vals = _vals(rng, LANES)
    (ja, ta), (jb, tb) = _both(_limbs(vals)), _both(_limbs(vals[:8] + _vals(rng, 8)))
    ja2, ta2 = jfp.sub(jfp.add(ja, ja), ja), tfp.sub(tfp.add(ta, ta), ta)
    _same(jfp.eq(ja, jb), tfp.eq(ta, tb))
    _same(jfp.eq(ja, ja2), tfp.eq(ta, ta2))
    assert tfp.eq(ta, ta2).all()
    jz, tz = _both(_limbs([0, 1, P - 1, 0, 5, 0] * 2 + [0] * 4))
    _same(jfp.is_zero(jz), tfp.is_zero(tz))
    jn, tn = jfp.sub(jz * 0, jz), tfp.sub(tz * 0, tz)  # borrowed zeros
    _same(jfp.is_zero(jn), tfp.is_zero(tn))
    cond = np.arange(LANES) % 3 == 0
    _same(jfp.select(jnp.asarray(cond), ja, jb), tfp.select(torch.from_numpy(cond), ta, tb))


def test_constants_and_conversions():
    np.testing.assert_array_equal(tfp._SOLINAS_M, jfp._SOLINAS_M)
    np.testing.assert_array_equal(tfp._get_bias(), jfp._get_bias())
    assert tfp._FOLD_PATTERN == jfp._FOLD_PATTERN and tfp.P == jfp.P
    for v in (0, 1, P - 1, 2**256 - 1):
        np.testing.assert_array_equal(tfp.int_to_limbs(v), jfp.int_to_limbs(v))
        assert tfp.limbs_to_int(tfp.int_to_limbs(v)) == v
    with pytest.raises(ValueError):
        tfp.int_to_limbs(2**256)
    with pytest.raises(ValueError):
        tfp._reduce_wide(torch.zeros(64, 2))  # wider than a 32 x 32-limb product
    like = torch.zeros(32, LANES)
    _same(
        jfp.constant_like(P + 7, jnp.zeros((32, LANES))),
        tfp.constant_like(P + 7, like).contiguous(),
    )


def test_solinas_product_is_exact_under_reduced_matmul_precision():
    """The Solinas matrix product must not round whatever the matmul
    precision settings say: with TF32 allowed and float32 matmuls at "high"
    (or "medium") precision the results stay limb-identical to JAX's
    ``Precision.HIGHEST``."""
    rng = np.random.default_rng(17)
    a, b = _weaken(_limbs(_vals(rng, LANES))), _limbs(_vals(rng, LANES))
    (ja, ta), (jb, tb) = _both(a), _both(b)
    want_mul, want_sub = jfp.mul(ja, jb), jfp.sub(ja, jb)
    saved = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    try:
        for precision in ("high", "medium"):
            torch.set_float32_matmul_precision(precision)
            torch.backends.cuda.matmul.allow_tf32 = True
            _same(want_mul, tfp.mul(ta, tb))
            _same(want_sub, tfp.sub(ta, tb))
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
