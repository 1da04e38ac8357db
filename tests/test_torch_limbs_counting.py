"""The port's field-operation counting shim (``consensus_tpu_torch/ops/limbs.py``)
held against the JAX package's (``consensus_tpu/ops/limbs.py``) on the CPU.

The JAX shim counts while tracing, once per ``lax.scan`` body weighted by
the trip counts; the port runs every trip and each trip notes itself.  On
the same inputs, made from a numpy seed, both give equal ``muls``,
``squares``, ``adds``, ``dots`` and ``dot_macs`` (tolerance 0): the field
operations, the verify bodies at batch 8, the fused scalar stage.  The
batch-512 pins of ``tests/test_batch_verify.py`` and the VPU half of
``tests/test_mxu_limbs.py`` are mirrored and marked ``slow``, as the JAX
package marks them.  The bounds' work counts in ``chip_smoke.py`` are held
to the shim's per-lane counts of the plain versions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from consensus_tpu.models import ed25519 as jmodel
from consensus_tpu.ops import field25519 as jfe
from consensus_tpu.ops import field_p256 as jfp
from consensus_tpu.ops import limbs as jlimbs
from consensus_tpu.ops import scalar25519 as jsc
from consensus_tpu_torch.models import ed25519 as model
from consensus_tpu_torch.ops import ed25519 as ed
from consensus_tpu_torch.ops import field25519 as fe
from consensus_tpu_torch.ops import field_p256 as fp
from consensus_tpu_torch.ops import limbs
from consensus_tpu_torch.ops import p256
from consensus_tpu_torch.ops import scalar25519 as sc
from consensus_tpu_torch.ops import scan_kernels

FIELDS = ("muls", "squares", "adds", "dots", "dot_macs")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions' tensors here are a few lanes wide: one intra-op
    thread runs them faster than many, and leaves the cores to the other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _counts(count) -> tuple:
    return tuple(getattr(count, f) for f in FIELDS)


def _limbs(rng, *shape) -> np.ndarray:
    return rng.integers(0, 256, (32, *shape)).astype(np.float32)


def _both(fn_pair, arrays, **kw):
    """(port count, JAX count) of the two functions on the same arrays."""
    port_fn, jax_fn = fn_pair
    port = limbs.measure_field_ops(port_fn, *[torch.from_numpy(a) for a in arrays], **kw)
    jax = jlimbs.measure_field_ops(jax_fn, *[jnp.asarray(a) for a in arrays], **kw)
    return port, jax


# --- the shim's semantics (tests/test_batch_verify.py:220-244) -----------------


def test_counting_shim_weighs_lanes_and_scan_trips():
    a = torch.zeros((32, 4), dtype=torch.float32)  # 4 batch lanes
    assert not limbs.counting()
    count = limbs.measure_field_ops(fe.mul, a, a)
    assert (count.muls, count.squares) == (4, 0)
    count = limbs.measure_field_ops(fe.square, a)
    assert (count.muls, count.squares) == (0, 4)
    assert count.m_equiv == pytest.approx(4 * limbs.SQUARE_M_RATIO)

    def scanned(x):
        def body(c, _):
            return fe.mul(c, x), None

        c, _ = limbs.counted_scan(body, x, None, length=5)
        return c

    # Five trips of one mul body over 4 lanes.
    count = limbs.measure_field_ops(scanned, a)
    assert (count.muls, count.squares) == (20, 0)
    assert not limbs.counting()


def test_constants_and_breakdown_equal_the_jax_shims():
    assert limbs.SQUARE_M_RATIO == jlimbs.SQUARE_M_RATIO == 0.55
    assert limbs.DOT_MACS_PER_MUL == jlimbs.DOT_MACS_PER_MUL == 1024
    a = np.zeros((32, 3), np.float32)
    port, jax = _both((fp.mul, jfp.mul), [a, a])
    assert port.as_dict() == jax.as_dict()
    assert port.as_dict()["dot_m_equiv"] == 6.0 and port.m_equiv == pytest.approx(9.0)
    # Outside a region every hook is a no-op, and regions nest.
    limbs.note_mul(5)
    with limbs.count_field_ops() as outer:
        limbs.note_byte_muls(1025, 2)  # two field muls' worth, on 2 lanes
        with limbs.count_field_ops() as inner:
            limbs.note_dot(2, 3, 4, lanes=2)
            limbs.note_add(7)
    assert (outer.muls, outer.dots, outer.dot_macs, outer.adds) == (4, 2, 48, 7)
    assert (inner.muls, inner.dots, inner.dot_macs, inner.adds) == (0, 2, 48, 7)
    assert not limbs.counting()


def test_counted_scan_runs_every_trip_and_stacks_like_lax_scan():
    xs = (torch.arange(6).reshape(3, 2), torch.ones(3, 2))
    trips = []

    def body(carry, x):
        trips.append(1)
        return carry + x[0] * x[1], (x[0], carry)

    carry, (ys0, ys1) = limbs.counted_scan(body, torch.zeros(2), xs)
    assert len(trips) == 3 and carry.tolist() == [6.0, 9.0]
    assert ys0.tolist() == [[0, 1], [2, 3], [4, 5]] and ys1.shape == (3, 2)
    point = ed.identity_like(torch.zeros(32, 1))
    _, none = limbs.counted_scan(lambda p, _: (p, None), point, None, length=2)
    assert none is None
    with pytest.raises(ValueError):
        limbs.counted_scan(body, torch.zeros(2), xs, length=4)


# --- equal counts on the same inputs ---------------------------------------


@pytest.mark.parametrize(
    "name", ["fe.mul", "fe.square", "fe.add", "fe.sub", "fp.mul", "fp.square", "fp.add", "fp.sub"]
)
def test_field_op_counts_equal_jax(name):
    rng = np.random.default_rng(7)
    module, op = name.split(".")
    pair = {"fe": (fe, jfe), "fp": (fp, jfp)}[module]
    fns = (getattr(pair[0], op), getattr(pair[1], op))
    # Batch dims (3, 2): 6 lanes per op; squares take one operand.
    arrays = [_limbs(rng, 3, 2)] if op == "square" else [_limbs(rng, 3, 2), _limbs(rng, 3, 2)]
    port, jax = _both(fns, arrays)
    assert _counts(port) == _counts(jax)
    assert sum(_counts(port)[:3]) == 6


def test_square_notes_one_squaring_and_no_mul():
    """The port's squarings are ``mul(a, a)`` (divergence 3 and 7): each
    must note one squaring, as the JAX module's do, and no multiplication."""
    a = torch.zeros((32, 5), dtype=torch.float32)
    for module in (fe, fp):
        count = limbs.measure_field_ops(module.square, a)
        assert (count.muls, count.squares) == (0, 5)
    # The power chain's squarings and its per-bit multiply (JAX's select).
    port, jax = _both((fe.pow_2_252_m3, jfe.pow_2_252_m3), [np.ones((32, 2), np.float32)])
    assert _counts(port) == _counts(jax) == (2 * 11, 2 * 251, 0, 0, 0)
    port, jax = _both((fe.invert, jfe.invert), [np.ones((32, 1), np.float32)])
    assert _counts(port) == _counts(jax)


def _strict_args(rng, b):
    return [
        rng.integers(0, 256, (32, b)).astype(np.uint8),
        rng.integers(0, 2, (b,)).astype(np.uint8),
        rng.integers(0, 256, (32, b)).astype(np.uint8),
        rng.integers(0, 2, (b,)).astype(np.uint8),
        rng.integers(0, 256, (32, b)).astype(np.uint8),
        rng.integers(0, 17, (64, b)).astype(np.uint8),
        rng.integers(0, 2, (b,)).astype(bool),
    ]


def _randomized_args(rng, b):
    return [
        rng.integers(0, 256, (32, b)).astype(np.uint8),
        rng.integers(0, 2, (b,)).astype(np.uint8),
        rng.integers(0, 256, (32, b)).astype(np.uint8),
        rng.integers(0, 2, (b,)).astype(np.uint8),
        rng.integers(0, 256, (32, 1)).astype(np.uint8),
        rng.integers(0, 17, (64, b)).astype(np.uint8),
        rng.integers(0, 17, (33, b)).astype(np.uint8),
        rng.integers(0, 2, (b,)).astype(bool),
    ]


def test_verify_impl_counts_equal_jax_at_batch_8():
    port, jax = _both(
        (model.verify_impl, jmodel.verify_impl), _strict_args(np.random.default_rng(1), 8)
    )
    assert _counts(port) == _counts(jax) == (16288, 10224, 5200, 0, 0)


def test_batch_verify_impl_counts_equal_jax_at_batch_8():
    port, jax = _both(
        (model.batch_verify_impl, jmodel.batch_verify_impl),
        _randomized_args(np.random.default_rng(2), 8),
    )
    assert _counts(port) == _counts(jax) == (9409, 5040, 2288, 0, 0)


def _scalar_stage(mod, digest, z, s_rows):
    """The fused front end's scalar stage: k = H mod L, z k, sum z s, and
    both recodings."""
    k = mod.reduce_bytes_mod_l(digest)
    zk = mod.mul_mod_l(z, k)
    u = mod.sum_mod_l(mod.mul_mod_l(z, s_rows))
    return mod.signed_window_digits(zk, 64), mod.signed_window_digits(z, 33), u


def test_scalar_stage_counts_equal_jax():
    rng = np.random.default_rng(3)
    digest = rng.integers(0, 256, (64, 8)).astype(np.int32)
    z = rng.integers(0, 256, (16, 8)).astype(np.int32)
    s_rows = rng.integers(0, 256, (32, 8)).astype(np.int32)
    port = limbs.measure_field_ops(
        _scalar_stage, sc, *[torch.from_numpy(a) for a in (digest, z, s_rows)]
    )
    jax = jlimbs.measure_field_ops(
        lambda *a: _scalar_stage(jsc, *a), *[jnp.asarray(a) for a in (digest, z, s_rows)]
    )
    # reduce 64 bytes: 2 + 1 field muls' worth a lane; each 16 x 32 product
    # 1 + its reduction of 64 bytes 3; the sum's reduction of 64 bytes 3.
    assert _counts(port) == _counts(jax) == (8 * 3 + 2 * 8 * 4 + 3, 0, 0, 0, 0)


def test_a_kernel_launch_refuses_to_be_counted():
    """A hand-written kernel cannot note: inside a count the launch raises
    before it reaches the card (the card's own case is in
    tests/test_torch_cuda.py)."""
    with limbs.count_field_ops():
        with pytest.raises(RuntimeError, match="cannot be counted"):
            scan_kernels._launch("horner_scan", (), (), 0, torch.device("cuda", 0))
    # The plain versions, on CPU tensors, are what a count measures.
    a = torch.zeros((32, 2), dtype=torch.float32)
    count = limbs.measure_field_ops(scan_kernels.decompress, a, torch.zeros(2, dtype=torch.int32))
    assert (count.muls, count.squares) == (2 * 20, 2 * 255)


# --- the bounds' work counts -----------------------------------------------


#: Doubles per lane in B1's Horner scan: 64 windows of 4.  The plain
#: version's f32 8-bit limbs square a double's X + Y through a
#: multiplication (its one-raw-level operand is past their squaring's
#: exactness bound), so the shim counts each double one multiplication more
#: and one squaring less than the function needs; the kernels' 64-bit limbs
#: square it.
HORNER_DOUBLES = 64 * 4


def test_bound_work_counts_are_the_plain_versions_counts():
    """``chip_smoke.py``'s per-lane work counts of B1, B2 and B3 (and D1's)
    equal the shim's count of each kernel's plain version, lane for lane,
    once each double's (X + Y)^2 is counted as the squaring it is."""
    rng = np.random.default_rng(4)
    n = 2
    coords = [torch.from_numpy(_limbs(rng, n)) for _ in range(4)]
    k = torch.from_numpy(rng.integers(0, 17, (64, n)).astype(np.int32))
    b1 = limbs.measure_field_ops(scan_kernels.horner_scan_reference, *coords, k)
    assert (b1.muls, b1.squares) == (
        (chip_smoke.HORNER_MULS + HORNER_DOUBLES) * n,
        (chip_smoke.HORNER_SQUARES - HORNER_DOUBLES) * n,
    )

    u2 = torch.from_numpy(rng.integers(0, 17, (65, n)).astype(np.int32))
    b2 = limbs.measure_field_ops(scan_kernels.horner_scan_p256_reference, coords[0], coords[1], u2)
    assert (b2.muls, b2.squares) == (chip_smoke.P256_MULS * n, chip_smoke.P256_SQUARES * n)

    z = torch.from_numpy(rng.integers(0, 17, (33, n)).astype(np.int32))
    neg_r = ed.Point(*[torch.from_numpy(_limbs(rng, n)) for _ in range(4)])
    b3 = limbs.measure_field_ops(scan_kernels.straus_msm_reference, ed.Point(*coords), neg_r, k, z)
    bound = chip_smoke.msm_bound(n, n, 33, sm_count=132, sm_clock_hz=1.98e9)
    assert (b3.muls, b3.squares) == (
        bound["muls"] + bound["doubles"], bound["squares"] - bound["doubles"]
    )

    d1 = limbs.measure_field_ops(
        scan_kernels.decompress_reference, coords[1], torch.zeros(n, dtype=torch.int32)
    )
    assert (d1.muls, d1.squares) == (
        chip_smoke.DECOMPRESS_MULS * n, chip_smoke.DECOMPRESS_SQUARES * n
    )


def test_verdict_kernel_work_counts_are_the_plain_versions_counts():
    """``chip_smoke.py``'s per-lane work counts of E1 (both modes), P1 and
    P2 equal the shim's count of each kernel's plain version, lane for
    lane (E1's comparison counted on lanes whose masks pass, as the kernel
    runs it)."""
    rng = np.random.default_rng(6)
    n = 3
    pt = lambda k: [torch.from_numpy(_limbs(rng, n)) for _ in range(k)]
    yes = torch.ones(n, dtype=torch.bool)
    e1 = limbs.measure_field_ops(
        scan_kernels.add_and_equal_reference, ed.Point(*pt(4)), ed.Point(*pt(4)),
        ed.Point(*pt(4)), yes, yes, yes)
    assert (e1.muls, e1.squares) == (
        (chip_smoke.E1_ADD_MULS + chip_smoke.E1_COMPARE_MULS) * n, 0)
    e1_id = limbs.measure_field_ops(
        scan_kernels.add_is_identity_reference, ed.Point(*pt(4)), ed.Point(*pt(4)))
    assert (e1_id.muls, e1_id.squares) == (chip_smoke.E1_ADD_MULS * n, 0)
    digits = torch.from_numpy(rng.integers(0, 256, (32, n)).astype(np.int32))
    p1 = limbs.measure_field_ops(scan_kernels.fixed_base_mul_comb_p256_reference, digits)
    assert (p1.muls, p1.squares) == (chip_smoke.P1_MULS * n, 0)
    p2 = limbs.measure_field_ops(
        scan_kernels.verdict_p256_reference, p256.Point(*pt(3)), p256.Point(*pt(3)), *pt(4),
        yes, yes)
    assert (p2.muls, p2.squares) == (chip_smoke.P2_MULS * n, chip_smoke.P2_SQUARES * n)


# --- the batch-512 pins (slow, as in the JAX package) ---------------------------


def _zeros_strict(b):
    return [
        torch.zeros((32, b), dtype=torch.uint8), torch.zeros((b,), dtype=torch.uint8),
        torch.zeros((32, b), dtype=torch.uint8), torch.zeros((b,), dtype=torch.uint8),
        torch.zeros((32, b), dtype=torch.uint8), torch.zeros((64, b), dtype=torch.uint8),
        torch.zeros((b,), dtype=torch.bool),
    ]


def _zeros_randomized(b):
    return [
        torch.zeros((32, b), dtype=torch.uint8), torch.zeros((b,), dtype=torch.uint8),
        torch.zeros((32, b), dtype=torch.uint8), torch.zeros((b,), dtype=torch.uint8),
        torch.zeros((32, 1), dtype=torch.uint8), torch.zeros((64, b), dtype=torch.uint8),
        torch.zeros((33, b), dtype=torch.uint8), torch.zeros((b,), dtype=torch.bool),
    ]


@pytest.mark.slow
def test_batch512_op_counts_pinned():
    """The JAX package's batch-512 pins (``tests/test_mxu_limbs.py``'s VPU
    half): strict (1042432, 654336, 332800), randomized (516937, 274176,
    114176).  Slow: the plain bodies at batch 512 on the CPU."""
    strict = limbs.measure_field_ops(model.verify_impl, *_zeros_strict(512))
    rand = limbs.measure_field_ops(model.batch_verify_impl, *_zeros_randomized(512))
    assert (strict.muls, strict.squares, strict.adds) == (1042432, 654336, 332800)
    assert strict.m_equiv == pytest.approx(1402316.8)
    assert (rand.muls, rand.squares, rand.adds) == (516937, 274176, 114176)
    assert rand.m_equiv == pytest.approx(667733.8)


@pytest.mark.slow
def test_amortized_field_muls_at_512_below_half_of_strict():
    """``tests/test_batch_verify.py:250``: at batch 512 the randomized
    aggregate costs at most half the strict body's field multiplications."""
    strict = limbs.measure_field_ops(model.verify_impl, *_zeros_strict(512))
    batched = limbs.measure_field_ops(model.batch_verify_impl, *_zeros_randomized(512))
    assert batched.muls / strict.muls <= 0.50
    assert batched.m_equiv / strict.m_equiv <= 0.50
