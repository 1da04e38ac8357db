"""The port's tensor-core field lane (``consensus_tpu_torch/ops/mxu_limbs.py``,
kernel M1 in ``csrc/mxu_limbs.cu``) held against the JAX package's
(``consensus_tpu/ops/mxu_limbs.py``) on the CPU: the mirror of
``tests/test_mxu_limbs.py``.

Inputs are made with numpy from a seed and go through both packages;
tolerance 0 on raw limbs, with no ``freeze``: the lane's weakly reduced
limbs must equal the VPU lane's bit for bit.  The JAX lane runs on the CPU
under ``force_mxu_limbs`` (fresh traces, as its own tests take them); the
port's lane is read at every call, so an eager A/B needs no fresh trace.

Not mirrored: ``msm_config``'s cases (``tests/test_mxu_limbs.py:400-450``,
``CTPU_MXU_MSM``, ``CTPU_MXU_MSM_TILE``) and the MSM kernel's A/B.  They pin
env gates of the JAX package's Pallas MSM, and the port's B3 has no lane
switch: on a CUDA tensor it always runs (ROADMAP.md, divergence 11).  Nor
the distinct-graph pin (``:160-180``), whose subject is jit's trace cache;
its eager counterpart here shows each lane's own counts.

Kernel M1 runs only on the card (``tests/test_torch_cuda.py``).  Its
per-thread code is ``__host__ __device__``: the g++ harness below compiles
it for the host and replays a warpgroup's schedule with ``wgmma`` emulated
from its documented fragment layouts and shared-memory descriptor, held to
the plain version at tolerance 0.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from consensus_tpu.models import aggregate as jagg
from consensus_tpu.models import ed25519 as jmodel
from consensus_tpu.ops import field25519 as jfe
from consensus_tpu.ops import field_p256 as jfp
from consensus_tpu.ops import limbs as jlimbs
from consensus_tpu.ops import mxu_limbs as jmx
from consensus_tpu_torch.models import ed25519 as model
from consensus_tpu_torch.models.aggregate import HalfAggregator
from consensus_tpu_torch.models.verifier import Ed25519Signer
from consensus_tpu_torch.ops import field25519 as fe
from consensus_tpu_torch.ops import field_p256 as fp
from consensus_tpu_torch.ops import limbs, mxu_limbs, scan_kernels

FIELDS = ("muls", "squares", "adds", "dots", "dot_macs")

#: The JAX test's operand ranges: canonical bytes, one raw add/sub level
#: (-345, 681), and the subtraction bias's symmetric range; P-256's
#: canonical bytes and its weak bound.
_ED_RANGES = [(0, 256), (-345, 681), (-340, 341)]
_P256_RANGES = [(0, 256), (-600, 601)]

_PORT = {"ed25519": fe, "p256": fp}
_JAX = {"ed25519": jfe, "p256": jfp}
_CASES = [("ed25519", r) for r in _ED_RANGES] + [("p256", r) for r in _P256_RANGES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions' tensors here are a few lanes wide: one intra-op
    thread runs them faster than many, and leaves the cores to the other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _lane_off_by_default(monkeypatch):
    monkeypatch.delenv("CTPU_MXU_LIMBS", raising=False)


def _limbs(rng, lo, hi, *shape) -> np.ndarray:
    return rng.integers(lo, hi, size=(32, *shape)).astype(np.float32)


def _three_lanes(name: str, fn: str, *arrays: np.ndarray) -> dict:
    """``fn`` of the field module ``name`` on the same arrays: the JAX
    package's tensor-core lane, the port's (plain version) and the port's
    VPU lane, as numpy."""
    with jmx.force_mxu_limbs():
        jax_out = np.asarray(getattr(_JAX[name], fn)(*[jnp.asarray(a) for a in arrays]))
    port_in = [torch.from_numpy(a) for a in arrays]
    with mxu_limbs.force_mxu_limbs():
        mxu = getattr(_PORT[name], fn)(*port_in).numpy()
    with mxu_limbs.suppress_mxu_limbs():
        vpu = getattr(_PORT[name], fn)(*port_in).numpy()
    return {"jax": jax_out, "mxu": mxu, "vpu": vpu}


def _assert_bit_equal(out: dict) -> None:
    assert out["mxu"].dtype == out["vpu"].dtype == out["jax"].dtype == np.float32
    assert np.array_equal(out["mxu"], out["vpu"])
    assert np.array_equal(out["mxu"], out["jax"])


# --- operand-range bit-exactness (tests/test_mxu_limbs.py:92-135) ------------------


@pytest.mark.parametrize("name,bounds", _CASES, ids=lambda c: str(c))
def test_mul_and_square_bit_exact_across_operand_ranges(name, bounds):
    lo, hi = bounds
    rng = np.random.default_rng(1000 + hi - lo + (name == "p256"))
    a, b = _limbs(rng, lo, hi, 16), _limbs(rng, lo, hi, 16)
    _assert_bit_equal(_three_lanes(name, "mul", a, b))
    _assert_bit_equal(_three_lanes(name, "square", a))


@pytest.mark.parametrize("name", ["ed25519", "p256"])
def test_broadcast_constant_against_a_batch(name):
    """A (32, 1) constant against a (32, n) batch and a (32, 1, n) batch,
    both ways round, as ``_cexpand`` gives them: the note's lanes are the
    broadcast batch's."""
    rng = np.random.default_rng(5)
    c = _limbs(rng, 0, 256, 1)
    x = _limbs(rng, -340, 341, 24)
    _assert_bit_equal(_three_lanes(name, "mul", c, x))
    _assert_bit_equal(_three_lanes(name, "mul", x, c))
    _assert_bit_equal(_three_lanes(name, "mul", c[:, :, None], x.reshape(32, 3, 8)))
    with mxu_limbs.force_mxu_limbs():
        count = limbs.measure_field_ops(
            _PORT[name].mul, torch.from_numpy(c), torch.from_numpy(x)
        )
    assert count.dot_macs == 24 * (65536 if name == "ed25519" else 67584)


def test_mul_chain_bit_exact():
    """The JAX test's jitted scan of 8 dependent products (``:135``): the
    port's chain under each lane equals the JAX lane's."""
    rng = np.random.default_rng(7)
    a, b = _limbs(rng, 0, 256, 8), _limbs(rng, 0, 256, 8)

    def jax_chain(x, y):
        def body(c, _):
            return jfe.mul(c, y), None

        c, _ = jax.lax.scan(body, x, None, length=8)
        return c

    with jmx.force_mxu_limbs():
        want = np.asarray(jax.jit(jax_chain)(jnp.asarray(a), jnp.asarray(b)))
    got = {}
    for lane, ctx in (("mxu", mxu_limbs.force_mxu_limbs), ("vpu", mxu_limbs.suppress_mxu_limbs)):
        x, y = torch.from_numpy(a), torch.from_numpy(b)
        with ctx():
            for _ in range(8):
                x = fe.mul(x, y)
        got[lane] = x.numpy()
    assert np.array_equal(got["mxu"], want) and np.array_equal(got["vpu"], want)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    a = torch.zeros((32, 4), dtype=torch.float32)
    with pytest.raises(TypeError, match="float32"):
        mxu_limbs.mul25519(a.double(), a)
    with pytest.raises(ValueError, match=r"\(32, \*batch\)"):
        mxu_limbs.mul_p256(a[:31], a[:31])
    with pytest.raises(ValueError, match=r"\(32, \*batch\)"):
        mxu_limbs.square25519(torch.zeros(32))
    with pytest.raises(ValueError, match="one device"):
        mxu_limbs.mul25519(a, torch.zeros((32, 4), device="meta"))


# --- lane selection (tests/test_mxu_limbs.py:160-200) -----------------------------


def test_lane_selection_precedence(monkeypatch):
    assert not mxu_limbs.lane_active()
    monkeypatch.setenv("CTPU_MXU_LIMBS", "1")
    assert mxu_limbs.lane_active()
    # Suppression wins over both the environment and an explicit force.
    with mxu_limbs.suppress_mxu_limbs():
        assert not mxu_limbs.lane_active()
        with mxu_limbs.force_mxu_limbs():
            assert not mxu_limbs.lane_active()
    monkeypatch.delenv("CTPU_MXU_LIMBS")
    with mxu_limbs.force_mxu_limbs():
        assert mxu_limbs.lane_active()
    assert not mxu_limbs.lane_active()
    monkeypatch.setenv("CTPU_MXU_LIMBS", "0")
    assert not mxu_limbs.lane_active()


@pytest.mark.parametrize("name", ["ed25519", "p256"])
def test_lane_is_read_at_every_call(monkeypatch, name):
    """The eager A/B: the same call under forcing notes dots and under
    suppression muls, and the environment switches the next call."""
    a = torch.from_numpy(_limbs(np.random.default_rng(11), 0, 256, 4))
    mul = _PORT[name].mul
    with mxu_limbs.force_mxu_limbs():
        forced = limbs.measure_field_ops(mul, a, a)
    with mxu_limbs.suppress_mxu_limbs():
        suppressed = limbs.measure_field_ops(mul, a, a)
    assert forced.muls == 0 and forced.dots > 0
    assert suppressed.muls == 4
    monkeypatch.setenv("CTPU_MXU_LIMBS", "1")
    assert limbs.measure_field_ops(mul, a, a).muls == 0
    monkeypatch.setenv("CTPU_MXU_LIMBS", "")
    assert limbs.measure_field_ops(mul, a, a).muls == 4


# --- counting (tests/test_mxu_limbs.py:452-516) -----------------------------------


def _counts(count) -> tuple:
    return tuple(getattr(count, f) for f in FIELDS)


def test_counting_records_dots_not_muls():
    """The pinned per-site weights at batch 4: an Ed25519 product is the
    outer product (32 x 1 x 32) plus the assembly (63 x 1 x 1024), 65,536
    dense MACs a lane; P-256 adds the Solinas contraction (32 x 1 x 64).
    The JAX shim counts the same."""
    a = torch.zeros((32, 4), dtype=torch.float32)
    ja = jnp.zeros((32, 4), jnp.float32)
    with mxu_limbs.force_mxu_limbs(), jmx.force_mxu_limbs():
        for fn, jfn, n_args in ((fe.mul, jfe.mul, 2), (fe.square, jfe.square, 1)):
            d = limbs.measure_field_ops(fn, *[a] * n_args).as_dict()
            assert (d["muls"], d["squares"], d["adds"]) == (0, 0, 0)
            assert d["dots"] == 8
            assert d["dot_macs"] == 4 * 65536
            assert d["m_equiv"] == pytest.approx(4 * 64.0)
            assert d == jlimbs.measure_field_ops(jfn, *[ja] * n_args).as_dict()
        d = limbs.measure_field_ops(fp.mul, a, a).as_dict()
        assert (d["muls"], d["dots"]) == (0, 12)
        assert d["dot_macs"] == 4 * 67584
        assert d["m_equiv"] == pytest.approx(4 * 66.0)
        assert d == jlimbs.measure_field_ops(jfp.mul, ja, ja).as_dict()
    d = limbs.measure_field_ops(fe.mul, a, a).as_dict()
    assert (d["muls"], d["dots"], d["dot_macs"]) == (4, 0, 0)


def test_skipped_ladder_products_note_as_the_lane_does():
    """``pow_const``'s 0 bits note the product the JAX ladder's select
    computes: dots under the lane."""
    x = np.ones((32, 2), np.float32)
    with mxu_limbs.force_mxu_limbs(), jmx.force_mxu_limbs():
        port = limbs.measure_field_ops(lambda v: fe.pow_const(v, 0b1011), torch.from_numpy(x))
        jax_count = jlimbs.measure_field_ops(lambda v: jfe.pow_const(v, 0b1011), jnp.asarray(x))
    assert _counts(port) == _counts(jax_count)
    assert port.muls == port.squares == 0 and port.dots == 2 * 2 * (3 + 3)


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


def _lane_counts(port_fn, jax_fn, arrays):
    with mxu_limbs.force_mxu_limbs():
        port = limbs.measure_field_ops(port_fn, *[torch.from_numpy(a) for a in arrays])
    with jmx.force_mxu_limbs():
        jax_count = jlimbs.measure_field_ops(jax_fn, *[jnp.asarray(a) for a in arrays])
    return port, jax_count


def test_verify_impl_counts_equal_jax_at_batch_8_under_the_lane():
    port, jax_count = _lane_counts(
        model.verify_impl, jmodel.verify_impl, _strict_args(np.random.default_rng(1), 8)
    )
    assert _counts(port) == _counts(jax_count)
    assert (port.muls, port.squares) == (0, 0) and port.dots > 0


def test_batch_verify_impl_counts_equal_jax_at_batch_8_under_the_lane():
    port, jax_count = _lane_counts(
        model.batch_verify_impl, jmodel.batch_verify_impl,
        _randomized_args(np.random.default_rng(2), 8),
    )
    assert _counts(port) == _counts(jax_count)
    assert (port.muls, port.squares) == (0, 0) and port.dots > 0


@pytest.mark.slow
def test_batch512_op_counts_pinned_under_the_lane():
    """The JAX package's batch-512 pins of the tensor-core lane
    (``tests/test_mxu_limbs.py:505-516``).  Slow, as there: the plain
    bodies at batch 512 on the CPU."""
    b = 512
    strict_args = [
        torch.zeros((32, b), dtype=torch.uint8), torch.zeros((b,), dtype=torch.uint8),
        torch.zeros((32, b), dtype=torch.uint8), torch.zeros((b,), dtype=torch.uint8),
        torch.zeros((32, b), dtype=torch.uint8), torch.zeros((64, b), dtype=torch.uint8),
        torch.zeros((b,), dtype=torch.bool),
    ]
    rand_args = [
        torch.zeros((32, b), dtype=torch.uint8), torch.zeros((b,), dtype=torch.uint8),
        torch.zeros((32, b), dtype=torch.uint8), torch.zeros((b,), dtype=torch.uint8),
        torch.zeros((32, 1), dtype=torch.uint8), torch.zeros((64, b), dtype=torch.uint8),
        torch.zeros((33, b), dtype=torch.uint8), torch.zeros((b,), dtype=torch.bool),
    ]
    with mxu_limbs.force_mxu_limbs():
        strict = limbs.measure_field_ops(model.verify_impl, *strict_args)
        rand = limbs.measure_field_ops(model.batch_verify_impl, *rand_args)
    assert (strict.muls, strict.squares) == (0, 0)
    assert (strict.dots, strict.dot_macs) == (3393536, 111199387648)
    assert strict.m_equiv == pytest.approx(108593152.0)
    assert (rand.muls, rand.squares) == (0, 0)
    assert (rand.dots, rand.dot_macs) == (1582226, 51846381568)
    assert rand.m_equiv == pytest.approx(50631232.0)


# --- verdict parity under the lane (tests/test_mxu_limbs.py:202-364) ---------------


def _flip(raw, i):
    raw = bytearray(raw)
    raw[i] ^= 0x40
    return bytes(raw)


def _corpus(n=8):
    """The JAX test's corpus: valid signatures plus a forged, a tampered,
    a wrong-key, a non-canonical S (= L) and an undecodable key lane."""
    signers = [Ed25519Signer(i, bytes([i + 1] * 32)) for i in range(4)]
    msgs, sigs, keys = [], [], []
    for i in range(n):
        s = signers[i % len(signers)]
        m = b"mxu-parity-%d" % i
        msgs.append(m)
        sigs.append(s.sign_raw(m))
        keys.append(s.public_bytes)
    sigs[1] = bytes(64)
    sigs[2] = _flip(sigs[2], 3)
    keys[3] = signers[0].public_bytes
    sigs[4] = sigs[4][:32] + model.L.to_bytes(32, "little")
    keys[5] = b"\xff" * 32
    return msgs, sigs, keys


_EXPECTED = [True, False, False, False, False, False, True, True]

_PORT_LANES = (("vpu", mxu_limbs.suppress_mxu_limbs), ("mxu", mxu_limbs.force_mxu_limbs))


def _port_ab(make_engine, msgs, sigs, keys) -> dict:
    """Verdicts of the port's engine under each lane, with the lane's
    products counted (the mxu run notes dots and no muls)."""
    out = {}
    for lane, ctx in _PORT_LANES:
        with ctx(), limbs.count_field_ops() as count:
            out[lane] = np.asarray(make_engine().verify_batch(msgs, sigs, keys))
        assert (count.dots > 0) == (lane == "mxu") and (count.muls == 0) == (lane == "mxu")
    return out


def test_strict_verdict_parity_single_device():
    """The strict engine's device path on the CPU (the plain versions of
    every kernel, so every field product of the wave takes the lane)."""
    msgs, sigs, keys = _corpus()
    out = _port_ab(lambda: model.Ed25519BatchVerifier(device="cpu", min_device_batch=1),
                   msgs, sigs, keys)
    assert out["vpu"].tolist() == _EXPECTED
    assert np.array_equal(out["vpu"], out["mxu"])


@pytest.mark.slow
def test_strict_verdict_parity_single_device_against_jax(monkeypatch):
    msgs, sigs, keys = _corpus()
    with jmx.force_mxu_limbs():
        monkeypatch.setattr(jmodel, "_verify_kernel", jax.jit(lambda *a: jmodel.verify_impl(*a)))
        want = np.asarray(jmodel.Ed25519BatchVerifier(min_device_batch=1).verify_batch(msgs, sigs, keys))
    with mxu_limbs.force_mxu_limbs():
        got = model.Ed25519BatchVerifier(device="cpu", min_device_batch=1).verify_batch(msgs, sigs, keys)
    assert np.array_equal(got, want) and want.tolist() == _EXPECTED


@pytest.mark.slow
def test_randomized_verdict_parity_single_device(monkeypatch):
    """As the JAX test: ``min_device_batch=5`` keeps the bisection's small
    subsets on the strict floor; the JAX lane's verdicts too."""
    msgs, sigs, keys = _corpus()
    out = _port_ab(
        lambda: model.Ed25519RandomizedBatchVerifier(device="cpu", min_device_batch=5),
        msgs, sigs, keys,
    )
    with jmx.force_mxu_limbs():
        monkeypatch.setattr(
            jmodel, "_batch_verify_kernel", jax.jit(lambda *a: jmodel.batch_verify_impl(*a))
        )
        monkeypatch.setattr(jmodel, "_verify_kernel", jax.jit(lambda *a: jmodel.verify_impl(*a)))
        want = jmodel.Ed25519RandomizedBatchVerifier(min_device_batch=5).verify_batch(msgs, sigs, keys)
    assert out["vpu"].tolist() == _EXPECTED
    assert np.array_equal(out["vpu"], out["mxu"]) and np.array_equal(out["mxu"], np.asarray(want))


@pytest.mark.slow
def test_halfagg_verdict_parity(monkeypatch):
    """All-or-nothing aggregate certs under both lanes: the valid cert, a
    tampered aggregate scalar, a swapped key and a non-canonical R; the JAX
    lane's answers too."""
    signers = [Ed25519Signer(i, bytes([i + 1] * 32)) for i in range(4)]
    msgs = [b"halfagg-%d" % i for i in range(4)]
    sigs = [s.sign_raw(m) for s, m in zip(signers, msgs)]
    keys = [s.public_bytes for s in signers]
    cert, bad = HalfAggregator(min_device_batch=1, device_prep=False, device="cpu").aggregate(
        msgs, sigs, keys
    )
    assert cert is not None and bad == ()
    rs, s_agg = cert
    rs = list(rs)
    cases = {
        "valid": (msgs, rs, s_agg, keys),
        "tampered_s_agg": (msgs, rs, _flip(s_agg, 0), keys),
        "swapped_key": (msgs, rs, s_agg, [keys[1], keys[0]] + keys[2:]),
        "noncanonical_r": (msgs, [b"\xff" * 32] + rs[1:], s_agg, keys),
    }
    out = {}
    for lane, ctx in _PORT_LANES:
        with ctx():
            ver = HalfAggregator(min_device_batch=1, device_prep=False, device="cpu")
            out[lane] = {name: ver.verify(*case) for name, case in cases.items()}
    with jmx.force_mxu_limbs():
        monkeypatch.setattr(
            jagg, "_halfagg_verify_kernel", jax.jit(lambda *a: jagg.batch_verify_impl(*a))
        )
        ver = jagg.HalfAggregator(min_device_batch=1, device_prep=False)
        want = {name: ver.verify(*case) for name, case in cases.items()}
    assert out["vpu"] == out["mxu"] == want == {
        "valid": True, "tampered_s_agg": False, "swapped_key": False, "noncanonical_r": False,
    }


@pytest.mark.slow
@pytest.mark.parametrize("randomized", [False, True])
def test_verdict_parity_8way_mesh(randomized):
    """The sharded engines over the CPU's 8 virtual shards, under both
    lanes: topology never changes a verdict."""
    from consensus_tpu_torch.parallel import (
        ShardedEd25519RandomizedVerifier,
        ShardedEd25519Verifier,
    )

    cls = ShardedEd25519RandomizedVerifier if randomized else ShardedEd25519Verifier
    msgs, sigs, keys = _corpus()
    out = _port_ab(
        lambda: cls(device="cpu", min_device_batch=2 if randomized else 1), msgs, sigs, keys
    )
    assert out["vpu"].tolist() == _EXPECTED
    assert np.array_equal(out["vpu"], out["mxu"])


# --- kernel M1's per-thread code, compiled for the host --------------------------

_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "mxu_limbs.cu"

// Where the band lies in the block's shared-memory image: not at 0, so the
// descriptor's start address field is exercised.
constexpr uint32_t BAND_AT = 0x400;
constexpr int SMEM_BYTES = BAND_AT + 2 * BAND_HALF + 256;

// wgmma.mma_async .m64nNk32 (N = WINDOW, 48) emulated from its documented
// layouts over one warpgroup's 128 threads: A (64 x 32) gathered from the
// threads' registers (bytes, signed for plane 2), B (32 x N) read from the
// shared-memory image through the descriptor as the hardware reads a
// K-major tile with no swizzle (core matrices of 8 rows x 16 bytes, rows 16
// bytes apart, 8-row groups at the stride byte offset, the second 16 bytes
// of K at the leading byte offset), D += A B scattered back to the
// accumulators.
static void wgmma_emulated(int32_t acc[128][D_REGS], const uint32_t frag[128][A_REGS],
                           bool signed_a, const uint8_t* smem, uint64_t desc) {
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4;
  const uint32_t lbo = (uint32_t)((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
  if ((desc >> 62) != 0 || ((desc >> 49) & 7) != 0) {
    fprintf(stderr, "descriptor: a swizzle or base offset\n");
    exit(4);
  }
  static int A[64][32], B[32][64];
  for (int id = 0; id < 128; ++id) {
    const int w = id >> 5, g = (id & 31) >> 2, t = id & 3;
    for (int r = 0; r < A_REGS; ++r)
      for (int q = 0; q < 4; ++q) {
        int v = (frag[id][r] >> (8 * q)) & 0xFF;
        if (signed_a && v >= 128) v -= 256;
        A[a_row(w, g, r)][a_col(t, r, q)] = v;
      }
  }
  for (int k = 0; k < 32; ++k)
    for (int c = 0; c < WINDOW; ++c) {
      const uint32_t at = start + (c % 8) * 16 + (c / 8) * sbo + (k / 16) * lbo + (k % 16);
      if (at >= (uint32_t)SMEM_BYTES) {
        fprintf(stderr, "descriptor reads past the image\n");
        exit(4);
      }
      B[k][c] = smem[at];
    }
  for (int id = 0; id < 128; ++id) {
    const int w = id >> 5, g = (id & 31) >> 2, t = id & 3;
    for (int v = 0; v < WINDOW / 2; ++v) {
      int32_t s = 0;
      for (int k = 0; k < 32; ++k) s += A[d_row(w, g, v)][k] * B[k][d_col(t, v)];
      acc[id][v] += s;
    }
  }
}

// One block of 64 lanes from `base` on the kernel's schedule: every
// thread's coalesced loads into poisoned operand arrays, the band written
// word by word into a poisoned image, then each warpgroup on its k-blocks
// (every thread's fragment, the three planes' MMAs through the
// descriptor), both warpgroups' joined planes into poisoned stagings, and
// each quad's reduction of the two stagings' sum, its roles run in turn.
template <int CURVE>
static int block(const float* a, const float* b, float* out, long long n, int a_ld, int a_step,
                 int b_ld, int b_step, long long base) {
  static uint8_t smem[SMEM_BYTES];
  static uint32_t a_s[PAIRS * OPERAND_STRIDE], b_s[PAIRS * OPERAND_STRIDE];
  memset(smem, 0xA5, sizeof smem);
  memset(a_s, 0xA5, sizeof a_s);
  memset(b_s, 0xA5, sizeof b_s);
  for (int tid = 0; tid < THREADS; ++tid)
    load_rows(a, b, n, a_ld, a_step, b_ld, b_step, base, tid, a_s, b_s);
  for (int k = 0; k < BAND_WORDS; ++k) {
    const uint32_t word = band_word(k);
    memcpy(smem + BAND_AT + 4 * k, &word, 4);
  }
  static int32_t stage[THREADS / 32][STAGE_WORDS];
  for (int k = 0; k < THREADS / 32; ++k)
    for (int j = 0; j < STAGE_WORDS; ++j) stage[k][j] = 0x5A5A5A5A;
  int mmas = 0;
  for (int wg = 0; wg < WARPGROUPS; ++wg) {
    static uint32_t a_pairs[128][K_SPLIT], frag[PLANES][128][A_REGS];
    static int32_t bv[128][2][B_VALUES], acc[PLANES][128][D_REGS];
    memset(acc, 0, sizeof acc);
    for (int id = 0; id < 128; ++id)
      read_operands(a_s, b_s, id >> 5, (id & 31) >> 2, id & 3, wg, a_pairs[id], bv[id]);
    for (int ii = 0; ii < K_SPLIT; ++ii) {
      for (int id = 0; id < 128; ++id) {
        uint32_t f[PLANES][A_REGS];
        a_fragment(a_pairs[id][ii], bv[id], f);
        for (int p = 0; p < PLANES; ++p) memcpy(frag[p][id], f[p], sizeof f[p]);
      }
      const uint64_t desc = b_descriptor(BAND_AT, ii);
      for (int p = 0; p < PLANES; ++p) {
        wgmma_emulated(acc[p], frag[p], p == 2, smem, desc);
        ++mmas;
      }
    }
    for (int id = 0; id < 128; ++id) {
      int32_t mine[PLANES][D_REGS];
      for (int p = 0; p < PLANES; ++p) memcpy(mine[p], acc[p][id], sizeof mine[p]);
      stage_columns(stage[4 * wg + (id >> 5)], (id & 31) >> 2, id & 3, WINDOW_STEP * wg, mine);
    }
  }
  for (int wg = 0; wg < WARPGROUPS; ++wg)
    for (int w = 0; w < 4; ++w)
      for (int g = 0; g < 8; ++g) {
        const int row = g + 8 * wg;
        int32_t x[4][ROLE_COLS], r[4][ROLE_LIMBS];
        for (int t = 0; t < 4; ++t) gather_columns(stage[w], stage[4 + w], row, t, x[t]);
        reduce_columns<CURVE>(serial_quad{}, x, r);
        for (int t = 0; t < 4; ++t) store_limbs(out, n, base + 16 * w + row, t, r[t]);
      }
  return mmas;
}

// argv: curve n a_bcast b_bcast a.bin b.bin out.bin (float32 limb rows).
int main(int argc, char** argv) {
  if (argc != 8) return 2;
  const int curve = atoi(argv[1]);
  const long long n = atoll(argv[2]);
  const int a_bcast = atoi(argv[3]), b_bcast = atoi(argv[4]);
  std::vector<float> a(32 * (a_bcast ? 1 : n)), b(32 * (b_bcast ? 1 : n)), out(32 * n, -7.0f);
  FILE* f = fopen(argv[5], "rb");
  if (fread(a.data(), 4, a.size(), f) != a.size()) return 3;
  fclose(f);
  f = fopen(argv[6], "rb");
  if (fread(b.data(), 4, b.size(), f) != b.size()) return 3;
  fclose(f);
  const int a_ld = a_bcast ? 1 : (int)n, a_step = a_bcast ? 0 : 1;
  const int b_ld = b_bcast ? 1 : (int)n, b_step = b_bcast ? 0 : 1;
  int mmas = 0;
  for (long long base = 0; base < n; base += TILE_LANES) {
    if (curve == CURVE_ED25519)
      mmas = block<CURVE_ED25519>(a.data(), b.data(), out.data(), n, a_ld, a_step, b_ld, b_step, base);
    else
      mmas = block<CURVE_P256>(a.data(), b.data(), out.data(), n, a_ld, a_step, b_ld, b_step, base);
  }
  f = fopen(argv[7], "wb");
  fwrite(out.data(), 4, out.size(), f);
  fclose(f);
  printf("%d wgmma a plane for %d lanes\n", mmas / PLANES, TILE_LANES);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The harness compiled with g++ against ``csrc/``; skips where the box
    has no host C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build M1's per-thread code")
    tmp = tmp_path_factory.mktemp("m1")
    (tmp / "harness.cpp").write_text(_HARNESS)
    exe = tmp / "harness"
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-x", "c++", f"-I{scan_kernels._CSRC}", "-o", str(exe),
         str(tmp / "harness.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    return exe, tmp


def _run_harness(harness, curve: str, a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    exe, tmp = harness
    paths = [tmp / f"{curve}-{n}-{name}.bin" for name in ("a", "b", "out")]
    paths[0].write_bytes(np.ascontiguousarray(a, np.float32).tobytes())
    paths[1].write_bytes(np.ascontiguousarray(b, np.float32).tobytes())
    proc = subprocess.run(
        [str(exe), str(int(curve == "p256")), str(n), str(int(a.shape[1] == 1)),
         str(int(b.shape[1] == 1)), *map(str, paths)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    assert proc.stdout.split() == ["32", "wgmma", "a", "plane", "for", "64", "lanes"]
    return np.frombuffer(paths[2].read_bytes(), dtype=np.float32).reshape(32, n)


@pytest.mark.parametrize("name,bounds", _CASES, ids=lambda c: str(c))
def test_kernel_per_thread_code_compiled_for_the_host_matches_plain(harness, name, bounds):
    """The block schedule with wgmma emulated: the coalesced loads into
    poisoned operand arrays, the band written into a poisoned shared-memory
    image and read back through each k-block's descriptor, each
    warpgroup's half of the k-blocks with the products' byte planes as A
    fragments, the planes' join through the warps' poisoned stagings and
    both reductions split over each lane's quad (shuffles replayed by
    indexing) equal the plain version on every lane (tolerance 0), at
    ragged widths (1, 17: a block part filled; 65 and 130: a second and
    third block) and with a broadcast operand either side."""
    lo, hi = bounds
    rng = np.random.default_rng(hi - lo)
    product = mxu_limbs.mul25519 if name == "ed25519" else mxu_limbs.mul_p256
    for n, a_lanes, b_lanes in ((1, 1, 1), (17, 17, 17), (65, 65, 65), (65, 1, 65), (9, 9, 1),
                                (130, 130, 130)):
        a, b = _limbs(rng, lo, hi, a_lanes), _limbs(rng, lo, hi, b_lanes)
        want = product(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        assert want.shape == (32, n)
        assert np.array_equal(_run_harness(harness, name, a, b, n), want), (n, a_lanes, b_lanes)
