"""Kernel L1 (the fused front end's scalar stage, ``csrc/scalar25519.cu``)
against its plain versions and the JAX package.

The wrappers (``ops/scalar25519.py::scalar_challenge`` and
``::scalar_aggregate``) run their plain versions on CPU tensors and launch
nothing.  Those are held against the JAX package's
``consensus_tpu/ops/scalar25519.py`` compositions on seeded numpy inputs and
on the edge values (0, L - 1, L, L + 1, 2L, 2^252 - 1, 2^252, 2^512 - 1,
digests that reduce to 0, z = 1, s = L - 1 on every lane), at tolerance 0:
64-byte digests, the 16 x 32 products, the sum, and the digits at 64 and 33
windows.  The kernel's per-lane code is ``__host__ __device__``: compiled as
plain C++ with g++ and run with the kernel's block schedule (blocks of 64
lanes, each block's column sums, then the one-block sum) over poisoned
outputs, it must equal the plain versions at ragged widths.  The fused
bodies reach the stage only through the wrappers, which on a CUDA tensor
launch L1.  The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 25).
"""

import collections
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from consensus_tpu.ops import scalar25519 as jsc
from consensus_tpu_torch.models.aggregate import HalfAggregator
from consensus_tpu_torch.models.ed25519 import ref_public_key, ref_sign
from consensus_tpu_torch.models.fused import (
    FusedEd25519BatchVerifier,
    FusedEd25519RandomizedBatchVerifier,
)
from consensus_tpu_torch.obs.kernels import KERNELS
from consensus_tpu_torch.ops import limbs
from consensus_tpu_torch.ops import scalar25519 as sc
from consensus_tpu_torch.ops import scan_kernels
from test_torch_straus_msm import _host_build

L = sc.L
#: Values whose reduction, product or recoding sits on a carry or a fold.
EDGES = [0, 1, L - 1, L, L + 1, 2 * L, 2**252 - 1, 2**252, 2**253 - 1, 2**256 - 1,
         2**512 - 1, L * (2**259 + 12345), L * ((2**512 - 1) // L)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions' tensors are narrow: one intra-op thread runs them
    faster than many, and leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(values, width: int) -> np.ndarray:
    """(width, n) int32 little-endian byte rows of ``values``."""
    raw = b"".join(v.to_bytes(width, "little") for v in values)
    return np.frombuffer(raw, dtype=np.uint8).reshape(len(values), width).T.astype(np.int32)


def _value(col) -> int:
    return int.from_bytes(bytes(np.asarray(col).astype(np.uint8).tolist()), "little")


def _digest_case(n: int, seed: int) -> np.ndarray:
    """(64, n) digests: the edge values first, then random bytes."""
    rng = np.random.default_rng(seed)
    digest = rng.integers(0, 256, (64, n)).astype(np.int32)
    edges = _rows(EDGES, 64)[:, :n]
    digest[:, :edges.shape[1]] = edges
    return np.ascontiguousarray(digest)


def _aggregate_case(n: int, seed: int, live: int | None = None):
    """(z (16, n), k (32, n), s (32, n)): z = 1 and z = 2^128 - 1 among
    random 128-bit coefficients, k canonical (the edges below L among random
    k mod L), s random 256-bit S values (the edges among them); lanes from
    ``live`` on are padding as the aggregate layout writes it (s = 0, k =
    0)."""
    rng = np.random.default_rng(seed)
    z = rng.integers(0, 256, (16, n)).astype(np.int32)
    k = _rows([_value(c) % L for c in rng.integers(0, 256, (32, n)).T], 32)
    s = rng.integers(0, 256, (32, n)).astype(np.int32)
    specials = [v for v in EDGES if v < 2**256]
    m = min(n, len(specials))
    z[:, :2][:, : min(n, 2)] = _rows([1, 2**128 - 1], 16)[:, : min(n, 2)]
    k[:, :m] = _rows([v % L for v in specials[:m]], 32)
    s[:, :m] = _rows(specials[:m], 32)
    if live is not None:
        k[:, live:] = 0
        s[:, live:] = 0
    return tuple(np.ascontiguousarray(a) for a in (z, k, s))


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# --- the plain versions against the JAX package ----------------------------------


@pytest.mark.parametrize("n,seed", [(16, 1), (5, 2)])
def test_challenge_plain_matches_jax_and_bigint(n, seed):
    """k = H mod L of 64-byte digests (the edges: 0, L - 1, L, L + 1, 2L,
    2^252 - 1, 2^252, 2^512 - 1, multiples of L reducing to 0), as digits
    and as bytes: equal to JAX's ``signed_window_digits(reduce_bytes_mod_l)``
    and to Python's integers, tolerance 0; no launch."""
    digest = _digest_case(n, seed)
    before = KERNELS.stats("scalar25519").launches
    digits = sc.scalar_challenge(_t(digest)).numpy()
    k = sc.scalar_challenge(_t(digest), digits=False).numpy()
    assert KERNELS.stats("scalar25519").launches == before
    jk = np.asarray(jsc.reduce_bytes_mod_l(jnp.asarray(digest)))
    assert np.array_equal(k, jk)
    assert np.array_equal(digits, np.asarray(jsc.signed_window_digits(jk, 64)))
    assert digits.shape == (64, n) and k.shape == (32, n)
    assert [_value(k[:, i]) for i in range(n)] == [_value(digest[:, i]) % L for i in range(n)]
    if n >= len(EDGES):
        assert not k[:, len(EDGES) - 2:len(EDGES)].any()  # the multiples of L


@pytest.mark.parametrize("with_s", [True, False])
def test_aggregate_plain_matches_jax_and_bigint(with_s):
    """The digits of z k mod L (64 windows) and of z (33), and u = sum z s
    mod L, on 16 x 32 products over the edges: equal to the JAX
    compositions and to Python's integers; without s no u."""
    z, k, s = _aggregate_case(24, 3)
    zk_digits, z_digits, u = sc.scalar_aggregate(_t(z), _t(k), _t(s) if with_s else None)
    jzk = jsc.mul_mod_l(jnp.asarray(z), jnp.asarray(k))
    assert np.array_equal(zk_digits.numpy(), np.asarray(jsc.signed_window_digits(jzk, 64)))
    assert np.array_equal(z_digits.numpy(), np.asarray(jsc.signed_window_digits(
        jnp.asarray(z), 33)))
    if not with_s:
        assert u is None
        return
    ju = jsc.sum_mod_l(jsc.mul_mod_l(jnp.asarray(z), jnp.asarray(s)))
    assert u.shape == (32, 1) and np.array_equal(u.numpy(), np.asarray(ju))
    want = sum(_value(z[:, i]) * _value(s[:, i]) for i in range(z.shape[1])) % L
    assert _value(u.numpy()[:, 0]) == want


def test_sum_of_l_minus_one_on_every_lane_of_a_full_width():
    """s = L - 1 on all 8,192 lanes (the sum's columns far past 32 bits):
    u = -(sum z) mod L, the plain version's and Python's."""
    n = 8192
    rng = np.random.default_rng(5)
    z = rng.integers(0, 256, (16, n)).astype(np.int32)
    s = np.repeat(_rows([L - 1], 32), n, axis=1)
    k = np.zeros((32, n), dtype=np.int32)
    _, _, u = sc.scalar_aggregate(_t(z), _t(k), _t(s))
    total = sum(_value(z[:, i]) for i in range(n))
    assert _value(u.numpy()[:, 0]) == (-total) % L


# --- the kernel's per-lane code compiled for the host ---------------------------

_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "scalar25519.cu"
// L1's per-lane code on the host with the kernel's block schedule: blocks of
// LANES lanes, a lane past the batch adding zero to its block's column sums;
// then the one-block sum over the blocks' columns.  Outputs poisoned first.
//   harness challenge <n> <rows> <in: digest> <out: digits (64 x n), bytes (32 x n)>
//   harness aggregate <n> <with s> <in: z, k[, s]> <out: zk digits, z digits[, u]>
static bool read_all(FILE* f, void* p, size_t bytes) { return fread(p, 1, bytes, f) == bytes; }
int main(int argc, char** argv) {
  if (argc != 6) return 2;
  const long long n = atoll(argv[2]);
  const int arg = atoi(argv[3]);
  FILE* in = fopen(argv[4], "rb");
  if (!in) return 3;
  const bool challenge = strcmp(argv[1], "challenge") == 0;
  const int in_rows = challenge ? arg : 16 + 32 + (arg ? 32 : 0);
  std::vector<int32_t> x(in_rows * n);
  if (!read_all(in, x.data(), 4 * x.size())) return 3;
  fclose(in);
  std::vector<int32_t> out((challenge ? 64 + 32 : 64 + 33) * n + 32, 0x5a5a5a5a);
  scalar_args v = {x.data(), 0, 0, &out[0], 0, 0, 0, 0, n, MODE_CHALLENGE, arg};
  if (challenge) {
    v.bytes = &out[64 * n];
  } else {
    v = {x.data(), &x[16 * n], arg ? &x[48 * n] : 0, &out[0], &out[64 * n], 0,
         arg ? &out[97 * n] : 0, 0, n, MODE_AGGREGATE, 16};
  }
  const long long blocks = (n + LANES - 1) / LANES;
  std::vector<u64> partials(blocks * SUM_WORDS, 0x3c3c3c3c3c3cull);
  for (long long b = 0; b < blocks; ++b) {
    u64 cols[SUM_WORDS] = {0};
    for (int t = 0; t < LANES; ++t) {
      const long long lane = b * LANES + t;
      const scalar s = lane < n ? scalar_lane(v, lane) : scalar_zero();
      for (int j = 0; j < SUM_WORDS; ++j) cols[j] += s.w[j];
    }
    for (int j = 0; j < SUM_WORDS; ++j) partials[b * SUM_WORDS + j] = cols[j];
  }
  if (v.c) {
    u64 cols[SUM_WORDS] = {0};
    for (long long b = 0; b < blocks; ++b)
      for (int j = 0; j < SUM_WORDS; ++j) cols[j] += partials[b * SUM_WORDS + j];
    sum_columns(cols, v.u);
  }
  FILE* f = fopen(argv[5], "wb");
  if (!f || fwrite(out.data(), 4, out.size(), f) != out.size()) return 4;
  fclose(f);
  printf("blocks %lld lanes %d windows %d %d\n", blocks, LANES, K_WINDOWS, Z_WINDOWS);
  return 0;
}
"""


@pytest.fixture(scope="module")
def l1_harness(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("l1")
    return _host_build(tmp, _HARNESS, "l1"), tmp


def _run(harness, mode: str, n: int, arg: int, payload: bytes) -> np.ndarray:
    exe, tmp = harness
    (tmp / f"{mode}.in").write_bytes(payload)
    proc = subprocess.run(
        [str(exe), mode, str(n), str(arg), str(tmp / f"{mode}.in"), str(tmp / f"{mode}.out")],
        check=True, capture_output=True, text=True, timeout=300,
    )
    assert proc.stdout.split() == ["blocks", str(-(-n // sc.L1_LANES)), "lanes",
                                   str(sc.L1_LANES), "windows", "64", "33"]
    return np.frombuffer((tmp / f"{mode}.out").read_bytes(), dtype=np.int32)


@pytest.mark.parametrize("n", [1, 8, 70, 8192])
def test_challenge_kernel_code_matches_plain(l1_harness, n):
    """The challenge mode's lane code at ragged widths and the strict wave's
    8,192 lanes: digits and bytes equal the plain version's on every lane."""
    digest = _digest_case(n, n)
    got = _run(l1_harness, "challenge", n, 64, digest.tobytes())
    digits, k = got[:64 * n].reshape(64, n), got[64 * n:96 * n].reshape(32, n)
    assert np.array_equal(k, sc.scalar_challenge_reference(_t(digest), digits=False).numpy())
    assert np.array_equal(digits, sc.scalar_challenge_reference(_t(digest)).numpy())


def test_challenge_kernel_code_takes_short_digests(l1_harness):
    """A digest of fewer than 64 byte rows (the wrapper takes 1-64): its
    value mod L, as the plain version reads it."""
    digest = np.ascontiguousarray(_digest_case(9, 4)[:40])
    got = _run(l1_harness, "challenge", 9, 40, digest.tobytes())
    assert np.array_equal(got[:64 * 9].reshape(64, 9),
                          sc.scalar_challenge_reference(_t(digest)).numpy())


@pytest.mark.parametrize("n,live,with_s", [(1, None, True), (8, None, False), (8, None, True),
                                           (70, 66, True), (8192, 6860, True)])
def test_aggregate_kernel_code_matches_plain(l1_harness, n, live, with_s):
    """The aggregate mode's lane code and its sum at ragged widths, a
    certificate's 8 lanes with and without s (u given), and the randomized
    aggregate's 6,860 live lanes padded to 8,192: the digits and u equal
    the plain version's, tolerance 0."""
    z, k, s = _aggregate_case(n, n + 7, live)
    payload = z.tobytes() + k.tobytes() + (s.tobytes() if with_s else b"")
    got = _run(l1_harness, "aggregate", n, int(with_s), payload)
    want = sc.scalar_aggregate_reference(_t(z), _t(k), _t(s) if with_s else None)
    assert np.array_equal(got[:64 * n].reshape(64, n), want[0].numpy())
    assert np.array_equal(got[64 * n:97 * n].reshape(33, n), want[1].numpy())
    tail = got[97 * n:].reshape(32, 1)
    if with_s:
        assert np.array_equal(tail, want[2].numpy())
    else:
        assert (tail == 0x5a5a5a5a).all()  # u is not written


def test_aggregate_kernel_code_sums_l_minus_one_on_every_lane(l1_harness):
    n = 8192
    z = np.random.default_rng(6).integers(0, 256, (16, n)).astype(np.int32)
    k = np.zeros((32, n), dtype=np.int32)
    s = np.ascontiguousarray(np.repeat(_rows([L - 1], 32), n, axis=1))
    got = _run(l1_harness, "aggregate", n, 1, z.tobytes() + k.tobytes() + s.tobytes())
    total = sum(_value(z[:, i]) for i in range(n))
    assert _value(got[97 * n:]) == (-total) % L


# --- routing, refusals, builds, bounds ----------------------------------------------


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    seeds = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(n)]
    msgs = [rng.integers(0, 256, 60, dtype=np.uint8).tobytes() for _ in range(n)]
    return msgs, [ref_sign(s, m) for s, m in zip(seeds, msgs)], [ref_public_key(s) for s in seeds]


def test_fused_bodies_reach_the_scalar_stage_only_through_the_wrappers(monkeypatch):
    """The fused strict, randomized and half-aggregated bodies on CPU
    tensors, with ``reduce_bytes_mod_l``, ``mul_mod_l``, ``sum_mod_l`` and
    ``signed_window_digits`` guarded to run only inside an L1 wrapper: the
    strict wave calls ``scalar_challenge`` once, an aggregate check
    ``scalar_challenge`` (bytes) and ``scalar_aggregate`` (with s) once
    each, a certificate verify the same without s; the verdicts are right."""
    from test_torch_smoke_fused import _bigint_msm

    _bigint_msm(monkeypatch)
    inside: list[str] = []
    calls: collections.Counter = collections.Counter()
    forms: list = []
    for name in ("reduce_bytes_mod_l", "mul_mod_l", "sum_mod_l", "signed_window_digits"):
        orig = getattr(sc, name)

        def guarded(*a, _name=name, _orig=orig, **k):
            assert inside, f"scalar25519.{_name} ran outside an L1 wrapper"
            return _orig(*a, **k)

        monkeypatch.setattr(sc, name, guarded)
    for name in ("scalar_challenge", "scalar_aggregate"):
        orig = getattr(sc, name)

        def wrapped(*a, _name=name, _orig=orig, **k):
            calls[_name] += 1
            forms.append((_name, k.get("digits", True) if _name == "scalar_challenge"
                          else a[2] is not None))
            inside.append(_name)
            try:
                return _orig(*a, **k)
            finally:
                inside.pop()

        monkeypatch.setattr(sc, name, wrapped)

    msgs, sigs, keys = _batch(8, 11)
    strict = FusedEd25519BatchVerifier(min_device_batch=1, pad_to=8, device="cpu")
    assert strict.verify_batch(msgs, sigs, keys).tolist() == [True] * 8
    assert calls == {"scalar_challenge": 1} and forms == [("scalar_challenge", True)]
    calls.clear()
    forms.clear()
    rand = FusedEd25519RandomizedBatchVerifier(min_device_batch=1, pad_to=8, min_randomized=8,
                                               device="cpu")
    assert rand.verify_batch(msgs, sigs, keys).tolist() == [True] * 8
    assert calls == {"scalar_challenge": 1, "scalar_aggregate": 1}
    assert forms == [("scalar_challenge", False), ("scalar_aggregate", True)]
    calls.clear()
    forms.clear()
    host = HalfAggregator(min_device_batch=10**9, device="cpu")
    (rs, s_agg), bad = host.aggregate(msgs, sigs, keys)
    assert bad == ()
    agg = HalfAggregator(min_device_batch=1, pad_to=8, device_prep=True, device="cpu")
    assert agg.verify(msgs, list(rs), s_agg, keys)
    assert calls == {"scalar_challenge": 1, "scalar_aggregate": 1}
    assert forms == [("scalar_challenge", False), ("scalar_aggregate", False)]


def test_wrappers_refuse_what_the_kernel_does_not_take():
    z = torch.zeros((16, 4), dtype=torch.int32)
    k = torch.zeros((32, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"1\.\.64"):
        sc.scalar_challenge(torch.zeros((65, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"1\.\.64"):
        sc.scalar_challenge(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        sc.scalar_challenge(torch.zeros((64, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        sc.scalar_challenge(torch.zeros((64, 8), dtype=torch.int32)[:, ::2])
    with pytest.raises(ValueError, match=r"must be \(16, 4\)"):
        sc.scalar_aggregate(k, k)
    with pytest.raises(ValueError, match=r"must be \(32, 4\)"):
        sc.scalar_aggregate(z, k, z)
    with pytest.raises(TypeError, match="int32"):
        sc.scalar_aggregate(z, k.long())
    with pytest.raises(ValueError, match="one device"):
        sc.scalar_aggregate(z, k.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        sc.scalar_challenge(torch.zeros((64, 4), dtype=torch.int32, device="meta"))


def test_l1_bound_counts_the_plain_versions_work():
    """``chip_smoke.l1_bound``'s products are the counting shim's field-mul
    equivalents of the plain versions (each MUL_PRODUCTS 32x32->64-bit
    products), and its bytes each int32 row read and written once."""
    rng = np.random.default_rng(8)
    n = 3
    digest = _t(rng.integers(0, 256, (64, n)).astype(np.int32))
    z, k, s = (_t(a) for a in _aggregate_case(n, 9))
    count = limbs.measure_field_ops(sc.scalar_challenge_reference, digest)
    b = chip_smoke.l1_bound("challenge", n, 132, 1.98e9)
    assert b["products"] == count.muls * chip_smoke.MUL_PRODUCTS
    assert b["bytes"] == n * (64 + 64) * 4
    count = limbs.measure_field_ops(sc.scalar_challenge_reference, digest, digits=False)
    b = chip_smoke.l1_bound("challenge_bytes", n, 132, 1.98e9)
    assert b["products"] == count.muls * chip_smoke.MUL_PRODUCTS
    assert b["bytes"] == n * (64 + 32) * 4
    count = limbs.measure_field_ops(sc.scalar_aggregate_reference, z, k, s)
    b = chip_smoke.l1_bound("aggregate", n, 132, 1.98e9)
    assert b["products"] == count.muls * chip_smoke.MUL_PRODUCTS
    assert b["bytes"] == n * (16 + 32 + 32 + 64 + 33) * 4 + 32 * 4
    count = limbs.measure_field_ops(sc.scalar_aggregate_reference, z, k)
    b = chip_smoke.l1_bound("certificate", n, 132, 1.98e9)
    assert b["products"] == count.muls * chip_smoke.MUL_PRODUCTS
    assert b["bytes"] == n * (16 + 32 + 64 + 33) * 4
    b = chip_smoke.l1_bound("challenge", 8192, 132, 1.98e9)
    assert b["bound_by"] == "bytes" and 0.0012 < b["bound_ms"] < 0.0013


def test_phase_25_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's phase 25 at a tiny size on the CPU, where the wrappers
    run their plain versions (the MSM stood in for by its big-integer
    version): every case equal at tolerance 0, nothing launched."""
    from test_torch_smoke_fused import _bigint_msm

    _bigint_msm(monkeypatch)
    corpus = chip_smoke.make_corpus(24, per_class=1)
    rand = chip_smoke.make_corpus(24, per_class=1, classes=chip_smoke.RANDOMIZED_CLASSES)
    before = KERNELS.stats("scalar25519").launches
    r = chip_smoke.phase_scalar_kernel(torch.device("cpu"), corpus, rand, reps=1, plain_reps=1,
                                       replicas=1)
    assert KERNELS.stats("scalar25519").launches == before
    assert set(r) == {"strict", "aggregate", "recheck", "certificate", "one", "edges"}
    assert (r["strict"]["lanes"], r["certificate"]["lanes"], r["one"]["lanes"]) == (32, 8, 1)
    assert r["aggregate"]["live"] < r["aggregate"]["lanes"]
    for row in r.values():
        assert row["max_abs_err"] == 0.0 and row["ms"] > 0 and row["plain_ms"] > 0
