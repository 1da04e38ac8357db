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
import hashlib
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
from consensus_tpu_torch.ops import sha512 as sh
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
// L1's lane code on the host with the kernel's block schedule: blocks of
// lanes_a_block(mode) lanes, each lane's group of G roles run role by role (serial_group),
// a lane past the batch adding zero to its block's column sums; then the
// one-block sum over the blocks' columns.  Outputs poisoned first.
//   harness challenge <n> <rows, 0 for a state> <checks> <in: the state or
//     digest rows (int32); with checks sig (64 x n), key (32 x n), host_ok
//     (n) as bytes> <out: digits (64 x n), bytes (32 x n) int32, ok (n) bytes>
//   harness aggregate <n> <with s> 0 <in: z, k[, s]> <out: zk digits, z
//     digits[, u]>
static bool read_all(FILE* f, void* p, size_t bytes) { return fread(p, 1, bytes, f) == bytes; }
int main(int argc, char** argv) {
  if (argc != 7) return 2;
  const long long n = atoll(argv[2]);
  const int arg = atoi(argv[3]), checks = atoi(argv[4]);
  FILE* in = fopen(argv[5], "rb");
  if (!in) return 3;
  const bool challenge = strcmp(argv[1], "challenge") == 0;
  const int in_rows = challenge ? (arg ? arg : 16) : 16 + 32 + (arg ? 32 : 0);
  std::vector<int32_t> x(in_rows * n);
  if (!read_all(in, x.data(), 4 * x.size())) return 3;
  std::vector<uint8_t> sig(64 * n), key(32 * n), host_ok(n), ok(n, 0x5a);
  if (challenge && checks && !(read_all(in, sig.data(), sig.size())
                               && read_all(in, key.data(), key.size())
                               && read_all(in, host_ok.data(), host_ok.size())))
    return 3;
  fclose(in);
  std::vector<int32_t> out((challenge ? 64 + 32 : 64 + 33) * n + 32, 0x5a5a5a5a);
  scalar_args v = {};
  v.a = x.data();
  v.n = n;
  v.d64 = &out[0];
  if (challenge) {
    v.bytes = &out[64 * n];
    v.mode = MODE_CHALLENGE;
    v.a_rows = arg;
    if (checks) {
      v.sig = sig.data();
      v.key = key.data();
      v.host_ok = host_ok.data();
      v.ok = ok.data();
    }
  } else {
    v.b = &x[16 * n];
    v.c = arg ? &x[48 * n] : 0;
    v.d33 = &out[64 * n];
    v.u = arg ? &out[97 * n] : 0;
    v.mode = MODE_AGGREGATE;
    v.a_rows = 16;
  }
  const int lanes = lanes_a_block(v.mode);
  const long long blocks = (n + lanes - 1) / lanes;
  std::vector<u64> partials(blocks * SUM_WORDS, 0x3c3c3c3c3c3cull);
  for (long long b = 0; b < blocks; ++b) {
    u64 cols[SUM_WORDS] = {0};
    for (int t = 0; t < lanes; ++t) {
      const serial_group g;
      u32 contrib[G][8];
      scalar_group(g, v, b * lanes + t, contrib);
      for (int q = 0; q < G; ++q)
        for (int j = 0; j < SUM_WORDS; ++j) cols[j] += contrib[q][j];
    }
    for (int j = 0; j < SUM_WORDS; ++j) partials[b * SUM_WORDS + j] = cols[j];
  }
  if (v.c) {
    u64 cols[SUM_WORDS] = {0};
    for (long long b = 0; b < blocks; ++b)
      for (int j = 0; j < SUM_WORDS; ++j) cols[j] += partials[b * SUM_WORDS + j];
    sum_columns(cols, v.u);
  }
  FILE* f = fopen(argv[6], "wb");
  if (!f || fwrite(out.data(), 4, out.size(), f) != out.size()
      || fwrite(ok.data(), 1, ok.size(), f) != ok.size())
    return 4;
  fclose(f);
  printf("blocks %lld lanes %d group %d windows %d %d\n", blocks, lanes, G, K_WINDOWS, Z_WINDOWS);
  return 0;
}
"""

@pytest.fixture(scope="module")
def l1_harness(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("l1")
    return _host_build(tmp, _HARNESS, "l1"), tmp


def _run(harness, mode: str, n: int, arg: int, payload: bytes, checks: int = 0):
    """The harness's int32 outputs and, in the challenge mode, its ok bytes."""
    exe, tmp = harness
    (tmp / f"{mode}.in").write_bytes(payload)
    proc = subprocess.run(
        [str(exe), mode, str(n), str(arg), str(checks), str(tmp / f"{mode}.in"),
         str(tmp / f"{mode}.out")],
        check=True, capture_output=True, text=True, timeout=300,
    )
    words = proc.stdout.split()
    lanes = sc.L1_LANES if mode == "challenge" else sc.L1_SUM_LANES
    assert words[:4] == ["blocks", str(-(-n // lanes)), "lanes", str(lanes)]
    assert words[4:] == ["group", "4", "windows", "64", "33"]
    raw = (tmp / f"{mode}.out").read_bytes()
    size = 4 * ((64 + 32 if mode == "challenge" else 64 + 33) * n + 32)
    got = np.frombuffer(raw[:size], dtype=np.int32)
    return got if mode == "aggregate" else (got, np.frombuffer(raw[size:], dtype=np.uint8))


@pytest.mark.parametrize("n", [1, 8, 70, 8192])
def test_challenge_kernel_code_matches_plain(l1_harness, n):
    """The challenge mode's lane code at ragged widths and the strict wave's
    8,192 lanes: digits and bytes equal the plain version's on every lane."""
    digest = _digest_case(n, n)
    got, _ = _run(l1_harness, "challenge", n, 64, digest.tobytes())
    digits, k = got[:64 * n].reshape(64, n), got[64 * n:96 * n].reshape(32, n)
    assert np.array_equal(k, sc.scalar_challenge_reference(_t(digest), digits=False).numpy())
    assert np.array_equal(digits, sc.scalar_challenge_reference(_t(digest)).numpy())


def test_challenge_kernel_code_takes_short_digests(l1_harness):
    """A digest of fewer than 64 byte rows (the wrapper takes 1-64): its
    value mod L, as the plain version reads it."""
    digest = np.ascontiguousarray(_digest_case(9, 4)[:40])
    got, _ = _run(l1_harness, "challenge", 9, 40, digest.tobytes())
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


# --- the redesign: S1's state words, the canonical checks, the groups ------------

def _state(values) -> np.ndarray:
    """``chip_smoke.l1_state``: the S1 states whose digests read as
    ``values``, as numpy."""
    return chip_smoke.l1_state(values, "cpu").numpy()


def _state_case(n: int, seed: int) -> np.ndarray:
    """(8, 2, n) states: L1_EDGES' digests first, then random words."""
    rng = np.random.default_rng(seed)
    state = rng.integers(-2**31, 2**31, (8, 2, n)).astype(np.int32)
    edges = _state(chip_smoke.L1_EDGES)[..., :n]
    state[..., :edges.shape[-1]] = edges
    return np.ascontiguousarray(state)


def test_state_helper_is_what_s1_leaves():
    """``chip_smoke.l1_state`` is the inverse of ``digest_bytes``: S1's
    state words of a value read back as its little-endian bytes; and S1's
    plain version leaves those words for a real hash."""
    values = list(chip_smoke.L1_EDGES) + [12345, 2**511 + 7]
    got = sh.digest_bytes(_t(_state(values))).numpy()
    assert [_value(got[:, i]) for i in range(len(values))] == values
    blocks, n_blocks = sh.pad_messages([b"abc", b""])
    state = sh.sha512_blocks(sh.blocks_tensor(blocks), torch.from_numpy(n_blocks))
    want = [int.from_bytes(hashlib.sha512(m).digest(), "little") for m in (b"abc", b"")]
    assert np.array_equal(state.numpy(), _state(want))


def _check_rows(n: int, seed: int):
    """``chip_smoke.scalar_check_inputs`` as numpy: (state, sig, key,
    host_ok, the ok each lane should get)."""
    return tuple(t.numpy() if torch.is_tensor(t) else t
                 for t in chip_smoke.scalar_check_inputs("cpu", n, seed))


def _checked(harness, state, sig, key, host_ok):
    n = state.shape[-1]
    payload = state.tobytes() + sig.tobytes() + key.tobytes() + host_ok.astype(np.uint8).tobytes()
    got, ok = _run(harness, "challenge", n, 0, payload, checks=1)
    return got[:64 * n].reshape(64, n), got[64 * n:96 * n].reshape(32, n), ok


@pytest.mark.parametrize("n", [1, 37, 8192])
def test_challenge_kernel_code_reads_s1_state_words(l1_harness, n):
    """The challenge mode from S1's state (8, 2, n): k's
    digits and bytes equal the plain version's (``digest_bytes``, then
    ``scalar_challenge_reference``) on every lane, L1_EDGES' digests among
    them; without the checks' rows no ok is written."""
    state = _state_case(n, 40 + n)
    got, ok = _run(l1_harness, "challenge", n, 0, state.tobytes())
    digest = sh.digest_bytes(_t(state))
    assert np.array_equal(got[64 * n:96 * n].reshape(32, n),
                          sc.scalar_challenge_reference(digest, digits=False).numpy())
    assert np.array_equal(got[:64 * n].reshape(64, n),
                          sc.scalar_challenge_reference(_t(state)).numpy())
    assert (ok == 0x5a).all()


@pytest.mark.parametrize("n", [len(chip_smoke.L1_CHECK_LANES), 300])
def test_challenge_kernel_code_checks_the_canonical_ranges(l1_harness, n):
    """The checks in L1's challenge launch: over the
    synthetic lanes (S = L - 1, L, L + 1; y = p - 1, p for R and A; sign
    bits set on canonical and on p's y; host_ok cleared) and random ones,
    ok equals ``scalar_challenge_checked_reference`` (the fused body's former
    eager checks) and Python's integers, and the digits equal its digits."""
    state, sig, key, host_ok, want = _check_rows(n, n + 1)
    digits, _, ok = _checked(l1_harness, state, sig, key, host_ok)
    ref_digits, ref_ok = sc.scalar_challenge_checked_reference(
        _t(state), _t(sig), _t(key), _t(host_ok))
    assert np.array_equal(digits, ref_digits.numpy())
    assert np.array_equal(ok.astype(bool), ref_ok.numpy()) and set(ok.tolist()) <= {0, 1}
    assert np.array_equal(ok.astype(bool), want)
    assert want.any() and not want.all()


def test_challenge_kernel_code_checks_the_strict_waves_classes(l1_harness):
    """On a fused strict wave's own rows (every rejection class of
    chip_smoke's corpus: bad lengths, S >= L, y >= p for R and A, off-curve
    keys, wrong keys and messages; padded lanes), packed by the engine and
    hashed by S1's plain version: digits and ok equal the plain version's."""
    msgs, sigs, keys, _, _ = chip_smoke.make_corpus(24, per_class=1)
    engine = FusedEd25519BatchVerifier(min_device_batch=1, pad_to=32, device="cpu")
    sig, key, blocks, n_blocks, host_ok = engine._device_args(msgs, sigs, keys)
    state = sh.sha512_blocks(blocks, n_blocks)
    digits, _, ok = _checked(l1_harness, state.numpy(), sig.numpy(), key.numpy(),
                             host_ok.numpy())
    ref_digits, ref_ok = sc.scalar_challenge_checked_reference(state, sig, key, host_ok)
    assert np.array_equal(digits, ref_digits.numpy())
    assert np.array_equal(ok.astype(bool), ref_ok.numpy())
    assert 0 < ref_ok.sum() < 24


@pytest.mark.parametrize("n,live,with_s", [
    (1, None, False), (8, None, False), (33, None, False), (64, None, False), (65, None, False),
    (8192, None, False), (1, None, True), (16, None, True), (70, 66, True), (8192, 6860, True)])
def test_aggregate_kernel_code_splits_each_product_over_the_roles(l1_harness, n, live, with_s):
    """The aggregate mode's split products (z gathered over the group; with
    s, z k on one half of a lane's group and z s on the other, each half's
    roles forming its product's rows b_j z for their own words of b; without
    s the whole group forming z k), at widths around the blocks of 64
    lanes: the digits and u equal the plain version's."""
    z, k, s = _aggregate_case(n, n + 11, live)
    payload = z.tobytes() + k.tobytes() + (s.tobytes() if with_s else b"")
    got = _run(l1_harness, "aggregate", n, int(with_s), payload)
    want = sc.scalar_aggregate_reference(_t(z), _t(k), _t(s) if with_s else None)
    assert np.array_equal(got[:64 * n].reshape(64, n), want[0].numpy())
    assert np.array_equal(got[64 * n:97 * n].reshape(33, n), want[1].numpy())
    tail = got[97 * n:].reshape(32, 1)
    assert np.array_equal(tail, want[2].numpy()) if with_s else (tail == 0x5a5a5a5a).all()


@pytest.mark.parametrize("n", [1, 8, 64])
def test_aggregate_kernel_code_without_s_on_the_largest_products(l1_harness, n):
    """A certificate's aggregate (no s) where every row's carries run
    longest: z = 2^128 - 1 and k = L - 1 or 2^256 - 1 on alternate lanes
    (the byte rows the kernel takes may hold a k above L), with every word of
    z and k distinct on other lanes: the digits equal the plain version's."""
    rng = np.random.default_rng(40 + n)
    zs = [2**128 - 1 if i % 3 else int.from_bytes(rng.bytes(16), "little") for i in range(n)]
    ks = [(L - 1, 2**256 - 1)[i % 2] if i % 3 else int.from_bytes(rng.bytes(32), "little") % L
          for i in range(n)]
    z, k = _rows(zs, 16), _rows(ks, 32)
    got = _run(l1_harness, "aggregate", n, 0, z.tobytes() + k.tobytes())
    want = sc.scalar_aggregate_reference(_t(z), _t(k))
    assert np.array_equal(got[:64 * n].reshape(64, n), want[0].numpy())
    assert np.array_equal(got[64 * n:97 * n].reshape(33, n), want[1].numpy())
    digits = got[:64 * n].reshape(64, n)
    for i in range(n):
        value = sum((int(d) - 8) << (4 * (63 - j)) for j, d in enumerate(digits[:, i]))
        assert value == zs[i] * ks[i] % L


def _carry_scalars(windows: int) -> list[int]:
    """Scalars whose serial recoding carries through every window: nibble 0
    at 8 and every other nibble below the top at 7 (each window then
    carries into the next), and every nibble at 8."""
    top = windows - 1
    return [8 + sum(7 << (4 * j) for j in range(1, top)),
            sum(8 << (4 * j) for j in range(top)),
            8 + sum(7 << (4 * j) for j in range(1, top)) + (1 << (4 * top) if windows == 64 else 0)]


def _serial_digits(value: int, windows: int) -> list[int]:
    """The serial carry's digits + 8, most significant window first."""
    out, carry = [], 0
    for j in range(windows):
        t = ((value >> (4 * j)) & 0xF) + carry
        carry = int(t >= 8)
        out.append(t - 16 * carry + 8)
    return out[::-1]


def test_recoding_is_the_nibbles_of_a_constant_sum():
    """The carry-free recoding the kernel uses: over W windows the digits
    (+ 8) are the nibbles of s + sum_{j<W} 8 16^j, equal to the serial
    carry's on L1_EDGES mod L, random scalars below 2^253 (64 windows) and
    2^128 (33), and scalars whose carry runs through every window."""
    rng = np.random.default_rng(12)
    for windows, bound in ((64, 2**253), (33, 2**128)):
        c = sum(8 << (4 * j) for j in range(windows))
        values = [v % L % bound for v in chip_smoke.L1_EDGES] + _carry_scalars(windows)
        values += [int.from_bytes(rng.bytes(32), "little") % bound for _ in range(200)]
        for v in values:
            nibbles = [((v + c) >> (4 * j)) & 0xF for j in range(windows)][::-1]
            assert nibbles == _serial_digits(v, windows), hex(v)


def test_kernel_recoding_equals_the_serial_carry(l1_harness):
    """The kernel's recoding through the g++ replay: k =
    H mod L for H the carry-through scalars, L1_EDGES and random values (64
    windows), and z's 33 windows on the same kinds of z, equal to the plain
    version's serial carry (``signed_window_digits``)."""
    rng = np.random.default_rng(13)
    values = _carry_scalars(64) + list(chip_smoke.L1_EDGES)
    values += [int.from_bytes(rng.bytes(32), "little") % 2**253 for _ in range(30)]
    n = len(values)
    got, _ = _run(l1_harness, "challenge", n, 0, _state(values).tobytes())
    k = _rows([v % L for v in values], 32)
    assert np.array_equal(got[:64 * n].reshape(64, n),
                          sc.signed_window_digits(_t(k), 64).numpy())
    zs = _carry_scalars(33) + [1, 2**128 - 1] + [int.from_bytes(rng.bytes(16), "little")
                                                 for _ in range(30)]
    m = len(zs)
    z = _rows(zs, 16)
    kk = np.ascontiguousarray(k[:, :m])
    got = _run(l1_harness, "aggregate", m, 0, z.tobytes() + kk.tobytes())
    assert np.array_equal(got[64 * m:97 * m].reshape(33, m),
                          sc.signed_window_digits(_t(z), 33).numpy())


# --- routing, refusals, builds, bounds ----------------------------------------------


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    seeds = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(n)]
    msgs = [rng.integers(0, 256, 60, dtype=np.uint8).tobytes() for _ in range(n)]
    return msgs, [ref_sign(s, m) for s, m in zip(seeds, msgs)], [ref_public_key(s) for s in seeds]


def test_fused_bodies_reach_the_scalar_stage_only_through_the_wrappers(monkeypatch):
    """The fused strict (single and on 2 shards), randomized and
    half-aggregated bodies on CPU tensors, with ``reduce_bytes_mod_l``,
    ``mul_mod_l``, ``sum_mod_l``, ``signed_window_digits``, ``lt_l`` and
    ``field25519.bytes_lt_p`` guarded to run only inside an L1 wrapper, and
    every ``sha512.digest_bytes`` call logged: the strict wave calls
    ``scalar_challenge_checked`` once a shard (S1's state in, no digest
    pass, range check or recoding outside it), an aggregate check
    ``scalar_challenge`` (bytes, from S1's state, before any digest pass
    outside a wrapper) and ``scalar_aggregate`` (with s) once each, a
    certificate verify the same without s; the verdicts are right."""
    from test_torch_smoke_fused import _bigint_msm
    from consensus_tpu_torch.ops import field25519 as fe
    from consensus_tpu_torch.parallel import ShardedFusedEd25519Verifier, mesh_for_shards

    _bigint_msm(monkeypatch)
    inside: list[str] = []
    calls: collections.Counter = collections.Counter()
    forms: list = []
    events: list[str] = []
    guarded_fns = [(sc, name) for name in ("reduce_bytes_mod_l", "mul_mod_l", "sum_mod_l",
                                           "signed_window_digits", "lt_l")]
    for module, name in guarded_fns + [(fe, "bytes_lt_p")]:
        orig = getattr(module, name)

        def guarded(*a, _name=name, _orig=orig, **k):
            assert inside, f"{_name} ran outside an L1 wrapper"
            return _orig(*a, **k)

        monkeypatch.setattr(module, name, guarded)
    orig_digest = sh.digest_bytes

    def logged_digest(*a, **k):
        events.append("digest_bytes" + ("" if inside else " outside"))
        return orig_digest(*a, **k)

    monkeypatch.setattr(sh, "digest_bytes", logged_digest)
    for name in ("scalar_challenge", "scalar_challenge_checked", "scalar_aggregate"):
        orig = getattr(sc, name)

        def wrapped(*a, _name=name, _orig=orig, **k):
            calls[_name] += 1
            events.append(_name)
            form = {"scalar_challenge": lambda: k.get("digits", True),
                    "scalar_challenge_checked": lambda: True,
                    "scalar_aggregate": lambda: a[2] is not None}[_name]()
            forms.append((_name, form))
            if _name != "scalar_aggregate":
                assert tuple(a[0].shape[:2]) == (8, 2), "L1 was not given S1's state"
            inside.append(_name)
            try:
                return _orig(*a, **k)
            finally:
                inside.pop()

        monkeypatch.setattr(sc, name, wrapped)

    def reset():
        calls.clear()
        forms.clear()
        events.clear()

    msgs, sigs, keys = _batch(8, 11)
    strict = FusedEd25519BatchVerifier(min_device_batch=1, pad_to=8, device="cpu")
    assert strict.verify_batch(msgs, sigs, keys).tolist() == [True] * 8
    assert calls == {"scalar_challenge_checked": 1}
    assert forms == [("scalar_challenge_checked", True)]
    assert "digest_bytes outside" not in events
    reset()
    sharded = ShardedFusedEd25519Verifier(mesh_for_shards(2, device="cpu"), min_device_batch=1,
                                          pad_to=8, device="cpu")
    assert sharded.verify_batch(msgs, sigs, keys).tolist() == [True] * 8
    assert calls == {"scalar_challenge_checked": 2} and "digest_bytes outside" not in events
    reset()
    rand = FusedEd25519RandomizedBatchVerifier(min_device_batch=1, pad_to=8, min_randomized=8,
                                               device="cpu")
    assert rand.verify_batch(msgs, sigs, keys).tolist() == [True] * 8
    assert calls == {"scalar_challenge": 1, "scalar_aggregate": 1}
    assert forms == [("scalar_challenge", False), ("scalar_aggregate", True)]
    assert events[0] == "scalar_challenge"  # no digest pass before L1
    reset()
    host = HalfAggregator(min_device_batch=10**9, device="cpu")
    (rs, s_agg), bad = host.aggregate(msgs, sigs, keys)
    assert bad == ()
    agg = HalfAggregator(min_device_batch=1, pad_to=8, device_prep=True, device="cpu")
    assert agg.verify(msgs, list(rs), s_agg, keys)
    assert calls == {"scalar_challenge": 1, "scalar_aggregate": 1}
    assert forms == [("scalar_challenge", False), ("scalar_aggregate", False)]
    assert events[0] == "scalar_challenge"


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


def test_checked_wrapper_refuses_what_the_kernel_does_not_take():
    """``scalar_challenge_checked`` and the state form of
    ``scalar_challenge``: the rows must be uint8 of (64, n) and (32, n),
    host_ok bool (n,), one device, contiguous; a state must be (8, 2, n)
    int32 and contiguous."""
    state = torch.zeros((8, 2, 4), dtype=torch.int32)
    sig = torch.zeros((64, 4), dtype=torch.uint8)
    key = torch.zeros((32, 4), dtype=torch.uint8)
    ok = torch.ones(4, dtype=torch.bool)
    digits, got = sc.scalar_challenge_checked(state, sig, key, ok)
    assert digits.shape == (64, 4) and got.dtype == torch.bool and got.all()
    with pytest.raises(TypeError, match="uint8"):
        sc.scalar_challenge_checked(state, sig.to(torch.int32), key, ok)
    with pytest.raises(ValueError, match=r"must be \(32, 4\)"):
        sc.scalar_challenge_checked(state, sig, sig, ok)
    with pytest.raises(TypeError, match="bool"):
        sc.scalar_challenge_checked(state, sig, key, ok.to(torch.int32))
    with pytest.raises(ValueError, match=r"must be \(4,\)"):
        sc.scalar_challenge_checked(state, sig, key, ok[:3])
    with pytest.raises(ValueError, match="contiguous"):
        sc.scalar_challenge_checked(state, torch.zeros((64, 8), dtype=torch.uint8)[:, ::2], key,
                                    ok)
    with pytest.raises(ValueError, match="one device"):
        sc.scalar_challenge_checked(state, sig.to("meta"), key, ok)
    with pytest.raises(ValueError, match="contiguous"):
        sc.scalar_challenge(torch.zeros((8, 2, 8), dtype=torch.int32)[..., ::2])
    with pytest.raises(TypeError, match="int32"):
        sc.scalar_challenge(state.to(torch.int64))
    with pytest.raises(ValueError, match=r"1\.\.64"):
        sc.scalar_challenge(torch.zeros((8, 3, 4), dtype=torch.int32))


def test_l1_bound_counts_the_plain_versions_work():
    """``chip_smoke.l1_bound``'s products are the counting shim's field-mul
    equivalents of the plain versions (each MUL_PRODUCTS 32x32->64-bit
    products; the canonical checks add none), and its bytes each input the
    kernel reads and each output it writes, once: the strict body's S1
    state, signature and key rows and host_ok in, the digits and ok out;
    the aggregate body's state in, k's bytes out; z, k, s in, the digits
    (and u) out.  The first design's count reads 64 int32 digest rows
    instead, with no checks."""
    rng = np.random.default_rng(8)
    n = 3
    state, sig, key, host_ok, _ = chip_smoke.scalar_check_inputs("cpu", n, 8)
    z, k, s = (_t(a) for a in _aggregate_case(n, 9))
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    count = limbs.measure_field_ops(sc.scalar_challenge_checked_reference, state, sig, key,
                                    host_ok)
    digits, ok = sc.scalar_challenge_checked_reference(state, sig, key, host_ok)
    b = chip_smoke.l1_bound("challenge", n, 132, 1.98e9)
    assert b["products"] == count.muls * chip_smoke.MUL_PRODUCTS
    assert b["bytes"] == nbytes(state, sig, key, host_ok, digits, ok) == n * 418
    count = limbs.measure_field_ops(sc.scalar_challenge_reference, state, digits=False)
    b = chip_smoke.l1_bound("challenge_bytes", n, 132, 1.98e9)
    assert b["products"] == count.muls * chip_smoke.MUL_PRODUCTS
    assert b["bytes"] == nbytes(state, sc.scalar_challenge_reference(state, digits=False))
    count = limbs.measure_field_ops(sc.scalar_aggregate_reference, z, k, s)
    b = chip_smoke.l1_bound("aggregate", n, 132, 1.98e9)
    assert b["products"] == count.muls * chip_smoke.MUL_PRODUCTS
    assert b["bytes"] == nbytes(z, k, s, *sc.scalar_aggregate_reference(z, k, s))
    count = limbs.measure_field_ops(sc.scalar_aggregate_reference, z, k)
    b = chip_smoke.l1_bound("certificate", n, 132, 1.98e9)
    assert b["products"] == count.muls * chip_smoke.MUL_PRODUCTS
    assert b["bytes"] == nbytes(z, k, *sc.scalar_aggregate_reference(z, k)[:2])
    digest = _t(rng.integers(0, 256, (64, n)).astype(np.int32))
    b = chip_smoke.l1_bound("challenge", n, 132, 1.98e9, first_design=True)
    assert b["bytes"] == nbytes(digest, sc.scalar_challenge_reference(digest))
    b = chip_smoke.l1_bound("challenge_bytes", n, 132, 1.98e9, first_design=True)
    assert b["bytes"] == nbytes(digest, sc.scalar_challenge_reference(digest, digits=False))
    b = chip_smoke.l1_bound("challenge", 8192, 132, 1.98e9)
    assert b["bound_by"] == "bytes" and 0.00102 < b["bound_ms"] < 0.00103
    b = chip_smoke.l1_bound("challenge", 8192, 132, 1.98e9, first_design=True)
    assert 0.0012 < b["bound_ms"] < 0.0013


def test_ptxas_summary_names_each_mode_of_l1():
    """L1 is one kernel a mode, a template over the mode: ``ptxas_summary``
    books each instance under its own name (``scalar25519_kernel<0>`` and
    ``<1>``), so phase 25 can hold each to no stack frame and no spills."""
    report = """ptxas info    : Compiling entry function '_Z18scalar25519_kernelILi1EEv11scalar_args' for 'sm_90a'
ptxas info    : Function properties for _Z18scalar25519_kernelILi1EEv11scalar_args
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 256 bytes smem
ptxas info    : Compiling entry function '_Z18scalar25519_kernelILi0EEv11scalar_args' for 'sm_90a'
ptxas info    : Function properties for _Z18scalar25519_kernelILi0EEv11scalar_args
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
"""
    got = chip_smoke.ptxas_summary(report)
    assert got == {
        "scalar25519_kernel<1>": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                                  "registers": 64, "smem": 256},
        "scalar25519_kernel<0>": {"stack": 8, "spill_stores": 8, "spill_loads": 4,
                                  "registers": 40, "smem": 0},
    }


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
    assert set(r) == {"strict", "aggregate", "recheck", "certificate", "one", "edges", "mask"}
    assert (r["strict"]["lanes"], r["certificate"]["lanes"], r["one"]["lanes"]) == (32, 8, 1)
    assert r["aggregate"]["live"] < r["aggregate"]["lanes"]
    assert 0 < r["strict"]["ok_lanes"] < 24 and 0 < r["mask"]["ok_lanes"] < r["mask"]["lanes"]
    for row in r.values():
        assert row["max_abs_err"] == 0.0 and row["ms"] > 0 and row["plain_ms"] > 0
        assert row["first_graph_ms"] is None  # the first design runs on the card only
