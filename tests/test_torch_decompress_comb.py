"""Kernels D1 (Ed25519 point decompression) and D2 (the fixed-base comb
[S]B) against their plain versions and the JAX package.

The kernels' per-lane code (``csrc/decompress25519.cu``,
``csrc/comb25519.cu`` and what they use of ``csrc/ed25519_field.cuh``) is
``__host__ __device__``: compiled as plain C++ with g++ (no nvcc here) and
run lane by lane over outputs poisoned first, it must equal the port's plain
versions (``ops/ed25519.py::decompress`` / ``::fixed_base_mul_comb``) and
the JAX package's ``consensus_tpu.ops.ed25519.decompress`` /
``::fixed_base_mul_comb`` on frozen coordinates, tolerance 0 (integer
arithmetic mod p), with identical valid masks.  The wrappers
(``ops/scan_kernels.py::decompress`` / ``::fixed_base_mul_comb``) run the
plain versions on CPU tensors, launch nothing, and refuse what the kernels
do not take.  The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 18).
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from consensus_tpu.ops import ed25519 as jed
from consensus_tpu_torch.models import ed25519 as tmed
from consensus_tpu_torch.obs.kernels import KERNELS
from consensus_tpu_torch.ops import ed25519 as ted
from consensus_tpu_torch.ops import field25519 as tfe
from consensus_tpu_torch.ops import scan_kernels

P = tfe.P


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions' tensors are a few hundred lanes wide: one
    intra-op thread runs them faster than many, and leaves the cores to the
    other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: The kernels' geometry: D1's points a block, D2's lanes (groups of 4
#: threads) a block.
POINTS_A_BLOCK = 64
COMB_LANES_A_BLOCK = 16

_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "decompress25519.cu"
#include "comb25519.cu"
// The kernels' per-lane code on the host, over outputs poisoned before the
// run.  D1: every point in turn.  D2: the kernel's block schedule -- blocks
// of LANES groups, the lane of each group at comb_group_lane(block,
// thread), a group past the batch skipped, each group running its G roles
// in turn (serial_group) over its block's slots and digit stage, as the
// card's shared memory holds them, both poisoned before every block.
//   harness decompress[:<negate flags>] <m> <in: y limbs, signs> <out: X, Y, Z, T, valid>
//   harness comb <n> <in: table, digits> <out: X, Y, Z, T>
static bool read_parts(FILE* f, void* p, size_t bytes) { return fread(p, 1, bytes, f) == bytes; }
int main(int argc, char** argv) {
  if (argc != 5) return 2;
  const long long n = atoll(argv[2]);
  FILE* in = fopen(argv[3], "rb");
  if (!in) return 3;
  std::vector<float> out(4 * 32 * n, -7.0f);
  float* o[4] = {&out[0], &out[32 * n], &out[64 * n], &out[96 * n]};
  std::vector<uint8_t> valid;
  long long blocks = 0;
  if (strncmp(argv[1], "decompress", 10) == 0) {
    const int negate = argv[1][10] == ':' ? atoi(argv[1] + 11) : 0;
    std::vector<float> y(32 * n);
    std::vector<int32_t> sign(n);
    if (!read_parts(in, y.data(), 4 * y.size()) || !read_parts(in, sign.data(), 4 * n)) return 3;
    valid.assign(n, 0xa5);
    for (long long lane = 0; lane < n; ++lane)
      decompress_point(y.data(), sign.data(), o[0], o[1], o[2], o[3], valid.data(), n, lane,
                       point_negated(n, lane, negate));
    blocks = (n + POINTS - 1) / POINTS;
  } else {
    std::vector<u64> table(COMB_WINDOWS * COMB_ENTRIES * ENTRY_WORDS);
    std::vector<int32_t> digits(32 * n);
    if (!read_parts(in, table.data(), 8 * table.size()) ||
        !read_parts(in, digits.data(), 4 * digits.size())) return 3;
    blocks = (n + LANES - 1) / LANES;
    for (long long b = 0; b < blocks; ++b) {
      static fe slots[LANES][2][G];
      static int32_t stages[LANES][COMB_WINDOWS];
      memset(slots, 0x5a, sizeof slots);
      memset(stages, 0xa5, sizeof stages);
      for (int t = 0; t < THREADS; t += G) {
        const long long lane = comb_group_lane(b, t);
        if (lane >= n) continue;
        const serial_group g = {0, G, slots[t / G]};
        comb_lane(g, stages[t / G], table.data(), digits.data(), o[0], o[1], o[2], o[3], n, lane);
      }
    }
  }
  fclose(in);
  FILE* f = fopen(argv[4], "wb");
  fwrite(out.data(), 4, out.size(), f);
  fwrite(valid.data(), 1, valid.size(), f);
  fclose(f);
  printf("%lld blocks; %d points a block; %d lanes of %d roles a block\n", blocks, POINTS,
         LANES, G);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The harness compiled with g++ against ``csrc/``; skips where the box
    has no host C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernels' per-lane code")
    tmp = tmp_path_factory.mktemp("d1d2")
    (tmp / "harness.cpp").write_text(_HARNESS)
    exe = tmp / "harness"
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-x", "c++", f"-I{scan_kernels._CSRC}", "-o", str(exe),
         str(tmp / "harness.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    return exe, tmp


def _run(harness, mode: str, n: int, payload: bytes, negate: int = 0):
    exe, tmp = harness
    (tmp / f"{mode}-{n}.in").write_bytes(payload)
    proc = subprocess.run(
        [str(exe), f"{mode}:{negate}" if negate else mode, str(n), str(tmp / f"{mode}-{n}.in"),
         str(tmp / f"{mode}-{n}.out")],
        check=True, capture_output=True, text=True, timeout=300,
    )
    per_block = {"decompress": POINTS_A_BLOCK, "comb": COMB_LANES_A_BLOCK}[mode]
    assert proc.stdout.split() == [
        str(-(-n // per_block)), "blocks;", str(POINTS_A_BLOCK), "points", "a", "block;",
        str(COMB_LANES_A_BLOCK), "lanes", "of", "4", "roles", "a", "block",
    ]
    raw = (tmp / f"{mode}-{n}.out").read_bytes()
    coords = np.frombuffer(raw[: 4 * 4 * 32 * n], dtype=np.float32).reshape(4, 32, n)
    return coords.copy(), np.frombuffer(raw[4 * 4 * 32 * n:], dtype=np.uint8)


def _frozen(point) -> np.ndarray:
    """(4, 32, n) canonical limbs of a torch or JAX point."""
    return np.stack([
        tfe.freeze(torch.from_numpy(np.array(c, dtype=np.float32))).numpy() for c in point
    ])


def _limbs(values) -> np.ndarray:
    return np.stack([tfe.int_to_limbs(v) for v in values], axis=1).astype(np.float32)


# --- D1: decompression ---------------------------------------------------------


def _decompress_case():
    """(y limbs (32, m) float32, signs (m,) int32, class of each lane):
    R and A encodings of RFC 8032 signatures, the base point and its
    negation, y = +-1 with both sign bits (x = 0), off-curve y's, y >= p
    (both signs), random y's with random signs, and a few of the valid
    encodings in weak limbs with negative entries."""
    rng = np.random.default_rng(31)
    ys, signs, kinds = [], [], []

    def add(kind, y, s):
        ys.append(y)
        signs.append(s)
        kinds.append(kind)

    for i in range(48):
        seed = rng.bytes(32)
        msg = rng.bytes(int(rng.integers(0, 80)))
        sig, key = tmed.ref_sign(seed, msg), tmed.ref_public_key(seed)
        for kind, enc in (("R", sig[:32]), ("A", key)):
            v = int.from_bytes(enc, "little")
            add(kind, v & ((1 << 255) - 1), v >> 255)
    add("base", ted._BY, 0)
    add("base", ted._BY, 1)
    for y in (1, P - 1):
        for s in (0, 1):
            add("x=0", y, s)
    for y in chip_smoke._off_curve_ys(16):
        add("off-curve", y, int(rng.integers(0, 2)))
    for y in (P, P + 1, P + 2, P + 18, (1 << 255) - 1):
        for s in (0, 1):
            add("y>=p", y, s)
    while len(ys) < 288:
        add("random", int.from_bytes(rng.bytes(32), "little") >> 1, int(rng.integers(0, 2)))
    y = torch.from_numpy(_limbs(ys))
    weak = [i for i, k in enumerate(kinds) if k in ("R", "A")][:24]
    y[:, weak] = chip_smoke.weaken(y[:, weak])
    assert float(y.min()) < 0
    return y.numpy(), np.array(signs, dtype=np.int32), kinds


@pytest.fixture(scope="module")
def decompress_case():
    return _decompress_case()


@pytest.fixture(scope="module")
def jax_decompressed(decompress_case):
    """JAX's ``decompress`` of the whole corpus: frozen (4, 32, m) and the
    valid mask."""
    y, sign, _ = decompress_case
    pt, ok = jed.decompress(jnp.asarray(y), jnp.asarray(sign))
    return _frozen(pt), np.asarray(ok)


def test_decompress_kernel_code_compiled_for_the_host_matches_plain_and_jax(
    harness, decompress_case, jax_decompressed
):
    """D1's per-lane code on 288 lanes of every input class: frozen X, Y, Z,
    T and the valid mask equal to the plain version's and to JAX's
    ``decompress``; the kernel writes canonical limbs."""
    y, sign, kinds = decompress_case
    m = y.shape[1]
    got, valid = _run(harness, "decompress", m, y.tobytes() + sign.tobytes())
    assert got.min() >= 0 and got.max() <= 255
    assert np.array_equal(got, _frozen(torch.from_numpy(got)))  # canonical limbs
    plain, plain_ok = scan_kernels.decompress_reference(torch.from_numpy(y), torch.from_numpy(sign))
    jax_frozen, jax_ok = jax_decompressed
    assert valid.dtype == np.uint8 and set(valid.tolist()) <= {0, 1}
    assert np.array_equal(valid.astype(bool), plain_ok.numpy())
    assert np.array_equal(valid.astype(bool), jax_ok)
    want = _frozen(plain)
    for name, g, w, j in zip("XYZT", got, want, jax_frozen):
        assert np.array_equal(g, w), (name, np.flatnonzero((g != w).any(axis=0))[:8])
        assert np.array_equal(g, j), name
    # Every class reached the kernel, and the mask is the one RFC 8032 gives.
    by_kind = {}
    for k, ok in zip(kinds, valid.astype(bool)):
        by_kind.setdefault(k, []).append(bool(ok))
    assert all(by_kind["R"]) and all(by_kind["A"]) and by_kind["base"] == [True, True]
    assert by_kind["x=0"] == [True, False, True, False]
    assert not any(by_kind["off-curve"])
    assert any(by_kind["random"]) and not all(by_kind["random"])
    # y >= p decodes as y - p (the host, not the device, rejects it): y = p
    # as y = 0 (x = sqrt(-1)), y = p + 1 as y = 1 (x = 0).
    assert by_kind["y>=p"][:4] == [True, True, True, False]


def test_decompress_kernel_code_base_point_coordinates(harness):
    """The base point's encoding gives (B_x, B_y, 1, B_x B_y) and its sign
    bit -B, as big integers."""
    y = _limbs([ted._BY, ted._BY])
    got, valid = _run(harness, "decompress", 2, y.tobytes() + np.array([0, 1], np.int32).tobytes())
    x, yy, z, t = ([tfe.limbs_to_int(c[:, i]) for i in range(2)] for c in got)
    assert valid.tolist() == [1, 1]
    assert x == [ted._BX, P - ted._BX] and yy == [ted._BY] * 2 and z == [1, 1]
    assert t == [ted._BX * ted._BY % P, (P - ted._BX) * ted._BY % P]


@pytest.mark.parametrize("negate", [(False, True), (True, True), (True, False)])
def test_decompress_kernel_code_negate_option_matches_plain_and_jax(
    harness, decompress_case, jax_decompressed, negate
):
    """D1's negate option (the strict body's -A, the batch bodies' -R and
    -A, and R alone) on the 288-lane corpus: frozen X, Y, Z, T equal to the
    plain decompression followed by ``ops/ed25519.py::negate`` on the chosen
    halves (the wrapper's plain version on a CPU tensor), and to JAX's
    ``negate`` of its ``decompress``; canonical limbs; the valid mask
    unchanged."""
    y, sign, _ = decompress_case
    m = y.shape[1]
    flags = int(negate[0]) | int(negate[1]) << 1
    got, valid = _run(harness, "decompress", m, y.tobytes() + sign.tobytes(), negate=flags)
    assert got.min() >= 0 and got.max() <= 255
    plain, plain_ok = scan_kernels.decompress(torch.from_numpy(y), torch.from_numpy(sign),
                                              negate)
    assert np.array_equal(valid.astype(bool), plain_ok.numpy())
    want = _frozen(plain)
    half = m // 2
    base = jax_decompressed[0]  # JAX's decompress, frozen
    jhalves = [jed.Point(*(jnp.asarray(c[:, cols]) for c in base))
               for cols in (slice(0, half), slice(half, m))]
    jhalves = [jed.negate(h) if f else h for h, f in zip(jhalves, negate)]
    jax_frozen = np.concatenate([_frozen(h) for h in jhalves], axis=2)
    for name, g, w, j in zip("XYZT", got, want, jax_frozen):
        assert np.array_equal(g, w), (name, np.flatnonzero((g != w).any(axis=0))[:8])
        assert np.array_equal(g, j), name
    assert np.array_equal(got[1:3], base[1:3])  # Y and Z are the decompression's


def test_decompress_negate_option_wrapper_on_cpu():
    """On a CPU tensor the option is the plain decompression, then
    ``ops/ed25519.py::negate`` on each chosen half, limb for limb (the limbs
    the bodies negated before), with no launch; an odd stack is refused."""
    y = torch.from_numpy(_limbs([ted._BY] * 4))
    sign = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    before = KERNELS.stats("decompress25519").launches
    got, ok = scan_kernels.decompress(y, sign, (False, True))
    assert KERNELS.stats("decompress25519").launches == before
    pt, want_ok = ted.decompress(y, sign)
    neg_a = ted.negate(ted.Point(*(c[:, 2:] for c in pt)))
    assert torch.equal(ok, want_ok)
    for g, w, n in zip(got, pt, neg_a):
        assert torch.equal(g[:, :2], w[:, :2]) and torch.equal(g[:, 2:], n)
    with pytest.raises(ValueError, match="two halves"):
        scan_kernels.decompress(y[:, :3].contiguous(), sign[:3].contiguous(), (True, False))


# --- D2: the fixed-base comb -------------------------------------------------


def _comb_digits(scalars) -> np.ndarray:
    rows = np.frombuffer(b"".join(s.to_bytes(32, "little") for s in scalars), dtype=np.uint8)
    return tmed._bits_to_comb_digits8(tmed._bytes_rows_to_bits(rows.reshape(-1, 32)))


def _comb_case():
    """(32, 260) int32 digits: S = 0, S = L - 1, a lane of 255 in every
    window, lanes with digit 0 and 255 in alternate windows, random
    scalars below L and random bytes."""
    rng = np.random.default_rng(37)
    scalars = [0, tmed.L - 1, 1, tmed.L - 2] + [
        int.from_bytes(rng.bytes(32), "little") % tmed.L for _ in range(120)
    ]
    digits = np.concatenate(
        [_comb_digits(scalars), rng.integers(0, 256, size=(32, 136))], axis=1
    ).astype(np.int32)
    digits[:, -4] = 255
    digits[::2, -3], digits[1::2, -3] = 0, 255
    digits[::2, -2], digits[1::2, -2] = 255, 0
    digits[:, -1] = 0
    assert (digits == 0).any(axis=1).all() and (digits == 255).any(axis=1).all()
    return digits


@pytest.fixture(scope="module")
def jax_combed():
    """JAX's ``fixed_base_mul_comb`` of the whole comb corpus, frozen."""
    return _frozen(jed.fixed_base_mul_comb(jnp.asarray(_comb_case())))


def _table_bytes() -> bytes:
    table = scan_kernels.comb_niels_np()
    assert table.shape == (32, 256, 3, 5) and table.dtype == np.uint64
    return table.tobytes()


@pytest.mark.parametrize("width", [260, 1])
def test_comb_kernel_code_compiled_for_the_host_matches_plain_and_jax(harness, width):
    """D2's per-lane code on 260 lanes (digit 0 and 255 in every window,
    S = 0, S = L - 1) and at batch 1: frozen X, Y, Z, T equal to the plain
    version's and to JAX's ``fixed_base_mul_comb`` (the same projective
    representative: digit 0 is added, not skipped), canonical limbs, and
    the affine point equal to [S]B in big integers."""
    digits = np.ascontiguousarray(_comb_case()[:, :width] if width > 1 else _comb_case()[:, 1:2])
    got, _ = _run(harness, "comb", width, _table_bytes() + digits.tobytes())
    assert got.min() >= 0 and got.max() <= 255
    plain = scan_kernels.fixed_base_mul_comb_reference(torch.from_numpy(digits))
    jax_pt = jed.fixed_base_mul_comb(jnp.asarray(digits))
    for name, g, w, j in zip("XYZT", got, _frozen(plain), _frozen(jax_pt)):
        assert np.array_equal(g, w), (name, np.flatnonzero((g != w).any(axis=0))[:8])
        assert np.array_equal(g, j), name
    for lane in range(0, width, 37):
        s = int.from_bytes(bytes(digits[:, lane].astype(np.uint8)), "little")
        x, y, z, _ = (tfe.limbs_to_int(c[:, lane]) for c in got)
        wx, wy, wz, _ = tmed._ref_mul(s, tmed._BASE_POINT)
        assert (x * wz - wx * z) % P == 0 and (y * wz - wy * z) % P == 0


@pytest.mark.parametrize("width", [1, 3, 17, 65])
def test_kernel_code_at_ragged_widths_matches_plain_and_jax(
    harness, decompress_case, jax_decompressed, jax_combed, width
):
    """Widths where a block (D1's 64 points, D2's 16 lanes of 4 roles) or a
    group straddles the batch's end, over lanes drawn from both corpora: D1's
    valid mask and frozen X, Y, Z, T and D2's frozen X, Y, Z, T equal to the
    plain versions' and to JAX's on every lane (JAX's outputs of the whole
    corpora, at the drawn lanes), none left poisoned."""
    y, sign, _ = decompress_case
    pick = np.random.default_rng(width).permutation(y.shape[1])[:width]
    y_w, sign_w = np.ascontiguousarray(y[:, pick]), np.ascontiguousarray(sign[pick])
    got, valid = _run(harness, "decompress", width, y_w.tobytes() + sign_w.tobytes())
    plain, plain_ok = scan_kernels.decompress_reference(torch.from_numpy(y_w),
                                                        torch.from_numpy(sign_w))
    assert np.array_equal(valid.astype(bool), plain_ok.numpy())
    assert np.array_equal(valid.astype(bool), jax_decompressed[1][pick])
    for g, w, j in zip(got, _frozen(plain), jax_decompressed[0][:, :, pick]):
        assert np.array_equal(g, w) and np.array_equal(g, j)

    digits = np.ascontiguousarray(_comb_case()[:, pick % 260])
    got, _ = _run(harness, "comb", width, _table_bytes() + digits.tobytes())
    assert got.min() >= 0
    plain = scan_kernels.fixed_base_mul_comb_reference(torch.from_numpy(digits))
    for g, w, j in zip(got, _frozen(plain), jax_combed[:, :, pick % 260]):
        assert np.array_equal(g, w) and np.array_equal(g, j)


def test_comb_table_is_the_plain_tables_niels_form():
    """Entry [j][d] of D2's table is (y - x, y + x, 2d x y) mod p of the plain
    comb table's entry, in canonical radix-2^51 limbs; [j][0] is the
    identity's (1, 1, 0)."""
    table = scan_kernels.comb_niels_np()
    xs, ys, ts = ted._comb_table_np()
    assert (table < (1 << 51)).all()

    def value(words) -> int:
        return sum(int(w) << (51 * i) for i, w in enumerate(words))

    for j, d in ((0, 0), (0, 1), (5, 200), (31, 255), (17, 0)):
        x, y, t = (tfe.limbs_to_int(a[j, d]) for a in (xs, ys, ts))
        assert [value(table[j, d, c]) for c in range(3)] == [
            (y - x) % P, (y + x) % P, 2 * tfe.D * t % P
        ]
    assert [value(table[9, 0, c]) for c in range(3)] == [1, 1, 0]
    # Built once per device, the same bits as int64.
    t_cpu = scan_kernels.comb_niels_table(torch.device("cpu"))
    assert t_cpu is scan_kernels.comb_niels_table(torch.device("cpu"))
    assert t_cpu.dtype == torch.int64 and np.array_equal(t_cpu.numpy().view(np.uint64), table)


# --- the wrappers on CPU tensors ---------------------------------------------


def test_wrappers_run_the_plain_versions_on_cpu_without_a_launch(decompress_case):
    y, sign, _ = decompress_case
    y_t, sign_t = torch.from_numpy(y[:, :40].copy()), torch.from_numpy(sign[:40].copy())
    digits = torch.from_numpy(np.ascontiguousarray(_comb_case()[:, :9]))
    before = (KERNELS.stats("decompress25519").launches, KERNELS.stats("comb25519").launches)
    pt, ok = scan_kernels.decompress(y_t, sign_t)
    comb = scan_kernels.fixed_base_mul_comb(digits)
    assert (KERNELS.stats("decompress25519").launches, KERNELS.stats("comb25519").launches) == before
    want_pt, want_ok = ted.decompress(y_t, sign_t)
    assert ok.dtype == torch.bool and torch.equal(ok, want_ok)
    for g, w in zip((*pt, *comb), (*want_pt, *ted.fixed_base_mul_comb(digits))):
        assert torch.equal(g, w)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    y = torch.from_numpy(_limbs([ted._BY] * 4))
    sign = torch.zeros(4, dtype=torch.int32)
    digits = torch.zeros((32, 4), dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        scan_kernels.decompress(y.double(), sign)
    with pytest.raises(TypeError, match="int32"):
        scan_kernels.decompress(y, sign.long())
    with pytest.raises(ValueError, match=r"\(32, batch\)"):
        scan_kernels.decompress(y[:31].contiguous(), sign)
    with pytest.raises(ValueError, match=r"must be \(4,\)"):
        scan_kernels.decompress(y, torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="one device"):
        scan_kernels.decompress(y, sign.to("meta"))
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.from_numpy(_limbs([ted._BY] * 8))
        scan_kernels.decompress(wide[:, ::2], sign)
    with pytest.raises(TypeError, match="int32"):
        scan_kernels.fixed_base_mul_comb(digits.to(torch.uint8))
    with pytest.raises(ValueError, match=r"must be \(32, 4\)"):
        scan_kernels.fixed_base_mul_comb(digits[:31].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        scan_kernels.fixed_base_mul_comb(torch.zeros((32, 8), dtype=torch.int32)[:, ::2])
