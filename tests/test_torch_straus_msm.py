"""The port's Straus MSM against the JAX package.

The randomized verifier's shared-doubling multi-scalar multiplication:
``multiples_table9``, ``batch_sum`` and ``straus_shared_msm`` of
``consensus_tpu_torch/ops/ed25519.py`` are held limb for limb against the
JAX module's on the same numpy inputs (the XLA path the JAX verifier takes by
default, no ``CTPU_MXU_LIMBS``), and ``straus_msm_reference`` (the plain
version of kernel B3) against a pure-Python sum of scalar multiplications
in affine coordinates.  The kernel's arithmetic and the schedule of its
four kernels (tables, window sums, join, split-role Horner chain) are
held against the same sum compiled as plain C++ with g++, and the chain's
split stages against the unsplit point operations limb for limb; the
kernel itself runs only on the card (tests/test_torch_cuda.py, chip_smoke.py phase 6).
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from consensus_tpu.models import ed25519 as jmed
from consensus_tpu.ops import ed25519 as jed
from consensus_tpu.ops import pallas_scan
from consensus_tpu_torch.models import ed25519 as tmed
from consensus_tpu_torch.obs.kernels import KERNELS
from consensus_tpu_torch.ops import ed25519 as ted
from consensus_tpu_torch.ops import field25519 as tfe
from consensus_tpu_torch.ops import scan_kernels

P = tfe.P
N = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path's tensors are a few dozen lanes wide: one intra-op
    thread runs them faster than many, and leaves the cores to the other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _walk(n: int, offset: int) -> list[tuple[int, int]]:
    """n distinct points: (offset + 1)B, (offset + 2)B, ..."""
    base = (ted._BX, ted._BY)
    cur = base
    for _ in range(offset):
        cur = ted._edwards_add_int(cur, base)
    pts = []
    for _ in range(n):
        pts.append(cur)
        cur = ted._edwards_add_int(cur, base)
    return pts


def _neg_limbs(points) -> list[np.ndarray]:
    """(-P) for affine ``points`` in the weak limbs the port's ``negate``
    produces, as four (32, n) float32 arrays."""
    cols = (
        [x for x, _ in points], [y for _, y in points], [1] * len(points),
        [x * y % P for x, y in points],
    )
    coords = [torch.from_numpy(np.stack([tfe.int_to_limbs(v) for v in c], axis=1)) for c in cols]
    return [c.contiguous().numpy() for c in ted.negate(ted.Point(*coords))]


def _digits(values, windows) -> np.ndarray:
    return tmed._signed_digits_rows(values, windows).astype(np.int32)


def _msm_case(n: int, seed: int, masked=(), n_low: int = tmed._Z_WINDOWS):
    """-A, -R for A = (j+1)B and R = (j+51)B, scalars zk < L and z from
    numpy seed ``seed`` over ``n_low`` windows (z < 2^128 for the engine's
    33, z < L for 64, none for 0); ``masked`` lanes get all-8 digits
    (scalar 0)."""
    a_pts, r_pts = _walk(n, 0), _walk(n, 50)
    rng = np.random.default_rng(seed)
    zk = [int.from_bytes(rng.bytes(32), "little") % tmed.L for _ in range(n)]
    if n_low == tmed._Z_WINDOWS:
        zs = [int.from_bytes(rng.bytes(16), "little") or 1 for _ in range(n)]
    elif n_low == tmed._WINDOWS:
        zs = [int.from_bytes(rng.bytes(32), "little") % tmed.L or 1 for _ in range(n)]
    elif n_low == 0:
        zs = [0] * n
    else:
        raise ValueError(f"no case for n_low {n_low}")
    for i in masked:
        zk[i] = zs[i] = 0
    z_digits = _digits(zs, n_low) if n_low else np.zeros((0, n), dtype=np.int32)
    return {
        "a_pts": a_pts, "r_pts": r_pts, "zk": zk, "zs": zs,
        "neg_a": _neg_limbs(a_pts), "neg_r": _neg_limbs(r_pts),
        "zk_digits": _digits(zk, tmed._WINDOWS), "z_digits": z_digits,
    }


def _bigint_msm(case) -> tuple[int, int]:
    """sum [zk_i](-A_i) + [z_i](-R_i) with the RFC 8032 reference, affine."""
    acc = tmed._REF_IDENTITY
    for (ax, ay), (rx, ry), k, z in zip(case["a_pts"], case["r_pts"], case["zk"], case["zs"]):
        for (x, y), s in (((ax, ay), k), ((rx, ry), z)):
            neg = ((P - x) % P, y, 1, (P - x * y % P) % P)
            acc = tmed._ref_add(acc, tmed._ref_mul(s, neg))
    zi = pow(acc[2], P - 2, P)
    return acc[0] * zi % P, acc[1] * zi % P


def _affine(point: ted.Point) -> tuple[int, int]:
    x, y = chip_smoke.affine(ted.Point(*(c[:, :1] for c in point)))
    return tfe.limbs_to_int(x[:, 0]), tfe.limbs_to_int(y[:, 0])


def _torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _jax_xla_msm(ax, ay, az, at, rx, ry, rz, rt, zk_digits, z_digits):
    """The JAX verifier's default MSM (models/ed25519.py batch_verify_impl)."""
    a_table = jed.multiples_table9(jed.Point(ax, ay, az, at))
    r_table = jed.multiples_table9(jed.Point(rx, ry, rz, rt))
    return jed.straus_shared_msm(a_table, r_table, zk_digits, z_digits)


@pytest.fixture(scope="module")
def msm_case():
    case = _msm_case(N, seed=17, masked=(2,))
    jax_in = [jnp.asarray(c) for c in (*case["neg_a"], *case["neg_r"])]
    case["xla"] = [
        np.asarray(c) for c in jax.jit(_jax_xla_msm)(
            *jax_in, jnp.asarray(case["zk_digits"]), jnp.asarray(case["z_digits"])
        )
    ]
    case["ref"] = scan_kernels.straus_msm_reference(
        ted.Point(*_torch(case["neg_a"])), ted.Point(*_torch(case["neg_r"])),
        *_torch([case["zk_digits"], case["z_digits"]]),
    )
    return case


@pytest.mark.parametrize("width", [1, 3, 5, 8])
def test_batch_sum_matches_jax_limb_for_limb(width):
    limbs = _neg_limbs(_walk(width, 3))
    want = jed.batch_sum(jed.Point(*(jnp.asarray(c) for c in limbs)))
    got = ted.batch_sum(ted.Point(*_torch(limbs)))
    assert got.x.shape == (32, 1)
    for name, w, g in zip("xyzt", want, got):
        assert np.array_equal(np.asarray(w), g.numpy()), name


def test_multiples_table9_matches_jax_limb_for_limb(msm_case):
    want = jed.multiples_table9(jed.Point(*(jnp.asarray(c) for c in msm_case["neg_a"])))
    got = ted.multiples_table9(ted.Point(*_torch(msm_case["neg_a"])))
    assert got.x.shape == (9, 32, N)
    for name, w, g in zip("xyzt", want, got):
        assert np.array_equal(np.asarray(w), g.numpy()), name
    # Entry j is j*(-A), the same group elements as the sequential-add table.
    seq = ted.multiples_table(ted.Point(*_torch(msm_case["neg_a"])), 9)
    for j in range(9):
        assert ted.equal(ted.Point(*(c[j] for c in got)), ted.Point(*(c[j] for c in seq))).all()


def test_plain_msm_matches_jax_xla_path_limb_for_limb(msm_case):
    for name, w, g in zip("xyzt", msm_case["xla"], msm_case["ref"]):
        assert np.array_equal(w, g.numpy()), name


def test_plain_msm_matches_bigint_sum(msm_case):
    assert msm_case["zk_digits"][:, 2].tolist() == [8] * 64  # the masked lane
    assert _affine(msm_case["ref"]) == _bigint_msm(msm_case)


def test_wrapper_on_cpu_runs_the_plain_version_without_a_launch(msm_case):
    before = KERNELS.stats("straus_msm").launches
    got = scan_kernels.straus_msm(
        ted.Point(*_torch(msm_case["neg_a"])), ted.Point(*_torch(msm_case["neg_r"])),
        *_torch([msm_case["zk_digits"], msm_case["z_digits"]]),
    )
    assert KERNELS.stats("straus_msm").launches == before
    for g, r in zip(got, msm_case["ref"]):
        assert torch.equal(g, r)


def test_wrapper_checks_dtype_shape_and_contiguity():
    case = _msm_case(3, seed=1)
    a, r = ted.Point(*_torch(case["neg_a"])), ted.Point(*_torch(case["neg_r"]))
    zk, z = _torch([case["zk_digits"], case["z_digits"]])
    msm = scan_kernels.straus_msm
    with pytest.raises(TypeError):
        msm(a._replace(x=a.x.double()), r, zk, z)
    with pytest.raises(TypeError):
        msm(a, r, zk, z.long())
    with pytest.raises(ValueError):
        msm(a, r, zk[:, :2], z)              # zk batch differs
    with pytest.raises(ValueError):
        msm(a, r, zk[:63], z)                # not 64 windows
    with pytest.raises(ValueError):
        msm(a, r, zk, torch.zeros(65, 3, dtype=torch.int32))  # n_low > 64
    with pytest.raises(ValueError):
        msm(a, r._replace(t=r.t[:16]), zk, z)
    wide = torch.zeros(32, 6)
    with pytest.raises(ValueError):
        msm(a._replace(y=wide[:, ::2]), r, zk, z)


def test_msm_bound_counts_the_work():
    # Phase 6's wave: 8,192 lanes, 1,332 padded and 70 undecodable (masked to
    # digit 8, so they add the identity and need no work), 6,790 live.
    b = chip_smoke.msm_bound(8192, 6790, 33, sm_count=132, sm_clock_hz=1.98e9)
    # Per live lane two 9-entry tables (3 adds and 4 doubles with T each),
    # 33 combining adds and 64 summing adds; one chain of 64 windows of 3
    # doubles without T and 1 with T (held to the counting shim's count of
    # the plain version in tests/test_torch_limbs_counting.py).
    assert b["adds"] == 6790 * (6 + 33 + 64) == 699_370
    assert b["doubles"] == 64 * 4 + 6790 * 8
    assert b["products"] == (
        699_370 * 9 * 72 + 192 * (3 * 72 + 4 * 44) + (64 + 6790 * 8) * (4 * 72 + 4 * 44)
    )
    assert b["products"] == 478_501_200
    assert b["bytes"] == (8 * 32 + 64 + 33) * 8192 * 4 + 4 * 32 * 4
    assert b["bound_by"] == "operations" and b["bound_ms"] == b["ops_ms"] > b["bytes_ms"]
    assert abs(b["ops_ms"] - 0.028606) < 1e-6
    # Masked lanes cost nothing; the chain is paid once whatever the width.
    assert chip_smoke.msm_bound(8192, 0, 33, 132, 1.98e9)["products"] == 75_264 + 29_696


# The split-role point operations of the chain, run role after role: what
# the chain kernel's four lanes compute (the header's stages on its inlined
# multiplication), with the shuffles replaced by arrays.
_SPLIT_OPS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "straus_msm.cu"
static ge split_dbl(const ge& p, bool need_t) {
  fe m[4], o[4];
  for (int r = 0; r < 4; ++r) m[r] = dbl_stage1<MUL_INLINE>(p, r);
  for (int r = 0; r < 4; ++r) o[r] = dbl_stage2<MUL_INLINE>(p, m, r, need_t);
  return ge{o[0], o[1], o[2], o[3]};
}
static ge split_add(const ge& p, const ge& q) {
  fe m[4], o[4];
  const fe t1 = mul<MUL_INLINE>(p.T, fe_d2());
  for (int r = 0; r < 4; ++r) m[r] = add_stage1<MUL_INLINE>(p, t1, add_factor(q, r), r);
  for (int r = 0; r < 4; ++r) o[r] = add_stage2<MUL_INLINE>(m, r);
  return ge{o[0], o[1], o[2], o[3]};
}
static bool read_all(const char* path, void* a, size_t na, void* b = 0, size_t nb = 0,
                     void* c = 0, size_t nc = 0) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  const bool ok = fread(a, 1, na, f) == na && fread(b, 1, nb, f) == nb && fread(c, 1, nc, f) == nc;
  fclose(f);
  return ok;
}
static bool write_all(const char* path, const void* a, size_t n) {
  FILE* f = fopen(path, "wb");
  if (!f) return false;
  const bool ok = fwrite(a, 1, n, f) == n;
  fclose(f);
  return ok;
}
"""

_HOST_HARNESS = _SPLIT_OPS + r"""
// The four kernels' schedule, one thread after another, with the block
// geometry from the command line (threads per window-sum block, lanes per
// warp, lanes per chunk): the tables per (lane, point); per (window, chunk)
// every thread's share, a halving tree down to one warp and a butterfly in
// it; per window a butterfly over its chunk partials; then the two-level
// Horner chain on the split stages.  On the card a butterfly is
// __shfl_xor_sync: lane 0 ends with ge_add(v[0], v[m]) at each level m.
static ge butterfly(std::vector<ge> v) {
  for (size_t m = v.size() / 2; m > 0; m >>= 1) {
    std::vector<ge> next(v.size());
    for (size_t i = 0; i < v.size(); ++i) next[i] = ge_add(v[i], v[i ^ m]);
    v = next;
  }
  return v[0];
}
int main(int argc, char** argv) {
  if (argc != 8) return 2;
  const long long batch = atoll(argv[1]);
  const int n_low = atoi(argv[2]), threads = atoi(argv[3]), warp = atoi(argv[4]);
  const long long chunk = atoll(argv[5]);
  const long long s = 32 * batch;
  std::vector<float> c(8 * s);
  std::vector<int32_t> zk(64 * batch), z(n_low * batch);
  if (!read_all(argv[6], c.data(), 4 * c.size(), zk.data(), 4 * zk.size(), z.data(), 4 * z.size()))
    return 3;
  std::vector<u64> scratch(msm_scratch_words(batch, n_low, chunk));
  const msm_args in = {{&c[0], &c[s], &c[2 * s], &c[3 * s]},
                       {&c[4 * s], &c[5 * s], &c[6 * s], &c[7 * s]},
                       zk.data(), z.data(), batch, n_low, scratch.data()};
  for (int pt = 0; pt < msm_points(n_low); ++pt)
    for (long long lane = 0; lane < batch; ++lane) msm_table(in, pt, lane);
  const long long chunks = msm_chunks(batch, chunk);
  u64* partials = scratch.data() + msm_table_words(batch, n_low);
  for (int w = 0; w < WINDOWS; ++w) {
    for (long long ch = 0; ch < chunks; ++ch) {
      const long long lo = ch * chunk, hi = lo + chunk < batch ? lo + chunk : batch;
      std::vector<ge> acc;
      for (int t = 0; t < threads; ++t) acc.push_back(msm_thread_sum(in, w, lo, hi, t, threads));
      for (int s = threads / 2; s >= warp; s >>= 1)
        for (int t = 0; t < s; ++t) acc[t] = ge_add(acc[t], acc[t + s]);
      acc.resize(warp);
      ge_write(partials + msm_slot(chunks, w, ch), butterfly(acc));
    }
  }
  const int g = msm_group(chunks, warp);
  std::vector<ge> sums;
  for (int w = 0; w < WINDOWS; ++w) {
    std::vector<ge> shares;
    for (int j = 0; j < g; ++j) shares.push_back(msm_window_share(partials, chunks, w, j, g));
    sums.push_back(butterfly(shares));
  }
  std::vector<ge> groups;
  for (int i = 0; i < GROUPS; ++i) {
    ge c = sums[SPAN * i];
    for (int k = 1; k < SPAN; ++k) {
      for (int d = 0; d < 4; ++d) c = split_dbl(c, d == 3);
      c = split_add(c, sums[SPAN * i + k]);
    }
    groups.push_back(c);
  }
  ge acc = groups[0];
  for (int i = 1; i < GROUPS; ++i) {
    for (int d = 0; d < 4 * SPAN; ++d) acc = split_dbl(acc, d == 4 * SPAN - 1);
    acc = split_add(acc, groups[i]);
  }
  std::vector<float> out(4 * 32);
  for (int r = 0; r < 4; ++r) fe_store(&out[32 * r], 1, fe_pick(r, acc.X, acc.Y, acc.Z, acc.T));
  printf("chunks %lld group %d\n", chunks, g);
  return write_all(argv[7], out.data(), 4 * out.size()) ? 0 : 4;
}
"""

# For each of n point pairs (p, q) loaded from weak limbs: ge_dbl(p) without
# and with T and ge_add(p, q), each from the header (every role in turn on
# its out-of-line multiplication), from the chain's split stages and from
# the straight-line formulas, as 20 words each.
_SPLIT_HARNESS = _SPLIT_OPS + r"""
// dbl-2008-hwcd and add-2008-hwcd-3 in one straight line, as
// consensus_tpu/ops/ed25519.py writes them, on fe_mul.
static ge line_dbl(const ge& p, bool need_t) {
  const fe a = fe_mul(p.X, p.X), b = fe_mul(p.Y, p.Y), zz = fe_mul(p.Z, p.Z);
  const fe xy = fe_add(p.X, p.Y);
  const fe c = fe_add(zz, zz), h = fe_add(a, b);
  const fe e = fe_sub(h, fe_mul(xy, xy)), g = fe_sub(a, b);
  const fe f = fe_add(c, g);
  return ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), need_t ? fe_mul(e, h) : p.T};
}
static ge line_add(const ge& p, const ge& q) {
  const fe a = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
  const fe b = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
  const fe c = fe_mul(fe_mul(p.T, fe_d2()), q.T);
  const fe d = fe_mul(fe_add(p.Z, p.Z), q.Z);
  const fe e = fe_sub(b, a), f = fe_sub(d, c), g = fe_add(d, c), h = fe_add(b, a);
  return ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}
int main(int argc, char** argv) {
  if (argc != 4) return 2;
  const long long n = atoll(argv[1]), s = 32 * n;
  std::vector<float> c(8 * s);
  if (!read_all(argv[2], c.data(), 4 * c.size())) return 3;
  std::vector<u64> out(n * 9 * POINT_WORDS);
  for (long long i = 0; i < n; ++i) {
    const ge p = {fe_load(&c[i], n), fe_load(&c[s + i], n), fe_load(&c[2 * s + i], n),
                  fe_load(&c[3 * s + i], n)};
    const ge q = {fe_load(&c[4 * s + i], n), fe_load(&c[5 * s + i], n),
                  fe_load(&c[6 * s + i], n), fe_load(&c[7 * s + i], n)};
    const ge r[9] = {ge_dbl(p, false), split_dbl(p, false), line_dbl(p, false),
                     ge_dbl(p, true),  split_dbl(p, true),  line_dbl(p, true),
                     ge_add(p, q),     split_add(p, q),     line_add(p, q)};
    for (int k = 0; k < 9; ++k) ge_write(&out[(i * 9 + k) * POINT_WORDS], r[k]);
  }
  return write_all(argv[3], out.data(), 8 * out.size()) ? 0 : 4;
}
"""


def _host_build(tmp_path, source: str, name: str):
    """``source`` compiled as plain C++ with g++ against ``csrc/``; skips
    where the box has no host C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source's arithmetic")
    (tmp_path / f"{name}.cpp").write_text(source)
    exe = tmp_path / name
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-x", "c++", f"-I{scan_kernels._CSRC}",
         "-o", str(exe), str(tmp_path / f"{name}.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    return exe


@pytest.mark.parametrize(
    "n, n_low, masked, chunk, chunks",
    [(37, 33, (4, 36), 16, 3), (5, 0, (1,), 16, 1), (40, 64, (0, 39), 4, 10)],
)
def test_kernel_arithmetic_compiled_for_the_host_matches_bigint(
    tmp_path, n, n_low, masked, chunk, chunks
):
    """The CUDA source's tables, lookups, window sums, join and split-role
    chain are ``__host__ __device__``: compiled as plain C++ (no nvcc) and
    run with the four kernels' schedule -- blocks of 8 threads in warps of
    4; chunks of 16 lanes (two per thread) with a ragged last one, or of 4
    lanes, so that 10 chunks fold into a join group of 4; masked lanes;
    negative weak limbs; n_low of 33 (the engine's), 0 (no R table) or 64
    -- they must give the pure-Python sum's point, in affine coordinates,
    as canonical limbs with T Z = X Y."""
    exe = _host_build(tmp_path, _HOST_HARNESS, "harness")
    case = _msm_case(n, seed=5 + n_low, masked=masked, n_low=n_low)
    coords = [chip_smoke.weaken(torch.from_numpy(c)).numpy() for c in (*case["neg_a"], *case["neg_r"])]
    assert min(c.min() for c in coords) < 0
    assert case["z_digits"].shape == (n_low, n)
    (tmp_path / "in.bin").write_bytes(
        b"".join(c.astype(np.float32).tobytes() for c in coords)
        + case["zk_digits"].astype(np.int32).tobytes()
        + case["z_digits"].astype(np.int32).tobytes()
    )
    proc = subprocess.run(
        [str(exe), str(n), str(n_low), "8", "4", str(chunk), str(tmp_path / "in.bin"),
         str(tmp_path / "out.bin")],
        check=True, capture_output=True, text=True, timeout=300,
    )
    assert proc.stdout.split()[:2] == ["chunks", str(chunks)]
    out = np.fromfile(tmp_path / "out.bin", dtype=np.float32).reshape(4, 32, 1)
    assert out.min() >= 0 and out.max() <= 255  # canonical bytes
    assert _affine(ted.Point(*(torch.from_numpy(c) for c in out))) == _bigint_msm(case)
    x, y, z, t = (tfe.limbs_to_int(c[:, 0]) for c in out)
    assert t * z % P == x * y % P


def test_split_chain_stages_equal_the_point_operations_limb_for_limb(tmp_path):
    """The chain kernel's four-role stages (ed25519_field.cuh's, on the
    inlined multiplication), put back together, are the header's ge_dbl
    (with and without T) and ge_add (the tables', window sums' and join's
    add, on the out-of-line multiplication) and the straight-line formulas
    limb for limb, on seeded points in weak limbs: the same field operations
    in the same order."""
    exe = _host_build(tmp_path, _SPLIT_HARNESS, "split")
    n = 64
    rng = np.random.default_rng(23)
    values = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(8 * n)]
    limbs = np.stack([tfe.int_to_limbs(v) for v in values], axis=1).astype(np.float32)
    coords = [chip_smoke.weaken(torch.from_numpy(limbs[:, k * n:(k + 1) * n])).numpy()
              for k in range(8)]
    assert min(c.min() for c in coords) < 0
    (tmp_path / "in.bin").write_bytes(b"".join(c.astype(np.float32).tobytes() for c in coords))
    subprocess.run([str(exe), str(n), str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
                   check=True, timeout=300)
    out = np.fromfile(tmp_path / "out.bin", dtype=np.uint64).reshape(n, 9, 20)
    for name, k in (("dbl without T", 0), ("dbl with T", 3), ("add", 6)):
        assert np.array_equal(out[:, k], out[:, k + 1]), name
        assert np.array_equal(out[:, k + 1], out[:, k + 2]), name + ", straight line"
    # The three operations differ, so the comparison is not vacuous: T
    # passes through without need_t and is a product with it.
    assert not np.array_equal(out[:, 0, 15:], out[:, 3, 15:])
    assert not np.array_equal(out[:, 0, :15], out[:, 6, :15])
    assert (out < 2**52).all()


@pytest.fixture(scope="module")
def pallas_msm(msm_case):
    """JAX's Pallas MSM kernel in interpret mode, one tile of 4 lanes."""
    return pallas_scan.straus_msm(
        *(jnp.asarray(c) for c in (*msm_case["neg_a"], *msm_case["neg_r"])),
        jnp.asarray(msm_case["zk_digits"]), jnp.asarray(msm_case["z_digits"]),
        tile=4, interpret=True,
    )


@pytest.mark.slow
def test_plain_msm_equals_jax_pallas_kernel(msm_case, pallas_msm):
    """The JAX package's own check (tests/test_mxu_limbs.py): the Pallas
    kernel's projective representative differs, the group element does not."""
    got = ted.Point(*(torch.from_numpy(np.array(c)) for c in pallas_msm))
    assert ted.equal(got, msm_case["ref"]).all()
    assert not ted.is_identity(got).all()
