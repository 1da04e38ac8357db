"""The port's Straus MSM against the JAX package.

The randomized verifier's shared-doubling multi-scalar multiplication:
``multiples_table9``, ``batch_sum`` and ``straus_shared_msm`` of
``consensus_tpu_torch/ops/ed25519.py`` are held limb for limb against the
JAX module's on the same numpy inputs (the XLA path the JAX verifier takes by
default, no ``CTPU_MXU_LIMBS``), and ``straus_msm_reference`` (the plain
version of kernel B3) against a pure-Python sum of scalar multiplications
in affine coordinates.  The kernel's arithmetic and block schedule are held
against the same sum compiled as plain C++ with g++; the kernel itself runs
only on the card (tests/test_torch_cuda.py, chip_smoke.py phase 6).
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


def _msm_case(n: int, seed: int, masked=()):
    """-A, -R for A = (j+1)B and R = (j+51)B, scalars zk < L and z < 2^128
    from numpy seed ``seed``; ``masked`` lanes get all-8 digits (scalar 0)."""
    a_pts, r_pts = _walk(n, 0), _walk(n, 50)
    rng = np.random.default_rng(seed)
    zk = [int.from_bytes(rng.bytes(32), "little") % tmed.L for _ in range(n)]
    zs = [int.from_bytes(rng.bytes(16), "little") or 1 for _ in range(n)]
    for i in masked:
        zk[i] = zs[i] = 0
    return {
        "a_pts": a_pts, "r_pts": r_pts, "zk": zk, "zs": zs,
        "neg_a": _neg_limbs(a_pts), "neg_r": _neg_limbs(r_pts),
        "zk_digits": _digits(zk, tmed._WINDOWS), "z_digits": _digits(zs, tmed._Z_WINDOWS),
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
    before = scan_kernels.launches_msm
    got = scan_kernels.straus_msm(
        ted.Point(*_torch(msm_case["neg_a"])), ted.Point(*_torch(msm_case["neg_r"])),
        *_torch([msm_case["zk_digits"], msm_case["z_digits"]]),
    )
    assert scan_kernels.launches_msm == before
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
    # Per live lane 14 table adds, 33 combining adds and 64 summing adds; one
    # chain of 64 windows of 3 doubles without T and 1 with T.
    assert b["adds"] == 6790 * (14 + 33 + 64) == 753_690
    assert b["doubles"] == 64 * 4
    assert b["products"] == 753_690 * 9 * 72 + 192 * (3 * 72 + 4 * 44) + 64 * (4 * 72 + 4 * 44)
    assert b["products"] == 488_496_080
    assert b["bytes"] == (8 * 32 + 64 + 33) * 8192 * 4 + 4 * 32 * 4
    assert b["bound_by"] == "operations" and b["bound_ms"] == b["ops_ms"] > b["bytes_ms"]
    assert abs(b["ops_ms"] - 0.029204) < 1e-6
    # Masked lanes cost nothing; the chain is paid once whatever the width.
    assert chip_smoke.msm_bound(8192, 0, 33, 132, 1.98e9)["products"] == 75_264 + 29_696


_HOST_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "straus_msm.cu"
// The two kernels' schedule, one thread after another: per block, per window,
// thread 0's four doubles, every thread's contribution into its slot, the
// halving tree, thread 0's add; then the join of the blocks' partial sums by
// the same tree in one block.
static void tree(std::vector<u64>& sh, int threads) {
  for (int s = threads / 2; s > 0; s >>= 1)
    for (int t = 0; t < s; ++t)
      ge_put(sh.data(), threads, t, ge_add(ge_get(sh.data(), threads, t), ge_get(sh.data(), threads, t + s)));
}
int main(int argc, char** argv) {
  if (argc != 6) return 2;
  const long long batch = atoll(argv[1]);
  const int n_low = atoi(argv[2]), threads = atoi(argv[3]);
  const long long s = 32 * batch;
  std::vector<float> c(8 * s);
  std::vector<int32_t> zk(64 * batch), z(n_low * batch);
  FILE* f = fopen(argv[4], "rb");
  if (!f || fread(c.data(), 4, c.size(), f) != c.size() ||
      fread(zk.data(), 4, zk.size(), f) != zk.size() ||
      fread(z.data(), 4, z.size(), f) != z.size()) return 3;
  fclose(f);
  const msm_inputs in = {{&c[0], &c[s], &c[2 * s], &c[3 * s]},
                         {&c[4 * s], &c[5 * s], &c[6 * s], &c[7 * s]},
                         zk.data(), z.data(), batch, n_low};
  const int nblocks = (int)((batch + threads - 1) / threads);
  std::vector<u64> partials(20 * nblocks), sh(20 * threads);
  std::vector<ge> a_tab(9 * threads), r_tab(9 * threads);
  for (int b = 0; b < nblocks; ++b) {
    for (int t = 0; t < threads; ++t) {
      const long long lane = (long long)b * threads + t;
      if (lane < batch) msm_tables(in, lane, &a_tab[9 * t], &r_tab[9 * t]);
    }
    ge acc = ge_identity();
    for (int w = 0; w < WINDOWS; ++w) {
      acc = ge_quad_double(acc);
      for (int t = 0; t < threads; ++t) {
        const long long lane = (long long)b * threads + t;
        ge_put(sh.data(), threads, t, lane < batch
               ? msm_contribution(in, &a_tab[9 * t], &r_tab[9 * t], w, lane) : ge_identity());
      }
      tree(sh, threads);
      acc = ge_add(acc, ge_get(sh.data(), threads, 0));
    }
    ge_put(partials.data(), nblocks, b, acc);
  }
  for (int t = 0; t < threads; ++t) {
    ge sum = ge_identity();
    for (int b = t; b < nblocks; b += threads) sum = ge_add(sum, ge_get(partials.data(), nblocks, b));
    ge_put(sh.data(), threads, t, sum);
  }
  tree(sh, threads);
  const ge r = ge_get(sh.data(), threads, 0);
  std::vector<float> out(4 * 32);
  fe_store(&out[0], 1, r.X);
  fe_store(&out[32], 1, r.Y);
  fe_store(&out[64], 1, r.Z);
  fe_store(&out[96], 1, r.T);
  f = fopen(argv[5], "wb");
  if (!f || fwrite(out.data(), 4, out.size(), f) != out.size()) return 4;
  fclose(f);
  return 0;
}
"""


def test_kernel_arithmetic_compiled_for_the_host_matches_bigint(tmp_path):
    """The CUDA source's tables, lookups and point code are ``__host__
    __device__``: compiled as plain C++ (no nvcc) and run with the kernels'
    block schedule -- 37 lanes in blocks of 32, a ragged second block, a
    masked lane and negative weak limbs -- they must give the pure-Python
    sum's point, in affine coordinates, as canonical limbs."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source's arithmetic")
    (tmp_path / "harness.cpp").write_text(_HOST_HARNESS)
    exe = tmp_path / "harness"
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-x", "c++", f"-I{scan_kernels._CSRC}",
         "-o", str(exe), str(tmp_path / "harness.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    n = 37
    case = _msm_case(n, seed=5, masked=(4, 36))
    coords = [chip_smoke.weaken(torch.from_numpy(c)).numpy() for c in (*case["neg_a"], *case["neg_r"])]
    assert min(c.min() for c in coords) < 0
    (tmp_path / "in.bin").write_bytes(
        b"".join(c.astype(np.float32).tobytes() for c in coords)
        + case["zk_digits"].astype(np.int32).tobytes()
        + case["z_digits"].astype(np.int32).tobytes()
    )
    subprocess.run(
        [str(exe), str(n), "33", "32", str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
        check=True, timeout=300,
    )
    out = np.fromfile(tmp_path / "out.bin", dtype=np.float32).reshape(4, 32, 1)
    assert out.min() >= 0 and out.max() <= 255  # canonical bytes
    assert _affine(ted.Point(*(torch.from_numpy(c) for c in out))) == _bigint_msm(case)


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
