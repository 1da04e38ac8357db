"""The port's P-256 Horner scan against the JAX package's.

``horner_scan_p256_reference`` (the plain torch version of the CUDA kernel
B2) is held limb for limb against the XLA ``lax.scan`` of
tests/test_pallas_scan.py (``_p256_xla_reference``, the JAX verifier's
default scan), and on frozen values against JAX's Pallas kernel
``horner_scan_p256(..., tile=2, interpret=True)``, on the same 4-lane case
as that file.  The CUDA source's arithmetic is compiled for the host with
g++ and held against the plain version on lanes with Q off the curve, zero
coordinates, negative weak limbs, coordinates at or above p and all-zero
digits.  The kernel itself runs only on the card: its tests are in
tests/test_torch_cuda.py.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from consensus_tpu.models import ecdsa_p256 as jmodel
from consensus_tpu.ops import field_p256 as jfp
from consensus_tpu.ops.pallas_scan import horner_scan_p256 as jax_horner_scan_p256
from consensus_tpu_torch.models import ecdsa_p256 as tmodel
from consensus_tpu_torch.ops import field_p256 as tfp
from consensus_tpu_torch.ops import p256 as tp
from consensus_tpu_torch.ops import scan_kernels
from test_pallas_scan import _p256_case, _p256_xla_reference

P = tfp.P


@pytest.fixture(scope="module")
def scan_case():
    qx, qy, scalars = _p256_case(4)
    kd = tmodel._scalars_to_signed_window_digits(scalars).astype(np.int32)
    jkd = jnp.asarray(kd)
    pallas = jax_horner_scan_p256(qx, qy, jkd, tile=2, interpret=True)
    xla = jax.jit(_p256_xla_reference)(qx, qy, jkd)
    qx, qy = np.asarray(qx), np.asarray(qy)
    ref = scan_kernels.horner_scan_p256_reference(
        torch.from_numpy(qx.copy()), torch.from_numpy(qy.copy()), torch.from_numpy(kd.copy())
    )
    return {
        "qx": qx, "qy": qy, "scalars": scalars, "kd": kd,
        "pallas": [np.asarray(c) for c in pallas],
        "xla": [np.asarray(c) for c in xla],
        "ref": ref,
    }


def _affine(point, lane: int):
    x, y, z = (tfp.limbs_to_int(tfp.freeze(c[:, lane : lane + 1])[:, 0]) for c in point)
    if z == 0:
        return None
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


def test_scalar_encodings_match_jax():
    rng = np.random.default_rng(19)
    scalars = [0, 1, 8, 0x88, tp.N - 1, 2**256 - 1] + [
        int.from_bytes(rng.bytes(32), "big") % tp.N for _ in range(10)
    ]
    np.testing.assert_array_equal(
        tmodel._scalars_to_signed_window_digits(scalars),
        jmodel._scalars_to_signed_window_digits(scalars),
    )
    np.testing.assert_array_equal(
        tmodel._scalars_to_comb_digits8(scalars), jmodel._scalars_to_comb_digits8(scalars)
    )
    rows = rng.integers(0, 256, size=(5, 32), dtype=np.uint8)
    np.testing.assert_array_equal(
        tmodel._be_bytes_to_limb_rows(rows), jmodel._be_bytes_to_limb_rows(rows)
    )
    # 2^256 - 1 needs the carry window; n - 1 too (its top window is 0xF).
    assert tmodel._scalars_to_signed_window_digits(scalars)[0, 4:6].tolist() == [9, 9]


def test_reference_matches_xla_scan_limb_for_limb(scan_case):
    for name, want, got in zip("xyz", scan_case["xla"], scan_case["ref"]):
        assert np.array_equal(want, got.numpy()), name


def test_reference_matches_pallas_kernel_on_frozen_values(scan_case):
    for name, want, got in zip("xyz", scan_case["pallas"], scan_case["ref"]):
        want_frozen = np.asarray(jax.jit(jfp.freeze)(jnp.asarray(want)))
        assert np.array_equal(want_frozen, tfp.freeze(got).numpy()), name


def test_reference_matches_bigint_on_every_lane(scan_case):
    ref = scan_case["ref"]
    for lane, k in enumerate(scan_case["scalars"]):
        q = (tfp.limbs_to_int(scan_case["qx"][:, lane]), tfp.limbs_to_int(scan_case["qy"][:, lane]))
        want, base = None, q
        while k:
            if k & 1:
                want = tp._add_int(want, base)
            base = tp._add_int(base, base)
            k >>= 1
        assert _affine(ref, lane) == want, lane


def test_wrapper_on_cpu_runs_the_plain_version_without_a_launch(scan_case):
    before = (scan_kernels.launches, scan_kernels.launches_p256)
    got = scan_kernels.horner_scan_p256(
        torch.from_numpy(scan_case["qx"].copy()),
        torch.from_numpy(scan_case["qy"].copy()),
        torch.from_numpy(scan_case["kd"].copy()),
    )
    assert (scan_kernels.launches, scan_kernels.launches_p256) == before
    for g, r in zip(got, scan_case["ref"]):
        assert torch.equal(g, r)


def test_wrapper_checks_dtype_shape_and_contiguity():
    qx, qy = torch.zeros(32, 4), torch.zeros(32, 4)
    digits = torch.full((65, 4), 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        scan_kernels.horner_scan_p256(qx.double(), qy, digits)
    with pytest.raises(TypeError):
        scan_kernels.horner_scan_p256(qx, qy, digits.long())
    with pytest.raises(ValueError):
        scan_kernels.horner_scan_p256(qx, qy, digits[:64])  # the carry window is missing
    with pytest.raises(ValueError):
        scan_kernels.horner_scan_p256(qx[:16], qy, digits)
    with pytest.raises(ValueError):
        scan_kernels.horner_scan_p256(torch.zeros(32, 8)[:, ::2], qy, digits)
    with pytest.raises(ValueError):
        scan_kernels.horner_scan_p256(qx.to("meta"), qy.to("meta"), digits.to("meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler is an error, never a silent fallback."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(scan_kernels, "BUILD_DIR", tmp_path / "build")
    scan_kernels._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            scan_kernels.build("horner_scan_p256")
    finally:
        scan_kernels._library.cache_clear()


_HOST_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "horner_scan_p256.cu"
int main(int argc, char** argv) {
  if (argc != 4) return 2;
  long long batch = atoll(argv[1]);
  long long s = 32 * batch;
  std::vector<float> in(2 * s), out(3 * s);
  std::vector<int32_t> digits(65 * batch);
  FILE* f = fopen(argv[2], "rb");
  if (!f || fread(in.data(), 4, in.size(), f) != in.size() ||
      fread(digits.data(), 4, digits.size(), f) != digits.size()) return 3;
  fclose(f);
  for (long long lane = 0; lane < batch; ++lane)
    horner_lane_p256(&in[0], &in[s], digits.data(), &out[0], &out[s], &out[2 * s],
                     batch, lane);
  f = fopen(argv[3], "wb");
  if (!f || fwrite(out.data(), 4, out.size(), f) != out.size()) return 4;
  fclose(f);
  return 0;
}
"""


def test_kernel_arithmetic_compiled_for_the_host_matches_reference(tmp_path):
    """The CUDA source's field and point code is ``__host__ __device__``:
    compiled as plain C++ (no nvcc) it must give, lane for lane, the plain
    version's projective point as canonical limbs."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source's arithmetic")
    (tmp_path / "harness.cpp").write_text(_HOST_HARNESS)
    exe = tmp_path / "harness"
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-x", "c++", f"-I{scan_kernels._CSRC}",
         "-o", str(exe), str(tmp_path / "harness.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    n = 8
    pts, cur = [], (tp.GX, tp.GY)
    for _ in range(n):
        pts.append(cur)
        cur = tp._add_int(cur, (tp.GX, tp.GY))
    xs, ys = [x for x, _ in pts], [y for _, y in pts]
    xs[4] = 5                            # Q off the curve
    xs[5], ys[5] = 0, 0                  # a padded lane's zeros
    xs[6], ys[6] = 2**256 - 1, P         # coordinates at and above p
    qx = np.stack([tfp.int_to_limbs(v) for v in xs], axis=1)
    qy = np.stack([tfp.int_to_limbs(v) for v in ys], axis=1)
    for c in (qx, qy):  # lanes 0-3: the same values in negative weak limbs
        for i in range(31):
            move = (c[i, :4] >= 172).astype(np.float32)
            c[i, :4] -= 256 * move
            c[i + 1, :4] += move
    assert qx.min() < 0 and qy.min() < 0
    rng = np.random.default_rng(23)
    scalars = [0, 1, tp.N - 1] + [int.from_bytes(rng.bytes(32), "big") % tp.N for _ in range(n - 3)]
    kd = tmodel._scalars_to_signed_window_digits(scalars).astype(np.int32)
    kd[:, 7] = 0  # a padded lane's digits: d = -8 in every window
    (tmp_path / "in.bin").write_bytes(qx.tobytes() + qy.tobytes() + kd.tobytes())
    subprocess.run(
        [str(exe), str(n), str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
        check=True, timeout=120,
    )
    out = np.fromfile(tmp_path / "out.bin", dtype=np.float32).reshape(3, 32, n)
    want = scan_kernels.horner_scan_p256_reference(
        torch.from_numpy(qx), torch.from_numpy(qy), torch.from_numpy(kd)
    )
    for name, got, w in zip("xyz", out, want):
        assert np.array_equal(got, tfp.freeze(w).numpy().astype(np.float32)), name
