"""The port's Horner scan against the JAX package's Pallas kernel.

``horner_scan_reference`` (the plain torch version of the CUDA kernel) is
held limb for limb against JAX's ``horner_scan(..., tile=4,
interpret=True)`` and against the XLA ``lax.scan`` the JAX verifier runs by
default, at n = 8 with the scalar-0 and scalar-1 lanes included, as
tests/test_pallas_scan.py does.  The CUDA kernel itself runs only on the
card: its tests are in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from consensus_tpu.ops import ed25519 as jed
from consensus_tpu.ops.pallas_scan import horner_scan as jax_horner_scan
from consensus_tpu_torch.models.ed25519 import (
    L,
    _bits_to_signed_window_digits,
    _bytes_rows_to_bits,
    _ref_mul,
)
from consensus_tpu_torch.ops import ed25519 as ted
from consensus_tpu_torch.ops import field25519 as tfe
from consensus_tpu_torch.ops import scan_kernels

P = tfe.P
N = 8


def _digits(scalars) -> np.ndarray:
    rows = np.frombuffer(
        b"".join(s.to_bytes(32, "little") for s in scalars), dtype=np.uint8
    ).reshape(len(scalars), 32)
    return _bits_to_signed_window_digits(_bytes_rows_to_bits(rows)).astype(np.int32)


def _case(n: int, seed: int = 7):
    """(-A) for A = j*B, j = 1..n, in the weak limbs ``negate`` produces,
    and digits of scalars 0, 1 and n-2 random ones below L."""
    pts, cur = [], (ted._BX, ted._BY)
    for _ in range(n):
        pts.append(cur)
        cur = ted._edwards_add_int(cur, (ted._BX, ted._BY))
    coords = [
        torch.from_numpy(np.stack([tfe.int_to_limbs(c) for c in col], axis=1))
        for col in (
            [x for x, _ in pts], [y for _, y in pts], [1] * n, [x * y % P for x, y in pts]
        )
    ]
    neg = [c.contiguous().numpy() for c in ted.negate(ted.Point(*coords))]
    rng = np.random.default_rng(seed)
    scalars = [0, 1] + [int.from_bytes(rng.bytes(32), "little") % L for _ in range(n - 2)]
    return pts, neg, scalars, _digits(scalars)


def _xla_scan(nx, ny, nz, nt, k_digits):
    """The JAX verifier's default XLA scan (models/ed25519.py), verbatim."""
    neg_a = jed.Point(nx, ny, nz, nt)
    table = jed.multiples_table(neg_a, 9)
    lanes = jnp.arange(9, dtype=jnp.int32)[:, None]

    def step(acc, k_w):
        d = k_w - 8
        k_oh = (jnp.abs(d)[None] == lanes).astype(jnp.float32)
        for _ in range(3):
            acc = jed.double(acc, need_t=False)
        acc = jed.double(acc)
        q = jed.table_lookup(table, k_oh)
        q = jed.select(d < 0, jed.negate(q), q)
        return jed.add(acc, q), None

    acc, _ = jax.lax.scan(step, jed.identity_like(nx), k_digits)
    return acc


@pytest.fixture(scope="module")
def scan_case():
    pts, neg, scalars, kd = _case(N)
    jax_in = [jnp.asarray(c) for c in neg]
    pallas = jax_horner_scan(*jax_in, jnp.asarray(kd), tile=4, interpret=True)
    xla = jax.jit(_xla_scan)(*jax_in, jnp.asarray(kd))
    torch_in = [torch.from_numpy(c.copy()) for c in neg]
    ref = scan_kernels.horner_scan_reference(*torch_in, torch.from_numpy(kd.copy()))
    return {
        "pts": pts, "neg": neg, "scalars": scalars, "kd": kd,
        "pallas": [np.asarray(c) for c in pallas],
        "xla": [np.asarray(c) for c in xla],
        "ref": ref,
    }


def _affine(point: ted.Point, lane: int) -> tuple[int, int]:
    x, y, z = (
        tfe.limbs_to_int(tfe.freeze(c[:, lane : lane + 1])[:, 0]) for c in point[:3]
    )
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


def test_reference_matches_pallas_kernel_limb_for_limb(scan_case):
    for name, want, got in zip("xyzt", scan_case["pallas"], scan_case["ref"]):
        assert np.array_equal(want, got.numpy()), name


def test_reference_matches_xla_scan_limb_for_limb(scan_case):
    for name, want, got in zip("xyzt", scan_case["xla"], scan_case["ref"]):
        assert np.array_equal(want, got.numpy()), name


def test_reference_matches_bigint_on_every_lane(scan_case):
    ref = scan_case["ref"]
    for lane, (k, (x, y)) in enumerate(zip(scan_case["scalars"], scan_case["pts"])):
        neg_a = ((P - x) % P, y, 1, (P - x * y % P) % P)
        wx, wy, wz, _ = _ref_mul(k, neg_a)
        zi = pow(wz, P - 2, P)
        assert _affine(ref, lane) == (wx * zi % P, wy * zi % P), lane
    # Scalar 0 lands exactly on the identity, scalar 1 on the point itself.
    assert ted.is_identity(ted.Point(*(c[:, :1] for c in ref))).all()
    assert _affine(ref, 1) == ((P - scan_case["pts"][1][0]) % P, scan_case["pts"][1][1])


def test_wrapper_on_cpu_runs_the_plain_version_without_a_launch(scan_case):
    before = scan_kernels.launches
    got = scan_kernels.horner_scan(
        *(torch.from_numpy(c.copy()) for c in scan_case["neg"]),
        torch.from_numpy(scan_case["kd"].copy()),
    )
    assert scan_kernels.launches == before
    for g, r in zip(got, scan_case["ref"]):
        assert torch.equal(g, r)


def test_wrapper_checks_dtype_shape_and_contiguity():
    _, neg, _, kd = _case(4)
    coords = [torch.from_numpy(c.copy()) for c in neg]
    digits = torch.from_numpy(kd.copy())
    with pytest.raises(TypeError):
        scan_kernels.horner_scan(coords[0].double(), *coords[1:], digits)
    with pytest.raises(TypeError):
        scan_kernels.horner_scan(*coords, digits.long())
    with pytest.raises(ValueError):
        scan_kernels.horner_scan(*coords, digits[:, :3])
    with pytest.raises(ValueError):
        scan_kernels.horner_scan(coords[0][:16], *coords[1:], digits)
    wide = torch.zeros(32, 8)
    with pytest.raises(ValueError):
        scan_kernels.horner_scan(wide[:, ::2], *coords[1:], digits)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler is an error, never a silent fallback."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(scan_kernels, "BUILD_DIR", tmp_path / "build")
    scan_kernels._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            scan_kernels.build()
    finally:
        scan_kernels._library.cache_clear()


_HOST_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "horner_scan.cu"
int main(int argc, char** argv) {
  if (argc != 4) return 2;
  long long batch = atoll(argv[1]);
  long long s = 32 * batch;
  std::vector<float> in(4 * s), out(4 * s);
  std::vector<int32_t> digits(64 * batch);
  FILE* f = fopen(argv[2], "rb");
  if (!f || fread(in.data(), 4, in.size(), f) != in.size() ||
      fread(digits.data(), 4, digits.size(), f) != digits.size()) return 3;
  fclose(f);
  for (long long lane = 0; lane < batch; ++lane)
    horner_lane(&in[0], &in[s], &in[2 * s], &in[3 * s], digits.data(),
                &out[0], &out[s], &out[2 * s], &out[3 * s], batch, lane);
  f = fopen(argv[3], "wb");
  if (!f || fwrite(out.data(), 4, out.size(), f) != out.size()) return 4;
  fclose(f);
  return 0;
}
"""


def test_kernel_arithmetic_compiled_for_the_host_matches_reference(scan_case, tmp_path):
    """The CUDA source's field and point code is ``__host__ __device__``:
    compiled as plain C++ (no nvcc) it must give, lane for lane, the plain
    version's projective point as canonical limbs -- here on inputs with
    negative weak limbs."""
    import shutil
    import subprocess

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source's arithmetic")
    (tmp_path / "harness.cpp").write_text(_HOST_HARNESS)
    exe = tmp_path / "harness"
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-x", "c++", f"-I{scan_kernels._SOURCE.parent}",
         "-o", str(exe), str(tmp_path / "harness.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    neg = [c.copy() for c in scan_case["neg"]]
    for c in neg:  # borrow 256 from every limb >= 172: same value, negative limbs
        for i in range(31):
            move = (c[i] >= 172).astype(np.float32)
            c[i] -= 256 * move
            c[i + 1] += move
    assert min(c.min() for c in neg) < 0
    kd = scan_case["kd"]
    (tmp_path / "in.bin").write_bytes(
        b"".join(c.astype(np.float32).tobytes() for c in neg) + kd.astype(np.int32).tobytes()
    )
    subprocess.run(
        [str(exe), str(N), str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
        check=True, timeout=120,
    )
    out = np.fromfile(tmp_path / "out.bin", dtype=np.float32).reshape(4, 32, N)
    want = scan_kernels.horner_scan_reference(
        *(torch.from_numpy(c) for c in neg), torch.from_numpy(kd.copy())
    )
    for name, got, w in zip("xyzt", out, want):
        assert np.array_equal(got, tfe.freeze(w).numpy().astype(np.float32)), name
