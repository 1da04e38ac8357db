"""The port's P-256 Horner scan against the JAX package's.

``horner_scan_p256_reference`` (the plain torch version of the CUDA kernel
B2) is held limb for limb against the XLA ``lax.scan`` of
tests/test_pallas_scan.py (``_p256_xla_reference``, the JAX verifier's
default scan), and on frozen values against JAX's Pallas kernel
``horner_scan_p256(..., tile=2, interpret=True)``, on the same 4-lane case
as that file.  The CUDA source's arithmetic and its per-signature schedule
(a group of roles splitting each point operation by product level) are
compiled for the host with g++: the scan is held against the plain version
on lanes with Q off the curve, zero coordinates, negative weak limbs,
coordinates at or above p and all-zero digits, and every role's stage
products against the unsplit RCB formulas.  The kernel itself runs only on
the card: its tests are in tests/test_torch_cuda.py.
"""

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
from consensus_tpu_torch.obs.kernels import KERNELS
from consensus_tpu_torch.ops import field_p256 as tfp
from consensus_tpu_torch.ops import p256 as tp
from consensus_tpu_torch.ops import scan_kernels
from test_pallas_scan import _p256_case, _p256_xla_reference
from test_torch_straus_msm import _host_build

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
    before = (KERNELS.stats("horner_scan").launches, KERNELS.stats("horner_scan_p256").launches)
    got = scan_kernels.horner_scan_p256(
        torch.from_numpy(scan_case["qx"].copy()),
        torch.from_numpy(scan_case["qy"].copy()),
        torch.from_numpy(scan_case["kd"].copy()),
    )
    assert (KERNELS.stats("horner_scan").launches, KERNELS.stats("horner_scan_p256").launches) == before
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
    monkeypatch.setattr(scan_kernels, "_LIBRARIES", {})  # nothing loaded yet
    with pytest.raises(RuntimeError, match="nvcc not found"):
        scan_kernels.build("horner_scan_p256")


_HOST_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "horner_scan_p256.cu"
// The kernel's schedule on the host: blocks of SIGNATURES groups, the
// signature of each group at group_lane(block, thread), a group past the
// batch skipped; each group runs its G roles in turn (serial_group) over its
// block's slots and table, as the card's shared memory holds them.
int main(int argc, char** argv) {
  if (argc != 4) return 2;
  long long batch = atoll(argv[1]);
  long long s = 32 * batch;
  std::vector<float> in(2 * s), out(3 * s, -1.0f);
  std::vector<int32_t> digits(65 * batch);
  FILE* f = fopen(argv[2], "rb");
  if (!f || fread(in.data(), 4, in.size(), f) != in.size() ||
      fread(digits.data(), 4, digits.size(), f) != digits.size()) return 3;
  fclose(f);
  const long long blocks = (batch + SIGNATURES - 1) / SIGNATURES;
  for (long long b = 0; b < blocks; ++b) {
    static fe slots[SIGNATURES][SLOTS];
    static ge tables[SIGNATURES][TABLE];
    for (int t = 0; t < THREADS; t += G) {
      const long long lane = group_lane(b, t);
      if (lane >= batch) continue;
      const serial_group g = {slots[t / G], 0, G};
      scan_signature(g, tables[t / G], &in[0], &in[s], digits.data(), &out[0], &out[s],
                     &out[2 * s], batch, lane);
    }
  }
  printf("blocks %lld groups %d roles %d\n", blocks, SIGNATURES, G);
  f = fopen(argv[3], "wb");
  if (!f || fwrite(out.data(), 4, out.size(), f) != out.size()) return 4;
  fclose(f);
  return 0;
}
"""


def _multiples_of_g(n: int) -> list[tuple[int, int]]:
    pts, cur = [], (tp.GX, tp.GY)
    for _ in range(n):
        pts.append(cur)
        cur = tp._add_int(cur, (tp.GX, tp.GY))
    return pts


def test_kernel_arithmetic_compiled_for_the_host_matches_reference(tmp_path):
    """The CUDA source's field code, split point operations and scan are
    ``__host__ __device__``: compiled as plain C++ (no nvcc) and run with the
    kernel's schedule -- 16 signatures a block, 8 roles a signature run in
    turn over the block's slots and tables, 40 lanes in 3 blocks, the last
    holding 8 -- they must give, lane for lane, the plain version's projective
    point as canonical limbs.  The edge lanes sit in the first block and
    again in the ragged one: Q off the curve, zero coordinates, coordinates
    at and above p, negative weak limbs, all-zero digits."""
    exe = _host_build(tmp_path, _HOST_HARNESS, "harness")
    n, edges = 40, (0, 32)
    pts = _multiples_of_g(n)
    xs, ys = [x for x, _ in pts], [y for _, y in pts]
    for e in edges:
        xs[e + 4] = 5                            # Q off the curve
        xs[e + 5], ys[e + 5] = 0, 0              # a padded lane's zeros
        xs[e + 6], ys[e + 6] = 2**256 - 1, P     # coordinates at and above p
    qx = np.stack([tfp.int_to_limbs(v) for v in xs], axis=1)
    qy = np.stack([tfp.int_to_limbs(v) for v in ys], axis=1)
    weak = np.r_[0:4, 32:36]
    for c in (qx, qy):  # these lanes: the same values in negative weak limbs
        for i in range(31):
            move = (c[i, weak] >= 172).astype(np.float32)
            c[i, weak] -= 256 * move
            c[i + 1, weak] += move
    assert qx.min() < 0 and qy.min() < 0
    rng = np.random.default_rng(23)
    scalars = [0, 1, tp.N - 1] + [int.from_bytes(rng.bytes(32), "big") % tp.N for _ in range(n - 3)]
    kd = tmodel._scalars_to_signed_window_digits(scalars).astype(np.int32)
    kd[:, [7, n - 1]] = 0  # a padded lane's digits: d = -8 in every window
    (tmp_path / "in.bin").write_bytes(qx.tobytes() + qy.tobytes() + kd.tobytes())
    proc = subprocess.run(
        [str(exe), str(n), str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
        check=True, capture_output=True, text=True, timeout=120,
    )
    assert proc.stdout.split() == ["blocks", "3", "groups", "16", "roles", "8"]
    out = np.fromfile(tmp_path / "out.bin", dtype=np.float32).reshape(3, 32, n)
    want = scan_kernels.horner_scan_p256_reference(
        torch.from_numpy(qx), torch.from_numpy(qy), torch.from_numpy(kd)
    )
    for name, got, w in zip("xyz", out, want):
        assert np.array_equal(got, tfp.freeze(w).numpy().astype(np.float32)), name


# For each of n point pairs (p, q) loaded from limbs: every product of the
# add and of the double (of p) from the stage functions, role by role and
# level by level, each level given the unsplit products of the levels before
# it and poison in every other slot; ge_add(p, q) and ge_dbl(p) (the stage
# functions for every role in turn); then the same products and results from
# the unsplit RCB formulas.  The unsplit formulas are the straight-line
# sequence of consensus_tpu/ops/p256.py (squarings by fe_sqr), each product
# recorded in the slot the split operations give it.
_STAGE_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "horner_scan_p256.cu"
static ge unsplit_add(const ge& p, const ge& q, fe* u) {
  const fe b = fe_b();
  fe t0 = u[0] = fe_mul(p.X, q.X);
  fe t1 = u[1] = fe_mul(p.Y, q.Y);
  fe t2 = u[2] = fe_mul(p.Z, q.Z);
  fe t3 = fe_add(p.X, p.Y);
  fe t4 = fe_add(q.X, q.Y);
  t3 = u[3] = fe_mul(t3, t4);
  t4 = fe_add(t0, t1);
  t3 = fe_sub(t3, t4);
  t4 = fe_add(p.Y, p.Z);
  fe t5 = fe_add(q.Y, q.Z);
  t4 = u[4] = fe_mul(t4, t5);
  t5 = fe_add(t1, t2);
  t4 = fe_sub(t4, t5);
  fe x3 = fe_add(p.X, p.Z);
  fe y3 = fe_add(q.X, q.Z);
  x3 = u[5] = fe_mul(x3, y3);
  y3 = fe_add(t0, t2);
  y3 = fe_sub(x3, y3);
  fe z3 = u[6] = fe_mul(b, t2);
  x3 = fe_sub(y3, z3);
  z3 = fe_add(x3, x3);
  x3 = fe_add(x3, z3);
  z3 = fe_sub(t1, x3);
  x3 = fe_add(t1, x3);
  y3 = u[7] = fe_mul(b, y3);
  t1 = fe_add(t2, t2);
  t2 = fe_add(t1, t2);
  y3 = fe_sub(y3, t2);
  y3 = fe_sub(y3, t0);
  t1 = fe_add(y3, y3);
  y3 = fe_add(t1, y3);
  t1 = fe_add(t0, t0);
  t0 = fe_add(t1, t0);
  t0 = fe_sub(t0, t2);
  t1 = u[8] = fe_mul(t4, y3);
  t2 = u[9] = fe_mul(t0, y3);
  y3 = u[10] = fe_mul(x3, z3);
  y3 = fe_add(y3, t2);
  x3 = u[11] = fe_mul(t3, x3);
  x3 = fe_sub(x3, t1);
  z3 = u[12] = fe_mul(t4, z3);
  t1 = u[13] = fe_mul(t3, t0);
  z3 = fe_add(z3, t1);
  return ge{x3, y3, z3};
}
static ge unsplit_dbl(const ge& p, fe* u) {
  const fe b = fe_b();
  fe t0 = u[0] = fe_sqr(p.X);
  fe t1 = u[1] = fe_sqr(p.Y);
  fe t2 = u[2] = fe_sqr(p.Z);
  fe t3 = u[3] = fe_mul(p.X, p.Y);
  t3 = fe_add(t3, t3);
  fe z3 = u[4] = fe_mul(p.X, p.Z);
  z3 = fe_add(z3, z3);
  fe y3 = u[6] = fe_mul(b, t2);
  y3 = fe_sub(y3, z3);
  fe x3 = fe_add(y3, y3);
  y3 = fe_add(x3, y3);
  x3 = fe_sub(t1, y3);
  y3 = fe_add(t1, y3);
  y3 = u[9] = fe_mul(x3, y3);
  x3 = u[10] = fe_mul(x3, t3);
  t3 = fe_add(t2, t2);
  t2 = fe_add(t2, t3);
  z3 = u[7] = fe_mul(b, z3);
  z3 = fe_sub(z3, t2);
  z3 = fe_sub(z3, t0);
  t3 = fe_add(z3, z3);
  z3 = fe_add(z3, t3);
  t3 = fe_add(t0, t0);
  t0 = fe_add(t3, t0);
  t0 = fe_sub(t0, t2);
  t0 = u[11] = fe_mul(t0, z3);
  y3 = fe_add(y3, t0);
  t0 = u[5] = fe_mul(p.Y, p.Z);
  t0 = fe_add(t0, t0);
  z3 = u[12] = fe_mul(t0, z3);
  x3 = fe_sub(x3, z3);
  z3 = u[8] = fe_mul(t0, t1);
  z3 = fe_add(z3, z3);
  z3 = fe_add(z3, z3);
  return ge{x3, y3, z3};
}
// Slots [0, lo) from u, the rest poison: a stage that read a slot of its
// own level or a later one would see it.
static void prime(fe* s, const fe* u, int lo) {
  for (int k = 0; k < SLOTS; ++k)
    for (int i = 0; i < 8; ++i) s[k].v[i] = k < lo ? u[k].v[i] : 0xa5a5a5a5u ^ (k * 8 + i);
}
static void put(std::vector<u32>& out, const fe& a) { out.insert(out.end(), a.v, a.v + 8); }
int main(int argc, char** argv) {
  if (argc != 4) return 2;
  const long long n = atoll(argv[1]), s = 32 * n;
  std::vector<float> c(6 * s);
  FILE* f = fopen(argv[2], "rb");
  if (!f || fread(c.data(), 4, c.size(), f) != c.size()) return 3;
  fclose(f);
  std::vector<u32> out;
  for (long long i = 0; i < n; ++i) {
    const ge p = {fe_load(&c[i], n), fe_load(&c[s + i], n), fe_load(&c[2 * s + i], n)};
    const ge q = {fe_load(&c[3 * s + i], n), fe_load(&c[4 * s + i], n), fe_load(&c[5 * s + i], n)};
    fe ua[SLOTS], ud[SLOTS], sa[SLOTS], sd[SLOTS], buf[SLOTS];
    const ge ra = unsplit_add(p, q, ua), rd = unsplit_dbl(p, ud);
    for (int r = 0; r < G; ++r) {
      prime(buf, ua, 0);
      for (int k = r; k < 6; k += G) sa[k] = add_level1(p, q, k);
      prime(buf, ua, 6);
      for (int k = r; k < 2; k += G) sa[6 + k] = add_level2(buf, k);
      prime(buf, ua, 8);
      const add_terms va = add_level3_terms(buf);
      for (int k = r; k < 6; k += G) sa[8 + k] = add_level3(va, k);
      prime(buf, ud, 0);
      for (int k = r; k < 6; k += G) sd[k] = dbl_level1(p, k);
      prime(buf, ud, 6);
      for (int k = r; k < 3; k += G) sd[6 + k] = dbl_level2(buf, k);
      prime(buf, ud, 9);
      const dbl_terms vd = dbl_level3_terms(buf);
      for (int k = r; k < 4; k += G) sd[9 + k] = dbl_level3(vd, k);
    }
    const ge ga = ge_add(p, q), gd = ge_dbl(p);
    for (int k = 0; k < 14; ++k) put(out, sa[k]);
    for (int k = 0; k < 13; ++k) put(out, sd[k]);
    for (const ge* e : {&ga, &gd}) { put(out, e->X); put(out, e->Y); put(out, e->Z); }
    for (int k = 0; k < 14; ++k) put(out, ua[k]);
    for (int k = 0; k < 13; ++k) put(out, ud[k]);
    for (const ge* e : {&ra, &rd}) { put(out, e->X); put(out, e->Y); put(out, e->Z); }
  }
  f = fopen(argv[3], "wb");
  if (!f || fwrite(out.data(), 4, out.size(), f) != out.size()) return 4;
  fclose(f);
  return 0;
}
"""


def _words_to_int(w) -> int:
    return sum(int(x) << (32 * i) for i, x in enumerate(w))


def test_split_stages_equal_the_unsplit_formulas_limb_for_limb(tmp_path):
    """Every product of the add's and the double's three levels, computed by
    the stage function of each of the G roles from the unsplit products of
    the earlier levels (poison in every other slot), equals the product the
    unsplit RCB formulas form, word for word; so do ge_add and ge_dbl (the
    stages for every role in turn) and the unsplit results.  Pairs: random
    canonical coordinates, points on the curve in other projective
    representatives, the identity on either side and on both, a point added
    to itself and to its negation."""
    exe = _host_build(tmp_path, _STAGE_HARNESS, "stages")
    rng = np.random.default_rng(29)

    def rand():
        return int.from_bytes(rng.bytes(32), "little") % P

    def scaled(pt):
        lam = rand() or 1
        return (pt[0] * lam % P, pt[1] * lam % P, lam)

    ident = (0, 1, 0)
    base = _multiples_of_g(6)
    on = [scaled(pt) for pt in base]
    pairs = [((rand(), rand(), rand()), (rand(), rand(), rand())) for _ in range(12)]
    pairs += [(on[i], on[i + 1]) for i in range(5)]
    pairs += [(ident, on[0]), (on[1], ident), (ident, ident)]
    pairs += [(on[2], on[2]), (on[3], scaled(base[3]))]            # p + p
    pairs += [(on[4], (on[4][0], (P - on[4][1]) % P, on[4][2]))]            # p + (-p)
    pairs += [((P - 1, P - 1, P - 1), (P - 1, 0, P - 1))]
    n = len(pairs)
    rows = [[pr[k // 3][k % 3] for pr in pairs] for k in range(6)]
    coords = [np.stack([tfp.int_to_limbs(v) for v in row], axis=1) for row in rows]
    (tmp_path / "in.bin").write_bytes(b"".join(c.astype(np.float32).tobytes() for c in coords))
    subprocess.run([str(exe), str(n), str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
                   check=True, timeout=300)
    out = np.fromfile(tmp_path / "out.bin", dtype=np.uint32).reshape(n, 2, 14 + 13 + 6, 8)
    split, unsplit = out[:, 0], out[:, 1]
    for k in range(14):
        assert np.array_equal(split[:, k], unsplit[:, k]), f"add product {k}"
    for k in range(13):
        assert np.array_equal(split[:, 14 + k], unsplit[:, 14 + k]), f"dbl product {k}"
    assert np.array_equal(split[:, 27:], unsplit[:, 27:]), "ge_add / ge_dbl results"
    vals = [[_words_to_int(w) for w in lane] for lane in split]
    assert all(v < P for lane in vals for v in lane)  # canonical throughout
    # Not vacuous: the products differ from one another and from the poison.
    assert len({tuple(w) for w in split[:12, :27].reshape(-1, 8).tolist()}) == 12 * 27

    def affine(x, y, z):
        zi = pow(z, P - 2, P)
        return x * zi % P, y * zi % P

    for i in (20, 21):  # p + p is the double of p, as a group element
        assert affine(*vals[i][27:30]) == affine(*vals[i][30:33]) != (0, 0)
    assert vals[22][29] == 0 and vals[22][28] != 0   # p + (-p) is the identity
    assert vals[19][27:33] == [0, 1, 0, 0, 1, 0]      # identity + identity, 2 identity
