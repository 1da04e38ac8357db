"""The port's Horner scan against the JAX package's Pallas kernel.

``horner_scan_reference`` (the plain torch version of the CUDA kernel) is
held limb for limb against JAX's ``horner_scan(..., tile=4,
interpret=True)`` and against the XLA ``lax.scan`` the JAX verifier runs by
default, at n = 8 with the scalar-0 and scalar-1 lanes included, as
tests/test_pallas_scan.py does.  The CUDA kernel itself runs only on the
card: its tests are in tests/test_torch_cuda.py.
"""

import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
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
from consensus_tpu_torch.obs.kernels import KERNELS
from consensus_tpu_torch.ops import scan_kernels
from test_torch_straus_msm import _host_build

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
    before = KERNELS.stats("horner_scan").launches
    got = scan_kernels.horner_scan(
        *(torch.from_numpy(c.copy()) for c in scan_case["neg"]),
        torch.from_numpy(scan_case["kd"].copy()),
    )
    assert KERNELS.stats("horner_scan").launches == before
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
    monkeypatch.setattr(scan_kernels, "_LIBRARIES", {})  # nothing loaded yet
    with pytest.raises(RuntimeError, match="nvcc not found"):
        scan_kernels.build()


_HOST_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "horner_scan.cu"
// The kernel's schedule on the host: blocks of SIGNATURES groups, the
// signature of each group at group_lane(block, thread), a group past the
// batch skipped; each group runs its G roles in turn (serial_group) over its
// block's tables and slots, as the card's shared memory holds them, both
// poisoned before every block.
int main(int argc, char** argv) {
  if (argc != 4) return 2;
  long long batch = atoll(argv[1]);
  long long s = 32 * batch;
  std::vector<float> in(4 * s), out(4 * s, -1.0f);
  std::vector<int32_t> digits(64 * batch);
  FILE* f = fopen(argv[2], "rb");
  if (!f || fread(in.data(), 4, in.size(), f) != in.size() ||
      fread(digits.data(), 4, digits.size(), f) != digits.size()) return 3;
  fclose(f);
  const long long blocks = (batch + SIGNATURES - 1) / SIGNATURES;
  for (long long b = 0; b < blocks; ++b) {
    static fe tables[SIGNATURES][TABLE][G];
    static fe slots[SIGNATURES][2][G];
    memset(tables, 0xa5, sizeof tables);
    memset(slots, 0x5a, sizeof slots);
    for (int t = 0; t < THREADS; t += G) {
      const long long lane = group_lane(b, t);
      if (lane >= batch) continue;
      const serial_group g = {0, G, slots[t / G]};
      scan_signature(g, tables[t / G], &in[0], &in[s], &in[2 * s], &in[3 * s], digits.data(),
                     &out[0], &out[s], &out[2 * s], &out[3 * s], batch, lane);
    }
  }
  printf("blocks %lld groups %d roles %d\n", blocks, SIGNATURES, G);
  f = fopen(argv[3], "wb");
  if (!f || fwrite(out.data(), 4, out.size(), f) != out.size()) return 4;
  fclose(f);
  return 0;
}
"""


def test_kernel_arithmetic_compiled_for_the_host_matches_reference(tmp_path):
    """The CUDA source's field code, split point operations and scan are
    ``__host__ __device__``: compiled as plain C++ (no nvcc) and run with the
    kernel's schedule -- 16 signatures a block, 4 roles a signature run in
    turn over the block's poisoned tables and slots, 39 lanes in 3 blocks,
    the last holding 7 -- they must give, lane for lane, the plain version's projective
    point as canonical limbs.  Every lane's -A is in negative weak limbs; the
    edge lanes sit in the first block and again in the ragged one: -A of the
    identity, stored digits all 0 (d = -8 in every window) and all 8 (d = 0)."""
    exe = _host_build(tmp_path, _HOST_HARNESS, "harness")
    n, edges = 39, (0, 32)
    pts, _, scalars, kd = _case(n, seed=11)
    for e in edges:
        pts[e + 2] = (0, 1)           # A the identity
        kd[:, e + 3] = 0              # d = -8 in every window
        kd[:, e + 4] = 8              # d = 0 in every window
    coords = [
        torch.from_numpy(np.stack([tfe.int_to_limbs(c) for c in col], axis=1))
        for col in (
            [x for x, _ in pts], [y for _, y in pts], [1] * n, [x * y % P for x, y in pts]
        )
    ]
    neg = [chip_smoke.weaken(c).contiguous().numpy() for c in ted.negate(ted.Point(*coords))]
    assert all((c < 0).any(axis=0).sum() > n // 2 for c in neg[:2])
    (tmp_path / "in.bin").write_bytes(
        b"".join(c.astype(np.float32).tobytes() for c in neg) + kd.astype(np.int32).tobytes()
    )
    proc = subprocess.run(
        [str(exe), str(n), str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
        check=True, capture_output=True, text=True, timeout=120,
    )
    assert proc.stdout.split() == ["blocks", "3", "groups", "16", "roles", "4"]
    out = np.fromfile(tmp_path / "out.bin", dtype=np.float32).reshape(4, 32, n)
    want = scan_kernels.horner_scan_reference(
        *(torch.from_numpy(c) for c in neg), torch.from_numpy(kd.copy())
    )
    for name, got, w in zip("xyzt", out, want):
        assert np.array_equal(got, tfe.freeze(w).numpy().astype(np.float32)), name
    # Not vacuous: the edge lanes land on the identity, the others do not.
    ident = ted.is_identity(want).numpy()
    for e in edges:
        assert ident[e + 2] and ident[e + 4] and not ident[e + 3]
    assert ident.sum() == 1 + 2 * len(edges)  # and scalar 0 on lane 0


# For each of n point pairs (p, q) loaded from weak limbs: the double of p
# without and with T and the add p + q from the stage functions, role by
# role (level 2 given the unsplit level-1 products in slots 0-3 and poison
# in slots 4-7); ge_dbl and ge_add; the add of p and the table entry of q
# (X, Y, Z, 2d T), as is and negated, from entry_factor and the stages and
# from group_add on serial_group; then the unsplit straight-line formulas'
# products and results: the double without and with T, p + q and p + (-q).
_STAGE_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "horner_scan.cu"
// dbl-2008-hwcd and add-2008-hwcd-3 in one straight line, as
// consensus_tpu/ops/ed25519.py writes them: u[0..3] the level-1 products,
// u[4..7] the result (X3, Y3, Z3, T3).
static void unsplit_dbl(const ge& p, bool need_t, fe* u) {
  const fe a = u[0] = fe_mul(p.X, p.X);
  const fe b = u[1] = fe_mul(p.Y, p.Y);
  const fe zz = u[2] = fe_mul(p.Z, p.Z);
  const fe c = fe_add(zz, zz);
  const fe h = fe_add(a, b);
  const fe xy = fe_add(p.X, p.Y);
  const fe e = fe_sub(h, u[3] = fe_mul(xy, xy));
  const fe g = fe_sub(a, b);
  const fe f = fe_add(c, g);
  u[4] = fe_mul(e, f);
  u[5] = fe_mul(g, h);
  u[6] = fe_mul(f, g);
  u[7] = need_t ? fe_mul(e, h) : p.T;
}
static void unsplit_add(const ge& p, const ge& q, fe* u) {
  const fe a = u[0] = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
  const fe b = u[1] = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
  const fe c = u[2] = fe_mul(fe_mul(p.T, fe_d2()), q.T);
  const fe d = u[3] = fe_mul(fe_add(p.Z, p.Z), q.Z);
  const fe e = fe_sub(b, a);
  const fe f = fe_sub(d, c);
  const fe g = fe_add(d, c);
  const fe h = fe_add(b, a);
  u[4] = fe_mul(e, f);
  u[5] = fe_mul(g, h);
  u[6] = fe_mul(f, g);
  u[7] = fe_mul(e, h);
}
// Slots 0-3 from u, slots 4-7 poison.
static void prime(fe* s, const fe* u) {
  for (int k = 0; k < 8; ++k)
    for (int i = 0; i < 5; ++i) s[k].v[i] = k < 4 ? u[k].v[i] : 0xa5a5a5a5a5a5ULL ^ (k * 5 + i);
}
static void put(std::vector<u64>& out, const fe& a) { out.insert(out.end(), a.v, a.v + 5); }
static void put(std::vector<u64>& out, const ge& p) { put(out, p.X); put(out, p.Y); put(out, p.Z); put(out, p.T); }
int main(int argc, char** argv) {
  if (argc != 4) return 2;
  const long long n = atoll(argv[1]), s = 32 * n;
  std::vector<float> c(8 * s);
  FILE* f = fopen(argv[2], "rb");
  if (!f || fread(c.data(), 4, c.size(), f) != c.size()) return 3;
  fclose(f);
  std::vector<u64> out;
  fe group_slots[2][G];
  const serial_group g = {0, G, group_slots};
  for (long long i = 0; i < n; ++i) {
    const ge p = {fe_load(&c[i], n), fe_load(&c[s + i], n), fe_load(&c[2 * s + i], n),
                  fe_load(&c[3 * s + i], n)};
    const ge q = {fe_load(&c[4 * s + i], n), fe_load(&c[5 * s + i], n),
                  fe_load(&c[6 * s + i], n), fe_load(&c[7 * s + i], n)};
    const ge nq = {fe_neg(q.X), q.Y, q.Z, fe_neg(q.T)};
    fe ud[8], udt[8], ua[8], un[8], slots[8];
    unsplit_dbl(p, false, ud);
    unsplit_dbl(p, true, udt);
    unsplit_add(p, q, ua);
    unsplit_add(p, nq, un);
    for (int need_t = 0; need_t < 2; ++need_t) {
      const fe* u = need_t ? udt : ud;
      for (int r = 0; r < G; ++r) put(out, dbl_stage1(p, r));
      prime(slots, u);
      for (int r = 0; r < G; ++r) put(out, dbl_stage2(p, slots, r, need_t));
    }
    const fe t1 = fe_mul(p.T, fe_d2());
    for (int r = 0; r < G; ++r) put(out, add_stage1(p, t1, add_factor(q, r), r));
    prime(slots, ua);
    for (int r = 0; r < G; ++r) put(out, add_stage2(slots, r));
    put(out, ge_dbl(p, false));
    put(out, ge_dbl(p, true));
    put(out, ge_add(p, q));
    const fe entry[G] = {q.X, q.Y, q.Z, fe_mul(q.T, fe_d2())};
    for (int neg = 0; neg < 2; ++neg) {
      fe m[G];
      for (int r = 0; r < G; ++r) put(out, m[r] = add_stage1(p, p.T, entry_factor(entry, r, neg), r));
      for (int r = 0; r < G; ++r) put(out, add_stage2(m, r));
      put(out, group_add(g, p, entry, neg));
    }
    for (const fe* u : {ud, udt, ua, un})
      for (int k = 0; k < 8; ++k) put(out, u[k]);
  }
  f = fopen(argv[3], "wb");
  if (!f || fwrite(out.data(), 8, out.size(), f) != out.size()) return 4;
  fclose(f);
  return 0;
}
"""


def _fe_values(words: np.ndarray) -> np.ndarray:
    """Field elements (..., 5) of radix-2^51 limbs -> their values mod p."""
    flat = words.reshape(-1, 5)
    vals = [sum(int(w) << (51 * i) for i, w in enumerate(row)) % P for row in flat]
    return np.array(vals, dtype=object).reshape(words.shape[:-1])


def test_split_stages_equal_the_unsplit_formulas_limb_for_limb(tmp_path):
    """Every role's product of both levels of the double (without and with
    T) and of the add, from the stage functions, with level 2 fed the
    unsplit level-1 products and poison in the slots it must not read,
    equals the product the straight-line formulas form, limb for limb; so do
    ge_dbl and ge_add (the stages for every role in turn).  The kernel's add
    of a table entry holding 2d T (entry_factor, as is and negated, and
    group_add on serial_group) forms A, B and D limb for limb and C and the
    sum equal mod p to the straight-line add of q and of -q.  Pairs: random
    field elements, points on the curve in other projective representatives,
    the identity on either side and on both, p + p and p + (-p), in weak
    limbs with negative entries."""
    exe = _host_build(tmp_path, _STAGE_HARNESS, "stages")
    rng = np.random.default_rng(31)

    def rand():
        return int.from_bytes(rng.bytes(32), "little") % P

    def scaled(pt):  # extended coordinates (X : Y : Z : T) with Z = lam
        lam = rand() or 1
        x, y = pt
        return (x * lam % P, y * lam % P, lam, x * y % P * lam % P)

    ident = (0, 1, 1, 0)
    base, cur = [], (ted._BX, ted._BY)
    for _ in range(6):
        base.append(cur)
        cur = ted._edwards_add_int(cur, (ted._BX, ted._BY))
    on = [scaled(pt) for pt in base]
    neg0 = ((P - on[4][0]) % P, on[4][1], on[4][2], (P - on[4][3]) % P)
    pairs = [(tuple(rand() for _ in range(4)), tuple(rand() for _ in range(4))) for _ in range(12)]
    pairs += [(on[i], on[i + 1]) for i in range(5)]
    pairs += [(ident, on[0]), (on[1], ident), (ident, ident)]
    pairs += [(on[2], on[2]), (on[3], scaled(base[3])), (on[4], neg0)]
    pairs += [((P - 1,) * 4, (P - 1, 0, P - 1, 0))]
    n = len(pairs)
    rows = [[pr[k // 4][k % 4] for pr in pairs] for k in range(8)]
    coords = [
        chip_smoke.weaken(torch.from_numpy(np.stack([tfe.int_to_limbs(v) for v in row], axis=1)))
        .numpy()
        for row in rows
    ]
    assert min(c.min() for c in coords) < 0
    (tmp_path / "in.bin").write_bytes(b"".join(c.astype(np.float32).tobytes() for c in coords))
    subprocess.run([str(exe), str(n), str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
                   check=True, timeout=300)
    out = np.fromfile(tmp_path / "out.bin", dtype=np.uint64).reshape(n, 92, 5)
    dbl, dbl_t, add = out[:, 0:8], out[:, 8:16], out[:, 16:24]
    ge_dbl, ge_dbl_t, ge_add = out[:, 24:28], out[:, 28:32], out[:, 32:36]
    entry, entry_neg = out[:, 36:48], out[:, 48:60]
    u_dbl, u_dbl_t, u_add, u_add_neg = (out[:, 60 + 8 * k:68 + 8 * k] for k in range(4))
    for name, split, unsplit in (("dbl without T", dbl, u_dbl), ("dbl with T", dbl_t, u_dbl_t),
                                 ("add", add, u_add)):
        for k in range(8):
            assert np.array_equal(split[:, k], unsplit[:, k]), f"{name} product {k}"
    assert np.array_equal(ge_dbl, u_dbl[:, 4:]), "ge_dbl without T"
    assert np.array_equal(ge_dbl_t, u_dbl_t[:, 4:]), "ge_dbl with T"
    assert np.array_equal(ge_add, u_add[:, 4:]), "ge_add"
    for name, got, want in (("entry", entry, u_add), ("negated entry", entry_neg, u_add_neg)):
        for k in (0, 1, 3):  # A, B, D
            assert np.array_equal(got[:, k], want[:, k]), f"{name} product {k}"
        vg, vw = _fe_values(got), _fe_values(want)
        assert (vg[:, 2] == vw[:, 2]).all(), f"{name} C"
        assert (vg[:, 4:8] == vw[:, 4:8]).all(), f"{name} stages' sum"
        assert (vg[:, 8:12] == vw[:, 4:8]).all(), f"{name} group_add"
    assert (out < 2**52).all()  # reduced limbs throughout
    # Not vacuous: T passes through without need_t and is a product with it;
    # the products differ from one another and from the poison; p + (-p) is
    # the identity and 2 (p + p) the double.
    assert not np.array_equal(dbl[:, 7], dbl_t[:, 7])
    assert len({tuple(w) for w in out[:12, 8:24].reshape(-1, 5).tolist()}) == 12 * 16
    v = _fe_values(u_add)
    assert v[22, 4] == 0 and v[22, 5] == v[22, 6] != 0          # on[4] + (-on[4])
    vd = _fe_values(u_dbl_t)
    for i in (20, 21):                                            # p + p == 2p
        x, y, z = v[i, 4:7]
        dx, dy, dz = vd[i, 4:7]
        assert x * dz % P == dx * z % P and y * dz % P == dy * z % P
