"""Kernels E1 (the Ed25519 add-and-compare), P1 (the P-256 fixed-base comb
[u1]G) and P2 (the P-256 verdict) against their plain versions and the JAX
package.

The wrappers (``ops/scan_kernels.py::add_and_equal``, ``::add_is_identity``,
``::fixed_base_mul_comb_p256`` and ``::verdict_p256``) run their plain
versions on CPU tensors and launch nothing.  Those are held against the JAX
package's functions on the same numpy inputs: ``ed.add`` + ``ed.equal`` and
``ed.add`` + ``ed.is_identity`` (verdicts, and the sum limb for limb),
``p256.fixed_base_mul_comb`` (limb for limb) and the JAX P-256 body's last
lines with ``p256.on_curve`` (verdicts), on the accept and reject classes: a
forged signature, the wrong key, the wrong message, an undecodable R,
host-rejected lanes, an off-curve Q, Z = 0 and a synthetic ``has_r2`` lane
(x(R') >= n).  The kernels' per-lane code (``csrc/verdict25519.cu``,
``csrc/comb_p256.cu``, ``csrc/verdict_p256.cu`` and what they use of
``csrc/ed25519_field.cuh`` and ``csrc/p256_field.cuh``) is
``__host__ __device__``: compiled as plain C++ with g++ and run with each
kernel's block schedule (E1's 4 roles a lane, P1's 4 window groups of 8
roles and P2's 8 roles in turn, over slots and P2's staged limbs poisoned
before each block) over poisoned
outputs, on limbs that are not canonical, it must equal the plain versions
(tolerance 0: verdicts, and P1's point projectively, since its window
groups land on another representative: ROADMAP divergence 26).  The bodies
reach the eager add, compare, comb and on-curve ops only through these
wrappers, which on a CUDA tensor launch the kernels.  The kernels
themselves run only on the card (tests/test_torch_cuda.py, chip_smoke.py
phase 24).
"""

import collections
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from consensus_tpu.ops import ed25519 as jed
from consensus_tpu.ops import field_p256 as jfp
from consensus_tpu.ops import p256 as jp
from consensus_tpu_torch.models import ecdsa_p256 as tmp
from consensus_tpu_torch.models import ed25519 as tmed
from consensus_tpu_torch.obs.kernels import KERNELS
from consensus_tpu_torch.ops import ed25519 as ted
from consensus_tpu_torch.ops import field25519 as tfe
from consensus_tpu_torch.ops import field_p256 as tfp
from consensus_tpu_torch.ops import p256 as tp
from consensus_tpu_torch.ops import scan_kernels
from test_torch_straus_msm import _host_build

PE = tfe.P
PP = tfp.P
N = tp.N
#: The kernels' geometry: E1's lanes (groups of 4 threads) a block, P1's
#: lanes (warps of 4 window groups of 8 threads) a block, P2's lanes (groups
#: of 8 threads) a block.
E1_LANES = 16
COMB_LANES = 4
VERDICT_LANES = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions' tensors are a few dozen lanes wide: one intra-op
    thread runs them faster than many, and leaves the cores to the other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t) -> np.ndarray:
    return np.ascontiguousarray(np.array(t, dtype=np.float32))


def _weak(a: np.ndarray) -> np.ndarray:
    """The same field elements in limbs that are not canonical: wherever a
    limb is >= 172 it lends 256 to the next (chip_smoke.weaken), so limbs
    turn negative (|limb| <= 340, inside both fields' weak contracts)."""
    return chip_smoke.weaken(torch.from_numpy(_np(a))).numpy()


# --- E1: the Ed25519 add-and-compare -------------------------------------------------

_ED_CLASSES = ("valid", "forged_s", "wrong_key", "wrong_message", "flipped_r", "r_off_curve",
               "s_ge_l", "bad_length")


def _ed_corpus():
    """Two lanes of each class of ``_ED_CLASSES``, and the expected verdict
    of each (RFC 8032 with the strict pre-checks)."""
    rng = np.random.default_rng(41)
    msgs, sigs, keys, kinds = [], [], [], []
    off = chip_smoke._off_curve_ys(2)
    for j, kind in enumerate(_ED_CLASSES * 2):
        seed = rng.bytes(32)
        msg = b"e1-%d-" % j + rng.bytes(int(rng.integers(0, 40)))
        sig, key = tmed.ref_sign(seed, msg), tmed.ref_public_key(seed)
        s = int.from_bytes(sig[32:], "little")
        if kind == "forged_s":
            sig = sig[:32] + ((s + 1) % tmed.L).to_bytes(32, "little")
        elif kind == "wrong_key":
            key = tmed.ref_public_key(rng.bytes(32))
        elif kind == "wrong_message":
            msg = msg + b"!"
        elif kind == "flipped_r":
            sig = bytes([sig[0] ^ 4]) + sig[1:]
        elif kind == "r_off_curve":
            sig = off[j % 2].to_bytes(32, "little") + sig[32:]
        elif kind == "s_ge_l":
            sig = sig[:32] + (s + tmed.L).to_bytes(32, "little")
        elif kind == "bad_length":
            sig = sig[:63]
        msgs.append(msg)
        sigs.append(sig)
        keys.append(key)
        kinds.append(kind)
    canon = tmed.Ed25519BatchVerifier._canonical_ok(sigs, keys)
    expected = np.array([bool(c) and tmed.ref_verify(k, s, m)
                         for c, k, s, m in zip(canon, keys, sigs, msgs)])
    return msgs, sigs, keys, kinds, expected


@pytest.fixture(scope="module")
def ed_case():
    """The strict body's inputs to its last step on the CPU, as
    ``verify_impl`` makes them for the corpus (padded to 16 lanes): acc =
    [k](-A), comb = [S]B, R and A side by side as decompression writes them,
    the masks, and the model's own verdicts."""
    msgs, sigs, keys, kinds, expected = _ed_corpus()
    engine = tmed.Ed25519BatchVerifier(device="cpu")
    inputs = engine.prepare_device_inputs(msgs, sigs, keys)
    y_r, sign_r, y_a, sign_a, s8, kd, host_ok = inputs
    b = y_r.shape[-1]
    pt, pt_ok = scan_kernels.decompress(
        torch.cat([y_r, y_a], dim=-1).to(torch.float32),
        torch.cat([sign_r, sign_a], dim=-1).to(torch.int32),
    )
    neg_a = [c[:, b:].contiguous() for c in ted.negate(ted.Point(*pt))]
    acc = scan_kernels.horner_scan(*neg_a, kd.to(torch.int32).contiguous())
    comb = scan_kernels.fixed_base_mul_comb(s8.to(torch.int32).contiguous())
    rz = pt.z.expand(tfe.LIMBS, 2 * b).contiguous()
    both = [c.expand(tfe.LIMBS, 2 * b).contiguous() for c in (pt.x, pt.y, rz, pt.t)]
    return {
        "n": len(msgs), "b": b, "kinds": kinds, "expected": expected,
        "acc": [c.numpy() for c in acc], "comb": [c.numpy() for c in comb],
        "both": [c.numpy() for c in both],
        "host_ok": host_ok.numpy().astype(bool), "r_ok": pt_ok[:b].numpy(),
        "a_ok": pt_ok[b:].numpy(), "model": tmed.verify_impl(*inputs).numpy(),
    }


def _r_of(case):
    """R's coordinates: the first b columns of D1's R || A output."""
    return [c[:, : case["b"]] for c in case["both"]]


@jax.jit
def _jax_add_equal(acc, comb, r):
    total = jed.add(acc, comb)
    return jed.equal(total, r), total


@jax.jit
def _jax_add_is_identity(acc, comb):
    return jed.is_identity(jed.add(acc, comb))


def _jax_strict(case):
    """JAX's verdicts (with the masks) and its sum acc + comb."""
    jp_ = [jed.Point(*(jnp.asarray(c) for c in case[k])) for k in ("acc", "comb")]
    r = jed.Point(*(jnp.asarray(np.ascontiguousarray(c)) for c in _r_of(case)))
    ok = case["host_ok"] & case["r_ok"] & case["a_ok"]
    same, total = _jax_add_equal(*jp_, r)
    return ok & np.asarray(same), total


def test_e1_strict_plain_matches_jax_and_the_classes(ed_case):
    """The wrapper on CPU tensors is the strict body's verdict, equal to the
    JAX package's ``add`` + ``equal`` with the masks and to RFC 8032 on
    every class; the sum is JAX's limb for limb; nothing launches."""
    c = ed_case
    t = lambda arrs: ted.Point(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs))
    before = KERNELS.stats("verdict25519").launches
    got = scan_kernels.add_and_equal(
        t(c["acc"]), t(c["comb"]), ted.Point(*(torch.from_numpy(a) for a in _r_of(c))),
        *(torch.from_numpy(c[k]) for k in ("host_ok", "r_ok", "a_ok")),
    ).numpy()
    assert KERNELS.stats("verdict25519").launches == before
    assert got.dtype == bool and got.shape == (c["b"],)
    jax_got, jtotal = _jax_strict(c)
    assert np.array_equal(got, jax_got)
    assert np.array_equal(got, c["model"])
    assert np.array_equal(got[: c["n"]], c["expected"]) and not got[c["n"]:].any()
    by_kind = collections.defaultdict(list)
    for k, v in zip(c["kinds"], got):
        by_kind[k].append(bool(v))
    assert by_kind.pop("valid") == [True, True]
    assert not any(v for vs in by_kind.values() for v in vs)
    total = ted.add(t(c["acc"]), t(c["comb"]))
    for g, w in zip(total, jtotal):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _identity_case():
    """E1's identity mode: comb = [x]B by the plain comb, acc = -comb (or
    another point) in another projective representative (all four
    coordinates times lam), one lane each: accept for x = 0 and for -comb;
    reject for comb itself, -comb + B and the 2-torsion point (0, -1)."""
    rng = np.random.default_rng(43)
    xs = [0, 1, tmed.L - 1] + [int.from_bytes(rng.bytes(32), "little") % tmed.L for _ in range(9)]
    digits = np.stack([np.frombuffer(x.to_bytes(32, "little"), np.uint8) for x in xs], axis=1)
    comb = ted.fixed_base_mul_comb(torch.from_numpy(digits.astype(np.int32)))
    frozen = [[tfe.limbs_to_int(tfe.freeze(c[:, i : i + 1])[:, 0]) for i in range(len(xs))]
              for c in comb]
    accs, want = [], []
    for i in range(len(xs)):
        x, y, z, t = (frozen[k][i] for k in range(4))
        lam = int.from_bytes(rng.bytes(32), "little") % PE or 1
        kind = i % 4
        if kind in (0, 1):  # -comb: the identity
            pt, ok = ((PE - x) % PE, y, z, (PE - t) % PE), True
        elif kind == 2:  # comb: 2 comb
            pt, ok = (x, y, z, t), xs[i] == 0
        else:  # -comb + B
            pt, ok = tmed._ref_add(((PE - x) % PE, y, z, (PE - t) % PE), tmed._BASE_POINT), False
        accs.append(tuple(v * lam % PE for v in pt))
        want.append(ok)
    # The 2-torsion point (0 : -1 : 1 : 0) against the identity: X = 0, Y != Z.
    accs.append((0, PE - 1, 1, 0))
    want.append(False)
    comb_np = [np.concatenate([c.numpy(), c.numpy()[:, :1]], axis=1) for c in comb]
    acc_np = [np.stack([tfe.int_to_limbs(p[k]) for p in accs], axis=1) for k in range(4)]
    return acc_np, comb_np, np.array(want)


def test_e1_identity_plain_matches_jax():
    """The identity mode's wrapper on CPU tensors equals the JAX package's
    ``add`` + ``is_identity`` and the construction."""
    acc, comb, want = _identity_case()
    got = scan_kernels.add_is_identity(
        ted.Point(*map(torch.from_numpy, acc)), ted.Point(*map(torch.from_numpy, comb))
    ).numpy()
    jgot = _jax_add_is_identity(jed.Point(*map(jnp.asarray, acc)),
                                jed.Point(*map(jnp.asarray, comb)))
    assert np.array_equal(got, np.asarray(jgot))
    assert np.array_equal(got, want) and want.any() and not want.all()


_E1_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "verdict25519.cu"
// E1's group code on the host with the kernel's block schedule (blocks of
// LANES groups, the lane of each group at verdict_group_lane(block, thread),
// a group past the batch skipped, each group running its G roles in turn
// (serial_group) over its block's slots, poisoned before every block) over
// verdicts poisoned first.  Mode 1 gets null R and mask pointers, as the
// wrapper passes them.
//   harness <n> <mode> <r_ld> <in: acc X Y Z T, comb X Y Z T (32 x n each),
//           R X Y Z T (32 x r_ld each), host_ok, r_ok, a_ok (n bytes each)> <out>
int main(int argc, char** argv) {
  if (argc != 6) return 2;
  const long long n = atoll(argv[1]), r_ld = atoll(argv[3]);
  const int mode = atoi(argv[2]);
  std::vector<float> ac(8 * 32 * n), r(4 * 32 * r_ld);
  std::vector<uint8_t> masks(3 * n), out(n, 0xa5);
  FILE* f = fopen(argv[4], "rb");
  if (!f || fread(ac.data(), 4, ac.size(), f) != ac.size() ||
      fread(r.data(), 4, r.size(), f) != r.size() ||
      fread(masks.data(), 1, masks.size(), f) != masks.size()) return 3;
  fclose(f);
  verdict_args v;
  for (int k = 0; k < 4; ++k) {
    v.acc[k] = &ac[k * 32 * n];
    v.comb[k] = &ac[(4 + k) * 32 * n];
    v.r[k] = mode == 1 ? nullptr : &r[k * 32 * r_ld];
  }
  v.host_ok = mode == 1 ? nullptr : &masks[0];
  v.r_ok = mode == 1 ? nullptr : &masks[n];
  v.a_ok = mode == 1 ? nullptr : &masks[2 * n];
  v.out = out.data();
  v.n = n;
  v.r_ld = r_ld;
  v.mode = mode;
  const long long blocks = (n + LANES - 1) / LANES;
  for (long long b = 0; b < blocks; ++b) {
    static fe slots[LANES][SLOTS];
    memset(slots, 0x5a, sizeof slots);
    for (int t = 0; t < THREADS; t += G) {
      const long long lane = verdict_group_lane(b, t);
      if (lane >= n) continue;
      verdict_group(serial_group{0, G, slots[t / G]}, v, lane);
    }
  }
  printf("blocks %lld lanes %d roles %d\n", blocks, LANES, G);
  f = fopen(argv[5], "wb");
  if (!f || fwrite(out.data(), 1, out.size(), f) != out.size()) return 4;
  fclose(f);
  return 0;
}
"""


@pytest.fixture(scope="module")
def e1_harness(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("e1")
    return _host_build(tmp, _E1_HARNESS, "e1"), tmp


def _run_e1(harness, mode, acc, comb, r, r_ld, masks):
    exe, tmp = harness
    n = acc[0].shape[1]
    payload = b"".join(_np(x).tobytes() for x in (*acc, *comb, *r))
    # Mode 1's masks are read from the file but never reach the kernel.
    masks = masks or [np.zeros(n, dtype=np.uint8)] * 3
    payload += b"".join(np.asarray(m, dtype=np.uint8).tobytes() for m in masks)
    (tmp / "in.bin").write_bytes(payload)
    proc = subprocess.run(
        [str(exe), str(n), str(mode), str(r_ld), str(tmp / "in.bin"), str(tmp / "out.bin")],
        check=True, capture_output=True, text=True, timeout=120,
    )
    assert proc.stdout.split() == ["blocks", str(-(-n // E1_LANES)), "lanes", str(E1_LANES),
                                   "roles", "4"]
    out = np.fromfile(tmp / "out.bin", dtype=np.uint8)
    assert set(out.tolist()) <= {0, 1}  # every lane written
    return out.astype(bool)


def test_e1_kernel_code_compiled_for_the_host_matches_plain(e1_harness, ed_case):
    """E1's strict mode on 70 lanes (the case tiled: two blocks, the second
    ragged), its inputs in negative weak limbs and R read from D1's layout
    (R and A side by side: row stride 2n): the plain version's verdict on
    every lane."""
    c = ed_case
    reps = -(-70 // c["b"])
    tile = lambda a: np.tile(a, (1, reps))[:, :70] if a.ndim == 2 else np.tile(a, reps)[:70]
    acc = [_weak(tile(a)) for a in c["acc"]]
    comb = [_weak(tile(a)) for a in c["comb"]]
    r = [np.concatenate([_weak(tile(a)), _weak(tile(a))], axis=1) for a in _r_of(c)]
    assert min(x.min() for x in (*acc, *comb, *r)) < 0
    masks = [tile(c[k]) for k in ("host_ok", "r_ok", "a_ok")]
    got = _run_e1(e1_harness, 0, acc, comb, r, 140, masks)
    want = scan_kernels.add_and_equal_reference(
        *(ted.Point(*map(torch.from_numpy, x)) for x in (acc, comb, [a[:, :70] for a in r])),
        *(torch.from_numpy(m) for m in masks),
    ).numpy()
    assert np.array_equal(got, want) and want.any() and not want.all()


def test_e1_identity_kernel_code_matches_plain(e1_harness):
    """E1's identity mode, reading no R and no masks (null pointers), on
    weak limbs: the plain version's verdicts, at the batch and at one lane."""
    acc, comb, want = _identity_case()
    acc, comb = [_weak(a) for a in acc], [_weak(a) for a in comb]
    got = _run_e1(e1_harness, 1, acc, comb, [], 0, [])
    plain = scan_kernels.add_is_identity_reference(
        ted.Point(*map(torch.from_numpy, acc)), ted.Point(*map(torch.from_numpy, comb))
    ).numpy()
    assert np.array_equal(got, plain) and np.array_equal(got, want)
    one = _run_e1(e1_harness, 1, [a[:, :1].copy() for a in acc],
                  [a[:, :1].copy() for a in comb], [], 0, [])
    assert one.tolist() == [bool(want[0])]


def _tiled(a: np.ndarray, width: int) -> np.ndarray:
    """``a``'s columns (or entries) repeated up to ``width``."""
    reps = -(-width // a.shape[-1])
    return np.ascontiguousarray(np.tile(a, (1, reps) if a.ndim == 2 else reps)[..., :width])


@pytest.mark.parametrize("width", [40, 1])
@pytest.mark.parametrize("mode", ["strict", "identity"])
def test_e1_group_schedule_matches_plain_at_ragged_widths(e1_harness, ed_case, mode, width):
    """E1's four roles a lane run in turn over slots poisoned before each
    block, at 40 lanes (16 a block: three blocks, the last ragged) and at
    one lane, every coordinate in negative weak limbs: the plain version's
    verdicts, accepted and refused lanes both at 40.  Strict: the case with
    R in D1's layout (row stride 2n), the masks on; identity: comb against
    -comb, comb, -comb + B and the 2-torsion point."""
    if mode == "strict":
        c = ed_case
        acc, comb = ([_weak(_tiled(a, width)) for a in c[k]] for k in ("acc", "comb"))
        r_own = [_weak(_tiled(a, width)) for a in _r_of(c)]
        r = [np.concatenate([a, a], axis=1) for a in r_own]
        masks = [_tiled(c[k], width) for k in ("host_ok", "r_ok", "a_ok")]
        got = _run_e1(e1_harness, 0, acc, comb, r, 2 * width, masks)
        want = scan_kernels.add_and_equal_reference(
            *(ted.Point(*map(torch.from_numpy, x)) for x in (acc, comb, r_own)),
            *(torch.from_numpy(m) for m in masks),
        ).numpy()
        assert np.array_equal(want, _tiled(c["model"], width))
    else:
        acc0, comb0, want0 = _identity_case()
        acc, comb = ([_weak(_tiled(a, width)) for a in x] for x in (acc0, comb0))
        got = _run_e1(e1_harness, 1, acc, comb, [], 0, [])
        want = scan_kernels.add_is_identity_reference(
            ted.Point(*map(torch.from_numpy, acc)), ted.Point(*map(torch.from_numpy, comb))
        ).numpy()
        assert np.array_equal(want, _tiled(want0, width))
    assert min(x.min() for x in (*acc, *comb)) < 0
    assert np.array_equal(got, want)
    assert want.any() and (width == 1 or not want.all())


# --- P1: the P-256 fixed-base comb ---------------------------------------------------


def _p1_digits() -> np.ndarray:
    """(32, 40) int32 digits: u = 0 (the identity), 1, N - 1, random scalars
    below N, then 255 in every window, digits 0 and 255 alternating both
    ways, random digits, random digits with window group 1 (windows 8-15)
    all 0 (an identity partial sum), and with groups 0 and 3 all 0."""
    rng = np.random.default_rng(47)
    scalars = [0, 1, N - 1] + [int.from_bytes(rng.bytes(32), "big") % N for _ in range(31)]
    d = np.stack([np.frombuffer(s.to_bytes(32, "little"), np.uint8) for s in scalars], axis=1)
    extra = np.zeros((32, 6), dtype=np.uint8)
    extra[:, 0] = 255
    extra[::2, 1], extra[1::2, 1] = 0, 255
    extra[::2, 2], extra[1::2, 2] = 255, 0
    extra[:, 3:] = rng.integers(0, 256, (32, 3))
    extra[8:16, 4] = 0
    extra[:8, 5] = extra[24:, 5] = 0
    return np.ascontiguousarray(np.concatenate([d, extra], axis=1).astype(np.int32))


@pytest.fixture(scope="module")
def p1_case():
    digits = _p1_digits()
    jax_pt = jax.jit(jp.fixed_base_mul_comb)(jnp.asarray(digits))
    return digits, [np.asarray(c) for c in jax_pt]


def test_p1_plain_matches_jax_limb_for_limb(p1_case):
    """The wrapper on a CPU tensor is the plain comb, JAX's
    ``fixed_base_mul_comb`` limb for limb, and launches nothing."""
    digits, jax_pt = p1_case
    before = KERNELS.stats("comb_p256").launches
    got = scan_kernels.fixed_base_mul_comb_p256(torch.from_numpy(digits))
    assert KERNELS.stats("comb_p256").launches == before
    for g, w in zip(got, jax_pt):
        assert np.array_equal(g.numpy(), w)


def test_p1_table_is_the_plain_tables_words():
    """Entry [j][d] of P1's table is the plain comb table's (x, y) and b x
    mod p in 8 little-endian 32-bit words each; [j][0] is (0, 1, 0), whose
    Z the kernel sets to 0; built once per device, the same bits as int32."""
    table = scan_kernels.comb_p256_np()
    xs, ys, zs = tp._comb_table_np()
    assert table.shape == (32, 256, 3, 8) and table.dtype == np.uint32

    def value(words) -> int:
        return sum(int(w) << (32 * i) for i, w in enumerate(words))

    for j, d in ((0, 0), (0, 1), (5, 200), (31, 255), (17, 0)):
        assert value(table[j, d, 0]) == tfp.limbs_to_int(xs[j, d])
        assert value(table[j, d, 1]) == tfp.limbs_to_int(ys[j, d])
        assert value(table[j, d, 2]) == tp.B * tfp.limbs_to_int(xs[j, d]) % PP
        assert tfp.limbs_to_int(zs[j, d]) == (d != 0)
    assert value(table[3, 0, 0]) == 0 and value(table[3, 0, 1]) == 1
    assert value(table[3, 0, 2]) == 0
    t_cpu = scan_kernels.comb_p256_table(torch.device("cpu"))
    assert t_cpu is scan_kernels.comb_p256_table(torch.device("cpu"))
    assert t_cpu.dtype == torch.int32 and np.array_equal(t_cpu.numpy().view(np.uint32), table)


_P256_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include "comb_p256.cu"
#include "verdict_p256.cu"
// P1's and P2's per-lane code on the host with each kernel's block schedule,
// over outputs poisoned first.  P1: blocks of LANES lanes, the lane of each
// warp at comb_warp_lane(block, thread), a lane past the batch skipped, each
// lane's W window groups run in turn (serial_warp), each group's G roles in
// turn (serial_group), over its block's slots, partial sums and digit
// stage, all poisoned before every block.  P2: blocks of VERDICT_LANES
// lanes, each block's staging loaded thread by thread (stage_thread), then
// the lane of each group at verdict_group_lane(block, thread), a group past
// the batch skipped, its G roles in turn (serial_group) over its slots; the
// staging and the slots poisoned before every block.
//   harness comb <n> <in: table, digits> <out: X, Y, Z>
//   harness verdict <n> <in: 10 x (32 x n) f32, has_r2, host_ok> <out: n bytes>
static bool read_all(FILE* f, void* p, size_t bytes) { return fread(p, 1, bytes, f) == bytes; }
int main(int argc, char** argv) {
  if (argc != 5) return 2;
  const long long n = atoll(argv[2]);
  FILE* in = fopen(argv[3], "rb");
  if (!in) return 3;
  long long blocks;
  std::vector<uint8_t> out;
  if (strcmp(argv[1], "comb") == 0) {
    std::vector<u32> table(COMB_WINDOWS * COMB_ENTRIES * ENTRY_WORDS);
    std::vector<int32_t> digits(32 * n);
    if (!read_all(in, table.data(), 4 * table.size()) ||
        !read_all(in, digits.data(), 4 * digits.size())) return 3;
    std::vector<float> o(3 * 32 * n, -7.0f);
    blocks = (n + LANES - 1) / LANES;
    for (long long b = 0; b < blocks; ++b) {
      static fe slots[LANES][W][SLOTS];
      static ge sums[LANES][W];
      static int32_t stages[LANES][COMB_WINDOWS];
      memset(slots, 0x5a, sizeof slots);
      memset(sums, 0x3c, sizeof sums);
      memset(stages, 0xa5, sizeof stages);
      for (int t = 0; t < THREADS; t += LANE_THREADS) {
        const long long lane = comb_warp_lane(b, t);
        if (lane >= n) continue;
        const int sub = t / LANE_THREADS;
        const serial_warp wp = {slots[sub], sums[sub]};
        comb_lane(wp, stages[sub], table.data(), digits.data(), &o[0], &o[32 * n], &o[64 * n],
                  n, lane);
      }
    }
    out.resize(4 * o.size());
    memcpy(out.data(), o.data(), out.size());
    printf("comb blocks %lld lanes %d groups %d roles %d\n", blocks, LANES, W, G);
  } else {
    std::vector<float> c(10 * 32 * n);
    std::vector<uint8_t> masks(2 * n);
    if (!read_all(in, c.data(), 4 * c.size()) || !read_all(in, masks.data(), masks.size()))
      return 3;
    out.assign(n, 0xa5);
    verdict_args v;
    for (int k = 0; k < PLANES; ++k) v.planes[k] = &c[k * 32 * n];
    v.has_r2 = &masks[0];
    v.host_ok = &masks[n];
    v.out = out.data();
    v.n = n;
    blocks = (n + VERDICT_LANES - 1) / VERDICT_LANES;
    for (long long b = 0; b < blocks; ++b) {
      static float stage[STAGE_FLOATS];
      static fe slots[VERDICT_LANES][VERDICT_SLOTS];
      memset(stage, 0x7f, sizeof stage);
      memset(slots, 0x5a, sizeof slots);
      for (int t = 0; t < VERDICT_THREADS; ++t) stage_thread(stage, v, b, t);
      for (int t = 0; t < VERDICT_THREADS; t += G) {
        const long long lane = verdict_group_lane(b, t);
        if (lane >= n) continue;
        verdict_group(serial_group{slots[t / G], 0, G}, stage, v, lane, t / G);
      }
    }
    printf("verdict blocks %lld lanes %d roles %d\n", blocks, VERDICT_LANES, G);
  }
  fclose(in);
  FILE* f = fopen(argv[4], "wb");
  if (!f || fwrite(out.data(), 1, out.size(), f) != out.size()) return 4;
  fclose(f);
  return 0;
}
"""


@pytest.fixture(scope="module")
def p256_harness(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("p1p2")
    return _host_build(tmp, _P256_HARNESS, "p256"), tmp


def _run_p256(harness, mode: str, n: int, payload: bytes) -> tuple[str, np.ndarray]:
    exe, tmp = harness
    (tmp / f"{mode}.in").write_bytes(payload)
    proc = subprocess.run(
        [str(exe), mode, str(n), str(tmp / f"{mode}.in"), str(tmp / f"{mode}.out")],
        check=True, capture_output=True, text=True, timeout=120,
    )
    return proc.stdout, np.fromfile(tmp / f"{mode}.out", dtype=np.uint8)


@pytest.mark.parametrize("width", [40, 1])
def test_p1_kernel_code_compiled_for_the_host_matches_plain(p256_harness, p1_case, width):
    """P1's per-lane code with its block schedule (4 lanes a block, each of 4
    window groups of 8 roles: 40 lanes are 10 blocks, and one lane a block
    of one) and at one lane: canonical limbs of the plain version's point,
    projectively (divergence 26: the window groups' sums and their joins
    land on another representative), Z = 0 exactly on the identity lanes,
    and the affine point [u]G in big integers.  The lanes include the
    identity (u = 0), 255 in every window and a window group of zero digits
    (an identity partial sum)."""
    digits = np.ascontiguousarray(p1_case[0][:, :width])
    stdout, raw = _run_p256(
        p256_harness, "comb", width, scan_kernels.comb_p256_np().tobytes() + digits.tobytes()
    )
    assert stdout.split() == ["comb", "blocks", str(-(-width // COMB_LANES)), "lanes",
                              str(COMB_LANES), "groups", "4", "roles", "8"]
    got = raw.view(np.float32).reshape(3, 32, width)
    assert got.min() >= 0 and got.max() <= 255
    plain = scan_kernels.fixed_base_mul_comb_p256_reference(torch.from_numpy(digits))
    err = chip_smoke.p256_projective_max_err("comb_p256",
                                             tp.Point(*map(torch.from_numpy, got)), plain)
    assert err == 0.0
    for lane in range(width):
        u = int.from_bytes(bytes(digits[:, lane].astype(np.uint8)), "little")
        x, y, z = (tfp.limbs_to_int(c[:, lane]) for c in got)
        assert max(x, y, z) < PP  # canonical
        xp, yp, zp = (tfp.limbs_to_int(tfp.freeze(c[:, lane : lane + 1])[:, 0]) for c in plain)
        assert (x * zp - xp * z) % PP == 0 and (y * zp - yp * z) % PP == 0
        ref = tmp._to_affine(tmp._base_mul(u)) if u else None
        if ref is None:
            assert z == 0 == zp and x == 0 and y != 0
        else:
            zi = pow(z, PP - 2, PP)
            assert (x * zi % PP, y * zi % PP) == ref
    if width > 1:
        assert (digits[8:16, 38] == 0).all() and digits[:, 38].any()
        assert not np.array_equal(got[2], tfp.freeze(plain.z).numpy()), (
            "the window groups' representative should differ from the plain chain's")


# --- P2: the P-256 verdict -----------------------------------------------------------


def _affine_of(point, lane):
    x, y, z = (tfp.limbs_to_int(tfp.freeze(torch.from_numpy(np.array(c[:, lane : lane + 1])))[:, 0])
               for c in point)
    if z == 0:
        return None
    zi = pow(z, PP - 2, PP)
    return x * zi % PP, y * zi % PP


def _p2_case():
    """P2's inputs for a small P-256 wave: lanes from real signatures (valid,
    forged s, the wrong key, the wrong message, a high-s twin, an off-curve
    key, r >= n) with acc = [u2]Q in big integers in a random projective
    representative and comb = [u1]G from the plain comb, then
    ``chip_smoke.P2_SYNTHETIC``'s six lanes over padded columns 8-13
    (x(R') in [n, p) with has_r2 set and cleared, Z = 0, an off-curve key,
    a host rejection, a valid lane), the rest zeros.  Returns the ten
    (32, 32) float32 limb arrays, has_r2, host_ok and the expected
    verdicts."""
    rng = np.random.default_rng(53)
    kinds = ["valid", "valid", "forged_s", "wrong_key", "wrong_message", "high_s", "off_curve",
             "r_ge_n"]
    msgs, sigs, keys = [], [], []
    for j, kind in enumerate(kinds):
        d = int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1
        msg = b"p2-%d" % j + rng.bytes(16)
        sig, key = tmp.ref_p256_sign(d, msg), tmp.ref_p256_public_key(d)
        r, s = sig[:32], int.from_bytes(sig[32:], "big")
        if kind == "forged_s":
            sig = r + ((s + 1) % N).to_bytes(32, "big")
        elif kind == "wrong_key":
            key = tmp.ref_p256_public_key(d + 1)
        elif kind == "wrong_message":
            msg = msg + b"!"
        elif kind == "high_s":
            sig = r + (N - s).to_bytes(32, "big")
        elif kind == "off_curve":
            y = int.from_bytes(key[33:], "big")
            key = key[:33] + ((y + 1) % PP).to_bytes(32, "big")
        elif kind == "r_ge_n":
            sig = (N + 1).to_bytes(32, "big") + sig[32:]
        msgs.append(msg)
        sigs.append(sig)
        keys.append(key)
    expected = [tmp.ref_p256_verify(k, s, m) for k, s, m in zip(keys, sigs, msgs)]
    engine = tmp.EcdsaP256BatchVerifier(device="cpu", pad_to=32)
    qx, qy, u1d, _, r1, r2, has_r2, host_ok = (
        np.array(a) for a in engine.host_layout(msgs, sigs, keys)
    )
    comb = scan_kernels.fixed_base_mul_comb_p256_reference(torch.from_numpy(u1d.astype(np.int32)))
    acc = [np.zeros((32, 32), np.float32) for _ in range(3)]
    for i in np.flatnonzero(host_ok):
        r = int.from_bytes(sigs[i][:32], "big")
        s = int.from_bytes(sigs[i][32:], "big")
        q = (int.from_bytes(keys[i][1:33], "big"), int.from_bytes(keys[i][33:], "big"), 1)
        pt = tmp._to_affine(tmp._jac_mul(r * pow(s, N - 2, N) % N, q))
        lam = int.from_bytes(rng.bytes(32), "big") % PP or 1
        xyz = (0, lam, 0) if pt is None else (pt[0] * lam, pt[1] * lam, lam)
        for c, v in zip(acc, xyz):
            c[:, i] = tfp.int_to_limbs(v % PP)
    # The padded columns' comb is [0]G, the identity, so R' is acc there.
    assert all(_affine_of(comb, lane) is None for lane in range(8, 32))
    expected += [False] * (32 - len(expected))
    expected[8:14] = chip_smoke.write_p256_synthetic_lanes(acc, qx, qy, r1, r2, has_r2, host_ok,
                                                           start=8)
    coords = [*acc, *(c.numpy() for c in comb), qx, qy, r1, r2]
    return [np.ascontiguousarray(c, dtype=np.float32) for c in coords], has_r2, host_ok, \
        np.array(expected)


@pytest.fixture(scope="module")
def p2_case():
    return _p2_case()


@jax.jit
def _jax_p256_tail_jit(ax, ay, az, cx, cy, cz, qx, qy, r1, r2, has_r2, host_ok):
    q_ok = jp.on_curve(qx, qy)
    acc = jp.add(jp.Point(ax, ay, az), jp.Point(cx, cy, cz))
    nonzero = ~jfp.is_zero(acc.z)
    match1 = jfp.eq(acc.x, jfp.mul(r1, acc.z))
    match2 = has_r2 & jfp.eq(acc.x, jfp.mul(r2, acc.z))
    return host_ok & q_ok & nonzero & (match1 | match2)


def _jax_p256_tail(coords, has_r2, host_ok) -> np.ndarray:
    """The JAX P-256 body's on-curve check and last lines
    (consensus_tpu/models/ecdsa_p256.py:120, :152-158), jitted."""
    return np.asarray(_jax_p256_tail_jit(*(jnp.asarray(c) for c in coords),
                                         jnp.asarray(has_r2), jnp.asarray(host_ok)))


def _verdict_p256_plain(coords, has_r2, host_ok) -> np.ndarray:
    t = [torch.from_numpy(c) for c in coords]
    return scan_kernels.verdict_p256(
        tp.Point(*t[:3]), tp.Point(*t[3:6]), *t[6:],
        torch.from_numpy(has_r2.astype(bool)), torch.from_numpy(host_ok.astype(bool)),
    ).numpy()


def test_p2_plain_matches_jax_and_the_classes(p2_case):
    """The wrapper on CPU tensors equals the JAX body's last lines and the
    construction on every class (the signed lanes against
    ``ref_p256_verify``), and launches nothing."""
    coords, has_r2, host_ok, expected = p2_case
    before = KERNELS.stats("verdict_p256").launches
    got = _verdict_p256_plain(coords, has_r2, host_ok)
    assert KERNELS.stats("verdict_p256").launches == before
    assert got.dtype == bool
    assert np.array_equal(got, _jax_p256_tail(coords, has_r2, host_ok))
    assert np.array_equal(got, expected)
    assert got[:2].all() and got[5] and got[8] and got[13]
    assert got.sum() == 5


def _p2_tiled(p2_case, width: int, offset: int = 0):
    """P2's case tiled to ``width`` lanes from lane ``offset``, every
    coordinate in negative weak limbs: (coords, masks, expected)."""
    coords, has_r2, host_ok, expected = p2_case
    reps = -(-(width + offset) // 32)
    tile = lambda a: np.ascontiguousarray(
        np.tile(a, (1, reps))[:, offset:offset + width] if a.ndim == 2
        else np.tile(a, reps)[offset:offset + width])
    weak = [_weak(tile(c)) for c in coords]
    return weak, [tile(has_r2).astype(np.uint8), tile(host_ok).astype(np.uint8)], tile(expected)


def _run_p2(p256_harness, weak, masks) -> np.ndarray:
    n = weak[0].shape[1]
    stdout, got = _run_p256(
        p256_harness, "verdict", n,
        b"".join(c.tobytes() for c in weak) + b"".join(m.tobytes() for m in masks),
    )
    assert stdout.split() == ["verdict", "blocks", str(-(-n // VERDICT_LANES)), "lanes",
                              str(VERDICT_LANES), "roles", "8"]
    assert set(got.tolist()) <= {0, 1}
    return got.astype(bool)


def test_p2_kernel_code_compiled_for_the_host_matches_plain(p256_harness, p2_case):
    """P2's per-lane code on the case tiled to 70 lanes (9 blocks of 8
    lanes, the last ragged) with every coordinate in negative weak limbs:
    the plain version's verdict on every lane."""
    weak, masks, expected = _p2_tiled(p2_case, 70)
    assert min(c.min() for c in weak) < 0
    got = _run_p2(p256_harness, weak, masks)
    want = _verdict_p256_plain(weak, *masks)
    assert np.array_equal(got, want)
    assert np.array_equal(want, expected)


@pytest.mark.parametrize("width,offset", [(1, 0), (1, 8), (5, 8), (8, 6), (37, 3)])
def test_p2_group_schedule_matches_plain_at_ragged_widths(p256_harness, p2_case, width, offset):
    """P2's group schedule at widths where a block of 8 lanes (groups of 8
    roles, the staging spread over the block's 64 threads) straddles the
    batch's end, one lane included, over the real and the synthetic lanes
    (has_r2, Z = 0, an off-curve key, a host rejection): the plain
    version's verdicts and the construction's."""
    weak, masks, expected = _p2_tiled(p2_case, width, offset)
    got = _run_p2(p256_harness, weak, masks)
    assert np.array_equal(got, _verdict_p256_plain(weak, *masks))
    assert np.array_equal(got, expected)


# --- routing, refusals, builds ---------------------------------------------------------


_WRAPPERS = ("decompress", "horner_scan", "fixed_base_mul_comb", "add_and_equal", "straus_msm",
             "add_is_identity", "horner_scan_p256", "fixed_base_mul_comb_p256", "verdict_p256")


def test_bodies_reach_the_eager_tail_only_through_the_wrappers(monkeypatch, ed_case, p2_case):
    """The strict, randomized and P-256 device bodies run on CPU tensors
    with the eager ``add``, ``equal``, ``is_identity``, comb and
    ``on_curve`` ops guarded: each may run only inside a kernel wrapper
    (which on a CUDA tensor launches its kernel instead), and each body
    calls its wrappers once: D1, B1, D2 and E1; D1, B3, D2 and E1; B2, P1
    and P2."""
    inside: list[str] = []
    calls: collections.Counter = collections.Counter()

    def guard(mod, name):
        orig = getattr(mod, name)

        def guarded(*a, **k):
            assert inside, f"{mod.__name__}.{name} ran outside a kernel wrapper"
            return orig(*a, **k)

        monkeypatch.setattr(mod, name, guarded)

    for name in ("add", "equal", "is_identity", "fixed_base_mul_comb"):
        guard(ted, name)
    for name in ("add", "fixed_base_mul_comb", "on_curve"):
        guard(tp, name)
    for name in _WRAPPERS:
        orig = getattr(scan_kernels, name)

        def wrapped(*a, _name=name, _orig=orig, **k):
            calls[_name] += 1
            inside.append(_name)
            try:
                return _orig(*a, **k)
            finally:
                inside.pop()

        monkeypatch.setattr(scan_kernels, name, wrapped)

    msgs, sigs, keys, _, expected = _ed_corpus()
    strict = tmed.Ed25519BatchVerifier(device="cpu")
    got = tmed.verify_impl(*strict.prepare_device_inputs(msgs[:4], sigs[:4], keys[:4]))
    assert got.numpy()[:4].tolist() == expected[:4].tolist()
    assert calls == {"decompress": 1, "horner_scan": 1, "fixed_base_mul_comb": 1,
                     "add_and_equal": 1}
    calls.clear()
    rand = tmed.Ed25519RandomizedBatchVerifier(device="cpu")
    valid = [i for i, ok in enumerate(expected) if ok][:2]
    _, scalars = rand._host_scalars(msgs, sigs, keys)
    zs = [int.from_bytes(np.random.default_rng(3).bytes(16), "little") | 1 for _ in valid]
    eq_ok, _ = tmed.batch_verify_impl(
        *rand._aggregate_device_inputs(valid, sigs, keys, scalars, zs))
    assert bool(eq_ok)
    assert calls == {"decompress": 1, "straus_msm": 1, "fixed_base_mul_comb": 1,
                     "add_is_identity": 1}
    calls.clear()
    p256_engine = tmp.EcdsaP256BatchVerifier(device="cpu")
    d = 12345
    m = b"routing"
    pm = [m, m + b"!"]
    ps = [tmp.ref_p256_sign(d, m)] * 2
    pk = [tmp.ref_p256_public_key(d)] * 2
    got = tmp.verify_impl(*p256_engine.prepare_device_inputs(pm, ps, pk))
    assert got.numpy()[:2].tolist() == [True, False]
    assert calls == {"horner_scan_p256": 1, "fixed_base_mul_comb_p256": 1, "verdict_p256": 1}


def test_wrappers_refuse_what_the_kernels_do_not_take(ed_case, p2_case):
    c = ed_case
    pt = ted.Point(*(torch.from_numpy(np.ascontiguousarray(a)) for a in c["acc"]))
    r = ted.Point(*(torch.from_numpy(a) for a in _r_of(c)))
    masks = [torch.from_numpy(c[k]) for k in ("host_ok", "r_ok", "a_ok")]
    with pytest.raises(TypeError, match="float32"):
        scan_kernels.add_and_equal(ted.Point(*(x.double() for x in pt)), pt, r, *masks)
    with pytest.raises(TypeError, match="bool"):
        scan_kernels.add_and_equal(pt, pt, r, masks[0].to(torch.uint8), *masks[1:])
    with pytest.raises(ValueError, match=r"must be \(16,\)"):
        scan_kernels.add_and_equal(pt, pt, r, masks[0][:8], *masks[1:])
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros((32, 32), dtype=torch.float32)[:, ::2]
        scan_kernels.add_is_identity(ted.Point(wide, *pt[1:]), pt)
    with pytest.raises(ValueError, match="one device"):
        scan_kernels.add_is_identity(ted.Point(pt.x.to("meta"), *pt[1:]), pt)
    with pytest.raises(TypeError, match="int32"):
        scan_kernels.fixed_base_mul_comb_p256(torch.zeros((32, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match=r"must be \(32, 4\)"):
        scan_kernels.fixed_base_mul_comb_p256(torch.zeros((31, 4), dtype=torch.int32))
    coords, has_r2, host_ok, _ = p2_case
    t = [torch.from_numpy(x) for x in coords]
    with pytest.raises(ValueError, match=r"\(32, batch\)"):
        scan_kernels.verdict_p256(tp.Point(*t[:3]), tp.Point(*t[3:6]), t[6][:31].contiguous(),
                                  *t[7:], torch.from_numpy(has_r2), torch.from_numpy(host_ok))
    with pytest.raises(TypeError, match="bool"):
        scan_kernels.verdict_p256(tp.Point(*t[:3]), tp.Point(*t[3:6]), *t[6:],
                                  torch.from_numpy(has_r2).int(), torch.from_numpy(host_ok))
    # Neither a CPU nor a CUDA tensor: refused, never run by the plain version.
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="unsupported device"):
        scan_kernels.verdict_p256(tp.Point(*meta[:3]), tp.Point(*meta[3:6]), *meta[6:],
                                  torch.from_numpy(has_r2).to("meta"),
                                  torch.from_numpy(host_ok).to("meta"))


@pytest.mark.parametrize("name", ["verdict25519", "comb_p256", "verdict_p256", "scalar25519"])
def test_build_without_nvcc_raises(monkeypatch, tmp_path, name):
    """A missing compiler is an error, never a silent fallback to the plain
    version."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(scan_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(scan_kernels, "_LIBRARIES", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        scan_kernels.build(name)
    assert name in scan_kernels.KERNELS


# --- chip_smoke.py phase 24 rehearsed on the CPU --------------------------------


def _bigint_p256_scan(monkeypatch):
    """``horner_scan_p256`` computed with Python integers: [u2]Q per lane
    from the digits' signed values, as affine (x : y : 1) limbs, (0 : 1 : 0)
    for the identity.  The plain scan is about a million eager calls at a
    rehearsal's width; P2 reads only the point."""

    def scan(qx, qy, digits):
        cols = []
        for i in range(digits.shape[1]):
            u = 0
            for d in digits[:, i].tolist():
                u = 16 * u + (d - 8)
            q = (tfp.limbs_to_int(qx[:, i]) % PP, tfp.limbs_to_int(qy[:, i]) % PP, 1)
            cols.append(tmp._to_affine(tmp._jac_mul(u % N, q)) if u % N else None)
        xyz = [[0, 1, 0] if c is None else [c[0], c[1], 1] for c in cols]
        return tp.Point(*(torch.from_numpy(np.stack([tfp.int_to_limbs(v[k]) for v in xyz],
                                                    axis=1)) for k in range(3)))

    monkeypatch.setattr(scan_kernels, "horner_scan_p256", scan)


def test_chip_smoke_verdict_phase_rehearses_on_cpu(monkeypatch):
    """Phase 24 at a tiny size on the CPU, where every wrapper runs its plain
    version (the P-256 scan and the MSM stood in for by big-integer
    versions): E1 on a 24-request strict wave and at one lane (the
    randomized wave's first aggregate refused, comb + (-comb) accepted), P1
    on a 26-request P-256 wave's digits and on one lane, P2 with the six
    synthetic lanes over the wave's padded columns; no kernel launches."""
    from test_torch_smoke_fused import _bigint_msm

    _bigint_msm(monkeypatch)
    _bigint_p256_scan(monkeypatch)
    corpus = chip_smoke.make_corpus(24, per_class=1)
    rand = chip_smoke.make_corpus(24, per_class=1, classes=chip_smoke.RANDOMIZED_CLASSES)
    p256_corpus = chip_smoke.make_p256_corpus(26, per_class=1)
    names = ("verdict25519", "comb_p256", "verdict_p256")
    before = [KERNELS.stats(n).launches for n in names]
    r = chip_smoke.phase_verdict_kernels(torch.device("cpu"), corpus, rand, p256_corpus, reps=1,
                                         plain_reps=1, replicas=1, p256_replicas=1)
    assert [KERNELS.stats(n).launches for n in names] == before
    assert (r["e1"]["lanes"], r["e1"]["signatures"]) == (32, 24)
    assert 0 < r["e1"]["accepted"] <= r["e1"]["compared"] < 24
    e1 = r["e1"]
    assert e1["accepted"] <= e1["x_matched"] <= e1["compared"] <= e1["host_r_ok"] <= e1["host_ok"]
    assert r["e1_identity"]["cases"] == ["aggregate", "identity", "double"]
    assert (r["p1"]["lanes"], r["p1_one"]["lanes"]) == (32, 1)
    assert (r["p2"]["lanes"], r["p2"]["signatures"], r["p2"]["has_r2_lanes"]) == (32, 26, 1)
    assert r["p2"]["synthetic"] == [kind for kind, _ in chip_smoke.P2_SYNTHETIC]
    for key in ("e1", "e1_identity", "p1", "p1_one", "p2"):
        assert r[key]["max_abs_err"] == 0.0 and r[key]["ms"] > 0 and r[key]["plain_ms"] > 0


def test_verdict_bounds_count_the_work():
    """The bounds of phase 24 count what the kernels read on the data: E1's
    products (the add on every lane, X's comparison on lanes whose masks
    pass, Y's where X matches) and bytes (acc, comb, host_ok and the verdict
    on every lane, r_ok and a_ok behind the masks before them, R on the
    compared lanes; acc, comb and the verdict in the identity mode), P1's
    products and the distinct table entries its digits pick, P2's (r2 and
    its product only on has_r2 lanes)."""
    b = chip_smoke.e1_bound(8192, "strict", 132, 1.98e9, host_ok=7000, host_r_ok=6900,
                            compared=6825, x_matched=6720)
    assert b["products"] == (9 * 8192 + 2 * 6825 + 2 * 6720) * 72
    assert b["bytes"] == 8192 * 1026 + 7000 + 6900 + 6825 * 384
    assert b["bound_by"] == "bytes"
    b = chip_smoke.e1_bound(1, "identity", 132, 1.98e9)
    assert (b["products"], b["bytes"]) == (9 * 72, 1025)
    digits = torch.zeros((32, 4), dtype=torch.int32)
    digits[:, 1] = 255
    b = chip_smoke.p1_bound(digits, 132, 1.98e9)
    assert b["entries"] == 64 and b["products"] == 448 * 64 * 4
    assert b["bytes"] == 4 * 128 + 64 * 64 + 4 * 384
    b = chip_smoke.p2_bound(2048, 1, 132, 1.98e9)
    assert b["products"] == (16 * 64 + 2 * 36) * 2048 + 64
    assert b["bytes"] == 1155 * 2048 + 128 and b["bound_by"] == "bytes"


def test_trials_script_names_its_designs_and_refuses_without_a_card(tmp_path):
    """``scripts/e1_p1_trials.py`` builds csrc's E1, P1, P2, L1 and M1 (with
    ``--kernel``, only the named kernels') and every ``<kernel>_<design>.cu``
    named on its command line (the kept designs beside it among them),
    refuses any other name, and exits 1 where no card is present."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "e1_p1_trials", scan_kernels._CSRC.parent.parent / "scripts" / "e1_p1_trials.py")
    trials = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trials)
    alt = tmp_path / "comb_p256_general.cu"
    first = tmp_path / "verdict_p256_first.cu"
    kept = sorted((scan_kernels._CSRC.parent.parent / "scripts" / "e1_p1_trials").glob("*.cu"))
    got = trials.designs([alt, first])
    assert got == {("verdict25519", "csrc"): scan_kernels._CSRC / "verdict25519.cu",
                   ("comb_p256", "csrc"): scan_kernels._CSRC / "comb_p256.cu",
                   ("verdict_p256", "csrc"): scan_kernels._CSRC / "verdict_p256.cu",
                   ("scalar25519", "csrc"): scan_kernels._CSRC / "scalar25519.cu",
                   ("mxu_limbs", "csrc"): scan_kernels._CSRC / "mxu_limbs.cu",
                   ("comb_p256", "general"): alt.resolve(),
                   ("verdict_p256", "first"): first.resolve()}
    assert {d for d in trials.designs(kept) if d[1] != "csrc"} == {
        ("comb_p256", "general"), ("scalar25519", "first"), ("scalar25519", "group8"),
        ("verdict_p256", "first"), ("mxu_limbs", "first"), ("mxu_limbs", "wg1")}
    m1 = [p for p in kept if p.stem.startswith("mxu_limbs_")]
    assert set(trials.designs(m1, ["mxu_limbs"])) == {
        ("mxu_limbs", "csrc"), ("mxu_limbs", "first"), ("mxu_limbs", "wg1")}
    with pytest.raises(SystemExit, match="not <kernel>_<design>.cu"):
        trials.designs([tmp_path / "sha512_x.cu"])
    if not torch.cuda.is_available():
        assert trials.main([]) == 1
