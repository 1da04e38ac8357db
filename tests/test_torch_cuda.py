"""Card-only tests of the port's hand-written CUDA kernels.

Every test here carries the ``cuda`` marker and asks for a card through the
``cuda_device`` fixture, which skips with the reason where none is present.
The file imports neither JAX nor the JAX package (the machine with the card
has no JAX), so it runs there on its own:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import weaken
from consensus_tpu_torch.config import Configuration
from consensus_tpu_torch.models import ecdsa_p256 as mp
from consensus_tpu_torch.models import ed25519 as med
from consensus_tpu_torch.models.verifier import engine_for_config
from consensus_tpu_torch.ops import ed25519 as ed
from consensus_tpu_torch.ops import field25519 as fe
from consensus_tpu_torch.ops import field_p256 as fp
from consensus_tpu_torch.ops import p256
from consensus_tpu_torch.ops import scan_kernels

P = fe.P


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernel runs only on the card")
    return torch.device("cuda")


def _scan_case(n: int, device):
    """(-A) for A = j*B in weak limbs with negative entries, and digits of
    scalars 0, 1 and random ones below L."""
    pts, cur = [], (ed._BX, ed._BY)
    for _ in range(n):
        pts.append(cur)
        cur = ed._edwards_add_int(cur, (ed._BX, ed._BY))
    coords = [
        torch.from_numpy(np.stack([fe.int_to_limbs(c) for c in col], axis=1)).to(device)
        for col in (
            [x for x, _ in pts], [y for _, y in pts], [1] * n, [x * y % P for x, y in pts]
        )
    ]
    neg = [weaken(c).contiguous() for c in ed.negate(ed.Point(*coords))]
    rng = np.random.default_rng(n)
    scalars = [0, 1] + [int.from_bytes(rng.bytes(32), "little") % med.L for _ in range(n - 2)]
    rows = np.frombuffer(
        b"".join(s.to_bytes(32, "little") for s in scalars), dtype=np.uint8
    ).reshape(n, 32)
    digits = med._bits_to_signed_window_digits(med._bytes_rows_to_bits(rows))
    return neg, torch.from_numpy(digits.astype(np.int32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 256])
def test_kernel_matches_reference_on_card(cuda_device, n):
    """Frozen X, Y, Z, T of the kernel equal the plain version's on every
    lane (tolerance 0), at a batch that does and one that does not fill the
    last block; the kernel writes canonical limbs; one launch per call."""
    neg, digits = _scan_case(n, cuda_device)
    assert min(float(c.min()) for c in neg) < 0  # weak limbs reach the kernel
    before = scan_kernels.launches
    got = scan_kernels.horner_scan(*neg, digits)
    torch.cuda.synchronize()
    assert scan_kernels.launches == before + 1
    want = scan_kernels.horner_scan_reference(*neg, digits)
    for g, w in zip(got, want):
        assert torch.equal(fe.freeze(g), fe.freeze(w))
        assert torch.equal(g, fe.freeze(g).to(torch.float32))


@pytest.mark.cuda
def test_kernel_rejects_mixed_devices(cuda_device):
    neg, digits = _scan_case(8, cuda_device)
    with pytest.raises(ValueError):
        scan_kernels.horner_scan(*neg, digits.cpu())


@pytest.mark.cuda
def test_engine_on_card_matches_host_and_launches_once(cuda_device):
    rng = np.random.default_rng(3)
    seeds = [rng.bytes(32) for _ in range(8)]
    keys = [med.ref_public_key(s) for s in seeds]
    msgs = [b"m-%d" % i for i in range(8)]
    sigs = [med.ref_sign(s, m) for s, m in zip(seeds, msgs)]
    sigs[0] = (P + 1).to_bytes(32, "little") + sigs[0][32:]    # R with y >= p
    keys[1] = (2).to_bytes(32, "little")                       # off-curve A
    sigs[2] = sigs[2][:32] + med.L.to_bytes(32, "little")      # S = L
    msgs[3] = b"x" + msgs[3]                                   # wrong message
    engine = engine_for_config(Configuration(crypto_tpu_min_batch=1))
    assert engine.device.type == "cuda"
    before = scan_kernels.launches
    got = engine.verify_batch(msgs, sigs, keys)
    assert scan_kernels.launches == before + 1
    np.testing.assert_array_equal(got, engine.verify_host(msgs, sigs, keys))
    assert got.tolist() == [False] * 4 + [True] * 4


def _p256_scan_case(n: int, device):
    """Q = jG in weak limbs with negative entries, with every 5th lane off
    the curve and every 7th a padded lane (zero coordinates, all-zero
    digits); digits of scalars 0, 1 and random ones below n."""
    pts, cur = [], (p256.GX, p256.GY)
    for _ in range(n):
        pts.append(cur)
        cur = p256._add_int(cur, (p256.GX, p256.GY))
    xs = [5 if i % 5 == 4 else (0 if i % 7 == 6 else x) for i, (x, _) in enumerate(pts)]
    ys = [0 if i % 7 == 6 else y for i, (_, y) in enumerate(pts)]
    qx, qy = (
        weaken(torch.from_numpy(np.stack([fp.int_to_limbs(v) for v in col], axis=1)))
        .contiguous().to(device)
        for col in (xs, ys)
    )
    rng = np.random.default_rng(n)
    scalars = [0, 1] + [int.from_bytes(rng.bytes(32), "big") % p256.N for _ in range(n - 2)]
    digits = mp._scalars_to_signed_window_digits(scalars).astype(np.int32)
    digits[:, 6::7] = 0
    return qx, qy, torch.from_numpy(digits).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 256])
def test_p256_kernel_matches_reference_on_card(cuda_device, n):
    """Frozen X, Y, Z of kernel B2 equal the plain version's on every lane
    (tolerance 0), off-curve and zero-digit lanes included; the kernel
    writes canonical limbs; one launch per call."""
    qx, qy, digits = _p256_scan_case(n, cuda_device)
    assert min(float(qx.min()), float(qy.min())) < 0  # weak limbs reach the kernel
    before = scan_kernels.launches_p256
    got = scan_kernels.horner_scan_p256(qx, qy, digits)
    torch.cuda.synchronize()
    assert scan_kernels.launches_p256 == before + 1
    want = scan_kernels.horner_scan_p256_reference(qx, qy, digits)
    for g, w in zip(got, want):
        assert torch.equal(fp.freeze(g), fp.freeze(w))
        assert torch.equal(g, fp.freeze(g).to(torch.float32))


@pytest.mark.cuda
def test_p256_kernel_rejects_mixed_devices(cuda_device):
    qx, qy, digits = _p256_scan_case(8, cuda_device)
    with pytest.raises(ValueError):
        scan_kernels.horner_scan_p256(qx, qy, digits.cpu())


@pytest.mark.cuda
def test_p256_engine_on_card_matches_reference_and_launches_once(cuda_device):
    rng = np.random.default_rng(5)
    privs = [int.from_bytes(rng.bytes(32), "big") % (mp.N - 1) + 1 for _ in range(8)]
    keys = [mp.ref_p256_public_key(d) for d in privs]
    msgs = [b"m-%d" % i for i in range(8)]
    sigs = [mp.ref_p256_sign(d, m) for d, m in zip(privs, msgs)]
    sigs[0] = sigs[0][:32] + mp.N.to_bytes(32, "big")                    # s = n
    keys[1] = b"\x04" + keys[1][1:33] + bytes(32)                         # off the curve
    msgs[2] = b"x" + msgs[2]                                              # wrong message
    s3 = int.from_bytes(sigs[3][32:], "big")
    sigs[3] = sigs[3][:32] + (mp.N - s3).to_bytes(32, "big")              # high s: accepted
    engine = engine_for_config(Configuration(crypto_tpu_min_batch=1), curve="p256")
    assert engine.device.type == "cuda"
    before = (scan_kernels.launches, scan_kernels.launches_p256)
    got = engine.verify_batch(msgs, sigs, keys)
    assert (scan_kernels.launches, scan_kernels.launches_p256) == (before[0], before[1] + 1)
    want = [mp.ref_p256_verify(k, s, m) for m, s, k in zip(msgs, sigs, keys)]
    assert got.tolist() == want == [False] * 3 + [True] * 5


def _msm_case(n: int, device):
    """-A and -R for A = jB, R = (j + 50)B in weak limbs with negative
    entries, digits of random zk < L and z < 2^128; every 5th lane is masked
    (all digits 8, zero coordinates, as a padded lane) and every 7th has all
    digits 0 (d = -8 in every window)."""
    pts, cur = [], (ed._BX, ed._BY)
    for _ in range(n + 50):
        pts.append(cur)
        cur = ed._edwards_add_int(cur, (ed._BX, ed._BY))

    def neg(points):
        cols = ([x for x, _ in points], [y for _, y in points], [1] * n,
                [x * y % P for x, y in points])
        coords = [torch.from_numpy(np.stack([fe.int_to_limbs(v) for v in c], axis=1)) for c in cols]
        out = [weaken(c) for c in ed.negate(ed.Point(*coords))]
        for c in out:
            c[:, 4::5] = 0
        return ed.Point(*(c.contiguous().to(device) for c in out))

    rng = np.random.default_rng(n)
    zk = [int.from_bytes(rng.bytes(32), "little") % med.L for _ in range(n)]
    zs = [int.from_bytes(rng.bytes(16), "little") or 1 for _ in range(n)]
    zk_digits = med._signed_digits_rows(zk, 64).astype(np.int32)
    z_digits = med._signed_digits_rows(zs, 33).astype(np.int32)
    for d in (zk_digits, z_digits):
        d[:, 6::7] = 0
        d[:, 4::5] = 8  # a masked lane stays masked
    return (neg(pts[:n]), neg(pts[50:]), torch.from_numpy(zk_digits).to(device),
            torch.from_numpy(z_digits).to(device))


def _affine(p: ed.Point):
    zinv = fe.invert(p.z)
    return fe.freeze(fe.mul(p.x, zinv)), fe.freeze(fe.mul(p.y, zinv))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 256])
def test_msm_kernel_matches_reference_on_card(cuda_device, n):
    """Kernel B3's point equals the plain version's in affine coordinates
    (tolerance 0; the projective representatives differ by design), with
    masked and zero-digit lanes, at a batch that does and one that does not
    fill its last block; canonical limbs out; one launch per call."""
    inputs = _msm_case(n, cuda_device)
    assert min(float(c.min()) for c in inputs[0]) < 0  # weak limbs reach the kernel
    before = scan_kernels.launches_msm
    got = scan_kernels.straus_msm(*inputs)
    torch.cuda.synchronize()
    assert scan_kernels.launches_msm == before + 1
    want = scan_kernels.straus_msm_reference(*inputs)
    assert got.x.shape == (32, 1)
    for g, w in zip(_affine(got), _affine(want)):
        assert torch.equal(g, w)
    for g in got:
        assert torch.equal(g, fe.freeze(g).to(torch.float32))
    assert not bool(ed.is_identity(got).all())


@pytest.mark.cuda
def test_msm_kernel_rejects_mixed_devices(cuda_device):
    neg_a, neg_r, zk, z = _msm_case(8, cuda_device)
    with pytest.raises(ValueError):
        scan_kernels.straus_msm(neg_a, neg_r, zk, z.cpu())


@pytest.mark.cuda
def test_randomized_engine_on_card_matches_strict_and_launches_once(cuda_device):
    rng = np.random.default_rng(11)
    seeds = [rng.bytes(32) for _ in range(8)]
    keys = [med.ref_public_key(s) for s in seeds] * 8
    msgs = [b"honest-%d" % i for i in range(64)]
    sigs = [med.ref_sign(seeds[i % 8], m) for i, m in enumerate(msgs)]
    engine = engine_for_config(Configuration(batch_verify_mode=True))
    assert engine.randomized and engine.device.type == "cuda"
    before = (scan_kernels.launches, scan_kernels.launches_msm)
    got = engine.verify_batch(msgs, sigs, keys)
    assert (scan_kernels.launches, scan_kernels.launches_msm) == (before[0], before[1] + 1)
    strict = engine_for_config(Configuration()).verify_batch(msgs, sigs, keys)
    assert got.all() and np.array_equal(got, strict)
