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
from consensus_tpu_torch.models.verifier import Ed25519Signer, engine_for_config
from consensus_tpu_torch.obs.kernels import KERNELS
from consensus_tpu_torch.ops import ed25519 as ed
from consensus_tpu_torch.ops import field25519 as fe
from consensus_tpu_torch.ops import field_p256 as fp
from consensus_tpu_torch.ops import p256
from consensus_tpu_torch.ops import scan_kernels
from consensus_tpu_torch.testing import ClientKeyring, Cluster, SigOnlyVerifier, SignedRequestApp

P = fe.P


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernel runs only on the card")
    return torch.device("cuda")


def _scan_case(n: int, device):
    """(-A) for A = j*B in weak limbs with negative entries, and digits of
    scalars 0, 1 (from n = 3 on) and random ones below L."""
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
    fixed = [0, 1] if n > 2 else []
    scalars = fixed + [int.from_bytes(rng.bytes(32), "little") % med.L for _ in range(n - len(fixed))]
    rows = np.frombuffer(
        b"".join(s.to_bytes(32, "little") for s in scalars), dtype=np.uint8
    ).reshape(n, 32)
    digits = med._bits_to_signed_window_digits(med._bytes_rows_to_bits(rows))
    return neg, torch.from_numpy(digits.astype(np.int32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 256, 8192 + 37])
def test_kernel_matches_reference_on_card(cuda_device, n):
    """Frozen X, Y, Z, T of the kernel equal the plain version's on every
    lane (tolerance 0): one lane (a block of one group), widths that do not
    fill the last 16-signature block (37, and 8,192 + 37 past the main
    path's 512 blocks) and one that fills 16 blocks; the kernel writes
    canonical limbs; one launch per call."""
    neg, digits = _scan_case(n, cuda_device)
    assert min(float(c.min()) for c in neg) < 0  # weak limbs reach the kernel
    before = KERNELS.stats("horner_scan").launches
    got = scan_kernels.horner_scan(*neg, digits)
    torch.cuda.synchronize()
    assert KERNELS.stats("horner_scan").launches == before + 1
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
    before = KERNELS.stats("horner_scan").launches
    got = engine.verify_batch(msgs, sigs, keys)
    assert KERNELS.stats("horner_scan").launches == before + 1
    np.testing.assert_array_equal(got, engine.verify_host(msgs, sigs, keys))
    assert got.tolist() == [False] * 4 + [True] * 4


def _p256_scan_case(n: int, device):
    """Q = jG in weak limbs with negative entries, with every 5th lane off
    the curve and every 7th a padded lane (zero coordinates, all-zero
    digits); digits of scalars 0, 1 (from n = 3 on) and random ones below n."""
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
    fixed = [0, 1] if n > 2 else []
    scalars = fixed + [int.from_bytes(rng.bytes(32), "big") % p256.N for _ in range(n - len(fixed))]
    digits = mp._scalars_to_signed_window_digits(scalars).astype(np.int32)
    digits[:, 6::7] = 0
    return qx, qy, torch.from_numpy(digits).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 256, 2048 + 37])
def test_p256_kernel_matches_reference_on_card(cuda_device, n):
    """Frozen X, Y, Z of kernel B2 equal the plain version's on every lane
    (tolerance 0), off-curve and zero-digit lanes included; the kernel
    writes canonical limbs; one launch per call.  B2 runs a group of 8
    threads per signature, 16 signatures a 128-thread block: n = 1 is one
    group in a block of 16, 37 three blocks with the last ragged, 256
    sixteen full blocks, 2,048 + 37 the 128 blocks of the P-256 wave and
    three more, the last holding 5 signatures."""
    qx, qy, digits = _p256_scan_case(n, cuda_device)
    assert min(float(qx.min()), float(qy.min())) < 0  # weak limbs reach the kernel
    before = KERNELS.stats("horner_scan_p256").launches
    got = scan_kernels.horner_scan_p256(qx, qy, digits)
    torch.cuda.synchronize()
    assert KERNELS.stats("horner_scan_p256").launches == before + 1
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
    before = (KERNELS.stats("horner_scan").launches, KERNELS.stats("horner_scan_p256").launches)
    got = engine.verify_batch(msgs, sigs, keys)
    assert (KERNELS.stats("horner_scan").launches, KERNELS.stats("horner_scan_p256").launches) == (before[0], before[1] + 1)
    want = [mp.ref_p256_verify(k, s, m) for m, s, k in zip(msgs, sigs, keys)]
    assert got.tolist() == want == [False] * 3 + [True] * 5


def _msm_case(n: int, device, n_low: int = 33):
    """-A and -R for A = jB, R = (j + 50)B in weak limbs with negative
    entries, digits of random zk < L and of z over ``n_low`` windows (z <
    2^128 for the engine's 33, z < L for 64, no z digits for 0); every 5th
    lane is masked (all digits 8, zero coordinates, as a padded lane) and
    every 7th has all digits 0 (d = -8 in every window)."""
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
    z_bytes = 16 if n_low == 33 else 32
    zs = [int.from_bytes(rng.bytes(z_bytes), "little") % med.L or 1 for _ in range(n)]
    zk_digits = med._signed_digits_rows(zk, 64).astype(np.int32)
    z_digits = (med._signed_digits_rows(zs, n_low) if n_low else np.zeros((0, n))).astype(np.int32)
    for d in (zk_digits, z_digits):
        d[:, 6::7] = 0
        d[:, 4::5] = 8  # a masked lane stays masked
    return (neg(pts[:n]), neg(pts[50:]), torch.from_numpy(zk_digits).to(device),
            torch.from_numpy(z_digits).to(device))


def _affine(p: ed.Point):
    zinv = fe.invert(p.z)
    return fe.freeze(fe.mul(p.x, zinv)), fe.freeze(fe.mul(p.y, zinv))


@pytest.mark.cuda
@pytest.mark.parametrize("n_low", [0, 33, 64])
@pytest.mark.parametrize("n", [37, 256, 2 * 2048 + 37])
def test_msm_kernel_matches_reference_on_card(cuda_device, n, n_low):
    """Kernel B3's point equals the plain version's in affine coordinates
    (tolerance 0; the projective representatives differ by design), with
    masked and zero-digit lanes, with no R table (n_low 0), the engine's 33
    R windows and R in every window; canonical limbs out; one count per
    call.  The window sums run 256 threads per block over chunks of 2,048
    lanes (8 per thread): at 37 lanes some threads hold one lane and the
    rest none; at 256 (the catch-up chunk's width) each holds one; at
    2 x 2,048 + 37 two full chunks, whose threads walk 8 lanes each, are
    followed by a ragged one, and the join folds 3 chunk partials per
    window."""
    inputs = _msm_case(n, cuda_device, n_low)
    assert min(float(c.min()) for c in inputs[0]) < 0  # weak limbs reach the kernel
    before = KERNELS.stats("straus_msm").launches
    got = scan_kernels.straus_msm(*inputs)
    torch.cuda.synchronize()
    assert KERNELS.stats("straus_msm").launches == before + 1
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
    before = (KERNELS.stats("horner_scan").launches, KERNELS.stats("straus_msm").launches)
    got = engine.verify_batch(msgs, sigs, keys)
    assert (KERNELS.stats("horner_scan").launches, KERNELS.stats("straus_msm").launches) == (before[0], before[1] + 1)
    strict = engine_for_config(Configuration()).verify_batch(msgs, sigs, keys)
    assert got.all() and np.array_equal(got, strict)


# --- the engine layer on the card ----------------------------------------------


def _signed_corpus(n: int, seed: int):
    """``n`` requests over 8 keys, every 9th tampered (S + 1)."""
    rng = np.random.default_rng(seed)
    seeds = [rng.bytes(32) for _ in range(8)]
    keys = [med.ref_public_key(seeds[i % 8]) for i in range(n)]
    msgs = [b"request-%d" % i for i in range(n)]
    sigs = [med.ref_sign(seeds[i % 8], m) for i, m in enumerate(msgs)]
    for i in range(0, n, 9):
        sigs[i] = sigs[i][:32] + bytes([sigs[i][32] ^ 1]) + sigs[i][33:]
    return msgs, sigs, keys


@pytest.mark.cuda
def test_seven_replica_threads_through_a_coalescer_launch_once_per_flush(cuda_device):
    """7 replica threads x 36 requests (252 on 256 lanes) through one
    coalescer over the strict engine: B1's launches equal the device
    flushes, no flush is served from the host, and every replica's verdicts
    equal the CPU plain path's."""
    import threading

    from consensus_tpu_torch.models.engine import ThreadCoalescingVerifier

    msgs, sigs, keys = _signed_corpus(36, 5)
    engine = engine_for_config(Configuration(), device=cuda_device)
    flushes, host_calls = [], []

    class _Counted:
        def verify_batch(self, m, s, k):
            flushes.append(len(m))
            return engine.verify_batch(m, s, k)

        def verify_host(self, m, s, k):
            host_calls.append(len(m))
            return engine.verify_host(m, s, k)

    coalescer = ThreadCoalescingVerifier(
        _Counted(), window=0.05, max_batch=7 * 36, hard_cap=256, bypass_below=16
    )
    barrier = threading.Barrier(7)
    got = {}

    def replica(r):
        barrier.wait()
        got[r] = coalescer.verify_batch(msgs, sigs, keys)

    before = KERNELS.stats("horner_scan").launches
    threads = [threading.Thread(target=replica, args=(r,)) for r in range(7)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    coalescer.close()
    assert not any(t.is_alive() for t in threads)
    assert KERNELS.stats("horner_scan").launches - before == len(flushes) < 7
    assert sum(flushes) == 7 * 36 and not host_calls and not coalescer.device_suspect
    want = engine_for_config(Configuration(), device="cpu").verify_batch(msgs, sigs, keys)
    assert want.tolist() == [i % 9 != 0 for i in range(36)]
    for r in range(7):
        assert got[r].tolist() == want.tolist()


@pytest.mark.cuda
def test_concurrent_first_launches_build_the_kernel_once(cuda_device, monkeypatch, tmp_path):
    """Two threads launch B1 for the first time together in an empty build
    directory: one nvcc build, one library, both results right."""
    import threading

    from consensus_tpu_torch.obs.kernels import COMPILE_CACHE

    monkeypatch.setattr(scan_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(scan_kernels, "_LIBRARIES", {})
    neg, digits = _scan_case(37, cuda_device)
    misses = COMPILE_CACHE.snapshot()["misses"]
    barrier = threading.Barrier(2)
    got, errors = [], []

    def launch():
        try:
            barrier.wait()
            out = scan_kernels.horner_scan(*neg, digits)
            torch.cuda.synchronize()
            got.append(out)
        except Exception as exc:
            errors.append(exc)

    threads = [threading.Thread(target=launch) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600.0)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert COMPILE_CACHE.snapshot()["misses"] == misses + 1
    assert len(list((tmp_path / "build").glob("horner_scan-*.so"))) == 1
    assert not list((tmp_path / "build").glob(".*"))  # no temporary left behind
    want = scan_kernels.horner_scan_reference(*neg, digits)
    for out in got:
        for g, w in zip(out, want):
            assert torch.equal(fe.freeze(g), fe.freeze(w))


@pytest.mark.cuda
def test_supervised_engine_cross_checks_clean_on_card(cuda_device):
    from consensus_tpu_torch.metrics import InMemoryProvider, Metrics
    from consensus_tpu_torch.models.supervisor import EngineSupervisor

    msgs, sigs, keys = _signed_corpus(40, 9)
    provider = InMemoryProvider()
    sup = engine_for_config(
        Configuration(engine_supervision=True, engine_crosscheck_interval=1),
        device=cuda_device, metrics=Metrics(provider),
    )
    assert isinstance(sup, EngineSupervisor) and sup.engine.device.type == "cuda"
    before = KERNELS.stats("horner_scan").launches
    got = sup.verify_batch(msgs, sigs, keys)
    assert KERNELS.stats("horner_scan").launches == before + 1
    assert got.tolist() == [i % 9 != 0 for i in range(40)]
    dump = provider.dump()
    assert dump["engine_crosscheck_total"]["value"] == 1
    assert dump["engine_crosscheck_mismatch_total"]["value"] == 0
    assert sup.rung == 0 and not sup.health.suspect


def _signed_request_cluster(engine, replicas: int = 4, clients: int = 4):
    cluster = Cluster(replicas, seed=9,
                      config_tweaks={"request_batch_max_count": 64, "request_pool_size": 256})
    signers = {i: Ed25519Signer(i, bytes([i]) * 32) for i in cluster.nodes}
    keys = {i: s.public_bytes for i, s in signers.items()}
    keyring = ClientKeyring([Ed25519Signer(100 + c, bytes([100 + c]) * 32) for c in range(clients)])
    for node_id, node in cluster.nodes.items():
        node.app = SignedRequestApp(
            node_id, cluster, signers[node_id], SigOnlyVerifier(keys, engine=engine),
            client_keys=keyring.public_keys, engine=engine,
        )
    cluster.start()
    for block in range(2):
        for r in range(64):
            cluster.submit_to_all(keyring.make_request(r % clients, block * 64 + r))
        assert cluster.run_until_ledger(block + 1, max_time=300.0)
    cluster.assert_ledgers_consistent()
    return [[d.proposal.digest() for d in n.app.ledger] for n in cluster.nodes.values()]


class _CountingEngine(med.Ed25519BatchVerifier):
    """The strict engine, counting its calls that reach ``min_device_batch``
    (its device calls)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.device_calls = 0

    def verify_batch(self, messages, signatures, public_keys):
        self.device_calls += len(messages) >= self._min_device_batch
        return super().verify_batch(messages, signatures, public_keys)


@pytest.mark.cuda
def test_signed_request_cluster_on_card_launches_b1_and_orders_as_the_host_path(cuda_device):
    """4 SignedRequestApp replicas order 2 blocks of 64 signed requests with
    one strict engine on the card: every replica's proposal wave (64
    requests, then 64 + the previous commit certificate) is a device call,
    B1 launches once per device call and B2 and B3 never, and the ledgers
    equal those of the same cluster on the host path."""
    card = _CountingEngine(device=cuda_device, min_device_batch=32)
    before = {name: KERNELS.stats(name).launches for name in scan_kernels.KERNELS}
    on_card = _signed_request_cluster(card)
    launches = {name: KERNELS.stats(name).launches - n for name, n in before.items()}
    assert card.device_calls >= 2 * 4  # each replica's wave, each block
    assert launches == {"horner_scan": card.device_calls, "horner_scan_p256": 0, "straus_msm": 0}
    host = med.Ed25519BatchVerifier(device="cpu", min_device_batch=10**9)
    assert _signed_request_cluster(host) == on_card
    assert len(on_card[0]) == 2
