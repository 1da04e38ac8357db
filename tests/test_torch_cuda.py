"""Card-only tests of the port's hand-written CUDA kernels.

Every test here carries the ``cuda`` marker and asks for a card through the
``cuda_device`` fixture, which skips with the reason where none is present.
The file imports neither JAX nor the JAX package (the machine with the card
has no JAX), so it runs there on its own:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import hashlib

import numpy as np
import pytest
import torch

from chip_smoke import weaken
from consensus_tpu_torch.config import Configuration
from consensus_tpu_torch.models import ecdsa_p256 as mp
from consensus_tpu_torch.models import ed25519 as med
from consensus_tpu_torch.models.aggregate import HalfAggregator
from consensus_tpu_torch.models.fused import (
    FusedEd25519BatchVerifier,
    FusedEd25519RandomizedBatchVerifier,
)
from consensus_tpu_torch.models.verifier import Ed25519Signer, engine_for_config
from consensus_tpu_torch.obs.kernels import KERNELS
from consensus_tpu_torch.ops import ed25519 as ed
from consensus_tpu_torch.ops import field25519 as fe
from consensus_tpu_torch.ops import field_p256 as fp
from consensus_tpu_torch.ops import mxu_limbs
from consensus_tpu_torch.ops import p256
from consensus_tpu_torch.ops import scalar25519 as sc
from consensus_tpu_torch.ops import scan_kernels
from consensus_tpu_torch.ops import sha512 as sh
from consensus_tpu_torch.testing import ClientKeyring, Cluster, SigOnlyVerifier, SignedRequestApp

P = fe.P


def _launches() -> dict:
    return {name: KERNELS.stats(name).launches for name in scan_kernels.KERNELS}


def _delta(before: dict) -> dict:
    return {name: n - before[name] for name, n in _launches().items()}


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
    before = _launches()
    got = engine.verify_batch(msgs, sigs, keys)
    delta = _delta(before)
    assert (delta["horner_scan"], delta["verdict25519"], delta["verdict_p256"]) == (1, 1, 0)
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
    before = _launches()
    got = engine.verify_batch(msgs, sigs, keys)
    delta = _delta(before)
    assert {k: v for k, v in delta.items() if v} == {
        "horner_scan_p256": 1, "comb_p256": 1, "verdict_p256": 1}
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
    before = _launches()
    got = engine.verify_batch(msgs, sigs, keys)
    delta = _delta(before)
    assert {k: v for k, v in delta.items() if v} == {
        "straus_msm": 1, "decompress25519": 1, "comb25519": 1, "verdict25519": 1}
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
    B1, D1, D2 and E1 launch once per device call and B2, B3, P1 and P2
    never, and the ledgers
    equal those of the same cluster on the host path."""
    card = _CountingEngine(device=cuda_device, min_device_batch=32)
    before = {name: KERNELS.stats(name).launches for name in scan_kernels.KERNELS}
    on_card = _signed_request_cluster(card)
    launches = {name: KERNELS.stats(name).launches - n for name, n in before.items()}
    assert card.device_calls >= 2 * 4  # each replica's wave, each block
    assert launches == {
        "horner_scan": card.device_calls, "horner_scan_p256": 0, "straus_msm": 0, "sha512": 0,
        "decompress25519": card.device_calls, "comb25519": card.device_calls, "mxu_limbs": 0,
        "verdict25519": card.device_calls, "comb_p256": 0, "verdict_p256": 0,
        "scalar25519": 0,
    }
    host = med.Ed25519BatchVerifier(device="cpu", min_device_batch=10**9)
    assert _signed_request_cluster(host) == on_card
    assert len(on_card[0]) == 2


# --- kernel S1 (SHA-512) and the fused front end ------------------------------




@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 256, 8192 + 37])
def test_sha512_kernel_matches_hashlib_and_plain_version_on_card(cuda_device, n):
    """S1 at widths 1, 37, 256 and 8,229 on ragged messages of 0-360 bytes
    (1-3 blocks), with one lane's count forced past the block axis: the
    state equal to the plain version's, the digests to hashlib's."""
    rng = np.random.default_rng(n)
    msgs = [rng.bytes(int(k)) for k in rng.integers(0, 360, size=n)]
    blocks, n_blocks = sh.pad_messages(msgs)
    assert blocks.shape[0] == (3 if n > 1 else sh.padded_blocks_for(len(msgs[0])))
    b = sh.blocks_tensor(blocks).to(cuda_device)
    c = torch.from_numpy(n_blocks).to(cuda_device)
    before = KERNELS.stats("sha512").launches
    got = sh.sha512_blocks(b, c)
    torch.cuda.synchronize()
    assert KERNELS.stats("sha512").launches == before + 1
    assert torch.equal(got, sh.sha512_blocks_reference(b, c))
    digests = sh.digest_bytes(got).cpu().numpy().astype(np.uint8)
    assert [bytes(digests[:, i]) for i in range(n)] == [hashlib.sha512(m).digest() for m in msgs]
    forced = c.clone()
    forced[-1] = 99
    assert torch.equal(sh.sha512_blocks(b, forced), sh.sha512_blocks_reference(b, forced))


def _s1_case(case: str) -> list[bytes]:
    """Messages for S1's producer/consumer CTAs: 16 lanes of up to 40 blocks
    (the long-lane regime, one CTA), one lane of the transcript root's 3,431
    blocks, and 70 lanes over three CTAs whose step counts differ (1-block
    messages in the first, up to 12 blocks in the second, 2 lanes of 3 in
    the third)."""
    rng = np.random.default_rng(len(case))
    if case == "long":
        return [rng.bytes(int(k)) for k in [40 * 128 - 17, *rng.integers(0, 40 * 128, 15)]]
    if case == "root":
        return [rng.bytes(439062)]
    lengths = [*rng.integers(0, 111, 32), *rng.integers(0, 12 * 128 - 17, 32), 300, 5, 0, 1, 2, 3]
    return [rng.bytes(int(k)) for k in lengths]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["long", "root", "ragged_ctas"])
def test_sha512_kernel_ring_on_long_and_ragged_lanes(cuda_device, case):
    """S1's ring of schedules across many blocks a lane and across CTAs that
    take different step counts: every digest equal to hashlib's, the state
    equal to the plain version's where it can finish (not on the root's
    3,431 blocks), with counts forced to 0, negative and past the block
    axis inside one CTA."""
    msgs = _s1_case(case)
    blocks, n_blocks = sh.pad_messages(msgs)
    b = sh.blocks_tensor(blocks).to(cuda_device)
    c = torch.from_numpy(n_blocks).to(cuda_device)
    before = KERNELS.stats("sha512").launches
    got = sh.sha512_blocks(b, c)
    torch.cuda.synchronize()
    assert KERNELS.stats("sha512").launches == before + 1
    digests = sh.digest_bytes(got).cpu().numpy().astype(np.uint8)
    assert [bytes(digests[:, i]) for i in range(len(msgs))] == [
        hashlib.sha512(m).digest() for m in msgs
    ]
    if case == "root":
        return
    assert torch.equal(got, sh.sha512_blocks_reference(b, c))
    forced = c.clone()
    forced[0], forced[1], forced[2] = 0, -4, blocks.shape[0] + 9
    assert torch.equal(sh.sha512_blocks(b, forced), sh.sha512_blocks_reference(b, forced))


@pytest.mark.cuda
def test_sha512_kernel_rejects_mixed_devices(cuda_device):
    blocks, n_blocks = sh.pad_messages([b"abc"])
    with pytest.raises(ValueError, match="one device"):
        sh.sha512_blocks(sh.blocks_tensor(blocks).to(cuda_device), torch.from_numpy(n_blocks))


def _signed(n, seed):
    rng = np.random.default_rng(seed)
    seeds = [rng.bytes(32) for _ in range(n)]
    msgs = [rng.bytes(int(k)) for k in rng.integers(0, 300, size=n)]
    return msgs, [med.ref_sign(s, m) for s, m in zip(seeds, msgs)], [
        med.ref_public_key(s) for s in seeds
    ]


@pytest.mark.cuda
def test_fused_waves_launch_as_counted_on_card(cuda_device):
    """A fused strict wave is one S1, one L1, one D1, one B1, one D2 and one
    E1 launch; a fused randomized wave with one forged signature launches B3
    once per aggregate check it books, S1 four times a check and L1 twice,
    plus one S1, one L1 and one B1 per strict-floor call, and D1, D2 and E1
    once per check and per floor call; both equal the host-prep engine's
    verdicts."""
    msgs, sigs, keys = _signed(40, seed=5)
    sigs[7] = sigs[7][:40] + bytes([sigs[7][40] ^ 1]) + sigs[7][41:]  # S off by one bit
    sigs[9] = sigs[9][:63]  # bad length: rejected before the device
    want = med.Ed25519BatchVerifier(device=cuda_device).verify_batch(msgs, sigs, keys)
    assert want.sum() == 38
    strict = FusedEd25519BatchVerifier(device=cuda_device)
    before = _launches()
    assert np.array_equal(strict.verify_batch(msgs, sigs, keys), want)
    assert _delta(before) == {
        "horner_scan": 1, "horner_scan_p256": 0, "straus_msm": 0, "sha512": 1,
        "decompress25519": 1, "comb25519": 1, "mxu_limbs": 0, "verdict25519": 1,
        "comb_p256": 0, "verdict_p256": 0, "scalar25519": 1,
    }

    randomized = FusedEd25519RandomizedBatchVerifier(device=cuda_device, min_randomized=4)
    before = _launches()
    checks = KERNELS.stats("ed25519.fused_batch_verify").launches
    floors = KERNELS.stats("ed25519.fused_verify").launches
    assert np.array_equal(randomized.verify_batch(msgs, sigs, keys), want)
    checks = KERNELS.stats("ed25519.fused_batch_verify").launches - checks
    floors = KERNELS.stats("ed25519.fused_verify").launches - floors
    assert checks >= 3 and floors >= 1  # the aggregate fails, then bisection
    assert _delta(before) == {
        "horner_scan": floors, "horner_scan_p256": 0, "straus_msm": checks,
        "sha512": 4 * checks + floors, "decompress25519": checks + floors,
        "comb25519": checks + floors, "mxu_limbs": 0, "verdict25519": checks + floors,
        "comb_p256": 0, "verdict_p256": 0, "scalar25519": 2 * checks + floors,
    }


@pytest.mark.cuda
@pytest.mark.parametrize("device_prep", [False, True])
def test_halfagg_verify_launches_b3_once_on_card(cuda_device, device_prep):
    """A half-aggregated cert verify on the card is one B3, one D1, one D2
    and one E1 launch (and four S1 and two L1 launches on the fused path),
    accepting the honest cert and rejecting a tampered one as the host twin
    does."""
    msgs, sigs, keys = _signed(5, seed=6)
    host = HalfAggregator(min_device_batch=10**9, device=cuda_device)
    agg, bad = host.aggregate(msgs, sigs, keys)
    assert bad == ()
    rs, s_agg = agg
    card = HalfAggregator(min_device_batch=1, device_prep=device_prep, device=cuda_device)
    for s_value, verdict in ((s_agg, True), (bytes([s_agg[0] ^ 1]) + s_agg[1:], False)):
        before = _launches()
        assert card.verify(msgs, list(rs), s_value, keys) is verdict
        assert host.verify(msgs, list(rs), s_value, keys) is verdict
        assert _delta(before) == {
            "horner_scan": 0, "horner_scan_p256": 0, "straus_msm": 1,
            "sha512": 4 if device_prep else 0, "decompress25519": 1, "comb25519": 1,
            "mxu_limbs": 0, "verdict25519": 1, "comb_p256": 0, "verdict_p256": 0,
            "scalar25519": 2 if device_prep else 0,
        }


# --- kernels D1 (decompression) and D2 (the fixed-base comb) -------------------


def _decompress_case(m: int, device):
    """(32, m) y limbs and (m,) signs: encodings of j*B (both sign bits),
    y = +-1 with both signs, y >= p, and random y's (about half of them off
    the curve) with random signs."""
    rng = np.random.default_rng(m)
    special = [(1, 0), (1, 1), (P - 1, 0), (P - 1, 1), (P, 0), (P + 1, 1), ((1 << 255) - 1, 0)]
    pts, cur = [], (ed._BX, ed._BY)
    for _ in range(min(m // 4, 512)):
        pts.append(cur)
        cur = ed._edwards_add_int(cur, (ed._BX, ed._BY))
    lanes = special + [(y, (x & 1) ^ int(rng.integers(0, 2))) for x, y in pts]
    while len(lanes) < m:
        lanes.append((int.from_bytes(rng.bytes(32), "little") >> 1, int(rng.integers(0, 2))))
    lanes = lanes[:m] if m > 1 else [(ed._BY, 1)]
    y = np.stack([fe.int_to_limbs(v) for v, _ in lanes], axis=1)
    sign = np.array([s for _, s in lanes], dtype=np.int32)
    return torch.from_numpy(y).to(device), torch.from_numpy(sign).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 255, 8192, 16384, 3, 17, 65, 2048])
def test_decompress_kernel_matches_reference_on_card(cuda_device, m):
    """D1's frozen X, Y, Z, T and valid mask equal the plain version's on
    every lane (tolerance 0), valid or not; canonical limbs; one launch.
    The widths include ragged ones (a 64-point block straddling the end)
    and phase 12's R || A stack (2,048 points)."""
    y, sign = _decompress_case(m, cuda_device)
    before = KERNELS.stats("decompress25519").launches
    got, ok = scan_kernels.decompress(y, sign)
    torch.cuda.synchronize()
    assert KERNELS.stats("decompress25519").launches == before + 1
    want, want_ok = scan_kernels.decompress_reference(y, sign)
    assert ok.dtype == torch.bool and torch.equal(ok, want_ok)
    if m > 255:
        assert 0 < int(ok.sum()) < m
    for g, w in zip(got, want):
        assert torch.equal(fe.freeze(g), fe.freeze(w))
        assert torch.equal(g, fe.freeze(g).to(torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 8192, 3, 17, 65, 1024])
def test_comb_kernel_matches_reference_on_card(cuda_device, n):
    """D2's frozen X, Y, Z, T equal the plain version's on every lane
    (tolerance 0): digit 0 and 255 in every window, S = 0, random bytes;
    canonical limbs; one launch.  The widths include ragged ones (a block
    of 16 lanes, each a group of 4 threads, straddling the end) and phase
    12's wave (1,024 lanes)."""
    rng = np.random.default_rng(n)
    digits = rng.integers(0, 256, size=(32, n)).astype(np.int32)
    if n > 2:
        digits[:, 0] = 0
        digits[:, 1] = 255
    d = torch.from_numpy(digits).to(cuda_device)
    before = KERNELS.stats("comb25519").launches
    got = scan_kernels.fixed_base_mul_comb(d)
    torch.cuda.synchronize()
    assert KERNELS.stats("comb25519").launches == before + 1
    want = scan_kernels.fixed_base_mul_comb_reference(d)
    for g, w in zip(got, want):
        assert torch.equal(fe.freeze(g), fe.freeze(w))
        assert torch.equal(g, fe.freeze(g).to(torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 66, 16384])
@pytest.mark.parametrize("negate", [(False, True), (True, True), (True, False)])
def test_decompress_negate_option_matches_plain_on_card(cuda_device, m, negate):
    """D1's negate option (the strict body's -A, the batch bodies' -R and
    -A, R alone): frozen X, Y, Z, T equal to the plain decompression
    followed by ``ops/ed25519.py::negate`` on the chosen halves, tolerance
    0, the valid mask unchanged; canonical limbs; one launch."""
    y, sign = _decompress_case(m, cuda_device)
    before = KERNELS.stats("decompress25519").launches
    got, ok = scan_kernels.decompress(y, sign, negate)
    torch.cuda.synchronize()
    assert KERNELS.stats("decompress25519").launches == before + 1
    want, want_ok = scan_kernels.decompress_negated_reference(y, sign, negate)
    assert torch.equal(ok, want_ok)
    for g, w in zip(got, want):
        assert torch.equal(fe.freeze(g), fe.freeze(w))
        assert torch.equal(g, fe.freeze(g).to(torch.float32))
    plain, _ = scan_kernels.decompress(y, sign)
    for c in (1, 2):  # Y and Z as without the option
        assert torch.equal(got[c], plain[c])


@pytest.mark.cuda
def test_decompress_and_comb_kernels_reject_mixed_devices(cuda_device):
    y, sign = _decompress_case(8, cuda_device)
    with pytest.raises(ValueError, match="one device"):
        scan_kernels.decompress(y, sign.cpu())
    with pytest.raises(ValueError, match="one device"):
        scan_kernels.decompress(y.cpu(), sign)


@pytest.mark.cuda
def test_ed25519_waves_launch_d1_d2_and_never_the_plain_versions(cuda_device, monkeypatch):
    """With ops/ed25519.py's decompress, fixed_base_mul_comb, add, equal and
    is_identity patched to raise: a strict wave launches D1, B1, D2 and E1
    once each, and a randomized wave with an undecodable key (the
    aggregate, then the survivors' re-check) D1, D2, B3 and E1 twice each;
    both answer as the host path."""

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card's path")

    msgs, sigs, keys = _signed(64, seed=13)
    keys[5] = (2).to_bytes(32, "little")  # off the curve: fails decompression
    host = med.Ed25519BatchVerifier(device="cpu").verify_host(msgs, sigs, keys)
    strict = engine_for_config(Configuration(crypto_tpu_min_batch=1), device=cuda_device)
    randomized = engine_for_config(Configuration(batch_verify_mode=True), device=cuda_device)
    for name in ("decompress", "fixed_base_mul_comb", "add", "equal", "is_identity"):
        monkeypatch.setattr(ed, name, refuse)
    zero = {name: 0 for name in scan_kernels.KERNELS}
    before = _launches()
    assert np.array_equal(strict.verify_batch(msgs, sigs, keys), host)
    assert _delta(before) == {**zero, "decompress25519": 1, "horner_scan": 1, "comb25519": 1,
                              "verdict25519": 1}
    before = _launches()
    assert np.array_equal(randomized.verify_batch(msgs, sigs, keys), host)
    assert _delta(before) == {**zero, "decompress25519": 2, "straus_msm": 2, "comb25519": 2,
                              "verdict25519": 2}


# --- the chaos harness on the card: device faults under the supervisor --------


@pytest.mark.cuda
@pytest.mark.parametrize("mode,kernel", [("strict", "horner_scan"), ("fused", "sha512")])
def test_faulted_chaos_run_on_card_is_byte_identical_to_the_fault_free_run(
    cuda_device, mode, kernel
):
    """The device-fault matrix's schedule with its engine on the card at
    ``min_device_batch=1``: one hang, one raise and one verdict flip, each
    masked by the supervisor, leave the event log and the ledgers exactly
    as the fault-free card run's, and the mode's kernel launches in both."""
    from chip_smoke import CHAOS_FAULTS, CHAOS_SEED, CHAOS_STEPS, chaos_mode
    from consensus_tpu_torch.testing.chaos import ChaosEngine, ChaosSchedule

    crypto, factory = chaos_mode(mode, cuda_device, 1)
    schedule = ChaosSchedule.generate(CHAOS_SEED, n=4, steps=CHAOS_STEPS)
    runs = []
    for faults in ((), CHAOS_FAULTS):
        before = KERNELS.stats(kernel).launches
        engine = ChaosEngine(schedule, crypto=crypto, engine_factory=factory,
                             device_faults=faults)
        result = engine.run()
        assert result.ok, result.violation
        assert KERNELS.stats(kernel).launches > before
        runs.append((engine, result))
    (_, clean), (engine, faulted) = runs
    assert faulted.event_log == clean.event_log
    assert faulted.ledgers == clean.ledgers
    assert engine.fault_injector.fired == list(CHAOS_FAULTS)
    assert engine.fault_injector.pending == 0
    assert engine.supervisor.rung == 0 and not engine.supervisor.degraded


@pytest.mark.cuda
def test_counting_refuses_a_kernel_launch_on_card(cuda_device):
    """A hand-written kernel cannot note its field operations: inside a
    count its wrapper raises on a CUDA tensor, launches nothing, and the
    same wrapper on the CPU copy is counted as its plain version."""
    from consensus_tpu_torch.ops import limbs

    neg, digits = _scan_case(4, cuda_device)
    before = KERNELS.stats("horner_scan").launches
    with limbs.count_field_ops() as count:
        with pytest.raises(RuntimeError, match="cannot be counted"):
            scan_kernels.horner_scan(*neg, digits)
    assert KERNELS.stats("horner_scan").launches == before and count.muls == 0
    cpu = limbs.measure_field_ops(
        scan_kernels.horner_scan, *(c.cpu() for c in neg), digits.cpu()
    )
    assert cpu.muls > 0 and cpu.squares > 0
    assert scan_kernels.horner_scan(*neg, digits).x.is_cuda  # no count: it launches


@pytest.mark.cuda
def test_virtual_shards_on_card_equal_the_single_engine(cuda_device):
    """Two virtual shards on the card: the strict and randomized sharded
    engines give the single engines' verdicts and launch each kernel once
    per shard; 3 signatures on 8 shards leave 5 padding-only shards, whose
    aggregates (u_s = 0, every digit masked) vote ok."""
    from consensus_tpu_torch.parallel import (
        ShardedEd25519RandomizedVerifier,
        ShardedEd25519Verifier,
        mesh_for_shards,
    )

    signers = [Ed25519Signer(i, bytes([i + 1]) * 32) for i in range(4)]
    msgs = [b"mesh-%d" % i for i in range(13)]
    sigs = [signers[i % 4].sign_raw(m) for i, m in enumerate(msgs)]
    keys = [signers[i % 4].public_bytes for i in range(13)]
    sigs[3] = bytes(64)
    sigs[9] = sigs[9][:32] + bytes(32)
    want = med.Ed25519BatchVerifier(device=cuda_device, min_device_batch=1).verify_batch(
        msgs, sigs, keys)
    assert list(np.flatnonzero(~want)) == [3, 9]
    two = mesh_for_shards(2, [cuda_device] * 2)
    before = {k: KERNELS.stats(k).launches for k in ("horner_scan", "decompress25519")}
    got = ShardedEd25519Verifier(two, min_device_batch=1).verify_batch(msgs, sigs, keys)
    assert (got == want).all()
    assert {k: KERNELS.stats(k).launches - v for k, v in before.items()} == {
        "horner_scan": 2, "decompress25519": 2,
    }
    rand = ShardedEd25519RandomizedVerifier(two, min_device_batch=1).verify_batch(msgs, sigs, keys)
    assert (rand == want).all()
    eight = ShardedEd25519RandomizedVerifier(mesh_for_shards(8, [cuda_device] * 8),
                                             min_device_batch=1)
    before = KERNELS.stats("straus_msm").launches
    assert eight.verify_batch(msgs[:3], sigs[:3], keys[:3]).all()
    assert KERNELS.stats("straus_msm").launches - before == 8


# --- kernel M1: the tensor-core field lane --------------------------------------

_MXU = {"ed25519": (mxu_limbs.mul25519, fe.mul), "p256": (mxu_limbs.mul_p256, fp.mul)}
_MXU_RANGES = [("ed25519", (0, 256)), ("ed25519", (-345, 681)), ("ed25519", (-340, 341)),
               ("p256", (0, 256)), ("p256", (-600, 601))]


@pytest.mark.cuda
@pytest.mark.parametrize("a_lanes,b_lanes", [(1, 1), (37, 37), (63, 63), (64, 64), (65, 65),
                                             (129, 129), (8192 + 37, 8192 + 37), (1, 2048),
                                             (2048, 1), (1, 65)])
@pytest.mark.parametrize("curve,bounds", _MXU_RANGES)
def test_mxu_kernel_matches_vpu_lane_and_plain_on_card(cuda_device, curve, bounds, a_lanes,
                                                       b_lanes):
    """M1's raw limbs (no freeze) equal the VPU lane's eager torch on the
    card and the plain version on the CPU, bit for bit, on every operand
    range, at ragged widths (63, 64, 65 and 129: the edges of a block's 64
    lanes) and with a (32, 1) constant either side; one launch a product, a
    square included."""
    rng = np.random.default_rng(a_lanes + b_lanes)
    a, b = (torch.from_numpy(rng.integers(*bounds, (32, n)).astype(np.float32))
            for n in (a_lanes, b_lanes))
    product, vpu = _MXU[curve]
    before = KERNELS.stats("mxu_limbs").launches
    got = product(a.to(cuda_device), b.to(cuda_device))
    assert KERNELS.stats("mxu_limbs").launches == before + 1
    with mxu_limbs.suppress_mxu_limbs():
        want = vpu(a.to(cuda_device), b.to(cuda_device))
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), product(a, b))
    sq = mxu_limbs.square25519 if curve == "ed25519" else mxu_limbs.square_p256
    with mxu_limbs.suppress_mxu_limbs():
        want_sq = (fe if curve == "ed25519" else fp).square(a.to(cuda_device))
    assert torch.equal(sq(a.to(cuda_device)), want_sq)
    assert KERNELS.stats("mxu_limbs").launches == before + 2


@pytest.mark.cuda
def test_mxu_kernel_takes_batched_and_strided_operands_on_card(cuda_device):
    """A (32, 1, 1) constant against a (32, 4, 96) batch, a slice of a wider
    tensor, and a (32, 4, 1) operand that broadcasts over part of the batch:
    the field modules' shapes, each one launch, equal to the VPU lane."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.integers(-340, 341, (32, 4, 200)).astype(np.float32)).to(cuda_device)
    c = torch.from_numpy(rng.integers(0, 256, (32, 1, 1)).astype(np.float32)).to(cuda_device)
    part = torch.from_numpy(rng.integers(0, 256, (32, 4, 1)).astype(np.float32)).to(cuda_device)
    view = x[:, :, 7:103]
    assert not view.is_contiguous()
    for a, b in ((c, view), (view, part), (part, view), (view, view)):
        before = KERNELS.stats("mxu_limbs").launches
        got = mxu_limbs.mul25519(a, b)
        assert KERNELS.stats("mxu_limbs").launches == before + 1
        with mxu_limbs.suppress_mxu_limbs():
            want = fe.mul(a, b)
        assert got.shape == want.shape == (32, 4, 96) and torch.equal(got, want)


@pytest.mark.cuda
def test_mxu_kernel_rejects_what_it_does_not_take(cuda_device):
    a = torch.zeros((32, 8), dtype=torch.float32, device=cuda_device)
    before = KERNELS.stats("mxu_limbs").launches
    with pytest.raises(TypeError, match="float32"):
        mxu_limbs.mul25519(a.double(), a.double())
    with pytest.raises(ValueError, match=r"\(32, \*batch\)"):
        mxu_limbs.mul_p256(a[:31], a[:31])
    with pytest.raises(ValueError, match="one device"):
        mxu_limbs.mul25519(a, a.cpu())
    with pytest.raises(ValueError, match="one device"):
        mxu_limbs.mul_p256(a.cpu(), a)
    assert KERNELS.stats("mxu_limbs").launches == before


@pytest.mark.cuda
def test_counting_refuses_an_m1_launch_on_card(cuda_device):
    from consensus_tpu_torch.ops import limbs

    a = torch.ones((32, 4), dtype=torch.float32, device=cuda_device)
    before = KERNELS.stats("mxu_limbs").launches
    with limbs.count_field_ops() as count:
        with pytest.raises(RuntimeError, match="cannot be counted"):
            mxu_limbs.mul25519(a, a)
    assert KERNELS.stats("mxu_limbs").launches == before and count.dots == 0


@pytest.mark.cuda
def test_mxu_lane_strict_wave_on_card_gives_the_lane_off_verdicts(cuda_device, monkeypatch):
    """The strict engine from ``engine_for_config`` with
    ``CTPU_MXU_LIMBS=1`` (the registry's ``mxu`` key): its wave's verdicts
    equal the lane-off engine's, M1 launches in neither lane (every product
    of the wave runs inside B1, D1, D2 and E1, which take no lane:
    ROADMAP divergence 23), every kernel launches as often, and its device
    call is booked as ``ed25519.verify_mxu``."""
    signers = [Ed25519Signer(i, bytes([i + 1]) * 32) for i in range(4)]
    msgs = [b"mxu-wave-%d" % i for i in range(64)]
    sigs = [signers[i % 4].sign_raw(m) for i, m in enumerate(msgs)]
    keys = [signers[i % 4].public_bytes for i in range(64)]
    sigs[3] = bytes(64)
    sigs[9] = sigs[9][:32] + med.L.to_bytes(32, "little")
    keys[17] = (2).to_bytes(32, "little")
    msgs[30] = b"x" + msgs[30]
    monkeypatch.delenv("CTPU_MXU_LIMBS", raising=False)
    off_engine = engine_for_config(Configuration(crypto_tpu_min_batch=1))
    before = _launches()
    off = off_engine.verify_batch(msgs, sigs, keys)
    off_launches = _delta(before)
    monkeypatch.setenv("CTPU_MXU_LIMBS", "1")
    on_engine = engine_for_config(Configuration(crypto_tpu_min_batch=1))
    booked = KERNELS.stats("ed25519.verify_mxu").launches
    before = _launches()
    on = on_engine.verify_batch(msgs, sigs, keys)
    on_launches = _delta(before)
    assert np.array_equal(on, off) and list(np.flatnonzero(~on)) == [3, 9, 17, 30]
    assert off_launches["mxu_limbs"] == 0 and on_launches["mxu_limbs"] == 0
    assert on_launches == off_launches and off_launches["verdict25519"] == 1
    assert KERNELS.stats("ed25519.verify_mxu").launches == booked + 1


# --- the consensus groups' shared fleet on the card ---------------------------


@pytest.mark.cuda
def test_groups_shared_fleet_on_card_launches_once_per_wave(cuda_device):
    """Phase 23a at 2 groups of 4: the committed certificates through one
    shared wave former and through one private former a group, each over the
    strict engine on the card at ``min_device_batch=1``.  B1, D1, D2 and E1
    launch once per launch of each drive, the shared drive launches less
    often with the same signatures, and a forged lane is refused by the
    shared drive (naming its group), the card and the host path alike."""
    from chip_smoke import phase_groups_fleet

    g = phase_groups_fleet(cuda_device, n_groups=2, n=4, tenants=8, decisions=3)
    shared, private = g["shared"], g["private"]
    for d in (shared, private):
        assert d["kernel_launches"] == (d["launches"],) * 4 and d["launches"] >= 1
    assert shared["total_signatures"] == private["total_signatures"]
    assert shared["launches"] < private["launches"]
    assert shared["multi_group_launches"] >= 1
    assert g["forged_error"].endswith(" " + g["forged_group"])


# --- kernels E1, P1 and P2: the waves' verdict tails ---------------------------


def _strict_tail(n: int, device):
    """E1's strict inputs for ``n`` requests as the strict body builds them
    on the card (D1, B1, D2): every 9th signature tampered, every 11th key
    off the curve, every 13th message changed."""
    from chip_smoke import strict_tail_inputs

    msgs, sigs, keys = _signed(n, seed=n)
    for i in range(0, n, 9):
        sigs[i] = sigs[i][:32] + bytes([sigs[i][32] ^ 1]) + sigs[i][33:]
    for i in range(5, n, 11):
        keys[i] = (2).to_bytes(32, "little")
    for i in range(7, n, 13):
        msgs[i] = b"x" + msgs[i]
    engine = med.Ed25519BatchVerifier(device=device, min_device_batch=1)
    host = engine.verify_host(msgs, sigs, keys)
    return strict_tail_inputs(engine, msgs, sigs, keys), host


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 8192 + 37])
def test_e1_strict_matches_plain_and_host_on_card(cuda_device, n):
    """E1's strict mode on the body's own inputs (R as row slices of D1's
    R || A output) and on the same values in negative weak limbs and
    contiguous R: verdicts equal the plain version's and the host path's,
    tolerance 0, one launch a call."""
    args, host = _strict_tail(n, cuda_device)
    acc, comb, r_point, *masks = args
    before = KERNELS.stats("verdict25519").launches
    got = scan_kernels.add_and_equal(*args)
    assert KERNELS.stats("verdict25519").launches == before + 1
    assert got.dtype == torch.bool
    assert torch.equal(got, scan_kernels.add_and_equal_reference(*args))
    assert np.array_equal(got.cpu().numpy()[:n], host)
    weak = [ed.Point(*(weaken(c).contiguous() for c in p)) for p in (acc, comb, r_point)]
    assert torch.equal(scan_kernels.add_and_equal(*weak, *masks), got)
    assert torch.equal(scan_kernels.add_and_equal_reference(*weak, *masks), got)


@pytest.mark.cuda
def test_e1_identity_matches_plain_on_card(cuda_device):
    """E1's identity mode: comb + (-comb) in another representative is the
    identity, comb + comb is not, at one lane and at 37."""
    rng = np.random.default_rng(17)
    digits = torch.from_numpy(rng.integers(0, 256, (32, 37)).astype(np.int32)).to(cuda_device)
    comb = scan_kernels.fixed_base_mul_comb(digits)
    neg = ed.Point(*(weaken(c).contiguous() for c in ed.negate(comb)))
    for p, want in ((neg, True), (comb, False)):
        for width in (1, 37):
            a = ed.Point(*(c[:, :width].contiguous() for c in p))
            b = ed.Point(*(c[:, :width].contiguous() for c in comb))
            got = scan_kernels.add_is_identity(a, b)
            assert torch.equal(got, scan_kernels.add_is_identity_reference(a, b))
            assert bool(got.all()) is want and bool(got.any()) is want


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 2048 + 37])
def test_p1_matches_plain_on_card(cuda_device, n):
    """P1 against the plain comb: the same point on every lane, projectively
    (divergence 26: canonical limbs, frozen X_k Z_p == X_p Z_k and Y_k Z_p
    == Y_p Z_k, Z = 0 exactly on the identity), digits 0 and 255 in every
    window included; one launch."""
    from chip_smoke import p256_projective_max_err

    rng = np.random.default_rng(n)
    digits = rng.integers(0, 256, (32, n)).astype(np.int32)
    digits[:, 0] = 0
    if n > 2:
        digits[:, 1] = 255
        digits[::2, 2] = 0
    digits = torch.from_numpy(digits).to(cuda_device)
    before = KERNELS.stats("comb_p256").launches
    got = scan_kernels.fixed_base_mul_comb_p256(digits)
    assert KERNELS.stats("comb_p256").launches == before + 1
    want = scan_kernels.fixed_base_mul_comb_p256_reference(digits)
    assert p256_projective_max_err("comb_p256", got, want) == 0.0


@pytest.mark.cuda
def test_p2_matches_plain_on_card_with_the_synthetic_lanes(cuda_device):
    """P2 on a P-256 wave's own inputs (acc from B2, comb from P1) with the
    synthetic lanes over its padded columns (x(R') >= n with has_r2 set and
    cleared, Z = 0, Q off the curve, a host rejection, a valid lane), and
    in negative weak limbs: the plain version's verdicts, the host path's
    on the signed lanes and the construction's on the synthetic ones."""
    from chip_smoke import p256_tail_inputs, write_p256_synthetic_lanes

    rng = np.random.default_rng(19)
    privs = [int.from_bytes(rng.bytes(32), "big") % (mp.N - 1) + 1 for _ in range(40)]
    keys = [mp.ref_p256_public_key(d) for d in privs]
    msgs = [b"p2-%d" % i for i in range(40)]
    sigs = [mp.ref_p256_sign(d, m) for d, m in zip(privs, msgs)]
    sigs[0] = sigs[0][:32] + mp.N.to_bytes(32, "big")
    keys[1] = b"\x04" + keys[1][1:33] + bytes(32)
    msgs[2] = b"x" + msgs[2]
    engine = mp.EcdsaP256BatchVerifier(device=cuda_device)
    _, tail = p256_tail_inputs(engine, msgs, sigs, keys)
    acc, comb, qx, qy, r1, r2, has_r2, host_ok = tail
    host = [c.cpu().numpy().copy() for c in (*acc, qx, qy, r1, r2, has_r2, host_ok)]
    want = write_p256_synthetic_lanes(host[:3], *host[3:], start=40)
    dev = lambda a: torch.from_numpy(a).to(cuda_device)
    args = (p256.Point(*(dev(c) for c in host[:3])), comb, *(dev(c) for c in host[3:]))
    before = KERNELS.stats("verdict_p256").launches
    got = scan_kernels.verdict_p256(*args)
    assert KERNELS.stats("verdict_p256").launches == before + 1
    assert torch.equal(got, scan_kernels.verdict_p256_reference(*args))
    cpu = got.cpu().numpy()
    assert cpu[:40].tolist() == [mp.ref_p256_verify(k, s, m) for m, s, k in zip(msgs, sigs, keys)]
    assert cpu[40:40 + len(want)].tolist() == want
    weak = (p256.Point(*(weaken(c) for c in args[0])), p256.Point(*(weaken(c) for c in comb)),
            *(weaken(c) for c in args[2:6]), *args[6:])
    assert torch.equal(scan_kernels.verdict_p256(*weak), got)


@pytest.mark.cuda
def test_p256_wave_never_runs_the_plain_tail_on_card(cuda_device, monkeypatch):
    """With ops/p256.py's fixed_base_mul_comb, add and on_curve patched to
    raise, a P-256 wave launches B2, P1 and P2 once each and answers as the
    host path."""

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card's path")

    rng = np.random.default_rng(23)
    privs = [int.from_bytes(rng.bytes(32), "big") % (mp.N - 1) + 1 for _ in range(8)]
    keys = [mp.ref_p256_public_key(d) for d in privs]
    msgs = [b"tail-%d" % i for i in range(8)]
    sigs = [mp.ref_p256_sign(d, m) for d, m in zip(privs, msgs)]
    keys[3] = b"\x04" + keys[3][1:33] + bytes(32)
    engine = engine_for_config(Configuration(crypto_tpu_min_batch=1), curve="p256")
    for name in ("fixed_base_mul_comb", "add", "on_curve"):
        monkeypatch.setattr(p256, name, refuse)
    before = _launches()
    got = engine.verify_batch(msgs, sigs, keys)
    assert {k: v for k, v in _delta(before).items() if v} == {
        "horner_scan_p256": 1, "comb_p256": 1, "verdict_p256": 1}
    assert got.tolist() == [mp.ref_p256_verify(k, s, m) for m, s, k in zip(msgs, sigs, keys)]


@pytest.mark.cuda
def test_verdict_kernels_reject_mixed_devices(cuda_device):
    args, _ = _strict_tail(8, cuda_device)
    acc, comb, r_point, host_ok, r_ok, a_ok = args
    with pytest.raises(ValueError, match="one device"):
        scan_kernels.add_and_equal(acc, comb, r_point, host_ok.cpu(), r_ok, a_ok)
    with pytest.raises(ValueError, match="one device"):
        scan_kernels.add_and_equal(acc, comb, ed.Point(*(c.cpu() for c in r_point)), *args[3:])
    on_card = lambda: torch.zeros((32, 4), device=cuda_device)
    flag = torch.zeros(4, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="one device"):
        scan_kernels.verdict_p256(
            p256.Point(on_card(), on_card(), on_card()),
            p256.Point(*(torch.zeros((32, 4)) for _ in range(3))),
            on_card(), on_card(), on_card(), on_card(), flag, flag)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8, 37, 8192])
def test_p2_group_schedule_matches_plain_on_card_at_ragged_widths(cuda_device, n):
    """The P2 redesign's groups (8 lanes a block, staged loads) at widths a
    block straddles, one lane and the wave's 8,192: the plain version's
    verdicts, tolerance 0, over random points (mostly refused), and lanes
    where acc + comb is a valid R' for its r."""
    rng = np.random.default_rng(n)
    lam = lambda: int.from_bytes(rng.bytes(32), "big") % fp.P or 1
    g = pt = (p256.GX, p256.GY)
    cols = []
    for i in range(n):
        pt = p256._add_int(pt, g)  # (i + 2) G
        l1, l2 = lam(), lam()
        acc = (pt[0] * l1, pt[1] * l1, l1) if i % 3 else (0, l1, 0)
        comb = (0, l2, 0) if i % 3 else (pt[0] * l2, pt[1] * l2, l2)
        r = pt[0] % p256.N if i % 4 else (pt[0] + 1) % p256.N
        cols.append([*acc, *comb, g[0], g[1] if i % 5 else g[1] + 1, r, r + p256.N])
    limbs = [torch.from_numpy(np.stack([fp.int_to_limbs(c[j] % fp.P) for c in cols], axis=1))
             .to(cuda_device) for j in range(10)]
    has_r2 = torch.from_numpy(np.array([i % 7 == 0 for i in range(n)])).to(cuda_device)
    host_ok = torch.from_numpy(np.array([i % 11 != 10 for i in range(n)])).to(cuda_device)
    args = (p256.Point(*limbs[:3]), p256.Point(*limbs[3:6]), *limbs[6:], has_r2, host_ok)
    before = KERNELS.stats("verdict_p256").launches
    got = scan_kernels.verdict_p256(*args)
    assert KERNELS.stats("verdict_p256").launches == before + 1
    want = scan_kernels.verdict_p256_reference(*args)
    assert torch.equal(got, want)
    if n > 8:
        assert 0 < int(want.sum()) < n


# --- kernel L1: the fused scalar stage -------------------------------------------


def _l1_case(n: int, device):
    """(digest (64, n), z (16, n), k (32, n), s (32, n)) on ``device``: the
    edge values of chip_smoke's L1_EDGES on the first lanes (digests; k mod
    L; s below 2^256), z = 1 on lane 0, the rest random."""
    from chip_smoke import L1_EDGES

    rng = np.random.default_rng(n)

    def rows(values, width):
        raw = b"".join(v.to_bytes(width, "little") for v in values)
        return np.frombuffer(raw, dtype=np.uint8).reshape(len(values), width).T

    digest = rng.integers(0, 256, (64, n)).astype(np.int32)
    z = rng.integers(0, 256, (16, n)).astype(np.int32)
    k = rows([int(v) % sc.L for v in rng.integers(0, 2**62, n)], 32).astype(np.int32)
    s = rng.integers(0, 256, (32, n)).astype(np.int32)
    m = min(n, len(L1_EDGES))
    digest[:, :m] = rows(L1_EDGES[:m], 64)
    k[:, :m] = rows([v % sc.L for v in L1_EDGES[:m]], 32)
    small = [v for v in L1_EDGES if v < 2**256][:m]
    s[:, :len(small)] = rows(small, 32)
    z[:, 0] = rows([1], 16)[:, 0]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (digest, z, k, s))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8, 65, 6860, 8192])
def test_l1_matches_plain_on_card(cuda_device, n):
    """L1's challenge mode (digits and bytes) and aggregate mode (with s,
    and without: a certificate's u given) against the plain versions on the
    card, tolerance 0, over the edge values and random lanes; one launch a
    call."""
    digest, z, k, s = _l1_case(n, cuda_device)
    before = KERNELS.stats("scalar25519").launches
    digits = sc.scalar_challenge(digest)
    k_bytes = sc.scalar_challenge(digest, digits=False)
    full = sc.scalar_aggregate(z, k, s)
    cert = sc.scalar_aggregate(z, k)
    torch.cuda.synchronize()
    assert KERNELS.stats("scalar25519").launches == before + 4
    assert torch.equal(digits, sc.scalar_challenge_reference(digest))
    assert torch.equal(k_bytes, sc.scalar_challenge_reference(digest, digits=False))
    for got, want in zip(full, sc.scalar_aggregate_reference(z, k, s)):
        assert torch.equal(got, want)
    assert cert[2] is None
    for got, want in zip(cert[:2], sc.scalar_aggregate_reference(z, k)[:2]):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 8192])
def test_l1_aggregate_splits_the_largest_products_on_card(cuda_device, n):
    """The aggregate mode's products split over a lane's roles, where every
    row's carries run longest (z = 2^128 - 1, k and s = 2^256 - 1 or L - 1
    on alternate lanes, random lanes between), with and without s: equal to
    the plain version, tolerance 0."""
    rng = np.random.default_rng(50 + n)

    def rows(values, width):
        raw = b"".join(v.to_bytes(width, "little") for v in values)
        return torch.from_numpy(np.frombuffer(raw, dtype=np.uint8).reshape(n, width).T
                                .astype(np.int32).copy()).to(cuda_device)

    big = lambda i, r: (2**256 - 1, sc.L - 1)[i % 2] if i % 3 else int.from_bytes(r, "little")
    z = rows([2**128 - 1 if i % 3 else int.from_bytes(rng.bytes(16), "little")
              for i in range(n)], 16)
    k = rows([big(i, rng.bytes(32)) for i in range(n)], 32)
    s = rows([big(i + 1, rng.bytes(32)) for i in range(n)], 32)
    for got, want in zip(sc.scalar_aggregate(z, k, s), sc.scalar_aggregate_reference(z, k, s)):
        assert torch.equal(got, want)
    for got, want in zip(sc.scalar_aggregate(z, k)[:2], sc.scalar_aggregate_reference(z, k)[:2]):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_l1_sums_l_minus_one_on_every_lane_on_card(cuda_device):
    """s = L - 1 on all 8,192 lanes: u = -(sum z) mod L."""
    n = 8192
    z = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (16, n)).astype(np.int32))
    s = torch.from_numpy(np.frombuffer((sc.L - 1).to_bytes(32, "little"), dtype=np.uint8)
                         .astype(np.int32)[:, None].repeat(n, axis=1).copy())
    _, _, u = sc.scalar_aggregate(z.to(cuda_device), torch.zeros((32, n), dtype=torch.int32,
                                  device=cuda_device), s.to(cuda_device))
    total = sum(int.from_bytes(bytes(z[:, i].to(torch.uint8).tolist()), "little")
                for i in range(n))
    got = int.from_bytes(bytes(u[:, 0].cpu().to(torch.uint8).tolist()), "little")
    assert got == (-total) % sc.L


@pytest.mark.cuda
def test_fused_bodies_never_run_the_plain_scalar_stage_on_card(cuda_device, monkeypatch):
    """With ops/scalar25519.py's reduce_bytes_mod_l, mul_mod_l, sum_mod_l
    and signed_window_digits patched to raise, the fused strict wave, the
    fused randomized wave and a fused certificate verify answer as the host
    path and launch L1 once, twice and twice."""

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version of the scalar stage ran on the card's path")

    msgs, sigs, keys = _signed(24, seed=29)
    host = med.Ed25519BatchVerifier(device="cpu").verify_host(msgs, sigs, keys)
    strict = FusedEd25519BatchVerifier(device=cuda_device, min_device_batch=1)
    rand = FusedEd25519RandomizedBatchVerifier(device=cuda_device, min_device_batch=1)
    agg, bad = HalfAggregator(min_device_batch=10**9, device=cuda_device).aggregate(
        msgs[:5], sigs[:5], keys[:5])
    assert bad == ()
    card = HalfAggregator(min_device_batch=1, device_prep=True, device=cuda_device)
    for name in ("reduce_bytes_mod_l", "mul_mod_l", "sum_mod_l", "signed_window_digits"):
        monkeypatch.setattr(sc, name, refuse)
    for run, want, l1 in ((lambda: strict.verify_batch(msgs, sigs, keys), host, 1),
                          (lambda: rand.verify_batch(msgs, sigs, keys), host, 2),
                          (lambda: card.verify(msgs[:5], list(agg[0]), agg[1], keys[:5]), True,
                           2)):
        before = KERNELS.stats("scalar25519").launches
        got = run()
        assert KERNELS.stats("scalar25519").launches - before == l1
        assert np.array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 16, 300, 8192])
def test_l1_reads_s1_states_and_checks_on_card(cuda_device, n):
    """L1 from S1's state words: the challenge digits and bytes, and with
    the signature and key rows the canonical checks' ok, against the plain
    versions on the card, tolerance 0, over chip_smoke's check lanes (S = L
    - 1, L, L + 1; y = p - 1 and p for R and A; sign bits; host_ok cleared)
    and random ones; ok equal to the construction too; one launch a
    call."""
    from chip_smoke import scalar_check_inputs

    state, sig, key, host_ok, want = scalar_check_inputs(cuda_device, n, seed=n)
    before = KERNELS.stats("scalar25519").launches
    digits, ok = sc.scalar_challenge_checked(state, sig, key, host_ok)
    k_digits = sc.scalar_challenge(state)
    k_bytes = sc.scalar_challenge(state, digits=False)
    torch.cuda.synchronize()
    assert KERNELS.stats("scalar25519").launches == before + 3
    ref_digits, ref_ok = sc.scalar_challenge_checked_reference(state, sig, key, host_ok)
    assert torch.equal(digits, ref_digits) and torch.equal(k_digits, ref_digits)
    assert torch.equal(ok, ref_ok) and np.array_equal(ok.cpu().numpy(), want)
    assert torch.equal(k_bytes, sc.scalar_challenge_reference(state, digits=False))


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2])
def test_fused_strict_body_hands_s1_to_l1_on_card(cuda_device, monkeypatch, shards):
    """The fused strict body on the card, single and on 2 virtual shards,
    with ``sha512.digest_bytes``, ``scalar25519.lt_l`` and
    ``field25519.bytes_lt_p`` patched to raise: verdicts equal to the
    host path's, and S1, L1, D1, B1, D2 and E1 launch once a shard; a fused
    randomized wave's first digest pass comes after L1's first launch (the
    challenges go from S1 to L1 as state words)."""
    from consensus_tpu_torch.parallel import ShardedFusedEd25519Verifier, mesh_for_shards

    def refuse(*args, **kwargs):
        raise AssertionError("an eager stage ran between S1 and D1 on the card")

    msgs, sigs, keys = _signed(24, seed=31)
    sigs[3] = sigs[3][:32] + (int.from_bytes(sigs[3][32:], "little") + sc.L).to_bytes(
        32, "little")  # S >= L
    host = med.Ed25519BatchVerifier(device="cpu").verify_host(msgs, sigs, keys)
    engine = (FusedEd25519BatchVerifier(device=cuda_device, min_device_batch=1) if shards == 1
              else ShardedFusedEd25519Verifier(mesh_for_shards(2, [cuda_device] * 2),
                                               device=cuda_device, min_device_batch=1))
    with monkeypatch.context() as m:
        for module, name in ((sh, "digest_bytes"), (sc, "lt_l"), (fe, "bytes_lt_p")):
            m.setattr(module, name, refuse)
        before = _launches()
        got = engine.verify_batch(msgs, sigs, keys)
        torch.cuda.synchronize()
    assert np.array_equal(got, host) and not got[3]
    delta = {k: v for k, v in _delta(before).items() if v}
    assert delta == {name: shards for name in ("sha512", "scalar25519", "decompress25519",
                                               "horner_scan", "comb25519", "verdict25519")}

    events: list[str] = []
    orig_digest, orig_challenge = sh.digest_bytes, sc.scalar_challenge
    monkeypatch.setattr(sh, "digest_bytes",
                        lambda *a, **k: events.append("digest") or orig_digest(*a, **k))
    monkeypatch.setattr(sc, "scalar_challenge",
                        lambda *a, **k: events.append("l1") or orig_challenge(*a, **k))
    rand = FusedEd25519RandomizedBatchVerifier(device=cuda_device, min_device_batch=1)
    assert np.array_equal(rand.verify_batch(msgs, sigs, keys), host)
    assert events and events[0] == "l1"


@pytest.mark.cuda
def test_l1_rejects_mixed_devices(cuda_device):
    z = torch.zeros((16, 4), dtype=torch.int32, device=cuda_device)
    k = torch.zeros((32, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="one device"):
        sc.scalar_aggregate(z, k.cpu())
    with pytest.raises(ValueError, match="one device"):
        sc.scalar_aggregate(z, k, k.cpu())
    state = torch.zeros((8, 2, 4), dtype=torch.int32, device=cuda_device)
    sig = torch.zeros((64, 4), dtype=torch.uint8, device=cuda_device)
    ok = torch.ones(4, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="one device"):
        sc.scalar_challenge_checked(state, sig, sig[:32].cpu(), ok)
    with pytest.raises(ValueError, match="one device"):
        sc.scalar_challenge_checked(state, sig, sig[:32].contiguous(), ok.cpu())
