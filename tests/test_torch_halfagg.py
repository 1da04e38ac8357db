"""The port's half-aggregated Ed25519 quorum certs
(``consensus_tpu_torch/models/aggregate.py``) against the JAX package's.

``tests/test_halfagg.py`` and ``tests/test_halfagg_cluster.py`` mirrored:
each rejection class of the adversarial matrix on both backends (the
device path, host-prep and fused, here on the plain torch versions of its
kernels, and the big-int host twin); bisection localizing exactly the strict-invalid components; one
device call per cert verify; a cert aggregated by either package verifies
in the other, ``rs`` and ``s_agg`` byte for byte; and a 4-replica
``cert_mode="half-agg"`` cluster (host-twin engines) whose ledgers, WAL
records and network send sequence equal the JAX cluster's under the same
seed, restarts from its WAL, catches a crashed replica up over certs and
syncs a ledger whose cert format flips mid-history.  Tolerance 0.
"""

import struct

import numpy as np
import pytest
import torch

import consensus_tpu.models as jmodels
import consensus_tpu.testing as jtesting
import consensus_tpu.wire as jwire
from consensus_tpu.models.aggregate import HalfAggregator as JaxHalfAggregator
from consensus_tpu.models.aggregate import halfagg_coefficients as jax_coefficients
from consensus_tpu_torch import wire as twire
from consensus_tpu_torch.metrics import (
    CERT_AGGREGATE_LAUNCHES_KEY,
    CERT_BYTES_PER_CERT_KEY,
    CERT_FALLBACK_BISECTIONS_KEY,
    NET_CERT_BYTES_KEY,
    SYNC_CERT_BYTES_KEY,
    WAL_CERT_BYTES_KEY,
    InMemoryProvider,
    Metrics,
)
from consensus_tpu_torch.models import (
    Ed25519BatchVerifier,
    Ed25519Signer,
    Ed25519VerifierMixin,
    EcdsaP256VerifierMixin,
)
from consensus_tpu_torch.models.aggregate import HalfAggregator, halfagg_coefficients
from consensus_tpu_torch.models.ed25519 import L, _ref_decompress, ref_public_key, ref_sign
from consensus_tpu_torch.obs.kernels import KERNELS
from consensus_tpu_torch.ops import field25519 as fe
from consensus_tpu_torch.sync import (
    InProcessSyncTransport,
    LedgerDecisionStore,
    LedgerSynchronizer,
    SyncServer,
)
from consensus_tpu_torch.testing import Cluster, CryptoApp, make_request, pack_batch
from consensus_tpu_torch.types import Decision, Proposal, QuorumCert
from consensus_tpu_torch.wire import SavedCommit, ViewMetadata, encode_view_metadata
from consensus_tpu_torch.wire.codec import decode_saved

N = 4  # quorum-sized; the padded device batch stays tiny on the CPU


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path's tensors are 8 lanes wide: one intra-op thread runs
    them faster than many, and leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_quorum(n=N, tag=b"halfagg"):
    msgs, sigs, keys = [], [], []
    for i in range(n):
        seed = bytes([i + 1]) * 32
        m = b"ctpu/%s/%d" % (tag, i)
        msgs.append(m)
        sigs.append(ref_sign(seed, m))
        keys.append(ref_public_key(seed))
    return msgs, sigs, keys


def strict_verdicts(msgs, sigs, keys):
    return np.asarray(
        Ed25519BatchVerifier(min_device_batch=10**9, device="cpu").verify_batch(msgs, sigs, keys)
    )


DEVICE = HalfAggregator(min_device_batch=1, device="cpu")
FUSED = HalfAggregator(min_device_batch=1, device_prep=True, device="cpu")
HOST = HalfAggregator(min_device_batch=10**9, device="cpu")
JAX_HOST = JaxHalfAggregator(min_device_batch=10**9)


def aggregate_parts(msgs, sigs, keys):
    agg, bad = HOST.aggregate(msgs, sigs, keys)
    assert agg is not None and bad == ()
    rs, s_agg = agg
    return list(rs), s_agg


def test_aggregate_verifies_on_both_backends():
    msgs, sigs, keys = make_quorum()
    rs, s_agg = aggregate_parts(msgs, sigs, keys)
    assert rs == [s[:32] for s in sigs]
    assert HOST.verify(msgs, rs, s_agg, keys)
    assert DEVICE.verify(msgs, rs, s_agg, keys)


def test_coefficients_deterministic_committing_and_the_jax_packages():
    msgs, sigs, keys = make_quorum()
    rs = [s[:32] for s in sigs]
    zs = halfagg_coefficients(msgs, rs, keys)
    assert zs == halfagg_coefficients(msgs, rs, keys) == jax_coefficients(msgs, rs, keys)
    assert zs[0] == 1 and all(z != 0 for z in zs)
    other = halfagg_coefficients([b"x"] + msgs[1:], rs, keys)
    assert other[1:] != zs[1:]
    assert halfagg_coefficients([], [], []) == []


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_certs_cross_between_the_packages_byte_for_byte(direction):
    msgs, sigs, keys = make_quorum(5, tag=b"cross")
    port_agg, port_bad = HOST.aggregate(msgs, sigs, keys)
    jax_agg, jax_bad = JAX_HOST.aggregate(msgs, sigs, keys)
    assert port_bad == jax_bad == ()
    assert port_agg[0] == jax_agg[0] and port_agg[1] == jax_agg[1]  # rs, s_agg
    rs, s_agg = port_agg if direction == "port_to_jax" else jax_agg
    verifier = JAX_HOST if direction == "port_to_jax" else HOST
    assert verifier.verify(msgs, list(rs), s_agg, keys)
    bad = bytearray(s_agg)
    bad[0] ^= 1
    assert not verifier.verify(msgs, list(rs), bytes(bad), keys)


# --- the adversarial rejection-class matrix --------------------------------


def _tamper_s_agg(msgs, rs, s_agg, keys):
    bad = bytearray(s_agg)
    bad[0] ^= 0x01
    return msgs, rs, bytes(bad), keys


def _s_agg_above_l(msgs, rs, s_agg, keys):
    return msgs, rs, L.to_bytes(32, "little"), keys


def _s_agg_bad_length(msgs, rs, s_agg, keys):
    return msgs, rs, s_agg[:31], keys


def _forge_component_r(msgs, rs, s_agg, keys):
    bad = bytearray(rs[1])
    bad[3] ^= 0xFF
    return msgs, [rs[0], bytes(bad)] + rs[2:], s_agg, keys


def _wrong_key(msgs, rs, s_agg, keys):
    return msgs, rs, s_agg, [keys[1], keys[0]] + keys[2:]


def _wrong_message(msgs, rs, s_agg, keys):
    return [b"swapped"] + msgs[1:], rs, s_agg, keys


def _non_decodable_r_high_y(msgs, rs, s_agg, keys):
    return msgs, [b"\xff" * 32] + rs[1:], s_agg, keys


def _non_decodable_r_off_curve(msgs, rs, s_agg, keys):
    y = next(c for c in range(2, 64) if _ref_decompress(c.to_bytes(32, "little")) is None)
    assert (y & ((1 << 255) - 1)) < fe.P
    return msgs, [y.to_bytes(32, "little")] + rs[1:], s_agg, keys


REJECTION_CLASSES = {
    "tampered_s_agg": _tamper_s_agg,
    "s_agg_above_L": _s_agg_above_l,
    "s_agg_bad_length": _s_agg_bad_length,
    "forged_component_R": _forge_component_r,
    "wrong_key": _wrong_key,
    "wrong_message": _wrong_message,
    "non_decodable_R_high_y": _non_decodable_r_high_y,
    "non_decodable_R_off_curve": _non_decodable_r_off_curve,
}


@pytest.mark.parametrize("cls", sorted(REJECTION_CLASSES))
def test_rejection_class_parity_device_host_and_jax(cls):
    msgs, sigs, keys = make_quorum()
    rs, s_agg = aggregate_parts(msgs, sigs, keys)
    m2, r2, s2, k2 = REJECTION_CLASSES[cls](msgs, list(rs), s_agg, list(keys))
    host = HOST.verify(m2, r2, s2, k2)
    device = DEVICE.verify(m2, r2, s2, k2)
    fused = FUSED.verify(m2, r2, s2, k2)
    jax_host = JAX_HOST.verify(m2, r2, s2, k2)
    assert host is False and device is False and fused is False and jax_host is False, cls


def test_empty_cert_rejected():
    assert HOST.verify([], [], b"\x00" * 32, []) is False
    assert DEVICE.verify([], [], b"\x00" * 32, []) is False


@pytest.mark.parametrize("bad_indices", [(1,), (0, 3), (2,)])
def test_bisection_localizes_exactly_the_strict_invalid_set(bad_indices):
    msgs, sigs, keys = make_quorum(8)
    for i in bad_indices:
        flipped = bytearray(sigs[i])
        flipped[7] ^= 0xFF
        sigs[i] = bytes(flipped)
    agg = HalfAggregator(min_device_batch=10**9, device="cpu")
    cert, bad = agg.aggregate(msgs, sigs, keys)
    assert cert is None
    assert agg.fallback_bisections == 1
    strict = strict_verdicts(msgs, sigs, keys)
    assert set(bad) == {i for i in range(8) if not strict[i]} == set(bad_indices)
    assert JaxHalfAggregator(min_device_batch=10**9).aggregate(msgs, sigs, keys) == (None, bad)


def test_component_scalar_above_l_localized_like_strict():
    msgs, sigs, keys = make_quorum(4)
    sigs[2] = sigs[2][:32] + L.to_bytes(32, "little")  # S >= L: non-canonical
    agg = HalfAggregator(min_device_batch=10**9, device="cpu")
    cert, bad = agg.aggregate(msgs, sigs, keys)
    assert cert is None
    strict = strict_verdicts(msgs, sigs, keys)
    assert set(bad) == {i for i in range(4) if not strict[i]} == {2}


def test_aggregate_counts_checks_and_rejects_length_mismatch():
    msgs, sigs, keys = make_quorum()
    agg = HalfAggregator(min_device_batch=10**9, device="cpu")
    before = agg.aggregate_checks
    assert agg.aggregate(msgs, sigs, keys)[0] is not None
    assert agg.aggregate_checks == before + 1  # ONE self-check per aggregate
    with pytest.raises(ValueError):
        agg.aggregate(msgs, sigs[:-1], keys)
    with pytest.raises(ValueError):
        agg.verify(msgs, [s[:32] for s in sigs][:-1], b"\x00" * 32, keys)


def _halfagg_launches() -> int:
    return KERNELS.stats("ed25519.halfagg_verify").launches


def test_one_device_call_per_cert_verify():
    msgs, sigs, keys = make_quorum()
    rs, s_agg = aggregate_parts(msgs, sigs, keys)
    before = _halfagg_launches()
    for _ in range(2):
        assert DEVICE.verify(msgs, rs, s_agg, keys)
    assert _halfagg_launches() - before == 2
    # The host twin never takes the device path.
    before = _halfagg_launches()
    assert HOST.verify(msgs, rs, s_agg, keys)
    assert _halfagg_launches() == before


def test_engine_knobs_inherited():
    engine = Ed25519BatchVerifier(min_device_batch=10**9, pad_to=32, device="cpu")
    agg = HalfAggregator(engine=engine)
    assert agg._min_device_batch == 10**9 and agg._pad_to == 32
    assert agg.device.type == "cpu" and not agg._device_prep


def test_supports_cert_aggregation_per_curve():
    assert Ed25519VerifierMixin.supports_cert_aggregation is True
    assert EcdsaP256VerifierMixin.supports_cert_aggregation is False


# --- the protocol with half-aggregated certs (host-twin engines) ------------


class _SigVerifier(Ed25519VerifierMixin):
    def verify_proposal(self, proposal):
        raise NotImplementedError  # app half lives in CryptoApp

    def verify_request(self, raw):
        raise NotImplementedError

    def verification_sequence(self):
        return 0

    def requests_from_proposal(self, proposal):
        return []


class _JaxSigVerifier(jmodels.Ed25519VerifierMixin):
    verify_proposal = _SigVerifier.verify_proposal
    verify_request = _SigVerifier.verify_request
    verification_sequence = _SigVerifier.verification_sequence
    requests_from_proposal = _SigVerifier.requests_from_proposal


def _halfagg_cluster(port: bool, n=4, *, seed=0, cert_mode="half-agg"):
    tweaks = {} if cert_mode is None else {"cert_mode": cert_mode}
    if port:
        cluster = Cluster(n, seed=seed, config_tweaks=tweaks)
        engine = Ed25519BatchVerifier(min_device_batch=10**9, device="cpu")  # host twin
        signer_cls, verifier_cls, app_cls = Ed25519Signer, _SigVerifier, CryptoApp
        metrics = lambda: Metrics(InMemoryProvider())  # noqa: E731
    else:
        from consensus_tpu.metrics import InMemoryProvider as JaxProvider
        from consensus_tpu.metrics import Metrics as JaxMetrics

        cluster = jtesting.Cluster(n, seed=seed, config_tweaks=tweaks)
        engine = jmodels.Ed25519BatchVerifier(min_device_batch=10**9)
        signer_cls, verifier_cls, app_cls = (
            jmodels.Ed25519Signer, _JaxSigVerifier, jtesting.CryptoApp,
        )
        metrics = lambda: JaxMetrics(JaxProvider())  # noqa: E731
    signers = {i: signer_cls(i, bytes([i + 1]) * 32) for i in cluster.nodes}
    keys = {i: s.public_bytes for i, s in signers.items()}
    for node_id, node in cluster.nodes.items():
        node.metrics = metrics()
        node.app = app_cls(node_id, cluster, signers[node_id], verifier_cls(keys, engine=engine))
    return cluster


def _record_sends(wire, cluster) -> list:
    sends = []
    now = cluster.scheduler.now

    def recorder(sender, target, payload):
        data = payload if isinstance(payload, bytes) else wire.encode_message(payload)
        sends.append((now(), sender, target, data))
        return payload

    cluster.network.mutate_send = recorder
    return sends


def _ledger_bytes(wire, cluster) -> dict:
    return {
        node_id: [
            wire.encode_message(wire.SyncChunk(
                from_seq=i + 1, height=i + 1, decisions=(d.proposal,),
                quorum_certs=(d.signatures,),
            ))
            for i, d in enumerate(node.app.ledger)
        ]
        for node_id, node in cluster.nodes.items()
    }


def test_halfagg_cluster_orders_with_aggregate_certs_like_jax():
    cluster = _halfagg_cluster(True)
    jcluster = _halfagg_cluster(False)
    sends = _record_sends(twire, cluster)
    jsends = _record_sends(jwire, jcluster)
    for c, mk in ((cluster, make_request), (jcluster, jtesting.make_request)):
        c.start()
        for i in range(3):
            c.submit_to_all(mk("c", i))
            assert c.run_until_ledger(i + 1, max_time=300.0), f"block {i} stalled"
        c.assert_ledgers_consistent()

    for node in cluster.nodes.values():
        for decision in node.app.ledger:
            cert = decision.signatures
            assert isinstance(cert, QuorumCert), "half-agg mode must decide certs"
            assert len(set(cert.signer_ids)) >= 3
            assert node.app.verify_aggregate_cert(cert, decision.proposal) is not None
    # Byte for byte the JAX cluster's: ledgers (certs included), every
    # replica's WAL records and the whole network send sequence.
    assert _ledger_bytes(twire, cluster) == _ledger_bytes(jwire, jcluster)
    for node_id in cluster.nodes:
        assert cluster.nodes[node_id].wal_backing == jcluster.nodes[node_id].wal_backing
    assert len(sends) > 50 and sends == jsends

    p = cluster.nodes[1].metrics.provider
    assert p.value(CERT_AGGREGATE_LAUNCHES_KEY) >= 3
    assert p.value(WAL_CERT_BYTES_KEY) > 0
    assert p.value(NET_CERT_BYTES_KEY) > 0
    assert p.observations(CERT_BYTES_PER_CERT_KEY)
    assert p.value(CERT_FALLBACK_BISECTIONS_KEY) == 0
    jp = jcluster.nodes[1].metrics.provider
    for key in (CERT_AGGREGATE_LAUNCHES_KEY, WAL_CERT_BYTES_KEY, NET_CERT_BYTES_KEY):
        assert p.value(key) == jp.value(key)


def test_full_mode_stays_tuple_and_counts_nothing():
    cluster = _halfagg_cluster(True, cert_mode=None)
    cluster.start()
    cluster.submit_to_all(make_request("c", 0))
    assert cluster.run_until_ledger(1, max_time=300.0)
    for node in cluster.nodes.values():
        for decision in node.app.ledger:
            assert not isinstance(decision.signatures, QuorumCert)
        p = node.metrics.provider
        assert p.value(CERT_AGGREGATE_LAUNCHES_KEY) == 0
        assert p.value(WAL_CERT_BYTES_KEY) == 0
        assert p.value(NET_CERT_BYTES_KEY) == 0


def test_halfagg_saved_commit_survives_wal_restart():
    cluster = _halfagg_cluster(True)
    cluster.start()
    for i in range(2):
        cluster.submit_to_all(make_request("c", i))
        assert cluster.run_until_ledger(i + 1, max_time=300.0)
    node = cluster.nodes[2]
    cert_records = [
        rec for rec in (decode_saved(e) for e in node.wal_backing)
        if isinstance(rec, SavedCommit) and rec.cert is not None
    ]
    assert cert_records, "no cert-bearing SavedCommit twin reached the WAL"
    for rec in cert_records:
        assert isinstance(rec.cert, QuorumCert)
        assert len(set(rec.cert.signer_ids)) >= 3
    node.restart()
    cluster.submit_to_all(make_request("c", 2))
    assert cluster.run_until_ledger(3, max_time=300.0), "restart from a cert-bearing WAL wedged"
    cluster.assert_ledgers_consistent()


def test_crashed_node_catches_up_over_halfagg_certs():
    cluster = _halfagg_cluster(True)
    cluster.start()
    cluster.submit_to_all(make_request("c", 0))
    assert cluster.run_until_ledger(1, max_time=300.0)
    cluster.nodes[4].crash()
    for i in range(1, 3):
        cluster.submit_to_all(make_request("c", i))
        assert cluster.run_until_ledger(i + 1, node_ids=[1, 2, 3], max_time=300.0)
    cluster.nodes[4].start()
    assert cluster.run_until_ledger(3, max_time=600.0), "catch-up stalled"
    cluster.assert_ledgers_consistent()
    assert all(isinstance(d.signatures, QuorumCert) for d in cluster.nodes[4].app.ledger)
    assert cluster.nodes[4].metrics.provider.value(SYNC_CERT_BYTES_KEY) > 0


def _signed_chain(length, signers, keys, engine, *, halfagg_from):
    verifier = _SigVerifier(keys, engine=engine)
    chain = []
    for seq in range(1, length + 1):
        proposal = Proposal(
            payload=pack_batch([make_request("chain", seq)]),
            header=struct.pack(">Q", seq - 1),
            metadata=encode_view_metadata(
                ViewMetadata(view_id=0, latest_sequence=seq, decisions_in_view=seq)
            ),
        )
        sigs = tuple(signers[i].sign_proposal(proposal, b"aux") for i in (1, 3, 4))
        if seq >= halfagg_from:
            cert = verifier.aggregate_cert(proposal, sigs)
            assert cert is not None
            chain.append(Decision(proposal=proposal, signatures=cert))
        else:
            chain.append(Decision(proposal=proposal, signatures=sigs))
    return chain


class _CountingVerifier:
    def __init__(self, inner):
        self.inner = inner
        self.calls = 0
        self.kinds = []

    def verify_consenter_sigs_multi_batch(self, groups):
        self.calls += 1
        self.kinds.append({isinstance(c, QuorumCert) for _, c in groups})
        return self.inner.verify_consenter_sigs_multi_batch(groups)


class _OpenNetwork:
    def node_ids(self):
        return [1, 2, 3, 4]

    def reachable(self, a, b):
        return True


def test_sync_catchup_over_mixed_cert_format_ledger():
    engine = Ed25519BatchVerifier(min_device_batch=10**9, device="cpu")
    signers = {i: Ed25519Signer(i, bytes([i + 1]) * 32) for i in (1, 2, 3, 4)}
    keys = {i: s.public_bytes for i, s in signers.items()}
    chain = _signed_chain(12, signers, keys, engine, halfagg_from=7)
    servers = {p: SyncServer(LedgerDecisionStore(list(chain))) for p in (1, 3, 4)}
    transport = InProcessSyncTransport(2, _OpenNetwork(), servers)
    counting = _CountingVerifier(_SigVerifier(keys, engine=engine))
    provider = InMemoryProvider()
    ledger = []
    client = LedgerSynchronizer(
        node_id=2,
        store=LedgerDecisionStore(ledger),
        transport=transport,
        verifier=counting,
        nodes=(1, 2, 3, 4),
        metrics=Metrics(provider).sync,
    )
    response = client.sync()
    assert len(ledger) == 12
    assert [d.proposal.digest() for d in ledger] == [d.proposal.digest() for d in chain]
    assert all(not isinstance(d.signatures, QuorumCert) for d in ledger[:6])
    assert all(isinstance(d.signatures, QuorumCert) for d in ledger[6:])
    assert response.latest.proposal.digest() == chain[-1].proposal.digest()
    assert counting.calls == 2
    assert all(len(k) == 1 for k in counting.kinds)
    assert provider.value(SYNC_CERT_BYTES_KEY) > 0


def test_multi_batch_rejects_mixed_cert_modes():
    engine = Ed25519BatchVerifier(min_device_batch=10**9, device="cpu")
    signers = {i: Ed25519Signer(i, bytes([i + 1]) * 32) for i in (1, 2, 3, 4)}
    keys = {i: s.public_bytes for i, s in signers.items()}
    verifier = _SigVerifier(keys, engine=engine)
    proposal = Proposal(payload=b"x")
    sigs = tuple(signers[i].sign_proposal(proposal, b"") for i in (1, 2, 3))
    cert = verifier.aggregate_cert(proposal, sigs)
    assert cert is not None
    assert verifier.verify_consenter_sigs_batch(cert, proposal) == [b"", b"", b""]
    with pytest.raises(ValueError, match="contradict"):
        verifier.verify_consenter_sigs_multi_batch([(proposal, sigs), (proposal, cert)])
