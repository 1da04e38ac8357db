"""The port's protocol core with real signatures: ``tests/test_crypto_cluster.py``
mirrored on the port's engines with ``device="cpu"``, held against the
JAX package's clusters under the same seed.

Ed25519 signing is deterministic (RFC 8032), so a port ``CryptoApp``
cluster and a JAX one with the same replica keys must order byte-identical
ledgers, signatures included.  The JAX engines run on their host path here
(``min_device_batch=10**9``), as its own tests run them; the port's run
on the CPU, where a batch of at least ``min_device_batch`` signatures
takes the plain-torch device path.  ECDSA-P256 replicas show the core is
not tied to Ed25519; a JAX P-256 signer draws a random nonce, so there the
proposals are compared, not the signatures.  Tolerance 0 throughout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives.asymmetric import ec

import consensus_tpu.models as jmodels
from chip_smoke import P256SigOnlyVerifier
import consensus_tpu.testing as jtesting
import consensus_tpu.wire as jwire
from consensus_tpu.testing.crypto_app import SigOnlyVerifier as JaxSigOnlyVerifier
from consensus_tpu_torch import wire as twire
from consensus_tpu_torch.models.ecdsa_p256 import EcdsaP256BatchVerifier, ref_p256_verify
from consensus_tpu_torch.models.ed25519 import Ed25519BatchVerifier, ref_verify
from consensus_tpu_torch.models.verifier import EcdsaP256Signer, Ed25519Signer, commit_message
from consensus_tpu_torch.obs.kernels import KERNELS
from consensus_tpu_torch.testing import (
    ClientKeyring,
    Cluster,
    CryptoApp,
    SigOnlyVerifier,
    SignedRequestApp,
    make_request,
)
from consensus_tpu_torch.utils import commit_signatures_digest

SEED = 21


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain-torch waves here are a few dozen lanes: one intra-op
    thread runs them faster than many, and leaves the cores to the other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def replica_seed(node_id: int) -> bytes:
    return bytes([node_id + 1]) * 32


def client_seed(i: int) -> bytes:
    return bytes([100 + i]) * 32


class CountingEngine(Ed25519BatchVerifier):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.sizes: list[int] = []

    def verify_batch(self, messages, signatures, public_keys) -> np.ndarray:
        self.sizes.append(len(messages))
        return super().verify_batch(messages, signatures, public_keys)


class JaxCountingEngine(jmodels.Ed25519BatchVerifier):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.sizes: list[int] = []

    def verify_batch(self, messages, signatures, public_keys) -> np.ndarray:
        self.sizes.append(len(messages))
        return super().verify_batch(messages, signatures, public_keys)


def decision_bytes(wire, cluster) -> dict[int, list[bytes]]:
    return {
        node_id: [
            wire.encode_message(wire.SyncChunk(
                from_seq=1, height=1, decisions=(d.proposal,),
                quorum_certs=(tuple(d.signatures),),
            ))
            for d in node.app.ledger
        ]
        for node_id, node in cluster.nodes.items()
    }


def crypto_cluster(port: bool, signers=None, engine=None):
    """A 4-replica CryptoApp cluster with seeded Ed25519 replica keys."""
    if port:
        cluster_cls, signer_cls, mixin = Cluster, Ed25519Signer, SigOnlyVerifier
        app_cls = CryptoApp
    else:
        cluster_cls, signer_cls, mixin = jtesting.Cluster, jmodels.Ed25519Signer, JaxSigOnlyVerifier
        app_cls = jtesting.CryptoApp
    cluster = cluster_cls(4, seed=SEED)
    signers = signers or {i: signer_cls(i, replica_seed(i)) for i in cluster.nodes}
    keys = {i: signer_cls(i, replica_seed(i)).public_bytes for i in cluster.nodes}
    for node_id, node in cluster.nodes.items():
        node.app = app_cls(node_id, cluster, signers[node_id], mixin(keys, engine=engine))
    return cluster, keys


def test_cluster_orders_with_real_ed25519_signatures():
    engine = CountingEngine(device="cpu", min_device_batch=16)
    cluster, keys = crypto_cluster(True, engine=engine)
    jcluster, _ = crypto_cluster(False, engine=JaxCountingEngine(min_device_batch=10**9))
    for c, mk in ((cluster, make_request), (jcluster, jtesting.make_request)):
        c.start()
        for i in range(3):
            c.submit_to_all(mk("c", i))
            assert c.run_until_ledger(i + 1, max_time=300.0), f"block {i} stalled"
        c.assert_ledgers_consistent()

    # Every decision carries a quorum of real signatures that verify under
    # the registered public keys, on the RFC 8032 reference.
    for node in cluster.nodes.values():
        assert len(node.app.ledger) == 3
        for decision in node.app.ledger:
            assert len(decision.signatures) >= 3
            for s in decision.signatures:
                assert ref_verify(keys[s.id], s.value, commit_message(decision.proposal, s.msg))
    # The protocol drained its commit quorums through the batch engine.
    assert len(engine.sizes) > 0 and sum(engine.sizes) >= 3 * 4 * 2
    # Same seed, same keys, deterministic signatures: the same bytes.
    assert decision_bytes(twire, cluster) == decision_bytes(jwire, jcluster)


def test_forged_commit_rejected_by_real_crypto():
    engine = CountingEngine(device="cpu", min_device_batch=16)
    # Node 4 signs with a key nobody registered: its commits are rejected,
    # and the other three still form a quorum.
    signers = {i: Ed25519Signer(i, replica_seed(i)) for i in (1, 2, 3)}
    signers[4] = Ed25519Signer(4, b"\xee" * 32)
    cluster, _ = crypto_cluster(True, signers=signers, engine=engine)
    cluster.start()
    cluster.submit_to_all(make_request("c", 0))
    assert cluster.run_until_ledger(1, node_ids=[1, 2, 3], max_time=300.0)
    for node_id in (1, 2, 3):
        decision = cluster.nodes[node_id].app.ledger[0]
        assert 4 not in {s.id for s in decision.signatures}, "forged signature entered the quorum"


def signed_request_cluster(port: bool, engine, clients: int = 4):
    if port:
        cluster_cls, signer_cls, mixin = Cluster, Ed25519Signer, SigOnlyVerifier
        app_cls, keyring_cls = SignedRequestApp, ClientKeyring
    else:
        cluster_cls, signer_cls, mixin = jtesting.Cluster, jmodels.Ed25519Signer, JaxSigOnlyVerifier
        app_cls, keyring_cls = jtesting.SignedRequestApp, jtesting.ClientKeyring
    cluster = cluster_cls(4, seed=SEED)
    signers = {i: signer_cls(i, replica_seed(i)) for i in cluster.nodes}
    keys = {i: s.public_bytes for i, s in signers.items()}
    keyring = keyring_cls([signer_cls(100 + i, client_seed(i)) for i in range(clients)])
    for node_id, node in cluster.nodes.items():
        node.app = app_cls(
            node_id, cluster, signers[node_id], mixin(keys, engine=engine),
            client_keys=keyring.public_keys, engine=engine,
        )
    return cluster, keyring


def test_signed_requests_batch_verified_per_proposal():
    """SignedRequestApp: each follower verifies a proposal's 16 request
    signatures and the previous decision's commit certificate in ONE engine
    call, which at 16 signatures and more takes the port's plain-torch
    device path; a tampered request never clears ingress; the ledgers equal
    the JAX cluster's."""
    engine = CountingEngine(device="cpu", min_device_batch=16)
    cluster, keyring = signed_request_cluster(True, engine)
    jengine = JaxCountingEngine(min_device_batch=10**9)
    jcluster, jkeyring = signed_request_cluster(False, jengine)
    before = KERNELS.stats("ed25519.verify").launches
    for c, ring in ((cluster, keyring), (jcluster, jkeyring)):
        c.start()
        for block in range(2):
            for r in range(16):
                c.submit_to_all(ring.make_request(r % 4, block * 16 + r))
            assert c.run_until_ledger(block + 1, max_time=300.0)
        c.assert_ledgers_consistent()
    device_calls = KERNELS.stats("ed25519.verify").launches - before
    waves = [n for n in engine.sizes if n >= 16]
    # The 3 followers' waves of each block: 16 requests, plus the previous
    # decision's commit certificate from the second block on.
    assert len(waves) == device_calls >= 2 * 3
    assert max(waves) >= 16 + 3
    assert sorted(engine.sizes) == sorted(jengine.sizes)
    total = sum(
        int.from_bytes(d.proposal.payload[:4], "big") for d in cluster.nodes[1].app.ledger
    )
    assert total == 32, f"requests lost: only {total}/32 ordered"
    assert decision_bytes(twire, cluster) == decision_bytes(jwire, jcluster)

    app = cluster.nodes[1].app
    bad = bytearray(keyring.make_request(0, 99))
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError):
        app.verify_request(bytes(bad))
    with pytest.raises(ValueError):
        jcluster.nodes[1].app.verify_request(bytes(bad))


class JaxP256SigOnlyVerifier(jmodels.EcdsaP256VerifierMixin):
    verify_proposal = P256SigOnlyVerifier.verify_proposal
    verify_request = P256SigOnlyVerifier.verify_request
    verification_sequence = P256SigOnlyVerifier.verification_sequence
    requests_from_proposal = P256SigOnlyVerifier.requests_from_proposal


def _proposal_without_cert_digest(wire, proposal):
    """A proposal's fields, with its metadata decoded and the digest of the
    previous decision's commit signatures (different signatures in the two
    packages: random nonces) left out."""
    md = wire.decode_view_metadata(proposal.metadata)
    return (
        proposal.payload, proposal.header, proposal.verification_sequence,
        dataclasses.astuple(dataclasses.replace(md, prev_commit_signature_digest=b"")),
    )


def test_p256_cluster_orders_the_same_proposals():
    """4 ECDSA-P256 replicas order 2 blocks through the port's P-256 engine:
    every commit signature verifies on the port's pure-Python reference,
    each proposal's metadata binds the previous decision's own signatures,
    and the proposals equal the JAX P-256 cluster's."""
    d = {i: (0xC0FFEE + 7919 * i) for i in range(1, 5)}
    engine = EcdsaP256BatchVerifier(device="cpu", min_device_batch=16)
    # With rotation on, each proposal's metadata carries the digest of the
    # previous decision's commit signatures.
    cluster = Cluster(4, seed=SEED, leader_rotation=True)
    signers = {i: EcdsaP256Signer(i, d[i]) for i in cluster.nodes}
    keys = {i: s.public_bytes for i, s in signers.items()}
    for node_id, node in cluster.nodes.items():
        node.app = CryptoApp(node_id, cluster, signers[node_id],
                             P256SigOnlyVerifier(keys, engine=engine))
    jcluster = jtesting.Cluster(4, seed=SEED, leader_rotation=True)
    jsigners = {
        i: jmodels.EcdsaP256Signer(i, ec.derive_private_key(d[i], ec.SECP256R1()))
        for i in jcluster.nodes
    }
    assert {i: s.public_bytes for i, s in jsigners.items()} == keys
    jengine = jmodels.EcdsaP256BatchVerifier(min_device_batch=10**9)
    for node_id, node in jcluster.nodes.items():
        node.app = jtesting.CryptoApp(node_id, jcluster, jsigners[node_id],
                                      JaxP256SigOnlyVerifier(keys, engine=jengine))
    for c, mk in ((cluster, make_request), (jcluster, jtesting.make_request)):
        c.start()
        for i in range(2):
            c.submit_to_all(mk("c", i))
            assert c.run_until_ledger(i + 1, max_time=300.0)
        c.assert_ledgers_consistent()

    for node in cluster.nodes.values():
        ledger = node.app.ledger
        assert len(ledger) == 2
        for k, decision in enumerate(ledger):
            assert len(decision.signatures) >= 3
            for s in decision.signatures:
                assert ref_p256_verify(keys[s.id], s.value, commit_message(decision.proposal, s.msg))
            # The leader (node 1 for both blocks) stamps the digest of the
            # certificate it collected for the previous decision.
            md = twire.decode_view_metadata(decision.proposal.metadata)
            prev = cluster.nodes[1].app.ledger[k - 1].signatures if k else ()
            assert md.prev_commit_signature_digest == commit_signatures_digest(prev)
            assert bool(md.prev_commit_signature_digest) == bool(k)
    for node_id in cluster.nodes:
        port = [_proposal_without_cert_digest(twire, x.proposal) for x in cluster.nodes[node_id].app.ledger]
        jax = [_proposal_without_cert_digest(jwire, x.proposal) for x in jcluster.nodes[node_id].app.ledger]
        assert port == jax
