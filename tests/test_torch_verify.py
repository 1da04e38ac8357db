"""The port's strict Ed25519 slice end to end against the JAX package.

Verdicts of ``Ed25519BatchVerifier.verify_batch`` from both packages are
compared on the RFC 8032 vectors and on the rejection matrix of
tests/test_crypto.py at n = 8 (the shape the JAX tests already compile);
host prep, kernel layout, signing, message binding and the Verifier-port
mixin are compared byte for byte.  Everything here runs the port with
``device="cpu"``; the card-only tests are in tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from consensus_tpu.config import Configuration as JaxConfiguration
from consensus_tpu.models import ed25519 as jmed
from consensus_tpu.models import verifier as jver
from consensus_tpu.types import Proposal as JaxProposal
from consensus_tpu_torch.config import Configuration
from consensus_tpu_torch.models.ecdsa_p256 import EcdsaP256BatchVerifier
from consensus_tpu_torch.models import ed25519 as tmed
from consensus_tpu_torch.models import verifier as tver
from consensus_tpu_torch.models.registry import UnknownEngineError
from consensus_tpu_torch.models.supervisor import EngineSupervisor
from consensus_tpu_torch.testing.crypto_app import SigOnlyVerifier
from consensus_tpu_torch.types import Proposal, QuorumCert, Signature

P = 2**255 - 19
L = tmed.L


def _corpus(n, seed=0, prefix=b"m"):
    rng = np.random.default_rng(seed)
    seeds = [rng.bytes(32) for _ in range(n)]
    keys = [tmed.ref_public_key(s) for s in seeds]
    msgs = [prefix + b"-%d" % i for i in range(n)]
    sigs = [tmed.ref_sign(s, m) for s, m in zip(seeds, msgs)]
    return msgs, sigs, keys


RFC8032 = [
    (
        "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
        "",
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
        "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b",
    ),
    (
        "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
        "72",
        "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
        "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00",
    ),
    (
        "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
        "af82",
        "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
        "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a",
    ),
]


def _matrix_a():
    """Corruption modes of test_valid_batch_and_each_corruption_mode plus
    S >= L, a wrong message and a wrong key, at n = 8."""
    msgs, sigs, keys = _corpus(8, seed=1)
    sigs[0] = bytes([sigs[0][0] ^ 1]) + sigs[0][1:]            # flipped R byte
    sigs[1] = sigs[1][:32] + bytes(32)                         # S = 0
    sigs[2] = b"short"                                         # bad length
    sigs[3] = sigs[3][:63] + bytes([sigs[3][63] ^ 0x40])       # flipped S bit
    s = int.from_bytes(sigs[4][32:], "little")
    sigs[4] = sigs[4][:32] + (s + L).to_bytes(32, "little")    # S >= L
    msgs[5] = b"x" + msgs[5]                                   # wrong message
    keys[6] = keys[7]                                          # wrong key
    return msgs, sigs, keys                                    # lane 7 valid


def _matrix_b():
    """The edge-case vectors of test_host_and_device_agree_on_edge_case_vectors."""
    msgs, sigs, keys = _corpus(8, seed=2)
    sigs[0] = (P + 1).to_bytes(32, "little") + sigs[0][32:]    # R with y >= p
    keys[1] = (P + 2).to_bytes(32, "little")                   # A with y >= p
    sigs[2] = sigs[2][:32] + L.to_bytes(32, "little")          # S = L
    sigs[3] = sigs[3][:32] + (L - 1).to_bytes(32, "little")    # S = L - 1, wrong
    keys[4] = (1).to_bytes(32, "little")                       # small-order A
    sigs[5] = (1).to_bytes(32, "little") + sigs[5][32:]        # small-order R
    keys[6] = bytes(31) + b"\x80"                              # y = 0, sign set
    return msgs, sigs, keys                                    # lane 7 valid


@pytest.fixture(scope="module")
def engines():
    return tmed.Ed25519BatchVerifier(device="cpu"), jmed.Ed25519BatchVerifier()


def test_rfc8032_vectors_match_jax(engines):
    port, ref = engines
    keys = [bytes.fromhex(pk) for pk, _, _ in RFC8032]
    msgs = [bytes.fromhex(m) for _, m, _ in RFC8032]
    sigs = [bytes.fromhex(s) for _, _, s in RFC8032]
    got = port.verify_batch(msgs, sigs, keys)
    assert got.dtype == bool and got.shape == (3,) and got.all()
    np.testing.assert_array_equal(got, ref.verify_batch(msgs, sigs, keys))


@pytest.mark.parametrize("matrix", [_matrix_a, _matrix_b], ids=["corruptions", "edge_cases"])
def test_rejection_matrix_matches_jax_host_and_reference(engines, matrix):
    port, ref = engines
    msgs, sigs, keys = matrix()
    got = port.verify_batch(msgs, sigs, keys)
    np.testing.assert_array_equal(got, ref.verify_batch(msgs, sigs, keys))
    np.testing.assert_array_equal(got, port.verify_host(msgs, sigs, keys))
    want = [
        bool(ok) and tmed.ref_verify(k, s, m)
        for ok, m, s, k in zip(tmed.Ed25519BatchVerifier._canonical_ok(sigs, keys), msgs, sigs, keys)
    ]
    assert got.tolist() == want
    assert got[7] and not got[:4].any()


def test_host_prep_and_kernel_layout_match_jax():
    msgs, sigs, keys = _matrix_b()
    jp = jmed.Ed25519BatchVerifier()._prepare(msgs, sigs, keys)
    tp = tmed.Ed25519BatchVerifier(device="cpu")._prepare(msgs, sigs, keys)
    for j, t in zip(jp, tp):
        np.testing.assert_array_equal(j, t)
        assert j.dtype == t.dtype
    for j, t in zip(jmed.to_kernel_layout(*jp), tmed.to_kernel_layout(*tp)):
        np.testing.assert_array_equal(np.asarray(j), t)
        assert np.asarray(j).dtype == t.dtype


def test_kernel_inputs_from_numpy_gives_jax_verdicts():
    """The same prepared inputs, shipped from JAX's layout through
    kernel_inputs_from_numpy, give the JAX kernel body's verdicts."""
    msgs, sigs, keys = _matrix_a()
    arrays = jmed.to_kernel_layout(*jmed.Ed25519BatchVerifier()._prepare(msgs, sigs, keys))
    want = np.asarray(jmed._verify_kernel(*arrays))
    inputs = tmed.kernel_inputs_from_numpy([np.asarray(a) for a in arrays], "cpu")
    assert [t.dtype for t in inputs] == [torch.uint8] * 6 + [torch.bool]
    got = tmed.verify_impl(*inputs).numpy()
    np.testing.assert_array_equal(got, want)


def test_signing_and_message_binding_are_byte_identical():
    rng = np.random.default_rng(5)
    for _ in range(3):
        seed, msg = rng.bytes(32), rng.bytes(int(rng.integers(0, 80)))
        assert tmed.ref_public_key(seed) == jmed.ref_public_key(seed)
        assert tmed.ref_sign(seed, msg) == jmed.ref_sign(seed, msg)
    fields = dict(payload=b"batch", header=b"h", metadata=b"md", verification_sequence=3)
    tp, jp = Proposal(**fields), JaxProposal(**fields)
    assert tp.digest() == jp.digest()
    assert tver.commit_message(tp, b"aux") == jver.commit_message(jp, b"aux")
    assert tver.raw_message(b"view-data") == jver.raw_message(b"view-data")
    seed = bytes(range(32))
    ts, js = tver.Ed25519Signer(4, seed), jver.Ed25519Signer(4, seed)
    assert ts.public_bytes == js.public_bytes
    t_sig, j_sig = ts.sign_proposal(tp, b"aux"), js.sign_proposal(jp, b"aux")
    assert (t_sig.id, t_sig.value, t_sig.msg) == (j_sig.id, j_sig.value, j_sig.msg)
    assert ts.sign(b"data") == js.sign(b"data")


class TestVerifierPort:
    def _quorum(self, engine):
        signers = {i: tver.Ed25519Signer(i, bytes([i]) * 32) for i in (1, 2, 3, 4)}
        verifier = SigOnlyVerifier({i: s.public_bytes for i, s in signers.items()}, engine=engine)
        return signers, verifier

    @pytest.mark.parametrize("min_device_batch", [1, 16], ids=["device_path", "host_path"])
    def test_sign_proposal_then_batch_verify_quorum(self, min_device_batch):
        engine = tver.engine_for_config(
            Configuration(crypto_tpu_min_batch=min_device_batch), device="cpu"
        )
        signers, verifier = self._quorum(engine)
        proposal = Proposal(payload=b"batch", metadata=b"md")
        sigs = [signers[i].sign_proposal(proposal, b"aux-%d" % i) for i in (2, 3, 4)]
        assert verifier.verify_consenter_sigs_batch(sigs, proposal) == [b"aux-2", b"aux-3", b"aux-4"]
        tampered = Signature(id=2, value=sigs[0].value, msg=b"aux-x")
        assert verifier.verify_consenter_sigs_batch([tampered], proposal) == [None]
        other = Proposal(payload=b"other")
        assert verifier.verify_consenter_sigs_batch(sigs, other) == [None] * 3
        unknown = tver.Ed25519Signer(9, bytes([9]) * 32).sign_proposal(proposal)
        assert verifier.verify_consenter_sigs_batch([unknown], proposal) == [None]
        assert verifier.verify_consenter_sig(sigs[1], proposal) == b"aux-3"
        with pytest.raises(ValueError):
            verifier.verify_consenter_sig(tampered, proposal)

    def test_verify_signature_and_triples(self):
        signers, verifier = self._quorum(tmed.Ed25519BatchVerifier(device="cpu"))
        data = b"view-data-bytes"
        verifier.verify_signature(Signature(id=3, value=signers[3].sign(data), msg=data))
        with pytest.raises(ValueError):
            verifier.verify_signature(Signature(id=3, value=bytes(64), msg=data))
        with pytest.raises(ValueError):
            verifier.verify_signature(Signature(id=8, value=bytes(64), msg=data))
        proposal = Proposal(payload=b"p")
        sigs = [signers[1].sign_proposal(proposal), Signature(id=8, value=bytes(64))]
        msgs, values, keys, known = verifier.consenter_sig_triples(sigs, proposal)
        assert msgs[0] == tver.commit_message(proposal, b"") and known == [True, False]
        assert keys[1] == b"" and values[0] == sigs[0].value
        cert = QuorumCert(signer_ids=(1,), rs=(bytes(32),), s_agg=bytes(32),
                          aux_table=(b"",), aux_index=(0,))
        assert verifier.verify_consenter_sigs_batch(cert, proposal) == [None]
        with pytest.raises(ValueError):
            verifier.consenter_sig_triples(cert, proposal)


def test_engine_for_config_default_and_unported_lanes():
    engine = tver.engine_for_config(Configuration(), device="cpu")
    assert type(engine) is tmed.Ed25519BatchVerifier
    assert engine._min_device_batch == 16 and engine._pad_pow2 and engine.padded_size(7000) == 8192
    # Every field, nested ones (trace, compile_cache) by value.
    assert [f.name for f in dataclasses.fields(Configuration)] == [
        f.name for f in dataclasses.fields(JaxConfiguration)
    ]
    assert dataclasses.asdict(Configuration()) == dataclasses.asdict(JaxConfiguration())
    # device_prep is ported: it routes to the fused engine (its lane is
    # pinned in tests/test_torch_fused.py); the mesh lanes are not.
    fused = tver.engine_for_config(Configuration(device_prep=True), device="cpu")
    assert type(fused).__name__ == "FusedEd25519BatchVerifier"
    assert isinstance(fused, tmed.Ed25519BatchVerifier) and fused._min_device_batch == 16
    for knobs, item in (
        (dict(mesh_shards=2), "item 12"),
        (dict(mesh_topology=(2, 4)), "item 12"),
        (dict(mesh_shards=2, device_prep=True), "item 12"),
    ):
        with pytest.raises(UnknownEngineError, match=f"ROADMAP.md queue A, {item}"):
            tver.engine_for_config(Configuration(**knobs), device="cpu")
    # Supervision is ported: the configured engine over the host twin.
    supervised = tver.engine_for_config(Configuration(engine_supervision=True), device="cpu")
    assert isinstance(supervised, EngineSupervisor)
    assert [supervised.rung_label(i) for i in range(supervised.rung_count)] == [
        "Ed25519BatchVerifier", "HostTwin",
    ]
    # P-256 and the randomized lane are ported: their configurations route to
    # their engines (their own lanes are pinned in tests/test_torch_ecdsa_p256.py
    # and tests/test_torch_batch_verify.py).
    assert isinstance(
        tver.engine_for_config(Configuration(), "p256", device="cpu"),
        EcdsaP256BatchVerifier,
    )
    assert isinstance(
        tver.engine_for_config(Configuration(batch_verify_mode=True), device="cpu"),
        tmed.Ed25519RandomizedBatchVerifier,
    )
    with pytest.raises(ValueError):
        tver.engine_for_config(Configuration(), "ed448", device="cpu")
    # A strict engine with batch_verify_mode is a contradiction, as in JAX.
    with pytest.raises(ValueError, match="randomized"):
        SigOnlyVerifier({}, engine=engine, batch_verify_mode=True)


@pytest.mark.parametrize(
    "knobs",
    [dict(mesh_shards=0), dict(mesh_topology=(0,)), dict(mesh_shards=4, mesh_topology=(2, 3)),
     dict(engine_crosscheck_interval=-1), dict(engine_crosscheck_interval=2),
     dict(crypto_tpu_min_batch=0)],
)
def test_configuration_validate_matches_jax(knobs):
    with pytest.raises(ValueError) as port_err:
        Configuration(self_id=1, **knobs).validate()
    with pytest.raises(ValueError) as jax_err:
        JaxConfiguration(self_id=1, **knobs).validate()
    assert str(port_err.value) == str(jax_err.value)


def test_default_device_engine_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmed.Ed25519BatchVerifier()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tver.engine_for_config(Configuration())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SigOnlyVerifier({})


def test_padding_returns_exact_length():
    msgs, sigs, keys = _corpus(5, seed=3)
    for engine in (
        tmed.Ed25519BatchVerifier(device="cpu", pad_pow2=False),
        tmed.Ed25519BatchVerifier(device="cpu", pad_to=16),
    ):
        ok = engine.verify_batch(msgs, sigs, keys)
        assert ok.shape == (5,) and ok.all()
    assert tmed.Ed25519BatchVerifier(device="cpu", pad_to=16).padded_size(5) == 16
    assert tmed.Ed25519BatchVerifier(device="cpu", pad_to=16).padded_size(17) == 32
    assert tmed.Ed25519BatchVerifier(device="cpu").verify_batch([], [], []).shape == (0,)
    with pytest.raises(ValueError):
        tmed.Ed25519BatchVerifier(device="cpu").verify_batch(msgs, sigs[:4], keys)
