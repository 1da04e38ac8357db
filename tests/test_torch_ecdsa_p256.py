"""The port's ECDSA-P256 engine, signer and Verifier-port mixin against the
JAX package.

One 16-lane rejection matrix -- every rejection class of the JAX engine's
``_prepare`` and device checks, plus the accepted high-s twin -- goes
through JAX ``EcdsaP256BatchVerifier`` and the port's engine on both of its
paths; the host arrays, the verdicts and the ``r + n < p`` branch of
``verify_impl`` are held against JAX's.  The pure-Python RFC 6979 signer is
held byte for byte against ``cryptography``'s deterministic ECDSA where that
package is installed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consensus_tpu.config import Configuration as JaxConfiguration
from consensus_tpu.models import ecdsa_p256 as jmodel
from consensus_tpu.models import verifier as jver
from consensus_tpu.types import Proposal as JaxProposal
from consensus_tpu.types import Signature as JaxSignature
from consensus_tpu_torch.config import Configuration
from consensus_tpu_torch.models import ecdsa_p256 as tmodel
from consensus_tpu_torch.models import verifier as tver
from consensus_tpu_torch.models.supervisor import EngineSupervisor
from consensus_tpu_torch.types import Proposal, Signature

N = tmodel.N
P = tmodel.fp.P
LANES = 16

#: (class, expected verdict) per lane of the matrix.
MATRIX = (
    ("valid", True), ("valid", True), ("high_s", True), ("sig_length_63", False),
    ("key_length_64", False), ("key_prefix_02", False), ("r_zero", False),
    ("r_eq_n", False), ("s_zero", False), ("s_eq_n", False), ("qx_ge_p", False),
    ("qy_ge_p", False), ("off_curve", False), ("wrong_key", False),
    ("wrong_message", False), ("sig_length_65", False),
)


def _corpus():
    rng = np.random.default_rng(41)
    privs = [int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1 for _ in range(LANES)]
    keys = [tmodel.ref_p256_public_key(d) for d in privs]
    msgs = [b"p256-request-%d" % i + rng.bytes(24) for i in range(LANES)]
    sigs = [tmodel.ref_p256_sign(d, m) for d, m in zip(privs, msgs)]
    for i, (kind, _) in enumerate(MATRIX):
        r, s = sigs[i][:32], sigs[i][32:]
        x, y = keys[i][1:33], keys[i][33:]
        if kind == "high_s":
            sigs[i] = r + (N - int.from_bytes(s, "big")).to_bytes(32, "big")
        elif kind == "sig_length_63":
            sigs[i] = sigs[i][:63]
        elif kind == "sig_length_65":
            sigs[i] = sigs[i] + b"\x00"
        elif kind == "key_length_64":
            keys[i] = keys[i][:64]
        elif kind == "key_prefix_02":
            keys[i] = b"\x02" + x + y
        elif kind == "r_zero":
            sigs[i] = bytes(32) + s
        elif kind == "r_eq_n":
            sigs[i] = N.to_bytes(32, "big") + s
        elif kind == "s_zero":
            sigs[i] = r + bytes(32)
        elif kind == "s_eq_n":
            sigs[i] = r + N.to_bytes(32, "big")
        elif kind == "qx_ge_p":
            keys[i] = b"\x04" + P.to_bytes(32, "big") + y
        elif kind == "qy_ge_p":
            keys[i] = b"\x04" + x + (P + 1).to_bytes(32, "big")
        elif kind == "off_curve":
            keys[i] = b"\x04" + x + ((int.from_bytes(y, "big") + 1) % P).to_bytes(32, "big")
        elif kind == "wrong_key":
            keys[i] = keys[0]
        elif kind == "wrong_message":
            msgs[i] = msgs[i][:-1] + bytes([msgs[i][-1] ^ 1])
    return msgs, sigs, keys, privs


@pytest.fixture(scope="module")
def matrix():
    msgs, sigs, keys, privs = _corpus()
    engine = tmodel.EcdsaP256BatchVerifier(device="cpu")
    return {
        "msgs": msgs, "sigs": sigs, "keys": keys, "privs": privs,
        "expected": np.array([ok for _, ok in MATRIX]),
        "jax_device": np.asarray(
            jmodel.EcdsaP256BatchVerifier(min_device_batch=1).verify_batch(msgs, sigs, keys)
        ),
        "port_device": engine.verify_batch(msgs, sigs, keys),
        "port_host": engine.verify_host(msgs, sigs, keys),
    }


def test_host_prep_arrays_match_jax(matrix):
    args = (matrix["msgs"], matrix["sigs"], matrix["keys"])
    want = jmodel.EcdsaP256BatchVerifier()._prepare(*args)
    got = tmodel.EcdsaP256BatchVerifier(device="cpu")._prepare(*args)
    assert len(got) == len(want) == 8
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g)
    padded_w = jmodel.pad_prepared(want, 32)
    padded_g = tmodel.pad_prepared(got, 32)
    for w, g in zip(jmodel.to_kernel_layout(*padded_w), tmodel.to_kernel_layout(*padded_g)):
        w = np.asarray(w)
        assert w.shape == g.shape and w.dtype == g.dtype and np.array_equal(w, g)


@pytest.mark.parametrize("path", ["port_device", "port_host"])
def test_verdicts_equal_jax_on_the_rejection_matrix(matrix, path):
    np.testing.assert_array_equal(matrix["jax_device"], matrix["expected"])
    np.testing.assert_array_equal(matrix[path], matrix["jax_device"])


def test_host_verdicts_equal_jax_host_path(matrix):
    pytest.importorskip("cryptography", reason="the JAX host path needs cryptography")
    args = (matrix["msgs"], matrix["sigs"], matrix["keys"])
    jax_host = jmodel.EcdsaP256BatchVerifier(min_device_batch=10**9).verify_batch(*args)
    np.testing.assert_array_equal(matrix["port_host"], jax_host)


def test_compressed_keys_are_rejected_not_decompressed(matrix):
    """The device path rejects a compressed SEC1 key (length 33, prefix 2 or
    3), and the port's host path keeps that rule; JAX's host path goes
    through ``cryptography``, which decompresses it (ROADMAP C)."""
    msg, sig, key = matrix["msgs"][0], matrix["sigs"][0], matrix["keys"][0]
    compressed = bytes([2 + (key[-1] & 1)]) + key[1:33]
    engine = tmodel.EcdsaP256BatchVerifier(device="cpu")
    assert not engine.verify_host([msg], [sig], [compressed])[0]
    assert not tmodel.ref_p256_verify(compressed, sig, msg)
    prepped = engine._prepare([msg], [sig], [compressed])
    assert not prepped[-1][0]  # host_ok: never reaches the device
    pytest.importorskip("cryptography", reason="the JAX host path needs cryptography")
    jax_host = jmodel.EcdsaP256BatchVerifier(min_device_batch=10**9)
    assert jax_host.verify_batch([msg], [sig], [compressed])[0]


def _second_candidate_inputs(matrix):
    """The matrix's 16-lane kernel inputs (JAX layout, as numpy) with lanes
    0-3 replaced by a hand-built case of x(R') in [n, p): Q on the curve
    with x in [n, p), u1 = 0, u2 = 1, so R' = Q and r = x - n.  Lane 0
    accepts through the r + n candidate, lane 1 has it switched off, lane 2
    carries a wrong r + n, lane 3 matches r directly."""
    x = N
    while True:
        rhs = (x * x * x - 3 * x + tmodel.p256.B) % P
        y = pow(rhs, (P + 1) // 4, P)
        if y * y % P == rhs and x + 1 < P:
            break
        x += 1
    prepped = jmodel.EcdsaP256BatchVerifier()._prepare(
        matrix["msgs"], matrix["sigs"], matrix["keys"]
    )
    arrays = [np.array(a) for a in jmodel.to_kernel_layout(*jmodel.pad_prepared(prepped, LANES))]
    qx, qy, u1d, u2d, r1, r2, has_r2, host_ok = arrays

    def limbs(v):
        return np.frombuffer(v.to_bytes(32, "little"), dtype=np.uint8)

    u2_one = tmodel._scalars_to_signed_window_digits([1])[:, 0]
    for lane, (r_val, r2_val, second) in enumerate(
        [(x - N, x, True), (x - N, x, False), (x - N, x + 1, True), (x, 0, False)]
    ):
        qx[:, lane], qy[:, lane] = limbs(x), limbs(y)
        u1d[:, lane], u2d[:, lane] = 0, u2_one
        r1[:, lane], r2[:, lane] = limbs(r_val), limbs(r2_val)
        has_r2[lane], host_ok[lane] = second, True
    return arrays


def test_second_candidate_branch_matches_jax_verify_impl(matrix):
    arrays = _second_candidate_inputs(matrix)
    want = np.asarray(jmodel._verify_kernel(*(jnp.asarray(a) for a in arrays)))
    got = tmodel.verify_impl(*tmodel.kernel_inputs_from_numpy(arrays, "cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:4].tolist() == [True, False, False, True]


def test_rfc6979_signatures_are_byte_identical_to_cryptography():
    pytest.importorskip("cryptography", reason="the reference signer needs cryptography")
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec

    rng = np.random.default_rng(43)
    for d in [1, 2, N - 1] + [int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1 for _ in range(3)]:
        sk = ec.derive_private_key(d, ec.SECP256R1())
        assert tmodel.ref_p256_public_key(d) == sk.public_key().public_bytes(
            serialization.Encoding.X962, serialization.PublicFormat.UncompressedPoint
        )
        for msg in (b"", b"sample", rng.bytes(200)):
            der = sk.sign(msg, ec.ECDSA(hashes.SHA256(), deterministic_signing=True))
            assert tmodel.ref_p256_sign(d, msg) == jmodel.raw_signature_from_der(der)
    with pytest.raises(ValueError):
        tmodel.ref_p256_sign(0, b"m")
    with pytest.raises(ValueError):
        tmodel.ref_p256_public_key(N)


def test_der_decoding_matches_jax():
    pytest.importorskip("cryptography", reason="JAX's DER decoder needs cryptography")
    from cryptography.hazmat.primitives.asymmetric.utils import encode_dss_signature

    for r, s in [(1, 1), (N - 1, N - 1), (0x80, 0x7F), (2**255, 2**200 + 3), (255, 2**248)]:
        der = encode_dss_signature(r, s)
        assert tmodel.raw_signature_from_der(der) == jmodel.raw_signature_from_der(der)
    good = encode_dss_signature(5, 7)
    for bad in (
        b"", b"\x31" + good[1:], good + b"\x00", good[:-1],
        b"\x30\x06\x02\x01\x85\x02\x01\x07",        # a negative r
        b"\x30\x07\x02\x02\x00\x05\x02\x01\x07",    # a non-minimal r
        b"\x30\x81\x06\x02\x01\x05\x02\x01\x07",    # a non-minimal length
    ):
        with pytest.raises(ValueError):
            jmodel.raw_signature_from_der(bad)
        with pytest.raises(ValueError):
            tmodel.raw_signature_from_der(bad)


class _SigOnly(tver.EcdsaP256VerifierMixin):
    def verify_proposal(self, proposal):
        return []

    def verify_request(self, raw):
        raise NotImplementedError

    def verification_sequence(self):
        return 0

    def requests_from_proposal(self, proposal):
        return []


def test_quorum_through_the_mixin_on_the_host_path():
    signers = {i: tver.EcdsaP256Signer(i, bytes([i]) * 32) for i in (1, 2, 3)}
    assert signers[1].public_bytes == tver.EcdsaP256Signer(1, int.from_bytes(b"\x01" * 32, "big")).public_bytes
    engine = tver.engine_for_config(Configuration(), curve="p256", device="cpu")
    verifier = _SigOnly({i: s.public_bytes for i, s in signers.items()}, engine=engine)
    assert verifier.engine is engine and not verifier.supports_cert_aggregation
    proposal = Proposal(payload=b"batch", metadata=b"view-0/seq-1")
    votes = [signers[i].sign_proposal(proposal, b"aux-%d" % i) for i in (1, 2, 3)]
    # 2f + 1 = 3 votes are below crypto_tpu_min_batch: the host path.
    assert len(votes) < Configuration().crypto_tpu_min_batch
    assert verifier.verify_consenter_sigs_batch(votes, proposal) == [b"aux-1", b"aux-2", b"aux-3"]
    tampered = Signature(id=1, value=votes[0].value, msg=b"other-aux")
    stranger = Signature(id=9, value=votes[0].value, msg=votes[0].msg)
    assert verifier.verify_consenter_sigs_batch([tampered, stranger], proposal) == [None, None]
    data = b"view-data"
    verifier.verify_signature(Signature(id=2, value=signers[2].sign(data), msg=data))
    with pytest.raises(ValueError):
        verifier.verify_signature(Signature(id=2, value=bytes(64), msg=data))


def test_votes_cross_verify_between_the_packages():
    """A vote signed by the port verifies in the JAX mixin (its host path)
    and a vote signed by the JAX package verifies in the port's mixin: the
    message binding is byte-identical."""
    pytest.importorskip("cryptography", reason="the JAX signer needs cryptography")

    class _JaxSigOnly(jver.EcdsaP256VerifierMixin):
        verify_proposal = _SigOnly.verify_proposal
        verify_request = _SigOnly.verify_request
        verification_sequence = _SigOnly.verification_sequence
        requests_from_proposal = _SigOnly.requests_from_proposal

    port_signer = tver.EcdsaP256Signer(1, 12345)
    jax_signer = jver.EcdsaP256Signer(2)
    keys = {1: port_signer.public_bytes, 2: jax_signer.public_bytes}
    jax_verifier = _JaxSigOnly(
        keys, engine=jmodel.EcdsaP256BatchVerifier(min_device_batch=10**9)
    )
    port_verifier = _SigOnly(keys, engine=tmodel.EcdsaP256BatchVerifier(device="cpu", min_device_batch=16))
    port_vote = port_signer.sign_proposal(Proposal(payload=b"b"), b"x")
    jax_vote = jax_signer.sign_proposal(JaxProposal(payload=b"b"), b"y")
    assert jax_verifier.verify_consenter_sigs_batch(
        [JaxSignature(id=1, value=port_vote.value, msg=port_vote.msg)], JaxProposal(payload=b"b")
    ) == [b"x"]
    assert port_verifier.verify_consenter_sigs_batch(
        [Signature(id=2, value=jax_vote.value, msg=jax_vote.msg)], Proposal(payload=b"b")
    ) == [b"y"]


def test_engine_for_config_routes_p256_and_raises_like_jax():
    engine = tver.engine_for_config(Configuration(), curve="p256", device="cpu")
    assert isinstance(engine, tmodel.EcdsaP256BatchVerifier)
    assert engine.device.type == "cpu" and engine._min_device_batch == 16
    assert engine.padded_size(2000) == 2048
    unpadded = tver.engine_for_config(Configuration(crypto_pad_pow2=False), curve="p256", device="cpu")
    assert unpadded.padded_size(2000) == 2000
    for knobs in (dict(batch_verify_mode=True), dict(device_prep=True)):
        with pytest.raises(ValueError) as port_err:
            tver.engine_for_config(Configuration(**knobs), curve="p256", device="cpu")
        with pytest.raises(ValueError) as jax_err:
            jver.engine_for_config(JaxConfiguration(self_id=1, **knobs), curve="p256")
        assert str(port_err.value) in str(jax_err.value)
        assert "Ed25519-only" in str(port_err.value)
    sharded = tver.engine_for_config(Configuration(mesh_shards=2), curve="p256", device="cpu")
    assert type(sharded).__name__ == "ShardedEcdsaP256Verifier" and sharded.shard_count == 2
    supervised = tver.engine_for_config(
        Configuration(engine_supervision=True), curve="p256", device="cpu"
    )
    assert isinstance(supervised, EngineSupervisor)
    assert [supervised.rung_label(i) for i in range(supervised.rung_count)] == [
        "EcdsaP256BatchVerifier", "HostTwin",
    ]


def test_default_p256_engine_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tver.engine_for_config(Configuration(), curve="p256")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.EcdsaP256BatchVerifier()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _SigOnly({})


def test_padding_and_empty_batches():
    msgs, sigs, keys, _ = _corpus()
    engine = tmodel.EcdsaP256BatchVerifier(device="cpu", pad_to=16)
    assert engine.padded_size(5) == 16 and engine.padded_size(17) == 32
    assert engine.verify_batch([], [], []).shape == (0,)
    with pytest.raises(ValueError):
        engine.verify_batch(msgs, sigs[:4], keys)
    host = tmodel.EcdsaP256BatchVerifier(device="cpu", min_device_batch=10**9)
    assert host.verify_batch(msgs[:3], sigs[:3], keys[:3]).tolist() == [True, True, True]
