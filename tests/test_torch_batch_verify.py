"""The port's randomized Ed25519 batch verifier against the JAX package.

``Ed25519RandomizedBatchVerifier`` checks a batch in one aggregate equation
and bisects when it fails; the contract is exact verdict parity with the
strict verifier.  Here the port is held against the JAX package on the same
bytes: the transcript coefficients byte for byte, the digit recoding, the
device body ``batch_verify_impl`` (plain torch on the CPU) at 16 lanes, and
the engine's verdicts on the rejection matrix of tests/test_batch_verify.py
through bisection, on the device path and on the host path.  The wiring
(``engine_for_config``, the mixin, multi-batch coalescing) mirrors the JAX
tests.  Everything runs the port with ``device="cpu"``.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from consensus_tpu.models import ed25519 as jmed
from consensus_tpu_torch.api.deps import Verifier
from consensus_tpu_torch.config import Configuration
from consensus_tpu_torch.models import ed25519 as tmed
from consensus_tpu_torch.models import verifier as tver
from consensus_tpu_torch.testing.crypto_app import SigOnlyVerifier
from consensus_tpu_torch.types import Proposal, QuorumCert

N = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path's tensors are a few dozen lanes wide: one intra-op
    thread runs them faster than many, and leaves the cores to the other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus():
    """64 honest triples from 8 signers (the JAX tests' seeds and messages)."""
    seeds = [hashlib.sha512(b"ctpu/test-bv/%d" % i).digest()[:32] for i in range(8)]
    pubs = [tmed.ref_public_key(s) for s in seeds]
    msgs = [b"batch-verify-%d" % i for i in range(N)]
    sigs = [tmed.ref_sign(seeds[i % 8], m) for i, m in enumerate(msgs)]
    return msgs, sigs, [pubs[i % 8] for i in range(N)]


def _forge(sig: bytes) -> bytes:
    """A flipped low byte of S: still canonical, wrong by math."""
    f = bytearray(sig)
    f[33] ^= 0xFF
    return bytes(f)


def _host_strict():
    return tmed.Ed25519BatchVerifier(device="cpu", min_device_batch=10**9)


def _host_randomized(**kw):
    return tmed.Ed25519RandomizedBatchVerifier(device="cpu", min_device_batch=10**9, **kw)


def _matrix(corpus):
    """Every rejection class in 16 lanes (tests/test_batch_verify.py:146)."""
    msgs, sigs, keys = [list(x[:16]) for x in corpus]
    sigs[1] = _forge(sigs[1])
    msgs[3] = b"tampered"
    keys[5] = keys[6]                                  # valid point, wrong signer
    sigs[7] = b"\xff" * 64                             # S >= L
    keys[9] = b"\x02" + b"\x00" * 31                   # y = 2 is not on the curve
    sigs[11] = b"\x02" + b"\x00" * 31 + sigs[11][32:]  # undecodable R
    return msgs, sigs, keys


def test_transcript_coefficients_are_byte_identical(corpus):
    msgs, sigs, keys = [list(x[:32]) for x in corpus]
    msgs[0], sigs[1], keys[2] = b"", sigs[1][:63], b"\x01" * 33  # odd lengths frame too
    z = tmed._transcript_coefficients(msgs, sigs, keys)
    assert z == jmed._transcript_coefficients(msgs, sigs, keys)
    assert all(1 <= v < 2**128 for v in z)
    assert (tmed._Z_BITS, tmed._Z_WINDOWS, tmed._Z_TAG) == (
        jmed._Z_BITS, jmed._Z_WINDOWS, jmed._Z_TAG
    ) == (128, 33, b"ctpu/batchz/v1")


def test_digit_recodings_match_jax():
    rng = np.random.default_rng(3)
    for windows, bits in ((64, 252), (33, 128)):
        values = [int.from_bytes(rng.bytes(bits // 8 + 1), "little") % (1 << bits) for _ in range(200)]
        values += [0, 1, 7, 8, 15, 16, (1 << bits) - 1, int("8" * (bits // 4), 16)]
        want = [jmed._signed_digits_int(v, windows) for v in values]
        assert [tmed._signed_digits_int(v, windows) for v in values] == want
        rows = tmed._signed_digits_rows(values, windows)
        assert rows.dtype == np.uint8 and rows.shape == (windows, len(values))
        assert np.array_equal(rows.astype(np.int16) - 8, np.array(want, dtype=np.int16).T)
    for too_wide in (1 << 132, 8 << 128):  # past the top window; a top carry
        with pytest.raises(ValueError):
            jmed._signed_digits_int(too_wide, 33)
        with pytest.raises(ValueError):
            tmed._signed_digits_int(too_wide, 33)
        with pytest.raises(ValueError):
            tmed._signed_digits_rows([too_wide], 33)


@pytest.mark.parametrize("honest", [False, True], ids=["forged_and_undecodable", "honest"])
def test_batch_verify_impl_matches_jax(corpus, honest):
    """(eq_ok, valid) of the device body, port (plain torch) against JAX's
    compiled kernel, on the 16-lane inputs the engine builds: with one
    forged and one undecodable lane (the masked lane's z s still sits in the
    comb's scalar, so the check fails and the engine re-checks the
    survivors), and honest."""
    msgs, sigs, keys = [list(x[:16]) for x in corpus]
    if not honest:
        sigs[4] = _forge(sigs[4])
        keys[9] = b"\x02" + b"\x00" * 31
    engine = tmed.Ed25519RandomizedBatchVerifier(device="cpu", pad_to=16)
    host_ok, scalars = engine._host_scalars(msgs, sigs, keys)
    idx = np.flatnonzero(host_ok).tolist()
    zs = tmed._transcript_coefficients(msgs, sigs, keys)
    inputs = engine._aggregate_device_inputs(idx, sigs, keys, scalars, zs)
    eq_ok, valid = tmed.batch_verify_impl(*inputs)
    j_eq, j_valid = jmed._batch_verify_kernel(*(jnp.asarray(t.numpy()) for t in inputs))
    assert bool(eq_ok) == bool(j_eq) == honest
    assert np.array_equal(valid.numpy(), np.asarray(j_valid))
    assert valid.numpy().tolist() == [honest or i != 9 for i in range(16)]


@pytest.mark.parametrize("path", ["device", "host"])
def test_rejection_matrix_matches_jax_and_strict(corpus, path):
    """Every rejection class through bisection: the port's randomized
    verdicts equal JAX's randomized engine's and the port's strict ones."""
    msgs, sigs, keys = _matrix(corpus)
    if path == "device":
        port = tmed.Ed25519RandomizedBatchVerifier(device="cpu", min_device_batch=1, pad_to=16)
        ref = jmed.Ed25519RandomizedBatchVerifier(min_device_batch=1, pad_to=16)
    else:
        port, ref = _host_randomized(), jmed.Ed25519RandomizedBatchVerifier(min_device_batch=10**9)
    expected = _host_strict().verify_batch(msgs, sigs, keys)
    got = port.verify_batch(msgs, sigs, keys)
    assert got.dtype == np.bool_
    assert np.array_equal(got, expected)
    assert np.array_equal(got, np.asarray(ref.verify_batch(msgs, sigs, keys)))
    assert not expected[[1, 3, 5, 7, 9, 11]].any()
    assert expected[[0, 2, 4, 6, 8, 10, 12, 13, 14, 15]].all()


@pytest.mark.parametrize(
    "forged",
    [[37], [3, 17, 40, 41, 50, 62], [0, 31, 32, 63], list(range(64))],
    ids=["one", "several", "boundaries", "all"],
)
def test_forgeries_localized_exactly(corpus, forged):
    msgs, sigs, keys = corpus
    sigs = list(sigs)
    for i in forged:
        sigs[i] = _forge(sigs[i])
    expected = np.ones(N, dtype=bool)
    expected[forged] = False
    assert np.array_equal(_host_strict().verify_batch(msgs, sigs, keys), expected)
    assert np.array_equal(_host_randomized().verify_batch(msgs, sigs, keys), expected)


def test_tiny_batches_delegate_to_strict(corpus):
    msgs, sigs, keys = corpus
    v = _host_randomized()
    assert v.verify_batch([], [], []).shape == (0,)
    assert v.verify_batch(msgs[:1], sigs[:1], keys[:1]).tolist() == [True]
    assert v.verify_batch(msgs[:1], [_forge(sigs[0])], keys[:1]).tolist() == [False]
    with pytest.raises(ValueError):
        v.verify_batch(msgs[:2], sigs[:1], keys[:2])


def test_same_inputs_same_verdicts(corpus):
    msgs, sigs, keys = [list(x[:32]) for x in corpus]
    sigs[10] = _forge(sigs[10])
    a = _host_randomized().verify_batch(msgs, sigs, keys)
    b = _host_randomized().verify_batch(msgs, sigs, keys)
    assert np.array_equal(a, b) and a.sum() == 31
    z1 = tmed._transcript_coefficients(msgs, sigs, keys)
    assert z1 == tmed._transcript_coefficients(msgs, sigs, keys)
    # The transcript binds content and position.
    assert tmed._transcript_coefficients(msgs[::-1], sigs[::-1], keys[::-1]) != z1


# --- the multi-batch coalescing seam ------------------------------------------


class _SpyMixin:
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.launches = 0

    def verify_batch(self, msgs, sigs, keys):
        self.launches += 1
        return super().verify_batch(msgs, sigs, keys)


class _SpyRandomized(_SpyMixin, tmed.Ed25519RandomizedBatchVerifier):
    pass


class _SpyStrict(_SpyMixin, tmed.Ed25519BatchVerifier):
    pass


class _Facade(Verifier):
    """A Verifier-port facade over an inner signature verifier that leaves
    multi-batch to the port's default (the shape of CryptoApp)."""

    def __init__(self, inner):
        self._inner = inner
        self.multi_batch_delegate = inner
        self.batch_verify_enabled = inner.batch_verify_enabled

    def verify_proposal(self, proposal):
        raise NotImplementedError

    def verify_request(self, raw):
        raise NotImplementedError

    def verify_consenter_sig(self, signature, proposal):
        return self._inner.verify_consenter_sig(signature, proposal)

    def verify_signature(self, signature):
        raise NotImplementedError

    def verification_sequence(self):
        return 0

    def requests_from_proposal(self, proposal):
        return []

    def verify_consenter_sigs_batch(self, signatures, proposal):
        return self._inner.verify_consenter_sigs_batch(signatures, proposal)


def _quorum_groups(n_groups=3):
    signers = {
        i: tver.Ed25519Signer(i, hashlib.sha512(b"ctpu/test-mb/%d" % i).digest()[:32])
        for i in (1, 2, 3, 4)
    }
    keys = {i: s.public_bytes for i, s in signers.items()}
    groups = []
    for g in range(n_groups):
        proposal = Proposal(payload=b"blk-%d" % g, metadata=b"md")
        groups.append((proposal, [signers[i].sign_proposal(proposal, b"aux") for i in (1, 2, 3)]))
    return keys, groups


def test_multi_batch_coalesces_to_one_engine_call():
    keys, groups = _quorum_groups()
    spy = _SpyRandomized(device="cpu", min_device_batch=10**9)
    out = _Facade(SigOnlyVerifier(keys, engine=spy)).verify_consenter_sigs_multi_batch(groups)
    assert spy.launches == 1
    assert out == [[b"aux"] * 3] * 3
    # A strict engine keeps the Verifier port's per-group loop.
    strict_spy = _SpyStrict(device="cpu", min_device_batch=10**9)
    facade = _Facade(SigOnlyVerifier(keys, engine=strict_spy))
    assert facade.verify_consenter_sigs_multi_batch(groups) == out
    assert strict_spy.launches == 3


def test_multi_batch_coalesced_rejections_localized():
    keys, groups = _quorum_groups()
    bad = groups[1][1][2]
    groups[1][1][2] = type(bad)(id=bad.id, value=_forge(bad.value), msg=bad.msg)
    groups[2][1][0] = type(bad)(id=9, value=groups[2][1][0].value, msg=b"aux")  # unknown signer
    spy = _SpyRandomized(device="cpu", min_device_batch=10**9)
    out = _Facade(SigOnlyVerifier(keys, engine=spy)).verify_consenter_sigs_multi_batch(groups)
    assert spy.launches == 1
    assert out == [[b"aux"] * 3, [b"aux", b"aux", None], [None, b"aux", b"aux"]]
    assert SigOnlyVerifier(keys, engine=spy).verify_consenter_sigs_multi_batch([]) == []


def test_multi_batch_rejects_mixed_cert_kinds():
    keys, groups = _quorum_groups(2)
    cert = QuorumCert(signer_ids=(1,), rs=(bytes(32),), s_agg=bytes(32),
                      aux_table=(b"",), aux_index=(0,))
    verifier = SigOnlyVerifier(keys, engine=_host_randomized())
    with pytest.raises(ValueError, match="mix"):
        verifier.verify_consenter_sigs_multi_batch([groups[0], (groups[1][0], cert)])
    # All half-aggregated: each cert on its own, rejected until half-aggregation.
    assert verifier.verify_consenter_sigs_multi_batch([(groups[1][0], cert)]) == [[None]]


def test_engine_for_config_routes_the_randomized_lane(monkeypatch):
    engine = tver.engine_for_config(Configuration(batch_verify_mode=True), device="cpu")
    assert type(engine) is tmed.Ed25519RandomizedBatchVerifier and engine.randomized
    assert engine._min_device_batch == 16 and engine.padded_size(7000) == 8192
    assert engine.device.type == "cpu"
    with pytest.raises(ValueError, match="Ed25519-only"):
        tver.engine_for_config(Configuration(batch_verify_mode=True), "p256", device="cpu")
    strict = tver.engine_for_config(Configuration(), device="cpu")
    assert not SigOnlyVerifier({}, engine=strict).batch_verify_enabled
    assert SigOnlyVerifier({}, engine=engine).batch_verify_enabled
    assert SigOnlyVerifier({}, engine=engine, batch_verify_mode=True).engine is engine
    with pytest.raises(ValueError, match="randomized"):
        SigOnlyVerifier({}, engine=strict, batch_verify_mode=True)
    # The lane runs on the card unless asked for the CPU, and raises without one.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tver.engine_for_config(Configuration(batch_verify_mode=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SigOnlyVerifier({}, batch_verify_mode=True)
