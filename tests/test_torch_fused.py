"""The port's fused bytes-in -> verdict-out engines (``device_prep``,
``consensus_tpu_torch/models/fused.py``) held against the host-prep engines
and the JAX package's fused module, on the CPU.

``tests/test_fused.py`` mirrored, less its sharded case (in
``tests/test_torch_mesh.py``): the vectorized pre-checks equal the loop twin; the
device transcript equals the host coefficients byte for byte (batch and
half-agg tags); the fused front end's stages (challenge digests, reduced
scalars, window digits, canonical checks) equal the JAX module's on the
same wave; the rejection matrix's verdicts are bit-identical to the port's
and the JAX package's host-prep engines; one ledger entry per fused wave
and per aggregate check; ``verify_stream`` keeps wave order; the registry
routes ``device_prep``.  JAX's fused engines themselves compile their
graphs for minutes on the CPU (their own tests are marked slow), so their
stages are run eagerly here instead.  Tolerance 0 throughout.
"""

import hashlib

import numpy as np
import pytest
import torch

import consensus_tpu.models.fused as jfused
from consensus_tpu.config import Configuration as JaxConfiguration
from consensus_tpu.models import ed25519 as jmed
from consensus_tpu.models import registry as jreg
from consensus_tpu.models import verifier as jver
from consensus_tpu.ops import field25519 as jfe
from consensus_tpu.ops import scalar25519 as jsc
from consensus_tpu.ops import sha512 as jsh
from consensus_tpu_torch.config import Configuration
from consensus_tpu_torch.models import fused
from consensus_tpu_torch.models.aggregate import HalfAggregator, halfagg_coefficients
from consensus_tpu_torch.models.ed25519 import (
    _Z_TAG,
    Ed25519BatchVerifier,
    Ed25519RandomizedBatchVerifier,
    L,
    _transcript_coefficients,
    ref_public_key,
    ref_sign,
)
from consensus_tpu_torch.models.fused import (
    FusedEd25519BatchVerifier,
    FusedEd25519RandomizedBatchVerifier,
    canonical_ok_fast,
)
from consensus_tpu_torch.models.registry import UnknownEngineError
from consensus_tpu_torch.models.verifier import degrade_ladder_configs, engine_for_config
from consensus_tpu_torch.obs.kernels import KERNELS
from consensus_tpu_torch.ops import field25519 as fe
from consensus_tpu_torch.ops import sha512 as sh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path's tensors are 8 lanes wide: one intra-op thread runs
    them faster than many, and leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(n, seed=0, msg_len=100):
    rng = np.random.default_rng(seed)
    seeds = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(n)]
    keys = [ref_public_key(s) for s in seeds]
    msgs = [rng.integers(0, 256, msg_len, dtype=np.uint8).tobytes() for _ in range(n)]
    sigs = [ref_sign(s, m) for s, m in zip(seeds, msgs)]
    return msgs, sigs, keys


def _flip(raw, i):
    raw = bytes(raw)
    return raw[:i] + bytes([raw[i] ^ 1]) + raw[i + 1 :]


def _adversarial_waves():
    """tests/test_fused.py's two 8-lane waves: every rejection class next to
    honest lanes, an honest empty message among them."""
    msgs, sigs, keys = _batch(16, seed=42)
    msgs, sigs, keys = list(msgs), list(sigs), list(keys)
    sigs[1] = _flip(sigs[1], 2)                  # tampered R: forged
    msgs[2] = _flip(msgs[2], 50)                 # tampered message
    keys[3] = keys[0]                            # wrong key
    sigs[4] = sigs[4][:32] + (
        int.from_bytes(sigs[4][32:], "little") + L
    ).to_bytes(32, "little")                     # S >= L (malleability)
    sigs[5] = sigs[5][:32] + (2**256 - 1).to_bytes(32, "little")  # S max
    keys[6] = fe.P.to_bytes(32, "little")        # non-canonical A (y = p)
    sigs[7] = (fe.P + 1).to_bytes(32, "little") + sigs[7][32:]  # y_r > p
    sigs[9] = sigs[9][:40]                       # bad signature length
    keys[10] = keys[10][:16]                     # bad key length
    sigs[11] = (2).to_bytes(32, "little") + sigs[11][32:]  # non-square y
    seeds_extra = np.random.default_rng(1).integers(0, 256, 32, dtype=np.uint8)
    msgs[12] = b""                               # honest empty message
    sigs[12] = ref_sign(seeds_extra.tobytes(), msgs[12])
    keys[12] = ref_public_key(seeds_extra.tobytes())
    return [(msgs[:8], sigs[:8], keys[:8]), (msgs[8:], sigs[8:], keys[8:])]


_KW = dict(min_device_batch=1, pad_to=8, device="cpu")


def _launches():
    return {k: v["launches"] for k, v in KERNELS.snapshot().items()}


def _delta(before, after):
    return {
        k: after.get(k, 0) - before.get(k, 0)
        for k in set(before) | set(after)
        if after.get(k, 0) != before.get(k, 0)
    }


def test_canonical_ok_fast_matches_loop_twin_and_jax():
    for _, sigs, keys in _adversarial_waves():
        fast = canonical_ok_fast(sigs, keys)
        assert list(fast) == list(Ed25519BatchVerifier._canonical_ok(sigs, keys))
        assert list(fast) == list(jfused.canonical_ok_fast(sigs, keys))


@pytest.mark.parametrize("tag, fixed_z1", [(_Z_TAG, False), (b"ctpu/halfagg/v1", True)])
def test_device_transcript_matches_host_coefficients(tag, fixed_z1):
    """``device_transcript`` (leaf hashes -> root assembled from the leaf
    digests -> z_i = H(root || i)[:16]) reproduces the host derivation byte
    for byte on the 5 live lanes of an 8-lane pad: the batch transcript's
    ``_transcript_coefficients`` and half-agg's ``halfagg_coefficients``
    (z_1 pinned to 1)."""
    msgs, sigs, keys = _batch(5, seed=3, msg_len=40)
    mids = sigs if not fixed_z1 else [s[:32] for s in sigs]
    leaf_blocks, leaf_nblocks = fused._pack_blocks(
        [fused._frame(m) + fused._frame(x) + fused._frame(a) for m, x, a in zip(msgs, mids, keys)]
    )
    # The JAX module's packing of the same leaves, then padded to 8 lanes.
    want_blocks, want_n = jfused._pack_blocks(
        [jfused._frame(m) + jfused._frame(x) + jfused._frame(a) for m, x, a in zip(msgs, mids, keys)]
    )
    assert np.array_equal(leaf_blocks, want_blocks) and np.array_equal(leaf_nblocks, want_n)
    leaf_blocks = np.pad(leaf_blocks, ((0, 0),) * 3 + ((0, 3),))
    leaf_nblocks = np.pad(leaf_nblocks, (0, 3))
    z = fused.device_transcript(
        tag, 5, sh.blocks_tensor(leaf_blocks), torch.from_numpy(leaf_nblocks), fixed_z1=fixed_z1
    ).numpy()
    assert z.shape == (16, 8)
    got = [int.from_bytes(bytes(z[:, i].astype(np.uint8)), "little") for i in range(5)]
    if fixed_z1:
        assert got == halfagg_coefficients(msgs, mids, keys) and got[0] == 1
    else:
        assert got == _transcript_coefficients(msgs, sigs, keys) == jmed._transcript_coefficients(
            msgs, sigs, keys
        )
    # The constants are the JAX module's.
    for a, b in zip(fused._aggregate_constants(tag, 5, 8), jfused._aggregate_constants(tag, 5, 8)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    leaf0 = hashlib.sha512(fused._frame(msgs[0]) + fused._frame(mids[0]) + fused._frame(keys[0]))
    state = sh.sha512_blocks(sh.blocks_tensor(leaf_blocks), torch.from_numpy(leaf_nblocks))
    assert bytes(sh.digest_bytes(state)[:, 0].numpy().astype(np.uint8)) == leaf0.digest()


def test_fused_front_end_stages_equal_the_jax_modules():
    """The stages fused_verify_impl runs before B1's body -- the challenge
    digests, the reduced k, its window digits and the canonical checks --
    equal the JAX fused module's formulas on the same packed wave, lane for
    lane, over every rejection class and the padded lanes."""
    eng = FusedEd25519BatchVerifier(**_KW)
    for msgs, sigs, keys in _adversarial_waves():
        sig_rows, key_rows, blocks, n_blocks, host_ok = (
            t.numpy() for t in eng._device_args(msgs, sigs, keys)
        )
        jax_blocks = np.asarray(blocks).view(np.uint32)
        digest = sh.digest_bytes(
            sh.sha512_blocks(torch.from_numpy(blocks), torch.from_numpy(n_blocks))
        ).numpy()
        jdigest = np.asarray(jsh.digest_bytes(jsh.sha512_blocks(jax_blocks, n_blocks)))
        assert np.array_equal(digest, jdigest)
        for i, (m, s, k) in enumerate(zip(msgs, sigs, keys)):
            if len(s) == 64 and len(k) == 32:
                assert bytes(digest[:, i].astype(np.uint8)) == hashlib.sha512(s[:32] + k + m).digest()
        from consensus_tpu_torch.ops import scalar25519 as sc

        k_bytes = sc.reduce_bytes_mod_l(torch.from_numpy(digest))
        jk = np.asarray(jsc.reduce_bytes_mod_l(jdigest))
        assert np.array_equal(k_bytes.numpy(), jk)
        assert np.array_equal(
            sc.signed_window_digits(k_bytes).numpy(), np.asarray(jsc.signed_window_digits(jk))
        )
        sig = sig_rows.astype(np.int32)
        y_r = np.concatenate([sig[:31], (sig[31] & 0x7F)[None]])
        assert np.array_equal(
            sc.lt_l(torch.from_numpy(sig[32:])).numpy(), np.asarray(jsc.lt_l(sig[32:]))
        )
        assert np.array_equal(
            fe.bytes_lt_p(torch.from_numpy(y_r)).numpy(), np.asarray(jfe.bytes_lt_p(y_r))
        )


def test_engine_for_config_device_prep_routing():
    cfg = Configuration(device_prep=True, crypto_tpu_min_batch=4)
    eng = engine_for_config(cfg, device="cpu")
    assert type(eng) is FusedEd25519BatchVerifier and eng.fused and eng.device.type == "cpu"
    eng = engine_for_config(cfg.with_(batch_verify_mode=True), device="cpu")
    assert type(eng) is FusedEd25519RandomizedBatchVerifier
    assert eng.randomized and eng.fused and eng._min_device_batch == 4
    # P-256 with device_prep: the JAX package's refusal, word for word.
    with pytest.raises(UnknownEngineError, match="Ed25519-only") as port_err:
        engine_for_config(cfg, curve="p256", device="cpu")
    with pytest.raises(jreg.UnknownEngineError) as jax_err:
        jver.engine_for_config(JaxConfiguration(self_id=1, device_prep=True), curve="p256")
    assert str(port_err.value) == str(jax_err.value)
    # The fused mesh keys route to the sharded fused engines, as in JAX.
    assert type(engine_for_config(cfg.with_(mesh_shards=2), device="cpu")).__name__ == (
        "ShardedFusedEd25519Verifier"
    )
    assert type(
        engine_for_config(cfg.with_(mesh_shards=2, batch_verify_mode=True), device="cpu")
    ).__name__ == "ShardedFusedEd25519RandomizedVerifier"
    # device_prep off: the previous engine classes, exactly.
    assert type(engine_for_config(Configuration(), device="cpu")) is Ed25519BatchVerifier
    assert type(
        engine_for_config(Configuration(batch_verify_mode=True), device="cpu")
    ) is Ed25519RandomizedBatchVerifier
    # Supervision keeps JAX's fused -> host-prep rung.
    assert degrade_ladder_configs(cfg) == [cfg, cfg.with_(device_prep=False)]
    sup = engine_for_config(cfg.with_(engine_supervision=True), device="cpu")
    assert [sup.rung_label(i) for i in range(sup.rung_count)] == [
        "FusedEd25519BatchVerifier", "Ed25519BatchVerifier", "HostTwin",
    ]


def test_halfagg_inherits_device_prep_and_device_from_engine():
    fused_engine = FusedEd25519BatchVerifier(min_device_batch=10**9, device="cpu")
    legacy_engine = Ed25519BatchVerifier(min_device_batch=10**9, device="cpu")
    assert HalfAggregator(engine=fused_engine)._device_prep
    assert HalfAggregator(engine=fused_engine).device.type == "cpu"
    assert not HalfAggregator(engine=legacy_engine)._device_prep
    assert not HalfAggregator(engine=fused_engine, device_prep=False)._device_prep
    assert HalfAggregator(engine=legacy_engine, device_prep=True)._device_prep


def test_config_knob_validates():
    cfg = Configuration(self_id=1).with_(device_prep=True)
    cfg.validate()
    assert cfg.device_prep


def test_fused_strict_rejection_matrix_bit_identical_and_one_call_a_wave():
    host = Ed25519BatchVerifier(**_KW)
    fused_engine = FusedEd25519BatchVerifier(**_KW)
    jax_host = jmed.Ed25519BatchVerifier(min_device_batch=10**9)
    for msgs, sigs, keys in _adversarial_waves():
        want = host.verify_batch(msgs, sigs, keys)
        before = _launches()
        got = fused_engine.verify_batch(msgs, sigs, keys)
        # One fused device call a wave (the CPU runs S1's and B1's plain
        # versions, which are not launches).
        assert _delta(before, _launches()) == {"ed25519.fused_verify": 1}
        assert list(got) == list(want) == list(jax_host.verify_batch(msgs, sigs, keys))
    assert not all(want) and any(want)


def test_fused_strict_small_batches_take_the_host_path():
    eng = FusedEd25519BatchVerifier(min_device_batch=16, device="cpu")
    msgs, sigs, keys = _adversarial_waves()[0]
    before = _launches()
    assert list(eng.verify_batch(msgs, sigs, keys)) == list(
        Ed25519BatchVerifier._verify_host(msgs, sigs, keys)
    )
    assert _delta(before, _launches()) == {}
    assert len(eng.verify_batch([], [], [])) == 0
    with pytest.raises(ValueError, match="mismatch"):
        eng.verify_batch(msgs, sigs[:-1], keys)


def test_fused_verify_stream_keeps_wave_order():
    eng = FusedEd25519BatchVerifier(**_KW)
    host = Ed25519BatchVerifier(**_KW)
    waves = _adversarial_waves()
    waves = [waves[1], waves[0], tuple(w[:5] for w in waves[1])]
    before = _launches()
    got = list(eng.verify_stream(iter(waves)))
    assert _delta(before, _launches()) == {"ed25519.fused_verify": 3}
    assert [len(g) for g in got] == [8, 8, 5]
    for out, (msgs, sigs, keys) in zip(got, waves):
        assert list(out) == list(host.verify_batch(msgs, sigs, keys))
    assert list(eng.verify_stream(iter([]))) == []


def test_fused_randomized_parity_and_one_call_per_check():
    rkw = dict(min_device_batch=1, pad_to=8, min_randomized=8, device="cpu")
    legacy = Ed25519RandomizedBatchVerifier(**rkw)
    fused_engine = FusedEd25519RandomizedBatchVerifier(**rkw)
    msgs, sigs, keys = _batch(8, seed=6)
    before = _launches()
    got = fused_engine.verify_batch(msgs, sigs, keys)
    assert _delta(before, _launches()) == {"ed25519.fused_batch_verify": 1}
    assert list(got) == [True] * 8
    # One forged lane (S off by one bit, still below L): the aggregate fails
    # and the halves fall to the fused strict floor -- the host-prep
    # engine's verdicts lane for lane.
    sigs = list(sigs)
    sigs[5] = _flip(sigs[5], 33)
    assert int.from_bytes(sigs[5][32:], "little") < L
    before = _launches()
    got = fused_engine.verify_batch(msgs, sigs, keys)
    assert _delta(before, _launches()) == {
        "ed25519.fused_batch_verify": 1, "ed25519.fused_verify": 2,
    }
    assert list(got) == list(legacy.verify_batch(msgs, sigs, keys))
    assert list(got) == [i != 5 for i in range(8)]


def test_fused_randomized_host_twin_and_host_rejected_lanes():
    """Below ``min_device_batch`` the fused randomized engine checks on the
    host twin with lazily hashed scalars; lanes the pre-checks reject never
    join the transcript."""
    rkw = dict(min_device_batch=10**9, min_randomized=2, device="cpu")
    msgs, sigs, keys = (list(x) for x in _adversarial_waves()[0])
    got = FusedEd25519RandomizedBatchVerifier(**rkw).verify_batch(msgs, sigs, keys)
    assert list(got) == list(Ed25519RandomizedBatchVerifier(**rkw).verify_batch(msgs, sigs, keys))
    assert list(got) == list(Ed25519BatchVerifier._verify_host(msgs, sigs, keys))


def test_fused_halfagg_parity_and_one_call_per_verify():
    legacy = HalfAggregator(min_device_batch=1, pad_to=8, device_prep=False, device="cpu")
    host = HalfAggregator(min_device_batch=10**9, device="cpu")
    fused_agg = HalfAggregator(min_device_batch=1, pad_to=8, device_prep=True, device="cpu")
    msgs, sigs, keys = _batch(8, seed=8)
    agg, bad = host.aggregate(msgs, sigs, keys)
    assert agg is not None and bad == ()
    rs, s_agg = agg

    before = _launches()
    assert fused_agg.verify(msgs, list(rs), s_agg, keys)
    assert _delta(before, _launches()) == {"ed25519.fused_halfagg_verify": 1}
    assert legacy.verify(msgs, list(rs), s_agg, keys)

    cases = []
    bad_rs = list(rs)
    bad_rs[3] = _flip(rs[3], 0)
    cases.append((msgs, bad_rs, s_agg, keys))
    bad_msgs = list(msgs)
    bad_msgs[5] = _flip(msgs[5], 10)
    cases.append((bad_msgs, list(rs), s_agg, keys))
    cases.append((msgs, list(rs), _flip(s_agg, 1), keys))
    bad_keys = list(keys)
    bad_keys[0] = keys[1]  # lane 0 is the fixed z = 1 lane
    cases.append((msgs, list(rs), s_agg, bad_keys))
    for m, r, u, k in cases:
        assert not host.verify(m, r, u, k)
        assert not fused_agg.verify(m, r, u, k)
