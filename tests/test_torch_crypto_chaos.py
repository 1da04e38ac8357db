"""Chaos with real Ed25519 on the port, held against the JAX package.

The JAX package's ``tests/test_crypto_chaos.py`` (a byzantine replica's
commits corrupted three ways and shed by real verification),
``tests/test_byzantine_ed25519_chaos.py`` (the chaos engine's signature-flip
arm) and ``tests/test_halfagg_chaos.py`` (half-aggregated certificates
under chaos), on the port's engines built with ``device="cpu"`` on the host
path (``min_device_batch=10**9``).  Keys come from seeds, so each run is
also made in the JAX package and must give the same ledgers, event log and
repro text.
"""

import dataclasses
import logging
import random
import zlib

import pytest

import consensus_tpu.models as jmodels
import consensus_tpu.testing.chaos as jchaos
import consensus_tpu.testing.crypto_app as jcrypto_app
import consensus_tpu.types as jtypes
import consensus_tpu.wire as jwire
from consensus_tpu.testing import Cluster as JCluster
from consensus_tpu.testing import make_request as jmake_request
import consensus_tpu_torch.testing.chaos as tchaos
from consensus_tpu_torch import models as tmodels
from consensus_tpu_torch import types as ttypes
from consensus_tpu_torch import wire as twire
from consensus_tpu_torch.config import ObsConfig
from consensus_tpu_torch.models.verifier import commit_message
from consensus_tpu_torch.testing import Cluster, make_request
from consensus_tpu_torch.testing import crypto_app as tcrypto_app
from consensus_tpu_torch.testing.chaos import ChaosEngine, format_repro

CPU = {"device": "cpu"}


def _same_run(jres, tres) -> None:
    assert tres.ok == jres.ok
    assert tres.event_log == jres.event_log
    assert tres.ledgers == jres.ledgers
    assert format_repro(tres).replace("consensus_tpu_torch", "consensus_tpu") == \
        jchaos.format_repro(jres)


# --- tests/test_crypto_chaos.py ---------------------------------------------

FAST = {
    "request_forward_timeout": 1.0,
    "request_complain_timeout": 4.0,
    "request_auto_remove_timeout": 120.0,
    "view_change_resend_interval": 2.0,
    "view_change_timeout": 10.0,
    "leader_heartbeat_timeout": 20.0,
}
SEED = 60493
BYZANTINE = 4
HONEST = (1, 2, 3)
DECISIONS = 3


def _verifier_class(models):
    class _SigVerifier(models.Ed25519VerifierMixin):
        def verify_proposal(self, proposal):
            raise NotImplementedError

        def verify_request(self, raw):
            raise NotImplementedError

        def verification_sequence(self):
            return 0

        def requests_from_proposal(self, proposal):
            return []

    return _SigVerifier


def _flip_signature(rng, msg):
    value = bytearray(msg.signature.value)
    value[rng.randrange(len(value))] ^= 0xFF
    return dataclasses.replace(msg, signature=dataclasses.replace(msg.signature,
                                                                  value=bytes(value)))


def _claim_other_signer(rng, msg):
    return dataclasses.replace(msg, signature=dataclasses.replace(msg.signature,
                                                                  id=rng.choice(HONEST)))


def _zero_signature(rng, msg):
    return dataclasses.replace(msg, signature=dataclasses.replace(
        msg.signature, value=bytes(len(msg.signature.value))))


MODES = {
    "flip_byte": _flip_signature,
    "claim_other_signer": _claim_other_signer,
    "zero_signature": _zero_signature,
}


def _corrupted_cluster(mode, cluster_cls, request, models, crypto_app, commit_cls, engine_kw):
    seed = SEED + zlib.crc32(mode.encode()) % 1000
    rng = random.Random(seed)
    cluster = cluster_cls(4, seed=seed, config_tweaks=dict(FAST))
    engine = models.Ed25519BatchVerifier(min_device_batch=10**9, **engine_kw)
    signers = {i: models.Ed25519Signer(i, bytes([i]) * 32) for i in cluster.nodes}
    keys = {i: s.public_bytes for i, s in signers.items()}
    verifier = _verifier_class(models)
    for node_id, node in cluster.nodes.items():
        node.app = crypto_app.CryptoApp(node_id, cluster, signers[node_id],
                                        verifier(keys, engine=engine))
    corrupted = [0]

    def mutate(sender, target, msg):
        if sender == BYZANTINE and isinstance(msg, commit_cls):
            corrupted[0] += 1
            return MODES[mode](rng, msg)
        return msg

    cluster.network.mutate_send = mutate
    cluster.start()
    for i in range(DECISIONS):
        cluster.submit_to_all(request("chaos", i))
        assert cluster.run_until_ledger(i + 1, node_ids=list(HONEST), max_time=600.0), \
            f"[{mode} seed={seed}] block {i} stalled behind corrupted commits"
    assert corrupted[0] > 0, "byzantine node never sent a commit to corrupt"
    cluster.assert_ledgers_consistent()
    return cluster, keys


@pytest.mark.parametrize("mode", sorted(MODES))
def test_byzantine_commit_corruption_shed_by_real_ed25519_as_in_jax(mode):
    cluster, keys = _corrupted_cluster(mode, Cluster, make_request, tmodels, tcrypto_app,
                                       twire.Commit, CPU)
    checker = tmodels.Ed25519BatchVerifier(min_device_batch=10**9, device="cpu")
    for node_id in HONEST:
        for decision in cluster.nodes[node_id].app.ledger:
            assert len(decision.signatures) >= 3
            assert BYZANTINE not in {s.id for s in decision.signatures}
            msgs = [commit_message(decision.proposal, s.msg) for s in decision.signatures]
            assert checker.verify_batch(msgs, [s.value for s in decision.signatures],
                                        [keys[s.id] for s in decision.signatures]).all()
    jcluster, _ = _corrupted_cluster(mode, JCluster, jmake_request, jmodels, jcrypto_app,
                                     jwire.Commit, {})
    for node_id in cluster.nodes:
        assert [repr(d) for d in cluster.nodes[node_id].app.ledger] == \
            [repr(d) for d in jcluster.nodes[node_id].app.ledger]


# --- tests/test_byzantine_ed25519_chaos.py ----------------------------------

BYZANTINE_SEEDS = (0, 1, 9)


def _schedule(seed, chaos=tchaos):
    schedule = chaos.ChaosSchedule.generate(seed, n=4, steps=10)
    assert "byzantine" in [a.kind for a in schedule.actions]
    return schedule


@pytest.mark.parametrize("seed", BYZANTINE_SEEDS)
def test_byzantine_schedule_survives_real_ed25519_as_in_jax(seed):
    result = ChaosEngine(_schedule(seed), crypto="ed25519", **CPU).run()
    assert result.ok, result.violation
    assert result.deliveries > 0
    _same_run(jchaos.ChaosEngine(_schedule(seed, jchaos), crypto="ed25519").run(), result)


def test_byzantine_ed25519_replay_is_byte_identical():
    a = ChaosEngine(_schedule(9), crypto="ed25519", **CPU).run()
    b = ChaosEngine(_schedule(9), crypto="ed25519", **CPU).run()
    assert a.ok and b.ok
    assert a.event_log == b.event_log
    assert a.ledgers == b.ledgers


def test_flipped_signatures_are_rejected_by_real_verification(caplog):
    rejected = False
    with caplog.at_level(logging.WARNING, logger="consensus_tpu_torch.view"):
        for seed in BYZANTINE_SEEDS:
            result = ChaosEngine(_schedule(seed), crypto="ed25519", **CPU).run()
            assert result.ok, (seed, result.violation)
            if any("invalid commit signature" in rec.message for rec in caplog.records):
                rejected = True
                break
    assert rejected


# --- tests/test_halfagg_chaos.py --------------------------------------------

HONEST_ACTIONS = (
    ("loss", 35.0, {"a": 1, "b": 3, "p": 0.2}), ("delay", 55.0, {"a": 2, "b": 4, "d": 0.3}),
    ("crash", 80.0, {"node": 3}), ("restart", 105.0, {"node": 3}), ("heal", 125.0, {}),
)
BYZANTINE_ACTIONS = (
    ("byzantine", 35.0, {"node": 4, "rate": 1.0}), ("heal", 60.0, {}), ("heal", 85.0, {}),
    ("heal", 110.0, {}), ("heal", 135.0, {}), ("byzantine_stop", 160.0, {}),
)


def _fixed(chaos, seed, actions):
    return chaos.ChaosSchedule(seed=seed, n=4, actions=tuple(
        chaos.ChaosAction(at=at, kind=kind, args=dict(args)) for kind, at, args in actions))


def test_same_seed_chaos_parity_full_vs_halfagg_as_in_jax():
    schedule = _fixed(tchaos, 9021, HONEST_ACTIONS)
    full = ChaosEngine(schedule, crypto="ed25519", **CPU).run()
    assert full.ok, full.violation
    half = ChaosEngine(schedule, crypto="ed25519-halfagg", **CPU).run()
    assert half.ok, half.violation
    assert full.ledgers == half.ledgers
    assert full.event_log == half.event_log
    assert max(len(d) for d in full.ledgers.values()) >= 1
    _same_run(jchaos.ChaosEngine(_fixed(jchaos, 9021, HONEST_ACTIONS),
                                 crypto="ed25519-halfagg").run(), half)


def _halfagg_fallbacks(engine, quorum_cert):
    fallbacks = {nid: node.app._verifier.aggregator.fallback_bisections
                 for nid, node in engine.cluster.nodes.items()}
    degraded = {nid: sum(1 for d in node.app.ledger if not isinstance(d.signatures, quorum_cert))
                for nid, node in engine.cluster.nodes.items()}
    return fallbacks, degraded


def test_byzantine_component_corruption_falls_back_to_full_cert_as_in_jax():
    engine = ChaosEngine(_fixed(tchaos, 77, BYZANTINE_ACTIONS), crypto="ed25519-halfagg", **CPU)
    result = engine.run()
    assert result.ok, result.violation
    fallbacks, degraded = _halfagg_fallbacks(engine, ttypes.QuorumCert)
    assert fallbacks[4] > 0, "the byzantine arm never tripped the self-check"
    assert degraded[4] == fallbacks[4]
    assert all(fallbacks[n] == 0 and degraded[n] == 0 for n in (1, 2, 3))
    assert max(len(d) for d in result.ledgers.values()) >= 3
    jengine = jchaos.ChaosEngine(_fixed(jchaos, 77, BYZANTINE_ACTIONS), crypto="ed25519-halfagg")
    _same_run(jengine.run(), result)
    assert _halfagg_fallbacks(jengine, jtypes.QuorumCert) == (fallbacks, degraded)


def test_verify_collapse_detector_silent_on_honest_halfagg_run():
    quiet = _fixed(tchaos, 9021, HONEST_ACTIONS[:2] + (("heal", 80.0, {}),))
    result = ChaosEngine(quiet, obs=ObsConfig(enabled=True, sample_interval=5.0),
                         crypto="ed25519-halfagg", **CPU).run()
    assert result.ok, result.violation
    assert not [a for a in result.anomalies if a.kind == "verify_collapse"]


def test_crypto_chaos_engines_are_built_on_the_named_device():
    engine = ChaosEngine(_schedule(9), crypto="ed25519-batch", **CPU)
    engine.run()
    verifier = engine.cluster.nodes[1].app._verifier
    assert verifier._engine.device.type == "cpu"
    assert verifier._engine.randomized
