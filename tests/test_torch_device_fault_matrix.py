"""The JAX package's device-fault chaos cases (``tests/test_supervisor.py``
374-584) on the port, with its engines built on the CPU.

The injector's launch faults (hang, raise, silent verdict flip) under an
``EngineSupervisor`` that cross-checks every launch on the host twin: the
faulted run of the matrix schedule is byte-identical to the fault-free run
in the strict, randomized, fused and ``mesh2`` (a sharded engine over 2
virtual CPU shards) engine modes, each fault degrades once and recovers.
The strict, randomized and ``mesh2`` faulted runs are also the JAX
package's faulted runs, event log for event log and ledger for ledger.  The
half-agg mode is ``test_torch_halfagg_fault_matrix.py``.
"""

import numpy as np
import pytest

import consensus_tpu.parallel as jparallel
import consensus_tpu.testing.chaos as jchaos
from consensus_tpu_torch.config import ObsConfig
from consensus_tpu_torch.metrics import (
    ENGINE_CROSSCHECK_MISMATCH_KEY,
    ENGINE_DEGRADE_KEY,
    ENGINE_RECOVERED_KEY,
    ENGINE_RUNG_KEY,
)
from consensus_tpu_torch.models import FAULT_CLASSES, LaunchTimeout
from consensus_tpu_torch.models.ed25519 import Ed25519BatchVerifier
from consensus_tpu_torch.models.fused import FusedEd25519BatchVerifier
from consensus_tpu_torch.parallel import ShardedEd25519Verifier, mesh_for_shards
from consensus_tpu_torch.testing.chaos import (
    DEVICE_FAULT_CLASSES,
    ChaosEngine,
    ChaosSchedule,
    FaultInjectingEngine,
    format_repro,
)

#: tests/test_supervisor.py's matrix: one fault per class, spread across
#: launches so each degrade/recover cycle completes before the next fires.
MATRIX_FAULTS = ((2, "hang"), (5, "raise"), (8, "flip"))
MATRIX_SEED = 31

MODES = {
    "strict": ("ed25519", None),
    "randomized": ("ed25519-batch", None),
    "fused": ("ed25519", lambda: FusedEd25519BatchVerifier(min_device_batch=10**9, device="cpu")),
    "mesh2": ("ed25519", lambda: ShardedEd25519Verifier(
        mesh_for_shards(2, device="cpu"), min_device_batch=10**9)),
}
#: The JAX package's engines of the modes it builds through a factory
#: (tests/test_supervisor.py:431-447).
JAX_FACTORIES = {
    "mesh2": lambda: jparallel.ShardedEd25519Verifier(
        jparallel.mesh_for_shards(2), min_device_batch=10**9),
}


def _schedule(chaos=None):
    return (chaos.ChaosSchedule if chaos else ChaosSchedule).generate(MATRIX_SEED, n=4, steps=6)


def _run(mode, faults=()):
    crypto, factory = MODES[mode]
    engine = ChaosEngine(_schedule(), crypto=crypto, engine_factory=factory,
                         device_faults=faults, device="cpu")
    return engine, engine.run()


def assert_masked(engine) -> None:
    """Every armed fault fired, each class booked one degrade, all
    recovered, one cross-check mismatch, rung 0, breakers closed."""
    assert engine.fault_injector.fired == list(MATRIX_FAULTS)
    assert engine.fault_injector.pending == 0
    dump = engine.engine_metrics.provider.dump()
    for reason in FAULT_CLASSES:
        assert dump[f"{ENGINE_DEGRADE_KEY}{{{reason}}}"]["value"] == 1, reason
    assert dump[ENGINE_RECOVERED_KEY]["value"] == 3
    assert dump[ENGINE_CROSSCHECK_MISMATCH_KEY]["value"] == 1
    assert dump[ENGINE_RUNG_KEY]["value"] == 0
    assert not engine.supervisor.degraded
    assert all(b.state == "closed" for b in engine.supervisor.breakers.values())


# --- schedules and the injector ---------------------------------------------


def test_device_fault_schedules_are_deterministic_opt_in_and_the_jax_packages():
    base = ChaosSchedule.generate(7, steps=12)
    assert ChaosSchedule.generate(7, steps=12, device_faults=False) == base
    s1 = ChaosSchedule.generate(7, steps=12, device_faults=True)
    assert s1 == ChaosSchedule.generate(7, steps=12, device_faults=True)
    assert s1.device_faults is True
    for seed in range(30):
        s = ChaosSchedule.generate(seed, steps=12, device_faults=True)
        assert repr(s) == repr(jchaos.ChaosSchedule.generate(seed, steps=12, device_faults=True))
    drawn = [a for seed in range(30)
             for a in ChaosSchedule.generate(seed, steps=12, device_faults=True).actions
             if a.kind == "device_fault"]
    assert drawn, "30 seeds of 12 steps must draw one device_fault"
    for a in drawn:
        assert a.args["fault"] in DEVICE_FAULT_CLASSES
        assert 1 <= a.args["launch"] <= 3


def test_format_repro_carries_the_device_fault_flag():
    snippet = format_repro(ChaosEngine(ChaosSchedule.generate(3, steps=4)).run())
    assert "device_faults=False," in snippet


class _Scripted:
    def verify_batch(self, msgs, sigs, keys):
        return np.array([s == b"good" for s in sigs], dtype=bool)

    verify_host = verify_batch


def test_fault_injector_arms_fires_and_forwards_host_uninjected():
    batch = ([b"m"] * 3, [b"good", b"bad", b"good"], [b"k"] * 3)
    want = [True, False, True]
    inj = FaultInjectingEngine(_Scripted())
    inj.arm(1, "hang")
    inj.arm(2, "flip")
    with pytest.raises(ValueError, match="unknown device fault"):
        inj.arm(3, "melt")
    with pytest.raises(LaunchTimeout):
        inj.verify_batch(*batch)
    assert list(inj.verify_batch(*batch)) == [not v for v in want]
    assert list(inj.verify_host(*batch)) == want
    assert list(inj.verify_batch(*batch)) == want
    assert inj.fired == [(1, "hang"), (2, "flip")] and inj.pending == 0


def test_injected_fault_messages_are_the_jax_packages():
    """The injector's exceptions carry the JAX package's text, which the
    supervisor logs: the event logs stay byte-identical across packages."""
    for package in (jchaos, None):
        inj = (package.FaultInjectingEngine if package else FaultInjectingEngine)(_Scripted())
        inj.arm(1, "hang")
        inj.arm(2, "raise")
        batch = ([b"m"], [b"good"], [b"k"])
        with pytest.raises(Exception) as hang:
            inj.verify_batch(*batch)
        with pytest.raises(RuntimeError) as raised:
            inj.verify_batch(*batch)
        assert str(hang.value) == "injected device hang at launch 1"
        assert str(raised.value) == "injected XLA launch failure at launch 2"


# --- the byte-parity matrix -------------------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
def test_device_fault_matrix_is_byte_identical_to_clean_run(mode):
    _, clean = _run(mode)
    engine, res = _run(mode, MATRIX_FAULTS)
    assert clean.ok, clean.violation
    assert res.ok, res.violation
    assert res.event_log == clean.event_log
    assert res.ledgers == clean.ledgers
    assert_masked(engine)
    assert engine.fault_injector.launches == 64


@pytest.mark.parametrize("mode", ["strict", "randomized", "mesh2"])
def test_faulted_run_equals_the_jax_packages(mode):
    crypto, _ = MODES[mode]
    _, ours = _run(mode, MATRIX_FAULTS)
    jengine = jchaos.ChaosEngine(_schedule(jchaos), crypto=crypto, device_faults=MATRIX_FAULTS,
                                 engine_factory=JAX_FACTORIES.get(mode))
    theirs = jengine.run()
    assert ours.event_log == theirs.event_log
    assert ours.ledgers == theirs.ledgers
    assert format_repro(ours).replace("consensus_tpu_torch", "consensus_tpu") == \
        jchaos.format_repro(theirs)
    assert jengine.fault_injector.fired == list(MATRIX_FAULTS)


def test_constructor_faults_imply_crypto_and_schedule_faults_arm_injector():
    eng = ChaosEngine(ChaosSchedule(seed=1, n=4, actions=()), device_faults=((1, "hang"),))
    assert eng.crypto == "ed25519"
    for seed in range(40):
        sched = ChaosSchedule.generate(seed, steps=10, device_faults=True)
        if any(a.kind == "device_fault" for a in sched.actions):
            assert ChaosEngine(sched).crypto == "ed25519"
            return
    raise AssertionError("40 seeds of 10 steps must draw one device_fault")


def test_generated_device_fault_schedule_runs_clean_and_replays_as_in_jax():
    sched = next(s for s in (ChaosSchedule.generate(seed, n=4, steps=8, device_faults=True)
                             for seed in range(60))
                 if any(a.kind == "device_fault" for a in s.actions))
    e1 = ChaosEngine(sched, device="cpu")
    r1 = e1.run()
    assert r1.ok, r1.violation
    assert e1.fault_injector.fired, "the armed fault must actually fire"
    r2 = ChaosEngine(sched, device="cpu").run()
    assert r1.event_log == r2.event_log
    assert r1.ledgers == r2.ledgers
    jres = jchaos.ChaosEngine(jchaos.ChaosSchedule.generate(
        sched.seed, n=4, steps=8, device_faults=True)).run()
    assert r1.event_log == jres.event_log
    assert r1.ledgers == jres.ledgers


# --- observability ----------------------------------------------------------


def test_device_faults_fire_the_engine_degraded_detector():
    eng = ChaosEngine(_schedule(), obs=ObsConfig(enabled=True, sample_interval=2.0),
                      device_faults=MATRIX_FAULTS, device="cpu")
    res = eng.run()
    assert res.ok, res.violation
    counts = eng.cluster.sampler.anomaly_counts()
    assert counts.get("engine_degraded", 0) >= 1
    assert "verify_collapse" not in counts
    assert b"ANOMALY engine_degraded" in res.event_log
    assert any(a.kind == "engine_degraded" for a in res.anomalies)
    assert_masked(eng)
    _, plain = _run("strict", MATRIX_FAULTS)
    assert res.ledgers == plain.ledgers


def test_supervised_clean_soak_keeps_the_detector_silent():
    eng = ChaosEngine(_schedule(), obs=ObsConfig(enabled=True, sample_interval=2.0),
                      device_faults=((10**6, "hang"),), device="cpu")
    res = eng.run()
    assert res.ok, res.violation
    assert eng.fault_injector.fired == []
    assert "engine_degraded" not in eng.cluster.sampler.anomaly_counts()
    assert b"ANOMALY engine_degraded" not in res.event_log
    dump = eng.engine_metrics.provider.dump()
    assert dump[ENGINE_RECOVERED_KEY]["value"] == 0
    assert dump[ENGINE_RUNG_KEY]["value"] == 0


def test_strict_engine_factory_on_the_cpu_equals_the_built_engine():
    """An ``engine_factory`` placing its own engine on the CPU runs the
    matrix schedule exactly as the engine ``device="cpu"`` builds."""
    factory = ChaosEngine(_schedule(), crypto="ed25519", device_faults=MATRIX_FAULTS,
                          engine_factory=lambda: Ed25519BatchVerifier(
                              min_device_batch=10**9, device="cpu")).run()
    _, built = _run("strict", MATRIX_FAULTS)
    assert factory.event_log == built.event_log
    assert factory.ledgers == built.ledgers
