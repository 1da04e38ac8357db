"""The port's chaos engine held against the JAX package's.

``consensus_tpu_torch.testing.chaos`` (with ``invariants.py``, ``faults.py``
and ``membership.py``) against ``consensus_tpu.testing.chaos``: the same
seeded schedules, generated in both packages, are equal action for action,
and run through both engines they give the same event log, ledgers,
violation and repro text (the rename undone).  Then the JAX package's own
cases of ``tests/test_chaos_engine.py`` on the port: the seeded sentinel bug
found at delivery time and shrunk to a reproducer that replays, and the
fault plan's crash race.  Schedules without crypto never resolve a device.
"""

import dataclasses
import threading

import pytest

import consensus_tpu.core.view as jview
import consensus_tpu.testing.chaos as jchaos
import consensus_tpu_torch.core.view as tview
from consensus_tpu_torch.testing.chaos import (
    ChaosAction,
    ChaosEngine,
    ChaosSchedule,
    format_repro,
    shrink,
)
from consensus_tpu_torch.testing.faults import FaultPlan, SimulatedCrash
from consensus_tpu_torch.testing.invariants import InvariantViolation


def _port_repro(result) -> str:
    return format_repro(result).replace("consensus_tpu_torch", "consensus_tpu")


def _violation(v):
    return None if v is None else dataclasses.astuple(v)


def assert_same_run(jres, tres) -> None:
    """The two packages' results of one schedule are the same run."""
    assert tres.ok == jres.ok
    assert tres.event_log == jres.event_log
    assert tres.ledgers == jres.ledgers
    assert tres.deliveries == jres.deliveries
    assert _violation(tres.violation) == _violation(jres.violation)
    assert _port_repro(tres) == jchaos.format_repro(jres)


def _jax_schedule(sched: ChaosSchedule) -> jchaos.ChaosSchedule:
    """The port's schedule as the JAX package's dataclasses."""
    actions = tuple(jchaos.ChaosAction(at=a.at, kind=a.kind, args=dict(a.args))
                    for a in sched.actions)
    return jchaos.ChaosSchedule(**{**dataclasses.asdict(sched), "actions": actions})


# --- schedule generation ----------------------------------------------------


@pytest.mark.parametrize("seed", [1, 7, 19, 20260728])
@pytest.mark.parametrize("n", [4, 7])
def test_generated_schedules_equal_the_jax_packages(seed, n):
    ours = ChaosSchedule.generate(seed, n=n, steps=30)
    theirs = jchaos.ChaosSchedule.generate(seed, n=n, steps=30)
    assert repr(ours) == repr(theirs)
    assert _jax_schedule(ours) == theirs


@pytest.mark.parametrize("flag", ["wan", "device_faults", "storage_faults", "adversarial_net"])
def test_generated_schedules_with_each_arm_equal_the_jax_packages(flag):
    kw = {flag: "3region" if flag == "wan" else True}
    for seed in (3, 11):
        ours = ChaosSchedule.generate(seed, n=4, steps=20, **kw)
        assert repr(ours) == repr(jchaos.ChaosSchedule.generate(seed, n=4, steps=20, **kw))


def test_generate_is_deterministic_and_seed_sensitive():
    a = ChaosSchedule.generate(42, steps=15)
    b = ChaosSchedule.generate(42, steps=15)
    c = ChaosSchedule.generate(43, steps=15)
    assert a == b
    assert a != c
    assert len(a.actions) == 15
    ats = [act.at for act in a.actions]
    assert ats == sorted(ats), "actions must be sim-clock ordered"


@pytest.mark.parametrize("seed", [1, 7, 19, 20260728])
def test_generate_stays_inside_the_fault_model(seed):
    for n in (4, 7):
        sched = ChaosSchedule.generate(seed, n=n, steps=30)
        f = (n - 1) // 3
        down, byz = set(), set()
        for act in sched.actions:
            if act.kind in ("crash", "arm_fault"):
                down.add(act.args["node"])
            elif act.kind == "restart":
                down.discard(act.args["node"])
            elif act.kind == "byzantine":
                byz.add(act.args["node"])
            elif act.kind == "byzantine_stop":
                byz.clear()
            assert len(down) <= f, f"{n=} schedule exceeds f crashed"
            assert len(byz) <= max(f, 1), f"{n=} schedule exceeds f byzantine"


# --- runs in both packages --------------------------------------------------


@pytest.mark.parametrize("seed", [2, 5, 9])
def test_engine_smoke_equals_the_jax_run(seed):
    result = ChaosEngine(ChaosSchedule.generate(seed, steps=10)).run()
    assert result.ok, f"{result.violation}\n\nreproduce with:\n{format_repro(result)}"
    assert result.deliveries > 0
    assert_same_run(jchaos.ChaosEngine(jchaos.ChaosSchedule.generate(seed, steps=10)).run(),
                    result)


@pytest.mark.parametrize("seed", [1, 7, 19, 20260728])
def test_thirty_step_schedule_run_equals_the_jax_run(seed):
    result = ChaosEngine(ChaosSchedule.generate(seed, steps=30)).run()
    assert result.ok, result.violation
    assert_same_run(jchaos.ChaosEngine(jchaos.ChaosSchedule.generate(seed, steps=30)).run(),
                    result)


def test_engine_smoke_group_commit_equals_the_jax_run():
    result = ChaosEngine(ChaosSchedule.generate(3, steps=10, durability_window=0.05)).run()
    assert result.ok, result.violation
    jres = jchaos.ChaosEngine(
        jchaos.ChaosSchedule.generate(3, steps=10, durability_window=0.05)).run()
    assert_same_run(jres, result)


@pytest.mark.parametrize("seed", [5, 6])
def test_adversarial_net_run_equals_the_jax_run(seed):
    """The ``net_abuse`` arm drives the port's ``testing/adversary.py``
    batteries at a node's ``ListenerGuard``: the same event log, ledgers
    and sampler anomalies as the JAX package, ``wire_abuse`` among them."""
    from consensus_tpu.config import ObsConfig as JObsConfig
    from consensus_tpu_torch.config import ObsConfig

    engine = ChaosEngine(ChaosSchedule.generate(seed, steps=20, adversarial_net=True),
                         obs=ObsConfig(enabled=True, sample_interval=2.0))
    result = engine.run()
    assert result.ok, result.violation
    jengine = jchaos.ChaosEngine(
        jchaos.ChaosSchedule.generate(seed, steps=20, adversarial_net=True),
        obs=JObsConfig(enabled=True, sample_interval=2.0))
    assert_same_run(jengine.run(), result)
    counts = engine.cluster.sampler.anomaly_counts()
    assert counts["wire_abuse"] >= 1
    assert counts == jengine.cluster.sampler.anomaly_counts()


# --- the seeded sentinel bug ------------------------------------------------

SENTINEL_SCHEDULE = ChaosSchedule(
    seed=7,
    n=4,
    durability_window=0.0,
    actions=(
        ChaosAction(at=35.0, kind="loss", args={"a": 2, "b": 3, "p": 0.3}),
        ChaosAction(at=50.0, kind="delay", args={"a": 1, "b": 4, "d": 0.2}),
        ChaosAction(at=65.0, kind="crash", args={"node": 1}),
        ChaosAction(at=80.0, kind="duplicate", args={"a": 2, "b": 4, "p": 0.3}),
        ChaosAction(at=95.0, kind="heal"),
        ChaosAction(at=110.0, kind="restart", args={"node": 1}),
        ChaosAction(at=130.0, kind="reorder", args={"a": 3, "b": 2, "p": 0.3}),
        ChaosAction(at=150.0, kind="heal"),
    ),
)


@pytest.fixture
def sentinel_bug():
    jview.SENTINEL_MISWIRED_QUORUM = True
    tview.SENTINEL_MISWIRED_QUORUM = True
    try:
        yield
    finally:
        jview.SENTINEL_MISWIRED_QUORUM = False
        tview.SENTINEL_MISWIRED_QUORUM = False


def test_monitor_detects_sentinel_at_delivery_time_as_the_jax_engine(sentinel_bug):
    result = ChaosEngine(SENTINEL_SCHEDULE).run()
    assert not result.ok
    v = result.violation
    assert v.invariant == "quorum-cert"
    assert v.sim_time < SENTINEL_SCHEDULE.actions[-1].at
    assert v.node is not None
    assert "quorum is 3" in v.detail
    assert any("crash" in line for line in v.history)
    assert b"VIOLATION quorum-cert" in result.event_log
    assert_same_run(jchaos.ChaosEngine(_jax_schedule(SENTINEL_SCHEDULE)).run(), result)


def test_sentinel_is_dormant_without_a_view_change(sentinel_bug):
    result = ChaosEngine(ChaosSchedule(seed=7, n=4, actions=())).run()
    assert result.ok, result.violation


def test_shrinker_converges_to_the_jax_reproducer(sentinel_bug):
    small, res = shrink(SENTINEL_SCHEDULE, invariant="quorum-cert")
    assert len(small.actions) <= 3, f"shrinker left {len(small.actions)} actions: {small.actions}"
    assert any(a.kind == "crash" for a in small.actions)
    assert res.violation.invariant == "quorum-cert"
    jsmall, jres = jchaos.shrink(_jax_schedule(SENTINEL_SCHEDULE), invariant="quorum-cert")
    assert repr(small) == repr(jsmall)
    assert_same_run(jres, res)

    snippet = format_repro(res)
    assert "from consensus_tpu_torch.testing.chaos import (" in snippet
    scope = {}
    exec(compile(snippet, "<repro>", "exec"), scope)
    assert scope["result"].violation.invariant == "quorum-cert"
    assert scope["result"].event_log == res.event_log


def test_shrink_refuses_a_passing_schedule():
    with pytest.raises(ValueError, match="does not fail"):
        shrink(ChaosSchedule(seed=7, n=4, actions=()))


def test_assert_clean_raises_with_context():
    engine = ChaosEngine(ChaosSchedule.generate(2, steps=5))
    result = engine.run()
    assert result.ok
    engine.monitor.record("liveness", None, "synthetic for the error path")
    with pytest.raises(InvariantViolation, match="synthetic"):
        engine.monitor.assert_clean()
    assert engine.monitor.first.history, "violations must carry the action history"


def test_a_crypto_free_schedule_never_resolves_a_device(monkeypatch):
    """The port's engines raise without a card unless built on the CPU; a
    schedule without crypto builds none, so it runs with no card whatever
    ``device`` says, and a crypto schedule on ``cuda`` raises."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    engine = ChaosEngine(ChaosSchedule.generate(5, steps=10), device="cuda")
    assert engine.crypto is None
    assert engine.run().ok
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChaosEngine(ChaosSchedule.generate(5, steps=10), crypto="ed25519").run()


# --- FaultPlan crash-seam race ----------------------------------------------


def test_fault_plan_crash_race_two_threads():
    point = "net.send.io_error"
    for _ in range(200):
        plan = FaultPlan(point, on_hit=3)
        teardowns = []
        plan.on_crash = lambda: teardowns.append(1)
        fired = []
        barrier = threading.Barrier(2)

        def worker():
            barrier.wait()
            for _ in range(5):
                try:
                    plan.crash(point)
                except SimulatedCrash as e:
                    if "injected crash" in str(e):
                        fired.append(e)

        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(fired) == 1, f"{len(fired)} threads observed the firing"
        assert len(teardowns) == 1, "on_crash ran more than once"
        assert plan.fired == (point, 3)
        assert plan.dead
        assert plan.hits[point] == 3
