"""The port's engine supervision held against the JAX package's.

``consensus_tpu_torch.models.supervisor`` against
``consensus_tpu.models.supervisor``: the breaker, the shared engine health,
the host twin, and the supervisor's fault classes, ladder, re-promotion,
cross-check sampling and booking, first as the JAX package's own cases
(``tests/test_supervisor.py``) run on the port's classes, then as a
differential run: one seeded schedule of launches (ok, raise,
``LaunchTimeout``, flipped verdicts, clock steps) through both supervisors
over the same scripted numpy engine, with exact equality of every
(rung, verdict) and of the final metric dump.
"""

import numpy as np
import pytest

from consensus_tpu import metrics as jmetrics
from consensus_tpu.models import supervisor as jsup
from consensus_tpu_torch import metrics as tmetrics
from consensus_tpu_torch.config import Configuration
from consensus_tpu_torch.metrics import (
    ENGINE_CROSSCHECK_KEY,
    ENGINE_CROSSCHECK_MISMATCH_KEY,
    ENGINE_DEGRADE_KEY,
    ENGINE_RECOVERED_KEY,
    ENGINE_RUNG_KEY,
    InMemoryProvider,
    Metrics,
)
from consensus_tpu_torch.models import (
    ENGINE_HEALTH,
    FAULT_CLASSES,
    CircuitBreaker,
    EngineHealth,
    EngineSupervisor,
    HostTwin,
    LaunchTimeout,
)
from consensus_tpu_torch.models import supervisor as tsup
from consensus_tpu_torch.models.verifier import degrade_ladder_configs, engine_for_config


class _Scripted:
    """Engine whose next-call behavior is set by the test: raise
    ``fail_with``, or answer (optionally with every verdict flipped)."""

    def __init__(self):
        self.calls = 0
        self.host_calls = 0
        self.fail_with = None
        self.flip = False

    def _truth(self, sigs):
        return np.array([s == b"good" for s in sigs], dtype=bool)

    def verify_batch(self, msgs, sigs, keys):
        self.calls += 1
        if self.fail_with is not None:
            raise self.fail_with
        out = self._truth(sigs)
        return ~out if self.flip else out

    def verify_host(self, msgs, sigs, keys):
        self.host_calls += 1
        return self._truth(sigs)


_BATCH = ([b"m"] * 3, [b"good", b"bad", b"good"], [b"k"] * 3)
_WANT = [True, False, True]


def _sup(engine=None, **kw):
    engine = engine or _Scripted()
    kw.setdefault("backoff_initial", 2.0)
    kw.setdefault("metrics", Metrics(InMemoryProvider()))
    return engine, EngineSupervisor([engine], **kw)


def _provider_dump(sup):
    return sup._metrics.count_degrade._provider.dump()


# --- the JAX package's cases on the port's classes -----------------------------


def test_breaker_lifecycle_closed_open_halfopen_closed():
    b = CircuitBreaker(failure_threshold=1, backoff_initial=10.0)
    assert b.state == "closed"
    assert b.record_failure(now=100.0)
    assert b.state == "open" and b.opened_count == 1
    assert not b.probe_due(105.0)
    assert b.state == "open"
    assert b.probe_due(110.0)
    assert b.state == "half_open"
    assert b.probe_due(110.0)
    assert b.record_success(110.0)
    assert b.state == "closed" and b.failures == 0


def test_breaker_failed_probe_reopens_with_doubled_backoff():
    b = CircuitBreaker(failure_threshold=1, backoff_initial=10.0, backoff_max=15.0)
    b.record_failure(0.0)
    assert b.probe_due(10.0)
    assert b.record_failure(10.0)
    assert b.state == "open"
    assert not b.probe_due(10.0 + 10.0)
    assert b.probe_due(10.0 + 15.0)
    b.record_success(25.0)
    b.record_failure(30.0)
    assert b.probe_due(40.0)


def test_breaker_threshold_counts_failures_before_opening():
    b = CircuitBreaker(failure_threshold=3, backoff_initial=1.0)
    assert not b.record_failure(0.0)
    assert not b.record_failure(0.0)
    assert b.record_failure(0.0)
    assert b.state == "open"


def test_breaker_validation_is_loud():
    with pytest.raises(ValueError):
        CircuitBreaker(failure_threshold=0)
    with pytest.raises(ValueError):
        CircuitBreaker(backoff_initial=0.0)
    with pytest.raises(ValueError):
        CircuitBreaker(backoff_initial=10.0, backoff_max=5.0)


def test_engine_health_reports_edges_only():
    h = EngineHealth()
    assert not h.suspect
    assert h.mark_suspect("launch_raise")
    assert not h.mark_suspect("launch_raise")
    assert h.suspect and h.reason == "launch_raise"
    assert h.suspect_marks == 2
    assert h.clear()
    assert not h.clear()
    assert not h.suspect


def test_health_registry_shares_one_entry_per_engine():
    a, b = _Scripted(), _Scripted()
    ha = ENGINE_HEALTH.for_engine(a)
    assert ENGINE_HEALTH.for_engine(a) is ha
    assert ENGINE_HEALTH.for_engine(b) is not ha
    assert isinstance(ENGINE_HEALTH.for_engine([]), EngineHealth)


def test_host_twin_is_ground_truth_and_its_own_twin():
    eng = _Scripted()
    eng.flip = True
    twin = HostTwin(eng)
    assert list(twin.verify_batch(*_BATCH)) == _WANT
    assert list(twin.verify_host(*_BATCH)) == _WANT
    assert twin.randomized is False


def test_host_twin_requires_a_host_path():
    class _DeviceOnly:
        def verify_batch(self, m, s, k):  # pragma: no cover - never called
            raise AssertionError

    with pytest.raises(ValueError, match="no host twin"):
        HostTwin(_DeviceOnly())


def test_supervisor_appends_host_twin_and_delegates_shape_attrs():
    eng = _Scripted()
    eng.pad_to = 64
    sup = EngineSupervisor([eng])
    assert sup.rung_count == 2 and isinstance(sup._rungs[-1], HostTwin)
    assert sup.pad_to == 64
    with pytest.raises(AttributeError):
        sup._no_such_attr
    with pytest.raises(ValueError):
        EngineSupervisor([])


@pytest.mark.parametrize(
    "exc,reason",
    [
        (LaunchTimeout("wedged kernel"), "launch_timeout"),
        (RuntimeError("kernel launch failed"), "launch_raise"),
    ],
)
def test_launch_fault_degrades_to_host_and_repromotes(exc, reason):
    eng, sup = _sup()
    eng.fail_with = exc
    assert list(sup.verify_batch(*_BATCH)) == _WANT
    assert sup.degraded and sup.rung == 1
    assert sup.breakers[reason].state == "open"
    eng.fail_with = None
    assert list(sup.verify_batch(*_BATCH)) == _WANT
    assert sup.degraded and eng.calls == 1
    assert list(sup.verify_batch(*_BATCH)) == _WANT
    assert not sup.degraded and sup.rung == 0 and eng.calls == 2
    assert sup.breakers[reason].state == "closed"
    assert not sup.health.suspect
    dump = _provider_dump(sup)
    assert dump[f"{ENGINE_DEGRADE_KEY}{{{reason}}}"]["value"] == 1
    assert dump[ENGINE_RECOVERED_KEY]["value"] == 1
    assert dump[ENGINE_RUNG_KEY]["value"] == 0


def test_crosscheck_catches_wrong_answers_and_serves_host_verdict():
    eng, sup = _sup(crosscheck_interval=1)
    eng.flip = True
    assert list(sup.verify_batch(*_BATCH)) == _WANT
    assert sup.degraded
    assert sup.breakers["wrong_answer"].state == "open"
    dump = _provider_dump(sup)
    assert dump[f"{ENGINE_DEGRADE_KEY}{{wrong_answer}}"]["value"] == 1
    assert dump[ENGINE_CROSSCHECK_KEY]["value"] == 1
    assert dump[ENGINE_CROSSCHECK_MISMATCH_KEY]["value"] == 1


def test_crosscheck_samples_every_kth_launch():
    eng, sup = _sup(crosscheck_interval=3)
    for _ in range(6):
        assert list(sup.verify_batch(*_BATCH)) == _WANT
    dump = _provider_dump(sup)
    assert dump[ENGINE_CROSSCHECK_KEY]["value"] == 2
    assert dump[ENGINE_CROSSCHECK_MISMATCH_KEY]["value"] == 0
    assert not sup.degraded


def test_failed_probe_doubles_backoff_without_double_booking():
    eng, sup = _sup()
    eng.fail_with = RuntimeError("persistent device loss")
    served = [list(sup.verify_batch(*_BATCH)) for _ in range(8)]
    assert all(out == _WANT for out in served)
    assert sup.degraded and len(sup._degrade_stack) == 1
    eng.fail_with = None
    for _ in range(8):
        assert list(sup.verify_batch(*_BATCH)) == _WANT
        if not sup.degraded:
            break
    assert not sup.degraded and sup.rung == 0
    assert sup.breakers["launch_raise"].state == "closed"


def test_no_raise_escapes_verify_while_a_host_twin_exists():
    eng, sup = _sup()
    for exc in (RuntimeError("x"), LaunchTimeout("y"), ValueError("z")):
        eng.fail_with = exc
        assert list(sup.verify_batch(*_BATCH)) == _WANT

    class _NoHost:
        boom = RuntimeError("device loss")

        def verify_batch(self, m, s, k):
            raise self.boom

    bare_engine = _NoHost()
    bare = EngineSupervisor([bare_engine], append_host=True)
    assert bare.rung_count == 1
    with pytest.raises(RuntimeError):
        bare.verify_batch(*_BATCH)
    bare_engine.boom = LaunchTimeout("wedged, no floor")
    with pytest.raises(LaunchTimeout):
        bare.verify_batch(*_BATCH)


def test_injected_clock_paces_the_breaker():
    t = [0.0]
    eng, sup = _sup(clock=lambda: t[0], backoff_initial=30.0)
    eng.fail_with = RuntimeError("boom")
    sup.verify_batch(*_BATCH)
    eng.fail_with = None
    sup.verify_batch(*_BATCH)
    assert sup.degraded
    t[0] = 31.0
    sup.verify_batch(*_BATCH)
    assert not sup.degraded


def test_transition_hooks_and_rung_labels():
    class _Sharded(_Scripted):
        shard_count = 2

    eng, sup = _sup(engine=_Sharded())
    seen = []
    sup.on_transition.append(lambda kind, reason, rung: seen.append((kind, reason, rung)))
    assert sup.rung_label(0) == "_Sharded[2]"
    assert sup.rung_label(1) == "HostTwin"
    eng.fail_with = LaunchTimeout("wedge")
    sup.verify_batch(*_BATCH)
    eng.fail_with = None
    sup.verify_batch(*_BATCH)
    sup.verify_batch(*_BATCH)
    assert seen == [("degrade", "launch_timeout", 1), ("recover", "launch_timeout", 0)]


def test_tracer_and_flight_recorder_are_duck_typed():
    class _Tracer:
        enabled = True

        def __init__(self):
            self.instants = []

        def instant(self, cat, event, **kw):
            self.instants.append((cat, event, kw["reason"], kw["rung"], kw["name"]))

    class _Flight:
        def __init__(self):
            self.triggers = []

        def trigger(self, reason, detail=""):
            self.triggers.append(reason)
            raise OSError("disk full")  # a failing snapshot must not break verify

    tracer, flight = _Tracer(), _Flight()
    eng, sup = _sup(tracer=tracer, flight_recorder=flight)
    eng.fail_with = RuntimeError("boom")
    assert list(sup.verify_batch(*_BATCH)) == _WANT
    eng.fail_with = None
    sup.verify_batch(*_BATCH)
    sup.verify_batch(*_BATCH)
    assert tracer.instants == [
        ("engine", "engine.degrade", "launch_raise", 1, "engine"),
        ("engine", "engine.recover", "launch_raise", 0, "engine"),
    ]
    assert flight.triggers == ["engine-degrade-launch_raise"]


def test_fault_classes_are_the_pinned_label_order():
    assert FAULT_CLASSES == jsup.FAULT_CLASSES == ("launch_timeout", "launch_raise", "wrong_answer")
    _, sup = _sup()
    assert set(sup.breakers) == set(FAULT_CLASSES)


def test_degrade_ladder_configs_of_the_ported_lanes():
    assert degrade_ladder_configs(Configuration()) == [Configuration()]
    randomized = Configuration(batch_verify_mode=True)
    assert degrade_ladder_configs(randomized) == [randomized]
    # The mesh lane is ported: its ladder walks mesh -> single device ->
    # host prep, as JAX's (tests/test_supervisor.py:337-347), and each mesh
    # rung is labelled with its shard count.
    fused_mesh = Configuration(mesh_shards=2, device_prep=True)
    assert [(c.mesh_shards, c.device_prep) for c in degrade_ladder_configs(fused_mesh)] == [
        (2, True), (1, True), (1, False),
    ]
    sup = engine_for_config(fused_mesh.with_(engine_supervision=True), device="cpu")
    assert [sup.rung_label(i) for i in range(sup.rung_count)] == [
        "ShardedFusedEd25519Verifier[2]", "FusedEd25519BatchVerifier",
        "Ed25519BatchVerifier", "HostTwin",
    ]
    # The fused lane is ported: its ladder keeps JAX's fused -> host-prep rung.
    fused = Configuration(device_prep=True)
    assert degrade_ladder_configs(fused) == [fused, fused.with_(device_prep=False)]
    sup = engine_for_config(fused.with_(engine_supervision=True), device="cpu")
    assert [sup.rung_label(i) for i in range(sup.rung_count)] == [
        "FusedEd25519BatchVerifier", "Ed25519BatchVerifier", "HostTwin",
    ]


def test_engine_for_config_routes_through_supervision():
    cfg = Configuration(engine_supervision=True, engine_crosscheck_interval=4)
    sup = engine_for_config(cfg, device="cpu")
    assert isinstance(sup, EngineSupervisor)
    assert sup.rung_count == 2 and isinstance(sup._rungs[-1], HostTwin)
    assert sup._crosscheck_interval == 4
    assert sup.rung_label(0) == "Ed25519BatchVerifier" and sup.name == "ed25519-engine"
    # No plain-torch rung: the ladder is the configured engine, then the host.
    assert sup.engine.device.type == "cpu"
    randomized = engine_for_config(cfg.with_(batch_verify_mode=True), device="cpu")
    assert [randomized.rung_label(i) for i in range(2)] == [
        "Ed25519RandomizedBatchVerifier", "HostTwin",
    ]
    assert randomized.randomized  # shape attributes come from the primary rung
    assert not isinstance(engine_for_config(Configuration(), device="cpu"), EngineSupervisor)


def test_config_validates_crosscheck_requires_supervision():
    Configuration(self_id=1, engine_supervision=True, engine_crosscheck_interval=2).validate()
    with pytest.raises(ValueError, match="requires engine_supervision"):
        Configuration(self_id=1, engine_crosscheck_interval=2).validate()
    with pytest.raises(ValueError, match="engine_crosscheck_interval"):
        Configuration(self_id=1, engine_supervision=True, engine_crosscheck_interval=-1).validate()


# --- differential: one seeded schedule through both supervisors ---------------


class _Script:
    """A numpy engine whose i-th device call follows ``actions[i]``: answer,
    raise, time out (the package's own ``LaunchTimeout``) or flip."""

    def __init__(self, actions, timeout_cls):
        self.actions = actions
        self.timeout_cls = timeout_cls
        self.calls = 0

    @staticmethod
    def _truth(sigs):
        return np.array([s[0] % 3 != 0 for s in sigs], dtype=bool)

    def verify_batch(self, msgs, sigs, keys):
        action = self.actions[self.calls % len(self.actions)]
        self.calls += 1
        if action == "raise":
            raise RuntimeError("scripted launch failure")
        if action == "timeout":
            raise self.timeout_cls("scripted wedge")
        out = self._truth(sigs)
        return ~out if action == "flip" else out

    def verify_host(self, msgs, sigs, keys):
        return self._truth(sigs)


def _schedule(seed: int, launches: int = 240):
    """(engine actions, per-launch (batch size, clock step)) from a seed."""
    rng = np.random.default_rng(seed)
    actions = rng.choice(
        ["ok", "raise", "timeout", "flip"], size=launches, p=[0.7, 0.1, 0.1, 0.1]
    ).tolist()
    steps = [(int(rng.integers(1, 7)), float(rng.choice([0.0, 0.5, 3.0, 40.0], p=[0.3, 0.2, 0.2, 0.3]))) for _ in range(launches)]
    batches = [
        [bytes([int(b)]) + b"sig" for b in rng.integers(0, 256, size=n)] for n, _ in steps
    ]
    return actions, steps, batches


def _drive(sup_mod, metrics_mod, actions, steps, batches):
    t = [0.0]
    engine = _Script(actions, sup_mod.LaunchTimeout)
    provider = metrics_mod.InMemoryProvider()
    sup = sup_mod.EngineSupervisor(
        [engine],
        clock=lambda: t[0],
        crosscheck_interval=3,
        backoff_initial=2.0,
        backoff_max=16.0,
        metrics=metrics_mod.Metrics(provider),
    )
    transitions = []
    sup.on_transition.append(lambda kind, reason, rung: transitions.append((kind, reason, rung)))
    trail = []
    for (n, step), sigs in zip(steps, batches):
        t[0] += step
        out = sup.verify_batch([b"m"] * n, sigs, [b"k"] * n)
        trail.append((sup.rung, out.tolist(), sup.health.suspect))
    engine_dump = {
        k: v for k, v in provider.dump().items() if k.startswith("engine_")
    }
    breakers = {c: (b.state, b.failures, b.opened_count) for c, b in sup.breakers.items()}
    return trail, transitions, engine_dump, breakers, engine.calls


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_fault_schedule_matches_jax_exactly(seed):
    actions, steps, batches = _schedule(seed)
    port = _drive(tsup, tmetrics, actions, steps, batches)
    assert port == _drive(jsup, jmetrics, actions, steps, batches)
    transitions = port[1]
    assert any(kind == "degrade" for kind, _, _ in transitions)
    assert any(kind == "recover" for kind, _, _ in transitions)


def test_seeded_schedules_cover_every_fault_class():
    degraded, mismatches = set(), 0
    for seed in (0, 1, 2):
        _, transitions, dump, _, _ = _drive(tsup, tmetrics, *_schedule(seed))
        degraded |= {reason for kind, reason, _ in transitions if kind == "degrade"}
        mismatches += dump[ENGINE_CROSSCHECK_MISMATCH_KEY]["value"]
    assert degraded == set(FAULT_CLASSES) and mismatches >= 1


def test_a_fault_during_another_class_probe_climbs_past_rung_0_as_in_jax():
    """A known fault of the reference, kept for parity (ROADMAP.md queue
    C3): a wrong answer caught during a launch_timeout probe pushes a
    second entry for the same ladder step, so a later free climb takes the
    rung to -1, which indexes the host twin for good."""
    actions = ["timeout", "flip", "ok", "ok", "ok"]
    ends = []
    for sup_mod in (tsup, jsup):
        t = [0.0]
        sup = sup_mod.EngineSupervisor(
            [_Script(actions, sup_mod.LaunchTimeout)],
            clock=lambda: t[0], crosscheck_interval=1, backoff_initial=2.0,
        )
        rungs = []
        for _ in range(5):
            sup.verify_batch([b"m"], [b"\x01sig"], [b"k"])
            rungs.append(sup.rung)
            t[0] += 3.0
        ends.append(rungs)
    assert ends[0] == ends[1] == [1, 1, 1, 0, -1]
