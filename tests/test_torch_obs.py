"""The port's observability plane held against the JAX package's.

``consensus_tpu_torch.obs`` (``sampler.py``, ``detectors.py``,
``export.py``, ``flightrec.py``) against ``consensus_tpu.obs``: the same
seeded chaos schedules with the plane on, run through both packages' chaos
engines, give byte-equal JSONL sample series, Prometheus scrape bodies,
detector firings, event logs and flight-record bundles, and the port's
fixed-seed 3-node scrape body equals the JAX package's golden file.  Then
the JAX package's own cases of ``tests/test_obs.py`` on the port.  The
``instrumented_jit`` cases stay with the JAX package: it wraps ``jax.jit``
and has no counterpart in the port.
"""

import json
import os

import pytest

import consensus_tpu.config as jconfig
import consensus_tpu.core.view as jview
import consensus_tpu.obs as jobs
import consensus_tpu.testing.chaos as jchaos
import consensus_tpu_torch.config as tconfig
import consensus_tpu_torch.core.view as tview
import consensus_tpu_torch.obs as tobs
import consensus_tpu_torch.testing.chaos as tchaos
from consensus_tpu_torch.config import ObsConfig
from consensus_tpu_torch.metrics import (
    OBS_ANOMALY_KEYS,
    OBS_SAMPLES_KEY,
    PINNED_METRIC_KEYS,
    InMemoryProvider,
    Metrics,
)
from consensus_tpu_torch.obs import (
    ClusterSampler,
    DetectorThresholds,
    load_flight_record,
    sample_to_prometheus,
    series_to_jsonl,
    sparkline,
)
from consensus_tpu_torch.obs.detectors import ANOMALY_KINDS, DetectorBank
from consensus_tpu_torch.obs.export import HEALTH_FIELDS, OPTIONAL_HEALTH_FIELDS, render_watch
from consensus_tpu_torch.obs.flightrec import FlightRecorder
from consensus_tpu_torch.runtime.scheduler import SimScheduler
from consensus_tpu_torch.testing.app import Cluster, make_request
from consensus_tpu_torch.testing.chaos import ChaosAction, ChaosEngine, ChaosSchedule

_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                       "obs_prometheus_3node.txt")

#: tests/test_obs.py's schedules: node 4 partitioned away for 100 sim-seconds
#: (commit_stall, sync_lag, verify_collapse), and leaders 1-3 crashed back
#: to back (view_change_storm, leader_flap at the widened thresholds).
PARTITION_ACTIONS = tuple(
    [("partition", 30.0, {"group": (4,)})]
    + [("loss", 40.0 + 10.0 * i, {"a": 1, "b": 2, "p": 0.0}) for i in range(8)]
    + [("heal", 130.0, {})]
)
CHURN_ACTIONS = (
    ("crash", 30.0, {"node": 1}), ("restart", 45.0, {"node": 1}),
    ("crash", 50.0, {"node": 2}), ("restart", 65.0, {"node": 2}),
    ("crash", 70.0, {"node": 3}), ("restart", 85.0, {"node": 3}),
    ("heal", 90.0, {}),
)
SENTINEL_ACTIONS = (
    ("loss", 35.0, {"a": 2, "b": 3, "p": 0.3}), ("delay", 50.0, {"a": 1, "b": 4, "d": 0.2}),
    ("crash", 65.0, {"node": 1}), ("duplicate", 80.0, {"a": 2, "b": 4, "p": 0.3}),
    ("heal", 95.0, {}), ("restart", 110.0, {"node": 1}),
    ("reorder", 130.0, {"a": 3, "b": 2, "p": 0.3}), ("heal", 150.0, {}),
)
CHURN_THRESHOLDS = dict(storm_views=3, storm_window=120.0, flap_changes=3, flap_window=120.0)


def _schedule(chaos, seed, actions, **kw):
    return chaos.ChaosSchedule(seed=seed, n=4, actions=tuple(
        chaos.ChaosAction(at=at, kind=kind, args=dict(args)) for kind, at, args in actions), **kw)


def _obs_run(chaos, obs_mod, config_mod, schedule, *, interval=5.0, thresholds=None,
             flight_dir=None):
    obs = config_mod.ObsConfig(
        enabled=True, sample_interval=interval,
        detector_thresholds=None if thresholds is None else obs_mod.DetectorThresholds(**thresholds),
    )
    engine = chaos.ChaosEngine(schedule, obs=obs, flight_dir=flight_dir)
    return engine, engine.run()


def _port_run(schedule, **kw):
    return _obs_run(tchaos, tobs, tconfig, schedule, **kw)


def _jax_run(schedule, **kw):
    return _obs_run(jchaos, jobs, jconfig, schedule, **kw)


def _exports(engine, result, obs_mod):
    sampler = engine.cluster.sampler
    return {
        "series": obs_mod.series_to_jsonl(sampler.samples()),
        "prometheus": obs_mod.sample_to_prometheus(sampler.last_sample()),
        "anomalies": [a.as_dict() for a in result.anomalies],
        "counts": sampler.anomaly_counts(),
        "final_health": result.final_health,
        "event_log": result.event_log,
        "ledgers": result.ledgers,
    }


def assert_same_plane(seed, actions=None, *, steps=8, **kw):
    """One schedule through both packages with the plane on: every export
    byte-equal.  Returns the port's engine and result."""
    if actions is None:
        tsched = ChaosSchedule.generate(seed, n=4, steps=steps)
        jsched = jchaos.ChaosSchedule.generate(seed, n=4, steps=steps)
    else:
        tsched = _schedule(tchaos, seed, actions)
        jsched = _schedule(jchaos, seed, actions)
    tengine, tres = _port_run(tsched, **kw)
    jengine, jres = _jax_run(jsched, **kw)
    assert _exports(tengine, tres, tobs) == _exports(jengine, jres, jobs)
    return tengine, tres


@pytest.fixture
def sentinel_bug():
    jview.SENTINEL_MISWIRED_QUORUM = True
    tview.SENTINEL_MISWIRED_QUORUM = True
    try:
        yield
    finally:
        jview.SENTINEL_MISWIRED_QUORUM = False
        tview.SENTINEL_MISWIRED_QUORUM = False


# --- the same exports as the JAX package ------------------------------------


@pytest.mark.parametrize("seed", [3, 5])
def test_seeded_chaos_run_exports_equal_the_jax_packages(seed):
    engine, result = assert_same_plane(seed)
    assert result.ok, result.violation
    assert engine.cluster.sampler.taken > 0


def test_partition_detectors_fire_as_in_the_jax_package():
    engine, result = assert_same_plane(11, PARTITION_ACTIONS, interval=2.0)
    assert result.ok, result.violation
    counts = engine.cluster.sampler.anomaly_counts()
    assert {"commit_stall", "sync_lag", "verify_collapse"} <= set(counts)
    assert len(result.anomalies) == sum(counts.values())
    pinned = 0
    for node in engine.cluster.nodes.values():
        dump = node.metrics.provider.dump()
        pinned += sum(dump[key]["value"] for key in OBS_ANOMALY_KEYS)
    assert pinned == len(result.anomalies)
    assert b"ANOMALY commit_stall" in result.event_log
    assert {a.node for a in result.anomalies} == {4}


def test_churn_detectors_fire_as_in_the_jax_package():
    engine, result = assert_same_plane(13, CHURN_ACTIONS, interval=2.0,
                                       thresholds=CHURN_THRESHOLDS)
    assert result.ok, result.violation
    assert {"view_change_storm", "leader_flap"} <= set(engine.cluster.sampler.anomaly_counts())


def test_flight_record_equals_the_jax_packages(sentinel_bug, tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    tsched = _schedule(tchaos, 7, SENTINEL_ACTIONS, durability_window=0.0)
    _, tres = _port_run(tsched, interval=2.0, flight_dir=str(tmp_path / "port"))
    _, jres = _jax_run(_schedule(jchaos, 7, SENTINEL_ACTIONS, durability_window=0.0),
                       interval=2.0, flight_dir=str(tmp_path / "jax"))
    assert not tres.ok and not jres.ok
    assert os.path.basename(tres.flightrec_path) == os.path.basename(jres.flightrec_path)
    with open(tres.flightrec_path, "rb") as a, open(jres.flightrec_path, "rb") as b:
        assert a.read() == b.read()
    ours, theirs = load_flight_record(tres.flightrec_path), jobs.load_flight_record(
        jres.flightrec_path)
    node = tres.violation.node
    for attr in ("seed", "reason", "detail", "triggers", "schedule_doc"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert ours.last_health(node) == theirs.last_health(node)
    assert ours.metrics_of(node) == theirs.metrics_of(node)
    # The JAX package's bundle loads in the port, and the port's in JAX.
    assert load_flight_record(jres.flightrec_path).last_health(node) == ours.last_health(node)


def _golden_sample(cluster_cls, obs_cls, request):
    cluster = cluster_cls(
        3, seed=42,
        config_tweaks={"request_batch_max_count": 1, "request_batch_max_interval": 0.01},
        obs=obs_cls(enabled=True, sample_interval=1.0),
    )
    cluster.start()
    for i in range(5):
        cluster.submit_to_all(request("golden", i))
    cluster.scheduler.advance(30.0)
    assert len(cluster.nodes[1].app.ledger) == 5
    return cluster.sampler.last_sample()


def _port_golden_sample():
    return _golden_sample(Cluster, ObsConfig, make_request)


def test_prometheus_export_matches_the_jax_golden_file():
    from consensus_tpu.testing.app import Cluster as JCluster
    from consensus_tpu.testing.app import make_request as jmake

    body = sample_to_prometheus(_port_golden_sample())
    with open(_GOLDEN, encoding="utf-8") as fh:
        assert body == fh.read()
    assert body == jobs.sample_to_prometheus(_golden_sample(JCluster, jconfig.ObsConfig, jmake))


# --- the JAX package's cases on the port ------------------------------------


def test_same_seed_chaos_run_exports_byte_identical_series():
    exports = []
    for _ in range(2):
        engine, result = _port_run(ChaosSchedule.generate(3, n=4, steps=8))
        assert result.ok, result.violation
        sampler = engine.cluster.sampler
        assert sampler is not None and sampler.taken > 0
        exports.append((series_to_jsonl(sampler.samples()),
                        sample_to_prometheus(sampler.last_sample())))
    assert exports[0] == exports[1]


def test_sampling_is_observationally_transparent():
    schedule = ChaosSchedule.generate(3, n=4, steps=8)
    plain = ChaosEngine(schedule).run()
    engine, observed = _port_run(schedule)
    assert plain.ok and observed.ok
    assert observed.anomalies == ()
    assert observed.ledgers == plain.ledgers
    assert observed.event_log == plain.event_log
    assert set(observed.final_health) == {"1", "2", "3", "4"}
    for health in observed.final_health.values():
        assert set(HEALTH_FIELDS) - set(OPTIONAL_HEALTH_FIELDS) <= set(health)
        assert not set(OPTIONAL_HEALTH_FIELDS) & set(health)
    for node in engine.cluster.nodes.values():
        assert node.metrics.provider.dump()[OBS_SAMPLES_KEY]["value"] == \
            engine.cluster.sampler.taken


def test_quiet_cluster_soak_is_anomaly_free():
    engine, result = _port_run(ChaosSchedule(seed=7, n=4, actions=()), interval=2.0)
    assert result.ok, result.violation
    assert result.anomalies == ()
    assert engine.cluster.sampler.anomaly_counts() == {}
    for health in result.final_health.values():
        assert health["running"] and health["view"] == 0


def test_wal_corruption_and_stall_detectors_edge_trigger():
    bank = DetectorBank()

    def sample(t, fenced, degraded):
        h = {"running": True, "ledger": 1, "pool": 0}
        if fenced is not None:
            h["wal_fenced"] = fenced
        if degraded is not None:
            h["wal_degraded"] = degraded
        return [a.kind for a in bank.evaluate(t, {2: h})]

    assert sample(0.0, None, None) == []
    assert sample(1.0, True, False) == ["wal_corruption"]
    assert sample(2.0, True, False) == []
    assert sample(3.0, True, True) == ["wal_stall"]
    assert sample(4.0, True, True) == []
    assert sample(5.0, False, False) == []
    assert sample(6.0, True, False) == ["wal_corruption"]
    assert sample(7.0, None, None) == []
    assert sample(8.0, True, False) == ["wal_corruption"]


def test_detector_firings_are_deterministic():
    runs = []
    for _ in range(2):
        _, result = _port_run(_schedule(tchaos, 11, PARTITION_ACTIONS), interval=2.0)
        runs.append([a.as_dict() for a in result.anomalies])
    assert runs[0] == runs[1]
    assert runs[0]


def test_flight_recorder_reconstructs_sentinel_failure_without_rerun(sentinel_bug, tmp_path):
    sched = _schedule(tchaos, 7, SENTINEL_ACTIONS, durability_window=0.0)
    _, result = _port_run(sched, interval=2.0, flight_dir=str(tmp_path))
    assert not result.ok
    assert result.flightrec_path is not None and os.path.exists(result.flightrec_path)
    assert not os.path.exists(result.flightrec_path + ".tmp")
    violation = result.violation
    rec = load_flight_record(result.flightrec_path)
    assert rec.seed == sched.seed
    assert rec.reason == "invariant"
    assert "quorum-cert" in rec.detail and "quorum is 3" in rec.detail
    assert rec.triggers[0]["node"] == violation.node
    assert rec.triggers[0]["t"] == round(violation.sim_time, 6)
    health = rec.last_health(violation.node)
    assert health is not None
    assert health["view"] >= 1
    assert health["leader"] not in (-1, 1)
    assert health["in_flight"] >= 0
    assert health["ledger"] >= 1
    assert rec.schedule_doc["seed"] == sched.seed
    assert len(rec.schedule_doc["actions"]) == len(sched.actions)
    metrics = rec.metrics_of(violation.node)
    assert metrics is not None and OBS_SAMPLES_KEY in metrics


def test_flight_recorder_crash_point_and_exception_seams(tmp_path):
    sched = SimScheduler()
    rec = FlightRecorder(seed=99, out_dir=str(tmp_path), clock=sched.now)
    rec.attach_scheduler(sched)
    rec.on_fault_fired("state.save.commit.pre", 1)
    first = load_flight_record(rec.path)
    assert first.reason == "crash-point"
    assert "state.save.commit.pre" in first.detail

    def boom():
        raise RuntimeError("kaput")

    sched.call_later(1.0, boom, name="boom")
    sched.advance(2.0)
    redumped = load_flight_record(rec.path)
    assert redumped.reason == "crash-point"
    assert [t["reason"] for t in redumped.triggers] == ["crash-point", "unhandled-exception"]
    assert "kaput" in redumped.triggers[1]["detail"]
    assert redumped.triggers[1]["t"] == 1.0


def test_flight_record_loader_rejects_unknown_version(tmp_path):
    path = tmp_path / "flightrec_0.json"
    path.write_text(json.dumps({"flightrec_version": 999}))
    with pytest.raises(ValueError, match="unsupported flightrec version"):
        load_flight_record(str(path))


def test_prometheus_export_is_well_formed_and_sorted():
    body = sample_to_prometheus(_port_golden_sample())
    lines = body.splitlines()
    assert body.endswith("\n")
    families = []
    for line in lines:
        if line.startswith("# TYPE "):
            families.append(line.split()[2])
        else:
            name = line.partition("{")[0].partition(" ")[0]
            assert name == families[-1], "sample outside its family block"
            value = line.rpartition(" ")[2]
            float(value)
            assert not value.endswith(".0"), "integers export without .0"
    assert families == sorted(families)
    assert "obs_sample_time" in families
    for field in HEALTH_FIELDS:
        if field not in OPTIONAL_HEALTH_FIELDS:
            assert f"obs_health_{field}" in families
    assert 'obs_health_ledger{node="1"} 5' in lines
    assert 'obs_health_ledger{node="3"} 5' in lines


def test_jsonl_series_is_canonical_sorted_compact_json():
    engine, _ = _port_run(ChaosSchedule(seed=7, n=4, actions=()), interval=5.0)
    samples = engine.cluster.sampler.samples()
    lines = series_to_jsonl(samples).splitlines()
    assert len(lines) == len(samples)
    for line, sample in zip(lines, samples):
        assert line == json.dumps(sample, sort_keys=True, separators=(",", ":"))
        assert set(json.loads(line)) == {"t", "i", "nodes", "anomalies"}


def test_sparkline_rendering_equals_the_jax_packages():
    assert sparkline([]) == ""
    assert sparkline([3, 3, 3]) == "▁▁▁"
    assert sparkline(range(8)) == "▁▂▃▄▅▆▇█"
    assert len(sparkline(range(100), width=10)) == 10
    assert sparkline([0] * 99 + [1], width=2) == "▁█"
    for series, width in (([5, 1, 4, 1, 5, 9, 2, 6], 8), (list(range(50)), 7)):
        assert sparkline(series, width=width) == jobs.sparkline(series, width=width)


def test_render_watch_panel_equals_the_jax_packages():
    from consensus_tpu.obs.export import render_watch as jrender

    samples = [
        {"t": float(i), "i": i, "nodes": {
            "1": {"health": {"ledger": i, "pool": 0, "in_flight": 1}},
            "2": {"health": {"ledger": i + 1, "pool": 2, "in_flight": 0}},
        }, "anomalies": []}
        for i in range(4)
    ]
    panel = render_watch(samples)
    rows = panel.splitlines()
    assert len(rows) == 3
    for field, row in zip(("ledger", "pool", "in_flight"), rows):
        assert field in row
    assert rows[0].rstrip().endswith("4")
    assert panel == jrender(samples)


def test_pinned_metric_registry_covers_the_detectors():
    provider = InMemoryProvider()
    Metrics(provider)
    dump = provider.dump()
    for key in OBS_ANOMALY_KEYS + (OBS_SAMPLES_KEY,):
        assert key in PINNED_METRIC_KEYS and key in dump
    assert tuple(f"obs_anomaly_{kind}" for kind in ANOMALY_KINDS) == OBS_ANOMALY_KEYS
    from consensus_tpu.obs.detectors import ANOMALY_KINDS as JKINDS

    assert ANOMALY_KINDS == JKINDS


def test_disabled_obs_plane_samples_nothing_and_installs_nothing():
    before = ClusterSampler.total_samples
    cluster = Cluster(4, seed=31, config_tweaks={"request_batch_max_count": 1,
                                                 "request_batch_max_interval": 0.01})
    assert cluster.sampler is None
    cluster.start()
    for i in range(20):
        cluster.submit_to_all(make_request("off", i))
    assert cluster.run_until_ledger(20)
    assert ClusterSampler.total_samples == before
    assert all(node.metrics is None for node in cluster.nodes.values())


def test_obs_config_builds_a_sampler_and_validates_knobs():
    """``Cluster(obs=ObsConfig(enabled=True))`` builds the port's sampler
    (it raised before the plane was ported) and refuses bad knobs."""
    cluster = Cluster(4, obs=ObsConfig(enabled=True, sample_interval=2.0))
    assert isinstance(cluster.sampler, ClusterSampler)
    with pytest.raises(ValueError, match="sample_interval"):
        Cluster(4, obs=ObsConfig(enabled=True, sample_interval=0.0))
    with pytest.raises(ValueError, match="ring_capacity"):
        ObsConfig(enabled=True, ring_capacity=0).validate()
    assert Cluster(4, obs=ObsConfig(enabled=False, sample_interval=-1.0)).sampler is None


def test_detector_thresholds_are_the_jax_packages():
    assert DetectorThresholds() == DetectorThresholds(**vars(jobs.DetectorThresholds()))
