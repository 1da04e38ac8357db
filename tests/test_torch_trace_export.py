"""The port's trace exporters and critical-path report held against the JAX
package's.

``consensus_tpu_torch.trace.export`` and ``trace.report`` against
``consensus_tpu.trace``: the same seeded traced clusters, run in both
packages, give byte-equal Chrome/Perfetto JSON and JSONL exports, equal
reports and an equal rendered table.  Then the JAX package's own cases of
``tests/test_trace.py`` that read the exporters, on the port.
"""

import json

import pytest

import consensus_tpu.config as jconfig
import consensus_tpu.testing.app as japp
import consensus_tpu.trace as jtrace
from consensus_tpu_torch.config import TraceConfig
from consensus_tpu_torch.metrics import (
    VERIFY_LAUNCH_BATCH_KEY,
    WAL_RECORDS_PER_FSYNC_KEY,
    InMemoryProvider,
    Metrics,
)
from consensus_tpu_torch.testing.app import Cluster, make_request
from consensus_tpu_torch.testing.faults import FaultPlan
from consensus_tpu_torch.trace import (
    build_report,
    chrome_trace_events,
    format_table,
    to_chrome_json,
    to_jsonl,
)

DECISIONS = 50


def _tweaks(trace_config, **extra):
    tweaks = {"trace": trace_config(enabled=True), "request_batch_max_count": 1,
              "request_batch_max_interval": 0.01}
    tweaks.update(extra)
    return tweaks


def _run(cluster_cls, request, trace_config, seed, decisions, tag="trace", requests=None,
         **tweaks):
    cluster = cluster_cls(4, seed=seed, config_tweaks=_tweaks(trace_config, **tweaks))
    cluster.start()
    for i in range(decisions if requests is None else requests):
        cluster.submit_to_all(request(tag, i))
    assert cluster.run_until_ledger(decisions, max_time=120.0)
    return cluster


def _port_cluster(seed=7, decisions=DECISIONS, **kw):
    return _run(Cluster, make_request, TraceConfig, seed, decisions, **kw)


def _jax_cluster(seed=7, decisions=DECISIONS, **kw):
    return _run(japp.Cluster, japp.make_request, jconfig.TraceConfig, seed, decisions, **kw)


# --- the same exports as the JAX package ------------------------------------


@pytest.mark.parametrize("seed,decisions,kw", [
    (7, DECISIONS, {}),
    (11, DECISIONS, {}),
    (41, 24, {"requests": 48, "pipeline_depth": 4, "request_batch_max_count": 2,
              "request_batch_max_interval": 0.005}),
])
def test_exports_and_report_equal_the_jax_packages(seed, decisions, kw):
    ours = _port_cluster(seed=seed, decisions=decisions, **kw)
    theirs = _jax_cluster(seed=seed, decisions=decisions, **kw)
    for node in (1, 2):
        ev, jev = (c.nodes[node].consensus.tracer.events() for c in (ours, theirs))
        assert ev == jev
        assert to_chrome_json(ev) == jtrace.to_chrome_json(jev)
        assert to_jsonl(ev) == jtrace.to_jsonl(jev)
        assert chrome_trace_events(ev) == jtrace.chrome_trace_events(jev)
        report = build_report(ev)
        assert report == jtrace.build_report(jev)
        assert format_table(report) == jtrace.format_table(report)


def test_written_files_equal_the_jax_packages(tmp_path):
    from consensus_tpu_torch.trace import write_chrome_trace, write_jsonl

    ev = _port_cluster(seed=13, decisions=5).nodes[1].consensus.tracer.events()
    write_chrome_trace(str(tmp_path / "port.json"), ev)
    jtrace.write_chrome_trace(str(tmp_path / "jax.json"), ev)
    write_jsonl(str(tmp_path / "port.jsonl"), ev)
    jtrace.write_jsonl(str(tmp_path / "jax.jsonl"), ev)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()


# --- the JAX package's cases on the port ------------------------------------


def test_same_seed_exports_byte_identical_span_streams():
    streams = []
    for _ in range(2):
        tracer = _port_cluster(seed=7).nodes[1].consensus.tracer
        streams.append((to_chrome_json(tracer.events()), to_jsonl(tracer.events())))
    assert streams[0] == streams[1]


def test_chrome_export_valid_spans_nest_and_chains_complete():
    tracer = _port_cluster(seed=11).nodes[1].consensus.tracer
    doc = json.loads(to_chrome_json(tracer.events()))
    assert doc["displayTimeUnit"] == "ms"
    records = doc["traceEvents"]
    assert records
    open_spans = {}
    for ev in records:
        if ev["ph"] not in ("b", "e"):
            continue
        key = (ev["cat"], ev["id"], ev["name"])
        depth = open_spans.get(key, 0)
        if ev["ph"] == "b":
            assert depth == 0, f"double-begin for {key}"
            open_spans[key] = 1
        else:
            assert depth == 1, f"end-without-begin for {key}"
            open_spans[key] = 0
        assert ev["ts"] >= 0
    assert not [k for k, d in open_spans.items() if d]
    report = build_report(tracer.events())
    assert report["n_decisions"] == DECISIONS
    assert report["n_complete"] == DECISIONS
    assert sorted(seq for (seq, _view) in report["decisions"]) == list(range(1, DECISIONS + 1))
    for phase in ("pre_prepare", "prepare", "commit", "deliver"):
        stats = report["phase_percentiles"][phase]
        assert stats["n"] == DECISIONS
        assert stats["p50"] >= 0.0 and stats["p99"] >= stats["p50"]
    table = format_table(report)
    for phase in report["phase_percentiles"]:
        assert phase in table


def test_jsonl_export_one_valid_object_per_event():
    tracer = _port_cluster(seed=13, decisions=5).nodes[1].consensus.tracer
    lines = to_jsonl(tracer.events()).splitlines()
    assert len(lines) == len(tracer.events())
    for line in lines:
        obj = json.loads(line)
        assert obj["ph"] in ("B", "E", "i")
        assert isinstance(obj["ts"], float)


def test_critical_path_report_with_pipelined_decisions_in_flight():
    decisions = 24
    cluster = _port_cluster(seed=41, decisions=decisions, requests=decisions * 2,
                            tag="pipe", pipeline_depth=4, request_batch_max_count=2,
                            request_batch_max_interval=0.005)
    events = cluster.nodes[1].consensus.tracer.events()
    open_now = max_open = 0
    for ph, _track, name, _ts, _seq, _view, _args in events:
        if name == "decision":
            open_now += 1 if ph == "B" else -1
            max_open = max(max_open, open_now)
    assert max_open > 1, "depth=4 run never pipelined"
    report = build_report(events)
    assert report["n_decisions"] == decisions
    assert report["n_complete"] == decisions
    for phase in ("pool_wait", "seal_wait"):
        assert report["phase_percentiles"][phase]["n"] == decisions
        assert report["phase_percentiles"][phase]["p50"] >= 0.0
    for d in report["decisions"].values():
        assert d["phases"]["pool_wait"] >= 0.0
        assert d["phases"]["seal_wait"] >= 0.0
    admits = sum(1 for ev in events if ev[0] == "i" and ev[2] == "pool.admit")
    sealed = sum((ev[6] or {}).get("count", 1) for ev in events
                 if ev[0] == "i" and ev[2] == "batch.seal")
    assert sealed <= admits


def test_crash_trace_contains_fired_fault_instant():
    cluster = Cluster(4, seed=23, config_tweaks=_tweaks(TraceConfig))
    cluster.start()
    victim = cluster.nodes[2]
    point = "state.save.commit.pre"
    plan = FaultPlan(point, label="trace-visibility")
    victim.arm_fault_plan(plan)
    tracer = victim.consensus.tracer
    for i in range(3):
        cluster.submit_to_all(make_request("crash", i))
    assert cluster.run_until_ledger(1, node_ids=[1, 3, 4])
    assert plan.fired == (point, 1)
    fired = [ev for ev in tracer.events()
             if ev[0] == "i" and ev[1] == "fault" and ev[2] == "fault.fired"]
    assert len(fired) == 1
    assert fired[0][6] == {"point": point, "hit": 1}
    assert json.loads(to_jsonl(fired))["args"] == {"point": point, "hit": 1}


def test_dump_keys_pinned_and_trace_feeds_same_values():
    assert VERIFY_LAUNCH_BATCH_KEY == "consensus_cross_slot_verify_batch"
    assert WAL_RECORDS_PER_FSYNC_KEY == "consensus_wal_records_per_fsync"
    provider = InMemoryProvider()
    cluster = Cluster(4, seed=17, config_tweaks=_tweaks(TraceConfig), durability_window=0.02)
    cluster.nodes[1].metrics = Metrics(provider)
    cluster.start()
    for i in range(20):
        cluster.submit_to_all(make_request("par", i))
    assert cluster.run_until_ledger(20)
    report = build_report(cluster.nodes[1].consensus.tracer.events())
    dump = provider.dump()
    assert report["verify_launch_sizes"] == dump[VERIFY_LAUNCH_BATCH_KEY]["observations"]
    assert report["fsync_records"]
    assert report["fsync_records"][-1] == dump[WAL_RECORDS_PER_FSYNC_KEY]["value"]
