"""The port's protocol core against the JAX package's, on trivial crypto.

Seeded ``Cluster``s of ``TestApp`` replicas run the same scenario in both
packages on the simulated clock.  For every scenario the two must agree on
each replica's ledger, compared as decision bytes (the codec's encoding of
the proposals and their certificates), and on the whole recorded network
send sequence: virtual time, sender, target and the codec bytes of each
message.  Also: ``utils/quorum.py`` for n = 1..31, and
``Configuration``'s fields and ``validate()`` messages on seeded
configurations.  Tolerance 0: everything here is bytes and integers.
"""

from __future__ import annotations

import dataclasses
import random
from types import SimpleNamespace

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import consensus_tpu.config as jconfig
import consensus_tpu.testing as jtesting
import consensus_tpu.utils as jutils
import consensus_tpu.wire as jwire
import consensus_tpu_torch.config as tconfig
import consensus_tpu_torch.testing as ttesting
import consensus_tpu_torch.utils as tutils
import consensus_tpu_torch.wire as twire

JAX = SimpleNamespace(testing=jtesting, wire=jwire)
PORT = SimpleNamespace(testing=ttesting, wire=twire)

#: Short protocol timeouts so view changes and catch-up finish in a few
#: simulated minutes (the JAX package's scenario tests use the same).
FAST = {
    "request_forward_timeout": 1.0,
    "request_complain_timeout": 4.0,
    "request_auto_remove_timeout": 120.0,
    "view_change_resend_interval": 2.0,
    "view_change_timeout": 10.0,
    "leader_heartbeat_timeout": 20.0,
}


def record_sends(pkg, cluster) -> list:
    """Every message the simulated network accepts for delivery, as
    (virtual time, sender, target, bytes): requests as sent, consensus
    messages through the codec."""
    sends = []
    now = cluster.scheduler.now

    def recorder(sender, target, payload):
        data = payload if isinstance(payload, bytes) else pkg.wire.encode_message(payload)
        sends.append((now(), sender, target, data))
        return payload

    cluster.network.mutate_send = recorder
    return sends


def ledger_bytes(pkg, cluster) -> dict[int, list[bytes]]:
    out = {}
    for node_id, node in cluster.nodes.items():
        out[node_id] = [
            pkg.wire.encode_message(pkg.wire.SyncChunk(
                from_seq=i + 1, height=i + 1, decisions=(d.proposal,),
                quorum_certs=(tuple(d.signatures),),
            ))
            for i, d in enumerate(node.app.ledger)
        ]
    return out


def order(cluster, mk, blocks, start=0, node_ids=None, max_time=600.0):
    for i in range(start, start + blocks):
        cluster.submit_to_all(mk("c", i))
        assert cluster.run_until_ledger(i + 1, node_ids=node_ids, max_time=max_time), (
            f"block {i} was not ordered"
        )


def four_nodes_five_blocks(pkg, tmp_path):
    cluster = pkg.testing.Cluster(4, seed=11)
    sends = record_sends(pkg, cluster)
    cluster.start()
    order(cluster, pkg.testing.make_request, 5)
    return cluster, sends


def seven_nodes(pkg, tmp_path):
    cluster = pkg.testing.Cluster(7, seed=12)
    sends = record_sends(pkg, cluster)
    cluster.start()
    order(cluster, pkg.testing.make_request, 3)
    return cluster, sends


def leader_crash_view_change(pkg, tmp_path):
    cluster = pkg.testing.Cluster(4, seed=13, config_tweaks=FAST)
    sends = record_sends(pkg, cluster)
    cluster.start()
    order(cluster, pkg.testing.make_request, 2)
    cluster.nodes[1].crash()
    order(cluster, pkg.testing.make_request, 2, start=2, node_ids=[2, 3, 4], max_time=900.0)
    views = {cluster.nodes[i].consensus.controller.curr_view_number for i in (2, 3, 4)}
    assert views == {1}, "the survivors should have changed view once"
    return cluster, sends


def leader_rotation(pkg, tmp_path):
    cluster = pkg.testing.Cluster(
        4, seed=14, config_tweaks={"decisions_per_leader": 1}, leader_rotation=True
    )
    sends = record_sends(pkg, cluster)
    cluster.start()
    leaders = []
    for i in range(5):
        leaders.append(cluster.nodes[1].consensus.get_leader_id())
        order(cluster, pkg.testing.make_request, 1, start=i)
    assert len(set(leaders)) == 4, leaders
    return cluster, sends


def partition_then_wire_sync(pkg, tmp_path):
    cluster = pkg.testing.Cluster(4, seed=15, config_tweaks=FAST, sync_mode="wire")
    sends = record_sends(pkg, cluster)
    cluster.start()
    order(cluster, pkg.testing.make_request, 1)
    cluster.network.partition([4])
    order(cluster, pkg.testing.make_request, 4, start=1, node_ids=[1, 2, 3])
    assert len(cluster.nodes[4].app.ledger) == 1
    cluster.network.heal()
    order(cluster, pkg.testing.make_request, 1, start=5, max_time=900.0)
    assert len(cluster.nodes[4].app.ledger) == 6, "the partitioned node did not catch up"
    return cluster, sends


def file_wal_restart(pkg, tmp_path):
    cluster = pkg.testing.Cluster(4, seed=16, config_tweaks=FAST, wal_dir=str(tmp_path))
    sends = record_sends(pkg, cluster)
    cluster.start()
    order(cluster, pkg.testing.make_request, 2)
    for node_id in (2, 1):  # a follower, then the leader
        cluster.nodes[node_id].restart()
        cluster.scheduler.advance(30.0)
    order(cluster, pkg.testing.make_request, 2, start=2, max_time=900.0)
    return cluster, sends


SCENARIOS = {
    f.__name__: f
    for f in (
        four_nodes_five_blocks, seven_nodes, leader_crash_view_change,
        leader_rotation, partition_then_wire_sync, file_wal_restart,
    )
}


def _files(directory):
    return {
        str(p.relative_to(directory)): p.read_bytes()
        for p in sorted(directory.rglob("*")) if p.is_file()
    }


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_orders_and_sends_the_same_bytes_in_both_packages(name, tmp_path):
    run = SCENARIOS[name]
    jcluster, jsends = run(JAX, tmp_path / "jax")
    tcluster, tsends = run(PORT, tmp_path / "port")
    tcluster.assert_ledgers_consistent()
    assert ledger_bytes(PORT, tcluster) == ledger_bytes(JAX, jcluster)
    assert len(tsends) == len(jsends) > 100
    for k, (t, j) in enumerate(zip(tsends, jsends)):
        assert t == j, f"send {k} differs: port {t[:3]} jax {j[:3]}"
    assert tcluster.scheduler.now() == jcluster.scheduler.now()
    if name == "file_wal_restart":
        assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_quorum_arithmetic_matches():
    for n in range(1, 32):
        assert tutils.compute_quorum(n) == jutils.compute_quorum(n)
    for n in (0, -1):
        with pytest.raises(ValueError):
            tutils.compute_quorum(n)


def test_leader_and_blacklist_math_match():
    rng = random.Random(0)
    for n in range(1, 11):
        nodes = list(range(1, n + 1))
        f = (n - 1) // 3
        for view in range(12):
            for decisions in range(5):
                blacklist = tuple(sorted(rng.sample(nodes, rng.randrange(0, f + 1))))
                kw = dict(leader_rotation=view % 2 == 0, decisions_in_view=decisions,
                          decisions_per_leader=2, blacklist=blacklist)
                assert tutils.get_leader_id(view, n, nodes, **kw) == jutils.get_leader_id(
                    view, n, nodes, **kw)
                prepares = {s: rng.sample(nodes, rng.randrange(0, n + 1)) for s in nodes}
                update = dict(
                    prev_view=view, prev_seq=decisions + view, prev_decisions_in_view=decisions,
                    prev_blacklist=blacklist, current_view=view + rng.randrange(2),
                    current_leader=rng.choice(nodes), n=n, f=f, nodes=nodes,
                    leader_rotation=True, decisions_per_leader=2, prepares_from=prepares,
                )
                assert tutils.compute_blacklist_update(**update) == jutils.compute_blacklist_update(**update)
                assert tutils.prune_blacklist(blacklist, prepares, f, nodes) == jutils.prune_blacklist(
                    blacklist, prepares, f, nodes)


def _field_summary(module):
    return [
        (f.name, repr(f.default) if f.default is not dataclasses.MISSING else repr(f.default_factory()))
        for f in dataclasses.fields(module.Configuration)
    ]


def test_configuration_has_every_field_with_the_same_default():
    assert _field_summary(tconfig) == _field_summary(jconfig)
    for cls in ("TraceConfig", "ObsConfig", "CompileCacheConfig"):
        t, j = getattr(tconfig, cls)(), getattr(jconfig, cls)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(tconfig.default_config(3)) == dataclasses.asdict(jconfig.default_config(3))


_NUMBERS = st.sampled_from([-1, 0, 1, 2, 3, 5, 16])
_TIMES = st.sampled_from([-1.0, 0.0, 0.001, 1.0, 2.0, 20.0, 180.0])
_CONFIG = st.fixed_dictionaries({
    "self_id": st.sampled_from([0, 1, 7]),
    "request_batch_max_count": _NUMBERS,
    "request_batch_max_bytes": st.sampled_from([-1, 0, 100, 10 * 1024 * 1024]),
    "request_max_bytes": st.sampled_from([-1, 0, 100, 10 * 1024]),
    "request_batch_max_interval": _TIMES,
    "incoming_message_buffer_size": _NUMBERS,
    "request_pool_size": _NUMBERS,
    "request_forward_timeout": _TIMES,
    "request_complain_timeout": _TIMES,
    "request_auto_remove_timeout": _TIMES,
    "submit_timeout": _TIMES,
    "view_change_resend_interval": _TIMES,
    "view_change_timeout": _TIMES,
    "leader_heartbeat_timeout": _TIMES,
    "leader_heartbeat_count": _NUMBERS,
    "num_of_ticks_behind_before_syncing": _NUMBERS,
    "collect_timeout": _TIMES,
    "leader_rotation": st.booleans(),
    "decisions_per_leader": _NUMBERS,
    "pipeline_depth": _NUMBERS,
    "crypto_tpu_min_batch": _NUMBERS,
    "cert_mode": st.sampled_from(["full", "half-agg", "other"]),
    "mesh_shards": _NUMBERS,
    "mesh_topology": st.sampled_from([(), (2, 4), (0, 2), (8,)]),
    "engine_supervision": st.booleans(),
    "engine_crosscheck_interval": _NUMBERS,
    "min_compile_time_secs": st.sampled_from([-1.0, 0.0, 1.0]),
    "trace_capacity": st.sampled_from([0, 1, 65536]),
})


def _validate(module, knobs):
    knobs = dict(knobs)
    cache = module.CompileCacheConfig(min_compile_time_secs=knobs.pop("min_compile_time_secs"))
    trace = module.TraceConfig(capacity=knobs.pop("trace_capacity"))
    try:
        module.Configuration(compile_cache=cache, trace=trace, **knobs).validate()
    except ValueError as exc:
        return str(exc)
    return None


@settings(max_examples=300, deadline=None, derandomize=True)
@given(_CONFIG)
def test_validate_gives_the_same_message(knobs):
    assert _validate(tconfig, knobs) == _validate(jconfig, knobs)


def test_validate_accepts_the_default_and_names_every_fault():
    assert _validate(tconfig, {"self_id": 1, "min_compile_time_secs": 1.0, "trace_capacity": 1}) is None
    bad = {k: -1 for k in ("request_batch_max_count", "pipeline_depth", "mesh_shards")}
    msg = _validate(tconfig, {**bad, "min_compile_time_secs": -1.0, "trace_capacity": 0})
    assert msg == _validate(jconfig, {**bad, "min_compile_time_secs": -1.0, "trace_capacity": 0})
    assert msg.startswith("invalid configuration: self_id must be set (nonzero)")
    assert "compile_cache.min_compile_time_secs must be >= 0" in msg
