"""The deployment rig and the consensus groups across the two packages.

- ``cluster.json`` written by either package loads in the other and is
  written back byte for byte (the device never enters the spec);
- the derived identities, the client keyring's signed requests and the
  seeded process-chaos schedule are identical on the same namespace and
  seed;
- a sharded cluster on the same seed gives identical per-group ledgers and
  identical cert workloads, and the cross-group chaos engine identical
  results on the same schedules;
- a mixed process cluster: one spec, replicas 1-2 from the JAX package's
  ``replica_main`` and 3-4 from the port's (``--device cpu``), one port
  sidecar, ordering 20 decisions with prefix agreement; replica 2 is then
  killed -9 and restarted as a port process on its JAX-written WAL, and
  rejoins to the cluster's height.
"""

import contextlib
import json
import os
import time

import pytest

import chip_smoke
import consensus_tpu.deploy as jdeploy
import consensus_tpu.deploy.identity as jidentity
import consensus_tpu.groups as jgroups
import consensus_tpu_torch.deploy as tdeploy
import consensus_tpu_torch.deploy.identity as tidentity
import consensus_tpu_torch.groups as tgroups

PACKAGES = {"jax": jdeploy, "port": tdeploy}


# --- the spec -----------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_cluster_json_crosses_packages_byte_for_byte(tmp_path, writer, reader):
    spec = PACKAGES[writer].ClusterSpec.generate(
        4, 2, str(tmp_path), clients=5,
        config_overrides={"request_batch_max_count": 1, "view_change_timeout": 2.5},
    )
    spec.add_sidecar()
    path = spec.write()
    with open(path, "rb") as fh:
        written = fh.read()
    loaded = PACKAGES[reader].ClusterSpec.load(path)
    assert loaded.node_ids() == spec.node_ids()
    assert loaded.comm_addresses() == spec.comm_addresses()
    assert loaded.sidecar_addresses() == spec.sidecar_addresses()
    assert loaded.auth_secret == spec.auth_secret
    assert loaded.make_configuration(3).view_change_timeout == 2.5
    os.remove(path)
    assert loaded.write() == path
    with open(path, "rb") as fh:
        assert fh.read() == written
    assert "device" not in json.loads(written)


# --- identities, requests and process chaos ------------------------------------


def test_identities_and_client_requests_are_identical():
    namespace = "00c0ffee12345678"
    assert (jidentity.make_node_keys(namespace, [1, 2, 3, 4, 7])
            == tidentity.make_node_keys(namespace, [1, 2, 3, 4, 7]))
    jring = jidentity.make_client_keyring(namespace, 5)
    tring = tidentity.make_client_keyring(namespace, 5)
    assert jring.public_keys == tring.public_keys
    for client in range(5):
        for seq in (0, 1, (client << 32) | 9):
            assert jring.make_request(client, seq) == tring.make_request(client, seq)
    jsigner = jidentity.make_node_signer(namespace, 2)
    tsigner = tidentity.make_node_signer(namespace, 2)
    assert jsigner.sign_raw(b"ctpu") == tsigner.sign_raw(b"ctpu")


class _RecordingLauncher:
    """Launcher double recording chaos verbs (no processes)."""

    def __init__(self, sidecar_ids=("sc-0", "sc-1")):
        self.replicas = {i: None for i in (1, 2, 3, 4, 5)}
        self.sidecars = {s: None for s in sidecar_ids}
        self.calls = []

    def leader_id(self):
        return min(self.replicas)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def verb(*args, **kw):
            self.calls.append((name, args, tuple(sorted(kw.items()))))
        return verb


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_process_chaos_schedule_is_identical(seed):
    runs = {}
    for name, package in PACKAGES.items():
        launcher = _RecordingLauncher()
        sched = package.ProcessChaosSchedule(launcher, seed=seed)
        for _ in range(12):
            sched.step()
        sched.quiesce()
        runs[name] = (sched.history, launcher.calls)
    assert runs["jax"] == runs["port"]
    assert jdeploy.DEFAULT_ACTION_WEIGHTS == tdeploy.DEFAULT_ACTION_WEIGHTS
    assert jdeploy.STORAGE_FAULT_KINDS == tdeploy.STORAGE_FAULT_KINDS


# --- the sharded cluster -----------------------------------------------------


def _sharded(package, seed):
    shard = package.ShardedCluster(2, n=4, seed=seed)
    shard.start()
    for r in range(3):
        for t in range(8):
            shard.submit(f"tenant-{t}", b"w%d" % r)
        assert shard.run_until_heights(r + 1, max_time=600.0)
    shard.assert_clean()
    return shard


def test_sharded_cluster_ledgers_and_cert_workload_are_identical():
    jshard, tshard = _sharded(jgroups, 3), _sharded(tgroups, 3)
    assert jshard.ledger_digests() == tshard.ledger_digests()
    assert jshard.heights() == tshard.heights()
    jwork, twork = jshard.cert_workload(), tshard.cert_workload()
    assert jwork == twork
    assert sum(len(b) for b in twork.values()) >= 4


@pytest.mark.parametrize("seed,steps,sentinel", [
    (5, 6, False), (22, 6, False), (3, 5, False), (3, 5, True),
])
def test_group_chaos_results_are_identical(seed, steps, sentinel):
    jsched = jgroups.GroupChaosSchedule.generate(seed, steps=steps)
    tsched = tgroups.GroupChaosSchedule.generate(seed, steps=steps)
    assert repr(jsched) == repr(tsched)
    a = jgroups.GroupChaosEngine(jsched, sentinel_one_sided=sentinel).run()
    b = tgroups.GroupChaosEngine(tsched, sentinel_one_sided=sentinel).run()
    assert (a.ok, a.event_log, a.ledgers, a.resolution, a.txid, a.deliveries) == (
        b.ok, b.event_log, b.ledgers, b.resolution, b.txid, b.deliveries)
    assert a.ok is not sentinel
    if sentinel:
        assert (a.violation.invariant, a.violation.detail) == (
            b.violation.invariant, b.violation.detail)
        assert b.violation.invariant == "cross-group-atomicity"


# --- a process cluster of both packages ---------------------------------------


class _MixedLauncher(tdeploy.ClusterLauncher):
    """Replicas in ``jax_nodes`` run the JAX package's main; the others and
    every sidecar run the port's (``--device cpu``)."""

    def __init__(self, spec, jax_nodes, **kw):
        super().__init__(spec, device="cpu", **kw)
        self.jax_nodes = set(jax_nodes)

    def _replica_argv(self, node_id):
        if node_id in self.jax_nodes:
            return [
                self.python, "-m", "consensus_tpu.deploy.replica_main",
                "--config", self.spec.config_path, "--node-id", str(node_id),
            ]
        return super()._replica_argv(node_id)

    def port_argv(self, node_id):
        return super()._replica_argv(node_id)


def test_mixed_process_cluster_and_a_port_restart_on_a_jax_wal(tmp_path):
    spec = tdeploy.ClusterSpec.generate(
        4, 1, str(tmp_path), config_overrides={"request_batch_max_count": 1},
        hold_ports=True,
    )
    launcher = _MixedLauncher(spec, jax_nodes=(1, 2))
    held = contextlib.ExitStack()
    injector = None
    try:
        launcher.start(timeout=120)
        client_port = held.enter_context(chip_smoke.held_ports(1))[0]
        argv = {i: sup.argv for i, sup in launcher.replicas.items()}
        assert [i for i, a in argv.items() if "consensus_tpu.deploy.replica_main" in a] == [1, 2]
        assert all(a[-2:] == ["--device", "cpu"] for i, a in argv.items() if i > 2)
        assert launcher.sidecars["sc-0"].argv[-2:] == ["--device", "cpu"]
        assert "consensus_tpu_torch.deploy.sidecar_main" in launcher.sidecars["sc-0"].argv
        injector = chip_smoke.RigInjector(spec, client_port)
        injector.submit(20)
        assert launcher.wait_height(20, timeout=90), launcher.heights()
        launcher.observe_invariants()
        launcher.monitor.assert_clean()
        assert len(launcher.monitor.agreed) >= 20

        # Replica 2 dies by kill -9 and comes back as the port's main on
        # the WAL the JAX main wrote.
        wal_dir = spec.replica(2).wal_dir
        assert os.listdir(wal_dir)
        sup = launcher.replicas[2]
        sup.argv = launcher.port_argv(2)
        height = max(launcher.heights().values())
        launcher.kill_replica(2)
        injector.submit(3)
        target = height + 3
        assert launcher.wait_height(target, timeout=60, min_nodes=3), launcher.heights()
        deadline = time.monotonic() + 90.0
        health = None
        while time.monotonic() < deadline:
            health = sup.probe()
            if health and health.get("restarted") and health.get("ledger", 0) >= target:
                break
            time.sleep(0.2)
        assert health and health.get("restarted") and health["ledger"] >= target, health
        assert sup.restarts >= 1
        assert sup.spawned[-1].args == launcher.port_argv(2)
        launcher.observe_invariants()
        launcher.monitor.assert_clean()
    finally:
        if injector is not None:
            injector.stop()
        held.close()
        summary = launcher.stop()
    assert summary["orphans"] == [] and summary["leaked_ports"] == []
