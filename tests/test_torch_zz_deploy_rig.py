"""The JAX package's process-rig tests (``tests/test_zz_deploy_rig.py``) on
the port's ``deploy/``, its imports renamed (``torch_mirror``): real OS
processes of the port's ``replica_main`` and ``sidecar_main`` over real TCP
sockets and file-backed WALs.  The file sorts last for the same reason as
the JAX file: its subprocess tests must not displace the fast suite.

The smoke and the acceptance run launch the port's mains, which refuse to
start without a card unless they are asked for the CPU; both run below
with ``device="cpu"`` given to ``ClusterLauncher`` as their only change
(``--device cpu`` in every child's argv).  The acceptance run stays
``slow``, as in the JAX file.  The soak drives ``scripts/soak.py``, which
runs the JAX package, and is dropped.
"""

import time

import pytest

from torch_mirror import mirror

_CPU = ("launches the port's mains with no device, which they refuse without "
        "a card; re-written below with device=\"cpu\"")
mirror("test_zz_deploy_rig", globals(), drop={
    "test_cluster_smoke_orders_decisions": _CPU,
    "test_acceptance_kill9_leader_sidecar_and_rejoin": _CPU,
    "test_soak_ci_scale": (
        "runs scripts/soak.py, which drives the JAX package; scripts are not "
        "modules of the package (ROADMAP.md queue A)"
    ),
})


def test_cluster_smoke_orders_decisions(tmp_path):
    """3 replicas + 1 sidecar as real subprocesses order ~20 decisions
    through real sockets; teardown leaves zero orphans / leaked ports."""
    spec = ClusterSpec.generate(  # noqa: F821
        3, 1, str(tmp_path),
        config_overrides={"request_batch_max_count": 1},  # 1 request = 1 decision
    )
    launcher = ClusterLauncher(spec, device="cpu")  # noqa: F821
    injector = None
    try:
        launcher.start(timeout=120)
        health = launcher.health()
        assert health["sc-0"]["role"] == "sidecar"
        assert all(
            health[f"replica-{i}"]["ok"] for i in spec.node_ids()
        )
        injector = _Injector(spec)  # noqa: F821
        injector.submit(20)
        assert launcher.wait_height(20, timeout=60), (
            f"cluster never reached height 20: {launcher.heights()}"
        )
        # Prefix agreement across every process's reported ledger.
        launcher.observe_invariants()
        launcher.monitor.assert_clean()
        assert len(launcher.monitor.agreed) >= 20
        # The obs plane scrapes every replica over its control socket.
        bodies = launcher.scrape()
        assert set(bodies) == {f"replica-{i}" for i in spec.node_ids()}
        assert all("obs_sample_time" in b for b in bodies.values())
    finally:
        if injector is not None:
            injector.stop()
        summary = launcher.stop()  # raises on orphans / leaked ports
    assert summary["orphans"] == [] and summary["leaked_ports"] == []


@pytest.mark.slow
def test_acceptance_kill9_leader_sidecar_and_rejoin(tmp_path):
    """The acceptance run on a 5-replica (f=1) cluster."""
    spec = ClusterSpec.generate(  # noqa: F821
        5, 2, str(tmp_path),
        config_overrides={
            "view_change_timeout": 3.0,
            "view_change_resend_interval": 1.0,
            "leader_heartbeat_timeout": 2.0,
            "leader_heartbeat_count": 8,
        },
    )
    # Supervisor backoff well past the view-change window: the killed
    # leader must come back AFTER the survivors elected a successor, so
    # the run proves the view change rather than a fast restart.
    launcher = ClusterLauncher(spec, backoff_initial=8.0, device="cpu")  # noqa: F821
    injector = None
    try:
        launcher.start(timeout=180)
        injector = _Injector(spec)  # noqa: F821
        injector.submit(5)
        assert launcher.wait_height(1, timeout=30)
        old_leader = launcher.leader_id()
        assert old_leader is not None

        # --- leg 1: kill -9 the current leader -> view change completes,
        # ordering resumes among the surviving 4 (quorum with f=1).
        launcher.kill_replica(old_leader)
        view_advanced = False
        deadline = time.monotonic() + 40.0
        while time.monotonic() < deadline:
            views = [
                h["view"]
                for i, sup in launcher.replicas.items()
                if i != old_leader and (h := sup.probe()) is not None
            ]
            if views and max(views) >= 1:
                view_advanced = True
                break
            time.sleep(0.2)
        assert view_advanced, "view change never completed after leader kill"
        h0 = max(launcher.heights().values())
        resumed = False
        deadline = time.monotonic() + 40.0
        while time.monotonic() < deadline:
            injector.submit(2)
            reached = sum(
                1 for v in launcher.heights().values() if v >= h0 + 1
            )
            if reached >= 4:
                resumed = True
                break
            time.sleep(0.5)
        assert resumed, f"ordering did not resume: {launcher.heights()}"
        new_leader = launcher.leader_id()
        assert new_leader != old_leader

        # --- leg 2: kill -9 one sidecar -> replicas reroute verification
        # through the surviving fleet member; ordering continues.
        launcher.kill_sidecar("sc-0")
        h1 = max(launcher.heights().values())
        ok = False
        deadline = time.monotonic() + 40.0
        while time.monotonic() < deadline:
            injector.submit(2)
            if sum(1 for v in launcher.heights().values() if v >= h1 + 1) >= 4:
                ok = True
                break
            time.sleep(0.5)
        assert ok, f"ordering stalled after sidecar kill: {launcher.heights()}"

        # --- leg 3: the supervisor restarts the killed replica; it rejoins
        # through verified sync off its intact WAL and catches up.
        target = max(launcher.heights().values())
        rejoined = False
        deadline = time.monotonic() + 90.0
        while time.monotonic() < deadline:
            h = launcher.replicas[old_leader].probe()
            if (h is not None and h.get("restarted")
                    and h.get("ledger", 0) >= target):
                rejoined = True
                break
            time.sleep(0.5)
        assert rejoined, (
            f"killed replica never rejoined: "
            f"{launcher.replicas[old_leader].probe()}"
        )
        assert launcher.replicas[old_leader].restarts >= 1

        launcher.observe_invariants()
        launcher.monitor.assert_clean()
    finally:
        if injector is not None:
            injector.stop()
        summary = launcher.stop()  # raises on orphans / leaked ports
    assert summary["orphans"] == [] and summary["leaked_ports"] == []
