"""The JAX package's sharded-rig tests (``tests/test_zz_groups_deploy.py``)
on the port's ``groups/deploy.py`` and ``deploy/spec.py``, its imports
renamed (``torch_mirror``): the bind-and-hold port reservations, and N
consensus groups as real OS-process clusters of the port's mains over one
shared sidecar fleet.

The process case launches the port's mains, which refuse to start without
a card unless they are asked for the CPU; it runs below with
``ShardedClusterLauncher(sharded, device="cpu")`` as its only change (the
launcher hands ``device`` to every group's ``ClusterLauncher``).
"""

from torch_mirror import mirror

mirror("test_zz_groups_deploy", globals(), drop={
    "test_two_groups_share_one_fleet_as_processes": (
        "launches the port's mains with no device, which they refuse without "
        "a card; re-written below with device=\"cpu\""
    ),
})


def test_two_groups_share_one_fleet_as_processes(tmp_path):
    """2 groups x 3 replicas + ONE shared sidecar boot as 7 real OS
    processes; both groups order decisions, only the fleet-owning
    launcher runs sidecar processes, and teardown leaves zero orphans
    and zero leaked ports in EVERY group."""
    sharded = ShardedDeploySpec.generate(  # noqa: F821
        2, 3, 1, str(tmp_path),
        config_overrides={"request_batch_max_count": 1},
    )
    # Shared fleet, disjoint identities: same sidecar addresses + auth
    # secret everywhere, per-group key namespaces.
    s0, s1 = (sharded.specs[g] for g in sharded.group_ids())
    assert s0.sidecar_addresses() == s1.sidecar_addresses()
    assert s0.auth_secret_hex == s1.auth_secret_hex
    assert s0.key_namespace != s1.key_namespace
    assert s0.ports_held and s1.ports_held

    launcher = ShardedClusterLauncher(sharded, device="cpu")  # noqa: F821
    injectors = []
    try:
        launcher.start(timeout=120)
        assert not s0.ports_held  # released just before spawn
        # Exactly one launcher owns sidecar processes.
        owners = [
            gid for gid, sub in launcher.launchers.items() if sub.sidecars
        ]
        assert owners == [sharded.group_ids()[0]]
        for i, gid in enumerate(sharded.group_ids()):
            injector = _GroupInjector(sharded.specs[gid], _CLIENT_ID + i)  # noqa: F821
            injectors.append(injector)
            injector.submit(8)
        assert launcher.wait_heights(8, timeout=90), launcher.heights()
        launcher.observe_invariants()
        for sub in launcher.launchers.values():
            sub.monitor.assert_clean()
    finally:
        for injector in injectors:
            injector.stop()
        summaries = launcher.stop()  # raises on orphans / leaked ports
    for gid, summary in summaries.items():
        assert summary["orphans"] == [], gid
        assert summary["leaked_ports"] == [], gid
