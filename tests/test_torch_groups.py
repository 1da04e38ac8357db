"""The JAX package's consensus-sharding tests (``tests/test_groups.py``) on
the port's ``groups/``, its imports renamed (``torch_mirror``): the
placement directory, admit-then-route, the 2PC payload codec and its WAL
record, cross-group coalescing over one shared wave former, each group's
ledger against a standalone cluster's, and the shared fleet against four
private ones.  The ingress case runs the port's ``IngressDriver(groups=3)``
branch, which imports ``groups/`` lazily.

Two JAX cases build ``Ed25519BatchVerifier`` with no device (directly, or
through the fleet drives' default engine), which the port refuses on a
machine without a card; they run below with ``device="cpu"`` as their only
change.  Three cases drive ``scripts/`` and ``bench.py``, which run the
JAX package; they are dropped, as the port's other mirrors drop the
sweeps.
"""

import threading

from torch_mirror import mirror

_CPU = ("builds Ed25519BatchVerifier with no device, which the port refuses "
        "without a card; re-written below with device=\"cpu\"")
_SCRIPT = ("runs scripts/ or bench.py, which drive the JAX package; scripts "
           "are not modules of the package (ROADMAP.md queue A)")
mirror("test_groups", globals(), drop={
    "test_shared_former_coalesces_across_groups": _CPU,
    "test_four_groups_one_fleet_beats_four_private_fleets": _CPU,
    "_run_script": _SCRIPT,
    "test_ingress_sweep_script_multigroup": _SCRIPT,
    "test_chaos_sweep_script_groups": _SCRIPT,
    "test_bench_groups_family_records_the_shared_fleet_win": _SCRIPT,
})


def test_shared_former_coalesces_across_groups():
    """Two groups submitting concurrently share one fused launch, and the
    wave NEVER splits a submission (SAFETY §7): per-group signature runs
    stay contiguous and complete."""
    metrics = Metrics(InMemoryProvider())  # noqa: F821
    engine = Ed25519BatchVerifier(min_device_batch=10**9, device="cpu")  # noqa: F821
    waves = []
    former = FairShareWaveFormer(  # noqa: F821
        engine,
        window=0.2,
        groups_metrics=metrics.groups,
        on_group_wave=lambda counts, total: waves.append(dict(counts)),
        name="test-groups-former",
    )
    signer = Ed25519Signer(1, b"\x11" * 32)  # noqa: F821
    barrier = threading.Barrier(2)
    results = {}

    def submit(gid):
        barrier.wait()
        msgs, sigs, keys = _signed(signer, gid.encode(), 3)  # noqa: F821
        results[gid] = former.submit(
            f"{gid}/certs", msgs, sigs, keys, group=gid
        )

    threads = [
        threading.Thread(target=submit, args=(g,))
        for g in ("group-0", "group-1")
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    former.close()
    assert all(results["group-0"]) and all(results["group-1"])
    assert any(len(w) == 2 for w in waves), waves
    multi = [w for w in waves if len(w) == 2]
    # Whole submissions: the coalesced wave carries all 3 sigs per group.
    assert multi[0] == {"group-0": 3, "group-1": 3}
    assert metrics.provider.dump()[GROUPS_WAVE_MULTI_KEY]["value"] >= 1.0  # noqa: F821


def test_four_groups_one_fleet_beats_four_private_fleets():
    """THE acceptance gate: identical committed cert work, strictly fewer
    and larger launches through the one shared fleet than through four
    private ones — the deployment win sharding is paying for."""
    metrics = Metrics(InMemoryProvider())  # noqa: F821
    shard = ShardedCluster(4, n=4, seed=2, metrics=metrics, device="cpu")  # noqa: F821
    tenants = [f"tenant-{i}" for i in range(16)]
    _run_workload(shard, tenants, per_tenant=2, height=1)  # noqa: F821

    workload = shard.cert_workload()
    assert sum(len(b) for b in workload.values()) >= 4
    shared = shard.drive_shared_fleet(window=0.1, workload=workload)
    private = shard.drive_private_fleets(window=0.01, workload=workload)

    # Same bytes verified either way...
    assert shared["total_signatures"] == private["total_signatures"]
    # ...but the shared fleet fuses across groups: strictly fewer launches,
    assert shared["launches"] < private["launches"]
    # larger on average,
    assert (
        shared["total_signatures"] / shared["launches"]
        > private["total_signatures"] / private["launches"]
    )
    # with at least one launch actually serving 2+ groups, booked on the
    # pinned multi-group counter too.
    assert shared["multi_group_launches"] >= 1
    dump = metrics.provider.dump()
    assert dump[GROUPS_WAVE_MULTI_KEY]["value"] >= 1.0  # noqa: F821
