"""The deployment rig and the consensus groups never fall back to the CPU on
their own, and chip_smoke.py's phase 23 rehearsed on the CPU.

- The port's ``replica_main`` and ``sidecar_main`` started without
  ``--device`` on a machine without a card exit non-zero with the device
  error (``resolve_device``'s); they never carry on on the CPU.
- ``ShardedCluster``'s fleet drives build their default engine on the
  cluster's device (``cuda`` unless named), so without a card and without
  ``device="cpu"`` they raise; a crypto-free run (the sim, a cross-group
  commit, a chaos schedule) resolves no device at all.
- Phase 23a with 2 groups of 4 replicas, and phase 23b with a 4-replica
  rig of the port's mains and 2 sidecars, both with ``device="cpu"``: on
  the CPU the engines run the kernels' plain versions, so nothing launches.
"""

import subprocess
import sys

import pytest
import torch

import chip_smoke
from consensus_tpu_torch.deploy import ClusterSpec
from consensus_tpu_torch.groups import GroupChaosEngine, GroupChaosSchedule, ShardedCluster

NO_CARD = "no CUDA device is available"
needs_no_card = pytest.mark.skipif(torch.cuda.is_available(),
                                   reason="a card is present: cuda resolves")


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@needs_no_card
@pytest.mark.parametrize("main,flag,name", [
    ("replica_main", "--node-id", "1"),
    ("sidecar_main", "--sidecar-id", "sc-0"),
])
def test_process_mains_without_a_device_exit_with_the_device_error(tmp_path, main, flag, name):
    spec = ClusterSpec.generate(4, 1, str(tmp_path))
    spec.write()
    proc = subprocess.run(
        [sys.executable, "-m", f"consensus_tpu_torch.deploy.{main}",
         "--config", spec.config_path, flag, name],
        capture_output=True, text=True, cwd=str(chip_smoke.REPO), timeout=120,
    )
    assert proc.returncode != 0
    assert NO_CARD in proc.stderr
    assert "ready" not in proc.stdout


@pytest.fixture
def device_resolutions(monkeypatch):
    """Every call of ``resolve_device`` anywhere in the port, recorded (and
    refused)."""
    calls = []

    def record(device=None):
        calls.append(device)
        raise AssertionError(f"resolve_device({device!r}) on a crypto-free run")

    for module in ("consensus_tpu_torch.device", "consensus_tpu_torch.models.ed25519",
                   "consensus_tpu_torch.models.ecdsa_p256", "consensus_tpu_torch.models.aggregate",
                   "consensus_tpu_torch.parallel.mesh"):
        monkeypatch.setattr(f"{module}.resolve_device", record)
    return calls


def test_crypto_free_group_runs_resolve_no_device(device_resolutions):
    shard = ShardedCluster(2, n=4, seed=1)
    shard.start()
    for t in range(6):
        shard.submit(f"tenant-{t}")
    assert shard.run_until_heights(1)
    shard.coordinator.start("tx-1", shard.group_ids())
    assert shard.run_until(lambda: shard.coordinator.all_prepared("tx-1"))
    assert shard.coordinator.decide("tx-1") == "commit"
    assert shard.run_until(lambda: shard.registry.resolved("tx-1") == "committed")
    shard.assert_clean()
    assert len(shard.cert_workload()) == 2
    result = GroupChaosEngine(GroupChaosSchedule.generate(5, steps=6)).run()
    assert result.ok
    assert device_resolutions == []


@needs_no_card
def test_fleet_drives_without_a_device_raise():
    shard = ShardedCluster(2, n=4, seed=1)
    shard.start()
    for t in range(4):
        shard.submit(f"tenant-{t}")
    assert shard.run_until_heights(1)
    workload = shard.cert_workload()
    with pytest.raises(RuntimeError, match=NO_CARD):
        shard.drive_shared_fleet(workload=workload)
    with pytest.raises(RuntimeError, match=NO_CARD):
        shard.drive_private_fleets(workload=workload)


def test_groups_fleet_phase_rehearses_on_cpu(one_thread):
    g = chip_smoke.phase_groups_fleet("cpu", n_groups=2, n=4, tenants=8, decisions=2)
    shared, private = g["shared"], g["private"]
    assert all(h >= 2 for h in g["heights"].values())
    assert shared["total_signatures"] == private["total_signatures"] >= 4 * 3
    assert shared["launches"] < private["launches"]
    assert shared["multi_group_launches"] >= 1
    assert shared["kernel_launches"] == private["kernel_launches"] == (0, 0, 0)
    assert shared["mean_wave"] > private["mean_wave"]
    assert g["forged_group"] == "group-1" and g["forged_error"].endswith(" group-1")


def test_groups_fleet_phase_fails_when_a_forgery_is_accepted(one_thread, monkeypatch):
    monkeypatch.setattr(chip_smoke, "_forge", lambda workload, gid: (workload, workload[gid][0]))
    with pytest.raises(AssertionError, match="accepted a forged signature of group-1"):
        chip_smoke.phase_groups_fleet("cpu", n_groups=2, n=4, tenants=8, decisions=1)


def test_rig_phase_rehearses_on_cpu():
    r = chip_smoke.phase_rig("cpu", n=4, driver_seconds=4.0)
    assert (r["n"], r["f"], r["bar"]) == (4, 1, 3)
    assert r["new_leader"] != r["old_leader"]
    assert r["restarts"][r["old_leader"]] >= 1
    assert r["driver"]["submitted"] >= 1
    assert min(r["heights"].values()) >= r["target"]
    assert r["agreed"] >= r["target"]
    assert r["teardown"]["orphans"] == [] and r["teardown"]["leaked_ports"] == []
    assert r["gpu_apps"] is None
