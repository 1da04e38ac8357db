"""``chip_smoke.py`` phase 19 (the device-fault chaos matrix) rehearsed on
the CPU.

The phase's checks run on the port's engines built on the CPU at the host
path's threshold: the fault-free, faulted and host-path runs byte-identical,
every fault fired, degraded once and recovered, no kernel launched (none
can launch on the CPU), and the observed run's anomalies.  The half-agg
mode is left out here for its cost on the CPU (its faulted run checks each
certificate with the plain torch MSM; ``test_torch_halfagg_fault_matrix.py``
holds it).
"""

import pytest

import chip_smoke


def test_chip_smoke_chaos_phase_rehearses_on_cpu():
    m = chip_smoke.phase_chaos_matrix("cpu", modes=("strict", "randomized", "fused"),
                                      min_device_batch=10**9)
    assert set(m["modes"]) == {"strict", "randomized", "fused"}
    for mode, r in m["modes"].items():
        assert r["engine_launches"] == 64, mode
        assert not any(r["clean_launches"].values()) and not any(r["fault_launches"].values())
        assert r["heights"] and r["deliveries"] > 0
    assert "engine_degraded" in m["observed"]["anomalies"]
    assert m["observed"]["samples"] > 0
    chip_smoke.log_chaos_matrix(m)


def test_chip_smoke_chaos_phase_fails_when_a_fault_does_not_fire(monkeypatch):
    monkeypatch.setattr(chip_smoke, "CHAOS_FAULTS", ((10**6, "hang"),))
    with pytest.raises(AssertionError, match="faults fired"):
        chip_smoke.phase_chaos_matrix("cpu", modes=("strict",), min_device_batch=10**9)


def test_chip_smoke_chaos_modes_name_every_kernel():
    from consensus_tpu_torch.ops import scan_kernels

    for mode, (on_path, off_path) in chip_smoke.CHAOS_KERNELS.items():
        assert set(on_path) | set(off_path) <= set(scan_kernels.KERNELS), mode
        assert not set(on_path) & set(off_path), mode
        assert {"decompress25519", "comb25519"} <= set(on_path), mode
    for mode in chip_smoke.CHAOS_KERNELS:
        crypto, factory = chip_smoke.chaos_mode(mode, "cpu", 7)
        engine = factory()
        assert engine.device.type == "cpu" and engine._min_device_batch == 7, mode
        assert crypto.startswith("ed25519"), mode
