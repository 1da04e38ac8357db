"""``chip_smoke.py`` phase 20 (the mesh) and phase 19's ``mesh2`` mode
rehearsed on the CPU at a tiny size.

Each wave runs through its single engine, the 1-shard mesh and 2 virtual
CPU shards, and the strict wave over a (2, 2) topology too: verdicts equal
lane for lane, and the launch accounting (none on the CPU) holds.  The
P-256 wave's sharded parity is ``tests/test_torch_mesh_lanes.py``'s; it is
left out here for the plain P-256 scan's cost on the CPU.
"""

import torch

import chip_smoke


def test_chip_smoke_mesh_phase_rehearses_on_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        corpora = {
            "strict": chip_smoke.make_corpus(12, per_class=1),
            "randomized": chip_smoke.make_corpus(
                8, per_class=1, classes=chip_smoke.RANDOMIZED_CLASSES),
        }
        waves = ("strict", "fused", "randomized", "fused_randomized")
        m = chip_smoke.phase_mesh("cpu", corpora, waves=waves, wide=((2, 2),),
                                  replicas={name: 1 for name in waves})
    finally:
        torch.set_num_threads(threads)
    assert set(m["waves"]) == set(waves)
    for name, r in m["waves"].items():
        assert set(r["meshes"]) == {"1", "2 virtual"} | ({"2x2 virtual"} if name == "strict"
                                                          else set()), name
        assert r["meshes"]["2 virtual"]["shards"] == 2
        assert r["meshes"]["2 virtual"]["shard_lanes"] * 2 == r["padded"], name
        # No kernel launches on the CPU: the plain versions serve it.
        assert not any(r["single_launches"].values())
    assert m["waves"]["strict"]["rejected"] == 8
    assert m["padding"]["verdicts"] == [True, True, True]
    assert "needs 9 devices but only 8" in m["refused"]
    chip_smoke.log_mesh(m)


def test_chip_smoke_chaos_phase_mesh2_rehearses_on_cpu():
    m = chip_smoke.phase_chaos_matrix("cpu", modes=("mesh2",), min_device_batch=10**9)
    r = m["modes"]["mesh2"]
    assert r["engine_launches"] == 64 and r["heights"]
    assert not any(r["clean_launches"].values()) and not any(r["fault_launches"].values())
