"""``chip_smoke.py`` phase 21 (the tensor-core field lane) rehearsed on the
CPU at a tiny size, where the wrapper runs the plain version: the parity
checks, the timing rows, the lane-off/lane-on strict wave with its
booking under the ``_mxu`` names, and the log lines.  The profiled re-run
is replaced by a plain call here (the profiler takes minutes to sort the
plain path's ops on the CPU; phase 3's rehearsal covers ``profile_wave``),
and the P-256 wave is left to the card (its plain scan is ~1.4 million
torch ops).  M1 itself runs only on the card.
"""

import pytest
import torch

import chip_smoke
from consensus_tpu_torch.ops import limbs, mxu_limbs, scan_kernels


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    monkeypatch.delenv("CTPU_MXU_LIMBS", raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_mxu_kernel_phase_rehearses_on_cpu():
    k = chip_smoke.phase_mxu_kernel("cpu", reps=1, plain_reps=1, widths=(16, 3, 1),
                                    broadcast_lanes=16)
    # 5 ranges x (3 widths x a product and a square + 2 broadcast products).
    assert k["checks"] == 5 * (3 * 2 + 2) and k["max_abs_err"] == 0.0
    assert list(k["times"]) == [(c, n) for c in ("ed25519", "p256") for n in (16, 3, 1)]
    for (curve, n), row in k["times"].items():
        assert row["launch_ms"] is None and row["ms"] > 0 and row["vpu_ms"] > 0
        assert row["bound"]["bytes"] == 384 * n and row["bound"]["bound_by"] == "bytes"
        assert row["bound"]["macs"] == n * (65536 if curve == "ed25519" else 67584)
    assert k["library_ms"] is None


def test_mxu_bound_at_the_strict_waves_width():
    """The bound's dense MACs a lane are the counting shim's count of one
    product on each curve, and at 8,192 lanes the bytes set it."""
    a = torch.zeros((32, 3), dtype=torch.float32)
    for curve, product in (("ed25519", mxu_limbs.mul25519), ("p256", mxu_limbs.mul_p256)):
        assert limbs.measure_field_ops(product, a, a).dot_macs == 3 * chip_smoke.MXU_MACS[curve]
    b = chip_smoke.mxu_bound(8192, "ed25519", 3 * 32 * 4 * 8192)
    assert b["bound_by"] == "bytes" and abs(b["bound_ms"] - 0.000939) < 1e-6
    assert b["ops_ms"] < b["bytes_ms"]


def test_mxu_waves_phase_rehearses_on_cpu(monkeypatch):
    def unprofiled(engine, msgs, sigs, keys, device, **kw):
        return {"verdicts": engine.verify_batch(msgs, sigs, keys), "busy_share": None}

    monkeypatch.setattr(chip_smoke, "profile_wave", unprofiled)
    corpus = chip_smoke.make_corpus(16, per_class=1)
    w = chip_smoke.phase_mxu_waves("cpu", {"strict": corpus}, waves=("strict",),
                                   replicas={"strict": 1})
    r = w["strict"]
    assert r["signatures"] == 16 and r["rejected"] == 8
    # Two timed calls a lane, in turns, each with the construction's verdicts.
    assert len(r["off"]["ms"]) == len(r["on"]["ms"]) == 2
    assert r["off"]["calls"] == {"ed25519.verify": 1}
    assert r["on"]["calls"] == {"ed25519.verify_mxu": 1}
    assert set(r["on"]["launches"]) == set(scan_kernels.KERNELS)
    assert not any(r["on"]["launches"].values())  # the plain versions: no launch
    k = chip_smoke.phase_mxu_kernel("cpu", reps=1, plain_reps=1, widths=(4,), broadcast_lanes=4)
    info = scan_kernels.BuildInfo("lib", "", 0.0, "", True)
    chip_smoke.log_mxu(k, w, {"mxu_limbs_kernel": 282}, info, "card")
