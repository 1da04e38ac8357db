"""``chip_smoke.py`` phase 21 (the tensor-core field lane) rehearsed on the
CPU at a tiny size, where the wrapper runs the plain version: the parity
checks, the timing rows, the lane-off/lane-on strict wave with its
booking under the ``_mxu`` names, and the log lines.  The P-256 wave is
left to the card (its plain scan is ~1.4 million torch ops).  M1 itself
runs only on the card.
"""

import subprocess

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


def test_mxu_waves_phase_rehearses_on_cpu():
    corpus = chip_smoke.make_corpus(16, per_class=1)
    w = chip_smoke.phase_mxu_waves("cpu", {"strict": corpus}, waves=("strict",),
                                   replicas={"strict": 1})
    r = w["strict"]
    assert r["signatures"] == 16 and r["rejected"] == 8
    # One call a lane, each with the construction's verdicts, the same
    # launches in both lanes and no timing.
    assert r["off"]["launches"] == r["on"]["launches"] and "ms" not in r["on"]
    assert r["off"]["calls"] == {"ed25519.verify": 1}
    assert r["on"]["calls"] == {"ed25519.verify_mxu": 1}
    assert set(r["on"]["launches"]) == set(scan_kernels.KERNELS)
    assert not any(r["on"]["launches"].values())  # the plain versions: no launch
    k = chip_smoke.phase_mxu_kernel("cpu", reps=1, plain_reps=1, widths=(4,), broadcast_lanes=4)
    info = scan_kernels.BuildInfo("lib", "", 0.0, "", True)
    sass = {"mxu_limbs_kernel<0>": {"instructions": 2400, "tensor": {"IGMMA": 96}}}
    chip_smoke.log_mxu(k, w, sass, info, "card")


# Shaped like cuobjdump -sass on M1's library: one function with the
# warpgroup form and a predicated IMMA, NOPs left out of the count.
_SASS = """
\t\tFunction : _Z16mxu_limbs_kernelILi0EEvPKfS1_Pfiiiiii
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;
        /*0010*/                   IGMMA.64x64x32.U8.U8 R24, R152, gdesc[UR4], R24, gsb0 ;
        /*0020*/              @!P0 IMMA.16832.U8.S8 R4, R8.ROW, R12.COL, R4 ;
        /*0030*/                   NOP;
        /*0040*/                   EXIT ;
\t\tFunction : _Z16mxu_limbs_kernelILi1EEvPKfS1_Pfiiiiii
        /*0000*/                   IGMMA.64x64x32.S8.U8 R24, R152, gdesc[UR4], R24, gsb0 ;
        /*0010*/                   IGMMA.64x64x32.U8.U8 R56, R156, gdesc[UR4], R56, gsb0 ;
        /*0020*/                   EXIT ;
"""

_PTXAS = """ptxas info    : Compiling entry function '_Z16mxu_limbs_kernelILi0EEvPKfS1_Pfiiiiii' for 'sm_90a'
ptxas info    : Function properties for _Z16mxu_limbs_kernelILi0EEvPKfS1_Pfiiiiii
    {stack} bytes stack frame, {spills} bytes spill stores, 0 bytes spill loads
ptxas info    : Used 200 registers, used 1 barriers, 20480 bytes smem
ptxas info    : Compiling entry function '_Z16mxu_limbs_kernelILi1EEvPKfS1_Pfiiiiii' for 'sm_90a'
ptxas info    : Function properties for _Z16mxu_limbs_kernelILi1EEvPKfS1_Pfiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 198 registers, used 1 barriers, 20480 bytes smem
"""


def test_sass_counts_read_each_function_and_tensor_form(monkeypatch):
    monkeypatch.setattr(scan_kernels, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    ran = []

    def fake_run(cmd, **kw):
        ran.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=_SASS, stderr="")

    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    got = chip_smoke.sass_counts("lib.so")
    assert ran == [["/usr/local/cuda/bin/cuobjdump", "-sass", "lib.so"]]
    assert got == {
        "_Z16mxu_limbs_kernelILi0EEvPKfS1_Pfiiiiii": {
            "instructions": 4, "tensor": {"IGMMA": 1, "IMMA": 1}},
        "_Z16mxu_limbs_kernelILi1EEvPKfS1_Pfiiiiii": {"instructions": 3, "tensor": {"IGMMA": 2}},
    }


@pytest.mark.parametrize("stack,spills,tensor,ok", [
    (0, 0, {"IGMMA": 96}, True),
    (0, 0, {"IMMA": 282}, True),
    (0, 0, {}, False),
    (16, 0, {"IGMMA": 96}, False),
    (0, 8, {"IGMMA": 96}, False),
])
def test_mxu_build_gate_wants_tensor_cores_and_no_stack_or_spills(stack, spills, tensor, ok):
    """Phase 21 fails on a function of M1's library with no tensor-core
    instruction (IMMA or a warpgroup form), and on a stack frame or a spill
    in ptxas's report of either kernel; a loaded build (no report) is held
    to the SASS alone."""
    sass = {"mxu_limbs_kernel<0>": {"instructions": 10, "tensor": tensor},
            "mxu_limbs_kernel<1>": {"instructions": 10, "tensor": {"IGMMA": 96}}}
    report = _PTXAS.format(stack=stack, spills=spills)
    if ok:
        got = chip_smoke.check_mxu_build(sass, report)
        assert sorted(got) == ["mxu_limbs_kernel<0>", "mxu_limbs_kernel<1>"]
        assert got["mxu_limbs_kernel<0>"]["registers"] == 200
    else:
        with pytest.raises(AssertionError, match="M1"):
            chip_smoke.check_mxu_build(sass, report)
    if tensor:
        assert chip_smoke.check_mxu_build(sass, "") == {}
