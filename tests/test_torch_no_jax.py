"""The port stands alone: no JAX, nothing of the JAX package, and a
chip_smoke.py whose phases rehearse on the CPU.

``consensus_tpu_torch`` and ``chip_smoke.py`` may import neither ``jax``,
``jaxlib`` nor ``consensus_tpu`` (the exact names or their submodules),
checked both statically (AST) and in a fresh interpreter (``sys.modules``).
The smoke script's phases (the strict Ed25519 path's, the P-256 path's, the
randomized path's and the engine layer's) run here with ``device="cpu"`` at
8-32 lanes, and its entry point refuses to run without a card.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from consensus_tpu_torch.ops import scan_kernels

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "consensus_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "consensus_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources() -> list[Path]:
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    return files


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_fresh_interpreter_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import consensus_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(consensus_tpu_torch.__path__, 'consensus_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.') for f in {FORBIDDEN!r})]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 10 else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_phases_rehearse_on_cpu():
    corpus = chip_smoke.make_corpus(16, per_class=1)
    msgs, sigs, keys, expected, bad = corpus
    assert len(msgs) == 16 and sorted(np.flatnonzero(~expected).tolist()) == sorted(bad)
    k = chip_smoke.phase_kernel("cpu", keys, lanes=8, reps=1, plain_reps=1, sub_lanes=3)
    assert k["lanes"] == 8 and k["max_abs_err"] == 0.0
    assert k["sub_lanes"] == 3 and k["sub_max_abs_err"] == 0.0  # the catch-up width's check
    assert k["negative_lanes"] >= 4  # weak limbs below zero reach the scan
    w = chip_smoke.phase_wave("cpu", corpus, replicas=1)
    assert w["signatures"] == 16 and w["padded"] == 16 and w["rejected"] == 8
    assert w["reference_checked"] == 16
    # The plain version runs on the CPU: no kernel launch, and the 5-vote
    # quorum takes the host path.
    assert w["wave_launches"] == 0 and w["quorum_launches"] == 0
    assert w["quorum_size"] == 5 < w["min_device_batch"]
    # The stages are read off the engine's own ranges; on the CPU the
    # profiler sees no device, so no device time is claimed.
    p = w["profiled"]
    assert list(p["ranges"]) == list(chip_smoke.WAVE_RANGES)
    assert all(r["host_ms"] > 0 and r["device_ms"] is None for r in p["ranges"].values())
    assert p["busy_ms"] is None and p["busy_share"] is None and p["unranged_ms"] is None


def test_horner_bound_counts_the_work():
    b = chip_smoke.horner_bound(8192, sm_count=132, sm_clock_hz=1.98e9)
    # 2,495 field products per lane, of which 1,024 are squarings.
    assert (chip_smoke.HORNER_MULS, chip_smoke.HORNER_SQUARES) == (1471, 1024)
    assert (chip_smoke.MUL_PRODUCTS, chip_smoke.SQUARE_PRODUCTS) == (72, 44)
    assert b["bytes"] == 8 * 32 * 8192 * 4 + 64 * 8192 * 4
    assert b["products"] == (1471 * 72 + 1024 * 44) * 8192
    assert b["bound_by"] == "operations" and b["bound_ms"] == b["ops_ms"] > b["bytes_ms"]


def test_chip_smoke_p256_phases_rehearse_on_cpu(monkeypatch):
    corpus = chip_smoke.make_p256_corpus(16, per_class=1)
    msgs, sigs, keys, expected, special = corpus
    # 12 rejection classes and the accepted high-s class, one lane each.
    assert len(msgs) == 16 and len(special) == 13
    assert sorted(np.flatnonzero(~expected).tolist()) == sorted(special[:12])
    k = chip_smoke.phase_kernel_p256("cpu", corpus, replicas=1, reps=1, plain_reps=1)
    assert k["lanes"] == 16 and k["max_abs_err"] == 0.0 and k["padded_lanes"] == 0
    # Off the curve: the off-curve key, and the zeros of the lanes of the 9
    # classes the host rejects before the device.
    assert k["off_curve_lanes"] == 10
    # The profiled re-run records every torch op, and on the CPU the plain
    # scan is ~1.4 million of them, which the profiler takes minutes to
    # sort.  Here the scan's result on the wave's own inputs stands in for
    # it after its first call, as the kernel does on the card.
    real, seen = scan_kernels.horner_scan_p256, {}

    def remembered_scan(qx, qy, digits):
        key = (qx.numpy().tobytes(), qy.numpy().tobytes(), digits.numpy().tobytes())
        if key not in seen:
            seen[key] = real(qx, qy, digits)
        return seen[key]

    monkeypatch.setattr(scan_kernels, "horner_scan_p256", remembered_scan)
    w = chip_smoke.phase_wave_p256("cpu", corpus, replicas=1)
    assert len(seen) == 1  # the wave and its profiled re-run: the same inputs
    assert w["signatures"] == 16 and w["padded"] == 16 and w["rejected"] == 12
    assert w["high_s_accepted"] == 1 and w["reference_checked"] == 16
    # The plain version runs on the CPU: no kernel launch, and the 3-vote
    # quorum takes the host path.
    assert w["wave_launches"] == 0 and w["other_launches"] == 0
    assert w["quorum_launches"] == 0 and w["quorum_size"] == 3 < w["min_device_batch"]
    p = w["profiled"]
    assert list(p["ranges"]) == list(chip_smoke.P256_WAVE_RANGES)
    assert all(r["host_ms"] > 0 and r["device_ms"] is None for r in p["ranges"].values())
    assert p["busy_ms"] is None and p["busy_share"] is None and p["unranged_ms"] is None


def test_p256_bound_counts_the_work():
    b = chip_smoke.p256_bound(2048, sm_count=132, sm_clock_hz=1.98e9)
    # 72 complete adds x 14 multiplications and 260 doubles x (10 + 3).
    assert (chip_smoke.P256_MULS, chip_smoke.P256_SQUARES) == (3608, 780)
    assert (chip_smoke.P256_MUL_PRODUCTS, chip_smoke.P256_SQUARE_PRODUCTS) == (64, 36)
    assert b["products"] == 258_992 * 2048 == 530_415_616
    assert b["bytes"] == (5 * 32 + 65) * 2048 * 4 == 1_843_200
    assert b["bound_by"] == "operations" and b["bound_ms"] == b["ops_ms"] > b["bytes_ms"]
    assert abs(b["ops_ms"] - 0.031710) < 1e-6


def test_chip_smoke_randomized_phases_rehearse_on_cpu(monkeypatch):
    # 32 lanes: one intra-op thread runs the plain path faster than many.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _rehearse_randomized_phases(monkeypatch)
    finally:
        torch.set_num_threads(threads)


def _rehearse_randomized_phases(monkeypatch):
    corpus = chip_smoke.make_corpus(32, per_class=1, classes=chip_smoke.RANDOMIZED_CLASSES)
    msgs, sigs, keys, expected, bad = corpus
    assert len(msgs) == 32 and sorted(np.flatnonzero(~expected).tolist()) == sorted(bad)
    assert len(bad) == 6
    # Phase 6 on the first aggregate: 28 lanes pass the host pre-checks (4
    # padded to 32), 2 of them undecodable and masked.
    k = chip_smoke.phase_kernel_msm("cpu", corpus, replicas=1, reps=1)
    assert (k["lanes"], k["n_low"], k["masked_lanes"], k["padded_lanes"]) == (32, 33, 2, 4)
    assert k["live_lanes"] == 32 - 2 - 4
    assert k["max_abs_err"] == 0.0
    # The catch-up width: all 32 columns here (fewer than 256).
    assert (k["sub_lanes"], k["sub_live_lanes"], k["sub_max_abs_err"]) == (32, 26, 0.0)
    # No CUDA kernel runs on the CPU, so there is no per-kernel split.
    assert k["split"] is None and k["sub_split"] is None
    # As in the P-256 rehearsal, the MSM's result on the same inputs stands
    # in for it after its first call, so the profiler has few ops to sort.
    real, seen, calls = scan_kernels.straus_msm, {}, []

    def remembered_msm(neg_a, neg_r, zk, z):
        calls.append(zk.shape[1])
        key = tuple(t.numpy().tobytes() for t in (*neg_a, *neg_r, zk, z))
        if key not in seen:
            seen[key] = real(neg_a, neg_r, zk, z)
        return seen[key]

    monkeypatch.setattr(scan_kernels, "straus_msm", remembered_msm)
    w = chip_smoke.phase_wave_randomized("cpu", corpus, replicas=1)
    # The aggregate and the survivors' re-check, in the wave and its re-run.
    assert calls == [32] * 4 and len(seen) == 2
    assert w["signatures"] == 32 and w["padded"] == 32
    assert w["rejected"] == 6 and w["host_rejected"] == 4 and w["reference_checked"] == 32
    assert (w["msm_launches"], w["horner_launches"], w["horner_p256_launches"]) == (0, 0, 0)
    p = w["profiled"]
    assert list(p["ranges"]) == list(chip_smoke.BATCH_RANGES)
    assert all(r["host_ms"] > 0 and r["device_ms"] is None for r in p["ranges"].values())
    assert p["busy_ms"] is None and p["unranged_ms"] is None
    # Phase 8 at 4 decisions: 20 votes, 3 forged; the host-side count of
    # bisection nodes of >= 16 votes equals the MSM calls the engine made.
    calls.clear()
    c = chip_smoke.phase_catch_up("cpu", 4)
    assert c["votes"] == 20 and c["padded"] == 32 and c["rejected"] == 3
    assert len(c["forged"]) == 3 and c["min_device_batch"] == 16
    assert len(calls) == c["device_checks"] == 1 and c["host_checks"] >= 2
    assert (c["msm_launches"], c["horner_launches"]) == (0, 0)


def test_ptxas_summary_reads_each_function():
    # Shaped like nvcc -Xptxas -v on the Straus MSM source: two kernels
    # around an out-of-line device function, whose properties must not be
    # booked to the kernel before it.
    report = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z22straus_msm_join_kernelPKmiPm' for 'sm_90a'
ptxas info    : Function properties for _Z22straus_msm_join_kernelPKmiPm
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 166 registers, used 0 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_111fe_mul_callENS_2feES0_
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Compiling entry function '_Z24straus_msm_tables_kernel8msm_args' for 'sm_90a'
ptxas info    : Function properties for _Z24straus_msm_tables_kernel8msm_args
    104 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 178 registers, used 1 barriers, 20480 bytes smem, 104 bytes cumulative stack size
"""
    got = chip_smoke.ptxas_summary(report)
    assert got == {
        "straus_msm_join_kernel": {
            "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 166, "smem": 0,
        },
        "_ZN12_GLOBAL__N_111fe_mul_callENS_2feES0_": {
            "stack": 16, "spill_stores": 8, "spill_loads": 12,
        },
        "straus_msm_tables_kernel": {
            "stack": 104, "spill_stores": 0, "spill_loads": 0, "registers": 178, "smem": 20480,
        },
    }
    assert chip_smoke.ptxas_summary("") == {}


def test_bisection_node_count():
    # No forgery: one check.  One forgery at 0 of 256: the root, both halves,
    # then both halves of each part that holds it down to 16 on the device
    # (9), and the 8-, 4- and 2-lane pairs on the host (6).
    assert chip_smoke.bisection_nodes(256, [], 16) == (1, 0)
    assert chip_smoke.bisection_nodes(256, [0], 16) == (9, 6)
    assert chip_smoke.bisection_nodes(15, [3], 16) == (0, 7)
    device, host = chip_smoke.bisection_nodes(255, [7, 100, 254], 16)
    assert device >= 1 + 2 * 3 and host > 0


def test_chip_smoke_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_coalesced_phases_rehearse_on_cpu():
    """Phases 9 and 10 at 16 requests x 2 replicas: one shared coalescer,
    every replica's verdicts equal the direct wave's, one flush, no host
    fallback; on the CPU the plain versions run, so nothing launches."""
    for curve, corpus in (
        ("ed25519", chip_smoke.make_corpus(16, per_class=1)),
        ("p256", chip_smoke.make_p256_corpus(16, per_class=1)),
    ):
        direct = np.tile(corpus[3], 2)
        c = chip_smoke.phase_coalesced(
            "cpu", corpus, 2, direct, curve=curve, bypass_below=8, window=5.0
        )
        assert (c["signatures"], c["hard_cap"], c["flushes"]) == (32, 32, 1)
        assert c["launches"] == 0 and c["host_calls"] == 0
        assert c["quorum_size"] == (5 if curve == "ed25519" else 3) < c["bypass_below"]
        assert c["wave_ms"] > 0 and c["peak_bytes"] is None and c["held_bytes"] == [None, None]


def test_chip_smoke_coalesced_phase_fails_on_a_wrong_verdict():
    corpus = chip_smoke.make_corpus(16, per_class=1)
    direct = np.tile(corpus[3], 2)
    direct[20] = not direct[20]
    with pytest.raises(AssertionError, match="replica 1: coalesced verdicts differ"):
        chip_smoke.phase_coalesced("cpu", corpus, 2, direct, bypass_below=8, window=5.0)


def test_chip_smoke_supervised_phase_rehearses_on_cpu():
    """Phase 11 on 4 decisions (20 votes, 3 forged): clean supervised strict
    and randomized chunks with one cross-check each, then the injected
    raise, probe and flip, each booked once."""
    s = chip_smoke.phase_supervised("cpu", 4)
    assert s["votes"] == 20 and len(s["forged"]) == 3
    for label in ("strict", "randomized"):
        r = s[label]
        assert r["launches"] == (0, 0, 0) and r["crosscheck_s"] > 0
        assert r["engine"]["engine_crosscheck_total"] == 1 and r["engine"]["engine_rung"] == 0
    raise_, probe, flip = s["faults"]
    assert [f["step"] for f in s["faults"]] == ["raise", "probe", "flip"]
    assert [f["rung"] for f in s["faults"]] == [1, 0, 1]
    assert flip["engine"]["engine_degrade_total{launch_raise}"] == 1
    assert flip["engine"]["engine_degrade_total{wrong_answer}"] == 1
    assert flip["engine"]["engine_recovered_total"] == 1
    assert flip["engine"]["engine_crosscheck_total"] == 2  # the probe's and the flip's
    assert [len(f["host_s"]) for f in s["faults"]] == [1, 1, 1]


def test_chip_smoke_cluster_phase_rehearses_on_cpu(monkeypatch):
    """Phase 12 at 4 replicas x 20 signed requests, 2 blocks, device calls
    from 16 signatures: identical ledgers, every replica's proposal wave
    (the 3 followers' and the leader's own) a device call of the plain
    version, the commit quorums on the host path, nothing launched."""
    # As in the P-256 rehearsal, the plain scan's result on the same inputs
    # stands in for it in the profiled re-run (its first call is real), so
    # the profiler has few ops to sort.
    real, seen = scan_kernels.horner_scan, {}

    def remembered_scan(*args):
        key = tuple(t.numpy().tobytes() for t in args)
        if key not in seen:
            seen[key] = real(*args)
        return seen[key]

    monkeypatch.setattr(scan_kernels, "horner_scan", remembered_scan)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        c = chip_smoke.phase_cluster("cpu", replicas=4, requests=20, blocks=2, min_device_batch=16)
    finally:
        torch.set_num_threads(threads)
    p = c["profiled"]
    assert c["profiled_sigs"] == 23 and list(p["ranges"]) == list(chip_smoke.WAVE_RANGES)
    assert p["busy_ms"] is None and p["unranged_ms"] is None
    assert (c["replicas"], c["blocks"], c["quorum"]) == (4, 2, 3)
    assert (c["device_calls"], c["follower_waves"], c["leader_waves"]) == (8, 6, 2)
    # 20 requests, then 20 + the previous decision's 3-vote certificate.
    assert c["wave_sizes"] == [20, 23] and c["padded"] == [32]
    assert c["launches"] == (0, 0, 0) and c["host_calls"] > 0 and c["host_sigs"] < 16 * c["host_calls"]
    assert [b["device_calls"] for b in c["block_log"]] == [4, 4]
    for b in c["block_log"]:
        assert b["wall_ms"] >= b["device_ms"] + b["host_ms"] > 0
    assert c["votes_checked"] >= 2 * 4 * 3 and c["reference_checked"] == 8
    assert c["tx_per_s"] > 0 and c["peak_bytes"] is None and c["wal_bytes"] > 0
    # B1 held against its plain version on the last follower wave's inputs.
    assert c["scan"]["lanes"] == 32 and c["scan"]["max_abs_err"] == 0


def test_wave_scan_inputs_are_the_engines_own(monkeypatch):
    """The inputs phase 12 holds B1 to its plain version on are the ones
    the engine's own verify call hands horner_scan, padding included."""
    from consensus_tpu_torch.models import ed25519 as med
    from consensus_tpu_torch.models.verifier import Ed25519Signer

    signers = [Ed25519Signer(1 + i, bytes([1 + i]) * 32) for i in range(3)]
    msgs = [b"wave-%d" % i for i in range(19)]
    sigs = [signers[i % 3].sign_raw(m) for i, m in enumerate(msgs)]
    keys = [signers[i % 3].public_bytes for i in range(len(msgs))]
    sigs[4] = sigs[4][:10] + bytes([sigs[4][10] ^ 1]) + sigs[4][11:]
    engine = med.Ed25519BatchVerifier(device="cpu", min_device_batch=16)
    seen = []
    real = scan_kernels.horner_scan

    def recording_scan(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(scan_kernels, "horner_scan", recording_scan)
    assert engine.verify_batch(msgs, sigs, keys).tolist() == [i != 4 for i in range(19)]
    neg_a, k_digits = chip_smoke.wave_scan_inputs(engine, msgs, sigs, keys)
    (got,) = seen
    assert k_digits.shape == (64, 32)
    for g, w in zip(got, (*neg_a, k_digits)):
        assert g.dtype == w.dtype and torch.equal(g, w)
