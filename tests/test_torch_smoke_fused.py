"""chip_smoke.py's phases 13-17 (kernel S1, the fused strict and randomized
waves, half-aggregated certificates, the configuration-path cluster)
rehearsed on the CPU at a few dozen lanes, and S1's bound and SASS reading.

The plain versions stand in for the kernels, as in the other phases'
rehearsals.  Where a phase re-runs a call under ``torch.profiler``, the
kernel's result on the same inputs is replayed after its first call, so
the profiler has few ops to sort.  The half-aggregation and randomized
phases run many aggregate checks with fresh inputs; there the MSM is
computed with Python integers (the host twin's arithmetic), the same group
element in another projective representative, since the plain MSM costs
about a second a check here.  The plain MSM is held to the kernel on the
card (phase 6) and to the JAX package on the CPU (tests/test_torch_straus_msm.py).
"""

import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from consensus_tpu_torch.config import Configuration
from consensus_tpu_torch.models import ed25519 as med
from consensus_tpu_torch.ops import ed25519 as ed
from consensus_tpu_torch.ops import field25519 as fe
from consensus_tpu_torch.ops import scan_kernels
from consensus_tpu_torch.ops import sha512 as sh


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _remembered(monkeypatch, module, name):
    """``module.name`` replaced by a function that runs it once per distinct
    input and replays the result after."""
    real, seen, calls = getattr(module, name), {}, []

    def remembered(*args):
        flat = [t for a in args for t in (a if isinstance(a, tuple) else (a,))]
        key = tuple(t.numpy().tobytes() for t in flat)
        calls.append(key)
        if key not in seen:
            seen[key] = real(*args)
        return seen[key]

    monkeypatch.setattr(module, name, remembered)
    return calls


def _bigint_msm(monkeypatch):
    """``straus_msm`` computed with Python integers: sum [zk_i](-A_i) +
    [z_i](-R_i) from the digits' signed values, as (32, 1) limbs."""
    calls = []

    def point(p, i):
        return tuple(fe.limbs_to_int(c[:, i]) % fe.P for c in p)

    def value(digits, i):
        out = 0
        for d in digits[:, i].tolist():
            out = 16 * out + (d - 8)
        return out

    def msm(neg_a, neg_r, zk, z):
        calls.append(zk.shape[1])
        acc = med._REF_IDENTITY
        for i in range(zk.shape[1]):
            for pts, digits in ((neg_a, zk), (neg_r, z)):
                k = value(digits, i)
                if k:
                    acc = med._ref_add(acc, med._ref_mul(k % med.L, point(pts, i)))
        return ed.Point(*(
            torch.from_numpy(fe.int_to_limbs(c % fe.P)[:, None].copy()) for c in acc
        ))

    monkeypatch.setattr(scan_kernels, "straus_msm", msm)
    return calls


def test_bigint_msm_stand_in_is_the_plain_msms_group_element(monkeypatch):
    corpus = chip_smoke.make_corpus(12, per_class=1, classes=chip_smoke.RANDOMIZED_CLASSES)
    (neg_a, neg_r, zk, z), _, _ = chip_smoke.msm_wave_inputs(corpus, 1, torch.device("cpu"))
    want = chip_smoke.affine(scan_kernels.straus_msm_reference(neg_a, neg_r, zk, z))
    _bigint_msm(monkeypatch)
    got = chip_smoke.affine(scan_kernels.straus_msm(neg_a, neg_r, zk, z))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_sha512_bound_counts_the_work():
    """The bound counts SHA-512's own instructions (FIPS 180-4: 64 schedule
    words and 80 rounds a block), not the kernel's SASS: at a wave's width
    the instructions over every SM bound it, on one long lane the chain of
    4 dependent instructions a round at the measured latency."""
    assert (chip_smoke.SHA512_WORD_OPS, chip_smoke.SHA512_ROUND_OPS) == (20, 28)
    assert chip_smoke.SHA512_BLOCK_OPS == 64 * 20 + 80 * 28 + 16 == 3536
    assert chip_smoke.SHA512_CHAIN_DEPTH == 4
    n_blocks = np.array([2] * 7000 + [0] * 1192, dtype=np.int32)
    b = chip_smoke.sha512_bound(n_blocks, sm_count=132, sm_clock_hz=1.98e9, latency_cycles=4.5)
    assert b["blocks"] == 14000 and b["instructions"] == 3536 * 14000
    assert b["bytes"] == 14000 * 128 + 8192 * (4 + 64)
    assert b["ops_ms"] == pytest.approx(3536 * 14000 / (132 * 64 * 1.98e9) * 1e3)
    assert b["chain"] == 2 * 80 * 4
    assert b["chain_ms"] == pytest.approx(2 * 80 * 4 * 4.5 / 1.98e9 * 1e3)
    assert b["bound_by"] == "operations" and b["bound_ms"] == b["ops_ms"] > b["chain_ms"]
    root = chip_smoke.sha512_bound(np.array([3431]), 132, 1.98e9, 4.5)
    assert root["bound_ms"] == root["chain_ms"] == pytest.approx(3431 * 320 * 4.5 / 1.98e9 * 1e3)
    # The former yardstick, printed beside the bound: the block loop's SASS
    # instructions at one a clock.
    assert chip_smoke.sass_issue_ms(np.array([3430]), 3637, 1.98e9) == pytest.approx(
        3637 * 3430 / 1.98e9 * 1e3)


_SASS = """
\tcode for sm_90a
\t\tFunction : _Z13sha512_kernelPKjPKiPjxi
        /*0000*/                   LDC R1, c[0x0][0x28] ;    /* 0x00000a00ff017b82 */
        /*0010*/               @P0 EXIT ;                    /* 0x000000000000094d */
        /*0020*/              @!P0 BRA 0x70 ;                /* 0x000000e400288947 */
        /*0030*/                   IADD3 R4, P0, R2, R3, RZ ;
        /*0040*/                   SHF.R.U64 R5, R4, 0xe, R5 ;
        /*0050*/                   LOP3.LUT R6, R5, R4, R7, 0x96, !PT ;
        /*0060*/              @!P4 BRA 0x30 ;                /* 0xffffff1c0038c947 */
        /*0070*/                   EXIT ;
        /*0080*/                   BRA 0x80;
        /*0090*/                   NOP;
\t\tFunction : _Z11other_kernelv
        /*0000*/                   BRA 0x0;
"""


def test_sass_block_loop_reads_the_widest_backward_branch(monkeypatch):
    monkeypatch.setattr(scan_kernels, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    ran = []

    def fake_run(cmd, **kw):
        ran.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=_SASS, stderr="")

    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    loop = chip_smoke.sass_block_loop("lib.so")
    assert ran == [["/usr/local/cuda/bin/cuobjdump", "-sass", "lib.so"]]
    assert loop == {"per_block": 4, "kernel": 9, "loop": ("0x30", "0x60")}


def test_chip_smoke_sha512_phase_rehearses_on_cpu():
    corpus = chip_smoke.make_corpus(16, per_class=1)
    rand = chip_smoke.make_corpus(16, per_class=1, classes=chip_smoke.RANDOMIZED_CLASSES)
    k = chip_smoke.phase_sha512("cpu", corpus, rand, replicas=2, reps=1, plain_reps=1,
                                long_lanes=3, long_blocks=3)
    assert (k["lanes"], k["live"], k["block_axis"], k["max_abs_err"]) == (32, 32, 2, 0)
    assert k["n_blocks"].tolist() == [2] * 32  # 160-byte R || A || M
    w = k["widths"]
    assert list(w) == ["wave", "one_block", "certs", "long", "root"]
    assert w["wave"]["ms"] == k["ms"] and w["wave"]["max_abs_err"] == 0
    assert (w["one_block"]["lanes"], w["one_block"]["block_axis"]) == (32, 1)
    assert w["one_block"]["n_blocks"].tolist() == [1] * 32  # counts cut to the axis
    assert (w["certs"]["lanes"], w["certs"]["block_axis"]) == (chip_smoke.S1_CERT_LANES, 2)
    assert (w["long"]["lanes"], w["long"]["block_axis"]) == (3, 3)
    assert all(w[key]["max_abs_err"] == 0 for key in ("one_block", "certs", "long"))
    # No kernel on the CPU: the launches-alone time is the wrapper's again.
    assert all(r["launch_ms"] == r["ms"] for r in w.values())
    # 12 of the 16 randomized requests pass the host pre-checks, twice.
    assert k["root_live"] == 24 and k["root_bytes"] == 14 + 8 + 64 * 24
    assert k["root_blocks"] == sh.padded_blocks_for(k["root_bytes"])


def test_chip_smoke_fused_phases_rehearse_on_cpu(monkeypatch):
    corpus = chip_smoke.make_corpus(16, per_class=1)
    wave = chip_smoke.replica_wave(corpus, 2)
    direct = med.Ed25519BatchVerifier(device="cpu", min_device_batch=1).verify_batch(*wave[:3])
    scans = _remembered(monkeypatch, scan_kernels, "horner_scan")
    hashes = _remembered(monkeypatch, sh, "sha512_blocks")
    f = chip_smoke.phase_fused_wave("cpu", corpus, 2, direct)
    assert (f["signatures"], f["padded"], f["rejected"]) == (32, 32, 16)
    # No kernel launches on the CPU; one device call of the fused engine.
    assert f["launches"] == (0, 0, 0) and f["s1"] == 0 and f["calls"] == 1
    assert f["d_launches"] == (0, 0, 0)
    assert f["stream_waves"] == 2 and f["stream_s1"] == 0
    # The wave, its profiled re-run and the two streamed waves: 4 hashes.
    assert len(hashes) == 4 and len(scans) == 4
    p = f["profiled"]
    assert list(p["ranges"]) == list(chip_smoke.FUSED_RANGES)
    assert p["busy_ms"] is None and f["peak_bytes"] is None
    # The first call's ranges on the host clock, inside its end-to-end time.
    assert list(f["first"]) == list(chip_smoke.FUSED_RANGES)
    assert all(0 < ms <= f["wave_ms"] for ms in f["first"].values())
    assert f["fused_prep_ms"] > 0 and f["host_prep_ms"] > 0


def test_chip_smoke_fused_randomized_phase_rehearses_on_cpu(monkeypatch):
    corpus = chip_smoke.make_corpus(16, per_class=1, classes=chip_smoke.RANDOMIZED_CLASSES)
    wave = chip_smoke.replica_wave(corpus, 2)
    direct = med.Ed25519RandomizedBatchVerifier(device="cpu", min_device_batch=1).verify_batch(
        *wave[:3]
    )
    msm = _bigint_msm(monkeypatch)
    hashes = _remembered(monkeypatch, sh, "sha512_blocks")
    f = chip_smoke.phase_fused_randomized("cpu", corpus, 2, direct)
    # The aggregate, then the survivors' re-check (two R off the curve), in
    # the wave and its profiled re-run: 4 S1 calls a check.
    assert f["checks"] == 2 and msm == [32] * 4
    assert len(hashes) == 2 * chip_smoke.S1_PER_CHECK * 2
    assert (f["signatures"], f["rejected"]) == (32, 12)
    assert f["launches"] == (0, 0, 0) and f["s1"] == 0 and f["d_launches"] == (0, 0, 0)
    assert list(f["profiled"]["ranges"]) == list(chip_smoke.FUSED_BATCH_RANGES)


def test_chip_smoke_halfagg_phase_rehearses_on_cpu(monkeypatch):
    msm = _bigint_msm(monkeypatch)
    h = chip_smoke.phase_halfagg_certs("cpu", 2)
    assert (h["certs"], h["components"], h["checks"], h["tampered"]) == (2, 5, 2, 2)
    assert h["launches"] == (0, 0, 0) and h["s1"] == 0 and h["d_launches"] == (0, 0, 0)
    # Each forged vote localized to its own signer.
    signers, groups, _, forged = chip_smoke.catch_up_chunk(2)
    assert [pos for pos, _ in h["localized"]] == forged
    assert [sid for _, sid in h["localized"]] == [groups[p // 5][1][p % 5].id for p in forged]
    # 2 self-checks, 2 verifies, 2 tampered certs, then the bisections.
    assert len(msm) > 6 and set(msm) == {8}


def test_chip_smoke_config_cluster_phase_rehearses_on_cpu(monkeypatch):
    """Phase 17 at 4 replicas x 20 signed requests, 2 blocks, device calls
    from 16 signatures: the fused engine from the configuration, identical
    ledgers of half-aggregated certificates that verify on the host twin,
    the proposal waves its device calls."""
    _remembered(monkeypatch, scan_kernels, "horner_scan")
    _remembered(monkeypatch, sh, "sha512_blocks")
    config = Configuration(device_prep=True, cert_mode="half-agg", crypto_tpu_min_batch=16)
    c = chip_smoke.phase_cluster("cpu", replicas=4, requests=20, blocks=2, config=config)
    assert c["fused"] and c["half_agg"] and c["min_device_batch"] == 16
    assert list(c["profiled"]["ranges"]) == list(chip_smoke.FUSED_RANGES)
    assert (c["device_calls"], c["follower_waves"], c["leader_waves"]) == (8, 6, 2)
    # The previous decision's certificate is a QuorumCert: it is checked on
    # its own (host twin), so every proposal wave is its 20 requests.
    assert c["wave_sizes"] == [20] and c["padded"] == [32]
    assert c["launches"] == (0, 0, 0) and c["s1_launches"] == 0 and c["d_launches"] == (0, 0, 0)
    assert c["votes_checked"] == 4 * 2 and c["reference_checked"] == 0
    assert c["scan"]["kernel"] == "sha512" and c["scan"]["max_abs_err"] == 0
    assert c["scan"]["lanes"] == 32 and c["wal_bytes"] > 0
