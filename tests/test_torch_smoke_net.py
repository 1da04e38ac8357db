"""chip_smoke.py's phase 22 (the sidecar and the transport) rehearsed on
the CPU at a tiny size, with one torch thread as the other plain-path
rehearsals use: four tenants' sweeps of a 16-signature corpus through one
multi-tenant sidecar, and a 4-replica cluster over real TCP sockets
ordering 2 blocks of 8 signed requests, verifying through one sidecar on a
unix socket.  On the CPU the server's engine runs the kernels' plain
versions, so nothing launches.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from consensus_tpu_torch.models import ed25519 as med


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sidecar_tenants_phase_rehearses_on_cpu(one_thread):
    corpus = chip_smoke.make_corpus(16, per_class=1)
    msgs, sigs, keys, expected, bad = corpus
    direct = med.Ed25519BatchVerifier(device="cpu").verify_host(msgs, sigs, keys)
    s = chip_smoke.phase_sidecar_tenants("cpu", corpus, 1, direct, min_device_batch=1,
                                         timeout=300.0)
    assert (s["tenants"], s["signatures"], s["sweep"]) == (4, 16, [4, 4, 4, 4])
    assert 1 <= s["waves"] <= 4 and s["launches"] == (0, 0, 0, 0)
    assert s["tenant_rides"] >= 4 and s["rejected"] == len(bad)
    assert set(s["accounting"]) == {f"tenant-{t}" for t in range(4)}
    assert all(v["signatures"] == 4 for v in s["accounting"].values())
    assert len(s["roundtrip_ms"]) == 4 and min(s["roundtrip_ms"]) > 0


def test_sidecar_tenants_phase_fails_on_a_wrong_verdict(one_thread):
    corpus = chip_smoke.make_corpus(16, per_class=1)
    msgs, sigs, keys, expected, _ = corpus
    direct = np.array(expected)
    direct[0] = not direct[0]
    with pytest.raises(AssertionError, match="differ from phase 3's"):
        chip_smoke.phase_sidecar_tenants("cpu", corpus, 1, direct, min_device_batch=10**9)


def test_sidecar_cluster_phase_rehearses_on_cpu(one_thread):
    c = chip_smoke.phase_sidecar_cluster("cpu", replicas=4, requests=8, blocks=2, clients=4,
                                         min_device_batch=8, timeout=300.0)
    assert (c["replicas"], c["blocks"], c["quorum"]) == (4, 2, 3)
    assert c["heights"][0] >= 2 and c["launches"] == (0, 0, 0, 0) and c["flushes"] >= 2
    # Every follower wave (8 requests, then 8 + the previous 3-vote
    # certificate) went to the sidecar; each quorum check stayed local.
    assert set(c["sweep_sizes"]) <= {8, 11} and c["sweeps"] >= 2 * 3
    assert c["local_calls"] > 0 and c["local_sigs"] < 8 * c["local_calls"]
    for b in c["block_log"]:
        assert b["wall_ms"] > 0 and b["flushes"] >= 1 and b["failovers"] == 0
        assert b["sweeps"] >= b["flushes"]
    assert c["tx_per_s"] > 0 and c["wal_bytes"] > 0 and c["peak_bytes"] is None
