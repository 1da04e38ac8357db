"""The port's write-ahead log against the JAX package's: the same file
format byte for byte, each package reading the other's directory, damage
found at the same record, and a replica restarted by the port from a WAL
the JAX package wrote.

The records are seeded random blobs with seeded ``truncate_to`` marks,
written with small segments so rolls and truncations happen.  Tolerance 0:
everything here is bytes and integers.
"""

from __future__ import annotations

import os
import random
import shutil
from pathlib import Path

import pytest

from consensus_tpu import wal as jwal
from consensus_tpu import wire as jwire
from consensus_tpu.testing import Cluster as JaxCluster
from consensus_tpu.types import Decision as JaxDecision
from consensus_tpu.testing import make_request as jax_make_request
from consensus_tpu_torch import wal as twal
from consensus_tpu_torch import wire as twire
from consensus_tpu_torch.testing import Cluster as PortCluster
from consensus_tpu_torch.testing import make_request
from consensus_tpu_torch.types import Decision

SEGMENT_BYTES = 512


def records(seed: int, count: int = 60) -> list[tuple[bytes, bool]]:
    rng = random.Random(seed)
    return [
        (rng.randbytes(rng.randrange(0, 120)), rng.random() < 0.08)
        for _ in range(count)
    ]


def write(pkg, directory: Path, recs) -> None:
    wal, initial = pkg.initialize_and_read_all(str(directory), segment_max_bytes=SEGMENT_BYTES)
    assert initial == []
    for entry, truncate in recs:
        wal.append(entry, truncate_to=truncate)
    wal.close()


def expected_entries(recs) -> list[bytes]:
    out: list[bytes] = []
    for entry, truncate in recs:
        if truncate:
            out.clear()
        out.append(entry)
    return out


def files(directory: Path) -> dict[str, bytes]:
    return {
        str(p.relative_to(directory)): p.read_bytes()
        for p in sorted(directory.rglob("*")) if p.is_file()
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_records_give_byte_identical_segments(tmp_path, seed):
    recs = records(seed)
    write(jwal, tmp_path / "jax", recs)
    write(twal, tmp_path / "port", recs)
    jf, tf = files(tmp_path / "jax"), files(tmp_path / "port")
    assert len(jf) > 1, "the records should roll over several segments"
    assert tf == jf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_each_package_reads_the_others_directory(tmp_path, seed):
    recs = records(seed)
    write(jwal, tmp_path / "jax", recs)
    write(twal, tmp_path / "port", recs)
    want = expected_entries(recs)
    for reader, directory in ((twal, "jax"), (jwal, "port")):
        wal, entries = reader.initialize_and_read_all(
            str(tmp_path / directory), segment_max_bytes=SEGMENT_BYTES
        )
        assert entries == want
        # The reopened log appends where the writer stopped.
        wal.append(b"after reopen")
        wal.close()
        assert reader.WriteAheadLog(str(tmp_path / directory)).read_all() == want + [b"after reopen"]
    assert files(tmp_path / "jax") == files(tmp_path / "port")


def _damage(directory: Path, kind: str, rng: random.Random) -> None:
    segments = sorted(p for p in directory.iterdir() if p.suffix == ".wal")
    if kind == "torn_tail":
        last = segments[-1]
        buf = last.read_bytes()
        last.write_bytes(buf[: rng.randrange(9, len(buf) - 1)])
    else:  # a flipped payload byte: the CRC no longer matches
        # Walk the frames and flip a byte inside an entry's payload (the
        # CRC does not cover the padding between frames).
        def frames(buf):
            offs, off = [], 0
            while off + 8 <= len(buf):
                length = int.from_bytes(buf[off:off + 4], "little")
                offs.append((off, length))
                off += 8 + length + (-length) % 8
            return [(o, n) for o, n in offs[1:] if n > 2]  # entries past the anchor

        candidates = [s for s in segments if frames(s.read_bytes())]
        seg = candidates[len(candidates) // 2] if kind == "crc_mid" else candidates[-1]
        buf = bytearray(seg.read_bytes())
        frame_off, length = rng.choice(frames(buf))
        buf[frame_off + 8 + rng.randrange(2, length)] ^= 1 << rng.randrange(8)
        seg.write_bytes(bytes(buf))


def _scan(pkg, directory: Path):
    try:
        return ("ok", pkg.WriteAheadLog(str(directory)).read_all())
    except pkg.CorruptLogError as err:
        return (str(err), err.segment, err.offset, list(err.entries))


def _boot(pkg, directory: Path):
    try:
        wal, entries = pkg.initialize_and_read_all(
            str(directory), segment_max_bytes=SEGMENT_BYTES, quarantine_corrupt=True
        )
    except pkg.WALError as err:
        return ("error", type(err).__name__, str(err))
    recovery = wal.recovery
    wal.close()
    return ("ok", entries, None if recovery is None else (
        recovery.quarantined, recovery.intact_entries, recovery.reason))


@pytest.mark.parametrize("kind", ["torn_tail", "crc_tail", "crc_mid"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_damage_is_found_at_the_same_record(tmp_path, kind, seed):
    recs = records(seed)
    write(jwal, tmp_path / "jax", recs)
    _damage(tmp_path / "jax", kind, random.Random(seed))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    jscan, tscan = _scan(jwal, tmp_path / "jax"), _scan(twal, tmp_path / "port")
    assert jscan[0] != "ok", "the damage should be found"
    assert tscan == jscan
    # Boot repairs a torn tail and quarantines a corrupt suffix; both
    # packages leave the same files and return the same entries.
    assert _boot(twal, tmp_path / "port") == _boot(jwal, tmp_path / "jax")
    assert files(tmp_path / "port") == files(tmp_path / "jax")


def _positions(cluster) -> dict[int, tuple[int, int, int]]:
    """node -> (view, latest decided sequence, decisions in view)."""
    out = {}
    for node_id, node in cluster.nodes.items():
        ctl = node.consensus.controller
        out[node_id] = (ctl.curr_view_number, ctl.latest_seq(), ctl.curr_decisions_in_view)
    return out


def _ledger_bytes(wire, ledger) -> bytes:
    """A ledger as codec bytes: one sync chunk of every decision."""
    return wire.encode_message(wire.SyncChunk(
        from_seq=1, height=len(ledger),
        decisions=tuple(d.proposal for d in ledger),
        quorum_certs=tuple(tuple(d.signatures) for d in ledger),
    ))


def test_port_restarts_a_replica_from_a_wal_the_jax_package_wrote(tmp_path):
    """A JAX cluster with file WALs decides 3 blocks with a leader change
    (rotation every 2 decisions) and crashes; the port boots every replica
    from those directories, its ledger carried across as codec bytes.  It
    resumes at the view and sequence the JAX replicas stopped at, goes on
    ordering, and orders exactly what a JAX cluster restarted from a copy
    of the same directories orders."""
    tweaks = {"decisions_per_leader": 2}
    jax = JaxCluster(4, seed=5, wal_dir=str(tmp_path / "wal"), config_tweaks=tweaks,
                     leader_rotation=True)
    jax.start()
    for i in range(3):
        jax.submit_to_all(jax_make_request("c", i))
        assert jax.run_until_ledger(i + 1, max_time=120.0)
    stopped_at = _positions(jax)
    # Rotation moves the leader inside view 0: 3 decisions, the third
    # under the second leader.
    assert set(stopped_at.values()) == {(0, 3, 3)}
    assert {n.consensus.get_leader_id() for n in jax.nodes.values()} == {2}
    ledgers = {i: _ledger_bytes(jwire, n.app.ledger) for i, n in jax.nodes.items()}
    for node in jax.nodes.values():
        node.crash()
    shutil.copytree(tmp_path / "wal", tmp_path / "wal-copy")

    def restarted(cluster_cls, wire, decision, wal_dir):
        cluster = cluster_cls(4, seed=5, wal_dir=str(wal_dir), config_tweaks=tweaks,
                              leader_rotation=True)
        for node_id, node in cluster.nodes.items():
            chunk = wire.decode_message(ledgers[node_id])
            node.app.ledger = [
                decision(proposal=p, signatures=c)
                for p, c in zip(chunk.decisions, chunk.quorum_certs)
            ]
        cluster.start()
        return cluster

    port = restarted(PortCluster, twire, Decision, tmp_path / "wal")
    assert _positions(port) == stopped_at
    again = restarted(JaxCluster, jwire, JaxDecision, tmp_path / "wal-copy")
    assert _positions(again) == stopped_at
    for cluster, mk in ((port, make_request), (again, jax_make_request)):
        for i in range(3, 5):
            cluster.submit_to_all(mk("c", i))
            assert cluster.run_until_ledger(i + 1, max_time=120.0)
        cluster.assert_ledgers_consistent()
    for node_id in port.nodes:
        assert _ledger_bytes(twire, port.nodes[node_id].app.ledger) == _ledger_bytes(
            jwire, again.nodes[node_id].app.ledger
        )
    assert files(tmp_path / "wal") == files(tmp_path / "wal-copy")
    assert os.listdir(tmp_path / "wal") == os.listdir(tmp_path / "wal-copy")
