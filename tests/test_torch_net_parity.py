"""The port's process seams held against the JAX package's.

The same numpy-seeded inputs go through both packages:

- the sidecar's request codec and its MACed frames, and ``TcpComm``'s
  HELLO, consensus and request frames answering a fixed challenge nonce,
  are byte-identical;
- a client of either package talks to a sidecar server of the other, over
  a unix socket and over authenticated TCP, in the legacy and the tenant
  handshake, and every pairing gives the same verdict bytes;
- a seeded Ed25519 corpus with every rejection class verifies to the same
  verdicts through the port's engine (``device="cpu"``) behind the port's
  server and through the JAX engine behind the JAX server;
- a 4-replica cluster of 2 port and 2 JAX replicas orders blocks over real
  TCP sockets, every replica with the same ledger digests;
- the ingress driver's ``summary_json()`` is byte-identical for the same
  seed under the clean, flood and duplicate-storm specs.

Listeners bind port 0 where the code allows it; ``TcpComm`` binds the port
its address map names, so the cluster and the frame capture hold each port
bound (``chip_smoke.held_ports``: ``SO_REUSEADDR``, not listening) until the
comm has bound it too: no other test worker can be handed those ports in
between.
"""

import json
import socket
import time

import numpy as np
import pytest
import torch

import chip_smoke
import consensus_tpu.config as jconfig
import consensus_tpu.consensus as jconsensus
import consensus_tpu.ingress as jingress
import consensus_tpu.net.sidecar as jsidecar
import consensus_tpu.net.transport as jtransport
import consensus_tpu.runtime as jruntime
import consensus_tpu.testing.app as japp
import consensus_tpu.types as jtypes
import consensus_tpu.wire as jwire
import consensus_tpu_torch.config as tconfig
import consensus_tpu_torch.consensus as tconsensus
import consensus_tpu_torch.ingress as tingress
import consensus_tpu_torch.net.sidecar as tsidecar
import consensus_tpu_torch.net.transport as ttransport
import consensus_tpu_torch.runtime as truntime
import consensus_tpu_torch.testing.app as tapp
import consensus_tpu_torch.types as ttypes
import consensus_tpu_torch.wire as twire
from consensus_tpu.models import ed25519 as jmed
from consensus_tpu_torch.models import ed25519 as tmed

SECRET = b"parity-secret"
TENANTS = {"alpha": b"alpha-secret", "beta": b"beta-secret"}
PACKAGES = {
    "jax": {"sidecar": jsidecar, "transport": jtransport, "wire": jwire, "types": jtypes,
            "app": japp, "config": jconfig, "consensus": jconsensus, "runtime": jruntime,
            "ingress": jingress},
    "port": {"sidecar": tsidecar, "transport": ttransport, "wire": twire, "types": ttypes,
             "app": tapp, "config": tconfig, "consensus": tconsensus, "runtime": truntime,
             "ingress": tingress},
}


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "connection closed early"
        buf += chunk
    return buf


# --- frames -------------------------------------------------------------------


def _sidecar_frames(mod, msgs, sigs, keys) -> tuple[bytes, bytes, tuple]:
    """The request payload, the bytes a MACed ``_write_frame`` puts on a
    socket pair for it, and what ``_read_frame`` makes of them."""
    payload = mod.encode_request(msgs, sigs, keys)
    a, b = socket.socketpair()
    try:
        mod._write_frame(a, 7, payload, b"k" * 32, b"c2s")
        a.shutdown(socket.SHUT_WR)
        wire = b""
        while chunk := b.recv(1 << 16):
            wire += chunk
        a2, b2 = socket.socketpair()
        a2.sendall(wire)
        read = mod._read_frame(b2, mod._MAX_FRAME, b"k" * 32, b"c2s")
        a2.close()
        b2.close()
    finally:
        a.close()
        b.close()
    return payload, wire, read


def test_sidecar_codec_and_maced_frames_are_byte_identical():
    rng = np.random.default_rng(3)
    msgs = [rng.bytes(int(rng.integers(0, 300))) for _ in range(17)]
    sigs = [rng.bytes(64) for _ in range(17)]
    keys = [rng.bytes(32) for _ in range(17)]
    ours = _sidecar_frames(tsidecar, msgs, sigs, keys)
    theirs = _sidecar_frames(jsidecar, msgs, sigs, keys)
    assert ours == theirs
    assert tsidecar.decode_request(ours[0]) == (msgs, sigs, keys)
    assert ours[2] == (7, ours[0])
    # A response body: status 0 and one verdict byte a lane.
    body = b"\x00" + np.asarray(rng.integers(0, 2, 17), dtype=np.uint8).tobytes()
    outs = []
    for mod in (tsidecar, jsidecar):
        a, b = socket.socketpair()
        mod._write_frame(a, 9, body, b"s" * 32, b"s2c")
        outs.append(_recv_exact(b, 12 + len(body) + 16))
        a.close()
        b.close()
    assert outs[0] == outs[1]


def _comm_frames(pkg: str, secret, nonce: bytes) -> bytes:
    """Everything ``TcpComm`` 1 of ``pkg`` writes to peer 2 (a bare socket
    that answers the connect with the challenge ``nonce``): its HELLO, a
    Prepare and a request."""
    mods = PACKAGES[pkg]
    transport, wire = mods["transport"], mods["wire"]
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    listener.settimeout(10.0)
    with chip_smoke.held_ports(1) as (own,):
        addrs = {1: ("127.0.0.1", own), 2: listener.getsockname()}
        comm = transport.TcpComm(1, addrs, lambda *a: None, auth_secret=secret)
        comm.start()
    try:
        comm.send_consensus(2, wire.Prepare(view=3, seq=11, digest="d1g3st"))
        comm.send_transaction(2, b"raw-request-bytes")
        conn, _ = listener.accept()
        conn.settimeout(10.0)
        conn.sendall(transport._HEADER.pack(len(nonce), 2, transport._KIND_HELLO) + nonce)
        proof = 32 if secret else 0
        consensus = len(wire.encode_message(wire.Prepare(view=3, seq=11, digest="d1g3st")))
        want = 3 * transport._HEADER.size + proof + consensus + len(b"raw-request-bytes")
        got = _recv_exact(conn, want)
        conn.close()
    finally:
        comm.stop()
        listener.close()
    return got


@pytest.mark.parametrize("secret", [None, SECRET], ids=["no_secret", "auth_secret"])
def test_tcp_comm_frames_are_byte_identical(secret):
    nonce = bytes(range(16))
    ours = _comm_frames("port", secret, nonce)
    assert ours == _comm_frames("jax", secret, nonce)
    header = ttransport._HEADER
    length, sender, kind = header.unpack(ours[:header.size])
    assert (sender, kind) == (1, ttransport._KIND_HELLO)
    assert ours[header.size:header.size + length] == ttransport._hello_proof(secret, nonce, 1)


# --- mixed sidecar pairs ----------------------------------------------------


class _GoodEngine:
    """Valid iff the signature is b"good"; counts its calls."""

    def __init__(self):
        self.calls = 0

    def verify_batch(self, msgs, sigs, keys):
        self.calls += 1
        return np.array([s == b"good" for s in sigs], dtype=bool)

    def verify_host(self, msgs, sigs, keys):
        return self.verify_batch(msgs, sigs, keys)


def _serve(pkg, engine, transport, handshake, tmp_path, **kw):
    """A started sidecar server of ``pkg`` on ``transport`` ("unix" or
    "tcp") in ``handshake`` ("legacy" or "tenant") mode, and the client
    keywords that authenticate against it."""
    mod = PACKAGES[pkg]["sidecar"]
    address = str(tmp_path / f"{pkg}.sock") if transport == "unix" else ("127.0.0.1", 0)
    if handshake == "legacy":
        server = mod.VerifySidecarServer(address, engine, auth_secret=SECRET, **kw)
        client_kw = {"auth_secret": SECRET}
    else:
        server = mod.VerifySidecarServer(address, engine, tenants=TENANTS, wave_window=0.001, **kw)
        client_kw = {"auth_secret": TENANTS["beta"], "tenant": "beta"}
    server.start()
    return server, client_kw


@pytest.mark.parametrize("handshake", ["legacy", "tenant"])
@pytest.mark.parametrize("transport", ["unix", "tcp"])
def test_mixed_client_and_server_pairs_give_the_same_verdict_bytes(transport, handshake, tmp_path):
    rng = np.random.default_rng(5)
    n = 40
    pattern = rng.integers(0, 2, n).astype(bool)
    msgs = [b"m%d" % i for i in range(n)]
    sigs = [b"good" if p else b"bad" for p in pattern]
    keys = [b"k" * 32] * n
    got = {}
    for server_pkg in PACKAGES:
        engine = _GoodEngine()
        server, client_kw = _serve(server_pkg, engine, transport, handshake, tmp_path)
        try:
            for client_pkg in PACKAGES:
                client = PACKAGES[client_pkg]["sidecar"].SidecarVerifierClient(
                    server.address, request_timeout=10.0, **client_kw)
                try:
                    got[client_pkg, server_pkg] = client.verify_batch(msgs, sigs, keys).tobytes()
                    assert not client._suspect
                finally:
                    client.close()
        finally:
            server.stop()
        assert engine.calls == 2
    assert set(got.values()) == {pattern.tobytes()}
    assert len(got) == 4


def test_a_wrong_secret_fails_across_the_packages(tmp_path):
    """The mutual handshake refuses a wrong secret whichever package holds
    which end: the client raises, and with a local engine it fails over."""
    for server_pkg, client_pkg in (("port", "jax"), ("jax", "port")):
        server, _ = _serve(server_pkg, _GoodEngine(), "tcp", "legacy", tmp_path)
        try:
            client = PACKAGES[client_pkg]["sidecar"].SidecarVerifierClient(
                server.address, auth_secret=b"wrong", request_timeout=5.0)
            with pytest.raises((ConnectionError, OSError)):
                client.verify_batch([b"m"], [b"good"], [b"k"])
            client.close()
        finally:
            server.stop()


def test_seeded_corpus_verifies_alike_behind_each_packages_server(tmp_path):
    """The corpus of chip_smoke.py (every rejection class) in sweeps of 8
    (the shape the JAX tests compile): the port's strict engine on the CPU
    behind the port's server, the JAX engine behind the JAX server, each
    asked by the other package's client, the verdicts equal to each other
    and to the construction."""
    msgs, sigs, keys, expected, bad = chip_smoke.make_corpus(24, per_class=2)
    assert len(bad) == 16
    engines = {"port": tmed.Ed25519BatchVerifier(min_device_batch=1, device="cpu"),
               "jax": jmed.Ed25519BatchVerifier(min_device_batch=1)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    got = {}
    try:
        for server_pkg, client_pkg in (("port", "jax"), ("jax", "port")):
            server, client_kw = _serve(server_pkg, engines[server_pkg], "tcp", "tenant", tmp_path)
            client = PACKAGES[client_pkg]["sidecar"].SidecarVerifierClient(
                server.address, request_timeout=300.0, **client_kw)
            try:
                got[server_pkg] = np.concatenate([
                    client.verify_batch(msgs[i:i + 8], sigs[i:i + 8], keys[i:i + 8])
                    for i in range(0, len(msgs), 8)
                ])
                assert not client._suspect
            finally:
                client.close()
                server.stop()
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(got["port"], got["jax"])
    np.testing.assert_array_equal(got["port"], expected)


# --- a cluster mixing the packages over real TCP ---------------------------------


class _Ledgers:
    """The sync registry of one package's replicas (``TestApp.sync`` reads
    the longest ledger among them)."""

    def __init__(self, reconfig_type):
        self.nodes = {}
        self._reconfig = reconfig_type

    def longest_ledger(self, *, exclude):
        best = []
        for node_id, holder in self.nodes.items():
            if node_id != exclude and len(holder.app.ledger) > len(best):
                best = holder.app.ledger
        return list(best)

    def reconfig_of(self, proposal):
        return self._reconfig()


class _Holder:
    def __init__(self, app):
        self.app = app
        self.running = True


def test_two_port_and_two_jax_replicas_order_blocks_over_real_tcp():
    """tests/test_tcp_transport.py's 4-replica cluster with replicas 1 and 3
    from the port and 2 and 4 from the JAX package: 5 blocks, identical
    ledger digests, every decision with a 2f+1 certificate."""
    n, blocks = 4, 5
    pkg_of = {1: "port", 2: "jax", 3: "port", 4: "jax"}
    registries = {pkg: _Ledgers(mods["types"].Reconfig) for pkg, mods in PACKAGES.items()}
    replicas, comms, schedulers = {}, {}, {}
    try:
        with chip_smoke.held_ports(n) as ports:
            addrs = {i + 1: ("127.0.0.1", ports[i]) for i in range(n)}
            for node_id, pkg in pkg_of.items():
                mods = PACKAGES[pkg]
                app = mods["app"].TestApp(node_id, registries[pkg])
                registries[pkg].nodes[node_id] = _Holder(app)
                rt = mods["runtime"].RealtimeScheduler()
                rt.start(thread_name=f"replica-{node_id}")
                schedulers[node_id] = rt

                def route(sender, payload, is_request, nid=node_id):
                    consensus = replicas.get(nid)
                    if consensus is None:
                        return
                    if is_request:
                        consensus.handle_request(sender, payload)
                    else:
                        consensus.handle_message(sender, payload)

                comm = mods["transport"].TcpComm(node_id, addrs, route, reconnect_backoff=0.05,
                                                 auth_secret=SECRET)
                comm.start()
                comms[node_id] = comm
                consensus = mods["consensus"].Consensus(
                    config=mods["config"].Configuration(
                        self_id=node_id, leader_rotation=False, decisions_per_leader=0,
                        request_batch_max_interval=0.02,
                    ),
                    scheduler=rt, comm=comm, application=app, assembler=app,
                    wal=mods["app"].MemWAL([]), signer=app, verifier=app,
                    request_inspector=app.inspector, synchronizer=app,
                )
                consensus.start()
                replicas[node_id] = consensus
        apps = {nid: registries[pkg].nodes[nid].app for nid, pkg in pkg_of.items()}
        for i in range(blocks):
            for node_id, consensus in replicas.items():
                consensus.submit_request(PACKAGES[pkg_of[node_id]]["app"].make_request("cli", i))
            deadline = time.monotonic() + 30.0
            while not all(len(a.ledger) >= i + 1 for a in apps.values()):
                assert time.monotonic() < deadline, f"block {i} not ordered over TCP"
                time.sleep(0.02)
        digests = {nid: [d.proposal.digest() for d in a.ledger[:blocks]] for nid, a in apps.items()}
        assert len({tuple(d) for d in digests.values()}) == 1, digests
        assert all(len(d.signatures) >= 3 for a in apps.values() for d in a.ledger[:blocks])
        # Each package decoded the other's frames into its own types.
        assert type(apps[1].ledger[0]).__module__.startswith("consensus_tpu_torch.")
        assert type(apps[2].ledger[0]).__module__.startswith("consensus_tpu.")
    finally:
        for consensus in replicas.values():
            consensus.stop()
        for comm in comms.values():
            comm.stop()
        for rt in schedulers.values():
            try:
                rt.stop(timeout=2.0)
            except RuntimeError:
                pass


# --- ingress ----------------------------------------------------------------------


@pytest.mark.parametrize("spec_name", ["clean_spec", "flood_spec", "duplicate_storm_spec"])
def test_ingress_summary_is_byte_identical_across_the_packages(spec_name):
    out = {}
    for pkg, mods in PACKAGES.items():
        ingress = mods["ingress"]
        spec = getattr(ingress, spec_name)(clients=300, duration=12.0)
        trace = ingress.generate_trace(11, spec)
        driver = ingress.IngressDriver(trace, spec, seed=11, servers=4)
        driver.run()
        out[pkg] = (driver.summary_json(), [repr(e) for e in trace[:500]], len(trace))
    assert out["port"] == out["jax"]
    summary = json.loads(out["port"][0])
    assert summary["offered"] > 0 and summary["admitted_honest"] == summary["offered_honest"]
