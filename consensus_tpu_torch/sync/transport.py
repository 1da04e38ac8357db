"""Sync transports: the request/response channel catch-up runs over.

The consensus ``Comm`` port is fire-and-forget by contract, and
``Synchronizer.sync()`` is called *synchronously* from inside the protocol
(controller ``_do_sync``, the view changer) — so catch-up gets its own
blocking fetch channel, exactly like the reference's deployment: Fabric's
block puller opens its own gRPC connections to peers, it does not ride the
consensus message stream.

Two implementations:

* :class:`InProcessSyncTransport` — for the simulated cluster.  Requests and
  replies make a full codec round-trip through bytes and honor the
  ``SimNetwork`` partition state in BOTH directions, so a partitioned
  replica cannot tunnel state through a side channel, and every byte a test
  syncs has survived encode→decode.
* :class:`TcpSyncTransport` + :class:`SyncListener` — real sockets with
  u32-length framing, for realtime deployments (benchmarks, the example
  orderer).

Both honor an armed :class:`~consensus_tpu_torch.testing.faults.FaultPlan` through
the ``sync.fetch.io_error`` (survivable fetch failure) and
``sync.chunk.corrupt`` (reply bytes damaged in flight) seams — one ``is
None`` check each when no plan is armed.

The PyTorch port's copy of ``consensus_tpu/sync/transport.py``, its imports renamed.
"""

from __future__ import annotations

import abc
import socket
import struct
import threading
from typing import Dict, Optional, Sequence, Union

from consensus_tpu_torch.net.framing import FrameStall, ListenerGuard, recv_exact
from consensus_tpu_torch.sync.server import SyncServer
from consensus_tpu_torch.wire.codec import CodecError, decode_message, encode_message
from consensus_tpu_torch.wire.messages import SyncChunk, SyncRequest, SyncSnapshotMeta

SyncReply = Union[SyncChunk, SyncSnapshotMeta]

_FRAME = struct.Struct(">I")
_MAX_FRAME_BYTES = 64 * 1024 * 1024


class SyncTransport(abc.ABC):
    """Blocking fetch channel to peers' sync servers."""

    #: Armed testing FaultPlan; None in production (one attr check per fetch).
    fault_plan = None

    @abc.abstractmethod
    def fetch(self, peer_id: int, request: SyncRequest) -> Optional[SyncReply]:
        """Send ``request`` to ``peer_id``; return its decoded reply, or
        None when the peer is unreachable / errored / sent garbage."""

    @abc.abstractmethod
    def peers(self) -> Sequence[int]:
        """Candidate peers (never includes self)."""


def _maybe_corrupt(plan, reply_bytes: bytes) -> bytes:
    """sync.chunk.corrupt seam: flip one byte mid-payload when armed —
    decode must then fail closed (CodecError), never yield a wrong chunk."""
    if plan is not None and plan.trip("sync.chunk.corrupt"):
        pos = len(reply_bytes) // 2
        return (
            reply_bytes[:pos]
            + bytes([reply_bytes[pos] ^ 0xFF])
            + reply_bytes[pos + 1 :]
        )
    return reply_bytes


class InProcessSyncTransport(SyncTransport):
    """Sim-cluster transport: full wire round-trip against the shared
    ``sync_servers`` registry, gated on network reachability both ways."""

    def __init__(
        self,
        node_id: int,
        network,
        servers: Dict[int, SyncServer],
        *,
        fault_plan=None,
    ) -> None:
        self.node_id = node_id
        self._network = network
        self._servers = servers
        self.fault_plan = fault_plan

    def peers(self) -> Sequence[int]:
        return [n for n in self._network.node_ids() if n != self.node_id]

    def fetch(self, peer_id: int, request: SyncRequest) -> Optional[SyncReply]:
        # A fetch is a request AND a reply: both directions must be up.
        if not self._network.reachable(self.node_id, peer_id):
            return None
        if not self._network.reachable(peer_id, self.node_id):
            return None
        server = self._servers.get(peer_id)
        if server is None:
            return None  # peer process is down
        plan = self.fault_plan
        try:
            if plan is not None:
                plan.io_error("sync.fetch.io_error")
            reply_bytes = server.handle_bytes(encode_message(request))
            reply_bytes = _maybe_corrupt(plan, reply_bytes)
            reply = decode_message(reply_bytes)
        except (OSError, CodecError):
            return None
        if not isinstance(reply, (SyncChunk, SyncSnapshotMeta)):
            return None
        return reply


class SyncListener:
    """Serves a :class:`SyncServer` over TCP: one framed request, one framed
    reply per connection (catch-up is bursty and rare; connection reuse is
    not worth the state).  Daemon accept thread; ``close()`` stops it.

    Hardened DEFAULT-ON via a :class:`~consensus_tpu_torch.net.framing
    .ListenerGuard`: connections are admitted against per-peer/global
    quotas before a byte is read, each is served on its own daemon thread
    (one slow-loris peer no longer blocks honest catch-up behind it), the
    first frame must start within the guard's handshake deadline, started
    frames must keep making progress, and malformed frames (oversized
    claim, stall, undecodable request) accrue strikes toward a temporary
    ban.  Pass a configured guard to tune, or ``guard=False`` for the
    pre-hardening serial listener behavior."""

    def __init__(
        self,
        server: SyncServer,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        guard=None,
    ) -> None:
        self.server = server
        if guard is None:
            guard = ListenerGuard(name="sync")
        self.guard = guard or None
        self._sock = socket.create_server((host, port))
        self._sock.settimeout(0.2)
        self.address = self._sock.getsockname()
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._accept_loop, name=f"sync-listener-{self.address[1]}",
            daemon=True,
        )
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            addr = "?"
            try:
                addr = conn.getpeername()[0]
            except OSError:
                pass
            guard = self.guard
            if guard is not None and not guard.admit(addr):
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            threading.Thread(
                target=self._serve_conn, args=(conn, addr),
                name=f"sync-serve-{self.address[1]}", daemon=True,
            ).start()

    def _serve_conn(self, conn: socket.socket, addr: str) -> None:
        guard = self.guard
        first_deadline = (
            guard.handshake_timeout if guard is not None else 5.0
        )
        progress = guard.progress_timeout if guard is not None else 5.0
        try:
            with conn:
                try:
                    header = recv_exact(
                        conn, _FRAME.size, progress_timeout=first_deadline
                    )
                except FrameStall as stall:
                    if guard is not None:
                        if stall.received == 0:
                            # Connect-and-idle: never started a frame.
                            guard.handshake_timed_out(addr)
                        else:
                            guard.strike(addr, "stall")
                    return
                if header is None:
                    return
                (length,) = _FRAME.unpack(header)
                if length > _MAX_FRAME_BYTES:
                    if guard is not None:
                        guard.strike(addr, "oversized")
                    return
                try:
                    raw = recv_exact(conn, length, progress_timeout=progress)
                except FrameStall:
                    if guard is not None:
                        guard.strike(addr, "stall")
                    return
                if raw is None:
                    return
                try:
                    reply = self.server.handle_bytes(raw)
                except CodecError:
                    if guard is not None:
                        guard.strike(addr, "garbage")
                    return
                conn.settimeout(5.0)
                conn.sendall(_FRAME.pack(len(reply)) + reply)
        except OSError:
            pass  # bad client; keep serving others
        finally:
            if guard is not None:
                guard.release(addr)

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)


def _read_frame(conn: socket.socket) -> Optional[bytes]:
    """Client-side framed read (the fetch reply path): cap check BEFORE
    any payload buffering, then the shared chunked
    :func:`~consensus_tpu_torch.net.framing.recv_exact` — allocation tracks
    bytes actually received, never the peer's claimed length.  EOF,
    ECONNRESET, and timeouts all collapse to None (the fetch yielded
    nothing; the connection is dropped)."""
    header = recv_exact(conn, _FRAME.size)
    if header is None:
        return None
    (length,) = _FRAME.unpack(header)
    if length > _MAX_FRAME_BYTES:
        raise CodecError(f"sync frame of {length} bytes exceeds cap")
    return recv_exact(conn, length)


class TcpSyncTransport(SyncTransport):
    """Real-socket fetch channel: ``addresses`` maps peer id -> (host, port)
    of that peer's :class:`SyncListener`."""

    def __init__(
        self,
        node_id: int,
        addresses: Dict[int, tuple],
        *,
        timeout: float = 5.0,
        fault_plan=None,
    ) -> None:
        self.node_id = node_id
        self.addresses = addresses
        self.timeout = timeout
        self.fault_plan = fault_plan

    def peers(self) -> Sequence[int]:
        return [n for n in sorted(self.addresses) if n != self.node_id]

    def fetch(self, peer_id: int, request: SyncRequest) -> Optional[SyncReply]:
        address = self.addresses.get(peer_id)
        if address is None:
            return None
        plan = self.fault_plan
        try:
            if plan is not None:
                plan.io_error("sync.fetch.io_error")
            with socket.create_connection(address, timeout=self.timeout) as conn:
                payload = encode_message(request)
                conn.sendall(_FRAME.pack(len(payload)) + payload)
                reply_bytes = _read_frame(conn)
            if reply_bytes is None:
                return None
            reply_bytes = _maybe_corrupt(plan, reply_bytes)
            reply = decode_message(reply_bytes)
        except (OSError, CodecError):
            return None
        if not isinstance(reply, (SyncChunk, SyncSnapshotMeta)):
            return None
        return reply


__all__ = [
    "SyncTransport",
    "SyncReply",
    "InProcessSyncTransport",
    "SyncListener",
    "TcpSyncTransport",
]
