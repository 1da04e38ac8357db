"""TCP transport: a ``Comm`` implementation over real sockets.

The reference ships no in-tree transport — Fabric supplies a gRPC/mTLS
cluster service and the tests use channel maps (reference
pkg/api/dependencies.go:22-30, test/network.go).  This module provides the
socket transport piece: length-framed messages over TCP between replica
hosts (BFT traffic rides the datacenter network — DCN; ICI is for the
co-located accelerator, not inter-replica consensus).

Contract fidelity: ``Comm`` is *fire-and-forget, unordered, unreliable*
(the protocol tolerates loss).  Accordingly: sends never block the replica
loop (a bounded per-peer queue + writer thread), connection failures trip
bounded in-writer retry (exponential backoff + jitter) before the frame is
dropped silently, and inbound frames are posted onto the replica's
scheduler (thread-safe with ``RealtimeScheduler``).

Reconnect hardening (deploy rig): a connection-refused peer (killed and
not yet restarted) or a mid-frame abrupt close (killed while we were
writing) never surfaces to the caller — the writer thread retries the
connect up to ``connect_attempts`` times with capped exponential backoff
and jitter, and re-sends an abruptly interrupted frame up to
``send_retries`` times over a fresh connection.  Only after both budgets
are exhausted is the frame dropped (the unreliable contract).  Every
outcome is booked on the pinned ``net_reconnect_*`` / ``net_send_*``
counters when a :class:`~consensus_tpu_torch.metrics.MetricsNetwork` bundle is
attached, so a soak scraper can attribute chaos-induced churn per process.

Identity: every connection opens with a HELLO frame that *pins* the peer id
for that connection; later frames claiming another sender kill the link.
With ``auth_secret`` set, the acceptor issues a fresh challenge nonce and
the HELLO carries an HMAC-SHA256 proof over it, so only live holders of the
cluster secret can claim an identity (observed handshakes don't replay).  This is connection-
level replica authentication, NOT transport encryption — for adversarial
networks, terminate TLS in front (stunnel/envoy) or swap in an mTLS
transport behind the same ``Comm`` port.  (Protocol-level safety does not
rest on the transport: consenter signatures are verified end-to-end.)

Frame: u32 length | u64 sender id | u8 kind (0 = consensus, 1 = request,
2 = hello) | payload (``wire.encode_message`` bytes, raw request bytes, or
the HELLO proof).

The PyTorch port's copy of ``consensus_tpu/net/transport.py``, its imports renamed.
"""

from __future__ import annotations

import hashlib
import hmac
import logging
import os
import queue
import random
import socket
import struct
import threading
from typing import Callable, Mapping, Optional, Sequence, Tuple

from consensus_tpu_torch.api.deps import Comm
from consensus_tpu_torch.net.framing import FrameStall, ListenerGuard, recv_exact
from consensus_tpu_torch.wire import ConsensusMessage, decode_message, encode_message

logger = logging.getLogger("consensus_tpu_torch.net")

_HEADER = struct.Struct(">IQB")
_KIND_CONSENSUS = 0
_KIND_REQUEST = 1
_KIND_HELLO = 2
_HELLO_CONTEXT = b"consensus-tpu/hello/v1"
_NONCE_BYTES = 16


def _hello_proof(secret: Optional[bytes], nonce: bytes, sender: int) -> bytes:
    """Per-connection proof: binds the cluster secret to the acceptor's
    fresh nonce, so observed handshakes cannot be replayed."""
    if not secret:
        return b""
    return hmac.new(
        secret, _HELLO_CONTEXT + nonce + struct.pack(">Q", sender), hashlib.sha256
    ).digest()
#: Frames larger than this are assumed corrupt and kill the connection.
MAX_FRAME_BYTES = 64 * 1024 * 1024


class TcpComm(Comm):
    """``Comm`` over TCP for one replica.

    ``on_message(sender, payload, is_request)`` is invoked from receiver
    threads — pass a function that posts into the replica scheduler (the
    ``Consensus`` facade's ``handle_message``/``handle_request`` already
    do).
    """

    def __init__(
        self,
        self_id: int,
        addresses: Mapping[int, Tuple[str, int]],
        on_message: Callable[[int, object, bool], None],
        *,
        send_queue_depth: int = 1000,
        reconnect_backoff: float = 0.5,
        reconnect_backoff_max: float = 5.0,
        connect_attempts: int = 3,
        send_retries: int = 2,
        connect_timeout: float = 2.0,
        auth_secret: Optional[bytes] = None,
        metrics=None,
        fault_plan=None,
        guard=None,
    ) -> None:
        #: Optional testing FaultPlan (consensus_tpu_torch/testing/faults.py):
        #: arms the net.send.io_error / net.recv.short_read seams below.
        #: A single ``is None`` check when unarmed.
        self.fault_plan = fault_plan
        #: Optional MetricsNetwork bundle booking reconnect/retry outcomes.
        self.metrics = metrics
        self.self_id = self_id
        self._addresses = dict(addresses)
        self._on_message = on_message
        self._queue_depth = send_queue_depth
        self._backoff = reconnect_backoff
        self._backoff_max = reconnect_backoff_max
        self._connect_attempts = max(1, connect_attempts)
        self._send_retries = max(0, send_retries)
        self._connect_timeout = connect_timeout
        self._auth_secret = auth_secret
        #: Listener hardening (net/framing.py), DEFAULT-ON: quotas at
        #: accept, handshake + mid-frame progress deadlines, strike/ban
        #: accounting.  Pass a configured :class:`ListenerGuard` to tune,
        #: or ``guard=False`` for the pre-hardening listener (bench
        #: baseline only — honest traffic behaves identically either way).
        if guard is None:
            guard = ListenerGuard(name=f"comm-{self_id}", metrics=metrics)
        self.guard: Optional[ListenerGuard] = guard or None
        # One-slot encode memo: broadcasts send the same message object to
        # n-1 peers back to back; encode it once (single-threaded caller).
        self._encode_memo: tuple[Optional[object], bytes] = (None, b"")
        self._peers: dict[int, "_Peer"] = {}
        self._listener: Optional[socket.socket] = None
        self._inbound: set[socket.socket] = set()
        self._inbound_lock = threading.Lock()
        self._stopped = threading.Event()
        self._listener_paused = False
        self._listener_lock = threading.Lock()
        # resume_listener rebind retry bounds (chaos heal vs FIN_WAIT).
        self._rebind_attempts = 100
        self._rebind_delay = 0.05

    # --- lifecycle ---------------------------------------------------------

    def _bind_listener(self) -> None:
        host, port = self._addresses[self.self_id]
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            listener.bind((host, port))
            listener.listen(16)
        except OSError:
            listener.close()
            raise
        self._listener = listener
        threading.Thread(
            target=self._accept_loop, args=(listener,),
            name=f"comm-{self.self_id}-accept", daemon=True,
        ).start()

    def start(self) -> None:
        """Bind our listen address and spin up per-peer sender threads."""
        self._bind_listener()
        for node_id, addr in self._addresses.items():
            if node_id == self.self_id:
                continue
            peer = _Peer(self, node_id, addr)
            self._peers[node_id] = peer
            peer.start()

    def pause_listener(self) -> None:
        """Chaos hook (deploy rig: "listener-port drop"): close the listen
        socket and sever inbound connections.  Outbound sending is
        untouched; peers see connection-refused and ride the bounded-retry
        path until :meth:`resume_listener` rebinds the same address."""
        with self._listener_lock:
            if self._listener_paused or self._stopped.is_set():
                return
            self._listener_paused = True
            if self._listener is not None:
                # shutdown() before close(): on Linux, close() alone does
                # not wake a thread blocked in accept(), and the parked
                # accept keeps the kernel socket in LISTEN — pinning the
                # port against the rebind in resume_listener().
                try:
                    self._listener.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    self._listener.close()
                except OSError:
                    pass
                self._listener = None
        with self._inbound_lock:
            inbound = list(self._inbound)
            self._inbound.clear()
        for conn in inbound:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def resume_listener(self) -> None:
        """Undo :meth:`pause_listener`: rebind the listen address and start
        a fresh accept thread."""
        with self._listener_lock:
            if not self._listener_paused or self._stopped.is_set():
                return
            # Sockets severed by pause_listener can linger in FIN_WAIT on
            # the listen port until the remote notices; retry the rebind
            # briefly rather than fail the heal.
            attempts = self._rebind_attempts
            for attempt in range(attempts):
                try:
                    self._bind_listener()
                    break
                except OSError:
                    if (
                        attempt == attempts - 1
                        or self._stopped.wait(self._rebind_delay)
                    ):
                        # Still paused: the flag only clears on a
                        # successful rebind, so a later resume_listener
                        # (e.g. the chaos heal re-issued over the control
                        # socket) retries instead of silently no-opping
                        # into a permanent inbound partition.
                        raise
            self._listener_paused = False

    def stop(self) -> None:
        self._stopped.set()
        if self._listener is not None:
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        for peer in self._peers.values():
            peer.close()
        # Unblock receiver threads parked in recv() and stop late dispatches.
        with self._inbound_lock:
            inbound = list(self._inbound)
            self._inbound.clear()
        for conn in inbound:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    @property
    def bound_port(self) -> int:
        """The actual listen port (useful with port 0 = ephemeral)."""
        assert self._listener is not None
        return self._listener.getsockname()[1]

    # --- Comm port ---------------------------------------------------------

    def send_consensus(self, target_id: int, message: ConsensusMessage) -> None:
        memo_obj, memo_bytes = self._encode_memo
        if memo_obj is message:
            payload = memo_bytes
        else:
            payload = encode_message(message)
            self._encode_memo = (message, payload)
        self._send(target_id, _KIND_CONSENSUS, payload)

    def send_transaction(self, target_id: int, request: bytes) -> None:
        self._send(target_id, _KIND_REQUEST, bytes(request))

    def nodes(self) -> Sequence[int]:
        return sorted(self._addresses)

    def _send(self, target_id: int, kind: int, payload: bytes) -> None:
        peer = self._peers.get(target_id)
        if peer is None:
            return
        if len(payload) > MAX_FRAME_BYTES:
            # Enforced on the send side too: an oversized frame would be
            # killed by every receiver (poisoning the link), and > 2^32
            # would crash the header pack — both violate fire-and-forget.
            logger.warning(
                "%d: dropping oversized %d-byte frame to %d",
                self.self_id, len(payload), target_id,
            )
            return
        frame = _HEADER.pack(len(payload), self.self_id, kind) + payload
        peer.enqueue(frame)  # drops when the queue is full (unreliable contract)

    # --- inbound -----------------------------------------------------------

    def _accept_loop(self, listener: socket.socket) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = listener.accept()
            except OSError:
                if self._stopped.is_set():
                    return
                if self._listener is not listener:
                    return  # paused/replaced: this accept loop retires
                # Transient accept failure (ECONNABORTED, fd pressure):
                # keep serving — a dead accept loop would silently
                # partition this replica on the receive side.
                logger.warning("%d: accept failed; retrying", self.self_id, exc_info=True)
                self._stopped.wait(0.05)
                continue
            # Accepted sockets share the listen port as their local addr;
            # without SO_REUSEADDR a severed-but-lingering one (FIN_WAIT
            # after pause_listener) would block the rebind on resume.
            try:
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            except OSError:
                pass
            addr = "?"
            try:
                addr = conn.getpeername()[0]
            except OSError:
                pass
            guard = self.guard
            if guard is not None and not guard.admit(addr):
                # Banned peer or full quota: refuse before reading a byte.
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            with self._inbound_lock:
                if self._stopped.is_set():
                    conn.close()
                    if guard is not None:
                        guard.release(addr)
                    return
                self._inbound.add(conn)
            threading.Thread(
                target=self._receive_loop,
                args=(conn, addr),
                name=f"comm-{self.self_id}-recv",
                daemon=True,
            ).start()

    def _receive_loop(self, conn: socket.socket, addr: str = "?") -> None:
        pinned_sender: Optional[int] = None
        guard = self.guard

        def strike(kind: str) -> None:
            if guard is not None:
                guard.strike(addr, kind)

        # Challenge: a fresh nonce per connection (replay protection).
        nonce = os.urandom(_NONCE_BYTES)
        try:
            conn.sendall(_HEADER.pack(len(nonce), self.self_id, _KIND_HELLO) + nonce)
        except OSError:
            with self._inbound_lock:
                self._inbound.discard(conn)
            if guard is not None:
                guard.release(addr)
            try:
                conn.close()
            except OSError:
                pass
            return
        try:
            while not self._stopped.is_set():
                plan = self.fault_plan
                if plan is not None and plan.trip("net.recv.short_read"):
                    # Simulate the link dying mid-frame: the finally block
                    # closes the connection exactly as a real short read
                    # below would; the sender reconnects lazily.
                    return
                # Until the HELLO pins an identity, every read runs under
                # the handshake deadline; after it, the header read waits
                # patiently (an idle honest peer) but any started frame
                # must keep making progress (slow-loris defense).
                if guard is None:
                    timeout, patient, preset = None, False, False
                elif pinned_sender is None:
                    timeout, patient, preset = (
                        guard.handshake_timeout, False, False
                    )
                else:
                    # Pinned connections read non-blocking (set below):
                    # preset reads try recv first and enforce the
                    # progress deadline only when a read actually blocks.
                    timeout, patient, preset = (
                        guard.progress_timeout, True, True
                    )
                try:
                    header = recv_exact(
                        conn, _HEADER.size,
                        progress_timeout=timeout, patient_first=patient,
                        preset=preset,
                    )
                except FrameStall as stall:
                    if pinned_sender is None and stall.received == 0:
                        # Never sent a byte: connect-and-idle, not a frame.
                        if guard is not None:
                            guard.handshake_timed_out(addr)
                    else:
                        strike("stall")
                    return
                if header is None:
                    return
                length, sender, kind = _HEADER.unpack(header)
                if length > MAX_FRAME_BYTES:
                    logger.warning("oversized frame from %d; dropping link", sender)
                    strike("oversized")
                    return
                try:
                    payload = recv_exact(
                        conn, length, progress_timeout=timeout, preset=preset,
                    )
                except FrameStall:
                    strike("stall")
                    return
                if payload is None:
                    return
                if pinned_sender is None:
                    # First frame must be the HELLO that pins this
                    # connection's identity (optionally HMAC-proven).
                    if kind != _KIND_HELLO:
                        logger.warning(
                            "%d: connection sent %d before HELLO; dropping link",
                            self.self_id, kind,
                        )
                        strike("pre_hello")
                        return
                    expected = _hello_proof(self._auth_secret, nonce, sender)
                    if not hmac.compare_digest(payload, expected):
                        logger.warning(
                            "%d: bad HELLO proof for claimed sender %d; dropping link",
                            self.self_id, sender,
                        )
                        strike("bad_hello")
                        return
                    pinned_sender = sender
                    if guard is not None:
                        # Pinned: go non-blocking for the connection's
                        # lifetime — preset reads try recv first and pay
                        # for a readiness wait only when a read actually
                        # blocks, so honest line rate matches unguarded.
                        try:
                            conn.setblocking(False)
                        except OSError:
                            return
                    continue
                if sender != pinned_sender:
                    logger.warning(
                        "%d: frame claims sender %d on connection pinned to %d; dropping link",
                        self.self_id, sender, pinned_sender,
                    )
                    strike("sender_pin")
                    return
                self._dispatch(sender, kind, payload)
        finally:
            with self._inbound_lock:
                self._inbound.discard(conn)
            if guard is not None:
                guard.release(addr)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, sender: int, kind: int, payload: bytes) -> None:
        if self._stopped.is_set():
            return
        try:
            if kind == _KIND_CONSENSUS:
                self._on_message(sender, decode_message(payload), False)
            elif kind == _KIND_REQUEST:
                self._on_message(sender, payload, True)
            else:
                logger.warning("unknown frame kind %d from %d", kind, sender)
        except Exception:
            # A malformed message must not kill the receive loop.
            logger.exception("failed dispatching frame from %d", sender)


class _Peer:
    """Outbound side for one peer: bounded queue + writer thread with lazy
    (re)connection."""

    def __init__(self, comm: TcpComm, node_id: int, addr: Tuple[str, int]) -> None:
        self._comm = comm
        self.node_id = node_id
        self.addr = addr
        self._queue: "queue.Queue[bytes]" = queue.Queue(maxsize=comm._queue_depth)
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._writer_loop,
            name=f"comm-{self._comm.self_id}->{self.node_id}",
            daemon=True,
        )
        self._thread.start()

    def enqueue(self, frame: bytes) -> None:
        try:
            self._queue.put_nowait(frame)
        except queue.Full:
            pass  # fire-and-forget: backpressure drops, protocol recovers

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    def _writer_loop(self) -> None:
        stopped = self._comm._stopped
        while not stopped.is_set():
            try:
                frame = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            self._send_with_retry(frame)

    def _send_with_retry(self, frame: bytes) -> None:
        """Deliver one frame, riding out a peer killed mid-frame: an abrupt
        close during ``sendall`` reconnects and re-sends the SAME frame up
        to ``send_retries`` times before the fire-and-forget drop."""
        metrics = self._comm.metrics
        for attempt in range(self._comm._send_retries + 1):
            sock = self._ensure_connected()
            if sock is None:
                break  # connect budget exhausted; drop below
            try:
                plan = self._comm.fault_plan
                if plan is not None:
                    plan.io_error("net.send.io_error")
                sock.sendall(frame)
                return
            except OSError:
                self._drop_connection()
                if attempt < self._comm._send_retries:
                    if metrics is not None:
                        metrics.count_send_retried.add(1)
                    continue
        if metrics is not None:
            metrics.count_send_dropped.add(1)

    def _ensure_connected(self) -> Optional[socket.socket]:
        """Bounded connect: up to ``connect_attempts`` tries with capped
        exponential backoff + jitter (desynchronizes a fleet reconnecting
        to a restarted peer), then give up on THIS frame — the next frame
        starts a fresh budget, so a peer that stays down costs bounded
        writer time and a peer that comes back is re-reached quickly."""
        if self._sock is not None:
            return self._sock
        comm = self._comm
        metrics = comm.metrics
        for attempt in range(comm._connect_attempts):
            if comm._stopped.is_set():
                return None
            if attempt:
                delay = min(
                    comm._backoff * (2.0 ** (attempt - 1)), comm._backoff_max
                )
                delay *= 0.5 + random.random() / 2.0  # jitter: 50-100%
                if comm._stopped.wait(delay):
                    return None
            if metrics is not None:
                metrics.count_reconnect_attempts.add(1)
            try:
                sock = socket.create_connection(
                    self.addr, timeout=comm._connect_timeout
                )
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # Read the acceptor's challenge nonce, answer with the proof.
                sock.settimeout(comm._connect_timeout)
                header = recv_exact(sock, _HEADER.size)
                if header is None:
                    raise OSError("peer closed during handshake")
                length, _, kind = _HEADER.unpack(header)
                if kind != _KIND_HELLO or length != _NONCE_BYTES:
                    raise OSError("bad handshake challenge")
                nonce = recv_exact(sock, length)
                if nonce is None:
                    raise OSError("peer closed during handshake")
                sock.settimeout(None)
                proof = _hello_proof(comm._auth_secret, nonce, comm.self_id)
                sock.sendall(
                    _HEADER.pack(len(proof), comm.self_id, _KIND_HELLO) + proof
                )
                self._sock = sock
                if metrics is not None:
                    metrics.count_reconnect_success.add(1)
                logger.info(
                    "%d: connected to peer %d at %s:%d",
                    comm.self_id, self.node_id, *self.addr,
                )
                return sock
            except OSError:
                continue
        # Budget exhausted: brief pause so a hard-down peer cannot spin the
        # writer thread at full speed frame after frame.
        comm._stopped.wait(comm._backoff)
        return None

    def _drop_connection(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


__all__ = ["TcpComm", "MAX_FRAME_BYTES"]
