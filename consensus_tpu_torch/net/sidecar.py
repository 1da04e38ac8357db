"""Verification service: many replica *processes* — and many replica
CLUSTERS — sharing one device mesh.

The reference always deploys replicas as separate OS processes (its Comm
contract is a network transport, reference pkg/api/dependencies.go:22-30);
each Go process burns its own cores verifying signatures.  The TPU-native
deployment shape (SURVEY §7 step 9) keeps one device (or mesh) per host and
lets every co-located replica process drain its signature sweeps into it
through a tiny socket front: the sidecar process owns the engine (and the
one compiled kernel shape) and coalesces concurrent requests into single
device launches.

**Single-tenant mode** (no ``tenants`` map): the original behavior —
one shared secret, requests served straight on the engine (typically a
:class:`consensus_tpu_torch.models.engine.ThreadCoalescingVerifier`).

**Multi-tenant mode** (``tenants`` = tenant id -> secret): one server
serves many replica clusters/channels.  Each connection authenticates AS a
tenant (per-tenant secret, same wire format as the legacy handshake), and
requests flow through a :class:`consensus_tpu_torch.models.engine
.FairShareWaveFormer`: per-tenant bounded queues with admission control
(structured reject — status 2 — never a stall), round-robin fair-share
draining, and deadline-aware cross-tenant coalescing so four channels'
quorum certs ride ONE mesh launch.  Over a mesh engine the former learns
the engine's ``preferred_wave_size`` (the padded shard-multiple that
saturates the whole slice, not one chip) and launches as soon as the
slice is full rather than waiting out the window.  Per-tenant metrics land in a
:class:`consensus_tpu_torch.metrics.MetricsSidecar` bundle and per-tenant kernel
attribution in :data:`consensus_tpu_torch.obs.kernels.TENANT_KERNELS`.

Client side, :class:`SidecarVerifierClient` is a drop-in ``engine`` for the
``Verifier`` mixins (same ``verify_batch`` contract).  With a
``local_engine`` supplied it also inherits the wedged-device escape hatch:
a sidecar that dies or stalls past ``request_timeout`` fails over to local
host verification (slower, still correct) instead of wedging the replica.
An admission reject surfaces as :class:`TenantAdmissionReject` (structured:
tenant, queue depth, limit) and falls back locally WITHOUT marking the
sidecar suspect — the service is healthy, the tenant is over quota.

Framing (both directions, all integers big-endian):

    u32 payload_len | u64 req_id | payload

Request payload:  u32 count | count * (u32 mlen u32 slen u32 klen m s k)
Response payload: u8 status | body
    status 0: count result bytes
    status 1: utf-8 error text
    status 2: u32 queue_depth | u32 limit | utf-8 tenant  (admission reject)
    status 3: count result bytes, served by a DEGRADED engine (the server's
              supervised verifier is below its top ladder rung — verdicts
              are still ground-truth correct, but a fleet-aware client
              deprioritizes this server on the placement ring until a
              status-0 answer clears it)

Addresses: a ``(host, port)`` tuple serves TCP (cross-container), a string
serves a unix domain socket (same-host, lower latency — the common shape).
TCP mode REQUIRES authentication (``auth_secret`` and/or ``tenants``): the
handshake is MUTUAL (both ends prove knowledge of the secret over a
domain-separated nonce pair) and derives a per-connection session key that
MACs every frame in both directions — a verification verdict is consensus
input, so a peer in path must not be able to forge "all valid" responses
(it can still drop the connection; that is the failover path, not a safety
hole).  Unix sockets rely on filesystem permissions instead but honour the
secrets when given.  The tenant handshake is wire-compatible with the
legacy one (same byte counts in each direction); the server distinguishes
tenants by WHICH secret validates the proof, with the tenant id bound into
the proof/session-key derivations so two tenants sharing a secret value
still get distinct sessions.

The PyTorch port's copy of ``consensus_tpu/net/sidecar.py``, its imports renamed.
"""

from __future__ import annotations

import hashlib
import hmac
import logging
import os
import socket
import struct
import threading
import time
from typing import Optional, Sequence, Union

import numpy as np

# jax-free (models/engine.py is pure numpy/threading), so importing the
# sidecar module still never drags in the accelerator stack.
from consensus_tpu_torch.models.engine import AdmissionReject as _AdmissionReject
from consensus_tpu_torch.net.framing import RECV_CHUNK_BYTES, ListenerGuard

logger = logging.getLogger("consensus_tpu_torch.net.sidecar")

_FRAME = struct.Struct(">IQ")
_ITEM = struct.Struct(">III")
#: Default frame-size ceiling.  64 MiB comfortably fits the largest real
#: sweep (a 16k-signature wave is < 2 MiB) while bounding what one
#: misbehaving peer can make the server buffer (ADVICE r4).
_MAX_FRAME = 64 * 1024 * 1024
_NONCE_LEN = 32
_MAC_LEN = 16
_HANDSHAKE_TIMEOUT = 5.0
#: Domain separation for the three HMAC uses (client proof, server proof,
#: session-key derivation) so a transcript from one role can never stand in
#: for another.
_CLIENT_PROOF = b"ctpu-sidecar-client-v1"
_SERVER_PROOF = b"ctpu-sidecar-server-v1"
_SESSION_KEY = b"ctpu-sidecar-session-v1"
#: Tenant-mode client proof: a distinct domain tag (and the tenant id bound
#: into every derivation) so a legacy transcript can never double as a
#: tenant proof or vice versa.
_TENANT_PROOF = b"ctpu-sidecar-tenant-v1"

Address = Union[tuple, str]


class QueueStallTimeout(TimeoutError):
    """The per-request budget expired while the request was still QUEUED
    behind other senders — the wire itself was never observed to stall, so
    callers must not treat this as evidence the sidecar is wedged."""


class SidecarQueueStall(QueueStallTimeout):
    """A :class:`QueueStallTimeout` with structure: WHICH tenant gave up,
    how many requests were locally queued ahead of it, and the budget that
    expired — so a multi-tenant operator can tell one tenant's local send
    pressure from a service-wide stall."""

    def __init__(
        self, reason: str, *, tenant: str = "", queue_depth: int = 0,
        deadline: float = 0.0,
    ) -> None:
        super().__init__(reason)
        self.tenant = tenant
        self.queue_depth = queue_depth
        self.deadline = deadline


class TenantAdmissionReject(RuntimeError):
    """The server REJECTED the batch at admission (tenant queue full,
    status 2) — structured, immediate, and deliberately NOT a
    ``TimeoutError``: the service is healthy, so the client must fall back
    locally without marking the sidecar suspect or disturbing other
    tenants' waves."""

    def __init__(self, tenant: str, queue_depth: int, limit: int) -> None:
        super().__init__(
            f"sidecar admission rejected tenant {tenant!r}: "
            f"{queue_depth} signatures queued, limit {limit}"
        )
        self.tenant = tenant
        self.queue_depth = queue_depth
        self.limit = limit


def _with_tenant(instrument, tenant: str):
    """The per-tenant child series of a pinned instrument, or the base
    instrument when the bundle was built without a tenant label (metrics
    must never break the serve path)."""
    try:
        return instrument.with_labels(tenant)
    except Exception:
        return instrument


def _hmac256(key: bytes, *parts: bytes) -> bytes:
    mac = hmac.new(key, digestmod=hashlib.sha256)
    for p in parts:
        mac.update(p)
    return mac.digest()


def _frame_mac(key: bytes, direction: bytes, req_id: int, payload: bytes) -> bytes:
    return _hmac256(key, direction, req_id.to_bytes(8, "big"), payload)[:_MAC_LEN]


class _MidFrameStall(ConnectionError):
    """A peer stopped sending mid-frame (the server books a ``stall``)."""


class _FrameTooLarge(ConnectionError):
    """A peer claimed a frame beyond the cap (booked as ``oversized``)."""


class _MacMismatch(ConnectionError):
    """A frame MAC failed verification (booked as ``bad_hello``)."""


def _recv_exact(sock: socket.socket, n: int, patient: bool = False) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            # Chunked (cap-check-before-allocate): allocation tracks bytes
            # actually received, never the peer's claimed length.
            chunk = sock.recv(min(n - len(buf), RECV_CHUNK_BYTES))
        except TimeoutError:
            if patient:
                # The CLIENT reader trusts its one sidecar and must not
                # tear a healthy connection down over a slow frame (another
                # thread may also shorten the shared socket's deadline
                # transiently); liveness comes from the per-request budget,
                # whose expiry closes the socket and ends this recv.
                continue
            if buf:
                # A stall MID-frame loses protocol sync; only an idle
                # timeout at a frame boundary is benign (re-raised for the
                # caller to swallow).
                raise _MidFrameStall("sidecar stalled mid-frame")
            raise
        if not chunk:
            raise ConnectionError("sidecar connection closed")
        buf.extend(chunk)
    return bytes(buf)


def _read_frame(
    sock: socket.socket,
    max_frame: int = _MAX_FRAME,
    mac_key: Optional[bytes] = None,
    direction: bytes = b"",
    patient: bool = False,
) -> tuple[int, bytes]:
    """Read one frame; with a session ``mac_key``, verify the trailing MAC
    (keyed on direction + req_id + payload) and drop the connection on any
    mismatch — an in-path forger must not be able to mint verdicts."""
    header = _recv_exact(sock, _FRAME.size, patient)
    length, req_id = _FRAME.unpack(header)
    if length > max_frame:
        raise _FrameTooLarge(f"sidecar frame too large: {length}")
    try:
        payload = _recv_exact(sock, length, patient)
        if mac_key is not None:
            mac = _recv_exact(sock, _MAC_LEN, patient)
            if not hmac.compare_digest(
                mac, _frame_mac(mac_key, direction, req_id, payload)
            ):
                raise _MacMismatch("sidecar frame MAC mismatch")
    except TimeoutError:
        raise _MidFrameStall("sidecar stalled mid-frame") from None
    return req_id, payload


def _write_frame(
    sock: socket.socket,
    req_id: int,
    payload: bytes,
    mac_key: Optional[bytes] = None,
    direction: bytes = b"",
) -> None:
    buf = _FRAME.pack(len(payload), req_id) + payload
    if mac_key is not None:
        buf += _frame_mac(mac_key, direction, req_id, payload)
    sock.sendall(buf)


def encode_request(messages, signatures, keys) -> bytes:
    parts = [struct.pack(">I", len(messages))]
    for m, s, k in zip(messages, signatures, keys):
        parts.append(_ITEM.pack(len(m), len(s), len(k)))
        parts.append(bytes(m))
        parts.append(bytes(s))
        parts.append(bytes(k))
    return b"".join(parts)


def decode_request(payload: bytes) -> tuple[list, list, list]:
    (count,) = struct.unpack_from(">I", payload, 0)
    offset = 4
    messages, signatures, keys = [], [], []
    for _ in range(count):
        mlen, slen, klen = _ITEM.unpack_from(payload, offset)
        offset += _ITEM.size
        messages.append(payload[offset : offset + mlen]); offset += mlen
        signatures.append(payload[offset : offset + slen]); offset += slen
        keys.append(payload[offset : offset + klen]); offset += klen
    if offset != len(payload):
        raise ValueError("trailing bytes in sidecar request")
    return messages, signatures, keys


class VerifySidecarServer:
    """Socket front on a verification engine (typically a
    ``ThreadCoalescingVerifier`` so concurrent replica processes merge into
    one device launch).  One thread per connection reads requests; each
    request is served on its own worker thread — a replica pipelining
    decisions can have several requests in flight on one connection, and a
    blocking coalescer call must not serialize them.

    ``auth_secret`` (REQUIRED for TCP): shared secret for the per-connection
    challenge-response — the server sends a random nonce, the peer must
    answer ``HMAC-SHA256(secret, nonce)`` within ``_HANDSHAKE_TIMEOUT`` or
    the connection is dropped before any frame is read.  Unix sockets may
    omit it (filesystem permissions are the perimeter) but honour it when
    given.

    ``max_inflight`` bounds the worker threads PER CONNECTION: when a peer
    has that many requests outstanding the connection's read loop blocks,
    pushing backpressure into the peer's socket instead of spawning
    unbounded threads (ADVICE r4 flood surface).

    ``io_timeout`` is the per-connection socket timeout: a peer that stops
    READING its responses stalls a worker's send for at most this long,
    after which the connection is torn down and its worker slots recovered —
    otherwise a connect-flood-abandon peer would park ``max_inflight``
    threads per connection forever.

    ``guard``: hardened DEFAULT-ON via a :class:`~consensus_tpu_torch.net.framing
    .ListenerGuard` — per-peer/global connection quotas checked at accept
    (before the handshake spends a nonce), plus strikes toward a temporary
    ban for provably-malformed traffic: a failed auth proof or frame-MAC
    mismatch (``bad_hello``), an oversized length claim, a mid-frame stall.
    A peer that connects and never attempts the handshake books a
    handshake timeout.  Pass a configured guard to tune, or ``guard=False``
    for the pre-hardening behavior."""

    def __init__(
        self,
        address: Address,
        engine,
        *,
        auth_secret: Optional[bytes] = None,
        tenants: Optional[dict] = None,
        max_inflight: int = 32,
        max_frame: int = _MAX_FRAME,
        io_timeout: float = 60.0,
        wave_window: float = 0.005,
        max_wave: int = 8192,
        tenant_queue_limit: int = 4096,
        metrics=None,
        tenant_accounting=None,
        guard=None,
    ) -> None:
        self._address = address
        self._engine = engine
        self._secret = auth_secret
        if guard is None:
            guard = ListenerGuard(name="sidecar")
        self.guard = guard or None
        self._tenants = dict(tenants) if tenants else None
        self._max_inflight = max_inflight
        self._max_frame = max_frame
        self._io_timeout = io_timeout
        self._metrics = metrics
        self._accounting = tenant_accounting
        self._former = None
        if self._tenants is not None:
            from consensus_tpu_torch.models.engine import FairShareWaveFormer

            if self._accounting is None:
                from consensus_tpu_torch.obs.kernels import TENANT_KERNELS

                self._accounting = TENANT_KERNELS
            self._former = FairShareWaveFormer(
                engine,
                window=wave_window,
                max_wave=max_wave,
                tenant_queue_limit=tenant_queue_limit,
                on_wave=self._record_wave,
                name="sidecar-waves",
            )
        self._listener: Optional[socket.socket] = None
        self._stopping = False

    def _record_wave(self, tenant_counts: dict, total: int) -> None:
        """FairShareWaveFormer hook: per-tenant kernel attribution + the
        pinned wave metrics (one launch, its signature volume, how many
        tenants shared it)."""
        if self._accounting is not None:
            for tenant, count in tenant_counts.items():
                self._accounting.record_wave(tenant, count)
        m = self._metrics
        if m is not None:
            m.count_wave_launches.add(1)
            m.count_wave_signatures.add(total)
            m.count_wave_tenants.add(len(tenant_counts))
            for tenant, count in tenant_counts.items():
                _with_tenant(m.count_wave_signatures, tenant).add(count)

    @property
    def address(self) -> Address:
        """The bound address (with the real port once started)."""
        return self._address

    def start(self) -> None:
        if isinstance(self._address, str):
            try:
                os.unlink(self._address)
            except OSError:
                pass
            listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            listener.bind(self._address)
        elif self._secret is None and self._tenants is None:
            raise ValueError(
                "TCP sidecar mode requires auth_secret or tenants: an "
                "unauthenticated TCP listener hands free verification "
                "cycles to anyone who can reach the port (use a unix "
                "socket for same-host deployments)"
            )
        else:
            listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.bind(tuple(self._address))
            self._address = listener.getsockname()
        listener.listen(64)
        self._listener = listener
        threading.Thread(
            target=self._accept_loop, daemon=True, name="sidecar-accept"
        ).start()

    def stop(self) -> None:
        self._stopping = True
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if self._former is not None:
            self._former.close()
        if isinstance(self._address, str):
            try:
                os.unlink(self._address)
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            addr = "local"  # AF_UNIX peers have no address; quota them as one
            if conn.family == socket.AF_INET:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                try:
                    addr = conn.getpeername()[0]
                except OSError:
                    addr = "?"
            guard = self.guard
            if guard is not None and not guard.admit(addr):
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            # Daemon threads, deliberately untracked: connections churn for
            # the life of the sidecar and holding dead Thread objects would
            # grow without bound; stop() only needs the listener.
            threading.Thread(
                target=self._serve_conn, args=(conn, addr), daemon=True,
                name="sidecar-conn",
            ).start()

    def _handshake(
        self, conn: socket.socket, addr: str = "?"
    ) -> Optional[tuple[bytes, str]]:
        """MUTUAL challenge-response: the peer proves knowledge of A secret
        over (server_nonce, client_nonce), the server proves it back, and
        both derive the per-connection session key that MACs every frame.
        Returns ``(session_key, tenant_id)`` — tenant ``""`` for the legacy
        shared secret — or None to drop the peer.  The tenant variant is
        byte-compatible on the wire: the server identifies the tenant by
        WHICH secret validates the proof (the tenant id is bound inside the
        HMACs, not sent in clear).  Runs under a deadline so an idle
        connect cannot park a thread."""
        conn.settimeout(
            self.guard.handshake_timeout
            if self.guard is not None else _HANDSHAKE_TIMEOUT
        )
        try:
            server_nonce = os.urandom(_NONCE_LEN)
            conn.sendall(server_nonce)
            client_nonce = _recv_exact(conn, _NONCE_LEN)
            answer = _recv_exact(conn, hashlib.sha256().digest_size)
            matched: Optional[tuple[bytes, str, bytes, bytes]] = None
            if self._secret is not None:
                expect = _hmac256(
                    self._secret, _CLIENT_PROOF, server_nonce, client_nonce
                )
                if hmac.compare_digest(answer, expect):
                    matched = (
                        self._secret,
                        "",
                        _hmac256(
                            self._secret, _SERVER_PROOF,
                            server_nonce, client_nonce,
                        ),
                        _hmac256(
                            self._secret, _SESSION_KEY,
                            server_nonce, client_nonce,
                        ),
                    )
            if matched is None and self._tenants:
                for tenant, secret in self._tenants.items():
                    tid = tenant.encode()
                    expect = _hmac256(
                        secret, _TENANT_PROOF, tid, server_nonce, client_nonce
                    )
                    if hmac.compare_digest(answer, expect):
                        matched = (
                            secret,
                            tenant,
                            _hmac256(
                                secret, _SERVER_PROOF, tid,
                                server_nonce, client_nonce,
                            ),
                            _hmac256(
                                secret, _SESSION_KEY, tid,
                                server_nonce, client_nonce,
                            ),
                        )
                        break
            if matched is None:
                # A wrong proof (wrong secret, or a replayed transcript
                # against this connection's fresh nonce) is provably
                # malformed: strike toward a ban.
                if self.guard is not None:
                    self.guard.strike(addr, "bad_hello")
                logger.warning("sidecar: rejected peer with bad auth answer")
                return None
            _, tenant, server_proof, session_key = matched
            conn.sendall(server_proof)
            return session_key, tenant
        except socket.timeout:
            # Connect-and-idle: the peer never attempted the handshake.
            if self.guard is not None:
                self.guard.handshake_timed_out(addr)
            logger.warning("sidecar: peer failed to complete auth handshake")
            return None
        except (ConnectionError, OSError):
            # EOF mid-handshake: a crashed honest client looks the same, so
            # this path books nothing (quotas still bound connect-floods).
            logger.warning("sidecar: peer failed to complete auth handshake")
            return None

    def _serve_conn(self, conn: socket.socket, addr: str = "local") -> None:
        write_lock = threading.Lock()
        # Per-connection in-flight bound: acquire before dispatch, release
        # when the worker answers; a saturated peer blocks HERE (TCP
        # backpressure) instead of growing the thread count.
        slots = threading.BoundedSemaphore(self._max_inflight)
        guard = self.guard
        mac_key: Optional[bytes] = None
        tenant = ""
        try:
            if self._secret is not None or self._tenants is not None:
                outcome = self._handshake(conn, addr)
                if outcome is None:
                    return
                mac_key, tenant = outcome
            # Socket timeout bounds worker SENDS to a non-reading peer; the
            # read loop below treats frame-boundary timeouts as idle.
            conn.settimeout(self._io_timeout)
            while True:
                try:
                    req_id, payload = _read_frame(
                        conn, self._max_frame, mac_key, b"c2s"
                    )
                except _FrameTooLarge:
                    if guard is not None:
                        guard.strike(addr, "oversized")
                    return
                except _MacMismatch:
                    if guard is not None:
                        guard.strike(addr, "bad_hello")
                    return
                except _MidFrameStall:
                    if guard is not None:
                        guard.strike(addr, "stall")
                    return
                except TimeoutError:
                    continue  # idle peer at a frame boundary
                slots.acquire()
                threading.Thread(
                    target=self._serve_request,
                    args=(
                        conn, write_lock, slots, mac_key, tenant,
                        req_id, payload,
                    ),
                    daemon=True,
                    name="sidecar-verify",
                ).start()
        except (ConnectionError, OSError):
            pass
        finally:
            if guard is not None:
                guard.release(addr)
            try:
                conn.close()
            except OSError:
                pass

    def _verify(self, tenant: str, messages, signatures, keys):
        """Single-tenant mode serves straight on the engine (PR-4 path);
        multi-tenant mode goes through the fair-share wave former, which may
        raise :class:`consensus_tpu_torch.models.engine.AdmissionReject`."""
        if self._former is None:
            return self._engine.verify_batch(messages, signatures, keys)
        results = self._former.submit(tenant, messages, signatures, keys)
        m = self._metrics
        if m is not None:
            m.count_admission_accepted.add(1)
            _with_tenant(m.count_admission_accepted, tenant).add(1)
            m.admission_queue_depth.set(self._former.pending_count)
        return results

    def _serve_request(
        self, conn, write_lock, slots, mac_key, tenant: str, req_id: int,
        payload: bytes,
    ) -> None:
        try:
            messages, signatures, keys = decode_request(payload)
            results = np.asarray(self._verify(tenant, messages, signatures, keys))
            if len(results) != len(messages):
                raise ValueError("engine returned wrong result count")
            # Degraded-health surfacing: sampled at answer time so the
            # status tracks the supervisor's CURRENT rung (and the
            # coalescer's suspect flag), not the state when the request
            # was queued.
            degraded = bool(
                getattr(self._engine, "degraded", False)
                or getattr(self._engine, "device_suspect", False)
            )
            status = b"\x03" if degraded else b"\x00"
            body = status + np.asarray(results, dtype=np.uint8).tobytes()
        except _AdmissionReject as rej:
            # Structured, immediate, and NOT an error to log at exception
            # level: the tenant is over quota, the service is fine.
            logger.warning(
                "sidecar admission reject: tenant %r depth %d limit %d",
                tenant, rej.queue_depth, rej.limit,
            )
            body = (
                b"\x02"
                + struct.pack(">II", rej.queue_depth, rej.limit)
                + tenant.encode()
            )
            m = self._metrics
            if m is not None:
                m.count_admission_rejects.add(1)
                _with_tenant(m.count_admission_rejects, tenant).add(1)
        except Exception as exc:  # serve the error, keep the connection
            logger.exception("sidecar verify request %d failed", req_id)
            body = b"\x01" + repr(exc).encode()
        try:
            with write_lock:
                try:
                    _write_frame(conn, req_id, body, mac_key, b"s2c")
                except OSError:
                    # Client gone OR not reading (send timed out): close
                    # WHILE STILL HOLDING write_lock — a partial frame may
                    # be on the wire, and the next writer interleaving into
                    # it would splice its header bytes into this frame's
                    # declared payload (a forged verdict on un-MAC'd unix
                    # connections).  A dead fd makes every queued writer
                    # fail fast and recovers the read loop's slots.
                    try:
                        conn.close()
                    except OSError:
                        pass
                    raise
        except OSError:
            pass
        finally:
            slots.release()


class SidecarVerifierClient:
    """Drop-in ``engine`` (the ``verify_batch`` contract) that forwards
    batches to a :class:`VerifySidecarServer` over one multiplexed
    connection.  Thread-safe: concurrent calls are tagged with request ids
    and a single reader thread routes responses.

    ``local_engine``: optional engine whose ``verify_host`` serves as the
    escape hatch — if the sidecar is unreachable, errors, or stalls past
    ``request_timeout``, verification falls back to the local host path
    (logged loudly) instead of wedging the replica.

    ``bypass_below``: batches smaller than this verify locally (via
    ``local_engine.verify_host``) without a socket round trip — quorum-sized
    checks and single signatures gain nothing from the device and shouldn't
    pay the sidecar RTT + coalescing window.

    ``auth_secret``: shared secret answering the server's TCP
    challenge-response handshake (must match the server's).

    ``tenant``: authenticate as this tenant on a multi-tenant server —
    ``auth_secret`` then holds the PER-TENANT secret and the handshake
    binds the tenant id into every derivation.  Leave None for the legacy
    single-tenant handshake.

    ``fleet`` / ``fleet_id``: placement-aware retry.  ``fleet`` is a
    :class:`~consensus_tpu_torch.ingress.placement.SidecarFleet` and ``fleet_id``
    this client's own server id on its ring.  A structured
    :class:`TenantAdmissionReject` then means THIS server's tenant queue is
    full, not that the fleet is — the batch is handed to the ring's next
    candidate for the tenant (pinned ``ingress_reroute_total`` counts the
    handoffs) before any local fallback.
    """

    def __init__(
        self,
        address: Address,
        *,
        local_engine=None,
        request_timeout: float = 60.0,
        connect_timeout: float = 5.0,
        bypass_below: int = 0,
        probe_interval: float = 10.0,
        auth_secret: Optional[bytes] = None,
        tenant: Optional[str] = None,
        fault_plan=None,
        tracer=None,
        fleet=None,
        fleet_id: Optional[str] = None,
    ) -> None:
        #: Optional testing FaultPlan (consensus_tpu_torch/testing/faults.py):
        #: arms the sidecar.send.io_error / sidecar.recv.short_read seams.
        self.fault_plan = fault_plan
        #: Optional decision-lifecycle tracer.  verify_batch runs on caller
        #: threads, so posted instants rely on the tracer's internal lock.
        self._tracer = tracer
        self._address = address
        self._timeout = request_timeout
        self._connect_timeout = connect_timeout
        self._local = local_engine
        self._bypass_below = bypass_below if local_engine is not None else 0
        self._probe_interval = probe_interval
        self._secret = auth_secret
        self._tenant = tenant
        if tenant is not None and auth_secret is None:
            raise ValueError("tenant mode requires auth_secret (the tenant secret)")
        self._fleet = fleet
        self._fleet_id = fleet_id
        if fleet is not None and fleet_id is None:
            raise ValueError("fleet mode requires fleet_id (this server's ring id)")
        self._mac_key: Optional[bytes] = None  # per-connection session key
        self._lock = threading.Lock()  # guards socket create + pending map
        self._sock: Optional[socket.socket] = None
        #: Serializes SENDS on the current socket, separately from
        #: ``_lock``: a send that stalls (wedged sidecar, full kernel
        #: buffer) must not block verify calls that only need the pending
        #: map (ADVICE r4 medium).  Replaced together with the socket.
        self._wlock = threading.Lock()
        self._pending: dict[int, dict] = {}
        self._next_id = 0
        self._reader: Optional[threading.Thread] = None
        #: Set after a request TIMES OUT (sidecar wedged, not just dead):
        #: later calls skip the stall and go straight to the local fallback
        #: while a background probe watches for recovery.
        self._suspect = False
        self._closed = False

    # -- engine contract ---------------------------------------------------

    def verify_batch(self, messages, signatures, public_keys) -> np.ndarray:
        n = len(messages)
        if not (n == len(signatures) == len(public_keys)):
            raise ValueError("batch length mismatch")
        if n == 0:
            return np.zeros(0, dtype=bool)
        tracer = self._tracer
        if tracer is not None and tracer.enabled:
            tracer.instant("net", "sidecar.verify", n=n)
        if self._suspect and self._local is not None:
            # Wedged sidecar: don't stall request_timeout on every call —
            # the background probe clears the flag when it recovers.
            return np.asarray(
                self._local.verify_host(messages, signatures, public_keys)
            )
        if n < self._bypass_below:
            return np.asarray(
                self._local.verify_host(messages, signatures, public_keys)
            )
        try:
            result = self._roundtrip(messages, signatures, public_keys)
        except TenantAdmissionReject as reject:
            rerouted = self._fleet_reroute(
                messages, signatures, public_keys, reject
            )
            if rerouted is not None:
                return rerouted
            if self._local is None:
                raise
            logger.error(
                "sidecar admission reject (%r) with no accepting fleet peer "
                "— falling back to LOCAL host verification for %d signatures",
                reject,
                n,
            )
            if tracer is not None and tracer.enabled:
                tracer.instant("net", "sidecar.fallback", n=n)
            return np.asarray(
                self._local.verify_host(messages, signatures, public_keys)
            )
        except Exception as exc:
            if self._local is None:
                raise
            if isinstance(exc, TimeoutError) and not isinstance(
                exc, QueueStallTimeout
            ):
                self._mark_suspect()
            logger.error(
                "sidecar verify failed (%r) — falling back to LOCAL host "
                "verification for %d signatures",
                exc,
                n,
            )
            if tracer is not None and tracer.enabled:
                tracer.instant("net", "sidecar.fallback", n=n)
            return np.asarray(
                self._local.verify_host(messages, signatures, public_keys)
            )
        return result

    def _fleet_reroute(self, messages, signatures, keys, reject):
        """Placement-aware retry: walk the hash ring's remaining candidates
        for our tenant and hand the batch to the first peer that accepts
        it.  Per-tenant admission pressure is a PER-SERVER property, so the
        rendezvous order gives every tenant the same deterministic failover
        chain.  Returns None when no fleet is configured or every peer
        refuses (the caller then falls back locally / re-raises)."""
        fleet = self._fleet
        if fleet is None:
            return None
        tenant = self._tenant or ""
        for server_id in fleet.candidates(tenant):
            if server_id == self._fleet_id:
                continue
            peer = fleet.client_for(server_id)
            if peer is self:
                continue
            try:
                result = peer.verify_batch(messages, signatures, keys)
            except Exception:
                continue  # rejected or unreachable peer: try the next
            fleet.on_reroute(tenant, self._fleet_id, server_id)
            logger.warning(
                "tenant %r admission-rejected by %r (depth %d/%d) — "
                "rerouted batch to fleet peer %r",
                tenant, self._fleet_id, reject.queue_depth, reject.limit,
                server_id,
            )
            return result
        return None

    def _mark_suspect(self) -> None:
        """A timed-out request means the sidecar is wedged (its device call
        hung), not merely dead: drop the socket so other in-flight waiters
        fail over immediately, and probe for recovery in the background."""
        with self._lock:
            if self._suspect or self._closed:
                already = True
            else:
                self._suspect = True
                already = False
            sock = self._sock
        if already:
            return
        logger.error(
            "sidecar did not answer within %.1fs — marking it suspect; "
            "verification continues on the LOCAL host path until a probe "
            "succeeds",
            self._timeout,
        )
        if sock is not None:
            self._drop_socket(sock)
        threading.Thread(
            target=self._probe_loop, daemon=True, name="sidecar-probe"
        ).start()

    def _probe_loop(self) -> None:
        while True:
            time.sleep(self._probe_interval)
            with self._lock:
                if self._closed or not self._suspect:
                    return
            try:
                # An empty batch exercises the full socket + server + engine
                # dispatch path cheaply.
                self._roundtrip([], [], [], timeout=self._probe_interval)
            except Exception:
                continue
            with self._lock:
                self._suspect = False
            logger.warning("sidecar recovered — resuming sidecar verification")
            return

    def verify_host(self, messages, signatures, public_keys) -> np.ndarray:
        """Escape-hatch seam (used if this client is itself wrapped in a
        coalescer): local host verification, bypassing the sidecar."""
        if self._local is None:
            raise RuntimeError("no local_engine configured")
        return np.asarray(
            self._local.verify_host(messages, signatures, public_keys)
        )

    # -- plumbing ----------------------------------------------------------

    def _ensure_connected(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        if isinstance(self._address, str):
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        else:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.settimeout(self._connect_timeout)
        sock.connect(
            self._address if isinstance(self._address, str)
            else tuple(self._address)
        )
        self._mac_key = None
        if self._secret is not None:
            # Legacy and tenant handshakes are byte-identical on the wire;
            # tenant mode swaps the proof domain tag and binds the tenant id
            # into every derivation.
            tid = None if self._tenant is None else self._tenant.encode()
            try:
                server_nonce = _recv_exact(sock, _NONCE_LEN)
                client_nonce = os.urandom(_NONCE_LEN)
                if tid is None:
                    answer = _hmac256(
                        self._secret, _CLIENT_PROOF, server_nonce, client_nonce
                    )
                    expect = _hmac256(
                        self._secret, _SERVER_PROOF, server_nonce, client_nonce
                    )
                else:
                    answer = _hmac256(
                        self._secret, _TENANT_PROOF, tid,
                        server_nonce, client_nonce,
                    )
                    expect = _hmac256(
                        self._secret, _SERVER_PROOF, tid,
                        server_nonce, client_nonce,
                    )
                sock.sendall(client_nonce + answer)
                proof = _recv_exact(sock, hashlib.sha256().digest_size)
                if not hmac.compare_digest(proof, expect):
                    raise ConnectionError(
                        "sidecar failed mutual auth (bad server proof)"
                    )
            except BaseException:
                # Close on EVERY failed-handshake path (rejection, EOF,
                # timeout) — each verify retry would otherwise abandon an
                # open fd to the GC.
                sock.close()
                raise
            if tid is None:
                self._mac_key = _hmac256(
                    self._secret, _SESSION_KEY, server_nonce, client_nonce
                )
            else:
                self._mac_key = _hmac256(
                    self._secret, _SESSION_KEY, tid, server_nonce, client_nonce
                )
        # A real timeout (not None) so a blocked sendall on a wedged sidecar
        # surfaces as TimeoutError instead of hanging the sender forever;
        # the reader treats frame-boundary timeouts as idle (ADVICE r4).
        sock.settimeout(self._timeout)
        if sock.family == socket.AF_INET:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._wlock = threading.Lock()
        self._reader = threading.Thread(
            target=self._read_loop, args=(sock, self._mac_key), daemon=True,
            name="sidecar-client-reader",
        )
        self._reader.start()
        return sock

    def _roundtrip(
        self, messages, signatures, keys, *, timeout: Optional[float] = None
    ) -> np.ndarray:
        payload = encode_request(messages, signatures, keys)
        waiter = {"event": threading.Event(), "body": None}
        with self._lock:
            sock = self._ensure_connected()
            wlock = self._wlock
            mac_key = self._mac_key
            req_id = self._next_id
            self._next_id += 1
            waiter["sock"] = sock
            self._pending[req_id] = waiter
        # OUTSIDE self._lock: a send that stalls on a full kernel buffer
        # (wedged sidecar) must not block other verify calls — they only
        # need the pending map.  The per-socket wlock keeps frames whole;
        # the socket's timeout turns a dead stall into TimeoutError, which
        # verify_batch maps to suspect + local failover.  ONE absolute
        # deadline covers every stage (wlock queueing, the send itself, the
        # response wait) so a call behind a stalled sender still fails over
        # within its own budget rather than 3x it.
        budget = timeout if timeout is not None else self._timeout
        # Real-thread I/O deadline: this path runs outside the scheduler.
        deadline = time.monotonic() + budget  # wallclock-ok

        def _give_up_queued(reason: str):
            # Budget spent without touching the wire: the socket is healthy,
            # so concurrent waiters keep it — only this call bows out, and
            # the distinct type keeps verify_batch from marking the sidecar
            # suspect over what is only local queueing pressure.  Structured
            # so a multi-tenant operator sees WHO gave up and behind how
            # many locally queued requests.
            with self._lock:
                self._pending.pop(req_id, None)
                depth = len(self._pending)
            return SidecarQueueStall(
                reason, tenant=self._tenant or "", queue_depth=depth,
                deadline=budget,
            )

        if not wlock.acquire(timeout=budget):
            raise _give_up_queued(f"sidecar send queue stalled for {budget}s")
        try:
            if waiter["event"].is_set():
                raise ConnectionError("sidecar connection lost before send")
            if deadline - time.monotonic() <= 0:  # wallclock-ok
                raise _give_up_queued(
                    f"sidecar send queue stalled for {budget}s"
                )
            # The send runs under the socket's FIXED timeout (per-call
            # shrinking would race the reader thread recv'ing on the same
            # socket mid-frame), so the true worst case is queue-wait +
            # one socket timeout.  A timeout DURING sendall leaves a
            # partial frame on the wire, so that path drops the socket.
            try:
                plan = self.fault_plan
                if plan is not None:
                    plan.io_error("sidecar.send.io_error")
                _write_frame(sock, req_id, payload, mac_key, b"c2s")
            except OSError as exc:
                with self._lock:
                    self._pending.pop(req_id, None)
                self._drop_socket(sock)
                raise exc
        except ConnectionError:
            with self._lock:
                self._pending.pop(req_id, None)
            raise
        finally:
            wlock.release()
        if not waiter["event"].wait(max(0.0, deadline - time.monotonic())):  # wallclock-ok
            with self._lock:
                self._pending.pop(req_id, None)
            raise TimeoutError(f"sidecar did not answer within {budget}s")
        body = waiter["body"]
        if body is None:
            raise ConnectionError("sidecar connection lost mid-request")
        if body[0] == 2:
            depth, limit = struct.unpack_from(">II", body, 1)
            raise TenantAdmissionReject(
                body[9:].decode(errors="replace"), depth, limit
            )
        if body[0] == 1:
            raise RuntimeError(f"sidecar error: {body[1:].decode(errors='replace')}")
        if body[0] not in (0, 3):
            raise RuntimeError(f"unknown sidecar status byte {body[0]}")
        if self._fleet is not None and self._fleet_id is not None:
            # Status 3: results from a DEGRADED engine — verdicts are
            # correct (the supervisor's host twin is ground truth) but the
            # ring should steer reroutes at healthy peers first; a status-0
            # answer means the supervisor re-promoted, clearing the mark.
            self._fleet.note_degraded(self._fleet_id, body[0] == 3)
        results = np.frombuffer(body[1:], dtype=np.uint8).astype(bool)
        if len(results) != len(messages):
            raise ValueError("sidecar returned wrong result count")
        return results

    def _read_loop(self, sock: socket.socket, mac_key: Optional[bytes]) -> None:
        try:
            while True:
                plan = self.fault_plan
                if plan is not None and plan.trip("sidecar.recv.short_read"):
                    # Simulate the response link dying mid-frame: the finally
                    # block drops the socket, failing in-flight waiters over
                    # to the local path exactly as a real short read would.
                    return
                try:
                    req_id, body = _read_frame(
                        sock, _MAX_FRAME, mac_key, b"s2c", patient=True
                    )
                except TimeoutError:
                    continue  # unreachable with patient=True; belt-and-braces
                with self._lock:
                    waiter = self._pending.pop(req_id, None)
                if waiter is not None:
                    waiter["body"] = body
                    waiter["event"].set()
        except (ConnectionError, OSError):
            pass
        finally:
            self._drop_socket(sock)

    def _drop_socket(self, sock: socket.socket) -> None:
        """Fail THIS socket's in-flight requests and let the next call
        reconnect.  Waiters registered on a newer socket are left alone — a
        stale reader thread's teardown racing a reconnect must not wipe
        fresh requests (ADVICE r4)."""
        with self._lock:
            if self._sock is sock:
                self._sock = None
            stale = {
                rid: w for rid, w in self._pending.items()
                if w.get("sock") is sock
            }
            for rid in stale:
                del self._pending[rid]
        try:
            sock.close()
        except OSError:
            pass
        for waiter in stale.values():
            waiter["event"].set()  # body stays None -> ConnectionError

    def close(self) -> None:
        with self._lock:
            self._closed = True
        sock = self._sock
        if sock is not None:
            self._drop_socket(sock)


__all__ = [
    "VerifySidecarServer",
    "SidecarVerifierClient",
    "QueueStallTimeout",
    "SidecarQueueStall",
    "TenantAdmissionReject",
    "encode_request",
    "decode_request",
]
