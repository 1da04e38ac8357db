"""Shared hardened framing for every raw-TCP listener.

Four listener families speak length-prefixed frames over real sockets: the
consensus transport (net/transport.py), the sync catch-up listener
(sync/transport.py), the multi-tenant verify sidecar (net/sidecar.py), and
the deploy-rig control servers (deploy/control.py).  Before this module,
each carried its own copy of ``recv_exact`` — and the copies drifted: the
consensus transport checked the frame cap before reading, the sync/control
copies called ``conn.recv(n)`` with the ATTACKER'S claimed length, which
CPython turns into an n-byte buffer allocation before a single payload
byte arrives.  A peer that writes ``\\x80\\x00\\x00\\x00`` as a length
header could cost a replica 2 GiB of transient allocations for 4 sent
bytes.

This module is the single copy:

* :func:`recv_exact` — reads in bounded chunks into a growing buffer, so
  allocation is proportional to bytes actually RECEIVED, never to bytes
  claimed.  Optional per-chunk progress deadline (slow-loris defense):
  once a frame has started arriving, each successive chunk must land
  within ``progress_timeout`` or :class:`FrameStall` is raised —
  ``patient_first`` lets the FIRST byte wait indefinitely, which is what
  an honest-but-idle consensus connection between frames looks like.
* :class:`ListenerGuard` — per-listener abuse accounting shared by all
  four families: per-peer + global inbound connection quotas (checked at
  accept, before any read), a per-peer malformed-frame strike counter,
  and temporary bans.  Every defense event is triple-booked when the
  hooks are attached: a pinned metric (``net_malformed_total{kind}`` /
  ``net_handshake_timeout_total`` / ``net_peer_banned_total`` /
  ``net_conn_rejected_total``), a ``net.abuse`` trace instant, and an
  ``on_ban`` callback the deploy rig points at the flight recorder.

Censorship-safety (SAFETY.md §16): quotas bound CONCURRENCY, not
identity — an honest peer holds one connection per direction and never
approaches the per-peer cap.  Strikes only accrue on frames that are
*provably* malformed before any protocol state is touched (oversized
length claim, failed HELLO/HMAC proof, pre-HELLO traffic, a violated
sender pin, mid-frame stalls past the progress deadline) — events an
honest implementation of the wire format cannot produce, whatever the
network does to it, because TCP delivers its bytes intact and in order or
kills the connection.  Bans are temporary (``ban_seconds``) and the Comm
contract is unreliable fire-and-forget: frames lost to a ban window are
frames the protocol already tolerates losing, and the sender's bounded
reconnect/backoff path outlives any ban, so a mistakenly banned honest
peer regains service after expiry without operator action.

Real sockets mean real time: deadlines and ban expiries below are audited
``# wallclock-ok`` escapes, same as the rest of the deploy plane.

The PyTorch port's copy of ``consensus_tpu/net/framing.py``, its imports renamed.
"""

from __future__ import annotations

import logging
import select
import socket
import threading
import time
from typing import Callable, Dict, Optional

logger = logging.getLogger("consensus_tpu_torch.net")

#: recv() granularity: allocation per read is bounded by this, not by the
#: peer's claimed frame length.
RECV_CHUNK_BYTES = 64 * 1024

#: Strike kinds a listener may book (the ``kind`` label on
#: ``net_malformed_total``).  Pinned here so the four families cannot
#: invent divergent vocabularies.
MALFORMED_KINDS = (
    "oversized",    # claimed frame length beyond the listener's cap
    "bad_hello",    # HELLO/HMAC proof failed verification
    "pre_hello",    # payload traffic before the handshake completed
    "sender_pin",   # frame claimed a different sender than the pinned one
    "stall",        # mid-frame progress deadline exceeded (slow-loris)
    "garbage",      # frame payload failed structural validation
)


class FrameStall(OSError):
    """A peer stopped making progress mid-frame (slow-loris).

    ``received`` is how many bytes of the read had arrived when the
    deadline fired: 0 means the peer never started this frame (a listener
    in its handshake phase books that as a handshake timeout, not a
    strike), > 0 means a frame stalled mid-flight (provably malformed)."""

    def __init__(self, message: str, received: int = 0) -> None:
        super().__init__(message)
        self.received = received


def recv_exact(
    conn: socket.socket,
    n: int,
    *,
    progress_timeout: Optional[float] = None,
    patient_first: bool = False,
    preset: bool = False,
) -> Optional[bytes]:
    """Read exactly ``n`` bytes or fail cleanly.

    Cap-check-before-allocate: the buffer grows with bytes actually
    received (bounded :data:`RECV_CHUNK_BYTES` reads), never with the
    claimed length — callers validate ``n`` against their frame cap
    before calling, and even an unvalidated huge ``n`` costs memory only
    as the attacker actually sends it.

    Returns None on EOF / reset / (when no progress deadline is armed)
    timeout, exactly like the per-listener copies this replaces.  With
    ``progress_timeout`` set, every chunk must arrive within the deadline
    or :class:`FrameStall` is raised so the caller can book the stall;
    ``patient_first=True`` exempts the wait for the FIRST byte (an idle
    connection between frames is honest, a stalled frame is not).

    ``preset=True`` means the caller has put the socket in NON-BLOCKING
    mode for the connection's lifetime: ``recv`` is attempted first (one
    syscall when bytes are already waiting — the honest hot path), and
    the progress deadline is enforced with a ``select`` only when the
    read would actually block.  An armed socket timeout makes CPython
    poll readiness before EVERY recv, which the ``net_abuse`` bench
    family measures as a double-digit per-frame tax at honest line rate;
    try-first pays it only on the reads that actually wait.
    """
    buf = bytearray()
    first = True
    while len(buf) < n:
        if progress_timeout is not None and not preset:
            try:
                conn.settimeout(
                    None if (patient_first and first) else progress_timeout
                )
            except OSError:
                return None
        try:
            chunk = conn.recv(min(n - len(buf), RECV_CHUNK_BYTES))
        except BlockingIOError:
            # preset non-blocking lane: nothing waiting — block on
            # readiness, patiently for a frame's first byte, under the
            # progress deadline once one has started.
            wait = None if (patient_first and first) else progress_timeout
            try:
                ready = select.select([conn], [], [], wait)[0]
            except (OSError, ValueError):
                return None
            if not ready:
                raise FrameStall(
                    f"no progress for {progress_timeout:g}s mid-frame",
                    received=len(buf),
                )
            continue
        except socket.timeout as exc:
            if patient_first and first:
                return None
            if progress_timeout is not None:
                raise FrameStall(
                    f"no progress for {progress_timeout:g}s mid-frame",
                    received=len(buf),
                ) from exc
            return None
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
        first = False
    return bytes(buf)


class GuardStats:
    """Cumulative per-listener abuse counters — the health surface the obs
    sampler reads (``wire_abuse`` detector fires on per-sample deltas)."""

    __slots__ = ("malformed", "handshake_timeouts", "bans", "rejected")

    def __init__(self) -> None:
        self.malformed = 0
        self.handshake_timeouts = 0
        self.bans = 0
        self.rejected = 0

    def total(self) -> int:
        return (
            self.malformed + self.handshake_timeouts
            + self.bans + self.rejected
        )


class ListenerGuard:
    """Abuse accounting for one listener: quotas, strikes, temporary bans.

    Thread-safe: accept loops and per-connection receiver threads call in
    concurrently.  Booking hooks (``metrics``: a
    :class:`~consensus_tpu_torch.metrics.MetricsNetwork` bundle; ``tracer``: a
    decision tracer; ``on_ban(addr, kind)``) are all optional and invoked
    outside the lock.
    """

    def __init__(
        self,
        *,
        name: str = "net",
        max_conns_per_peer: int = 32,
        max_conns_total: int = 256,
        strike_limit: int = 3,
        ban_seconds: float = 2.0,
        handshake_timeout: float = 5.0,
        progress_timeout: float = 10.0,
        metrics=None,
        tracer=None,
        on_ban: Optional[Callable[[str, str], None]] = None,
        clock: Optional[Callable[[], float]] = None,
    ) -> None:
        if max_conns_per_peer < 1 or max_conns_total < 1:
            raise ValueError("connection quotas must be >= 1")
        if strike_limit < 1:
            raise ValueError("strike_limit must be >= 1")
        self.name = name
        self.max_conns_per_peer = max_conns_per_peer
        self.max_conns_total = max_conns_total
        self.strike_limit = strike_limit
        self.ban_seconds = ban_seconds
        #: Handshake deadline: a connection must complete HELLO/HMAC within
        #: this budget of being accepted or be dropped.
        self.handshake_timeout = handshake_timeout
        #: Mid-frame progress deadline handed to :func:`recv_exact`.
        self.progress_timeout = progress_timeout
        self.metrics = metrics
        self.tracer = tracer
        self.on_ban = on_ban
        self._clock = clock if clock is not None else time.monotonic  # wallclock-ok
        self._lock = threading.Lock()
        self._conns: Dict[str, int] = {}
        self._total = 0
        self._strikes: Dict[str, int] = {}
        self._bans: Dict[str, float] = {}  # addr -> expiry
        self.stats = GuardStats()

    # --- admission ---------------------------------------------------------

    def admit(self, addr: str) -> bool:
        """Accept-time gate: False (and one ``net_conn_rejected_total``
        booking) when ``addr`` is banned or a quota is full.  Callers MUST
        pair every True with exactly one :meth:`release`."""
        now = self._clock()
        reason = None
        with self._lock:
            expiry = self._bans.get(addr)
            if expiry is not None:
                if now < expiry:
                    reason = "banned"
                else:
                    # Ban expired: a fresh start, strikes forgiven.
                    del self._bans[addr]
                    self._strikes.pop(addr, None)
            if reason is None:
                if self._total >= self.max_conns_total:
                    reason = "global_quota"
                elif self._conns.get(addr, 0) >= self.max_conns_per_peer:
                    reason = "peer_quota"
            if reason is None:
                self._conns[addr] = self._conns.get(addr, 0) + 1
                self._total += 1
            else:
                self.stats.rejected += 1
        if reason is None:
            return True
        self._book_rejected(addr, reason)
        return False

    def release(self, addr: str) -> None:
        """Connection closed: return its quota slot."""
        with self._lock:
            left = self._conns.get(addr, 0) - 1
            if left > 0:
                self._conns[addr] = left
            else:
                self._conns.pop(addr, None)
            if self._total > 0:
                self._total -= 1

    # --- strikes and bans --------------------------------------------------

    def strike(self, addr: str, kind: str) -> bool:
        """Book one malformed frame from ``addr``; returns True when the
        strike crossed the limit and ``addr`` is now temporarily banned.
        ``kind`` must come from :data:`MALFORMED_KINDS`."""
        if kind not in MALFORMED_KINDS:
            raise ValueError(f"unknown malformed kind {kind!r}")
        now = self._clock()
        with self._lock:
            strikes = self._strikes.get(addr, 0) + 1
            self._strikes[addr] = strikes
            self.stats.malformed += 1
            banned = strikes >= self.strike_limit
            if banned:
                self._bans[addr] = now + self.ban_seconds
                self._strikes.pop(addr, None)
                self.stats.bans += 1
        self._book_malformed(addr, kind)
        if banned:
            self._book_ban(addr, kind)
        return banned

    def handshake_timed_out(self, addr: str) -> None:
        """A connection never completed HELLO/HMAC within the deadline."""
        with self._lock:
            self.stats.handshake_timeouts += 1
        metrics = self.metrics
        if metrics is not None:
            metrics.count_handshake_timeout.add(1)
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            tracer.instant(
                "net", "net.abuse", event="handshake_timeout", peer=addr,
            )
        logger.warning(
            "%s: connection from %s never completed handshake; dropped",
            self.name, addr,
        )

    def is_banned(self, addr: str) -> bool:
        now = self._clock()
        with self._lock:
            expiry = self._bans.get(addr)
            return expiry is not None and now < expiry

    # --- booking (outside the lock) ----------------------------------------

    def _book_rejected(self, addr: str, reason: str) -> None:
        metrics = self.metrics
        if metrics is not None:
            metrics.count_conn_rejected.add(1)
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            tracer.instant(
                "net", "net.abuse", event="conn_rejected", peer=addr,
                reason=reason,
            )
        logger.warning(
            "%s: rejected connection from %s (%s)", self.name, addr, reason
        )

    def _book_malformed(self, addr: str, kind: str) -> None:
        metrics = self.metrics
        if metrics is not None:
            metrics.count_malformed.with_labels(kind).add(1)
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            tracer.instant(
                "net", "net.abuse", event="malformed", peer=addr, kind=kind,
            )
        logger.warning(
            "%s: malformed frame (%s) from %s", self.name, kind, addr
        )

    def _book_ban(self, addr: str, kind: str) -> None:
        metrics = self.metrics
        if metrics is not None:
            metrics.count_peer_banned.add(1)
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            tracer.instant(
                "net", "net.abuse", event="peer_banned", peer=addr, kind=kind,
            )
        on_ban = self.on_ban
        if on_ban is not None:
            try:
                on_ban(addr, kind)
            except Exception:
                logger.exception("%s: on_ban hook failed", self.name)
        logger.warning(
            "%s: peer %s banned for %gs after %d strikes (last: %s)",
            self.name, addr, self.ban_seconds, self.strike_limit, kind,
        )


__all__ = [
    "FrameStall",
    "GuardStats",
    "ListenerGuard",
    "MALFORMED_KINDS",
    "RECV_CHUNK_BYTES",
    "recv_exact",
]
