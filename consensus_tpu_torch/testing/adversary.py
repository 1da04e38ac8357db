"""AdversarialPeer: a byzantine wire driver for the hardened listeners.

Speaks RAW TCP — the frame layouts below are written out from the wire
specs, never imported from the server modules, so a server refactor that
accidentally changes bytes on the wire breaks these batteries instead of
silently tracking it.  One driver covers all four listener families:

========  =====================================================section
style     wire format
========  =====================================================
comm      ``u32 len | u64 sender | u8 kind`` (kind 2 = HELLO); the
          acceptor sends a 16-byte challenge nonce first and the HELLO
          answers ``HMAC-SHA256(secret, context | nonce | sender)``
sync      ``u32 len | payload`` (one codec-framed request per connection)
control   one JSON object per line (newline-terminated)
sidecar   ``u32 len | u64 req_id`` frames behind a mutual nonce
          handshake (server nonce -> client nonce + proof -> server
          proof)
========  =====================================================

Each battery method provokes ONE family of listener-guard defense events
and returns ``{event_kind: provoked_count}`` so a test can assert the
guard booked each defense EXACTLY once per provoked event:

* ``never_hello``     — connect and go silent: ``handshake_timeout``
* ``connect_flood``   — hold many simultaneous connections:
  ``conn_rejected`` for every one past the quota (the count is measured,
  not assumed: a refused connection is observable as an immediate close
  before the server speaks)
* ``midframe_stall``  — start a frame, never finish it: ``stall`` strike
* ``oversized_length``— claim a 2 GiB frame in the length header:
  ``oversized`` strike (the hardened reader allocates NOTHING for it)
* ``wrong_hmac_flood``— comm/sidecar: flood failing auth proofs
  (``bad_hello``); sync/control have no handshake, so the nearest
  equivalent is structurally-invalid payloads (``garbage``)
* ``handshake_replay``— complete one real handshake, then replay its
  captured proof against a FRESH nonce: ``bad_hello`` (requires the
  secret — this is the insider-byzantine case)

:data:`STYLE_BATTERIES` maps each style to the batteries that apply to
it; :meth:`AdversarialPeer.run_battery` runs them all and merges the
counts.  Batteries are synchronous with the defense they provoke: each
poisoned connection is held until the server closes it, which happens
strictly AFTER the strike/timeout is booked — so when a battery returns,
the guard's counters are settled (no sleeps, no polling).

Real sockets mean real deadlines, but everything here blocks on socket
timeouts — no wallclock reads, so the no-wallclock lint pins this file
with zero escapes.

The PyTorch port's copy of ``consensus_tpu/testing/adversary.py``, its imports renamed.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import select
import socket
import struct
from typing import Dict, Iterable, Optional, Tuple

# Wire constants (mirrors of the servers' specs — see module docstring).
_COMM_HEADER = struct.Struct(">IQB")
_COMM_KIND_CONSENSUS = 0
_COMM_KIND_HELLO = 2
_COMM_HELLO_CONTEXT = b"consensus-tpu/hello/v1"
_SYNC_FRAME = struct.Struct(">I")
_SIDECAR_FRAME = struct.Struct(">IQ")
_SIDECAR_NONCE_LEN = 32
_SIDECAR_CLIENT_PROOF = b"ctpu-sidecar-client-v1"
_SIDECAR_TENANT_PROOF = b"ctpu-sidecar-tenant-v1"

#: A length claim far beyond every listener's 64 MiB cap.
HUGE_LENGTH = 2**31

STYLES = ("comm", "sync", "control", "sidecar")

#: Batteries that apply per listener style (``run_battery`` default set).
STYLE_BATTERIES = {
    "comm": (
        "never_hello", "connect_flood", "midframe_stall",
        "oversized_length", "wrong_hmac_flood",
    ),
    "sync": (
        "never_hello", "connect_flood", "midframe_stall",
        "oversized_length", "wrong_hmac_flood",
    ),
    "control": (
        "never_hello", "connect_flood", "midframe_stall",
        "oversized_length", "wrong_hmac_flood",
    ),
    "sidecar": (
        "never_hello", "connect_flood", "wrong_hmac_flood",
        "handshake_replay",
    ),
}


def _merge(into: Dict[str, int], more: Dict[str, int]) -> Dict[str, int]:
    for k, v in more.items():
        into[k] = into.get(k, 0) + v
    return into


class AdversarialPeer:
    """Drives one abuse vocabulary against one listener address.

    ``secret`` arms the insider batteries (``handshake_replay``, and
    ``oversized_length`` against a sidecar) — a byzantine peer that HOLDS
    the cluster secret must still be bounded by the guard.  ``claim_id``
    is the replica id forged into comm frames.

    ``close_wait`` bounds how long a battery waits for the server to
    close a poisoned connection; it must exceed the guard's
    handshake/progress deadlines (tests shorten those, not this).
    """

    def __init__(
        self,
        address: Tuple[str, int],
        style: str = "comm",
        *,
        secret: Optional[bytes] = None,
        tenant: Optional[str] = None,
        claim_id: int = 999,
        connect_timeout: float = 5.0,
        close_wait: float = 30.0,
    ) -> None:
        if style not in STYLES:
            raise ValueError(f"unknown listener style {style!r}")
        self.address = tuple(address)
        self.style = style
        self.secret = secret
        self.tenant = tenant
        self.claim_id = claim_id
        self.connect_timeout = connect_timeout
        self.close_wait = close_wait

    # --- plumbing -----------------------------------------------------------

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(
            self.address, timeout=self.connect_timeout
        )
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _await_close(self, sock: socket.socket) -> None:
        """Drain until the server closes — i.e. until the defense we just
        provoked has been booked (servers strike, THEN close)."""
        sock.settimeout(self.close_wait)
        try:
            while sock.recv(4096):
                pass
        except OSError:
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _recv_n(self, sock: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed during read")
            buf += chunk
        return buf

    def _read_comm_challenge(self, sock: socket.socket) -> bytes:
        """The comm acceptor speaks first: header + 16-byte nonce."""
        sock.settimeout(self.connect_timeout)
        header = self._recv_n(sock, _COMM_HEADER.size)
        length, _, kind = _COMM_HEADER.unpack(header)
        if kind != _COMM_KIND_HELLO or length > 64:
            raise ConnectionError("unexpected comm challenge")
        return self._recv_n(sock, length)

    def _comm_hello_proof(self, nonce: bytes, sender: int) -> bytes:
        if not self.secret:
            return b""
        return hmac.new(
            self.secret,
            _COMM_HELLO_CONTEXT + nonce + struct.pack(">Q", sender),
            hashlib.sha256,
        ).digest()

    # --- batteries ----------------------------------------------------------

    def never_hello(self, events: int = 1) -> Dict[str, int]:
        """Connect and go silent; the listener must drop us at its
        handshake deadline and book exactly one ``handshake_timeout``."""
        for _ in range(events):
            sock = self._connect()
            try:
                if self.style == "comm":
                    self._read_comm_challenge(sock)
                elif self.style == "sidecar":
                    self._recv_n(sock, _SIDECAR_NONCE_LEN)
            except OSError:
                pass
            self._await_close(sock)
        return {"handshake_timeout": events}

    def connect_flood(
        self, count: int = 8, probe_timeout: float = 0.5
    ) -> Dict[str, int]:
        """Open ``count`` simultaneous connections and measure how many
        the listener refuses.  A refusal is an immediate close before the
        server speaks; an admitted comm/sidecar connection receives the
        challenge, an admitted sync/control connection just stays open
        (``probe_timeout`` must be well under the guard's handshake
        deadline so silence is unambiguous).  Admitted connections are
        closed BEFORE the handshake deadline, so the flood itself books
        nothing but ``conn_rejected``."""
        socks = []
        for _ in range(count):
            try:
                socks.append(self._connect())
            except OSError:
                # Kernel-level refusal (backlog overflow) counts too.
                socks.append(None)
        admitted = 0
        rejected = sum(1 for s in socks if s is None)
        pending = {s for s in socks if s is not None}
        while pending:
            readable, _, _ = select.select(list(pending), [], [], probe_timeout)
            if not readable:
                admitted += len(pending)  # silent and open = admitted
                break
            for sock in readable:
                try:
                    data = sock.recv(64)
                except OSError:
                    data = b""
                if data:
                    admitted += 1
                else:
                    rejected += 1
                pending.discard(sock)
        for sock in socks:
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        return {"conn_rejected": rejected, "admitted": admitted}

    def midframe_stall(self, events: int = 1) -> Dict[str, int]:
        """Start a frame, never finish it: a ``stall`` strike per event
        (this is the slow-loris the progress deadline exists for)."""
        if self.style == "sidecar":
            raise ValueError("midframe_stall battery does not apply to sidecar")
        for _ in range(events):
            sock = self._connect()
            try:
                if self.style == "comm":
                    self._read_comm_challenge(sock)
                    sock.sendall(b"\x00\x00\x00\x10\x00")  # 5 of 13 header bytes
                elif self.style == "sync":
                    sock.sendall(b"\x00\x00")  # 2 of 4 header bytes
                else:  # control: an unterminated JSON prefix
                    sock.sendall(b'{"op": "pi')
            except OSError:
                pass
            self._await_close(sock)
        return {"stall": events}

    def oversized_length(self, events: int = 1) -> Dict[str, int]:
        """Claim a :data:`HUGE_LENGTH` frame: an ``oversized`` strike per
        event, with no allocation on the server (cap-check-before-
        allocate).  For control (no length header) this is a line that
        overruns the server's ``max_line`` without a newline — pass the
        server's cap + 1 as ``payload_bytes`` via a configured test
        server; the default floods 256 KiB chunks until struck."""
        for _ in range(events):
            sock = self._connect()
            try:
                if self.style == "comm":
                    self._read_comm_challenge(sock)
                    sock.sendall(
                        _COMM_HEADER.pack(
                            HUGE_LENGTH, self.claim_id, _COMM_KIND_CONSENSUS
                        )
                    )
                elif self.style == "sync":
                    sock.sendall(_SYNC_FRAME.pack(HUGE_LENGTH))
                elif self.style == "sidecar":
                    self._sidecar_handshake(sock)  # insider: needs the secret
                    sock.sendall(_SIDECAR_FRAME.pack(HUGE_LENGTH, 0))
                else:  # control
                    chunk = b"x" * 65536
                    try:
                        while True:
                            sock.sendall(chunk)
                    except OSError:
                        pass  # server struck and closed mid-flood
            except OSError:
                pass
            self._await_close(sock)
        return {"oversized": events}

    def wrong_hmac_flood(self, events: int = 1) -> Dict[str, int]:
        """Flood failing proofs.  comm/sidecar: a HELLO/handshake answer
        that cannot verify (``bad_hello``).  sync/control have no
        handshake; the nearest equivalent is a structurally-invalid
        payload (``garbage`` — and control still answers its structured
        error, which this battery verifies by reading the reply)."""
        kind = "bad_hello" if self.style in ("comm", "sidecar") else "garbage"
        for _ in range(events):
            sock = self._connect()
            try:
                if self.style == "comm":
                    self._read_comm_challenge(sock)
                    proof = b"\x00" * 32  # cannot be a valid HMAC answer
                    sock.sendall(
                        _COMM_HEADER.pack(
                            len(proof), self.claim_id, _COMM_KIND_HELLO
                        ) + proof
                    )
                elif self.style == "sidecar":
                    self._recv_n(sock, _SIDECAR_NONCE_LEN)
                    sock.settimeout(self.connect_timeout)
                    sock.sendall(b"\x00" * (_SIDECAR_NONCE_LEN + 32))
                elif self.style == "sync":
                    payload = b"\xff" * 8  # no codec tag starts with 0xff
                    sock.sendall(_SYNC_FRAME.pack(len(payload)) + payload)
                else:  # control
                    sock.sendall(b"this is not json\n")
                    sock.settimeout(self.connect_timeout)
                    try:
                        reply = sock.recv(4096)
                        if reply and b"error" not in reply:
                            raise AssertionError(
                                "control server lost its error contract "
                                f"under garbage: {reply!r}"
                            )
                    except OSError:
                        pass
            except OSError:
                pass
            self._await_close(sock)
        return {kind: events}

    def handshake_replay(self, events: int = 1) -> Dict[str, int]:
        """Complete ONE honest handshake, then replay its captured proof
        against fresh nonces: each replay must fail verification
        (``bad_hello``) — proofs are bound to the acceptor's nonce."""
        if not self.secret:
            raise ValueError(
                "handshake_replay needs the secret (insider-byzantine case)"
            )
        if self.style == "comm":
            sock = self._connect()
            nonce = self._read_comm_challenge(sock)
            proof = self._comm_hello_proof(nonce, self.claim_id)
            sock.sendall(
                _COMM_HEADER.pack(len(proof), self.claim_id, _COMM_KIND_HELLO)
                + proof
            )
            sock.close()  # honest handshake done; now replay its proof
            for _ in range(events):
                replay = self._connect()
                try:
                    self._read_comm_challenge(replay)  # FRESH nonce, ignored
                    replay.sendall(
                        _COMM_HEADER.pack(
                            len(proof), self.claim_id, _COMM_KIND_HELLO
                        ) + proof
                    )
                except OSError:
                    pass
                self._await_close(replay)
        elif self.style == "sidecar":
            sock = self._connect()
            transcript = self._sidecar_handshake(sock)
            sock.close()
            for _ in range(events):
                replay = self._connect()
                try:
                    self._recv_n(replay, _SIDECAR_NONCE_LEN)  # fresh nonce
                    replay.sendall(transcript)  # stale client_nonce + answer
                except OSError:
                    pass
                self._await_close(replay)
        else:
            raise ValueError(
                f"handshake_replay battery does not apply to {self.style!r}"
            )
        return {"bad_hello": events}

    def _sidecar_handshake(self, sock: socket.socket) -> bytes:
        """Complete the sidecar's mutual handshake (requires the secret);
        returns the ``client_nonce + answer`` transcript for replays."""
        if not self.secret:
            raise ValueError("sidecar insider batteries need the secret")
        server_nonce = self._recv_n(sock, _SIDECAR_NONCE_LEN)
        client_nonce = b"\x5a" * _SIDECAR_NONCE_LEN
        mac = hmac.new(self.secret, digestmod=hashlib.sha256)
        if self.tenant is None:
            for part in (_SIDECAR_CLIENT_PROOF, server_nonce, client_nonce):
                mac.update(part)
        else:
            for part in (
                _SIDECAR_TENANT_PROOF, self.tenant.encode(),
                server_nonce, client_nonce,
            ):
                mac.update(part)
        transcript = client_nonce + mac.digest()
        sock.settimeout(self.connect_timeout)
        sock.sendall(transcript)
        self._recv_n(sock, 32)  # server proof (unchecked: we're the liar here)
        return transcript

    # --- the full vocabulary ------------------------------------------------

    def run_battery(
        self, names: Optional[Iterable[str]] = None, *, events: int = 1
    ) -> Dict[str, int]:
        """Run ``names`` (default: every battery that applies to this
        style) and merge the provoked-event counts."""
        provoked: Dict[str, int] = {}
        for name in names if names is not None else STYLE_BATTERIES[self.style]:
            battery = getattr(self, name)
            if name == "connect_flood":
                _merge(provoked, battery())
            else:
                _merge(provoked, battery(events))
        return provoked


def control_probe_reply(address: Tuple[str, int], op: str = "ping") -> dict:
    """A minimal HONEST control request (used by tests to show the plane
    still answers while a battery runs)."""
    with socket.create_connection(address, timeout=5.0) as sock:
        sock.sendall(json.dumps({"op": op}).encode() + b"\n")
        sock.settimeout(5.0)
        buf = b""
        while b"\n" not in buf:
            chunk = sock.recv(4096)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.split(b"\n", 1)[0] or b"{}")


__all__ = [
    "AdversarialPeer",
    "HUGE_LENGTH",
    "STYLES",
    "STYLE_BATTERIES",
    "control_probe_reply",
]
