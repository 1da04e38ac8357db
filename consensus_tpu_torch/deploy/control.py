"""Per-process control socket: the deploy rig's health/scrape/chaos channel.

Every child process (replica, sidecar) runs one :class:`ControlServer` on
its spec'd control port.  The protocol is deliberately tiny — one JSON
object per connection, one JSON reply — because three very different
callers share it:

* the :class:`~consensus_tpu_torch.deploy.supervisor.NodeSupervisor` health
  probe (``{"op": "ping"}``),
* the soak driver's obs scraper (``{"op": "prom"}`` returns the process's
  Prometheus text body, ``{"op": "health"}`` / ``{"op": "metrics"}`` the
  structured forms), and
* the chaos vocabulary's in-process arms (``net_pause`` / ``net_resume``
  for listener-port drop, ``storage_fault`` for the storage-fault injector).

This channel is the deploy-rig equivalent of the in-process
``controller.health()`` read the obs sampler does: handlers must be plain
reads (or explicit chaos arms) so probing cannot perturb the protocol.

This module is inherently real-time (sockets, I/O deadlines); the audited
``# wallclock-ok`` escapes below are the deploy-plane exception the
no-wallclock lint pins.

The PyTorch port's copy of ``consensus_tpu/deploy/control.py``, its imports renamed.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import time
from typing import Callable, Mapping, Optional, Tuple

from consensus_tpu_torch.net.framing import ListenerGuard

logger = logging.getLogger("consensus_tpu_torch.deploy")

_MAX_LINE = 16 * 1024 * 1024


class ControlServer:
    """One-request-one-reply JSON control endpoint on a daemon thread.

    ``handlers`` maps op name -> ``fn(request_dict) -> reply_dict``.  A
    handler exception answers ``{"error": ...}`` and keeps serving; an
    unknown op answers ``{"error": "unknown op ..."}`` — the control plane
    must never die under a confused or version-skewed prober.

    Hardened DEFAULT-ON via a :class:`~consensus_tpu_torch.net.framing
    .ListenerGuard`: connections are admitted against quotas before a byte
    is read and served on their own daemon threads (one stalled prober no
    longer blocks the supervisor's health probe behind it); a request that
    never starts within the handshake deadline, stalls mid-line, overruns
    ``max_line`` without a newline, or fails to parse as JSON (the error
    is still answered) books strikes toward a temporary ban.  Pass a
    configured guard to tune, or ``guard=False`` for the pre-hardening
    serial behavior."""

    def __init__(
        self,
        handlers: Mapping[str, Callable[[dict], dict]],
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        guard=None,
        max_line: int = _MAX_LINE,
    ) -> None:
        self._handlers = dict(handlers)
        if guard is None:
            guard = ListenerGuard(name="control")
        self.guard = guard or None
        self._max_line = max_line
        self._sock = socket.create_server((host, port))
        self._sock.settimeout(0.2)
        self.address: Tuple[str, int] = self._sock.getsockname()[:2]
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._accept_loop,
            name=f"deploy-control-{self.address[1]}",
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
                name=f"deploy-control-serve-{self.address[1]}", daemon=True,
            ).start()

    def _serve_conn(self, conn: socket.socket, addr: str) -> None:
        guard = self.guard
        try:
            with conn:
                line = self._read_request(conn, addr)
                if line is None:
                    return
                try:
                    json.loads(line)
                except ValueError:
                    # Strike the garbage but STILL answer the structured
                    # error — the control plane never goes silent on a
                    # merely confused prober.
                    if guard is not None:
                        guard.strike(addr, "garbage")
                reply = self._handle(line)
                conn.settimeout(5.0)
                conn.sendall(reply + b"\n")
        except OSError:
            pass  # dead prober; keep serving
        finally:
            if guard is not None:
                guard.release(addr)

    def _read_request(self, conn: socket.socket, addr: str) -> Optional[bytes]:
        """One newline-terminated request with guard deadlines: the first
        byte must arrive within the handshake deadline, later chunks within
        the progress deadline, and the line must fit ``max_line``."""
        guard = self.guard
        first_deadline = (
            guard.handshake_timeout if guard is not None else 5.0
        )
        progress = guard.progress_timeout if guard is not None else 5.0
        buf = b""
        while len(buf) < self._max_line:
            try:
                conn.settimeout(progress if buf else first_deadline)
                part = conn.recv(65536)
            except socket.timeout:
                if guard is not None:
                    if buf:
                        guard.strike(addr, "stall")
                    else:
                        guard.handshake_timed_out(addr)
                return None
            except OSError:
                return None
            if not part:
                return None
            buf += part
            if b"\n" in buf:
                return buf.split(b"\n", 1)[0]
        if guard is not None:
            guard.strike(addr, "oversized")
        return None

    def _handle(self, line: bytes) -> bytes:
        try:
            request = json.loads(line)
            op = request.get("op")
            handler = self._handlers.get(op)
            if handler is None:
                reply = {"error": f"unknown op {op!r}"}
            else:
                reply = handler(request)
        except Exception as exc:  # control plane never dies on a handler
            logger.exception("control handler failed")
            reply = {"error": f"{type(exc).__name__}: {exc}"}
        return json.dumps(reply, sort_keys=True).encode()

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)


def _read_line(conn: socket.socket) -> Optional[bytes]:
    """One newline-terminated request, or None on EOF/timeout/overrun —
    mirroring the sync listener's fail-clean contract for partial frames."""
    buf = b""
    while len(buf) < _MAX_LINE:
        try:
            part = conn.recv(65536)
        except OSError:
            return None
        if not part:
            return None
        buf += part
        if b"\n" in buf:
            return buf.split(b"\n", 1)[0]
    return None


class ControlClient:
    """Blocking caller side: one connection per call, bounded by
    ``timeout`` — a frozen (SIGSTOP) or dead process yields None from
    :meth:`try_call`, never a hang."""

    def __init__(self, address: Tuple[str, int], *, timeout: float = 5.0) -> None:
        self.address = tuple(address)
        self.timeout = timeout

    def call(self, op: str, **kw) -> dict:
        request = dict(kw)
        request["op"] = op
        payload = json.dumps(request, sort_keys=True).encode() + b"\n"
        with socket.create_connection(self.address, timeout=self.timeout) as conn:
            conn.sendall(payload)
            line = _read_line(conn)
        if line is None:
            raise OSError(f"no control reply from {self.address}")
        return json.loads(line)

    def try_call(self, op: str, **kw) -> Optional[dict]:
        try:
            return self.call(op, **kw)
        except (OSError, ValueError):
            return None

    def wait_ready(self, timeout: float) -> bool:
        """Poll ``ping`` until the process answers or ``timeout`` elapses."""
        deadline = time.monotonic() + timeout  # wallclock-ok
        while time.monotonic() < deadline:  # wallclock-ok
            reply = self.try_call("ping")
            if reply is not None and "error" not in reply:
                return True
            time.sleep(0.05)
        return False


__all__ = ["ControlServer", "ControlClient"]
