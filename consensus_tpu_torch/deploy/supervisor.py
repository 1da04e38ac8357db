"""Node supervisor: one OS process under spawn/probe/restart management.

The reference system earns its fault-tolerance story as separate OS
processes under an init-style supervisor (the Fabric orderer restarts and
replays its WAL); this is that layer for the rig.  One
:class:`NodeSupervisor` owns one child process:

* **spawn** — ``Popen`` with stderr teed into a bounded ring buffer (the
  last lines of a dying replica are the single most valuable artifact of
  a chaos run),
* **health-probe** over the child's control socket
  (:class:`~consensus_tpu_torch.deploy.control.ControlClient`),
* **restart** with capped exponential backoff + jitter when the child
  dies and restart is enabled — a ``kill -9`` leader comes back as the
  same node id with the same config file and its intact WAL directory.
  ``max_restarts`` caps CONSECUTIVE failures, not lifetime restarts: a
  child that survives past ``healthy_uptime`` resets the failure count
  (and the backoff exponent), so a multi-hour soak can kill the same
  replica hundreds of times while a genuine crash loop (config error,
  port conflict — every incarnation dying within seconds) still gives
  up after ``max_restarts`` attempts,
* **flight-record capture on death**: every exit writes a JSON record
  (exit code / signal, uptime, restart count, stderr tail) under
  ``flight/`` so a multi-hour soak leaves a forensically useful trail
  even for deaths nobody was watching.

SIGSTOP freezes are NOT deaths: :meth:`suspend`/:meth:`resume` park the
child without triggering the restart path (the probe failing while frozen
is the observable symptom chaos wants).

Supervision is inherently real-time — backoff sleeps, uptime stamps, probe
deadlines — hence the audited ``# wallclock-ok`` escapes.

The PyTorch port's copy of ``consensus_tpu/deploy/supervisor.py``, its imports renamed.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import random
import signal
import subprocess
import threading
import time
from typing import Optional, Sequence, Tuple

from consensus_tpu_torch.deploy.control import ControlClient

logger = logging.getLogger("consensus_tpu_torch.deploy")


class NodeSupervisor:
    def __init__(
        self,
        name: str,
        argv: Sequence[str],
        control_address: Tuple[str, int],
        *,
        flight_dir: str,
        restart: bool = True,
        backoff_initial: float = 0.25,
        backoff_max: float = 5.0,
        max_restarts: int = 8,
        healthy_uptime: Optional[float] = None,
        stderr_tail_lines: int = 60,
        env: Optional[dict] = None,
        probe_timeout: float = 2.0,
    ) -> None:
        self.name = name
        self.argv = list(argv)
        self.control = ControlClient(control_address, timeout=probe_timeout)
        self.flight_dir = flight_dir
        self.restart_enabled = restart
        self._backoff_initial = backoff_initial
        self._backoff_max = backoff_max
        self._max_restarts = max_restarts
        #: Uptime past which an incarnation counts as healthy and resets
        #: the consecutive-failure budget.  Must sit well above interpreter
        #: boot (so an instant crash loop never resets) and well below the
        #: cadence of legitimate external kills (chaos, deploys).
        self._healthy_uptime = (
            healthy_uptime if healthy_uptime is not None
            else max(2.0 * backoff_max, 5.0)
        )
        self._tail_lines = stderr_tail_lines
        self._env = dict(env) if env is not None else None
        #: Lifetime restart count (reporting/flight records).
        self.restarts = 0
        #: Deaths since the last healthy incarnation — drives the cap and
        #: the backoff exponent.
        self.consecutive_failures = 0
        #: Every Popen this supervisor ever spawned, in spawn order.  The
        #: launcher's teardown orphan audit polls these handles instead of
        #: raw pids (a reaped pid can be recycled by an unrelated process).
        self.spawned: list = []
        self.flight_records: list = []
        self._proc: Optional[subprocess.Popen] = None
        self._tail: "collections.deque[str]" = collections.deque(
            maxlen=stderr_tail_lines
        )
        self._stopping = threading.Event()
        self._frozen = False
        self._lock = threading.Lock()
        self._waiter: Optional[threading.Thread] = None
        self._spawned_at = 0.0
        os.makedirs(flight_dir, exist_ok=True)

    # ------------------------------------------------------------- spawn

    def start(self) -> None:
        with self._lock:
            self._spawn_locked()

    def _spawn_locked(self) -> None:
        self._tail = collections.deque(maxlen=self._tail_lines)
        env = self._env if self._env is not None else os.environ.copy()
        proc = subprocess.Popen(
            self.argv,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE,
            env=env,
            text=True,
        )
        self._proc = proc
        self.spawned.append(proc)
        self._spawned_at = time.monotonic()  # wallclock-ok
        threading.Thread(
            target=self._stderr_pump, args=(proc,),
            name=f"sup-{self.name}-stderr", daemon=True,
        ).start()
        waiter = threading.Thread(
            target=self._wait_loop, args=(proc,),
            name=f"sup-{self.name}-wait", daemon=True,
        )
        self._waiter = waiter
        waiter.start()
        logger.info("%s: spawned pid %d", self.name, proc.pid)

    def _stderr_pump(self, proc: subprocess.Popen) -> None:
        try:
            for line in proc.stderr:
                self._tail.append(line.rstrip("\n"))
        except (OSError, ValueError):
            pass

    # ----------------------------------------------------------- restart

    def _wait_loop(self, proc: subprocess.Popen) -> None:
        rc = proc.wait()
        uptime = time.monotonic() - self._spawned_at  # wallclock-ok
        if uptime >= self._healthy_uptime:
            # This incarnation ran long enough to count as healthy: an
            # external kill (chaos, operator), not a crash loop.  Reset
            # the consecutive-failure budget and the backoff exponent so
            # a multi-hour soak never exhausts a lifetime cap.
            self.consecutive_failures = 0
        record = self._flight_record(rc, uptime)
        if self._stopping.is_set():
            return
        logger.warning(
            "%s: pid %d died (%s) after %.1fs", self.name, proc.pid,
            record["cause"], uptime,
        )
        if (
            not self.restart_enabled
            or self.consecutive_failures >= self._max_restarts
        ):
            return
        delay = min(
            self._backoff_initial * (2.0 ** self.consecutive_failures),
            self._backoff_max,
        )
        delay *= 0.5 + random.random() / 2.0  # jitter: fleet desync
        if self._stopping.wait(delay):
            return
        with self._lock:
            if self._stopping.is_set() or self._proc is not proc:
                return
            self.restarts += 1
            self.consecutive_failures += 1
            self._spawn_locked()

    def _flight_record(self, rc: int, uptime: float) -> dict:
        if rc >= 0:
            sig_name = None
            cause = f"exit {rc}"
        else:
            try:
                sig_name = signal.Signals(-rc).name
            except ValueError:  # platform-specific / real-time signal
                sig_name = f"signal {-rc}"
            cause = (
                f"signal {sig_name}" if not sig_name.startswith("signal ")
                else sig_name
            )
        record = {
            "name": self.name,
            "pid": self._proc.pid if self._proc else None,
            "exit_code": rc if rc >= 0 else None,
            "signal": sig_name,
            "cause": cause,
            "uptime_secs": round(uptime, 3),
            "restarts": self.restarts,
            "t": time.time(),  # wallclock-ok
            "stderr_tail": list(self._tail),
        }
        self.flight_records.append(record)
        path = os.path.join(
            self.flight_dir, f"{self.name}-{len(self.flight_records)}.json"
        )
        try:
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(record, fh, indent=2)
        except OSError:
            logger.exception("%s: failed writing flight record", self.name)
        return record

    # ------------------------------------------------------------- probes

    @property
    def pid(self) -> Optional[int]:
        proc = self._proc
        return proc.pid if proc is not None else None

    @property
    def alive(self) -> bool:
        proc = self._proc
        return proc is not None and proc.poll() is None

    def probe(self) -> Optional[dict]:
        """The child's ``health`` answer, or None when unreachable."""
        return self.control.try_call("health")

    def wait_healthy(self, timeout: float) -> bool:
        return self.control.wait_ready(timeout)

    # -------------------------------------------------------------- chaos

    def kill(self, sig: int = signal.SIGKILL) -> None:
        """Deliver ``sig`` to the child (kill -9 chaos rides through here).
        Death is observed by the waiter thread, which restarts per policy."""
        proc = self._proc
        if proc is not None and proc.poll() is None:
            os.kill(proc.pid, sig)

    def suspend(self) -> None:
        """SIGSTOP freeze — not a death; no restart fires."""
        proc = self._proc
        if proc is not None and proc.poll() is None:
            self._frozen = True
            os.kill(proc.pid, signal.SIGSTOP)

    def resume(self) -> None:
        proc = self._proc
        if proc is not None and proc.poll() is None and self._frozen:
            self._frozen = False
            os.kill(proc.pid, signal.SIGCONT)

    # ----------------------------------------------------------- shutdown

    def stop(self, timeout: float = 10.0) -> None:
        """Graceful-then-forceful: control ``exit``, SIGTERM, SIGKILL.
        Guarantees the child is reaped (no orphan survives a teardown)."""
        self._stopping.set()
        while True:
            proc = self._proc
            if proc is None:
                return
            if self._frozen:
                try:
                    os.kill(proc.pid, signal.SIGCONT)
                except OSError:
                    pass
                self._frozen = False
            if proc.poll() is None:
                self.control.try_call("exit")
                try:
                    proc.wait(timeout=timeout / 2)
                except subprocess.TimeoutExpired:
                    proc.terminate()
                    try:
                        proc.wait(timeout=timeout / 2)
                    except subprocess.TimeoutExpired:
                        proc.kill()
                        proc.wait(timeout=5.0)
            else:
                proc.wait()
            # A restart racing this stop may have swapped in a fresh child
            # between the event set and the lock: stop that one too.
            if self._proc is proc:
                break
        waiter = self._waiter
        if waiter is not None:
            waiter.join(timeout=2.0)

    def assert_reaped(self) -> None:
        proc = self._proc
        if proc is None:
            return
        if proc.poll() is None:
            raise AssertionError(f"{self.name}: pid {proc.pid} still running")


__all__ = ["NodeSupervisor"]
