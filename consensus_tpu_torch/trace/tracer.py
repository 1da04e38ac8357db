"""Span tracer over a fixed-capacity ring buffer, clocked externally.

The tracer never reads wall clock: its timestamps come from the injected
``clock`` callable (``scheduler.now``), so a trace recorded under
``SimScheduler`` is bit-identical across replays of the same seed — crash
schedules from fault plans included.

Hot-path contract: instrumented components hold a tracer that is either a
real ``Tracer`` or the module-level ``NOOP_TRACER`` and guard every emit
site with ``if tracer.enabled:``.  With tracing off the guard is a single
attribute load and branch — no kwargs dict, no tuple, no ring append.
``Tracer.total_appends`` (class-level) counts ring appends across all live
tracers, which is what the overhead regression guard asserts stays flat.

Events are tuples ``(ph, track, name, ts, seq, view, args)``:

- ``ph``: ``"B"``/``"E"`` span begin/end, ``"i"`` instant.
- ``track``: coarse source category (``"view"``, ``"wal"``, ``"pool"``,
  ``"sync"``, ``"net"``, ``"fault"``, ...) — becomes the Chrome tid.
- ``ts``: scheduler-clock seconds (float).
- ``seq``/``view``: decision key for per-decision spans, else ``None``.
- ``args``: extra payload dict or ``None``.

Appends take a single lock, so threads outside the consensus loop (sidecar
probe/verify threads, WAL waiters) may post events safely.

The PyTorch port's copy of ``consensus_tpu/trace/tracer.py``, its imports renamed.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional


class Tracer:
    """Fixed-capacity ring of trace events; oldest events are overwritten."""

    #: Class-level count of ring appends across every Tracer instance.
    #: The disabled-overhead guard snapshots this around a run.
    total_appends = 0

    def __init__(
        self,
        clock: Callable[[], float],
        *,
        capacity: int = 65536,
        pid: int = 0,
    ):
        if capacity < 1:
            raise ValueError(f"tracer capacity must be >= 1, got {capacity}")
        self._clock = clock
        self._capacity = capacity
        self._ring: list = [None] * capacity
        self._count = 0  # total events ever appended
        self._lock = threading.Lock()
        self.enabled = True
        self.pid = pid  # exported Chrome pid; conventionally the node id

    # -- emit ----------------------------------------------------------

    def begin(self, track, name, *, seq=None, view=None, **args) -> None:
        self._append("B", track, name, seq, view, args or None)

    def end(self, track, name, *, seq=None, view=None, **args) -> None:
        self._append("E", track, name, seq, view, args or None)

    def instant(self, track, name, *, seq=None, view=None, **args) -> None:
        self._append("i", track, name, seq, view, args or None)

    def _append(self, ph, track, name, seq, view, args) -> None:
        ev = (ph, track, name, self._clock(), seq, view, args)
        with self._lock:
            self._ring[self._count % self._capacity] = ev
            self._count += 1
            Tracer.total_appends += 1

    # -- read ----------------------------------------------------------

    def events(self) -> list:
        """Surviving events, oldest first (at most ``capacity``)."""
        with self._lock:
            n, cap = self._count, self._capacity
            if n <= cap:
                return [e for e in self._ring[:n]]
            cut = n % cap
            return self._ring[cut:] + self._ring[:cut]

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wrap-around."""
        with self._lock:
            return max(0, self._count - self._capacity)

    @property
    def appended(self) -> int:
        """Total events ever appended to this tracer."""
        with self._lock:
            return self._count


class NoopTracer:
    """Disabled tracer: same surface as ``Tracer``, does nothing.

    Deliberately *not* a ``Tracer`` subclass — it owns no ring and can
    never bump ``Tracer.total_appends``, which is what makes the
    zero-append overhead guard airtight.
    """

    enabled = False
    pid = 0

    def begin(self, track, name, *, seq=None, view=None, **args) -> None:
        pass

    def end(self, track, name, *, seq=None, view=None, **args) -> None:
        pass

    def instant(self, track, name, *, seq=None, view=None, **args) -> None:
        pass

    def events(self) -> list:
        return []

    @property
    def dropped(self) -> int:
        return 0

    @property
    def appended(self) -> int:
        return 0


#: Shared default for every instrumented component.  ``enabled`` is False
#: forever; call sites guard on it so the disabled hot path allocates
#: nothing.
NOOP_TRACER = NoopTracer()


def tracer_from_config(trace_config, clock, *, pid: int = 0):
    """Build the tracer a component stack should use for ``trace_config``
    (a ``config.TraceConfig``): a live ``Tracer`` when enabled, else the
    shared ``NOOP_TRACER``."""
    if trace_config is not None and trace_config.enabled:
        return Tracer(clock, capacity=trace_config.capacity, pid=pid)
    return NOOP_TRACER
