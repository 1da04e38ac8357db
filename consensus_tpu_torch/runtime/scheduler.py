"""Deterministic event scheduler (the port's copy of
``consensus_tpu/runtime/scheduler.py``, same names and behavior).

Every replica is a single-threaded state machine driven by an event queue
with an injectable clock: :class:`SimScheduler` runs virtual time for
tests and simulation (time moves only when the queue is consumed, so
replays are deterministic), and :class:`RealtimeScheduler` pumps the same
queue from one worker thread against the wall clock, with thread-safe
``post`` for ingress from transport and application threads.  The engine
layer's :class:`~consensus_tpu_torch.models.engine.BatchCoalescer` runs
its batch window on it.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import threading
import time as _time
from typing import Callable, Optional, Protocol

logger = logging.getLogger("consensus_tpu_torch.runtime")


class TimerHandle:
    """Cancelable handle for a scheduled callback."""

    __slots__ = ("when", "seq", "fn", "name", "_cancelled")

    def __init__(self, when: float, seq: int, fn: Callable[[], None], name: str):
        self.when = when
        self.seq = seq
        self.fn: Optional[Callable[[], None]] = fn
        self.name = name
        self._cancelled = False

    def cancel(self) -> None:
        self._cancelled = True
        self.fn = None  # break reference cycles for long-lived queues

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def __lt__(self, other: "TimerHandle") -> bool:
        # Total deterministic order: fire time, then scheduling order.
        return (self.when, self.seq) < (other.when, other.seq)

    def __repr__(self) -> str:
        state = "cancelled" if self._cancelled else f"@{self.when:.6f}"
        return f"<Timer {self.name or 'anon'} {state}>"


class Clock(Protocol):
    """Minimal time source components read; injected, never ``time.time``."""

    def now(self) -> float: ...


class Scheduler(Protocol):
    """What protocol components see: a clock plus callback scheduling.

    Implementations must execute callbacks one at a time (run-to-completion);
    callbacks may schedule further callbacks, including at zero delay.
    """

    def now(self) -> float: ...

    def call_later(
        self, delay: float, fn: Callable[[], None], *, name: str = ""
    ) -> TimerHandle: ...

    def post(self, fn: Callable[[], None], *, name: str = "") -> None: ...


class SimScheduler:
    """Virtual-time scheduler for tests and simulation.

    Time only moves when :meth:`advance` / :meth:`run` consume the queue; an
    idle queue costs nothing, so scenarios can leap over 20-second complaint
    timeouts instantly and stay fully deterministic (same seed of events →
    same interleaving, always).
    """

    def __init__(self, start: float = 0.0) -> None:
        self._now = start
        self._heap: list[TimerHandle] = []
        self._seq = itertools.count()
        #: Optional observer called as ``hook(event_name, exception)`` when
        #: an event handler raises — the flight recorder's trigger seam for
        #: unhandled controller exceptions.
        #: The exception is still swallowed (components must stay isolated
        #: from each other's failures); the hook only *observes* it.
        self.on_unhandled_error: Optional[Callable[[str, BaseException], None]] = None

    # --- Scheduler protocol ------------------------------------------------

    def now(self) -> float:
        return self._now

    def call_later(
        self, delay: float, fn: Callable[[], None], *, name: str = ""
    ) -> TimerHandle:
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        h = TimerHandle(self._now + delay, next(self._seq), fn, name)
        heapq.heappush(self._heap, h)
        return h

    def post(self, fn: Callable[[], None], *, name: str = "") -> None:
        self.call_later(0.0, fn, name=name)

    # --- test-driver surface ----------------------------------------------

    def _fire(self, h: TimerHandle) -> None:
        fn = h.fn
        if h.cancelled or fn is None:
            return
        try:
            fn()
        except Exception as err:
            # A crashing handler must not wedge the whole simulation; real
            # components are expected to catch their own errors.
            logger.exception("unhandled error in event %r", h.name)
            hook = self.on_unhandled_error
            if hook is not None:
                try:
                    hook(h.name, err)
                except Exception:
                    logger.exception("on_unhandled_error hook failed")

    def _drain(
        self,
        *,
        deadline: Optional[float],
        stop: Optional[Callable[[], bool]],
        max_events: int,
        label: str,
    ) -> int:
        """Shared event-loop body: pop due events in order, skip cancelled
        ones, fire the rest; stop at ``deadline`` (virtual time), when
        ``stop()`` turns true, or after ``max_events`` (livelock guard)."""
        executed = 0
        while self._heap:
            if deadline is not None and self._heap[0].when > deadline:
                break
            h = heapq.heappop(self._heap)
            if h.cancelled:
                continue
            if executed >= max_events:
                raise RuntimeError(f"{label} exceeded {max_events} events")
            self._now = max(self._now, h.when)
            self._fire(h)
            executed += 1
            if stop is not None and stop():
                break
        return executed

    def run_until_idle(self, *, max_events: int = 1_000_000) -> int:
        """Run events (advancing virtual time as needed) until none remain.

        Returns the number of events executed.  ``max_events`` guards against
        livelock from self-rescheduling handlers.
        """
        return self._drain(
            deadline=None, stop=None, max_events=max_events, label="run_until_idle"
        )

    def advance(self, dt: float, *, max_events: int = 1_000_000) -> int:
        """Run all events due within the next ``dt`` seconds, then set the
        clock to exactly ``now + dt``.  Returns events executed."""
        if dt < 0:
            raise ValueError(f"negative dt {dt}")
        deadline = self._now + dt
        executed = self._drain(
            deadline=deadline, stop=None, max_events=max_events, label="advance"
        )
        self._now = deadline
        return executed

    def run_until(
        self,
        predicate: Callable[[], bool],
        *,
        max_time: float = 3600.0,
        max_events: int = 1_000_000,
    ) -> bool:
        """Run events until ``predicate()`` holds or the virtual-time budget
        is exhausted.  Returns whether the predicate was met."""
        if predicate():
            return True
        self._drain(
            deadline=self._now + max_time,
            stop=predicate,
            max_events=max_events,
            label="run_until",
        )
        return predicate()

    @property
    def pending(self) -> int:
        """Live (non-cancelled) queued events."""
        return sum(1 for h in self._heap if not h.cancelled)


class RealtimeScheduler:
    """Wall-clock scheduler: one worker thread pumps the same event queue.

    Transport and application threads hand work in via the thread-safe
    ``post`` / ``call_later``; everything executes on the single worker
    thread, preserving the run-to-completion model the protocol core assumes.
    """

    def __init__(self) -> None:
        self._heap: list[TimerHandle] = []
        self._seq = itertools.count()
        self._cond = threading.Condition()
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        #: Same contract as ``SimScheduler.on_unhandled_error``.
        self.on_unhandled_error: Optional[Callable[[str, BaseException], None]] = None

    def now(self) -> float:
        return _time.monotonic()

    def call_later(
        self, delay: float, fn: Callable[[], None], *, name: str = ""
    ) -> TimerHandle:
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        with self._cond:
            h = TimerHandle(self.now() + delay, next(self._seq), fn, name)
            heapq.heappush(self._heap, h)
            self._cond.notify()
            return h

    def post(self, fn: Callable[[], None], *, name: str = "") -> None:
        self.call_later(0.0, fn, name=name)

    def start(self, *, thread_name: str = "consensus-runtime") -> None:
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        self._stopped = False
        self._thread = threading.Thread(
            target=self._run, name=thread_name, daemon=True
        )
        self._thread.start()

    def stop(self, *, timeout: float = 5.0) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                # A wedged callback outlived the join budget: keep the handle
                # so a later start() can't spawn a second worker over the
                # same heap (which would break run-to-completion).
                raise RuntimeError(
                    "runtime worker did not stop within "
                    f"{timeout}s; a callback is blocking it"
                )
            self._thread = None

    def _run(self) -> None:
        while True:
            with self._cond:
                while True:
                    if self._stopped:
                        return
                    now = self.now()
                    if self._heap and self._heap[0].cancelled:
                        heapq.heappop(self._heap)
                        continue
                    if self._heap and self._heap[0].when <= now:
                        h = heapq.heappop(self._heap)
                        break
                    wait = (self._heap[0].when - now) if self._heap else None
                    self._cond.wait(timeout=wait)
            fn = h.fn
            if h.cancelled or fn is None:
                continue
            try:
                fn()
            except Exception as err:
                logger.exception("unhandled error in event %r", h.name)
                hook = self.on_unhandled_error
                if hook is not None:
                    try:
                        hook(h.name, err)
                    except Exception:
                        logger.exception("on_unhandled_error hook failed")


__all__ = [
    "Clock",
    "Scheduler",
    "SimScheduler",
    "RealtimeScheduler",
    "TimerHandle",
]
