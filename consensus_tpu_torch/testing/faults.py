"""Deterministic crash-point fault injection for the durability spine.

The production modules (``wal/log.py``, ``core/state.py``,
``net/transport.py``, ``net/sidecar.py``) expose *named crash points*:
places where a real process can die (mid-frame, between fsyncs, between
the two halves of the view changer's endorsement append) or where real
I/O can fail (socket writes, short reads).  Each seam is a no-op unless a
:class:`FaultPlan` is armed — production code pays one ``is None``
attribute check per seam, no lock and no extra fsync.

The seam modules do NOT import this module (that would invert the
production→testing dependency); they only call methods on whatever plan
object the test attached.  The canonical catalog of point names therefore
lives HERE, and :meth:`FaultPlan.trip` validates every name it is handed
against it — a typo'd seam explodes the first time any plan is armed, and
the crash-matrix coverage gate (tests/test_crash_matrix.py) fails if a
cataloged point is never hit at all.

Determinism: a plan fires on the *Nth hit* of one named point.  Replaying
a matrix failure needs only the printed (crash point, hit, schedule seed)
triple — there is no wall clock and no unseeded randomness anywhere in
the injection path.

The PyTorch port's copy of ``consensus_tpu/testing/faults.py``, its imports renamed.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Callable, Optional


class SimulatedCrash(Exception):
    """Injected process death.  Raised by a crash seam when its plan fires;
    the plan's ``on_crash`` hook (typically ``Node.crash``) has already torn
    the replica down by the time this propagates, so even an intermediate
    ``except Exception`` swallowing it cannot resurrect the process — every
    later seam touch by the zombie frame raises again."""


class InjectedIOError(OSError):
    """Injected transport-level I/O failure (a *fault*, not a death): the
    component's normal OSError handling must absorb it — drop the link,
    reconnect, fall back — exactly as for a real socket error."""


#: name -> one-line description.  The single source of truth for what crash
#: points exist; the seams reference these names as string literals and
#: ``FaultPlan.trip`` rejects anything not listed.
CRASH_POINTS: dict[str, str] = {}


def register_crash_point(name: str, description: str = "") -> str:
    CRASH_POINTS[name] = description
    return name


def registered_crash_points(domain: Optional[str] = None) -> tuple[str, ...]:
    """All cataloged point names, optionally filtered by the leading
    dot-separated component (``wal`` / ``state`` / ``net`` / ``sidecar``)."""
    names = sorted(CRASH_POINTS)
    if domain is not None:
        names = [n for n in names if n.split(".", 1)[0] == domain]
    return tuple(names)


# --- the catalog -----------------------------------------------------------

# wal/log.py (real file-backed WAL only; MemWAL runs exercise the state.*
# points instead).
register_crash_point(
    "wal.append.pre_write", "before any byte of the record frame is written"
)
register_crash_point(
    "wal.append.torn_write",
    "half the record frame written + flushed, then death (repair must chop)",
)
register_crash_point(
    "wal.fsync.pre",
    "record written + flushed but not fsynced (bytes may still survive: the"
    " OS page cache outlives a process crash)",
)
register_crash_point("wal.fsync.post", "record durable, append never returned")
register_crash_point(
    "wal.segment.roll", "record written, death before rolling to a new segment"
)

# core/state.py — one pre/post pair per save() record kind, plus the view
# changer's endorsement append (the _commit_in_flight [proposed, commit]
# tail) labeled distinctly so the buried-vote restore gap stays pinned.
for _kind in ("proposed", "commit", "viewchange", "newview",
              "endorsement_proposed", "endorsement_commit"):
    register_crash_point(
        f"state.save.{_kind}.pre",
        f"before persisting a {_kind} record (nothing happened)",
    )
    register_crash_point(
        f"state.save.{_kind}.post",
        f"after the {_kind} record is durable (deferred sends already fired"
        " in per-append-fsync mode)",
    )

# net/transport.py + net/sidecar.py — I/O faults, not process deaths.
register_crash_point("net.send.io_error", "peer socket write fails")
register_crash_point("net.recv.short_read", "inbound link dies mid-frame")
register_crash_point("sidecar.send.io_error", "sidecar request write fails")
register_crash_point("sidecar.recv.short_read", "sidecar response link dies")

# sync/ — the catch-up path (client + transport).  The client seam is a
# process death at the worst moment (a chunk applied, the next not yet
# fetched — resume must start from the store height, not refetch or skip);
# the transport seams are survivable fetch failures the peer-scoring loop
# must absorb.
register_crash_point(
    "sync.client.chunk_boundary",
    "death right after a verified chunk is applied to the store",
)
register_crash_point(
    "sync.fetch.io_error", "sync fetch fails mid-flight (socket-level error)"
)
register_crash_point(
    "sync.chunk.corrupt",
    "a fetched chunk's bytes arrive corrupted (decode must fail closed)",
)


class FaultPlan:
    """One replica's armed fault: fire at the ``on_hit``-th hit of
    ``crash_at``.

    ``crash()`` seams mark the plan dead, run ``on_crash`` (the harness
    wires this to the node teardown), and raise :class:`SimulatedCrash`;
    ``io_error()`` seams raise :class:`InjectedIOError` without killing the
    plan (an I/O fault is survivable).  ``trip()`` is the raw
    count-and-check for seams that need custom behavior (torn writes,
    short reads).

    ``hits`` counts every visit to every point — armed or not — so the
    matrix's coverage-of-injection gate can prove each registered point is
    actually reachable.  Thread-safe: transport/sidecar seams run on their
    own threads.
    """

    def __init__(
        self,
        crash_at: Optional[str] = None,
        *,
        on_hit: int = 1,
        on_crash: Optional[Callable[[], None]] = None,
        label: str = "",
    ) -> None:
        if crash_at is not None and crash_at not in CRASH_POINTS:
            raise ValueError(f"unknown crash point {crash_at!r}")
        if on_hit < 1:
            raise ValueError("on_hit is 1-based")
        self.crash_at = crash_at
        self.on_hit = on_hit
        self.on_crash = on_crash
        self.label = label
        self.hits: Counter = Counter()
        self.dead = False
        #: (point, hit_number) once the plan has fired.
        self.fired: Optional[tuple[str, int]] = None
        #: Optional decision-lifecycle tracer (trace.Tracer): the armed hit
        #: emits a ``fault.fired`` instant so a trace shows exactly which
        #: seam fired, on the same deterministic clock as the phase spans.
        self.tracer = None
        #: Optional flight recorder (obs.FlightRecorder): the armed hit calls
        #: ``recorder.on_fault_fired(point, hit)`` BEFORE on_crash tears the
        #: node down, so the bundle captures the pre-crash state.
        self.recorder = None
        self._lock = threading.Lock()

    def _count_hit(self, point: str, *, die: bool) -> tuple[bool, int]:
        """One atomic hit of ``point``: count it and, when this hit is the
        armed one, mark it fired (and dead, for crash seams) in the SAME
        critical section — transport/sidecar seams race the consensus
        thread, and a dead-check outside the lock lets two threads both
        observe the firing (or a zombie slip one last effect through).
        Returns ``(armed, hit_number)``; ``hit_number`` is 0 when the call
        was a zombie touch (``die`` and already dead)."""
        if point not in CRASH_POINTS:
            raise ValueError(f"seam reports unregistered crash point {point!r}")
        with self._lock:
            if die and self.dead:
                return False, 0
            self.hits[point] += 1
            n = self.hits[point]
            if self.dead or self.fired is not None:
                return False, n
            armed = point == self.crash_at and n == self.on_hit
            if armed:
                self.fired = (point, n)
                if die:
                    self.dead = True
        if armed:
            tracer = self.tracer
            if tracer is not None and tracer.enabled:
                tracer.instant("fault", "fault.fired", point=point, hit=n)
            recorder = self.recorder
            if recorder is not None:
                try:
                    recorder.on_fault_fired(point, n)
                except Exception:
                    pass
        return armed, n

    def trip(self, point: str) -> bool:
        """Count one hit of ``point``; True when this hit is the armed one."""
        armed, _ = self._count_hit(point, die=False)
        return armed

    def will_fire(self, point: str) -> bool:
        """Whether the NEXT hit of ``point`` would fire (peek, no count) —
        for seams that must do damage (write torn bytes) before dying."""
        with self._lock:
            return (
                not self.dead
                and self.fired is None
                and point == self.crash_at
                and self.hits[point] + 1 == self.on_hit
            )

    def crash(self, point: str) -> None:
        """Crash-type seam: die here when armed; zombie frames die again.
        The dead-check, hit count, and dead-set are one atomic step
        (:meth:`_count_hit`), so concurrent seam threads agree on exactly
        one firing and no post-death touch slips through."""
        armed, n = self._count_hit(point, die=True)
        if n == 0:
            raise SimulatedCrash(f"zombie process touched {point}")
        if armed:
            if self.on_crash is not None:
                self.on_crash()
            raise SimulatedCrash(
                f"injected crash at {point} (hit {self.on_hit})"
            )

    def io_error(self, point: str) -> None:
        """I/O-fault seam: raise a survivable OSError when armed."""
        if self.trip(point):
            raise InjectedIOError(f"injected I/O error at {point}")

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (
            f"FaultPlan({self.crash_at!r}, on_hit={self.on_hit}, "
            f"fired={self.fired}, dead={self.dead}, label={self.label!r})"
        )


__all__ = [
    "FaultPlan",
    "SimulatedCrash",
    "InjectedIOError",
    "CRASH_POINTS",
    "register_crash_point",
    "registered_crash_points",
]
