"""Engine supervision: fault-classed circuit breakers and a degrade ladder
(the port's counterpart of ``consensus_tpu/models/supervisor.py``, same
names, transitions and booking).

Acceleration is an optimization, never a liveness or soundness dependency:

* :class:`EngineSupervisor` wraps a best-first ladder of engines and
  classifies failures into three fault classes -- ``launch_timeout``
  (:class:`LaunchTimeout`, the coalescer's wedged-device signal),
  ``launch_raise`` (a refused kernel launch, a lost card, a failed build),
  and ``wrong_answer`` (caught by a deterministic sampled host cross-check
  against the big-int twins).
* Each fault class runs its own circuit breaker (closed -> open ->
  half-open re-probe with exponential backoff).  Time is INJECTED -- a
  ``clock`` callable, usually ``scheduler.now`` -- so breaker behavior is
  replayable under SimScheduler; without a clock the supervisor counts
  launches, which is equally deterministic.
* An open breaker degrades the supervisor down the ladder: the configured
  engine, then mesh -> single device and fused -> unfused, then the host
  twin.  It re-promotes when the breaker
  closes after a successful half-open probe.  While ANY host twin exists,
  no launch ever raises out of :meth:`EngineSupervisor.verify_batch`.
  There is no plain-torch rung: the plain versions serve the CPU and the
  tests, not a card's fallback.
* Every transition is booked into the pinned
  ``engine_degrade_total{reason}`` / ``engine_recovered_total`` /
  ``engine_crosscheck_*`` metric families and the ``on_transition``
  hooks; an embedder's ``tracer`` (``.enabled`` and ``.instant(...)``) and
  ``flight_recorder`` (``.trigger(...)``) get an instant and a snapshot
  too.

:class:`EngineHealth` / :class:`EngineHealthRegistry` hold the suspect
state every ``ThreadCoalescingVerifier`` wrapping the same engine shares,
so a wedge seen by one waiter routes everyone to the host at once.
"""

from __future__ import annotations

import logging
import threading
import weakref
from typing import Callable, Optional, Sequence

import numpy as np

logger = logging.getLogger("consensus_tpu_torch.models.supervisor")

#: The three supervised fault classes, in degrade-reason label order.
FAULT_CLASSES = ("launch_timeout", "launch_raise", "wrong_answer")


class LaunchTimeout(TimeoutError):
    """A device launch exceeded its deadline (wedged tunnel, hung transfer).

    Raised into the supervisor by integration points that can observe a
    timeout without blocking forever -- the coalescer's waiter path, or a
    fault injector's launch wrapper, which models a hang as this exception
    so SimScheduler runs stay deterministic (a real thread hang would not
    replay)."""


class EngineHealth:
    """Shared suspect state for one engine, thread-safe.

    ``ThreadCoalescingVerifier`` instances (one per replica, or one per
    sidecar tenant lane) wrapping the same engine share one of these via
    :data:`ENGINE_HEALTH`, so a device wedge observed by any of them routes
    all of them to the host path at once."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._suspect = False
        self.reason = ""
        #: Total times this engine was marked suspect (diagnostics only).
        self.suspect_marks = 0

    @property
    def suspect(self) -> bool:
        return self._suspect

    def mark_suspect(self, reason: str = "") -> bool:
        """Mark the engine suspect; returns True on the CLEAR -> SUSPECT
        edge (callers log / book only on the edge)."""
        with self._lock:
            edge = not self._suspect
            self._suspect = True
            self.reason = reason
            self.suspect_marks += 1
            return edge

    def clear(self) -> bool:
        """Clear the suspect flag; returns True on the SUSPECT -> CLEAR
        edge."""
        with self._lock:
            edge = self._suspect
            self._suspect = False
            self.reason = ""
            return edge


class EngineHealthRegistry:
    """Process-wide map from engine instance to its shared
    :class:`EngineHealth` — weak-keyed, so engines die normally."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_engine: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def for_engine(self, engine) -> EngineHealth:
        with self._lock:
            try:
                health = self._by_engine.get(engine)
            except TypeError:  # unhashable / unweakrefable engine
                return EngineHealth()
            if health is None:
                health = EngineHealth()
                try:
                    self._by_engine[engine] = health
                except TypeError:
                    pass
            return health


#: The process-wide registry coalescers default to.
ENGINE_HEALTH = EngineHealthRegistry()


class CircuitBreaker:
    """Closed → open → half-open breaker with exponential backoff.

    Pure state machine over an injected ``now`` — no clock of its own, so
    it replays identically under SimScheduler or a launch-count clock."""

    def __init__(
        self,
        *,
        failure_threshold: int = 1,
        backoff_initial: float = 30.0,
        backoff_max: float = 480.0,
    ) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if backoff_initial <= 0 or backoff_max < backoff_initial:
            raise ValueError("backoff must satisfy 0 < initial <= max")
        self.failure_threshold = failure_threshold
        self.backoff_initial = backoff_initial
        self.backoff_max = backoff_max
        self.state = "closed"
        self.failures = 0
        self.opened_count = 0
        self._backoff = backoff_initial
        self._retry_at: Optional[float] = None

    def record_failure(self, now: float) -> bool:
        """Book one failure; returns True when the breaker (re)opens."""
        self.failures += 1
        if self.state == "half_open":
            # Failed re-probe: reopen with doubled backoff.
            self._backoff = min(self._backoff * 2.0, self.backoff_max)
            self.state = "open"
            self.opened_count += 1
            self._retry_at = now + self._backoff
            return True
        if self.state == "closed" and self.failures >= self.failure_threshold:
            self.state = "open"
            self.opened_count += 1
            self._retry_at = now + self._backoff
            return True
        if self.state == "open":
            self._retry_at = now + self._backoff
        return False

    def probe_due(self, now: float) -> bool:
        """True when an open breaker's backoff has elapsed — transitions to
        half-open, granting the caller exactly one re-probe."""
        if self.state == "open" and now >= (self._retry_at or 0.0):
            self.state = "half_open"
            return True
        return self.state == "half_open"

    def record_success(self, now: float) -> bool:
        """Book a successful probe (or healthy call); returns True on the
        half-open -> closed edge."""
        was_probe = self.state == "half_open"
        self.state = "closed"
        self.failures = 0
        self._backoff = self.backoff_initial
        self._retry_at = None
        return was_probe


class HostTwin:
    """The ladder's final rung: big-int host verification of a device
    engine -- slow, but ground truth."""

    randomized = False

    def __init__(self, engine) -> None:
        host = getattr(engine, "verify_host", None)
        if host is None:
            raise ValueError(f"{type(engine).__name__} has no host twin")
        self._engine = engine
        self._host = host

    def verify_batch(self, messages, signatures, public_keys) -> np.ndarray:
        return np.asarray(
            self._host(messages, signatures, public_keys), dtype=bool
        )

    # The twin of a twin is itself: coalescers wrapping a supervisor whose
    # ladder bottomed out still find a host fallback.
    def verify_host(self, messages, signatures, public_keys) -> np.ndarray:
        return self.verify_batch(messages, signatures, public_keys)


class EngineSupervisor:
    """Wraps a best-first ladder of engines with fault-classed breakers.

    ``rungs`` is a non-empty best-first sequence (e.g. ``[fused, unfused]``
    or ``[two_shard, single_device]`` once those lanes exist); unless ``append_host`` is False, a
    :class:`HostTwin` of the last rung is appended as the ladder's floor.
    ``clock`` is a zero-arg callable (``scheduler.now`` under simulation,
    ``time.monotonic`` from real-thread call sites); without one the
    supervisor counts launches, which keeps backoff deterministic.
    ``crosscheck_interval=k`` host-cross-checks every k-th launch (0 = off);
    sampling is launch-counter based, never random, so a fixed-seed run
    cross-checks the same launches every replay.
    """

    def __init__(
        self,
        rungs: Sequence,
        *,
        clock: Optional[Callable[[], float]] = None,
        crosscheck_interval: int = 0,
        failure_threshold: int = 1,
        backoff_initial: float = 30.0,
        backoff_max: float = 480.0,
        append_host: bool = True,
        metrics=None,
        tracer=None,
        flight_recorder=None,
        health: Optional[EngineHealth] = None,
        name: str = "engine",
    ) -> None:
        rungs = list(rungs)
        if not rungs:
            raise ValueError("supervisor needs at least one engine rung")
        if crosscheck_interval < 0:
            raise ValueError("crosscheck_interval must be >= 0")
        if append_host and not isinstance(rungs[-1], HostTwin):
            if getattr(rungs[-1], "verify_host", None) is not None:
                rungs.append(HostTwin(rungs[-1]))
        self._rungs = rungs
        self._has_host = isinstance(rungs[-1], HostTwin)
        self._clock = clock
        self._crosscheck_interval = crosscheck_interval
        self._lock = threading.RLock()
        self._rung = 0
        self._launches = 0
        self._probing: Optional[str] = None
        #: One reason per degrade step taken, newest last.
        self._degrade_stack: list[str] = []
        self.breakers = {
            cls: CircuitBreaker(
                failure_threshold=failure_threshold,
                backoff_initial=backoff_initial,
                backoff_max=backoff_max,
            )
            for cls in FAULT_CLASSES
        }
        self._metrics = getattr(metrics, "engine", metrics)
        self._tracer = tracer
        self._flight = flight_recorder
        self.health = health if health is not None else ENGINE_HEALTH.for_engine(self)
        self.name = name
        #: ``fn(kind, reason, rung)`` with kind in {"degrade", "recover"}.
        self.on_transition: list[Callable[[str, str, int], None]] = []
        if self._metrics is not None:
            self._metrics.rung.set(0)

    # -- introspection -------------------------------------------------------

    @property
    def rung(self) -> int:
        """Current ladder position (0 = as configured)."""
        return self._rung

    @property
    def degraded(self) -> bool:
        return self._rung > 0

    @property
    def rung_count(self) -> int:
        return len(self._rungs)

    @property
    def engine(self):
        """The engine currently serving (for tests / diagnostics)."""
        return self._rungs[self._rung]

    def rung_label(self, rung: int) -> str:
        """Human-readable rung name: the engine class, annotated with its
        ``shard_count`` when it has one — a mesh ladder's rungs are the
        same class at different widths, and "ShardedEd25519Verifier[2] ->
        ShardedEd25519Verifier[1]" is the readable transition."""
        engine = self._rungs[rung]
        label = type(engine).__name__
        shards = getattr(engine, "shard_count", None)
        if shards is not None:
            label += f"[{shards}]"
        return label

    def __getattr__(self, attr):
        # Engine-shape attributes (randomized, pad_to, min_device_batch,
        # shard_count, preferred_wave_size, …) come from the PRIMARY rung:
        # callers size batches — and coalescers size slice-filling waves —
        # for the engine they configured, and degrades must not change
        # wire-visible semantics mid-flight.
        if attr.startswith("_"):
            raise AttributeError(attr)
        return getattr(self._rungs[0], attr)

    def verify_host(self, messages, signatures, public_keys) -> np.ndarray:
        """The ladder's ground truth (used by coalescers as fallback)."""
        return np.asarray(
            self._rungs[-1].verify_batch(messages, signatures, public_keys),
            dtype=bool,
        )

    # -- clock ---------------------------------------------------------------

    def _now(self) -> float:
        if self._clock is not None:
            return float(self._clock())
        return float(self._launches)

    # -- verify --------------------------------------------------------------

    def verify_batch(self, messages, signatures, public_keys) -> np.ndarray:
        with self._lock:
            self._launches += 1
            now = self._now()
            self._maybe_repromote(now)
            rung = self._rung
            while True:
                engine = self._rungs[rung]
                if isinstance(engine, HostTwin):
                    # Ground truth: nothing to classify, nothing to check.
                    result = engine.verify_batch(messages, signatures, public_keys)
                    self._note_success(rung, now)
                    return result
                try:
                    result = np.asarray(
                        engine.verify_batch(messages, signatures, public_keys),
                        dtype=bool,
                    )
                except LaunchTimeout as exc:
                    if rung + 1 >= len(self._rungs):
                        raise  # no rung left below — fail loud
                    rung = self._fault(rung, "launch_timeout", exc, now)
                    continue
                except BaseException as exc:
                    if rung + 1 >= len(self._rungs):
                        raise  # no rung left below — fail loud
                    rung = self._fault(rung, "launch_raise", exc, now)
                    continue
                if self._crosscheck_due():
                    host = self._host_truth(messages, signatures, public_keys)
                    if host is not None and not np.array_equal(result, host):
                        self._book_crosscheck(mismatch=True)
                        self._fault(
                            rung,
                            "wrong_answer",
                            ValueError("host cross-check contradicted device"),
                            now,
                        )
                        # The device verdict is untrusted; the host twin's
                        # answer is the one that leaves this call.
                        return host
                    self._book_crosscheck(mismatch=False)
                self._note_success(rung, now)
                return result

    def _crosscheck_due(self) -> bool:
        k = self._crosscheck_interval
        return k > 0 and self._has_host and self._launches % k == 0

    def _host_truth(self, messages, signatures, public_keys):
        if not self._has_host:
            return None
        return self._rungs[-1].verify_batch(messages, signatures, public_keys)

    def _book_crosscheck(self, *, mismatch: bool) -> None:
        if self._metrics is None:
            return
        self._metrics.count_crosscheck.add(1)
        if mismatch:
            self._metrics.count_crosscheck_mismatch.add(1)

    # -- transitions ---------------------------------------------------------

    def _fault(self, rung: int, reason: str, exc: BaseException, now: float) -> int:
        """Book one classified fault at ``rung``; returns the rung the
        current call should be served from."""
        breaker = self.breakers[reason]
        was_probe = self._probing == reason
        if was_probe:
            self._probing = None  # failed half-open probe
        breaker.record_failure(now)
        below = min(rung + 1, len(self._rungs) - 1)
        if breaker.state == "open" and self._rung <= rung and below > self._rung:
            # A failed probe re-enters the degrade step it was probing out
            # of — book the transition but don't double-push the stack.
            self._degrade(
                reason, exc, from_rung=rung, to_rung=below, push=not was_probe
            )
        return below

    def _degrade(self, reason: str, exc: BaseException, *,
                 from_rung: int, to_rung: int, push: bool = True) -> None:
        self._rung = to_rung
        if push:
            self._degrade_stack.append(reason)
        self.health.mark_suspect(reason)
        detail = (
            f"{self.name}: {self.rung_label(from_rung)} fault "
            f"({reason}: {exc!r}) — degrading to rung {to_rung} "
            f"({self.rung_label(to_rung)})"
        )
        logger.error("%s", detail)
        if self._metrics is not None:
            _labeled(self._metrics.count_degrade, reason).add(1)
            self._metrics.rung.set(to_rung)
        if self._tracer is not None and self._tracer.enabled:
            self._tracer.instant(
                "engine", "engine.degrade",
                reason=reason, rung=to_rung, name=self.name,
            )
        if self._flight is not None:
            try:
                self._flight.trigger(f"engine-degrade-{reason}", detail=detail)
            except Exception:
                logger.exception("flight-record snapshot failed (ignored)")
        for hook in self.on_transition:
            hook("degrade", reason, to_rung)

    def _maybe_repromote(self, now: float) -> None:
        """Climb one rung when the breaker that degraded us grants a
        half-open probe (the current call serves as the probe), or freely
        when that breaker already re-closed — a probe one step up already
        vouched for the fault class."""
        if not self._degrade_stack or self._probing is not None:
            return
        reason = self._degrade_stack[-1]
        breaker = self.breakers[reason]
        if breaker.state == "closed":
            self._degrade_stack.pop()
            self._rung -= 1
            self._book_recover(reason, now)
            return
        if breaker.probe_due(now):
            self._probing = reason
            self._rung -= 1

    def _note_success(self, rung: int, now: float) -> None:
        if rung != self._rung:
            return  # served from an emergency rung below; state already moved
        reason = self._probing
        if reason is None:
            return
        self._probing = None
        self.breakers[reason].record_success(now)
        if self._degrade_stack and self._degrade_stack[-1] == reason:
            self._degrade_stack.pop()
        logger.warning(
            "%s: half-open probe at rung %d succeeded — breaker %s closed, "
            "re-promoted", self.name, rung, reason,
        )
        self._book_recover(reason, now)

    def _book_recover(self, reason: str, now: float) -> None:
        if not self._degrade_stack:
            self.health.clear()
        if self._metrics is not None:
            self._metrics.count_recovered.add(1)
            self._metrics.rung.set(self._rung)
        if self._tracer is not None and self._tracer.enabled:
            self._tracer.instant(
                "engine", "engine.recover",
                reason=reason, rung=self._rung, name=self.name,
            )
        for hook in self.on_transition:
            hook("recover", reason, self._rung)


def _labeled(instrument, value: str):
    """The labeled child series, or the base instrument when the bundle has
    no label dimension (metrics must never break the verify path)."""
    try:
        return instrument.with_labels(value)
    except Exception:
        return instrument


__all__ = [
    "CircuitBreaker",
    "ENGINE_HEALTH",
    "EngineHealth",
    "EngineHealthRegistry",
    "EngineSupervisor",
    "FAULT_CLASSES",
    "HostTwin",
    "LaunchTimeout",
]
