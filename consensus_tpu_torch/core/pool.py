"""Request pool: FIFO admission, dedup, back-pressure, and the three-stage
timeout cascade that drives failure detection.

Parity: reference internal/bft/requestpool.go:52-567.  Differences by design:

* **Event-driven back-pressure** — the reference blocks the submitting
  goroutine on a weighted semaphore with ``SubmitTimeout``
  (requestpool.go:191-284); here a full pool *parks* the submission and
  completes its callback when space frees or the timeout fires.  Nothing
  blocks the replica loop.
* **No background GC goroutine** — the reference garbage-collects its
  recently-deleted dedup map every 5 s on a goroutine (requestpool.go:128-141);
  here the retention window is enforced opportunistically on mutation, which
  keeps simulations quiescence-detectable (no perpetual timer).

The cascade (requestpool.go:493-567): after ``request_forward_timeout`` the
request is forwarded to the leader (stage 1); after a further
``request_complain_timeout`` the replica complains, triggering a view change
(stage 2); after ``request_auto_remove_timeout`` more the request is dropped
(stage 3).  ``stop_timers`` / ``restart_timers`` flip the whole pool around
view changes (requestpool.go:456-490).

The PyTorch port's copy of ``consensus_tpu/core/pool.py``, its imports renamed.
"""

from __future__ import annotations

import logging
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Protocol, Sequence

from consensus_tpu_torch.api.deps import RequestInspector
from consensus_tpu_torch.metrics import MetricsRequestPool, NoopProvider
from consensus_tpu_torch.runtime.scheduler import Scheduler, TimerHandle
from consensus_tpu_torch.trace.tracer import NOOP_TRACER
from consensus_tpu_torch.types import RequestInfo

logger = logging.getLogger("consensus_tpu_torch.pool")

#: How long a deleted request's identity is remembered for dedup purposes.
DELETED_RETENTION_SECONDS = 5.0


class RequestTimeoutHandler(Protocol):
    """Callbacks for the cascade stages (implemented by the Controller).

    Parity: reference internal/bft/requestpool.go:30-44.
    """

    def on_request_timeout(self, raw_request: bytes, info: RequestInfo) -> None:
        """Stage 1: forward the request to the current leader."""

    def on_leader_fwd_request_timeout(self, raw_request: bytes, info: RequestInfo) -> None:
        """Stage 2: the leader ignored the forwarded request — complain."""

    def on_auto_remove_timeout(self, info: RequestInfo) -> None:
        """Stage 3: the request outlived all patience — it was dropped."""


@dataclass
class PoolOptions:
    """Pool tuning (split out of Configuration for standalone use)."""

    pool_size: int = 400
    request_max_bytes: int = 10 * 1024
    submit_timeout: float = 5.0
    forward_timeout: float = 2.0
    complain_timeout: float = 20.0
    auto_remove_timeout: float = 180.0


class _Entry:
    __slots__ = ("raw", "info", "arrived_at", "timer", "stage")

    def __init__(self, raw: bytes, info: RequestInfo, arrived_at: float):
        self.raw = raw
        self.info = info
        self.arrived_at = arrived_at
        self.timer: Optional[TimerHandle] = None
        self.stage = 0  # 0=armed-forward, 1=armed-complain, 2=armed-remove


class _Parked:
    __slots__ = ("raw", "info", "on_done", "timer")

    def __init__(self, raw: bytes, info: RequestInfo, on_done, timer):
        self.raw = raw
        self.info = info
        self.on_done = on_done
        self.timer = timer


class RequestPool:
    """FIFO of pending client requests keyed by :class:`RequestInfo`."""

    def __init__(
        self,
        scheduler: Scheduler,
        inspector: RequestInspector,
        options: PoolOptions,
        *,
        timeout_handler: Optional[RequestTimeoutHandler] = None,
        on_submitted: Optional[Callable[[], None]] = None,
        metrics: Optional[MetricsRequestPool] = None,
        tracer=None,
    ) -> None:
        self._sched = scheduler
        self._inspector = inspector
        self._opts = options
        self._handler = timeout_handler
        #: Notified after every successful admission (the batcher listens).
        self._on_submitted = on_submitted
        # Insertion-ordered map == FIFO + O(1) lookup (the reference keeps a
        # list.List plus a separate existMap; one OrderedDict does both).
        self._fifo: "OrderedDict[str, _Entry]" = OrderedDict()
        self._bytes = 0
        self._parked: deque[_Parked] = deque()
        # Recently-deleted identities -> deletion time (dedup of stragglers).
        self._deleted: "OrderedDict[str, float]" = OrderedDict()
        # Identities the leader has batched into a still-in-flight pipelined
        # proposal: hidden from next_requests until decided (removed) or the
        # view aborts (released).  Always empty at pipeline_depth=1.
        self._reserved: set[str] = set()
        self._timers_stopped = False
        self._closed = False
        self._metrics = metrics or MetricsRequestPool(NoopProvider())
        self._tracer = tracer if tracer is not None else NOOP_TRACER

    # --- admission ---------------------------------------------------------

    def submit(
        self, raw_request: bytes, on_done: Optional[Callable[[Optional[str]], None]] = None
    ) -> None:
        """Admit a request; ``on_done(error)`` fires with ``None`` on success
        or a reason string on rejection/timeout.

        Parity: reference requestpool.go:191-284 (Submit).
        """

        def done(err: Optional[str]) -> None:
            if err is not None:
                self._metrics.count_of_fail_add_request.add(1)
            if on_done is not None:
                on_done(err)

        if self._closed:
            done("pool closed")
            return
        if len(raw_request) > self._opts.request_max_bytes:
            done(
                f"request size {len(raw_request)} exceeds max {self._opts.request_max_bytes}"
            )
            return
        try:
            info = self._inspector.request_id(raw_request)
        except Exception as e:  # inspector is app code
            done(f"request rejected by inspector: {e}")
            return
        self._gc_deleted()
        key = info.key()
        if key in self._fifo or key in self._deleted:
            done("request already exists")
            return
        if len(self._fifo) < self._opts.pool_size:
            self._admit(raw_request, info)
            done(None)
            return
        # Pool full: park until space frees or the submit timeout expires.
        parked = _Parked(raw_request, info, done, None)
        parked.timer = self._sched.call_later(
            self._opts.submit_timeout,
            lambda: self._park_expired(parked),
            name=f"submit-timeout {info}",
        )
        self._parked.append(parked)

    def _park_expired(self, parked: _Parked) -> None:
        try:
            self._parked.remove(parked)
        except ValueError:
            return  # already admitted
        parked.on_done("submit timed out: pool is full")

    def _admit(self, raw: bytes, info: RequestInfo) -> None:
        entry = _Entry(raw, info, self._sched.now())
        if self._tracer.enabled:
            self._tracer.instant("pool", "pool.admit")
        self._fifo[info.key()] = entry
        self._bytes += len(raw)
        self._metrics.count_of_elements.set(len(self._fifo))
        self._metrics.count_of_elements_all.add(1)
        if not self._timers_stopped:
            self._arm_stage(entry, 0)
        if self._on_submitted is not None:
            self._on_submitted()

    def _drain_parked(self) -> None:
        while self._parked and len(self._fifo) < self._opts.pool_size:
            parked = self._parked.popleft()
            if parked.timer is not None:
                parked.timer.cancel()
            key = parked.info.key()
            if key in self._fifo or key in self._deleted:
                parked.on_done("request already exists")
                continue
            self._admit(parked.raw, parked.info)
            parked.on_done(None)

    # --- timeout cascade ---------------------------------------------------

    def _arm_stage(self, entry: _Entry, stage: int) -> None:
        entry.stage = stage
        delays = (
            self._opts.forward_timeout,
            self._opts.complain_timeout,
            self._opts.auto_remove_timeout,
        )
        entry.timer = self._sched.call_later(
            delays[stage],
            lambda: self._stage_fired(entry),
            name=f"request-stage{stage} {entry.info}",
        )

    def _stage_fired(self, entry: _Entry) -> None:
        if self._timers_stopped or entry.info.key() not in self._fifo:
            return
        if entry.stage == 0:
            logger.debug("request %s forward timeout", entry.info)
            self._metrics.count_leader_forward_request.add(1)
            if self._handler is not None:
                self._handler.on_request_timeout(entry.raw, entry.info)
            self._arm_stage(entry, 1)
        elif entry.stage == 1:
            self._metrics.count_timeout_two_step.add(1)
            logger.warning("request %s leader-forward timeout: complaining", entry.info)
            if self._handler is not None:
                self._handler.on_leader_fwd_request_timeout(entry.raw, entry.info)
            self._arm_stage(entry, 2)
        else:
            logger.warning("request %s auto-removed", entry.info)
            self._delete(entry.info.key())
            if self._handler is not None:
                self._handler.on_auto_remove_timeout(entry.info)

    def stop_timers(self) -> None:
        """Freeze the cascade (view change in progress).

        Parity: reference requestpool.go:456-469.
        """
        self._timers_stopped = True
        for entry in self._fifo.values():
            if entry.timer is not None:
                entry.timer.cancel()
                entry.timer = None

    def restart_timers(self) -> None:
        """Re-arm every request at stage 1 of the cascade.

        Parity: reference requestpool.go:471-490.
        """
        self._timers_stopped = False
        for entry in self._fifo.values():
            if entry.timer is not None:
                entry.timer.cancel()
            self._arm_stage(entry, 0)

    # --- consumption -------------------------------------------------------

    def next_requests(self, max_count: int, max_size_bytes: int) -> list[bytes]:
        """A prefix batch of raw requests within the count/byte budget.

        Parity: reference requestpool.go:297-332.
        """
        out: list[bytes] = []
        total = 0
        for key, entry in self._fifo.items():
            if key in self._reserved:
                continue  # already riding an in-flight pipelined slot
            if len(out) >= max_count:
                break
            if out and total + len(entry.raw) > max_size_bytes:
                break
            out.append(entry.raw)
            total += len(entry.raw)
        return out

    def reserve_raws(self, raw_requests: Iterable[bytes]) -> None:
        """Hide pooled requests from subsequent :meth:`next_requests` while
        they ride an in-flight pipelined proposal.  Without this a depth>1
        leader would re-batch the pool front into the next slot (removal
        only happens at delivery) and decide every request twice."""
        if self._tracer.enabled:
            raw_requests = list(raw_requests)
            self._tracer.instant("pool", "pool.reserve", count=len(raw_requests))
        for raw in raw_requests:
            try:
                key = self._inspector.request_id(raw).key()
            except Exception:
                continue  # unidentifiable requests were never pooled
            if key in self._fifo:
                self._reserved.add(key)

    def release_reservations(self) -> None:
        """Forget all reservations (view abort/sync): slots that will never
        decide must hand their requests back to the batcher."""
        self._reserved.clear()

    def remove_request(self, info: RequestInfo) -> bool:
        """Remove a delivered/invalid request.  Returns whether it was here.

        Parity: reference requestpool.go:357-401.
        """
        return self._delete(info.key())

    def remove_requests(self, infos: Iterable[RequestInfo]) -> int:
        """Bulk removal for a delivered batch: one parked-queue drain and
        dedup GC for the whole batch instead of per request (the per-decision
        hot path removes ``request_batch_max_count`` at once)."""
        removed = 0
        now = self._sched.now()
        for info in infos:
            key = info.key()
            if self._delete_entry(key):
                removed += 1
            else:
                # Delivered but not pooled here (e.g. still parked): mark it
                # recently-deleted anyway so the trailing drain cannot
                # re-admit a copy of an already-committed request.  Pop
                # first: a refresh must move to the end, or the GC's
                # stop-at-first-fresh scan retains expired entries behind it.
                self._deleted.pop(key, None)
                self._deleted[key] = now
        self._gc_deleted()
        self._drain_parked()
        return removed

    def _delete(self, key: str) -> bool:
        present = self._delete_entry(key)
        if not present:
            # Same delivered-while-parked guard as the bulk path (pop first
            # to keep the OrderedDict in timestamp order for the GC).
            self._deleted.pop(key, None)
            self._deleted[key] = self._sched.now()
        self._gc_deleted()
        self._drain_parked()
        return present

    def _delete_entry(self, key: str) -> bool:
        self._reserved.discard(key)
        entry = self._fifo.pop(key, None)
        if entry is None:
            return False
        if entry.timer is not None:
            entry.timer.cancel()
        self._bytes -= len(entry.raw)
        self._metrics.count_of_delete_request.add(1)
        self._metrics.count_of_elements.set(len(self._fifo))
        self._metrics.latency_of_elements.observe(self._sched.now() - entry.arrived_at)
        self._deleted[key] = self._sched.now()
        return True

    def _gc_deleted(self) -> None:
        horizon = self._sched.now() - DELETED_RETENTION_SECONDS
        while self._deleted:
            key, when = next(iter(self._deleted.items()))
            if when >= horizon:
                break
            del self._deleted[key]

    def prune(self, keep: Callable[[bytes], bool]) -> None:
        """Per-request :meth:`prune_batch`.  Parity: reference
        requestpool.go:335-354."""
        self.prune_batch(lambda raws: [keep(r) for r in raws])

    def prune_batch(self, keep_batch: Callable[[list], "list[bool]"]) -> None:
        """Like :meth:`prune` but validates the whole pool in ONE call —
        the controller drains the re-validation burst into the batch
        verifier instead of the reference's per-request loop (the sig-heavy
        burst of reference controller.go:733-746)."""
        entries = list(self._fifo.values())
        if not entries:
            return
        mask = keep_batch([e.raw for e in entries])
        doomed = [
            e.info for e, ok in zip(entries, mask, strict=True) if not ok
        ]
        for info in doomed:
            logger.info("pruning request %s (failed re-validation)", info)
        self.remove_requests(doomed)

    def change_options(
        self,
        timeout_handler: Optional[RequestTimeoutHandler] = None,
        options: Optional[PoolOptions] = None,
    ) -> None:
        """Re-point the pool at a new handler/config across reconfiguration,
        keeping every queued request.

        Parity: reference requestpool.go ChangeOptions (used by
        pkg/consensus/consensus.go:231)."""
        if timeout_handler is not None:
            self._handler = timeout_handler
        if options is not None:
            self._opts = options
        self._closed = False

    def close(self) -> None:
        self._closed = True
        self.stop_timers()
        while self._parked:
            parked = self._parked.popleft()
            if parked.timer is not None:
                parked.timer.cancel()
            parked.on_done("pool closed")

    # --- introspection -----------------------------------------------------

    @property
    def count(self) -> int:
        return len(self._fifo)

    @property
    def available_count(self) -> int:
        """Pooled requests NOT riding an in-flight pipelined slot — what
        :meth:`next_requests` can actually hand out.  Equals :attr:`count`
        at pipeline_depth=1 (reservations never happen there)."""
        return len(self._fifo) - len(self._reserved)

    @property
    def size_bytes(self) -> int:
        return self._bytes


__all__ = [
    "RequestPool",
    "PoolOptions",
    "RequestTimeoutHandler",
    "DELETED_RETENTION_SECONDS",
]
