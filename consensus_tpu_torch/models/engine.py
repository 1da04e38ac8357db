"""Micro-batching coalescers: merge verification work from many sources
into single device launches (the port's counterpart of
``consensus_tpu/models/engine.py``, same names and behavior).

A host running several replicas -- or a replica pipelining decisions --
produces many small batches in a short window.  The coalescers hold
submissions for ``window`` seconds (or until ``max_batch`` items are
pending) and flush them as one engine call, so the kernels behind the
engine (B1, B2, B3 in ``ops/scan_kernels.py``) launch once per flush,
trading a bounded latency for arithmetic intensity.  The window must stay
well under the network RTT to not hurt p50 commit latency.

* :class:`BatchCoalescer` -- generic (items -> results) coalescing on the
  replica scheduler;
* :class:`ThreadCoalescingVerifier` -- thread-safe coalescing of the
  ``verify_batch`` calls of replicas sharing one card, with the
  wedged-device escape hatch to the engine's host path;
* :class:`FairShareWaveFormer` -- multi-tenant waves with per-tenant
  admission control and round-robin fair share.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from consensus_tpu_torch.models.supervisor import ENGINE_HEALTH, EngineHealth
from consensus_tpu_torch.runtime.scheduler import Scheduler, TimerHandle

logger = logging.getLogger("consensus_tpu_torch.models.engine")


def _split_results(results: Sequence, sizes: Sequence[int]):
    """Slice a merged result vector back into per-submission pieces,
    refusing short results (a truncated slice must never read as 'all
    valid' downstream)."""
    total = sum(sizes)
    if len(results) != total:
        raise ValueError(
            f"run_batch returned {len(results)} results for {total} items"
        )
    out, offset = [], 0
    for size in sizes:
        out.append(results[offset : offset + size])
        offset += size
    return out


class BatchCoalescer:
    """Generic (items -> results) coalescer on the replica scheduler.

    ``run_batch`` receives the concatenated items of all pending
    submissions and must return one result per item, in order.
    """

    def __init__(
        self,
        scheduler: Scheduler,
        run_batch: Callable[[Sequence], Sequence],
        *,
        window: float = 0.002,
        max_batch: int = 1024,
    ) -> None:
        self._sched = scheduler
        self._run_batch = run_batch
        self._window = window
        self._max_batch = max_batch
        self._pending: list[tuple[list, Callable[[Sequence], None]]] = []
        self._pending_count = 0
        self._timer: Optional[TimerHandle] = None

    def submit(self, items: Sequence, on_results: Callable[[Sequence], None]) -> None:
        """Queue ``items``; ``on_results`` fires with their results once the
        batch they rode in completes."""
        items = list(items)
        if not items:
            on_results([])
            return
        self._pending.append((items, on_results))
        self._pending_count += len(items)
        if self._pending_count >= self._max_batch:
            self.flush()
        elif self._timer is None:
            self._timer = self._sched.call_later(
                self._window, self.flush, name="crypto-batch-window"
            )

    def flush(self) -> None:
        """Run everything pending as one batch."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        pending, self._pending, self._pending_count = self._pending, [], 0
        if not pending:
            return
        merged: list = []
        for items, _ in pending:
            merged.extend(items)
        results = self._run_batch(merged)
        slices = _split_results(results, [len(items) for items, _ in pending])
        for (_, on_results), piece in zip(pending, slices):
            on_results(piece)

    @property
    def pending_count(self) -> int:
        return self._pending_count


class _Pending:
    __slots__ = (
        "messages", "signatures", "keys", "done", "result", "error", "waiterless",
    )

    def __init__(self, messages, signatures, keys, *, waiterless: bool = False):
        self.messages = messages
        self.signatures = signatures
        self.keys = keys
        self.done = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        # Recovery probes have no waiter: nobody consumes their results, so
        # failure paths shouldn't burn host CPU computing them.
        self.waiterless = waiterless


def _slice_wave_target(engine, cap: int) -> int:
    """The early-flush signature count for a coalescer over ``engine``.

    Multi-device engines advertise ``preferred_wave_size`` — the smallest
    padded wave that saturates the WHOLE topology (every shard fed at least
    its device-batch floor), not one chip — so once that many signatures
    are aboard the coalescer launches without waiting out the window:
    the slice is already full, further waiting is pure latency.  Engines
    without a multi-device topology keep the plain size cap, so
    single-device coalescing behavior is bit-for-bit unchanged."""
    if int(getattr(engine, "shard_count", 1) or 1) <= 1:
        return cap
    preferred = int(getattr(engine, "preferred_wave_size", 0) or 0)
    if preferred <= 0:
        return cap
    return min(cap, preferred)


class ThreadCoalescingVerifier:
    """Thread-safe verify coalescer for replicas *sharing one device*.

    In a deployment where several replica threads (or processes behind a
    sidecar) share a single card, each replica independently batch-verifies
    the same proposal's signatures — n device launches per decision, each
    paying the fixed dispatch/transfer overhead.  This wrapper merges
    concurrent ``verify_batch`` calls from any thread into one kernel
    launch: submissions wait up to ``window`` seconds (or until
    ``max_batch`` signatures are pending) and ride a single padded device
    call, then each caller gets its own slice of the results.

    The per-replica semantics are unchanged — every replica still checks
    exactly the signatures it chose to check; only the *execution* is
    fused.  (The reference has no equivalent: each Go replica burns its own
    cores — reference internal/bft/view.go:537-541.)

    ``hard_cap`` bounds a single launch (whole submissions are never
    split); overflow waits for the next flush.  Set it to the engine's
    padded wave size so a mid-run launch never outgrows the wave's shape
    (and the device memory sized for it).
    Submissions larger than ``hard_cap`` are chunked and enqueued together
    (they share flushes; results are re-concatenated for the caller).

    ``bypass_below``: submissions smaller than this go straight to the
    wrapped engine on the caller's thread with NO window wait.  Merging
    only pays off for *device* launches (amortizing dispatch overhead);
    host-path work gains nothing from fusion, so single-signature checks
    (heartbeats, view-change messages, quorum votes) shouldn't pay the
    window latency.  Match it to the engine's ``min_device_batch``.

    ``wait_timeout``: a wedged device (e.g. a hung kernel) must not
    block a replica past its protocol timeouts.  A waiter whose flush has
    not completed after this many seconds falls back to the engine's host
    path (``engine.verify_host``) on its own thread — the decision still
    completes, just without acceleration — and the coalescer marks the
    device *suspect* so subsequent submissions skip the queue entirely and
    go straight to host.  The first successful device flush clears the
    flag (device recovered).  Size it above the worst-case first kernel
    build (nvcc); engines without a ``verify_host`` method keep the old fail-loud
    behavior (raise on timeout).
    """

    def __init__(
        self,
        engine,
        *,
        window: float = 0.010,
        max_batch: int = 8192,
        hard_cap: int = 0,
        bypass_below: int = 0,
        wait_timeout: Optional[float] = None,
        scheduler: Optional[Scheduler] = None,
        health: Optional[EngineHealth] = None,
        name: str = "verify-coalescer",
    ) -> None:
        self._engine = engine
        self._window = window
        self._max_batch = max_batch
        # Early-flush point: the engine's slice-filling wave size on mesh
        # engines, the plain cap otherwise (see _slice_wave_target).
        self._flush_target = _slice_wave_target(engine, max_batch)
        self._hard_cap = hard_cap if hard_cap > 0 else max(max_batch, 1)
        self._bypass_below = bypass_below
        self._host_fallback = getattr(engine, "verify_host", None)
        if wait_timeout is None:
            # With a host escape hatch, timing out early just means one
            # slower-but-correct decision (and the flag clears on the next
            # successful flush, e.g. when a long first compile lands).
            # Without one, a timeout is a hard error — keep the generous
            # budget that covers worst-case first compiles.
            wait_timeout = 60.0 if self._host_fallback is not None else 300.0
        self._wait_timeout = wait_timeout
        self._cv = threading.Condition()
        self._pending: list[_Pending] = []
        self._count = 0
        self._closed = False
        # Suspect state is SHARED across every coalescer (and tenant lane)
        # wrapping the same engine: a wedge seen by one waiter routes all
        # of them host-side.  An engine carrying its own health surface
        # (e.g. an EngineSupervisor) contributes it; otherwise the
        # process-wide registry keys one per engine instance.
        if health is None:
            health = getattr(engine, "health", None)
            if not isinstance(health, EngineHealth):
                health = ENGINE_HEALTH.for_engine(engine)
        self._health = health
        # Suspect re-probe pacing: protocol-clocked when the embedder hands
        # us its scheduler; only the real-thread sidecar path (no scheduler
        # available) reads the wall clock.
        if scheduler is not None:
            self._probe_clock = scheduler.now
        else:
            self._probe_clock = time.monotonic  # wallclock-ok
        self._probe_interval = 30.0
        self._last_probe = -float("inf")
        self._thread = threading.Thread(target=self._loop, daemon=True, name=name)
        self._thread.start()

    @property
    def device_suspect(self) -> bool:
        """True while the device is considered wedged (submissions are
        routed straight to the host path)."""
        return self._health.suspect

    @property
    def health(self) -> EngineHealth:
        """The shared engine-health entry this coalescer reports into."""
        return self._health

    @property
    def _device_suspect(self) -> bool:
        return self._health.suspect

    def verify_batch(self, messages, signatures, public_keys) -> np.ndarray:
        n = len(messages)
        if not (n == len(signatures) == len(public_keys)):
            raise ValueError("batch length mismatch")
        if n == 0:
            return np.zeros(0, dtype=bool)
        if self._device_suspect and self._host_fallback is not None:
            # Wedged device: don't queue behind a flusher that may be stuck
            # inside a hung device call — verify on the caller's thread.
            # A no-wait copy of the work probes the device for recovery.
            self._maybe_probe_device(messages, signatures, public_keys)
            return np.asarray(self._host_fallback(messages, signatures, public_keys))
        if n < self._bypass_below:
            # Too small to ever ride the device: verify on the caller's
            # thread, zero added latency (the engine routes it host-side).
            return np.asarray(self._engine.verify_batch(messages, signatures, public_keys))
        # Chunk oversized submissions so no launch exceeds the compiled
        # shape, enqueueing ALL chunks before waiting on any (they may
        # share flushes — waiting per-chunk would serialize windows).
        cap = self._hard_cap
        items = [
            _Pending(
                list(messages[i : i + cap]),
                list(signatures[i : i + cap]),
                list(public_keys[i : i + cap]),
            )
            for i in range(0, n, cap)
        ]
        with self._cv:
            if self._closed:
                raise RuntimeError("coalescer is closed")
            for item in items:
                self._pending.append(item)
                self._count += len(item.messages)
            self._cv.notify_all()
        for item in items:
            if not item.done.wait(timeout=self._wait_timeout):
                if self._host_fallback is None:
                    raise RuntimeError(
                        f"verify flush did not complete within {self._wait_timeout}s "
                        "(wedged device?)"
                    )
                self._abandon_to_host(items)
                break
            if item.error is not None:
                if self._host_fallback is not None:
                    # A flush error with a host twin available is a degrade,
                    # not a decision-killer: mark the device suspect and
                    # complete the wave on the caller's thread via host
                    # (mirrors the timeout path above — errors reaching a
                    # waiter here mean the flusher's own host attempt hit a
                    # transient, so retry it where the waiter can see it).
                    self._abandon_to_host(items, reason="launch_raise")
                    break
                # A merged flush fails for every waiter; raising the SAME
                # exception object from N threads would interleave their
                # frames into one shared traceback — wrap per waiter.
                raise RuntimeError(
                    f"coalesced verify flush failed: {item.error!r}"
                ) from item.error
        if len(items) == 1:
            return items[0].result
        return np.concatenate([item.result for item in items])

    def _maybe_probe_device(self, messages, signatures, public_keys) -> None:
        """While suspect, periodically enqueue a no-waiter copy of real work
        so the flusher (once it unwedges / recovers) runs a device flush and
        clears the flag.  At most one probe is queued at a time, and probes
        are rate-limited — a stuck flusher can't accumulate a backlog."""
        # Probe pacing through the injected clock (scheduler.now when the
        # embedder provided one; the real-thread sidecar path falls back to
        # the audited wall clock chosen in __init__).
        now = self._probe_clock()
        with self._cv:
            if (
                self._closed
                or self._pending
                or now - self._last_probe < self._probe_interval
            ):
                return
            self._last_probe = now
            cap = min(len(messages), self._hard_cap)
            item = _Pending(
                list(messages[:cap]),
                list(signatures[:cap]),
                list(public_keys[:cap]),
                waiterless=True,
            )
            self._pending.append(item)
            self._count += cap
            self._cv.notify_all()

    def _abandon_to_host(
        self, items: list["_Pending"], reason: str = "launch_timeout"
    ) -> None:
        """Waiter-side escape hatch: the flush never completed within
        ``wait_timeout`` (hung device call).
        Mark the device suspect, pull any chunks still queued out of the
        flusher's reach, and verify everything on the caller's thread via
        the engine's host path so the replica completes its decision within
        protocol timeouts.  Results the stuck flusher produces later for
        these items are simply ignored."""
        with self._cv:
            if self._health.mark_suspect(reason):
                logger.error(
                    "verify flush did not complete (%s) — device suspect; "
                    "falling back to HOST verification (slower, still "
                    "correct) until a device flush succeeds",
                    reason,
                )
            for item in items:
                if item in self._pending:
                    self._pending.remove(item)
                    self._count -= len(item.messages)
        for item in items:
            if item.done.is_set() and item.error is None and item.result is not None:
                continue  # completed while we were escaping — keep it
            item.result = np.asarray(
                self._host_fallback(item.messages, item.signatures, item.keys)
            )
            item.error = None
            item.done.set()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        # A legitimate in-flight flush (first compile, big host pass) may
        # run long — grant it the same budget as waiters before calling
        # the device wedged.
        self._thread.join(timeout=self._wait_timeout)
        if self._thread.is_alive():
            # Daemon thread — it can't block process exit; shutdown itself
            # must not crash on a wedged device.
            logger.error(
                "coalescer flusher did not exit within %.1fs (wedged device?)",
                self._wait_timeout,
            )

    # -- flusher thread ----------------------------------------------------

    def _take_batch(self) -> list[_Pending]:
        """Pop whole pending submissions up to ``hard_cap`` signatures."""
        taken, total = [], 0
        while self._pending:
            nxt = len(self._pending[0].messages)
            if taken and total + nxt > self._hard_cap:
                break
            item = self._pending.pop(0)
            taken.append(item)
            total += nxt
        self._count -= total
        return taken

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending and self._closed:
                    return
                deadline = time.monotonic() + self._window  # wallclock-ok
                while self._count < self._flush_target and not self._closed:
                    remaining = deadline - time.monotonic()  # wallclock-ok
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                batch = self._take_batch()
            if not batch:
                continue
            messages: list = []
            signatures: list = []
            keys: list = []
            for item in batch:
                messages.extend(item.messages)
                signatures.extend(item.signatures)
                keys.extend(item.keys)
            try:
                results = np.asarray(self._engine.verify_batch(messages, signatures, keys))
                slices = _split_results(results, [len(i.messages) for i in batch])
            except BaseException as exc:
                if self._host_fallback is not None:
                    # Device call failed fast (not hung): serve this flush
                    # from the host path so waiters complete, and mark the
                    # device suspect so new submissions skip the queue.
                    logger.error(
                        "device verify flush failed (%r) — serving %d "
                        "signatures via HOST fallback; device suspect",
                        exc,
                        len(messages),
                    )
                    self._health.mark_suspect("launch_raise")
                    for item in batch:
                        if item.waiterless:
                            item.done.set()  # failed probe: nothing to serve
                            continue
                        try:
                            item.result = np.asarray(
                                self._host_fallback(
                                    item.messages, item.signatures, item.keys
                                )
                            )
                        except BaseException as host_exc:
                            # The host path failing too (e.g. malformed
                            # inputs) must not kill the flusher thread —
                            # deliver it as this waiter's error.
                            item.error = host_exc
                        item.done.set()
                    continue
                for item in batch:  # no host path: propagate to every waiter
                    item.error = exc
                    item.done.set()
                continue
            if self._health.clear():
                logger.warning(
                    "device verify flush succeeded — clearing suspect flag, "
                    "resuming device batching"
                )
            for item, piece in zip(batch, slices):
                item.result = piece
                item.done.set()


class AdmissionReject(Exception):
    """A tenant's bounded queue is full: the submission is REJECTED with
    structure (who, how deep, the limit) instead of stalling — the caller
    retries or falls back locally, and other tenants' waves are untouched."""

    def __init__(self, tenant: str, queue_depth: int, limit: int) -> None:
        super().__init__(
            f"tenant {tenant!r} admission rejected: "
            f"{queue_depth} signatures queued, limit {limit}"
        )
        self.tenant = tenant
        self.queue_depth = queue_depth
        self.limit = limit


class _TenantPending(_Pending):
    __slots__ = ("tenant", "group")

    def __init__(self, tenant, messages, signatures, keys, group=None):
        super().__init__(messages, signatures, keys)
        self.tenant = tenant
        self.group = group


class FairShareWaveFormer:
    """Multi-tenant wave forming over one engine: per-tenant bounded queues,
    round-robin draining, cross-tenant coalescing into single launches.

    The sidecar's single-tenant coalescer (:class:`ThreadCoalescingVerifier`)
    merges submissions but knows nothing about who they belong to — one
    flooding client can fill every launch and starve the rest.  This former
    gives each tenant its own queue with three properties:

    * **Admission control** — a submission that would push the tenant's
      queued signature count past ``tenant_queue_limit`` raises
      :class:`AdmissionReject` immediately (bounded memory, structured
      reject, never a stall).  Other tenants are unaffected: their queues,
      their limits.
    * **Fair share** — waves are formed round-robin across tenant queues,
      one whole submission per tenant per pass, and the rotation order
      advances every wave, so a heavy tenant gets the leftover capacity
      but can never exclude a light one from the next launch.
    * **Deadline-aware coalescing** — a wave closes when the flush target
      is aboard or ``window`` seconds after the first pending submission,
      whichever is first; until then, cross-tenant submissions keep joining
      the same launch.  The flush target is ``max_wave``, except over a
      mesh engine, where the former learns the engine's
      ``preferred_wave_size`` — the padded shard-multiple that saturates
      the whole slice — and launches as soon as the slice is full instead
      of waiting out the window.

    ``on_wave(tenant_counts, total)`` fires after each successful launch
    with the per-tenant signature counts that rode it — the sidecar's
    metrics/kernel-accounting hook.

    **Cross-GROUP coalescing** (consensus sharding): ``submit`` takes an
    optional ``group`` id.  When present, the admission identity becomes
    (group, tenant) — each group's replicas get their own bounded queues
    and their own fair-share slot — and one fused launch serves
    submissions from several consensus groups at once.  SAFETY §7 is
    preserved by construction: waves are formed from WHOLE submissions
    (``_take_wave`` never splits one), so every quorum cert's signatures
    ride a single engine call and no cert ever mixes engines.  Per-wave
    group composition is booked through ``groups_metrics`` (a
    :class:`~consensus_tpu_torch.metrics.MetricsGroups` bundle: one
    ``groups_wave_span`` observation per launch, plus the multi-group
    counter when a launch spans two or more groups) and surfaced raw via
    ``on_group_wave(group_counts, total)``.
    """

    def __init__(
        self,
        engine,
        *,
        window: float = 0.005,
        max_wave: int = 8192,
        tenant_queue_limit: int = 4096,
        on_wave: Optional[Callable[[dict, int], None]] = None,
        on_group_wave: Optional[Callable[[dict, int], None]] = None,
        groups_metrics=None,
        wait_timeout: float = 300.0,
        name: str = "verify-waves",
    ) -> None:
        self._engine = engine
        self._window = window
        self._max_wave = max(1, max_wave)
        # Early-flush point: the engine's slice-filling wave size on mesh
        # engines, the plain cap otherwise (see _slice_wave_target).
        self._wave_target = _slice_wave_target(engine, self._max_wave)
        self._tenant_queue_limit = max(1, tenant_queue_limit)
        self._on_wave = on_wave
        self._on_group_wave = on_group_wave
        self._groups_metrics = groups_metrics
        self._wait_timeout = wait_timeout
        self._cv = threading.Condition()
        self._queues: dict[str, list[_TenantPending]] = {}
        self._rr: list[str] = []
        self._count = 0
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True, name=name)
        self._thread.start()

    @staticmethod
    def _admission_key(tenant: str, group: Optional[str]) -> str:
        """The queue/fair-share identity: the tenant alone (sidecar mode),
        or (group, tenant) under consensus sharding — a group's replicas
        never contend on another group's admission budget."""
        return tenant if group is None else f"{group}\x1f{tenant}"

    def queue_depth(self, tenant: str, group: Optional[str] = None) -> int:
        """Signatures currently queued for ``tenant`` (within ``group``
        when the group id is part of the admission identity)."""
        key = self._admission_key(tenant, group)
        with self._cv:
            return sum(len(i.messages) for i in self._queues.get(key, ()))

    @property
    def pending_count(self) -> int:
        return self._count

    def submit(
        self, tenant: str, messages, signatures, public_keys,
        *, group: Optional[str] = None,
    ) -> np.ndarray:
        """Queue one tenant submission and block until its wave lands.
        Raises :class:`AdmissionReject` when the tenant's queue is full.
        ``group`` joins the admission identity under consensus sharding —
        the submission stays whole either way (SAFETY §7)."""
        n = len(messages)
        if not (n == len(signatures) == len(public_keys)):
            raise ValueError("batch length mismatch")
        if n == 0:
            return np.zeros(0, dtype=bool)
        key = self._admission_key(tenant, group)
        with self._cv:
            if self._closed:
                raise RuntimeError("wave former is closed")
            depth = sum(len(i.messages) for i in self._queues.get(key, ()))
            if depth + n > self._tenant_queue_limit:
                raise AdmissionReject(key, depth, self._tenant_queue_limit)
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = []
                self._rr.append(key)
            item = _TenantPending(
                tenant, list(messages), list(signatures), list(public_keys),
                group=group,
            )
            q.append(item)
            self._count += n
            self._cv.notify_all()
        if not item.done.wait(timeout=self._wait_timeout):
            raise RuntimeError(
                f"verify wave did not complete within {self._wait_timeout}s "
                "(wedged device?)"
            )
        if item.error is not None:
            raise RuntimeError(
                f"coalesced verify wave failed: {item.error!r}"
            ) from item.error
        return item.result

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=self._wait_timeout)
        if self._thread.is_alive():
            logger.error(
                "wave former thread did not exit within %.1fs (wedged device?)",
                self._wait_timeout,
            )

    # -- wave thread -------------------------------------------------------

    def _take_wave(self) -> list[_TenantPending]:
        """Pop whole submissions round-robin across tenant queues up to
        ``max_wave`` signatures, then advance the rotation so the next wave
        starts with a different tenant."""
        taken: list[_TenantPending] = []
        total = 0
        progress = True
        while progress and total < self._max_wave:
            progress = False
            for tenant in self._rr:
                q = self._queues.get(tenant)
                if not q:
                    continue
                nxt = len(q[0].messages)
                if taken and total + nxt > self._max_wave:
                    continue
                taken.append(q.pop(0))
                total += nxt
                progress = True
        if self._rr:
            self._rr.append(self._rr.pop(0))
        self._count -= total
        return taken

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._count and not self._closed:
                    self._cv.wait()
                if not self._count and self._closed:
                    return
                # Real-thread deadline: wave closes at first-pending + window
                # or the size cap, whichever fires first.
                deadline = time.monotonic() + self._window  # wallclock-ok
                while self._count < self._wave_target and not self._closed:
                    remaining = deadline - time.monotonic()  # wallclock-ok
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                wave = self._take_wave()
            if not wave:
                continue
            messages: list = []
            signatures: list = []
            keys: list = []
            for item in wave:
                messages.extend(item.messages)
                signatures.extend(item.signatures)
                keys.extend(item.keys)
            try:
                results = np.asarray(
                    self._engine.verify_batch(messages, signatures, keys)
                )
                slices = _split_results(results, [len(i.messages) for i in wave])
            except BaseException as exc:
                for item in wave:
                    item.error = exc
                    item.done.set()
                continue
            if self._on_wave is not None:
                tenant_counts: dict[str, int] = {}
                for item in wave:
                    tenant_counts[item.tenant] = (
                        tenant_counts.get(item.tenant, 0) + len(item.messages)
                    )
                try:
                    self._on_wave(tenant_counts, len(messages))
                except Exception:
                    logger.exception("on_wave hook failed (ignored)")
            group_counts: dict[str, int] = {}
            for item in wave:
                if item.group is not None:
                    group_counts[item.group] = (
                        group_counts.get(item.group, 0) + len(item.messages)
                    )
            if group_counts and self._groups_metrics is not None:
                self._groups_metrics.wave_span.observe(float(len(group_counts)))
                if len(group_counts) >= 2:
                    self._groups_metrics.count_wave_multi_group.add(1)
            if group_counts and self._on_group_wave is not None:
                try:
                    self._on_group_wave(group_counts, len(messages))
                except Exception:
                    logger.exception("on_group_wave hook failed (ignored)")
            for item, piece in zip(wave, slices):
                item.result = piece
                item.done.set()


__all__ = [
    "AdmissionReject",
    "BatchCoalescer",
    "FairShareWaveFormer",
    "ThreadCoalescingVerifier",
]
