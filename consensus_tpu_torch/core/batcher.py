"""Batch builder: turns the request pool into leader proposals.

Parity: reference internal/bft/batcher.go:40-92.  The reference's
``NextBatch`` blocks its goroutine until the pool can fill a batch or the
batch timeout elapses; here the leader *asks* for a batch and gets a callback
— either immediately (pool already full enough), early (a submission tops the
pool up), or when ``request_batch_max_interval`` expires with whatever is
there.  This is the scheduler-driven design the reference left as a TODO
(reference internal/bft/batcher.go:46).

The PyTorch port's copy of ``consensus_tpu/core/batcher.py``, its imports renamed.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

from consensus_tpu_torch.core.pool import RequestPool
from consensus_tpu_torch.runtime.scheduler import Scheduler, TimerHandle
from consensus_tpu_torch.trace.tracer import NOOP_TRACER

logger = logging.getLogger("consensus_tpu_torch.batcher")


class Batcher:
    """Single-consumer batch source for the leader."""

    def __init__(
        self,
        scheduler: Scheduler,
        pool: RequestPool,
        *,
        batch_max_count: int,
        batch_max_bytes: int,
        batch_max_interval: float,
        tracer=None,
    ) -> None:
        self._sched = scheduler
        self._pool = pool
        self._max_count = batch_max_count
        self._max_bytes = batch_max_bytes
        self._max_interval = batch_max_interval
        self._pending_cb: Optional[Callable[[list[bytes]], None]] = None
        self._timer: Optional[TimerHandle] = None
        self._closed = False
        self._tracer = tracer if tracer is not None else NOOP_TRACER

    def next_batch(self, on_batch: Callable[[list[bytes]], None]) -> None:
        """Request the next batch; at most one outstanding request.

        ``on_batch`` fires with a possibly-empty list (empty only after
        ``close``).  Parity: reference batcher.go:40-63.
        """
        if self._pending_cb is not None:
            raise RuntimeError("a batch request is already outstanding")
        if self._closed:
            on_batch([])
            return
        if self._pool.available_count >= self._max_count:
            on_batch(self._take())
            return
        self._pending_cb = on_batch
        self._timer = self._sched.call_later(
            self._max_interval, self._interval_expired, name="batch-interval"
        )

    def pool_changed(self) -> None:
        """Pool notification hook: complete an outstanding request early once
        a full batch is available."""
        if self._pending_cb is None or self._closed:
            return
        if self._pool.available_count >= self._max_count:
            self._complete()

    def _interval_expired(self) -> None:
        if self._pending_cb is None or self._closed:
            return
        self._complete()

    def _complete(self) -> None:
        cb = self._pending_cb
        self._pending_cb = None
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        cb(self._take())

    def _take(self) -> list[bytes]:
        batch = self._pool.next_requests(self._max_count, self._max_bytes)
        if batch and self._tracer.enabled:
            self._tracer.instant("batcher", "batch.take", count=len(batch))
        return batch

    def cancel(self) -> None:
        """Abandon any outstanding request without calling back."""
        self._pending_cb = None
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def close(self) -> None:
        """Shut down: an outstanding request completes with an empty batch.

        Parity: reference batcher.go:66-78 (Close unblocks NextBatch).
        """
        self._closed = True
        cb = self._pending_cb
        self._pending_cb = None
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if cb is not None:
            cb([])

    def reset(self) -> None:
        """Reopen after a view change.  Parity: reference batcher.go:81-92."""
        self._closed = False

    @property
    def closed(self) -> bool:
        """Parity: reference batcher.go Closed()."""
        return self._closed


__all__ = ["Batcher"]
