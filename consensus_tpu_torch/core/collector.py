"""State collector: gathers StateTransferResponse votes until f+1 agree on a
(view, seq), or the collection window closes.

Parity: reference internal/bft/statecollector.go:18-148.  The reference
blocks the calling goroutine on ``CollectStateResponses`` with a timeout;
here collection is a window opened by ``begin`` and closed by either an
f+1 agreement or the ``collect_timeout`` timer — the result arrives via
callback on the replica loop.

The PyTorch port's copy of ``consensus_tpu/core/collector.py``, its imports renamed.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

from consensus_tpu_torch.runtime.scheduler import Scheduler, TimerHandle
from consensus_tpu_torch.utils.quorum import compute_quorum
from consensus_tpu_torch.wire import StateTransferResponse

logger = logging.getLogger("consensus_tpu_torch.collector")


class StateCollector:
    def __init__(
        self, scheduler: Scheduler, *, n: int, collect_timeout: float
    ) -> None:
        self._sched = scheduler
        self._n = n
        self._timeout = collect_timeout
        _, self._f = compute_quorum(n)
        self._votes: dict[int, tuple[int, int]] = {}
        self._callback: Optional[Callable[[Optional[tuple[int, int]]], None]] = None
        self._timer: Optional[TimerHandle] = None

    def begin(self, on_result: Callable[[Optional[tuple[int, int]]], None]) -> None:
        """Open a collection window.  ``on_result`` receives the agreed
        (view, seq) or ``None`` on timeout.  A new ``begin`` supersedes any
        window still open (its callback gets ``None``)."""
        self._finish(None)
        self._votes = {}
        self._callback = on_result
        self._timer = self._sched.call_later(
            self._timeout, lambda: self._finish(None), name="state-collect-timeout"
        )

    def handle_response(self, sender: int, msg: StateTransferResponse) -> None:
        if self._callback is None:
            return  # no window open; late response
        self._votes[sender] = (msg.view_num, msg.sequence)
        counts: dict[tuple[int, int], int] = {}
        for vote in self._votes.values():
            counts[vote] = counts.get(vote, 0) + 1
        for vote, count in counts.items():
            if count >= self._f + 1:
                logger.debug("state agreement: view=%d seq=%d (%d votes)", *vote, count)
                self._finish(vote)
                return

    def _finish(self, result) -> None:
        cb = self._callback
        if cb is None:
            return
        self._callback = None
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        cb(result)

    def close(self) -> None:
        self._finish(None)


__all__ = ["StateCollector"]
