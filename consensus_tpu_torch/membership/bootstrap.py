"""Joining-node bootstrap: a ``LedgerSynchronizer`` run with retry/backoff.

A node admitted by a grow decision boots with an empty ledger and a WAL that
knows nothing; its catch-up is exactly the wire sync path (chunked fetch,
``f + 1`` honest-endorsement bar per decision — sync/client.py).  This class
drives that path to completion on the injected scheduler:

* attempts are spaced by exponential backoff (``initial_delay * backoff^k``,
  capped at ``max_delay``) so a join under heavy injected loss keeps retrying
  without hammering the network;
* when the membership EPOCH advances while the join is still running (the
  cluster reconfigured again mid-join), the peer set the synchronizer probes
  has changed — the backoff resets to ``initial_delay`` and the next probe
  goes out promptly instead of waiting out a delay computed against a stale
  membership;
* every attempt and every retry is counted into the pinned membership
  metrics (``membership_join_attempts`` / ``membership_join_retries``), so a
  wedged join is visible on the obs plane.

Everything runs on the scheduler — no wall clock, no threads — so a chaos
run containing a join replays byte-identically from its seed.

The PyTorch port's copy of ``consensus_tpu/membership/bootstrap.py``, its imports renamed.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

logger = logging.getLogger("consensus_tpu_torch.membership")


class JoinBootstrap:
    """Retry/backoff driver around a node's ``controller.sync()``.

    Callables (not objects) are injected because reconfiguration REBUILDS
    the controller: a captured bound method would go stale the moment the
    join itself succeeds.
    """

    def __init__(
        self,
        scheduler,
        *,
        sync: Callable[[], None],
        caught_up: Callable[[], bool],
        current_epoch: Optional[Callable[[], int]] = None,
        metrics=None,
        initial_delay: float = 2.0,
        max_delay: float = 60.0,
        backoff: float = 2.0,
    ) -> None:
        self._sched = scheduler
        self._sync = sync
        self._caught_up = caught_up
        self._current_epoch = current_epoch
        self._metrics = metrics
        self._initial_delay = initial_delay
        self._max_delay = max_delay
        self._backoff = backoff

        self.attempts = 0
        self.retries = 0
        self.done = False
        self._delay = initial_delay
        self._seen_epoch: Optional[int] = None
        self._timer = None

    def start(self) -> None:
        """Arm the first probe (immediately, on the next scheduler turn)."""
        if self._timer is None and not self.done:
            self._timer = self._sched.call_later(
                0.0, self._attempt, name="join-bootstrap"
            )

    def stop(self) -> None:
        self.done = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _attempt(self) -> None:
        self._timer = None
        if self.done:
            return
        if self._caught_up():
            self.done = True
            logger.info("join bootstrap complete after %d attempt(s)", self.attempts)
            return
        if self._current_epoch is not None:
            epoch = self._current_epoch()
            if self._seen_epoch is not None and epoch != self._seen_epoch:
                # The cluster reconfigured again mid-join: the peer set
                # changed under us — re-probe promptly against the new one.
                self._delay = self._initial_delay
            self._seen_epoch = epoch
        self.attempts += 1
        if self._metrics is not None:
            self._metrics.count_join_attempts.add(1)
        if self.attempts > 1:
            self.retries += 1
            if self._metrics is not None:
                self._metrics.count_join_retries.add(1)
        try:
            self._sync()
        except Exception:
            logger.exception("join bootstrap sync attempt failed; will retry")
        self._timer = self._sched.call_later(
            self._delay, self._attempt, name="join-bootstrap"
        )
        self._delay = min(self._delay * self._backoff, self._max_delay)


__all__ = ["JoinBootstrap"]
