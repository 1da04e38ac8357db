"""Ingress hardening ahead of pool insertion: rate limiting + dedup.

Two layers, both deterministic functions of the injected clock:

* :class:`TokenBucket` — per-client refill at ``rate`` tokens per
  sim-second up to ``burst``; a client inside its budget is never touched
  by any other client's traffic (the non-censorship argument,
  SAFETY.md §11).
* :class:`DedupCache` — bounded LRU over ``RequestInfo.key()`` (client id
  AND request id — a flooding client cannot pre-insert another client's
  future request ids, so dedup can absorb retry storms without giving
  anyone a censorship lever).

:class:`AdmissionController` composes them — dedup FIRST, so a client's
own retries don't drain its token budget — and triple-books every decision
the established way: pinned ``ingress_*`` counters
(:data:`~consensus_tpu_torch.metrics.PINNED_METRIC_KEYS`), ``ingress.<outcome>``
trace instants, and cumulative stats the obs detectors
(``admission_overload`` / ``dedup_storm``) read through health snapshots.

The PyTorch port's copy of ``consensus_tpu/ingress/admission.py``, its imports renamed.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from consensus_tpu_torch.types import RequestInfo

#: The three admission outcomes, in the order summaries report them.
ADMISSION_OUTCOMES = ("admitted", "rate_limited", "duplicate")


class TokenBucket:
    """Classic token bucket on an injected clock (no wall-clock reads)."""

    __slots__ = ("rate", "burst", "tokens", "_last")

    def __init__(self, rate: float, burst: float) -> None:
        if rate <= 0 or burst < 1:
            raise ValueError("token bucket needs rate > 0 and burst >= 1")
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self._last: Optional[float] = None

    def allow(self, now: float, cost: float = 1.0) -> bool:
        if self._last is not None and now > self._last:
            self.tokens = min(
                self.burst, self.tokens + (now - self._last) * self.rate
            )
        self._last = max(now, self._last or now)
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


class DedupCache:
    """Bounded seen-request LRU keyed on the FULL RequestInfo."""

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError("dedup capacity must be >= 1")
        self.capacity = capacity
        self._seen: OrderedDict[str, None] = OrderedDict()

    def seen(self, info: RequestInfo) -> bool:
        """True if ``info`` was already admitted recently; records it (and
        refreshes its recency) either way."""
        key = info.key()
        hit = key in self._seen
        if hit:
            self._seen.move_to_end(key)
        else:
            self._seen[key] = None
            while len(self._seen) > self.capacity:
                self._seen.popitem(last=False)
        return hit

    def __len__(self) -> int:
        return len(self._seen)


class AdmissionController:
    """Per-client token buckets + one shared dedup cache.

    ``rate``/``burst`` apply per client id (buckets are created lazily);
    ``dedup_capacity`` bounds the shared LRU.  ``metrics`` is a
    :class:`~consensus_tpu_torch.metrics.MetricsIngress` bundle (or None).
    """

    def __init__(
        self,
        *,
        rate: float = 2.0,
        burst: float = 4.0,
        dedup_capacity: int = 65536,
        metrics=None,
        tracer=None,
    ) -> None:
        self.rate = rate
        self.burst = burst
        self.dedup = DedupCache(dedup_capacity)
        self.metrics = metrics
        self.tracer = tracer
        self._buckets: dict[str, TokenBucket] = {}
        self.offered = 0
        self.admitted = 0
        self.rate_limited = 0
        self.dedup_hits = 0

    def bucket(self, client_id: str) -> TokenBucket:
        b = self._buckets.get(client_id)
        if b is None:
            b = self._buckets[client_id] = TokenBucket(self.rate, self.burst)
        return b

    def admit(self, now: float, info: RequestInfo, size: int = 1) -> str:
        """One admission decision: ``"admitted"`` / ``"rate_limited"`` /
        ``"duplicate"``.  Dedup runs BEFORE the bucket so a client's own
        retry storm is absorbed without draining its token budget."""
        self.offered += 1
        if self.dedup.seen(info):
            self.dedup_hits += 1
            outcome = "duplicate"
        elif not self.bucket(info.client_id).allow(now):
            self.rate_limited += 1
            outcome = "rate_limited"
        else:
            self.admitted += 1
            outcome = "admitted"
        m = self.metrics
        if m is not None:
            m.count_offered.add(1)
            if outcome == "admitted":
                m.count_admitted.add(1)
            elif outcome == "rate_limited":
                m.count_rate_limited.add(1)
            else:
                m.count_dedup_hits.add(1)
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            tracer.instant(
                "ingress", f"ingress.{outcome}",
                client=info.client_id, request=info.request_id, size=size,
            )
        return outcome

    def health(self) -> dict:
        """Cumulative ingress counters in the health-snapshot shape the
        ``admission_overload`` / ``dedup_storm`` detectors read (absent
        fields keep cluster-only samples silent)."""
        return {
            "running": True,
            "ingress_offered": self.offered,
            "ingress_admitted": self.admitted,
            "ingress_rate_limited": self.rate_limited,
            "ingress_dedup_hits": self.dedup_hits,
        }


__all__ = [
    "ADMISSION_OUTCOMES",
    "AdmissionController",
    "DedupCache",
    "TokenBucket",
]
