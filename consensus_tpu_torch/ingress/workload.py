"""Seeded, open-loop client traces on the sim clock.

A trace is generated UP FRONT from one ``random.Random(seed)`` stream —
arrival times are absolute sim-times, so replaying the same seed yields a
byte-identical event sequence no matter how the consumer schedules it
(the same discipline as :class:`~consensus_tpu_torch.testing.chaos.ChaosSchedule`).

The population splits into HONEST clients and FLOOD clients:

* honest clients pace themselves inside the admission budget by
  construction — inter-arrival gaps are drawn uniform and never shorter
  than ``1 / (admission_rate * honest_rate)`` with ``honest_rate <= 1``,
  so a per-client token bucket refilling at ``admission_rate`` can never
  reject them.  That makes "admitted-honest == offered-honest" a testable
  non-starvation claim, not a tautology.
* flood clients offer a Poisson stream at ``flood_rate_x`` times the
  admission rate, optionally diurnally modulated (thinning against the
  peak rate), bursty (geometric back-to-back clumps), and tenant-skewed
  (a ``hot_tenant_bias`` fraction of flood arrivals pile onto tenant 0).

Duplicate-retry storms re-emit ALREADY-SENT flood requests
(``duplicate=True``) inside configured windows — the dedup cache's load,
distinct from fresh-request floods which are the token bucket's load.

Request sizes are heavy-tailed (bounded Pareto) for everyone.

The PyTorch port's copy of ``consensus_tpu/ingress/workload.py``, its imports renamed.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Iterable

from consensus_tpu_torch.types import RequestInfo


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One open-loop arrival, anchored to the sim clock."""

    t: float
    client: str
    tenant: str
    rid: int
    size: int
    honest: bool
    duplicate: bool = False

    def info(self) -> RequestInfo:
        return RequestInfo(client_id=self.client, request_id=str(self.rid))


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Trace-shape knobs; every field is deterministic input to the
    generator (no knob consults the clock or ambient RNG)."""

    clients: int = 1000
    tenants: int = 8
    duration: float = 30.0
    #: Reference admission budget, tokens per client per sim-second — the
    #: spec travels with the trace so driver and admission agree on it.
    admission_rate: float = 2.0
    admission_burst: float = 4.0
    #: Fraction of clients that are honest (paced inside the budget).
    honest_fraction: float = 0.9
    #: Honest offered rate as a fraction of ``admission_rate`` (<= 1).
    honest_rate: float = 0.5
    #: Flood offered rate as a multiple of ``admission_rate``.
    flood_rate_x: float = 6.0
    #: Bounded-Pareto request sizes: min, tail exponent, cap.
    size_min: int = 64
    size_alpha: float = 1.3
    size_cap: int = 16384
    #: 0..1 peak-to-trough modulation of flood arrivals over ``duration``.
    diurnal_amplitude: float = 0.0
    #: Probability a flood arrival extends into a 2-5 event burst clump.
    burstiness: float = 0.0
    #: 0..1: fraction of flood arrivals redirected to tenant 0.
    hot_tenant_bias: float = 0.0
    #: Duplicate-retry storm windows: ((t0, t1, rate_x), ...) — inside
    #: [t0, t1) each flood client re-emits already-sent requests as a
    #: Poisson stream at ``rate_x * admission_rate``.
    duplicate_storms: tuple = ()

    def validate(self) -> None:
        errors = []
        if self.clients < 1:
            errors.append("clients must be >= 1")
        if self.tenants < 1:
            errors.append("tenants must be >= 1")
        if self.duration <= 0:
            errors.append("duration must be positive")
        if self.admission_rate <= 0 or self.admission_burst < 1:
            errors.append("admission_rate > 0 and admission_burst >= 1 required")
        if not 0.0 <= self.honest_fraction <= 1.0:
            errors.append("honest_fraction must be in [0, 1]")
        if not 0.0 < self.honest_rate <= 1.0:
            errors.append("honest_rate must be in (0, 1]")
        if self.flood_rate_x <= 0:
            errors.append("flood_rate_x must be positive")
        if self.size_min < 1 or self.size_cap < self.size_min:
            errors.append("size_min >= 1 and size_cap >= size_min required")
        if self.size_alpha <= 0:
            errors.append("size_alpha must be positive")
        if not 0.0 <= self.diurnal_amplitude <= 1.0:
            errors.append("diurnal_amplitude must be in [0, 1]")
        if not 0.0 <= self.burstiness <= 1.0:
            errors.append("burstiness must be in [0, 1]")
        if not 0.0 <= self.hot_tenant_bias <= 1.0:
            errors.append("hot_tenant_bias must be in [0, 1]")
        for storm in self.duplicate_storms:
            t0, t1, rate_x = storm
            if not (0.0 <= t0 < t1 <= self.duration) or rate_x <= 0:
                errors.append(f"bad duplicate storm window {storm!r}")
        if errors:
            raise ValueError("; ".join(errors))


def clean_spec(**overrides) -> WorkloadSpec:
    """All-honest soak: every detector must stay silent on this."""
    base = dict(honest_fraction=1.0, flood_rate_x=1.0)
    base.update(overrides)
    return WorkloadSpec(**base)


def flood_spec(**overrides) -> WorkloadSpec:
    """Admission-overload scenario: a flood cohort far past its budget."""
    base = dict(
        honest_fraction=0.7, flood_rate_x=10.0,
        burstiness=0.3, hot_tenant_bias=0.5,
    )
    base.update(overrides)
    return WorkloadSpec(**base)


def duplicate_storm_spec(duration: float = 30.0, **overrides) -> WorkloadSpec:
    """Dedup-storm scenario: retry storms across the middle of the run."""
    base = dict(
        duration=duration,
        honest_fraction=0.7,
        flood_rate_x=2.0,
        duplicate_storms=(
            (duration * 0.3, duration * 0.8, 8.0),
        ),
    )
    base.update(overrides)
    return WorkloadSpec(**base)


def _pareto_size(rng: random.Random, spec: WorkloadSpec) -> int:
    u = 1.0 - rng.random()  # (0, 1]
    size = spec.size_min * u ** (-1.0 / spec.size_alpha)
    return int(min(size, spec.size_cap))


def _diurnal_keep(rng: random.Random, spec: WorkloadSpec, t: float) -> bool:
    """Thinning against the peak: keep an arrival with probability
    rate(t)/peak where rate(t) rides one sine period over the duration."""
    if spec.diurnal_amplitude <= 0.0:
        return True
    phase = math.sin(2.0 * math.pi * t / spec.duration)
    keep = (1.0 + spec.diurnal_amplitude * phase) / (
        1.0 + spec.diurnal_amplitude
    )
    return rng.random() < keep


def generate_trace(
    seed: int, spec: WorkloadSpec | None = None
) -> tuple[TraceEvent, ...]:
    """The full trace for ``seed``, sorted by arrival time (ties break on
    client id then rid, so the order is total and replay-stable)."""
    spec = spec or WorkloadSpec()
    spec.validate()
    rng = random.Random(seed ^ 0x1264E55)
    n_honest = int(round(spec.clients * spec.honest_fraction))
    events: list[TraceEvent] = []
    #: Per flood client: rids already emitted (the storm's replay pool).
    flood_history: dict[str, list[int]] = {}

    for idx in range(spec.clients):
        honest = idx < n_honest
        client = f"{'h' if honest else 'f'}{idx:06d}"
        tenant_i = idx % spec.tenants
        if honest:
            # Paced inside the budget BY CONSTRUCTION: gap >= 1/rate of the
            # admission bucket, so honest traffic can never be rate-limited.
            client_rate = spec.admission_rate * spec.honest_rate
            t = rng.uniform(0.0, 1.0 / client_rate)
            rid = 0
            while t < spec.duration:
                events.append(TraceEvent(
                    t=t, client=client, tenant=f"t{tenant_i}", rid=rid,
                    size=_pareto_size(rng, spec), honest=True,
                ))
                rid += 1
                t += rng.uniform(1.0, 2.0) / client_rate
        else:
            lam = spec.admission_rate * spec.flood_rate_x
            history = flood_history[client] = []
            t = rng.expovariate(lam)
            rid = 0
            while t < spec.duration:
                if _diurnal_keep(rng, spec, t):
                    if (spec.hot_tenant_bias
                            and rng.random() < spec.hot_tenant_bias):
                        tenant = "t0"
                    else:
                        tenant = f"t{tenant_i}"
                    burst = 1
                    if spec.burstiness and rng.random() < spec.burstiness:
                        burst += rng.randrange(1, 5)
                    for b in range(burst):
                        bt = t + b * 1e-4
                        if bt >= spec.duration:
                            break
                        events.append(TraceEvent(
                            t=bt, client=client, tenant=tenant, rid=rid,
                            size=_pareto_size(rng, spec), honest=False,
                        ))
                        history.append(rid)
                        rid += 1
                t += rng.expovariate(lam)

    # Duplicate-retry storms: flood clients re-offer ALREADY-SENT rids.
    for (t0, t1, rate_x) in spec.duplicate_storms:
        lam = spec.admission_rate * rate_x
        for client in sorted(flood_history):
            history = flood_history[client]
            tenant_i = int(client[1:]) % spec.tenants
            t = t0 + rng.expovariate(lam)
            while t < t1:
                prior = [r for r in history if r is not None]
                if prior:
                    events.append(TraceEvent(
                        t=t, client=client, tenant=f"t{tenant_i}",
                        rid=rng.choice(prior),
                        size=_pareto_size(rng, spec),
                        honest=False, duplicate=True,
                    ))
                t += rng.expovariate(lam)

    events.sort(key=lambda e: (e.t, e.client, e.rid))
    return tuple(events)


def honest_counts(events: Iterable[TraceEvent]) -> tuple[int, int]:
    """(honest events, flood+duplicate events) — summary bookkeeping."""
    honest = flood = 0
    for ev in events:
        if ev.honest:
            honest += 1
        else:
            flood += 1
    return honest, flood


__all__ = [
    "TraceEvent",
    "WorkloadSpec",
    "clean_spec",
    "duplicate_storm_spec",
    "flood_spec",
    "generate_trace",
    "honest_counts",
]
