"""Open-loop trace replay against an admission layer + sidecar fleet.

OPEN-LOOP means arrivals are scheduled from the trace alone — a slow or
rejecting fleet never back-pressures the arrival process, which is exactly
how a million independent clients behave (they do not politely wait for
each other's completions).  Closed-loop load generators hide collapse;
this driver is built to expose it: it records offered vs admitted vs
committed load separately, plus commit-latency percentiles on the sim
clock, and feeds per-sample ingress health to the obs
:class:`~consensus_tpu_torch.obs.detectors.DetectorBank` so
``admission_overload`` and ``dedup_storm`` fire on the same edge-triggered
contract as the cluster detectors.

Two fleet backends:

* :class:`SimSidecarFleet` — N simulated verify servers on the shared
  SimScheduler (bounded queues, deterministic service times).  The whole
  replay is a pure function of (trace, config): ``summary_json()`` is
  byte-identical per seed.
* a real :class:`~consensus_tpu_torch.net.sidecar.VerifySidecarServer` fleet —
  reached through :class:`~consensus_tpu_torch.ingress.placement.SidecarFleet`
  and the client's structured reroute path; exercised by the integration
  tests rather than this driver (real sockets live on wall-clock threads).

The PyTorch port's copy of ``consensus_tpu/ingress/driver.py``, its imports renamed.
"""

from __future__ import annotations

import json
from typing import Optional

from consensus_tpu_torch.ingress.admission import AdmissionController
from consensus_tpu_torch.ingress.placement import PlacementRing
from consensus_tpu_torch.ingress.workload import TraceEvent, WorkloadSpec
from consensus_tpu_torch.metrics import InMemoryProvider, Metrics
from consensus_tpu_torch.obs.detectors import DetectorBank, DetectorThresholds
from consensus_tpu_torch.runtime.scheduler import SimScheduler


def _percentile(sorted_values: list, q: float) -> float:
    """Nearest-rank percentile over an already-sorted list (0 when empty)."""
    if not sorted_values:
        return 0.0
    rank = max(0, min(len(sorted_values) - 1,
                      int(round(q * (len(sorted_values) - 1)))))
    return sorted_values[rank]


class _SimServer:
    """One simulated verify server: a bounded FIFO with deterministic
    service times on the shared sim clock."""

    __slots__ = ("server_id", "depth", "busy_until", "accepted", "rejected")

    def __init__(self, server_id: str) -> None:
        self.server_id = server_id
        self.depth = 0
        self.busy_until = 0.0
        self.accepted = 0
        self.rejected = 0


class SimSidecarFleet:
    """N simulated sidecar servers behind rendezvous placement.

    ``service_rate`` is requests per sim-second per server at the reference
    size; larger requests take proportionally longer
    (``(1 + size/4096) / service_rate``).  ``queue_limit`` bounds each
    server's backlog — an enqueue past it is a structured admission reject,
    the sim twin of the real server's status-2
    ``TenantAdmissionReject``."""

    def __init__(
        self,
        scheduler: SimScheduler,
        server_ids,
        *,
        service_rate: float = 2000.0,
        queue_limit: int = 512,
    ) -> None:
        if len(server_ids) < 1:
            raise ValueError("fleet needs at least one server")
        self.scheduler = scheduler
        self.service_rate = service_rate
        self.queue_limit = queue_limit
        self.servers = {sid: _SimServer(sid) for sid in server_ids}

    def try_enqueue(self, server_id: str, event: TraceEvent, on_done) -> bool:
        """False = structured reject (queue full); True = accepted, with
        ``on_done(event, commit_time)`` scheduled at service completion."""
        srv = self.servers[server_id]
        if srv.depth >= self.queue_limit:
            srv.rejected += 1
            return False
        now = self.scheduler.now()
        service = (1.0 + event.size / 4096.0) / self.service_rate
        start = max(now, srv.busy_until)
        srv.busy_until = start + service
        srv.depth += 1
        srv.accepted += 1
        done_at = srv.busy_until

        def complete() -> None:
            srv.depth -= 1
            on_done(event, done_at)

        self.scheduler.call_later(
            done_at - now, complete, name=f"ingress svc {server_id}"
        )
        return True

    def total_depth(self) -> int:
        return sum(s.depth for s in self.servers.values())


class IngressDriver:
    """Replays one trace open-loop and reports the ledgered truth."""

    #: Sim-time allowed after the last arrival for queues to drain.
    DRAIN_BUDGET = 30.0

    def __init__(
        self,
        trace,
        spec: WorkloadSpec,
        *,
        seed: int = 0,
        servers: int = 4,
        scheduler: Optional[SimScheduler] = None,
        metrics: Optional[Metrics] = None,
        tracer=None,
        thresholds: Optional[DetectorThresholds] = None,
        sample_interval: float = 1.0,
        service_rate: float = 2000.0,
        queue_limit: int = 512,
        groups: int = 0,
    ) -> None:
        if servers < 1:
            raise ValueError("driver needs at least one fleet server")
        self.trace = tuple(trace)
        self.spec = spec
        self.seed = seed
        self.scheduler = scheduler or SimScheduler()
        self.metrics = metrics or Metrics(InMemoryProvider())
        self.tracer = tracer
        self.sample_interval = sample_interval
        self.server_ids = tuple(f"sidecar-{i}" for i in range(servers))
        self.ring = PlacementRing(self.server_ids)
        self.fleet = SimSidecarFleet(
            self.scheduler, self.server_ids,
            service_rate=service_rate, queue_limit=queue_limit,
        )
        self.admission = AdmissionController(
            rate=spec.admission_rate, burst=spec.admission_burst,
            metrics=self.metrics.ingress, tracer=tracer,
        )
        #: ``groups >= 1`` turns on consensus sharding: every ADMITTED
        #: request is also routed to its owning consensus group
        #: (admit-then-route — admission stays global so a flooder cannot
        #: escape its budget by hashing into a quiet group).  Off by
        #: default; summaries without groups stay byte-identical.
        self.group_router = None
        if groups:
            from consensus_tpu_torch.groups.directory import GroupDirectory
            from consensus_tpu_torch.groups.router import GroupRouter

            self.group_router = GroupRouter(
                GroupDirectory.of_size(groups),
                metrics=self.metrics.groups,
                tracer=tracer,
            )
        self.detectors = DetectorBank(thresholds)
        self.anomalies: list = []
        self.offered_honest = 0
        self.admitted_honest = 0
        self.committed = 0
        self.committed_honest = 0
        self.fleet_rejected = 0
        self.reroutes = 0
        self._latencies: list[float] = []
        self.metrics.ingress.fleet_size.set(float(servers))

    # -- per-event flow ----------------------------------------------------

    def _on_done(self, event: TraceEvent, commit_time: float) -> None:
        self.committed += 1
        if event.honest:
            self.committed_honest += 1
        latency = commit_time - event.t
        self._latencies.append(latency)
        self.metrics.ingress.commit_latency.observe(latency)

    def _arrive(self, event: TraceEvent) -> None:
        now = self.scheduler.now()
        if event.honest:
            self.offered_honest += 1
        outcome = self.admission.admit(now, event.info(), event.size)
        if outcome != "admitted":
            return
        if event.honest:
            self.admitted_honest += 1
        if self.group_router is not None:
            self.group_router.route(event.tenant)
        hops = 0
        for server_id in self.ring.candidates(event.tenant):
            if self.fleet.try_enqueue(server_id, event, self._on_done):
                if hops:
                    self.reroutes += hops
                    self.metrics.ingress.count_reroutes.add(hops)
                    tracer = self.tracer
                    if tracer is not None and tracer.enabled:
                        tracer.instant(
                            "ingress", "ingress.reroute",
                            tenant=event.tenant, dst=server_id, hops=hops,
                        )
                return
            hops += 1
        self.fleet_rejected += 1

    # -- sampling ----------------------------------------------------------

    def _sample(self) -> None:
        t = self.scheduler.now()
        health = dict(self.admission.health())
        health["ingress_fleet_depth"] = self.fleet.total_depth()
        for anomaly in self.detectors.evaluate(t, {0: health}):
            self.anomalies.append(anomaly)
            self.metrics.obs.anomaly_counter(anomaly.kind).add(1)
            tracer = self.tracer
            if tracer is not None and tracer.enabled:
                tracer.instant(
                    "obs", "obs.anomaly",
                    kind=anomaly.kind, node=anomaly.node,
                    detail=anomaly.detail,
                )

    # -- the run -----------------------------------------------------------

    def run(self) -> dict:
        sched = self.scheduler
        start = sched.now()
        for ev in self.trace:
            sched.call_later(
                max(0.0, start + ev.t - sched.now()),
                lambda e=ev: self._arrive(e),
                name="ingress arrival",
            )
        horizon = self.spec.duration + self.DRAIN_BUDGET
        ticks = int(horizon / self.sample_interval) + 1
        for i in range(1, ticks + 1):
            sched.call_later(
                i * self.sample_interval, self._sample, name="ingress sample"
            )
        sched.advance(horizon + self.sample_interval)
        return self.summary()

    def summary(self) -> dict:
        lat = sorted(self._latencies)
        counts: dict[str, int] = {}
        for a in self.anomalies:
            counts[a.kind] = counts.get(a.kind, 0) + 1
        adm = self.admission
        out = {
            "seed": self.seed,
            "clients": self.spec.clients,
            "servers": len(self.server_ids),
            "events": len(self.trace),
            "duration": self.spec.duration,
            "offered": adm.offered,
            "admitted": adm.admitted,
            "rate_limited": adm.rate_limited,
            "dedup_hits": adm.dedup_hits,
            "offered_honest": self.offered_honest,
            "admitted_honest": self.admitted_honest,
            "committed": self.committed,
            "committed_honest": self.committed_honest,
            "fleet_rejected": self.fleet_rejected,
            "reroutes": self.reroutes,
            "latency_p50": round(_percentile(lat, 0.50), 9),
            "latency_p90": round(_percentile(lat, 0.90), 9),
            "latency_p99": round(_percentile(lat, 0.99), 9),
            "anomalies": dict(sorted(counts.items())),
        }
        if self.group_router is not None:
            # Keys appear ONLY in groups mode so a non-sharded summary is
            # byte-identical to every pre-sharding run of the same seed.
            out["groups"] = len(self.group_router.directory)
            out["group_routed"] = self.group_router.counts()
        return out

    def summary_json(self) -> str:
        """Sorted-key JSON — the byte-identical same-seed artifact."""
        return json.dumps(self.summary(), sort_keys=True)


__all__ = ["IngressDriver", "SimSidecarFleet"]
