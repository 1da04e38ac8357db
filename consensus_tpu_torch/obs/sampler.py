"""Sim-clock time-series sampler: the heart of the observability plane.

A :class:`ClusterSampler` re-arms itself on the cluster's scheduler
(``call_later`` every ``interval`` sim-seconds) and, at each tick, snapshots
every node into one sample record:

* ``metrics`` — the node's full ``Metrics.dump()`` (the sampler installs an
  ``InMemoryProvider``-backed bundle on any node that has none, so every
  node dumps);
* ``health`` — derived fields read straight off the live objects: current
  view, leader, in-progress sequence, in-flight pipeline depth, pool
  occupancy, WAL size and fsync count, ledger height, and sync lag versus
  the tallest running peer.

Samples land in a bounded ring (oldest overwritten) and are evaluated by the
anomaly :class:`~consensus_tpu_torch.obs.detectors.DetectorBank`; a firing bumps
the affected node's pinned ``obs_anomaly_*`` counter, emits an
``obs.anomaly`` trace instant, and is appended to :attr:`anomalies` (the
entry chaos runs assert on).

Everything reads — nothing writes protocol state — so sampling is
observationally transparent: a fixed-seed run produces byte-identical
ledgers and event logs with the plane on or off, and byte-identical sample
series across replays (enforced by tests/test_obs.py).

Hot-path contract (mirrors trace/tracer.py): the plane is DEFAULT OFF.  A
disabled cluster never constructs a sampler, never installs an in-memory
provider, and never takes a ring append — ``ClusterSampler.total_samples``
(class-level) is the guard counter the overhead test asserts stays flat.

The PyTorch port's copy of ``consensus_tpu/obs/sampler.py``, its imports renamed.
"""

from __future__ import annotations

from typing import Callable, Optional

from consensus_tpu_torch.metrics import InMemoryProvider, Metrics
from consensus_tpu_torch.obs.detectors import Anomaly, DetectorBank, DetectorThresholds
from consensus_tpu_torch.trace.tracer import NOOP_TRACER


class ClusterSampler:
    """Samples every node of a ``testing.app.Cluster`` (or anything
    duck-typed like one: ``scheduler``, ``nodes: {id: node}``) on a fixed
    sim-clock interval into a bounded ring."""

    #: Class-level count of ring appends across every sampler instance —
    #: the disabled-overhead guard snapshots this around a run.
    total_samples = 0

    def __init__(
        self,
        cluster,
        *,
        interval: float = 1.0,
        capacity: int = 4096,
        thresholds: Optional[DetectorThresholds] = None,
        tracer=None,
        install_metrics: bool = True,
    ) -> None:
        if interval <= 0:
            raise ValueError(f"sample interval must be positive, got {interval}")
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.cluster = cluster
        self.interval = interval
        self._capacity = capacity
        self._ring: list = [None] * capacity
        self._count = 0  # samples ever taken
        self._timer = None
        self._stopped = False
        self.detectors = DetectorBank(thresholds)
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        #: Every detector firing, in order.  Chaos runs assert on this.
        self.anomalies: list[Anomaly] = []
        #: ``fn(Anomaly)`` hooks called at fire time (the chaos engine logs
        #: through here so anomalies land in the deterministic event log).
        self.on_anomaly: list[Callable[[Anomaly], None]] = []
        if install_metrics:
            # Before cluster.start(): Node.start hands node.metrics to the
            # Consensus build, so every node must have a dumpable provider
            # by then.  Nodes that already carry a bundle keep it.
            for node in cluster.nodes.values():
                if getattr(node, "metrics", None) is None:
                    node.metrics = Metrics(InMemoryProvider())

    # --- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Arm the first tick (one full ``interval`` from now)."""
        self._stopped = False
        if self._timer is None:
            self._timer = self.cluster.scheduler.call_later(
                self.interval, self._tick, name="obs-sample"
            )

    def stop(self) -> None:
        self._stopped = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    # --- sampling ----------------------------------------------------------

    def _tick(self) -> None:
        self._timer = None
        if self._stopped:
            return
        self.sample_now()
        self._timer = self.cluster.scheduler.call_later(
            self.interval, self._tick, name="obs-sample"
        )

    def sample_now(self) -> dict:
        """Take one sample immediately (ticks call this; tests may too)."""
        t = self.cluster.scheduler.now()
        nodes = self.cluster.nodes
        max_height = max(
            (len(n.app.ledger) for n in nodes.values() if n.running),
            default=0,
        )
        health: dict[int, dict] = {}
        launches: dict[int, float] = {}
        node_records: dict[str, dict] = {}
        for nid in sorted(nodes):
            node = nodes[nid]
            h = self._node_health(node, max_height)
            health[nid] = h
            record: dict = {"health": h}
            provider = getattr(getattr(node, "metrics", None), "provider", None)
            if isinstance(provider, InMemoryProvider):
                record["metrics"] = provider.dump()
                inst = provider.instruments.get("consensus_verify_launches")
                if inst is not None:
                    launches[nid] = inst.value
                node.metrics.obs.count_samples.add(1)
            node_records[str(nid)] = record

        fired = self.detectors.evaluate(t, health, launches)
        for anomaly in fired:
            node = nodes.get(anomaly.node)
            metrics = getattr(node, "metrics", None)
            if metrics is not None:
                metrics.obs.anomaly_counter(anomaly.kind).add(1)
            if self.tracer.enabled:
                self.tracer.instant(
                    "obs", "obs.anomaly",
                    kind=anomaly.kind, node=anomaly.node,
                )
            self.anomalies.append(anomaly)
            for hook in self.on_anomaly:
                hook(anomaly)

        sample = {
            "t": round(t, 6),
            "i": self._count,
            "nodes": node_records,
            "anomalies": [a.as_dict() for a in fired],
        }
        self._ring[self._count % self._capacity] = sample
        self._count += 1
        ClusterSampler.total_samples += 1
        return sample

    def _node_health(self, node, max_height: int) -> dict:
        ledger = len(node.app.ledger)
        h = {
            "running": bool(node.running),
            "view": -1,
            "leader": -1,
            "seq": -1,
            "in_flight": 0,
            "syncing": False,
            "pool": 0,
            "wal_entries": -1,
            "wal_fsyncs": -1,
            "ledger": ledger,
            "sync_lag": max(0, max_height - ledger),
            "epoch": -1,
        }
        wal = getattr(node, "wal", None)
        entries = getattr(wal, "entries", None)
        if entries is not None:
            h["wal_entries"] = len(entries)
        fsyncs = getattr(wal, "fsync_count", None)
        if fsyncs is not None:
            h["wal_fsyncs"] = int(fsyncs)
        cons = getattr(node, "consensus", None)
        if node.running and cons is not None and cons.controller is not None:
            ch = cons.controller.health()
            h["view"] = int(ch["view"])
            h["leader"] = int(ch["leader"])
            h["seq"] = int(ch["seq"])
            h["in_flight"] = int(ch["in_flight"])
            h["syncing"] = bool(ch["syncing"])
            h["epoch"] = int(ch["epoch"])
            pool = getattr(cons, "pool", None)
            if pool is not None:
                h["pool"] = int(pool.count)
        # Optional supervision surface: only nodes carrying a supervised
        # engine report it, so pre-supervision samples stay byte-identical.
        sup = getattr(node, "engine_supervisor", None)
        if sup is not None:
            h["engine_degraded"] = bool(sup.degraded)
            h["engine_rung"] = int(sup.rung)
        # Optional durable-storage surface: only file-backed WALs carry a
        # degraded flag (MemWAL does not), so pre-storage samples stay
        # byte-identical.
        # Optional listener-guard surface: only nodes carrying a wire_guard
        # (hardened listeners, or the chaos net_abuse arm) report it, so
        # pre-hardening samples stay byte-identical.
        guard = getattr(node, "wire_guard", None)
        if guard is not None:
            stats = guard.stats
            h["net_malformed"] = int(stats.malformed)
            h["net_handshake_timeouts"] = int(stats.handshake_timeouts)
            h["net_peer_bans"] = int(stats.bans)
            h["net_conn_rejected"] = int(stats.rejected)
        wal_deg = getattr(wal, "degraded", None)
        if wal_deg is not None:
            h["wal_degraded"] = bool(wal_deg)
            fenced = False
            if node.running and cons is not None and cons.controller is not None:
                fenced = bool(cons.controller.health().get("fenced", False))
            h["wal_fenced"] = fenced
        return h

    # --- reads -------------------------------------------------------------

    def samples(self) -> list:
        """Surviving samples, oldest first (at most ``capacity``)."""
        n, cap = self._count, self._capacity
        if n <= cap:
            return [s for s in self._ring[:n]]
        cut = n % cap
        return self._ring[cut:] + self._ring[:cut]

    @property
    def taken(self) -> int:
        """Samples ever taken by this sampler."""
        return self._count

    def last_sample(self) -> Optional[dict]:
        if self._count == 0:
            return None
        return self._ring[(self._count - 1) % self._capacity]

    def latest_health(self) -> dict:
        """``{node id (str): health dict}`` from the most recent sample."""
        last = self.last_sample()
        if last is None:
            return {}
        return {nid: rec["health"] for nid, rec in last["nodes"].items()}

    def anomaly_counts(self) -> dict:
        """``{kind: total firings}``, only kinds that fired (sorted)."""
        counts: dict[str, int] = {}
        for a in self.anomalies:
            counts[a.kind] = counts.get(a.kind, 0) + 1
        return dict(sorted(counts.items()))


__all__ = ["ClusterSampler"]
