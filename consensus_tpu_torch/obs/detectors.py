"""Anomaly detectors evaluated at sample time.

Each detector is a pure function of the health/metrics series the sampler
accumulates — no wall clock, no randomness — so the anomaly stream of a
fixed-seed run is byte-identical across replays.  Detectors are
EDGE-TRIGGERED: a condition fires once at onset and re-arms only after the
condition clears, so a 300-second stall is one anomaly, not 300.

The thirteen kinds (pinned metric names: metrics.OBS_ANOMALY_KEYS):

``commit_stall``        a running node has pending pool work but its ledger
                        has not grown for ``stall_window`` sim-seconds
``view_change_storm``   the node's view number advanced ``storm_views``+
                        times within ``storm_window``
``leader_flap``         the node's leader identity changed ``flap_changes``+
                        times within ``flap_window``
``sync_lag``            the node's ledger is ``lag_decisions``+ behind the
                        tallest RUNNING peer
``verify_collapse``     the ledger grew ``collapse_decisions``+ while the
                        node's ``consensus_verify_launches`` counter stayed
                        flat — decisions are appearing without commit-path
                        verification work (e.g. a sync catch-up burst, or a
                        verifier wedge)
``membership_churn``    the node's membership epoch advanced
                        ``churn_epochs``+ times within ``churn_window`` —
                        reconfigurations landing faster than a healthy
                        administrative cadence (an elastic-membership run
                        gone thrashy, or an adversary replaying admin
                        traffic)
``admission_overload`` between two samples, the ingress admission layer
                        rate-limited ``overload_reject_fraction``+ of at
                        least ``overload_min_offered`` offered requests —
                        sustained demand past the per-client budgets
``dedup_storm``         between two samples, ``dedup_hit_fraction``+ of at
                        least ``dedup_min_offered`` offered requests were
                        duplicates — a retry storm landing on the dedup
                        cache
``engine_degraded``     the node's supervised verify engine is serving
                        below its configured ladder rung (a fault-classed
                        breaker opened — models/supervisor.py); clears when
                        the supervisor re-promotes to rung 0
``wal_corruption``      the node quarantined a corrupt WAL suffix (boot or
                        scrub detection) and is fenced as a non-voting
                        learner until verified sync carries it past the
                        damage (wal/scrub.py, core/controller.py); clears
                        when the fence releases
``wal_stall``           the node's WAL refuses appends — the fsync retry
                        cap was hit or a write failed (ENOSPC) — so the
                        node stopped proposing/voting while still serving
                        sync and reads; clears when an append/probe fsync
                        succeeds
``cross_group_stall``   a cross-group atomic (2PC) transaction has been
                        unresolved — prepared but neither committed nor
                        aborted everywhere — for
                        ``cross_group_stall_window`` sim-seconds (fed by
                        the groups harness via the optional
                        ``groups_twopc_oldest_age`` health field); clears
                        when the oldest in-flight transaction resolves
``wire_abuse``          the node's listener guard (net/framing.py) booked
                        ``wire_abuse_events``+ NEW defense events —
                        malformed-frame strikes, handshake timeouts, bans,
                        quota rejects — since the last sample (fed via the
                        optional ``net_malformed`` / ``net_handshake_timeouts``
                        / ``net_peer_bans`` / ``net_conn_rejected`` health
                        fields a ``wire_guard``-carrying node reports);
                        clears on the first sample with no new events

The two ingress detectors read OPTIONAL health fields
(``ingress_offered`` / ``ingress_rate_limited`` / ``ingress_dedup_hits``,
fed by ingress/driver.py), ``engine_degraded`` reads the optional
``engine_degraded`` / ``engine_rung`` fields (fed only when a node carries
an ``engine_supervisor``), and the two wal detectors read the optional
``wal_fenced`` / ``wal_degraded`` fields (fed only for file-backed WALs);
samples without them, so every pre-existing fixed-seed anomaly stream, are
untouched.

The PyTorch port's copy of ``consensus_tpu/obs/detectors.py``, its imports renamed.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

ANOMALY_KINDS = (
    "commit_stall",
    "view_change_storm",
    "leader_flap",
    "sync_lag",
    "verify_collapse",
    "membership_churn",
    "admission_overload",
    "dedup_storm",
    "engine_degraded",
    "wal_corruption",
    "wal_stall",
    "cross_group_stall",
    "wire_abuse",
)


@dataclasses.dataclass(frozen=True)
class DetectorThresholds:
    """Tuning knobs, all in sim-seconds / decision counts."""

    stall_window: float = 30.0
    storm_views: int = 3
    storm_window: float = 60.0
    flap_changes: int = 3
    flap_window: float = 60.0
    lag_decisions: int = 5
    collapse_decisions: int = 3
    churn_epochs: int = 2
    churn_window: float = 120.0
    overload_min_offered: int = 20
    overload_reject_fraction: float = 0.5
    dedup_min_offered: int = 20
    dedup_hit_fraction: float = 0.5
    cross_group_stall_window: float = 60.0
    wire_abuse_events: int = 1

    def validate(self) -> None:
        if self.stall_window <= 0 or self.storm_window <= 0 or self.flap_window <= 0:
            raise ValueError("detector windows must be positive")
        if self.churn_window <= 0 or self.cross_group_stall_window <= 0:
            raise ValueError("detector windows must be positive")
        if min(self.storm_views, self.flap_changes,
               self.lag_decisions, self.collapse_decisions,
               self.churn_epochs) < 1:
            raise ValueError("detector counts must be >= 1")
        if min(self.overload_min_offered, self.dedup_min_offered,
               self.wire_abuse_events) < 1:
            raise ValueError("detector counts must be >= 1")
        if not (0.0 < self.overload_reject_fraction <= 1.0
                and 0.0 < self.dedup_hit_fraction <= 1.0):
            raise ValueError("detector fractions must be in (0, 1]")


@dataclasses.dataclass(frozen=True)
class Anomaly:
    """One detector firing, pinned to the sim clock."""

    kind: str
    node: int
    sim_time: float
    detail: str

    def as_dict(self) -> dict:
        return {
            "kind": self.kind,
            "node": self.node,
            "t": self.sim_time,
            "detail": self.detail,
        }


class _NodeState:
    """Per-node detector memory between samples."""

    __slots__ = (
        "stall_since", "last_ledger", "view_changes", "leader_changes",
        "last_view", "last_leader", "collapse_base",
        "epoch_changes", "last_epoch", "ingress_base", "wire_abuse_base",
    )

    def __init__(self) -> None:
        self.stall_since: Optional[float] = None
        self.last_ledger = 0
        self.view_changes: deque = deque()     # (t, view)
        self.leader_changes: deque = deque()   # (t, leader)
        self.last_view: Optional[int] = None
        self.last_leader: Optional[int] = None
        self.collapse_base: Optional[tuple[int, float]] = None  # (ledger, launches)
        self.epoch_changes: deque = deque()    # (t, epoch)
        self.last_epoch: Optional[int] = None
        #: Previous sample's cumulative (offered, rate_limited, dedup_hits)
        #: — the ingress detectors fire on PER-SAMPLE deltas.
        self.ingress_base: Optional[tuple[int, int, int]] = None
        #: Previous sample's cumulative listener-guard event total — the
        #: wire_abuse detector fires on PER-SAMPLE deltas.
        self.wire_abuse_base: Optional[int] = None


class DetectorBank:
    """Stateful evaluator: feed it one ``(t, {node: health}, {node: launches})``
    tuple per sample, get the anomalies that FIRED at that sample."""

    def __init__(self, thresholds: Optional[DetectorThresholds] = None) -> None:
        self.thresholds = thresholds or DetectorThresholds()
        self.thresholds.validate()
        self._nodes: dict[int, _NodeState] = {}
        #: (kind, node) pairs whose condition currently holds — the
        #: edge-trigger latch.
        self._active: set[tuple[str, int]] = set()

    def _state(self, nid: int) -> _NodeState:
        st = self._nodes.get(nid)
        if st is None:
            st = self._nodes[nid] = _NodeState()
        return st

    def _edge(self, fired: list, kind: str, nid: int, t: float,
              condition: bool, detail: str) -> None:
        key = (kind, nid)
        if condition:
            if key not in self._active:
                self._active.add(key)
                fired.append(Anomaly(kind=kind, node=nid, sim_time=t,
                                     detail=detail))
        else:
            self._active.discard(key)

    def evaluate(
        self,
        t: float,
        health: dict,
        launches: Optional[dict] = None,
    ) -> list[Anomaly]:
        """``health``: node id -> the sampler's health dict;
        ``launches``: node id -> cumulative ``consensus_verify_launches``
        (None / missing node skips the collapse detector)."""
        th = self.thresholds
        fired: list[Anomaly] = []
        for nid in sorted(health):
            h = health[nid]
            st = self._state(nid)
            running = h.get("running", False)
            ledger = h.get("ledger", 0)

            # --- commit stall ------------------------------------------
            if not running or h.get("pool", 0) <= 0 or ledger > st.last_ledger:
                st.stall_since = None
            elif st.stall_since is None:
                st.stall_since = t
            stalled = (
                st.stall_since is not None
                and t - st.stall_since >= th.stall_window
            )
            self._edge(
                fired, "commit_stall", nid, t, stalled,
                f"ledger stuck at {ledger} with pending pool work for "
                f">= {th.stall_window:g}s",
            )
            st.last_ledger = max(st.last_ledger, ledger)

            # --- view-change storm -------------------------------------
            view = h.get("view", -1)
            if running and view >= 0:
                if st.last_view is not None and view != st.last_view:
                    st.view_changes.append((t, view))
                st.last_view = view
            while st.view_changes and t - st.view_changes[0][0] > th.storm_window:
                st.view_changes.popleft()
            self._edge(
                fired, "view_change_storm", nid, t,
                len(st.view_changes) >= th.storm_views,
                f"{len(st.view_changes)} view changes within "
                f"{th.storm_window:g}s (now at view {view})",
            )

            # --- leader flap -------------------------------------------
            leader = h.get("leader", -1)
            if running and leader >= 0:
                if st.last_leader is not None and leader != st.last_leader:
                    st.leader_changes.append((t, leader))
                st.last_leader = leader
            while st.leader_changes and t - st.leader_changes[0][0] > th.flap_window:
                st.leader_changes.popleft()
            self._edge(
                fired, "leader_flap", nid, t,
                len(st.leader_changes) >= th.flap_changes,
                f"{len(st.leader_changes)} leader changes within "
                f"{th.flap_window:g}s (now following {leader})",
            )

            # --- sync-lag divergence -----------------------------------
            lag = h.get("sync_lag", 0)
            self._edge(
                fired, "sync_lag", nid, t, lag >= th.lag_decisions,
                f"{lag} decisions behind the tallest running peer",
            )

            # --- membership churn --------------------------------------
            epoch = h.get("epoch", -1)
            if running and epoch >= 0:
                if st.last_epoch is not None and epoch != st.last_epoch:
                    st.epoch_changes.append((t, epoch))
                st.last_epoch = epoch
            while st.epoch_changes and t - st.epoch_changes[0][0] > th.churn_window:
                st.epoch_changes.popleft()
            self._edge(
                fired, "membership_churn", nid, t,
                len(st.epoch_changes) >= th.churn_epochs,
                f"{len(st.epoch_changes)} membership epoch changes within "
                f"{th.churn_window:g}s (now serving epoch {epoch})",
            )

            # --- ingress: admission overload / dedup storm -------------
            offered = h.get("ingress_offered")
            if offered is None:
                # Not an ingress-plane sample: clear state + latches so
                # cluster health dicts keep their pre-ingress streams.
                st.ingress_base = None
                self._active.discard(("admission_overload", nid))
                self._active.discard(("dedup_storm", nid))
            else:
                limited = h.get("ingress_rate_limited", 0)
                dedup = h.get("ingress_dedup_hits", 0)
                if st.ingress_base is None:
                    st.ingress_base = (0, 0, 0)
                d_off = offered - st.ingress_base[0]
                d_lim = limited - st.ingress_base[1]
                d_dup = dedup - st.ingress_base[2]
                st.ingress_base = (offered, limited, dedup)
                overloaded = (
                    d_off >= th.overload_min_offered
                    and d_lim >= th.overload_reject_fraction * d_off
                )
                self._edge(
                    fired, "admission_overload", nid, t, overloaded,
                    f"rate-limited {d_lim}/{d_off} offered requests since "
                    "the last sample",
                )
                storming = (
                    d_off >= th.dedup_min_offered
                    and d_dup >= th.dedup_hit_fraction * d_off
                )
                self._edge(
                    fired, "dedup_storm", nid, t, storming,
                    f"dedup absorbed {d_dup}/{d_off} offered requests since "
                    "the last sample",
                )

            # --- engine degraded ---------------------------------------
            degraded = h.get("engine_degraded")
            if degraded is None:
                # No supervised engine on this node: discard the latch so
                # pre-supervision health streams stay byte-identical.
                self._active.discard(("engine_degraded", nid))
            else:
                self._edge(
                    fired, "engine_degraded", nid, t, bool(degraded),
                    f"supervised verify engine serving at rung "
                    f"{h.get('engine_rung', -1)} (below configured)",
                )

            # --- wal corruption (fenced learner) -----------------------
            fenced = h.get("wal_fenced")
            if fenced is None:
                # No file-backed WAL on this node: discard the latch so
                # pre-storage health streams stay byte-identical.
                self._active.discard(("wal_corruption", nid))
            else:
                self._edge(
                    fired, "wal_corruption", nid, t, bool(fenced),
                    "durable-state corruption quarantined; fenced as a "
                    "non-voting learner pending verified sync",
                )

            # --- wal stall (degraded append path) ----------------------
            wal_deg = h.get("wal_degraded")
            if wal_deg is None:
                self._active.discard(("wal_stall", nid))
            else:
                self._edge(
                    fired, "wal_stall", nid, t, bool(wal_deg),
                    "WAL refusing appends (fsync/append failures); node "
                    "stopped proposing and voting until the disk heals",
                )

            # --- cross-group 2PC stall ---------------------------------
            twopc_age = h.get("groups_twopc_oldest_age")
            if twopc_age is None:
                # Not a sharded-deployment sample: discard the latch so
                # pre-groups health streams stay byte-identical.
                self._active.discard(("cross_group_stall", nid))
            else:
                self._edge(
                    fired, "cross_group_stall", nid, t,
                    twopc_age >= th.cross_group_stall_window,
                    f"oldest cross-group transaction unresolved for "
                    f"{twopc_age:g}s (window {th.cross_group_stall_window:g}s)",
                )

            # --- wire abuse (listener guard deltas) --------------------
            malformed = h.get("net_malformed")
            if malformed is None:
                # No listener guard on this node: discard the latch so
                # pre-hardening health streams stay byte-identical.
                st.wire_abuse_base = None
                self._active.discard(("wire_abuse", nid))
            else:
                total = (
                    malformed
                    + h.get("net_handshake_timeouts", 0)
                    + h.get("net_peer_bans", 0)
                    + h.get("net_conn_rejected", 0)
                )
                if st.wire_abuse_base is None:
                    st.wire_abuse_base = 0
                delta = total - st.wire_abuse_base
                st.wire_abuse_base = total
                self._edge(
                    fired, "wire_abuse", nid, t,
                    delta >= th.wire_abuse_events,
                    f"listener guard booked {delta} abuse events since the "
                    f"last sample ({total} cumulative: {malformed} malformed, "
                    f"{h.get('net_peer_bans', 0)} bans)",
                )

            # --- verify-launch-rate collapse ---------------------------
            nl = (launches or {}).get(nid)
            if nl is None:
                st.collapse_base = None
                self._active.discard(("verify_collapse", nid))
            else:
                if st.collapse_base is None or nl > st.collapse_base[1]:
                    st.collapse_base = (ledger, nl)
                grown = ledger - st.collapse_base[0]
                self._edge(
                    fired, "verify_collapse", nid, t,
                    grown >= th.collapse_decisions,
                    f"ledger grew {grown} decisions with zero verify "
                    f"launches (counter flat at {nl:g})",
                )
        return fired


__all__ = [
    "ANOMALY_KINDS",
    "Anomaly",
    "DetectorBank",
    "DetectorThresholds",
]
