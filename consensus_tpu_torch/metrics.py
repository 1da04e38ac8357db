"""Metrics: provider abstraction, no-op and in-memory implementations, and
the five instrument bundles the protocol reports into.

Parity: reference pkg/metrics/provider.go:11-18 (Provider / Counter / Gauge /
Histogram), pkg/metrics/disabled/provider.go (no-op), and
pkg/api/metrics.go:70-578 (the 5 bundles / 28 instruments, same names).
An embedder passes its own Provider (e.g. Prometheus-backed) to the facade;
the default is no-op.

The PyTorch port's copy of ``consensus_tpu/metrics.py``: the same pinned
instrument names, help texts and bundles (the names
``tests/golden/obs_prometheus_3node.txt`` pins).
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence


#: Stable, documented instrument names for the latency-attribution pair the
#: tracer mirrors (see consensus_tpu/trace/): the decision tracer's
#: ``verify.launch`` instants carry the exact values this histogram observes,
#: and its ``wal.fsync`` instants carry the per-flush record counts behind
#: this gauge.  Tests and embedder dashboards key on these constants, not on
#: string literals, so a rename breaks loudly.
VERIFY_LAUNCH_BATCH_KEY = "consensus_cross_slot_verify_batch"
WAL_RECORDS_PER_FSYNC_KEY = "consensus_wal_records_per_fsync"

#: Pinned instrument names for INJECTED network adversary events (the chaos
#: engine's SimNetwork primitives: loss/mutate/filter drops, duplication,
#: reordering, stale replay — consensus_tpu/testing/network.py).  The
#: network tracer mirrors each as a ``net.<kind>`` instant; the parity test
#: (tests/test_trace.py) holds counter and instant streams equal.  Order
#: matches network.INJECTED_EVENT_KINDS.
NET_DROPPED_KEY = "net_injected_dropped"
NET_DUPLICATED_KEY = "net_injected_duplicated"
NET_REORDERED_KEY = "net_injected_reordered"
NET_REPLAYED_KEY = "net_injected_replayed"
NET_INJECTED_KEYS = (
    NET_DROPPED_KEY, NET_DUPLICATED_KEY, NET_REORDERED_KEY, NET_REPLAYED_KEY,
)

#: Pinned instrument names for the real TCP transport's reconnect path
#: (consensus_tpu/net/transport.py).  The Comm contract stays
#: fire-and-forget, but connection-refused and mid-frame abrupt-close now
#: get bounded retry with backoff + jitter before a frame is dropped —
#: these counters make that recovery visible per process so the deploy
#: rig's soak scraper can attribute chaos-induced churn.
NET_RECONNECT_ATTEMPTS_KEY = "net_reconnect_attempts"
NET_RECONNECT_SUCCESS_KEY = "net_reconnect_success"
NET_SEND_RETRIED_KEY = "net_send_retried"
NET_SEND_DROPPED_KEY = "net_send_dropped"
NET_RECONNECT_KEYS = (
    NET_RECONNECT_ATTEMPTS_KEY, NET_RECONNECT_SUCCESS_KEY,
    NET_SEND_RETRIED_KEY, NET_SEND_DROPPED_KEY,
)

#: Pinned instrument names for the listener-hardening layer
#: (consensus_tpu/net/framing.py): every guard defense event is
#: triple-booked — one of these counters, a ``net.abuse`` trace instant,
#: and the ``wire_abuse`` obs detector.  ``net_malformed_total`` carries a
#: ``kind`` label drawn from framing.MALFORMED_KINDS.
NET_MALFORMED_KEY = "net_malformed_total"
NET_HANDSHAKE_TIMEOUT_KEY = "net_handshake_timeout_total"
NET_PEER_BANNED_KEY = "net_peer_banned_total"
NET_CONN_REJECTED_KEY = "net_conn_rejected_total"
NET_ABUSE_KEYS = (
    NET_MALFORMED_KEY, NET_HANDSHAKE_TIMEOUT_KEY,
    NET_PEER_BANNED_KEY, NET_CONN_REJECTED_KEY,
)

#: Pinned instrument names for the observability plane (consensus_tpu/obs/).
#: One counter per anomaly detector — the sampler bumps the affected node's
#: counter the moment a detector fires (edge-triggered), mirrored by an
#: ``obs.anomaly`` trace instant — plus the total sample count.  The chaos
#: detector-soundness matrix asserts on these names.
OBS_SAMPLES_KEY = "obs_samples_total"
OBS_ANOMALY_COMMIT_STALL_KEY = "obs_anomaly_commit_stall"
OBS_ANOMALY_VIEW_CHANGE_STORM_KEY = "obs_anomaly_view_change_storm"
OBS_ANOMALY_LEADER_FLAP_KEY = "obs_anomaly_leader_flap"
OBS_ANOMALY_SYNC_LAG_KEY = "obs_anomaly_sync_lag"
OBS_ANOMALY_VERIFY_COLLAPSE_KEY = "obs_anomaly_verify_collapse"
OBS_ANOMALY_MEMBERSHIP_CHURN_KEY = "obs_anomaly_membership_churn"
OBS_ANOMALY_ADMISSION_OVERLOAD_KEY = "obs_anomaly_admission_overload"
OBS_ANOMALY_DEDUP_STORM_KEY = "obs_anomaly_dedup_storm"
OBS_ANOMALY_ENGINE_DEGRADED_KEY = "obs_anomaly_engine_degraded"
OBS_ANOMALY_WAL_CORRUPTION_KEY = "obs_anomaly_wal_corruption"
OBS_ANOMALY_WAL_STALL_KEY = "obs_anomaly_wal_stall"
OBS_ANOMALY_CROSS_GROUP_STALL_KEY = "obs_anomaly_cross_group_stall"
OBS_ANOMALY_WIRE_ABUSE_KEY = "obs_anomaly_wire_abuse"
OBS_ANOMALY_KEYS = (
    OBS_ANOMALY_COMMIT_STALL_KEY,
    OBS_ANOMALY_VIEW_CHANGE_STORM_KEY,
    OBS_ANOMALY_LEADER_FLAP_KEY,
    OBS_ANOMALY_SYNC_LAG_KEY,
    OBS_ANOMALY_VERIFY_COLLAPSE_KEY,
    OBS_ANOMALY_MEMBERSHIP_CHURN_KEY,
    OBS_ANOMALY_ADMISSION_OVERLOAD_KEY,
    OBS_ANOMALY_DEDUP_STORM_KEY,
    OBS_ANOMALY_ENGINE_DEGRADED_KEY,
    OBS_ANOMALY_WAL_CORRUPTION_KEY,
    OBS_ANOMALY_WAL_STALL_KEY,
    OBS_ANOMALY_CROSS_GROUP_STALL_KEY,
    OBS_ANOMALY_WIRE_ABUSE_KEY,
)

#: Pinned instrument names for durable-state self-healing (wal/scrub.py,
#: wal/log.py's degrade path, testing/storage.py's injected faults).  Every
#: storage-fault transition is triple-booked: one of these instruments, a
#: ``wal.*`` trace instant, and the ``wal_corruption`` / ``wal_stall`` obs
#: detectors.  The chaos matrix asserts EXACTLY ONE quarantine or degraded
#: transition per injected fault, keyed on these names.
WAL_FSYNC_RETRY_KEY = "wal_fsync_retry_total"
WAL_SCRUB_RUNS_KEY = "wal_scrub_runs_total"
WAL_SCRUB_RECORDS_KEY = "wal_scrub_records_total"
WAL_SCRUB_CORRUPTIONS_KEY = "wal_scrub_corruptions_total"
WAL_QUARANTINE_KEY = "wal_quarantine_total"
WAL_DEGRADED_KEY = "wal_degraded"
WAL_DEGRADED_TOTAL_KEY = "wal_degraded_total"
WAL_STORAGE_KEYS = (
    WAL_FSYNC_RETRY_KEY,
    WAL_SCRUB_RUNS_KEY,
    WAL_SCRUB_RECORDS_KEY,
    WAL_SCRUB_CORRUPTIONS_KEY,
    WAL_QUARANTINE_KEY,
    WAL_DEGRADED_KEY,
    WAL_DEGRADED_TOTAL_KEY,
)

#: Pinned instrument names for the membership-epoch subsystem
#: (consensus_tpu/membership/): the facade's epoch gauge and stale-epoch
#: ingress drops, and the joining-node bootstrap's attempt/retry counters.
MEMBERSHIP_EPOCH_KEY = "membership_epoch"
MEMBERSHIP_STALE_EPOCH_DROPPED_KEY = "membership_stale_epoch_dropped"
MEMBERSHIP_JOIN_ATTEMPTS_KEY = "membership_join_attempts"
MEMBERSHIP_JOIN_RETRIES_KEY = "membership_join_retries"
MEMBERSHIP_KEYS = (
    MEMBERSHIP_EPOCH_KEY,
    MEMBERSHIP_STALE_EPOCH_DROPPED_KEY,
    MEMBERSHIP_JOIN_ATTEMPTS_KEY,
    MEMBERSHIP_JOIN_RETRIES_KEY,
)

#: Pinned instrument names for the multi-tenant verification sidecar
#: (consensus_tpu/net/sidecar.py).  Admission control (bounded per-tenant
#: queues with structured rejects, never stalls) and cross-tenant wave
#: forming (many tenants' signatures coalesced into one mesh launch) each
#: get a counter; per-tenant series hang off these via ``with_labels``.
SIDECAR_ADMISSION_ACCEPTED_KEY = "sidecar_admission_accepted"
SIDECAR_ADMISSION_REJECTS_KEY = "sidecar_admission_rejects"
SIDECAR_ADMISSION_QUEUE_DEPTH_KEY = "sidecar_admission_queue_depth"
SIDECAR_WAVE_LAUNCHES_KEY = "sidecar_wave_launches"
SIDECAR_WAVE_SIGNATURES_KEY = "sidecar_wave_signatures"
SIDECAR_WAVE_TENANTS_KEY = "sidecar_wave_tenants"
SIDECAR_KEYS = (
    SIDECAR_ADMISSION_ACCEPTED_KEY,
    SIDECAR_ADMISSION_REJECTS_KEY,
    SIDECAR_ADMISSION_QUEUE_DEPTH_KEY,
    SIDECAR_WAVE_LAUNCHES_KEY,
    SIDECAR_WAVE_SIGNATURES_KEY,
    SIDECAR_WAVE_TENANTS_KEY,
)

#: Pinned instrument names for the ingress plane (consensus_tpu/ingress/):
#: the admission layer's offered/admitted/rate-limited/dedup accounting,
#: the placement fleet's size and structured-reject reroutes, and the
#: open-loop driver's commit latency.  Every admission decision is
#: triple-booked: one of these counters, an ``ingress.<outcome>`` trace
#: instant, and (through health snapshots) the ``admission_overload`` /
#: ``dedup_storm`` obs detectors.
INGRESS_OFFERED_KEY = "ingress_offered_total"
INGRESS_ADMITTED_KEY = "ingress_admitted_total"
INGRESS_RATE_LIMITED_KEY = "ingress_rate_limited_total"
INGRESS_DEDUP_HITS_KEY = "ingress_dedup_hits_total"
INGRESS_REROUTE_KEY = "ingress_reroute_total"
INGRESS_FLEET_SIZE_KEY = "ingress_fleet_size"
INGRESS_COMMIT_LATENCY_KEY = "ingress_commit_latency"
INGRESS_KEYS = (
    INGRESS_OFFERED_KEY,
    INGRESS_ADMITTED_KEY,
    INGRESS_RATE_LIMITED_KEY,
    INGRESS_DEDUP_HITS_KEY,
    INGRESS_REROUTE_KEY,
    INGRESS_FLEET_SIZE_KEY,
    INGRESS_COMMIT_LATENCY_KEY,
)

#: Pinned instrument names for half-aggregated quorum certs
#: (consensus_tpu/models/aggregate.py, Configuration.cert_mode).  The byte
#: counters account encoded cert-field bytes (wire/codec.py
#: ``encoded_cert_size``) at each surface a cert crosses — leader broadcast,
#: WAL persistence, sync catch-up — so the full-vs-half-agg compression
#: ratio is directly observable per path; the launch/bisection counters
#: expose the one-MSM-launch economy and its strict fallback.
WAL_CERT_BYTES_KEY = "wal_cert_bytes_total"
SYNC_CERT_BYTES_KEY = "sync_cert_bytes_total"
NET_CERT_BYTES_KEY = "net_cert_bytes_total"
CERT_BYTES_PER_CERT_KEY = "cert_bytes_per_cert"
CERT_AGGREGATE_LAUNCHES_KEY = "cert_aggregate_launches"
CERT_FALLBACK_BISECTIONS_KEY = "cert_fallback_bisections"
CERT_KEYS = (
    WAL_CERT_BYTES_KEY,
    SYNC_CERT_BYTES_KEY,
    NET_CERT_BYTES_KEY,
    CERT_BYTES_PER_CERT_KEY,
    CERT_AGGREGATE_LAUNCHES_KEY,
    CERT_FALLBACK_BISECTIONS_KEY,
)

#: Pinned instrument names for the engine supervision layer
#: (models/supervisor.py).  Every degrade/recover transition is booked into
#: one of these counters (and, where the embedder passes them, a trace
#: instant and a flight-recorder snapshot).  Per-fault-class degrade series are children of the pinned
#: degrade name (``with_labels(reason)`` -> ``engine_degrade_total{reason}``
#: in the in-memory provider), so the aggregate name stays stable for
#: dashboards while the chaos matrix can read one fault class out.
ENGINE_DEGRADE_KEY = "engine_degrade_total"
ENGINE_RECOVERED_KEY = "engine_recovered_total"
ENGINE_CROSSCHECK_KEY = "engine_crosscheck_total"
ENGINE_CROSSCHECK_MISMATCH_KEY = "engine_crosscheck_mismatch_total"
ENGINE_RUNG_KEY = "engine_rung"
ENGINE_COMPILE_CACHE_HITS_KEY = "engine_compile_cache_hits_total"
ENGINE_COMPILE_CACHE_MISSES_KEY = "engine_compile_cache_misses_total"
ENGINE_KEYS = (
    ENGINE_DEGRADE_KEY,
    ENGINE_RECOVERED_KEY,
    ENGINE_CROSSCHECK_KEY,
    ENGINE_CROSSCHECK_MISMATCH_KEY,
    ENGINE_RUNG_KEY,
    ENGINE_COMPILE_CACHE_HITS_KEY,
    ENGINE_COMPILE_CACHE_MISSES_KEY,
)

#: Consensus-sharding (groups) plane.  Fed by the ingress GroupRouter
#: (routed counter + directory-size gauge), the shared FairShareWaveFormer
#: (cross-GROUP wave-span histogram + multi-group launch counter), and the
#: cross-group 2PC coordinator/participants.  Aggregate names are pinned;
#: per-group series are ``with_labels(group)`` children.
GROUPS_ROUTED_KEY = "groups_routed_total"
GROUPS_COUNT_KEY = "groups_count"
GROUPS_WAVE_SPAN_KEY = "groups_wave_span"
GROUPS_WAVE_MULTI_KEY = "groups_wave_multi_group_total"
GROUPS_TWOPC_STARTED_KEY = "groups_twopc_started_total"
GROUPS_TWOPC_COMMITTED_KEY = "groups_twopc_committed_total"
GROUPS_TWOPC_ABORTED_KEY = "groups_twopc_aborted_total"
GROUPS_KEYS = (
    GROUPS_ROUTED_KEY,
    GROUPS_COUNT_KEY,
    GROUPS_WAVE_SPAN_KEY,
    GROUPS_WAVE_MULTI_KEY,
    GROUPS_TWOPC_STARTED_KEY,
    GROUPS_TWOPC_COMMITTED_KEY,
    GROUPS_TWOPC_ABORTED_KEY,
)

#: THE module-level registry of every pinned instrument name: key -> one-line
#: description.  Tests and embedder dashboards key on this mapping; every
#: name here is created by a fresh ``Metrics`` bundle (asserted by
#: tests/test_obs.py), so a rename or a bundle regression breaks loudly in
#: one place instead of silently stranding a dashboard.
PINNED_METRIC_KEYS: dict[str, str] = {
    VERIFY_LAUNCH_BATCH_KEY:
        "commit signatures drained per batched verify launch (histogram)",
    WAL_RECORDS_PER_FSYNC_KEY:
        "group-commit coalescing ratio: WAL records per fsync (gauge)",
    NET_DROPPED_KEY: "messages dropped by network injection",
    NET_DUPLICATED_KEY: "messages delivered twice by network injection",
    NET_REORDERED_KEY: "messages held back past later sends",
    NET_REPLAYED_KEY: "stale captured messages re-delivered",
    NET_RECONNECT_ATTEMPTS_KEY:
        "TCP peer (re)connect attempts (refused/reset peers retried with "
        "backoff + jitter)",
    NET_RECONNECT_SUCCESS_KEY:
        "TCP peer (re)connects that completed the HELLO handshake",
    NET_SEND_RETRIED_KEY:
        "frames re-sent after a mid-frame abrupt close (peer killed)",
    NET_SEND_DROPPED_KEY:
        "frames dropped after exhausting connect/send retries "
        "(fire-and-forget contract)",
    NET_MALFORMED_KEY:
        "provably-malformed inbound frames booked as strikes "
        "(kind label: oversized/bad_hello/pre_hello/sender_pin/stall/garbage)",
    NET_HANDSHAKE_TIMEOUT_KEY:
        "inbound connections dropped for never completing HELLO/HMAC "
        "within the handshake deadline",
    NET_PEER_BANNED_KEY:
        "peers temporarily banned after crossing the malformed-frame "
        "strike limit",
    NET_CONN_REJECTED_KEY:
        "inbound connections refused at accept (active ban or a "
        "per-peer/global quota full)",
    OBS_SAMPLES_KEY: "observability-plane samples taken",
    OBS_ANOMALY_COMMIT_STALL_KEY:
        "detector firings: pending work but no ledger growth",
    OBS_ANOMALY_VIEW_CHANGE_STORM_KEY:
        "detector firings: view number churning within the storm window",
    OBS_ANOMALY_LEADER_FLAP_KEY:
        "detector firings: leader identity churning within the flap window",
    OBS_ANOMALY_SYNC_LAG_KEY:
        "detector firings: ledger height diverging from the running peers",
    OBS_ANOMALY_VERIFY_COLLAPSE_KEY:
        "detector firings: ledger growth with zero verify launches",
    OBS_ANOMALY_MEMBERSHIP_CHURN_KEY:
        "detector firings: membership epoch churning within the churn window",
    OBS_ANOMALY_ADMISSION_OVERLOAD_KEY:
        "detector firings: admission rejecting a sustained fraction of "
        "offered ingress load",
    OBS_ANOMALY_DEDUP_STORM_KEY:
        "detector firings: dedup cache absorbing a duplicate-retry storm",
    OBS_ANOMALY_ENGINE_DEGRADED_KEY:
        "detector firings: a supervised verify engine running below its "
        "configured rung",
    OBS_ANOMALY_WAL_CORRUPTION_KEY:
        "detector firings: a replica quarantined corrupt WAL state or is "
        "fenced as a non-voting learner",
    OBS_ANOMALY_WAL_STALL_KEY:
        "detector firings: a replica's WAL stopped accepting appends "
        "(degraded: ENOSPC or fsync-retry cap)",
    OBS_ANOMALY_CROSS_GROUP_STALL_KEY:
        "detector firings: a cross-group atomic transaction stuck "
        "unresolved past the stall window",
    OBS_ANOMALY_WIRE_ABUSE_KEY:
        "detector firings: a listener booked new abuse events (malformed "
        "strikes, handshake timeouts, bans, quota rejects) since the last "
        "sample",
    WAL_FSYNC_RETRY_KEY:
        "group-commit fsync attempts that failed and were re-armed",
    WAL_SCRUB_RUNS_KEY:
        "background scrub passes over the WAL segment inventory",
    WAL_SCRUB_RECORDS_KEY:
        "records re-walked (CRC re-verified) by the background scrubber",
    WAL_SCRUB_CORRUPTIONS_KEY:
        "corruptions detected by the scrubber or at open/restore time",
    WAL_QUARANTINE_KEY:
        "corrupt WAL suffixes renamed aside (never deleted) preserving the "
        "intact prefix",
    WAL_DEGRADED_KEY:
        "whether the WAL is refusing appends (1 = degraded: ENOSPC or "
        "fsync-retry cap; gauge)",
    WAL_DEGRADED_TOTAL_KEY:
        "transitions into wal_degraded (append path unsatisfiable)",
    INGRESS_OFFERED_KEY:
        "client requests offered to the ingress admission layer",
    INGRESS_ADMITTED_KEY:
        "client requests admitted past rate limiting and dedup",
    INGRESS_RATE_LIMITED_KEY:
        "client requests rejected by the per-client token bucket",
    INGRESS_DEDUP_HITS_KEY:
        "duplicate client requests absorbed by the dedup cache",
    INGRESS_REROUTE_KEY:
        "admitted batches rerouted to the hash ring's next fleet candidate "
        "after a structured admission reject",
    INGRESS_FLEET_SIZE_KEY:
        "verifier fleet servers currently in the placement ring (gauge)",
    INGRESS_COMMIT_LATENCY_KEY:
        "sim-seconds from open-loop arrival to fleet commit (histogram)",
    MEMBERSHIP_EPOCH_KEY:
        "membership epoch this replica is serving (gauge)",
    MEMBERSHIP_STALE_EPOCH_DROPPED_KEY:
        "inbound messages dropped at ingress for carrying another epoch",
    MEMBERSHIP_JOIN_ATTEMPTS_KEY:
        "join-bootstrap sync attempts (first try included)",
    MEMBERSHIP_JOIN_RETRIES_KEY:
        "join-bootstrap sync retries (attempts after the first)",
    SIDECAR_ADMISSION_ACCEPTED_KEY:
        "sidecar verification batches admitted to a tenant queue",
    SIDECAR_ADMISSION_REJECTS_KEY:
        "sidecar batches rejected at admission (tenant queue full)",
    SIDECAR_ADMISSION_QUEUE_DEPTH_KEY:
        "signatures queued across tenant queues at last admission (gauge)",
    SIDECAR_WAVE_LAUNCHES_KEY:
        "cross-tenant waves launched on the sidecar engine",
    SIDECAR_WAVE_SIGNATURES_KEY:
        "signatures verified across all sidecar waves",
    SIDECAR_WAVE_TENANTS_KEY:
        "tenants sharing a wave, summed over waves (launches divides it)",
    WAL_CERT_BYTES_KEY:
        "encoded quorum-cert bytes persisted to the WAL",
    SYNC_CERT_BYTES_KEY:
        "encoded quorum-cert bytes received in sync catch-up chunks",
    NET_CERT_BYTES_KEY:
        "encoded quorum-cert bytes broadcast in pre-prepares",
    CERT_BYTES_PER_CERT_KEY:
        "encoded bytes per quorum cert assembled or received (histogram)",
    CERT_AGGREGATE_LAUNCHES_KEY:
        "half-aggregated cert checks (one MSM launch each)",
    CERT_FALLBACK_BISECTIONS_KEY:
        "cert aggregations abandoned to bisection + full-tuple fallback",
    ENGINE_DEGRADE_KEY:
        "supervised engine degrades down the ladder (per-reason children)",
    ENGINE_RECOVERED_KEY:
        "supervised engine re-promotions after a breaker re-closed",
    ENGINE_CROSSCHECK_KEY:
        "sampled host cross-checks run against device verdicts",
    ENGINE_CROSSCHECK_MISMATCH_KEY:
        "host cross-checks that contradicted the device verdict",
    ENGINE_RUNG_KEY:
        "current degrade-ladder rung (0 = as configured; gauge)",
    ENGINE_COMPILE_CACHE_HITS_KEY:
        "engine constructions that reused an already-traced kernel from "
        "the in-process compiled-kernel memo",
    ENGINE_COMPILE_CACHE_MISSES_KEY:
        "engine constructions that traced a kernel fresh (first build of "
        "that topology, or the memo disabled)",
    GROUPS_ROUTED_KEY:
        "admitted requests routed to their owning consensus group",
    GROUPS_COUNT_KEY:
        "consensus groups currently in the placement directory (gauge)",
    GROUPS_WAVE_SPAN_KEY:
        "distinct consensus groups sharing one fused verify launch "
        "(histogram)",
    GROUPS_WAVE_MULTI_KEY:
        "fused verify launches serving submissions from two or more groups",
    GROUPS_TWOPC_STARTED_KEY:
        "cross-group atomic transactions entering the prepare phase",
    GROUPS_TWOPC_COMMITTED_KEY:
        "cross-group atomic transactions decided commit by every group",
    GROUPS_TWOPC_ABORTED_KEY:
        "cross-group atomic transactions decided abort by every group",
}


class Counter(abc.ABC):
    @abc.abstractmethod
    def add(self, delta: float = 1.0) -> None: ...

    def with_labels(self, *values: str) -> "Counter":
        """Bind label values (embedder dimensions, e.g. channel).  Parity:
        reference pkg/metrics Counter.With."""
        return self


class Gauge(abc.ABC):
    @abc.abstractmethod
    def set(self, value: float) -> None: ...

    @abc.abstractmethod
    def add(self, delta: float = 1.0) -> None: ...

    def with_labels(self, *values: str) -> "Gauge":
        return self


class Histogram(abc.ABC):
    @abc.abstractmethod
    def observe(self, value: float) -> None: ...

    def with_labels(self, *values: str) -> "Histogram":
        return self


def extend_label_names(
    base: Sequence[str], extra: Sequence[str]
) -> tuple[str, ...]:
    """Embedder label names appended to an instrument's own, extras sorted —
    the reference applies the same merge to every bundle so embedders can add
    per-channel dimensions.  ``with_labels`` values must follow this sorted
    order (same contract as the reference's makeStatsdFormat, which sorts
    names before appending).  Parity: reference pkg/api/metrics.go:16-68
    (NewGaugeOpts / makeLabelNames / makeStatsdFormat)."""
    return tuple(base) + tuple(sorted(extra))


class Provider(abc.ABC):
    """Parity: reference pkg/metrics/provider.go:11-18."""

    @abc.abstractmethod
    def new_counter(
        self, name: str, help: str = "", label_names: Sequence[str] = ()
    ) -> Counter: ...

    @abc.abstractmethod
    def new_gauge(
        self, name: str, help: str = "", label_names: Sequence[str] = ()
    ) -> Gauge: ...

    @abc.abstractmethod
    def new_histogram(
        self, name: str, help: str = "", label_names: Sequence[str] = ()
    ) -> Histogram: ...


class _NoopInstrument(Counter, Gauge, Histogram):
    def add(self, delta: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass


class NoopProvider(Provider):
    """Parity: reference pkg/metrics/disabled/provider.go:13-17."""

    _instrument = _NoopInstrument()

    def new_counter(self, name, help="", label_names=()) -> Counter:
        return self._instrument

    def new_gauge(self, name, help="", label_names=()) -> Gauge:
        return self._instrument

    def new_histogram(self, name, help="", label_names=()) -> Histogram:
        return self._instrument


class _MemInstrument(Counter, Gauge, Histogram):
    def __init__(self, provider: "InMemoryProvider", name: str,
                 label_names: tuple[str, ...] = (),
                 bound_tail: tuple[str, ...] = ()) -> None:
        self._provider = provider
        self._name = name
        self.label_names = label_names
        self._bound_tail = bound_tail
        self.value = 0.0
        self.observations: list[float] = []

    def add(self, delta: float = 1.0) -> None:
        self.value += delta

    def set(self, value: float) -> None:
        self.value = value

    def observe(self, value: float) -> None:
        self.observations.append(value)

    def with_labels(self, *values: str) -> "_MemInstrument":
        """A child instrument keyed ``name{v1,v2}`` — one series per label
        value set, like a Prometheus vector.  Binding fewer values than
        label names binds the TRAILING names (the embedder extras
        ``extend_label_names`` appends): ``_Bundle.with_labels`` can bind
        the channel dimension first and the instrument's owner binds its
        own leading labels (e.g. ``reason``) later."""
        if len(values) > len(self.label_names):
            raise ValueError(
                f"{self._name}: {len(self.label_names)} label(s) expected, "
                f"got {len(values)}"
            )
        if not values:
            return self
        if len(values) < len(self.label_names):
            # Partial bind — not a series yet, so not registered with the
            # provider; the final child is created on the full bind below.
            return _MemInstrument(
                self._provider, self._name,
                self.label_names[: len(self.label_names) - len(values)],
                tuple(values) + self._bound_tail,
            )
        return self._provider._get(
            "%s{%s}" % (self._name,
                        ",".join(tuple(values) + self._bound_tail)), ()
        )


class InMemoryProvider(Provider):
    """Collects values in plain dicts — for tests and the bench harness."""

    def __init__(self) -> None:
        self.instruments: dict[str, _MemInstrument] = {}

    def _get(self, name: str, label_names=()) -> _MemInstrument:
        inst = self.instruments.get(name)
        if inst is None:
            inst = self.instruments[name] = _MemInstrument(
                self, name, tuple(label_names)
            )
        return inst

    def new_counter(self, name, help="", label_names=()) -> Counter:
        return self._get(name, label_names)

    def new_gauge(self, name, help="", label_names=()) -> Gauge:
        return self._get(name, label_names)

    def new_histogram(self, name, help="", label_names=()) -> Histogram:
        return self._get(name, label_names)

    def value(self, name: str) -> float:
        # Strict read: a misspelled/unwired name fails instead of
        # vacuously returning 0.
        return self.instruments[name].value

    def observations(self, name: str) -> list[float]:
        return self.instruments[name].observations

    def dump(self) -> dict[str, dict]:
        """Stable snapshot of every instrument, sorted by name: ``{name:
        {"value": <counter/gauge value>, "observations": [histogram
        samples]}}``.  The machine-readable surface the bench harness and
        trace-parity tests consume — names here are the documented contract
        (see :data:`VERIFY_LAUNCH_BATCH_KEY` /
        :data:`WAL_RECORDS_PER_FSYNC_KEY`)."""
        return {
            name: {
                "value": inst.value,
                "observations": list(inst.observations),
            }
            for name, inst in sorted(self.instruments.items())
        }


# --- instrument bundles (names mirror reference pkg/api/metrics.go) --------


class _Bundle:
    """Shared label plumbing: ``with_labels`` returns a copy of the bundle
    with every instrument bound to the given label values.  Parity:
    reference pkg/api/metrics.go With() on each bundle."""

    def with_labels(self, *values: str) -> "_Bundle":
        import copy

        clone = copy.copy(self)
        for k, v in vars(self).items():
            if isinstance(v, (Counter, Gauge, Histogram)):
                setattr(clone, k, v.with_labels(*values))
        return clone


class MetricsWAL(_Bundle):
    """Parity: reference pkg/wal/metrics.go:8-37 (1 instrument), plus the
    self-healing instruments (consensus_tpu addition): fsync-retry
    accounting, the background scrubber's pass/record/corruption counters,
    quarantine bookkeeping, and the degraded-mode gauge + transition
    counter.  The pinned names live in :data:`PINNED_METRIC_KEYS`."""

    def __init__(self, p: Provider, label_names: Sequence[str] = ()) -> None:
        ln = extend_label_names((), label_names)
        self.count_of_files = p.new_gauge(
            "wal_count_of_files", "Count of wal-files.", ln
        )
        self.count_of_files.add(0)  # reference Initialize()
        self.fsync_retries = p.new_counter(
            WAL_FSYNC_RETRY_KEY,
            "Group-commit fsync attempts that failed and were re-armed.",
            ln,
        )
        self.scrub_runs = p.new_counter(
            WAL_SCRUB_RUNS_KEY,
            "Background scrub passes over the WAL segment inventory.",
            ln,
        )
        self.scrub_records = p.new_counter(
            WAL_SCRUB_RECORDS_KEY,
            "Records re-walked (CRC re-verified) by the scrubber.",
            ln,
        )
        self.scrub_corruptions = p.new_counter(
            WAL_SCRUB_CORRUPTIONS_KEY,
            "Corruptions detected by the scrubber or at open/restore time.",
            ln,
        )
        self.quarantines = p.new_counter(
            WAL_QUARANTINE_KEY,
            "Corrupt WAL suffixes renamed aside preserving the prefix.",
            ln,
        )
        self.degraded = p.new_gauge(
            WAL_DEGRADED_KEY,
            "Whether the WAL is refusing appends (1 = degraded).",
            ln,
        )
        self.degraded.add(0)
        self.degraded_transitions = p.new_counter(
            WAL_DEGRADED_TOTAL_KEY,
            "Transitions into wal_degraded (append path unsatisfiable).",
            ln,
        )


class MetricsRequestPool(_Bundle):
    """Parity: reference pkg/api/metrics.go:172-237 (7 instruments)."""

    def __init__(self, p: Provider, label_names: Sequence[str] = ()) -> None:
        ln = extend_label_names((), label_names)
        self.count_of_elements = p.new_gauge(
            "pool_count_of_elements", "Number of elements in the consensus request pool.", ln
        )
        self.count_of_elements_all = p.new_counter(
            "pool_count_of_elements_all", "Total amount of elements in the pool.", ln
        )
        self.count_of_fail_add_request = p.new_counter(
            "pool_count_of_fail_add_request", "Submissions the pool rejected.", ln
        )
        self.count_of_delete_request = p.new_counter(
            "pool_count_of_delete_request", "Elements removed from the pool.", ln
        )
        self.count_leader_forward_request = p.new_counter(
            "pool_count_leader_forward_request", "Requests forwarded to the leader.", ln
        )
        self.count_timeout_two_step = p.new_counter(
            "pool_count_timeout_two_step", "Complaint-stage timeouts.", ln
        )
        self.latency_of_elements = p.new_histogram(
            "pool_latency_of_elements", "Time requests spend in the pool.", ln
        )


class MetricsBlacklist(_Bundle):
    """Parity: reference pkg/api/metrics.go:258-297 (2 instruments)."""

    def __init__(self, p: Provider, label_names: Sequence[str] = ()) -> None:
        ln = extend_label_names((), label_names)
        self.count = p.new_gauge(
            "blacklist_count", "Nodes in the blacklist.", ln
        )
        self.node_id_in_blacklist = p.new_gauge(
            "node_id_in_blacklist", "Whether this node id is blacklisted.", ln
        )


class MetricsConsensus(_Bundle):
    """Parity: reference pkg/api/metrics.go:319-344 (2 instruments), plus
    the decision-pipelining instruments (consensus_tpu addition)."""

    def __init__(self, p: Provider, label_names: Sequence[str] = ()) -> None:
        ln = extend_label_names((), label_names)
        self.count_consensus_reconfig = p.new_counter(
            "consensus_reconfig", "Reconfigurations applied.", ln
        )
        self.latency_sync = p.new_histogram(
            "consensus_latency_sync", "Duration of synchronization rounds.", ln
        )
        # --- decision pipelining (pipeline_depth > 1) -------------------
        self.in_flight_depth = p.new_gauge(
            "consensus_in_flight_depth",
            "Proposal slots currently moving through the 3-phase pipeline.",
            ln,
        )
        self.count_verify_launches = p.new_counter(
            "consensus_verify_launches",
            "Batched commit-signature verification launches (cross-slot "
            "coalescing makes this grow slower than decisions).",
            ln,
        )
        self.cross_slot_verify_batch = p.new_histogram(
            "consensus_cross_slot_verify_batch",
            "Commit signatures drained per batched verify launch.",
            ln,
        )
        self.wal_records_per_fsync = p.new_gauge(
            "consensus_wal_records_per_fsync",
            "Group-commit coalescing ratio: WAL records made durable per "
            "fsync in the most recent flush window.",
            ln,
        )
        # --- half-aggregated quorum certs (cert_mode="half-agg") --------
        self.wal_cert_bytes = p.new_counter(
            WAL_CERT_BYTES_KEY,
            "Encoded quorum-cert bytes persisted to the WAL.",
            ln,
        )
        self.net_cert_bytes = p.new_counter(
            NET_CERT_BYTES_KEY,
            "Encoded quorum-cert bytes broadcast in pre-prepares.",
            ln,
        )
        self.cert_bytes_per_cert = p.new_histogram(
            CERT_BYTES_PER_CERT_KEY,
            "Encoded bytes per quorum cert assembled or received.",
            ln,
        )
        self.cert_aggregate_launches = p.new_counter(
            CERT_AGGREGATE_LAUNCHES_KEY,
            "Half-aggregated cert checks (one MSM launch each).",
            ln,
        )
        self.cert_fallback_bisections = p.new_counter(
            CERT_FALLBACK_BISECTIONS_KEY,
            "Cert aggregations abandoned to bisection + full-tuple fallback.",
            ln,
        )


class MetricsView(_Bundle):
    """Parity: reference pkg/api/metrics.go:448-518 (12 instruments)."""

    def __init__(self, p: Provider, label_names: Sequence[str] = ()) -> None:
        ln = extend_label_names((), label_names)
        self.view_number = p.new_gauge(
            "view_number", "Current view number.", ln
        )
        self.leader_id = p.new_gauge(
            "view_leader_id", "Current leader id.", ln
        )
        self.proposal_sequence = p.new_gauge(
            "view_proposal_sequence", "In-progress proposal sequence.", ln
        )
        self.decisions_in_view = p.new_gauge(
            "view_decisions", "Decisions made in the current view.", ln
        )
        self.phase = p.new_gauge(
            "view_phase", "Current 3-phase state.", ln
        )
        self.count_txs_in_batch = p.new_gauge(
            "view_count_txs_in_batch", "Transactions in the current batch.", ln
        )
        self.count_batch_all = p.new_counter(
            "view_count_batch_all", "Batches decided in total.", ln
        )
        self.count_txs_all = p.new_counter(
            "view_count_txs_all", "Transactions decided in total.", ln
        )
        self.size_of_batch = p.new_counter(
            "view_size_batch", "Decided bytes in total.", ln
        )
        self.latency_batch_processing = p.new_histogram(
            "view_latency_batch_processing", "Pre-prepare to commit latency.", ln
        )
        self.latency_batch_save = p.new_histogram(
            "view_latency_batch_save", "Application delivery latency.", ln
        )
        self.count_batch_sig_verifications = p.new_counter(
            "view_count_batch_sig_verifications",
            "Signature verifications drained into device batches "
            "(consensus_tpu addition: the TPU offload volume).",
            ln,
        )


class MetricsSync(_Bundle):
    """Catch-up (state transfer) instruments — consensus_tpu addition; the
    reference has no sync subsystem to measure (Fabric's block puller lives
    outside the library)."""

    def __init__(self, p: Provider, label_names: Sequence[str] = ()) -> None:
        ln = extend_label_names((), label_names)
        self.count_chunks_fetched = p.new_counter(
            "sync_count_chunks_fetched", "Verified chunks applied during catch-up.", ln
        )
        self.count_decisions_fetched = p.new_counter(
            "sync_count_decisions_fetched", "Decisions applied during catch-up.", ln
        )
        self.count_sig_verifications = p.new_counter(
            "sync_count_sig_verifications",
            "Quorum-cert signatures drained into batched verifier calls.",
            ln,
        )
        self.sigs_per_chunk = p.new_histogram(
            "sync_sigs_per_chunk", "Signatures batch-verified per chunk.", ln
        )
        self.latency_catchup = p.new_histogram(
            "sync_latency_catchup", "Duration of one catch-up (sync) call.", ln
        )
        self.count_peer_demotions = p.new_counter(
            "sync_count_peer_demotions",
            "Peer score demotions (failed fetches + forged chunks).",
            ln,
        )
        self.sync_cert_bytes = p.new_counter(
            SYNC_CERT_BYTES_KEY,
            "Encoded quorum-cert bytes received in sync catch-up chunks.",
            ln,
        )


class MetricsNetwork(_Bundle):
    """Injected network adversary events — consensus_tpu addition, fed by
    ``SimNetwork`` (testing/network.py) when a bundle is attached, so chaos
    runs are attributable: how much of the schedule's adversary budget
    actually landed on the wire."""

    def __init__(self, p: Provider, label_names: Sequence[str] = ()) -> None:
        ln = extend_label_names((), label_names)
        self.count_dropped = p.new_counter(
            NET_DROPPED_KEY,
            "Messages dropped by injection (loss rolls, mutate/filter drops).",
            ln,
        )
        self.count_duplicated = p.new_counter(
            NET_DUPLICATED_KEY, "Messages delivered twice by injection.", ln
        )
        self.count_reordered = p.new_counter(
            NET_REORDERED_KEY, "Messages held back past later sends.", ln
        )
        self.count_replayed = p.new_counter(
            NET_REPLAYED_KEY, "Stale captured messages re-delivered.", ln
        )
        # Real-transport reconnect path (net/transport.py): a TcpComm with
        # this bundle attached books every bounded-retry outcome here.
        self.count_reconnect_attempts = p.new_counter(
            NET_RECONNECT_ATTEMPTS_KEY,
            "TCP peer (re)connect attempts, including retries.",
            ln,
        )
        self.count_reconnect_success = p.new_counter(
            NET_RECONNECT_SUCCESS_KEY,
            "TCP peer (re)connects that completed the HELLO handshake.",
            ln,
        )
        self.count_send_retried = p.new_counter(
            NET_SEND_RETRIED_KEY,
            "Frames re-sent after a mid-frame abrupt close.",
            ln,
        )
        self.count_send_dropped = p.new_counter(
            NET_SEND_DROPPED_KEY,
            "Frames dropped after exhausting connect/send retries.",
            ln,
        )
        # Listener-hardening guard (net/framing.py): a ListenerGuard with
        # this bundle attached books every defense event here.  The
        # malformed counter carries a "kind" label (framing.MALFORMED_KINDS)
        # so with_labels(kind) yields per-kind child series.
        self.count_malformed = p.new_counter(
            NET_MALFORMED_KEY,
            "Provably-malformed inbound frames booked as strikes.",
            extend_label_names(("kind",), label_names),
        )
        self.count_handshake_timeout = p.new_counter(
            NET_HANDSHAKE_TIMEOUT_KEY,
            "Inbound connections dropped for never completing the handshake.",
            ln,
        )
        self.count_peer_banned = p.new_counter(
            NET_PEER_BANNED_KEY,
            "Peers temporarily banned after crossing the strike limit.",
            ln,
        )
        self.count_conn_rejected = p.new_counter(
            NET_CONN_REJECTED_KEY,
            "Inbound connections refused at accept (ban or quota).",
            ln,
        )


class MetricsObs(_Bundle):
    """Observability-plane instruments — consensus_tpu addition, fed by the
    ``obs`` sampler/detectors (consensus_tpu/obs/).  One counter per anomaly
    detector plus the sample count; the pinned names live in
    :data:`PINNED_METRIC_KEYS` so they appear in a fresh ``Metrics.dump()``
    even before the first sample."""

    def __init__(self, p: Provider, label_names: Sequence[str] = ()) -> None:
        ln = extend_label_names((), label_names)
        self.count_samples = p.new_counter(
            OBS_SAMPLES_KEY, "Observability-plane samples taken.", ln
        )
        self.count_anomaly_commit_stall = p.new_counter(
            OBS_ANOMALY_COMMIT_STALL_KEY,
            "Commit-stall detector firings (pending work, no ledger growth).",
            ln,
        )
        self.count_anomaly_view_change_storm = p.new_counter(
            OBS_ANOMALY_VIEW_CHANGE_STORM_KEY,
            "View-change-storm detector firings.",
            ln,
        )
        self.count_anomaly_leader_flap = p.new_counter(
            OBS_ANOMALY_LEADER_FLAP_KEY,
            "Leader-flap detector firings.",
            ln,
        )
        self.count_anomaly_sync_lag = p.new_counter(
            OBS_ANOMALY_SYNC_LAG_KEY,
            "Sync-lag-divergence detector firings.",
            ln,
        )
        self.count_anomaly_verify_collapse = p.new_counter(
            OBS_ANOMALY_VERIFY_COLLAPSE_KEY,
            "Verify-launch-rate-collapse detector firings.",
            ln,
        )
        self.count_anomaly_membership_churn = p.new_counter(
            OBS_ANOMALY_MEMBERSHIP_CHURN_KEY,
            "Membership-churn detector firings.",
            ln,
        )
        self.count_anomaly_admission_overload = p.new_counter(
            OBS_ANOMALY_ADMISSION_OVERLOAD_KEY,
            "Ingress-admission-overload detector firings.",
            ln,
        )
        self.count_anomaly_dedup_storm = p.new_counter(
            OBS_ANOMALY_DEDUP_STORM_KEY,
            "Ingress duplicate-retry-storm detector firings.",
            ln,
        )
        self.count_anomaly_engine_degraded = p.new_counter(
            OBS_ANOMALY_ENGINE_DEGRADED_KEY,
            "Engine-degraded detector firings (supervised engine below its "
            "configured rung).",
            ln,
        )
        self.count_anomaly_wal_corruption = p.new_counter(
            OBS_ANOMALY_WAL_CORRUPTION_KEY,
            "WAL-corruption detector firings (quarantine or learner fence).",
            ln,
        )
        self.count_anomaly_wal_stall = p.new_counter(
            OBS_ANOMALY_WAL_STALL_KEY,
            "WAL-stall detector firings (degraded: appends refused).",
            ln,
        )
        self.count_anomaly_cross_group_stall = p.new_counter(
            OBS_ANOMALY_CROSS_GROUP_STALL_KEY,
            "Cross-group-stall detector firings (a 2PC transaction stuck "
            "unresolved past the stall window).",
            ln,
        )
        self.count_anomaly_wire_abuse = p.new_counter(
            OBS_ANOMALY_WIRE_ABUSE_KEY,
            "Wire-abuse detector firings (a listener booked new guard "
            "defense events since the last sample).",
            ln,
        )

    def anomaly_counter(self, kind: str) -> Counter:
        """The pinned counter for detector ``kind`` (its short name, e.g.
        ``commit_stall``) — fails loudly on an unknown kind."""
        return getattr(self, f"count_anomaly_{kind}")


class MetricsMembership(_Bundle):
    """Membership-epoch instruments — consensus_tpu addition, fed by the
    facade's epoch gate (consensus.py) and the joining-node bootstrap driver
    (membership/bootstrap.py).  The epoch gauge tracks the configuration a
    replica is SERVING (it lags the cluster's newest epoch while the replica
    is catching up); stale-epoch drops count ingress traffic carrying a
    different epoch — a removed node's zombie sends land here instead of
    perturbing the protocol."""

    def __init__(self, p: Provider, label_names: Sequence[str] = ()) -> None:
        ln = extend_label_names((), label_names)
        self.epoch = p.new_gauge(
            MEMBERSHIP_EPOCH_KEY,
            "Membership epoch this replica is serving.",
            ln,
        )
        self.count_stale_epoch_dropped = p.new_counter(
            MEMBERSHIP_STALE_EPOCH_DROPPED_KEY,
            "Inbound messages dropped at ingress for carrying another epoch "
            "or a non-member sender.",
            ln,
        )
        self.count_join_attempts = p.new_counter(
            MEMBERSHIP_JOIN_ATTEMPTS_KEY,
            "Join-bootstrap sync attempts (first try included).",
            ln,
        )
        self.count_join_retries = p.new_counter(
            MEMBERSHIP_JOIN_RETRIES_KEY,
            "Join-bootstrap sync retries (attempts after the first).",
            ln,
        )


class MetricsSidecar(_Bundle):
    """Multi-tenant verification-sidecar instruments — consensus_tpu
    addition, fed by ``net.sidecar.VerifySidecarServer``.  Per-tenant series
    are children of these pinned names (``with_labels(tenant)`` ->
    ``name{tenant}`` in the in-memory provider), so the aggregate names stay
    stable for dashboards while isolation tests can read one tenant out."""

    def __init__(self, p: Provider, label_names: Sequence[str] = ()) -> None:
        ln = extend_label_names((), label_names)
        self.count_admission_accepted = p.new_counter(
            SIDECAR_ADMISSION_ACCEPTED_KEY,
            "Verification batches admitted to a tenant queue.",
            ln,
        )
        self.count_admission_rejects = p.new_counter(
            SIDECAR_ADMISSION_REJECTS_KEY,
            "Batches rejected at admission because the tenant queue was full.",
            ln,
        )
        self.admission_queue_depth = p.new_gauge(
            SIDECAR_ADMISSION_QUEUE_DEPTH_KEY,
            "Signatures queued across tenant queues at the last admission.",
            ln,
        )
        self.count_wave_launches = p.new_counter(
            SIDECAR_WAVE_LAUNCHES_KEY,
            "Cross-tenant waves launched on the sidecar engine.",
            ln,
        )
        self.count_wave_signatures = p.new_counter(
            SIDECAR_WAVE_SIGNATURES_KEY,
            "Signatures verified across all sidecar waves.",
            ln,
        )
        self.count_wave_tenants = p.new_counter(
            SIDECAR_WAVE_TENANTS_KEY,
            "Tenants sharing a wave, summed over waves.",
            ln,
        )


class MetricsIngress(_Bundle):
    """Ingress-plane instruments — consensus_tpu addition, fed by the
    admission layer (ingress/admission.py), the placement fleet
    (ingress/placement.py), and the open-loop trace driver
    (ingress/driver.py).  ``offered = admitted + rate_limited + dedup_hits``
    holds by construction; the reroute counter tracks structured
    ``TenantAdmissionReject`` retries hopping to the hash ring's next
    candidate."""

    def __init__(self, p: Provider, label_names: Sequence[str] = ()) -> None:
        ln = extend_label_names((), label_names)
        self.count_offered = p.new_counter(
            INGRESS_OFFERED_KEY,
            "Client requests offered to the ingress admission layer.",
            ln,
        )
        self.count_admitted = p.new_counter(
            INGRESS_ADMITTED_KEY,
            "Client requests admitted past rate limiting and dedup.",
            ln,
        )
        self.count_rate_limited = p.new_counter(
            INGRESS_RATE_LIMITED_KEY,
            "Client requests rejected by the per-client token bucket.",
            ln,
        )
        self.count_dedup_hits = p.new_counter(
            INGRESS_DEDUP_HITS_KEY,
            "Duplicate client requests absorbed by the dedup cache.",
            ln,
        )
        self.count_reroutes = p.new_counter(
            INGRESS_REROUTE_KEY,
            "Admitted batches rerouted to the next fleet candidate after a "
            "structured admission reject.",
            ln,
        )
        self.fleet_size = p.new_gauge(
            INGRESS_FLEET_SIZE_KEY,
            "Verifier fleet servers currently in the placement ring.",
            ln,
        )
        self.commit_latency = p.new_histogram(
            INGRESS_COMMIT_LATENCY_KEY,
            "Sim-seconds from open-loop arrival to fleet commit.",
            ln,
        )


class MetricsEngine(_Bundle):
    """Engine-supervision instruments, fed by
    ``models.supervisor.EngineSupervisor``.  Per-fault-class degrade series
    are children of the pinned degrade name (``with_labels(reason)`` ->
    ``engine_degrade_total{reason}`` in the in-memory provider); the rung
    gauge tracks where on the ladder the supervisor is currently serving
    (0 = as configured, last rung = host twin)."""

    def __init__(self, p: Provider, label_names: Sequence[str] = ()) -> None:
        ln = extend_label_names((), label_names)
        self.count_degrade = p.new_counter(
            ENGINE_DEGRADE_KEY,
            "Supervised engine degrades down the ladder.",
            extend_label_names(("reason",), label_names),
        )
        self.count_recovered = p.new_counter(
            ENGINE_RECOVERED_KEY,
            "Supervised engine re-promotions after a breaker re-closed.",
            ln,
        )
        self.count_crosscheck = p.new_counter(
            ENGINE_CROSSCHECK_KEY,
            "Sampled host cross-checks run against device verdicts.",
            ln,
        )
        self.count_crosscheck_mismatch = p.new_counter(
            ENGINE_CROSSCHECK_MISMATCH_KEY,
            "Host cross-checks that contradicted the device verdict.",
            ln,
        )
        self.rung = p.new_gauge(
            ENGINE_RUNG_KEY,
            "Current degrade-ladder rung (0 = as configured).",
            ln,
        )
        self.count_compile_cache_hits = p.new_counter(
            ENGINE_COMPILE_CACHE_HITS_KEY,
            "Engine constructions that reused a memoized compiled kernel.",
            ln,
        )
        self.count_compile_cache_misses = p.new_counter(
            ENGINE_COMPILE_CACHE_MISSES_KEY,
            "Engine constructions that traced a kernel fresh.",
            ln,
        )


class MetricsGroups(_Bundle):
    """Consensus-sharding instruments, fed by the ingress group router
    (routed counter + directory gauge; not ported yet), the shared
    :class:`~consensus_tpu_torch.models.engine.FairShareWaveFormer` (one wave-span
    observation per fused launch; the multi-group counter bumps when a
    launch serves two or more groups — the cross-GROUP coalescing win), and
    the cross-group 2PC machinery (started/committed/aborted lifecycle)."""

    def __init__(self, p: Provider, label_names: Sequence[str] = ()) -> None:
        ln = extend_label_names((), label_names)
        self.count_routed = p.new_counter(
            GROUPS_ROUTED_KEY,
            "Admitted requests routed to their owning consensus group.",
            ln,
        )
        self.group_count = p.new_gauge(
            GROUPS_COUNT_KEY,
            "Consensus groups currently in the placement directory.",
            ln,
        )
        self.wave_span = p.new_histogram(
            GROUPS_WAVE_SPAN_KEY,
            "Distinct consensus groups sharing one fused verify launch.",
            ln,
        )
        self.count_wave_multi_group = p.new_counter(
            GROUPS_WAVE_MULTI_KEY,
            "Fused verify launches serving two or more groups.",
            ln,
        )
        self.count_twopc_started = p.new_counter(
            GROUPS_TWOPC_STARTED_KEY,
            "Cross-group atomic transactions entering the prepare phase.",
            ln,
        )
        self.count_twopc_committed = p.new_counter(
            GROUPS_TWOPC_COMMITTED_KEY,
            "Cross-group atomic transactions decided commit by every group.",
            ln,
        )
        self.count_twopc_aborted = p.new_counter(
            GROUPS_TWOPC_ABORTED_KEY,
            "Cross-group atomic transactions decided abort by every group.",
            ln,
        )


class MetricsViewChange(_Bundle):
    """Parity: reference pkg/api/metrics.go:548-578 (3 instruments)."""

    def __init__(self, p: Provider, label_names: Sequence[str] = ()) -> None:
        ln = extend_label_names((), label_names)
        self.current_view = p.new_gauge(
            "viewchange_current_view", "View-changer current view.", ln
        )
        self.next_view = p.new_gauge(
            "viewchange_next_view", "View being changed to.", ln
        )
        self.real_view = p.new_gauge(
            "viewchange_real_view", "Last installed view.", ln
        )


class Metrics:
    """The full bundle set handed through the facade.

    Parity: reference pkg/api/metrics.go:70-104."""

    def __init__(
        self,
        provider: Optional[Provider] = None,
        label_names: Sequence[str] = (),
    ) -> None:
        provider = provider or NoopProvider()
        self.provider = provider
        self.request_pool = MetricsRequestPool(provider, label_names)
        self.blacklist = MetricsBlacklist(provider, label_names)
        self.consensus = MetricsConsensus(provider, label_names)
        self.view = MetricsView(provider, label_names)
        self.view_change = MetricsViewChange(provider, label_names)
        self.wal = MetricsWAL(provider, label_names)
        self.sync = MetricsSync(provider, label_names)
        self.network = MetricsNetwork(provider, label_names)
        self.obs = MetricsObs(provider, label_names)
        self.membership = MetricsMembership(provider, label_names)
        self.sidecar = MetricsSidecar(provider, label_names)
        self.ingress = MetricsIngress(provider, label_names)
        self.engine = MetricsEngine(provider, label_names)
        self.groups = MetricsGroups(provider, label_names)

    def with_labels(self, *values: str) -> "Metrics":
        """Bind embedder label values on every bundle (e.g. the channel id).
        Values are positional in SORTED label-name order (the order
        ``extend_label_names`` stores them).  Parity: reference per-bundle
        With()."""
        import copy

        clone = copy.copy(self)
        for k, v in vars(self).items():
            if isinstance(v, _Bundle):
                setattr(clone, k, v.with_labels(*values))
        return clone


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Provider",
    "NoopProvider",
    "InMemoryProvider",
    "Metrics",
    "MetricsRequestPool",
    "MetricsBlacklist",
    "MetricsConsensus",
    "MetricsView",
    "MetricsViewChange",
    "MetricsWAL",
    "MetricsSync",
    "MetricsNetwork",
    "MetricsObs",
    "MetricsMembership",
    "MetricsSidecar",
    "MetricsIngress",
    "MetricsEngine",
    "MetricsGroups",
    "extend_label_names",
    "VERIFY_LAUNCH_BATCH_KEY",
    "WAL_RECORDS_PER_FSYNC_KEY",
    "NET_DROPPED_KEY",
    "NET_DUPLICATED_KEY",
    "NET_REORDERED_KEY",
    "NET_REPLAYED_KEY",
    "NET_INJECTED_KEYS",
    "NET_RECONNECT_ATTEMPTS_KEY",
    "NET_RECONNECT_SUCCESS_KEY",
    "NET_SEND_RETRIED_KEY",
    "NET_SEND_DROPPED_KEY",
    "NET_RECONNECT_KEYS",
    "NET_MALFORMED_KEY",
    "NET_HANDSHAKE_TIMEOUT_KEY",
    "NET_PEER_BANNED_KEY",
    "NET_CONN_REJECTED_KEY",
    "NET_ABUSE_KEYS",
    "OBS_SAMPLES_KEY",
    "OBS_ANOMALY_COMMIT_STALL_KEY",
    "OBS_ANOMALY_VIEW_CHANGE_STORM_KEY",
    "OBS_ANOMALY_LEADER_FLAP_KEY",
    "OBS_ANOMALY_SYNC_LAG_KEY",
    "OBS_ANOMALY_VERIFY_COLLAPSE_KEY",
    "OBS_ANOMALY_MEMBERSHIP_CHURN_KEY",
    "OBS_ANOMALY_ADMISSION_OVERLOAD_KEY",
    "OBS_ANOMALY_DEDUP_STORM_KEY",
    "OBS_ANOMALY_ENGINE_DEGRADED_KEY",
    "OBS_ANOMALY_WAL_CORRUPTION_KEY",
    "OBS_ANOMALY_WAL_STALL_KEY",
    "OBS_ANOMALY_CROSS_GROUP_STALL_KEY",
    "OBS_ANOMALY_WIRE_ABUSE_KEY",
    "OBS_ANOMALY_KEYS",
    "WAL_FSYNC_RETRY_KEY",
    "WAL_SCRUB_RUNS_KEY",
    "WAL_SCRUB_RECORDS_KEY",
    "WAL_SCRUB_CORRUPTIONS_KEY",
    "WAL_QUARANTINE_KEY",
    "WAL_DEGRADED_KEY",
    "WAL_DEGRADED_TOTAL_KEY",
    "WAL_STORAGE_KEYS",
    "INGRESS_OFFERED_KEY",
    "INGRESS_ADMITTED_KEY",
    "INGRESS_RATE_LIMITED_KEY",
    "INGRESS_DEDUP_HITS_KEY",
    "INGRESS_REROUTE_KEY",
    "INGRESS_FLEET_SIZE_KEY",
    "INGRESS_COMMIT_LATENCY_KEY",
    "INGRESS_KEYS",
    "MEMBERSHIP_EPOCH_KEY",
    "MEMBERSHIP_STALE_EPOCH_DROPPED_KEY",
    "MEMBERSHIP_JOIN_ATTEMPTS_KEY",
    "MEMBERSHIP_JOIN_RETRIES_KEY",
    "MEMBERSHIP_KEYS",
    "SIDECAR_ADMISSION_ACCEPTED_KEY",
    "SIDECAR_ADMISSION_REJECTS_KEY",
    "SIDECAR_ADMISSION_QUEUE_DEPTH_KEY",
    "SIDECAR_WAVE_LAUNCHES_KEY",
    "SIDECAR_WAVE_SIGNATURES_KEY",
    "SIDECAR_WAVE_TENANTS_KEY",
    "SIDECAR_KEYS",
    "WAL_CERT_BYTES_KEY",
    "SYNC_CERT_BYTES_KEY",
    "NET_CERT_BYTES_KEY",
    "CERT_BYTES_PER_CERT_KEY",
    "CERT_AGGREGATE_LAUNCHES_KEY",
    "CERT_FALLBACK_BISECTIONS_KEY",
    "CERT_KEYS",
    "ENGINE_DEGRADE_KEY",
    "ENGINE_RECOVERED_KEY",
    "ENGINE_CROSSCHECK_KEY",
    "ENGINE_CROSSCHECK_MISMATCH_KEY",
    "ENGINE_RUNG_KEY",
    "ENGINE_COMPILE_CACHE_HITS_KEY",
    "ENGINE_COMPILE_CACHE_MISSES_KEY",
    "ENGINE_KEYS",
    "GROUPS_ROUTED_KEY",
    "GROUPS_COUNT_KEY",
    "GROUPS_WAVE_SPAN_KEY",
    "GROUPS_WAVE_MULTI_KEY",
    "GROUPS_TWOPC_STARTED_KEY",
    "GROUPS_TWOPC_COMMITTED_KEY",
    "GROUPS_TWOPC_ABORTED_KEY",
    "GROUPS_KEYS",
    "PINNED_METRIC_KEYS",
]
