"""Replica configuration: batching, pool, timeout cascade, view-change and
heartbeat tuning, rotation, and the crypto-batching knobs.

Parity: reference pkg/types/config.go:15-188 (Configuration, DefaultConfig,
Validate).  Times are float seconds (the runtime clock is injectable, so tests
use a simulated clock rather than shrinking these).  The engine knobs
(`crypto_*`) are new — they tune the batch signature-verification engine and
have no reference counterpart.

The PyTorch port's copy of ``consensus_tpu/config.py``: every field with the
JAX name and default, and the same ``validate()`` with the same messages.
``compile_cache`` is inert here (see its comment).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class TraceConfig:
    """Decision-lifecycle tracing knob (no reference counterpart).

    Default-off; when enabled the consensus facade builds a
    ``trace.Tracer`` over the injected scheduler clock, so traces stay
    deterministic under ``SimScheduler``.  ``capacity`` bounds the event
    ring — oldest events are overwritten, memory never grows.
    """

    enabled: bool = False
    capacity: int = 65536


@dataclass(frozen=True)
class ObsConfig:
    """Cluster observability plane knob (no reference counterpart).

    Default-off, like :class:`TraceConfig`.  When enabled the test harness
    (``testing.app.Cluster(obs=...)``) installs an in-memory metrics
    provider on every node and arms a :class:`~consensus_tpu_torch.obs.sampler.
    ClusterSampler` on the shared scheduler: every ``sample_interval``
    sim-seconds it snapshots each node's ``Metrics.dump()`` plus derived
    health fields into a bounded ring of ``ring_capacity`` samples and
    evaluates the anomaly detectors.  ``flight_samples`` bounds how many
    trailing samples a flight-recorder bundle carries.
    """

    enabled: bool = False
    sample_interval: float = 1.0
    ring_capacity: int = 4096
    flight_samples: int = 64
    #: Optional ``consensus_tpu_torch.obs.detectors.DetectorThresholds`` override
    #: (held opaque here: config must not import the obs package).
    detector_thresholds: object = None

    def validate(self) -> None:
        errs = []
        if self.sample_interval <= 0:
            errs.append("obs.sample_interval must be positive")
        if self.ring_capacity < 1:
            errs.append("obs.ring_capacity must be >= 1")
        if self.flight_samples < 1:
            errs.append("obs.flight_samples must be >= 1")
        if errs:
            raise ValueError("invalid configuration: " + "; ".join(errs))


@dataclass(frozen=True)
class CompileCacheConfig:
    """Compilation-cache knobs of the JAX engines (no reference
    counterpart), kept so a configuration carries the same fields in both
    packages.  Inert in the port: nothing reads them.  ``validate`` checks
    them as the JAX package does.
    """

    enabled: bool = True
    persistent_dir: str = ""
    min_compile_time_secs: float = 1.0

    def validate(self) -> None:
        if self.min_compile_time_secs < 0:
            raise ValueError(
                "invalid configuration: "
                "compile_cache.min_compile_time_secs must be >= 0"
            )


@dataclass(frozen=True)
class Configuration:
    # --- identity -------------------------------------------------------
    self_id: int = 0

    # --- batching (leader) ---------------------------------------------
    # Parity: reference pkg/types/config.go:21-29,94-96 (defaults 100 / 10MB / 50ms).
    request_batch_max_count: int = 100
    request_batch_max_bytes: int = 10 * 1024 * 1024
    request_batch_max_interval: float = 0.050

    # --- message ingress ------------------------------------------------
    incoming_message_buffer_size: int = 200

    # --- request pool + timeout cascade ---------------------------------
    # Parity: reference pkg/types/config.go:37-55.
    request_pool_size: int = 400
    request_max_bytes: int = 10 * 1024
    request_forward_timeout: float = 2.0
    request_complain_timeout: float = 20.0
    request_auto_remove_timeout: float = 180.0
    submit_timeout: float = 5.0

    # --- view change ----------------------------------------------------
    # Parity: reference pkg/types/config.go:57-66.
    view_change_resend_interval: float = 5.0
    view_change_timeout: float = 20.0
    speed_up_view_change: bool = False

    # --- heartbeats / failure detection ---------------------------------
    # Parity: reference pkg/types/config.go:68-75.
    leader_heartbeat_timeout: float = 60.0
    leader_heartbeat_count: int = 10
    num_of_ticks_behind_before_syncing: int = 10

    # --- state transfer -------------------------------------------------
    collect_timeout: float = 1.0

    # --- leader rotation ------------------------------------------------
    # Parity: reference pkg/types/config.go:77-84,109-111 (defaults: rotation
    # on, 3 decisions per leader).
    leader_rotation: bool = True
    decisions_per_leader: int = 3

    # --- lifecycle ------------------------------------------------------
    sync_on_start: bool = False

    # --- decision pipelining (no reference counterpart) -----------------
    # Bounded window of in-flight proposal slots.  1 keeps the reference's
    # single-in-flight semantics; >1 lets the leader pre-prepare seq n+1
    # before decide(n) while commit/delivery stay sequence-ordered.
    # Pipelining requires a static leader: rotation counts decisions per
    # leader against checkpoint certificates that a pipelined window does
    # not produce in order, so depth > 1 demands leader_rotation off.
    pipeline_depth: int = 1

    # --- crypto engine (no reference counterpart) ----------------------
    # Minimum number of pending verifications before the engine takes the
    # device path instead of the host path, and the micro-batch coalescing
    # window.
    crypto_tpu_min_batch: int = 16
    crypto_batch_window: float = 0.002
    # Pad verification batches up to the next power of two (a handful of
    # stable shapes across batch sizes).
    crypto_pad_pow2: bool = True
    # Randomized batch verification (one aggregate check per batch).  All
    # replicas in a cluster must agree on it.  Ed25519 only: the engine is
    # Ed25519RandomizedBatchVerifier (models/ed25519.py).
    batch_verify_mode: bool = False
    # Quorum-certificate encoding (models/aggregate.py): "full" (n full
    # signatures) or "half-agg" (half-aggregated Ed25519 certs, (R_1..R_n,
    # s_agg), verified in one MSM check).  All replicas in a cluster must
    # agree on it.  P-256 verifiers report supports_cert_aggregation = False,
    # so the core keeps full certs for them under either value.
    cert_mode: str = "full"
    # Whole-pipeline-on-device verification (models/fused.py): the engine's
    # host prep (SHA-512 challenge hashing, mod-L reduction, range checks,
    # digit recoding) moves onto the device; the host only slices bytes into
    # SHA-512 block layout.  Verdicts are bit-identical to the host-prep
    # engines, so it changes only where work runs.  Ed25519-only.
    device_prep: bool = False
    # Device-mesh width and layout for the batch engine.  1 and () keep the
    # single-device engine; wider meshes are not ported yet (item 12).
    mesh_shards: int = 1
    mesh_topology: tuple = ()
    # Kept for parity with the JAX Configuration and inert in the port: the
    # port has no jit memo and no XLA cache to configure.  Its kernel
    # libraries are cached on disk by the source's hash (ops/scan_kernels.py)
    # whatever this says.  validate() still checks it, with the same message.
    compile_cache: CompileCacheConfig = field(default=CompileCacheConfig())
    # Fault-classed supervision of the engine with a degrade ladder to the
    # host (models/supervisor.py), plus a sampled host cross-check every
    # k-th launch (0 = off).
    engine_supervision: bool = False
    engine_crosscheck_interval: int = 0

    # --- membership epochs (no reference counterpart) -------------------
    # Stamp outbound consensus traffic with the sender's membership epoch
    # (wire.EpochTagged) and drop inbound traffic from other epochs at the
    # facade ingress — counted under the pinned membership_stale_epoch_
    # dropped metric, with a trace instant, instead of corrupting
    # collectors or provoking spurious view changes.  Default off: tagging
    # wraps every wire message, so all replicas in a cluster must agree on
    # this flag (a tagged message is still UNWRAPPED by a non-tagging
    # receiver, but an untagged sender gets no protection).
    epoch_tagging: bool = False

    # --- decision-lifecycle tracing (no reference counterpart) ----------
    trace: TraceConfig = field(default=TraceConfig())

    def validate(self) -> None:
        """Cross-field validation. Parity: reference pkg/types/config.go:116-188."""
        errs = []
        if self.self_id == 0:
            errs.append("self_id must be set (nonzero)")
        if self.request_batch_max_count <= 0:
            errs.append("request_batch_max_count must be positive")
        if self.request_batch_max_bytes <= 0:
            errs.append("request_batch_max_bytes must be positive")
        if self.request_batch_max_interval <= 0:
            errs.append("request_batch_max_interval must be positive")
        if self.request_max_bytes <= 0:
            errs.append("request_max_bytes must be positive")
        if self.request_batch_max_bytes < self.request_max_bytes:
            errs.append("request_batch_max_bytes must be >= request_max_bytes")
        if self.incoming_message_buffer_size <= 0:
            errs.append("incoming_message_buffer_size must be positive")
        if self.request_pool_size <= 0:
            errs.append("request_pool_size must be positive")
        if self.submit_timeout <= 0:
            errs.append("submit_timeout must be positive")
        if self.request_forward_timeout <= 0:
            errs.append("request_forward_timeout must be positive")
        if self.request_complain_timeout <= 0:
            errs.append("request_complain_timeout must be positive")
        if self.request_auto_remove_timeout <= 0:
            errs.append("request_auto_remove_timeout must be positive")
        if not (
            self.request_forward_timeout
            <= self.request_complain_timeout
            <= self.request_auto_remove_timeout
        ):
            errs.append(
                "timeout cascade must satisfy forward <= complain <= auto_remove"
            )
        if self.view_change_resend_interval <= 0:
            errs.append("view_change_resend_interval must be positive")
        if self.view_change_timeout <= 0:
            errs.append("view_change_timeout must be positive")
        if self.view_change_resend_interval > self.view_change_timeout:
            errs.append("view_change_resend_interval must be <= view_change_timeout")
        if self.leader_heartbeat_timeout <= 0:
            errs.append("leader_heartbeat_timeout must be positive")
        if self.leader_heartbeat_count <= 0:
            errs.append("leader_heartbeat_count must be positive")
        if self.num_of_ticks_behind_before_syncing <= 0:
            errs.append("num_of_ticks_behind_before_syncing must be positive")
        if self.collect_timeout <= 0:
            errs.append("collect_timeout must be positive")
        if self.leader_rotation and self.decisions_per_leader <= 0:
            errs.append("decisions_per_leader must be positive when rotating")
        if not self.leader_rotation and self.decisions_per_leader != 0:
            errs.append("decisions_per_leader must be zero when rotation is off")
        if self.pipeline_depth < 1:
            errs.append("pipeline_depth must be >= 1")
        if self.mesh_shards < 1:
            errs.append("mesh_shards must be >= 1")
        if self.mesh_topology:
            if any(int(a) < 1 for a in self.mesh_topology):
                errs.append("mesh_topology axes must all be >= 1")
            else:
                product = 1
                for a in self.mesh_topology:
                    product *= int(a)
                if self.mesh_shards != 1 and product != self.mesh_shards:
                    errs.append(
                        "mesh_topology axes product must equal mesh_shards "
                        "when both are set"
                    )
        try:
            self.compile_cache.validate()
        except ValueError as exc:
            errs.append(str(exc).replace("invalid configuration: ", ""))
        if self.engine_crosscheck_interval < 0:
            errs.append("engine_crosscheck_interval must be >= 0")
        if self.engine_crosscheck_interval and not self.engine_supervision:
            errs.append(
                "engine_crosscheck_interval requires engine_supervision"
            )
        if self.cert_mode not in ("full", "half-agg"):
            errs.append('cert_mode must be "full" or "half-agg"')
        if self.crypto_tpu_min_batch < 1:
            errs.append("crypto_tpu_min_batch must be >= 1")
        if self.pipeline_depth > 1 and self.leader_rotation:
            errs.append("pipeline_depth > 1 requires leader_rotation off")
        if self.trace.capacity < 1:
            errs.append("trace.capacity must be >= 1")
        if errs:
            raise ValueError("invalid configuration: " + "; ".join(errs))

    def with_(self, **kw) -> "Configuration":
        return replace(self, **kw)


def default_config(self_id: int) -> Configuration:
    """A validated default configuration for ``self_id``.

    Parity: reference pkg/types/config.go:93-114.
    """
    cfg = Configuration(self_id=self_id)
    cfg.validate()
    return cfg


__all__ = [
    "CompileCacheConfig",
    "Configuration",
    "ObsConfig",
    "TraceConfig",
    "default_config",
]
