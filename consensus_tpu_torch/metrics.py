"""Metrics, engine part (the port's copy of the provider abstraction and
of the engine-layer bundles of ``consensus_tpu/metrics.py``).

Same names, pinned instrument keys and label plumbing as the JAX package:
the ``Provider`` / ``Counter`` / ``Gauge`` / ``Histogram`` interfaces, the
no-op and in-memory providers, and the two bundles the engine layer books
into -- :class:`MetricsEngine` (the supervisor's degrade / recover /
cross-check / rung series and the kernel-build cache counters) and
:class:`MetricsGroups` (the wave former's cross-group composition).  The
protocol bundles come with the protocol core.
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence


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


class Metrics:
    """The bundles the engine layer books into (the JAX ``Metrics`` holds
    the protocol's bundles too; they come with the protocol core)."""

    def __init__(
        self,
        provider: Optional[Provider] = None,
        label_names: Sequence[str] = (),
    ) -> None:
        provider = provider or NoopProvider()
        self.provider = provider
        self.engine = MetricsEngine(provider, label_names)
        self.groups = MetricsGroups(provider, label_names)

    def with_labels(self, *values: str) -> "Metrics":
        """Bind embedder label values on every bundle (e.g. the channel id).
        Values are positional in SORTED label-name order (the order
        ``extend_label_names`` stores them)."""
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
    "MetricsEngine",
    "MetricsGroups",
    "extend_label_names",
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
]
