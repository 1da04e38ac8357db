"""Observability exporters: Prometheus text format (v0.0.4), sorted-key
JSONL, and terminal sparklines.

Byte-determinism contract (same as trace/export.py): dict keys sorted,
separators fixed, timestamps from the scheduler clock, float formatting
canonical — two identically seeded runs export identical bytes, and the
golden-file test (tests/test_obs.py) pins the Prometheus export of a
fixed-seed 3-node run byte-for-byte.

The PyTorch port's copy of ``consensus_tpu/obs/export.py``, its imports renamed.
"""

from __future__ import annotations

import json
import re
from typing import Iterable, Optional

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

#: Health fields a node reports only when the corresponding surface
#: exists — the listener guard's counters appear once a ``wire_guard``
#: is attached (hardened listeners, the chaos ``net_abuse`` arm) and
#: never before, so pre-hardening scrapes stay byte-identical.
OPTIONAL_HEALTH_FIELDS = (
    "net_malformed", "net_handshake_timeouts", "net_peer_bans",
    "net_conn_rejected",
)

#: Health fields exported as ``obs_health_<field>{node="..."}`` gauges.
#: The :data:`OPTIONAL_HEALTH_FIELDS` tail is emitted only when present.
HEALTH_FIELDS = (
    "running", "view", "leader", "seq", "in_flight", "syncing",
    "pool", "wal_entries", "wal_fsyncs", "ledger", "sync_lag", "epoch",
) + OPTIONAL_HEALTH_FIELDS


def _fmt_value(v) -> str:
    """Canonical Prometheus sample value: integers without a trailing
    ``.0``, floats via repr (shortest round-trip, stable across runs)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _split_series(name: str) -> tuple[str, Optional[str]]:
    """An ``InMemoryProvider`` label-vector child is keyed
    ``name{v1,v2}`` — map it to the parent family plus a ``labels`` label
    so the export stays inside the Prometheus grammar."""
    if name.endswith("}") and "{" in name:
        base, _, rest = name.partition("{")
        return base, rest[:-1]
    return name, None


def sample_to_prometheus(sample: dict, *, prefix: str = "") -> str:
    """Render ONE sampler record as a Prometheus text-format (v0.0.4)
    scrape body: the sample clock, every health field, and every metrics
    instrument, each labeled ``node="<id>"``."""
    families: dict[str, list[tuple[str, str]]] = {}

    def emit(name: str, labels: list[tuple[str, str]], value) -> None:
        name = prefix + name
        if not _NAME_OK.match(name):
            return  # unexportable name: skip rather than corrupt the scrape
        label_str = ",".join(f'{k}="{v}"' for k, v in labels)
        families.setdefault(name, []).append((label_str, _fmt_value(value)))

    emit("obs_sample_time", [], sample.get("t", 0.0))
    emit("obs_sample_index", [], sample.get("i", 0))
    for nid in sorted(sample.get("nodes", {})):
        record = sample["nodes"][nid]
        health = record.get("health", {})
        for field in HEALTH_FIELDS:
            if field in health:
                emit(f"obs_health_{field}", [("node", nid)], health[field])
        for name in sorted(record.get("metrics", {})):
            data = record["metrics"][name]
            base, extra = _split_series(name)
            labels: list[tuple[str, str]] = []
            if extra is not None:
                labels.append(("labels", extra))
            labels.append(("node", nid))
            emit(base, labels, data.get("value", 0.0))
            obs = data.get("observations") or ()
            if obs:
                emit(base + "_count", labels, len(obs))
                emit(base + "_sum", labels, sum(obs))

    lines: list[str] = []
    for name in sorted(families):
        lines.append(f"# TYPE {name} untyped")
        for label_str, value in sorted(families[name]):
            if label_str:
                lines.append(f"{name}{{{label_str}}} {value}")
            else:
                lines.append(f"{name} {value}")
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, sample: dict, *, prefix: str = "") -> str:
    body = sample_to_prometheus(sample, prefix=prefix)
    with open(path, "w") as fh:
        fh.write(body)
    return path


# --- JSONL ------------------------------------------------------------------


def series_to_jsonl(samples: Iterable[dict]) -> str:
    """One sorted-key compact JSON object per sample, trailing newline."""
    return "".join(
        json.dumps(s, sort_keys=True, separators=(",", ":")) + "\n"
        for s in samples
    )


def write_series_jsonl(path: str, samples: Iterable[dict]) -> str:
    with open(path, "w") as fh:
        fh.write(series_to_jsonl(samples))
    return path


# --- sparklines -------------------------------------------------------------

_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values, *, width: int = 60) -> str:
    """A tiny unicode sparkline of ``values`` (most recent ``width``)."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _BLOCKS[0] * len(vals)
    return "".join(
        _BLOCKS[min(len(_BLOCKS) - 1, int((v - lo) / span * len(_BLOCKS)))]
        for v in vals
    )


def render_watch(samples, *, fields=("ledger", "pool", "in_flight"),
                 width: int = 60) -> str:
    """Terminal panel for ``chain_tps.py --watch``: one sparkline per
    health field, aggregated across nodes (max per sample), annotated with
    the latest value."""
    lines = []
    for field in fields:
        series = [
            max(
                (rec["health"].get(field, 0) for rec in s["nodes"].values()),
                default=0,
            )
            for s in samples
        ]
        spark = sparkline(series, width=width)
        latest = series[-1] if series else 0
        lines.append(f"{field:>10} {spark} {_fmt_value(latest)}")
    return "\n".join(lines)


__all__ = [
    "HEALTH_FIELDS",
    "render_watch",
    "sample_to_prometheus",
    "series_to_jsonl",
    "sparkline",
    "write_prometheus",
    "write_series_jsonl",
]
