"""Per-decision critical-path reconstruction from a tracer's event stream.

``build_report`` keys decisions by ``(seq, view)`` and attributes each
decision's latency to the pipeline phases::

    pool_wait    pool.admit  -> batch.seal      (first admitted request)
    seal_wait    batch.seal  -> phase.pre_prepare begin
    pre_prepare  pre-prepare processing (verify + persist admission)
    prepare      pre-prepare done -> prepare quorum
    commit       prepare quorum -> commit quorum
    deliver      application delivery

plus the cross-cutting attribution streams: verify-launch batch sizes and
WAL records-per-fsync.

``pool_wait`` uses FIFO matching: each leader ``batch.seal`` instant with
``count=k`` consumes the ``k`` oldest unconsumed ``pool.admit`` instants,
and the decision's pool wait is measured from the first of those.  This is
exact for the FIFO request pool and needs no per-request ids on the hot
path.

The PyTorch port's copy of ``consensus_tpu/trace/report.py``, its imports renamed.
"""

from __future__ import annotations

from typing import Iterable

PHASES = (
    "pool_wait",
    "seal_wait",
    "pre_prepare",
    "prepare",
    "commit",
    "deliver",
)

_PHASE_SPANS = {
    "phase.pre_prepare": "pre_prepare",
    "phase.prepare": "prepare",
    "phase.commit": "commit",
    "phase.deliver": "deliver",
}


def percentile(sorted_values: list, q: float) -> float:
    if not sorted_values:
        return 0.0
    idx = min(len(sorted_values) - 1, int(round(q * (len(sorted_values) - 1))))
    return sorted_values[idx]


def build_report(events: Iterable[tuple]) -> dict:
    events = list(events)
    admits: list = []
    seals: list = []  # (ts, seq, view, count)
    spans: dict = {}  # (seq, view) -> {name: [begin_ts, end_ts]}
    verify_sizes: list = []
    fsync_records: list = []

    for ph, track, name, ts, seq, view, args in events:
        if ph == "i":
            if name == "pool.admit":
                admits.append(ts)
            elif name == "batch.seal" and seq is not None:
                seals.append((ts, seq, view, (args or {}).get("count", 1)))
            elif name == "verify.launch":
                verify_sizes.append((args or {}).get("size", 0))
            elif name == "wal.fsync":
                fsync_records.append((args or {}).get("records", 0))
        elif seq is not None and (name == "decision" or name in _PHASE_SPANS):
            slot = spans.setdefault((seq, view), {}).setdefault(
                name, [None, None]
            )
            if ph == "B":
                slot[0] = ts
            elif ph == "E":
                slot[1] = ts

    # FIFO-match admits to seals, in seal order.
    seal_of: dict = {}  # (seq, view) -> (seal_ts, first_admit_ts | None)
    cursor = 0
    for ts, seq, view, count in sorted(seals):
        first = admits[cursor] if cursor < len(admits) else None
        cursor += count
        seal_of[(seq, view)] = (ts, first)

    decisions: dict = {}
    for key in sorted(spans):
        named = spans[key]
        phases: dict = {}
        for span_name, phase in _PHASE_SPANS.items():
            pair = named.get(span_name)
            if pair and pair[0] is not None and pair[1] is not None:
                phases[phase] = pair[1] - pair[0]
        seal = seal_of.get(key)
        pre = named.get("phase.pre_prepare")
        if seal is not None and pre and pre[0] is not None:
            seal_ts, first_admit = seal
            phases["seal_wait"] = pre[0] - seal_ts
            if first_admit is not None:
                phases["pool_wait"] = seal_ts - first_admit
        decision = named.get("decision", [None, None])
        decisions[key] = {
            "phases": phases,
            "begin": decision[0],
            "end": decision[1],
            "complete": all(
                phase in phases
                for phase in ("pre_prepare", "prepare", "commit", "deliver")
            ),
        }

    phase_percentiles: dict = {}
    for phase in PHASES:
        values = sorted(
            d["phases"][phase]
            for d in decisions.values()
            if phase in d["phases"]
        )
        phase_percentiles[phase] = {
            "n": len(values),
            "p50": percentile(values, 0.50),
            "p99": percentile(values, 0.99),
        }

    return {
        "n_decisions": len(decisions),
        "n_complete": sum(1 for d in decisions.values() if d["complete"]),
        "decisions": decisions,
        "phase_percentiles": phase_percentiles,
        "verify_launch_sizes": verify_sizes,
        "fsync_records": fsync_records,
    }


def format_table(report: dict) -> str:
    """Human-readable phase breakdown (milliseconds)."""
    lines = [
        f"{'phase':<14} {'n':>6} {'p50_ms':>10} {'p99_ms':>10}",
        "-" * 43,
    ]
    for phase in PHASES:
        cell = report["phase_percentiles"][phase]
        lines.append(
            f"{phase:<14} {cell['n']:>6} "
            f"{cell['p50'] * 1000:>10.3f} {cell['p99'] * 1000:>10.3f}"
        )
    sizes = report["verify_launch_sizes"]
    records = report["fsync_records"]
    lines.append("-" * 43)
    lines.append(
        f"decisions: {report['n_decisions']} "
        f"(complete chains: {report['n_complete']})"
    )
    if sizes:
        lines.append(
            f"verify launches: {len(sizes)} "
            f"(mean batch {sum(sizes) / len(sizes):.2f})"
        )
    if records:
        lines.append(
            f"fsyncs: {len(records)} "
            f"(mean records/fsync {sum(records) / len(records):.2f})"
        )
    return "\n".join(lines)
