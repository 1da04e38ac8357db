"""Trace exporters: Chrome/Perfetto trace-event JSON and JSONL.

Both formats are byte-deterministic for a given event stream: dict keys
are sorted, separators are fixed, and timestamps come from the scheduler
clock — two identically seeded ``SimScheduler`` runs export identical
bytes.

Chrome mapping (load in ``ui.perfetto.dev`` or ``chrome://tracing``):

- Per-decision spans (``seq`` set) become *async nestable* events
  (``ph="b"``/``"e"``) with ``id=seq`` and ``cat=track``, so overlapping
  decisions under pipelining render as separate nested tracks instead of
  corrupting one thread's begin/end stack.
- Spans without a ``seq`` (e.g. sync chunk fetches) become thread-scoped
  duration events (``ph="B"``/``"E"``).
- Instants map to ``ph="i"`` with thread scope.
- Each tracer ``track`` gets its own tid plus a ``thread_name`` metadata
  record; ``pid`` is the node id.

The PyTorch port's copy of ``consensus_tpu/trace/export.py``, its imports renamed.
"""

from __future__ import annotations

import json
from typing import Iterable

_ASYNC_PH = {"B": "b", "E": "e"}


def chrome_trace_events(events: Iterable[tuple], *, pid: int = 0) -> list:
    """Convert tracer event tuples to Chrome trace-event dicts."""
    events = list(events)
    tracks = sorted({ev[1] for ev in events})
    tid_of = {track: i + 1 for i, track in enumerate(tracks)}
    out = [
        {
            "ph": "M",
            "name": "thread_name",
            "pid": pid,
            "tid": tid_of[track],
            "args": {"name": track},
        }
        for track in tracks
    ]
    for ph, track, name, ts, seq, view, args in events:
        ev = {
            "name": name,
            "cat": track,
            "pid": pid,
            "tid": tid_of[track],
            # Chrome wants microseconds; round so float noise can't leak
            # into the export bytes.
            "ts": round(ts * 1e6, 3),
        }
        merged = dict(args) if args else {}
        if seq is not None:
            merged["seq"] = seq
        if view is not None:
            merged["view"] = view
        if merged:
            ev["args"] = merged
        if ph == "i":
            ev["ph"] = "i"
            ev["s"] = "t"
        elif seq is not None:
            ev["ph"] = _ASYNC_PH[ph]
            ev["id"] = seq
        else:
            ev["ph"] = ph
        out.append(ev)
    return out


def to_chrome_json(events: Iterable[tuple], *, pid: int = 0) -> str:
    doc = {
        "displayTimeUnit": "ms",
        "traceEvents": chrome_trace_events(events, pid=pid),
    }
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def write_chrome_trace(path, events: Iterable[tuple], *, pid: int = 0) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(to_chrome_json(events, pid=pid))


def to_jsonl(events: Iterable[tuple], *, pid: int = 0) -> str:
    """One JSON object per raw tracer event, in append order."""
    lines = []
    for ph, track, name, ts, seq, view, args in events:
        rec = {"ph": ph, "track": track, "name": name, "ts": ts, "pid": pid}
        if seq is not None:
            rec["seq"] = seq
        if view is not None:
            rec["view"] = view
        if args:
            rec["args"] = args
        lines.append(json.dumps(rec, sort_keys=True, separators=(",", ":")))
    return "\n".join(lines) + ("\n" if lines else "")


def write_jsonl(path, events: Iterable[tuple], *, pid: int = 0) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(to_jsonl(events, pid=pid))
