"""Decision-lifecycle tracing: deterministic spans over the scheduler clock.

Always compiled, default off.  See tracer.py (ring-buffer Tracer + the
module-level no-op), export.py (Chrome/Perfetto JSON + JSONL), report.py
(per-decision critical-path reconstruction): copies of the JAX package's
modules.
"""

from consensus_tpu_torch.trace.tracer import NOOP_TRACER, NoopTracer, Tracer
from consensus_tpu_torch.trace.export import (
    chrome_trace_events,
    to_chrome_json,
    to_jsonl,
    write_chrome_trace,
    write_jsonl,
)
from consensus_tpu_torch.trace.report import build_report, format_table

__all__ = [
    "Tracer",
    "NoopTracer",
    "NOOP_TRACER",
    "chrome_trace_events",
    "to_chrome_json",
    "to_jsonl",
    "write_chrome_trace",
    "write_jsonl",
    "build_report",
    "format_table",
]
