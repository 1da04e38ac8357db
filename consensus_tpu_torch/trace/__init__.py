"""Decision-lifecycle tracing: deterministic spans over the scheduler clock.

Always compiled, default off.  See tracer.py (ring-buffer Tracer + the
module-level no-op).  The port has the tracer only; the JAX package's
exporters (``trace/export.py``) and critical-path report
(``trace/report.py``) are ROADMAP.md queue A item 7b.
"""

from consensus_tpu_torch.trace.tracer import NOOP_TRACER, NoopTracer, Tracer

__all__ = [
    "Tracer",
    "NoopTracer",
    "NOOP_TRACER",
]
