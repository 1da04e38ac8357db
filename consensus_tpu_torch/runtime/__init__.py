"""Deterministic clock + event scheduler (the port's copy of
``consensus_tpu/runtime``)."""

from consensus_tpu_torch.runtime.scheduler import (
    Clock,
    RealtimeScheduler,
    Scheduler,
    SimScheduler,
    TimerHandle,
)

__all__ = [
    "Clock",
    "Scheduler",
    "SimScheduler",
    "RealtimeScheduler",
    "TimerHandle",
]
