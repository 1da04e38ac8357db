"""Flight recorder: one atomic failure bundle per run, plus its loader.

On any of the three trigger seams —

* **invariant violation** (``InvariantMonitor.on_violation``),
* **node crash-point fire** (``FaultPlan.recorder``: the armed hit calls
  :meth:`FlightRecorder.on_fault_fired` before the node tears down, so the
  bundle captures the pre-crash state),
* **unhandled controller exception** (``SimScheduler.on_unhandled_error``)

— the recorder dumps the last-N sampler records, the trace ring, a live
per-node metrics snapshot, and the active chaos schedule into one
``flightrec_<seed>.json``, written atomically (tmp + ``os.replace``, so a
crash mid-dump never leaves a torn bundle).  Every subsequent trigger
re-dumps with the full trigger list; the bundle's ``reason`` stays the
FIRST cause.

The loader (:func:`load_flight_record`) reconstructs a failing node's last
known view / leader / in-flight state from the bundle alone — no re-run of
the schedule required (proved by tests/test_obs.py against the PR-5
sentinel-bug schedule).

No wall clock anywhere: timestamps come from the injected ``clock``
callable (the scheduler), so bundles of a fixed-seed run are deterministic
modulo the trigger that produced them.

The PyTorch port's copy of ``consensus_tpu/obs/flightrec.py``, its imports renamed.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional

FLIGHTREC_VERSION = 1


def _schedule_doc(schedule) -> Optional[dict]:
    if schedule is None:
        return None
    return {
        "seed": schedule.seed,
        "n": schedule.n,
        "durability_window": schedule.durability_window,
        "actions": [dataclasses.asdict(a) for a in schedule.actions],
    }


class FlightRecorder:
    """Collects trigger seams and dumps bundles.  Construct one per run and
    attach the seams you have; every attach is optional."""

    def __init__(
        self,
        *,
        seed: int,
        out_dir: str = ".",
        clock: Optional[Callable[[], float]] = None,
        sampler=None,
        tracer=None,
        schedule=None,
        last_n: int = 64,
    ) -> None:
        if last_n < 1:
            raise ValueError("last_n must be >= 1")
        self.seed = seed
        self.out_dir = out_dir
        self.clock = clock
        self.sampler = sampler
        self.tracer = tracer
        self.schedule = schedule
        self.last_n = last_n
        #: Every trigger seen, in order: {"reason", "t", "node", "detail"}.
        self.triggers: list[dict] = []
        #: Path of the written bundle (None until the first trigger).
        self.path: Optional[str] = None

    # --- seam wiring --------------------------------------------------------

    def attach_scheduler(self, scheduler) -> None:
        """Observe unhandled event-handler exceptions."""
        scheduler.on_unhandled_error = self._on_unhandled_error

    def attach_monitor(self, monitor) -> None:
        """Observe invariant violations the moment they are recorded."""
        monitor.on_violation.append(self._on_violation)

    def watch_plan(self, plan) -> None:
        """Observe a FaultPlan's armed firing (pre-teardown)."""
        plan.recorder = self

    # --- the seams ----------------------------------------------------------

    def _on_violation(self, violation) -> None:
        self.trigger(
            "invariant",
            node=violation.node,
            detail=f"{violation.invariant}: {violation.detail}",
        )

    def on_fault_fired(self, point: str, hit: int) -> None:
        self.trigger("crash-point", detail=f"{point} (hit {hit})")

    def _on_unhandled_error(self, name: str, err: BaseException) -> None:
        self.trigger(
            "unhandled-exception", detail=f"event {name!r}: {err!r}"
        )

    # --- dumping ------------------------------------------------------------

    def _now(self) -> float:
        return self.clock() if self.clock is not None else 0.0

    def trigger(self, reason: str, *, node=None, detail: str = "") -> str:
        """Record one trigger and (re)write the bundle.  Returns the path."""
        self.triggers.append({
            "reason": reason,
            "t": round(self._now(), 6),
            "node": node,
            "detail": detail,
        })
        return self._dump()

    def _metrics_snapshot(self) -> dict:
        sampler = self.sampler
        if sampler is None:
            return {}
        out = {}
        for nid in sorted(sampler.cluster.nodes):
            node = sampler.cluster.nodes[nid]
            provider = getattr(node.metrics, "provider", None)
            dump = getattr(provider, "dump", None)
            if dump is not None:
                out[str(nid)] = dump()
        return out

    def _dump(self) -> str:
        first = self.triggers[0]
        samples = self.sampler.samples()[-self.last_n:] if self.sampler else []
        trace = (
            [list(ev) for ev in self.tracer.events()]
            if self.tracer is not None
            else []
        )
        doc = {
            "flightrec_version": FLIGHTREC_VERSION,
            "seed": self.seed,
            "reason": first["reason"],
            "t": first["t"],
            "node": first["node"],
            "detail": first["detail"],
            "triggers": self.triggers,
            "samples": samples,
            "anomalies": (
                [a.as_dict() for a in self.sampler.anomalies]
                if self.sampler else []
            ),
            "trace": trace,
            "metrics": self._metrics_snapshot(),
            "schedule": _schedule_doc(self.schedule),
        }
        path = os.path.join(self.out_dir, f"flightrec_{self.seed}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(json.dumps(doc, sort_keys=True, separators=(",", ":")))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        self.path = path
        return path


# --- loader -----------------------------------------------------------------


class FlightRecord:
    """A loaded bundle with reconstruction helpers — diagnosis without a
    re-run."""

    def __init__(self, doc: dict) -> None:
        if doc.get("flightrec_version") != FLIGHTREC_VERSION:
            raise ValueError(
                f"unsupported flightrec version {doc.get('flightrec_version')!r}"
            )
        self.doc = doc

    @property
    def seed(self) -> int:
        return self.doc["seed"]

    @property
    def reason(self) -> str:
        return self.doc["reason"]

    @property
    def detail(self) -> str:
        return self.doc["detail"]

    @property
    def triggers(self) -> list:
        return self.doc["triggers"]

    @property
    def samples(self) -> list:
        return self.doc["samples"]

    @property
    def anomalies(self) -> list:
        return self.doc.get("anomalies", [])

    @property
    def trace(self) -> list:
        return self.doc["trace"]

    @property
    def schedule_doc(self) -> Optional[dict]:
        return self.doc["schedule"]

    def last_sample(self) -> Optional[dict]:
        return self.samples[-1] if self.samples else None

    def last_health(self, node) -> Optional[dict]:
        """The failing node's last recorded health dict (view, leader,
        in-flight depth, ...), scanning the sample tail backwards."""
        key = str(node)
        for sample in reversed(self.samples):
            record = sample["nodes"].get(key)
            if record is not None:
                return record["health"]
        return None

    def metrics_of(self, node) -> Optional[dict]:
        return self.doc["metrics"].get(str(node))


def load_flight_record(path: str) -> FlightRecord:
    with open(path) as fh:
        return FlightRecord(json.load(fh))


__all__ = [
    "FLIGHTREC_VERSION",
    "FlightRecord",
    "FlightRecorder",
    "load_flight_record",
]
