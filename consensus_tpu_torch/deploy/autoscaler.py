"""Fleet autoscaler: add/drain sidecar verifier processes on load signals.

The decision function consumes exactly the two signals the earlier PRs
defined:

* **admission overload** (the ingress plane): the fleet-wide reject fraction over the
  last evaluation window crosses the same bar as the obs
  ``admission_overload`` detector — rejects/offered >= 0.5 with at least
  ``min_offered`` offered — meaning clients are being turned away, so a
  sidecar is ADDED (up to ``max_sidecars``).
* **engine degraded** (engine supervision): a sidecar reporting its supervised engine
  below its top rung is serving correct-but-slow verdicts from its host
  twin; it is DRAINED (and, when draining would take the fleet below
  ``min_sidecars``, a replacement is added first).

A calm fleet (reject fraction under ``calm_reject_fraction``) above
``min_sidecars`` drains the newest sidecar.  ``decide()`` is a pure
function of the signals — unit-testable with zero processes — and
``run_once()`` wires it to a live
:class:`~consensus_tpu_torch.deploy.launcher.ClusterLauncher`.  A cooldown of
``cooldown_evals`` evaluations between actions keeps restarts-in-progress
from double-triggering.

The PyTorch port's copy of ``consensus_tpu/deploy/autoscaler.py``, its imports renamed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass
class AutoscaleDecision:
    action: Optional[str]  # "scale_up" | "drain" | None
    target: Optional[str]  # sidecar id for drain
    reason: str


class FleetAutoscaler:
    def __init__(
        self,
        *,
        min_sidecars: int = 1,
        max_sidecars: int = 4,
        overload_reject_fraction: float = 0.5,
        min_offered: int = 20,
        calm_reject_fraction: float = 0.05,
        cooldown_evals: int = 3,
    ) -> None:
        self.min_sidecars = min_sidecars
        self.max_sidecars = max_sidecars
        self.overload_reject_fraction = overload_reject_fraction
        self.min_offered = min_offered
        self.calm_reject_fraction = calm_reject_fraction
        self.cooldown_evals = cooldown_evals
        self._cooldown = 0
        #: Applied decisions, newest last (soak summary material).
        self.history: list = []

    # ------------------------------------------------------------- policy

    def decide(self, signals: Sequence[dict]) -> AutoscaleDecision:
        """``signals``: one dict per live sidecar with ``sidecar_id``,
        ``offered``, ``rejected``, and ``engine_degraded`` (window-relative
        offered/rejected counts)."""
        if self._cooldown > 0:
            self._cooldown -= 1
            return AutoscaleDecision(None, None, "cooldown")
        fleet = len(signals)
        degraded = [s for s in signals if s.get("engine_degraded")]
        if degraded:
            target = degraded[0]["sidecar_id"]
            if fleet <= self.min_sidecars:
                return self._fire("scale_up", None,
                                  f"{target} engine_degraded at min fleet: "
                                  "add replacement before draining")
            return self._fire("drain", target, f"{target} engine_degraded")
        offered = sum(int(s.get("offered", 0)) for s in signals)
        rejected = sum(int(s.get("rejected", 0)) for s in signals)
        if offered >= self.min_offered:
            fraction = rejected / offered
            if (fraction >= self.overload_reject_fraction
                    and fleet < self.max_sidecars):
                return self._fire(
                    "scale_up", None,
                    f"admission_overload: {rejected}/{offered} rejected",
                )
        if (fleet > self.min_sidecars
                and (offered == 0
                     or rejected / offered <= self.calm_reject_fraction)):
            target = signals[-1]["sidecar_id"]
            return self._fire("drain", target,
                              f"calm fleet ({rejected}/{offered} rejected)")
        return AutoscaleDecision(None, None, "steady")

    def _fire(self, action, target, reason) -> AutoscaleDecision:
        self._cooldown = self.cooldown_evals
        decision = AutoscaleDecision(action, target, reason)
        self.history.append(decision)
        return decision

    # --------------------------------------------------------------- live

    def run_once(self, launcher) -> AutoscaleDecision:
        """Scrape signals from the launcher's live sidecars, decide, apply."""
        signals = launcher.sidecar_signals()
        decision = self.decide(signals)
        if decision.action == "scale_up":
            launcher.add_sidecar()
        elif decision.action == "drain" and decision.target is not None:
            launcher.drain_sidecar(decision.target)
        return decision


__all__ = ["FleetAutoscaler", "AutoscaleDecision"]
