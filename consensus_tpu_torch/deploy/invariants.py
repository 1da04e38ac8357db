"""Cross-process safety invariants for the deployment rig.

The in-process harnesses assert ledger equality by reading shared Python
lists; a process-per-replica cluster only exposes what each process
*reports* over its control socket.  The monitor therefore checks the two
properties that survive any amount of process death:

* **Prefix agreement** — every ledger digest list any replica has EVER
  reported must be prefix-consistent with every other report: position i
  holds the same digest everywhere it is populated.  Two replicas
  disagreeing at any height is a safety violation, full stop.

* **Durable-before-visible** — once ANY replica has reported a digest at
  height i, that digest is pinned: no later report (including one from a
  replica restarted after ``kill -9``) may show a different digest at i.
  A replica that lost acknowledged state to amnesia and re-ordered
  different decisions over the same heights fails exactly this check.
  (A restarted replica reporting a SHORTER ledger is fine — it rebuilds
  through verified sync — it just must re-extend the same chain.)

``observe`` is pure bookkeeping over reported digest lists, so the soak
driver can feed it from control-socket scrapes at any cadence.

The PyTorch port's copy of ``consensus_tpu/deploy/invariants.py``, its imports renamed.
"""

from __future__ import annotations

from typing import Sequence


class DeployInvariantMonitor:
    def __init__(self) -> None:
        #: The agreed chain: digest at height i, pinned by first report.
        self.agreed: list = []
        #: node_id -> greatest height that node has reported.
        self.reported_height: dict = {}
        self.violations: list = []
        self.observations = 0

    def observe(self, node_id, digests: Sequence[str]) -> None:
        self.observations += 1
        digests = list(digests)
        for i, digest in enumerate(digests):
            if i < len(self.agreed):
                if self.agreed[i] != digest:
                    self.violations.append(
                        f"node {node_id} reports {digest!r} at height {i}, "
                        f"but {self.agreed[i]!r} was already visible there "
                        "(prefix agreement / durable-before-visible broken)"
                    )
                    return  # one divergence poisons the suffix; stop here
            else:
                self.agreed.append(digest)
        previous = self.reported_height.get(node_id, 0)
        self.reported_height[node_id] = max(previous, len(digests))

    @property
    def clean(self) -> bool:
        return not self.violations

    def assert_clean(self) -> None:
        if self.violations:
            raise AssertionError(
                "deploy invariants violated:\n  "
                + "\n  ".join(self.violations)
            )

    def summary(self) -> dict:
        return {
            "agreed_height": len(self.agreed),
            "observations": self.observations,
            "violations": list(self.violations),
            "reported_height": {
                str(k): v for k, v in sorted(self.reported_height.items())
            },
        }


__all__ = ["DeployInvariantMonitor"]
