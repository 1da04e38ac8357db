"""Deterministic leader selection, with optional rotation and blacklist skip.

Parity: reference internal/bft/util.go:79-107 (getLeaderID).

The PyTorch port's copy of ``consensus_tpu/utils/leader.py``, its imports renamed.
"""

from __future__ import annotations

from typing import Sequence


def get_leader_id(
    view: int,
    n: int,
    nodes: Sequence[int],
    *,
    leader_rotation: bool = False,
    decisions_in_view: int = 0,
    decisions_per_leader: int = 1,
    blacklist: Sequence[int] = (),
) -> int:
    """Return the leader for ``view`` given the (sorted) node list.

    Without rotation the leader is static per view: ``nodes[view % n]``.
    With rotation, leadership additionally advances every
    ``decisions_per_leader`` decisions inside the view, and blacklisted
    nodes are skipped (scanning forward around the ring).
    """
    if not leader_rotation:
        return nodes[view % n]

    banned = frozenset(blacklist)
    base = view + decisions_in_view // decisions_per_leader
    for hop in range(len(nodes)):
        candidate = nodes[(base + hop) % n]
        if candidate not in banned:
            return candidate
    raise RuntimeError(f"all {len(nodes)} nodes are blacklisted")


__all__ = ["get_leader_id"]
