"""Decision storage behind the catch-up subsystem.

The sync server reads ranges out of a :class:`DecisionStore` and the sync
client appends verified decisions into one — neither side knows whether the
store is the test harness's in-memory ledger, the example orderer's hash
chain, or a real database.  Positions are 1-based chain heights (position
``i`` is the ``i``-th decision ever committed), matching how the reference's
block puller addresses Fabric blocks by number.

The PyTorch port's copy of ``consensus_tpu/sync/store.py``, its imports renamed.
"""

from __future__ import annotations

import abc
from typing import List, Optional, Sequence

from consensus_tpu_torch.types import Decision


class DecisionStore(abc.ABC):
    """Ranged, position-addressed access to the committed decision chain."""

    @abc.abstractmethod
    def height(self) -> int:
        """Number of decisions in the chain (0 when empty)."""

    @abc.abstractmethod
    def read(self, from_seq: int, to_seq: int) -> Sequence[Decision]:
        """Decisions at positions ``[from_seq, to_seq]`` (1-based,
        inclusive), clamped to the available range; empty when the range is
        entirely above the current height."""

    @abc.abstractmethod
    def append(self, decision: Decision) -> None:
        """Extend the chain by one decision (the next position)."""

    def last(self) -> Optional[Decision]:
        h = self.height()
        if h == 0:
            return None
        return self.read(h, h)[0]


class LedgerDecisionStore(DecisionStore):
    """Adapter over a mutable ``list[Decision]`` ledger — the harness's
    ``TestApp.ledger`` and the example orderer's chain both plug in directly
    (the list object is shared, not copied, so consensus deliveries and sync
    appends land in the same chain)."""

    def __init__(self, ledger: List[Decision]) -> None:
        self._ledger = ledger

    def height(self) -> int:
        return len(self._ledger)

    def read(self, from_seq: int, to_seq: int) -> Sequence[Decision]:
        if from_seq < 1 or to_seq < from_seq:
            return []
        return list(self._ledger[from_seq - 1 : to_seq])

    def append(self, decision: Decision) -> None:
        self._ledger.append(decision)


__all__ = ["DecisionStore", "LedgerDecisionStore"]
