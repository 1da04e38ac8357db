"""Membership epochs: add/remove-node as an ordered, quorum-certified
decision with a first-class lifecycle.

A membership change in this system is an ordinary decision — it is batched,
three-phase ordered, and commit-certified like any other proposal, and it
surfaces to the replica through the existing ``Reconfig`` path
(``Controller.decide`` on the deliver path, ``Controller._do_sync`` on the
sync-learned path).  What was missing before this module is an owner for the
*arithmetic* of that lifecycle: which committee certifies which sequence.

* :class:`MembershipConfig` — one epoch's frozen membership: the epoch
  number, the sorted node ids, and the quorum arithmetic derived from them.
* :class:`MembershipChange` — the delta between two adjacent epochs, pinned
  to the decision (sequence + proposal digest) that ordered it.
* :class:`MembershipDirectory` — the cluster-level epoch timeline keyed by
  decision sequence.  The membership-change decision itself is certified by
  the membership of the epoch it RETIRES (its signers are the old
  committee); every decision after it belongs to the new one.  The
  epoch-aware invariant checks (testing/invariants.py) and the chaos churn
  actions read this.

Parity model: reference pkg/types/types.go (Reconfig) and
pkg/consensus/consensus.go:166-252 (the rebuild); the reference leaves the
epoch bookkeeping to the application — this module is that bookkeeping.

The PyTorch port's copy of ``consensus_tpu/membership/epoch.py``, its imports renamed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from consensus_tpu_torch.utils.quorum import compute_quorum


@dataclass(frozen=True)
class MembershipConfig:
    """One epoch's membership: ids are stored sorted, so two configs with
    the same member set compare equal regardless of input order."""

    epoch: int
    nodes: tuple[int, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "nodes", tuple(sorted(self.nodes)))

    @property
    def n(self) -> int:
        return len(self.nodes)

    @property
    def quorum(self) -> int:
        return compute_quorum(self.n)[0]

    @property
    def f(self) -> int:
        return compute_quorum(self.n)[1]

    def __contains__(self, node_id: int) -> bool:
        return node_id in self.nodes

    def validate(self) -> None:
        errs = []
        if self.epoch < 0:
            errs.append("epoch must be >= 0")
        if not self.nodes:
            errs.append("membership must not be empty")
        if any(node <= 0 for node in self.nodes):
            errs.append(f"node ids must be positive: {list(self.nodes)}")
        if len(set(self.nodes)) != len(self.nodes):
            errs.append(f"membership contains duplicate ids: {list(self.nodes)}")
        if errs:
            raise ValueError("invalid membership config: " + "; ".join(errs))


@dataclass(frozen=True)
class MembershipChange:
    """The transition ``old -> new``, ordered by the decision at ``seq``
    whose proposal digest is ``digest`` (the idempotence key: every replica
    delivers the same decision, and a lagging replica re-surfaces it through
    sync)."""

    seq: int
    digest: str
    old: MembershipConfig
    new: MembershipConfig

    @property
    def added(self) -> tuple[int, ...]:
        return tuple(i for i in self.new.nodes if i not in self.old.nodes)

    @property
    def removed(self) -> tuple[int, ...]:
        return tuple(i for i in self.old.nodes if i not in self.new.nodes)

    def __str__(self) -> str:
        parts = []
        if self.added:
            parts.append("+" + ",".join(map(str, self.added)))
        if self.removed:
            parts.append("-" + ",".join(map(str, self.removed)))
        delta = " ".join(parts) or "(no delta)"
        return (
            f"epoch {self.old.epoch} -> {self.new.epoch} at seq {self.seq}: {delta}"
        )


class MembershipDirectory:
    """Cluster-level epoch timeline: which membership certifies which
    decision sequence.

    Deliveries are totally ordered (every replica commits the same decisions
    in the same order), so the first replica to surface a change assigns the
    next epoch number deterministically; every later sighting of the same
    proposal digest — another replica's delivery, or a sync replay — is
    idempotent and returns the already-recorded config.
    """

    def __init__(self, initial_nodes: Sequence[int]) -> None:
        base = MembershipConfig(epoch=0, nodes=tuple(initial_nodes))
        base.validate()
        #: ``(first_seq, config)`` — config certifies decisions at
        #: sequences >= first_seq (until the next entry takes over).
        self._timeline: list[tuple[int, MembershipConfig]] = [(0, base)]
        self._by_digest: dict[str, MembershipChange] = {}
        #: Every recorded transition, in epoch order.
        self.changes: list[MembershipChange] = []

    @property
    def current(self) -> MembershipConfig:
        return self._timeline[-1][1]

    @property
    def current_epoch(self) -> int:
        return self.current.epoch

    def record_change(
        self, digest: str, seq: int, nodes: Sequence[int]
    ) -> MembershipConfig:
        """Record the membership decision ``digest`` committed at ``seq``,
        idempotently, and return the config of the epoch it opens.

        The change decision itself (at ``seq``) is certified by the OLD
        committee — its commit signatures were gathered before anyone
        learned of the change — so the new config takes over at ``seq + 1``.
        """
        existing = self._by_digest.get(digest)
        if existing is not None:
            return existing.new
        old = self.current
        new = MembershipConfig(epoch=old.epoch + 1, nodes=tuple(nodes))
        new.validate()
        change = MembershipChange(seq=seq, digest=digest, old=old, new=new)
        self._by_digest[digest] = change
        self.changes.append(change)
        self._timeline.append((seq + 1, new))
        return new

    def membership_at(self, seq: Optional[int]) -> MembershipConfig:
        """The membership whose quorum certifies the decision at ``seq``
        (the latest config whose reign starts at or before ``seq``)."""
        if seq is None:
            return self.current
        cfg = self._timeline[0][1]
        for first_seq, candidate in self._timeline:
            if seq < first_seq:
                break
            cfg = candidate
        return cfg

    def config_for_epoch(self, epoch: int) -> Optional[MembershipConfig]:
        for _, cfg in self._timeline:
            if cfg.epoch == epoch:
                return cfg
        return None

    def ever_removed(self) -> set[int]:
        """Every id that was a member of some epoch and is not one now."""
        seen: set[int] = set()
        for _, cfg in self._timeline:
            seen.update(cfg.nodes)
        return seen - set(self.current.nodes)


__all__ = ["MembershipConfig", "MembershipChange", "MembershipDirectory"]
