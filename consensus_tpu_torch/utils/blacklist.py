"""Leader blacklist maintenance.

A deterministic function of committed metadata, so every replica computes the
same blacklist: leaders that were skipped over by view changes get
blacklisted; blacklisted nodes observed sending prepares by more than ``f``
commit-signers get redeemed; the list is capped at ``f`` (oldest evicted).

Parity: reference internal/bft/util.go:436-548 (blacklist.computeUpdate,
pruneBlacklist); follower-side validation lives in the view
(reference internal/bft/view.go:649-716).

The PyTorch port's copy of ``consensus_tpu/utils/blacklist.py``, its imports renamed.
"""

from __future__ import annotations

from typing import Mapping, Sequence

from consensus_tpu_torch.utils.leader import get_leader_id


def prune_blacklist(
    prev_blacklist: Sequence[int],
    prepares_from: Mapping[int, Sequence[int]],
    f: int,
    nodes: Sequence[int],
) -> list[int]:
    """Drop blacklist entries that no longer deserve it.

    ``prepares_from`` maps a commit-signer id to the list of node ids it
    attested to have received prepares from (carried in the auxiliary signed
    payload of commit signatures).  A blacklisted node vouched for by more
    than ``f`` distinct signers is redeemed (each signer counts once, however
    many times it repeats a node in its vouch list); nodes removed from
    membership are purged unconditionally.
    """
    if not prev_blacklist:
        return []

    member = frozenset(nodes)
    ack_count: dict[int, int] = {}
    for _, vouched in prepares_from.items():
        for prepare_sender in set(vouched):
            ack_count[prepare_sender] = ack_count.get(prepare_sender, 0) + 1

    kept: list[int] = []
    for node in prev_blacklist:
        if node not in member:
            continue  # removed by reconfiguration
        if ack_count.get(node, 0) > f:
            continue  # redeemed: observed alive by > f signers
        kept.append(node)
    return kept


def compute_blacklist_update(
    *,
    prev_view: int,
    prev_seq: int,
    prev_decisions_in_view: int,
    prev_blacklist: Sequence[int],
    current_view: int,
    current_leader: int,
    n: int,
    f: int,
    nodes: Sequence[int],
    leader_rotation: bool,
    decisions_per_leader: int,
    prepares_from: Mapping[int, Sequence[int]],
) -> list[int]:
    """Compute the blacklist to stamp into the next proposal's metadata.

    If the view advanced since the previous committed proposal, every leader
    of a skipped view (computed exactly as followers would) is blacklisted —
    it failed to drive a proposal.  If the view is unchanged, redemption
    pruning applies instead.  The result is capped at ``f`` entries by
    evicting the oldest.
    """
    updated = list(prev_blacklist)

    if prev_view != current_view:
        # Leadership moved via view change(s): blacklist each skipped leader.
        # For any proposal after the first in a view, the would-have-been
        # leader is computed one decision past the last committed one.
        offset = 0 if prev_seq == 0 else 1
        for skipped_view in range(prev_view, current_view):
            leader = get_leader_id(
                skipped_view,
                n,
                nodes,
                leader_rotation=leader_rotation,
                decisions_in_view=prev_decisions_in_view + offset,
                decisions_per_leader=decisions_per_leader,
                blacklist=prev_blacklist,
            )
            if leader == current_leader:
                continue  # never blacklist the node now driving progress
            updated.append(leader)
    else:
        updated = prune_blacklist(updated, prepares_from, f, nodes)

    while len(updated) > f:
        updated.pop(0)
    return updated


__all__ = ["prune_blacklist", "compute_blacklist_update"]
