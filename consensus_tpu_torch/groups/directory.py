"""Tenant→consensus-group placement: the sharding map itself.

Same rendezvous (highest-random-weight) construction as the ingress
fleet's tenant→sidecar map (:mod:`consensus_tpu_torch.ingress.placement`), under
a sibling hash domain so the two maps are independent draws: a tenant's
sidecar and its consensus group are uncorrelated, and the remap bound
carries over verbatim — retiring one group moves ONLY the tenants whose
top-scoring group was the retired one (~1/N of them, exactly), because
every other tenant's ranking among the survivors is untouched.  No ring
state, no RNG: placement is a pure function of the (group id, tenant id)
strings, so the ingress router, every replica, and every test compute the
same map independently.

The PyTorch port's copy of ``consensus_tpu/groups/directory.py``, its imports renamed.
"""

from __future__ import annotations

import hashlib
from typing import Iterable

#: Hash domain for tenant→group scores.  Sibling of the ingress domain
#: ``ctpu/ingress/placement/v1`` — bump the version suffix, never reuse it,
#: if the scoring construction ever changes.
GROUPS_PLACEMENT_DOMAIN = b"ctpu/groups/placement/v1"


def _group_score(group: str, tenant: str) -> int:
    """64-bit rendezvous weight for placing ``tenant`` in ``group``."""
    digest = hashlib.sha256(
        GROUPS_PLACEMENT_DOMAIN + b"\x00"
        + group.encode() + b"\x00" + tenant.encode()
    ).digest()
    return int.from_bytes(digest[:8], "big")


def group_ids(n: int) -> tuple[str, ...]:
    """The canonical id set for an ``n``-group deployment."""
    if n < 1:
        raise ValueError("a deployment needs at least one group")
    return tuple(f"group-{i}" for i in range(n))


class GroupDirectory:
    """Rendezvous-hash tenant→group map over a mutable group set."""

    def __init__(self, groups: Iterable[str] = ()) -> None:
        self._groups: set[str] = set()
        for g in groups:
            self.add(g)

    @classmethod
    def of_size(cls, n: int) -> "GroupDirectory":
        return cls(group_ids(n))

    def add(self, group: str) -> None:
        if not group:
            raise ValueError("group id must be non-empty")
        self._groups.add(group)

    def remove(self, group: str) -> None:
        self._groups.discard(group)

    def groups(self) -> tuple[str, ...]:
        return tuple(sorted(self._groups))

    def __len__(self) -> int:
        return len(self._groups)

    def candidates(self, tenant: str) -> list[str]:
        """Every group, best placement first; ties (astronomically
        unlikely) break on the group id so the order is total."""
        if not self._groups:
            raise ValueError("group directory has no groups")
        return sorted(
            self._groups, key=lambda g: (-_group_score(g, tenant), g)
        )

    def assign(self, tenant: str) -> str:
        return self.candidates(tenant)[0]

    def assignment_map(self, tenants: Iterable[str]) -> dict[str, str]:
        """tenant -> group for a whole tenant population (the remap-bound
        tests diff two of these across a group join/leave)."""
        return {t: self.assign(t) for t in tenants}


__all__ = ["GROUPS_PLACEMENT_DOMAIN", "GroupDirectory", "group_ids"]
