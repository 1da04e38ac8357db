"""Admit-then-route: the ingress step that picks a request's owning group.

The :class:`~consensus_tpu_torch.ingress.driver.IngressDriver` admits a request
first (rate limit + dedup — admission is global, not per-group, so a
flooding client cannot escape its budget by hashing into a quiet group)
and THEN asks the router which consensus group owns the tenant.  Routing
is a pure function of the directory, so the driver, every replica, and
every test agree on ownership without coordination.

Each routed request is triple-booked: the pinned ``groups_routed_total``
counter (per-group children via ``with_labels``), a ``groups.route``
trace instant when a tracer is attached, and the router's own per-group
tally (the summary artifact).

The PyTorch port's copy of ``consensus_tpu/groups/router.py``, its imports renamed.
"""

from __future__ import annotations

from typing import Optional

from consensus_tpu_torch.groups.directory import GroupDirectory


class GroupRouter:
    """Routes admitted requests to their owning consensus group."""

    def __init__(
        self,
        directory: GroupDirectory,
        *,
        metrics=None,
        tracer=None,
    ) -> None:
        if len(directory) < 1:
            raise ValueError("router needs at least one group")
        self.directory = directory
        self.metrics = metrics
        self.tracer = tracer
        #: group id -> requests routed there (insertion-ordered by first
        #: route; summaries sort it).
        self.routed: dict[str, int] = {}
        if metrics is not None:
            metrics.group_count.set(float(len(directory)))

    def route(self, tenant: str) -> str:
        """The owning group for ``tenant`` (books the route)."""
        group = self.directory.assign(tenant)
        self.routed[group] = self.routed.get(group, 0) + 1
        if self.metrics is not None:
            self.metrics.count_routed.add(1)
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            tracer.instant(
                "groups", "groups.route", tenant=tenant, group=group
            )
        return group

    def counts(self) -> dict:
        """Sorted group -> routed-count map (the summary artifact)."""
        return dict(sorted(self.routed.items()))


__all__ = ["GroupRouter"]
