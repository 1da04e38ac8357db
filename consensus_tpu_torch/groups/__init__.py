"""Horizontal consensus sharding: many PBFT groups, one verifier fleet.

One consensus group tops out at a single leader's ordering pipeline no
matter how fast batch verification gets; the verifier is the shareable
resource.  This package is the unit of horizontal scale built on that
observation:

* :mod:`~consensus_tpu_torch.groups.directory` — :class:`GroupDirectory`, the
  tenant→group rendezvous map under the ``ctpu/groups/placement/v1``
  domain (a sibling of the ingress ``ctpu/ingress/placement/v1`` domain,
  so the server-leave remap bounds carry over verbatim).
* :mod:`~consensus_tpu_torch.groups.router` — :class:`GroupRouter`, the
  admit-then-route step the ingress driver runs per request.
* :mod:`~consensus_tpu_torch.groups.cluster` — :class:`ShardedCluster`, N
  simulated consensus groups on ONE shared :class:`SimScheduler`, all
  verifying through one shared :class:`FairShareWaveFormer` so waves
  coalesce across GROUPS, not just tenants (SAFETY §7 still holds: a
  submission is never split, so no quorum cert ever mixes engines).
* :mod:`~consensus_tpu_torch.groups.twopc` — the minimal cross-group atomic
  commit (2PC over ordered per-group records) plus the cross-group
  atomicity registry the invariant monitors consult at every delivery.
* :mod:`~consensus_tpu_torch.groups.chaos` — the per-group chaos vocabulary
  (kill a coordinator, partition one group's leader mid-2PC) with ddmin
  shrinking to paste-able reproducers.
* :mod:`~consensus_tpu_torch.groups.deploy` — the process-per-replica sharding
  of the deployment rig: N per-group ``ClusterSpec`` documents sharing one
  sidecar fleet, one launcher per group, zero orphans at teardown.

The PyTorch port's copy of ``consensus_tpu/groups/__init__.py``, its imports renamed.
"""

from consensus_tpu_torch.groups.chaos import (
    GroupChaosAction,
    GroupChaosResult,
    GroupChaosSchedule,
    GroupChaosEngine,
    format_group_repro,
    shrink_group_schedule,
)
from consensus_tpu_torch.groups.cluster import ShardedCluster
from consensus_tpu_torch.groups.deploy import ShardedClusterLauncher, ShardedDeploySpec
from consensus_tpu_torch.groups.directory import GROUPS_PLACEMENT_DOMAIN, GroupDirectory
from consensus_tpu_torch.groups.router import GroupRouter
from consensus_tpu_torch.groups.twopc import (
    CrossGroupRegistry,
    TwoPhaseCoordinator,
    TwoPhaseParticipant,
    twopc_payload,
    parse_twopc_payload,
)

__all__ = [
    "GROUPS_PLACEMENT_DOMAIN",
    "GroupDirectory",
    "GroupRouter",
    "ShardedCluster",
    "ShardedClusterLauncher",
    "ShardedDeploySpec",
    "CrossGroupRegistry",
    "TwoPhaseCoordinator",
    "TwoPhaseParticipant",
    "twopc_payload",
    "parse_twopc_payload",
    "GroupChaosAction",
    "GroupChaosResult",
    "GroupChaosSchedule",
    "GroupChaosEngine",
    "format_group_repro",
    "shrink_group_schedule",
]
