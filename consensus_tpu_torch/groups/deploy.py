"""Sharded deployment rig: N groups as real OS-process clusters, one fleet.

The sim harness (:mod:`consensus_tpu_torch.groups.cluster`) shards on one
virtual clock; this module is the same topology over the real deploy rig
(:mod:`consensus_tpu_torch.deploy`): every group is a full process-per-replica
cluster — its own replicas, WAL directories, consensus/sync/control
ports — while the sidecar verifier FLEET is shared by all of them:

* One :class:`~consensus_tpu_torch.deploy.spec.PortReservation` covers every
  port in the shard (3 per replica x n x groups + 2 per sidecar), held
  bound from generate to just-before-spawn, so two shards generating
  concurrently can never collide (the free_ports TOCTOU fix).
* All groups share one ``auth_secret`` (the sidecar service authenticates
  every group's replicas with it) and the SAME sidecar address list;
  each group gets its OWN ``key_namespace`` (``<ns>-g<i>``) so replica
  identities never collide across groups.
* Group 0's :class:`~consensus_tpu_torch.deploy.launcher.ClusterLauncher` owns
  the fleet (spawns + audits the sidecar processes); every other group
  runs with ``spawn_sidecars=False`` and merely dials it.

Teardown stops the non-owning groups first, the fleet owner last, and
every launcher's zero-orphan / zero-leaked-port audit runs as usual.

The PyTorch port's copy of ``consensus_tpu/groups/deploy.py``, its imports renamed.
"""

from __future__ import annotations

import os
import secrets
from typing import Dict, Optional

from consensus_tpu_torch.deploy.launcher import ClusterLauncher
from consensus_tpu_torch.deploy.spec import (
    ClusterSpec,
    PortReservation,
    ReplicaSpec,
    SidecarSpec,
)
from consensus_tpu_torch.groups.directory import group_ids


class ShardedDeploySpec:
    """Per-group :class:`ClusterSpec`s minted together over one held
    reservation, sharing the sidecar fleet and the auth secret."""

    def __init__(self, specs: Dict[str, ClusterSpec], reservation=None) -> None:
        if not specs:
            raise ValueError("need at least one group spec")
        self.specs = dict(specs)
        self._reservation = reservation

    @classmethod
    def generate(
        cls,
        n_groups: int,
        n: int,
        n_sidecars: int,
        base_dir: str,
        *,
        clients: int = 8,
        host: str = "127.0.0.1",
        config_overrides: Optional[dict] = None,
    ) -> "ShardedDeploySpec":
        os.makedirs(base_dir, exist_ok=True)
        base_dir = os.path.abspath(base_dir)
        reservation = PortReservation(
            3 * n * n_groups + 2 * n_sidecars, host=host
        )
        ports = reservation.ports
        auth_secret_hex = secrets.token_hex(16)
        namespace = secrets.token_hex(8)
        fleet_base = 3 * n * n_groups
        fleet = [
            SidecarSpec(
                sidecar_id=f"sc-{k}",
                host=host,
                port=ports[fleet_base + 2 * k],
                control_port=ports[fleet_base + 2 * k + 1],
            )
            for k in range(n_sidecars)
        ]
        specs: Dict[str, ClusterSpec] = {}
        for gi, gid in enumerate(group_ids(n_groups)):
            group_dir = os.path.join(base_dir, gid)
            os.makedirs(group_dir, exist_ok=True)
            spec = ClusterSpec(
                n=n,
                base_dir=group_dir,
                auth_secret_hex=auth_secret_hex,
                key_namespace=f"{namespace}-g{gi}",
                clients=clients,
                config_overrides=dict(config_overrides or {}),
            )
            offset = 3 * n * gi
            for i in range(n):
                node_id = i + 1
                spec.replicas.append(
                    ReplicaSpec(
                        node_id=node_id,
                        host=host,
                        port=ports[offset + 3 * i],
                        sync_port=ports[offset + 3 * i + 1],
                        control_port=ports[offset + 3 * i + 2],
                        wal_dir=os.path.join(
                            group_dir, f"node-{node_id}", "wal"
                        ),
                    )
                )
            # Every group's cluster.json lists the SAME fleet addresses:
            # dataclass copies, so a later autoscale in one group's spec
            # cannot silently mutate another's.
            spec.sidecars = [
                SidecarSpec(**vars(sc)) for sc in fleet
            ]
            spec.attach_reservation(reservation)
            specs[gid] = spec
        return cls(specs, reservation=reservation)

    def group_ids(self) -> list:
        return sorted(self.specs)

    def release_ports(self) -> None:
        if self._reservation is not None:
            self._reservation.release()


class ShardedClusterLauncher:
    """Boots and operates one launcher per group over the shared fleet.

    Group 0 owns the sidecars; all launchers share the one reservation,
    released exactly once right before the first spawn."""

    def __init__(self, sharded: ShardedDeploySpec, **launcher_kwargs) -> None:
        self.sharded = sharded
        self.launchers: Dict[str, ClusterLauncher] = {}
        for gi, gid in enumerate(sharded.group_ids()):
            self.launchers[gid] = ClusterLauncher(
                sharded.specs[gid],
                spawn_sidecars=(gi == 0),
                **launcher_kwargs,
            )

    @property
    def fleet_owner(self) -> ClusterLauncher:
        return self.launchers[self.sharded.group_ids()[0]]

    def start(self, timeout: float = 120.0) -> None:
        self.sharded.release_ports()
        # Fleet owner first: its sidecars must listen before the other
        # groups' replicas dial them at verify time.
        for gid in self.sharded.group_ids():
            self.launchers[gid].start(timeout=timeout)

    def heights(self) -> dict:
        return {gid: l.heights() for gid, l in sorted(self.launchers.items())}

    def wait_heights(self, height: int, timeout: float) -> bool:
        deadline_each = max(timeout / max(len(self.launchers), 1), 1.0)
        return all(
            self.launchers[gid].wait_height(height, deadline_each)
            for gid in self.sharded.group_ids()
        )

    def observe_invariants(self) -> None:
        for launcher in self.launchers.values():
            launcher.observe_invariants()

    def stop(self) -> dict:
        """Tear down non-owning groups first, the fleet owner last (its
        stop kills the shared sidecars and audits their ports).  Every
        launcher's zero-orphan assertion runs; summaries are per group."""
        summaries = {}
        errors = []
        for gid in reversed(self.sharded.group_ids()):
            try:
                summaries[gid] = self.launchers[gid].stop()
            except BaseException as exc:  # audit all groups, then raise
                errors.append((gid, exc))
        if errors:
            raise errors[0][1]
        return summaries


__all__ = ["ShardedClusterLauncher", "ShardedDeploySpec"]
