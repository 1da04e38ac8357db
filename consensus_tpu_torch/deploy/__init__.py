"""Process-per-replica deployment rig.

Everything before this package runs the cluster as threads inside one
Python process.  This package runs it the way the reference system ships:
N consensus replicas, a horizontally scaled sidecar verifier fleet, and
the ingress driver as **separate OS processes** over the real TCP
transports and file-backed WALs — under an init-style supervisor with
``kill -9`` chaos, fleet autoscaling, and an invariant monitor that holds
across restarts.

Layers:

* :mod:`~consensus_tpu_torch.deploy.spec` — ``cluster.json``: the one document
  that distributes ports, keys, and config to every process,
* :mod:`~consensus_tpu_torch.deploy.control` — JSON-line control sockets
  (health probes, scrapes, chaos arms),
* :mod:`~consensus_tpu_torch.deploy.supervisor` — spawn / probe / restart with
  capped backoff, flight-record capture on death,
* :mod:`~consensus_tpu_torch.deploy.launcher` — the operator console: boots the
  fleet, scrapes it, runs the chaos verbs, asserts clean teardown,
* :mod:`~consensus_tpu_torch.deploy.autoscaler` — sidecar fleet sizing on
  overload / degraded signals,
* :mod:`~consensus_tpu_torch.deploy.invariants` — prefix agreement and
  durable-before-visible across process restarts,
* :mod:`~consensus_tpu_torch.deploy.chaos` — the seeded process-chaos schedule,
* ``replica_main`` / ``sidecar_main`` / ``driver_main`` — the child
  process entry points.

The PyTorch port's copy of ``consensus_tpu/deploy/__init__.py``, its imports renamed.
"""

from consensus_tpu_torch.deploy.autoscaler import AutoscaleDecision, FleetAutoscaler
from consensus_tpu_torch.deploy.chaos import (
    DEFAULT_ACTION_WEIGHTS,
    STORAGE_FAULT_KINDS,
    ProcessChaosSchedule,
)
from consensus_tpu_torch.deploy.control import ControlClient, ControlServer
from consensus_tpu_torch.deploy.invariants import DeployInvariantMonitor
from consensus_tpu_torch.deploy.launcher import ClusterLauncher
from consensus_tpu_torch.deploy.spec import (
    ClusterSpec,
    ReplicaSpec,
    SidecarSpec,
    free_ports,
)
from consensus_tpu_torch.deploy.supervisor import NodeSupervisor

__all__ = [
    "AutoscaleDecision",
    "ClusterLauncher",
    "ClusterSpec",
    "ControlClient",
    "ControlServer",
    "DEFAULT_ACTION_WEIGHTS",
    "DeployInvariantMonitor",
    "FleetAutoscaler",
    "NodeSupervisor",
    "ProcessChaosSchedule",
    "ReplicaSpec",
    "SidecarSpec",
    "STORAGE_FAULT_KINDS",
    "free_ports",
]
