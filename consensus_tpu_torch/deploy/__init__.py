"""Process-per-replica deployment rig: the part of it the port has so far.

The JAX package's ``deploy/`` runs the cluster as separate OS processes
over the real TCP transports and file-backed WALs.  The port carries its
JSON-line control sockets (:mod:`~consensus_tpu_torch.deploy.control`:
health probes, scrapes, chaos arms), a copy of the JAX module.  The rest
of ``deploy/`` (the spec, the supervisor, the launcher, the autoscaler, the
invariant monitor, the process chaos and the child-process mains) is
ROADMAP.md queue A item 14b.
"""

from consensus_tpu_torch.deploy.control import ControlClient, ControlServer

__all__ = ["ControlClient", "ControlServer"]
