"""The one supported reconfiguration harness for Cluster-based tests.

Lifted out of the test files (PR 9): a membership change in a test cluster
is an ORDINARY ORDERED REQUEST whose payload names the new member set
(``nodes=1,2,3``); when any replica surfaces that decision —
commit-path delivery or wire-sync replay — :func:`install_reconfig_hook`'s
interpreter turns it into a ``Reconfig`` carrying the new epoch's
:class:`~consensus_tpu_torch.membership.MembershipConfig`, records the change in
the cluster's :class:`~consensus_tpu_torch.membership.MembershipDirectory`, and
routes the network-level membership through ``SimNetwork.set_membership``
(epoch-bumped, removed-node deliveries accounted).

Idempotence is keyed on the proposal digest: every replica delivers the
same decision, and a lagging replica re-surfaces it through sync — only the
first sighting assigns an epoch; later sightings (including stale replays)
return the already-recorded config and leave the network membership at the
directory's CURRENT epoch.

The PyTorch port's copy of ``consensus_tpu/testing/membership.py``, its imports renamed.
"""

from __future__ import annotations

from consensus_tpu_torch.membership import MembershipDirectory
from consensus_tpu_torch.testing.app import Cluster, Node, make_request, unpack_batch
from consensus_tpu_torch.types import Proposal, Reconfig
from consensus_tpu_torch.wire import decode_view_metadata


def reconfig_request(rid, nodes) -> bytes:
    """An admin request whose commit changes membership to ``nodes``."""
    payload = b"nodes=" + ",".join(str(n) for n in nodes).encode()
    return make_request("admin", rid, payload)


def install_reconfig_hook(cluster: Cluster) -> MembershipDirectory:
    """Install the membership interpreter on ``cluster``; returns the
    directory (also stored as ``cluster.membership_directory``).

    Installs via ``cluster._membership_interpreter`` — ``Cluster.reconfig_of``
    stays a stable bound method (the LedgerSynchronizer captures it at
    ``Node.start``), so install order relative to node starts is free.
    """
    directory = MembershipDirectory(cluster.network.node_ids())
    cluster.membership_directory = directory

    def interpret(proposal: Proposal) -> Reconfig:
        try:
            requests = unpack_batch(proposal.payload)
        except Exception:
            return Reconfig()
        for raw in requests:
            _, _, payload = raw.partition(b"|")
            if payload.startswith(b"nodes="):
                ids = tuple(int(x) for x in payload[6:].split(b","))
                try:
                    seq = decode_view_metadata(proposal.metadata).latest_sequence
                except Exception:
                    seq = 0
                cfg = directory.record_change(proposal.digest(), seq, ids)
                # Network membership follows the directory's CURRENT epoch
                # (a stale sync replay of an old change must not drag it
                # backwards).
                current = directory.current
                cluster.network.set_membership(
                    list(current.nodes), epoch=current.epoch
                )
                reconfig = Reconfig(
                    in_latest_decision=True,
                    current_nodes=cfg.nodes,
                    membership=cfg,
                )
                # Cache by digest: later sightings skip re-parsing and the
                # synchronizer's per-proposal reconfig_of stays cheap.
                cluster._reconfigs[proposal.digest()] = reconfig
                return reconfig
        return Reconfig()

    cluster._membership_interpreter = interpret
    return directory


def boot_node(cluster: Cluster, node_id: int) -> Node:
    """Boot a freshly-admitted node WITHOUT the JoinBootstrap driver: it
    catches up through heartbeat-gap detection + sync, exactly like the
    historical test-local ``_boot_node`` (kept for ledger parity on pinned
    seeds; new tests should prefer ``cluster.add_node(node_id)``)."""
    return cluster.add_node(node_id, bootstrap=False)


__all__ = ["boot_node", "install_reconfig_hook", "reconfig_request"]
