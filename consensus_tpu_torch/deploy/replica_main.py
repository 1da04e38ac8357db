"""Replica process entry for the deployment rig.

``python -m consensus_tpu_torch.deploy.replica_main --config cluster.json
--node-id N`` boots ONE consensus replica as its own OS process: real TCP
consensus links (hardened reconnect path), a real SyncListener serving its
ledger on the spec'd port, a file-backed WAL under the spec'd directory
(recovered with ``initialize_and_read_all`` + quarantine on every boot, so
a ``kill -9`` restart resumes from its intact durable prefix), signature
verification through the sidecar fleet when one is configured (with
placement-aware reroute on sidecar death), and a control socket answering
health probes, Prometheus scrapes, and chaos arms.

Everything this process IS comes from the config file plus its WAL
directory — which is exactly the restart contract the supervisor relies
on.

A child process lives on the real clock by definition; the audited
``# wallclock-ok`` escapes below cover its serving loop and scrape
timestamps.

The PyTorch port's copy of ``consensus_tpu/deploy/replica_main.py``, its
imports renamed.  One divergence (ROADMAP.md queue C, divergence 25):
``--device`` names where the host engine lives (``cuda`` when it is not
given); without a card and without ``--device cpu`` the process exits
non-zero with the device error.  Health and control answers carry no
device field: they stay the JAX main's, byte for byte.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading
import time


class _StubCluster:
    """Cross-process deployments have no in-process ledger registry: the
    toy sync shortcut answers empty (real catch-up rides the verified
    LedgerSynchronizer below)."""

    nodes: dict = {}

    def longest_ledger(self, *, exclude):
        return []

    def reconfig_of(self, proposal):
        from consensus_tpu_torch.types import Reconfig

        return Reconfig()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--node-id", type=int, required=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    logging.basicConfig(
        level=logging.INFO,
        stream=sys.stderr,
        format=f"[replica-{args.node_id}] %(name)s %(levelname)s %(message)s",
    )

    from consensus_tpu_torch.consensus import Consensus
    from consensus_tpu_torch.deploy.control import ControlServer
    from consensus_tpu_torch.deploy.identity import (
        make_client_keyring,
        make_node_signer,
        make_sig_verifier,
    )
    from consensus_tpu_torch.deploy.spec import ClusterSpec
    from consensus_tpu_torch.ingress.placement import SidecarFleet
    from consensus_tpu_torch.metrics import InMemoryProvider, Metrics
    from consensus_tpu_torch.models.ed25519 import Ed25519BatchVerifier
    from consensus_tpu_torch.net import SidecarVerifierClient, TcpComm
    from consensus_tpu_torch.obs.export import sample_to_prometheus
    from consensus_tpu_torch.runtime import RealtimeScheduler
    from consensus_tpu_torch.sync import (
        LedgerDecisionStore,
        LedgerSynchronizer,
        SyncListener,
        SyncServer,
        TcpSyncTransport,
    )
    from consensus_tpu_torch.testing.crypto_app import SignedRequestApp
    from consensus_tpu_torch.testing.storage import StorageFaultInjector
    from consensus_tpu_torch.wal.log import initialize_and_read_all

    spec = ClusterSpec.load(args.config)
    me = spec.replica(args.node_id)
    node_ids = spec.node_ids()
    secret = spec.auth_secret

    # --- identity + engine ------------------------------------------------
    host_engine = Ed25519BatchVerifier(min_device_batch=10**9, device=args.device)
    fleet = None
    if spec.sidecars:
        fleet = SidecarFleet(
            spec.sidecar_addresses(),
            client_factory=lambda addr: SidecarVerifierClient(
                tuple(addr),
                local_engine=host_engine,
                bypass_below=spec.sidecar_bypass_below,
                request_timeout=spec.sidecar_request_timeout,
                auth_secret=secret,
            ),
        )
        primary = fleet.assign(f"replica-{args.node_id}")
        engine = SidecarVerifierClient(
            spec.sidecar_addresses()[primary],
            local_engine=host_engine,
            bypass_below=spec.sidecar_bypass_below,
            request_timeout=spec.sidecar_request_timeout,
            auth_secret=secret,
            fleet=fleet,
            fleet_id=primary,
        )
    else:
        engine = host_engine

    signer = make_node_signer(spec.key_namespace, args.node_id)
    verifier = make_sig_verifier(spec.key_namespace, node_ids, engine=engine)
    clients = make_client_keyring(spec.key_namespace, spec.clients)

    cluster = _StubCluster()
    app = SignedRequestApp(
        args.node_id, cluster, signer, verifier,
        client_keys=clients.public_keys, engine=engine, sig_len=64,
    )

    # --- runtime + transports --------------------------------------------
    provider = InMemoryProvider()
    metrics = Metrics(provider)
    rt = RealtimeScheduler()
    rt.start(thread_name=f"replica-{args.node_id}")
    consensus_holder: list = [None]

    member_ids = set(node_ids)

    def route(sender, payload, is_request):
        c = consensus_holder[0]
        if c is None:
            return
        if is_request:
            if sender in member_ids:
                # Replica-to-replica forward (pool timeout cascade).
                c.handle_request(sender, payload)
            else:
                # Client ingress over the request channel (the deploy
                # driver): verify before pooling, same hygiene as the
                # leader-forward path.
                try:
                    app.verify_request(payload)
                except Exception:
                    return
                c.submit_request(payload)
        else:
            c.handle_message(sender, payload)

    comm = TcpComm(
        args.node_id, spec.comm_addresses(), route,
        reconnect_backoff=0.05, auth_secret=secret, metrics=metrics.network,
    )
    comm.start()

    store = LedgerDecisionStore(app.ledger)
    sync_listener = SyncListener(
        SyncServer(store), host=me.host, port=me.sync_port
    )
    synchronizer = LedgerSynchronizer(
        node_id=args.node_id,
        store=store,
        transport=TcpSyncTransport(
            args.node_id,
            {i: a for i, a in spec.sync_addresses().items()
             if i != args.node_id},
        ),
        verifier=app,
        nodes=node_ids,
        reconfig_of=cluster.reconfig_of,
    )

    # --- WAL: recover the durable prefix on every boot --------------------
    wal, entries = initialize_and_read_all(me.wal_dir, quarantine_corrupt=True)
    injector = StorageFaultInjector(seed=args.node_id)
    injector.install(wal)
    restarted = bool(entries)

    # Rejoin flow after a restart: catch up through verified sync before
    # contending (Configuration is frozen — set at construction).
    config = spec.make_configuration(
        args.node_id, **({"sync_on_start": True} if restarted else {})
    )

    consensus = Consensus(
        config=config,
        scheduler=rt,
        comm=comm,
        application=app,
        assembler=app,
        wal=wal,
        signer=app,
        verifier=app,
        request_inspector=app.inspector,
        synchronizer=synchronizer,
        wal_initial_content=entries,
        metrics=metrics,
    )
    consensus.start()
    consensus_holder[0] = consensus

    # --- control socket ---------------------------------------------------
    stop_event = threading.Event()
    scrape_count = [0]

    def _health(_request) -> dict:
        h = dict(consensus.controller.health()) if consensus.controller else {}
        h.update(
            ok=True, role="replica", node_id=args.node_id, pid=os.getpid(),
            running=True, ledger=len(app.ledger), restarted=restarted,
            wal_recovery=bool(getattr(wal, "recovery", None)),
        )
        return h

    def _ledger(request) -> dict:
        start = int(request.get("from", 0))
        digests = [d.proposal.digest() for d in list(app.ledger)]
        return {"height": len(digests), "digests": digests[start:]}

    def _prom(_request) -> dict:
        h = _health({})
        health = {
            "running": True,
            "view": h.get("view", -1),
            "leader": h.get("leader", -1),
            "seq": h.get("seq", -1),
            "in_flight": h.get("in_flight", 0),
            "syncing": bool(h.get("syncing", False)),
            "pool": 0,
            "wal_entries": len(getattr(wal, "entries", ()) or ()) or -1,
            "wal_fsyncs": getattr(wal, "fsync_count", -1),
            "ledger": len(app.ledger),
            "sync_lag": 0,
            "epoch": h.get("epoch", 0),
        }
        sample = {
            "t": round(time.time(), 6),  # wallclock-ok
            "i": scrape_count[0],
            "nodes": {str(args.node_id): {
                "health": health, "metrics": provider.dump(),
            }},
            "anomalies": [],
        }
        scrape_count[0] += 1
        return {"ok": True, "text": sample_to_prometheus(sample)}

    def _storage_fault(request) -> dict:
        kind = request["kind"]
        injector.arm(
            kind,
            budget=request.get("budget"),
            count=int(request.get("count", 1)),
        )
        return {"ok": True, "armed": kind}

    handlers = {
        "ping": lambda r: {"ok": True, "pid": os.getpid(),
                           "role": "replica", "node_id": args.node_id},
        "health": _health,
        "ledger": _ledger,
        "metrics": lambda r: {"ok": True, "metrics": provider.dump()},
        "prom": _prom,
        "net_pause": lambda r: (comm.pause_listener(), {"ok": True})[1],
        "net_resume": lambda r: (comm.resume_listener(), {"ok": True})[1],
        "storage_fault": _storage_fault,
        "storage_heal": lambda r: (injector.heal(), {"ok": True})[1],
        "exit": lambda r: (stop_event.set(), {"ok": True})[1],
    }
    control = ControlServer(
        handlers, host=me.host, port=me.control_port
    )
    print(json.dumps({"ready": True, "node_id": args.node_id,
                      "pid": os.getpid()}), flush=True)

    while not stop_event.wait(0.5):
        pass

    consensus.stop()
    comm.stop()
    sync_listener.close()
    control.close()
    try:
        rt.stop(timeout=2.0)
    except RuntimeError:
        pass
    try:
        wal.close()
    except Exception:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
