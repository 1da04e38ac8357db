"""Ingress driver process for the deployment rig.

``python -m consensus_tpu_torch.deploy.driver_main --config cluster.json
--seconds S`` is the ingress plane running as its own OS process:
it generates the deterministic client trace
(:func:`~consensus_tpu_torch.ingress.workload.generate_trace` — the same
million-client generator the sim driver replays), pushes every arrival
through a real :class:`~consensus_tpu_torch.ingress.admission.AdmissionController`,
signs admitted requests with the cluster's derived client keys, and
broadcasts them to every replica over its own authenticated ``TcpComm``
link (open-loop: a slow cluster never back-pressures the arrival
process).

On exit it prints ONE JSON summary line on stdout: offered / admitted /
submitted counts plus the final replica heights it observed over the
control sockets — the soak driver's load-side ground truth.

Replay happens on the real clock by definition (the trace's sim arrival
times are mapped onto wall time): hence the audited ``# wallclock-ok``
escapes.

The PyTorch port's copy of ``consensus_tpu/deploy/driver_main.py``, its imports renamed.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
import zlib

#: The driver's node id on the consensus transport: far outside the
#: replica id range, pinned by HELLO like any other peer.
DRIVER_NODE_ID = 900


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--trace-clients", type=int, default=64,
                    help="trace cohort size (the generator scales to "
                    "millions; CI uses a small cohort)")
    ap.add_argument("--rate", type=float, default=40.0,
                    help="approximate offered events/sec after time scaling")
    args = ap.parse_args()

    logging.basicConfig(
        level=logging.WARNING, stream=sys.stderr,
        format="[driver] %(name)s %(levelname)s %(message)s",
    )

    from consensus_tpu_torch.deploy.control import ControlClient
    from consensus_tpu_torch.deploy.identity import make_client_keyring
    from consensus_tpu_torch.deploy.spec import ClusterSpec, free_ports
    from consensus_tpu_torch.ingress.admission import AdmissionController
    from consensus_tpu_torch.ingress.workload import clean_spec, generate_trace
    from consensus_tpu_torch.net import TcpComm
    from consensus_tpu_torch.types import RequestInfo

    spec = ClusterSpec.load(args.config)
    keyring = make_client_keyring(spec.key_namespace, spec.clients)

    # Deterministic trace, scaled to the requested wall duration/rate.
    wspec = clean_spec(
        clients=args.trace_clients,
        tenants=4,
        duration=max(1.0, args.seconds),
    )
    trace = generate_trace(args.seed, wspec)
    if not trace:
        print(json.dumps({"error": "empty trace"}))
        return 1
    # Map trace sim-time onto [0, seconds].
    t_max = max(e.t for e in trace) or 1.0
    scale = args.seconds / t_max

    # Per-client token buckets sized so the offered wall rate spread over
    # the signing cohort mostly clears admission (some rate-limiting under
    # bursts is the admission semantics this plane exists to exercise).
    per_client = max(2.0, 2.0 * args.rate / max(1, spec.clients))
    admission = AdmissionController(rate=per_client, burst=2 * per_client)

    addresses = dict(spec.comm_addresses())
    addresses[DRIVER_NODE_ID] = ("127.0.0.1", free_ports(1)[0])
    comm = TcpComm(
        DRIVER_NODE_ID, addresses, lambda *a: None,
        reconnect_backoff=0.05, auth_secret=spec.auth_secret,
    )
    comm.start()

    offered = admitted = submitted = 0
    seq_per_client: dict = {}
    start = time.monotonic()  # wallclock-ok
    deadline = start + args.seconds
    for event in trace:
        target = start + event.t * scale
        now = time.monotonic()  # wallclock-ok
        if now >= deadline:
            break
        if target > now:
            time.sleep(min(target - now, 0.25))
        offered += 1
        # Trace client names ('h000007', 'a00003', ...) map stably onto
        # the cluster's derived client-key cohort.
        client_idx = zlib.crc32(event.client.encode()) % spec.clients
        info = RequestInfo(
            client_id=str(client_idx),
            request_id=f"{event.rid}",
        )
        verdict = admission.admit(
            time.monotonic() - start, info, size=1  # wallclock-ok
        )
        if verdict != "admitted":
            continue
        admitted += 1
        seq = seq_per_client.get(client_idx, 0)
        seq_per_client[client_idx] = seq + 1
        raw = keyring.make_request(client_idx, (client_idx << 32) | seq)
        for node_id in spec.node_ids():
            comm.send_transaction(node_id, raw)
        submitted += 1

    elapsed = time.monotonic() - start  # wallclock-ok
    # Final heights over the control plane (best effort).
    heights = {}
    for r in spec.replicas:
        reply = ControlClient(
            (r.host, r.control_port), timeout=2.0
        ).try_call("health")
        if reply is not None and "ledger" in reply:
            heights[str(r.node_id)] = reply["ledger"]
    comm.stop()
    print(
        json.dumps({
            "offered": offered,
            "admitted": admitted,
            "submitted": submitted,
            "elapsed_secs": round(elapsed, 2),
            "heights": heights,
        }, sort_keys=True),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
