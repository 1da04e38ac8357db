"""Sidecar verifier process entry for the deployment rig.

``python -m consensus_tpu_torch.deploy.sidecar_main --config cluster.json
--sidecar-id sc-K`` serves signature verification over authenticated TCP
(:class:`~consensus_tpu_torch.net.sidecar.VerifySidecarServer`) as one member of
the horizontally scaled fleet.  Replicas reach it through
:class:`~consensus_tpu_torch.ingress.placement.SidecarFleet`; killing this
process mid-run exercises the client's structured reroute path (the
fleet's reroute story), and the autoscaler drains/adds members by
stopping/spawning these processes.

The control socket exposes wave counters (offered/rejected) and an
``engine_degraded`` flag — the two autoscaler input signals — plus a
``degrade`` chaos arm that makes the engine wrapper report degraded
without changing verdicts (the engine supervisor's shape: degraded means slow-but-
correct, served from the host twin).

The PyTorch port's copy of ``consensus_tpu/deploy/sidecar_main.py``, its
imports renamed.  One divergence (ROADMAP.md queue C, divergence 25):
``--device`` names where the verifier lives (``cuda`` when it is not given,
as every entry point of the port).  Without a card and without
``--device cpu`` the process exits non-zero with the device error; it never
carries on on the CPU.  The threshold stays the JAX main's, so the waves
verify on the host path either way.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading


class _CountingEngine:
    """Engine wrapper: counts waves for the autoscaler signals and honors
    a chaos-armed degraded flag (verdicts never change — degraded is a
    health report, not a correctness state)."""

    def __init__(self, inner) -> None:
        self._inner = inner
        self.offered = 0
        self.degraded = False
        self._lock = threading.Lock()

    def verify_batch(self, messages, signatures, public_keys):
        with self._lock:
            self.offered += len(messages)
        return self._inner.verify_batch(messages, signatures, public_keys)

    def verify_host(self, messages, signatures, public_keys):
        with self._lock:
            self.offered += len(messages)
        return self._inner.verify_host(messages, signatures, public_keys)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--sidecar-id", required=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    logging.basicConfig(
        level=logging.INFO,
        stream=sys.stderr,
        format=f"[{args.sidecar_id}] %(name)s %(levelname)s %(message)s",
    )

    from consensus_tpu_torch.deploy.control import ControlServer
    from consensus_tpu_torch.deploy.spec import ClusterSpec
    from consensus_tpu_torch.models.ed25519 import Ed25519BatchVerifier
    from consensus_tpu_torch.net.sidecar import VerifySidecarServer

    spec = ClusterSpec.load(args.config)
    me = spec.sidecar(args.sidecar_id)

    # Host path: on a machine without an accelerator the sidecar still
    # serves real Ed25519 verification (pure host batches); with one, drop
    # min_device_batch to route big waves to the device.
    engine = _CountingEngine(
        Ed25519BatchVerifier(min_device_batch=10**9, device=args.device)
    )
    server = VerifySidecarServer(
        (me.host, me.port), engine, auth_secret=spec.auth_secret
    )
    server.start()

    stop_event = threading.Event()
    rejected = [0]

    def _health(_request) -> dict:
        return {
            "ok": True,
            "role": "sidecar",
            "sidecar_id": args.sidecar_id,
            "pid": os.getpid(),
            "offered": engine.offered,
            "rejected": rejected[0],
            "engine_degraded": engine.degraded,
        }

    def _degrade(request) -> dict:
        engine.degraded = bool(request.get("degraded", True))
        return {"ok": True, "engine_degraded": engine.degraded}

    control = ControlServer(
        {
            "ping": lambda r: {"ok": True, "pid": os.getpid(),
                               "role": "sidecar",
                               "sidecar_id": args.sidecar_id},
            "health": _health,
            "degrade": _degrade,
            "exit": lambda r: (stop_event.set(), {"ok": True})[1],
        },
        host=me.host,
        port=me.control_port,
    )
    print(json.dumps({"ready": True, "sidecar_id": args.sidecar_id,
                      "pid": os.getpid()}), flush=True)

    while not stop_event.wait(0.5):
        pass

    server.stop()
    control.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
