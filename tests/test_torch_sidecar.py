"""The JAX package's verification-sidecar tests (``tests/test_sidecar.py``)
on the port's ``net/sidecar.py``, its imports renamed (``torch_mirror``):
the request codec, round trips over TCP and unix sockets, coalescing,
failover to the local engine, the suspect mark and its probe, the mutual
handshake and the frame MACs, the flood bounds, and the multi-tenant
server's fair-share waves, structured admission rejects and handshake
floods.

One JAX case builds ``Ed25519BatchVerifier`` with no device, which the
port refuses on a machine without a card; it runs below with
``device="cpu"`` as its only change.  Frames and verdicts are held against
the JAX package across the packages in ``test_torch_net_parity.py``.
"""

import threading

from torch_mirror import mirror

mirror("test_sidecar", globals(), drop={
    "test_tenant_isolation_under_chaos_flood": (
        "builds Ed25519BatchVerifier with no device, which the port refuses "
        "without a card; re-written below with device=\"cpu\""
    ),
})


def test_tenant_isolation_under_chaos_flood():
    """The multi-tenant service under load: a flooding tenant hammering the
    shared verification service with over-quota sweeps is admission-rejected
    (status 2, bounded queue) while an honest tenant's REAL-crypto consensus
    cluster — running a lossy, delayed, byzantine chaos schedule THROUGH the
    shared sidecar — keeps committing, and the obs ``verify_collapse``
    detector stays silent for every honest node: the flood never starves
    their verify launches."""
    from consensus_tpu_torch.config import ObsConfig
    from consensus_tpu_torch.models import Ed25519BatchVerifier
    from consensus_tpu_torch.net.sidecar import TenantAdmissionReject
    from consensus_tpu_torch.testing.chaos import (
        ChaosAction,
        ChaosEngine,
        ChaosSchedule,
    )

    server = VerifySidecarServer(  # noqa: F821
        ("127.0.0.1", 0),
        Ed25519BatchVerifier(min_device_batch=10**9, device="cpu"),
        tenants={"honest": b"honest-secret", "flood": b"flood-secret"},
        wave_window=0.001,
        tenant_queue_limit=64,
    )
    server.start()

    stop = threading.Event()
    rejects = [0]

    def flood():
        client = SidecarVerifierClient(  # noqa: F821
            server.address, auth_secret=b"flood-secret", tenant="flood",
            request_timeout=5.0,
        )
        try:
            while not stop.is_set():
                try:
                    client.verify_batch(
                        [b"junk"] * 100, [bytes(64)] * 100, [bytes(32)] * 100
                    )
                except TenantAdmissionReject:
                    rejects[0] += 1
                except Exception:
                    pass
        finally:
            client.close()

    flooder = threading.Thread(target=flood, daemon=True)
    flooder.start()
    try:
        def honest_engine():
            return SidecarVerifierClient(  # noqa: F821
                server.address, auth_secret=b"honest-secret", tenant="honest",
                local_engine=Ed25519BatchVerifier(min_device_batch=10**9, device="cpu"),
            )

        # Loss, delay, and a signature-corrupting byzantine node — but no
        # partition/crash, so any verify_collapse firing could only come
        # from the flood starving honest verify launches.
        schedule = ChaosSchedule(
            seed=23,
            n=4,
            actions=(
                ChaosAction(at=20.0, kind="loss",
                            args={"a": 1, "b": 3, "p": 0.1}),
                ChaosAction(at=30.0, kind="byzantine",
                            args={"node": 4, "rate": 0.5}),
                ChaosAction(at=60.0, kind="delay",
                            args={"a": 2, "b": 4, "d": 0.5}),
                ChaosAction(at=90.0, kind="heal"),
            ),
        )
        result = ChaosEngine(
            schedule, crypto="ed25519", engine_factory=honest_engine,
            obs=ObsConfig(enabled=True, sample_interval=5.0),
        ).run()
    finally:
        stop.set()
        flooder.join(timeout=10.0)
        server.stop()

    assert result.ok, result.violation
    assert rejects[0] > 0, "the flooding tenant was never admission-rejected"
    collapse = [a for a in result.anomalies if a.kind == "verify_collapse"]
    assert not collapse, f"flood starved honest verify launches: {collapse}"
