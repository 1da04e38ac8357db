"""Cluster specification: the one JSON document the launcher distributes.

``ClusterSpec.generate`` mints everything a process-per-replica deployment
needs — consensus/sync/control ports for every replica, sidecar fleet
addresses, a fresh ``auth_secret`` (TCP handshake HMAC for both the
consensus links and the sidecar service), the ``key_namespace`` all
processes derive their Ed25519 identities from, and per-replica WAL
directories — and ``write()`` drops it as ``cluster.json`` under the
cluster's base directory.  Child processes are started with nothing but
``--config <cluster.json> --node-id N`` (or ``--sidecar-id``): config and
key distribution is exactly this one file, which is also what a restart
after ``kill -9`` re-reads.

Consensus tuning knobs ride along in ``config_overrides`` (plain
``Configuration`` field values) so tests can shrink view-change timeouts
without a second distribution channel.

The PyTorch port's copy of ``consensus_tpu/deploy/spec.py``, its imports renamed.
"""

from __future__ import annotations

import json
import os
import secrets
import socket
from dataclasses import asdict, dataclass, field
from typing import Optional


class PortReservation:
    """``n`` localhost ports, BOUND AND HELD until :meth:`release`.

    The old ``free_ports`` picked ports by bind-then-close, leaving a
    TOCTOU window from spec generation all the way to child spawn: two
    launchers generating specs concurrently could each draw the other's
    just-closed ports and collide at boot.  A reservation keeps the
    sockets bound, so the kernel itself arbitrates — while one launcher
    holds its reservation, no other ``PortReservation``/``free_ports``
    call (or anything else binding an ephemeral port) can be handed any
    of its ports.  The launcher releases JUST BEFORE spawning children
    (``ClusterLauncher.start``), shrinking the race window from
    "generate -> spawn" to the microseconds between ``close()`` and the
    child's own ``bind()`` — and that residual race is against random
    ephemeral allocation, not against another launcher's deliberate
    reuse of the same port list.
    """

    def __init__(self, n: int, host: str = "127.0.0.1") -> None:
        self._socks = []
        try:
            for _ in range(n):
                s = socket.socket()
                s.bind((host, 0))
                self._socks.append(s)
        except OSError:
            self.release()
            raise
        #: The reserved port numbers, stable for the reservation's life.
        self.ports = [s.getsockname()[1] for s in self._socks]

    @property
    def held(self) -> bool:
        return bool(self._socks)

    def release(self) -> None:
        """Close every held socket (idempotent) — call immediately before
        handing the ports to child processes."""
        socks, self._socks = self._socks, []
        for s in socks:
            try:
                s.close()
            except OSError:
                pass

    def __enter__(self) -> "PortReservation":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def free_ports(n: int) -> list:
    """``n`` currently-free localhost ports (bind-then-close, released
    immediately).  Callers that go on to spawn processes on these ports
    should prefer :class:`PortReservation` + ``hold_ports=True`` on
    ``ClusterSpec.generate``: a released port can be claimed by anyone
    between this call and the child's own bind."""
    with PortReservation(n) as reservation:
        return list(reservation.ports)


@dataclass
class ReplicaSpec:
    node_id: int
    host: str
    port: int          # consensus TcpComm listen port
    sync_port: int     # SyncListener (verified catch-up fetch channel)
    control_port: int  # ControlServer (health probe / scrape / chaos ops)
    wal_dir: str


@dataclass
class SidecarSpec:
    sidecar_id: str
    host: str
    port: int          # VerifySidecarServer TCP port
    control_port: int


@dataclass
class ClusterSpec:
    n: int
    base_dir: str
    auth_secret_hex: str
    key_namespace: str
    clients: int = 8
    replicas: list = field(default_factory=list)
    sidecars: list = field(default_factory=list)
    #: Plain Configuration field overrides applied to every replica.
    config_overrides: dict = field(default_factory=dict)
    #: Sidecar-client knobs on the replica side.
    sidecar_bypass_below: int = 64
    sidecar_request_timeout: float = 10.0

    # ------------------------------------------------------------- factory

    @classmethod
    def generate(
        cls,
        n: int,
        n_sidecars: int,
        base_dir: str,
        *,
        clients: int = 8,
        host: str = "127.0.0.1",
        config_overrides: Optional[dict] = None,
        hold_ports: bool = False,
    ) -> "ClusterSpec":
        """Mint a spec on fresh localhost ports.  ``hold_ports=True`` keeps
        the ports BOUND (a :class:`PortReservation` attached to the spec)
        until the launcher releases them right before spawn — the fix for
        the generate-to-spawn TOCTOU; two concurrent launchers holding
        reservations can never draw overlapping port sets."""
        os.makedirs(base_dir, exist_ok=True)
        reservation = PortReservation(3 * n + 2 * n_sidecars, host=host)
        ports = reservation.ports
        spec = cls(
            n=n,
            base_dir=os.path.abspath(base_dir),
            auth_secret_hex=secrets.token_hex(16),
            key_namespace=secrets.token_hex(8),
            clients=clients,
            config_overrides=dict(config_overrides or {}),
        )
        for i in range(n):
            node_id = i + 1
            spec.replicas.append(
                ReplicaSpec(
                    node_id=node_id,
                    host=host,
                    port=ports[3 * i],
                    sync_port=ports[3 * i + 1],
                    control_port=ports[3 * i + 2],
                    wal_dir=os.path.join(
                        spec.base_dir, f"node-{node_id}", "wal"
                    ),
                )
            )
        for k in range(n_sidecars):
            spec.sidecars.append(
                SidecarSpec(
                    sidecar_id=f"sc-{k}",
                    host=host,
                    port=ports[3 * n + 2 * k],
                    control_port=ports[3 * n + 2 * k + 1],
                )
            )
        if hold_ports:
            spec.attach_reservation(reservation)
        else:
            reservation.release()
        return spec

    # Deliberately UNANNOTATED class attribute — not a dataclass field, so
    # reservations stay process-local: never serialized into cluster.json,
    # never survive a load().
    _reservation = None

    def attach_reservation(self, reservation: PortReservation) -> None:
        self._reservation = reservation

    def release_ports(self) -> None:
        """Release a held :class:`PortReservation` (idempotent; no-op for
        specs generated without ``hold_ports``) — the launcher calls this
        immediately before spawning children."""
        reservation = self._reservation
        if reservation is not None:
            reservation.release()

    @property
    def ports_held(self) -> bool:
        return self._reservation is not None and self._reservation.held

    def add_sidecar(self) -> SidecarSpec:
        """Mint a spec for one more sidecar process (autoscaler scale-up).
        The launcher re-writes cluster.json so restarted replicas see the
        grown fleet."""
        taken = {int(s.sidecar_id.split("-", 1)[1]) for s in self.sidecars}
        k = 0
        while k in taken:
            k += 1
        port, control_port = free_ports(2)
        sc = SidecarSpec(
            sidecar_id=f"sc-{k}",
            host=self.replicas[0].host if self.replicas else "127.0.0.1",
            port=port,
            control_port=control_port,
        )
        self.sidecars.append(sc)
        return sc

    # --------------------------------------------------------------- views

    @property
    def auth_secret(self) -> bytes:
        return bytes.fromhex(self.auth_secret_hex)

    @property
    def config_path(self) -> str:
        return os.path.join(self.base_dir, "cluster.json")

    def node_ids(self) -> list:
        return [r.node_id for r in self.replicas]

    def replica(self, node_id: int) -> ReplicaSpec:
        for r in self.replicas:
            if r.node_id == node_id:
                return r
        raise KeyError(f"no replica {node_id} in spec")

    def sidecar(self, sidecar_id: str) -> SidecarSpec:
        for s in self.sidecars:
            if s.sidecar_id == sidecar_id:
                return s
        raise KeyError(f"no sidecar {sidecar_id} in spec")

    def comm_addresses(self) -> dict:
        return {r.node_id: (r.host, r.port) for r in self.replicas}

    def sync_addresses(self) -> dict:
        return {r.node_id: (r.host, r.sync_port) for r in self.replicas}

    def sidecar_addresses(self) -> dict:
        return {s.sidecar_id: (s.host, s.port) for s in self.sidecars}

    # ----------------------------------------------------------------- io

    def write(self) -> str:
        payload = asdict(self)
        path = self.config_path
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "ClusterSpec":
        with open(path, "r", encoding="utf-8") as fh:
            payload = json.load(fh)
        payload["replicas"] = [ReplicaSpec(**r) for r in payload["replicas"]]
        payload["sidecars"] = [SidecarSpec(**s) for s in payload["sidecars"]]
        return cls(**payload)

    def make_configuration(self, node_id: int, **extra):
        """Per-replica ``Configuration`` (frozen dataclass — boot-time
        extras like ``sync_on_start`` must be passed here, not assigned)."""
        from consensus_tpu_torch.config import Configuration

        defaults = dict(
            self_id=node_id,
            leader_rotation=False,
            decisions_per_leader=0,
            request_batch_max_count=20,
            request_batch_max_interval=0.05,
            request_pool_size=2000,
        )
        defaults.update(self.config_overrides)
        defaults.update(extra)
        return Configuration(**defaults)


__all__ = [
    "ClusterSpec",
    "PortReservation",
    "ReplicaSpec",
    "SidecarSpec",
    "free_ports",
]
