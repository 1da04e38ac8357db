"""Consistent-hash tenant→sidecar placement over a horizontally scaled fleet.

Rendezvous (highest-random-weight) hashing: every (server, tenant) pair gets
a deterministic 64-bit score derived from SHA-256, and a tenant lives on the
highest-scoring server.  The property the fleet leans on: removing one
server moves ONLY the tenants whose top candidate was that server (~1/N of
them, exactly — every other tenant's ranking among the survivors is
untouched), and adding a server steals only the tenants it now outscores.
No ring state, no virtual-node tuning, no RNG — placement is a pure
function of the (server id, tenant id) strings, so every ingress process
computes the same map independently.

:class:`SidecarFleet` packages a ring over live
:class:`~consensus_tpu_torch.net.sidecar.VerifySidecarServer` addresses with a
per-server client cache — the structured retry path
(``SidecarVerifierClient(fleet=...)``) walks ``candidates()`` order when a
fleet member answers with a ``TenantAdmissionReject``, bumping the pinned
``ingress_reroute_total`` counter through :meth:`SidecarFleet.on_reroute`.

The PyTorch port's copy of ``consensus_tpu/ingress/placement.py``, its imports renamed.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Iterable, Optional


def _score(server: str, tenant: str) -> int:
    """64-bit rendezvous weight for placing ``tenant`` on ``server``."""
    digest = hashlib.sha256(
        b"ctpu/ingress/placement/v1\x00"
        + server.encode() + b"\x00" + tenant.encode()
    ).digest()
    return int.from_bytes(digest[:8], "big")


class PlacementRing:
    """Rendezvous-hash placement over a mutable server set."""

    def __init__(self, servers: Iterable[str] = ()) -> None:
        self._servers: set[str] = set()
        for s in servers:
            self.add(s)

    def add(self, server: str) -> None:
        if not server:
            raise ValueError("server id must be non-empty")
        self._servers.add(server)

    def remove(self, server: str) -> None:
        self._servers.discard(server)

    def servers(self) -> tuple[str, ...]:
        return tuple(sorted(self._servers))

    def __len__(self) -> int:
        return len(self._servers)

    def candidates(self, tenant: str) -> list[str]:
        """Every server, best placement first.  Ties (astronomically
        unlikely) break on the server id so the order is total."""
        if not self._servers:
            raise ValueError("placement ring has no servers")
        return sorted(
            self._servers, key=lambda s: (-_score(s, tenant), s)
        )

    def assign(self, tenant: str) -> str:
        return self.candidates(tenant)[0]

    def assignment_map(self, tenants: Iterable[str]) -> dict[str, str]:
        """tenant -> server for a whole tenant population (the remap tests
        diff two of these across a join/leave)."""
        return {t: self.assign(t) for t in tenants}


class SidecarFleet:
    """A placement ring bound to concrete fleet addresses.

    ``client_factory(address)`` builds the transport used for rerouted
    batches (tests pass a factory closing over auth secrets); clients are
    cached per server id.  ``metrics`` is a
    :class:`~consensus_tpu_torch.metrics.MetricsIngress` bundle (or None) —
    every reroute hop bumps the pinned ``ingress_reroute_total`` counter
    and, with a tracer attached, an ``ingress.reroute`` instant.
    """

    def __init__(
        self,
        addresses: dict[str, object],
        *,
        client_factory: Callable[[object], object],
        metrics=None,
        tracer=None,
    ) -> None:
        if not addresses:
            raise ValueError("fleet needs at least one server")
        self.ring = PlacementRing(addresses)
        self.addresses = dict(addresses)
        self._client_factory = client_factory
        self._clients: dict[str, object] = {}
        self.metrics = metrics
        self.tracer = tracer
        #: (tenant, from_server, to_server) reroute hops, in order.
        self.reroutes: list[tuple[str, str, str]] = []
        #: Servers currently answering with status 3 (their supervised
        #: engine is below its top rung).  Fed by
        #: :class:`~consensus_tpu_torch.net.sidecar.SidecarVerifierClient` at
        #: response time; cleared by the first status-0 answer.
        self._degraded: set[str] = set()

    def candidates(self, tenant: Optional[str]) -> list[str]:
        """Rendezvous order, but NON-DEGRADED servers first: a degraded
        server still serves correct verdicts (its supervisor's host twin is
        ground truth), so it stays a candidate — just the last resort.  The
        sort is stable, so within each health class the deterministic ring
        order is preserved."""
        order = self.ring.candidates(tenant or "")
        if not self._degraded:
            return order
        return sorted(order, key=lambda s: s in self._degraded)

    def note_degraded(self, server_id: str, degraded: bool = True) -> None:
        """Record ``server_id``'s engine health as seen on the wire (the
        status byte of its last verify answer).  Unknown ids are accepted —
        health is an observation, not a membership operation."""
        if degraded:
            self._degraded.add(server_id)
        else:
            self._degraded.discard(server_id)

    def is_degraded(self, server_id: str) -> bool:
        return server_id in self._degraded

    def assign(self, tenant: Optional[str]) -> str:
        return self.ring.assign(tenant or "")

    def client_for(self, server_id: str):
        client = self._clients.get(server_id)
        if client is None:
            client = self._clients[server_id] = self._client_factory(
                self.addresses[server_id]
            )
        return client

    def on_reroute(
        self, tenant: Optional[str], from_id: str, to_id: str
    ) -> None:
        self.reroutes.append((tenant or "", from_id, to_id))
        if self.metrics is not None:
            self.metrics.count_reroutes.add(1)
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            tracer.instant(
                "ingress", "ingress.reroute",
                tenant=tenant or "", src=from_id, dst=to_id,
            )

    def close(self) -> None:
        for client in self._clients.values():
            close = getattr(client, "close", None)
            if close is not None:
                close()
        self._clients.clear()


__all__ = ["PlacementRing", "SidecarFleet"]
