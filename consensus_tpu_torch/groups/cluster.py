"""ShardedCluster: N consensus groups on one sim clock, one verifier fleet.

Horizontal sharding of the consensus plane: each group is a full
:class:`~consensus_tpu_torch.testing.app.Cluster` (n replicas, its own
SimNetwork, its own WALs, its own ledger) and tenants are partitioned
across groups by the rendezvous directory
(:class:`~consensus_tpu_torch.groups.directory.GroupDirectory`).  Three things
are deliberately SHARED:

* **The clock** — every group runs on ONE :class:`SimScheduler`, so
  cross-group facts ("group A committed before group B aborted") are
  totally ordered and the chaos engine can interleave per-group faults
  deterministically.  Each group keeps its own SimNetwork: a partition in
  group A cannot leak into group B.
* **The cross-group witness** — one :class:`CrossGroupRegistry` receives
  every group's 2PC participant transitions; each group's
  :class:`~consensus_tpu_torch.testing.invariants.InvariantMonitor` mirrors its
  atomicity violations at every delivery (``attach_cross_group``).
* **The verifier fleet** — replicas of ALL groups verify through one
  multi-tenant wave former.  The deployment win this harness measures:
  with the group id part of the admission identity, one fused device
  launch serves quorum certs from several groups at once
  (:class:`~consensus_tpu_torch.models.engine.FairShareWaveFormer` — SAFETY §7
  holds because waves are formed from whole submissions, so no cert ever
  mixes engines).

**Determinism.** Group i's consensus run is byte-identical to a
standalone ``Cluster`` built with the same derived seed: the shared
scheduler only interleaves events of different groups, never reorders one
group's own events, and SimNetworks draw from per-group RNGs.  The fleet
accounting (:meth:`ShardedCluster.drive_shared_fleet`) REPLAYS the
committed cert workload through the shared wave former on one OS thread
per group — the deployment shape, where each group's replicas are
separate processes hammering the same sidecars — so wave composition can
never perturb sim-time behavior: ledgers first, launches second.

The PyTorch port's copy of ``consensus_tpu/groups/cluster.py``, its imports
renamed.  One divergence (ROADMAP.md queue C, divergence 25):
``ShardedCluster(..., device=...)`` names where the fleet drives' default
engines live (``cuda`` unless named).  The device is resolved only when a
drive builds its default engine, so crypto-free runs (the sim, 2PC, group
chaos) never resolve one.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Callable, Optional, Sequence

from consensus_tpu_torch.groups.directory import GroupDirectory
from consensus_tpu_torch.groups.router import GroupRouter
from consensus_tpu_torch.groups.twopc import CrossGroupRegistry, TwoPhaseCoordinator, TwoPhaseParticipant
from consensus_tpu_torch.runtime.scheduler import SimScheduler
from consensus_tpu_torch.testing.app import Cluster, make_request
from consensus_tpu_torch.testing.invariants import InvariantMonitor

#: Seed-derivation tag: group i's Cluster seed under shard seed s.
_GROUP_SEED_TAG = 0x6709


def group_seed(seed: int, index: int) -> int:
    """Group ``index``'s private Cluster seed — a pure function of the
    shard seed, so a standalone Cluster with this seed replays the group
    byte-for-byte."""
    return seed ^ (_GROUP_SEED_TAG + 7919 * index)


class _CountingEngine:
    """Wraps a verify engine, recording every launch's signature count —
    the fleet-accounting gates assert on launches, not wall time."""

    def __init__(self, inner) -> None:
        self._inner = inner
        self.launch_sizes: list[int] = []

    @property
    def launches(self) -> int:
        return len(self.launch_sizes)

    @property
    def total_signatures(self) -> int:
        return sum(self.launch_sizes)

    def verify_batch(self, messages, signatures, public_keys):
        self.launch_sizes.append(len(messages))
        return self._inner.verify_batch(messages, signatures, public_keys)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class ShardedCluster:
    """N consensus groups over one scheduler, registry, and fleet."""

    def __init__(
        self,
        n_groups: int = 2,
        *,
        n: int = 4,
        seed: int = 0,
        config_tweaks: Optional[dict] = None,
        durability_window: float = 0.0,
        sync_mode: str = "wire",
        metrics=None,
        monitors: bool = True,
        check_durability: bool = True,
        device=None,
    ) -> None:
        if n_groups < 1:
            raise ValueError("need at least one group")
        self.seed = seed
        #: Where the fleet drives' default engines live (``cuda`` unless
        #: named); resolved only when a drive builds one.
        self.device = device
        self.n = n
        self.scheduler = SimScheduler()
        self.directory = GroupDirectory.of_size(n_groups)
        #: Optional full Metrics facade; the groups bundle books routing,
        #: 2PC, and shared-fleet wave composition.
        self.metrics = metrics
        gm = metrics.groups if metrics is not None else None
        self.router = GroupRouter(self.directory, metrics=gm)
        self.registry = CrossGroupRegistry(now=self.scheduler.now, metrics=gm)
        self.groups: dict[str, Cluster] = {}
        self.participants: dict[str, TwoPhaseParticipant] = {}
        self.monitors: dict[str, InvariantMonitor] = {}
        for gi, gid in enumerate(self.directory.groups()):
            cluster = Cluster(
                n,
                seed=group_seed(seed, gi),
                config_tweaks=config_tweaks,
                durability_window=durability_window,
                sync_mode=sync_mode,
                scheduler=self.scheduler,
            )
            participant = TwoPhaseParticipant(gid, registry=self.registry)
            # Hook order matters: the participant updates the registry
            # FIRST, then the monitor (appended below) judges the updated
            # cross-group state at the very same delivery.
            cluster.delivery_hooks.append(participant.on_delivery)
            self.groups[gid] = cluster
            self.participants[gid] = participant
        if monitors:
            for gid, cluster in self.groups.items():
                monitor = InvariantMonitor(
                    cluster, check_durability=check_durability
                )
                monitor.attach_cross_group(self.registry, gid)
                self.monitors[gid] = monitor
        self.coordinator = TwoPhaseCoordinator(self.groups, self.registry)
        self._rids: dict[str, int] = {}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        for cluster in self.groups.values():
            cluster.start()

    def group_ids(self) -> tuple:
        return self.directory.groups()

    # -- driving -------------------------------------------------------------

    def submit(self, tenant: str, payload: bytes = b"") -> str:
        """Admit-then-route: submit one request for ``tenant`` to every
        replica of its owning group; returns the group id."""
        group = self.router.route(tenant)
        rid = self._rids.get(tenant, 0) + 1
        self._rids[tenant] = rid
        self.groups[group].submit_to_all(make_request(tenant, rid, payload))
        return group

    def heights(self) -> dict:
        """Per-group ledger height (minimum across running replicas)."""
        out = {}
        for gid, cluster in self.groups.items():
            running = [nd for nd in cluster.nodes.values() if nd.running]
            out[gid] = min((len(nd.app.ledger) for nd in running), default=0)
        return out

    def run_until(self, predicate: Callable[[], bool], *, max_time: float = 600.0) -> bool:
        return self.scheduler.run_until(predicate, max_time=max_time)

    def run_until_heights(self, expected, *, max_time: float = 600.0) -> bool:
        """Advance until every group's ledger reaches ``expected`` (an int
        for all groups, or a {group id: height} map)."""
        if isinstance(expected, int):
            expected = {gid: expected for gid in self.groups}

        def done() -> bool:
            h = self.heights()
            return all(h[g] >= want for g, want in expected.items())

        return self.scheduler.run_until(done, max_time=max_time)

    # -- observation ---------------------------------------------------------

    def ledger_digests(self) -> dict:
        """{group id: {node id: (proposal digests...)}} — the byte-identity
        artifact the sharded-vs-private gates compare."""
        return {
            gid: {
                nid: tuple(d.proposal.digest() for d in node.app.ledger)
                for nid, node in sorted(cluster.nodes.items())
            }
            for gid, cluster in sorted(self.groups.items())
        }

    def health_fields(self) -> dict:
        """Obs-plane health fields for the shard as a whole: feeds the
        ``cross_group_stall`` detector.  The age key is present only while
        some transaction is unresolved, so the detector's latch clears the
        moment everything resolves."""
        fields = {}
        age = self.registry.oldest_unresolved_age()
        if age is not None:
            fields["groups_twopc_oldest_age"] = age
        return fields

    def assert_clean(self) -> None:
        """Every group's monitor clean AND cross-group atomicity holds."""
        for monitor in self.monitors.values():
            monitor.assert_clean()
        self.registry.assert_atomic()

    # -- shared-fleet accounting --------------------------------------------
    #
    # The sharding thesis, measured: identical committed cert work, driven
    # once through ONE shared wave former (group id in the admission
    # identity) and once through per-group private formers.  Shared must
    # book strictly fewer, larger launches — that is the fleet the groups
    # are paying for.

    def _cert_signer(self, gid: str, signer_id: int):
        from consensus_tpu_torch.models import Ed25519Signer

        return Ed25519Signer(
            signer_id,
            hashlib.sha512(
                b"ctpu/groups-cert-key/%d/%s/%d"
                % (self.seed, gid.encode(), signer_id)
            ).digest()[:32],
        )

    def cert_workload(self) -> dict:
        """Per-group verify workload, derived from the committed ledgers:
        for every delivered decision, one batch re-expressing its quorum
        cert as real Ed25519 signatures (deterministic keys from the shard
        seed).  Identical ledgers -> identical workload, so the shared and
        private drives verify the exact same bytes."""
        workload: dict[str, list] = {}
        for gid, cluster in sorted(self.groups.items()):
            signers = {
                nid: self._cert_signer(gid, nid) for nid in cluster.nodes
            }
            batches = []
            ledger = cluster.nodes[1].app.ledger
            for decision in ledger:
                digest = decision.proposal.digest().encode()
                messages, signatures, keys = [], [], []
                for sig in decision.signatures:
                    signer = signers[sig.id]
                    msg = b"ctpu/groups-cert|%s|%s|%d" % (
                        gid.encode(), digest, sig.id,
                    )
                    messages.append(msg)
                    signatures.append(signer.sign_raw(msg))
                    keys.append(signer.public_bytes)
                if messages:
                    batches.append((messages, signatures, keys))
            workload[gid] = batches
        return workload

    def drive_shared_fleet(
        self,
        *,
        window: float = 0.05,
        max_wave: int = 8192,
        engine=None,
        workload: Optional[dict] = None,
    ) -> dict:
        """Replay the cert workload through ONE shared wave former, one OS
        thread per group (the deployment shape: each group's replicas are
        separate processes sharing the sidecar fleet).  Returns the launch
        accounting; books ``groups_wave_span`` / multi-group counters when
        a metrics facade is attached."""
        from consensus_tpu_torch.models.engine import FairShareWaveFormer

        if workload is None:
            workload = self.cert_workload()
        counting = _CountingEngine(
            engine if engine is not None else _host_engine(self.device)
        )
        gm = self.metrics.groups if self.metrics is not None else None
        group_waves: list[dict] = []
        lock = threading.Lock()

        def on_group_wave(group_counts: dict, total: int) -> None:
            with lock:
                group_waves.append(dict(group_counts))

        former = FairShareWaveFormer(
            counting,
            window=window,
            max_wave=max_wave,
            groups_metrics=gm,
            on_group_wave=on_group_wave,
            name="groups-shared-fleet",
        )
        errors: list[BaseException] = []
        barrier = threading.Barrier(len(workload) or 1)

        def run_group(gid: str, batches) -> None:
            try:
                barrier.wait()
                for messages, signatures, keys in batches:
                    result = former.submit(
                        f"{gid}/certs", messages, signatures, keys, group=gid
                    )
                    if not all(result):
                        raise AssertionError(f"cert verify failed in {gid}")
            except BaseException as exc:  # surfaced after join
                with lock:
                    errors.append(exc)

        threads = [
            threading.Thread(
                target=run_group, args=(gid, batches),
                name=f"fleet-{gid}", daemon=True,
            )
            for gid, batches in sorted(workload.items())
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        former.close()
        if errors:
            raise errors[0]
        return {
            "launches": counting.launches,
            "total_signatures": counting.total_signatures,
            "launch_sizes": tuple(counting.launch_sizes),
            "group_waves": tuple(
                tuple(sorted(w.items())) for w in group_waves
            ),
            "multi_group_launches": sum(
                1 for w in group_waves if len(w) >= 2
            ),
        }

    def drive_private_fleets(
        self,
        *,
        window: float = 0.02,
        max_wave: int = 8192,
        engine_factory: Optional[Callable[[], object]] = None,
        workload: Optional[dict] = None,
    ) -> dict:
        """The baseline: the SAME workload through one PRIVATE wave former
        per group (no cross-group admission identity, no sharing).  Every
        cert batch launches alone — the fleet cost of not sharing."""
        from consensus_tpu_torch.models.engine import FairShareWaveFormer

        if workload is None:
            workload = self.cert_workload()
        factory = (
            engine_factory if engine_factory is not None
            else lambda: _host_engine(self.device)
        )
        launches = 0
        total = 0
        sizes: list[int] = []
        for gid, batches in sorted(workload.items()):
            counting = _CountingEngine(factory())
            former = FairShareWaveFormer(
                counting, window=window, max_wave=max_wave,
                name=f"groups-private-{gid}",
            )
            try:
                for messages, signatures, keys in batches:
                    result = former.submit(
                        f"{gid}/certs", messages, signatures, keys
                    )
                    if not all(result):
                        raise AssertionError(f"cert verify failed in {gid}")
            finally:
                former.close()
            launches += counting.launches
            total += counting.total_signatures
            sizes.extend(counting.launch_sizes)
        return {
            "launches": launches,
            "total_signatures": total,
            "launch_sizes": tuple(sizes),
        }


def _host_engine(device=None):
    from consensus_tpu_torch.models.ed25519 import Ed25519BatchVerifier

    return Ed25519BatchVerifier(min_device_batch=10**9, device=device)


__all__ = ["ShardedCluster", "group_seed"]
