"""All-ports test application + cluster builder.

Parity: reference test/test_app.go:49-494 — trivial crypto, a per-node
in-memory ledger that ``sync`` replays from peers, real (or in-memory) WALs,
and ``restart`` realism: tearing a replica down and rebuilding the whole
Consensus over the same WAL content.

The PyTorch port's copy of ``consensus_tpu/testing/app.py``, its imports
renamed.
"""

from __future__ import annotations

import hashlib
import os
import struct
from typing import Optional, Sequence

from consensus_tpu_torch.api.deps import (
    Application,
    Assembler,
    RequestInspector,
    Signer,
    Synchronizer,
    Verifier,
    WriteAheadLog,
)
from consensus_tpu_torch.config import Configuration
from consensus_tpu_torch.consensus import Consensus
from consensus_tpu_torch.core.view import Phase  # noqa: F401  (re-export convenience)
from consensus_tpu_torch.membership import JoinBootstrap
from consensus_tpu_torch.runtime.scheduler import SimScheduler
from consensus_tpu_torch.sync import (
    InProcessSyncTransport,
    LedgerDecisionStore,
    LedgerSynchronizer,
    SyncServer,
)
from consensus_tpu_torch.testing.network import NodeComm, SimNetwork
from consensus_tpu_torch.types import (
    Decision,
    Proposal,
    Reconfig,
    RequestInfo,
    Signature,
    SyncResponse,
    as_cert,
)

# --- request / batch encoding --------------------------------------------
# A request is b"client:reqid|payload".  A proposal payload is a packed
# sequence of requests.


def make_request(client: str, rid, payload: bytes = b"") -> bytes:
    return f"{client}:{rid}|".encode() + payload


def pack_batch(requests: Sequence[bytes]) -> bytes:
    out = [struct.pack(">I", len(requests))]
    for r in requests:
        out.append(struct.pack(">I", len(r)))
        out.append(r)
    return b"".join(out)


def unpack_batch(payload: bytes) -> list[bytes]:
    (count,) = struct.unpack_from(">I", payload, 0)
    off = 4
    out = []
    for _ in range(count):
        (n,) = struct.unpack_from(">I", payload, off)
        off += 4
        out.append(payload[off : off + n])
        off += n
    return out


class ByteInspector(RequestInspector):
    def request_id(self, raw_request: bytes) -> RequestInfo:
        head = raw_request.split(b"|", 1)[0].decode()
        client, _, rid = head.partition(":")
        if not client or not rid:
            raise ValueError(f"malformed request {raw_request!r}")
        return RequestInfo(client_id=client, request_id=rid)


def _toy_digest(data: bytes) -> bytes:
    """Short content digest for the toy signature scheme."""
    return hashlib.sha256(data).hexdigest()[:12].encode()


class MemWAL(WriteAheadLog):
    """In-memory WAL whose entries survive a simulated crash (the backing
    list lives in the cluster, not the node object)."""

    def __init__(self, backing: list[bytes]) -> None:
        self._backing = backing
        #: Simulated fsyncs — per append here (no group window), so the
        #: pipelining coalescing guards can count them like the real WAL's.
        self.fsync_count = 0
        self._tracer = None

    def attach_tracer(self, tracer) -> None:
        self._tracer = tracer

    def append(self, entry: bytes, truncate_to: bool = False, on_durable=None) -> None:
        if truncate_to:
            self._backing.clear()
        self._backing.append(entry)
        self.fsync_count += 1
        if self._tracer is not None and self._tracer.enabled:
            # Per-append fsync semantics: same instants the real WAL emits.
            self._tracer.instant(
                "wal", "wal.append", bytes=len(entry), truncate=truncate_to
            )
            self._tracer.instant("wal", "wal.fsync", records=1)
        if on_durable is not None:
            on_durable()  # memory-backed: "durable" immediately

    @property
    def entries(self) -> list[bytes]:
        return list(self._backing)


class DeferredMemWAL(WriteAheadLog):
    """MemWAL with GROUP-COMMIT durability semantics on the sim clock:
    appends land in a pending buffer, and only a flush (after ``window``
    sim-seconds) moves them into the crash-surviving backing list and
    fires their durability callbacks.  A simulated crash with unflushed
    records LOSES them — exactly the torn-tail realism a real group-commit
    window adds (and the regime that exposed the late-flush liveness
    wedge; see view.py::maybe_send_prepare)."""

    def __init__(self, backing: list[bytes], scheduler, window: float) -> None:
        self._backing = backing
        self._sched = scheduler
        self._window = window
        self._pending: list[tuple[bytes, bool, object]] = []
        self._timer = None
        self._dead = False
        #: Simulated fsyncs — one per group flush, however many records it
        #: covers (what the pipelining coalescing guards assert on).
        self.fsync_count = 0
        #: MetricsConsensus bundle for the coalescing-ratio gauge (the
        #: facade wires this like the real WAL's attach_consensus_metrics).
        self._consensus_metrics = None
        self._tracer = None

    def attach_consensus_metrics(self, metrics) -> None:
        self._consensus_metrics = metrics

    def attach_tracer(self, tracer) -> None:
        self._tracer = tracer

    def append(self, entry: bytes, truncate_to: bool = False, on_durable=None) -> None:
        if self._dead:
            return
        if self._tracer is not None and self._tracer.enabled:
            self._tracer.instant(
                "wal", "wal.append", bytes=len(entry), truncate=truncate_to
            )
        self._pending.append((entry, truncate_to, on_durable))
        if self._timer is None:
            self._timer = self._sched.call_later(
                self._window, self._flush, name="sim-wal-group-flush"
            )

    def _flush(self) -> None:
        self._timer = None
        if self._dead:
            return
        pending, self._pending = self._pending, []
        for entry, truncate_to, _ in pending:
            if truncate_to:
                self._backing.clear()
            self._backing.append(entry)
        if pending:
            self.fsync_count += 1
            if self._consensus_metrics is not None:
                self._consensus_metrics.wal_records_per_fsync.set(len(pending))
            if self._tracer is not None and self._tracer.enabled:
                self._tracer.instant("wal", "wal.fsync", records=len(pending))
        for _, _, on_durable in pending:
            if on_durable is not None:
                on_durable()

    def abandon(self) -> None:
        """Simulated process death: unflushed records are gone and the
        flush timer must never fire into a dead replica."""
        self._dead = True
        self._pending.clear()
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    @property
    def entries(self) -> list[bytes]:
        return list(self._backing)


class TestApp(Application, Assembler, Signer, Verifier, Synchronizer):
    """Implements every application-side port with trivial crypto.

    Parity: reference test/test_app.go (SignProposal returns {ID, aux};
    VerifyConsenterSig echoes the aux back — node.go:90-110 does the same in
    naive_chain)."""

    def __init__(self, node_id: int, cluster: "Cluster") -> None:
        self.node_id = node_id
        self.cluster = cluster
        self.ledger: list[Decision] = []
        self.inspector = ByteInspector()
        self._vseq = 0

    # Application
    def deliver(self, proposal: Proposal, signatures: Sequence[Signature]) -> Reconfig:
        decision = Decision(proposal=proposal, signatures=as_cert(signatures))
        self.ledger.append(decision)
        # Commit-path delivery hooks (the chaos invariant monitor lives
        # here): called AFTER the append so a hook sees the ledger it is
        # judging.  Sync/catch-up appends bypass deliver() — hooks observe
        # only decisions this replica committed itself.  getattr: several
        # tests duck-type `cluster` with minimal stubs.
        for hook in getattr(self.cluster, "delivery_hooks", ()):
            hook(self.node_id, decision)
        return self.cluster.reconfig_of(proposal)

    # Assembler
    def assemble_proposal(self, metadata: bytes, requests: Sequence[bytes]) -> Proposal:
        return Proposal(
            payload=pack_batch(requests),
            header=struct.pack(">Q", len(self.ledger)),
            metadata=metadata,
            verification_sequence=self._vseq,
        )

    # Signer
    # Toy signatures BIND THE SIGNED CONTENT (id + a digest of the bytes):
    # content-free values (the old b"sig-<id>") let a byzantine network
    # tamper a carried last-decision payload undetectably — the round-5
    # mutation chaos forked the ledger through exactly that hole, which
    # real Ed25519 consenter signatures (models/verifier.py) never allow.
    def sign(self, data: bytes) -> bytes:
        return b"sig-%d:%s" % (self.node_id, _toy_digest(data))

    def sign_proposal(self, proposal: Proposal, aux: bytes = b"") -> Signature:
        # Binds BOTH the proposal content and the aux payload (the
        # PreparesFrom proof travels in Signature.msg), mirroring what the
        # real Ed25519 signer signs (models/verifier.py commit_message).
        return Signature(
            id=self.node_id,
            value=b"sig-%d:%s" % (
                self.node_id, _toy_digest(proposal.digest().encode() + aux)
            ),
            msg=aux,
        )

    # Verifier
    def verify_proposal(self, proposal: Proposal) -> Sequence[RequestInfo]:
        return [self.inspector.request_id(r) for r in unpack_batch(proposal.payload)]

    def verify_request(self, raw_request: bytes) -> RequestInfo:
        return self.inspector.request_id(raw_request)

    def verify_consenter_sig(self, signature: Signature, proposal: Proposal) -> bytes:
        expect = b"sig-%d:%s" % (
            signature.id,
            _toy_digest(proposal.digest().encode() + signature.msg),
        )
        if signature.value != expect:
            raise ValueError(f"bad signature from {signature.id}")
        return signature.msg

    def verify_signature(self, signature: Signature) -> None:
        expect = b"sig-%d:%s" % (signature.id, _toy_digest(signature.msg))
        if signature.value != expect:
            raise ValueError(f"bad signature from {signature.id}")

    def verification_sequence(self) -> int:
        return self._vseq

    def requests_from_proposal(self, proposal: Proposal) -> Sequence[RequestInfo]:
        return [self.inspector.request_id(r) for r in unpack_batch(proposal.payload)]

    def raw_requests_from_proposal(self, proposal: Proposal) -> Sequence[bytes]:
        return unpack_batch(proposal.payload)

    def auxiliary_data(self, msg: bytes) -> bytes:
        return msg

    # Synchronizer (TOY fallback, ``Cluster(sync_mode="toy")``): replay
    # missing decisions straight out of the most advanced peer's in-memory
    # ledger — no wire protocol, no verification.  Kept for unit tests that
    # don't start transports; clusters default to the real wire path
    # (consensus_tpu/sync/), built per node in :meth:`Node.start`.
    # Parity: reference test/test_app.go:327-371.
    def sync(self) -> SyncResponse:
        best = self.cluster.longest_ledger(exclude=self.node_id)
        mine = len(self.ledger)
        reconfig = Reconfig()
        for decision in best[mine:]:
            self.ledger.append(decision)
            r = self.cluster.reconfig_of(decision.proposal)
            if r.in_latest_decision:
                reconfig = r
        if not self.ledger:
            return SyncResponse(latest=None, reconfig=reconfig)
        return SyncResponse(latest=self.ledger[-1], reconfig=reconfig)


class Node:
    """A replica: app + consensus + WAL, restartable."""

    def __init__(self, node_id: int, cluster: "Cluster", config: Configuration) -> None:
        self.node_id = node_id
        self.cluster = cluster
        self.config = config
        self.app = TestApp(node_id, cluster)
        self.wal_backing: list[bytes] = []
        self.wal: Optional[WriteAheadLog] = None
        self.consensus: Optional[Consensus] = None
        self.running = False
        #: Optional Metrics bundle handed to the next (re)build.
        self.metrics = None
        #: Armed testing FaultPlan (consensus_tpu/testing/faults.py); attach
        #: via arm_fault_plan so a firing crash seam tears this node down.
        self.fault_plan = None
        #: Wire-sync components (sync_mode="wire"): rebuilt on every start
        #: over the surviving app ledger.
        self.sync_server: Optional[SyncServer] = None
        self.synchronizer = None
        #: membership.JoinBootstrap armed by Cluster.add_node(bootstrap=True).
        self.join_bootstrap = None
        #: Optional testing.storage.StorageFaultInjector: installed over the
        #: file-backed WAL's open seams at every (re)start.
        self.storage_injector = None
        #: Background wal.scrub.WalScrubber (file-backed WAL + a cluster
        #: ``scrub_interval`` only); torn down with the process on crash.
        self.scrubber = None

    def arm_fault_plan(self, plan) -> None:
        """Arm ``plan`` on this node: its crash seams will call
        :meth:`crash` (teardown BEFORE the SimulatedCrash unwinds, so a
        swallowed exception cannot resurrect the process), and the plan is
        cleared on firing so a later :meth:`restart` boots clean."""
        plan.on_crash = self._fault_crash
        self.fault_plan = plan
        if self.wal is not None:
            self.wal.fault_plan = plan
        if self.consensus is not None:
            plan.tracer = self.consensus.tracer
        if isinstance(self.synchronizer, LedgerSynchronizer):
            self.synchronizer.fault_plan = plan
            self.synchronizer.transport.fault_plan = plan

    def _fault_crash(self) -> None:
        self.fault_plan = None  # the restarted process is a fresh one
        self.crash()

    def start(self) -> None:
        comm = self.cluster.network.register(self.node_id, self._on_message)
        last = self.app.ledger[-1] if self.app.ledger else None
        window = self.cluster.durability_window
        if self.cluster.wal_dir is not None:
            # Real file-backed WAL (fsync per append, small segments so
            # rolls happen under test): restart re-opens the directory,
            # repairing a torn tail exactly as a production boot would.
            from consensus_tpu_torch.wal.log import initialize_and_read_all

            self.wal, initial = initialize_and_read_all(
                os.path.join(self.cluster.wal_dir, f"wal-{self.node_id}"),
                segment_max_bytes=self.cluster.wal_segment_bytes,
                quarantine_corrupt=True,
                # Sim-clocked so the WAL's degraded-mode recovery probe can
                # arm (without a scheduler an ENOSPC episode never ends).
                scheduler=self.cluster.scheduler,
            )
            if self.storage_injector is not None:
                self.storage_injector.install(self.wal)
        else:
            self.wal = (
                DeferredMemWAL(self.wal_backing, self.cluster.scheduler, window)
                if window > 0
                else MemWAL(self.wal_backing)
            )
            initial = list(self.wal_backing)
        self.wal.fault_plan = self.fault_plan
        if self.cluster.sync_mode == "wire":
            # Real catch-up path: this node serves its ledger to peers and
            # fetches+verifies chunks over the (simulated) wire — no reads
            # of peer memory; every synced byte crossed the codec.
            store = LedgerDecisionStore(self.app.ledger)
            self.sync_server = SyncServer(store)
            self.cluster.sync_servers[self.node_id] = self.sync_server
            transport = InProcessSyncTransport(
                self.node_id,
                self.cluster.network,
                self.cluster.sync_servers,
                fault_plan=self.fault_plan,
            )
            self.synchronizer = LedgerSynchronizer(
                node_id=self.node_id,
                store=store,
                transport=transport,
                verifier=self.app,
                nodes=self.cluster.network.node_ids,
                reconfig_of=self.cluster.reconfig_of,
                metrics=self.metrics.sync if self.metrics is not None else None,
                fault_plan=self.fault_plan,
                now=self.cluster.scheduler.now,
            )
        else:
            self.synchronizer = self.app
        self.consensus = Consensus(
            config=self.config,
            scheduler=self.cluster.scheduler,
            comm=comm,
            application=self.app,
            assembler=self.app,
            wal=self.wal,
            signer=self.app,
            verifier=self.app,
            request_inspector=self.app.inspector,
            synchronizer=self.synchronizer,
            wal_initial_content=initial,
            last_proposal=last.proposal if last else None,
            last_signatures=last.signatures if last else (),
            metrics=self.metrics,
        )
        if self.fault_plan is not None:
            # A plan armed before (re)start binds to the fresh tracer so a
            # crash-matrix trace records exactly which seam fired.
            self.fault_plan.tracer = self.consensus.tracer
        self.consensus.start()
        inj = self.storage_injector
        if inj is not None and inj.consume_suspect_fence():
            # The injector knows this disk dropped or damaged durable bytes
            # in a way the boot scan could not prove (an fsync lie, an
            # unscrubbed flip chopped by tail repair): the incarnation
            # starts as a non-voting learner until verified sync clears it.
            self.consensus.controller.fence_as_learner(
                self.consensus.controller.latest_seq()
            )
        if (
            self.cluster.wal_dir is not None
            and self.cluster.scrub_interval is not None
        ):
            from consensus_tpu_torch.wal.scrub import WalScrubber

            self.scrubber = WalScrubber(
                self.wal,
                self.cluster.scheduler,
                interval=self.cluster.scrub_interval,
                metrics=getattr(self.wal, "_metrics", None),
                tracer=self.consensus.tracer,
                on_corruption=self._on_scrub_corruption,
            )
            self.scrubber.start()
        self.running = True

    def _on_scrub_corruption(self, err) -> None:
        """Scrub detection → quarantine the corrupt suffix, fence this
        replica as a non-voting learner, notify the cluster's hooks (the
        chaos engine logs + flight-records through them)."""
        recovery = self.wal.quarantine_corrupt(err)
        cons = self.consensus
        if cons is not None and cons.controller is not None:
            cons.controller.fence_as_learner(cons.controller.latest_seq())
        for hook in getattr(self.cluster, "corruption_hooks", ()):
            hook(self.node_id, recovery)

    def crash(self) -> None:
        """Hard-stop: drop off the network and kill all components."""
        self.running = False
        self.cluster.network.unregister(self.node_id)
        self.cluster.sync_servers.pop(self.node_id, None)
        self.sync_server = None
        if self.scrubber is not None:
            self.scrubber.stop()
            self.scrubber = None
        abandon = getattr(self.wal, "abandon", None)
        if abandon is not None:
            abandon()  # unflushed records / open fds die with the process
        if self.storage_injector is not None:
            # A lying disk drops its unsynced suffix exactly at crash time.
            self.storage_injector.on_crash()
        if self.consensus is not None:
            self.consensus.stop()
            self.consensus = None

    def restart(self) -> None:
        """Parity: reference test/test_app.go:130-143 (Restart)."""
        if self.running:
            self.crash()
        self.start()

    def submit(self, raw: bytes, on_done=None) -> None:
        if self.consensus is not None:
            self.consensus.submit_request(raw, on_done)

    def _on_message(self, sender: int, payload, is_request: bool) -> None:
        if self.consensus is None:
            return
        if is_request:
            self.consensus.handle_request(sender, payload)
        else:
            self.consensus.handle_message(sender, payload)


class Cluster:
    """n replicas over a simulated network on one virtual clock."""

    def __init__(
        self,
        n: int = 4,
        *,
        seed: int = 0,
        config_tweaks: Optional[dict] = None,
        leader_rotation: bool = False,
        durability_window: float = 0.0,
        wal_dir: Optional[str] = None,
        wal_segment_bytes: int = 2048,
        scrub_interval: Optional[float] = None,
        sync_mode: str = "wire",
        obs=None,
        scheduler=None,
    ) -> None:
        #: > 0 gives every node group-commit durability semantics
        #: (DeferredMemWAL): appends become durable — and their deferred
        #: sends fire — only after this many sim-seconds.
        self.durability_window = durability_window
        #: Set to a directory to give every node a REAL file-backed WAL
        #: (wal/log.py) under <wal_dir>/wal-<id> instead of the in-memory
        #: one; segments deliberately tiny so rolls happen in short runs.
        self.wal_dir = wal_dir
        self.wal_segment_bytes = wal_segment_bytes
        #: Sim-seconds between background WAL scrub passes (file-backed
        #: clusters only); None leaves the scrubber off.
        self.scrub_interval = scrub_interval
        #: fn(node_id, WALRecovery) called whenever a scrub detection
        #: quarantines a corrupt suffix (after the node fenced itself).
        self.corruption_hooks: list = []
        #: "wire" (default) gives every node the real catch-up subsystem
        #: (consensus_tpu/sync/: LedgerSynchronizer over an in-process wire
        #: transport with full codec round-trips and quorum-cert
        #: verification); "toy" opts back into TestApp.sync's direct
        #: peer-memory replay for unit tests that bypass transports.
        if sync_mode not in ("wire", "toy"):
            raise ValueError(f"unknown sync_mode {sync_mode!r}")
        self.sync_mode = sync_mode
        #: node id -> live SyncServer (wire mode); a crashed node serves
        #: nothing, exactly like its consensus ingress.
        self.sync_servers: dict[int, SyncServer] = {}
        #: Injectable virtual clock: a ShardedCluster hands every group ONE
        #: shared SimScheduler so cross-group time is a single total order;
        #: None (the default) keeps the private-clock construction
        #: bit-for-bit as before.  Each cluster always owns its own
        #: SimNetwork (per-group partitions/heals stay per-group).
        self.scheduler = scheduler if scheduler is not None else SimScheduler()
        self.network = SimNetwork(self.scheduler, seed=seed)
        self.network.set_membership(list(range(1, n + 1)), epoch=0)
        self.nodes: dict[int, Node] = {}
        #: fn(node_id, Decision) called on every COMMIT-PATH delivery (not
        #: on sync appends) — the invariant monitor's wiring point.
        self.delivery_hooks: list = []
        #: proposal-digest -> Reconfig to report on delivery (reconfig tests).
        self._reconfigs: dict[str, Reconfig] = {}
        #: membership.MembershipDirectory once the reconfig harness
        #: (testing/membership.py install_reconfig_hook) is installed.
        self.membership_directory = None
        #: fn(Proposal) -> Reconfig; consulted by :meth:`reconfig_of` after
        #: the explicit-digest table (the harness's payload interpreter).
        self._membership_interpreter = None
        self._config_tweaks = dict(config_tweaks or {})
        self._leader_rotation = leader_rotation
        for node_id in range(1, n + 1):
            self.nodes[node_id] = Node(node_id, self, self._node_config(node_id))
        #: Observability plane — DEFAULT OFF.  Pass an ``ObsConfig`` with
        #: ``enabled=True`` to build a ClusterSampler here (pre-start, so
        #: the installed metrics providers reach the Consensus builds) and
        #: arm it in :meth:`start`.
        self.sampler = None
        if obs is not None and obs.enabled:
            obs.validate()
            from consensus_tpu_torch.obs.sampler import ClusterSampler

            self.sampler = ClusterSampler(
                self,
                interval=obs.sample_interval,
                capacity=obs.ring_capacity,
                thresholds=obs.detector_thresholds,
            )

    def _node_config(self, node_id: int) -> Configuration:
        """Build a node's Configuration from the cluster-wide tweaks (the
        same recipe the constructor uses, so a node added later matches the
        boot-time ones)."""
        tweaks = dict(self._config_tweaks)
        return Configuration(
            self_id=node_id,
            leader_rotation=self._leader_rotation,
            decisions_per_leader=tweaks.pop("decisions_per_leader", 3)
            if self._leader_rotation
            else 0,
            **tweaks,
        )

    def start(self) -> None:
        for node in self.nodes.values():
            node.start()
        if self.sampler is not None:
            self.sampler.start()

    # --- dynamic membership ------------------------------------------------

    def add_node(self, node_id: int, *, bootstrap: bool = True) -> Node:
        """Boot a node admitted by an ordered grow decision.

        Always builds a FRESH Node (empty ledger, empty WAL) with the
        cluster-wide config recipe: a joiner — even a re-added id — is a
        new process that must sync the whole history over the wire.  With
        ``bootstrap=True`` and the reconfig harness installed, arms a
        :class:`~consensus_tpu_torch.membership.JoinBootstrap` so the joiner
        drives wire sync with retry/backoff until it reaches the current
        membership epoch (surviving injected loss and epochs advancing
        mid-join).
        """
        node = Node(node_id, self, self._node_config(node_id))
        self.nodes[node_id] = node
        if self.sampler is not None and node.metrics is None:
            # Same pre-start install the sampler does for boot-time nodes.
            from consensus_tpu_torch.metrics import InMemoryProvider, Metrics

            node.metrics = Metrics(InMemoryProvider())
        node.start()
        directory = self.membership_directory
        if bootstrap and directory is not None:
            bootstrapper = JoinBootstrap(
                self.scheduler,
                sync=lambda: (
                    node.consensus.controller.sync()
                    if node.consensus is not None and node.consensus._running
                    else None
                ),
                caught_up=lambda: (
                    node.consensus is None
                    or not node.consensus._running
                    or node.consensus.membership_epoch >= directory.current_epoch
                ),
                current_epoch=lambda: directory.current_epoch,
                metrics=node.metrics.membership if node.metrics is not None else None,
            )
            node.join_bootstrap = bootstrapper
            bootstrapper.start()
        return node

    def remove_node(self, node_id: int) -> None:
        """Retire a node evicted by an ordered shrink decision.

        The eviction must already have been ORDERED AND DELIVERED (the
        node's consensus self-shuts-down when it applies the Reconfig that
        drops it) — this method only retires the harness-level process.
        The node deliberately STAYS registered on the network: a removed-
        but-live process keeps transmitting, which is exactly the
        stale-epoch traffic the facade's epoch gate must drop-and-count.
        """
        node = self.nodes[node_id]
        assert node.consensus is None or not node.consensus._running, (
            f"node {node_id} is still running consensus — remove-node must be "
            f"ordered as a decision and delivered (self-eviction) first"
        )
        bootstrapper = getattr(node, "join_bootstrap", None)
        if bootstrapper is not None:
            bootstrapper.stop()
        node.running = False

    # --- app-level cluster state ------------------------------------------

    def longest_ledger(self, *, exclude: int) -> list[Decision]:
        """Longest ledger among peers REACHABLE from ``exclude`` — state
        transfer must not tunnel through a network partition."""
        best: list[Decision] = []
        for node_id, node in self.nodes.items():
            if node_id == exclude or not node.running:
                continue
            if not self.network.reachable(exclude, node_id):
                continue
            if len(node.app.ledger) > len(best):
                best = node.app.ledger
        return list(best)

    def reconfig_of(self, proposal: Proposal) -> Reconfig:
        # Stable METHOD (never replaced): LedgerSynchronizer captures it as
        # a bound method at Node.start, so the interpreter chain must live
        # inside it rather than in a swapped-out attribute.
        hit = self._reconfigs.get(proposal.digest())
        if hit is not None:
            return hit
        if self._membership_interpreter is not None:
            return self._membership_interpreter(proposal)
        return Reconfig()

    # --- driving -----------------------------------------------------------

    def submit_to_all(self, raw: bytes) -> None:
        for node in self.nodes.values():
            if node.running:
                node.submit(raw)

    def ledgers_equal_len(self, expected: int, node_ids: Optional[Sequence[int]] = None) -> bool:
        ids = node_ids or [i for i, nd in self.nodes.items() if nd.running]
        return all(len(self.nodes[i].app.ledger) >= expected for i in ids)

    def run_until_ledger(self, expected: int, *, max_time: float = 600.0, node_ids=None) -> bool:
        return self.scheduler.run_until(
            lambda: self.ledgers_equal_len(expected, node_ids), max_time=max_time
        )

    def assert_ledgers_consistent(self) -> None:
        """Every pair of ledgers must agree on their common prefix."""
        ledgers = [
            [d.proposal.digest() for d in node.app.ledger]
            for node in self.nodes.values()
        ]
        for i in range(len(ledgers)):
            for j in range(i + 1, len(ledgers)):
                common = min(len(ledgers[i]), len(ledgers[j]))
                assert ledgers[i][:common] == ledgers[j][:common], (
                    f"ledger fork between replicas {i + 1} and {j + 1}"
                )


__all__ = [
    "Cluster",
    "Node",
    "TestApp",
    "ByteInspector",
    "MemWAL",
    "make_request",
    "pack_batch",
    "unpack_batch",
]
