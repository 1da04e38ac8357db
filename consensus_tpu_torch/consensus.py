"""The Consensus facade: wires and owns every internal component of one
replica, and is the only object an application touches.

Parity: reference pkg/consensus/consensus.go (522 LoC): lifecycle
(``start``/``stop``), request ingress (``submit_request``), message ingress
(``handle_message``/``handle_request``), crash-restore point computation
(consensus.go:464-504), and dynamic reconfiguration (consensus.go:166-252).

The replica runs entirely on the injected scheduler: transport and
application threads must hand work in via the facade, which posts onto the
scheduler (in tests the SimScheduler is driven directly, so posts execute
deterministically).

The PyTorch port's copy of ``consensus_tpu/consensus.py``, its imports renamed.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Sequence

from consensus_tpu_torch.api.deps import (
    Application,
    Assembler,
    Comm,
    MembershipNotifier,
    RequestInspector,
    Signer,
    Synchronizer,
    Verifier,
    WriteAheadLog,
)
from consensus_tpu_torch.config import Configuration
from consensus_tpu_torch.core.batcher import Batcher
from consensus_tpu_torch.core.collector import StateCollector
from consensus_tpu_torch.core.controller import Controller
from consensus_tpu_torch.core.heartbeat import HeartbeatMonitor
from consensus_tpu_torch.core.pool import PoolOptions, RequestPool
from consensus_tpu_torch.core.state import InFlightData, PersistedState, ProposalMaker
from consensus_tpu_torch.core.view import View
from consensus_tpu_torch.metrics import Metrics
from consensus_tpu_torch.runtime.scheduler import Scheduler
from consensus_tpu_torch.trace.tracer import tracer_from_config
from consensus_tpu_torch.types import Checkpoint, Proposal, Reconfig, Signature
from consensus_tpu_torch.wire import (
    ConsensusMessage,
    EpochTagged,
    ViewMetadata,
    decode_view_metadata,
)

logger = logging.getLogger("consensus_tpu_torch.consensus")


class Consensus:
    """One BFT replica."""

    def __init__(
        self,
        *,
        config: Configuration,
        scheduler: Scheduler,
        comm: Comm,
        application: Application,
        assembler: Assembler,
        wal: WriteAheadLog,
        signer: Signer,
        verifier: Verifier,
        request_inspector: RequestInspector,
        synchronizer: Synchronizer,
        wal_initial_content: Sequence[bytes] = (),
        last_proposal: Optional[Proposal] = None,
        last_signatures: Sequence[Signature] = (),
        membership_notifier: Optional[MembershipNotifier] = None,
        metrics: Optional[Metrics] = None,
        tracer=None,
    ) -> None:
        self.config = config
        self.scheduler = scheduler
        self.comm = comm
        #: The membership epoch this replica believes it is in.  Epoch 0 is
        #: the boot membership; every applied membership-change Reconfig that
        #: carries a ``membership`` config advances it.
        self.membership_epoch = 0
        if config.epoch_tagging:
            # Stamp outbound consensus traffic with our epoch; ingress
            # (handle_message) drops other epochs before they reach the
            # collectors.  The wrapper reads membership_epoch live, so the
            # post-reconfig rebuild needs no re-wiring.
            self.comm = _EpochStampingComm(comm, self)
        self.application = application
        self.assembler = assembler
        self.wal = wal
        self.signer = signer
        self.verifier = verifier
        self.request_inspector = request_inspector
        self.synchronizer = synchronizer
        self.wal_initial_content = list(wal_initial_content)
        self.last_proposal = last_proposal or Proposal()
        self.last_signatures = tuple(last_signatures)
        self.membership_notifier = membership_notifier
        self.metrics = metrics or Metrics()
        # Decision-lifecycle tracing: default-off (the shared no-op keeps
        # every instrumented site to one attribute check).  An embedder may
        # inject a tracer to share one event stream across components it
        # builds itself (e.g. the sync client).
        if tracer is None:
            tracer = tracer_from_config(
                config.trace, scheduler.now, pid=config.self_id
            )
        self.tracer = tracer
        if hasattr(synchronizer, "attach_tracer"):
            synchronizer.attach_tracer(tracer)
        # The WAL is constructed by the embedder (it may pre-exist restart);
        # attach the facade's WAL bundle here so wal_count_of_files is live
        # without the embedder threading metrics twice.  Parity: reference
        # pkg/wal NewMetrics wiring in consensus.go.
        if (
            hasattr(wal, "attach_metrics")
            and getattr(wal, "_metrics", None) is None
        ):
            wal.attach_metrics(self.metrics.wal)
        if hasattr(wal, "attach_consensus_metrics"):
            wal.attach_consensus_metrics(self.metrics.consensus)
        if hasattr(wal, "attach_tracer"):
            wal.attach_tracer(tracer)

        self.nodes: tuple[int, ...] = ()
        self.controller: Optional[Controller] = None
        self.view_changer = None  # set by _create_components when available
        self.checkpoint = Checkpoint()
        self._running = False

    # --------------------------------------------------------------- config

    def validate_configuration(self, nodes: Sequence[int]) -> None:
        """Parity: reference consensus.go:341-363."""
        self.config.validate()
        node_set = set()
        for node in nodes:
            if node == 0:
                raise ValueError(f"node id 0 is not permitted: {nodes}")
            node_set.add(node)
        if self.config.self_id not in node_set:
            raise ValueError(
                f"nodes {list(nodes)} do not contain self id {self.config.self_id}"
            )
        if len(node_set) != len(nodes):
            raise ValueError(f"nodes contain duplicate ids: {list(nodes)}")

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        """Boot (or re-boot after a crash): restore protocol position from
        the last decision's metadata + the WAL tail, then start components.

        Parity: reference consensus.go:107-164."""
        nodes = list(self.comm.nodes())
        self.validate_configuration(nodes)
        self.nodes = tuple(sorted(nodes))

        self.in_flight = InFlightData()
        self.state = PersistedState(
            self.wal, self.in_flight, entries=self.wal_initial_content
        )
        self.checkpoint.set(self.last_proposal, self.last_signatures)

        md = (
            decode_view_metadata(self.last_proposal.metadata)
            if self.last_proposal.metadata
            else ViewMetadata()
        )
        view, seq, dec = self._set_view_and_seq(
            md.view_id, md.latest_sequence, md.decisions_in_view
        )

        self._create_components()
        # Sequence i was delivered -> we expect proposal i+1 next.
        self._start_components(view, seq + 1, dec)
        self._readmit_abandoned()
        if getattr(self.wal, "recovery", None) is not None:
            # Boot quarantined a corrupt WAL suffix: votes this replica
            # already sent may be gone from its durable state, so it joins
            # as a NON-VOTING LEARNER and re-enters the voter set only once
            # verified sync carries its checkpoint past the release bound
            # (SAFETY.md §13).
            self.controller.fence_as_learner(self.controller.latest_seq())
        self._running = True

    def _readmit_abandoned(self) -> None:
        """Re-admit the requests of pipelined slots the WAL restore abandoned
        above the oldest undecided sequence.  Those batches were pre-prepared
        but never commit-signed anywhere (SAFETY.md §5), so the only cost of
        dropping the slots is losing the requests — unless we hand them back
        to the pool here.  Dedup/removal in the pool makes this idempotent:
        a request that was meanwhile decided (or re-submitted) is refused."""
        abandoned = self.state.take_abandoned()
        if not abandoned:
            return
        raws: list[bytes] = []
        for proposal in abandoned:
            try:
                raws.extend(self.verifier.raw_requests_from_proposal(proposal))
            except Exception:
                logger.exception(
                    "%d: could not unpack an abandoned pipelined proposal; "
                    "its requests must be re-submitted by clients",
                    self.config.self_id,
                )
        logger.info(
            "%d: re-admitting %d request(s) from %d abandoned pipelined slot(s)",
            self.config.self_id, len(raws), len(abandoned),
        )
        for raw in raws:
            self.scheduler.post(
                lambda raw=raw: self.pool.submit(raw), name="readmit-abandoned"
            )

    def _set_view_and_seq(self, view: int, seq: int, dec: int) -> tuple[int, int, int]:
        """Compute the restore point, honoring trailing ViewChange/NewView
        WAL records.  Parity: reference consensus.go:464-504."""
        new_view, new_seq = view, seq
        # Decisions-in-view increments after delivery; genesis starts at 0.
        new_dec = dec + 1 if seq != 0 else 0

        self._restore_view_change = None
        view_change = self.state.load_view_change_if_applicable()
        if view_change is not None and view_change.next_view >= view:
            logger.info("restoring pending view change to view %d", view_change.next_view)
            new_view = view_change.next_view
            self._restore_view_change = view_change

        view_seq = self.state.load_new_view_if_applicable()
        if view_seq is not None:
            nv_view, nv_seq = view_seq
            if nv_seq >= seq:
                logger.info("restoring from new-view record (view %d, seq %d)", nv_view, nv_seq)
                new_view, new_seq, new_dec = nv_view, nv_seq, 0

        # A tail in-flight proposal from a HIGHER view proves that view was
        # installed here pre-crash even though its SavedNewView record was
        # truncated away by the proposal append itself — boot there, not in
        # the checkpoint's stale view (extension beyond reference
        # consensus.go:464-504, which has the same blind spot).
        #
        # Endorsement view-stamping: the _commit_in_flight endorsement tail
        # [vote, proposed, commit] stamps its ProposedRecord with the
        # proposal's ORIGINAL view, not the view change's target.  That is
        # safe here and deliberate: (a) the original view is <= the vote's
        # next_view (the proposal predates the change the vote joined), so
        # with the buried vote restored above this tail check can never
        # drag new_view backwards; (b) the PREPARED pin requires the
        # attestation to carry the proposal EXACTLY as commit-signed —
        # peers match it by equality in check_in_flight, so restamping the
        # embedded records with the target view would fork our own
        # attestation from the signature we already minted against the
        # original-view metadata.  The rejoin to the change's target is
        # carried by _restore_view_change (the vote), not by this record.
        # Pinned by tests/test_restart_recovery.py and the crash matrix.
        tail = self.state.load_in_flight_view_if_applicable()
        if tail is not None and tail[0] > new_view:
            logger.info("restoring view %d from the in-flight WAL tail", tail[0])
            new_view = tail[0]
            new_dec = tail[1]
        return new_view, new_seq, new_dec

    def _create_components(self) -> None:
        """Parity: reference consensus.go:386-462."""
        cfg = self.config
        self.collector = StateCollector(
            self.scheduler, n=len(self.nodes), collect_timeout=cfg.collect_timeout
        )
        controller = Controller(
            scheduler=self.scheduler,
            config=cfg,
            nodes=self.nodes,
            comm=self.comm,
            application=self.application,
            assembler=self.assembler,
            verifier=self.verifier,
            signer=self.signer,
            synchronizer=self.synchronizer,
            pool=None,  # plugged below (pool needs the controller as handler)
            batcher=None,
            leader_monitor=None,
            collector=self.collector,
            state=self.state,
            in_flight=self.in_flight,
            checkpoint=self.checkpoint,
            proposer_builder=None,
            view_changer=None,
            on_reconfig=self._on_reconfig,
            metrics=self.metrics,
            tracer=self.tracer,
        )
        self.controller = controller
        controller.membership_epoch = self.membership_epoch

        pool_options = PoolOptions(
            pool_size=cfg.request_pool_size,
            request_max_bytes=cfg.request_max_bytes,
            submit_timeout=cfg.submit_timeout,
            forward_timeout=cfg.request_forward_timeout,
            complain_timeout=cfg.request_complain_timeout,
            auto_remove_timeout=cfg.request_auto_remove_timeout,
        )
        if getattr(self, "pool", None) is not None:
            # Reconfiguration keeps the pool (and its queued requests),
            # re-pointed at the new controller.  Parity: reference
            # pkg/consensus/consensus.go:231 (Pool.ChangeOptions).
            pool = self.pool
            pool.change_options(timeout_handler=controller, options=pool_options)
        else:
            pool = RequestPool(
                self.scheduler,
                self.request_inspector,
                pool_options,
                timeout_handler=controller,
                on_submitted=self._on_pool_submitted,
                metrics=self.metrics.request_pool,
                tracer=self.tracer,
            )
        self.pool = pool
        batcher = Batcher(
            self.scheduler,
            pool,
            batch_max_count=cfg.request_batch_max_count,
            batch_max_bytes=cfg.request_batch_max_bytes,
            batch_max_interval=cfg.request_batch_max_interval,
            tracer=self.tracer,
        )
        self.batcher = batcher
        leader_monitor = HeartbeatMonitor(
            self.scheduler,
            comm=_CommAdapter(controller),
            handler=controller,
            n=len(self.nodes),
            heartbeat_timeout=cfg.leader_heartbeat_timeout,
            heartbeat_count=cfg.leader_heartbeat_count,
            num_of_ticks_behind_before_syncing=cfg.num_of_ticks_behind_before_syncing,
            view_sequence=controller.view_sequence,
        )
        controller.pool = pool
        controller.batcher = batcher
        controller.leader_monitor = leader_monitor

        proposer_builder = ProposalMaker(
            state=self.state, view_factory=self._make_view
        )
        controller._proposer_builder = proposer_builder

        self._create_view_changer()
        self._wire_storage_guard()

    def _wire_storage_guard(self) -> None:
        """Couple the durable-storage self-healing layer (wal/log.py) to the
        controller: while the WAL refuses appends (ENOSPC, fsync retry cap)
        the replica must not propose or vote — persist-before-send has
        nothing durable to stand on — and it auto-resumes when the log
        heals.  Only file-backed WALs carry ``degrade_hooks``; in-memory
        test WALs skip the wiring entirely."""
        hooks = getattr(self.wal, "degrade_hooks", None)
        if hooks is None:
            return
        # A reconfiguration rebuilds the controller: drop the hook pointed
        # at the retired instance before installing the new one.
        prev = getattr(self, "_wal_degrade_hook", None)
        if prev is not None and prev in hooks:
            hooks.remove(prev)
        hook = self.controller.set_wal_degraded
        hooks.append(hook)
        self._wal_degrade_hook = hook
        if getattr(self.wal, "degraded", False):
            self.controller.set_wal_degraded(True)

    def _create_view_changer(self) -> None:
        """Plug in the view changer (split out so the happy-path slice works
        before the failure path exists)."""
        try:
            from consensus_tpu_torch.core.viewchanger import ViewChanger
        except ImportError:
            self.view_changer = None
            return
        cfg = self.config
        self.view_changer = ViewChanger(
            scheduler=self.scheduler,
            self_id=cfg.self_id,
            n=len(self.nodes),
            nodes=self.nodes,
            comm=_CommAdapter(self.controller),
            signer=self.signer,
            verifier=self.verifier,
            checkpoint=self.checkpoint,
            in_flight=self.in_flight,
            state=self.state,
            controller=self.controller,
            requests_timer=self.pool,
            synchronizer=self.controller,
            application=self.controller,
            speed_up_view_change=cfg.speed_up_view_change,
            resend_timeout=cfg.view_change_resend_interval,
            view_change_timeout=cfg.view_change_timeout,
            leader_rotation=cfg.leader_rotation,
            decisions_per_leader=cfg.decisions_per_leader,
            on_reconfig=self._on_reconfig,
            metrics=self.metrics.view_change,
            cert_mode=cfg.cert_mode,
        )
        self.controller.view_changer = self.view_changer

    def _make_view(
        self, *, leader_id: int, proposal_sequence: int, number: int, decisions_in_view: int
    ) -> View:
        """View factory handed to the ProposalMaker.

        Parity: reference consensus.go:318-339 (proposalMaker)."""
        controller = self.controller
        return View(
            scheduler=self.scheduler,
            self_id=self.config.self_id,
            number=number,
            leader_id=leader_id,
            proposal_sequence=proposal_sequence,
            decisions_in_view=decisions_in_view,
            n=len(self.nodes),
            nodes=self.nodes,
            comm=_CommAdapter(controller),
            verifier=self.verifier,
            signer=self.signer,
            state=self.state,
            decider=controller,
            failure_detector=_FailureDetectorAdapter(controller),
            sync_requester=controller,
            checkpoint=self.checkpoint,
            decisions_per_leader=(
                self.config.decisions_per_leader if self.config.leader_rotation else 0
            ),
            membership_notifier=self.membership_notifier,
            metrics=self.metrics.view,
            pipeline_depth=self.config.pipeline_depth,
            consensus_metrics=self.metrics.consensus,
            tracer=self.tracer,
            cert_mode=self.config.cert_mode,
        )

    def _start_components(self, view: int, seq: int, dec: int) -> None:
        """Parity: reference consensus.go:512-522."""
        if self.view_changer is not None:
            self.view_changer.start(
                view, restore_view_change=self._restore_view_change
            )
        self.controller.start(view, seq, dec, sync_on_start=self.config.sync_on_start)

    def stop(self) -> None:
        self._running = False
        if self.view_changer is not None:
            self.view_changer.stop()
        if self.controller is not None:
            self.controller.stop()

    # ------------------------------------------------------- reconfiguration

    def _on_reconfig(self, reconfig: Reconfig) -> None:
        """A delivered decision changed membership/config: rebuild.

        Parity: reference consensus.go:166-252 (run + reconfig)."""
        self.scheduler.post(lambda: self._reconfig(reconfig), name="reconfig")

    def _reconfig(self, reconfig: Reconfig) -> None:
        logger.info("%d: reconfiguring", self.config.self_id)
        new_nodes = tuple(sorted(reconfig.current_nodes or self.comm.nodes()))
        if self.config.self_id not in new_nodes:
            logger.info("%d: evicted by reconfiguration; shutting down", self.config.self_id)
            self.stop()
            return
        if reconfig.current_config is not None:
            self.config = reconfig.current_config
        membership = getattr(reconfig, "membership", None)
        if membership is not None:
            self.membership_epoch = membership.epoch
            self.metrics.membership.epoch.set(membership.epoch)
            logger.info(
                "%d: entering membership epoch %d (nodes %s)",
                self.config.self_id, membership.epoch, list(new_nodes),
            )

        # Stop the old machinery, but only pause pool timers (requests
        # survive reconfiguration).
        if self.view_changer is not None:
            self.view_changer.stop()
        self.controller.stop(pool_pause_only=True)
        # Pipelined slots above the reconfig decision are abandoned (the new
        # epoch's leader re-proposes their batches); hand their pool
        # reservations back or those requests are stuck until auto-remove.
        self.pool.release_reservations()
        self.collector.close()

        self.nodes = new_nodes
        proposal, signatures = self.checkpoint.get()
        self.last_proposal, self.last_signatures = proposal, tuple(signatures)
        md = (
            decode_view_metadata(proposal.metadata)
            if proposal.metadata
            else ViewMetadata()
        )
        self.wal_initial_content = []  # records predate the new epoch
        self._restore_view_change = None
        self.in_flight = InFlightData()
        self.state = PersistedState(self.wal, self.in_flight, entries=[])
        new_dec = md.decisions_in_view + 1 if md.latest_sequence != 0 else 0
        self._create_components()
        self.pool.restart_timers()
        self._start_components(md.view_id, md.latest_sequence + 1, new_dec)

    # --------------------------------------------------------------- ingress

    def submit_request(self, raw: bytes, on_done: Optional[Callable[[Optional[str]], None]] = None) -> None:
        """Parity: reference consensus.go:302-316."""
        if not self._running:
            if on_done:
                on_done("not running")
            return
        self.scheduler.post(
            lambda: self.controller.submit_request(raw, on_done), name="submit"
        )

    def handle_message(self, sender: int, msg: ConsensusMessage) -> None:
        """Consensus traffic ingress (quorum-membership + epoch guarded).

        Parity: reference consensus.go:282-300 (the epoch gate is ours)."""
        if isinstance(msg, EpochTagged):
            if self.config.epoch_tagging and msg.epoch != self.membership_epoch:
                # Traffic from another epoch — a removed node that has not
                # yet learned of its eviction, or a lagging replica.  Drop
                # it HERE, counted and traced, so it can never corrupt the
                # collectors or provoke a spurious view change.
                self._drop_stale_epoch(sender, msg.epoch)
                return
            msg = msg.msg
        if not self._running:
            return
        if sender not in self.nodes:
            if self.config.epoch_tagging:
                self._drop_stale_epoch(sender, None)
            return
        self.scheduler.post(
            lambda: self.controller.process_message(sender, msg), name="handle-msg"
        )

    def _drop_stale_epoch(self, sender: int, epoch: Optional[int]) -> None:
        self.metrics.membership.count_stale_epoch_dropped.add(1)
        self.tracer.instant(
            "membership", "membership.stale_drop", sender=sender, epoch=epoch
        )
        if (
            epoch is not None
            and epoch > self.membership_epoch
            and self._running
            and self.controller is not None
        ):
            # The SENDER is ahead of us: a membership change we have not
            # delivered yet.  Nudge sync (idempotent) so we catch up instead
            # of silently discarding the future.
            self.scheduler.post(self.controller.sync, name="stale-epoch-sync")

    def handle_request(self, sender: int, raw: bytes) -> None:
        if not self._running or sender not in self.nodes:
            return
        self.scheduler.post(
            lambda: self.controller.handle_request(sender, raw), name="handle-req"
        )

    def get_leader_id(self) -> int:
        if not self._running or self.controller is None:
            return 0
        return self.controller.leader_id()

    def _on_pool_submitted(self) -> None:
        if self.controller is not None and not self.controller.stopped:
            self.batcher.pool_changed()


class _EpochStampingComm:
    """Comm decorator stamping outbound consensus traffic with the owner's
    current membership epoch (``wire.EpochTagged``).

    Reads ``consensus.membership_epoch`` at send time, so the stamp tracks
    reconfigurations without re-wiring; transactions and the node roster
    pass through untouched (request forwarding is epoch-agnostic — a request
    is valid in any epoch that still pools it)."""

    def __init__(self, inner: Comm, consensus: "Consensus") -> None:
        self._inner = inner
        self._consensus = consensus

    def send_consensus(self, target_id: int, message) -> None:
        self._inner.send_consensus(
            target_id,
            EpochTagged(epoch=self._consensus.membership_epoch, msg=message),
        )

    def send_transaction(self, target_id: int, request: bytes) -> None:
        self._inner.send_transaction(target_id, request)

    def nodes(self):
        return self._inner.nodes()


class _CommAdapter:
    """View/heartbeat-facing broadcast/send backed by the controller."""

    def __init__(self, controller: Controller) -> None:
        self._controller = controller

    def broadcast(self, msg: ConsensusMessage) -> None:
        self._controller.broadcast(msg)

    def send(self, target_id: int, msg: ConsensusMessage) -> None:
        self._controller.send(target_id, msg)


class _FailureDetectorAdapter:
    def __init__(self, controller: Controller) -> None:
        self._controller = controller

    def complain(self, view: int, stop_view: bool) -> None:
        self._controller.complain(view, stop_view)


__all__ = ["Consensus"]
