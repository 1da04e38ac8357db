"""The Controller: owns the current View, routes messages, runs leader
duties, drives sync, and anchors failure detection.

Parity: reference internal/bft/controller.go (965 LoC).  Structural
deviations, all consequences of the single-threaded runtime:

* The reference's channel plumbing (``decisionChan`` / ``deliverChan`` /
  ``leaderToken`` / ``syncChan``, controller.go:489-526) collapses into plain
  method calls and scheduler posts — the View calls ``decide`` synchronously,
  and delivery happens inline before the next message is processed, which is
  exactly the serialization ``MutuallyExclusiveDeliver`` + ``deliverChan``
  reconstruct with locks (controller.go:873-890, 928-965).  The
  sequence-already-synced guard inside the reference's wrapper is kept
  (``_deliver_checked``).
* The leader token (controller.go:748-761) becomes a boolean + a scheduled
  ``_propose`` continuation; the batcher hands batches back via callback.
* ``sync()`` (controller.go:576-680) becomes a state-machine step chain:
  synchronizer → state-fetch window (collector callback) → view math.

The PyTorch port's copy of ``consensus_tpu/core/controller.py``, its imports renamed.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Protocol, Sequence

from consensus_tpu_torch.api.deps import (
    Application,
    Assembler,
    Comm,
    Signer,
    Synchronizer,
    Verifier,
)
from consensus_tpu_torch.config import Configuration
from consensus_tpu_torch.core.batcher import Batcher
from consensus_tpu_torch.core.collector import StateCollector
from consensus_tpu_torch.core.heartbeat import HeartbeatMonitor, Role
from consensus_tpu_torch.core.pool import RequestPool
from consensus_tpu_torch.core.state import InFlightData, PersistedState, ProposalMaker
from consensus_tpu_torch.core.view import Phase, View
from consensus_tpu_torch.metrics import Metrics
from consensus_tpu_torch.runtime.scheduler import Scheduler
from consensus_tpu_torch.trace.tracer import NOOP_TRACER
from consensus_tpu_torch.types import Checkpoint, Proposal, Reconfig, RequestInfo, Signature
from consensus_tpu_torch.utils.leader import get_leader_id
from consensus_tpu_torch.utils.quorum import compute_quorum
from consensus_tpu_torch.wire import (
    Commit,
    ConsensusMessage,
    HeartBeat,
    HeartBeatResponse,
    NewView,
    PrePrepare,
    Prepare,
    SavedNewView,
    SignedViewData,
    StateTransferRequest,
    StateTransferResponse,
    ViewChange,
    ViewMetadata,
    decode_view_metadata,
    msg_to_string,
)

logger = logging.getLogger("consensus_tpu_torch.controller")

#: TEST-ONLY seeded bug: when True, a replica IGNORES a decision that carried
#: a reconfiguration — no rebuild, no eviction, no epoch advance — so the
#: retired committee keeps certifying decisions after its removal.  The
#: epoch-aware invariant monitor (testing/invariants.py) must catch the
#: resulting quorum certs signed by evicted members.  Never set outside
#: tests (see tests for the fixture that arms and disarms it).
SENTINEL_STALE_MEMBERSHIP = False

#: TEST-ONLY seeded bug: when True, a replica that quarantined a corrupt WAL
#: suffix skips the learner fence entirely — it keeps voting from its
#: amnesiac state before verified sync has carried it past the last intact
#: record.  The learner-fence invariant (testing/invariants.py via the chaos
#: engine's delivery hooks) must catch the resulting votes, because a vote
#: the replica already persisted-and-sent from the quarantined suffix could
#: be re-issued differently (SAFETY.md §13).  Never set outside tests.
SENTINEL_EAGER_UNFENCE = False


class ViewChangerPort(Protocol):
    """What the controller needs from the view changer (it is also the
    failure detector: a complaint is a vote to change views)."""

    def handle_message(self, sender: int, msg: ConsensusMessage) -> None: ...

    def handle_view_message(self, sender: int, msg: ConsensusMessage) -> None:
        """Feed 3-phase traffic to the embedded in-flight view (if any)."""

    def start_view_change(self, view: int, stop_view: bool) -> None: ...

    def inform_new_view(self, view: int) -> None: ...


class Controller:
    def __init__(
        self,
        *,
        scheduler: Scheduler,
        config: Configuration,
        nodes: Sequence[int],
        comm: Comm,
        application: Application,
        assembler: Assembler,
        verifier: Verifier,
        signer: Signer,
        synchronizer: Synchronizer,
        pool: RequestPool,
        batcher: Batcher,
        leader_monitor: HeartbeatMonitor,
        collector: StateCollector,
        state: PersistedState,
        in_flight: InFlightData,
        checkpoint: Checkpoint,
        proposer_builder: ProposalMaker,
        view_changer: Optional[ViewChangerPort] = None,
        on_reconfig: Optional[Callable[[Reconfig], None]] = None,
        metrics: Optional[Metrics] = None,
        tracer=None,
    ) -> None:
        self._sched = scheduler
        self._config = config
        self.id = config.self_id
        self.nodes = tuple(nodes)
        self.n = len(self.nodes)
        self.quorum, self.f = compute_quorum(self.n)
        self._comm = comm
        self._application = application
        self._assembler = assembler
        self._verifier = verifier
        self._signer = signer
        self._synchronizer = synchronizer
        self.pool = pool
        self.batcher = batcher
        self.leader_monitor = leader_monitor
        self.collector = collector
        self._state = state
        self.in_flight = in_flight
        self.checkpoint = checkpoint
        self._proposer_builder = proposer_builder
        self.view_changer = view_changer
        self._on_reconfig = on_reconfig
        self.metrics = metrics or Metrics()
        self._tracer = tracer if tracer is not None else NOOP_TRACER

        self.curr_view_number = 0
        self.curr_decisions_in_view = 0
        self.curr_view: Optional[View] = None
        self._verification_sequence = 0
        self._leader_token = False
        self._propose_pending = False
        self._batch_outstanding = False
        self._sync_in_progress = False
        self._stopped = True
        #: Membership epoch this controller serves (the facade stamps it
        #: after construction; a reconfiguration builds a NEW controller).
        self.membership_epoch = 0
        # Set the moment a reconfiguration surfaces (decide or sync) and
        # never cleared: the rebuild discards this instance.  While pending,
        # queued commits for higher slots must NOT deliver — their certs
        # belong to the retired membership (SAFETY.md §8).
        self._reconfig_pending = False
        # Storage fence: while _fence_height is set this replica is a
        # NON-VOTING LEARNER — it quarantined a corrupt WAL suffix and may
        # have forgotten votes it already sent, so it must not vote again
        # until verified sync carries its checkpoint past _fence_release
        # (SAFETY.md §13).  _wal_degraded suspends proposing/voting while
        # the WAL refuses appends (persist-before-send has nothing durable
        # to stand on) but needs no fence: nothing was forgotten.
        self._fence_height: Optional[int] = None
        self._fence_release: Optional[int] = None
        self._fence_resync_timer = None
        self._wal_degraded = False

    # ------------------------------------------------------------ identity

    def leader_id(self) -> int:
        """Deterministic leader for the current position.

        Parity: reference controller.go:169-183 + util.go:79-107."""
        blacklist: tuple[int, ...] = ()
        if self._config.leader_rotation:
            proposal, _ = self.checkpoint.get()
            if proposal.metadata:
                blacklist = tuple(decode_view_metadata(proposal.metadata).black_list)
        return get_leader_id(
            self.curr_view_number,
            self.n,
            self.nodes,
            leader_rotation=self._config.leader_rotation,
            decisions_in_view=self.curr_decisions_in_view,
            decisions_per_leader=self._config.decisions_per_leader,
            blacklist=blacklist,
        )

    def i_am_the_leader(self) -> bool:
        return self.leader_id() == self.id

    def latest_seq(self) -> int:
        """Sequence of the last checkpointed decision (0 if none)."""
        proposal, _ = self.checkpoint.get()
        if not proposal.metadata:
            return 0
        return decode_view_metadata(proposal.metadata).latest_sequence

    def view_sequence(self) -> tuple[bool, int]:
        """(view_active, in-progress sequence) — for heartbeats and state
        transfer responses."""
        v = self.curr_view
        if v is None or v.stopped:
            return False, 0
        return True, v.proposal_sequence

    def health(self) -> dict:
        """Derived health snapshot for the observability sampler
        (consensus_tpu/obs/): everything is a plain read of existing state,
        so sampling cannot perturb the protocol."""
        active, seq = self.view_sequence()
        v = self.curr_view
        return {
            "view": self.curr_view_number,
            "leader": self.leader_id(),
            "seq": seq,
            "view_active": active,
            "decisions_in_view": self.curr_decisions_in_view,
            "in_flight": v.in_flight_depth() if v is not None else 0,
            "syncing": self._sync_in_progress,
            "epoch": self.membership_epoch,
            "fenced": self.fence_required(),
            "wal_degraded": self._wal_degraded,
        }

    # ----------------------------------------------------------- lifecycle

    def start(
        self,
        start_view_number: int,
        start_proposal_sequence: int,
        start_decisions_in_view: int,
        sync_on_start: bool = False,
    ) -> None:
        """Parity: reference controller.go:781-811."""
        self._stopped = False
        self._verification_sequence = self._verifier.verification_sequence()
        if sync_on_start:
            def after(view: int, seq: int, decisions: int) -> None:
                v, s, d = start_view_number, start_proposal_sequence, start_decisions_in_view
                if view > v:
                    v, d = view, decisions
                if seq > s:
                    s, d = seq, decisions
                self.curr_view_number = v
                self.curr_decisions_in_view = d
                self._start_view(s)

            self._do_sync(on_complete=after)
            return
        self.curr_view_number = start_view_number
        self.curr_decisions_in_view = start_decisions_in_view
        self._start_view(start_proposal_sequence)

    def stop(self, *, pool_pause_only: bool = False) -> None:
        """Parity: reference controller.go:834-871 (Stop/StopWithPoolPause)."""
        self._stopped = True
        self._leader_token = False
        if self._fence_resync_timer is not None:
            self._fence_resync_timer.cancel()
            self._fence_resync_timer = None
        self.batcher.close()
        if pool_pause_only:
            self.pool.stop_timers()
        else:
            self.pool.close()
        self.leader_monitor.close()
        self.collector.close()
        if self.curr_view is not None:
            self.curr_view.abort()

    @property
    def stopped(self) -> bool:
        return self._stopped

    def _start_view(self, proposal_sequence: int) -> None:
        """Parity: reference controller.go:375-396."""
        view, init_phase = self._proposer_builder.new_proposer(
            self.leader_id(),
            proposal_sequence,
            self.curr_view_number,
            self.curr_decisions_in_view,
        )
        self.curr_view = view
        view.start()
        if self.i_am_the_leader():
            if init_phase in (Phase.COMMITTED, Phase.ABORT):
                self._acquire_leader_token()
            self.leader_monitor.change_role(
                Role.LEADER, self.curr_view_number, self.leader_id()
            )
        else:
            self.leader_monitor.change_role(
                Role.FOLLOWER, self.curr_view_number, self.leader_id()
            )
        logger.info(
            "%d: started view %d at seq %d (leader %d)",
            self.id, self.curr_view_number, proposal_sequence, self.leader_id(),
        )
        if self._tracer.enabled:
            self._tracer.instant(
                "controller",
                "viewchange.exit",
                view=self.curr_view_number,
                seq=proposal_sequence,
                leader=self.leader_id(),
            )

    def change_view(
        self, new_view_number: int, new_proposal_sequence: int, new_decisions: int
    ) -> None:
        """Parity: reference controller.go:398-426."""
        if self.curr_view_number > new_view_number:
            return
        if (
            self.curr_view is not None
            and not self.curr_view.stopped
            and self.curr_view_number == new_view_number
            and self.curr_view.leader_id == self.leader_id()
            and self.curr_decisions_in_view == new_decisions
        ):
            return
        self._abort_view(self.curr_view_number)
        self.curr_view_number = new_view_number
        self.curr_decisions_in_view = new_decisions
        self._start_view(new_proposal_sequence)
        if self.i_am_the_leader():
            self.batcher.reset()

    def _abort_view(self, view: int) -> bool:
        if view < self.curr_view_number:
            return False
        if self._tracer.enabled:
            self._tracer.instant("controller", "viewchange.enter", view=view)
        self._leader_token = False
        if self.curr_view is not None:
            self.curr_view.abort()
        # Abandon pipelined slots above the oldest undecided one: the view
        # change may only ever adopt the oldest (SAFETY.md §5), and a stale
        # higher entry would otherwise shadow it after the next decide.
        # No-op at depth 1 (at most one entry in flight).
        self.in_flight.drop_above_oldest()
        # Slots that will never decide must hand their requests back to the
        # batcher (the new view's leader re-batches them from the pool).
        self.pool.release_reservations()
        return True

    # ------------------------------------------------------------- ingress

    def process_message(self, sender: int, msg: ConsensusMessage) -> None:
        """Top-level message router.

        Parity: reference controller.go:321-373 (ProcessMessages)."""
        if self._stopped:
            return
        if isinstance(msg, (PrePrepare, Prepare, Commit)):
            if self._voting_suspended():
                # Fenced learner / degraded WAL: drop 3-phase traffic (we
                # must not vote), but still count leader traffic as a
                # heartbeat so the monitor doesn't manufacture complaints
                # about a leader that is in fact making progress.
                if sender == self.leader_id():
                    self.leader_monitor.inject_artificial_heartbeat(
                        sender, HeartBeat(view=msg.view, seq=msg.seq)
                    )
                return
            if self.curr_view is not None:
                self.curr_view.handle_message(sender, msg)
            if self.view_changer is not None:
                self.view_changer.handle_view_message(sender, msg)
            if sender == self.leader_id():
                self.leader_monitor.inject_artificial_heartbeat(
                    sender, HeartBeat(view=msg.view, seq=msg.seq)
                )
        elif isinstance(msg, (ViewChange, SignedViewData, NewView)):
            if self._voting_suspended():
                # View-change participation is also a vote (and carries our
                # possibly-amnesiac state); the fenced replica re-learns
                # view math from verified sync instead.
                return
            if self.view_changer is not None:
                self.view_changer.handle_message(sender, msg)
        elif isinstance(msg, (HeartBeat, HeartBeatResponse)):
            self.leader_monitor.process_msg(sender, msg)
        elif isinstance(msg, StateTransferRequest):
            active, seq = self.view_sequence()
            self._comm.send_consensus(
                sender,
                StateTransferResponse(
                    view_num=self.curr_view_number,
                    sequence=seq if active else self.latest_seq(),
                ),
            )
        elif isinstance(msg, StateTransferResponse):
            self.collector.handle_response(sender, msg)
        else:
            logger.warning("%d: unknown message %s from %d", self.id, msg, sender)

    # --------------------------------------------------------- requests

    def submit_request(self, raw: bytes, on_done=None) -> None:
        """Client ingress.  Parity: reference controller.go:249-264."""
        if self._stopped:
            if on_done:
                on_done("not running")
            return
        self.pool.submit(raw, on_done)

    def handle_request(self, sender: int, raw: bytes) -> None:
        """A follower forwarded a request to us (the presumed leader):
        verify, then pool it.  Parity: reference controller.go:233-246."""
        if not self.i_am_the_leader():
            logger.warning("%d: got forwarded request but not leader", self.id)
            return
        try:
            self._verifier.verify_request(raw)
        except Exception as e:
            logger.warning("%d: forwarded request failed verification: %s", self.id, e)
            return
        self.pool.submit(raw)

    # Pool timeout cascade (RequestTimeoutHandler).
    def on_request_timeout(self, raw: bytes, info: RequestInfo) -> None:
        leader = self.leader_id()
        if leader == self.id:
            return
        logger.debug("%d: forwarding %s to leader %d", self.id, info, leader)
        self._comm.send_transaction(leader, raw)

    def on_leader_fwd_request_timeout(self, raw: bytes, info: RequestInfo) -> None:
        logger.warning("%d: complaining about leader (request %s)", self.id, info)
        self.complain(self.curr_view_number, stop_view=False)

    def on_auto_remove_timeout(self, info: RequestInfo) -> None:
        pass  # pool already dropped it

    # Heartbeat events (HeartbeatEventHandler).
    def on_heartbeat_timeout(self, view: int, leader_id: int) -> None:
        if view != self.curr_view_number:
            return
        logger.warning("%d: heartbeat timeout on leader %d", self.id, leader_id)
        self.complain(view, stop_view=False)

    def complain(self, view: int, stop_view: bool) -> None:
        """FailureDetector seam.  Parity: consensus.go wires the view changer
        here (pkg/consensus/consensus.go:69-73)."""
        if self._voting_suspended():
            # A complaint is a vote to change views; a fenced learner (or a
            # replica whose WAL refuses appends) must not cast it.
            return
        if self.view_changer is not None:
            self.view_changer.start_view_change(view, stop_view)

    # --------------------------------------- storage fence / degraded WAL

    def fence_as_learner(self, intact_height: int) -> None:
        """Suspend voting after WAL corruption was quarantined: this replica
        may have forgotten votes it already sent from the quarantined
        suffix, so re-voting those slots could equivocate.  It keeps
        serving reads and state transfer, and resumes voting only once a
        verified sync carries its checkpoint past a release bound above the
        last intact record (SAFETY.md §13)."""
        if self._fence_height is not None:
            return  # already fenced; keep the original intact height
        self._fence_height = max(0, int(intact_height))
        self._fence_release = None
        logger.warning(
            "%d: fencing as non-voting learner (intact height %d)",
            self.id, self._fence_height,
        )
        if self._tracer.enabled:
            self._tracer.instant(
                "controller", "fence.enter", intact=self._fence_height
            )
        self._leader_token = False
        self.batcher.close()
        if not self._stopped:
            self.sync()

    def fence_required(self) -> bool:
        """Ground truth for the invariant monitor: True whenever the fence
        bookkeeping says this replica must not vote — deliberately
        independent of the SENTINEL_EAGER_UNFENCE enforcement bypass, so a
        seeded eager-unfence bug is observable from the outside."""
        return self._fence_height is not None

    def _fence_active(self) -> bool:
        if SENTINEL_EAGER_UNFENCE:
            return False
        return self._fence_height is not None

    def _voting_suspended(self) -> bool:
        return self._wal_degraded or self._fence_active()

    def set_wal_degraded(self, degraded: bool) -> None:
        """WAL degrade hook (wal/log.py degrade_hooks): while the log
        refuses appends, persist-before-send has nothing durable to stand
        on, so stop proposing and voting; auto-resume when it heals."""
        degraded = bool(degraded)
        if degraded == self._wal_degraded:
            return
        self._wal_degraded = degraded
        if degraded:
            logger.warning(
                "%d: WAL degraded; suspending proposing/voting", self.id
            )
            self._leader_token = False
            return
        logger.info("%d: WAL recovered; resuming consensus duties", self.id)
        if not self._stopped and self.i_am_the_leader():
            self._acquire_leader_token()

    def _maybe_release_fence(self) -> None:
        """Called whenever the checkpoint advances.  The first verified
        sync after fencing pins the release bound: any vote this replica
        sent from the quarantined suffix was persisted first
        (persist-before-send), so its slot sits at most ``pipeline_depth``
        above what the cluster had decided when we crashed — which is at
        most the synced height.  Once the checkpoint passes that bound,
        every slot we could have voted on is decided and certified by
        others, and re-joining the voter set cannot equivocate."""
        if self._fence_height is None:
            return
        latest = self.latest_seq()
        if self._fence_release is None:
            self._fence_release = (
                max(latest, self._fence_height)
                + max(1, self._config.pipeline_depth)
            )
            logger.info(
                "%d: fence release bound set at seq %d (synced %d)",
                self.id, self._fence_release, latest,
            )
        if latest >= self._fence_release:
            logger.info(
                "%d: fence released at seq %d; resuming voting",
                self.id, latest,
            )
            if self._tracer.enabled:
                self._tracer.instant(
                    "controller", "fence.exit",
                    seq=latest, release=self._fence_release,
                )
            self._fence_height = None
            self._fence_release = None
            if self._fence_resync_timer is not None:
                self._fence_resync_timer.cancel()
                self._fence_resync_timer = None
            if (
                not self._stopped
                and self.i_am_the_leader()
                and not self._voting_suspended()
            ):
                self._acquire_leader_token()
            return
        # Still short of the bound: keep pulling verified state.
        if self._fence_resync_timer is None and not self._stopped:
            self._fence_resync_timer = self._sched.call_later(
                self._config.view_change_resend_interval,
                self._fence_resync,
                name="fence-resync",
            )

    def _fence_resync(self) -> None:
        self._fence_resync_timer = None
        if self._stopped or self._fence_height is None:
            return
        self.sync()

    # ------------------------------------------------------------ proposing

    def _acquire_leader_token(self) -> None:
        """Parity: reference controller.go:748-755 — but as a scheduled
        continuation instead of a channel token."""
        if self._leader_token or self._voting_suspended():
            return
        self._leader_token = True
        if not self._propose_pending:
            self._propose_pending = True
            self._sched.post(self._propose, name="leader-propose")

    def _propose(self) -> None:
        self._propose_pending = False
        if not self._leader_token or self._stopped or self._batch_outstanding:
            return
        self._leader_token = False
        if self.batcher.closed:
            # View change / sync in progress: the token is re-acquired when
            # the next view starts (parity: reference controller.go:476).
            return
        self._batch_outstanding = True
        self.batcher.next_batch(self._on_batch)

    def _on_batch(self, batch: list[bytes]) -> None:
        self._batch_outstanding = False
        if self._stopped:
            return
        if not batch:
            if not self.batcher.closed:
                self._acquire_leader_token()  # try again later
            return
        if self.curr_view is None or self.curr_view.stopped:
            return
        metadata = self.curr_view.get_metadata()
        proposal = self._assembler.assemble_proposal(metadata, batch)
        if self._tracer.enabled:
            # Stamped with the slot this proposal will occupy (read before
            # propose() advances it) so the report can join seal -> phases.
            self._tracer.instant(
                "controller",
                "batch.seal",
                seq=self.curr_view.next_propose_seq,
                view=self.curr_view_number,
                count=len(batch),
            )
        self.curr_view.propose(proposal)
        if self.curr_view.effective_depth > 1:
            # The batch now rides an in-flight slot while still pooled
            # (removal only happens at delivery): hide it from the batcher
            # or the NEXT slot would re-propose the same requests.
            self.pool.reserve_raws(batch)
        if self.curr_view.can_propose():
            # Pipelined window still has slot room: immediately pull the
            # next batch instead of waiting for decide() to hand the
            # leader token back (depth 1 never takes this — can_propose
            # is always False there).
            self._acquire_leader_token()

    # ------------------------------------------------------------- deciding

    def decide(
        self,
        proposal: Proposal,
        signatures: Sequence[Signature],
        requests: Sequence[RequestInfo],
    ) -> None:
        """Called synchronously by the View once a quorum committed.

        Parity: reference controller.go:528-558 (decide) + 873-890 (Decide)
        + the MutuallyExclusiveDeliver guard (928-965)."""
        if self._reconfig_pending:
            # A reconfiguration already surfaced at a lower slot: commits
            # queued for slots above it carry the RETIRED membership's
            # certs.  Those slots are abandoned and re-proposed under the
            # new epoch (the rebuild releases their pool reservations).
            return
        reconfig = self._deliver_checked(proposal, signatures)
        self.pool.remove_requests(requests)
        self.curr_decisions_in_view += 1

        if reconfig.in_latest_decision:
            logger.info("%d: decision carried a reconfiguration", self.id)
            self.metrics.consensus.count_consensus_reconfig.add(1)
            if SENTINEL_STALE_MEMBERSHIP:
                # Seeded bug: pretend the decision was ordinary.  The old
                # committee keeps running — and keeps certifying.
                logger.warning(
                    "%d: SENTINEL_STALE_MEMBERSHIP armed; ignoring reconfig",
                    self.id,
                )
            else:
                self._reconfig_pending = True
                if self._on_reconfig is not None:
                    self._on_reconfig(reconfig)
                return

        md = decode_view_metadata(proposal.metadata)
        self.metrics.blacklist.count.set(len(md.black_list))
        self.metrics.blacklist.node_id_in_blacklist.set(
            1 if self.id in md.black_list else 0
        )
        if self._check_if_rotate(md.black_list):
            logger.info("%d: rotating leader after seq %d", self.id, md.latest_sequence)
            self.change_view(
                self.curr_view_number, md.latest_sequence + 1, self.curr_decisions_in_view
            )
            self.pool.restart_timers()
        self.maybe_prune_revoked_requests()
        if self.i_am_the_leader():
            self._acquire_leader_token()

    def _deliver_checked(
        self, proposal: Proposal, signatures: Sequence[Signature]
    ) -> Reconfig:
        """Deliver unless this sequence was already obtained via sync.

        Parity: reference controller.go:928-965."""
        md = decode_view_metadata(proposal.metadata)
        latest = self.latest_seq()
        if latest != 0 and latest >= md.latest_sequence:
            logger.info(
                "%d: seq %d already synced (latest %d); syncing instead of delivering",
                self.id, md.latest_sequence, latest,
            )
            response = self._synchronizer.sync()
            if response.latest is not None:
                self.checkpoint.set(
                    response.latest.proposal, response.latest.signatures
                )
            self._state.prune_decided(latest)
            # Synced-past slots never hit the per-delivery removal path, so
            # their reservations would pin pooled requests forever.
            self.pool.release_reservations()
            self._maybe_release_fence()
            return response.reconfig
        tracing = self._tracer.enabled
        if tracing:
            self._tracer.begin(
                "view", "phase.deliver", seq=md.latest_sequence, view=md.view_id
            )
        begin = self._sched.now()
        reconfig = self._application.deliver(proposal, signatures)
        self.metrics.view.latency_batch_save.observe(self._sched.now() - begin)
        if tracing:
            self._tracer.end(
                "view", "phase.deliver", seq=md.latest_sequence, view=md.view_id
            )
            self._tracer.end(
                "view", "decision", seq=md.latest_sequence, view=md.view_id
            )
        self.checkpoint.set(proposal, signatures)
        # Forget the delivered slot's mem-window/in-flight entries: with a
        # pipelined window the view changer must only ever see the OLDEST
        # undecided slot, and the persist-before-sign coupling check must
        # not match against an already-delivered entry.
        self._state.prune_decided(md.latest_sequence)
        self._maybe_release_fence()
        return reconfig

    def deliver(self, proposal: Proposal, signatures: Sequence[Signature]) -> Reconfig:
        """Checked delivery for the view changer (its ``Application`` is the
        reference's MutuallyExclusiveDeliver wrapper — same guard here)."""
        if self._reconfig_pending:
            return Reconfig()
        return self._deliver_checked(proposal, signatures)

    def _check_if_rotate(self, blacklist: Sequence[int]) -> bool:
        """Parity: reference controller.go:560-574 (called post-increment)."""
        if not self._config.leader_rotation:
            return False
        curr = get_leader_id(
            self.curr_view_number, self.n, self.nodes,
            leader_rotation=True,
            decisions_in_view=self.curr_decisions_in_view - 1,
            decisions_per_leader=self._config.decisions_per_leader,
            blacklist=blacklist,
        )
        nxt = get_leader_id(
            self.curr_view_number, self.n, self.nodes,
            leader_rotation=True,
            decisions_in_view=self.curr_decisions_in_view,
            decisions_per_leader=self._config.decisions_per_leader,
            blacklist=blacklist,
        )
        return curr != nxt

    def maybe_prune_revoked_requests(self) -> None:
        """Parity: reference controller.go:733-746 — on a verification-
        sequence change, re-validate the whole pool (a sig-heavy burst the
        TPU verifier absorbs as batches)."""
        new_vseq = self._verifier.verification_sequence()
        if new_vseq == self._verification_sequence:
            return
        logger.info(
            "%d: verification sequence %d -> %d; pruning pool",
            self.id, self._verification_sequence, new_vseq,
        )
        self._verification_sequence = new_vseq

        def keep_batch(raws: list) -> list:
            try:
                results = self._verifier.verify_requests_batch(raws)
            except Exception:
                # Infrastructure failure (e.g. the verify device dropped
                # out) is not "every request is invalid": keep the pool and
                # let per-proposal verification catch stale requests.
                logger.exception(
                    "%d: batch re-validation failed; deferring prune", self.id
                )
                return [True] * len(raws)
            if len(results) != len(raws):
                logger.error(
                    "%d: verifier returned %d results for %d requests; "
                    "deferring prune", self.id, len(results), len(raws),
                )
                return [True] * len(raws)
            return [r is not None for r in results]

        self.pool.prune_batch(keep_batch)

    # ----------------------------------------------------------------- sync

    def sync(self) -> None:
        """Schedule a synchronization (idempotent while one is running).

        Parity: reference controller.go:449-454 + syncChan."""
        if self._sync_in_progress or self._stopped:
            return
        if self.i_am_the_leader():
            self.batcher.close()
        self._sched.post(lambda: self._do_sync(), name="controller-sync")

    def _do_sync(
        self, on_complete: Optional[Callable[[int, int, int], None]] = None
    ) -> None:
        """Parity: reference controller.go:576-680 (sync)."""
        if self._sync_in_progress:
            return
        self._sync_in_progress = True
        sync_begin = self._sched.now()

        if self._tracer.enabled:
            self._tracer.begin("controller", "sync")
        response = self._synchronizer.sync()
        if self._tracer.enabled:
            self._tracer.end("controller", "sync")
        if response.reconfig.in_latest_decision:
            self._sync_in_progress = False
            self._reconfig_pending = True
            if self._on_reconfig is not None:
                self._on_reconfig(response.reconfig)
            return

        latest = response.latest
        latest_md: Optional[ViewMetadata] = None
        if latest is not None and latest.proposal.metadata:
            latest_md = decode_view_metadata(latest.proposal.metadata)

        controller_seq = self.latest_seq()
        new_view = self.curr_view_number
        new_seq = controller_seq + 1
        new_decisions = 0

        if latest_md is not None and latest_md.latest_sequence > controller_seq:
            logger.info(
                "%d: sync advanced us to seq %d (was %d)",
                self.id, latest_md.latest_sequence, controller_seq,
            )
            self.checkpoint.set(latest.proposal, latest.signatures)
            self._verification_sequence = latest.proposal.verification_sequence
            new_seq = latest_md.latest_sequence + 1
            new_decisions = latest_md.decisions_in_view + 1
        elif (
            latest_md is not None
            and latest_md.latest_sequence == controller_seq
            and latest_md.view_id == self.curr_view_number
        ):
            # We already hold this view's latest decision: carry its
            # decisions-in-view forward.  When our counter is already right,
            # change_view's early-return makes this a no-op; when a
            # late-processed NewView reset it to 0 while the cluster kept
            # deciding, this repairs it — otherwise every future proposal is
            # rejected ("decisions-in-view N != 0") forever.
            new_decisions = latest_md.decisions_in_view + 1
            if new_decisions != self.curr_decisions_in_view:
                logger.info(
                    "%d: repairing decisions-in-view %d -> %d from checkpoint",
                    self.id, self.curr_decisions_in_view, new_decisions,
                )
        if latest_md is not None and latest_md.view_id > self.curr_view_number:
            new_view = latest_md.view_id

        def on_state(result: Optional[tuple[int, int]]) -> None:
            nonlocal new_view, new_decisions
            self._sync_in_progress = False
            self.metrics.consensus.latency_sync.observe(self._sched.now() - sync_begin)
            latest_decision_seq = (
                latest_md.latest_sequence if latest_md is not None else 0
            )
            latest_decision_view = latest_md.view_id if latest_md is not None else 0
            if result is None:
                logger.info("%d: state fetch failed", self.id)
                if latest_md is None or latest_decision_view < self.curr_view_number:
                    self._finish_sync(0, 0, 0, on_complete)
                    return
            else:
                view, seq = result
                if (
                    view <= self.curr_view_number
                    and latest_decision_view < self.curr_view_number
                ):
                    self._finish_sync(0, 0, 0, on_complete)
                    return
                if view > new_view and seq == latest_decision_seq + 1:
                    logger.info(
                        "%d: cluster is at view %d seq %d", self.id, view, seq
                    )
                    self._state.save(
                        SavedNewView(
                            view_metadata=ViewMetadata(
                                view_id=view,
                                latest_sequence=latest_decision_seq,
                                decisions_in_view=0,
                            )
                        )
                    )
                    new_view = view
                    new_decisions = 0
            if latest_md is not None:
                self._maybe_prune_in_flight(latest_md)
            if new_view > self.curr_view_number and self.view_changer is not None:
                self.view_changer.inform_new_view(new_view)
            self._finish_sync(new_view, new_seq, new_decisions, on_complete)

        self.collector.begin(on_state)
        self.broadcast(StateTransferRequest())

    def _finish_sync(
        self,
        view: int,
        seq: int,
        decisions: int,
        on_complete: Optional[Callable[[int, int, int], None]],
    ) -> None:
        self._maybe_release_fence()
        self.maybe_prune_revoked_requests()
        if on_complete is not None:
            # start(sync_on_start=True) path: caller decides what to start.
            on_complete(view, seq, decisions)
            return
        if view > 0 or seq > 0:
            self.change_view(view, seq, decisions)
        else:
            active, vseq = self.view_sequence()
            self.change_view(
                self.curr_view_number,
                vseq if active else self.latest_seq() + 1,
                self.curr_decisions_in_view,
            )

    def _maybe_prune_in_flight(self, synced_md: ViewMetadata) -> None:
        """Parity: reference controller.go:682-705."""
        proposal = self.in_flight.proposal()
        if proposal is None:
            return
        in_flight_md = decode_view_metadata(proposal.metadata)
        if synced_md.latest_sequence < in_flight_md.latest_sequence:
            return
        logger.info(
            "%d: synced past in-flight seq %d; clearing it",
            self.id, in_flight_md.latest_sequence,
        )
        self.in_flight.clear()

    # --------------------------------------------------------------- egress

    def broadcast(self, msg: ConsensusMessage) -> None:
        """Send to all peers (not self); protocol traffic doubles as our
        heartbeat.  Parity: reference controller.go:912-926."""
        for node in self.nodes:
            if node == self.id:
                continue
            self._comm.send_consensus(node, msg)
        if isinstance(msg, (PrePrepare, Prepare, Commit)) and self.i_am_the_leader():
            self.leader_monitor.heartbeat_was_sent()

    # View-facing comm adapter (View broadcasts through the controller so
    # heartbeat suppression and self-exclusion apply uniformly).
    def send(self, target_id: int, msg: ConsensusMessage) -> None:
        self._comm.send_consensus(target_id, msg)

    # ViewChanged hook (called by the ViewChanger).
    def view_changed(self, new_view_number: int, new_proposal_sequence: int) -> None:
        """Parity: reference controller.go:466-473."""
        if self.i_am_the_leader():
            self.batcher.close()
        self.change_view(new_view_number, new_proposal_sequence, 0)

    def abort_view(self, view: int) -> None:
        """Parity: reference controller.go:457-464."""
        self.batcher.close()
        self._abort_view(view)


__all__ = ["Controller", "ViewChangerPort"]
