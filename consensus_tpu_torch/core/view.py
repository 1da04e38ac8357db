"""The View: one instance of the 3-phase ordering pipeline.

Parity: reference internal/bft/view.go (the 1085-LoC hot loop).  A View is
created per (view number, leader) and restarted on every decision, rotation,
or view change.  Phases walk COMMITTED → PROPOSED → PREPARED → (decide) →
COMMITTED, with ABORT as the exit.

Architectural deviations (deliberate, TPU-first):

* **Event-driven, not goroutine-driven.**  The reference's ``run`` loop
  blocks on channels (view.go:262-299); here ``handle_message`` mutates vote
  state and ``_advance`` replays the phase logic until it stalls waiting for
  more input.  Decisions hand off through the scheduler (``post``) so deep
  decide→next-seq chains never recurse.
* **Batched commit verification.**  The reference spawns a goroutine per
  commit vote and verifies signatures one by one (view.go:537-541,820-849).
  Here incoming commit votes are *buffered unverified*; once enough are
  pending to possibly reach quorum they are verified in a single
  ``verify_consenter_sigs_batch`` call — the seam the TPU engine implements
  as one vmap'd kernel launch.  The same batch seam covers the leader-carried
  previous-commit signatures in ``verify_proposal``.

The PyTorch port's copy of ``consensus_tpu/core/view.py``, its imports renamed.
"""

from __future__ import annotations

import dataclasses
import logging
from enum import IntEnum
from typing import Callable, Optional, Protocol, Sequence

from consensus_tpu_torch.api.deps import MembershipNotifier, Signer, Verifier
from consensus_tpu_torch.metrics import MetricsConsensus, MetricsView, NoopProvider
from consensus_tpu_torch.runtime.scheduler import Scheduler
from consensus_tpu_torch.trace.tracer import NOOP_TRACER
from consensus_tpu_torch.types import Proposal, QuorumCert, RequestInfo, Signature, as_cert
from consensus_tpu_torch.utils.digests import commit_signatures_digest
from consensus_tpu_torch.utils.blacklist import compute_blacklist_update
from consensus_tpu_torch.utils.quorum import compute_quorum
from consensus_tpu_torch.wire import (
    Commit,
    ConsensusMessage,
    PrePrepare,
    Prepare,
    PreparesFrom,
    ProposedRecord,
    SavedCommit,
    ViewMetadata,
    decode_prepares_from,
    decode_view_metadata,
    encode_prepares_from,
    encode_view_metadata,
    encoded_cert_size,
    msg_to_string,
)

logger = logging.getLogger("consensus_tpu_torch.view")

#: TEST-ONLY sentinel (chaos-engine end-to-end validation;
#: tests/test_chaos_engine.py): when flipped, any view installed by a view
#: change (number > 0) collects only a SINGLE peer commit before deciding —
#: a deliberately mis-wired quorum check.  The delivered decision then
#: carries fewer than ``2f + 1`` consenter signatures, which the invariant
#: monitor's commit-implies-quorum-cert check must flag AT DELIVERY TIME,
#: and the delta-debugging shrinker must reduce any failing schedule down
#: to the disruptive action(s) that forced the view change.  Never set
#: outside tests; production constructors cannot reach it.
SENTINEL_MISWIRED_QUORUM = False


class Phase(IntEnum):
    """Parity: reference internal/bft/view.go:23-46."""

    COMMITTED = 0
    PROPOSED = 1
    PREPARED = 2
    ABORT = 3


class Decider(Protocol):
    """Receives a decided proposal (the Controller).

    Parity: reference internal/bft/controller.go:22-24.
    """

    def decide(
        self,
        proposal: Proposal,
        signatures: Sequence[Signature],
        requests: Sequence[RequestInfo],
    ) -> None: ...


class FailureDetector(Protocol):
    """Parity: reference internal/bft/controller.go:29-31."""

    def complain(self, view: int, stop_view: bool) -> None: ...


class SyncRequester(Protocol):
    def sync(self) -> None: ...


class ViewComm(Protocol):
    """Outbound messaging as the view sees it (Controller provides it)."""

    def broadcast(self, msg: ConsensusMessage) -> None: ...

    def send(self, target_id: int, msg: ConsensusMessage) -> None: ...


class ViewState(Protocol):
    """WAL persistence seam (PersistedState implements it).  ``save`` also
    accepts a ``truncate`` keyword (pipelined future-slot records pass
    ``truncate=False`` so only the oldest slot marks restore points); it is
    omitted here so depth-1 fakes need not accept it."""

    def save(self, record, on_durable=None) -> None: ...

    def mark_proposed_verified(self, view_number: int, seq: int) -> None: ...


class CheckpointReader(Protocol):
    def get(self) -> tuple[Proposal, tuple[Signature, ...]]: ...


class _FutureSlot:
    """Per-sequence state for one in-flight slot ABOVE the oldest undecided
    sequence (pipeline_depth > 1 only).  A future slot runs pre-prepare and
    prepare — verify the proposal, persist the ProposedRecord, broadcast our
    Prepare, collect peers' votes — but NEVER signs a commit: the in-order
    commit gate lives in the promotion path (_start_next_seq), which folds
    the slot into the View's legacy current-sequence fields only after every
    lower sequence has decided."""

    __slots__ = (
        "pre_prepare", "proposal", "requests", "prepares", "commits",
        "prepare_sent", "processed", "valid_commit_sigs", "rejected", "begin",
    )

    def __init__(self) -> None:
        self.pre_prepare: Optional[tuple[int, PrePrepare]] = None
        self.proposal: Optional[Proposal] = None
        self.requests: Sequence[RequestInfo] = ()
        self.prepares: dict[int, Prepare] = {}
        self.commits: dict[int, Commit] = {}
        self.prepare_sent: Optional[Prepare] = None
        self.processed = False
        self.valid_commit_sigs: dict[int, Signature] = {}
        self.rejected: set[int] = set()
        self.begin = 0.0


class View:
    """A single view's ordering state machine."""

    def __init__(
        self,
        *,
        scheduler: Scheduler,
        self_id: int,
        number: int,
        leader_id: int,
        proposal_sequence: int,
        decisions_in_view: int,
        n: int,
        nodes: Sequence[int],
        comm: ViewComm,
        verifier: Verifier,
        signer: Signer,
        state: ViewState,
        decider: Decider,
        failure_detector: FailureDetector,
        sync_requester: SyncRequester,
        checkpoint: CheckpointReader,
        decisions_per_leader: int = 0,
        membership_notifier: Optional[MembershipNotifier] = None,
        blacklist_supported: bool = False,
        metrics: Optional[MetricsView] = None,
        pipeline_depth: int = 1,
        consensus_metrics: Optional[MetricsConsensus] = None,
        tracer=None,
        cert_mode: str = "full",
    ) -> None:
        self._sched = scheduler
        self.self_id = self_id
        self.number = number
        self.leader_id = leader_id
        self.proposal_sequence = proposal_sequence
        self.decisions_in_view = decisions_in_view
        self.n = n
        self.nodes = tuple(nodes)
        self.quorum, self.f = compute_quorum(n)
        self._comm = comm
        self._verifier = verifier
        self._signer = signer
        self._state = state
        self._decider = decider
        self._failure_detector = failure_detector
        self._sync = sync_requester
        self._checkpoint = checkpoint
        self.decisions_per_leader = decisions_per_leader
        self._membership_notifier = membership_notifier
        self._blacklist_supported = blacklist_supported

        self.phase = Phase.COMMITTED
        self.in_flight_proposal: Optional[Proposal] = None
        self.in_flight_requests: Sequence[RequestInfo] = ()
        self.my_commit_signature: Optional[Signature] = None

        #: Bounded in-flight window (config `pipeline_depth`).  The legacy
        #: single-slot fields below always describe the OLDEST undecided
        #: sequence; sequences strictly above it (up to the window edge) live
        #: in `_future` and only ever reach the prepare phase there — the
        #: commit gate is promotion-ordered (see _FutureSlot).
        self.pipeline_depth = max(1, pipeline_depth)
        self._future: dict[int, _FutureSlot] = {}
        self._consensus_metrics = consensus_metrics
        #: Configuration.cert_mode — "half-agg" compresses each decided
        #: quorum into a half-aggregated QuorumCert (models/aggregate.py)
        #: when the verifier supports it; "full" keeps signature tuples
        #: bit-for-bit.
        self.cert_mode = cert_mode

        # Pipelining buffers: current sequence + the next one (depth 1),
        # parity: reference view.go:107-113,860-894.
        self._pending_pre_prepare: Optional[tuple[int, PrePrepare]] = None
        self._next_pre_prepare: Optional[tuple[int, PrePrepare]] = None
        self._prepares: dict[int, Prepare] = {}
        self._next_prepares: dict[int, Prepare] = {}
        self._commits: dict[int, Commit] = {}
        self._next_commits: dict[int, Commit] = {}
        #: Commit signatures proven valid for the in-flight proposal.
        self._valid_commit_sigs: dict[int, Signature] = {}
        #: Commit senders whose signature failed batch verification.
        self._rejected_commit_senders: set[int] = set()

        # Retransmission help (previous sequence), view.go:718-756.
        self._prev_prepare_sent: Optional[Prepare] = None
        self._prev_commit_sent: Optional[Commit] = None
        self._curr_prepare_sent: Optional[Prepare] = None
        self._curr_commit_sent: Optional[Commit] = None

        # Censorship / partition detection, view.go:758-818.
        self._last_voted_proposal_by_id: dict[int, Commit] = {}

        self.stopped = False
        #: Set when a restore re-verification of our own proposal failed
        #: (state.py::_enter_proposed): we stay pinned to the proposal (no
        #: equivocation) but must never endorse it — no prepare was armed,
        #: and the PROPOSED->PREPARED transition (which signs a commit, a
        #: stronger endorsement) is blocked until a view change resolves it.
        self.endorsement_blocked = False
        self._begin_pre_prepare = 0.0
        self._tracer = tracer if tracer is not None else NOOP_TRACER
        self.metrics = metrics or MetricsView(NoopProvider())
        self.metrics.view_number.set(number)
        self.metrics.leader_id.set(leader_id)
        self.metrics.proposal_sequence.set(proposal_sequence)
        self.metrics.decisions_in_view.set(decisions_in_view)

    # ------------------------------------------------------------------ API

    def start(self) -> None:
        """Kick a (possibly WAL-restored) view into action: re-broadcast the
        message implied by the restored phase (reference resurrects
        ``lastBroadcastSent``, internal/bft/state.go:163-247)."""
        if self.phase != Phase.COMMITTED and self._begin_pre_prepare == 0.0:
            # Restored mid-protocol: latency measures from the restart, not
            # from clock epoch.
            self._begin_pre_prepare = self._sched.now()
        self.metrics.phase.set(int(self.phase))
        # The recovery rebroadcast goes out WITHOUT the assist flag: peers
        # that already moved past this sequence reply to a non-assist
        # message with their own prev-seq assist copies (that reply is how
        # a commit-starved replica closes its gap), but deliberately ignore
        # assist-marked ones to avoid reply loops.  The stored *_sent copies
        # keep assist=True for their other job, straggler retransmission
        # help.  Parity: reference view.go:285-288 ("broadcast here serves
        # also recovery") vs the assist copies of view.go:417,512.
        if self.phase == Phase.PROPOSED and self._curr_prepare_sent is not None:
            self._comm.broadcast(
                dataclasses.replace(self._curr_prepare_sent, assist=False)
            )
        elif self.phase == Phase.PREPARED and self._curr_commit_sent is not None:
            self._comm.broadcast(
                dataclasses.replace(self._curr_commit_sent, assist=False)
            )

    @property
    def effective_depth(self) -> int:
        """Window width actually in force.  Rotation counts decisions per
        leader against checkpoint certificates a pipelined window does not
        produce in order, so depth collapses to 1 under rotation (config
        validation rejects the combination outright)."""
        return self.pipeline_depth if self.decisions_per_leader == 0 else 1

    @property
    def next_propose_seq(self) -> int:
        """First sequence in the window with no accepted or pending
        proposal — the slot the leader's next pre-prepare targets."""
        if (
            self.phase == Phase.COMMITTED
            and self._pending_pre_prepare is None
            and self.in_flight_proposal is None
        ):
            return self.proposal_sequence
        s = self.proposal_sequence + 1
        while True:
            slot = self._future.get(s)
            if slot is None or slot.pre_prepare is None:
                return s
            s += 1

    def can_propose(self) -> bool:
        """Whether the leader still has window room for another proposal
        (always False at depth 1: the controller's decide-driven token flow
        already covers the single-slot cadence)."""
        if self.stopped or self.effective_depth <= 1:
            return False
        return self.next_propose_seq < self.proposal_sequence + self.effective_depth

    def propose(self, proposal: Proposal) -> None:
        """Leader entry point: wrap ``proposal`` in a PrePrepare carrying the
        previous decision's commit signatures, and pre-prepare *ourselves*
        first (the broadcast to others happens after we persist — parity:
        reference view.go:951-974, 421-423).

        With a pipelined window the pre-prepare targets the first free slot,
        and carries NO previous-decision signatures: a follower verifying a
        future slot has not delivered the preceding decisions yet, so its
        checkpoint cannot match whatever certificate the leader would attach
        (pipelining requires rotation off, where the certificate is unused
        and `_verify_prev_commit_signatures` accepts an empty set)."""
        pipelined = self.effective_depth > 1
        _, prev_sigs = self._checkpoint.get()
        prev_cert = () if pipelined else as_cert(prev_sigs)
        pp = PrePrepare(
            view=self.number,
            seq=self.next_propose_seq if pipelined else self.proposal_sequence,
            proposal=proposal,
            prev_commit_signatures=prev_cert,
        )
        if isinstance(prev_cert, QuorumCert) and self._consensus_metrics is not None:
            self._consensus_metrics.net_cert_bytes.add(encoded_cert_size(prev_cert))
        self.handle_message(self.leader_id, pp)

    def abort(self) -> None:
        """Parity: reference view.go Abort/stop."""
        if not self.stopped and self._tracer.enabled:
            self._tracer.instant(
                "view", "view.abort", seq=self.proposal_sequence, view=self.number
            )
        self.stopped = True
        self.phase = Phase.ABORT
        self.metrics.phase.set(int(self.phase))

    @property
    def view_sequence(self) -> tuple[int, int]:
        return self.number, self.proposal_sequence

    # ----------------------------------------------------------- ingress

    def handle_message(self, sender: int, msg: ConsensusMessage) -> None:
        """Route one consensus message into the view.

        Parity: reference view.go:194-259 (processMsg).
        """
        if self.stopped:
            return
        if not isinstance(msg, (PrePrepare, Prepare, Commit)):
            return

        msg_view = msg.view
        msg_seq = msg.seq

        if msg_view != self.number:
            if sender != self.leader_id:
                self._discover_if_sync_needed(sender, msg)
                return
            # Wrong view *from the leader* is evidence of a sick leader.
            logger.warning(
                "%d: leader %d sent view %d, expected %d — complaining",
                self.self_id, sender, msg_view, self.number,
            )
            self._failure_detector.complain(self.number, False)
            if msg_view > self.number:
                self._sync.sync()
            self.abort()
            return

        if msg_seq == self.proposal_sequence - 1 and self.proposal_sequence > 0:
            self._handle_prev_seq_message(sender, msg)
            return

        depth = self.effective_depth
        if depth > 1 and self.proposal_sequence < msg_seq <= self.proposal_sequence + depth:
            # Windowed mode: anything above the oldest slot (up to one past
            # the window edge, for a leader one decision ahead of us) lands
            # in a future slot.  Depth 1 keeps the legacy ps/ps+1 routing
            # below untouched.
            self._handle_future_slot_message(sender, msg, msg_seq)
            return
        if depth > 1 and msg_seq < self.proposal_sequence - 1:
            # Replicas spread over several sequences routinely deliver
            # assist votes for slots the window has already decided and
            # advanced past — stale by construction, not sync evidence.
            return

        if msg_seq not in (self.proposal_sequence, self.proposal_sequence + 1):
            logger.warning(
                "%d: got %s from %d at seq %d, ours is %d",
                self.self_id, msg_to_string(msg), sender, msg_seq, self.proposal_sequence,
            )
            self._discover_if_sync_needed(sender, msg)
            return

        for_next = msg_seq == self.proposal_sequence + 1

        if isinstance(msg, PrePrepare):
            self._accept_pre_prepare(sender, msg, for_next)
        elif sender == self.self_id:
            return  # own votes are implicit
        elif isinstance(msg, Prepare):
            votes = self._next_prepares if for_next else self._prepares
            votes.setdefault(sender, msg)
            if not for_next:
                self._advance()
        else:  # Commit
            if msg.signature.id != sender:
                return  # vote must be signed by its sender
            votes = self._next_commits if for_next else self._commits
            votes.setdefault(sender, msg)
            if not for_next:
                self._advance()

    def _accept_pre_prepare(self, sender: int, pp: PrePrepare, for_next: bool) -> None:
        if sender != self.leader_id:
            logger.warning(
                "%d: pre-prepare from %d but leader is %d",
                self.self_id, sender, self.leader_id,
            )
            return
        if for_next:
            if self._next_pre_prepare is None:
                self._next_pre_prepare = (sender, pp)
            return
        if self._pending_pre_prepare is None:
            self._pending_pre_prepare = (sender, pp)
            self._advance()

    # ------------------------------------------- pipelined window (depth > 1)

    def _handle_future_slot_message(
        self, sender: int, msg: ConsensusMessage, seq: int
    ) -> None:
        """Buffer/process a message for a sequence above the oldest slot.

        Sequences strictly inside the window run pre-prepare/prepare
        immediately; the slot one past the window edge is buffer-only until
        a decision slides the window over it."""
        slot = self._future.get(seq)
        if slot is None:
            slot = self._future[seq] = _FutureSlot()
        if isinstance(msg, PrePrepare):
            if sender != self.leader_id:
                logger.warning(
                    "%d: pre-prepare from %d but leader is %d",
                    self.self_id, sender, self.leader_id,
                )
                return
            if slot.pre_prepare is None:
                slot.pre_prepare = (sender, msg)
                if seq < self.proposal_sequence + self.effective_depth:
                    self._process_future_slot(seq, slot)
            return
        if sender == self.self_id:
            return  # own votes are implicit
        if isinstance(msg, Prepare):
            slot.prepares.setdefault(sender, msg)
        else:  # Commit
            if msg.signature.id != sender:
                return  # vote must be signed by its sender
            slot.commits.setdefault(sender, msg)

    def _process_future_slot(self, seq: int, slot: _FutureSlot) -> None:
        """Run pre-prepare + prepare for a future slot: verify, persist the
        ProposedRecord (truncate-free — only the oldest slot marks a stable
        restore point), and broadcast our Prepare once durable AND verified.
        Mirrors _try_process_proposal but never advances the legacy phase
        machine — commits stay gated on promotion."""
        assert slot.pre_prepare is not None
        _, pp = slot.pre_prepare
        proposal = pp.proposal
        i_am_leader = self.self_id == self.leader_id
        prepare = Prepare(view=self.number, seq=seq, digest=proposal.digest())
        gate = {"durable": False, "verified": False, "prepare_sent": False}
        tracer = self._tracer
        if tracer.enabled:
            tracer.begin("view", "decision", seq=seq, view=self.number)
            tracer.begin("view", "phase.pre_prepare", seq=seq, view=self.number)

        def maybe_send_prepare() -> None:
            if not (gate["durable"] and gate["verified"]) or gate["prepare_sent"]:
                return
            gate["prepare_sent"] = True
            if self.stopped:
                return  # aborted view: never utter stale-view votes
            assist_copy = Prepare(
                view=prepare.view, seq=prepare.seq, digest=prepare.digest, assist=True
            )
            # A late flush may land after this slot was promoted (it became
            # the current sequence) or even decided; park the assist copy
            # wherever the retransmission machinery now looks for it.
            if self.proposal_sequence == seq and self._curr_prepare_sent is None:
                self._curr_prepare_sent = assist_copy
            elif self.proposal_sequence == seq + 1 and self._prev_prepare_sent is None:
                self._prev_prepare_sent = assist_copy
            else:
                slot.prepare_sent = assist_copy
            self._comm.broadcast(prepare)

        def send_after_durable() -> None:
            if gate["durable"]:
                return
            gate["durable"] = True
            if self.stopped:
                return
            if i_am_leader:
                # Reveal-before-verify, same rationale as the oldest slot.
                self._comm.broadcast(pp)
            maybe_send_prepare()

        if i_am_leader:
            self._state.save(
                ProposedRecord(pre_prepare=pp, prepare=prepare, verified=False),
                on_durable=send_after_durable,
                truncate=False,
            )
        try:
            requests = self._verify_proposal(
                proposal,
                pp.prev_commit_signatures,
                expected_seq=seq,
                expected_decisions=self.decisions_in_view
                + (seq - self.proposal_sequence),
            )
        except Exception as err:
            logger.warning(
                "%d: bad pipelined proposal from leader %d at seq %d: %s",
                self.self_id, self.leader_id, seq, err,
            )
            if tracer.enabled:
                tracer.instant(
                    "view", "proposal.rejected", seq=seq, view=self.number
                )
                tracer.end("view", "phase.pre_prepare", seq=seq, view=self.number)
                tracer.end("view", "decision", seq=seq, view=self.number)
            self._failure_detector.complain(self.number, False)
            self._sync.sync()
            self.abort()
            return

        slot.proposal = proposal
        slot.requests = tuple(requests)
        slot.processed = True
        slot.begin = self._sched.now()
        if tracer.enabled:
            tracer.end(
                "view",
                "phase.pre_prepare",
                seq=seq,
                view=self.number,
                txs=len(requests),
            )
            tracer.begin("view", "phase.prepare", seq=seq, view=self.number)
        if i_am_leader:
            self._state.mark_proposed_verified(self.number, seq)
        else:
            self._state.save(
                ProposedRecord(pre_prepare=pp, prepare=prepare),
                on_durable=send_after_durable,
                truncate=False,
            )
        gate["verified"] = True
        maybe_send_prepare()
        self._update_inflight_depth()
        logger.info(
            "%d: pipelined seq %d in view %d (oldest %d)",
            self.self_id, seq, self.number, self.proposal_sequence,
        )

    def in_flight_depth(self) -> int:
        """Proposal slots currently moving through the 3-phase pipeline:
        the oldest slot (when past PROPOSED) plus every processed pipelined
        slot above it.  The same number the ``consensus_in_flight_depth``
        gauge reports; public so the observability sampler can read it
        without an in-memory metrics provider."""
        depth = 1 if self.phase in (Phase.PROPOSED, Phase.PREPARED) else 0
        return depth + sum(1 for slot in self._future.values() if slot.processed)

    def _update_inflight_depth(self) -> None:
        if self._consensus_metrics is None:
            return
        self._consensus_metrics.in_flight_depth.set(self.in_flight_depth())

    # ------------------------------------------------------ phase machine

    def _advance(self) -> None:
        """Re-run the phase logic until it stalls waiting for input.

        Parity: reference view.go:282-299 (doPhase), minus the blocking.
        """
        if self.stopped:
            return
        if self.phase == Phase.COMMITTED:
            self._try_process_proposal()
        if self.phase == Phase.PROPOSED:
            self._try_process_prepares()
        if self.phase == Phase.PREPARED:
            self._try_process_commits()

    # --- COMMITTED -> PROPOSED (view.go:351-427) ---------------------------

    def _try_process_proposal(self) -> None:
        if self._pending_pre_prepare is None:
            return
        _, pp = self._pending_pre_prepare
        self._pending_pre_prepare = None
        proposal = pp.proposal
        i_am_leader = self.self_id == self.leader_id
        tracer = self._tracer
        if (
            isinstance(pp.prev_commit_signatures, QuorumCert)
            and self._consensus_metrics is not None
        ):
            # Every replica WALs this pre-prepare exactly once (leader before
            # verification, follower after); account the cert's share here.
            self._consensus_metrics.wal_cert_bytes.add(
                encoded_cert_size(pp.prev_commit_signatures)
            )
        if tracer.enabled:
            tracer.begin(
                "view", "decision", seq=self.proposal_sequence, view=self.number
            )
            tracer.begin(
                "view",
                "phase.pre_prepare",
                seq=self.proposal_sequence,
                view=self.number,
            )

        prepare = Prepare(
            view=self.number, seq=self.proposal_sequence, digest=proposal.digest()
        )
        # The prepare may only go out once BOTH gates pass: the ProposedRecord
        # is durable (WAL-before-send, view.go:404-414) and the proposal is
        # verified.  All callbacks run on the replica's scheduler thread
        # (group-commit flushes are scheduler events), so the gates need no
        # lock; gate["prepare_sent"] is the sent-once guard (late flushes
        # may fire after _start_next_seq reset _curr_prepare_sent).
        gate = {"durable": False, "verified": False, "prepare_sent": False}

        def maybe_send_prepare() -> None:
            if not (gate["durable"] and gate["verified"]) or gate["prepare_sent"]:
                return
            gate["prepare_sent"] = True
            if self.stopped:
                # Aborted view: do NOT utter stale-view votes.  A late
                # flush firing after a view change would broadcast a
                # wrong-view message — and if this replica is the NEW
                # view's leader, peers treat wrong-view-from-leader as
                # leader sickness (handle_message) and abort the view they
                # just installed.
                return
            if self.proposal_sequence != prepare.seq:
                # LATE but durable AND verified (a group-commit flush that
                # landed after this view advanced a sequence): still reveal
                # it — skipping the send can wedge peers that are still
                # collecting this quorum (found by the multi-process
                # disk-group bench: a replica that decided via its peers'
                # votes before its own flush fired never uttered its vote,
                # and a laggard starved forever).  Safety is unchanged —
                # the endorsement is durably pinned and carries its own
                # (view, seq).  The CURRENT-sequence assist slot is
                # off-limits, but a flush exactly one sequence late may arm
                # the PREV-seq assist copy (empty precisely because the
                # send was deferred), so the retransmission machinery
                # covers loss of this one late broadcast.
                if (
                    self.proposal_sequence == prepare.seq + 1
                    and self._prev_prepare_sent is None
                ):
                    self._prev_prepare_sent = Prepare(
                        view=prepare.view, seq=prepare.seq,
                        digest=prepare.digest, assist=True,
                    )
                self._comm.broadcast(prepare)
                return
            # The assist copy is only armed here — retransmission help must
            # never reveal an un-persisted message either.
            self._curr_prepare_sent = Prepare(
                view=prepare.view, seq=prepare.seq, digest=prepare.digest, assist=True
            )
            self._comm.broadcast(prepare)

        def send_after_durable() -> None:
            # Under group commit this fires from the batched fsync event;
            # default mode fires inline during save().  Idempotent: a retried
            # flush must not re-reveal the pre-prepare (durability is a fact
            # once achieved — the flush layer fires each callback exactly
            # once, and the gate guards the rest).
            if gate["durable"]:
                return
            gate["durable"] = True
            if self.stopped:
                # Aborted view: reveal nothing (a stale-view pre-prepare
                # from a replica that leads the NEW view too would read as
                # leader sickness to its peers — see maybe_send_prepare).
                return
            if i_am_leader:
                # Reveal the proposal the moment it is durable — BEFORE our
                # own verification completes.  This departs from the
                # reference's ordering (view.go:421-423 echoes the
                # pre-prepare only after verifyProposal) deliberately: the
                # followers' proposal verification then overlaps the
                # leader's, and on the batch-verify engine all n replicas'
                # request sweeps coalesce into ONE device launch instead of
                # the leader's solo launch serializing before everyone
                # else's.  Safety is unaffected: a pre-prepare carries no
                # endorsement (prepares/commits do, and ours still waits for
                # verification), and the durable ProposedRecord already
                # pins us to this proposal at this (view, seq) across
                # crashes, so no equivocation window opens.
                self._comm.broadcast(pp)
            maybe_send_prepare()

        if i_am_leader:
            # verified=False: this record is written BEFORE our own
            # verification completes, and any restore from it must re-verify
            # (state.py::_enter_proposed) before re-arming the prepare.
            self._state.save(
                ProposedRecord(pre_prepare=pp, prepare=prepare, verified=False),
                on_durable=send_after_durable,
            )

        try:
            requests = self._verify_proposal(proposal, pp.prev_commit_signatures)
        except Exception as err:
            logger.warning(
                "%d: bad proposal from leader %d: %s", self.self_id, self.leader_id, err
            )
            if tracer.enabled:
                # Close the spans so rejected slots cannot corrupt nesting.
                tracer.instant(
                    "view",
                    "proposal.rejected",
                    seq=self.proposal_sequence,
                    view=self.number,
                )
                tracer.end(
                    "view",
                    "phase.pre_prepare",
                    seq=self.proposal_sequence,
                    view=self.number,
                )
                tracer.end(
                    "view", "decision", seq=self.proposal_sequence, view=self.number
                )
            self._failure_detector.complain(self.number, False)
            self._sync.sync()
            self.abort()
            return

        self.in_flight_proposal = proposal
        self.in_flight_requests = tuple(requests)
        self.metrics.count_txs_in_batch.set(len(requests))
        # Stamped post-verification on every replica, keeping
        # latency_batch_processing's definition (prepare/commit exchange
        # only) identical to the pre-reordering numbers in BASELINE.md.
        self._begin_pre_prepare = self._sched.now()
        self.phase = Phase.PROPOSED
        self.metrics.phase.set(int(self.phase))
        if tracer.enabled:
            tracer.end(
                "view",
                "phase.pre_prepare",
                seq=self.proposal_sequence,
                view=self.number,
                txs=len(requests),
            )
            tracer.begin(
                "view", "phase.prepare", seq=self.proposal_sequence, view=self.number
            )
        if i_am_leader:
            # Verification succeeded: flip the in-memory record so a mid-run
            # view restart (reseed_if_inflight_matches) does not pay a
            # redundant re-verify.  The on-disk record keeps verified=False —
            # a crash-restore re-verifies, which is the conservative side.
            self._state.mark_proposed_verified(self.number, prepare.seq)
        else:
            # Followers keep the reference's strict order: verify first,
            # then persist, then speak (view.go:351-427).
            self._state.save(
                ProposedRecord(pre_prepare=pp, prepare=prepare),
                on_durable=send_after_durable,
            )
        gate["verified"] = True
        maybe_send_prepare()
        self._update_inflight_depth()
        logger.info("%d: proposed seq %d in view %d", self.self_id, prepare.seq, self.number)

    # --- PROPOSED -> PREPARED (view.go:441-517) ----------------------------

    def _try_process_prepares(self) -> None:
        assert self.in_flight_proposal is not None
        if self.endorsement_blocked:
            return
        expected = self.in_flight_proposal.digest()
        voters = [s for s, p in self._prepares.items() if p.digest == expected]
        if len(voters) < self.quorum - 1:
            return

        if self._tracer.enabled:
            self._tracer.end(
                "view",
                "phase.prepare",
                seq=self.proposal_sequence,
                view=self.number,
                prepares=len(voters),
            )
            self._tracer.begin(
                "view", "phase.commit", seq=self.proposal_sequence, view=self.number
            )
        aux = encode_prepares_from(PreparesFrom(ids=tuple(sorted(voters))))
        self.my_commit_signature = self._signer.sign_proposal(
            self.in_flight_proposal, aux
        )
        commit = Commit(
            view=self.number,
            seq=self.proposal_sequence,
            digest=expected,
            signature=self.my_commit_signature,
        )

        def send_after_durable() -> None:
            if self._tracer.enabled:
                self._tracer.instant(
                    "view", "commit.durable", seq=commit.seq, view=commit.view
                )
            if self.stopped:
                return  # aborted view: never utter stale-view votes
            assist_copy = Commit(
                view=commit.view,
                seq=commit.seq,
                digest=commit.digest,
                signature=commit.signature,
                assist=True,
            )
            if self.proposal_sequence == commit.seq:
                self._curr_commit_sent = assist_copy
            elif (
                self.proposal_sequence == commit.seq + 1
                and self._prev_commit_sent is None
            ):
                # One sequence late: arm the prev-seq assist slot (empty
                # precisely because this send was deferred) so loss of the
                # single late broadcast is retransmittable.
                self._prev_commit_sent = assist_copy
            # Broadcast even when the flush landed late (same view, next
            # sequence): the commit is durable and peers still assembling
            # this quorum need it — a skipped send can starve a laggard
            # forever (the group-commit wedge; see maybe_send_prepare
            # above).
            self._comm.broadcast(commit)

        self.phase = Phase.PREPARED
        self.metrics.phase.set(int(self.phase))
        # WAL before send again: the commit we are about to utter.
        self._state.save(SavedCommit(commit=commit), on_durable=send_after_durable)
        logger.info("%d: prepared seq %d (%d prepares)", self.self_id, commit.seq, len(voters))

    # --- PREPARED -> decide (view.go:519-551, batched) ---------------------

    def _try_process_commits(self) -> None:
        assert self.in_flight_proposal is not None
        needed = self.quorum - 1
        if SENTINEL_MISWIRED_QUORUM and self.number > 0:
            needed = 1  # test-only mis-wiring; see the module-level sentinel
        if len(self._valid_commit_sigs) < needed:
            self._batch_verify_pending_commits(needed)
        if len(self._valid_commit_sigs) < needed:
            return

        signatures = list(self._valid_commit_sigs.values())[:needed]
        proposal = self.in_flight_proposal
        requests = self.in_flight_requests
        assert self.my_commit_signature is not None
        signatures.append(self.my_commit_signature)
        logger.info(
            "%d: collected %d commits for seq %d",
            self.self_id, len(signatures), self.proposal_sequence,
        )
        self.metrics.count_batch_all.add(1)
        self.metrics.count_txs_all.add(len(requests))
        size = len(proposal.payload) + len(proposal.header) + len(proposal.metadata)
        size += sum(len(s.value) + len(s.msg) for s in signatures)
        self.metrics.size_of_batch.add(size)
        self.metrics.latency_batch_processing.observe(
            self._sched.now() - self._begin_pre_prepare
        )
        if self._tracer.enabled:
            self._tracer.end(
                "view",
                "phase.commit",
                seq=self.proposal_sequence,
                view=self.number,
                commits=len(signatures),
            )
        decided_sigs = self._maybe_aggregate_cert(proposal, signatures)
        self._start_next_seq()
        self._decider.decide(proposal, decided_sigs, requests)

    def _maybe_aggregate_cert(self, proposal: Proposal, signatures: list[Signature]):
        """Half-aggregate the decided quorum into a compact ``QuorumCert``.

        Active only under ``cert_mode="half-agg"`` with an aggregation-capable
        verifier; otherwise the full signature list flows through untouched
        (bit-for-bit identical to the pre-cert behaviour).  Aggregation
        failure — a component signature the aggregator's self-check rejects,
        localized by bisection — degrades gracefully back to the full tuple:
        compactness is a perf optimisation, never a liveness dependency.

        On success the cert is persisted alongside the already-WAL'd commit
        (a second SavedCommit twin at the same (view, seq); recovery scans
        tolerate the duplicate and prefer the cert-bearing record), so a
        restarted leader can re-serve the compact cert without re-running
        aggregation over signatures it no longer holds.
        """
        if self.cert_mode != "half-agg":
            return signatures
        aggregate = getattr(self._verifier, "aggregate_cert", None)
        if aggregate is None or not getattr(
            self._verifier, "supports_cert_aggregation", False
        ):
            return signatures
        cm = self._consensus_metrics
        if self._tracer.enabled:
            self._tracer.begin(
                "view", "cert.aggregate", seq=self.proposal_sequence, view=self.number
            )
        cert = None
        try:
            cert = aggregate(proposal, tuple(signatures))
        finally:
            if self._tracer.enabled:
                self._tracer.end(
                    "view",
                    "cert.aggregate",
                    seq=self.proposal_sequence,
                    view=self.number,
                    aggregated=cert is not None,
                )
        if cert is None:
            logger.warning(
                "%d: cert aggregation fell back to full signatures at seq %d",
                self.self_id, self.proposal_sequence,
            )
            if cm is not None:
                cm.cert_fallback_bisections.add(1)
            return signatures
        if cm is not None:
            nbytes = encoded_cert_size(cert)
            cm.cert_aggregate_launches.add(1)
            cm.cert_bytes_per_cert.observe(nbytes)
            cm.wal_cert_bytes.add(nbytes)
        if self._curr_commit_sent is not None:
            self._state.save(
                SavedCommit(
                    commit=dataclasses.replace(self._curr_commit_sent, assist=False),
                    cert=cert,
                )
            )
        return cert

    def _batch_verify_pending_commits(self, needed: int) -> None:
        """Verify buffered commit votes in one batch call (the TPU seam).

        Waits until enough unverified votes are pending to possibly reach
        quorum, then verifies them all at once — one kernel launch per
        decision in the common case, versus the reference's
        goroutine-per-vote (view.go:537-541)."""
        assert self.in_flight_proposal is not None
        expected = self.in_flight_proposal.digest()
        pending: list[Commit] = []
        for sender, commit in self._commits.items():
            if sender in self._valid_commit_sigs or sender in self._rejected_commit_senders:
                continue
            if commit.digest != expected:
                continue
            pending.append(commit)
        if len(self._valid_commit_sigs) + len(pending) < needed:
            return  # not enough to possibly decide; keep buffering

        sigs = [c.signature for c in pending]
        results = self._verify_commits_coalesced(sigs, pending)
        for commit, result in zip(pending, results):
            if result is None:
                logger.warning(
                    "%d: invalid commit signature from %d",
                    self.self_id, commit.signature.id,
                )
                self._rejected_commit_senders.add(commit.signature.id)
            else:
                self._valid_commit_sigs[commit.signature.id] = commit.signature

    def _verify_commits_coalesced(
        self, sigs: list[Signature], pending: list[Commit]
    ) -> Sequence[Optional[bytes]]:
        """One verification launch for the oldest slot's pending commits —
        and, when pipelined, for every future slot's buffered commits too.
        Peers that decided ahead of us send their commit for seq n+k the
        moment it is THEIR oldest, so under a saturated window the votes a
        promoted slot will need are already verified by the time it signs:
        launches-per-decision drops below one.  Results for future slots are
        cached on the slot (valid_commit_sigs / rejected)."""
        cm = self._consensus_metrics
        future_groups: list[tuple[_FutureSlot, list[Commit]]] = []
        if self.effective_depth > 1:
            for s in sorted(self._future):
                slot = self._future[s]
                if not slot.processed or slot.proposal is None:
                    continue
                want = slot.proposal.digest()
                extra = [
                    c
                    for sender, c in slot.commits.items()
                    if sender not in slot.valid_commit_sigs
                    and sender not in slot.rejected
                    and c.digest == want
                ]
                if extra:
                    future_groups.append((slot, extra))

        multi = getattr(self._verifier, "verify_consenter_sigs_multi_batch", None)
        if not future_groups or multi is None:
            self.metrics.count_batch_sig_verifications.add(len(sigs))
            if cm is not None:
                cm.count_verify_launches.add(1)
                cm.cross_slot_verify_batch.observe(len(sigs))
            if self._tracer.enabled:
                # Same value the cross_slot_verify_batch histogram observes:
                # the trace and metrics views of launch batching must agree.
                self._tracer.instant("view", "verify.launch", size=len(sigs))
            return self._verifier.verify_consenter_sigs_batch(
                sigs, self.in_flight_proposal
            )

        groups = [(self.in_flight_proposal, sigs)]
        groups.extend(
            (slot.proposal, [c.signature for c in extra])
            for slot, extra in future_groups
        )
        total = sum(len(g[1]) for g in groups)
        self.metrics.count_batch_sig_verifications.add(total)
        if cm is not None:
            cm.count_verify_launches.add(1)
            cm.cross_slot_verify_batch.observe(total)
        if self._tracer.enabled:
            self._tracer.instant(
                "view", "verify.launch", size=total, slots=len(groups)
            )
        all_results = multi(groups)
        for (slot, extra), slot_results in zip(future_groups, all_results[1:]):
            for commit, result in zip(extra, slot_results):
                if result is None:
                    slot.rejected.add(commit.signature.id)
                else:
                    slot.valid_commit_sigs[commit.signature.id] = commit.signature
        return all_results[0]

    # --- sequence pipelining (view.go:851-894) -----------------------------

    def _start_next_seq(self) -> None:
        self.proposal_sequence += 1
        self.decisions_in_view += 1
        self.metrics.proposal_sequence.set(self.proposal_sequence)
        self.metrics.decisions_in_view.set(self.decisions_in_view)
        self.phase = Phase.COMMITTED
        self.metrics.phase.set(int(self.phase))
        self.in_flight_proposal = None
        self.in_flight_requests = ()
        self.my_commit_signature = None

        self._prev_prepare_sent = self._curr_prepare_sent
        self._prev_commit_sent = self._curr_commit_sent
        self._curr_prepare_sent = None
        self._curr_commit_sent = None

        self._pending_pre_prepare = self._next_pre_prepare
        self._next_pre_prepare = None
        self._prepares = self._next_prepares
        self._next_prepares = {}
        self._commits = self._next_commits
        self._next_commits = {}
        self._valid_commit_sigs = {}
        self._rejected_commit_senders = set()

        kick = False
        if self.effective_depth > 1:
            kick = self._promote_future_slot()

        # Continue with any buffered next-sequence traffic on a fresh stack.
        if (
            kick
            or self._pending_pre_prepare is not None
            or self._prepares
            or self._commits
        ):
            self._sched.post(self._advance, name=f"view-{self.number}-advance")

    def _promote_future_slot(self) -> bool:
        """Fold the future slot at the (just advanced) oldest sequence into
        the legacy current-slot fields.  This is the in-order commit gate:
        only here — strictly after every lower sequence decided, and on the
        scheduler event AFTER the prior decision was delivered — does a
        pipelined slot become eligible to sign and persist a Commit.
        Returns whether _advance should be (re)posted."""
        slot = self._future.pop(self.proposal_sequence, None)
        kick = False
        if slot is not None:
            if slot.processed:
                # Pre-prepare/prepare already ran in the future slot: seed
                # the current-slot state directly and let _advance drive
                # PROPOSED -> PREPARED -> decide on the collected votes.
                self.in_flight_proposal = slot.proposal
                self.in_flight_requests = slot.requests
                self.metrics.count_txs_in_batch.set(len(slot.requests))
                self._begin_pre_prepare = slot.begin or self._sched.now()
                self.phase = Phase.PROPOSED
                self.metrics.phase.set(int(self.phase))
                self._curr_prepare_sent = slot.prepare_sent
                self._valid_commit_sigs = slot.valid_commit_sigs
                self._rejected_commit_senders = slot.rejected
                kick = True
            elif slot.pre_prepare is not None:
                self._pending_pre_prepare = slot.pre_prepare
            self._prepares = slot.prepares
            self._commits = slot.commits
        # The window slid: the previously buffer-only edge slot may now be
        # inside processing range with a parked pre-prepare.
        edge = self.proposal_sequence + self.effective_depth - 1
        edge_slot = self._future.get(edge)
        if (
            edge_slot is not None
            and edge_slot.pre_prepare is not None
            and not edge_slot.processed
        ):
            self._process_future_slot(edge, edge_slot)
        self._update_inflight_depth()
        return kick

    # --- verification (view.go:553-716) ------------------------------------

    def _verify_proposal(
        self,
        proposal: Proposal,
        prev_commits: Sequence[Signature],
        *,
        expected_seq: Optional[int] = None,
        expected_decisions: Optional[int] = None,
    ) -> Sequence[RequestInfo]:
        """Verify a proposal against this view.  ``expected_seq`` /
        ``expected_decisions`` default to the oldest slot's position; future
        slots pass their own (the decisions offset is seq-relative: both
        counters advance together on every decide)."""
        if expected_seq is None:
            expected_seq = self.proposal_sequence
        if expected_decisions is None:
            expected_decisions = self.decisions_in_view
        # The pre-prepare carries two signature waves: the proposal's
        # request signatures and the previous decision's commit-signature
        # quorum.  The previous cert only applies when no reconfiguration
        # happened in between (reference view.go:606-647 skips otherwise);
        # routing both waves through one port call lets verifiers that
        # share an engine fuse them into a single launch.  A request
        # failure still raises here, before any cert result is consumed.
        prev_proposal, _ = self._checkpoint.get()
        expected_vseq = self._verifier.verification_sequence()
        certs_apply = bool(prev_commits) and (
            prev_proposal.verification_sequence == expected_vseq
        )
        requests, cert_results = self._verifier.verify_proposal_and_prev_commits(
            proposal, prev_commits if certs_apply else (), prev_proposal
        )
        if certs_apply and isinstance(prev_commits, QuorumCert):
            # Follower-side accounting of the leader's compact cert: one
            # aggregate-verify launch, and the cert's wire footprint.
            cm = self._consensus_metrics
            if cm is not None:
                cm.cert_aggregate_launches.add(1)
                cm.cert_bytes_per_cert.observe(encoded_cert_size(prev_commits))

        md = decode_view_metadata(proposal.metadata)
        if md.view_id != self.number:
            raise ValueError(f"metadata view {md.view_id} != {self.number}")
        if md.latest_sequence != expected_seq:
            raise ValueError(
                f"metadata seq {md.latest_sequence} != {expected_seq}"
            )
        if md.decisions_in_view != expected_decisions:
            raise ValueError(
                f"metadata decisions-in-view {md.decisions_in_view} != {expected_decisions}"
            )
        if proposal.verification_sequence != expected_vseq:
            raise ValueError(
                f"verification sequence {proposal.verification_sequence} != {expected_vseq}"
            )

        prepare_acks = (
            self._decode_prev_commit_acks(prev_commits, cert_results)
            if certs_apply
            else {}
        )
        self._verify_blacklist(prev_commits, expected_vseq, md, prepare_acks)

        # The metadata must commit to the exact previous-signature set.
        if self.decisions_per_leader > 0:
            if commit_signatures_digest(prev_commits) != md.prev_commit_signature_digest:
                raise ValueError("prev commit signatures mismatch metadata digest")
        return requests

    def _verify_prev_commit_signatures(
        self, prev_commits: Sequence[Signature], curr_vseq: int
    ) -> dict[int, PreparesFrom]:
        """Verify the leader-carried previous-decision signatures *as a
        batch* and decode each one's prepare-acknowledgement vouch list.

        Parity: reference view.go:606-647 (sequential loop there)."""
        prev_proposal, _ = self._checkpoint.get()
        if prev_proposal.verification_sequence != curr_vseq:
            # Reconfiguration happened in between: signatures were made under
            # another config — skip (the reference does the same).
            return {}
        if not prev_commits:
            return {}
        results = self._verifier.verify_consenter_sigs_batch(
            prev_commits, prev_proposal
        )
        return self._decode_prev_commit_acks(prev_commits, results)

    @staticmethod
    def _decode_prev_commit_acks(
        prev_commits: Sequence[Signature], results: Sequence[Optional[bytes]]
    ) -> dict[int, PreparesFrom]:
        """Turn a cert wave's verdicts into the per-signer prepare-ack map,
        raising on the first invalid signature or malformed vouch payload."""
        acks: dict[int, PreparesFrom] = {}
        for sig, aux in zip(prev_commits, results):
            if aux is None:
                raise ValueError(f"invalid prev commit signature from {sig.id}")
            try:
                acks[sig.id] = decode_prepares_from(aux) if aux else PreparesFrom()
            except Exception as e:
                raise ValueError(f"bad prepare-ack payload from {sig.id}: {e}") from e
        return acks

    def _verify_blacklist(
        self,
        prev_commits: Sequence[Signature],
        curr_vseq: int,
        md: ViewMetadata,
        prepare_acks: dict[int, PreparesFrom],
    ) -> None:
        """Follower-side re-derivation of the leader's blacklist update.

        Parity: reference view.go:649-716."""
        if self.decisions_per_leader == 0:
            if md.black_list:
                raise ValueError(
                    f"rotation inactive but blacklist is {list(md.black_list)}"
                )
            return

        prev_proposal, my_last_sigs = self._checkpoint.get()
        prev_md = self._decode_prev_metadata(prev_proposal)

        if prev_proposal.verification_sequence != curr_vseq:
            if tuple(prev_md.black_list) != tuple(md.black_list):
                raise ValueError("blacklist changed during reconfiguration")
            return
        if self._membership_notifier is not None and self._membership_notifier.membership_change():
            if tuple(prev_md.black_list) != tuple(md.black_list):
                raise ValueError("blacklist changed during membership change")
            return

        if self._blacklisting_supported(my_last_sigs) and len(prev_commits) < len(
            my_last_sigs
        ):
            raise ValueError(
                f"only {len(prev_commits)} of {len(my_last_sigs)} previous commits included"
            )

        expected = compute_blacklist_update(
            prev_view=prev_md.view_id,
            prev_seq=prev_md.latest_sequence,
            prev_decisions_in_view=prev_md.decisions_in_view,
            prev_blacklist=list(prev_md.black_list),
            current_view=self.number,
            current_leader=self.leader_id,
            n=self.n,
            f=self.f,
            nodes=self.nodes,
            leader_rotation=self.decisions_per_leader > 0,
            decisions_per_leader=self.decisions_per_leader,
            prepares_from={i: list(pf.ids) for i, pf in prepare_acks.items()},
        )
        if tuple(md.black_list) != tuple(expected):
            raise ValueError(
                f"proposed blacklist {list(md.black_list)} != expected {expected}"
            )

    def _decode_prev_metadata(self, prev_proposal: Proposal) -> ViewMetadata:
        if not prev_proposal.metadata:
            return ViewMetadata()
        return decode_view_metadata(prev_proposal.metadata)

    def _blacklisting_supported(self, my_last_sigs: Sequence[Signature]) -> bool:
        """f+1 of the previous commit signatures carrying auxiliary data is
        the rolling-upgrade witness that blacklisting is active.

        Parity: reference view.go:1061-1085."""
        if self._blacklist_supported:
            return True
        count = sum(
            1 for sig in my_last_sigs if self._verifier.auxiliary_data(sig.msg)
        )
        if count > self.f:
            self._blacklist_supported = True
        return self._blacklist_supported

    # --- leader metadata (view.go:896-989) ---------------------------------

    def get_metadata(self) -> bytes:
        """The ViewMetadata the leader stamps into its next proposal: current
        position, updated blacklist, and the binding digest over the previous
        commit signatures."""
        prev_proposal, prev_sigs = self._checkpoint.get()
        prev_md = self._decode_prev_metadata(prev_proposal)
        # Rotation off clears any inherited blacklist (a downgraded cluster
        # may still carry entries from its rotation era; followers reject
        # rotation-inactive proposals with a non-empty blacklist).
        # Parity: reference view.go:1019-1023.
        black_list = tuple(prev_md.black_list) if self.decisions_per_leader > 0 else ()

        vseq = self._verifier.verification_sequence()
        membership_change = (
            self._membership_notifier is not None
            and self._membership_notifier.membership_change()
        )
        if (
            prev_proposal.verification_sequence == vseq
            and not membership_change
            and self.decisions_per_leader > 0
        ):
            acks: dict[int, list[int]] = {}
            for sig in prev_sigs:
                aux = self._verifier.auxiliary_data(sig.msg)
                if aux:
                    try:
                        acks[sig.id] = list(decode_prepares_from(aux).ids)
                    except Exception:
                        logger.warning("undecodable prepare-acks from %d", sig.id)
            black_list = tuple(
                compute_blacklist_update(
                    prev_view=prev_md.view_id,
                    prev_seq=prev_md.latest_sequence,
                    prev_decisions_in_view=prev_md.decisions_in_view,
                    prev_blacklist=list(prev_md.black_list),
                    current_view=self.number,
                    current_leader=self.leader_id,
                    n=self.n,
                    f=self.f,
                    nodes=self.nodes,
                    leader_rotation=True,
                    decisions_per_leader=self.decisions_per_leader,
                    prepares_from=acks,
                )
            )

        prev_digest = (
            commit_signatures_digest(prev_sigs)
            if self.decisions_per_leader > 0
            else b""
        )
        if self.effective_depth > 1:
            # Pipelined: stamp the slot this proposal will actually occupy.
            # The decisions offset is seq-relative (both counters advance
            # together on every decide), so followers verifying the future
            # slot recompute the same number.
            target = self.next_propose_seq
            md = ViewMetadata(
                view_id=self.number,
                latest_sequence=target,
                decisions_in_view=self.decisions_in_view
                + (target - self.proposal_sequence),
                black_list=black_list,
                prev_commit_signature_digest=prev_digest,
            )
            return encode_view_metadata(md)
        md = ViewMetadata(
            view_id=self.number,
            latest_sequence=self.proposal_sequence,
            decisions_in_view=self.decisions_in_view,
            black_list=black_list,
            prev_commit_signature_digest=prev_digest,
        )
        return encode_view_metadata(md)

    # --- stragglers + censorship (view.go:718-818) --------------------------

    def _handle_prev_seq_message(self, sender: int, msg: ConsensusMessage) -> None:
        if isinstance(msg, PrePrepare):
            return
        if isinstance(msg, Prepare):
            if msg.assist:
                return
            if self._prev_prepare_sent is not None:
                self._comm.send(sender, self._prev_prepare_sent)
        elif isinstance(msg, Commit):
            if msg.assist:
                return
            if self._prev_commit_sent is not None:
                self._comm.send(sender, self._prev_commit_sent)

    def _discover_if_sync_needed(self, sender: int, msg: ConsensusMessage) -> None:
        """f+1 distinct nodes voting to commit a (view, seq) ahead of ours
        means we missed a proposal — trigger a sync."""
        if not isinstance(msg, Commit):
            return
        self._last_voted_proposal_by_id[sender] = msg
        threshold = self.f + 1
        if len(self._last_voted_proposal_by_id) < threshold:
            return
        counts: dict[tuple[str, int, int], int] = {}
        for vote in self._last_voted_proposal_by_id.values():
            key = (vote.digest, vote.view, vote.seq)
            counts[key] = counts.get(key, 0) + 1
        for (digest, view, seq), count in counts.items():
            if count < threshold:
                continue
            if view < self.number:
                continue
            if seq <= self.proposal_sequence and view == self.number:
                continue
            logger.warning(
                "%d: %d votes for (view=%d, seq=%d) vs our (view=%d, seq=%d) — syncing",
                self.self_id, count, view, seq, self.number, self.proposal_sequence,
            )
            self.abort()
            self._sync.sync()
            return


__all__ = [
    "View",
    "Phase",
    "Decider",
    "FailureDetector",
    "SyncRequester",
    "ViewComm",
    "ViewState",
    "CheckpointReader",
]
