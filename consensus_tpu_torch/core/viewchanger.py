"""ViewChanger: the BFT view-change protocol.

Parity: reference internal/bft/viewchanger.go (1364 LoC).  Flow:

1. A complaint broadcasts ``ViewChange{next_view}``; replicas join at f+1
   (with ``speed_up_view_change``) or quorum−1 votes, persist a ViewChange
   record, abort the current view, and send ``SignedViewData`` — their last
   decision + its signature quorum + any prepared in-flight proposal — to
   the next leader (viewchanger.go:364-431).
2. The new leader validates each ViewData (``checkLastDecision``: the sender
   may be one decision ahead, in which case the leader *delivers* that
   decision itself), collects a quorum, runs ``check_in_flight`` (condition
   A: an in-flight proposal f+1 saw prepared and a quorum doesn't contradict
   → must re-commit it; condition B: a quorum says no in-flight → safe to
   skip), then broadcasts ``NewView`` (viewchanger.go:501-785).
3. Followers re-validate everything the leader claimed, possibly delivering
   one decision or syncing, persist a NewView record, and install the view
   via ``controller.view_changed`` (viewchanger.go:932-1168).
4. If an in-flight proposal must be re-committed, an **embedded View** is
   started directly in PREPARED phase with our own commit signature, with
   ourselves as leader, so the cluster re-runs the commit round for it
   (viewchanger.go:1187-1307).  The reference blocks its goroutine waiting
   for that view; here the pending transition is stashed and completed from
   the embedded view's ``decide`` callback.

Liveness: a resend timer re-broadcasts our ViewChange, and a view-change
timeout with exponential backoff syncs + escalates to the next view.

Signature-heavy spots (``validate_last_decision`` is quorum × consenter-sig,
per ViewData, per NewView) run through ``verify_consenter_sigs_batch`` — on
the TPU verifier an entire NewView validates in a few kernel launches.

The PyTorch port's copy of ``consensus_tpu/core/viewchanger.py``, its imports renamed.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Protocol, Sequence

from consensus_tpu_torch.api.deps import Signer, Verifier
from consensus_tpu_torch.core.state import (
    InFlightData,
    PersistedState,
    restore_requests_best_effort,
)
from consensus_tpu_torch.core.view import Phase, View
from consensus_tpu_torch.metrics import MetricsViewChange, NoopProvider
from consensus_tpu_torch.runtime.scheduler import Scheduler, TimerHandle
from consensus_tpu_torch.types import (
    Checkpoint,
    Proposal,
    QuorumCert,
    RequestInfo,
    Signature,
    as_cert,
)
from consensus_tpu_torch.utils.leader import get_leader_id
from consensus_tpu_torch.utils.quorum import compute_quorum
from consensus_tpu_torch.wire import (
    Commit,
    ConsensusMessage,
    NewView,
    PrePrepare,
    Prepare,
    ProposedRecord,
    SavedCommit,
    SavedNewView,
    SavedViewChange,
    SignedViewData,
    ViewChange,
    ViewData,
    ViewMetadata,
    decode_view_data,
    decode_view_metadata,
    encode_view_data,
)

logger = logging.getLogger("consensus_tpu_torch.viewchanger")

#: Ceiling for the view-change timeout backoff factor: rounds lengthen
#: T, 2T, ... up to this multiple and stay there.
_BACKOFF_CAP = 8


class ControllerPort(Protocol):
    """What the view changer needs from the controller."""

    def abort_view(self, view: int) -> None: ...

    def view_changed(self, new_view_number: int, new_proposal_sequence: int) -> None: ...

    def sync(self) -> None: ...

    def deliver(self, proposal: Proposal, signatures: Sequence[Signature]): ...

    def maybe_prune_revoked_requests(self) -> None: ...

    def broadcast(self, msg: ConsensusMessage) -> None: ...

    def send(self, target_id: int, msg: ConsensusMessage) -> None: ...


class RequestsTimer(Protocol):
    def stop_timers(self) -> None: ...

    def restart_timers(self) -> None: ...

    def remove_request(self, info: RequestInfo) -> bool: ...

    def remove_requests(self, infos) -> int: ...


def validate_last_decision(
    vd: ViewData, quorum: int, verifier: Verifier
) -> Optional[int]:
    """Validate a ViewData's last-decision proof; returns its sequence.

    Raises on failure.  Parity: reference viewchanger.go:681-727
    (ValidateLastDecision) — the quorum of consenter signatures is verified
    as one batch instead of a loop."""
    if vd.last_decision is None:
        raise ValueError("last decision is not set")
    if not vd.last_decision.metadata:
        return 0  # genesis: nothing to validate
    md = decode_view_metadata(vd.last_decision.metadata)
    if md.view_id >= vd.next_view:
        raise ValueError(
            f"last decision view {md.view_id} >= requested next view {vd.next_view}"
        )
    if isinstance(vd.last_decision_signatures, QuorumCert):
        # Half-aggregated proof: signer uniqueness is structural (one R per
        # signer id slot) — check count, then verify the whole cert in one
        # aggregate launch.  A verifier without aggregation support returns
        # None and the ViewData is rejected, same as an invalid signature.
        cert = vd.last_decision_signatures
        if len(set(cert.signer_ids)) < quorum:
            raise ValueError(
                f"only {len(set(cert.signer_ids))} last-decision cert signers"
            )
        vac = getattr(verifier, "verify_aggregate_cert", None)
        aux = vac(cert, vd.last_decision) if vac is not None else None
        if aux is None:
            raise ValueError("invalid last-decision quorum cert")
        return md.latest_sequence
    # Dedup by signer, then batch-verify.
    seen: set[int] = set()
    unique: list[Signature] = []
    for sig in vd.last_decision_signatures:
        if sig.id in seen:
            continue
        seen.add(sig.id)
        unique.append(sig)
    if len(unique) < quorum:
        raise ValueError(f"only {len(unique)} last-decision signatures")
    results = verifier.verify_consenter_sigs_batch(unique, vd.last_decision)
    valid = sum(1 for r in results if r is not None)
    if valid < len(unique):
        raise ValueError("invalid last-decision signature")
    return md.latest_sequence


def validate_in_flight(in_flight: Optional[Proposal], last_sequence: int) -> None:
    """Parity: reference viewchanger.go:760-777 (ValidateInFlight)."""
    if in_flight is None:
        return
    if not in_flight.metadata:
        raise ValueError("in-flight proposal metadata is empty")
    md = decode_view_metadata(in_flight.metadata)
    if md.latest_sequence != last_sequence + 1:
        raise ValueError(
            f"in-flight seq {md.latest_sequence} != last decision {last_sequence} + 1"
        )


def check_in_flight(
    messages: Sequence[ViewData], f: int, quorum: int
) -> tuple[bool, bool, Optional[Proposal]]:
    """The agreement rule for a possibly-committed in-flight proposal.

    Returns (ok, no_in_flight, proposal).  Parity: reference
    viewchanger.go:815-909 (CheckInFlight), conditions:
    A2 — some proposal at the expected sequence was seen prepared by ≥ f+1;
    A1 — ≥ quorum don't contradict it (no *different* prepared proposal);
    B  — ≥ quorum report no prepared in-flight at the expected sequence.

    One deliberate difference from the reference's A1: an UNPREPARED
    attestation of a *different* proposal counts as no-argument.  The
    reference counts it as a contradiction for A while counting the very
    same entry toward "no prepared in-flight" for B — incoherent, and the
    A-side reading wedges the cluster forever when mixed-view crash
    restores leave attestations split (seed-1268 chaos hunt: P@v10
    prepared on two replicas, later views' unprepared proposals on the
    other two — every change unsatisfiable).  An unprepared attestation
    means that replica never commit-signed anything at the sequence, so
    no decision it participated in is endangered by adopting the prepared
    candidate; only a prepared certificate can argue (classic PBFT's
    max-view-prepared rule has the same character).

    The consolidated quorum-intersection argument for this deviation —
    why the relaxation is safe with f byzantine replicas, and why the
    residual sub-f+1 split below stays unresolvable — lives in
    docs/inflight-safety.md (the standalone writeup, with the seed-1268
    wedge walked number by number) and in SAFETY.md at the repository
    root."""
    expected_seq = (
        max(
            (
                decode_view_metadata(vd.last_decision.metadata).latest_sequence
                for vd in messages
                if vd.last_decision is not None and vd.last_decision.metadata
            ),
            default=0,
        )
        + 1
    )
    no_in_flight_count = 0
    entries: list[tuple[Optional[Proposal], Optional[ViewMetadata], bool]] = []
    possible: list[Proposal] = []
    for vd in messages:
        p = vd.in_flight_proposal
        if p is None:
            no_in_flight_count += 1
            entries.append((None, None, False))
            continue
        if not p.metadata:
            raise ValueError("in-flight proposal without metadata")
        md = decode_view_metadata(p.metadata)
        entries.append((p, md, vd.in_flight_prepared))
        if md.latest_sequence != expected_seq or not vd.in_flight_prepared:
            no_in_flight_count += 1
            continue
        if p not in possible:
            possible.append(p)

    for candidate in possible:
        preprepared = 0
        no_argument = 0
        for p, md, prepared in entries:
            if p is None or md is None or md.latest_sequence != expected_seq:
                no_argument += 1
                continue
            if p == candidate:
                no_argument += 1
                preprepared += 1
            elif not prepared:
                # A different-but-UNPREPARED attestation asserts "nothing
                # prepared here" (condition B already counts it that way);
                # it carries no commit signature and so cannot argue.  This
                # relaxation only ever helps ADOPT an f+1-corroborated
                # candidate — the safe direction — and can never flip
                # condition B, so a lone byzantine claim gains nothing.
                no_argument += 1
        if preprepared >= f + 1 and no_argument >= quorum:
            return True, False, candidate  # condition A

    if no_in_flight_count >= quorum:
        return True, True, None  # condition B

    # KNOWN UNRESOLVABLE SPLIT (kept deliberately, matching the reference):
    # sub-f+1 prepared attestations of different proposals (e.g. P@v10 on
    # one replica, P'@v82 on another, rest silent) satisfy neither A nor B
    # and stall every change until sync or new evidence.  A "supersession"
    # rule discarding the lower-view attestation is TEMPTING and sound
    # crash-only, but unsound with f byzantine: attestations are unproven
    # claims, so a commit-quorum member can deny its signature and
    # fabricate a higher-view claim, flipping a committed sequence into a
    # fresh proposal — a fork.  Without carried prepare CERTIFICATES
    # (which this protocol family, like the reference, does not ship in
    # ViewData) the stall is the safe outcome.
    return False, False, None


class _NextViews:
    """(view -> voters) bookkeeping for laggard help.

    Parity: reference internal/bft/util.go:145-163 (nextViews), with one
    liveness-critical difference and one runtime-model adaptation:

    * The help gate RE-FIRES like the reference's ``sendRecv`` (true
      whenever the examined vote is the sender's latest) — an earlier
      once-per-(view, sender) guard wedged a healed cluster forever: the
      single help broadcast happened while the chaos was still dropping
      messages, and nothing ever re-fired (seed-1234 targeted-chaos hunt:
      three replicas collecting for views 19/22/23, no two alike).
    * Re-fires are rate-limited per (view, sender).  Helps are broadcasts
      that other eligible helpers may respond to in turn; the reference
      dampens that amplification with its bounded incoming-message queue
      (InMsgQSize drops excess), which this event-driven runtime does not
      have — the time gate is the equivalent backpressure, sized by the
      caller to the vote-resend cadence so a post-heal wedge still
      resolves within one resend period."""

    def __init__(self) -> None:
        self._votes: dict[int, set[int]] = {}
        self._latest: dict[int, int] = {}
        self._last_help: dict[tuple[int, int], float] = {}

    def register(self, view: int, sender: int) -> None:
        self._votes.setdefault(view, set()).add(sender)
        if view > self._latest.get(sender, -1):
            self._latest[sender] = view

    def send_recv(self, view: int, sender: int, now: float,
                  min_interval: float) -> bool:
        """True while ``view`` is the newest vote seen from ``sender`` and
        this (view, sender) hasn't been helped within ``min_interval``."""
        if self._latest.get(sender) != view:
            return False
        key = (view, sender)
        last = self._last_help.get(key)
        if last is not None and now - last < min_interval:
            return False
        self._last_help[key] = now
        return True

    def views_above(self, view: int) -> list[int]:
        """Views > ``view`` with at least one registered voter, ascending."""
        return sorted(v for v, senders in self._votes.items() if v > view and senders)

    def voters_of(self, view: int) -> set[int]:
        return set(self._votes.get(view, ()))

    def clear(self) -> None:
        self._votes.clear()
        self._latest.clear()
        self._last_help.clear()


class ViewChanger:
    def __init__(
        self,
        *,
        scheduler: Scheduler,
        self_id: int,
        n: int,
        nodes: Sequence[int],
        comm,
        signer: Signer,
        verifier: Verifier,
        checkpoint: Checkpoint,
        in_flight: InFlightData,
        state: PersistedState,
        controller: ControllerPort,
        requests_timer: RequestsTimer,
        synchronizer,
        application,
        speed_up_view_change: bool = False,
        resend_timeout: float = 5.0,
        view_change_timeout: float = 20.0,
        leader_rotation: bool = True,
        decisions_per_leader: int = 3,
        tick_period: float = 1.0,
        on_reconfig: Optional[Callable] = None,
        metrics: Optional[MetricsViewChange] = None,
        cert_mode: str = "full",
    ) -> None:
        self._sched = scheduler
        self.self_id = self_id
        self.n = n
        self.nodes = tuple(nodes)
        self.quorum, self.f = compute_quorum(n)
        self._comm = comm
        self._signer = signer
        self._verifier = verifier
        self._checkpoint = checkpoint
        self._in_flight = in_flight
        self._state = state
        self._controller = controller
        self._requests_timer = requests_timer
        self._synchronizer = synchronizer
        self._application = application
        self._speed_up = speed_up_view_change
        self._resend_timeout = resend_timeout
        self._vc_timeout = view_change_timeout
        self._leader_rotation = leader_rotation
        self._decisions_per_leader = decisions_per_leader
        self._tick_period = tick_period
        self._on_reconfig = on_reconfig
        self.cert_mode = cert_mode

        self.curr_view = 0
        #: Last view actually installed (realView in the reference).
        self.real_view = 0
        self.next_view = 0
        self._nvs = _NextViews()
        self._view_change_votes: dict[int, ViewChange] = {}
        self._view_data_votes: dict[int, SignedViewData] = {}
        self._committed_during_view_change: Optional[ViewMetadata] = None

        self._check_timeout = False
        self._start_change_time = 0.0
        self._last_resend = 0.0
        self._backoff_factor = 1

        self._in_flight_view: Optional[View] = None
        self._pending_transition = False
        self._pending_join_target: Optional[int] = None
        #: Distinct senders whose ViewData we rejected as too far
        #: ahead this collection round — f+1 of them prove WE are the
        #: behind party (see _check_last_decision).
        self._far_ahead_senders: set[int] = set()

        self._timer: Optional[TimerHandle] = None
        self._stopped = True
        self.metrics = metrics or MetricsViewChange(NoopProvider())

    # ----------------------------------------------------------- lifecycle

    def start(self, view: int, *, restore_view_change: Optional[ViewChange] = None) -> None:
        """Parity: reference viewchanger.go Start + the Restore channel."""
        self._stopped = False
        self.curr_view = view
        self.real_view = view
        self.next_view = view
        self._update_view_gauges()
        self._last_resend = self._sched.now()
        self._schedule_tick()
        if restore_view_change is not None:
            # We voted to leave this view before crashing: rejoin it.
            self._sched.post(
                lambda: self._process_view_change_votes(restore=True),
                name="viewchange-restore",
            )

    def stop(self) -> None:
        self._stopped = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if self._in_flight_view is not None:
            self._in_flight_view.abort()
            self._in_flight_view = None

    def _schedule_tick(self) -> None:
        if self._stopped:
            return
        self._timer = self._sched.call_later(
            self._tick_period, self._tick, name="viewchanger-tick"
        )

    def _tick(self) -> None:
        if self._stopped:
            return
        now = self._sched.now()
        self._check_if_resend(now)
        self._check_if_timeout(now)
        self._schedule_tick()

    def _check_if_resend(self, now: float) -> None:
        """Parity: reference viewchanger.go:235-252."""
        if now < self._last_resend + self._resend_timeout:
            return
        if self._check_timeout:
            self._comm.broadcast(ViewChange(next_view=self.next_view))
            self._last_resend = now

    def _check_if_timeout(self, now: float) -> bool:
        """Parity: reference viewchanger.go:254-270."""
        if not self._check_timeout:
            return False
        if now < self._start_change_time + self._vc_timeout * self._backoff_factor:
            return False
        logger.warning(
            "%d: view change to %d timed out (backoff %d)",
            self.self_id, self.next_view, self._backoff_factor,
        )
        self._check_timeout = False
        # Grow the round length (anti-thrash) but CAP it: an uncapped
        # factor accumulated during a long fault storm turns into a
        # minutes-long recovery stall after the network heals (a healed
        # cluster should converge within a few bounded rounds).
        self._backoff_factor = min(self._backoff_factor + 1, _BACKOFF_CAP)
        # Start each round from a FRESH view of peers' votes: corrupt or
        # stale next-view registrations otherwise poison the laggard-help
        # gate forever (a phantom high "latest vote" recorded during a
        # fault storm makes send_recv reject the sender's genuine resends
        # for eternity — the seed-171 corruption-chaos wedge).  Genuine
        # votes re-register within one resend interval.
        self._nvs.clear()
        if self._in_flight_view is not None:
            # The embedded in-flight view failed to commit in time.
            self._abandon_in_flight_view()
        self._synchronizer.sync()
        self.start_view_change(self.curr_view, stop_view=False)
        # The new timeout ROUND starts now: start_view_change's
        # already-changing early path re-arms the flag but keeps the old
        # _start_change_time, so without this reset every subsequent tick
        # "times out" again instantly and the backoff factor runs away
        # (observed at 150+ during a long corruption storm — a 1,500 s
        # recovery delay after the network healed).  The reference has the
        # same latent runaway (viewchanger.go:370 re-arms without touching
        # startViewChangeTime).
        self._start_change_time = self._sched.now()
        return True

    # ------------------------------------------------------------ identity

    def _update_view_gauges(self) -> None:
        self.metrics.current_view.set(self.curr_view)
        self.metrics.next_view.set(self.next_view)
        self.metrics.real_view.set(self.real_view)

    def _get_leader(self) -> int:
        proposal, _ = self._checkpoint.get()
        blacklist: tuple[int, ...] = ()
        if proposal.metadata:
            blacklist = tuple(decode_view_metadata(proposal.metadata).black_list)
        return get_leader_id(
            self.curr_view,
            self.n,
            self.nodes,
            leader_rotation=self._leader_rotation,
            decisions_in_view=0,
            decisions_per_leader=self._decisions_per_leader,
            blacklist=blacklist,
        )

    def _extract_current_sequence(self) -> tuple[int, Proposal]:
        proposal, _ = self._checkpoint.get()
        if not proposal.metadata:
            return 0, proposal
        return decode_view_metadata(proposal.metadata).latest_sequence, proposal

    # -------------------------------------------------------------- ingress

    def start_view_change(self, view: int, stop_view: bool) -> None:
        """A complaint arrived (pool cascade, heartbeat, bad proposal).

        Parity: reference viewchanger.go:356-391."""
        if self._stopped:
            return
        if view < self.curr_view:
            return
        if self.next_view == self.curr_view + 1:
            self._check_timeout = True  # already changing; keep the clock on
            return
        # ADVANCING to a new change: a live embedded in-flight view belongs
        # to the change being left behind and must not keep committing
        # concurrently with it (the reference's commitInFlightProposal
        # blocks the whole view changer and `defer Abort()`s the embedded
        # view on every exit, so it can never coexist with the next change
        # — viewchanger.go:1187,1287; an embedded view that survived here
        # delivered a stale decision AFTER the next view re-proposed the
        # same sequence: the seed-1144/1427 chaos-hunt fork).
        self._abandon_in_flight_view()
        self.next_view = self.curr_view + 1
        self._update_view_gauges()
        self._requests_timer.stop_timers()
        self._comm.broadcast(ViewChange(next_view=self.next_view))
        logger.info(
            "%d: started view change %d -> %d", self.self_id, self.curr_view, self.next_view
        )
        if stop_view:
            self._controller.abort_view(self.curr_view)
        self._start_change_time = self._sched.now()
        self._check_timeout = True

    def inform_new_view(self, view: int) -> None:
        """Sync discovered the cluster moved to ``view``.

        Parity: reference viewchanger.go:327-353."""
        if self._stopped or view < self.curr_view:
            return
        # Same rule as an advancing start_view_change: the embedded view
        # belongs to the change sync just moved us past.
        self._abandon_in_flight_view()
        self.curr_view = view
        self.real_view = view
        self.next_view = view
        self._update_view_gauges()
        self._nvs.clear()
        self._view_change_votes = {}
        self._view_data_votes = {}
        self._far_ahead_senders.clear()
        self._check_timeout = False
        self._backoff_factor = 1
        self._requests_timer.restart_timers()

    def handle_message(self, sender: int, msg: ConsensusMessage) -> None:
        """Parity: reference viewchanger.go:273-325 (processMsg)."""
        if self._stopped:
            return
        if isinstance(msg, ViewChange):
            self._handle_view_change(sender, msg)
        elif isinstance(msg, SignedViewData):
            self._handle_view_data(sender, msg)
        elif isinstance(msg, NewView):
            leader = self._get_leader()
            if sender != leader:
                logger.warning(
                    "%d: NewView from %d but expected leader %d",
                    self.self_id, sender, leader,
                )
                return
            self._process_new_view(msg)

    def handle_view_message(self, sender: int, msg: ConsensusMessage) -> None:
        """Feed 3-phase traffic to the embedded in-flight view.

        Parity: reference viewchanger.go:1348-1356."""
        if self._in_flight_view is not None:
            self._in_flight_view.handle_message(sender, msg)

    def _handle_view_change(self, sender: int, vc: ViewChange) -> None:
        self._nvs.register(vc.next_view, sender)
        if vc.next_view == self.curr_view + 1:
            if sender not in self._view_change_votes:
                self._view_change_votes[sender] = vc
            self._process_view_change_votes(restore=False)
            return
        if (
            self.next_view == self.curr_view + 1
            and self.real_view < vc.next_view < self.curr_view + 1
            and self._nvs.send_recv(
                vc.next_view, sender, self._sched.now(), self._resend_timeout
            )
        ):
            # Help lagging nodes converge on the earlier view change.
            self._comm.broadcast(ViewChange(next_view=vc.next_view))
            return
        if self._maybe_jump_ahead():
            return
        logger.debug(
            "%d: view change to %d from %d ignored (expecting %d)",
            self.self_id, vc.next_view, sender, self.curr_view + 1,
        )

    def _maybe_jump_ahead(self) -> bool:
        """PBFT laggard rule: f+1 distinct nodes voting for the SAME view
        beyond our next prove at least one honest replica wants that exact
        view — adopt the smallest such view, so diverged next-views
        re-converge instead of each replica escalating alone (a stall the
        randomized soak found: next-views 6/15/15/16 — view 15 carries the
        f+1 votes).  The threshold is per-view, not a union across views:
        f Byzantine votes for view X plus one honest vote for a different
        view Y must not drag us to X, a view with zero honest support
        (recovery from that relies solely on timeout escalation)."""
        target = None
        for view in self._nvs.views_above(self.next_view):
            voters = self._nvs.voters_of(view)
            voters.discard(self.self_id)
            if len(voters) >= self.f + 1:
                target = view
                break
        if target is None:
            return False
        logger.info(
            "%d: f+1 nodes vote for view %d beyond %d — jumping ahead",
            self.self_id, target, self.next_view,
        )
        # A live embedded in-flight view belongs to the abandoned change; a
        # late decide from it must not install the jumped-to view without a
        # NewView quorum (the timeout escalation path does the same).
        self._abandon_in_flight_view()
        self.curr_view = target - 1
        self.next_view = self.curr_view  # start_view_change bumps to target
        self._update_view_gauges()
        self._view_change_votes = {}  # all stale: they were for an older view+1
        self._view_data_votes = {}
        self._far_ahead_senders.clear()
        self.start_view_change(self.curr_view, stop_view=True)
        # Count any already-registered votes for the target view.
        for voter in self._nvs.voters_of(target):
            if voter != self.self_id:
                self._view_change_votes.setdefault(voter, ViewChange(next_view=target))
        self._process_view_change_votes(restore=False)
        return True

    def _process_view_change_votes(self, *, restore: bool) -> None:
        """Join + advance rules.  Parity: reference viewchanger.go:393-431.

        ``restore`` (crash recovery with a persisted ViewChange vote) joins
        unconditionally — it must re-arm the broadcast/timeout machinery just
        like a fresh join, or the replica stalls in the dead view."""
        votes = len(self._view_change_votes)
        if (votes == self.f + 1 and self._speed_up) or restore:
            self.start_view_change(self.curr_view, stop_view=True)
        if votes < self.quorum - 1 and not restore:
            return
        if not self._speed_up:
            self.start_view_change(self.curr_view, stop_view=True)
        # Snapshot the transition: under group commit the fsync window can
        # overlap state changes (inform_new_view, a jump, another quorum) —
        # the deferred continuation must no-op if it is no longer current,
        # and must not run twice for the same target.
        target = self.next_view
        prior_view = self.curr_view
        if self._pending_join_target == target and not restore:
            return
        self._pending_join_target = target

        def continue_after_durable() -> None:
            if self._pending_join_target == target:
                self._pending_join_target = None
            if self._stopped:
                return
            if self.curr_view != prior_view or self.next_view != target:
                return  # superseded while awaiting durability
            self._controller.abort_view(prior_view)
            # Installing the joined change: an embedded view still running
            # for the PREVIOUS change must not survive it (its late decide
            # would install this view without a NewView quorum) — covers
            # the path where start_view_change's already-changing guard
            # returned before its own abandon.
            self._abandon_in_flight_view()
            self.curr_view = target
            self._update_view_gauges()
            self._view_change_votes = {}
            self._view_data_votes = {}
            self._far_ahead_senders.clear()  # fresh evidence window per round
            svd = self._prepare_view_data()
            leader = self._get_leader()
            if leader == self.self_id:
                self._view_data_votes[self.self_id] = svd
                self._process_view_data_votes()
            else:
                self._comm.send(leader, svd)

        if restore:
            continue_after_durable()  # the vote is already in the WAL
        else:
            self._state.save(
                SavedViewChange(view_change=ViewChange(next_view=prior_view)),
                on_durable=continue_after_durable,
            )

    def _prepare_view_data(self) -> SignedViewData:
        """Parity: reference viewchanger.go:433-456."""
        last_decision, last_sigs = self._checkpoint.get()
        in_flight = self._get_in_flight(last_decision)
        vd = ViewData(
            next_view=self.curr_view,
            last_decision=last_decision,
            last_decision_signatures=as_cert(last_sigs),
            in_flight_proposal=in_flight,
            in_flight_prepared=self._in_flight.is_prepared(),
        )
        raw = encode_view_data(vd)
        return SignedViewData(
            raw_view_data=raw, signer=self.self_id, signature=self._signer.sign(raw)
        )

    def _get_in_flight(self, last_decision: Proposal) -> Optional[Proposal]:
        """Parity: reference viewchanger.go:458-499."""
        in_flight = self._in_flight.proposal()
        if in_flight is None:
            return None
        in_flight_md = decode_view_metadata(in_flight.metadata)
        if not last_decision.metadata:
            return in_flight  # first proposal after genesis
        last_md = decode_view_metadata(last_decision.metadata)
        if in_flight_md.latest_sequence == last_md.latest_sequence:
            return None  # already decided; not actually in flight
        if (
            in_flight_md.latest_sequence + 1 == last_md.latest_sequence
            and self._committed_during_view_change is not None
            and self._committed_during_view_change.latest_sequence
            == last_md.latest_sequence
        ):
            return None  # committed it during the view change itself
        return in_flight

    # ------------------------------------------- new-leader side (ViewData)

    def _handle_view_data(self, sender: int, svd: SignedViewData) -> None:
        if not self._validate_view_data(svd, sender):
            return
        if sender not in self._view_data_votes:
            self._view_data_votes[sender] = svd
        self._process_view_data_votes()

    def _validate_view_data(self, svd: SignedViewData, sender: int) -> bool:
        """Parity: reference viewchanger.go:501-533."""
        if self._get_leader() != self.self_id:
            logger.warning(
                "%d: got ViewData from %d but I am not the next leader",
                self.self_id, sender,
            )
            return False
        try:
            vd = decode_view_data(svd.raw_view_data)
        except Exception as e:
            logger.warning("%d: undecodable ViewData from %d: %s", self.self_id, sender, e)
            return False
        if vd.next_view != self.curr_view:
            logger.warning(
                "%d: ViewData for view %d from %d, but current is %d",
                self.self_id, vd.next_view, sender, self.curr_view,
            )
            return False
        ok, last_seq = self._check_last_decision(svd, vd, sender)
        if not ok:
            return False
        try:
            validate_in_flight(vd.in_flight_proposal, last_seq)
        except ValueError as e:
            logger.warning("%d: bad in-flight in ViewData from %d: %s", self.self_id, sender, e)
            return False
        return True

    def _check_last_decision(
        self, svd: SignedViewData, vd: ViewData, sender: int
    ) -> tuple[bool, int]:
        """Parity: reference viewchanger.go:535-666 — sender may be behind
        (reject), equal (compare decisions), or one ahead (validate quorum +
        deliver that decision ourselves)."""
        if vd.last_decision is None:
            return False, 0
        my_seq, my_last_decision = self._extract_current_sequence()

        def signature_valid() -> bool:
            if svd.signer != sender:
                return False
            try:
                self._verifier.verify_signature(
                    Signature(id=svd.signer, value=svd.signature, msg=svd.raw_view_data)
                )
                return True
            except Exception as e:
                logger.warning(
                    "%d: bad ViewData signature from %d: %s", self.self_id, sender, e
                )
                return False

        if not vd.last_decision.metadata:  # genesis
            if my_seq > 0:
                return False, 0
            return signature_valid(), 0

        last_md = decode_view_metadata(vd.last_decision.metadata)
        if last_md.view_id >= vd.next_view:
            return False, 0
        if last_md.latest_sequence > my_seq + 1:
            # Too far ahead to validate (might lack the config): reject the
            # vote, like the reference — ONE such sender might be lying.
            # But f+1 DISTINCT far-ahead senders contain an honest one, so
            # WE are provably behind: sync now.  The reference leaves this
            # to the view-change timeout's sync; that starves when every
            # vote-driven join resets the timeout clock faster than it can
            # fire (seed-1144 chaos livelock: the behind leader's ViewData
            # was rejected each cycle, CheckInFlight stayed unsatisfiable,
            # and the cluster churned view changes forever).
            self._far_ahead_senders.add(sender)
            if len(self._far_ahead_senders) >= self.f + 1:
                logger.warning(
                    "%d: %d senders report decisions far ahead of our seq "
                    "%d — we are behind; syncing",
                    self.self_id, len(self._far_ahead_senders), my_seq,
                )
                self._far_ahead_senders.clear()
                self._synchronizer.sync()
            return False, 0
        if last_md.latest_sequence < my_seq:
            return False, 0  # behind us; might lack config to validate
        if last_md.latest_sequence == my_seq:
            if not signature_valid():
                return False, 0
            if vd.last_decision != my_last_decision:
                logger.warning(
                    "%d: same-sequence last decisions differ (from %d)",
                    self.self_id, sender,
                )
                return False, 0
            return True, last_md.latest_sequence

        # Sender is exactly one decision ahead: validate and deliver it.
        try:
            validate_last_decision(vd, self.quorum, self._verifier)
        except ValueError as e:
            logger.warning(
                "%d: invalid last decision from %d: %s", self.self_id, sender, e
            )
            return False, 0
        self._deliver_decision(vd.last_decision, vd.last_decision_signatures)
        # my_seq just advanced: far-ahead evidence gathered against the old
        # sequence no longer proves anything — start fresh.
        self._far_ahead_senders.clear()
        self._committed_during_view_change = last_md
        if self._stopped:  # delivery carried a reconfig
            return False, 0
        if not signature_valid():
            return False, 0
        return True, last_md.latest_sequence

    def _process_view_data_votes(self) -> None:
        """Parity: reference viewchanger.go:747-785."""
        if len(self._view_data_votes) < self.quorum:
            return
        # Assemble the ACTUAL broadcast set first — a fresh own ViewData
        # (it may have changed since registration, e.g. a one-ahead decision
        # delivered in between) plus the other registered votes — and run
        # check_in_flight on exactly that set.  Followers recompute the check
        # on the broadcast contents, so checking anything else (like the
        # registered set with the stale own vote) could assemble a NewView
        # every follower rejects, wasting the round.
        my_msg = self._prepare_view_data()
        signed = [my_msg] + [
            svd for s, svd in self._view_data_votes.items() if s != self.self_id
        ]
        final_msgs = [decode_view_data(svd.raw_view_data) for svd in signed]
        ok, _, _ = check_in_flight(final_msgs, self.f, self.quorum)
        if not ok:
            logger.info("%d: in-flight check not yet satisfiable", self.self_id)
            return
        new_view = NewView(signed_view_data=tuple(signed))
        self._comm.broadcast(new_view)
        self._view_data_votes = {}
        self._process_new_view(new_view)  # leader installs it too

    # ------------------------------------------- follower side (NewView)

    def _process_new_view(self, msg: NewView) -> None:
        """Parity: reference viewchanger.go:1111-1168."""
        if self.next_view == self.curr_view + 1:
            # A NEWER change is already in progress: this NewView is for
            # the change we moved past.  Acting on it (worst case starting
            # an embedded in-flight view whose late decide would install
            # the newer view without its own NewView quorum) re-opens the
            # stale-decide hole — the reference cannot reach this state at
            # all because its view-changer loop blocks while a NewView is
            # being acted on.
            logger.info(
                "%d: ignoring NewView for view %d — already changing to %d",
                self.self_id, self.curr_view, self.next_view,
            )
            return
        while True:
            valid, called_sync, called_deliver = self._validate_new_view(msg)
            if not called_deliver:
                break
        if not valid:
            return
        if called_sync:
            return

        messages = []
        for svd in msg.signed_view_data:
            try:
                messages.append(decode_view_data(svd.raw_view_data))
            except Exception:
                return
        ok, no_in_flight, proposal = check_in_flight(messages, self.f, self.quorum)
        if not ok:
            logger.info("%d: NewView in-flight check failed", self.self_id)
            return
        if not no_in_flight:
            self._commit_in_flight(proposal)
            return  # transition completes from the embedded view's decide
        self._finish_new_view()

    def _validate_new_view(self, msg: NewView) -> tuple[bool, bool, bool]:
        """Parity: reference viewchanger.go:932-1096 (validateNewViewMsg).

        Returns (valid, called_sync, called_deliver)."""
        seen: set[int] = set()
        valid_count = 0
        my_seq, my_last_decision = self._extract_current_sequence()
        for svd in msg.signed_view_data:
            if svd.signer in seen:
                continue
            seen.add(svd.signer)
            try:
                vd = decode_view_data(svd.raw_view_data)
            except Exception:
                return False, False, False
            if vd.next_view != self.curr_view:
                logger.warning(
                    "%d: NewView contains ViewData for view %d, current is %d",
                    self.self_id, vd.next_view, self.curr_view,
                )
                return False, False, False
            if vd.last_decision is None:
                return False, False, False

            def svd_signature_valid() -> bool:
                try:
                    self._verifier.verify_signature(
                        Signature(
                            id=svd.signer, value=svd.signature, msg=svd.raw_view_data
                        )
                    )
                    return True
                except Exception:
                    return False

            if not vd.last_decision.metadata:  # genesis
                if my_seq == 0 and not svd_signature_valid():
                    return False, False, False
                try:
                    validate_in_flight(vd.in_flight_proposal, 0)
                except ValueError:
                    return False, False, False
                valid_count += 1
                continue

            last_md = decode_view_metadata(vd.last_decision.metadata)
            if last_md.view_id >= vd.next_view:
                return False, False, False
            if last_md.latest_sequence > my_seq + 1:
                self._synchronizer.sync()
                return True, True, False
            if last_md.latest_sequence < my_seq:
                try:
                    validate_in_flight(vd.in_flight_proposal, last_md.latest_sequence)
                except ValueError:
                    return False, False, False
                valid_count += 1
                continue
            if last_md.latest_sequence == my_seq:
                if not svd_signature_valid():
                    return False, False, False
                if vd.last_decision != my_last_decision:
                    return False, False, False
                try:
                    validate_in_flight(vd.in_flight_proposal, last_md.latest_sequence)
                except ValueError:
                    return False, False, False
                valid_count += 1
                continue

            # One ahead of us: validate + deliver, then re-walk the message.
            try:
                validate_last_decision(vd, self.quorum, self._verifier)
            except ValueError as e:
                logger.warning("%d: NewView last decision invalid: %s", self.self_id, e)
                return False, False, False
            self._deliver_decision(vd.last_decision, vd.last_decision_signatures)
            if self._stopped:
                return False, False, False
            if not svd_signature_valid():
                return False, False, False
            try:
                validate_in_flight(vd.in_flight_proposal, last_md.latest_sequence)
            except ValueError:
                return False, False, False
            return True, False, True

        if valid_count < self.quorum:
            logger.warning(
                "%d: NewView has only %d valid ViewData (quorum %d)",
                self.self_id, valid_count, self.quorum,
            )
            return False, False, False
        return True, False, False

    def _finish_new_view(self) -> None:
        """Install the new view (after any in-flight re-commit).

        Parity: reference viewchanger.go:1141-1168."""
        self._pending_transition = False
        my_seq, _ = self._extract_current_sequence()
        self._state.save(
            SavedNewView(
                view_metadata=ViewMetadata(
                    view_id=self.curr_view, latest_sequence=my_seq
                )
            )
        )
        if self._stopped:
            return
        self.real_view = self.curr_view
        self._update_view_gauges()
        self._nvs.clear()
        self._controller.view_changed(self.curr_view, my_seq + 1)
        self._requests_timer.restart_timers()
        self._check_timeout = False
        self._backoff_factor = 1
        logger.info("%d: installed view %d at seq %d", self.self_id, self.curr_view, my_seq + 1)

    def _deliver_decision(
        self, proposal: Proposal, signatures: Sequence[Signature]
    ) -> None:
        """Parity: reference viewchanger.go:1170-1185."""
        reconfig = self._application.deliver(proposal, signatures)
        if reconfig.in_latest_decision:
            self.stop()
            if self._on_reconfig is not None:
                self._on_reconfig(reconfig)
            return
        self._requests_timer.remove_requests(
            self._verifier.requests_from_proposal(proposal)
        )
        self._controller.maybe_prune_revoked_requests()

    # --------------------------------------- in-flight re-commit (embedded)

    def _commit_in_flight(self, proposal: Proposal) -> None:
        """Spin up a View already in PREPARED, seeded with our own commit
        signature and ourselves as leader, so the cluster re-commits the
        in-flight proposal.  Parity: reference viewchanger.go:1187-1307."""
        my_last_decision, _ = self._checkpoint.get()
        md = decode_view_metadata(proposal.metadata)
        if my_last_decision.metadata:
            last_md = decode_view_metadata(my_last_decision.metadata)
            if last_md.latest_sequence == md.latest_sequence:
                if my_last_decision != proposal:
                    logger.warning(
                        "%d: already decided seq %d differently than the in-flight",
                        self.self_id, md.latest_sequence,
                    )
                    return
                self._finish_new_view()  # already committed it
                return
            if last_md.latest_sequence != md.latest_sequence - 1:
                logger.error(
                    "%d: in-flight seq %d does not follow our last %d",
                    self.self_id, md.latest_sequence, last_md.latest_sequence,
                )
                return

        view = View(
            scheduler=self._sched,
            self_id=self.self_id,
            number=md.view_id,
            leader_id=self.self_id,  # no byzantine leader can trigger complaints
            proposal_sequence=md.latest_sequence,
            decisions_in_view=md.decisions_in_view,
            n=self.n,
            nodes=self.nodes,
            comm=self._comm,
            verifier=self._verifier,
            signer=self._signer,
            state=self._state,
            decider=_InFlightDecider(self),
            failure_detector=_InFlightFailureDetector(),
            sync_requester=_InFlightSync(self),
            checkpoint=self._checkpoint,
            decisions_per_leader=self._decisions_per_leader if self._leader_rotation else 0,
            cert_mode=self.cert_mode,
        )
        view.phase = Phase.PREPARED
        view.in_flight_proposal = proposal
        # Best-effort, shared with the WAL restore paths: an application
        # exception here must not stall the view change (the requests only
        # feed pool cleanup at decide time).
        restore_requests_best_effort(view, proposal)
        view.my_commit_signature = self._signer.sign_proposal(proposal, b"")
        commit = Commit(
            view=view.number,
            seq=view.proposal_sequence,
            digest=proposal.digest(),
            signature=view.my_commit_signature,
            assist=True,
        )
        view._curr_commit_sent = commit
        self._in_flight_view = view
        self._pending_transition = True
        # PERSIST THE ENDORSEMENT BEFORE THE SIGNATURE LEAVES THIS PROCESS
        # (the normal 3-phase discipline, core/view.py): the commit
        # signature minted above can complete a 2f+1 quorum at ANY later
        # time, so from this point every future ViewData of ours must
        # attest (proposal, prepared) — otherwise a subsequent view change
        # can conclude "no in-flight", re-propose this sequence fresh, and
        # fork against whoever assembles the quorum (the second half of
        # the seed-1144/1427 chaos-hunt fork).  Saving the records also
        # updates InFlightData (store_proposal + store_prepared) and gives
        # a crash-restore the standard [proposed, commit] tail to resurrect
        # the endorsement from.
        self._state.save(
            ProposedRecord(
                pre_prepare=PrePrepare(
                    view=view.number,
                    seq=view.proposal_sequence,
                    proposal=proposal,
                ),
                prepare=Prepare(
                    view=view.number,
                    seq=view.proposal_sequence,
                    digest=proposal.digest(),
                ),
                verified=True,
            ),
            # No truncation: this record implies no newly-decided sequence,
            # and the default truncate-on-proposal would erase the pending
            # SavedViewChange/SavedNewView history a crash-restore needs —
            # load_view_change_if_applicable scans back over exactly this
            # [vote, proposed, commit] tail to rejoin the pending change.
            truncate=False,
            fault_point="state.save.endorsement_proposed",
        )

        def start_after_durable() -> None:
            if self._stopped or self._in_flight_view is not view:
                return  # abandoned while the record was flushing
            view.start()
            # Peers that started their embedded view later missed our
            # commit broadcast: re-send it every tick until the view
            # decides (the reference instead delays its start by two ticks
            # and relies on the run-loop re-broadcast,
            # viewchanger.go:1277-1280 + view.go:285-288).
            self._rebroadcast_in_flight_commit(view, commit)
            logger.info(
                "%d: started embedded in-flight view %d for seq %d",
                self.self_id, view.number, view.proposal_sequence,
            )

        self._state.save(
            SavedCommit(commit=commit),
            on_durable=start_after_durable,
            fault_point="state.save.endorsement_commit",
        )

    def _rebroadcast_in_flight_commit(self, view: View, commit: Commit) -> None:
        if self._stopped or self._in_flight_view is not view or view.stopped:
            return
        self._comm.broadcast(commit)
        self._sched.call_later(
            self._tick_period,
            lambda: self._rebroadcast_in_flight_commit(view, commit),
            name="in-flight-commit-rebroadcast",
        )

    def _abandon_in_flight_view(self) -> None:
        if self._in_flight_view is not None:
            self._in_flight_view.abort()
            self._in_flight_view = None
        self._pending_transition = False

    # Embedded-view callbacks ------------------------------------------------

    def _in_flight_decided(
        self,
        proposal: Proposal,
        signatures: Sequence[Signature],
        requests: Sequence[RequestInfo],
    ) -> None:
        """Parity: reference viewchanger.go:1310-1332 (Decide)."""
        if self._in_flight_view is not None:
            self._in_flight_view.abort()
            self._in_flight_view = None
        self._deliver_decision(proposal, signatures)
        if self._stopped:
            return
        if self._pending_transition:
            self._finish_new_view()

    def _in_flight_sync(self) -> None:
        """Parity: reference viewchanger.go:1340-1345."""
        self._abandon_in_flight_view()
        self._synchronizer.sync()


class _InFlightDecider:
    def __init__(self, vc: ViewChanger) -> None:
        self._vc = vc

    def decide(self, proposal, signatures, requests) -> None:
        self._vc._in_flight_decided(proposal, signatures, requests)


class _InFlightFailureDetector:
    def complain(self, view: int, stop_view: bool) -> None:
        # The embedded view's leader is ourselves; a complaint here would be
        # a protocol bug (the reference panics).
        logger.error("complaint raised inside the in-flight re-commit view")


class _InFlightSync:
    def __init__(self, vc: ViewChanger) -> None:
        self._vc = vc

    def sync(self) -> None:
        self._vc._in_flight_sync()


__all__ = [
    "ViewChanger",
    "validate_last_decision",
    "validate_in_flight",
    "check_in_flight",
]
