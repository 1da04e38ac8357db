"""Persisted protocol state: WAL encode/decode and crash-restore-into-phase.

Parity: reference internal/bft/state.go:31-247 (PersistedState), util.go:191-254
(InFlightData), util.go:257-336 (ProposalMaker).

The PyTorch port's copy of ``consensus_tpu/core/state.py``, its imports renamed.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional, Sequence

from consensus_tpu_torch.api.deps import WriteAheadLog
from consensus_tpu_torch.core.view import Phase, View
from consensus_tpu_torch.wal.log import WALError
from consensus_tpu_torch.types import Proposal, Signature
from consensus_tpu_torch.wire import (
    Commit,
    Prepare,
    ProposedRecord,
    SavedCommit,
    SavedMessage,
    SavedNewView,
    SavedViewChange,
    ViewChange,
    ViewMetadata,
    decode_saved,
    decode_view_metadata,
    encode_saved,
)

logger = logging.getLogger("consensus_tpu_torch.state")


def restore_requests_best_effort(view: "View", proposal: Proposal) -> None:
    """Populate ``view.in_flight_requests`` from the application's
    ``requests_from_proposal`` during phase re-entry, so a restored replica
    that goes on to commit still removes the batch from its pool and counts
    it in the tx metrics.  Best-effort: a restored view with an empty
    request list commits correctly; only that cleanup/accounting is lost."""
    try:
        view.in_flight_requests = tuple(
            view._verifier.requests_from_proposal(proposal)
        )
    except Exception:
        logger.exception(
            "requests_from_proposal failed during restore; "
            "continuing with an empty request list"
        )


class InFlightData:
    """Holder of the proposals currently moving through the 3-phase
    pipeline, plus whether each reached the PREPARED stage.

    Parity: reference internal/bft/util.go:191-254 (lock dropped — the
    runtime is single-threaded per replica), WINDOWED for decision
    pipelining: one entry per in-flight sequence.  ``proposal()`` /
    ``is_prepared()`` report the OLDEST undecided entry — the only slot a
    view change can ever need to adopt (nothing above the oldest can have
    been commit-signed anywhere; see SAFETY.md §5) — so the view changer's
    single-slot reading stays correct at any depth.  Decided sequences are
    dropped by ``prune_decided`` (the controller calls it on delivery).
    """

    def __init__(self) -> None:
        #: seq (or None when the proposal carries no decodable metadata,
        #: which sorts as the oldest) -> [proposal, prepared].
        self._slots: dict[Optional[int], list] = {}

    @staticmethod
    def _seq_of(proposal: Proposal) -> Optional[int]:
        if not proposal.metadata:
            return None
        try:
            return decode_view_metadata(proposal.metadata).latest_sequence
        except Exception:
            return None

    def _oldest(self) -> Optional[list]:
        if not self._slots:
            return None
        key = min(self._slots, key=lambda k: -1 if k is None else k)
        return self._slots[key]

    def proposal(self) -> Optional[Proposal]:
        slot = self._oldest()
        return slot[0] if slot is not None else None

    def is_prepared(self) -> bool:
        slot = self._oldest()
        return bool(slot[1]) if slot is not None else False

    def store_proposal(self, proposal: Proposal) -> None:
        self._slots[self._seq_of(proposal)] = [proposal, False]

    def store_prepared(self, view: int, seq: int) -> bool:
        """Mark the entry whose metadata stamps match ``(view, seq)`` as
        prepared; returns whether one matched."""
        for slot in self._slots.values():
            prop = slot[0]
            md = (
                decode_view_metadata(prop.metadata)
                if prop.metadata
                else ViewMetadata()
            )
            if md.view_id == view and md.latest_sequence == seq:
                slot[1] = True
                return True
        return False

    def prune_decided(self, seq: int) -> None:
        """Drop every entry at or below a delivered sequence."""
        for key in [k for k in self._slots if k is not None and k <= seq]:
            del self._slots[key]

    def drop_above_oldest(self) -> None:
        """Abandon pipelined entries above the oldest undecided one (view
        aborts: higher slots are re-proposed in the next view, and our
        attestation must only ever cover the contested oldest slot)."""
        if len(self._slots) <= 1:
            return
        keep = min(self._slots, key=lambda k: -1 if k is None else k)
        self._slots = {keep: self._slots[keep]}

    def clear(self) -> None:
        self._slots.clear()


class PersistedState:
    """Bridges protocol records to the WAL and restores a View mid-protocol.

    Parity: reference internal/bft/state.go:31-247.
    """

    def __init__(
        self,
        wal: WriteAheadLog,
        in_flight: InFlightData,
        entries: Sequence[bytes] = (),
    ) -> None:
        self._wal = wal
        self._in_flight = in_flight
        #: Raw WAL entries read at boot (the restore source).
        self.entries = list(entries)
        #: In-memory WAL tail for MID-RUN view restarts (see
        #: reseed_if_inflight_matches), WINDOWED for decision pipelining:
        #: seq -> [ProposedRecord, Optional[SavedCommit]] for every sequence
        #: in the trailing run of protocol records.  At pipeline depth 1
        #: this holds at most the single legacy mem-tail pair.
        self._mem_window: dict[int, list] = {}
        #: The record object most recently appended this run — the guard for
        #: the verified-upgrade append (it must only ever replace the tail).
        self._last_written: Optional[SavedMessage] = None
        #: Proposals restore() abandoned above the oldest in-flight slot —
        #: the consensus layer re-admits their requests to the pool.
        self.abandoned: list[Proposal] = []
        try:
            for rec in self._trailing_protocol_records():
                if isinstance(rec, ProposedRecord):
                    # A later record at the same seq is the verified-upgrade
                    # twin; forward replay makes it win, like the legacy tail.
                    self._mem_window[rec.pre_prepare.seq] = [rec, None]
                else:  # SavedCommit
                    slot = self._mem_window.get(rec.commit.seq)
                    if (
                        slot is not None
                        and slot[0].pre_prepare.view == rec.commit.view
                    ):
                        slot[1] = rec
            last = self._last_record()
            if isinstance(last, ProposedRecord):
                slot = self._mem_window.get(last.pre_prepare.seq)
                if slot is not None:
                    # The restored tail counts as "last written" so a
                    # restore-time re-verification success upgrades the
                    # on-disk record too — without this, only the FIRST
                    # crash is protected and a second crash re-runs the
                    # spurious re-verify.  Keep object identity between the
                    # window slot and the tail guard.
                    self._last_written = slot[0]
        except Exception:
            # A torn/corrupt tail must not fail boot here: restore() has
            # its own tolerant handling ("starting clean"), and with no
            # mem-tail the reseed guard simply never fires.
            logger.exception("WAL mem-tail seeding failed; reseed disabled")

    def _trailing_protocol_records(self) -> list:
        """The contiguous run of ProposedRecord/SavedCommit entries at the
        WAL tail, in log order.  A run never spans views: any view install
        appends a SavedNewView (and the endorsement tail sits above its
        SavedViewChange), both of which stop the backward scan."""
        tail: list = []
        idx = len(self.entries) - 1
        while idx >= 0:
            rec = decode_saved(self.entries[idx])
            if not isinstance(rec, (ProposedRecord, SavedCommit)):
                break
            tail.append(rec)
            idx -= 1
        tail.reverse()
        return tail

    # --- saving ------------------------------------------------------------

    @staticmethod
    def _fault_point_of(record: SavedMessage) -> str:
        if isinstance(record, ProposedRecord):
            return "state.save.proposed"
        if isinstance(record, SavedCommit):
            return "state.save.commit"
        if isinstance(record, SavedViewChange):
            return "state.save.viewchange"
        return "state.save.newview"

    def save(self, record: SavedMessage, on_durable=None,
             truncate: Optional[bool] = None, fault_point: Optional[str] = None
             ) -> None:
        """Persist one protocol step; ``on_durable`` fires once the record
        is on stable storage (immediately for per-append fsync, deferred
        under group commit — the protocol defers its sends behind it).

        A new ProposedRecord doubles as a truncation point: the previous
        proposal is then stably decided (reference state.go:38-59).
        ``truncate`` overrides that default — the view changer's embedded
        in-flight endorsement appends a ProposedRecord that implies NO new
        decision (the sequence is the contested one), and truncating there
        would erase the pending-view-change vote the crash-restore rejoin
        depends on.

        ``fault_point`` relabels this save's crash points (the endorsement
        appends register under their own names); the seams fire only when
        the test harness armed a FaultPlan on the WAL — one ``is None``
        check otherwise."""
        plan = getattr(self._wal, "fault_plan", None)
        if plan is not None:
            point = fault_point or self._fault_point_of(record)
            # ".pre": the process dies before ANY effect of this step — the
            # in-memory mutations below never survive a real crash either.
            plan.crash(point + ".pre")
        if isinstance(record, ProposedRecord):
            self._in_flight.store_proposal(record.pre_prepare.proposal)
            self._mem_window[record.pre_prepare.seq] = [record, None]
        elif isinstance(record, SavedCommit):
            matched = self._in_flight.store_prepared(
                record.commit.view, record.commit.seq
            )
            if not matched:
                # Coupling invariant: a commit record is only ever persisted
                # for a proposal currently in flight (the commit signature
                # was minted against it).  If the (view, seq) stamps do not
                # line up, the check_in_flight "unprepared attestations are
                # no-argument" relaxation would be silently decoupled from
                # its persist-before-sign precondition — fail loudly instead.
                raise RuntimeError(
                    "persist-before-sign coupling violated: commit record at "
                    f"(view={record.commit.view}, seq={record.commit.seq}) "
                    "does not match an in-flight proposal"
                )
            slot = self._mem_window.get(record.commit.seq)
            if (
                slot is not None
                and slot[0].pre_prepare.view == record.commit.view
            ):
                slot[1] = record
        self._last_written = record
        try:
            self._wal.append(
                encode_saved(record),
                truncate_to=(
                    isinstance(record, ProposedRecord) if truncate is None else truncate
                ),
                on_durable=on_durable,
            )
        except WALError as err:
            if getattr(self._wal, "degraded", False):
                # The append was refused by a degraded WAL (ENOSPC, fsync
                # retry cap).  Swallow the failure WITHOUT firing
                # ``on_durable``: the dependent send never happens
                # (persist-before-send holds vacuously), and the degrade
                # hook already suspended this replica's proposing/voting
                # (core/controller.py::set_wal_degraded).
                logger.warning("WAL append refused while degraded: %s", err)
                return
            raise
        if plan is not None:
            plan.crash(point + ".post")

    # --- boot-time peeking (pkg/consensus setViewAndSeq equivalents) -------

    def _last_record(self) -> Optional[SavedMessage]:
        if not self.entries:
            return None
        return decode_saved(self.entries[-1])

    def load_new_view_if_applicable(self) -> Optional[tuple[int, int]]:
        """(view, seq) if the log ends with a finalized new-view record.

        Parity: reference state.go:80-95."""
        last = self._last_record()
        if isinstance(last, SavedNewView):
            md = last.view_metadata
            return md.view_id, md.latest_sequence
        return None

    def load_in_flight_view_if_applicable(self) -> Optional[tuple[int, int]]:
        """(view, decisions_in_view) of the WAL-tail in-flight pre-prepare,
        if the log ends in one (directly, or behind our commit).

        A proposal record at view v proves v was INSTALLED here before the
        crash (followers accept and leaders create proposals only inside an
        active view) — but the SavedNewView record that said so may be gone:
        the proposal append itself truncates the log.  Booting from the
        checkpoint's (older) view in that state strands the replica in a
        view the cluster left long ago, with its view changer blind to the
        regression (seed-3428 chaos wedge: two restored replicas idling at
        view 1 while holding (view 8) proposal records).

        Reads the mem-window ``__init__`` already seeded (same tail cases,
        and behind its torn-tail exception guard — a corrupt tail must not
        fail boot).  The NEWEST (max-seq) entry is the legacy "last
        ProposedRecord" — and since a trailing run never spans views, every
        window entry proves the same installed view anyway."""
        if not self._mem_window:
            return None
        rec = self._mem_window[max(self._mem_window)][0]
        pp = rec.pre_prepare
        dec = 0
        if pp.proposal.metadata:
            dec = decode_view_metadata(pp.proposal.metadata).decisions_in_view
        return pp.view, dec

    def load_view_change_if_applicable(self) -> Optional[ViewChange]:
        """The pending view-change vote if the log ends with one — directly,
        or buried under the view changer's in-flight endorsement tail.

        Parity: reference state.go:97-113, EXTENDED: after
        ``_commit_in_flight`` persists its endorsement the log reads
        ``[..., SavedViewChange, ProposedRecord, SavedCommit]`` (both
        endorsement appends use truncate=False precisely so the vote
        survives).  A replica that crashes there is still mid-view-change:
        only the vote's durability let it sign the ViewData attestation it
        broadcast, so on restart it MUST rejoin the pending change — booting
        from the bare in-flight tail would strand it in the contested view
        with its vote forgotten.  The bounded backward scan is safe because
        a *normal* ProposedRecord append truncates the log (clearing any
        older vote): a ProposedRecord sitting ABOVE a live SavedViewChange
        can only be a truncate=False append, i.e. the endorsement (or its
        verified-upgrade twin), and a crash between the two endorsement
        appends leaves the ``[..., SavedViewChange, ProposedRecord]``
        prefix this scan also handles."""
        idx = len(self.entries) - 1
        if idx < 0:
            return None
        rec = decode_saved(self.entries[idx])
        # Walk back over the SavedCommit run: under cert_mode="half-agg" the
        # endorsement commit may be followed by its cert-bearing twin at the
        # same (view, seq) — both truncate-free appends, both ours.
        while isinstance(rec, SavedCommit) and idx >= 1:
            idx -= 1
            rec = decode_saved(self.entries[idx])
        if isinstance(rec, ProposedRecord) and idx >= 1:
            idx -= 1
            rec = decode_saved(self.entries[idx])
        if isinstance(rec, SavedViewChange):
            return rec.view_change
        return None

    # --- restore-into-phase (state.go:115-247) -----------------------------

    def restore(self, view: View) -> None:
        """Re-enter the phase the replica crashed in: PROPOSED if the last
        record is a proposal, PREPARED if it is our commit (with our own
        signature resurrected).

        With decision pipelining the WAL tail can hold records from SEVERAL
        sequences.  Only the oldest undecided slot (``view.proposal_sequence``,
        anchored by the application's delivered height) is re-entered; every
        proposal above it is ABANDONED into :attr:`abandoned` for pool
        re-admission — by the in-order commit rule nothing above the oldest
        can have been commit-signed anywhere (SAFETY.md §5), so dropping
        those slots cannot contradict any commit quorum.  A single-sequence
        tail takes the exact legacy path."""
        view.phase = Phase.COMMITTED
        last = self._last_record()
        if last is None:
            logger.info("nothing to restore")
            return
        tail = self._trailing_protocol_records()
        seqs = {
            r.pre_prepare.seq if isinstance(r, ProposedRecord) else r.commit.seq
            for r in tail
        }
        if len(seqs) > 1:
            self._restore_windowed(view)
            return
        if isinstance(last, ProposedRecord):
            self._recover_proposed(last, view)
        elif isinstance(last, SavedCommit):
            self._recover_prepared(last, view)
        # SavedNewView / SavedViewChange need no phase recovery.

    def _restore_windowed(self, view: View) -> None:
        """Multi-sequence (pipelined) tail restore.  ``_mem_window`` was
        seeded from the same trailing run; the target slot is the oldest
        undecided sequence the caller booted the view at."""
        target = view.proposal_sequence
        for seq, slot in self._mem_window.items():
            if slot[1] is not None and seq > target:
                # A commit of ours above the delivered height would mean
                # the in-order gate was breached (or the app state is
                # behind a WAL from someone else's future) — refuse to
                # guess, like the legacy "WAL seq ahead" path.
                raise ValueError(
                    f"WAL commit at seq {seq} is ahead of our last "
                    f"committed {target}"
                )
        slot = self._mem_window.get(target)
        if slot is not None:
            rec, commit = slot
            pp = rec.pre_prepare
            view.number = pp.view
            if commit is not None:
                self._enter_prepared(rec, commit.commit, view)
                logger.info(
                    "restored into PREPARED at seq %d (pipelined tail)", pp.seq
                )
            else:
                self._enter_proposed(rec, view)
                logger.info(
                    "restored into PROPOSED at seq %d (pipelined tail)", pp.seq
                )
        dropped = sorted(s for s in self._mem_window if s > target)
        for seq in dropped:
            self.abandoned.append(self._mem_window[seq][0].pre_prepare.proposal)
        if dropped:
            logger.info(
                "abandoned %d pipelined slot(s) above seq %d: %s",
                len(dropped), target, dropped,
            )

    def take_abandoned(self) -> list[Proposal]:
        """Drain the proposals restore() abandoned above the oldest slot."""
        out, self.abandoned = self.abandoned, []
        return out

    def prune_decided(self, seq: int) -> None:
        """Forget mem-window and in-flight entries at or below a delivered
        sequence (the controller calls this on every delivery)."""
        for key in [k for k in self._mem_window if k <= seq]:
            del self._mem_window[key]
        self._in_flight.prune_decided(seq)

    def _recover_proposed(self, record: ProposedRecord, view: View) -> None:
        pp = record.pre_prepare
        self._in_flight.store_proposal(pp.proposal)
        view.number = pp.view
        view.proposal_sequence = pp.seq
        self._enter_proposed(record, view)
        logger.info("restored into PROPOSED at seq %d", pp.seq)

    def mark_proposed_verified(self, view_number: int, seq: int) -> None:
        """Flip the in-memory ProposedRecord to verified once the (leader's)
        deferred verification succeeds, so a mid-run view restart
        (reseed_if_inflight_matches) does not re-verify a proposal this
        process already verified.

        If the unverified record is still the WAL tail, an upgraded copy is
        appended so a CRASH-restore skips the re-verify too: re-running
        verification after a crash is conservative, but it spuriously fails
        when verifier state (e.g. verification_sequence) legitimately
        advanced between the write and the restore — deposing a leader that
        had already verified the proposal pre-crash (ADVICE r3).  The
        append is best-effort and tail-guarded: if ANY record followed (a
        commit, a view-change), the upgrade is skipped — a commit makes it
        moot (PREPARED restore doesn't re-verify) and anything else must
        stay the tail the restore logic sees.

        The append deliberately does NOT truncate: restore only decodes the
        last record(s), so the older verified=False copy on disk is
        harmless, and truncate_to=True would force an eager fsync outside
        any group-commit window — a second synchronous fsync on the
        leader's critical path per decision (ADVICE r4).  Losing an
        unflushed upgrade in a crash just re-verifies: the documented
        best-effort behavior."""
        slot = self._mem_window.get(seq)
        rec = slot[0] if slot is not None else None
        if (
            rec is not None
            and not rec.verified
            and rec.pre_prepare.view == view_number
            and rec.pre_prepare.seq == seq
        ):
            upgraded = dataclasses.replace(rec, verified=True)
            slot[0] = upgraded
            if self._last_written is rec:
                try:
                    self._wal.append(encode_saved(upgraded), truncate_to=False)
                    self._last_written = upgraded
                except Exception:
                    logger.exception(
                        "verified-upgrade append failed; a crash-restore "
                        "will re-verify (liveness-only cost)"
                    )

    def _enter_proposed(self, record: ProposedRecord, view: View) -> None:
        """Shared phase-reentry: seed ``view`` into PROPOSED from a
        persisted pre-prepare (used by boot restore AND the mid-run
        reseed guard — one body for the safety-critical invariant)."""
        pp = record.pre_prepare
        self._in_flight.store_proposal(pp.proposal)
        view.in_flight_proposal = pp.proposal
        md = decode_view_metadata(pp.proposal.metadata)
        view.decisions_in_view = md.decisions_in_view
        view.phase = Phase.PROPOSED
        if not record.verified:
            # The record was persisted BEFORE its verification completed —
            # only the leader's own reveal-before-verify path writes such
            # records (view.py::_try_process_proposal).  Durability does not
            # imply verification here, so re-run it before re-arming the
            # prepare: the prepare is an endorsement and must never outlive
            # a failed verification via restore.  On failure we stay pinned
            # to the proposal (no equivocation) but never endorse it — the
            # prepare stays un-armed AND the PREPARED transition (commit
            # signing) is blocked; the complaint cascade deposes us.
            try:
                requests = view._verify_proposal(
                    pp.proposal, pp.prev_commit_signatures
                )
            except Exception as err:
                logger.warning(
                    "restored own proposal at (%d, %d) fails verification "
                    "(%s); staying pinned without endorsing it",
                    pp.view, pp.seq, err,
                )
                view.endorsement_blocked = True
                return
            view.in_flight_requests = tuple(requests)
            # Re-verification succeeded: flip the in-memory copy so later
            # mid-run reseeds at this (view, seq) don't verify a third time.
            self.mark_proposed_verified(pp.view, pp.seq)
        else:
            restore_requests_best_effort(view, pp.proposal)
        p = record.prepare
        view._curr_prepare_sent = Prepare(
            view=p.view, seq=p.seq, digest=p.digest, assist=True
        )

    def _enter_prepared(self, record: ProposedRecord, commit, view: View) -> None:
        """Shared phase-reentry: seed ``view`` into PREPARED from a
        persisted pre-prepare + our commit."""
        pp = record.pre_prepare
        self._in_flight.store_proposal(pp.proposal)
        self._in_flight.store_prepared(commit.view, commit.seq)
        view.in_flight_proposal = pp.proposal
        restore_requests_best_effort(view, pp.proposal)
        md = decode_view_metadata(pp.proposal.metadata)
        view.decisions_in_view = md.decisions_in_view
        view.my_commit_signature = commit.signature
        view.phase = Phase.PREPARED
        view._curr_commit_sent = Commit(
            view=commit.view,
            seq=commit.seq,
            digest=commit.digest,
            signature=commit.signature,
            assist=True,
        )

    def _recover_prepared(self, record: SavedCommit, view: View) -> None:
        commit = record.commit
        if len(self.entries) < 2:
            raise ValueError("commit record without a preceding pre-prepare")
        # Under cert_mode="half-agg" the decide path appends a cert-bearing
        # SavedCommit twin after the endorsement commit — walk back over any
        # same-(view, seq) SavedCommit run to the anchoring ProposedRecord.
        idx = len(self.entries) - 2
        prev = decode_saved(self.entries[idx])
        while (
            isinstance(prev, SavedCommit)
            and prev.commit.view == commit.view
            and prev.commit.seq == commit.seq
            and idx >= 1
        ):
            idx -= 1
            prev = decode_saved(self.entries[idx])
        if not isinstance(prev, ProposedRecord):
            raise ValueError(
                f"expected ProposedRecord before commit, got {type(prev).__name__}"
            )
        pp = prev.pre_prepare
        if view.proposal_sequence < pp.seq:
            raise ValueError(
                f"WAL seq {pp.seq} is ahead of our last committed {view.proposal_sequence}"
            )
        if view.proposal_sequence > pp.seq:
            logger.info("seq %d already safely committed", view.proposal_sequence)
            return
        view.number = pp.view
        view.proposal_sequence = pp.seq
        self._enter_prepared(prev, commit, view)
        logger.info("restored into PREPARED at seq %d", pp.seq)


    def reseed_if_inflight_matches(self, view: "View") -> None:
        """Equivocation guard for MID-RUN view restarts (the boot restore
        runs once; this runs on every later view start): if the view being
        started sits at EXACTLY the (view, seq) we persisted a pre-prepare
        (and possibly our commit) for, the fresh View object must resume
        from that state.  Starting clean would let this replica prepare a
        DIFFERENT proposal at the same (view, seq) — and a sync-with-
        nothing-new restarting the current view does exactly that on every
        stalled replica at once, which is a quorum of equivocators and a
        forked ledger (found by the targeted-chaos soak, seed 114: two
        proposals both "committed" at the same view/seq with overlapping
        signers).  Restarts at a different view or sequence are untouched:
        cross-view safety belongs to the view-change protocol
        (check_in_flight + the embedded re-commit view)."""
        slot = self._mem_window.get(view.proposal_sequence)
        if slot is None:
            return
        rec, commit = slot
        pp = rec.pre_prepare
        if pp.view != view.number or pp.seq != view.proposal_sequence:
            return
        if commit is not None and (
            commit.commit.view != pp.view or commit.commit.seq != pp.seq
        ):
            commit = None
        if commit is None:
            self._enter_proposed(rec, view)
            logger.info(
                "reseeded restarted view into PROPOSED at (%d, %d)", pp.view, pp.seq
            )
        else:
            self._enter_prepared(rec, commit.commit, view)
            logger.info(
                "reseeded restarted view into PREPARED at (%d, %d)", pp.view, pp.seq
            )


class ProposalMaker:
    """Builds each View, restoring protocol state from the WAL exactly once
    (the first view created after boot).

    Parity: reference internal/bft/util.go:257-336 (ProposalMaker).
    """

    def __init__(
        self,
        *,
        state: PersistedState,
        view_factory: Callable[..., View],
    ) -> None:
        self._state = state
        self._factory = view_factory
        self._restored_once = False

    def new_proposer(
        self,
        leader_id: int,
        proposal_sequence: int,
        view_number: int,
        decisions_in_view: int,
    ) -> tuple[View, Phase]:
        view = self._factory(
            leader_id=leader_id,
            proposal_sequence=proposal_sequence,
            number=view_number,
            decisions_in_view=decisions_in_view,
        )
        if self._restored_once:
            self._state.reseed_if_inflight_matches(view)
        else:
            self._restored_once = True
            try:
                self._state.restore(view)
            except Exception:
                logger.exception("WAL restore failed; starting clean")
        return view, view.phase


__all__ = ["InFlightData", "PersistedState", "ProposalMaker"]
