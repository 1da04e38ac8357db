"""Consensus wire messages and WAL record types.

Parity: reference smartbftprotos/messages.proto:14-128 — the ``Message`` oneof
with 10 consensus message kinds, the ``SavedMessage`` oneof with 4 persisted
record kinds, plus ``ViewMetadata`` and ``PreparesFrom``.

These are plain frozen dataclasses; serialization lives in
:mod:`consensus_tpu_torch.wire.codec` (a deterministic binary TLV codec — byte
compatibility with the Go protobuf wire is a non-goal, shape compatibility
is).  Sender identity travels *outside* the message, exactly like the
reference's ``HandleMessage(sender, msg)``.

The PyTorch port's copy of ``consensus_tpu/wire/messages.py``, its imports renamed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

from consensus_tpu_torch.types import Proposal, QuorumCert, Signature

#: A commit-signature quorum as carried on the wire / in the WAL: either the
#: full tuple of per-signer signatures (cert_mode="full", the seed encoding)
#: or a half-aggregated QuorumCert (cert_mode="half-agg", codec v2).
Cert = Union[tuple[Signature, ...], QuorumCert]


@dataclass(frozen=True)
class ViewMetadata:
    """Leader-stamped proposal metadata binding a proposal to its place in the
    protocol and carrying the rotation blacklist.

    Parity: reference smartbftprotos/messages.proto:103-109.
    """

    view_id: int = 0
    latest_sequence: int = 0
    decisions_in_view: int = 0
    black_list: tuple[int, ...] = ()
    prev_commit_signature_digest: bytes = b""


@dataclass(frozen=True)
class PrePrepare:
    """Leader's phase-1 proposal broadcast.

    ``prev_commit_signatures`` carries the quorum that committed the previous
    proposal — followers verify them and the blacklist update they imply.
    Under ``cert_mode="half-agg"`` it is a :class:`QuorumCert` instead of a
    signature tuple (wire v2; verified in one aggregate check).
    Parity: reference smartbftprotos/messages.proto:29-34.
    """

    view: int
    seq: int
    proposal: Proposal
    prev_commit_signatures: Cert = ()


@dataclass(frozen=True)
class Prepare:
    """Phase-2 echo of the proposal digest.

    ``assist`` marks retransmission-help replies that must not be re-answered
    (reference smartbftprotos/messages.proto:40).
    Parity: reference smartbftprotos/messages.proto:36-41.
    """

    view: int
    seq: int
    digest: str
    assist: bool = False


@dataclass(frozen=True)
class Commit:
    """Phase-3 vote carrying the voter's signature over the proposal.

    Parity: reference smartbftprotos/messages.proto:48-54.
    """

    view: int
    seq: int
    digest: str
    signature: Signature
    assist: bool = False


@dataclass(frozen=True)
class PreparesFrom:
    """The prepare-sender id list a consenter vouches for inside its commit
    signature's auxiliary payload (blacklist redemption voting).

    Parity: reference smartbftprotos/messages.proto:56-58.
    """

    ids: tuple[int, ...] = ()


@dataclass(frozen=True)
class ViewChange:
    """Vote to abandon the current view.

    Parity: reference smartbftprotos/messages.proto:60-63.
    """

    next_view: int
    reason: str = ""


@dataclass(frozen=True)
class ViewData:
    """A replica's signed account of its state, sent to the next leader.

    Parity: reference smartbftprotos/messages.proto:65-71.
    """

    next_view: int
    last_decision: Optional[Proposal] = None
    last_decision_signatures: Cert = ()
    in_flight_proposal: Optional[Proposal] = None
    in_flight_prepared: bool = False


@dataclass(frozen=True)
class SignedViewData:
    """ViewData as signed raw bytes + the signer's identity.

    Parity: reference smartbftprotos/messages.proto:73-77.
    """

    raw_view_data: bytes
    signer: int
    signature: bytes


@dataclass(frozen=True)
class NewView:
    """New leader's proof: a quorum of SignedViewData.

    Parity: reference smartbftprotos/messages.proto:79-81.
    """

    signed_view_data: tuple[SignedViewData, ...] = ()


@dataclass(frozen=True)
class HeartBeat:
    """Leader liveness beacon carrying its current (view, seq).

    Parity: reference smartbftprotos/messages.proto:83-86.
    """

    view: int
    seq: int = 0


@dataclass(frozen=True)
class HeartBeatResponse:
    """Follower's answer to a stale-view heartbeat (tells the leader the
    cluster moved on).  Parity: reference smartbftprotos/messages.proto:88-90.
    """

    view: int


@dataclass(frozen=True)
class StateTransferRequest:
    """Ask peers for their current (view, seq).

    Parity: reference smartbftprotos/messages.proto:122-123.
    """


@dataclass(frozen=True)
class StateTransferResponse:
    """Answer to a state-transfer request.

    Parity: reference smartbftprotos/messages.proto:126-128.
    """

    view_num: int
    sequence: int


# --- sync (catch-up) messages ---------------------------------------------
# The reference delegates state transfer entirely to the application (Fabric's
# block puller speaks the Deliver API on its own connections).  These three
# messages are our equivalent of that side protocol: they travel on the sync
# channel (consensus_tpu/sync/transport.py), never on the consensus Comm.


@dataclass(frozen=True)
class SyncRequest:
    """Ask a peer for decided proposals in the position range
    ``[from_seq, to_seq]`` (1-based, inclusive).  ``to_seq == 0`` is a
    metadata probe: the server answers :class:`SyncSnapshotMeta` only.
    """

    from_seq: int
    to_seq: int = 0


@dataclass(frozen=True)
class SyncChunk:
    """A server's bounded answer to a ranged :class:`SyncRequest`.

    ``decisions[i]`` is the proposal at position ``from_seq + i`` and
    ``quorum_certs[i]`` its commit-signature quorum — kept as parallel
    sequences so a client can drain every cert in the chunk into one
    batched verifier call.  ``height`` is the server's chain height at
    reply time (flow control: the client learns how far behind it still
    is without a second probe).
    """

    from_seq: int
    height: int
    decisions: tuple[Proposal, ...] = ()
    quorum_certs: tuple[Cert, ...] = ()


@dataclass(frozen=True)
class SyncSnapshotMeta:
    """A server's chain snapshot metadata: height and the digest of the
    decision at the tip (empty when the chain is empty)."""

    height: int
    last_digest: str = ""


@dataclass(frozen=True)
class EpochTagged:
    """Membership-epoch envelope around any other wire message.

    When ``Configuration.epoch_tagging`` is on, every outbound consensus
    message is wrapped with the sender's current membership epoch and the
    receiving facade drops traffic from other epochs at ingress — counted
    and traced, never fed to the collectors.  Exactly one level of wrapping
    is legal (the codec rejects a nested ``EpochTagged``).

    No reference counterpart: the reference leaves membership bookkeeping to
    the application and has no epoch discriminator on the wire.
    """

    epoch: int
    msg: "ConsensusMessage"


#: The "Message oneof": anything a replica may put on the wire.
#: QuorumCert (types.py) is a member too: a half-aggregated cert travels
#: standalone under codec tag 15 as well as embedded in PrePrepare /
#: SyncChunk / ViewData / SavedCommit cert fields.
ConsensusMessage = Union[
    QuorumCert,
    PrePrepare,
    Prepare,
    Commit,
    ViewChange,
    SignedViewData,
    NewView,
    HeartBeat,
    HeartBeatResponse,
    StateTransferRequest,
    StateTransferResponse,
    SyncRequest,
    SyncChunk,
    SyncSnapshotMeta,
    EpochTagged,
]


# --- WAL record kinds ----------------------------------------------------


@dataclass(frozen=True)
class ProposedRecord:
    """WAL record: a proposal was accepted and a prepare is about to be sent.

    ``verified`` records whether proposal verification had already succeeded
    when the record was written.  Followers verify before persisting, so
    their records say True; the leader persists (and reveals) its own
    proposal BEFORE verifying it (reveal-before-verify,
    core/view.py::_try_process_proposal), so its record says False until
    verification completes — and any restore from a False record must
    re-verify before re-arming the prepare endorsement.

    Parity: reference smartbftprotos/messages.proto:43-46 (the flag is an
    addition; the reference has no pre-verification persistence).
    """

    pre_prepare: PrePrepare
    prepare: Prepare
    verified: bool = True


@dataclass(frozen=True)
class SavedCommit:
    """WAL record: a prepared quorum was reached and a commit is about to be
    sent.  Wraps the commit message itself (the reference stores the whole
    ``Message``; we store the ``Commit`` directly).

    Parity: reference smartbftprotos/messages.proto:113-116 (``commit`` arm).

    ``cert`` (half-agg mode only, WAL v3) persists the assembled
    :class:`QuorumCert` for the decided sequence so a restart can re-serve
    the compact cert to sync clients and view changes without re-aggregating.
    """

    commit: Commit
    cert: Optional[QuorumCert] = None


@dataclass(frozen=True)
class SavedNewView:
    """WAL record: a new view was finalized; stores the restore point.

    Parity: reference smartbftprotos/messages.proto:117 (``new_view`` arm —
    a ViewMetadata).
    """

    view_metadata: ViewMetadata


@dataclass(frozen=True)
class SavedViewChange:
    """WAL record: we voted to leave a view.

    Parity: reference smartbftprotos/messages.proto:118 (``view_change`` arm).
    """

    view_change: ViewChange


#: The observable phases of a cross-group 2PC participant, in order.
TWOPC_PHASES = ("prepared", "committed", "aborted")


@dataclass(frozen=True)
class SavedTwoPC:
    """WAL record (saved v4): one cross-group 2PC participant transition.

    consensus_tpu addition (no reference counterpart): each consensus group
    participating in a cross-group atomic transaction persists its
    participant state machine — prepared, then committed OR aborted — so a
    restarted participant resumes knowing exactly which transactions it has
    promised and which it has resolved.  ``groups`` names every participant
    (the atomicity invariant's scope) and ``coordinator`` the group whose
    coordinator drives the decision.
    """

    txid: str
    phase: str  # one of TWOPC_PHASES
    groups: tuple = ()
    coordinator: str = ""


#: The "SavedMessage oneof": anything persisted to the WAL.
SavedMessage = Union[
    ProposedRecord, SavedCommit, SavedNewView, SavedViewChange, SavedTwoPC
]


def msg_to_string(msg: ConsensusMessage) -> str:
    """Compact human-readable rendering for logs.

    Parity: reference internal/bft/util.go:345-420 (MsgToString).
    """
    if isinstance(msg, PrePrepare):
        return (
            f"<PrePrepare view={msg.view} seq={msg.seq} "
            f"digest={msg.proposal.digest()[:8]}>"
        )
    if isinstance(msg, Prepare):
        return f"<Prepare view={msg.view} seq={msg.seq} digest={msg.digest[:8]} assist={msg.assist}>"
    if isinstance(msg, Commit):
        return (
            f"<Commit view={msg.view} seq={msg.seq} digest={msg.digest[:8]} "
            f"signer={msg.signature.id} assist={msg.assist}>"
        )
    if isinstance(msg, ViewChange):
        return f"<ViewChange next_view={msg.next_view} reason={msg.reason!r}>"
    if isinstance(msg, SignedViewData):
        return f"<SignedViewData signer={msg.signer}>"
    if isinstance(msg, NewView):
        return f"<NewView n={len(msg.signed_view_data)}>"
    if isinstance(msg, HeartBeat):
        return f"<HeartBeat view={msg.view} seq={msg.seq}>"
    if isinstance(msg, HeartBeatResponse):
        return f"<HeartBeatResponse view={msg.view}>"
    if isinstance(msg, StateTransferRequest):
        return "<StateTransferRequest>"
    if isinstance(msg, StateTransferResponse):
        return f"<StateTransferResponse view={msg.view_num} seq={msg.sequence}>"
    if isinstance(msg, SyncRequest):
        return f"<SyncRequest from={msg.from_seq} to={msg.to_seq}>"
    if isinstance(msg, SyncChunk):
        return (
            f"<SyncChunk from={msg.from_seq} n={len(msg.decisions)} "
            f"height={msg.height}>"
        )
    if isinstance(msg, SyncSnapshotMeta):
        return f"<SyncSnapshotMeta height={msg.height} tip={msg.last_digest[:8]}>"
    if isinstance(msg, EpochTagged):
        return f"<EpochTagged epoch={msg.epoch} msg={msg_to_string(msg.msg)}>"
    if isinstance(msg, QuorumCert):
        return f"<QuorumCert n={len(msg)} signers={list(msg.signer_ids)}>"
    return repr(msg)


__all__ = [
    "Cert",
    "QuorumCert",
    "ViewMetadata",
    "PrePrepare",
    "Prepare",
    "Commit",
    "PreparesFrom",
    "ViewChange",
    "ViewData",
    "SignedViewData",
    "NewView",
    "HeartBeat",
    "HeartBeatResponse",
    "StateTransferRequest",
    "StateTransferResponse",
    "SyncRequest",
    "SyncChunk",
    "SyncSnapshotMeta",
    "EpochTagged",
    "ConsensusMessage",
    "ProposedRecord",
    "SavedCommit",
    "SavedNewView",
    "SavedViewChange",
    "SavedTwoPC",
    "TWOPC_PHASES",
    "SavedMessage",
    "msg_to_string",
]
