"""Deterministic binary codec for wire messages and WAL records.

Replaces the reference's protobuf layer (smartbftprotos/messages.pb.go) with a
compact hand-rolled tag + length-prefixed encoding.  Properties the protocol
relies on:

* **Deterministic** — the same message always encodes to the same bytes
  (protobuf does not guarantee this across implementations).  ViewData
  signatures and WAL CRC chains are computed over these bytes.
* **Self-delimiting** — every value knows its own length, so records can be
  concatenated (WAL) or nested (SignedViewData.raw_view_data).
* **Versioned** — one format-version byte leads every envelope so the codec
  can evolve.

Primitive layer: u8, u64 (big-endian), bool, bytes (u32 length prefix),
str (utf-8 bytes), and homogeneous sequences (u32 count prefix).

The PyTorch port's copy of ``consensus_tpu/wire/codec.py``, its imports renamed.
"""

from __future__ import annotations

import struct
from typing import Callable, Optional, Sequence

from consensus_tpu_torch.types import Proposal, QuorumCert, Signature
from consensus_tpu_torch.wire.messages import (
    Cert,
    Commit,
    ConsensusMessage,
    EpochTagged,
    HeartBeat,
    HeartBeatResponse,
    NewView,
    PrePrepare,
    Prepare,
    PreparesFrom,
    ProposedRecord,
    SavedCommit,
    SavedMessage,
    SavedNewView,
    SavedTwoPC,
    SavedViewChange,
    SignedViewData,
    StateTransferRequest,
    StateTransferResponse,
    SyncChunk,
    SyncRequest,
    SyncSnapshotMeta,
    TWOPC_PHASES,
    ViewChange,
    ViewData,
    ViewMetadata,
)

_VERSION = 1
# Wire v2: cert-carrying fields (PrePrepare.prev_commit_signatures,
# SyncChunk.quorum_certs, ViewData.last_decision_signatures) gain a
# cert-kind discriminator so a half-aggregated QuorumCert can ride where a
# signature tuple used to.  v2 is emitted ONLY when a QuorumCert is
# actually present (lowest-lossless-version rule, same as the WAL's
# ProposedRecord pattern), so cert_mode="full" traffic stays bit-for-bit
# the v1 seed encoding.
_WIRE_VERSION = 2

# Domain discriminators: the second envelope byte separates the wire-message
# and WAL-record encodings so bytes from one domain can never silently decode
# in the other (e.g. a misrouted buffer during crash recovery).
_DOMAIN_WIRE = 0x57  # 'W'
_DOMAIN_SAVED = 0x4C  # 'L'


class CodecError(ValueError):
    """Raised on malformed input bytes."""


class _Writer:
    __slots__ = ("_parts",)

    def __init__(self) -> None:
        self._parts: list[bytes] = []

    def u8(self, v: int) -> None:
        self._parts.append(struct.pack(">B", v))

    def u64(self, v: int) -> None:
        self._parts.append(struct.pack(">Q", v))

    def boolean(self, v: bool) -> None:
        self._parts.append(b"\x01" if v else b"\x00")

    def blob(self, v: bytes) -> None:
        self._parts.append(struct.pack(">I", len(v)))
        self._parts.append(v)

    def text(self, v: str) -> None:
        self.blob(v.encode("utf-8"))

    def seq(self, items: Sequence, write_item: Callable) -> None:
        self._parts.append(struct.pack(">I", len(items)))
        for item in items:
            write_item(item)

    def getvalue(self) -> bytes:
        return b"".join(self._parts)


class _Reader:
    __slots__ = ("_buf", "_pos")

    def __init__(self, buf: bytes) -> None:
        self._buf = buf
        self._pos = 0

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._buf):
            raise CodecError(
                f"truncated input: need {n} bytes at offset {self._pos}, "
                f"have {len(self._buf) - self._pos}"
            )
        out = self._buf[self._pos : self._pos + n]
        self._pos += n
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def u64(self) -> int:
        return struct.unpack(">Q", self._take(8))[0]

    def boolean(self) -> bool:
        b = self._take(1)[0]
        if b not in (0, 1):
            raise CodecError(f"invalid bool byte {b!r}")
        return b == 1

    def blob(self) -> bytes:
        n = struct.unpack(">I", self._take(4))[0]
        return self._take(n)

    def text(self) -> str:
        try:
            return self.blob().decode("utf-8")
        except UnicodeDecodeError as e:
            raise CodecError(f"invalid utf-8: {e}") from e

    def seq(self, read_item: Callable) -> tuple:
        n = struct.unpack(">I", self._take(4))[0]
        if n > len(self._buf):  # cheap sanity bound: each item is >= 1 byte
            raise CodecError(f"implausible sequence count {n}")
        return tuple(read_item() for _ in range(n))

    def expect_end(self) -> None:
        if self._pos != len(self._buf):
            raise CodecError(f"{len(self._buf) - self._pos} trailing bytes")


# --- shared value encoders -----------------------------------------------


def _w_proposal(w: _Writer, p: Proposal) -> None:
    w.blob(p.header)
    w.blob(p.payload)
    w.blob(p.metadata)
    w.u64(p.verification_sequence)


def _r_proposal(r: _Reader) -> Proposal:
    header = r.blob()
    payload = r.blob()
    metadata = r.blob()
    vseq = r.u64()
    return Proposal(
        header=header, payload=payload, metadata=metadata, verification_sequence=vseq
    )


def _w_opt_proposal(w: _Writer, p: Optional[Proposal]) -> None:
    w.boolean(p is not None)
    if p is not None:
        _w_proposal(w, p)


def _r_opt_proposal(r: _Reader) -> Optional[Proposal]:
    return _r_proposal(r) if r.boolean() else None


def _w_signature(w: _Writer, s: Signature) -> None:
    w.u64(s.id)
    w.blob(s.value)
    w.blob(s.msg)


def _r_signature(r: _Reader) -> Signature:
    sid = r.u64()
    value = r.blob()
    msg = r.blob()
    return Signature(id=sid, value=value, msg=msg)


def _w_quorum_cert_body(w: _Writer, c: QuorumCert) -> None:
    if not (len(c.signer_ids) == len(c.rs) == len(c.aux_index)):
        raise CodecError(
            f"QuorumCert parallel-field length mismatch: "
            f"{len(c.signer_ids)} ids, {len(c.rs)} rs, "
            f"{len(c.aux_index)} aux indices"
        )
    w.seq(c.signer_ids, w.u64)
    w.seq(c.rs, w.blob)
    w.blob(c.s_agg)
    w.seq(c.aux_table, w.blob)
    w.seq(c.aux_index, w.u64)


def _r_quorum_cert_body(r: _Reader) -> QuorumCert:
    signer_ids = r.seq(r.u64)
    rs = r.seq(r.blob)
    s_agg = r.blob()
    aux_table = r.seq(r.blob)
    aux_index = r.seq(r.u64)
    if not (len(signer_ids) == len(rs) == len(aux_index)):
        raise CodecError(
            f"QuorumCert parallel-field length mismatch: "
            f"{len(signer_ids)} ids, {len(rs)} rs, {len(aux_index)} aux indices"
        )
    for i in aux_index:
        if i >= len(aux_table):
            raise CodecError(
                f"QuorumCert aux_index {i} out of range "
                f"(aux_table has {len(aux_table)} entries)"
            )
    return QuorumCert(
        signer_ids=signer_ids,
        rs=rs,
        s_agg=s_agg,
        aux_table=aux_table,
        aux_index=aux_index,
    )


def _w_cert(w: _Writer, cert: Cert) -> None:
    """v2 cert field: a one-byte kind discriminator, then either the v1
    signature-tuple body (kind 0) or a QuorumCert body (kind 1)."""
    if isinstance(cert, QuorumCert):
        w.u8(1)
        _w_quorum_cert_body(w, cert)
    else:
        w.u8(0)
        w.seq(cert, lambda s: _w_signature(w, s))


def _r_cert(r: _Reader) -> Cert:
    kind = r.u8()
    if kind == 0:
        return r.seq(lambda: _r_signature(r))
    if kind == 1:
        return _r_quorum_cert_body(r)
    raise CodecError(f"unknown cert kind {kind}")


def encoded_cert_size(cert: Cert) -> int:
    """Encoded byte size of ONE cert field (kind byte included) — the unit
    the pinned ``*_cert_bytes_total`` counters account in, so wire/WAL/sync
    byte ratios compare cert payloads, not the unrelated message framing
    around them."""
    w = _Writer()
    _w_cert(w, cert)
    return len(w.getvalue())


def _w_view_metadata(w: _Writer, m: ViewMetadata) -> None:
    w.u64(m.view_id)
    w.u64(m.latest_sequence)
    w.u64(m.decisions_in_view)
    w.seq(m.black_list, w.u64)
    w.blob(m.prev_commit_signature_digest)


def _r_view_metadata(r: _Reader) -> ViewMetadata:
    view_id = r.u64()
    latest_sequence = r.u64()
    decisions_in_view = r.u64()
    black_list = r.seq(r.u64)
    digest = r.blob()
    return ViewMetadata(
        view_id=view_id,
        latest_sequence=latest_sequence,
        decisions_in_view=decisions_in_view,
        black_list=black_list,
        prev_commit_signature_digest=digest,
    )


# --- per-message bodies ---------------------------------------------------


def _w_pre_prepare(w: _Writer, m: PrePrepare, version: int = 1) -> None:
    w.u64(m.view)
    w.u64(m.seq)
    _w_proposal(w, m.proposal)
    if version >= 2:
        _w_cert(w, m.prev_commit_signatures)
    else:
        if isinstance(m.prev_commit_signatures, QuorumCert):
            raise CodecError("QuorumCert prev_commit_signatures need wire v2")
        w.seq(m.prev_commit_signatures, lambda s: _w_signature(w, s))


def _r_pre_prepare(r: _Reader, version: int = 1) -> PrePrepare:
    view = r.u64()
    seq = r.u64()
    proposal = _r_proposal(r)
    if version >= 2:
        prev_sigs = _r_cert(r)
    else:
        prev_sigs = r.seq(lambda: _r_signature(r))
    return PrePrepare(
        view=view, seq=seq, proposal=proposal, prev_commit_signatures=prev_sigs
    )


def _w_prepare(w: _Writer, m: Prepare) -> None:
    w.u64(m.view)
    w.u64(m.seq)
    w.text(m.digest)
    w.boolean(m.assist)


def _r_prepare(r: _Reader) -> Prepare:
    view = r.u64()
    seq = r.u64()
    digest = r.text()
    assist = r.boolean()
    return Prepare(view=view, seq=seq, digest=digest, assist=assist)


def _w_commit(w: _Writer, m: Commit) -> None:
    w.u64(m.view)
    w.u64(m.seq)
    w.text(m.digest)
    _w_signature(w, m.signature)
    w.boolean(m.assist)


def _r_commit(r: _Reader) -> Commit:
    view = r.u64()
    seq = r.u64()
    digest = r.text()
    sig = _r_signature(r)
    assist = r.boolean()
    return Commit(view=view, seq=seq, digest=digest, signature=sig, assist=assist)


def _w_view_change(w: _Writer, m: ViewChange) -> None:
    w.u64(m.next_view)
    w.text(m.reason)


def _r_view_change(r: _Reader) -> ViewChange:
    next_view = r.u64()
    reason = r.text()
    return ViewChange(next_view=next_view, reason=reason)


def _w_signed_view_data(w: _Writer, m: SignedViewData) -> None:
    w.blob(m.raw_view_data)
    w.u64(m.signer)
    w.blob(m.signature)


def _r_signed_view_data(r: _Reader) -> SignedViewData:
    raw = r.blob()
    signer = r.u64()
    sig = r.blob()
    return SignedViewData(raw_view_data=raw, signer=signer, signature=sig)


def _w_new_view(w: _Writer, m: NewView) -> None:
    w.seq(m.signed_view_data, lambda s: _w_signed_view_data(w, s))


def _r_new_view(r: _Reader) -> NewView:
    return NewView(signed_view_data=r.seq(lambda: _r_signed_view_data(r)))


def _w_heart_beat(w: _Writer, m: HeartBeat) -> None:
    w.u64(m.view)
    w.u64(m.seq)


def _r_heart_beat(r: _Reader) -> HeartBeat:
    view = r.u64()
    seq = r.u64()
    return HeartBeat(view=view, seq=seq)


def _w_heart_beat_response(w: _Writer, m: HeartBeatResponse) -> None:
    w.u64(m.view)


def _r_heart_beat_response(r: _Reader) -> HeartBeatResponse:
    return HeartBeatResponse(view=r.u64())


def _w_str(w: _Writer, m: StateTransferRequest) -> None:
    pass


def _r_str(r: _Reader) -> StateTransferRequest:
    return StateTransferRequest()


def _w_sts(w: _Writer, m: StateTransferResponse) -> None:
    w.u64(m.view_num)
    w.u64(m.sequence)


def _r_sts(r: _Reader) -> StateTransferResponse:
    view_num = r.u64()
    sequence = r.u64()
    return StateTransferResponse(view_num=view_num, sequence=sequence)


def _w_sync_request(w: _Writer, m: SyncRequest) -> None:
    w.u64(m.from_seq)
    w.u64(m.to_seq)


def _r_sync_request(r: _Reader) -> SyncRequest:
    from_seq = r.u64()
    to_seq = r.u64()
    return SyncRequest(from_seq=from_seq, to_seq=to_seq)


def _w_sync_chunk(w: _Writer, m: SyncChunk, version: int = 1) -> None:
    if len(m.decisions) != len(m.quorum_certs):
        raise CodecError(
            f"SyncChunk decisions/quorum_certs length mismatch: "
            f"{len(m.decisions)} != {len(m.quorum_certs)}"
        )
    w.u64(m.from_seq)
    w.u64(m.height)
    w.seq(m.decisions, lambda p: _w_proposal(w, p))
    if version >= 2:
        w.seq(m.quorum_certs, lambda cert: _w_cert(w, cert))
    else:
        if any(isinstance(c, QuorumCert) for c in m.quorum_certs):
            raise CodecError("QuorumCert endorsements need wire v2")
        w.seq(
            m.quorum_certs,
            lambda cert: w.seq(cert, lambda s: _w_signature(w, s)),
        )


def _r_sync_chunk(r: _Reader, version: int = 1) -> SyncChunk:
    from_seq = r.u64()
    height = r.u64()
    decisions = r.seq(lambda: _r_proposal(r))
    if version >= 2:
        certs = r.seq(lambda: _r_cert(r))
    else:
        certs = r.seq(lambda: r.seq(lambda: _r_signature(r)))
    if len(decisions) != len(certs):
        raise CodecError(
            f"SyncChunk decisions/quorum_certs length mismatch: "
            f"{len(decisions)} != {len(certs)}"
        )
    return SyncChunk(
        from_seq=from_seq, height=height, decisions=decisions, quorum_certs=certs
    )


def _w_sync_snapshot_meta(w: _Writer, m: SyncSnapshotMeta) -> None:
    w.u64(m.height)
    w.text(m.last_digest)


def _r_sync_snapshot_meta(r: _Reader) -> SyncSnapshotMeta:
    height = r.u64()
    last_digest = r.text()
    return SyncSnapshotMeta(height=height, last_digest=last_digest)


def _w_epoch_tagged(w: _Writer, m: EpochTagged) -> None:
    if isinstance(m.msg, EpochTagged):
        raise CodecError("EpochTagged must not nest another EpochTagged")
    w.u64(m.epoch)
    w.blob(encode_message(m.msg))


def _r_epoch_tagged(r: _Reader) -> EpochTagged:
    epoch = r.u64()
    inner = decode_message(r.blob())
    if isinstance(inner, EpochTagged):
        raise CodecError("EpochTagged must not nest another EpochTagged")
    return EpochTagged(epoch=epoch, msg=inner)


def _w_quorum_cert(w: _Writer, m: QuorumCert) -> None:
    _w_quorum_cert_body(w, m)


def _r_quorum_cert(r: _Reader) -> QuorumCert:
    return _r_quorum_cert_body(r)


# Tag assignments mirror the reference's oneof field numbers
# (smartbftprotos/messages.proto:15-26) for easy cross-auditing; tags 11-15
# are ours — the reference has no sync wire protocol (Fabric's block puller
# fills that role outside the library).
_MESSAGE_CODECS: dict[int, tuple[type, Callable, Callable]] = {
    1: (PrePrepare, _w_pre_prepare, _r_pre_prepare),
    2: (Prepare, _w_prepare, _r_prepare),
    3: (Commit, _w_commit, _r_commit),
    4: (ViewChange, _w_view_change, _r_view_change),
    5: (SignedViewData, _w_signed_view_data, _r_signed_view_data),
    6: (NewView, _w_new_view, _r_new_view),
    7: (HeartBeat, _w_heart_beat, _r_heart_beat),
    8: (HeartBeatResponse, _w_heart_beat_response, _r_heart_beat_response),
    9: (StateTransferRequest, _w_str, _r_str),
    10: (StateTransferResponse, _w_sts, _r_sts),
    11: (SyncRequest, _w_sync_request, _r_sync_request),
    12: (SyncChunk, _w_sync_chunk, _r_sync_chunk),
    13: (SyncSnapshotMeta, _w_sync_snapshot_meta, _r_sync_snapshot_meta),
    # 14 is ours: the membership-epoch envelope (no reference counterpart).
    14: (EpochTagged, _w_epoch_tagged, _r_epoch_tagged),
    # 15 is ours: a standalone half-aggregated quorum cert (models/aggregate).
    15: (QuorumCert, _w_quorum_cert, _r_quorum_cert),
}

_TAG_BY_TYPE = {cls: tag for tag, (cls, _, _) in _MESSAGE_CODECS.items()}

# Message kinds whose body layout depends on the envelope version (their
# writers/readers take an extra version argument).
_VERSIONED_WIRE_TYPES = (PrePrepare, SyncChunk)


def _wire_version_for(msg: ConsensusMessage) -> int:
    """Lowest wire version that expresses ``msg`` losslessly.

    Same rule as :func:`_saved_version_for`: v2 is emitted ONLY when a
    half-aggregated QuorumCert is actually present, so cert_mode="full"
    traffic stays bit-for-bit the v1 seed encoding (and remains decodable
    by pre-upgrade binaries).  An EpochTagged envelope stays v1 even when
    its inner message needs v2 — the inner blob is self-versioned.
    """
    if isinstance(msg, QuorumCert):
        return 2
    if isinstance(msg, PrePrepare) and isinstance(
        msg.prev_commit_signatures, QuorumCert
    ):
        return 2
    if isinstance(msg, SyncChunk) and any(
        isinstance(c, QuorumCert) for c in msg.quorum_certs
    ):
        return 2
    return 1


def encode_message(msg: ConsensusMessage) -> bytes:
    """Serialize a consensus message to self-delimiting bytes."""
    tag = _TAG_BY_TYPE.get(type(msg))
    if tag is None:
        raise CodecError(f"not a wire message: {type(msg).__name__}")
    version = _wire_version_for(msg)
    w = _Writer()
    w.u8(version)
    w.u8(_DOMAIN_WIRE)
    w.u8(tag)
    if isinstance(msg, _VERSIONED_WIRE_TYPES):
        _MESSAGE_CODECS[tag][1](w, msg, version)
    else:
        _MESSAGE_CODECS[tag][1](w, msg)
    return w.getvalue()


def decode_message(buf: bytes) -> ConsensusMessage:
    """Parse bytes produced by :func:`encode_message` (any accepted
    version — mixed-version clusters exchange v1 traffic until a
    QuorumCert actually rides a message)."""
    r = _Reader(buf)
    version = r.u8()
    if not 1 <= version <= _WIRE_VERSION:
        raise CodecError(f"unsupported codec version {version}")
    if r.u8() != _DOMAIN_WIRE:
        raise CodecError("not a wire-message encoding (wrong domain byte)")
    tag = r.u8()
    entry = _MESSAGE_CODECS.get(tag)
    if entry is None:
        raise CodecError(f"unknown message tag {tag}")
    if issubclass(entry[0], _VERSIONED_WIRE_TYPES):
        msg = entry[2](r, version)
    else:
        msg = entry[2](r)
    r.expect_end()
    return msg


# --- ViewData (signed payload, not a top-level wire message) --------------


def encode_view_data(vd: ViewData) -> bytes:
    """Serialize ViewData — these bytes are what gets signed and embedded in
    ``SignedViewData.raw_view_data`` (reference viewchanger.go:433-456).

    v2 (emitted only when the last-decision proof is a half-aggregated
    QuorumCert) carries the cert-kind discriminator; full-signature view
    data stays bit-for-bit v1.
    """
    version = (
        2 if isinstance(vd.last_decision_signatures, QuorumCert) else _VERSION
    )
    w = _Writer()
    w.u8(version)
    w.u64(vd.next_view)
    _w_opt_proposal(w, vd.last_decision)
    if version >= 2:
        _w_cert(w, vd.last_decision_signatures)
    else:
        w.seq(vd.last_decision_signatures, lambda s: _w_signature(w, s))
    _w_opt_proposal(w, vd.in_flight_proposal)
    w.boolean(vd.in_flight_prepared)
    return w.getvalue()


def decode_view_data(buf: bytes) -> ViewData:
    r = _Reader(buf)
    version = r.u8()
    if not 1 <= version <= _WIRE_VERSION:
        raise CodecError(f"unsupported codec version {version}")
    next_view = r.u64()
    last_decision = _r_opt_proposal(r)
    if version >= 2:
        last_sigs = _r_cert(r)
    else:
        last_sigs = r.seq(lambda: _r_signature(r))
    in_flight = _r_opt_proposal(r)
    prepared = r.boolean()
    r.expect_end()
    return ViewData(
        next_view=next_view,
        last_decision=last_decision,
        last_decision_signatures=last_sigs,
        in_flight_proposal=in_flight,
        in_flight_prepared=prepared,
    )


def encode_prepares_from(pf: PreparesFrom) -> bytes:
    """Serialize the prepare-sender vouch list (commit signature aux data)."""
    w = _Writer()
    w.u8(_VERSION)
    w.seq(pf.ids, w.u64)
    return w.getvalue()


def decode_prepares_from(buf: bytes) -> PreparesFrom:
    r = _Reader(buf)
    version = r.u8()
    if version != _VERSION:
        raise CodecError(f"unsupported codec version {version}")
    ids = r.seq(r.u64)
    r.expect_end()
    return PreparesFrom(ids=ids)


def encode_view_metadata(m: ViewMetadata) -> bytes:
    """Serialize ViewMetadata — stamped into ``Proposal.metadata``."""
    w = _Writer()
    w.u8(_VERSION)
    _w_view_metadata(w, m)
    return w.getvalue()


def decode_view_metadata(buf: bytes) -> ViewMetadata:
    r = _Reader(buf)
    version = r.u8()
    if version != _VERSION:
        raise CodecError(f"unsupported codec version {version}")
    m = _r_view_metadata(r)
    r.expect_end()
    return m


# --- SavedMessage (WAL records) ------------------------------------------


def _w_proposed_record(w: _Writer, m: ProposedRecord, version: int = 2) -> None:
    # Saved v3 records encode the nested PrePrepare at wire v2 so its
    # prev-commit cert field can hold a QuorumCert.
    _w_pre_prepare(w, m.pre_prepare, 2 if version >= 3 else 1)
    _w_prepare(w, m.prepare)
    if version >= 2:
        w.boolean(m.verified)


def _r_proposed_record(r: _Reader, version: int) -> ProposedRecord:
    pp = _r_pre_prepare(r, 2 if version >= 3 else 1)
    p = _r_prepare(r)
    # v1 records predate the flag; they were only ever written after
    # verification succeeded (the strict verify-then-persist order).
    verified = r.boolean() if version >= 2 else True
    return ProposedRecord(pre_prepare=pp, prepare=p, verified=verified)


def _w_saved_commit(w: _Writer, m: SavedCommit, version: int = 1) -> None:
    _w_commit(w, m.commit)
    if version >= 3:
        w.boolean(m.cert is not None)
        if m.cert is not None:
            _w_quorum_cert_body(w, m.cert)
    elif m.cert is not None:
        raise CodecError("SavedCommit.cert needs saved v3")


def _r_saved_commit(r: _Reader, version: int) -> SavedCommit:
    commit = _r_commit(r)
    cert = None
    if version >= 3 and r.boolean():
        cert = _r_quorum_cert_body(r)
    return SavedCommit(commit=commit, cert=cert)


def _w_saved_new_view(w: _Writer, m: SavedNewView) -> None:
    _w_view_metadata(w, m.view_metadata)


def _r_saved_new_view(r: _Reader, version: int) -> SavedNewView:
    return SavedNewView(view_metadata=_r_view_metadata(r))


def _w_saved_view_change(w: _Writer, m: SavedViewChange) -> None:
    _w_view_change(w, m.view_change)


def _r_saved_view_change(r: _Reader, version: int) -> SavedViewChange:
    return SavedViewChange(view_change=_r_view_change(r))


def _w_saved_twopc(w: _Writer, m: SavedTwoPC) -> None:
    if m.phase not in TWOPC_PHASES:
        raise CodecError(f"unknown 2PC phase {m.phase!r}")
    w.text(m.txid)
    w.u8(TWOPC_PHASES.index(m.phase))
    w.seq(m.groups, w.text)
    w.text(m.coordinator)


def _r_saved_twopc(r: _Reader, version: int) -> SavedTwoPC:
    txid = r.text()
    phase_idx = r.u8()
    if phase_idx >= len(TWOPC_PHASES):
        raise CodecError(f"unknown 2PC phase index {phase_idx}")
    groups = r.seq(r.text)
    coordinator = r.text()
    return SavedTwoPC(
        txid=txid, phase=TWOPC_PHASES[phase_idx],
        groups=tuple(groups), coordinator=coordinator,
    )


# Tags mirror the SavedMessage oneof (smartbftprotos/messages.proto:113-120).
# Readers take (reader, envelope_version) — the WAL-record domain is
# versioned independently of the wire messages so a record-layout change
# cannot invalidate inter-replica traffic (and vice versa).
# v2: ProposedRecord gained `verified` (v1 record => True).
# v3: half-aggregated quorum certs — SavedCommit gained an optional
#     QuorumCert and ProposedRecord's nested PrePrepare is encoded at wire
#     v2 so its prev-commit field can carry one.
# v4: cross-group sharding — SavedTwoPC (tag 5) persists a 2PC participant
#     transition; only SavedTwoPC records emit v4, so every WAL without
#     cross-group transactions stays bit-for-bit its pre-groups encoding.
_SAVED_VERSION = 4

_SAVED_CODECS: dict[int, tuple[type, Callable, Callable]] = {
    1: (ProposedRecord, _w_proposed_record, _r_proposed_record),
    2: (SavedCommit, _w_saved_commit, _r_saved_commit),
    3: (SavedNewView, _w_saved_new_view, _r_saved_new_view),
    4: (SavedViewChange, _w_saved_view_change, _r_saved_view_change),
    5: (SavedTwoPC, _w_saved_twopc, _r_saved_twopc),
}

_SAVED_TAG_BY_TYPE = {cls: tag for tag, (cls, _, _) in _SAVED_CODECS.items()}


def _saved_version_for(msg: SavedMessage) -> int:
    """Lowest record version that expresses ``msg`` losslessly.

    Records stay at v1 whenever possible (a ProposedRecord's ``verified``
    flag defaults to True under v1 semantics, and the other three kinds are
    unchanged since v1), so a binary ROLLBACK after an upgrade still finds
    a WAL it can decode — the crash-recovery pin must survive downgrades,
    not just upgrades.  Only the rare mid-verification crash window
    (``verified=False``) needs v2, and such a record is rewritten at the
    next truncation anyway.  Only cert_mode="half-agg" records actually
    carrying a QuorumCert need v3, so full-mode WALs stay bit-for-bit the
    seed encoding.
    """
    if isinstance(msg, ProposedRecord):
        if isinstance(msg.pre_prepare.prev_commit_signatures, QuorumCert):
            return 3
        if not msg.verified:
            return 2
        return 1
    if isinstance(msg, SavedCommit) and msg.cert is not None:
        return 3
    if isinstance(msg, SavedTwoPC):
        # The record kind itself is new in v4; there is no older encoding
        # that could express it.
        return 4
    return 1


def encode_saved(msg: SavedMessage) -> bytes:
    """Serialize a WAL record."""
    tag = _SAVED_TAG_BY_TYPE.get(type(msg))
    if tag is None:
        raise CodecError(f"not a saved message: {type(msg).__name__}")
    version = _saved_version_for(msg)
    w = _Writer()
    w.u8(version)
    w.u8(_DOMAIN_SAVED)
    w.u8(tag)
    if isinstance(msg, ProposedRecord):
        _w_proposed_record(w, msg, version)
    elif isinstance(msg, SavedCommit):
        _w_saved_commit(w, msg, version)
    else:
        _SAVED_CODECS[tag][1](w, msg)
    return w.getvalue()


def decode_saved(buf: bytes) -> SavedMessage:
    """Parse bytes produced by :func:`encode_saved` (any accepted version —
    a WAL written before an upgrade must keep restoring, or the crash-
    recovery pin it carries is silently lost)."""
    r = _Reader(buf)
    version = r.u8()
    if not 1 <= version <= _SAVED_VERSION:
        raise CodecError(f"unsupported codec version {version}")
    if r.u8() != _DOMAIN_SAVED:
        raise CodecError("not a WAL-record encoding (wrong domain byte)")
    tag = r.u8()
    entry = _SAVED_CODECS.get(tag)
    if entry is None:
        raise CodecError(f"unknown saved-message tag {tag}")
    msg = entry[2](r, version)
    r.expect_end()
    return msg


__all__ = [
    "CodecError",
    "encode_message",
    "decode_message",
    "encode_view_data",
    "decode_view_data",
    "encode_prepares_from",
    "decode_prepares_from",
    "encode_view_metadata",
    "decode_view_metadata",
    "encode_saved",
    "decode_saved",
    "encoded_cert_size",
]
