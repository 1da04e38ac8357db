"""Deterministic structure-aware wire fuzzer.

A Byzantine peer controls every byte on the wire, so the codec's contract
is binary: ANY input either decodes to a message that re-encodes
canonically, or raises :class:`~consensus_tpu_torch.wire.codec.CodecError` —
never another exception type, never a hang, never an allocation
proportional to a lied-about length field.

This module enforces that contract without a ``hypothesis`` dependency
(the old fuzz tests silently skipped wherever the package was absent —
which was every CI environment that mattered).  Everything is driven by
``random.Random(seed)``:

* the **seed corpus** is one real encoding per codec case — every wire
  tag 1–15 and every saved tag 1–5, including the version-dependent
  layouts (wire v2 cert-carrying PrePrepare/SyncChunk/QuorumCert, saved
  v2 unverified records, saved v3 cert-carrying records, saved v4 2PC
  records) — produced by the codec itself, so the fuzzer can never drift
  from the format it is attacking;
* **mutation operators** (:data:`MUTATION_OPERATORS`) are structure-aware:
  truncation, bit flips, length-field lies, tag swaps, envelope nesting,
  field repetition, and huge-length headers that probe the
  allocation-before-validation class of bug specifically;
* the run is **byte-identical per seed**: :class:`FuzzReport` carries a
  SHA-256 over the corpus and over every mutated frame in generation
  order, so two same-seed runs must produce equal digests (pinned by
  tests/test_fuzz.py).

No wall clock, no I/O — pure bytes in, verdicts out.

The PyTorch port's copy of ``consensus_tpu/testing/fuzz.py``, its imports renamed.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
import struct
from typing import Callable, Dict, List, Optional, Tuple

from consensus_tpu_torch.types import Proposal, QuorumCert, Signature
from consensus_tpu_torch.wire.codec import (
    CodecError,
    decode_message,
    decode_saved,
    encode_message,
    encode_saved,
)
from consensus_tpu_torch.wire.messages import (
    Commit,
    EpochTagged,
    HeartBeat,
    HeartBeatResponse,
    NewView,
    PrePrepare,
    Prepare,
    ProposedRecord,
    SavedCommit,
    SavedNewView,
    SavedTwoPC,
    SavedViewChange,
    SignedViewData,
    StateTransferRequest,
    StateTransferResponse,
    SyncChunk,
    SyncRequest,
    SyncSnapshotMeta,
    ViewChange,
    ViewMetadata,
)

MUTATION_OPERATORS = (
    "truncate",
    "bit_flip",
    "length_lie",
    "tag_swap",
    "envelope_nest",
    "field_repeat",
    "huge_length",
)

_PROPOSAL = Proposal(
    header=b"hdr", payload=b"batch-bytes", metadata=b"md",
    verification_sequence=7,
)
_SIG = Signature(id=3, value=b"\x01\x02", msg=b"aux")
_BIG_SIG = Signature(id=2**63 + 5, value=b"v" * 64, msg=b"")
_CERT = QuorumCert(
    signer_ids=(1, 2, 3),
    rs=(b"\x11" * 32, b"\x22" * 32, b"\x33" * 32),
    s_agg=b"\x44" * 32,
    aux_table=(b"aux-a", b"aux-b"),
    aux_index=(0, 1, 0),
)
_PRE_PREPARE_V1 = PrePrepare(
    view=1, seq=2, proposal=_PROPOSAL,
    prev_commit_signatures=(_SIG, _BIG_SIG),
)
_PRE_PREPARE_V2 = PrePrepare(
    view=1, seq=2, proposal=_PROPOSAL, prev_commit_signatures=_CERT
)
_COMMIT = Commit(view=9, seq=10, digest="ff00", signature=_SIG)
_VIEW_METADATA = ViewMetadata(
    view_id=4, latest_sequence=17, decisions_in_view=2, black_list=(3, 9),
    prev_commit_signature_digest=b"\xaa" * 32,
)

#: Every codec case the corpus seeds from: (key, encoder, message).  Keys
#: are stable identifiers — tests assert the tag coverage against the
#: codec's own tables, so a new message kind that forgets to register here
#: fails loudly.
_WIRE_CASES: Tuple[Tuple[str, object], ...] = (
    ("wire/tag01/v1/PrePrepare", _PRE_PREPARE_V1),
    ("wire/tag01/v2/PrePrepare", _PRE_PREPARE_V2),
    ("wire/tag02/v1/Prepare", Prepare(view=1, seq=2, digest="abcd", assist=True)),
    ("wire/tag03/v1/Commit", _COMMIT),
    ("wire/tag04/v1/ViewChange", ViewChange(next_view=4, reason="heartbeat timeout")),
    ("wire/tag05/v1/SignedViewData",
     SignedViewData(raw_view_data=b"vd-bytes", signer=2, signature=b"s")),
    ("wire/tag06/v1/NewView", NewView(signed_view_data=(
        SignedViewData(raw_view_data=b"a", signer=1, signature=b"x"),
        SignedViewData(raw_view_data=b"b", signer=2, signature=b"y"),
    ))),
    ("wire/tag07/v1/HeartBeat", HeartBeat(view=3, seq=11)),
    ("wire/tag08/v1/HeartBeatResponse", HeartBeatResponse(view=5)),
    ("wire/tag09/v1/StateTransferRequest", StateTransferRequest()),
    ("wire/tag10/v1/StateTransferResponse",
     StateTransferResponse(view_num=2, sequence=30)),
    ("wire/tag11/v1/SyncRequest", SyncRequest(from_seq=1, to_seq=9)),
    ("wire/tag12/v1/SyncChunk", SyncChunk(
        from_seq=1, height=2, decisions=(_PROPOSAL, _PROPOSAL),
        quorum_certs=((_SIG,), (_SIG, _BIG_SIG)),
    )),
    ("wire/tag12/v2/SyncChunk", SyncChunk(
        from_seq=1, height=2, decisions=(_PROPOSAL,), quorum_certs=(_CERT,),
    )),
    ("wire/tag13/v1/SyncSnapshotMeta",
     SyncSnapshotMeta(height=40, last_digest="deadbeef")),
    ("wire/tag14/v1/EpochTagged", EpochTagged(epoch=6, msg=HeartBeat(view=3, seq=11))),
    ("wire/tag15/v2/QuorumCert", _CERT),
)

_SAVED_CASES: Tuple[Tuple[str, object], ...] = (
    ("saved/tag01/v1/ProposedRecord", ProposedRecord(
        pre_prepare=PrePrepare(view=1, seq=2, proposal=_PROPOSAL),
        prepare=Prepare(view=1, seq=2, digest=_PROPOSAL.digest()),
    )),
    ("saved/tag01/v2/ProposedRecord", ProposedRecord(
        pre_prepare=PrePrepare(view=1, seq=2, proposal=_PROPOSAL),
        prepare=Prepare(view=1, seq=2, digest=_PROPOSAL.digest()),
        verified=False,
    )),
    ("saved/tag01/v3/ProposedRecord", ProposedRecord(
        pre_prepare=_PRE_PREPARE_V2,
        prepare=Prepare(view=1, seq=2, digest=_PROPOSAL.digest()),
    )),
    ("saved/tag02/v1/SavedCommit", SavedCommit(commit=_COMMIT)),
    ("saved/tag02/v3/SavedCommit", SavedCommit(commit=_COMMIT, cert=_CERT)),
    ("saved/tag03/v1/SavedNewView", SavedNewView(view_metadata=_VIEW_METADATA)),
    ("saved/tag04/v1/SavedViewChange",
     SavedViewChange(view_change=ViewChange(next_view=6, reason=""))),
    ("saved/tag05/v4/SavedTwoPC", SavedTwoPC(
        txid="tx-7", phase="prepared", groups=("g0", "g1"), coordinator="g0",
    )),
)


def seed_corpus() -> Dict[str, bytes]:
    """Real encodings of every codec case, keyed by the stable case id.
    Deterministic by construction — the codec is deterministic and the
    exemplar messages are module constants."""
    corpus: Dict[str, bytes] = {}
    for key, msg in _WIRE_CASES:
        corpus[key] = encode_message(msg)
    for key, msg in _SAVED_CASES:
        corpus[key] = encode_saved(msg)
    return corpus


# --- mutation operators ----------------------------------------------------


def _op_truncate(rng: random.Random, base: bytes) -> bytes:
    if not base:
        return base
    return base[: rng.randrange(len(base))]


def _op_bit_flip(rng: random.Random, base: bytes) -> bytes:
    if not base:
        return base
    raw = bytearray(base)
    for _ in range(rng.randint(1, 8)):
        raw[rng.randrange(len(raw))] ^= 1 << rng.randrange(8)
    return bytes(raw)


def _op_length_lie(rng: random.Random, base: bytes) -> bytes:
    """Overwrite 4 bytes somewhere with a lying u32 — the codec's length
    prefixes live at data-dependent offsets, so a random placement hits
    blob/seq counts often enough while also exercising misaligned lies."""
    if len(base) < 4:
        return base + b"\xff\xff\xff\xff"
    raw = bytearray(base)
    pos = rng.randrange(len(raw) - 3)
    lie = rng.choice(
        (0, 1, len(base), len(base) * 2, 0xFFFF, 0x7FFFFFFF, 0xFFFFFFFF)
    )
    raw[pos:pos + 4] = struct.pack(">I", lie)
    return bytes(raw)


def _op_tag_swap(rng: random.Random, base: bytes) -> bytes:
    """Rewrite an envelope byte (version, domain, or tag) — cross-domain
    and unknown-tag probes."""
    if len(base) < 3:
        return base
    raw = bytearray(base)
    raw[rng.randrange(3)] = rng.randrange(256)
    return bytes(raw)


def _op_envelope_nest(rng: random.Random, base: bytes) -> bytes:
    """Wrap the frame as the inner blob of a synthetic EpochTagged
    envelope (tag 14), or double the envelope header in place.  A valid
    wire frame nested this way must decode and round-trip; a nested
    EpochTagged must be rejected (the codec forbids two levels)."""
    if rng.random() < 0.5:
        epoch = rng.randrange(2**32)
        return (
            bytes((1, 0x57, 14))
            + struct.pack(">Q", epoch)
            + struct.pack(">I", len(base))
            + base
        )
    return base[:3] + base


def _op_field_repeat(rng: random.Random, base: bytes) -> bytes:
    if len(base) < 2:
        return base + base
    i = rng.randrange(len(base))
    j = rng.randrange(len(base))
    lo, hi = min(i, j), max(i, j) + 1
    return base[:hi] + base[lo:hi] + base[hi:]


def _op_huge_length(rng: random.Random, base: bytes) -> bytes:
    """Plant a 2^31..2^32-1 length header: the allocation-before-
    validation probe.  A codec that trusts it would try to materialize
    gigabytes; ours must raise CodecError from its have-vs-need check."""
    raw = bytearray(base + b"\x00" * 8)
    pos = rng.randrange(len(raw) - 7)
    raw[pos:pos + 4] = struct.pack(
        ">I", rng.choice((2**31, 2**31 + 1, 2**32 - 1))
    )
    return bytes(raw)


_OPERATOR_FNS: Dict[str, Callable[[random.Random, bytes], bytes]] = {
    "truncate": _op_truncate,
    "bit_flip": _op_bit_flip,
    "length_lie": _op_length_lie,
    "tag_swap": _op_tag_swap,
    "envelope_nest": _op_envelope_nest,
    "field_repeat": _op_field_repeat,
    "huge_length": _op_huge_length,
}


def mutate(rng: random.Random, base: bytes, op: str) -> bytes:
    """Apply one named operator; unknown names fail loudly."""
    fn = _OPERATOR_FNS.get(op)
    if fn is None:
        raise ValueError(f"unknown mutation operator {op!r}")
    return fn(rng, base)


# --- the oracle ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FuzzEscape:
    """One oracle violation: an input whose decode (or re-encode) raised
    something other than CodecError, or round-tripped non-canonically."""

    case: str
    op: str
    frame_hex: str
    error: str


@dataclasses.dataclass(frozen=True)
class FuzzReport:
    seed: int
    frames: int
    decoded: int
    rejected: int
    escapes: Tuple[FuzzEscape, ...]
    corpus_digest: str
    stream_digest: str
    frames_per_case: Dict[str, int]

    def ok(self) -> bool:
        return not self.escapes


def check_frame(buf: bytes, *, saved: bool = False) -> Optional[str]:
    """The oracle for one frame: None when the contract held (decoded
    canonically or rejected with CodecError), else a description of the
    escape."""
    decode = decode_saved if saved else decode_message
    encode = encode_saved if saved else encode_message
    try:
        msg = decode(buf)
    except CodecError:
        return None
    except Exception as exc:  # the contract: CodecError or nothing
        return f"decode escaped with {type(exc).__name__}: {exc}"
    try:
        again = decode(encode(msg))
    except Exception as exc:
        return f"re-encode of decoded message failed: {type(exc).__name__}: {exc}"
    if again != msg:
        return "non-canonical round-trip"
    return None


def run_fuzz(
    seed: int,
    *,
    frames_per_case: int = 10_000,
    operators: Tuple[str, ...] = MUTATION_OPERATORS,
) -> FuzzReport:
    """Fuzz every corpus case with ``frames_per_case`` mutated frames.

    Byte-identical per seed: the mutation stream is a pure function of
    ``(seed, frames_per_case, operators)``; ``stream_digest`` commits to
    every generated frame in order.
    """
    corpus = seed_corpus()
    corpus_hash = hashlib.sha256()
    for key in sorted(corpus):
        corpus_hash.update(key.encode())
        corpus_hash.update(struct.pack(">I", len(corpus[key])))
        corpus_hash.update(corpus[key])
    rng = random.Random(seed)
    stream_hash = hashlib.sha256()
    decoded = rejected = frames = 0
    escapes: List[FuzzEscape] = []
    per_case: Dict[str, int] = {}
    for key in sorted(corpus):
        base = corpus[key]
        saved = key.startswith("saved/")
        for _ in range(frames_per_case):
            op = operators[rng.randrange(len(operators))]
            frame = mutate(rng, base, op)
            if rng.random() < 0.25:  # stacked mutations find deeper paths
                op2 = operators[rng.randrange(len(operators))]
                frame = mutate(rng, frame, op2)
                op = f"{op}+{op2}"
            stream_hash.update(struct.pack(">I", len(frame)))
            stream_hash.update(frame)
            frames += 1
            per_case[key] = per_case.get(key, 0) + 1
            verdict = check_frame(frame, saved=saved)
            if verdict is None:
                # Count decodes vs rejects for the report (re-running the
                # decode is cheaper than widening check_frame's return).
                try:
                    (decode_saved if saved else decode_message)(frame)
                except CodecError:
                    rejected += 1
                else:
                    decoded += 1
            elif len(escapes) < 32:  # enough to debug, bounded to report
                escapes.append(FuzzEscape(
                    case=key, op=op, frame_hex=frame[:512].hex(),
                    error=verdict,
                ))
    return FuzzReport(
        seed=seed,
        frames=frames,
        decoded=decoded,
        rejected=rejected,
        escapes=tuple(escapes),
        corpus_digest=corpus_hash.hexdigest(),
        stream_digest=stream_hash.hexdigest(),
        frames_per_case=per_case,
    )


__all__ = [
    "MUTATION_OPERATORS",
    "FuzzEscape",
    "FuzzReport",
    "check_frame",
    "mutate",
    "run_fuzz",
    "seed_corpus",
]
