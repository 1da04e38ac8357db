"""The port's wire codec against the JAX package's: byte for byte.

A TPU replica and a GPU replica exchange these bytes, so every message
class of ``wire/messages.py`` (the consensus messages, the WAL records and
the signed payloads) is built with the same seeded random fields in both
packages, and must encode to identical bytes; each package must decode the
other's bytes to equal fields; and truncated or corrupted frames must fail
the same way (the same error class) or decode to the same fields in both.
Tolerance 0: everything here is bytes and integers.
"""

from __future__ import annotations

import dataclasses
import random
from types import SimpleNamespace

import pytest

import consensus_tpu.types as jtypes
import consensus_tpu.wire as jwire
import consensus_tpu_torch.types as ttypes
import consensus_tpu_torch.wire as twire


def _namespace(types_mod, wire_mod) -> SimpleNamespace:
    public = lambda m: {k: v for k, v in vars(m).items() if not k.startswith("_")}  # noqa: E731
    return SimpleNamespace(**{**public(types_mod), **public(wire_mod)})


JAX = _namespace(jtypes, jwire)
PORT = _namespace(ttypes, twire)

#: (codec family, encode, decode) names in ``wire``.
CODECS = {
    "message": ("encode_message", "decode_message"),
    "saved": ("encode_saved", "decode_saved"),
    "view_data": ("encode_view_data", "decode_view_data"),
    "prepares_from": ("encode_prepares_from", "decode_prepares_from"),
    "view_metadata": ("encode_view_metadata", "decode_view_metadata"),
}


def _blob(rng: random.Random, lo: int = 0, hi: int = 40) -> bytes:
    return rng.randbytes(rng.randrange(lo, hi + 1))


def _u64(rng: random.Random) -> int:
    return rng.choice((0, 1, rng.randrange(2**16), rng.randrange(2**64)))


def _text(rng: random.Random) -> str:
    return "".join(rng.choice("abcxyz-_0189é€") for _ in range(rng.randrange(0, 12)))


def _digest(rng: random.Random) -> str:
    return rng.randbytes(32).hex()


def _proposal(ns, rng):
    return ns.Proposal(
        payload=_blob(rng), header=_blob(rng), metadata=_blob(rng),
        verification_sequence=_u64(rng),
    )


def _signature(ns, rng):
    return ns.Signature(id=_u64(rng), value=rng.randbytes(64), msg=_blob(rng, 0, 12))


def _signatures(ns, rng):
    return tuple(_signature(ns, rng) for _ in range(rng.randrange(0, 6)))


def _quorum_cert(ns, rng):
    n = rng.randrange(1, 6)
    table = tuple(_blob(rng, 0, 8) for _ in range(rng.randrange(1, 3)))
    return ns.QuorumCert(
        signer_ids=tuple(_u64(rng) for _ in range(n)),
        rs=tuple(rng.randbytes(32) for _ in range(n)),
        s_agg=rng.randbytes(32),
        aux_table=table,
        aux_index=tuple(rng.randrange(len(table)) for _ in range(n)),
    )


def _view_metadata(ns, rng):
    return ns.ViewMetadata(
        view_id=_u64(rng), latest_sequence=_u64(rng), decisions_in_view=_u64(rng),
        black_list=tuple(_u64(rng) for _ in range(rng.randrange(0, 4))),
        prev_commit_signature_digest=_blob(rng, 0, 32),
    )


def _pre_prepare(ns, rng, cert=False):
    return ns.PrePrepare(
        view=_u64(rng), seq=_u64(rng), proposal=_proposal(ns, rng),
        prev_commit_signatures=_quorum_cert(ns, rng) if cert else _signatures(ns, rng),
    )


def _prepare(ns, rng):
    return ns.Prepare(view=_u64(rng), seq=_u64(rng), digest=_digest(rng),
                      assist=rng.random() < 0.5)


def _commit(ns, rng):
    return ns.Commit(view=_u64(rng), seq=_u64(rng), digest=_digest(rng),
                     signature=_signature(ns, rng), assist=rng.random() < 0.5)


def _view_change(ns, rng):
    return ns.ViewChange(next_view=_u64(rng), reason=_text(rng))


def _view_data(ns, rng, cert=False):
    return ns.ViewData(
        next_view=_u64(rng),
        last_decision=_proposal(ns, rng) if rng.random() < 0.7 else None,
        last_decision_signatures=_quorum_cert(ns, rng) if cert else _signatures(ns, rng),
        in_flight_proposal=_proposal(ns, rng) if rng.random() < 0.5 else None,
        in_flight_prepared=rng.random() < 0.5,
    )


def _signed_view_data(ns, rng):
    return ns.SignedViewData(raw_view_data=_blob(rng, 0, 80), signer=_u64(rng),
                             signature=rng.randbytes(64))


def _sync_chunk(ns, rng, cert=False):
    n = rng.randrange(0, 4)
    return ns.SyncChunk(
        from_seq=_u64(rng), height=_u64(rng),
        decisions=tuple(_proposal(ns, rng) for _ in range(n)),
        quorum_certs=tuple(
            _quorum_cert(ns, rng) if cert and i % 2 == 0 else _signatures(ns, rng)
            for i in range(n)
        ),
    )


#: case id -> (codec family, builder(ns, rng)).
BUILDERS = {
    "QuorumCert": ("message", _quorum_cert),
    "PrePrepare": ("message", _pre_prepare),
    "PrePrepare-halfagg": ("message", lambda ns, rng: _pre_prepare(ns, rng, cert=True)),
    "Prepare": ("message", _prepare),
    "Commit": ("message", _commit),
    "ViewChange": ("message", _view_change),
    "SignedViewData": ("message", _signed_view_data),
    "NewView": ("message", lambda ns, rng: ns.NewView(
        signed_view_data=tuple(_signed_view_data(ns, rng) for _ in range(rng.randrange(0, 4))))),
    "HeartBeat": ("message", lambda ns, rng: ns.HeartBeat(view=_u64(rng), seq=_u64(rng))),
    "HeartBeatResponse": ("message", lambda ns, rng: ns.HeartBeatResponse(view=_u64(rng))),
    "StateTransferRequest": ("message", lambda ns, rng: ns.StateTransferRequest()),
    "StateTransferResponse": ("message", lambda ns, rng: ns.StateTransferResponse(
        view_num=_u64(rng), sequence=_u64(rng))),
    "SyncRequest": ("message", lambda ns, rng: ns.SyncRequest(from_seq=_u64(rng), to_seq=_u64(rng))),
    "SyncChunk": ("message", _sync_chunk),
    "SyncChunk-halfagg": ("message", lambda ns, rng: _sync_chunk(ns, rng, cert=True)),
    "SyncSnapshotMeta": ("message", lambda ns, rng: ns.SyncSnapshotMeta(
        height=_u64(rng), last_digest=_digest(rng))),
    "EpochTagged": ("message", lambda ns, rng: ns.EpochTagged(epoch=_u64(rng), msg=_commit(ns, rng))),
    "ProposedRecord": ("saved", lambda ns, rng: ns.ProposedRecord(
        pre_prepare=_pre_prepare(ns, rng), prepare=_prepare(ns, rng), verified=True)),
    "ProposedRecord-unverified": ("saved", lambda ns, rng: ns.ProposedRecord(
        pre_prepare=_pre_prepare(ns, rng), prepare=_prepare(ns, rng), verified=False)),
    "ProposedRecord-halfagg": ("saved", lambda ns, rng: ns.ProposedRecord(
        pre_prepare=_pre_prepare(ns, rng, cert=True), prepare=_prepare(ns, rng))),
    "SavedCommit": ("saved", lambda ns, rng: ns.SavedCommit(commit=_commit(ns, rng))),
    "SavedCommit-cert": ("saved", lambda ns, rng: ns.SavedCommit(
        commit=_commit(ns, rng), cert=_quorum_cert(ns, rng))),
    "SavedNewView": ("saved", lambda ns, rng: ns.SavedNewView(view_metadata=_view_metadata(ns, rng))),
    "SavedViewChange": ("saved", lambda ns, rng: ns.SavedViewChange(view_change=_view_change(ns, rng))),
    "SavedTwoPC": ("saved", lambda ns, rng: ns.SavedTwoPC(
        txid=_text(rng), phase=rng.choice(ns.TWOPC_PHASES),
        groups=tuple(_text(rng) for _ in range(rng.randrange(0, 4))), coordinator=_text(rng))),
    "ViewData": ("view_data", _view_data),
    "ViewData-halfagg": ("view_data", lambda ns, rng: _view_data(ns, rng, cert=True)),
    "PreparesFrom": ("prepares_from", lambda ns, rng: ns.PreparesFrom(
        ids=tuple(_u64(rng) for _ in range(rng.randrange(0, 6))))),
    "ViewMetadata": ("view_metadata", _view_metadata),
}

SEEDS = (0, 1, 2, 3)


def plain(obj):
    """A package-independent value: the class name and fields of a
    dataclass, recursively; tuples stay tuples."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, plain(getattr(obj, f.name))) for f in dataclasses.fields(obj)
        )
    if isinstance(obj, (tuple, list)):
        return tuple(plain(x) for x in obj)
    return obj


def _outcome(decode, buf: bytes):
    try:
        return ("ok", plain(decode(buf)))
    except Exception as exc:  # the class is what is compared
        return ("error", type(exc).__name__)


def _corruptions(buf: bytes, rng: random.Random) -> list[bytes]:
    """Truncations at every length up to 64 and at random cut points, one
    extra trailing byte, and single-byte flips and overwrites."""
    out = [buf[:n] for n in range(min(len(buf), 64))]
    out += [buf[:rng.randrange(len(buf))] for _ in range(8)]
    out.append(buf + b"\x00")
    for _ in range(24):
        i = rng.randrange(len(buf))
        out.append(buf[:i] + bytes([buf[i] ^ (1 << rng.randrange(8))]) + buf[i + 1:])
        out.append(buf[:i] + bytes([rng.choice((0x00, 0xFF, 0x02, 0x7F))]) + buf[i + 1:])
    return out


@pytest.mark.parametrize("case", sorted(BUILDERS))
def test_every_message_class_is_byte_identical_across_packages(case):
    family, build = BUILDERS[case]
    enc, dec = CODECS[family]
    for seed in SEEDS:
        jmsg = build(JAX, random.Random(seed))
        tmsg = build(PORT, random.Random(seed))
        assert type(jmsg).__name__ == type(tmsg).__name__
        assert plain(jmsg) == plain(tmsg)
        jbytes = getattr(jwire, enc)(jmsg)
        tbytes = getattr(twire, enc)(tmsg)
        assert tbytes == jbytes, f"{case} seed {seed}: encodings differ"
        # Each package decodes the other's bytes to the same fields.
        assert plain(getattr(twire, dec)(jbytes)) == plain(jmsg)
        assert plain(getattr(jwire, dec)(tbytes)) == plain(tmsg)
        # Malformed frames: the same error class, or the same fields.
        rng = random.Random(1000 + seed)
        for bad in _corruptions(jbytes, rng):
            assert _outcome(getattr(twire, dec), bad) == _outcome(getattr(jwire, dec), bad), (
                f"{case} seed {seed}: packages disagree on {bad.hex()}"
            )


def test_message_classes_are_all_covered():
    names = {c.split("-")[0] for c in BUILDERS}
    wire_classes = {
        n for n, v in vars(twire).items()
        if isinstance(v, type) and dataclasses.is_dataclass(v)
    }
    assert wire_classes <= names, wire_classes - names
    assert set(twire.__all__) == set(jwire.__all__)
