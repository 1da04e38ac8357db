"""Catch-up server: serves ranged decision chunks out of a DecisionStore.

Stateless per request (any replica can answer any range it holds), with two
flow-control caps so one lagging peer cannot make the server materialize an
unbounded reply: a decision-count cap and an encoded-bytes cap per chunk.
The client keeps asking for the next range until it reaches its target — the
``height`` echoed in every chunk tells it how far the server's chain extends
without a second metadata probe.

The PyTorch port's copy of ``consensus_tpu/sync/server.py``, its imports renamed.
"""

from __future__ import annotations

from consensus_tpu_torch.sync.store import DecisionStore
from consensus_tpu_torch.types import Decision, as_cert
from consensus_tpu_torch.wire.codec import decode_message, encode_message
from consensus_tpu_torch.wire.messages import SyncChunk, SyncRequest, SyncSnapshotMeta

#: Per-signature framing overhead in the wire encoding (id + 2 length
#: prefixes); used by the cheap size estimate below.
_SIG_OVERHEAD = 8 + 4 + 4
_PROPOSAL_OVERHEAD = 4 * 3 + 8


def _decision_wire_size(d: Decision) -> int:
    """Close upper-bound estimate of a decision's encoded size — cheap
    (no serialization) and monotone, which is all flow control needs."""
    p = d.proposal
    size = (
        _PROPOSAL_OVERHEAD
        + len(p.header)
        + len(p.payload)
        + len(p.metadata)
        + 4  # cert count prefix
    )
    for sig in d.signatures:
        size += _SIG_OVERHEAD + len(sig.value) + len(sig.msg)
    return size


class SyncServer:
    """Answers :class:`SyncRequest` with :class:`SyncChunk` /
    :class:`SyncSnapshotMeta` over whatever byte transport the caller runs.
    """

    def __init__(
        self,
        store: DecisionStore,
        *,
        max_chunk_decisions: int = 32,
        max_chunk_bytes: int = 1 << 20,
    ) -> None:
        if max_chunk_decisions < 1:
            raise ValueError("max_chunk_decisions must be >= 1")
        self.store = store
        self.max_chunk_decisions = max_chunk_decisions
        self.max_chunk_bytes = max_chunk_bytes
        #: Served-chunk counter (observability / tests).
        self.chunks_served = 0

    def handle(self, request: SyncRequest):
        """One request, one reply.  ``to_seq == 0`` or a range starting
        above our height is a metadata probe."""
        height = self.store.height()
        if request.to_seq == 0 or request.from_seq > height:
            tip = self.store.last()
            return SyncSnapshotMeta(
                height=height,
                last_digest=tip.proposal.digest() if tip is not None else "",
            )
        from_seq = max(1, request.from_seq)
        to_seq = min(request.to_seq, height, from_seq + self.max_chunk_decisions - 1)
        decisions: list = []
        certs: list = []
        budget = self.max_chunk_bytes
        for d in self.store.read(from_seq, to_seq):
            size = _decision_wire_size(d)
            # Always serve at least one decision, or a pathologically large
            # single decision could never be transferred at all.
            if decisions and size > budget:
                break
            budget -= size
            decisions.append(d.proposal)
            # Serve the cert in its stored format: a half-aggregated
            # QuorumCert passes through intact, a signature list as a tuple.
            certs.append(as_cert(d.signatures))
        self.chunks_served += 1
        return SyncChunk(
            from_seq=from_seq,
            height=height,
            decisions=tuple(decisions),
            quorum_certs=tuple(certs),
        )

    def handle_bytes(self, raw: bytes) -> bytes:
        """Wire entry point: decode the request, encode the reply.  Raises
        :class:`consensus_tpu_torch.wire.codec.CodecError` on malformed input —
        transports surface that as a failed fetch."""
        request = decode_message(raw)
        if not isinstance(request, SyncRequest):
            from consensus_tpu_torch.wire.codec import CodecError

            raise CodecError(
                f"sync server got {type(request).__name__}, want SyncRequest"
            )
        return encode_message(self.handle(request))


__all__ = ["SyncServer"]
