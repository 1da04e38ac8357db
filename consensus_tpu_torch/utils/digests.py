"""Deterministic digests binding signature sets into proposal metadata.

Parity: reference internal/bft/util.go:564-586 (CommitSignaturesDigest,
ASN.1 + SHA-256 there; here a length-prefixed encoding + SHA-256 — the wire
is ours, only the binding property matters: the digest commits to the exact
ordered (signer, value, msg) triples).

The PyTorch port's copy of ``consensus_tpu/utils/digests.py``, its imports renamed.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Sequence

from consensus_tpu_torch.types import Signature


def commit_signatures_digest(sigs: Sequence[Signature]) -> bytes:
    """Digest of an ordered list of commit signatures; empty input -> b''.

    A half-aggregated ``types.QuorumCert`` (duck-typed via its ``s_agg``
    attribute) is bound through its component view — ordered
    (signer, R, aux) triples — PLUS the aggregate scalar, so two certs over
    the same components but different ``s_agg`` bytes digest differently.
    """
    if not sigs:
        return b""
    h = hashlib.sha256()
    for sig in sigs:
        h.update(struct.pack(">Q", sig.id))
        h.update(struct.pack(">Q", len(sig.value)))
        h.update(sig.value)
        h.update(struct.pack(">Q", len(sig.msg)))
        h.update(sig.msg)
    s_agg = getattr(sigs, "s_agg", None)
    if s_agg is not None:
        h.update(b"\x00s_agg")
        h.update(struct.pack(">Q", len(s_agg)))
        h.update(s_agg)
    return h.digest()


__all__ = ["commit_signatures_digest"]
