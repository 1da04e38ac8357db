"""Value types the signature ports share (torch port of the part of
``consensus_tpu/types.py`` that the crypto slice needs).

``RequestInfo``, ``Proposal``, ``Signature`` and ``QuorumCert`` behave byte
for byte as in the JAX package: ``Proposal.digest`` is the same
length-prefixed SHA-256, so commit messages signed by either package verify
in the other.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass


def _lp(buf: bytes) -> bytes:
    """Length-prefix a byte string (u64 big-endian) for deterministic hashing."""
    return struct.pack(">Q", len(buf)) + buf


@dataclass(frozen=True)
class RequestInfo:
    """Identity of a client request: (client id, request id).

    Parity: reference pkg/types/types.go:44-48.
    """

    client_id: str
    request_id: str

    def key(self) -> str:
        return self.client_id + "\x00" + self.request_id

    def __str__(self) -> str:  # used in logs
        return f"{self.client_id}/{self.request_id}"


@dataclass(frozen=True)
class Proposal:
    """A batch of requests assembled by the leader, plus consensus metadata.

    ``payload`` carries the application batch, ``header`` application framing,
    ``metadata`` the serialized ViewMetadata stamped by the leader, and
    ``verification_sequence`` the membership/config epoch under which the
    proposal must be verified.  Parity: reference pkg/types/types.go:18-30.
    """

    payload: bytes = b""
    header: bytes = b""
    metadata: bytes = b""
    verification_sequence: int = 0

    def digest(self) -> str:
        """Deterministic content digest (hex), cached per instance — the hot
        protocol paths (prepare/commit digest matching, WAL records) call
        this repeatedly on the same immutable proposal.

        Parity: reference pkg/types/types.go:50-62 (ASN.1+SHA-256 there).
        """
        cached = getattr(self, "_digest_cache", None)
        if cached is not None:
            return cached
        h = hashlib.sha256()
        h.update(struct.pack(">Q", self.verification_sequence))
        h.update(_lp(self.header))
        h.update(_lp(self.payload))
        h.update(_lp(self.metadata))
        value = h.hexdigest()
        # Frozen dataclass: bypass the immutability guard for the memo only
        # (not a field — equality/repr/replace are unaffected).
        object.__setattr__(self, "_digest_cache", value)
        return value


@dataclass(frozen=True)
class Signature:
    """A consenter's signature over a proposal.

    ``msg`` is auxiliary signed payload (the reference threads the
    prepare-sender id list through it for blacklist redemption voting —
    internal/bft/view.go:472-481).  Parity: reference pkg/types/types.go:32-37.
    """

    id: int
    value: bytes = b""
    msg: bytes = b""


@dataclass(frozen=True)
class QuorumCert:
    """Half-aggregated Ed25519 quorum certificate (arXiv:2302.00418).

    Instead of n full 64-byte signatures, the cert keeps each signer's
    32-byte nonce commitment ``Rᵢ`` plus ONE aggregate scalar
    ``s_agg = Σ zᵢ·sᵢ mod L`` under transcript-derived Fiat–Shamir
    coefficients — ~64n bytes shrink to ~32n + 32.  ``aux_table`` holds the
    deduplicated per-signer auxiliary payloads (Signature.msg), indexed by
    ``aux_index`` so the common all-identical-aux case costs one entry.

    The sequence protocol (``len`` / iteration / indexing) yields
    per-component :class:`Signature` views with ``value=Rᵢ`` — enough for
    every signer-identity consumer (quorum counting, blacklists, epoch
    checks).  Those views do NOT verify individually; a cert only verifies
    as a whole through ``Verifier.verify_aggregate_cert``.
    """

    signer_ids: tuple[int, ...] = ()
    rs: tuple[bytes, ...] = ()
    s_agg: bytes = b""
    aux_table: tuple[bytes, ...] = ()
    aux_index: tuple[int, ...] = ()

    def __len__(self) -> int:
        return len(self.signer_ids)

    def __iter__(self):
        return (self[i] for i in range(len(self.signer_ids)))

    def __getitem__(self, i):
        if isinstance(i, slice):
            return tuple(
                self[j] for j in range(*i.indices(len(self.signer_ids)))
            )
        return Signature(
            id=self.signer_ids[i],
            value=self.rs[i],
            msg=self.aux_table[self.aux_index[i]],
        )


__all__ = ["RequestInfo", "Proposal", "Signature", "QuorumCert"]
