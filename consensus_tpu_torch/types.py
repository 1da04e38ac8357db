"""Core value types shared by the protocol, the ports, and applications.

Parity: reference pkg/types/types.go:18-123 (Proposal, Signature, Decision,
RequestInfo, Checkpoint, Reconfig, SyncResponse).  The digest construction is
deterministic SHA-256 over a length-prefixed field encoding (the reference
uses ASN.1 + SHA-256, pkg/types/types.go:50-62; byte-compatibility with the Go
wire is a non-goal — shape compatibility is).

The PyTorch port's copy of ``consensus_tpu/types.py``.  ``Proposal.digest``
and the signature types are byte for byte the JAX package's, so commit
messages signed by either package verify in the other.
"""

from __future__ import annotations

import hashlib
import struct
import threading
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence


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
class Decision:
    """A committed proposal together with its quorum of signatures.

    ``signatures`` is either a plain tuple of :class:`Signature` (the full
    cert, ``cert_mode="full"``) or a :class:`QuorumCert` — which quacks like
    that tuple (len / iteration / indexing yield per-signer ``Signature``
    views) so cert-shape-agnostic consumers need no branch.
    Parity: reference pkg/types/types.go:39-42.
    """

    proposal: Proposal
    signatures: "tuple[Signature, ...] | QuorumCert" = ()


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


def as_cert(signatures):
    """Preserve a :class:`QuorumCert` through call sites that historically
    flattened signature sequences with ``tuple(...)`` — flattening a cert
    to its component views would silently discard ``s_agg``."""
    if isinstance(signatures, QuorumCert):
        return signatures
    return tuple(signatures)


@dataclass(frozen=True)
class Reconfig:
    """Signals that the latest decision changed membership or configuration.

    Parity: reference pkg/types/types.go:107-111.
    """

    in_latest_decision: bool = False
    current_nodes: tuple[int, ...] = ()
    current_config: Optional["object"] = None  # Configuration; avoid cycle
    #: Optional membership.MembershipConfig for the epoch this decision
    #: opens (held opaque: types must not import the membership package).
    #: None preserves the pre-epoch Reconfig shape — consumers that only
    #: need the node set keep reading current_nodes.
    membership: Optional["object"] = None


@dataclass(frozen=True)
class SyncResponse:
    """Result of Synchronizer.sync(): the latest decision plus any reconfig.

    Parity: reference pkg/types/types.go:113-116.
    """

    latest: Optional[Decision] = None
    reconfig: Reconfig = field(default_factory=Reconfig)


@dataclass(frozen=True)
class ViewSequence:
    """A replica's current (view, proposal sequence) and whether the view is
    active.  Exchanged in state-transfer responses.

    Parity: reference internal/bft types (ViewSequence in controller.go).
    """

    view_active: bool = False
    view: int = 0
    seq: int = 0


class Checkpoint:
    """Thread-safe holder of the last decided proposal + its signature quorum.

    Fed on every decision and by sync; anchors view changes (the last-decision
    proof inside ViewData) and the leader's proposal metadata.
    Parity: reference pkg/types/types.go:71-105.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._proposal: Proposal = Proposal()
        self._signatures: tuple[Signature, ...] = ()

    def get(self) -> tuple[Proposal, tuple[Signature, ...]]:
        with self._lock:
            return self._proposal, self._signatures

    def set(self, proposal: Proposal, signatures: Sequence[Signature]) -> None:
        with self._lock:
            self._proposal = proposal
            self._signatures = as_cert(signatures)


__all__ = [
    "RequestInfo",
    "Proposal",
    "Signature",
    "Decision",
    "QuorumCert",
    "as_cert",
    "Reconfig",
    "SyncResponse",
    "ViewSequence",
    "Checkpoint",
    "replace",
]
