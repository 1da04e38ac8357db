"""The ports (dependency interfaces) of the consensus core.

Parity: reference pkg/api/dependencies.go:14-99 — Application, Comm,
Assembler, WriteAheadLog, Signer, Verifier, MembershipNotifier,
RequestInspector, Synchronizer (Logger is Python ``logging`` here).

Batch-first deviation: ``Verifier`` exposes *batch* verification entry
points (``verify_requests_batch``, ``verify_consenter_sigs_batch``) with
looping defaults.  The protocol core always calls the batch forms — a
device-backed verifier overrides them to drain whole quorums / request
batches into one kernel launch (the reference instead spawns one goroutine
per commit signature, internal/bft/view.go:537-541).

The PyTorch port's copy of ``consensus_tpu/api/deps.py``: the same ports,
its imports renamed.
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence

from consensus_tpu_torch.types import (
    Decision,
    Proposal,
    QuorumCert,
    Reconfig,
    RequestInfo,
    Signature,
    SyncResponse,
)


class Application(abc.ABC):
    """The replicated state machine being driven by consensus.

    Parity: reference pkg/api/dependencies.go:14-19.
    """

    @abc.abstractmethod
    def deliver(self, proposal: Proposal, signatures: Sequence[Signature]) -> Reconfig:
        """Commit a decided proposal; returns membership/config changes."""


class Comm(abc.ABC):
    """Unreliable, unordered, fire-and-forget message transport.

    The protocol tolerates loss; delivery guarantees are *not* part of the
    contract.  Parity: reference pkg/api/dependencies.go:22-30.
    """

    @abc.abstractmethod
    def send_consensus(self, target_id: int, message) -> None: ...

    @abc.abstractmethod
    def send_transaction(self, target_id: int, request: bytes) -> None: ...

    @abc.abstractmethod
    def nodes(self) -> Sequence[int]: ...


class Assembler(abc.ABC):
    """Builds application proposals out of request batches.

    Parity: reference pkg/api/dependencies.go:33-37.
    """

    @abc.abstractmethod
    def assemble_proposal(self, metadata: bytes, requests: Sequence[bytes]) -> Proposal: ...


class WriteAheadLog(abc.ABC):
    """Persistence for protocol step records (crash recovery).

    ``on_durable`` (when given) must fire once the entry is on stable
    storage; implementations that fsync synchronously call it before
    returning, group-commit implementations defer it to the batched fsync.
    Parity: reference pkg/api/dependencies.go:40-44 (callback is ours — the
    seam that lets the protocol defer sends under group commit).
    """

    @abc.abstractmethod
    def append(
        self, entry: bytes, truncate_to: bool = False, on_durable=None
    ) -> None: ...


class Signer(abc.ABC):
    """This replica's signing identity.

    Parity: reference pkg/api/dependencies.go:47-52.
    """

    @abc.abstractmethod
    def sign(self, data: bytes) -> bytes: ...

    @abc.abstractmethod
    def sign_proposal(self, proposal: Proposal, aux: bytes = b"") -> Signature: ...

    def aggregate_cert(
        self, proposal: Proposal, signatures: Sequence[Signature]
    ) -> Optional[QuorumCert]:
        """Optionally compress a full commit-signature quorum into a
        half-aggregated :class:`~consensus_tpu_torch.types.QuorumCert`
        (cert_mode="half-agg").  Default returns None — aggregation
        unsupported, the core keeps the full signature tuple, so
        third-party signers are unaffected."""
        return None


class Verifier(abc.ABC):
    """Validation of requests, proposals, and signatures.

    Parity: reference pkg/api/dependencies.go:55-71 (7 methods), plus the
    batch entry points the device engine accelerates.
    """

    @abc.abstractmethod
    def verify_proposal(self, proposal: Proposal) -> Sequence[RequestInfo]:
        """Fully verify a proposal (including its requests); returns their
        infos, or raises on failure."""

    @abc.abstractmethod
    def verify_request(self, raw_request: bytes) -> RequestInfo:
        """Verify a single client request; returns its info or raises."""

    @abc.abstractmethod
    def verify_consenter_sig(self, signature: Signature, proposal: Proposal) -> bytes:
        """Verify a consenter's signature over a proposal; returns the
        auxiliary payload it vouches for (see blacklist redemption), or
        raises."""

    @abc.abstractmethod
    def verify_signature(self, signature: Signature) -> None:
        """Verify a raw signature (view-change data); raises on failure."""

    @abc.abstractmethod
    def verification_sequence(self) -> int:
        """The current membership/config epoch requests are verified under."""

    @abc.abstractmethod
    def requests_from_proposal(self, proposal: Proposal) -> Sequence[RequestInfo]:
        """Cheaply list the request infos inside a proposal (no verification)."""

    def auxiliary_data(self, msg: bytes) -> bytes:
        """Extract auxiliary data out of a signed message payload."""
        return b""

    def raw_requests_from_proposal(self, proposal: Proposal) -> Sequence[bytes]:
        """The raw request bytes inside a proposal, for re-admission to the
        request pool when a pipelined slot is abandoned during crash restore
        (the slot's requests live nowhere else after a reboot).  Default
        returns nothing — re-admission is then skipped and the requests are
        re-submitted by their clients, which is always correct (the pool
        dedups and delivery removal forgets decided identities)."""
        return ()

    # --- batch entry points (device acceleration seam) ------------------

    #: True when this verifier is backed by a randomized batch-verification
    #: engine (Configuration.batch_verify_mode) — one aggregate check per
    #: batch amortizes the doubling chain, so the multi-batch default below
    #: coalesces every group into a single launch instead of looping.
    batch_verify_enabled: bool = False

    #: Facades that delegate signature checks to an inner crypto verifier
    #: (e.g. testing.crypto_app.CryptoApp) set this to that inner verifier
    #: so the coalesced multi-batch path reaches the engine in ONE call —
    #: without it the default loop would split a sync chunk's quorum certs
    #: into per-group launches and re-pay the doubling chain per group.
    multi_batch_delegate: Optional["Verifier"] = None

    #: True when this verifier can assemble AND check half-aggregated
    #: quorum certs (Configuration.cert_mode="half-agg").  Third-party
    #: verifiers keep the False default: the core then never aggregates
    #: and full signature tuples flow exactly as before.
    supports_cert_aggregation: bool = False

    def aggregate_cert(
        self, proposal: Proposal, signatures: Sequence[Signature]
    ) -> Optional[QuorumCert]:
        """Compress a verified commit-signature quorum over ``proposal``
        into a half-aggregated cert, or return None when aggregation is
        unsupported/fails (the caller keeps the full tuple — graceful
        fallback, never an error)."""
        return None

    def verify_aggregate_cert(
        self, cert: QuorumCert, proposal: Proposal
    ) -> Optional[list[bytes]]:
        """Verify a half-aggregated quorum cert over ``proposal`` in one
        aggregate check; returns the per-component auxiliary payloads on
        success, or None when the cert is invalid or this verifier cannot
        check aggregates (default — a full-mode replica REJECTS compact
        certs rather than crashing on them)."""
        return None

    def verify_requests_batch(self, raw_requests: Sequence[bytes]) -> list[Optional[RequestInfo]]:
        """Verify many requests; element is None where verification failed.

        Default loops over ``verify_request``; device verifiers override.
        """
        out: list[Optional[RequestInfo]] = []
        for raw in raw_requests:
            try:
                out.append(self.verify_request(raw))
            except Exception:
                out.append(None)
        return out

    def verify_consenter_sigs_batch(
        self, signatures: Sequence[Signature], proposal: Proposal
    ) -> list[Optional[bytes]]:
        """Verify many consenter signatures over one proposal; element is the
        auxiliary payload, or None where verification failed.

        Default loops over ``verify_consenter_sig``; device verifiers override.
        A half-aggregated :class:`QuorumCert` routes through
        ``verify_aggregate_cert`` instead — all-or-nothing, so a failed
        aggregate rejects every component (the engine's bisection, where
        available, localizes the culprit before results reach here).
        """
        if isinstance(signatures, QuorumCert):
            aux = self.verify_aggregate_cert(signatures, proposal)
            if aux is None:
                return [None] * len(signatures)
            return list(aux)
        out: list[Optional[bytes]] = []
        for sig in signatures:
            try:
                out.append(self.verify_consenter_sig(sig, proposal))
            except Exception:
                out.append(None)
        return out

    def verify_consenter_sigs_multi_batch(
        self, groups: Sequence[tuple[Proposal, Sequence[Signature]]]
    ) -> list[list[Optional[bytes]]]:
        """Verify consenter-signature quorums over MANY proposals at once —
        the sync client drains a whole catch-up chunk (dozens of decisions,
        each with a quorum cert) through this single entry point.

        Default loops over ``verify_consenter_sigs_batch``; device verifiers
        override to flatten every (proposal, signature) pair into one
        device batch.  When the randomized batch verifier is enabled
        (``batch_verify_enabled``) and a ``multi_batch_delegate`` is wired,
        the default instead forwards the whole group list to the delegate's
        coalescing implementation — one launch for all groups, with the
        engine's bisection localizing any failing group on its own.

        Groups must be cert-mode homogeneous: mixing half-aggregated
        QuorumCerts with full signature tuples in one call raises
        ValueError (contradiction guard, mirroring the batch_verify_mode
        all-replicas-agree rule) — a mixed chunk means the peers disagree
        on cert_mode and silently splitting it would mask that.  Callers
        spanning a cert_mode flip (sync catch-up across a membership epoch
        boundary) partition into homogeneous calls first.
        """
        if groups:
            kinds = {isinstance(sigs, QuorumCert) for _, sigs in groups}
            if len(kinds) > 1:
                raise ValueError(
                    "verify_consenter_sigs_multi_batch: groups mix "
                    "half-aggregated QuorumCerts with full signature tuples "
                    "— cert modes contradict; partition the groups first"
                )
        delegate = self.multi_batch_delegate
        if self.batch_verify_enabled and delegate is not None:
            return delegate.verify_consenter_sigs_multi_batch(groups)
        return [
            self.verify_consenter_sigs_batch(sigs, proposal)
            for proposal, sigs in groups
        ]

    def verify_proposal_and_prev_commits(
        self,
        proposal: Proposal,
        prev_commits: Sequence[Signature],
        prev_proposal: Proposal,
    ) -> tuple[Sequence[RequestInfo], list[Optional[bytes]]]:
        """Verify a proposal AND the previous decision's commit-signature
        quorum it carries — the two signature waves of one pre-prepare.

        Default runs them as two calls (exactly the split the core did
        before this entry point existed).  Verifiers whose request
        signatures and consenter certs share one engine override this to
        fuse both waves into a single launch; any request failure must
        still raise exactly as ``verify_proposal`` would, BEFORE cert
        results are consumed.
        """
        requests = self.verify_proposal(proposal)
        if not prev_commits:
            return requests, []
        cert_results = self.verify_consenter_sigs_batch(prev_commits, prev_proposal)
        return requests, cert_results


# Convenience alias for implementations that only provide the batch forms.
BatchVerifier = Verifier


class MembershipNotifier(abc.ABC):
    """Notified when a decision changed cluster membership.

    Parity: reference pkg/api/dependencies.go:74-77.
    """

    @abc.abstractmethod
    def membership_change(self) -> None: ...


class RequestInspector(abc.ABC):
    """Extracts (client, request) identity from raw request bytes.

    Parity: reference pkg/api/dependencies.go:80-83.
    """

    @abc.abstractmethod
    def request_id(self, raw_request: bytes) -> RequestInfo: ...


class Synchronizer(abc.ABC):
    """Application-level catch-up: fetch and deliver decided proposals from
    peers, returning the latest decision reached.

    Parity: reference pkg/api/dependencies.go:86-90.
    """

    @abc.abstractmethod
    def sync(self) -> SyncResponse: ...


class TracerPort(abc.ABC):
    """Decision-lifecycle tracing sink (no reference counterpart).

    Implemented by ``trace.Tracer`` and ``trace.NoopTracer``.  Call sites
    MUST guard emission with ``if tracer.enabled:`` so the disabled hot
    path stays allocation-free; ``seq``/``view`` key per-decision spans.
    """

    #: False on the no-op tracer; the emission guard reads this.
    enabled: bool = False

    @abc.abstractmethod
    def begin(self, track: str, name: str, *, seq=None, view=None, **args) -> None: ...

    @abc.abstractmethod
    def end(self, track: str, name: str, *, seq=None, view=None, **args) -> None: ...

    @abc.abstractmethod
    def instant(self, track: str, name: str, *, seq=None, view=None, **args) -> None: ...


__all__ = [
    "Application",
    "Comm",
    "Assembler",
    "WriteAheadLog",
    "Signer",
    "Verifier",
    "BatchVerifier",
    "MembershipNotifier",
    "RequestInspector",
    "Synchronizer",
    "TracerPort",
    "Decision",
]
