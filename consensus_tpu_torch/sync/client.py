"""Catch-up client: the production implementation of the Synchronizer port.

Replaces the test harness's shared-memory shortcut (``TestApp.sync`` reading
``cluster.longest_ledger``) with a real wire protocol: probe peers for their
chain height, fetch ranged decision chunks from the best-scored peer, verify
every fetched decision's commit-signature quorum, and apply.  Parity model:
the reference leaves ``Synchronizer`` to the application and Fabric fills it
with the block puller (pulls blocks from orderers, verifies each block's
signature set, round-robins away from failing endpoints) — this module is
that component for consensus_tpu.

The PyTorch port's copy of ``consensus_tpu/sync/client.py``, its imports renamed.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional, Sequence, Set, Union

from consensus_tpu_torch.api.deps import Synchronizer, Verifier
from consensus_tpu_torch.sync.store import DecisionStore
from consensus_tpu_torch.sync.transport import SyncTransport
from consensus_tpu_torch.types import Decision, QuorumCert, Reconfig, SyncResponse, as_cert
from consensus_tpu_torch.utils.quorum import compute_quorum
from consensus_tpu_torch.wire.codec import CodecError, decode_view_metadata, encoded_cert_size
from consensus_tpu_torch.wire.messages import SyncChunk, SyncRequest, SyncSnapshotMeta

logger = logging.getLogger("consensus_tpu_torch.sync")

#: Score deltas: a failed fetch is routine (peer down, partition); serving
#: data that fails verification is byzantine evidence and effectively
#: disqualifies the peer until everyone else has failed many times over.
_DEMOTE_FETCH = 1.0
_DEMOTE_FORGED = 100.0


def honest_endorsement_threshold(n: int) -> int:
    """Default per-decision acceptance threshold: ``f + 1`` distinct valid
    consenter signatures.

    Commit certs are written with a full ``2f + 1`` quorum, and every
    signature in a fetched cert is batch-verified — but a decision committed
    before a membership change carries the quorum of ITS era, whose size is
    not reconstructible from the current configuration alone (a cluster
    grown from 4 to 5 nodes has 3-signature certs in its history that are
    perfectly valid).  ``f + 1`` valid signatures under the current fault
    assumption guarantee at least one HONEST replica signed the commit, and
    honest replicas only sign prepared proposals — the standard PBFT
    state-transfer acceptance rule.  Forging it needs ``f + 1`` colluding
    consenters, which is outside the fault model.  See SAFETY.md §4.
    """
    _q, f = compute_quorum(n)
    return f + 1


class LedgerSynchronizer(Synchronizer):
    """Verified, chunked catch-up over a :class:`SyncTransport`.

    Every fetched chunk is accepted only if (1) it starts exactly at our
    next chain position, (2) each decision's ``ViewMetadata.latest_sequence``
    equals its chain position exactly, and (3) each decision's commit cert contains at
    least ``threshold(n)`` distinct VALID consenter signatures (default
    ``f + 1`` — :func:`honest_endorsement_threshold` explains why that is
    the sound bar under reconfiguration) — every signature in every cert in
    the chunk drained through ONE
    ``Verifier.verify_consenter_sigs_multi_batch`` call, so a TPU-backed
    verifier validates catch-up at kernel throughput.  See SAFETY.md §4
    ("Byzantine sync servers") for why an unverified sync channel would let
    a single faulty peer fork a recovering replica.

    Peers that fail fetches are scored down and retried later; peers that
    serve data failing verification are scored down hard and skipped for the
    rest of the call — the sync completes from the remaining honest peers
    (there are at least ``n - f`` of them).
    """

    def __init__(
        self,
        *,
        node_id: int,
        store: DecisionStore,
        transport: SyncTransport,
        verifier: Verifier,
        nodes: Union[Sequence[int], Callable[[], Sequence[int]]],
        reconfig_of: Optional[Callable[[object], Reconfig]] = None,
        metrics=None,
        fault_plan=None,
        now: Callable[[], float] = time.monotonic,
        chunk_window: int = 32,
        max_fetch_failures: int = 3,
        threshold: Callable[[int], int] = honest_endorsement_threshold,
    ) -> None:
        self.node_id = node_id
        self.store = store
        self.transport = transport
        self.verifier = verifier
        self._nodes = nodes
        self._reconfig_of = reconfig_of
        if metrics is None:
            from consensus_tpu_torch.metrics import MetricsSync, NoopProvider

            metrics = MetricsSync(NoopProvider())
        self.metrics = metrics
        self.fault_plan = fault_plan
        #: Optional decision-lifecycle tracer (trace.Tracer); None when off.
        self._tracer = None
        self._now = now
        self.chunk_window = chunk_window
        self.max_fetch_failures = max_fetch_failures
        #: n -> required distinct valid signers per decision.
        self.threshold = threshold
        #: Peer scores persist across sync() calls (higher is better).
        self.scores: Dict[int, float] = {}
        #: Height of the tallest probed peer on the most recent sync() call
        #: — the obs plane's sync-lag source (0 until a sync runs).
        self.last_target_height = 0

    def attach_tracer(self, tracer) -> None:
        """Emit chunk fetch/verify spans into a decision tracer."""
        self._tracer = tracer

    # --- peer scoring ------------------------------------------------------

    def _demote(self, peer: int, delta: float) -> None:
        self.scores[peer] = self.scores.get(peer, 0.0) - delta
        self.metrics.count_peer_demotions.add(1)

    def _ranked(self, candidates: Sequence[int]) -> list[int]:
        """Best-scored first; peer id breaks ties deterministically."""
        return sorted(candidates, key=lambda p: (-self.scores.get(p, 0.0), p))

    def _membership(self) -> Sequence[int]:
        nodes = self._nodes
        return list(nodes()) if callable(nodes) else list(nodes)

    # --- the port ----------------------------------------------------------

    def sync(self) -> SyncResponse:
        begin = self._now()
        reconfig = Reconfig()
        banned: Set[int] = set()  # served-forged-data, this call
        failures: Dict[int, int] = {}

        # Phase 1: probe reachable peers for their heights.
        heights: Dict[int, int] = {}
        for peer in self._ranked(self.transport.peers()):
            reply = self.transport.fetch(peer, SyncRequest(from_seq=1, to_seq=0))
            if reply is None:
                self._demote(peer, _DEMOTE_FETCH)
                continue
            if isinstance(reply, SyncSnapshotMeta):
                heights[peer] = reply.height
            elif isinstance(reply, SyncChunk):
                heights[peer] = reply.height
        target = max(heights.values(), default=0)
        self.last_target_height = target

        # Phase 2: chunk-fetch loop.  The target is pinned to the probed
        # maximum — a byzantine peer inflating `height` in later chunks
        # cannot extend the loop, and `max_rounds` bounds it even against
        # an inflated probe (each productive round advances >= 1 decision;
        # unproductive rounds consume the peer's failure budget).
        deficit = max(0, target - self.store.height())
        max_rounds = deficit + len(heights) * (self.max_fetch_failures + 1) + 4
        rounds = 0
        while self.store.height() < target and rounds < max_rounds:
            rounds += 1
            mine = self.store.height()
            candidates = [
                p
                for p, h in heights.items()
                if h > mine
                and p not in banned
                and failures.get(p, 0) < self.max_fetch_failures
            ]
            if not candidates:
                break
            peer = self._ranked(candidates)[0]
            request = SyncRequest(
                from_seq=mine + 1, to_seq=min(target, mine + self.chunk_window)
            )
            tracer = self._tracer
            tracing = tracer is not None and tracer.enabled
            if tracing:
                tracer.begin(
                    "sync",
                    "sync.fetch",
                    peer=peer,
                    from_seq=request.from_seq,
                    to_seq=request.to_seq,
                )
            reply = self.transport.fetch(peer, request)
            if tracing:
                tracer.end("sync", "sync.fetch", ok=reply is not None)
            if reply is None:
                failures[peer] = failures.get(peer, 0) + 1
                self._demote(peer, _DEMOTE_FETCH)
                continue
            if isinstance(reply, SyncSnapshotMeta):
                # Peer is shorter than it claimed at probe time.
                heights[peer] = min(heights[peer], reply.height)
                continue
            if tracing:
                tracer.begin("sync", "sync.apply", from_seq=mine + 1)
            applied = self._verify_and_apply(reply, expected_from=mine + 1)
            if tracing:
                tracer.end("sync", "sync.apply", ok=applied is not None)
            if applied is None:
                logger.warning(
                    "%d: peer %d served a chunk that failed verification; "
                    "routing around it", self.node_id, peer,
                )
                self._demote(peer, _DEMOTE_FORGED)
                banned.add(peer)
                continue
            if applied.in_latest_decision:
                reconfig = applied
            # sync.client.chunk_boundary: the canonical mid-transfer death —
            # a chunk durably applied, the next not yet requested.
            plan = self.fault_plan
            if plan is not None:
                plan.crash("sync.client.chunk_boundary")

        self.metrics.latency_catchup.observe(self._now() - begin)
        latest = self.store.last()
        return SyncResponse(latest=latest, reconfig=reconfig)

    # --- verification ------------------------------------------------------

    def _verify_and_apply(
        self, chunk: SyncChunk, *, expected_from: int
    ) -> Optional[Reconfig]:
        """Verify a whole chunk (position, metadata continuity, quorum
        certs), then apply it.  Returns the last reconfig seen (possibly the
        empty one) on success, None on any verification failure — a chunk
        is all-or-nothing so a crash mid-call never leaves half a chunk."""
        if chunk.from_seq != expected_from or not chunk.decisions:
            return None
        if len(chunk.decisions) != len(chunk.quorum_certs):
            return None

        required = self.threshold(len(self._membership()))

        # One batched verifier call per cert FORMAT in the chunk.  A ledger
        # whose cert_mode flipped mid-history (e.g. at a membership epoch
        # boundary) serves chunks mixing full signature tuples with
        # half-aggregated QuorumCerts; verify_consenter_sigs_multi_batch
        # rejects mixed groups by contract, so partition into homogeneous
        # sub-calls and merge the verdicts back in chunk order.
        groups = list(zip(chunk.decisions, chunk.quorum_certs))
        full_idx = [i for i, (_, c) in enumerate(groups) if not isinstance(c, QuorumCert)]
        agg_idx = [i for i, (_, c) in enumerate(groups) if isinstance(c, QuorumCert)]
        results: list = [None] * len(groups)
        for idx_list in (full_idx, agg_idx):
            if not idx_list:
                continue
            sub = self.verifier.verify_consenter_sigs_multi_batch(
                [groups[i] for i in idx_list]
            )
            for i, r in zip(idx_list, sub):
                results[i] = r
        total_sigs = sum(len(cert) for cert in chunk.quorum_certs)
        self.metrics.count_sig_verifications.add(total_sigs)
        self.metrics.sigs_per_chunk.observe(total_sigs)
        for i in agg_idx:
            self.metrics.sync_cert_bytes.add(encoded_cert_size(groups[i][1]))

        for i, (proposal, cert) in enumerate(groups):
            valid_signers = {
                cert[j].id for j in range(len(cert)) if results[i][j] is not None
            }
            if len(valid_signers) < required:
                return None
            # Chain position == committed sequence, exactly: a server that
            # omits, reorders, or offsets decisions (e.g. dropping the first
            # one against an empty store) produces a mismatch here and the
            # whole chunk is rejected.
            if _metadata_sequence(proposal) != chunk.from_seq + i:
                return None

        reconfig = Reconfig()
        for proposal, cert in groups:
            self.store.append(Decision(proposal=proposal, signatures=as_cert(cert)))
            if self._reconfig_of is not None:
                r = self._reconfig_of(proposal)
                if r.in_latest_decision:
                    reconfig = r
        self.metrics.count_chunks_fetched.add(1)
        self.metrics.count_decisions_fetched.add(len(groups))
        return reconfig


def _metadata_sequence(proposal) -> Optional[int]:
    if not proposal.metadata:
        return None
    try:
        return decode_view_metadata(proposal.metadata).latest_sequence
    except CodecError:
        return None


__all__ = ["LedgerSynchronizer"]
