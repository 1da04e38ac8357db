"""Continuously-checked protocol invariants for chaos runs.

The soak loops used to spot-check safety BETWEEN schedule steps
(``cluster.assert_ledgers_consistent()`` after each ``advance``); a fork
that appears and is "healed" by a later sync inside one step, or a
decision delivered on an undersized certificate, could slip through.  The
:class:`InvariantMonitor` instead hangs off the cluster's COMMIT-PATH
delivery hook (``Cluster.delivery_hooks``) and judges every delivery the
moment it happens, recording the exact sim-time and the adversary-action
history that led there.

Monitored invariants (formal statements: SAFETY.md §6):

* **prefix-agreement** — at every delivery, each pair of replica ledgers
  agrees on its common prefix of proposal digests.
* **quorum-cert** — every delivered decision carries ``>= 2f + 1``
  commit signatures from distinct consenters, each verifying against the
  delivered proposal.  With a membership directory installed
  (``install_reconfig_hook``) the quorum bar is the one of the EPOCH THE
  DECISION BELONGS TO, and only that epoch's members count toward it.
* **epoch-cert** — with a directory installed: no valid signer of a
  delivered decision lies outside the membership of the decision's epoch —
  in particular, a removed node never appears in a later quorum cert
  (SAFETY.md §8).  Without a directory the ledgers carry no epoch
  structure and this check is vacuous.
* **durable-before-visible** — at the moment a replica delivers sequence
  ``s`` through the commit path, its own WAL already holds a protocol
  record binding it to that proposal at ``s`` (the persist-before-sign
  spine made visible).  Checked against the union of durable + pending
  appends: under group commit the durability of the *send* is what the
  protocol defers, and the append always precedes visibility (see
  SAFETY.md §6 for why this is the strongest true statement).

Violations are RECORDED, not raised: delivery runs inside a scheduler
event and ``SimScheduler._fire`` swallows exceptions, so raising would
hide the failure.  The chaos engine polls :attr:`InvariantMonitor.violations`
between schedule steps and aborts the run on the first one;
:meth:`InvariantMonitor.assert_clean` re-raises for plain pytest use.

The PyTorch port's copy of ``consensus_tpu/testing/invariants.py``, its imports renamed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from consensus_tpu_torch.utils.quorum import compute_quorum
from consensus_tpu_torch.wire import (
    ProposedRecord,
    SavedCommit,
    decode_saved,
    decode_view_metadata,
)


@dataclasses.dataclass(frozen=True)
class Violation:
    """One invariant failure, pinned to the sim clock and the adversary
    actions executed before it."""

    invariant: str  # "prefix-agreement" | "quorum-cert" | "epoch-cert" | "durable-before-visible" | "cross-group-atomicity" | "liveness"
    sim_time: float
    node: Optional[int]
    detail: str
    history: tuple[str, ...]

    def __str__(self) -> str:  # pragma: no cover — formatting aid
        lines = [
            f"invariant {self.invariant} violated at sim t={self.sim_time:.6f}"
            + (f" on replica {self.node}" if self.node is not None else ""),
            f"  {self.detail}",
        ]
        if self.history:
            lines.append("  adversary actions so far:")
            lines.extend(f"    {h}" for h in self.history)
        return "\n".join(lines)


class InvariantViolation(AssertionError):
    """Raised by :meth:`InvariantMonitor.assert_clean`."""

    def __init__(self, violation: Violation) -> None:
        super().__init__(str(violation))
        self.violation = violation


def _wal_appended_entries(node) -> Optional[list[bytes]]:
    """Every record the node's WAL has ACCEPTED (durable backing plus any
    group-commit pending buffer), or None when the WAL is not inspectable
    in memory (real file-backed WALs)."""
    wal = node.wal
    entries = getattr(wal, "entries", None)
    if entries is None:
        return None
    out = list(entries)
    pending = getattr(wal, "_pending", None)
    if pending:
        out.extend(entry for entry, _, _ in pending)
    return out


def _seq_of(proposal) -> Optional[int]:
    if not proposal.metadata:
        return None
    try:
        return decode_view_metadata(proposal.metadata).latest_sequence
    except Exception:
        return None


class InvariantMonitor:
    """Wired into ``Cluster.delivery_hooks``; judges every commit-path
    delivery and records the first failure of each kind."""

    def __init__(self, cluster, *, check_durability: bool = True) -> None:
        self.cluster = cluster
        n = len(cluster.nodes)
        self.quorum, self.f = compute_quorum(n)
        self.check_durability = check_durability
        self.violations: list[Violation] = []
        #: Adversary-action lines the chaos engine appends as it executes
        #: the schedule; snapshotted into each violation.
        self.history: list[str] = []
        #: ``fn(Violation)`` called the moment a violation is recorded —
        #: the flight recorder hangs here to dump while the failing state
        #: is still live.  Hook failures must not mask the violation.
        self.on_violation: list = []
        self.deliveries = 0
        #: Cross-group atomicity wiring (consensus sharding): a shared
        #: CrossGroupRegistry + this monitor's group id, installed via
        #: :meth:`attach_cross_group`.  None on single-group clusters.
        self.cross_group_registry = None
        self.cross_group_id: Optional[str] = None
        self._cross_group_seen = 0
        cluster.delivery_hooks.append(self._on_deliver)

    def attach_cross_group(self, registry, group_id: str) -> None:
        """Mirror the shared registry's cross-group atomicity verdicts
        into THIS monitor at every delivery (SAFETY.md §15): a violation
        involving this group surfaces with the group's own sim-time and
        adversary history attached.  Install the registry-feeding
        participant hook BEFORE this monitor was constructed so the
        delivery that completes a one-sided commit is judged immediately."""
        self.cross_group_registry = registry
        self.cross_group_id = group_id
        self._cross_group_seen = len(registry.violations)

    # --- recording ---------------------------------------------------------

    @property
    def first(self) -> Optional[Violation]:
        return self.violations[0] if self.violations else None

    def record(self, invariant: str, node: Optional[int], detail: str) -> None:
        violation = Violation(
            invariant=invariant,
            sim_time=self.cluster.scheduler.now(),
            node=node,
            detail=detail,
            history=tuple(self.history),
        )
        self.violations.append(violation)
        for hook in self.on_violation:
            try:
                hook(violation)
            except Exception:
                pass

    def assert_clean(self) -> None:
        if self.violations:
            raise InvariantViolation(self.violations[0])

    # --- the delivery-time checks -----------------------------------------

    def _on_deliver(self, node_id: int, decision) -> None:
        self.deliveries += 1
        self._check_prefix_agreement(node_id)
        self._check_quorum_cert(node_id, decision)
        if self.check_durability:
            self._check_durable_before_visible(node_id, decision)
        self._check_cross_group_atomicity(node_id)

    def _check_cross_group_atomicity(self, node_id: int) -> None:
        """Mirror any NEW cross-group atomicity violations the shared
        registry recorded (the participant hook runs before this monitor,
        so the registry is up to date for this very delivery)."""
        registry = self.cross_group_registry
        if registry is None:
            return
        fresh = registry.violations[self._cross_group_seen:]
        self._cross_group_seen = len(registry.violations)
        for violation in fresh:
            self.record(
                "cross-group-atomicity",
                node_id,
                f"[{self.cross_group_id}] {violation.detail} "
                f"(txid {violation.txid})",
            )

    def _check_prefix_agreement(self, node_id: Optional[int] = None) -> None:
        """Every pair of ledgers agrees on its common digest prefix."""
        ledgers = {
            nid: [d.proposal.digest() for d in node.app.ledger]
            for nid, node in self.cluster.nodes.items()
        }
        ids = sorted(ledgers)
        for i, a in enumerate(ids):
            for b in ids[i + 1:]:
                la, lb = ledgers[a], ledgers[b]
                common = min(len(la), len(lb))
                if la[:common] != lb[:common]:
                    at = next(
                        k for k in range(common) if la[k] != lb[k]
                    )
                    self.record(
                        "prefix-agreement",
                        node_id,
                        f"replicas {a} and {b} fork at height {at}: "
                        f"{la[at]} != {lb[at]}",
                    )
                    return

    def _check_quorum_cert(self, node_id: int, decision) -> None:
        """>= quorum distinct consenters, each signature verifying against
        the delivered proposal.  Epoch-aware when the cluster carries a
        membership directory: the quorum bar and the eligible signer set
        are the ones of the epoch the decision's sequence falls in, and a
        valid signer OUTSIDE that membership is its own violation
        (``epoch-cert``) — the cert a node built from a retired committee,
        or padded with an evicted member, is caught here even if it is
        numerically big enough."""
        app = self.cluster.nodes[node_id].app
        valid: set[int] = set()
        bad: list[str] = []
        if getattr(decision.signatures, "s_agg", None) is not None:
            # Half-aggregated QuorumCert: the proof is all-or-nothing — one
            # aggregate verification vouches for every listed signer at once.
            cert = decision.signatures
            vac = getattr(app, "verify_aggregate_cert", None)
            aux = vac(cert, decision.proposal) if vac is not None else None
            if aux is not None:
                valid = set(cert.signer_ids)
            else:
                bad.append(
                    f"half-agg cert with signers {sorted(set(cert.signer_ids))} "
                    "failed aggregate verification"
                )
        else:
            for sig in decision.signatures:
                try:
                    app.verify_consenter_sig(sig, decision.proposal)
                except Exception as err:
                    bad.append(f"id={sig.id}: {err}")
                    continue
                valid.add(sig.id)
        seq = _seq_of(decision.proposal)
        quorum = self.quorum
        directory = getattr(self.cluster, "membership_directory", None)
        if directory is not None:
            cfg = directory.membership_at(seq)
            quorum = cfg.quorum
            members = set(cfg.nodes)
            foreign = sorted(valid - members)
            if foreign:
                evicted = sorted(set(foreign) & directory.ever_removed())
                self.record(
                    "epoch-cert",
                    node_id,
                    f"decision at seq {seq} (epoch {cfg.epoch}, members "
                    f"{list(cfg.nodes)}) carries valid signature(s) from "
                    f"non-member(s) {foreign}"
                    + (f", previously removed: {evicted}" if evicted else ""),
                )
            valid &= members
        if len(valid) < quorum:
            self.record(
                "quorum-cert",
                node_id,
                f"decision at seq {seq} delivered with "
                f"{len(valid)} distinct valid commit signature(s) "
                f"(quorum is {quorum}"
                + (f"; invalid: {'; '.join(bad)}" if bad else "")
                + ")",
            )

    def _check_durable_before_visible(self, node_id: int, decision) -> None:
        """The delivering replica's own WAL already holds a record binding
        it to this proposal at this sequence.

        Scoped to deliveries the replica itself ATTESTED: the certificate
        contains its own commit signature (the 3-phase commit path always
        does — ``_try_process_commits`` asserts it).  A decision ADOPTED
        from a peer's verified quorum cert during a view change
        (``viewchanger._deliver_decision``) carries no local-durability
        claim — the signers' WALs back it, not ours — and is exempt, same
        as the sync path (which bypasses ``deliver`` entirely).  Persist-
        before-sign (SAFETY.md §1) is what makes the scoped form airtight:
        an own signature cannot exist in any cert before the backing
        record was appended (and, at durability window 0, fsynced)."""
        if not any(sig.id == node_id for sig in decision.signatures):
            return  # adopted foreign cert: no local-durability claim
        node = self.cluster.nodes[node_id]
        entries = _wal_appended_entries(node)
        if entries is None:
            return  # file-backed WAL: not inspectable without re-opening
        digest = decision.proposal.digest()
        seq = _seq_of(decision.proposal)
        for raw in entries:
            try:
                rec = decode_saved(raw)
            except Exception:
                continue
            if (
                isinstance(rec, ProposedRecord)
                and rec.pre_prepare.proposal.digest() == digest
            ):
                return
            if (
                isinstance(rec, SavedCommit)
                and seq is not None
                and rec.commit.seq == seq
                and rec.commit.digest == digest
            ):
                return
        self.record(
            "durable-before-visible",
            node_id,
            f"delivered seq {seq} (digest {digest}) with no WAL record "
            f"binding this replica to it ({len(entries)} entries searched)",
        )


def is_known_unresolvable_split(cluster, n: int) -> bool:
    """True iff the cluster's CURRENT attestations form a PREPARED-SPLIT
    stall that is unresolvable BY DESIGN (``check_in_flight`` docstring,
    SAFETY.md §2): prepared attestations exist at the next sequence, no
    candidate is adoptable (condition A), and a fresh proposal is not
    justified (condition B) — covering both the sub-f+1 split and opposed
    f+1-corroborated camps, where a hidden commit cannot be ruled out on
    either side.  The arithmetic is recomputed here INDEPENDENTLY of
    ``check_in_flight`` so a resolvability regression in the production
    code cannot self-excuse a wedge.  The liveness invariant's one excuse:
    stalling here is the safe outcome."""
    from consensus_tpu_torch.wire import decode_view_data

    msgs = []
    for node in cluster.nodes.values():
        if not node.running or node.consensus is None:
            continue  # a retired (evicted) replica argues no camp
        vc = node.consensus.view_changer
        svd = vc._prepare_view_data()
        msgs.append(decode_view_data(svd.raw_view_data))
    quorum, f = compute_quorum(n)

    expected_seq = max(
        (
            decode_view_metadata(m.last_decision.metadata).latest_sequence
            for m in msgs
            if m.last_decision is not None and m.last_decision.metadata
        ),
        default=0,
    ) + 1
    prepared_groups: dict = {}
    quiet = 0  # none / unprepared / wrong-seq — the B-side count
    for m in msgs:
        p = m.in_flight_proposal
        if p is None or not p.metadata:
            quiet += 1
            continue
        md = decode_view_metadata(p.metadata)
        if md.latest_sequence != expected_seq or not m.in_flight_prepared:
            quiet += 1
            continue
        prepared_groups[p.digest()] = prepared_groups.get(p.digest(), 0) + 1

    if not prepared_groups:
        return False  # nothing prepared: a stall here is a real bug
    if quiet >= quorum:
        return False  # condition B should have fired: real bug
    prepared_total = sum(prepared_groups.values())
    for count in prepared_groups.values():
        arguing = prepared_total - count
        if count >= f + 1 and len(msgs) - arguing >= quorum:
            return False  # condition A should have adopted it: real bug
    return True


__all__ = [
    "InvariantMonitor",
    "InvariantViolation",
    "Violation",
    "is_known_unresolvable_split",
]
