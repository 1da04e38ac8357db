"""Cross-group atomic commits: a 2PC overlay on ordered per-group requests.

A cross-group transaction touches tenants owned by two (or more) consensus
groups.  No group can order the other's requests, so atomicity is layered
ON TOP of per-group total order, classic two-phase commit style:

* **Prepare** — the coordinator submits a ``prepare`` request to every
  participant group.  Each group ORDERS it like any other request (full
  PBFT: quorum cert, WAL, the lot), so "group G is prepared" is itself a
  replicated, crash-durable fact — not a volatile ack.
* **Decide** — once every participant group has ordered its prepare, the
  coordinator submits ``commit`` to all of them; if it concludes a group
  cannot prepare, ``abort`` to all.  The decision requests are again
  ordered per group.
* **Recover** — a dead coordinator presumes abort: a recovery coordinator
  reads the replicated participant states and submits ``commit`` to the
  undecided groups only if some group already ordered a commit (the
  decision point had been passed), otherwise ``abort`` everywhere.

The participant state machine (:class:`TwoPhaseParticipant`) hangs off a
group's commit-path delivery hooks and persists every transition as a
versioned :class:`~consensus_tpu_torch.wire.SavedTwoPC` wire record
(``encode_saved`` — the v4 record; SAFETY.md §15) in a dedicated per-group
2PC WAL, so a restarted harness can replay its transaction states without
touching the consensus WAL.  The :class:`CrossGroupRegistry` is the
cross-group witness: every participant transition lands there, and the
atomicity invariant — **never one group commits while another aborts the
same transaction** — is re-checked at every delivery (the per-group
:class:`~consensus_tpu_torch.testing.invariants.InvariantMonitor` mirrors
registry violations via ``attach_cross_group``).

Payloads ride the standard test request format (``client:rid|payload``)
with a recognizable ``2pc|`` marker, so ordinary requests and 2PC control
requests coexist in one ledger.

The PyTorch port's copy of ``consensus_tpu/groups/twopc.py``, its imports renamed.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

from consensus_tpu_torch.testing.app import make_request, unpack_batch
from consensus_tpu_torch.wire import SavedTwoPC, decode_saved, encode_saved

#: Payload marker distinguishing 2PC control requests from app requests.
TWOPC_MARKER = b"2pc|"

#: Control-request kinds, in protocol order.
TWOPC_KINDS = ("prepare", "commit", "abort")

#: Control kind -> the participant state it drives a group into.
_KIND_TO_PHASE = {"prepare": "prepared", "commit": "committed", "abort": "aborted"}

#: Participant states that end a transaction for that group.
TERMINAL_PHASES = ("committed", "aborted")


def twopc_payload(
    kind: str, txid: str, groups: Sequence[str], coordinator: str = "coord-0"
) -> bytes:
    """Encode one 2PC control payload (the part after ``client:rid|``)."""
    if kind not in TWOPC_KINDS:
        raise ValueError(f"unknown 2PC kind {kind!r}")
    if not txid or "|" in txid or "," in txid:
        raise ValueError(f"bad txid {txid!r}")
    for g in groups:
        if "|" in g or "," in g:
            raise ValueError(f"bad group id {g!r}")
    return TWOPC_MARKER + b"|".join(
        (kind.encode(), txid.encode(), ",".join(groups).encode(), coordinator.encode())
    )


def parse_twopc_payload(payload: bytes) -> Optional[dict]:
    """Decode a 2PC control payload; None when ``payload`` is not one."""
    if not payload.startswith(TWOPC_MARKER):
        return None
    parts = payload[len(TWOPC_MARKER):].split(b"|")
    if len(parts) != 4:
        raise ValueError(f"malformed 2PC payload {payload!r}")
    kind = parts[0].decode()
    if kind not in TWOPC_KINDS:
        raise ValueError(f"malformed 2PC payload {payload!r}: kind {kind!r}")
    return {
        "kind": kind,
        "txid": parts[1].decode(),
        "groups": tuple(g for g in parts[2].decode().split(",") if g),
        "coordinator": parts[3].decode(),
    }


@dataclasses.dataclass(frozen=True)
class AtomicityViolation:
    """One cross-group atomicity failure: the same transaction committed
    in one group and aborted in another."""

    txid: str
    detail: str

    def __str__(self) -> str:
        return f"cross-group atomicity violated for {self.txid}: {self.detail}"


class CrossGroupRegistry:
    """The cross-group witness: per-transaction participant decisions,
    resolution tracking, and the atomicity check.

    ``metrics`` is a :class:`~consensus_tpu_torch.metrics.MetricsGroups` bundle
    (duck-typed): transaction starts and resolutions book the pinned
    ``groups_twopc_*`` counters.  ``now`` is the sim clock; it stamps
    transaction starts so :meth:`oldest_unresolved_age` can feed the
    obs plane's ``cross_group_stall`` detector health field.
    """

    def __init__(self, *, now=None, metrics=None) -> None:
        self._now = now if now is not None else (lambda: 0.0)
        self.metrics = metrics
        #: txid -> {"groups", "coordinator", "started", "decisions",
        #:          "booked"}; decisions maps group id -> latest phase.
        self.transactions: dict[str, dict] = {}
        self.violations: list[AtomicityViolation] = []
        #: Atomicity evaluations run (every delivery re-checks).
        self.checks = 0
        self._flagged: set[str] = set()

    # -- lifecycle -----------------------------------------------------------

    def begin(self, txid: str, groups: Sequence[str], coordinator: str = "") -> None:
        """Register a transaction at coordinator start time."""
        tx = self._tx(txid)
        tx["groups"] = tuple(groups)
        tx["coordinator"] = coordinator
        if self.metrics is not None:
            self.metrics.count_twopc_started.add(1)

    def _tx(self, txid: str) -> dict:
        tx = self.transactions.get(txid)
        if tx is None:
            # A participant can report before begin() (recovery replay):
            # groups fill in from the delivered payload via record().
            tx = self.transactions[txid] = {
                "groups": (),
                "coordinator": "",
                "started": self._now(),
                "decisions": {},
                "booked": False,
            }
        return tx

    def record(
        self, group: str, txid: str, phase: str, *, groups: Sequence[str] = ()
    ) -> None:
        """One participant transition; re-runs the atomicity check and
        books the resolution counters when the transaction completes."""
        tx = self._tx(txid)
        if groups and not tx["groups"]:
            tx["groups"] = tuple(groups)
        tx["decisions"][group] = phase
        self.check(txid)
        outcome = self.resolved(txid)
        if outcome is not None and not tx["booked"]:
            tx["booked"] = True
            if self.metrics is not None:
                if outcome == "committed":
                    self.metrics.count_twopc_committed.add(1)
                else:
                    self.metrics.count_twopc_aborted.add(1)

    # -- the invariant -------------------------------------------------------

    def check(self, txid: str) -> Optional[AtomicityViolation]:
        """THE cross-group atomicity check, run at every delivery: no
        transaction may be committed in one group and aborted in another."""
        self.checks += 1
        tx = self.transactions.get(txid)
        if tx is None:
            return None
        decided = tx["decisions"]
        committed = sorted(g for g, p in decided.items() if p == "committed")
        aborted = sorted(g for g, p in decided.items() if p == "aborted")
        if committed and aborted and txid not in self._flagged:
            self._flagged.add(txid)
            violation = AtomicityViolation(
                txid=txid,
                detail=(
                    f"committed in {committed} but aborted in {aborted} "
                    f"(participants {list(tx['groups'])}, "
                    f"coordinator {tx['coordinator']!r})"
                ),
            )
            self.violations.append(violation)
            return violation
        return None

    def resolved(self, txid: str) -> Optional[str]:
        """The transaction's outcome ("committed"/"aborted") once EVERY
        participant group reached the SAME terminal phase; None before
        then (and None forever for a flagged atomicity violation)."""
        tx = self.transactions.get(txid)
        if tx is None or not tx["groups"]:
            return None
        phases = {tx["decisions"].get(g) for g in tx["groups"]}
        if len(phases) == 1:
            (phase,) = phases
            if phase in TERMINAL_PHASES:
                return phase
        return None

    def oldest_unresolved_age(self, now: Optional[float] = None) -> Optional[float]:
        """Age of the oldest transaction still lacking a resolution — the
        obs plane's ``groups_twopc_oldest_age`` health field (None when
        everything is resolved, which keeps the detector's latch clear)."""
        t = self._now() if now is None else now
        ages = [
            t - tx["started"]
            for txid, tx in self.transactions.items()
            if self.resolved(txid) is None
        ]
        return max(ages) if ages else None

    def assert_atomic(self) -> None:
        if self.violations:
            raise AssertionError(str(self.violations[0]))


class TwoPhaseParticipant:
    """One group's 2PC state machine, driven by commit-path deliveries.

    Hangs off ``Cluster.delivery_hooks``; for every ordered 2PC control
    request naming this group it applies the transition, persists it as a
    :class:`~consensus_tpu_torch.wire.SavedTwoPC` record in the group's 2PC WAL
    (``wal`` — anything with ``append(bytes)``; defaults to an internal
    list-backed log), and reports to the :class:`CrossGroupRegistry`.
    Transitions are idempotent under re-delivery across the group's n
    replicas: only the FIRST delivery of a phase change persists/reports.
    """

    def __init__(
        self,
        group_id: str,
        *,
        registry: Optional[CrossGroupRegistry] = None,
        wal=None,
        tracer=None,
    ) -> None:
        self.group_id = group_id
        self.registry = registry
        self.wal = wal if wal is not None else _ListWAL()
        self.tracer = tracer
        #: txid -> current phase ("prepared" | "committed" | "aborted").
        self.state: dict[str, str] = {}
        #: Out-of-protocol transitions observed (commit without prepare,
        #: abort after commit) — harness-level red flags, not exceptions.
        self.errors: list[str] = []
        self.deliveries = 0

    # -- delivery hook -------------------------------------------------------

    def on_delivery(self, node_id: int, decision) -> None:
        """``Cluster.delivery_hooks`` signature."""
        self.deliveries += 1
        for raw in unpack_batch(decision.proposal.payload):
            split = raw.split(b"|", 1)
            if len(split) != 2:
                continue
            try:
                rec = parse_twopc_payload(split[1])
            except ValueError:
                continue
            if rec is None or self.group_id not in rec["groups"]:
                continue
            self._apply(rec)

    def _apply(self, rec: dict) -> None:
        txid, kind = rec["txid"], rec["kind"]
        cur = self.state.get(txid)
        new = _KIND_TO_PHASE[kind]
        if cur == new:
            return  # re-delivery on another replica of this group
        if kind == "prepare" and cur is not None:
            return  # late prepare after the decision: stale, ignored
        if kind == "commit" and cur != "prepared":
            self.errors.append(
                f"{txid}: commit delivered in state {cur!r} (expected prepared)"
            )
        if kind == "abort" and cur == "committed":
            # The one transition that must NEVER happen: an ordered commit
            # is final for this group.  Keep the committed state — the
            # registry's cross-group check judges the pair.
            self.errors.append(f"{txid}: abort delivered after commit (kept commit)")
            return
        self.state[txid] = new
        self.wal.append(
            encode_saved(
                SavedTwoPC(
                    txid=txid,
                    phase=new,
                    groups=tuple(rec["groups"]),
                    coordinator=rec["coordinator"],
                )
            )
        )
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.instant(
                "groups", "groups.twopc", txid=txid, group=self.group_id, phase=new
            )
        if self.registry is not None:
            self.registry.record(
                self.group_id, txid, new, groups=rec["groups"]
            )

    # -- restart realism -----------------------------------------------------

    def replay(self, entries: Sequence[bytes]) -> None:
        """Rebuild transaction state from persisted ``SavedTwoPC`` records
        (last record per txid wins — the WAL is append-only)."""
        for entry in entries:
            msg = decode_saved(entry)
            if isinstance(msg, SavedTwoPC):
                self.state[msg.txid] = msg.phase


class _ListWAL:
    """Minimal append-only log backing a participant by default."""

    def __init__(self) -> None:
        self._entries: list[bytes] = []

    def append(self, entry: bytes) -> None:
        self._entries.append(entry)

    @property
    def entries(self) -> list[bytes]:
        return list(self._entries)


class TwoPhaseCoordinator:
    """Drives cross-group transactions by submitting ordered control
    requests to every participant group.

    ``clusters`` maps group id -> anything with ``submit_to_all(raw)``
    (a :class:`~consensus_tpu_torch.testing.app.Cluster`).  The coordinator is a
    plain process in the fault model: :meth:`kill` models a kill -9 —
    every later ``start``/``decide`` is a silent no-op, and recovery goes
    through the replicated participant states (:meth:`recover`).

    ``sentinel_one_sided=True`` plants the classic 2PC coordinator bug —
    commit to the first group, abort to the rest — used by the chaos
    sentinel gate to prove the atomicity invariant actually catches a
    one-sided commit.
    """

    def __init__(
        self,
        clusters: Mapping[str, object],
        registry: CrossGroupRegistry,
        *,
        coordinator_id: str = "coord-0",
        client: str = "txn-coord",
        sentinel_one_sided: bool = False,
    ) -> None:
        self.clusters = dict(clusters)
        self.registry = registry
        self.coordinator_id = coordinator_id
        self.client = client
        self.sentinel_one_sided = sentinel_one_sided
        self.alive = True
        self._rid = 0

    def kill(self) -> None:
        """kill -9: the coordinator stops mid-protocol, leaving in-flight
        transactions to :meth:`recover`."""
        self.alive = False

    def _submit(self, group: str, kind: str, txid: str, groups: Sequence[str]) -> None:
        self._rid += 1
        raw = make_request(
            self.client,
            f"{txid}.{kind}.{group}.{self._rid}",
            twopc_payload(kind, txid, groups, self.coordinator_id),
        )
        self.clusters[group].submit_to_all(raw)

    def start(self, txid: str, groups: Sequence[str]) -> None:
        """Phase 1: submit ``prepare`` to every participant group."""
        if not self.alive:
            return
        groups = tuple(groups)
        for g in groups:
            if g not in self.clusters:
                raise KeyError(f"unknown group {g!r}")
        self.registry.begin(txid, groups, coordinator=self.coordinator_id)
        for g in groups:
            self._submit(g, "prepare", txid, groups)

    def all_prepared(self, txid: str) -> bool:
        tx = self.registry.transactions.get(txid)
        if tx is None or not tx["groups"]:
            return False
        return all(
            tx["decisions"].get(g) in ("prepared",) + TERMINAL_PHASES
            for g in tx["groups"]
        )

    def decide(self, txid: str) -> Optional[str]:
        """Phase 2: ``commit`` everywhere iff every group prepared, else
        ``abort`` everywhere.  Returns the submitted outcome kind."""
        if not self.alive:
            return None
        tx = self.registry.transactions[txid]
        groups = tx["groups"]
        outcome = "commit" if self.all_prepared(txid) else "abort"
        if self.sentinel_one_sided and outcome == "commit" and len(groups) >= 2:
            # Planted bug: a one-sided commit the atomicity invariant must
            # catch (and ddmin must shrink to).
            self._submit(groups[0], "commit", txid, groups)
            for g in groups[1:]:
                self._submit(g, "abort", txid, groups)
            return "commit"
        for g in groups:
            self._submit(g, outcome, txid, groups)
        return outcome

    @classmethod
    def recover(
        cls,
        clusters: Mapping[str, object],
        registry: CrossGroupRegistry,
        txid: str,
        *,
        coordinator_id: str = "coord-recovery",
        client: str = "txn-recovery",
    ) -> str:
        """Presumed-abort recovery after a coordinator death: commit the
        undecided groups only if some group already ordered a commit (the
        dead coordinator had passed its decision point), otherwise abort
        everywhere undecided.  Safe to run repeatedly."""
        tx = registry.transactions.get(txid)
        if tx is None or not tx["groups"]:
            raise KeyError(f"unknown transaction {txid!r}")
        decisions = tx["decisions"]
        outcome = (
            "commit"
            if any(p == "committed" for p in decisions.values())
            else "abort"
        )
        recovery = cls(
            clusters, registry, coordinator_id=coordinator_id, client=client
        )
        for g in tx["groups"]:
            if decisions.get(g) not in TERMINAL_PHASES:
                recovery._submit(g, outcome, txid, tx["groups"])
        return outcome


__all__ = [
    "AtomicityViolation",
    "CrossGroupRegistry",
    "TERMINAL_PHASES",
    "TWOPC_KINDS",
    "TWOPC_MARKER",
    "TwoPhaseCoordinator",
    "TwoPhaseParticipant",
    "parse_twopc_payload",
    "twopc_payload",
]
