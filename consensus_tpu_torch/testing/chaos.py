"""Deterministic chaos engine: schedule DSL, executor, and shrinker.

The randomized soak loops (tests/test_soak.py) interleave their adversary
decisions WITH the run — the ``random.Random`` stream decides each step as
the cluster evolves, so a failure reproduces only by re-running the whole
loop, and no part of it can be removed without perturbing everything after
it.  The chaos engine splits those concerns:

* :class:`ChaosSchedule` — a seed-derived, **sim-clock-anchored** sequence
  of named adversary actions (:class:`ChaosAction`), generated up front.
  The schedule IS the adversary: executing the same schedule yields a
  byte-identical event log and identical final ledgers, and individual
  actions can be deleted without changing when the survivors fire.
* :class:`ChaosEngine` — executes a schedule on a fresh
  :class:`~consensus_tpu_torch.testing.app.Cluster` with an
  :class:`~consensus_tpu_torch.testing.invariants.InvariantMonitor` wired into
  the delivery hooks, checking safety AT EVERY DELIVERY and bounded
  time-to-progress after the last disruptive action.  Violations carry the
  exact sim-time and the action history that led there.
* :func:`shrink` — delta-debugging (ddmin) over the action list: given a
  failing schedule, converge to a minimal action subset that still fails
  with the SAME invariant, and :func:`format_repro` renders it as a
  paste-able snippet.

Adversary vocabulary (``ChaosAction.kind``):

``crash`` / ``restart``         process death and recovery (WAL survives)
``partition`` / ``heal``        link cuts around a group / clear ALL knobs
``loss`` / ``delay``            per-link probabilistic drop / latency
``duplicate`` / ``reorder`` / ``replay``
                                the byzantine-network primitives
                                (testing/network.py)
``byzantine`` / ``byzantine_stop``
                                per-SENDER message mutation (≤ f senders)
``arm_fault``                   arm a WAL/state/sync crash point from the
                                FaultPlan catalog (testing/faults.py)
``add_node`` / ``remove_node``  elastic membership (``generate(churn=True)``
                                only): order a reconfiguration through the
                                protocol itself, then boot the joiner /
                                retire the evictee.  A schedule containing
                                churn actions makes the engine install the
                                membership harness
                                (``install_reconfig_hook``) and turn on
                                ``epoch_tagging``; ``generate(churn=False)``
                                draws a byte-identical schedule to before
                                the vocabulary existed.
``region_partition`` / ``leader_shift``
                                WAN vocabulary (``generate(wan=<profile>)``
                                only).  A WAN schedule pins every node to a
                                region of the named :data:`WAN_PROFILES`
                                entry (round-robin over sorted ids) and the
                                engine arms per-link latency distributions
                                (``set_jitter``: intra-region base+spread vs
                                the profile's inter-region matrix), re-armed
                                after every heal since ``heal()`` clears all
                                knobs.  ``region_partition`` cuts one whole
                                region off; ``leader_shift`` multiplies the
                                base latency of every link INTO one region —
                                the leader-placement sensitivity probe (a
                                leader in the slowed region must hand over
                                or drag commit latency, never violate
                                safety).  ``generate(wan=None)`` draws a
                                byte-identical schedule to before the
                                vocabulary existed.
``device_fault``                device-fault vocabulary
                                (``generate(device_faults=True)`` only): arm
                                the shared verify engine's launch-fault
                                injector so its Kth next launch hangs
                                (:class:`~consensus_tpu_torch.models.supervisor.LaunchTimeout`),
                                raises (an injected XLA launch failure), or
                                flips its verdict bits.  A schedule carrying
                                device-fault actions makes the engine wrap
                                the shared crypto engine in a
                                :class:`FaultInjectingEngine` under an
                                :class:`~consensus_tpu_torch.models.supervisor.EngineSupervisor`
                                (host-twin cross-check every launch), so
                                every injected fault is masked: ledgers and
                                event logs stay byte-identical to the
                                fault-free run.  ``generate(device_faults=
                                False)`` consumes no extra RNG, so pinned
                                schedules replay byte-identically.
``storage_fault``               storage-fault vocabulary
                                (``generate(storage_faults=True)`` only):
                                arm one node's seeded disk-fault injector
                                (testing/storage.py) — a bit flip in a
                                committed WAL region, a torn write at an
                                arbitrary frame offset, a lying fsync
                                (acked bytes dropped at the next crash), an
                                ENOSPC byte budget, read EIO, or transient
                                fsync stalls.  A schedule carrying storage
                                faults runs the cluster on REAL file-backed
                                WALs under a temp dir with the background
                                scrubber (wal/scrub.py) on: a detection
                                quarantines the corrupt suffix and fences
                                the node as a non-voting learner until
                                verified sync carries it past its
                                checkpoint fence (a commit-path delivery
                                while fenced is the ``learner-fence``
                                invariant violation).
                                ``generate(storage_faults=False)`` consumes
                                no extra RNG, so pinned schedules replay
                                byte-identically.
``net_abuse``                   adversarial-network vocabulary
                                (``generate(adversarial_net=True)`` only):
                                a byzantine wire peer abuses one node's
                                listener guard (net/framing.py) — a
                                slow-loris stall flood, a malformed-frame
                                flood, or a connect flood past the
                                per-peer quota.  The sim arm drives a
                                :class:`~consensus_tpu_torch.net.framing
                                .ListenerGuard` directly on the sim clock
                                (scripted, zero sockets, byte-
                                deterministic); the REAL-socket
                                equivalent of the same vocabulary is
                                ``testing/adversary.py``, run tier-1
                                against live listeners and by the deploy
                                rig.  The guard surfaces on the node as
                                ``wire_guard`` so the obs sampler exports
                                its counters and the ``wire_abuse``
                                detector fires; bans land in the event
                                log and trip the flight recorder.
                                ``generate(adversarial_net=False)``
                                consumes no extra RNG, so pinned
                                schedules replay byte-identically.

Everything runs on the SimScheduler's virtual clock — no wall-clock reads
anywhere (scripts/check_no_wallclock.py lints this module too).

The PyTorch port's copy of ``consensus_tpu/testing/chaos.py``, its imports
renamed.  One divergence (ROADMAP.md queue C, divergence 20):
:class:`ChaosEngine` takes a ``device`` and builds its crypto engines on it
(``cuda`` unless the caller names one, as every entry point of the port);
schedules without crypto never resolve a device.
"""

from __future__ import annotations

import dataclasses
import random
import shutil
import tempfile
from typing import Optional

from consensus_tpu_torch.testing.app import Cluster, make_request
from consensus_tpu_torch.testing.faults import FaultPlan
from consensus_tpu_torch.testing.invariants import (
    InvariantMonitor,
    Violation,
    is_known_unresolvable_split,
)
from consensus_tpu_torch.testing.membership import install_reconfig_hook, reconfig_request
from consensus_tpu_torch.testing.storage import (
    STORAGE_FAULT_CLASSES,
    StorageFaultInjector,
)
from consensus_tpu_torch.utils.quorum import compute_quorum
from consensus_tpu_torch.wire import EpochTagged

#: The churn vocabulary: actions that change the member set through an
#: ordered reconfiguration (not a topology knob).
CHURN_KINDS = ("add_node", "remove_node")

#: The WAN vocabulary: region-shaped topology actions, only drawn when a
#: schedule names a geography profile.
WAN_KINDS = ("region_partition", "leader_shift")

#: The device-fault vocabulary: launch-level faults against the shared
#: verify engine (not a node or a link), only drawn when a schedule opts in.
DEVICE_FAULT_KINDS = ("device_fault",)

#: The three injectable launch-fault classes, matching the supervisor's
#: fault taxonomy: ``hang`` -> LaunchTimeout, ``raise`` -> launch raise,
#: ``flip`` -> verdict corruption (caught by the host cross-check).
DEVICE_FAULT_CLASSES = ("hang", "raise", "flip")

#: The storage-fault vocabulary: disk-level faults against one node's
#: file-backed WAL, only drawn when a schedule opts in.  The ``fault`` arg
#: is one of testing/storage.py's :data:`STORAGE_FAULT_CLASSES`.
STORAGE_FAULT_KINDS = ("storage_fault",)

#: The adversarial-network vocabulary: scripted listener-guard abuse
#: against one node's wire edge, only drawn when a schedule opts in.
ADVERSARIAL_NET_KINDS = ("net_abuse",)

#: The scripted abuse batteries a ``net_abuse`` action may run (sim-clock
#: mirrors of the real-socket batteries in testing/adversary.py).
NET_ABUSE_BATTERIES = ("stall_flood", "garbage_flood", "connect_flood")

#: Geography bank: per-profile region names, intra-region link latency
#: ``(base, jitter)`` in sim-seconds, and the inter-region latency matrix
#: keyed on the SORTED region pair.  Values are loosely shaped on public
#: cloud RTT tables — what matters for the harness is the ORDER between
#: them (intra << transatlantic << transpacific), not the digits.
WAN_PROFILES = {
    "3region": {
        "regions": ("us-east", "eu-west", "ap-south"),
        "intra": (0.002, 0.001),
        "inter": {
            ("ap-south", "eu-west"): (0.075, 0.020),
            ("ap-south", "us-east"): (0.110, 0.025),
            ("eu-west", "us-east"): (0.040, 0.010),
        },
    },
    "2region-lopsided": {
        "regions": ("us-east", "ap-south"),
        "intra": (0.002, 0.001),
        "inter": {
            ("ap-south", "us-east"): (0.140, 0.040),
        },
    },
    "global5": {
        "regions": ("us-east", "us-west", "eu-west", "ap-south", "sa-east"),
        "intra": (0.002, 0.001),
        "inter": {
            ("ap-south", "eu-west"): (0.075, 0.020),
            ("ap-south", "sa-east"): (0.160, 0.040),
            ("ap-south", "us-east"): (0.110, 0.025),
            ("ap-south", "us-west"): (0.090, 0.020),
            ("eu-west", "sa-east"): (0.095, 0.025),
            ("eu-west", "us-east"): (0.040, 0.010),
            ("eu-west", "us-west"): (0.065, 0.015),
            ("sa-east", "us-east"): (0.060, 0.015),
            ("sa-east", "us-west"): (0.085, 0.020),
            ("us-east", "us-west"): (0.030, 0.008),
        },
    },
}


def region_map(profile: str, ids) -> dict:
    """node id -> region name: round-robin over SORTED ids, so placement is
    a pure function of (profile, member set) and survives churn."""
    regions = WAN_PROFILES[profile]["regions"]
    return {
        nid: regions[i % len(regions)]
        for i, nid in enumerate(sorted(ids))
    }


def wan_links(profile: str, ids) -> tuple:
    """Every ordered link ``(a, b, base, jitter)`` for the member set under
    ``profile`` — the engine feeds these straight into ``set_jitter``."""
    prof = WAN_PROFILES[profile]
    rmap = region_map(profile, ids)
    intra_base, intra_jitter = prof["intra"]
    links = []
    ordered = sorted(ids)
    for a in ordered:
        for b in ordered:
            if a == b:
                continue
            ra, rb = rmap[a], rmap[b]
            if ra == rb:
                base, jitter = intra_base, intra_jitter
            else:
                base, jitter = prof["inter"][tuple(sorted((ra, rb)))]
            links.append((a, b, base, jitter))
    return tuple(links)

#: The soak suite's fast-timeout profile; chaos runs use the same one so a
#: 25-action schedule finishes in well under a sim-hour.
DEFAULT_TWEAKS = {
    "request_forward_timeout": 1.0,
    "request_complain_timeout": 4.0,
    "request_auto_remove_timeout": 120.0,
    "view_change_resend_interval": 2.0,
    "view_change_timeout": 10.0,
    "leader_heartbeat_timeout": 20.0,
}

#: Crash points the generator arms (all reachable on the in-memory WAL
#: path; the wal.* points need a file-backed cluster and stay out of the
#: default vocabulary).
ARMABLE_POINTS = (
    "state.save.proposed.pre",
    "state.save.proposed.post",
    "state.save.commit.pre",
    "state.save.commit.post",
    "state.save.viewchange.post",
    "state.save.newview.pre",
)


@dataclasses.dataclass(frozen=True)
class ChaosAction:
    """One named adversary action at an absolute sim-time.  The default
    dataclass repr is deliberately paste-able Python (``args`` is a plain
    dict literal) — :func:`format_repro` leans on that."""

    at: float
    kind: str
    args: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """A complete adversary: cluster shape + ordered actions.  Frozen so a
    schedule can be replayed or shrunk without aliasing surprises."""

    seed: int
    n: int = 4
    durability_window: float = 0.0
    actions: tuple = ()
    #: WAN geography profile name (a :data:`WAN_PROFILES` key) or None.
    #: Carried on the schedule so shrunk subsets keep their geography.
    wan: Optional[str] = None
    #: True when the schedule was drawn with the device-fault vocabulary.
    #: Carried so shrunk subsets keep arming the launch-fault injector even
    #: after every ``device_fault`` action was deleted.
    device_faults: bool = False
    #: True when the schedule was drawn with the storage-fault vocabulary.
    #: Carried so shrunk subsets keep the file-backed cluster + scrubber
    #: even after every ``storage_fault`` action was deleted.
    storage_faults: bool = False
    #: True when the schedule was drawn with the adversarial-network
    #: vocabulary.  Carried so shrunk subsets stay recognizable even after
    #: every ``net_abuse`` action was deleted.
    adversarial_net: bool = False

    @classmethod
    def generate(
        cls,
        seed: int,
        *,
        n: int = 4,
        steps: int = 25,
        durability_window: float = 0.0,
        start: float = 30.0,
        churn: bool = False,
        wan: Optional[str] = None,
        device_faults: bool = False,
        storage_faults: bool = False,
        adversarial_net: bool = False,
    ) -> "ChaosSchedule":
        """Derive a feasible schedule from ``seed``: action times are
        cumulative uniform(5, 40) gaps from ``start``, kinds are weighted
        draws constrained so the adversary stays inside the fault model
        (≤ f replicas down or doomed at once, ≤ f byzantine senders).

        ``churn=True`` adds ``add_node`` / ``remove_node`` to the
        vocabulary (bounded: member set never below 4 or more than two
        above ``n``, removes only target live non-byzantine members);
        ``churn=False`` leaves every RNG draw byte-identical to the
        pre-churn generator, so pinned schedules replay unchanged.

        ``wan=<profile>`` (a :data:`WAN_PROFILES` key) pins the geography
        and adds ``region_partition`` / ``leader_shift`` to the vocabulary;
        ``wan=None`` consumes no extra RNG, so pre-WAN schedules replay
        byte-identically.

        ``device_faults=True`` adds ``device_fault`` to the vocabulary:
        launch-level hang/raise/verdict-flip faults against the shared
        verify engine, masked at run time by the engine supervisor;
        ``device_faults=False`` consumes no extra RNG, so pre-device-fault
        schedules replay byte-identically.

        ``storage_faults=True`` adds ``storage_fault`` to the vocabulary:
        seeded disk faults against one node's file-backed WAL
        (testing/storage.py).  A faulted node may fence itself as a
        non-voting learner until verified sync clears it, so storage
        targets share the crash budget (at most ``f`` replicas down or
        suspect at once) and each node is faulted at most once per
        schedule; ``storage_faults=False`` consumes no extra RNG, so
        pre-storage schedules replay byte-identically.

        ``adversarial_net=True`` adds ``net_abuse`` to the vocabulary: a
        byzantine wire peer runs one scripted abuse battery
        (:data:`NET_ABUSE_BATTERIES`) against one node's listener guard.
        Abuse targets the wire EDGE, not the protocol, so it needs no
        feasibility budget — a guarded listener sheds it by design;
        ``adversarial_net=False`` consumes no extra RNG, so pre-hardening
        schedules replay byte-identically."""
        if wan is not None and wan not in WAN_PROFILES:
            raise ValueError(
                f"unknown WAN profile {wan!r}; "
                f"choose from {sorted(WAN_PROFILES)}"
            )
        rng = random.Random(seed)
        ids = list(range(1, n + 1))
        _, f = compute_quorum(n)
        kinds = ["crash", "restart", "partition", "heal", "loss", "delay",
                 "duplicate", "reorder", "replay", "byzantine",
                 "byzantine_stop", "arm_fault"]
        weights = [2.0, 2.0, 1.5, 2.0, 2.0, 1.5, 1.5, 1.5, 1.5, 1.0, 1.0, 1.0]
        if churn:
            kinds += list(CHURN_KINDS)
            weights += [1.2, 1.2]
        if wan is not None:
            kinds += list(WAN_KINDS)
            weights += [1.5, 1.0]
        if device_faults:
            kinds += list(DEVICE_FAULT_KINDS)
            weights += [1.5]
        if storage_faults:
            kinds += list(STORAGE_FAULT_KINDS)
            weights += [1.5]
        if adversarial_net:
            kinds += list(ADVERSARIAL_NET_KINDS)
            weights += [1.5]
        members = set(ids)
        next_id = n + 1
        t = start
        down: set[int] = set()  # crashed or armed-to-crash
        #: Storage-faulted nodes: they may spend sim-time fenced as
        #: non-voting learners, so they count against the crash budget and
        #: are never faulted twice (conservative — most faults heal).
        suspect: set[int] = set()
        byzantine: set[int] = set()
        actions = []
        for _ in range(steps):
            t += rng.uniform(5.0, 40.0)
            if churn:
                # Feasibility tracks the CURRENT member set, not the seed
                # shape: targets are drawn from live members and the fault
                # budget follows the shrunken/grown committee.
                ids = sorted(members)
                _, f = compute_quorum(len(ids))
            kind = rng.choices(kinds, weights)[0]
            if kind == "add_node" and len(members) - n >= 2:
                kind = "remove_node"
            if kind == "remove_node":
                evictable = [i for i in sorted(members)
                             if i not in down and i not in byzantine]
                if len(members) <= 4 or not evictable:
                    kind = "heal"
            # Feasibility downgrades keep every generated action applicable
            # (the engine re-checks at run time anyway — shrunk subsets may
            # still strand a restart whose crash was deleted).
            if kind == "storage_fault":
                targets = [i for i in ids
                           if i not in down and i not in suspect]
                if not targets or len(down) + len(suspect) >= f:
                    kind = "heal"
            if kind in ("crash", "arm_fault") and len(down) + len(suspect) >= f:
                kind = "restart" if down else "heal"
            if kind == "restart" and not down:
                kind = "heal"
            if kind == "byzantine" and len(byzantine) >= max(f, 1):
                kind = "byzantine_stop"
            if kind == "byzantine_stop" and not byzantine:
                kind = "loss"

            if kind == "crash":
                node = rng.choice([i for i in ids if i not in down])
                down.add(node)
                actions.append(ChaosAction(at=t, kind="crash",
                                           args={"node": node}))
            elif kind == "restart":
                node = rng.choice(sorted(down))
                down.discard(node)
                actions.append(ChaosAction(at=t, kind="restart",
                                           args={"node": node}))
            elif kind == "partition":
                group = sorted(rng.sample(ids, rng.choice([1, 1, 2])))
                actions.append(ChaosAction(at=t, kind="partition",
                                           args={"group": tuple(group)}))
            elif kind == "heal":
                actions.append(ChaosAction(at=t, kind="heal"))
            elif kind in ("loss", "duplicate", "reorder", "replay"):
                a, b = rng.sample(ids, 2)
                p = rng.choice([0.1, 0.3, 0.5])
                actions.append(ChaosAction(at=t, kind=kind,
                                           args={"a": a, "b": b, "p": p}))
            elif kind == "delay":
                a, b = rng.sample(ids, 2)
                d = round(rng.uniform(0.05, 0.5), 3)
                actions.append(ChaosAction(at=t, kind="delay",
                                           args={"a": a, "b": b, "d": d}))
            elif kind == "byzantine":
                node = rng.choice([i for i in ids if i not in byzantine])
                byzantine.add(node)
                actions.append(ChaosAction(
                    at=t, kind="byzantine",
                    args={"node": node, "rate": rng.choice([0.3, 0.7])},
                ))
            elif kind == "byzantine_stop":
                byzantine.clear()
                actions.append(ChaosAction(at=t, kind="byzantine_stop"))
            elif kind == "add_node":
                node = next_id
                next_id += 1
                members.add(node)
                actions.append(ChaosAction(at=t, kind="add_node",
                                           args={"node": node}))
            elif kind == "remove_node":
                node = rng.choice(evictable)
                members.discard(node)
                down.discard(node)
                actions.append(ChaosAction(at=t, kind="remove_node",
                                           args={"node": node}))
            elif kind == "region_partition":
                # The concrete group is baked in at generate time so the
                # action repros stand alone (no geography lookup needed).
                rmap = region_map(wan, ids)
                region = rng.choice(sorted(set(rmap.values())))
                group = tuple(sorted(i for i in ids if rmap[i] == region))
                actions.append(ChaosAction(
                    at=t, kind="region_partition",
                    args={"region": region, "group": group},
                ))
            elif kind == "leader_shift":
                rmap = region_map(wan, ids)
                region = rng.choice(sorted(set(rmap.values())))
                actions.append(ChaosAction(
                    at=t, kind="leader_shift",
                    args={"region": region,
                          "factor": rng.choice([2.0, 4.0])},
                ))
            elif kind == "storage_fault":
                node = rng.choice(targets)
                suspect.add(node)
                fault = rng.choice(STORAGE_FAULT_CLASSES)
                args = {"node": node, "fault": fault}
                if fault == "enospc":
                    # A zero budget refuses the very next append; positive
                    # budgets let a few records land first.
                    args["budget"] = rng.choice([0, 256, 1024])
                elif fault in ("eio_read", "slow_fsync"):
                    args["count"] = rng.randrange(1, 4)
                actions.append(ChaosAction(at=t, kind="storage_fault",
                                           args=args))
            elif kind == "device_fault":
                # ``launch`` is RELATIVE: the Kth verify launch after the
                # action applies faults, so the action stays meaningful in
                # shrunk subsets regardless of how many launches preceded it.
                actions.append(ChaosAction(
                    at=t, kind="device_fault",
                    args={"fault": rng.choice(DEVICE_FAULT_CLASSES),
                          "launch": rng.randrange(1, 4)},
                ))
            elif kind == "net_abuse":
                # Abuse hits the wire edge of one node; no feasibility
                # budget (a guarded listener sheds it without protocol
                # involvement, crashed targets are skipped at run time).
                actions.append(ChaosAction(
                    at=t, kind="net_abuse",
                    args={"node": rng.choice(ids),
                          "battery": rng.choice(NET_ABUSE_BATTERIES),
                          "events": rng.randrange(3, 8)},
                ))
            else:  # arm_fault: the armed replica dies at the seam firing
                node = rng.choice([i for i in ids if i not in down])
                down.add(node)
                actions.append(ChaosAction(
                    at=t, kind="arm_fault",
                    args={"node": node,
                          "point": rng.choice(ARMABLE_POINTS),
                          "hit": rng.randrange(1, 4)},
                ))
        return cls(seed=seed, n=n, durability_window=durability_window,
                   actions=tuple(actions), wan=wan,
                   device_faults=device_faults,
                   storage_faults=storage_faults,
                   adversarial_net=adversarial_net)


@dataclasses.dataclass
class ChaosResult:
    """Outcome of one engine run.  ``event_log`` is the full deterministic
    trace of applied actions, violations, and final ledger digests —
    byte-identical across replays of the same schedule."""

    ok: bool
    violation: Optional[Violation]
    event_log: bytes
    ledgers: dict
    schedule: ChaosSchedule
    deliveries: int
    #: Every obs-plane detector firing (obs.Anomaly), in sim-time order.
    #: Empty unless the engine ran with ``obs`` enabled.
    anomalies: tuple = ()
    #: Final per-node health snapshot ({node id (str): health dict}) from
    #: the sampler's last sample.  Empty without ``obs``.
    final_health: dict = dataclasses.field(default_factory=dict)
    #: Flight-recorder bundle path, when a recorder was armed AND triggered.
    flightrec_path: Optional[str] = None


class FaultInjectingEngine:
    """Deterministic launch-fault wrapper around a verify engine.

    Counts ``verify_batch`` launches and, when an armed index comes up,
    models one of the three supervisor fault classes:

    * ``hang``  — raises :class:`~consensus_tpu_torch.models.supervisor.LaunchTimeout`
      (a real thread-hang would wedge the deterministic sim; the timeout
      exception IS how the production watchdog surfaces one).
    * ``raise`` — raises ``RuntimeError`` (an XLA launch failure / device
      loss as the runtime reports it).
    * ``flip``  — lets the launch complete, then inverts every verdict bit
      (silent wrong answers, catchable only by the host cross-check).

    ``verify_host`` passes through UNINJECTED — the host twin is ground
    truth, so a supervisor wrapping this injector masks every fault.  All
    other attributes forward to the wrapped engine.
    """

    def __init__(self, engine) -> None:
        self.engine = engine
        #: Cumulative ``verify_batch`` calls (faulted launches count too).
        self.launches = 0
        #: Faults actually fired, in order: ``(launch index, fault kind)``.
        self.fired: list[tuple[int, str]] = []
        self._armed: dict[int, str] = {}

    def arm(self, launch_offset: int, fault: str) -> None:
        """Arm ``fault`` on the ``launch_offset``-th launch from now."""
        if fault not in DEVICE_FAULT_CLASSES:
            raise ValueError(
                f"unknown device fault {fault!r}; "
                f"choose from {DEVICE_FAULT_CLASSES}"
            )
        self._armed[self.launches + max(1, int(launch_offset))] = fault

    @property
    def pending(self) -> int:
        """Armed faults that have not fired yet."""
        return len(self._armed)

    def verify_batch(self, *args, **kwargs):
        from consensus_tpu_torch.models.supervisor import LaunchTimeout

        self.launches += 1
        fault = self._armed.pop(self.launches, None)
        if fault is not None:
            self.fired.append((self.launches, fault))
        if fault == "hang":
            raise LaunchTimeout(
                f"injected device hang at launch {self.launches}"
            )
        if fault == "raise":
            raise RuntimeError(
                f"injected XLA launch failure at launch {self.launches}"
            )
        out = self.engine.verify_batch(*args, **kwargs)
        if fault == "flip":
            import numpy as np

            return np.logical_not(np.asarray(out))
        return out

    def verify_host(self, *args, **kwargs):
        return self.engine.verify_host(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.engine, name)


class ChaosEngine:
    """Executes one :class:`ChaosSchedule` to a :class:`ChaosResult`."""

    #: Requests submitted alongside each applied action / at warmup / at
    #: the final progress probe.
    REQUESTS_PER_ACTION = 2
    WARMUP_REQUESTS = 4
    PROBE_REQUESTS = 5
    WARMUP_BUDGET = 300.0
    SETTLE_TIME = 60.0
    #: Sim-time allowed for one churn action's reconfiguration to ORDER
    #: (epoch advance observed) and, for removes, for the evictee to
    #: deliver its own eviction and shut down.
    RECONFIG_BUDGET = 300.0
    #: Bounded time-to-progress after the last disruptive action: n - f
    #: replicas must extend the ledger within this much sim-time of the
    #: post-schedule heal (the liveness invariant's budget).
    LIVENESS_BUDGET = 900.0
    #: Scrub cadence on storage-fault runs: short relative to the ≥5s
    #: action gaps, so a latent flip or tear is quarantined (and the node
    #: fenced) before the adversary can crash the node into the boot-time
    #: tail-repair path.
    SCRUB_INTERVAL = 2.0

    def __init__(
        self,
        schedule: ChaosSchedule,
        *,
        config_tweaks: Optional[dict] = None,
        check_durability: bool = True,
        metrics=None,
        tracer=None,
        crypto: Optional[str] = None,
        engine_factory=None,
        obs=None,
        flight_dir: Optional[str] = None,
        device_faults: tuple = (),
        device=None,
    ) -> None:
        """``crypto`` arms REAL Ed25519 on every replica signature path:
        ``"ed25519"`` uses the strict batch engine, ``"ed25519-batch"`` the
        randomized aggregate-check engine (Configuration.batch_verify_mode)
        — node keys are derived from the schedule seed, so two engines run
        on byte-identical schedules and must produce identical ledgers.
        Crypto mode also unlocks a signature-corruption byzantine arm,
        rolled on a dedicated RNG stream so non-crypto schedules replay
        byte-for-byte unchanged.

        ``engine_factory`` (requires ``crypto``) overrides the verification
        engine construction — a zero-arg callable returning any object with
        the ``verify_batch`` contract.  The mesh parity gates use it to run
        the SAME schedule through sharded engines and assert byte-identical
        ledgers/event logs against the single-device run.

        ``device_faults`` arms the launch-fault injector directly from the
        constructor: a tuple of ``(launch_offset, fault)`` pairs (fault in
        :data:`DEVICE_FAULT_CLASSES`), each firing on the given launch
        counted from run start.  Arming is SILENT — no schedule action, no
        event-log line, no RNG draw — so a run with constructor faults must
        stay byte-identical to the clean run (the supervisor masks every
        fault); the device-fault parity matrix is built on exactly that.
        Either form of device faults (constructor pairs or ``device_fault``
        schedule actions) implies a crypto run: ``crypto`` defaults up to
        ``"ed25519"`` when unset.

        ``device`` is where the engines this constructor builds for a crypto
        run live (``cuda`` unless the caller names one); an
        ``engine_factory`` places its own engine."""
        wants_faults = bool(device_faults) or any(
            a.kind in DEVICE_FAULT_KINDS for a in schedule.actions
        )
        #: Storage runs get a real file-backed cluster (temp WAL dir), the
        #: background scrubber, per-node disk-fault injectors, and the
        #: learner-fence invariant wired into the delivery hooks.
        self._wants_storage = schedule.storage_faults or any(
            a.kind in STORAGE_FAULT_KINDS for a in schedule.actions
        )
        self._wal_tmp: Optional[str] = None
        if wants_faults and crypto is None:
            crypto = "ed25519"
        if crypto not in (None, "ed25519", "ed25519-batch", "ed25519-halfagg"):
            raise ValueError(f"unknown chaos crypto mode {crypto!r}")
        if engine_factory is not None and crypto is None:
            raise ValueError("engine_factory requires a crypto mode")
        self.schedule = schedule
        self.config_tweaks = dict(config_tweaks or DEFAULT_TWEAKS)
        if crypto == "ed25519-halfagg":
            # Same strict engine as "ed25519", but every decided quorum is
            # compressed into a half-aggregated QuorumCert — the ledger/
            # event-log parity gate runs the SAME schedule under both modes.
            self.config_tweaks.setdefault("cert_mode", "half-agg")
        #: A schedule carrying churn actions runs with the membership
        #: harness installed and epoch tagging on — stale-epoch traffic
        #: from evictees must be dropped at ingress, not interpreted.
        self._churn = any(a.kind in CHURN_KINDS for a in schedule.actions)
        if self._churn:
            self.config_tweaks.setdefault("epoch_tagging", True)
        self.check_durability = check_durability
        self.metrics = metrics
        self.tracer = tracer
        self.crypto = crypto
        self.engine_factory = engine_factory
        self.device = device
        #: Observability plane: an ``ObsConfig`` (enabled=True) samples the
        #: cluster during the run; detector firings land in the event log
        #: as ANOMALY lines and on ``ChaosResult.anomalies``.  Sampling is
        #: read-only, so ledgers are byte-identical with or without it.
        self.obs = obs
        #: Directory for flight-recorder bundles; None leaves the recorder
        #: unarmed.  Requires ``obs`` for sample/health capture but works
        #: without it (trace + schedule only).
        self.flight_dir = flight_dir
        self.recorder = None
        self.cluster: Optional[Cluster] = None
        self.monitor: Optional[InvariantMonitor] = None
        self._log: list[str] = []
        self._submitted = 0
        self._byz_rules: dict[int, float] = {}
        #: Engine-owned mutation stream, independent of the network's RNG
        #: so arming byzantine mid-run cannot shift loss/duplicate rolls.
        self._byz_rng = random.Random(schedule.seed ^ 0xB12A)
        #: Separate stream for the crypto-only signature-flip arm: never
        #: consulted without ``crypto``, so existing pinned schedules keep
        #: their exact mutation sequence.
        self._sig_rng = random.Random(schedule.seed ^ 0x516)
        #: Active leader_shift ``(region, factor)`` or None — heal clears
        #: it along with every other topology knob.
        self._wan_shift: Optional[tuple] = None
        #: Constructor-armed ``(launch_offset, fault)`` pairs, applied as
        #: soon as the injector exists (before the cluster starts).
        self.device_faults = tuple(device_faults)
        self._wants_faults = wants_faults
        #: The launch-fault injector, its supervisor, and the supervisor's
        #: pinned-metrics bundle (``engine_degrade_total{reason}`` etc.) —
        #: built by ``_install_crypto`` only on device-fault runs.
        self.fault_injector: Optional[FaultInjectingEngine] = None
        self.supervisor = None
        self.engine_metrics = None

    # --- bookkeeping --------------------------------------------------------

    def _emit(self, line: str) -> None:
        self._log.append(line)
        self.monitor.history.append(line)

    def _now(self) -> float:
        return self.cluster.scheduler.now()

    def _submit(self, k: int) -> None:
        for _ in range(k):
            self.cluster.submit_to_all(make_request("chaos", self._submitted))
            self._submitted += 1

    def _fmt_args(self, action: ChaosAction) -> str:
        return " ".join(f"{k}={v!r}" for k, v in sorted(action.args.items()))

    def _apply_wan_links(self) -> None:
        """(Re-)arm the geography: one ``set_jitter`` per ordered member
        link, with an active leader_shift multiplying the base of every
        link INTO the shifted region.  Idempotent; called at start and
        after every heal, since ``heal()`` clears all jitter knobs."""
        if self.schedule.wan is None:
            return
        net = self.cluster.network
        ids = sorted(net.node_ids())
        rmap = region_map(self.schedule.wan, ids)
        shift = self._wan_shift
        for a, b, base, jitter in wan_links(self.schedule.wan, ids):
            if shift is not None and rmap[b] == shift[0]:
                base *= shift[1]
            net.set_jitter(a, b, base, jitter)

    # --- the adversary actions ---------------------------------------------

    def _apply(self, action: ChaosAction) -> bool:
        """Apply one action if currently feasible; False means skipped
        (shrunk subsets legitimately strand restarts, byzantine_stops, and
        churn actions whose prerequisite add/remove was deleted)."""
        net = self.cluster.network
        nodes = self.cluster.nodes
        members = set(net.node_ids())
        _, f = compute_quorum(len(members))
        # The fault budget covers MEMBERS only: an evicted node kept around
        # for its ledger is not a crash the protocol must tolerate.
        dead = sum(
            1 for nid, nd in nodes.items()
            if nid in members and not nd.running
        )
        kind, args = action.kind, action.args
        if kind == "crash":
            node = nodes.get(args["node"])
            if node is None or args["node"] not in members:
                return False
            if not node.running or dead >= f:
                return False
            node.crash()
            return True
        if kind == "restart":
            node = nodes.get(args["node"])
            if node is None or args["node"] not in members or node.running:
                return False
            node.restart()
            return True
        if kind == "partition":
            net.partition(list(args["group"]))
            return True
        if kind == "heal":
            net.heal()
            self._wan_shift = None
            self._apply_wan_links()
            return True
        if kind == "region_partition":
            if self.schedule.wan is None:
                return False
            net.partition(list(args["group"]))
            return True
        if kind == "leader_shift":
            if self.schedule.wan is None:
                return False
            self._wan_shift = (args["region"], args["factor"])
            self._apply_wan_links()
            return True
        if kind == "loss":
            net.set_loss(args["a"], args["b"], args["p"])
            return True
        if kind == "delay":
            net.set_delay(args["a"], args["b"], args["d"])
            return True
        if kind == "duplicate":
            net.set_duplicate(args["a"], args["b"], args["p"])
            return True
        if kind == "reorder":
            net.set_reorder(args["a"], args["b"], args["p"])
            return True
        if kind == "replay":
            net.set_replay(args["a"], args["b"], args["p"])
            return True
        if kind == "byzantine":
            if (args["node"] not in self._byz_rules
                    and len(self._byz_rules) >= max(f, 1)):
                return False
            self._byz_rules[args["node"]] = args["rate"]
            net.mutate_send = self._mutate
            return True
        if kind == "byzantine_stop":
            if not self._byz_rules:
                return False
            self._byz_rules.clear()
            return True
        if kind == "add_node":
            node_id = args["node"]
            if node_id in nodes or node_id in members:
                return False
            if not self._order_reconfig(sorted(members | {node_id})):
                return False
            self.cluster.add_node(node_id)
            self._apply_wan_links()  # geography follows the member set
            return True
        if kind == "remove_node":
            node_id = args["node"]
            node = nodes.get(node_id)
            if node is None or node_id not in members or len(members) <= 4:
                return False
            if not node.running:
                return False  # eviction must be DELIVERED, not assumed
            if not self._order_reconfig(sorted(members - {node_id})):
                return False
            # The evictee delivers its own eviction decision and shuts
            # itself down; only then is retiring the process legitimate.
            self.cluster.scheduler.run_until(
                lambda: node.consensus is None or not node.consensus._running,
                max_time=self.RECONFIG_BUDGET,
            )
            if node.consensus is not None and node.consensus._running:
                return False  # stranded (e.g. partitioned evictee): leave it
            self.cluster.remove_node(node_id)
            self._apply_wan_links()  # geography follows the member set
            return True
        if kind == "arm_fault":
            node = nodes.get(args["node"])
            if node is None or args["node"] not in members:
                return False
            if not node.running or node.fault_plan is not None or dead >= f:
                return False
            plan = FaultPlan(args["point"], on_hit=args["hit"],
                             label=f"chaos@{action.at:.4f}")
            node.arm_fault_plan(plan)
            if self.recorder is not None:
                self.recorder.watch_plan(plan)
            return True
        if kind == "device_fault":
            # Targets the SHARED verify engine, not a member — feasible
            # whenever the injector exists (i.e. any crypto device-fault
            # run; shrunk subsets keep it via schedule.device_faults).
            if self.fault_injector is None:
                return False
            self.fault_injector.arm(args["launch"], args["fault"])
            return True
        if kind == "storage_fault":
            node = nodes.get(args["node"])
            if node is None or args["node"] not in members or not node.running:
                return False
            inj = getattr(node, "storage_injector", None)
            if inj is None:
                return False
            inj.arm(
                args["fault"],
                **{k: v for k, v in args.items() if k in ("budget", "count")},
            )
            return True
        if kind == "net_abuse":
            node = nodes.get(args["node"])
            if node is None or args["node"] not in members or not node.running:
                return False
            self._run_net_abuse(args["node"], node,
                                args["battery"], args["events"])
            return True
        raise ValueError(f"unknown chaos action kind {kind!r}")

    def _run_net_abuse(self, nid, node, battery: str, events: int) -> None:
        """Scripted abuse against ``nid``'s listener guard, on the SIM
        clock (zero sockets, zero RNG, byte-deterministic).  The guard is
        attached lazily as ``node.wire_guard`` so the obs sampler exports
        its counters and the ``wire_abuse`` detector fires; a ban trips
        the flight recorder and lands in the event log."""
        from consensus_tpu_torch.net.framing import ListenerGuard

        guard = getattr(node, "wire_guard", None)
        if guard is None:
            guard = ListenerGuard(
                name=f"sim-{nid}",
                max_conns_per_peer=4,
                clock=self.cluster.scheduler.now,
                on_ban=lambda addr, kind, _nid=nid: self._on_wire_ban(
                    _nid, addr, kind
                ),
            )
            node.wire_guard = guard
        addr = f"10.66.0.{nid}"  # the (simulated) byzantine peer's address
        if battery == "stall_flood":
            for _ in range(events):
                guard.strike(addr, "stall")
        elif battery == "garbage_flood":
            for _ in range(events):
                guard.strike(addr, "garbage")
        elif battery == "connect_flood":
            held = 0
            for _ in range(guard.max_conns_per_peer):
                if guard.admit(addr):
                    held += 1
            for _ in range(events):
                guard.admit(addr)  # over quota (or banned): rejected
            for _ in range(held):
                guard.release(addr)
        else:
            raise ValueError(f"unknown net_abuse battery {battery!r}")

    def _on_wire_ban(self, nid, addr: str, kind: str) -> None:
        self._emit(
            f"{self._now():10.4f} wire-ban node={nid} peer={addr} "
            f"kind={kind}"
        )
        if self.recorder is not None:
            self.recorder.trigger(
                "wire-abuse-ban", node=nid,
                detail=f"peer {addr} banned after {kind}",
            )

    def _order_reconfig(self, target_nodes) -> bool:
        """Submit a membership-change request and run until SOME replica
        surfaces the decision (directory epoch advance).  False means the
        change did not order within the budget — the action is reported
        skipped, though the request stays pooled and may still order later
        (the final probe re-reads the member set, so a late reconfig is
        picked up there)."""
        directory = self.cluster.membership_directory
        before = directory.current_epoch
        self.cluster.submit_to_all(
            reconfig_request(f"chaos-{self._submitted}", target_nodes)
        )
        self._submitted += 1
        return self.cluster.scheduler.run_until(
            lambda: directory.current_epoch > before,
            max_time=self.RECONFIG_BUDGET,
        )

    def _mutate(self, sender: int, target: int, msg):
        """Byzantine-SENDER mutation: messages from an armed sender are
        corrupted at its configured rate.  Validation must shed all of it;
        ≤ f armed senders keeps this inside the threat model.  An
        epoch-tagged envelope is mutated THROUGH: the inner message is
        corrupted and re-wrapped under the sender's original epoch, so the
        byzantine arm keeps attacking the protocol rather than tripping on
        the envelope."""
        rate = self._byz_rules.get(sender)
        if not rate:
            return msg
        if isinstance(msg, EpochTagged):
            inner = self._mutate_body(msg.msg, rate)
            if inner is msg.msg:
                return msg
            return dataclasses.replace(msg, msg=inner)
        return self._mutate_body(msg, rate)

    def _mutate_body(self, msg, rate: float):
        if self.crypto is not None:
            # Crypto-only arm: flip a signature byte — real verification
            # (strict or randomized-batch) must shed it.  Dedicated RNG so
            # the shared _byz_rng stream (and every pinned non-crypto
            # schedule) is untouched.
            sig = getattr(msg, "signature", None)
            value = getattr(sig, "value", None)
            if value and self._sig_rng.random() < rate * 0.5:
                flipped = bytearray(value)
                i = self._sig_rng.randrange(len(flipped))
                flipped[i] ^= 0xFF
                return dataclasses.replace(
                    msg,
                    signature=dataclasses.replace(sig, value=bytes(flipped)),
                )
        if self._byz_rng.random() >= rate:
            return msg
        roll = self._byz_rng.random()
        digest = getattr(msg, "digest", None)
        if isinstance(digest, str) and roll < 0.4:
            return dataclasses.replace(msg, digest="byz-" + digest[:8])
        view = getattr(msg, "view", None)
        if isinstance(view, int) and roll < 0.7:
            return dataclasses.replace(
                msg, view=view + 1 + self._byz_rng.randrange(3)
            )
        seq = getattr(msg, "seq", None)
        if isinstance(seq, int):
            return dataclasses.replace(
                msg, seq=max(0, seq + self._byz_rng.choice([-1, 1, 5]))
            )
        return msg

    def _disarm_faults(self) -> None:
        for node in self.cluster.nodes.values():
            node.fault_plan = None
            if node.wal is not None:
                node.wal.fault_plan = None
            sync = node.synchronizer
            if sync is not None and hasattr(sync, "fault_plan"):
                sync.fault_plan = None
                sync.transport.fault_plan = None

    def _install_crypto(self) -> None:
        """Swap every node's app for a CryptoApp with REAL Ed25519 keys.

        Keys are sha512-derived from the schedule seed (no ambient RNG), so
        a strict-engine run and a randomized-batch run of the SAME schedule
        sign and verify the exact same bytes — ledger divergence between
        them can only come from the verifier, which is what the parity
        gate is hunting.  Node.app survives crash()/restart(), so one
        install covers the whole schedule."""
        import hashlib

        from consensus_tpu_torch.models import Ed25519Signer
        from consensus_tpu_torch.models.ed25519 import (
            Ed25519BatchVerifier,
            Ed25519RandomizedBatchVerifier,
        )
        from consensus_tpu_torch.testing.crypto_app import CryptoApp, SigOnlyVerifier

        if self.engine_factory is not None:
            engine = self.engine_factory()
        elif self.crypto == "ed25519-batch":
            # min_randomized=2 keeps quorum-sized batches on the randomized
            # aggregate path even at chaos scale (n=4 certs).
            engine = Ed25519RandomizedBatchVerifier(
                min_device_batch=10**9, min_randomized=2, device=self.device
            )
        else:
            engine = Ed25519BatchVerifier(
                min_device_batch=10**9, device=self.device
            )
        if self._wants_faults:
            # Device-fault arm: injector under a supervisor whose host twin
            # (the injector's UNINJECTED verify_host) is ground truth.
            # crosscheck_interval=1 cross-checks EVERY launch, so verdict
            # flips are caught on the launch they corrupt and never reach a
            # quorum decision — that is what keeps faulted runs
            # byte-identical to clean ones.  The supervisor's clock is the
            # sim scheduler, so breaker backoff/re-probe run on sim time.
            from consensus_tpu_torch.metrics import InMemoryProvider, Metrics
            from consensus_tpu_torch.models.supervisor import EngineSupervisor

            self.fault_injector = FaultInjectingEngine(engine)
            for launch, fault in self.device_faults:
                self.fault_injector.arm(launch, fault)
            self.engine_metrics = Metrics(InMemoryProvider())
            self.supervisor = EngineSupervisor(
                [self.fault_injector],
                clock=self.cluster.scheduler.now,
                crosscheck_interval=1,
                metrics=self.engine_metrics,
                name="chaos-engine",
            )
            engine = self.supervisor
        signers = {
            nid: Ed25519Signer(
                nid,
                hashlib.sha512(
                    b"ctpu/chaos-key/%d/%d" % (self.schedule.seed, nid)
                ).digest()[:32],
            )
            for nid in self.cluster.nodes
        }
        keys = {nid: s.public_bytes for nid, s in signers.items()}
        for nid, node in self.cluster.nodes.items():
            node.app = CryptoApp(
                nid, self.cluster, signers[nid],
                SigOnlyVerifier(keys, engine=engine),
            )
            if self.supervisor is not None:
                # Obs surface: the sampler reads node.engine_supervisor to
                # export engine_degraded / engine_rung health fields.
                node.engine_supervisor = self.supervisor
            if self.crypto == "ed25519-halfagg":
                self._arm_halfagg_byz(nid, node.app)

    def _arm_halfagg_byz(self, nid: int, app) -> None:
        """Half-agg byzantine arm: when this node has a byzantine rule armed,
        occasionally corrupt ONE component signature inside an otherwise
        valid quorum right before aggregation.  The aggregator's self-check
        must catch it, the bisection fallback must localize the bad index,
        and the view degrades to the full signature tuple — ledgers stay
        clean.  Rolls ride the crypto-only ``_sig_rng`` stream; honest runs
        (no byzantine rule) consume NO rolls, keeping honest half-agg
        schedules replayable against other crypto modes."""
        inner = app.aggregate_cert

        def aggregate_cert(proposal, signatures, _inner=inner, _nid=nid):
            rate = self._byz_rules.get(_nid)
            if rate and signatures and self._sig_rng.random() < rate * 0.5:
                sigs = list(signatures)
                i = self._sig_rng.randrange(len(sigs))
                flipped = bytearray(sigs[i].value)
                flipped[self._sig_rng.randrange(len(flipped))] ^= 0xFF
                sigs[i] = dataclasses.replace(sigs[i], value=bytes(flipped))
                return _inner(proposal, tuple(sigs))
            return _inner(proposal, signatures)

        app.aggregate_cert = aggregate_cert

    def _on_corruption(self, node_id: int, recovery) -> None:
        """Cluster corruption hook: a scrub detection quarantined a corrupt
        suffix and the node fenced itself.  Log it deterministically (counts
        only — never temp paths), heal that node's injector (the fault is
        consumed), and snapshot a flight record when one is armed."""
        self._emit(
            f"{self._now():10.4f} QUARANTINE node={node_id} "
            f"files={len(recovery.quarantined)} "
            f"intact={recovery.intact_entries}"
        )
        node = self.cluster.nodes.get(node_id)
        inj = getattr(node, "storage_injector", None)
        if inj is not None:
            inj.heal()
        if self.recorder is not None:
            self.recorder.trigger(
                "wal-corruption", node=node_id, detail=recovery.reason
            )

    def _check_learner_fence(self, node_id: int, decision) -> None:
        """Delivery-hook invariant: a replica whose WAL lost durable records
        must not commit (= must not have voted) until verified sync carried
        it past its fence.  Sync appends bypass deliver(), so any commit-path
        delivery while ``fence_required()`` means the fence leaked a vote."""
        node = self.cluster.nodes.get(node_id)
        cons = node.consensus if node is not None else None
        if (
            cons is not None
            and cons.controller is not None
            and cons.controller.fence_required()
        ):
            self.monitor.record(
                "learner-fence", node_id,
                "commit-path delivery while fenced as a non-voting learner "
                "(voted before verified sync passed the last intact record)",
            )

    # --- the run ------------------------------------------------------------

    def run(self) -> ChaosResult:
        if self._wants_storage:
            self._wal_tmp = tempfile.mkdtemp(prefix="chaos-wal-")
        try:
            return self._run()
        finally:
            if self._wal_tmp is not None:
                shutil.rmtree(self._wal_tmp, ignore_errors=True)
                self._wal_tmp = None

    def _run(self) -> ChaosResult:
        sched = self.schedule
        self.cluster = Cluster(
            sched.n,
            seed=sched.seed ^ 0xCA05,
            config_tweaks=self.config_tweaks,
            durability_window=sched.durability_window,
            wal_dir=self._wal_tmp,
            scrub_interval=(
                self.SCRUB_INTERVAL if self._wants_storage else None
            ),
            obs=self.obs,
        )
        if self._churn:
            install_reconfig_hook(self.cluster)
        if self.metrics is not None:
            self.cluster.network.metrics = self.metrics.network
        if self.tracer is not None:
            self.cluster.network.tracer = self.tracer
        if self.crypto is not None:
            self._install_crypto()
        self.monitor = InvariantMonitor(
            self.cluster, check_durability=self.check_durability
        )
        if self._wants_storage:
            for nid, node in self.cluster.nodes.items():
                # One private RNG stream per node, derived from the schedule
                # seed: fault targeting replays byte-identically.
                node.storage_injector = StorageFaultInjector(
                    seed=sched.seed ^ 0x570A ^ (nid * 7919)
                )
            self.cluster.corruption_hooks.append(self._on_corruption)
            self.cluster.delivery_hooks.append(self._check_learner_fence)
        sampler = self.cluster.sampler
        if sampler is not None:
            if self.tracer is not None:
                sampler.tracer = self.tracer
            # Detector firings land in the deterministic event log with the
            # same sim-time stamp format as adversary actions.
            sampler.on_anomaly.append(
                lambda a: self._emit(
                    f"{a.sim_time:10.4f} ANOMALY {a.kind} node={a.node} "
                    f"{a.detail}"
                )
            )
        if self.flight_dir is not None:
            from consensus_tpu_torch.obs.flightrec import FlightRecorder

            self.recorder = FlightRecorder(
                seed=sched.seed,
                out_dir=self.flight_dir,
                clock=self.cluster.scheduler.now,
                sampler=sampler,
                tracer=self.tracer,
                schedule=sched,
                last_n=(
                    self.obs.flight_samples if self.obs is not None else 64
                ),
            )
            self.recorder.attach_scheduler(self.cluster.scheduler)
            self.recorder.attach_monitor(self.monitor)
        self.cluster.start()
        self._apply_wan_links()
        self._emit(f"{self._now():10.4f} start n={sched.n} seed={sched.seed} "
                   f"window={sched.durability_window!r}"
                   + (f" wan={sched.wan}" if sched.wan else ""))

        # Warm up: the cluster must order a block before the adversary acts.
        self._submit(self.WARMUP_REQUESTS)
        if not self.cluster.run_until_ledger(1, max_time=self.WARMUP_BUDGET):
            self.monitor.record(
                "liveness", None,
                f"no block ordered within {self.WARMUP_BUDGET}s sim-time "
                "BEFORE any adversary action",
            )
        self._emit(f"{self._now():10.4f} warmup done")

        for action in sched.actions:
            if self.monitor.violations:
                break
            gap = action.at - self._now()
            if gap > 0:
                self.cluster.scheduler.advance(gap)
            if self.monitor.violations:
                break
            applied = self._apply(action)
            self._emit(
                f"{self._now():10.4f} "
                f"{'apply' if applied else 'skip '} "
                f"{action.kind} {self._fmt_args(action)}".rstrip()
            )
            self._submit(self.REQUESTS_PER_ACTION)

        if not self.monitor.violations:
            # Quiesce: adversary off, every MEMBER back, then LIVENESS —
            # m - f member replicas must make progress within the budget
            # (m follows the final member set under churn; a retired
            # evictee is neither restarted nor counted).
            self.cluster.network.heal()
            self._wan_shift = None
            self._apply_wan_links()
            self.cluster.network.mutate_send = None
            self._byz_rules.clear()
            self._disarm_faults()
            if self._wants_storage:
                # The disks heal (pending arms cleared; the suspect latch
                # survives so a lie-truncated node still boots fenced) and
                # degraded WALs recover on their probe during the settle.
                for node in self.cluster.nodes.values():
                    inj = getattr(node, "storage_injector", None)
                    if inj is not None:
                        inj.heal()
            members = set(self.cluster.network.node_ids())
            for nid, node in self.cluster.nodes.items():
                if nid in members and not node.running:
                    node.restart()
            self._emit(f"{self._now():10.4f} quiesce: healed + restarted")
            self.cluster.scheduler.advance(self.SETTLE_TIME)
            members = set(self.cluster.network.node_ids())
            m = len(members)
            member_nodes = [
                nd for nid, nd in self.cluster.nodes.items() if nid in members
            ]
            _, f = compute_quorum(m)
            floor = max(len(nd.app.ledger) for nd in member_nodes)
            self._submit(self.PROBE_REQUESTS)
            target = floor + 1
            progressed = self.cluster.scheduler.run_until(
                lambda: sum(
                    1 for nd in member_nodes
                    if len(nd.app.ledger) >= target
                ) >= m - f,
                max_time=self.LIVENESS_BUDGET,
            )
            if not progressed and not is_known_unresolvable_split(
                self.cluster, m
            ):
                self.monitor.record(
                    "liveness", None,
                    f"{m - f} replicas failed to reach height {target} "
                    f"within {self.LIVENESS_BUDGET}s sim-time of the final "
                    "heal (and the stall is not a known-unresolvable "
                    "prepared split)",
                )
            self.monitor._check_prefix_agreement()

        violation = self.monitor.first
        if violation is not None:
            self._emit(
                f"{violation.sim_time:10.4f} VIOLATION {violation.invariant}: "
                f"{violation.detail}"
            )
        ledgers = {
            nid: tuple(d.proposal.digest() for d in node.app.ledger)
            for nid, node in sorted(self.cluster.nodes.items())
        }
        for nid, digests in ledgers.items():
            tail = ",".join(digests[-3:])
            self._emit(f"{self._now():10.4f} ledger {nid} "
                       f"height={len(digests)} tail={tail}")
        sampler = self.cluster.sampler
        if sampler is not None:
            # One closing sample so the final health snapshot reflects the
            # post-quiesce state (deterministic: always exactly here).
            sampler.sample_now()
        return ChaosResult(
            ok=violation is None,
            violation=violation,
            event_log="\n".join(self._log).encode() + b"\n",
            ledgers=ledgers,
            schedule=sched,
            deliveries=self.monitor.deliveries,
            anomalies=tuple(sampler.anomalies) if sampler is not None else (),
            final_health=sampler.latest_health() if sampler is not None else {},
            flightrec_path=(
                self.recorder.path if self.recorder is not None else None
            ),
        )


# --- shrinking -------------------------------------------------------------


def _run_subset(schedule: ChaosSchedule, actions, engine_kwargs) -> ChaosResult:
    sub = dataclasses.replace(schedule, actions=tuple(actions))
    return ChaosEngine(sub, **engine_kwargs).run()


def shrink(
    schedule: ChaosSchedule,
    *,
    invariant: Optional[str] = None,
    engine_kwargs: Optional[dict] = None,
    max_runs: int = 200,
) -> tuple[ChaosSchedule, ChaosResult]:
    """Delta-debug (ddmin) a failing schedule down to a minimal action
    subset that still violates the SAME invariant.

    ``invariant`` defaults to whatever the full schedule violates (the
    full run happens first either way, to anchor the target); shrinking a
    passing schedule raises.  ``max_runs`` bounds the engine executions —
    each is a full deterministic sim, so this is a time cap, not a
    correctness knob.  Returns ``(shrunk_schedule, failing_result)``."""
    kwargs = dict(engine_kwargs or {})
    runs = [0]

    def failing(actions) -> Optional[ChaosResult]:
        if runs[0] >= max_runs:
            return None
        runs[0] += 1
        res = _run_subset(schedule, actions, kwargs)
        if res.violation is not None and (
            invariant is None or res.violation.invariant == invariant
        ):
            return res
        return None

    best_res = failing(schedule.actions)
    if best_res is None:
        raise ValueError(
            "schedule does not fail"
            + (f" with invariant {invariant!r}" if invariant else "")
            + " — nothing to shrink"
        )
    if invariant is None:
        invariant = best_res.violation.invariant
    best = list(schedule.actions)

    granularity = 2
    while len(best) >= 2:
        chunk = max(1, len(best) // granularity)
        reduced = False
        i = 0
        while i < len(best):
            candidate = best[:i] + best[i + chunk:]  # drop one chunk
            res = failing(candidate)
            if res is not None:
                best, best_res = candidate, res
                granularity = max(granularity - 1, 2)
                reduced = True
            else:
                i += chunk
        if not reduced:
            if granularity >= len(best):
                break
            granularity = min(len(best), granularity * 2)
        if runs[0] >= max_runs:
            break
    return dataclasses.replace(schedule, actions=tuple(best)), best_res


def format_repro(result: ChaosResult) -> str:
    """A paste-able snippet reproducing ``result``'s schedule byte-for-byte
    (drop it in a test or a REPL; the engine is fully deterministic)."""
    s = result.schedule
    lines = [
        "from consensus_tpu_torch.testing.chaos import (",
        "    ChaosAction, ChaosEngine, ChaosSchedule,",
        ")",
        "",
        "schedule = ChaosSchedule(",
        f"    seed={s.seed!r},",
        f"    n={s.n!r},",
        f"    durability_window={s.durability_window!r},",
        f"    wan={s.wan!r},",
        f"    device_faults={s.device_faults!r},",
        f"    storage_faults={s.storage_faults!r},",
        f"    adversarial_net={s.adversarial_net!r},",
        "    actions=(",
    ]
    for a in s.actions:
        lines.append(f"        {a!r},")
    lines += [
        "    ),",
        ")",
        "result = ChaosEngine(schedule).run()",
        "print(result.violation or 'run is clean')",
    ]
    return "\n".join(lines)


__all__ = [
    "ADVERSARIAL_NET_KINDS",
    "ARMABLE_POINTS",
    "CHURN_KINDS",
    "ChaosAction",
    "ChaosEngine",
    "ChaosResult",
    "ChaosSchedule",
    "DEFAULT_TWEAKS",
    "DEVICE_FAULT_CLASSES",
    "DEVICE_FAULT_KINDS",
    "FaultInjectingEngine",
    "NET_ABUSE_BATTERIES",
    "STORAGE_FAULT_CLASSES",
    "STORAGE_FAULT_KINDS",
    "WAN_KINDS",
    "WAN_PROFILES",
    "format_repro",
    "region_map",
    "shrink",
    "wan_links",
]
