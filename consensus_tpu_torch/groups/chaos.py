"""Seeded cross-group chaos: faults composed per-group, judged shard-wide.

The single-group chaos engine (:mod:`consensus_tpu_torch.testing.chaos`) attacks
one cluster; this engine attacks a :class:`ShardedCluster` mid-way through
a cross-group 2PC transaction with a vocabulary scoped PER GROUP — a
partition in group A's SimNetwork never touches group B — plus the one
genuinely cross-group fault: killing the transaction coordinator (a plain
process, kill -9 in deployment terms).

Run shape (fully deterministic on the shared sim clock):

1. **Warm up** every group to its first ordered block.
2. **Start** a cross-group transaction spanning the first two groups
   (prepare submitted to both quorums).
3. **Apply the schedule** — crash/restart/partition/heal/delay inside a
   chosen group, or ``kill_coordinator`` — interleaved with filler
   requests so every group keeps ordering.
4. **Quiesce**: heal every group, restart crashed members, settle.
5. **Resolve**: a live coordinator decides (commit iff both groups
   prepared); a killed one is replaced by presumed-abort recovery over the
   replicated participant states.  The run then waits for BOTH groups to
   reach the same terminal phase.
6. **Verdict**: per-group invariant monitors (which mirror the shared
   :class:`CrossGroupRegistry`'s atomicity check at every delivery) must
   be clean, the transaction must resolve with agreement, and every group
   must make post-heal progress.

``sentinel_one_sided=True`` plants the classic coordinator bug (commit to
one group, abort to the other); :func:`shrink_group_schedule` ddmins a
failing schedule to a minimal action subset, and :func:`format_group_repro`
emits a paste-able reproduction.

The PyTorch port's copy of ``consensus_tpu/groups/chaos.py``, its imports renamed.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional

from consensus_tpu_torch.groups.cluster import ShardedCluster
from consensus_tpu_torch.groups.twopc import TwoPhaseCoordinator
from consensus_tpu_torch.testing.app import make_request
from consensus_tpu_torch.utils.quorum import compute_quorum

#: The cross-group adversary vocabulary.  Per-group kinds carry a
#: ``group`` arg; ``kill_coordinator`` is shard-wide.
GROUP_CHAOS_KINDS = (
    "kill_coordinator",
    "partition_leader",
    "crash",
    "restart",
    "heal",
    "delay",
)


@dataclasses.dataclass(frozen=True)
class GroupChaosAction:
    """One adversary action at an absolute sim-time (repr is paste-able
    Python, same contract as testing.chaos.ChaosAction)."""

    at: float
    kind: str
    args: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class GroupChaosSchedule:
    """A complete cross-group adversary: shard shape + ordered actions."""

    seed: int
    n_groups: int = 2
    n: int = 4
    actions: tuple = ()

    @classmethod
    def generate(
        cls,
        seed: int,
        *,
        n_groups: int = 2,
        n: int = 4,
        steps: int = 8,
        start: float = 10.0,
    ) -> "GroupChaosSchedule":
        """Derive a feasible schedule from ``seed``: cumulative uniform
        (4, 25) gaps, per-group targets, at most ``f`` replicas down per
        group at once, and at most one ``kill_coordinator`` per schedule
        (a process dies once)."""
        if n_groups < 2:
            raise ValueError("cross-group chaos needs at least two groups")
        rng = random.Random(seed)
        gids = [f"group-{i}" for i in range(n_groups)]
        ids = list(range(1, n + 1))
        _, f = compute_quorum(n)
        kinds = list(GROUP_CHAOS_KINDS)
        weights = [1.0, 1.5, 1.5, 1.5, 1.5, 1.5]
        down: dict[str, set] = {g: set() for g in gids}
        killed = False
        t = start
        actions = []
        for _ in range(steps):
            t += rng.uniform(4.0, 25.0)
            kind = rng.choices(kinds, weights)[0]
            gid = rng.choice(gids)
            if kind == "kill_coordinator" and killed:
                kind = "heal"
            if kind == "crash" and len(down[gid]) >= f:
                kind = "restart" if down[gid] else "heal"
            if kind == "restart" and not down[gid]:
                kind = "heal"

            if kind == "kill_coordinator":
                killed = True
                actions.append(GroupChaosAction(at=t, kind="kill_coordinator"))
            elif kind == "partition_leader":
                # Isolate the group's CURRENT view-1 leader (node 1 at
                # boot); the group must view-change around it while the
                # 2PC prepare is in flight.
                actions.append(GroupChaosAction(
                    at=t, kind="partition_leader", args={"group": gid},
                ))
            elif kind == "crash":
                node = rng.choice([i for i in ids if i not in down[gid]])
                down[gid].add(node)
                actions.append(GroupChaosAction(
                    at=t, kind="crash", args={"group": gid, "node": node},
                ))
            elif kind == "restart":
                node = rng.choice(sorted(down[gid]))
                down[gid].discard(node)
                actions.append(GroupChaosAction(
                    at=t, kind="restart", args={"group": gid, "node": node},
                ))
            elif kind == "delay":
                a, b = rng.sample(ids, 2)
                d = round(rng.uniform(0.05, 0.4), 3)
                actions.append(GroupChaosAction(
                    at=t, kind="delay",
                    args={"group": gid, "a": a, "b": b, "d": d},
                ))
            else:  # heal
                actions.append(GroupChaosAction(
                    at=t, kind="heal", args={"group": gid},
                ))
        return cls(seed=seed, n_groups=n_groups, n=n, actions=tuple(actions))


@dataclasses.dataclass
class GroupChaosResult:
    """Outcome of one cross-group run.  ``resolution`` maps the two
    participant groups to their terminal phase; agreement is the verdict."""

    ok: bool
    violation: Optional[object]  # testing.invariants.Violation or None
    event_log: bytes
    ledgers: dict  # group id -> {node id: (digests...)}
    schedule: GroupChaosSchedule
    resolution: dict  # group id -> phase (participant view)
    txid: str
    deliveries: int


class GroupChaosEngine:
    """Executes one :class:`GroupChaosSchedule` to a :class:`GroupChaosResult`."""

    REQUESTS_PER_ACTION = 1
    WARMUP_REQUESTS = 3
    WARMUP_BUDGET = 300.0
    SETTLE_TIME = 60.0
    RESOLVE_BUDGET = 600.0
    LIVENESS_BUDGET = 900.0

    def __init__(
        self,
        schedule: GroupChaosSchedule,
        *,
        config_tweaks: Optional[dict] = None,
        sentinel_one_sided: bool = False,
        metrics=None,
    ) -> None:
        # Same leaner timers the single-group chaos engine runs with.
        from consensus_tpu_torch.testing.chaos import DEFAULT_TWEAKS

        self.schedule = schedule
        self.config_tweaks = dict(
            config_tweaks if config_tweaks is not None else DEFAULT_TWEAKS
        )
        self.sentinel_one_sided = sentinel_one_sided
        self.metrics = metrics
        self.shard: Optional[ShardedCluster] = None
        self._log: list[str] = []
        self._fill = 0

    # -- bookkeeping ---------------------------------------------------------

    def _emit(self, line: str) -> None:
        self._log.append(line)
        for monitor in self.shard.monitors.values():
            monitor.history.append(line)

    def _now(self) -> float:
        return self.shard.scheduler.now()

    def _fill_requests(self, k: int) -> None:
        """Keep every group ordering: k plain requests per group."""
        for gid, cluster in self.shard.groups.items():
            for _ in range(k):
                self._fill += 1
                cluster.submit_to_all(
                    make_request(f"fill-{gid}", self._fill)
                )

    def _first_violation(self):
        for gid in sorted(self.shard.monitors):
            monitor = self.shard.monitors[gid]
            if monitor.violations:
                return monitor.violations[0]
        return None

    # -- actions -------------------------------------------------------------

    def _apply(self, action: GroupChaosAction) -> bool:
        kind, args = action.kind, action.args
        if kind == "kill_coordinator":
            if not self.shard.coordinator.alive:
                return False
            self.shard.coordinator.kill()
            return True
        cluster = self.shard.groups.get(args.get("group"))
        if cluster is None:
            return False
        _, f = compute_quorum(len(cluster.nodes))
        dead = sum(1 for nd in cluster.nodes.values() if not nd.running)
        if kind == "partition_leader":
            cluster.network.partition([1])
            return True
        if kind == "crash":
            node = cluster.nodes.get(args["node"])
            if node is None or not node.running or dead >= f:
                return False
            node.crash()
            return True
        if kind == "restart":
            node = cluster.nodes.get(args["node"])
            if node is None or node.running:
                return False
            node.restart()
            return True
        if kind == "delay":
            cluster.network.set_delay(args["a"], args["b"], args["d"])
            return True
        if kind == "heal":
            cluster.network.heal()
            return True
        return False

    # -- the run -------------------------------------------------------------

    def run(self) -> GroupChaosResult:
        sched = self.schedule
        self.shard = ShardedCluster(
            sched.n_groups,
            n=sched.n,
            seed=sched.seed ^ 0xCA05,
            config_tweaks=self.config_tweaks,
            metrics=self.metrics,
        )
        shard = self.shard
        shard.coordinator.sentinel_one_sided = self.sentinel_one_sided
        shard.start()
        self._emit(
            f"{self._now():10.4f} start groups={sched.n_groups} n={sched.n} "
            f"seed={sched.seed}"
            + (" sentinel=one-sided" if self.sentinel_one_sided else "")
        )

        # Warm up: every group orders a block before the adversary acts.
        self._fill_requests(self.WARMUP_REQUESTS)
        if not shard.run_until_heights(1, max_time=self.WARMUP_BUDGET):
            for gid, monitor in shard.monitors.items():
                if shard.heights()[gid] < 1:
                    monitor.record(
                        "liveness", None,
                        f"[{gid}] no block ordered within "
                        f"{self.WARMUP_BUDGET}s sim-time BEFORE any action",
                    )
        self._emit(f"{self._now():10.4f} warmup done heights={shard.heights()}")

        # The transaction under attack: spans the first two groups.
        gids = shard.group_ids()
        participants = (gids[0], gids[1])
        txid = f"tx-{sched.seed}"
        shard.coordinator.start(txid, participants)
        self._emit(
            f"{self._now():10.4f} 2pc start txid={txid} "
            f"groups={list(participants)}"
        )

        for action in sched.actions:
            if self._first_violation() is not None:
                break
            gap = action.at - self._now()
            if gap > 0:
                shard.scheduler.advance(gap)
            if self._first_violation() is not None:
                break
            applied = self._apply(action)
            self._emit(
                f"{self._now():10.4f} "
                f"{'apply' if applied else 'skip '} "
                f"{action.kind} {action.args if action.args else ''}".rstrip()
            )
            self._fill_requests(self.REQUESTS_PER_ACTION)

        if self._first_violation() is None:
            # Quiesce: every group heals, every member restarts, settle.
            for cluster in shard.groups.values():
                cluster.network.heal()
                for node in cluster.nodes.values():
                    if not node.running:
                        node.restart()
            self._emit(f"{self._now():10.4f} quiesce: healed + restarted")
            shard.scheduler.advance(self.SETTLE_TIME)

            # Resolution: live coordinator decides; a killed one is
            # replaced by presumed-abort recovery over replicated state.
            coordinator = shard.coordinator
            if coordinator.alive:
                shard.run_until(
                    lambda: coordinator.all_prepared(txid),
                    max_time=self.RESOLVE_BUDGET,
                )
                outcome = coordinator.decide(txid)
                self._emit(f"{self._now():10.4f} coordinator decide {outcome}")
            else:
                outcome = TwoPhaseCoordinator.recover(
                    shard.groups, shard.registry, txid
                )
                self._emit(f"{self._now():10.4f} recovery decide {outcome}")
            shard.run_until(
                lambda: shard.registry.resolved(txid) is not None
                or shard.registry.violations,
                max_time=self.RESOLVE_BUDGET,
            )
            if (
                shard.registry.resolved(txid) is None
                and not shard.registry.violations
            ):
                tx = shard.registry.transactions.get(txid, {})
                for gid in participants:
                    shard.monitors[gid].record(
                        "liveness", None,
                        f"[{gid}] 2pc {txid} unresolved "
                        f"{self.RESOLVE_BUDGET}s after the decision "
                        f"(decisions so far: {tx.get('decisions')})",
                    )

        if self._first_violation() is None:
            # Post-heal liveness: every group must still make progress.
            floors = shard.heights()
            self._fill_requests(2)
            progressed = shard.run_until_heights(
                {g: h + 1 for g, h in floors.items()},
                max_time=self.LIVENESS_BUDGET,
            )
            if not progressed:
                heights = shard.heights()
                for gid, monitor in shard.monitors.items():
                    if heights[gid] < floors[gid] + 1:
                        monitor.record(
                            "liveness", None,
                            f"[{gid}] no post-heal progress within "
                            f"{self.LIVENESS_BUDGET}s sim-time",
                        )

        violation = self._first_violation()
        if violation is not None:
            self._emit(
                f"{violation.sim_time:10.4f} VIOLATION {violation.invariant}: "
                f"{violation.detail}"
            )
        resolution = {
            gid: shard.participants[gid].state.get(txid)
            for gid in participants
        }
        ledgers = shard.ledger_digests()
        for gid, by_node in ledgers.items():
            height = len(by_node[1])
            self._emit(f"{self._now():10.4f} ledger {gid} height={height}")
        return GroupChaosResult(
            ok=violation is None,
            violation=violation,
            event_log="\n".join(self._log).encode() + b"\n",
            ledgers=ledgers,
            schedule=sched,
            resolution=resolution,
            txid=txid,
            deliveries=sum(
                m.deliveries for m in shard.monitors.values()
            ),
        )


# --- shrinking --------------------------------------------------------------


def shrink_group_schedule(
    schedule: GroupChaosSchedule,
    *,
    invariant: Optional[str] = None,
    engine_kwargs: Optional[dict] = None,
    max_runs: int = 60,
) -> tuple[GroupChaosSchedule, GroupChaosResult]:
    """ddmin a failing cross-group schedule to a minimal action subset
    still violating the same invariant (same contract as
    ``testing.chaos.shrink``)."""
    kwargs = dict(engine_kwargs or {})
    runs = [0]

    def failing(actions) -> Optional[GroupChaosResult]:
        if runs[0] >= max_runs:
            return None
        runs[0] += 1
        sub = dataclasses.replace(schedule, actions=tuple(actions))
        res = GroupChaosEngine(sub, **kwargs).run()
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
            candidate = best[:i] + best[i + chunk:]
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
    # A sentinel failure needs no actions at all: try the empty schedule.
    if best:
        res = failing(())
        if res is not None:
            best, best_res = [], res
    return dataclasses.replace(schedule, actions=tuple(best)), best_res


def format_group_repro(result: GroupChaosResult) -> str:
    """A paste-able snippet reproducing ``result``'s schedule byte-for-byte."""
    s = result.schedule
    lines = [
        "from consensus_tpu_torch.groups.chaos import (",
        "    GroupChaosAction, GroupChaosEngine, GroupChaosSchedule,",
        ")",
        "",
        "schedule = GroupChaosSchedule(",
        f"    seed={s.seed!r},",
        f"    n_groups={s.n_groups!r},",
        f"    n={s.n!r},",
        "    actions=(",
    ]
    for a in s.actions:
        lines.append(f"        {a!r},")
    lines += [
        "    ),",
        ")",
        "result = GroupChaosEngine(schedule).run()",
        "print(result.violation or 'run is clean')",
    ]
    return "\n".join(lines)


__all__ = [
    "GROUP_CHAOS_KINDS",
    "GroupChaosAction",
    "GroupChaosEngine",
    "GroupChaosResult",
    "GroupChaosSchedule",
    "format_group_repro",
    "shrink_group_schedule",
]
