"""Process-level chaos vocabulary for the deployment rig.

The earlier chaos planes speak in dropped frames, corrupted sectors
and faulted device calls.  This one speaks in *processes*
— the unit an operator actually loses:

* ``kill9_leader`` / ``kill9_follower`` — SIGKILL the current leader (the
  view-change path) or a random non-leader (the quorum-margin path); the
  supervisor restarts the victim, which rejoins through verified sync off
  its intact WAL,
* ``kill9_sidecar`` — SIGKILL a verifier fleet member; replicas reroute
  through the placement layer's structured fleet path,
* ``freeze`` / (auto-``thaw``) — SIGSTOP a replica: alive to the kernel,
  dead to the protocol, exactly the grey-failure shape restarts don't fix,
* ``listener_drop`` / (auto-``restore``) — close a replica's consensus
  listen port so inbound peers see connection-refused while its outbound
  links stay up (asymmetric partition), exercising the hardened reconnect
  path,
* ``storage_fault`` — arm one storage fault (torn write, fsync lie,
  ENOSPC…) on a replica's WAL through its control socket.

:class:`ProcessChaosSchedule` draws these from a seeded RNG so a soak run
is replayable: same seed, same victim sequence.  All state transitions go
through the launcher, which is the single holder of process handles.

The PyTorch port's copy of ``consensus_tpu/deploy/chaos.py``, its imports renamed.
"""

from __future__ import annotations

import logging
import random
from typing import Optional

logger = logging.getLogger("consensus_tpu_torch.deploy")

#: The process-chaos vocabulary, weighted roughly by how often the
#: corresponding outage shape occurs in the wild (crashes dominate).
DEFAULT_ACTION_WEIGHTS = {
    "kill9_leader": 3,
    "kill9_follower": 4,
    "kill9_sidecar": 2,
    "freeze": 2,
    "listener_drop": 2,
    "storage_fault": 2,
    # Adversarial wire battery (testing/adversary.py) against one
    # follower's comm listener.  Weight 0 by default: step() filters
    # zero-weight actions, so existing seeded soak schedules replay
    # byte-identically; chaos_sweep --adversarial-net (and soaks that
    # opt in) raise it.
    "net_abuse": 0,
}

#: Storage fault classes safe to arm while a replica keeps running
#: (the injector self-heals after ``count`` operations).
STORAGE_FAULT_KINDS = ("bit_flip", "torn_mid", "fsync_lie", "slow_fsync")


class ProcessChaosSchedule:
    """Seeded sequence of process-chaos actions against a launcher.

    ``step()`` performs one action and returns a record of what it did;
    transient states (freeze, listener drop) are healed on the *next*
    step so the cluster is never left wedged by the schedule itself.
    """

    def __init__(
        self,
        launcher,
        *,
        seed: int = 0,
        weights: Optional[dict] = None,
        freeze_only_followers: bool = True,
    ) -> None:
        self.launcher = launcher
        self.rng = random.Random(seed)
        self.weights = dict(weights or DEFAULT_ACTION_WEIGHTS)
        self.freeze_only_followers = freeze_only_followers
        self.history: list = []
        #: Pending heals (callables) applied at the start of the next step.
        self._pending_heals: list = []

    # ------------------------------------------------------------ victims

    def _replica_ids(self) -> list:
        return sorted(self.launcher.replicas)

    def _pick_follower(self) -> Optional[int]:
        leader = self.launcher.leader_id()
        followers = [i for i in self._replica_ids() if i != leader]
        return self.rng.choice(followers) if followers else None

    # ------------------------------------------------------------ actions

    def _heal_pending(self) -> None:
        heals, self._pending_heals = self._pending_heals, []
        for heal in heals:
            try:
                heal()
            except Exception:
                logger.exception("chaos heal failed")

    def step(self) -> dict:
        """Heal last step's transient state, then perform one action."""
        self._heal_pending()
        actions = [a for a in self.weights if self.weights[a] > 0]
        if not self.launcher.sidecars:
            actions = [a for a in actions if a != "kill9_sidecar"]
        action = self.rng.choices(
            actions, weights=[self.weights[a] for a in actions]
        )[0]
        record = {"action": action, "target": None}

        if action == "kill9_leader":
            leader = self.launcher.leader_id()
            if leader is not None and leader in self.launcher.replicas:
                self.launcher.kill_replica(leader)
                record["target"] = leader
        elif action == "kill9_follower":
            victim = self._pick_follower()
            if victim is not None:
                self.launcher.kill_replica(victim)
                record["target"] = victim
        elif action == "kill9_sidecar":
            sids = sorted(self.launcher.sidecars)
            if sids:
                victim = self.rng.choice(sids)
                self.launcher.kill_sidecar(victim)
                record["target"] = victim
        elif action == "freeze":
            victim = (
                self._pick_follower()
                if self.freeze_only_followers
                else self.rng.choice(self._replica_ids())
            )
            if victim is not None:
                self.launcher.freeze_replica(victim)
                record["target"] = victim
                self._pending_heals.append(
                    lambda v=victim: self.launcher.thaw_replica(v)
                )
        elif action == "listener_drop":
            victim = self._pick_follower()
            if victim is not None:
                self.launcher.drop_listener(victim)
                record["target"] = victim
                self._pending_heals.append(
                    lambda v=victim: self.launcher.restore_listener(v)
                )
        elif action == "storage_fault":
            victim = self.rng.choice(self._replica_ids())
            kind = self.rng.choice(STORAGE_FAULT_KINDS)
            self.launcher.arm_storage_fault(victim, kind, count=1)
            record["target"] = victim
            record["kind"] = kind
        elif action == "net_abuse":
            # Real-socket byzantine battery against one follower's comm
            # listener: the hardened guard must shed it (strikes, quota
            # rejections, at most a temporary ban of this host's address)
            # while the soak's liveness probes keep passing.  Nothing to
            # heal — batteries self-terminate and bans expire.
            from consensus_tpu_torch.testing.adversary import AdversarialPeer

            victim = self._pick_follower()
            if victim is not None:
                addr = self.launcher.spec.comm_addresses()[victim]
                peer = AdversarialPeer(addr, "comm")
                provoked = {}
                for name in ("oversized_length", "wrong_hmac_flood"):
                    try:
                        for k, v in getattr(peer, name)(1).items():
                            provoked[k] = provoked.get(k, 0) + v
                    except OSError:
                        pass  # victim mid-restart: the battery found no ear
                record["target"] = victim
                record["provoked"] = provoked

        self.history.append(record)
        logger.info("chaos: %s -> %s", action, record.get("target"))
        return record

    def quiesce(self) -> None:
        """Heal all transient states (end-of-run cleanup)."""
        self._heal_pending()


__all__ = [
    "ProcessChaosSchedule",
    "DEFAULT_ACTION_WEIGHTS",
    "STORAGE_FAULT_KINDS",
]
