"""Heartbeat monitor: leader liveness beacons + follower failure detection.

Parity: reference internal/bft/heartbeatmonitor.go:80-415.  Tick-driven role
machine on the injected scheduler (the reference injects a ``<-chan
time.Time``; here a repeating timer with period ``timeout / count``).

Leader: broadcasts ``HeartBeat(view, seq)`` every tick window unless a real
protocol message already went out (``heartbeat_was_sent``).  Collects
HeartBeatResponses — f+1 responses naming a higher view mean the cluster
moved on without us → sync.

Follower: complains when no (real or artificial) heartbeat arrived within the
timeout; detects being exactly one sequence behind the leader for
``num_of_ticks_behind_before_syncing`` consecutive ticks → sync; answers
stale-view heartbeats with a HeartBeatResponse.

The PyTorch port's copy of ``consensus_tpu/core/heartbeat.py``, its imports renamed.
"""

from __future__ import annotations

import logging
from enum import Enum
from typing import Callable, Optional, Protocol

from consensus_tpu_torch.runtime.scheduler import Scheduler, TimerHandle
from consensus_tpu_torch.utils.quorum import compute_quorum
from consensus_tpu_torch.wire import ConsensusMessage, HeartBeat, HeartBeatResponse

logger = logging.getLogger("consensus_tpu_torch.heartbeat")


class Role(Enum):
    LEADER = "leader"
    FOLLOWER = "follower"


class HeartbeatEventHandler(Protocol):
    """Parity: reference internal/bft/heartbeatmonitor.go:23-34."""

    def on_heartbeat_timeout(self, view: int, leader_id: int) -> None: ...

    def sync(self) -> None: ...


class HeartbeatComm(Protocol):
    def broadcast(self, msg: ConsensusMessage) -> None: ...

    def send(self, target_id: int, msg: ConsensusMessage) -> None: ...


class HeartbeatMonitor:
    def __init__(
        self,
        scheduler: Scheduler,
        *,
        comm: HeartbeatComm,
        handler: HeartbeatEventHandler,
        n: int,
        heartbeat_timeout: float,
        heartbeat_count: int,
        num_of_ticks_behind_before_syncing: int,
        view_sequence: Callable[[], tuple[bool, int]],
    ) -> None:
        """``view_sequence()`` returns (view_active, current_seq) — the
        reference threads the same through an atomic ViewSequences value."""
        self._sched = scheduler
        self._comm = comm
        self._handler = handler
        self._n = n
        self._timeout = heartbeat_timeout
        self._tick_period = heartbeat_timeout / heartbeat_count
        self._ticks_behind_limit = num_of_ticks_behind_before_syncing
        self._view_sequence = view_sequence

        self._role = Role.FOLLOWER
        self._view = 0
        self._leader_id = 0
        self._suppress_leader_sends = False

        self._last_heartbeat: Optional[float] = None
        self._sent_since_tick = False
        self._timed_out = False
        self._follower_behind = False
        self._behind_seq = -1
        self._behind_counter = 0
        self._responses: dict[int, int] = {}
        self._sync_requested = False

        self._timer: Optional[TimerHandle] = None
        self._running = False

    # --- lifecycle ---------------------------------------------------------

    def change_role(self, role: Role, view: int, leader_id: int) -> None:
        """Parity: reference heartbeatmonitor.go:174-195 + handleCommand."""
        logger.debug("heartbeat role=%s view=%d leader=%d", role.value, view, leader_id)
        self._role = role
        self._view = view
        self._leader_id = leader_id
        self._suppress_leader_sends = False
        self._timed_out = False
        self._last_heartbeat = self._sched.now()
        self._responses = {}
        self._sync_requested = False
        if not self._running:
            self._running = True
            self._schedule_tick()

    def stop_leader_sends(self) -> None:
        """Keep monitoring but stop emitting heartbeats (used while a view
        change is pending against us as leader)."""
        self._suppress_leader_sends = True

    def close(self) -> None:
        self._running = False
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._last_heartbeat = None

    def _schedule_tick(self) -> None:
        self._timer = self._sched.call_later(
            self._tick_period, self._tick, name="heartbeat-tick"
        )

    # --- ticking -----------------------------------------------------------

    def _tick(self) -> None:
        if not self._running:
            return
        now = self._sched.now()
        if self._last_heartbeat is None:
            self._last_heartbeat = now
        if self._role == Role.LEADER and not self._suppress_leader_sends:
            self._leader_tick(now)
        else:
            self._follower_tick(now)
        self._schedule_tick()

    def _leader_tick(self, now: float) -> None:
        if (now - self._last_heartbeat) * 1.0 < self._tick_period:
            return
        if self._sent_since_tick:
            # A protocol message doubled as the heartbeat this window.
            self._sent_since_tick = False
            self._last_heartbeat = now
            return
        active, seq = self._view_sequence()
        if not active:
            return
        self._comm.broadcast(HeartBeat(view=self._view, seq=seq))
        self._last_heartbeat = now

    def _follower_tick(self, now: float) -> None:
        if self._timed_out:
            return
        delta = now - self._last_heartbeat
        if delta >= self._timeout:
            logger.warning(
                "heartbeat timeout: leader %d silent for %.3fs", self._leader_id, delta
            )
            self._timed_out = True
            self._handler.on_heartbeat_timeout(self._view, self._leader_id)
            return
        if not self._follower_behind:
            return
        self._behind_counter += 1
        if self._behind_counter >= self._ticks_behind_limit:
            logger.warning(
                "follower stuck one seq behind leader for %d ticks — syncing",
                self._behind_counter,
            )
            self._behind_counter = 0
            self._handler.sync()

    # --- ingress -----------------------------------------------------------

    def process_msg(self, sender: int, msg: ConsensusMessage) -> None:
        if isinstance(msg, HeartBeat):
            self._handle_heartbeat(sender, msg, artificial=False)
        elif isinstance(msg, HeartBeatResponse):
            self._handle_response(sender, msg)

    def inject_artificial_heartbeat(self, sender: int, msg: HeartBeat) -> None:
        """The controller converts the leader's protocol traffic into
        heartbeats so an active leader never looks dead.

        Parity: reference controller.go:330-331,362-373."""
        self._handle_heartbeat(sender, msg, artificial=True)

    def _handle_heartbeat(self, sender: int, hb: HeartBeat, *, artificial: bool) -> None:
        if hb.view < self._view:
            self._comm.send(sender, HeartBeatResponse(view=self._view))
            return
        # Only the current leader's heartbeats reset the follower timeout —
        # even while suppress_leader_sends has this (leader) node monitoring
        # as a follower, or a Byzantine non-leader could keep feeding the
        # timer and mute the complaint path.
        if sender != self._leader_id:
            return
        if hb.view > self._view:
            self._handler.sync()
            return
        active, our_seq = self._view_sequence()
        if active and not artificial:
            if our_seq + 1 < hb.seq:
                self._handler.sync()
                return
            if our_seq + 1 == hb.seq:
                self._follower_behind = True
                if our_seq > self._behind_seq:
                    self._behind_seq = our_seq
                    self._behind_counter = 0
            else:
                self._follower_behind = False
        else:
            self._follower_behind = False
        self._last_heartbeat = self._sched.now()
        self._timed_out = False

    def _handle_response(self, sender: int, hbr: HeartBeatResponse) -> None:
        if self._role != Role.LEADER or self._sync_requested:
            return
        if self._view >= hbr.view:
            return
        self._responses[sender] = hbr.view
        _, f = compute_quorum(self._n)
        if len(self._responses) >= f + 1:
            logger.info(
                "f+1 heartbeat responses claim views above %d — syncing", self._view
            )
            self._sync_requested = True
            self._handler.sync()

    def heartbeat_was_sent(self) -> None:
        """Parity: reference heartbeatmonitor.go:409-415."""
        self._sent_since_tick = True


__all__ = ["HeartbeatMonitor", "HeartbeatEventHandler", "Role"]
