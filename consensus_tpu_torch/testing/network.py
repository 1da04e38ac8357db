"""In-process simulated network for multi-replica tests.

Parity: reference test/network.go:34-253.  Every replica shares one
SimScheduler, so message delivery interleaves deterministically with timers;
fault-injection knobs mirror the reference:

* per-node and per-link disconnection (``disconnect`` / ``disconnect_pair``)
* probabilistic loss with a seeded RNG (``set_loss``)
* message mutation hooks for byzantine-sender simulation (``mutate_send``,
  reference test/test_app.go:180-191)
* receiver-side selective filters (``lose_messages``)
* per-link latency (``set_delay``)

plus the byzantine-NETWORK primitives the reference harness lacks (the
chaos engine's adversary vocabulary, consensus_tpu/testing/chaos.py):

* probabilistic duplication (``set_duplicate``) — the same signed message
  delivered twice,
* probabilistic reordering (``set_reorder``) — a message overtaken by
  later sends on the same link,
* stale replay (``set_replay``) — an OLD captured message re-delivered
  long after it was first sent (the baseline adversary for signed-message
  protocols; arXiv:2302.00418 §2).

Every injected event (a loss-roll drop, a mutate/filter drop, a duplicate,
a reorder, a replay) is counted in :attr:`SimNetwork.injected`, mirrored
into an attached ``MetricsNetwork`` bundle (``attach_metrics``) and, when a
tracer is attached, emitted as ``net.<event>`` instants on the shared sim
clock — so a chaos run's adversary activity is attributable in the same
trace as the protocol's phase spans.

The PyTorch port's copy of ``consensus_tpu/testing/network.py``, its imports renamed.
"""

from __future__ import annotations

import random
from collections import Counter, deque
from typing import Callable, Optional, Sequence

from consensus_tpu_torch.api.deps import Comm
from consensus_tpu_torch.runtime.scheduler import SimScheduler
from consensus_tpu_torch.wire import ConsensusMessage

#: The injected-event kinds :attr:`SimNetwork.injected` counts, in the
#: order the metrics bundle pins them (metrics.py NET_INJECTED_KEYS).
INJECTED_EVENT_KINDS = ("dropped", "duplicated", "reordered", "replayed")


class SimNetwork:
    """Routes messages between registered replicas over the shared clock."""

    #: Captured messages kept per replay-armed link (oldest evicted first).
    REPLAY_BUFFER_DEPTH = 32

    def __init__(self, scheduler: SimScheduler, *, seed: int = 0, default_delay: float = 0.001) -> None:
        self.scheduler = scheduler
        self.rng = random.Random(seed)
        self.default_delay = default_delay
        self._handlers: dict[int, Callable[[int, object, bool], None]] = {}
        #: Configured cluster membership (stable across crashes); falls back
        #: to the live registration set when unset.  Mutate ONLY through
        #: :meth:`set_membership` — the setter keeps the removed-node
        #: accounting and the epoch counter consistent.
        self.membership: Optional[list[int]] = None
        #: Bumped by every :meth:`set_membership` call (or pinned to the
        #: caller's epoch): lets assertions tie network-level membership to
        #: the protocol's membership epoch.
        self.membership_epoch = 0
        #: Ids removed from membership whose in-flight / future deliveries
        #: are dropped-and-counted rather than silently lost.
        self._removed: set[int] = set()
        #: In-flight deliveries to removed nodes that were accounted for
        #: (the membership analogue of :attr:`injected`, but NOT an
        #: injected-adversary event — removal is topology, so it gets its
        #: own counter instead of a new INJECTED_EVENT_KINDS entry).
        self.removed_drops = 0
        self._disconnected: set[int] = set()
        self._cut_links: set[tuple[int, int]] = set()
        self._loss: dict[tuple[int, int], float] = {}
        self._delay: dict[tuple[int, int], float] = {}
        #: (a, b) -> (base, spread): per-link latency DISTRIBUTION — each
        #: send draws uniform(base, base + spread) from the seeded RNG.
        #: The WAN scenario bank's geography knob; unarmed links consume
        #: no RNG, so non-WAN schedules replay byte-identically.
        self._jitter: dict[tuple[int, int], tuple[float, float]] = {}
        self._duplicate: dict[tuple[int, int], float] = {}
        self._reorder: dict[tuple[int, int], float] = {}
        self._replay: dict[tuple[int, int], float] = {}
        #: (a, b) -> deque of stale (payload, is_request) captures for links
        #: with replay armed.
        self._replay_buffers: dict[tuple[int, int], deque] = {}
        #: fn(sender, target, msg) -> msg | None (None drops the message).
        self.mutate_send: Optional[Callable[[int, int, object], Optional[object]]] = None
        #: fn(target, sender, msg) -> bool; True drops at the receiver.
        self.lose_messages: Optional[Callable[[int, int, object], bool]] = None
        #: Injected adversary events: dropped / duplicated / reordered /
        #: replayed.  "dropped" counts only *injected* drops (loss rolls,
        #: mutate_send returning None, lose_messages filtering) — cuts,
        #: partitions, and dead endpoints are topology, not per-message
        #: injection.
        self.injected: Counter = Counter()
        #: Optional MetricsNetwork bundle mirroring :attr:`injected`.
        self.metrics = None
        #: Optional trace.Tracer: injected events become ``net.<kind>``
        #: instants on the shared sim clock.
        self.tracer = None

    # --- membership --------------------------------------------------------

    def register(
        self, node_id: int, on_message: Callable[[int, object, bool], None]
    ) -> "NodeComm":
        """``on_message(sender, payload, is_request)`` is the replica ingress."""
        self._handlers[node_id] = on_message
        return NodeComm(self, node_id)

    def unregister(self, node_id: int) -> None:
        self._handlers.pop(node_id, None)

    def node_ids(self) -> list[int]:
        if self.membership is not None:
            return sorted(self.membership)
        return sorted(self._handlers)

    def set_membership(
        self, ids: Sequence[int], *, epoch: Optional[int] = None
    ) -> None:
        """The one supported way to change :attr:`membership`.

        Ids leaving the member set are tracked in ``_removed`` so their
        in-flight deliveries (already scheduled on the sim clock) are
        DROPPED AND COUNTED at delivery time instead of vanishing; a
        re-added id is un-tracked.  ``epoch`` pins the epoch counter (the
        harness passes the directory's epoch); omitted, it increments.
        """
        new = set(ids)
        old = set(self.membership) if self.membership is not None else set(
            self._handlers
        )
        self._removed |= old - new
        self._removed -= new
        self.membership = sorted(new)
        if epoch is not None:
            self.membership_epoch = epoch
        else:
            self.membership_epoch += 1

    # --- fault injection ---------------------------------------------------

    def disconnect(self, node_id: int) -> None:
        self._disconnected.add(node_id)

    def connect(self, node_id: int) -> None:
        self._disconnected.discard(node_id)

    def disconnect_pair(self, a: int, b: int) -> None:
        self._cut_links.add((a, b))
        self._cut_links.add((b, a))

    def connect_pair(self, a: int, b: int) -> None:
        self._cut_links.discard((a, b))
        self._cut_links.discard((b, a))

    def partition(self, group: Sequence[int]) -> None:
        """Cut every link crossing the boundary of ``group``.

        NOTE for direct users (Cluster sets this up for you): the boundary
        is computed over :meth:`node_ids`, which without ``membership``
        falls back to the *live registration set* — a node that is crashed
        (unregistered) when ``partition`` is called gets NO cut links, so
        the partition silently leaks around it once it restarts.  Set
        ``membership`` to the full configured id set before partitioning
        around crashes (pinned by
        tests/test_network_adversary.py::test_partition_leaks_around_crashed_node_without_membership).
        """
        inside = set(group)
        for a in self.node_ids():
            for b in self.node_ids():
                if (a in inside) != (b in inside):
                    self._cut_links.add((a, b))

    def heal(self) -> None:
        """Clear every fault knob: cuts, disconnections, loss, per-link
        delay overrides, duplication, reordering, and replay (stale capture
        buffers included — a healed network holds no adversary state)."""
        self._cut_links.clear()
        self._disconnected.clear()
        self._loss.clear()
        self._delay.clear()
        self._jitter.clear()
        self._duplicate.clear()
        self._reorder.clear()
        self._replay.clear()
        self._replay_buffers.clear()

    def set_loss(self, a: int, b: int, probability: float) -> None:
        """Drop a fraction of messages on the directed link a->b."""
        self._loss[(a, b)] = probability

    def set_duplicate(self, a: int, b: int, probability: float) -> None:
        """Deliver a fraction of messages on a->b TWICE (second copy lands
        one extra delay later — a retransmitting/duplicating network)."""
        self._duplicate[(a, b)] = probability

    def set_reorder(self, a: int, b: int, probability: float) -> None:
        """Hold back a fraction of messages on a->b so messages sent after
        them arrive first (delivery delay inflated 2-5x, seeded RNG)."""
        self._reorder[(a, b)] = probability

    def set_replay(self, a: int, b: int, probability: float) -> None:
        """Capture messages crossing a->b and, per send, with the given
        probability ALSO re-deliver one stale captured message — the
        signed-message replay adversary.  Captures are bounded
        (:attr:`REPLAY_BUFFER_DEPTH`) and cleared by :meth:`heal`."""
        self._replay[(a, b)] = probability
        self._replay_buffers.setdefault((a, b), deque(maxlen=self.REPLAY_BUFFER_DEPTH))

    def reachable(self, a: int, b: int) -> bool:
        """Whether a message from ``a`` could currently reach ``b`` —
        used by the test harness to keep OUT-OF-BAND paths (application
        state transfer in ``TestApp.sync``) honest about partitions: a
        partitioned replica must not be able to fetch peer state through a
        side channel the network would not carry."""
        if a in self._disconnected or b in self._disconnected:
            return False
        if self._loss.get((a, b), 0.0) >= 1.0:
            return False  # a total-loss link is a cut, not a lossy link
        return (a, b) not in self._cut_links

    def set_delay(self, a: int, b: int, delay: float) -> None:
        self._delay[(a, b)] = delay

    def set_jitter(
        self, a: int, b: int, base: float, spread: float = 0.0
    ) -> None:
        """Give the directed link a->b a latency DISTRIBUTION: each send is
        delayed uniform(base, base + spread), drawn from the network's
        seeded RNG.  This is the WAN geography primitive (chaos WAN
        profiles arm it per region pair); it composes with ``set_delay`` by
        taking whichever is larger, so a chaos ``delay`` degradation still
        bites on a WAN link.  Cleared by :meth:`heal` like every knob — the
        chaos engine re-arms geography after heals."""
        if base < 0 or spread < 0:
            raise ValueError("jitter base and spread must be >= 0")
        self._jitter[(a, b)] = (base, spread)

    # --- transport ---------------------------------------------------------

    def _record_injected(self, kind: str, sender: int, target: int) -> None:
        self.injected[kind] += 1
        if self.metrics is not None:
            getattr(self.metrics, f"count_{kind}").add(1)
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            tracer.instant("net", f"net.{kind}", sender=sender, target=target)

    def send(self, sender: int, target: int, payload, *, is_request: bool) -> None:
        if sender not in self._handlers:
            return  # a crashed (unregistered) process cannot transmit:
            # scheduler events queued by its zombie frames must not leak
            # messages a dead replica never actually sent.
        if sender in self._disconnected or target in self._disconnected:
            return
        if (sender, target) in self._cut_links:
            return
        loss = self._loss.get((sender, target), 0.0)
        if loss and self.rng.random() < loss:
            self._record_injected("dropped", sender, target)
            return
        if self.mutate_send is not None:
            payload = self.mutate_send(sender, target, payload)
            if payload is None:
                self._record_injected("dropped", sender, target)
                return
        link = (sender, target)
        jitter = self._jitter.get(link)
        if jitter is not None:
            base, spread = jitter
            drawn = base + (self.rng.random() * spread if spread else 0.0)
            override = self._delay.get(link)
            delay = drawn if override is None else max(drawn, override)
        else:
            delay = self._delay.get(link, self.default_delay)

        replay_p = self._replay.get(link, 0.0)
        if replay_p:
            buf = self._replay_buffers[link]
            if buf and self.rng.random() < replay_p:
                stale_payload, stale_is_request = buf[0]  # the STALEST capture
                self._record_injected("replayed", sender, target)
                self._schedule_delivery(
                    sender, target, stale_payload, stale_is_request,
                    delay + self.default_delay,
                )
            buf.append((payload, is_request))

        reorder_p = self._reorder.get(link, 0.0)
        if reorder_p and self.rng.random() < reorder_p:
            # Held back past 1-4 subsequently-sent messages' delivery times.
            self._record_injected("reordered", sender, target)
            delay = delay * (2 + 3 * self.rng.random())

        self._schedule_delivery(sender, target, payload, is_request, delay)

        dup_p = self._duplicate.get(link, 0.0)
        if dup_p and self.rng.random() < dup_p:
            self._record_injected("duplicated", sender, target)
            self._schedule_delivery(
                sender, target, payload, is_request, delay + self.default_delay
            )

    def _schedule_delivery(
        self, sender: int, target: int, payload, is_request: bool, delay: float
    ) -> None:
        def deliver() -> None:
            handler = self._handlers.get(target)
            if handler is None:
                if target in self._removed:
                    # The target left the membership AND unregistered while
                    # this delivery was in flight: account for the drop
                    # instead of silently losing it.  (A removed-but-live
                    # node still receives — it must be able to deliver the
                    # very decision that evicts it.)
                    self.removed_drops += 1
                return  # crashed / removed meanwhile
            if self.lose_messages is not None and self.lose_messages(
                target, sender, payload
            ):
                self._record_injected("dropped", sender, target)
                return
            handler(sender, payload, is_request)

        self.scheduler.call_later(delay, deliver, name=f"net {sender}->{target}")


class NodeComm(Comm):
    """The api.Comm a replica plugs in: fire-and-forget over the network."""

    def __init__(self, network: SimNetwork, node_id: int) -> None:
        self._network = network
        self.node_id = node_id

    def send_consensus(self, target_id: int, message: ConsensusMessage) -> None:
        self._network.send(self.node_id, target_id, message, is_request=False)

    def send_transaction(self, target_id: int, request: bytes) -> None:
        self._network.send(self.node_id, target_id, request, is_request=True)

    def nodes(self) -> Sequence[int]:
        return self._network.node_ids()


__all__ = ["SimNetwork", "NodeComm", "INJECTED_EVENT_KINDS"]
