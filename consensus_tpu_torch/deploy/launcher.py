"""Cluster launcher: the one object that owns a process-per-replica rig.

``start()`` writes the cluster spec to disk (config/key distribution),
boots the sidecar fleet first (replicas dial it at verify time), then the
replicas — every process under its own
:class:`~consensus_tpu_torch.deploy.supervisor.NodeSupervisor` — and waits for
each control socket to answer.  From there the launcher is the rig's
operator console:

* health/leader probes and Prometheus scrapes across every process,
* ledger-digest collection feeding the
  :class:`~consensus_tpu_torch.deploy.invariants.DeployInvariantMonitor`,
* the chaos verbs (`kill -9`, SIGSTOP freeze, listener-port drop,
  storage-fault arming) addressed by node id / sidecar id,
* autoscaler hooks (``add_sidecar`` / ``drain_sidecar`` re-write the spec
  so restarted replicas see the grown fleet), and
* ``stop()`` — graceful teardown that ASSERTS zero orphaned processes and
  zero leaked listen ports before returning its summary.

Real-time by nature (process lifecycles, socket deadlines): the audited
``# wallclock-ok`` escapes cover its waits.

The PyTorch port's copy of ``consensus_tpu/deploy/launcher.py``, its imports
renamed.  One divergence (ROADMAP.md queue C, divergence 25):
``ClusterLauncher(..., device=...)`` appends ``--device <device>`` to every
child's argv when it is given.  The device never enters the spec, whose
``cluster.json`` stays the JAX package's, byte for byte.
"""

from __future__ import annotations

import logging
import os
import signal
import socket
import sys
import time
from typing import Dict, Optional

from consensus_tpu_torch.deploy.control import ControlClient
from consensus_tpu_torch.deploy.invariants import DeployInvariantMonitor
from consensus_tpu_torch.deploy.spec import ClusterSpec
from consensus_tpu_torch.deploy.supervisor import NodeSupervisor

logger = logging.getLogger("consensus_tpu_torch.deploy")


class ClusterLauncher:
    def __init__(
        self,
        spec: ClusterSpec,
        *,
        restart: bool = True,
        python: str = sys.executable,
        backoff_initial: float = 0.25,
        max_restarts: int = 8,
        spawn_sidecars: bool = True,
        device: Optional[str] = None,
    ) -> None:
        #: ``spawn_sidecars=False`` — consensus sharding: the spec's
        #: sidecars are a SHARED fleet owned by another launcher (the
        #: first group's), so this launcher neither boots, audits, nor
        #: port-checks them; replicas still dial them at verify time.
        self.spawn_sidecars = spawn_sidecars
        #: The device the children's engines live on, passed as
        #: ``--device``; unset, the children resolve ``cuda``.
        self.device = device
        self.spec = spec
        self.python = python
        self.restart = restart
        self.backoff_initial = backoff_initial
        self.max_restarts = max_restarts
        self.monitor = DeployInvariantMonitor()
        self.replicas: Dict[int, NodeSupervisor] = {}
        self.sidecars: Dict[str, NodeSupervisor] = {}
        self.flight_dir = os.path.join(spec.base_dir, "flight")
        #: Every supervisor this launcher ever created, including drained
        #: sidecars (orphan audit at stop() walks their Popen handles).
        self._all_sups: list = []
        self._sidecar_window: Dict[str, dict] = {}
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        self._env = os.environ.copy()
        self._env["PYTHONPATH"] = (
            repo_root + os.pathsep + self._env.get("PYTHONPATH", "")
        ).rstrip(os.pathsep)

    # ------------------------------------------------------------- boot

    def _make_supervisor(self, name, argv, control_addr) -> NodeSupervisor:
        sup = NodeSupervisor(
            name,
            argv,
            control_addr,
            flight_dir=self.flight_dir,
            restart=self.restart,
            backoff_initial=self.backoff_initial,
            max_restarts=self.max_restarts,
            env=self._env,
        )
        self._all_sups.append(sup)
        return sup

    def _replica_argv(self, node_id: int) -> list:
        return [
            self.python, "-m", "consensus_tpu_torch.deploy.replica_main",
            "--config", self.spec.config_path, "--node-id", str(node_id),
        ] + self._device_argv()

    def _sidecar_argv(self, sidecar_id: str) -> list:
        return [
            self.python, "-m", "consensus_tpu_torch.deploy.sidecar_main",
            "--config", self.spec.config_path, "--sidecar-id", sidecar_id,
        ] + self._device_argv()

    def _device_argv(self) -> list:
        return [] if self.device is None else ["--device", str(self.device)]

    def start(self, timeout: float = 120.0) -> None:
        self.spec.write()
        # Ports reserved at generate time (hold_ports=True) stay BOUND
        # until this moment: release just before spawn, so no concurrent
        # launcher could have drawn them in the meantime (spec.py
        # PortReservation — the free_ports TOCTOU fix).
        self.spec.release_ports()
        deadline = time.monotonic() + timeout  # wallclock-ok
        sidecars = self.spec.sidecars if self.spawn_sidecars else []
        for sc in sidecars:
            sup = self._make_supervisor(
                sc.sidecar_id,
                self._sidecar_argv(sc.sidecar_id),
                (sc.host, sc.control_port),
            )
            self.sidecars[sc.sidecar_id] = sup
            sup.start()
        for r in self.spec.replicas:
            sup = self._make_supervisor(
                f"replica-{r.node_id}",
                self._replica_argv(r.node_id),
                (r.host, r.control_port),
            )
            self.replicas[r.node_id] = sup
            sup.start()
        for sup in list(self.sidecars.values()) + list(self.replicas.values()):
            remaining = deadline - time.monotonic()  # wallclock-ok
            if remaining <= 0 or not sup.wait_healthy(remaining):
                raise TimeoutError(f"{sup.name} failed to come up")

    # ------------------------------------------------------------ probes

    def health(self) -> dict:
        out = {}
        for node_id, sup in self.replicas.items():
            out[f"replica-{node_id}"] = sup.probe()
        for sid, sup in self.sidecars.items():
            out[sid] = sup.probe()
        return out

    def leader_id(self) -> Optional[int]:
        """The leader per the most-advanced view any replica reports."""
        best_view, leader = -1, None
        for sup in self.replicas.values():
            h = sup.probe()
            if h and "view" in h and h["view"] > best_view:
                best_view, leader = h["view"], h.get("leader")
        return leader

    def scrape(self) -> dict:
        """Prometheus text body per live replica (the soak obs plane)."""
        bodies = {}
        for node_id, sup in self.replicas.items():
            reply = sup.control.try_call("prom")
            if reply and reply.get("ok"):
                bodies[f"replica-{node_id}"] = reply["text"]
        return bodies

    def ledger_digests(self, node_id: int) -> Optional[list]:
        sup = self.replicas.get(node_id)
        if sup is None:
            return None
        reply = sup.control.try_call("ledger")
        if reply is None or "digests" not in reply:
            return None
        return reply["digests"]

    def observe_invariants(self) -> None:
        """One monitor pass: collect every live replica's digest list."""
        for node_id in self.replicas:
            digests = self.ledger_digests(node_id)
            if digests is not None:
                self.monitor.observe(node_id, digests)

    def heights(self) -> dict:
        out = {}
        for node_id, sup in self.replicas.items():
            h = sup.probe()
            if h is not None and "ledger" in h:
                out[node_id] = h["ledger"]
        return out

    def wait_height(
        self, height: int, timeout: float, *, min_nodes: Optional[int] = None
    ) -> bool:
        """Until >= ``min_nodes`` replicas (default: all) report ledger
        height >= ``height``."""
        want = min_nodes if min_nodes is not None else len(self.replicas)
        deadline = time.monotonic() + timeout  # wallclock-ok
        while time.monotonic() < deadline:  # wallclock-ok
            reached = sum(
                1 for h in self.heights().values() if h >= height
            )
            if reached >= want:
                return True
            time.sleep(0.1)
        return False

    # ------------------------------------------------------------- chaos

    def kill_replica(self, node_id: int, sig: int = signal.SIGKILL) -> None:
        self.replicas[node_id].kill(sig)

    def kill_sidecar(self, sidecar_id: str, sig: int = signal.SIGKILL) -> None:
        self.sidecars[sidecar_id].kill(sig)

    def freeze_replica(self, node_id: int) -> None:
        self.replicas[node_id].suspend()

    def thaw_replica(self, node_id: int) -> None:
        self.replicas[node_id].resume()

    def drop_listener(self, node_id: int) -> None:
        self.replicas[node_id].control.try_call("net_pause")

    def restore_listener(self, node_id: int) -> None:
        self.replicas[node_id].control.try_call("net_resume")

    def arm_storage_fault(self, node_id: int, kind: str, **kw) -> Optional[dict]:
        return self.replicas[node_id].control.try_call(
            "storage_fault", kind=kind, **kw
        )

    # -------------------------------------------------------- autoscaling

    def sidecar_signals(self) -> list:
        """Window-relative (since last call) offered/rejected per live
        sidecar — the FleetAutoscaler's input."""
        signals = []
        for sid, sup in self.sidecars.items():
            h = sup.probe()
            if h is None:
                continue
            prev = self._sidecar_window.get(sid, {})
            signals.append({
                "sidecar_id": sid,
                "offered": max(0, h.get("offered", 0)
                               - prev.get("offered", 0)),
                "rejected": max(0, h.get("rejected", 0)
                                - prev.get("rejected", 0)),
                "engine_degraded": bool(h.get("engine_degraded")),
            })
            self._sidecar_window[sid] = h
        return signals

    def add_sidecar(self, timeout: float = 60.0) -> str:
        sc = self.spec.add_sidecar()
        self.spec.write()
        sup = self._make_supervisor(
            sc.sidecar_id,
            self._sidecar_argv(sc.sidecar_id),
            (sc.host, sc.control_port),
        )
        self.sidecars[sc.sidecar_id] = sup
        sup.start()
        if not sup.wait_healthy(timeout):
            raise TimeoutError(f"{sc.sidecar_id} failed to come up")
        logger.info("autoscaler: added %s", sc.sidecar_id)
        return sc.sidecar_id

    def drain_sidecar(self, sidecar_id: str) -> None:
        sup = self.sidecars.pop(sidecar_id, None)
        if sup is None:
            return
        sup.stop()
        self.spec.sidecars = [
            s for s in self.spec.sidecars if s.sidecar_id != sidecar_id
        ]
        self.spec.write()
        self._sidecar_window.pop(sidecar_id, None)
        logger.info("autoscaler: drained %s", sidecar_id)

    # ----------------------------------------------------------- teardown

    def _listen_ports(self) -> list:
        ports = []
        for r in self.spec.replicas:
            ports += [r.port, r.sync_port, r.control_port]
        if self.spawn_sidecars:
            # A shared fleet (spawn_sidecars=False) is audited by the
            # launcher that owns it — its ports are legitimately busy here.
            for s in self.spec.sidecars:
                ports += [s.port, s.control_port]
        return ports

    def stop(self) -> dict:
        """Tear everything down; ASSERT no orphaned process and no leaked
        listen port survives.  Returns the teardown summary."""
        for sup in list(self.replicas.values()) + list(self.sidecars.values()):
            sup.stop()
        # Belt and braces: every process EVER spawned — including
        # pre-restart incarnations and drained sidecars — must be gone.
        # Audit Popen handles, not raw pids: poll() answers for exactly
        # the child we spawned, whereas a reaped pid can be recycled by
        # an unrelated same-user process over a multi-hour soak and make
        # os.kill(pid, 0) report a false orphan.
        orphans = []
        for sup in self._all_sups:
            for proc in sup.spawned:
                if proc.poll() is None:
                    orphans.append(f"{sup.name} pid {proc.pid} still running")
        leaked = []
        for port in self._listen_ports():
            probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                probe.bind(("127.0.0.1", port))
            except OSError:
                leaked.append(port)
            finally:
                probe.close()
        summary = {
            "orphans": orphans,
            "leaked_ports": leaked,
            "restarts": {
                sup.name: sup.restarts
                for sup in list(self.replicas.values())
                + list(self.sidecars.values())
            },
            "invariants": self.monitor.summary(),
        }
        if orphans:
            raise AssertionError(f"orphaned processes at teardown: {orphans}")
        if leaked:
            raise AssertionError(f"leaked listen ports at teardown: {leaked}")
        return summary


__all__ = ["ClusterLauncher"]
