"""ManagerSupervisor — keeps the rollout manager alive (a copy of
``polyrl_tpu/manager/supervisor.py``).

The manager binary is the control-plane single point of failure the rest of
the fault-tolerance stack (engine eviction + token continuation below it,
stream resume above it) cannot absorb: before this layer,
``spawn_rollout_manager`` returned an unsupervised Popen and a manager
crash ended the run. The supervisor owns the subprocess, watches liveness
(process exit + ``/health`` probes), respawns with capped exponential
backoff, and replays *desired state* onto the fresh process through the
idempotent ``POST /reconcile`` route — registered remote/local instance
endpoints, weight-sender endpoints, and a weight-version floor — so a
manager crash costs one respawn latency, not the training run.

Desired state is fed from two directions:
- the trainer-side :class:`~polyrl_tpu_torch.manager.client.ManagerClient`
  records its own registrations/sender updates/version bumps (``record_*``
  calls), and
- the health monitor snapshots ``/get_instances_status`` each probe, so
  instances that registered THEMSELVES from other processes
  (``python -m polyrl_tpu_torch.rollout.serve`` workers) are replayed too.

The union is replayed; a stale endpoint self-heals on the new manager (its
health-check deadline deregisters it), which is cheap, while a lost
endpoint would silently shrink the pool, which is not.

Controller-resilience parity with async RL frameworks (LlamaRL
arxiv 2505.24034, MindSpeed RL arxiv 2507.19017).
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading

from polyrl_tpu_torch.manager.client import ManagerClient, spawn_rollout_manager

log = logging.getLogger(__name__)


class ManagerSupervisor:
    def __init__(self, bind_addr: str = "127.0.0.1:0",
                 config_file: str | None = None,
                 extra_args: list[str] | None = None,
                 respawn_backoff_s: float = 0.5,
                 respawn_backoff_max_s: float = 10.0,
                 health_interval_s: float = 1.0,
                 health_failures: int = 3,
                 spawn_deadline_s: float = 30.0,
                 log_path: str | None = None):
        self.bind_addr = bind_addr
        self.config_file = config_file
        self.extra_args = list(extra_args or [])
        self.respawn_backoff_s = respawn_backoff_s
        self.respawn_backoff_max_s = respawn_backoff_max_s
        self.health_interval_s = health_interval_s
        self.health_failures = max(1, health_failures)
        self.spawn_deadline_s = spawn_deadline_s
        # one stable log file across respawns (appended): the last words of
        # a crashed manager are exactly what a post-mortem needs
        self.log_path = log_path or os.path.join(
            tempfile.gettempdir(),
            f"polyrl-manager-supervised-{os.getpid()}.log")
        host = bind_addr.rsplit(":", 1)[0]
        self._host = "127.0.0.1" if host in ("0.0.0.0", "") else host
        self.proc = None
        self.port: int | None = None
        self.restarts = 0  # surfaced as fault/manager_restarts
        self._lock = threading.Lock()
        self._desired: dict = {"remote": set(), "local": set(),
                               "senders": [], "groups_per_sender": 1,
                               "weight_version": 0,
                               # pool membership: endpoint -> last-known
                               # weight version (replayed so a respawn does
                               # not orphan a caught-up fleet behind a
                               # redundant weight bootstrap)
                               "instance_versions": {}}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- desired state (replayed through /reconcile on every respawn) ------

    def record_remote_instances(self, endpoints: list[str]) -> None:
        with self._lock:
            self._desired["remote"].update(e for e in endpoints if e)

    def record_local_instances(self, endpoints: list[str]) -> None:
        with self._lock:
            self._desired["local"].update(e for e in endpoints if e)

    def record_weight_senders(self, senders: list[str],
                              groups_per_sender: int = 1) -> None:
        with self._lock:
            self._desired["senders"] = list(senders)
            self._desired["groups_per_sender"] = int(groups_per_sender)

    def record_weight_version(self, version: int) -> None:
        with self._lock:
            if version > self._desired["weight_version"]:
                self._desired["weight_version"] = int(version)

    def record_instance_version(self, endpoint: str, version: int) -> None:
        """Per-engine weight version (monotonic per endpoint)."""
        if not endpoint or version <= 0:
            return
        with self._lock:
            cur = self._desired["instance_versions"].get(endpoint, 0)
            if version > cur:
                self._desired["instance_versions"][endpoint] = int(version)

    def forget_instance(self, endpoint: str) -> None:
        """Drop a departed engine from desired state (graceful leave /
        preemption drill): replaying it onto a fresh manager would re-add
        a dead endpoint the pool just said goodbye to."""
        with self._lock:
            self._desired["remote"].discard(endpoint)
            self._desired["local"].discard(endpoint)
            self._desired["instance_versions"].pop(endpoint, None)

    # -- lifecycle ---------------------------------------------------------

    @property
    def endpoint(self) -> str:
        """host:port of the CURRENT manager process ("" before start)."""
        port = self.port
        return f"{self._host}:{port}" if port else ""

    def client(self, **kwargs) -> ManagerClient:
        """A ManagerClient bound to this supervisor (endpoint re-resolves
        across respawns; registrations recorded for replay)."""
        return ManagerClient(supervisor=self, **kwargs)

    def start(self) -> "ManagerSupervisor":
        """Spawn the first manager (raising loudly on startup failure — a
        misconfiguration must not be retried forever) and start the
        monitor thread."""
        self._spawn()
        self._thread = threading.Thread(target=self._monitor, daemon=True,
                                        name="manager-supervisor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        proc = self.proc
        if proc is not None and proc.poll() is None:
            proc.kill()

    # -- internals ---------------------------------------------------------

    def _spawn(self) -> None:
        proc, port = spawn_rollout_manager(
            self.bind_addr, config_file=self.config_file,
            extra_args=self.extra_args, log_path=self.log_path)
        try:
            self.proc = proc
            self.port = port
            probe = ManagerClient(self.endpoint)
            probe.wait_healthy(self.spawn_deadline_s)
            self._replay(probe)
        except Exception:
            proc.kill()  # never leak a half-started manager into a retry
            raise

    def _replay(self, client: ManagerClient) -> None:
        with self._lock:
            remote = sorted(self._desired["remote"])
            local = sorted(self._desired["local"])
            senders = list(self._desired["senders"])
            groups = self._desired["groups_per_sender"]
            version = self._desired["weight_version"]
            inst_versions = dict(self._desired["instance_versions"])
        if not (remote or local or senders or version):
            return  # nothing registered yet (first spawn)
        out = client.reconcile(remote, local, senders, groups, version,
                               instance_versions=inst_versions)
        log.info("manager reconciled: %s", out)

    def _snapshot(self, client: ManagerClient) -> None:
        """Fold the live registry into desired state so self-registered
        instances (serve.py workers) survive a respawn too."""
        try:
            st = client._call_once("GET", "/get_instances_status", timeout=3.0)
        except Exception:  # noqa: BLE001 — probe already decided liveness
            return
        with self._lock:
            for inst in st.get("instances", []):
                ep = inst.get("endpoint", "")
                if not ep:
                    continue
                key = "local" if inst.get("is_local") else "remote"
                self._desired[key].add(ep)
                # pool membership: the engine's last-known weight version
                # rides along so the replay can re-admit a caught-up fleet
                iv = int(inst.get("weight_version", -1))
                if iv > self._desired["instance_versions"].get(ep, 0):
                    self._desired["instance_versions"][ep] = iv
            v = int(st.get("weight_version", 0))
            if v > self._desired["weight_version"]:
                self._desired["weight_version"] = v

    def _monitor(self) -> None:
        probe = ManagerClient(supervisor=self)
        fails = 0
        backoff = self.respawn_backoff_s
        while not self._stop.wait(self.health_interval_s):
            proc = self.proc
            dead = proc is None or proc.poll() is not None
            if not dead and probe.health():
                fails = 0
                backoff = self.respawn_backoff_s
                self._snapshot(probe)
                continue
            fails += 1
            if not dead and fails < self.health_failures:
                continue  # transient: give a live process a grace window
            log.warning("manager %s (%d health failures); respawning",
                        "exited" if dead else "unresponsive", fails)
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10.0)
            fails = 0
            while not self._stop.is_set():
                try:
                    self._spawn()
                    self.restarts += 1
                    log.info("manager respawned on %s (restart #%d)",
                             self.endpoint, self.restarts)
                    break
                except Exception:  # noqa: BLE001 — keep trying with backoff
                    log.exception("manager respawn failed; retrying in %.1fs",
                                  backoff)
                    self._stop.wait(backoff)
                    backoff = min(backoff * 2, self.respawn_backoff_max_s)
