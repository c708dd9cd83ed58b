"""ClusterDeployment — spawn, readiness, liveness, and the
drive-compatible ``ClusterEngine`` facade; the port's copy of
``repro.gnnserve.cluster.deployment``.

``Session.serve()`` builds one of these when ``DealConfig.cluster``
asks for shards: it dumps the config to the run directory, spawns one
worker per shard as a fresh interpreter (``python -m
repro_torch.gnnserve.cluster.worker --device <the session's>``: no CUDA
context is forked, and each worker builds — or restores + replays — the
full world from that config on that device), waits for readiness (the
port file is written only after the world stands and the socket
listens), and wires a ``Router`` over persistent channels.  On a card
the caller builds the kernels before it spawns (``CudaExecutor``'s
constructor does), so the workers load them and build none.

Liveness: every worker stamps ``shard<i>.hb`` from its MAIN thread;
``check_heartbeats`` reads the stamps and ``kill_wedged`` kills a stale
worker with a STAGE-NAMED diagnosis ("wedged in op:lookup for 12.3s")
instead of a bare timeout.  A killed worker is restartable in place —
``restart_worker`` respawns it against the same run directory, where it
reloads its checkpoint and replays its WAL segment (``worker.py``'s
bitwise rejoin contract); the router's reconnect hook does this
transparently when an RPC hits a dead channel.

``ClusterEngine`` gives the deployment the exact engine surface the
launchers and benchmarks already drive (submit/step/run, mutate,
refresh, full_epoch, stats, memory_stats): queries serve strictly in
submission order, and the refresh decision replicates the single-
process FIFO rule — refresh when the buffered log reaches the bound (or
a query demands fresh) — which is what makes cluster-served bytes equal
to a single-process ``Session`` on the same config: pins happen in
submission order in both, so each query serves the same epoch.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.gnnserve.cluster.protocol import (Channel, ProtocolError,
                                                   WorkerError,
                                                   WorkerTimeout)
from repro_torch.gnnserve.cluster.router import Router, RouterEndpoint


def _src_root() -> str:
    """The directory ``repro_torch`` is imported from (the workers'
    ``PYTHONPATH``)."""
    import repro_torch
    return os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))


def read_heartbeat(path: str):
    """``(stamp, stage)`` from a heartbeat file, or ``(None, "?")``."""
    try:
        with open(path) as f:
            stamp, _, stage = f.read().strip().partition(" ")
        return float(stamp), stage or "?"
    except (OSError, ValueError):
        return None, "?"


class WorkerWedged(RuntimeError):
    """A worker's main thread stopped stamping its heartbeat; the
    message names the stage it wedged in."""


class ClusterDeployment:
    """The worker processes of one cluster config on ``device`` ("cuda"
    by default, or "cpu"; every worker on the same device), the router
    over them, and the router's HTTP endpoint when
    ``cluster.http_port >= 0``."""

    def __init__(self, cfg, *, run_dir: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None, device="cuda"):
        spec = cfg.cluster
        if spec.n_shards <= 0:
            raise ValueError("ClusterSpec.n_shards must be > 0")
        self.cfg = cfg
        self.device = str(device)
        self.n_shards = int(spec.n_shards)
        self.host = spec.host
        self.run_dir = run_dir or spec.run_dir or tempfile.mkdtemp(
            prefix="deal-cluster-")
        os.makedirs(self.run_dir, exist_ok=True)
        self.config_path = os.path.join(self.run_dir, "config.json")
        cfg.dump(self.config_path)
        self._env = dict(os.environ if env is None else env)
        self._env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_src_root(), self._env.get("PYTHONPATH")) if p)
        self.procs: List[Optional[subprocess.Popen]] = [None] * self.n_shards
        self.n_restarts = 0
        self.ready_wait_s = 0.0
        self.router: Optional[Router] = None
        self.endpoint: Optional[RouterEndpoint] = None
        try:
            self._launch(spec)
        except BaseException:
            self.shutdown()         # no worker outlives a failed launch
            raise

    def _launch(self, spec) -> None:
        t0 = time.perf_counter()
        for i in range(self.n_shards):
            self._spawn(i)
        channels = []
        try:
            for i in range(self.n_shards):
                channels.append(
                    self._wait_ready(i, timeout=spec.ready_timeout_s))
        except BaseException:
            for ch in channels:
                ch.close()
            raise
        self.ready_wait_s = time.perf_counter() - t0
        st = channels[0].request("status")[0]
        self.n_levels = int(st["n_levels"])
        dims = [int(d) for d in st["dims"]]
        bounds = np.linspace(0, int(st["n_nodes"]),
                             self.n_shards + 1).astype(np.int64)
        self.router = Router(channels, bounds, dims,
                             reconnect=self._reconnect)
        self.router.n_nodes = int(st["n_nodes"])
        self.engine = ClusterEngine(self, self.router)
        if spec.http_port >= 0:
            self.endpoint = RouterEndpoint(
                self, port=spec.http_port, host=spec.host).start()

    # -- process lifecycle ----------------------------------------------
    def _paths(self, shard: int) -> Dict[str, str]:
        return {k: os.path.join(self.run_dir, f"shard{shard}.{ext}")
                for k, ext in (("port", "port"), ("hb", "hb"),
                               ("log", "log"))}

    def _spawn(self, shard: int) -> None:
        p = self._paths(shard)
        if os.path.exists(p["port"]):   # stale marker must not fake
            os.unlink(p["port"])        # readiness for the new process
        ports = self.cfg.cluster.ports
        argv = [sys.executable, "-m", "repro_torch.gnnserve.cluster.worker",
                "--config", self.config_path,
                "--shard", str(shard),
                "--n-shards", str(self.n_shards),
                "--dir", self.run_dir,
                "--host", self.host,
                "--heartbeat", p["hb"],
                "--device", self.device]
        if ports:
            argv += ["--port", str(ports[shard])]
        logf = open(p["log"], "ab")
        try:
            self.procs[shard] = subprocess.Popen(
                argv, env=self._env, stdout=logf, stderr=logf,
                cwd=self.run_dir)
        finally:
            logf.close()            # the child holds its own descriptor

    def _wait_ready(self, shard: int, *, timeout: float) -> Channel:
        """Block until the worker's port file appears, then connect.
        On timeout, diagnose via the heartbeat: a moving stamp means
        slow (report the stage it is in), a stale one means wedged."""
        p = self._paths(shard)
        deadline = time.monotonic() + timeout
        while not os.path.exists(p["port"]):
            proc = self.procs[shard]
            if proc is not None and proc.poll() is not None:
                raise RuntimeError(
                    f"shard {shard} exited with rc={proc.returncode} "
                    f"before readiness — see {p['log']}")
            if time.monotonic() > deadline:
                stamp, stage = read_heartbeat(p["hb"])
                age = (time.time() - stamp) if stamp else float("inf")
                raise WorkerWedged(
                    f"shard {shard} not ready after {timeout:.0f}s, "
                    f"last heartbeat stage {stage!r} ({age:.1f}s ago)")
            time.sleep(0.05)
        with open(p["port"]) as f:
            port = int(f.read().strip())
        ch = Channel(self.host, port,
                     timeout=self.cfg.cluster.hang_timeout_s)
        ch.request("status")        # one probe proves the loop serves
        return ch

    def kill_worker(self, shard: int, *, sig=signal.SIGKILL) -> None:
        """Hard-kill one worker (the failure-injection hook the replay
        tests and the CI smoke use)."""
        proc = self.procs[shard]
        if proc is not None and proc.poll() is None:
            proc.send_signal(sig)
            proc.wait(timeout=30)

    def restart_worker(self, shard: int) -> Channel:
        """Respawn a (dead) worker against the same run directory: it
        restores its checkpoint, replays its WAL segment, and rejoins
        bitwise-equal.  Returns the fresh channel (also installed in
        the router if one exists)."""
        self.kill_worker(shard)
        self._spawn(shard)
        self.n_restarts += 1
        ch = self._wait_ready(shard,
                              timeout=self.cfg.cluster.ready_timeout_s)
        if self.router is not None:
            self.router.channels[shard].close()
            self.router.channels[shard] = ch
        return ch

    def _reconnect(self, shard: int) -> Channel:
        """Router hook on a broken channel: reconnect if the process is
        alive (a probe connection dropped us), full restart if not."""
        proc = self.procs[shard]
        if proc is not None and proc.poll() is None:
            p = self._paths(shard)
            with open(p["port"]) as f:
                port = int(f.read().strip())
            try:
                ch = Channel(self.host, port,
                             timeout=self.cfg.cluster.hang_timeout_s)
                ch.request("status")
                return ch
            except (ProtocolError, WorkerError, WorkerTimeout, OSError):
                self.kill_worker(shard)     # alive but not serving
        return self.restart_worker(shard)

    # -- liveness ---------------------------------------------------------
    def check_heartbeats(self) -> List[Dict]:
        """Per-shard liveness: last stamped stage + staleness."""
        out = []
        now = time.time()
        for i in range(self.n_shards):
            stamp, stage = read_heartbeat(self._paths(i)["hb"])
            proc = self.procs[i]
            out.append({"shard": i, "stage": stage,
                        "age_s": (now - stamp) if stamp else None,
                        "alive": proc is not None and proc.poll() is None})
        return out

    def kill_wedged(self, *, max_age_s: Optional[float] = None,
                    restart: bool = True) -> List[str]:
        """Kill workers whose MAIN thread stopped stamping for longer
        than ``max_age_s`` (default: the spec's hang timeout).  Returns
        one stage-named diagnosis per kill; with ``restart`` the worker
        respawns and replays in place."""
        max_age = (self.cfg.cluster.hang_timeout_s
                   if max_age_s is None else max_age_s)
        diagnoses = []
        for hb in self.check_heartbeats():
            if not hb["alive"] or hb["age_s"] is None:
                continue
            if hb["age_s"] > max_age:
                diagnoses.append(
                    f"shard {hb['shard']} wedged in stage "
                    f"{hb['stage']!r} for {hb['age_s']:.1f}s — killed")
                self.kill_worker(hb["shard"])
                if restart:
                    self.restart_worker(hb["shard"])
        return diagnoses

    # -- merged views ----------------------------------------------------
    def stats(self) -> Dict:
        """Merged ``Session.stats()`` schema + a ``cluster`` subtree."""
        out = self.router.session_stats()
        out["cluster"] = {"n_shards": self.n_shards,
                          "n_restarts": self.n_restarts,
                          "run_dir": self.run_dir,
                          "ready_wait_s": self.ready_wait_s,
                          "router": self.router.router_stats(),
                          "shards": self.router.statuses()}
        return out

    def shutdown(self) -> None:
        if self.endpoint is not None:
            self.endpoint.stop()
            self.endpoint = None
        if self.router is not None:
            self.router.shutdown()
        for i, proc in enumerate(self.procs):
            if proc is not None and proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=10)
            self.procs[i] = None

    def __enter__(self) -> "ClusterDeployment":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


# ----------------------------------------------------------------------
# drive-compatible engine facade
# ----------------------------------------------------------------------

class _StoreProxy:
    """The store attributes launcher loops read (extent, dims,
    budget)."""

    def __init__(self, router: Router, n_levels: int, budget_rows):
        self._router = router
        self.n_levels = n_levels
        self.budget_rows = budget_rows

    @property
    def n_nodes(self) -> int:
        return int(self._router.n_nodes)

    def level_dim(self, level: int) -> int:
        return self._router.dims[level % len(self._router.dims)]


class _ReinferProxy:
    def __init__(self, n_layers: int):
        self.n_layers = n_layers


class _QoSProxy:
    """Just enough QoS surface for the launcher's printouts: the
    registry (names/specs); scheduling itself lives in the workers."""

    def __init__(self, registry):
        self.registry = registry


class ClusterEngine:
    """Engine-shaped front over the router: strict submission-order
    FIFO service with the single-process refresh rule (see the module
    docstring for why that makes served bytes equal)."""

    def __init__(self, deployment: ClusterDeployment, router: Router):
        cfg = deployment.cfg
        self.deployment = deployment
        self.router = router
        self.log = router.log
        self.store = _StoreProxy(router, deployment.n_levels,
                                 cfg.store.budget_rows or None)
        self.reinfer = _ReinferProxy(deployment.n_levels - 1)
        self.staleness_bound = cfg.qos.staleness_bound
        registry = cfg.qos.tenant_registry()
        self.qos = _QoSProxy(registry) if registry is not None else None
        self._slos = ({t.name: t.staleness_slo for t in registry}
                      if registry is not None else {})
        self._queue: List = []
        self.last_refresh_stats: Dict = {}
        self.n_served = 0

    # -- engine surface --------------------------------------------------
    def submit(self, q) -> None:
        q.node_ids = np.asarray(q.node_ids, np.int64)
        self._queue.append(q)

    def mutate(self):
        return self.log

    def refresh(self) -> Dict:
        stats = self.router.commit_pending()
        if stats:
            self.last_refresh_stats = stats
        return stats

    def full_epoch(self, n_shards: Optional[int] = None) -> Dict:
        return self.router.full_epoch(n_shards)

    def _threshold(self, q) -> int:
        """The freshness bound this query serves under: its tenant's
        SLO with QoS, the global bound otherwise."""
        return int(self._slos.get(q.tenant, self.staleness_bound))

    def step(self) -> bool:
        """Serve ONE queued query end-to-end (refresh decision first —
        the single-process FIFO rule at this query's pin point)."""
        if not self._queue:
            return False
        q = self._queue.pop(0)
        if self.log.pending and (q.fresh
                                 or self.log.pending >= self._threshold(q)):
            self.refresh()
        q.out, q.served_version = self.router.lookup(
            q.node_ids, level=q.level, tenant=q.tenant, uid=q.uid)
        q.done = True
        self.n_served += 1
        return True

    def run(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not self.step():
                return

    def stats(self) -> Dict:
        return self.router.engine_stats()

    def memory_stats(self) -> Dict:
        return self.router.memory_stats()


__all__ = ["ClusterDeployment", "ClusterEngine", "WorkerWedged",
           "read_heartbeat"]
