"""ShardWorker — one OS process owning a partition range of the serving
tier; the port's copy of ``repro.gnnserve.cluster.worker``.

Each worker builds the FULL ``repro_torch`` ``Session`` world from the
shared ``DealConfig`` on its device (``--device``, the deployment's:
every worker of a deployment on the session's device, each with its own
CUDA context).  Two sessions built from equal configs are bitwise equal
worlds: the graph and X come from numpy, the params from a
``torch.Generator``, the kernels sum each row in order with no atomics,
and every GEMM call has the same row count (``core.ops.gemm_rows``).  So
shard "ownership" is a routing policy at the front door, not a
data-placement constraint: any worker CAN serve any row, the router
sends each id range to its owner for cache locality and QoS isolation,
and cross-shard consistency is the bitwise-equal-worlds invariant
rather than a distributed coherence protocol.  Per-shard
``ClusterSpec.overrides`` may tighten a worker's store budget or QoS
geometry — residency changes, served bytes don't (the
recompute-on-miss guarantee).

Determinism contract (what makes restart-replay *bitwise*):

  * the router alone decides when mutations fold: workers never refresh
    autonomously (their own mutation logs are empty between commits),
    so every worker applies the SAME mutation batches in the SAME
    order at the SAME epoch boundaries;
  * every ``commit`` carries a per-shard monotonic ``seq`` and is
    appended to the worker's write-ahead log (``shard<i>.wal``,
    JSON-lines) BEFORE it is applied; duplicate seqs ack idempotently
    (the router may re-send after a restart);
  * after a successful commit the worker checkpoints its world
    (``gnnserve.checkpoint.save_world`` -> ``shard<i>.ckpt.npz``) with
    ``committed_seq``;
  * a restarted worker restores the checkpoint and replays exactly the
    WAL entries with ``seq > committed_seq``, each as one refresh at
    its original batch boundary — landing bitwise-equal to a
    never-killed worker.

Liveness: the worker stamps ``shard<i>.hb`` with ``<unix-time> <stage>``
from its MAIN thread before every potentially-slow stage (build,
restore, replay, each op).  The deployment watches the file's mtime, so
a hung worker is killed with a stage-named diagnosis instead of a bare
timeout.

Protocol ops (see ``protocol`` for framing): status, lookup, commit,
full_epoch, checkpoint, digest, stats, engine_stats, memory_stats,
health, shutdown — plus ``_test_hang``, a deliberate main-thread wedge
for the harness tests.  The port's ``status`` reply carries three
diagnostics the JAX package's lacks: ``kernel_launches`` (this
process's ``kernels.ops.launch_counts()``: the parent cannot see a
worker's launches), ``timings`` (seconds of the last world load —
build, restore or epoch, replay — and of the last commit — apply with
its refresh, WAL append, checkpoint) and ``memory`` (this process's
peak host RSS, sampled at the end of each world load and op, and, on a
card, its peak allocated device bytes).

    python -m repro_torch.gnnserve.cluster.worker --config CFG.json \
        --shard 0 --n-shards 2 --dir RUN_DIR [--device cuda]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import sys
import time
import traceback
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.gnnserve.cluster.protocol import recv_msg, send_msg

_HEX = "0123456789abcdef"


class Heartbeat:
    """Main-thread liveness stamps (``<time> <stage>``), the JAX
    package's format: a timer thread would keep ticking through a wedge
    and hide it."""

    def __init__(self, path: Optional[str]):
        self.path = path

    def beat(self, stage: str) -> None:
        if not self.path:
            return
        try:
            with open(self.path, "w") as f:
                f.write(f"{time.time():.3f} {stage}\n")
        except OSError as exc:
            print(f"# heartbeat write failed: {exc}", file=sys.stderr)


def _wal_encode(entry: Dict) -> str:
    return json.dumps(entry, sort_keys=True)


def _rows_to_wire(rows: Optional[np.ndarray]):
    """float32 rows -> JSON lists.  Exact: float32 -> float64 is exact,
    json round-trips the float64, and the cast back truncates to the
    original float32 bit pattern."""
    if rows is None:
        return None
    return np.asarray(rows, np.float32).tolist()


def _rows_from_wire(data, d: Optional[int] = None
                    ) -> Optional[np.ndarray]:
    if data is None:
        return None
    arr = np.asarray(data, np.float32)
    if arr.size == 0 and d is not None:
        arr = arr.reshape(0, d)
    return arr


class WorkerCore:
    """The op dispatcher over one Session world — everything but the
    socket, so tests drive restart/replay/bitwise in-process."""

    def __init__(self, cfg, shard: int, n_shards: int, run_dir: str,
                 heartbeat: Optional[Heartbeat] = None, device="cuda"):
        self.device = device
        self.shard = int(shard)
        self.n_shards = int(n_shards)
        self.dir = run_dir
        self.hb = heartbeat or Heartbeat(None)
        self.cfg = self._shard_config(cfg)
        self.wal_path = os.path.join(run_dir, f"shard{shard}.wal")
        self.ckpt_path = os.path.join(run_dir, f"shard{shard}.ckpt.npz")
        self.session = None
        self.timings: Dict[str, float] = {}
        self.rss_peak = 0
        self._load_world()

    def _load_world(self) -> None:
        """(Re)build the engine at the last COMMITTED state: restore
        the checkpoint when one exists (fresh world otherwise), then
        replay the WAL tail past ``committed_seq``.  Both the startup
        path and the recovery path after a failed apply (which may have
        half-mutated the live engine) land here."""
        from repro_torch.api.session import Session
        if self.session is not None:
            self.session.close()
        self.last_seq = 0
        self.replayed = 0
        self.restored = False
        self.last_refresh_stats: Dict = {}
        self.hb.beat("build")
        t0 = time.perf_counter()
        self.session = Session.build(self.cfg, device=self.device)
        t1 = time.perf_counter()
        if os.path.exists(self.ckpt_path):
            from repro_torch.gnnserve.checkpoint import restore_into_session
            self.hb.beat("restore")
            meta = restore_into_session(self.session, self.ckpt_path)
            self.last_seq = int(meta["committed_seq"])
            self.restored = True
        else:
            self.session.serve()
        t2 = time.perf_counter()
        self.engine = self.session.engine
        self.hb.beat("replay")
        self._replay_wal()
        self.timings.update(
            build_s=t1 - t0, replay_s=time.perf_counter() - t2,
            **{"restore_s" if self.restored else "epoch_s": t2 - t1})
        self._sample_rss()

    def _shard_config(self, cfg):
        """A deep copy with this shard's overrides applied and the
        worker-inappropriate bits neutralized (the ROUTER owns the HTTP
        front door and the cluster spec itself — a worker recursively
        launching a cluster would fork-bomb)."""
        from repro_torch.api.config import DealConfig
        cfg = DealConfig.from_dict(cfg.to_dict())
        cfg.telemetry.http_port = -1
        cfg.telemetry.snapshot_path = ""
        cfg.cluster.n_shards = 0
        for ov in cfg.cluster.overrides:
            if int(ov.get("shard", -1)) != self.shard:
                continue
            for k, v in ov.items():
                if k == "shard":
                    continue
                if k in ("budget_rows", "evict_policy", "admission"):
                    setattr(cfg.store, k, v)
                elif k in ("staleness_bound", "batch_slots",
                           "rows_per_step"):
                    setattr(cfg.qos, k, v)
        # folded into store/qos above; with n_shards zeroed, leftover
        # shard-indexed overrides would fail validation
        cfg.cluster.overrides = ()
        return cfg

    # -- WAL ------------------------------------------------------------
    def _wal_append(self, entry: Dict) -> None:
        """Durable BEFORE applied: a crash mid-apply replays the entry;
        a crash before the append means the router never got an ack and
        re-sends it with the same seq.  An apply that RAISES (rather
        than crashes) truncates the entry back out via ``_rollback`` —
        the WAL only ever ends at a committed boundary."""
        with open(self.wal_path, "a") as f:
            f.write(_wal_encode(entry) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def _replay_wal(self) -> None:
        if not os.path.exists(self.wal_path):
            return
        prev = None
        with open(self.wal_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                entry = json.loads(line)
                seq = int(entry["seq"])
                # the on-disk chain must be strictly increasing: a
                # duplicate seq means a torn entry escaped rollback —
                # replaying either copy could apply a batch the cluster
                # never committed, so refuse loudly instead
                if prev is not None and seq <= prev:
                    raise ValueError(
                        f"shard {self.shard}: WAL seq {seq} after "
                        f"{prev} — duplicate/out-of-order entry in "
                        f"{self.wal_path}")
                prev = seq
                if seq <= self.last_seq:
                    continue
                if seq != self.last_seq + 1:
                    raise ValueError(
                        f"shard {self.shard}: WAL gap — entry seq "
                        f"{seq} after committed {self.last_seq}")
                self.hb.beat(f"replay:seq{seq}")
                if entry["kind"] == "commit":
                    self._apply_commit(entry)
                elif entry["kind"] == "full_epoch":
                    self._apply_full_epoch(entry.get("n_shards"))
                else:
                    raise ValueError(
                        f"unknown WAL entry kind {entry['kind']!r}")
                self.last_seq = seq
                self.replayed += 1
        if self.replayed:
            # re-checkpoint so the NEXT restart skips this replay
            self._save_checkpoint()

    def _save_checkpoint(self) -> None:
        from repro_torch.gnnserve.checkpoint import save_world
        tmp = self.ckpt_path + ".tmp"
        save_world(tmp, self.engine, committed_seq=self.last_seq)
        os.replace(tmp, self.ckpt_path)

    def _wal_size(self) -> int:
        try:
            return os.path.getsize(self.wal_path)
        except OSError:
            return 0

    def _rollback(self, wal_pos: int) -> None:
        """A failed apply must leave NO trace: truncate the WAL back
        past the torn entry (otherwise a restart replays it and a later
        commit appends a second entry with the same seq) and rebuild
        the world at the last committed state — the apply may have
        half-mutated the live engine before raising."""
        with open(self.wal_path, "r+") as f:
            f.truncate(wal_pos)
            f.flush()
            os.fsync(f.fileno())
        self.hb.beat("recover")
        self._load_world()

    # -- mutation fold --------------------------------------------------
    def _apply_commit(self, entry: Dict) -> Dict:
        eng = self.engine
        log = eng.mutate()
        for kind, s, d in entry.get("edge_ops", []):
            if kind == "add":
                log.add_edge(int(s), int(d))
            else:
                log.remove_edge(int(s), int(d))
        feat_ids = np.asarray(entry.get("feat_ids", []), np.int64)
        if feat_ids.size:
            log.update_features(
                feat_ids, _rows_from_wire(entry["feat_rows"]))
        n_new = int(entry.get("n_new_nodes", 0))
        if n_new:
            log.add_nodes(n_new,
                          _rows_from_wire(entry.get("new_node_rows")))
        stats = eng.refresh() if log.pending else dict(
            self.last_refresh_stats)
        if eng.qos is not None:
            # a router commit is a BARRIER freshness event: every
            # tenant's view advances to the committed epoch, so per-
            # shard view lag can never depend on per-shard traffic —
            # the determinism the replay contract needs
            eng.qos.advance_views(eng.qos.registry.names,
                                  eng.store.version, eng.ops_drained,
                                  refreshed=bool(feat_ids.size or n_new
                                                 or entry.get("edge_ops")))
        self.last_refresh_stats = stats
        return stats

    def _apply_full_epoch(self, n_shards: Optional[int]) -> Dict:
        return self.engine.full_epoch(n_shards or None)

    # -- op dispatch ----------------------------------------------------
    def dispatch(self, header: Dict, arrays: Dict[str, np.ndarray]
                 ) -> Tuple[Dict, Dict[str, np.ndarray]]:
        op = header.get("op", "?")
        self.hb.beat(f"op:{op}")
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            raise ValueError(f"unknown op {op!r}")
        resp, resp_arrays = fn(header, arrays)
        resp.setdefault("ok", True)
        self._sample_rss()
        self.hb.beat("idle")
        return resp, resp_arrays

    def _op_status(self, header, arrays):
        from repro_torch.kernels import ops as kops
        st = self.engine.store
        return {"shard": self.shard, "n_shards": self.n_shards,
                "pid": os.getpid(), "n_nodes": int(st.n_nodes),
                "n_levels": int(st.n_levels),
                "dims": [st.level_dim(l) for l in range(st.n_levels)],
                "store_version": int(st.version),
                "last_seq": self.last_seq,
                "replayed": self.replayed,
                "restored": self.restored,
                "pending": int(self.engine.log.pending),
                "kernel_launches": kops.launch_counts(),
                "timings": dict(self.timings),
                "memory": self._memory()}, {}

    def _memory(self) -> Dict[str, int]:
        """Peak host RSS, sampled at the end of each world load and op,
        and, on a card, peak allocated device bytes (0 on the CPU)."""
        import torch
        device = self.session.device
        self._sample_rss()
        dev = (torch.cuda.max_memory_allocated(device)
               if device.type == "cuda" else 0)
        return {"host_peak_rss_bytes": self.rss_peak,
                "device_peak_bytes": int(dev)}

    def _sample_rss(self) -> None:
        self.rss_peak = max(self.rss_peak, _rss_bytes())

    def _op_lookup(self, header, arrays):
        from repro_torch.gnnserve.engine import Query
        eng = self.engine
        q = Query(uid=int(header.get("uid", 0)),
                  node_ids=np.asarray(arrays["ids"], np.int64),
                  level=int(header.get("level", -1)),
                  tenant=header.get("tenant", "default"))
        eng.submit(q)
        eng.run()
        if not q.done:
            raise RuntimeError("worker engine left a query unserved")
        return {"served_version": int(q.served_version)}, {"rows": q.out}

    def _op_commit(self, header, arrays):
        seq = int(header["seq"])
        if seq <= self.last_seq:
            # idempotent re-send after a router reconnect: the entry is
            # already durable and applied (or will replay); ack as-is
            return {"seq": seq, "duplicate": True,
                    "store_version": int(self.engine.store.version),
                    "n_nodes": int(self.engine.store.n_nodes),
                    "stats": _sanitize(self.last_refresh_stats)}, {}
        if seq != self.last_seq + 1:
            raise ValueError(
                f"shard {self.shard}: commit seq {seq} breaks the "
                f"monotonic chain at {self.last_seq}")
        entry = {"seq": seq, "kind": "commit",
                 "edge_ops": [[k, int(s), int(d)]
                              for k, s, d in header.get("edge_ops", [])],
                 "feat_ids": [int(i) for i in
                              np.asarray(arrays.get(
                                  "feat_ids", np.empty(0, np.int64)))],
                 "feat_rows": _rows_to_wire(arrays.get("feat_rows")),
                 "n_new_nodes": int(header.get("n_new_nodes", 0)),
                 "new_node_rows": _rows_to_wire(
                     arrays.get("new_node_rows"))}
        if entry["feat_rows"] is None:
            entry["feat_rows"] = []
        wal_pos = self._wal_size()
        t0 = time.perf_counter()
        self._wal_append(entry)
        t1 = time.perf_counter()
        try:
            stats = self._apply_commit(entry)
        except Exception:
            self._rollback(wal_pos)
            raise
        self.last_seq = seq
        t2 = time.perf_counter()
        self._save_checkpoint()
        self.timings.update(commit_wal_s=t1 - t0, commit_apply_s=t2 - t1,
                            commit_checkpoint_s=time.perf_counter() - t2)
        return {"seq": seq, "duplicate": False,
                "store_version": int(self.engine.store.version),
                "n_nodes": int(self.engine.store.n_nodes),
                "stats": _sanitize(stats)}, {}

    def _op_full_epoch(self, header, arrays):
        seq = int(header["seq"])
        if seq <= self.last_seq:
            return {"seq": seq, "duplicate": True,
                    "store_version": int(self.engine.store.version),
                    "stats": {}}, {}
        if seq != self.last_seq + 1:
            raise ValueError(
                f"shard {self.shard}: full_epoch seq {seq} breaks the "
                f"monotonic chain at {self.last_seq}")
        entry = {"seq": seq, "kind": "full_epoch",
                 "n_shards": header.get("n_shards")}
        wal_pos = self._wal_size()
        self._wal_append(entry)
        try:
            stats = self._apply_full_epoch(entry["n_shards"])
        except Exception:
            self._rollback(wal_pos)
            raise
        self.last_seq = seq
        self._save_checkpoint()
        return {"seq": seq, "duplicate": False,
                "store_version": int(self.engine.store.version),
                "n_nodes": int(self.engine.store.n_nodes),
                "stats": _sanitize(stats)}, {}

    def _op_checkpoint(self, header, arrays):
        self._save_checkpoint()
        return {"path": self.ckpt_path,
                "committed_seq": self.last_seq}, {}

    def _op_digest(self, header, arrays):
        """sha256 over every level's rows for ALL nodes (evicted rows
        rebuild through recompute-on-miss, so the digest is residency-
        independent) — the cluster-wide bitwise-equality probe."""
        st = self.engine.store
        ids = np.arange(st.n_nodes, dtype=np.int64)
        digests = {}
        for level in range(st.n_levels):
            h = hashlib.sha256()
            h.update(st.lookup(ids, level).tobytes())
            digests[f"level{level}"] = h.hexdigest()
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(st.bounds).tobytes())
        digests["bounds"] = h.hexdigest()
        return {"digests": digests, "store_version": int(st.version),
                "n_nodes": int(st.n_nodes)}, {}

    def _op_stats(self, header, arrays):
        return {"stats": _sanitize(self.session.stats())}, {}

    def _op_engine_stats(self, header, arrays):
        return {"stats": _sanitize(self.engine.stats()),
                "last_refresh": _sanitize(self.last_refresh_stats)}, {}

    def _op_memory_stats(self, header, arrays):
        return {"stats": _sanitize(self.engine.memory_stats())}, {}

    def _op_health(self, header, arrays):
        mon = self.engine.health
        summary = mon.summary() if mon is not None else {
            "n_alerts": 0, "alerts": [], "burn_rate": {},
            "wait_burn_rate": {}, "firing": []}
        summary["status"] = "alerting" if summary["firing"] else "ok"
        return {"health": _sanitize(summary)}, {}

    def _op_shutdown(self, header, arrays):
        return {"bye": True}, {}

    def _op__test_hang(self, header, arrays):
        """Deliberate main-thread wedge (never acks) — the target the
        heartbeat/wedge-detection harness tests shoot at."""
        self.hb.beat("op:_test_hang")
        time.sleep(float(header.get("seconds", 3600)))
        return {}, {}


def _sanitize(obj):
    from repro_torch.obs.endpoint import json_sanitize
    return json_sanitize(obj)


def _rss_bytes() -> int:
    """This process's resident set size now (``/proc/self/statm``).
    ``getrusage``'s maximum is no use in a worker: it carries the
    spawning parent's, which survives ``exec``."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def serve_loop(core: WorkerCore, sock: socket.socket) -> None:
    """Sequential accept loop: the router holds ONE persistent channel;
    probes (deployment readiness, tests) connect, ask, and disconnect.
    Single-threaded on purpose — the engine is single-threaded, and the
    main thread doing the work is what makes heartbeat stamps honest."""
    sock.settimeout(1.0)
    core.hb.beat("idle")
    while True:
        try:
            conn, _ = sock.accept()
        except socket.timeout:
            core.hb.beat("idle")
            continue
        # keep a timeout on the PERSISTENT router connection too: an
        # idle worker must wake to stamp heartbeats, or wedge detection
        # would false-positive on every healthy-but-quiet shard.  A
        # timeout while waiting for a frame to START is idleness; one
        # mid-frame (WorkerTimeout) means the sender died mid-send.
        conn.settimeout(1.0)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                try:
                    header, arrays = recv_msg(conn)
                except socket.timeout:
                    core.hb.beat("idle")
                    continue
                except Exception:
                    break               # client went away; next accept
                if header.get("op") == "shutdown":
                    send_msg(conn, {"ok": True, "bye": True})
                    core.hb.beat("shutdown")
                    return
                try:
                    resp, resp_arrays = core.dispatch(header, arrays)
                except Exception as exc:
                    resp = {"ok": False, "error": f"{exc}",
                            "traceback": traceback.format_exc()}
                    resp_arrays = {}
                    core.hb.beat("idle")
                try:
                    send_msg(conn, resp, resp_arrays)
                except Exception:
                    break
        finally:
            try:
                conn.close()
            except OSError:
                pass


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--shard", type=int, required=True)
    ap.add_argument("--n-shards", type=int, required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--heartbeat", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    hb = Heartbeat(args.heartbeat)
    hb.beat("startup")
    from repro_torch.api.config import DealConfig
    cfg = DealConfig.load(args.config)
    core = WorkerCore(cfg, args.shard, args.n_shards, args.dir,
                      heartbeat=hb, device=args.device)
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((args.host, args.port))
    sock.listen(8)
    port = sock.getsockname()[1]
    # the port file doubles as the readiness marker: written AFTER the
    # world is built/restored/replayed and the socket listens
    port_path = os.path.join(args.dir, f"shard{args.shard}.port")
    tmp = port_path + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{port}\n")
    os.replace(tmp, port_path)
    try:
        serve_loop(core, sock)
    finally:
        sock.close()


if __name__ == "__main__":
    main()
