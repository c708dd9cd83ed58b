"""Router — the stateless-ish RPC front door of the cluster tier; the
port's copy of ``repro.gnnserve.cluster.router``.

Queries route to owning shards along the store's existing 1-D
partitioning: ``bounds`` (the ``linspace`` node ranges the launch-time
world was sharded into) decide ownership, tail ids onboarded past the
launch extent clip to the LAST shard.  One client lookup whose ids span
several ranges scatter/gathers: per-owner sub-lookups fan out on a
thread pool (each worker serves its slice through its own
continuous-batching engine), the rows land back in client order.

Mutations never reach a worker one-by-one.  The router buffers them in
its own ``MutationLog`` — the same log clients already write through
``Session.apply_mutations()`` — and folds them with ONE ``commit``
broadcast carrying the whole drained batch and a per-shard monotonic
sequence number.  Workers WAL + apply + refresh the batch atomically,
which is what keeps every worker's world bitwise-equal: all shards fold
the same batches in the same order at the same epoch boundaries, and a
restarted worker replays exactly the committed batches it missed
(``worker.py``'s replay contract).  A commit that fails on only SOME
shards never drops the batch or reuses a seq: the router resyncs each
failed shard's seq from its status, requeues a batch that is durable
nowhere, and parks a partially-durable one in-flight until every shard
has folded it (``commit_pending``'s failure contract).

Stat merging keeps the single-process ``Session.stats()`` schema:
traffic counters SUM across shards, world-replicated values (versions,
epoch counters) assert equal and pass through, per-tenant attribution
sums reconcile exactly (each sub-query's segments sum against its own
e2e, so ``attributed_frac`` holds cluster-wide), and latency
percentiles take the worst shard.  ``RouterEndpoint`` serves the merged
tree plus an aggregated ``/healthz`` in the same shapes as
``obs.endpoint.TelemetryEndpoint``.
"""
from __future__ import annotations

import contextlib
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.gnnserve.cluster.protocol import (Channel, ProtocolError,
                                                   WorkerError,
                                                   WorkerTimeout)
from repro_torch.gnnserve.mutations import MutationLog

# transport failures worth one reconnect-and-retry (every router op is
# safe to retry: lookups/stats are reads, commits are seq-idempotent);
# WorkerError is NOT here — the remote handler failed, retrying repeats it
_RETRYABLE = (ProtocolError, WorkerTimeout, OSError)


class _RWLock:
    """Shared/exclusive lock over the cluster epoch: lookups and stat
    scrapes read SHARED (they must all see one consistent epoch across
    shards), commits/full epochs write EXCLUSIVE.  Writers get priority
    so a commit is never starved by a stream of lookups."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextlib.contextmanager
    def read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if not self._readers:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


class Router:
    def __init__(self, channels: Sequence[Channel], bounds: np.ndarray,
                 dims: Sequence[int], *,
                 reconnect: Optional[Callable[[int], Channel]] = None):
        self.channels: List[Channel] = list(channels)
        self.n_shards = len(self.channels)
        self.bounds = np.asarray(bounds, np.int64)
        assert self.bounds.size == self.n_shards + 1
        self.dims = [int(d) for d in dims]
        self.n_nodes = int(self.bounds[-1])  # grows under onboarding
        self.reconnect = reconnect
        self.log = MutationLog()
        self.seq = [0] * self.n_shards
        self.n_lookups = 0
        self.n_subqueries = 0       # per-shard RPCs issued for lookups
        self.n_scatter = 0          # lookups that spanned >1 shard
        self.n_commits = 0
        self.n_retries = 0
        self._pool = ThreadPoolExecutor(
            max_workers=max(self.n_shards, 1),
            thread_name_prefix="deal-router")
        # epoch lock: lookups/scrapes shared, commits exclusive — a
        # lookup that scatters mid-commit would gather rows from
        # different epochs
        self._rw = _RWLock()
        # a sequenced op that is durable on SOME shard but unacked on
        # others parks here; it re-drives (same per-shard seq, workers
        # ack duplicates idempotently) before any new batch drains
        self._inflight: Optional[Dict] = None

    # -- routing --------------------------------------------------------
    def owner_of(self, ids: np.ndarray) -> np.ndarray:
        """Owning shard per id: the launch-time 1-D range it falls in;
        tail ids past the last bound belong to the LAST shard (tail
        partitions append past the main partitioning)."""
        return np.clip(
            np.searchsorted(self.bounds, np.asarray(ids, np.int64),
                            side="right") - 1,
            0, self.n_shards - 1)

    def _call(self, shard: int, op: str, arrays=None, **fields):
        """One RPC with a single reconnect-and-retry on transport
        failure (a killed worker restarts + replays before answering)."""
        try:
            return self.channels[shard].request(op, arrays, **fields)
        except _RETRYABLE:
            if self.reconnect is None:
                raise
            self.n_retries += 1
            self.channels[shard].close()
            self.channels[shard] = self.reconnect(shard)
            return self.channels[shard].request(op, arrays, **fields)

    def broadcast(self, op: str, arrays=None, **fields) -> List[Dict]:
        """The same op to every shard, in parallel; headers in shard
        order.  Holds the epoch read lock so a broadcast scrape never
        interleaves with a commit (per-shard stats stay one epoch)."""
        with self._rw.read():
            futs = [self._pool.submit(self._call, s, op, arrays,
                                      **fields)
                    for s in range(self.n_shards)]
            return [f.result()[0] for f in futs]

    # -- scatter/gather lookup ------------------------------------------
    def lookup(self, node_ids: np.ndarray, *, level: int = -1,
               tenant: str = "default", uid: int = 0):
        """Route ``node_ids`` to their owners, gather the rows back in
        client order.  Returns ``(rows, served_version)``."""
        ids = np.asarray(node_ids, np.int64)
        d = self.dims[level % len(self.dims)]
        with self._rw.read():
            if ids.size == 0:       # zero parts — nothing to scatter,
                                    # serve the current epoch directly
                st = self._call(0, "status")[0]
                return (np.empty((0, d), np.float32),
                        int(st["store_version"]))
            owners = self.owner_of(ids)
            out = np.empty((ids.size, d), np.float32)
            parts = [(int(s), np.flatnonzero(owners == s))
                     for s in np.unique(owners)]
            self.n_lookups += 1
            if len(parts) > 1:
                self.n_scatter += 1

            def _one(s, idx):
                resp, arrs = self._call(s, "lookup", {"ids": ids[idx]},
                                        level=level, tenant=tenant,
                                        uid=uid)
                return resp["served_version"], idx, arrs["rows"]

            # commits are excluded by the read lock, so one retry only
            # covers a shard that restarted/replayed mid-gather
            versions: set = set()
            for _ in range(2):
                futs = [self._pool.submit(_one, s, idx)
                        for s, idx in parts]
                versions = set()
                for f in futs:
                    version, idx, rows = f.result()
                    out[idx] = rows
                    versions.add(int(version))
                self.n_subqueries += len(parts)
                if len(versions) == 1:
                    return out, versions.pop()
            raise RuntimeError(
                f"shards served different epochs {sorted(versions)} "
                f"for one query — the commit barrier is broken")

    # -- mutation fold --------------------------------------------------
    def commit_pending(self) -> Dict:
        """Drain the router's mutation log and fold it on EVERY shard as
        one sequenced commit.  Returns shard 0's refresh stats (the
        worlds are replicas; their stats are equal).

        Failure contract: a batch is never silently dropped and a seq
        is never reused for a different batch.  If a shard's commit RPC
        fails, the router resyncs that shard's seq from its status; a
        batch that is positively durable NOWHERE requeues into the log,
        while one that landed on SOME shard parks in-flight and must
        complete everywhere (re-driven here, same seqs, duplicate acks)
        before the next batch drains."""
        with self._rw.write():
            self._drive_inflight()
            if not self.log.pending:
                return {}
            batch = self.log.drain()
            fields = {"edge_ops": [[k, int(s), int(d)]
                                   for k, s, d in batch.edge_ops],
                      "n_new_nodes": int(batch.n_new_nodes)}
            arrays = {"feat_ids": np.asarray(batch.feat_ids, np.int64),
                      "feat_rows": np.asarray(batch.feat_rows,
                                              np.float32)}
            if batch.new_node_rows is not None:
                arrays["new_node_rows"] = np.asarray(
                    batch.new_node_rows, np.float32)
            return self._sequenced("commit", fields, arrays,
                                   batch=batch)

    def full_epoch(self, n_shards: Optional[int] = None) -> Dict:
        """Sequenced re-partition epoch on every shard (pending
        mutations fold first, exactly like the single-process path)."""
        self.commit_pending()
        with self._rw.write():
            self._drive_inflight()
            return self._sequenced("full_epoch",
                                   {"n_shards": n_shards}, None)

    def _sequenced(self, op: str, fields: Dict, arrays,
                   batch=None) -> Dict:
        """One sequenced op to every shard, each shard's result handled
        INDIVIDUALLY — one failed future must not abandon the seq
        bookkeeping of the shards that committed.  Caller holds the
        write lock."""
        target = [s + 1 for s in self.seq]

        def _one(s):
            return self._call(s, op, arrays, seq=target[s], **fields)[0]

        futs = {s: self._pool.submit(_one, s)
                for s in range(self.n_shards)}
        resps: Dict[int, Dict] = {}
        failures: Dict[int, Exception] = {}
        for s, f in futs.items():
            try:
                resps[s] = f.result()
                self.seq[s] = int(resps[s]["seq"])
            except Exception as exc:     # noqa: BLE001 — per-shard
                failures[s] = exc
        if failures:
            # raises unless the resync shows every shard reached target
            self._resolve_failures(op, fields, arrays, target,
                                   failures, batch)
        if op == "commit":
            self.n_commits += 1
        versions = {int(r["store_version"]) for r in resps.values()}
        if len(versions) > 1:
            raise RuntimeError(
                f"{op} left shards at different epochs "
                f"{sorted(versions)}")
        if not resps:           # every ack was lost but resync proved
            return {}           # the op applied cluster-wide
        first = resps[min(resps)]
        self.n_nodes = int(first.get("n_nodes", self.n_nodes))
        return first.get("stats", {})

    def _resolve_failures(self, op: str, fields: Dict, arrays, target,
                          failures: Dict[int, Exception],
                          batch) -> None:
        """Resync each failed shard's seq from its status: an applied-
        but-unacked commit just advances our bookkeeping; anything
        still behind requeues (durable nowhere) or parks in-flight
        (durable somewhere — it MUST complete everywhere)."""
        unknown = []
        for s in failures:
            try:
                st = self._call(s, "status")[0]
            except Exception:            # noqa: BLE001 — state unknown
                unknown.append(s)
                continue
            if int(st["last_seq"]) >= target[s]:
                self.seq[s] = target[s]  # applied; the ack was lost
        behind = [s for s in range(self.n_shards)
                  if self.seq[s] < target[s]]
        if not behind:
            return
        cause = failures[behind[0]] if behind[0] in failures else \
            next(iter(failures.values()))
        applied_anywhere = any(self.seq[s] >= target[s]
                               for s in range(self.n_shards))
        if batch is not None and not applied_anywhere and not unknown:
            # positively durable nowhere: the mutations go back in the
            # log so the next commit re-drains them under fresh seqs
            self.log.requeue(batch)
            raise RuntimeError(
                f"{op} failed on shards {behind} before any shard "
                f"applied it; batch requeued "
                f"({self.log.pending} mutations pending)") from cause
        self._inflight = {"op": op, "fields": fields,
                          "arrays": arrays, "target": list(target)}
        raise RuntimeError(
            f"{op} is durable on some shards but failed on "
            f"{sorted(set(behind) | set(unknown))}; parked in-flight — "
            f"it will re-drive before the next commit") from cause

    def _drive_inflight(self) -> None:
        """Complete a parked sequenced op on every shard still behind
        its target seq (shards that already applied ack the duplicate
        idempotently).  Caller holds the write lock."""
        inf = self._inflight
        if inf is None:
            return
        op, target = inf["op"], inf["target"]
        behind = [s for s in range(self.n_shards)
                  if self.seq[s] < target[s]]
        failures: Dict[int, Exception] = {}

        def _one(s):
            return self._call(s, op, inf["arrays"], seq=target[s],
                              **inf["fields"])[0]

        futs = {s: self._pool.submit(_one, s) for s in behind}
        for s, f in futs.items():
            try:
                self.seq[s] = max(self.seq[s], int(f.result()["seq"]))
            except Exception as exc:     # noqa: BLE001 — per-shard
                failures[s] = exc
        still = [s for s in range(self.n_shards)
                 if self.seq[s] < target[s]]
        if still:
            raise RuntimeError(
                f"in-flight {op} still incomplete on shards "
                f"{still}") from next(iter(failures.values()), None)
        self._inflight = None
        if op == "commit":
            self.n_commits += 1

    # -- merged views ---------------------------------------------------
    def statuses(self) -> List[Dict]:
        return self.broadcast("status")

    def digests(self) -> List[Dict]:
        return self.broadcast("digest")

    def _client_counts(self, merged: Dict) -> Dict:
        """Workers count SUB-queries (one per shard a lookup touched);
        the client-facing count is the router's.  Keep both."""
        merged["n_served_subqueries"] = merged.get("n_served", 0)
        merged["n_served"] = self.n_lookups
        return merged

    def engine_stats(self) -> Dict:
        per_shard = [r["stats"] for r in self.broadcast("engine_stats")]
        return self._client_counts(
            merge_engine_stats(per_shard, pending=self.log.pending))

    def memory_stats(self) -> Dict:
        per_shard = [r["stats"] for r in self.broadcast("memory_stats")]
        return merge_memory_stats(per_shard)

    def session_stats(self) -> Dict:
        per_shard = [r["stats"] for r in self.broadcast("stats")]
        return self._client_counts(
            merge_session_stats(per_shard, pending=self.log.pending))

    def health(self) -> Dict:
        per_shard = [r["health"] for r in self.broadcast("health")]
        return merge_health(per_shard)

    def last_refresh_stats(self) -> Dict:
        return self.broadcast("engine_stats")[0]["last_refresh"]

    def router_stats(self) -> Dict:
        return {"n_shards": self.n_shards,
                "n_lookups": self.n_lookups,
                "n_subqueries": self.n_subqueries,
                "n_scatter": self.n_scatter,
                "n_commits": self.n_commits,
                "n_retries": self.n_retries,
                "seq": list(self.seq),
                "pending_mutations": int(self.log.pending),
                "inflight": (self._inflight["op"]
                             if self._inflight else None)}

    def shutdown(self) -> None:
        for s in range(self.n_shards):
            try:
                self.channels[s].request("shutdown")
            except _RETRYABLE:
                pass                # already dead is fine at teardown
            self.channels[s].close()
        self._pool.shutdown(wait=False)


# ----------------------------------------------------------------------
# stat merging (single-process Session.stats() schema, cluster-wide)
# ----------------------------------------------------------------------

# engine/store counters that measure TRAFFIC (each worker saw only its
# slice — the cluster total is the sum)
_SUM_KEYS = frozenset((
    "n_served", "n_gather_steps", "store_n_lookups",
    "store_rows_gathered", "store_hits", "store_misses",
    "store_n_evictions", "store_rows_evicted", "store_n_recomputes",
    "store_n_recompute_spans", "store_rows_recomputed",
    "store_recompute_s", "store_resident_bytes"))

# per-tenant keys where the cluster-wide value is the WORST shard
# (percentiles/maxima/utilization), not the sum
_TENANT_MAX = ("_p50", "_p95", "_max", "quota_util", "view_version")
# per-tenant keys replicated by construction (same registry everywhere)
_TENANT_FIRST = ("staleness_slo",)


def _merge_tenants(per_shard: List[Dict]) -> Dict:
    out: Dict[str, Dict] = {}
    for shard in per_shard:
        for name, t in shard.items():
            if name not in out:
                out[name] = dict(t)
                continue
            m = out[name]
            for k, v in t.items():
                if any(k.endswith(s) or k == s for s in _TENANT_FIRST):
                    continue
                if any(k.endswith(s) or k == s for s in _TENANT_MAX):
                    m[k] = max(m[k], v)
                else:
                    m[k] = m.get(k, 0) + v
    return out


def merge_engine_stats(per_shard: List[Dict], *, pending: int = 0
                       ) -> Dict:
    """Merge per-shard ``EmbeddingServeEngine.stats()`` trees into one
    tree of the same shape."""
    assert per_shard
    versions = {int(s["store_version"]) for s in per_shard}
    if len(versions) > 1:           # a real error, not an assert: the
        raise RuntimeError(         # /stats endpoint must surface it
            f"shards report different store versions "  # under -O too
            f"{sorted(versions)}")
    out = dict(per_shard[0])        # replicated keys pass through
    for k in _SUM_KEYS:
        if k in out:
            out[k] = sum(s[k] for s in per_shard)
    hits = out.get("store_hits", 0)
    misses = out.get("store_misses", 0)
    out["store_hit_rate"] = hits / max(hits + misses, 1)
    if "store_budget_util" in out:  # worst shard (budgets may differ
        out["store_budget_util"] = max(    # under per-shard overrides)
            s["store_budget_util"] for s in per_shard)
    # workers hold no pending mutations between commits; the truth is
    # the router's buffer
    out["pending_mutations"] = int(pending)
    if "tenants" in out:
        out["tenants"] = _merge_tenants(
            [s.get("tenants", {}) for s in per_shard])
    return out


def merge_memory_stats(per_shard: List[Dict]) -> Dict:
    """Per-level residency summed across shards (the cluster's real
    footprint: every worker holds its own replica/budget)."""
    out: Dict[str, Dict] = {}
    for shard in per_shard:
        for level, m in shard.items():
            if level not in out:
                out[level] = dict(m)
            else:
                for k, v in m.items():
                    out[level][k] = out[level][k] + v
    for level, m in out.items():
        m["budget_util"] = (m["resident_rows"] / max(m["budget_rows"], 1)
                            if not level.endswith("level0") else 0.0)
    return out


def merge_attribution(per_shard: List[Dict]) -> Dict:
    """Per-tenant critical-path summaries merged across shards: counts
    and segment/e2e SUMS add (each sub-query's ledger closes against its
    own e2e, so the 5% ``attributed_frac`` reconciliation survives the
    merge), means re-derive, percentiles take the worst shard."""
    out: Dict[str, Dict] = {}
    for shard in per_shard:
        for name, t in shard.items():
            if name not in out:
                out[name] = json.loads(json.dumps(t))   # deep copy
                continue
            m = out[name]
            m["n_queries"] += t["n_queries"]
            e = m["e2e_ms"]
            e["sum"] += t["e2e_ms"]["sum"]
            for k in ("p50", "p95", "max"):
                e[k] = max(e[k], t["e2e_ms"][k])
            for s, v in t["segments_ms"].items():
                m["segments_ms"][s] += v
    for m in out.values():
        e2e = max(m["e2e_ms"]["sum"], 1e-12)
        m["e2e_ms"]["mean"] = m["e2e_ms"]["sum"] / max(m["n_queries"], 1)
        m["segments_frac"] = {s: v / e2e
                              for s, v in m["segments_ms"].items()}
        m["attributed_frac"] = sum(m["segments_ms"].values()) / e2e
    return out


def merge_health(per_shard: List[Dict]) -> Dict:
    """Aggregate per-shard ``HealthMonitor.summary()`` docs: alerts
    concatenate (tagged with their shard), burn rates take the worst
    shard, and the aggregate fires if ANY shard fires."""
    alerts, firing = [], set()
    burn: Dict[str, float] = {}
    wait_burn: Dict[str, float] = {}
    shards = []
    for i, h in enumerate(per_shard):
        shards.append({"shard": i,
                       "status": h.get("status",
                                       "alerting" if h.get("firing")
                                       else "ok"),
                       "n_alerts": h.get("n_alerts", 0),
                       "firing": list(h.get("firing", []))})
        for a in h.get("alerts", []):
            alerts.append({**a, "shard": i})
        for f in h.get("firing", []):
            firing.add(f"shard{i}:{f}")
        for k, v in h.get("burn_rate", {}).items():
            burn[k] = max(burn.get(k, 0.0), v)
        for k, v in h.get("wait_burn_rate", {}).items():
            wait_burn[k] = max(wait_burn.get(k, 0.0), v)
    out = {"n_alerts": len(alerts), "alerts": alerts,
           "burn_rate": burn, "wait_burn_rate": wait_burn,
           "firing": sorted(firing), "shards": shards}
    out["status"] = "alerting" if out["firing"] else "ok"
    return out


def merge_session_stats(per_shard: List[Dict], *, pending: int = 0
                        ) -> Dict:
    """Merge per-shard ``Session.stats()`` trees (the worker's full
    view) into the single-process schema."""
    assert per_shard
    engine_keys = set(per_shard[0]) - {"attribution", "health",
                                       "tenants", "metrics",
                                       "plan_cache", "refresh_cutover"}
    eng_in = []
    for s in per_shard:
        eng_in.append({k: s[k] for k in s
                       if k in engine_keys or k == "tenants"})
    out = merge_engine_stats(eng_in, pending=pending)
    # world-replicated subtrees pass through from shard 0; per-process
    # caches/metrics are process-local and stay per-shard
    if "refresh_cutover" in per_shard[0]:
        out["refresh_cutover"] = per_shard[0]["refresh_cutover"]
    if any("attribution" in s for s in per_shard):
        out["attribution"] = merge_attribution(
            [s["attribution"] for s in per_shard if "attribution" in s])
    if any("health" in s for s in per_shard):
        out["health"] = merge_health(
            [s["health"] for s in per_shard if "health" in s])
    return out


class RouterEndpoint:
    """HTTP front door over the merged cluster view — the shapes of
    ``obs.endpoint.TelemetryEndpoint`` with a ``shards`` breakdown.

    Routes (GET): ``/healthz`` (aggregated per-shard health; status is
    alerting if ANY shard alerts), ``/stats`` (merged Session.stats
    schema + ``cluster`` subtree), ``/shards`` (raw per-shard status).
    """

    def __init__(self, deployment, *, port: int = 0,
                 host: str = "127.0.0.1"):
        self.deployment = deployment
        self.host = host
        self.want_port = int(port)
        self.port: Optional[int] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _health_doc(self) -> dict:
        from repro_torch.obs.endpoint import json_sanitize
        return json_sanitize(self.deployment.router.health())

    def _stats_doc(self) -> dict:
        from repro_torch.obs.endpoint import json_sanitize
        return json_sanitize(self.deployment.stats())

    def _shards_doc(self) -> dict:
        from repro_torch.obs.endpoint import json_sanitize
        return json_sanitize(
            {"shards": self.deployment.router.statuses(),
             "router": self.deployment.router.router_stats()})

    def start(self) -> "RouterEndpoint":
        ep = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                try:
                    if self.path == "/healthz":
                        doc = ep._health_doc()
                    elif self.path == "/stats":
                        doc = ep._stats_doc()
                    elif self.path == "/shards":
                        doc = ep._shards_doc()
                    else:
                        self.send_error(404)
                        return
                    body = json.dumps(doc, sort_keys=True).encode()
                except Exception as exc:    # surface, don't wedge
                    self.send_error(500, str(exc))
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((self.host, self.want_port),
                                           _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="deal-router-http",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


__all__ = ["Router", "RouterEndpoint", "merge_engine_stats",
           "merge_memory_stats", "merge_attribution", "merge_health",
           "merge_session_stats"]
