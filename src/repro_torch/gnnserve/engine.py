"""Continuous-batching embedding lookup engine with bounded staleness —
the port's twin of ``repro.gnnserve.engine``.

Modeled on ``serve.engine``'s fixed-slot pattern: B slots each hold one
in-flight query; every ``step`` assembles one fixed-size gather batch
(``rows_per_step`` rows, round-robin across active slots) and issues a
single sharded ``store.lookup`` — new queries are admitted into free
slots while others are mid-gather, so the gather pipe never drains.

Freshness contract: the engine tracks a ``staleness_bound`` — the max
number of pending graph/feature mutations a served row may pre-date.
When the mutation log exceeds the bound (or a query demands
``fresh=True``), the engine drains the log, splices the CSR overlay,
and runs delta re-inference BEFORE the next gather; the store's
double-buffered commit makes the epoch flip invisible to readers.
Node additions onboard incrementally on ``onboarding="tail"`` stores
(a tail partition appended past the main 1-D partitioning); on
``onboarding="none"`` stores they refuse and defer to ``full_epoch()``
(the re-partition event).

Multi-tenant QoS (``tenants=TenantRegistry(...)``): the global bound
and FIFO queue are replaced by ``gnnserve.qos`` — per-tenant freshness
SLOs with deadline-driven refresh planning (lagged per-tenant epoch
views), weighted-fair slot quotas with preemptive reclaim, and a
deficit-round-robin row budget with token buckets.  Queries carry a
``tenant`` tag; with ``tenants=None`` the engine behaves exactly as
before (single implicit tenant at ``staleness_bound``).

Refresh is a SCHEDULED workload under QoS when ``refresh_chunk_rows``
is set: instead of running the whole delta frontier inline inside one
serve step (head-of-line blocking every tenant behind a large
mutation batch), the engine opens a ``RefreshJob`` and advances it ONE
row chunk per step, interleaved with tenant gathers.  Chunk compute is
charged to the lowest-priority tenants' DRR credit as it lands; only
the tenants whose SLO (or ``fresh=True``) demanded the refresh wait
for it — everyone else keeps gathering at their pinned views, and the
committed bits are chunk-invariant (see ``DeltaReinference.
begin_refresh``), so chunking never changes what any tenant reads.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.core.graph import Graph
from repro_torch.gnnserve.delta import (DeltaReinference, RefreshJob,
                                        attach_recompute)
from repro_torch.gnnserve.mutations import (MutationBatch, MutationLog,
                                            apply_edge_mutations, grow_graph)
from repro_torch.gnnserve.qos import QoSScheduler, TenantRegistry
from repro_torch.gnnserve.store import (EmbeddingStore, SnapshotMiss,
                                        store_from_inference)


@dataclasses.dataclass
class Query:
    uid: int
    node_ids: np.ndarray            # (n,) int64
    level: int = -1                 # which store level to read
    fresh: bool = False             # force a refresh before serving
    tenant: str = "default"         # QoS tenant tag (ignored w/o QoS)
    out: Optional[np.ndarray] = None
    served_version: int = -1
    done: bool = False
    # epoch snapshot pinned at first gather: a refresh committing while
    # this query is mid-gather must not tear the response across epochs
    snap: Optional[object] = dataclasses.field(default=None, repr=False)
    # QoS bookkeeping: per-query cursor (survives preemption), queue-wait
    # and observed-staleness samples
    cursor: int = 0
    submit_step: int = -1
    first_gather_step: int = -1
    observed_staleness: int = -1
    # wall-clock submit stamp (telemetry only; -1 when disabled) —
    # queue-wait histograms read it at first pin
    submit_ns: int = -1
    # critical-path ledger (telemetry only; None when disabled): per-
    # segment ns accumulated by the engine's hooks, closed by
    # ``_finish_attrib`` into the session's AttributionCollector
    attrib: Optional[Dict] = dataclasses.field(default=None, repr=False)


@dataclasses.dataclass
class _RefreshRec:
    """Engine-side record of one in-flight (or inline) refresh: the
    drained batch for rollback/requeue, the delta job, the post-splice
    graph to swap in at commit, and the onboarding extent."""
    batch: MutationBatch
    job: RefreshJob
    graph: Graph
    n_new: int
    n_nodes_before: int         # store extent before any tail append
    charged: int = 0            # rows_gemm already charged per chunk


class EmbeddingServeEngine:
    def __init__(self, store: EmbeddingStore, reinfer: DeltaReinference,
                 graph: Graph, *, batch_slots: int = 4,
                 rows_per_step: int = 256, staleness_bound: int = 64,
                 tenants: Optional[TenantRegistry] = None,
                 refresh_charge: float = 1.0,
                 refresh_chunk_rows: int = 0):
        self.store = store
        self.reinfer = reinfer
        self.graph = graph
        self.log = MutationLog()
        self.B = batch_slots
        self.rows_per_step = rows_per_step
        self.staleness_bound = staleness_bound
        self.slot_q: List[Optional[Query]] = [None] * batch_slots
        self.cursor = np.zeros(batch_slots, np.int64)
        self.queue: List[Query] = []
        self.n_gather_steps = 0
        self.n_refreshes = 0
        self.n_full_epochs = 0
        self.n_onboarded = 0        # nodes added via tail onboarding
        self.n_served = 0
        self.ops_drained = 0        # mutation ops folded into the store
        self.last_refresh_stats: Dict = {}
        # preemptible chunked refresh (QoS scheduling only; the FIFO
        # path keeps its inline refresh): 0 = inline, >0 = rows per
        # chunk, one chunk advanced per _step_qos
        self.refresh_chunk_rows = int(refresh_chunk_rows)
        self.n_refresh_chunks = 0
        self._rjob: Optional[_RefreshRec] = None
        # serving-tier health (telemetry only): built lazily on the
        # first submit with telemetry enabled, so the disabled path pays
        # nothing.  ``health_opts`` is overridable (Session wires
        # TelemetrySpec's window/budget/threshold through it) as long as
        # it happens before the first submit.
        self.attrib = None              # obs.health.AttributionCollector
        self.health = None              # obs.health.HealthMonitor
        self.health_opts: Dict = {}
        self.qos: Optional[QoSScheduler] = None
        if tenants is not None:
            self.qos = QoSScheduler(tenants, batch_slots=batch_slots,
                                    rows_per_step=rows_per_step,
                                    refresh_charge=refresh_charge)
            for name in tenants.names:      # views start at the current
                st = self.qos.state(name)   # epoch, nothing unobserved
                st.view_version = store.version
                st.ops_at_view = 0
            self.qos.record_epoch(store.version, 0, store.snapshot())

    # -- ingress --------------------------------------------------------
    def submit(self, q: Query) -> None:
        if obs.enabled():
            q.submit_ns = obs.current().now_ns()
            obs.add("serve.submitted")
            self._obs_init()
            q.attrib = {"t_enq": q.submit_ns, "t_slot": -1, "wait": 0,
                        "pin": 0, "recompute": 0, "gather": 0,
                        "refresh_wait": 0, "slot": 0}
        if self.qos is not None:
            q.node_ids = np.asarray(q.node_ids, np.int64)
            self.qos.route(q)
        else:
            self.queue.append(q)

    def mutate(self) -> MutationLog:
        """The writable mutation log (add_edges / remove_edges /
        update_features / add_nodes)."""
        return self.log

    # -- freshness ------------------------------------------------------
    @property
    def staleness(self) -> int:
        return self.log.pending

    def refresh(self) -> Dict:
        """Drain the log and fold it into the store via delta
        re-inference.  Node additions onboard incrementally when the
        store was built with ``onboarding="tail"`` (a tail partition is
        appended and the new ids ride this refresh's resampled set) —
        QoS engines included: tenants whose views lag the append keep
        their pre-append epoch snapshot, and tail ids resolve only for
        views at/after the append version (see ``_pin_qos``).  On
        ``onboarding="none"`` stores node additions refuse here and
        fold via ``full_epoch()``."""
        self._drain_refresh_job()   # an in-flight chunked job commits
        self._check_onboarding()    # first, THEN any newly pending ops
        return self._refresh()

    def _check_onboarding(self) -> None:
        # check BEFORE draining: rejecting must not discard pending edits
        if self.log.has_node_adds and self.store.onboarding != "tail":
            raise NotImplementedError(
                "node additions re-partition the store; build it "
                "with onboarding=\"tail\" (StoreSpec.onboarding) "
                "for incremental onboarding, or call full_epoch() "
                "(the re-partition event, which folds them)")

    def _observe_wait(self, q: Query) -> None:
        """Queue-wait sample at first pin (submit -> first gather)."""
        if q.submit_ns >= 0 and obs.enabled():
            wait_ms = (obs.current().now_ns() - q.submit_ns) / 1e6
            obs.observe("serve.queue_wait_ms", wait_ms)
            if self.qos is not None:
                obs.observe(f"qos.tenant.{q.tenant}.wait_ms", wait_ms)
            if self.health is not None:
                self.health.on_wait(q.tenant, wait_ms)

    # -- serving-tier health (telemetry only) ---------------------------
    def _obs_init(self) -> None:
        """Lazily build the attribution collector + health monitor on
        the first submit with telemetry enabled."""
        if self.attrib is not None:
            return
        from repro_torch.obs.health import AttributionCollector, HealthMonitor
        self.attrib = AttributionCollector()
        slos = ({s.name: s.staleness_slo for s in self.qos.registry}
                if self.qos is not None
                else {"default": self.staleness_bound})
        self.health = HealthMonitor(slos, **self.health_opts)

    def _timed_pin(self, q: Query, pin) -> None:
        """Run ``pin()`` charging its wall time to the query's ``pin``
        segment, with the store's recompute-on-miss share split out into
        ``recompute`` (the store keeps a cumulative recompute clock; the
        delta across the pin is this query's admission recompute)."""
        a = q.attrib
        if a is None:
            pin()
            return
        tel = obs.current()
        t0 = tel.now_ns()
        rc0 = self.store.recompute_s
        pin()
        rc = int((self.store.recompute_s - rc0) * 1e9)
        a["recompute"] += rc
        a["pin"] += max(tel.now_ns() - t0 - rc, 0)

    def _charge_refresh_wait(self, active: List[int], dur: int) -> None:
        """Refresh interference: work that ran between this step's
        admissions and gathers delays every query holding a slot, so
        the full duration lands on each one's ``refresh_wait``."""
        if dur <= 0:
            return
        for i in active:
            a = self.slot_q[i].attrib
            if a is not None:
                a["refresh_wait"] += dur

    def _charge_gather(self, chunks: List, dur: int) -> None:
        """Apportion one fused gather's wall time across the queries
        that rode it, by their row share."""
        tot = sum(hi - lo for _, lo, hi in chunks)
        if tot <= 0:
            return
        for i, lo, hi in chunks:
            a = self.slot_q[i].attrib
            if a is not None:
                a["gather"] += dur * (hi - lo) // tot

    def _finish_attrib(self, q: Query) -> None:
        """Close the query's critical-path ledger: stop the in-slot
        clock, derive ``sched_wait`` as the unexplained in-slot
        remainder, fold the segments into the per-tenant collector, and
        record one ``serve.query`` trace event spanning submit -> done
        (rendered on its own Perfetto track; the report CLI's top-k
        critical-path table reads these events)."""
        a, q.attrib = q.attrib, None
        tel = obs.current()
        if not tel.enabled or self.attrib is None:
            return
        now = tel.now_ns()
        if a["t_slot"] >= 0:
            a["slot"] += now - a["t_slot"]
        e2e = max(now - q.submit_ns, 0)
        comp = a["pin"] + a["recompute"] + a["gather"] + a["refresh_wait"]
        segs = {"queue_wait": a["wait"], "pin": a["pin"],
                "recompute": a["recompute"], "gather": a["gather"],
                "refresh_wait": a["refresh_wait"],
                "sched_wait": max(a["slot"] - comp, 0)}
        self.attrib.record(uid=q.uid, tenant=q.tenant, e2e_ns=e2e,
                           segments_ns=segs,
                           served_version=q.served_version)
        attrs = {"uid": int(q.uid), "tenant": q.tenant,
                 "served_version": int(q.served_version),
                 "_track": "queries"}
        for k, v in segs.items():
            attrs[f"{k}_ms"] = round(v / 1e6, 4)
        tel.tracer.record("serve.query", q.submit_ns, e2e, 0, attrs)

    def _refresh(self) -> Dict:
        """The gate-free refresh body: ``full_epoch`` calls it directly
        so pending node adds fold there even on ``onboarding="none"``
        stores (a full epoch IS the re-partition event)."""
        with obs.span("serve.refresh") as rsp:
            stats = self._refresh_body()
            if rsp:
                rsp.set(rows_gemm=int(stats.get("rows_gemm", 0)),
                        n_onboarded=int(stats.get("n_onboarded", 0)))
        return stats

    def _refresh_body(self) -> Dict:
        rec = self._open_refresh(chunk_rows=0)
        try:
            while not rec.job.done:
                rec.job.step()
        except Exception:
            self._rollback_refresh(rec)
            raise
        return self._finish_refresh(rec)

    def _open_refresh(self, *, chunk_rows: int) -> _RefreshRec:
        """Drain the log and open the delta job: onboarding structures,
        CSR splice, resample + frontier + staging overlay (the job
        prologue).  Nothing is reader-visible until the job commits."""
        batch = self.log.drain()
        n_new = batch.n_new_nodes
        new_ids = np.empty(0, np.int64)
        graph0 = self.graph
        n_before = self.store.n_nodes
        extended = tailed = False
        try:
            if n_new:
                # onboard: empty CSR rows + grown layer graphs + tail
                # shard, all BEFORE the edge splice so ops touching new
                # ids are legal
                new_ids = np.arange(graph0.n_nodes,
                                    graph0.n_nodes + n_new,
                                    dtype=np.int64)
                graph0 = grow_graph(graph0, n_new)
                self.reinfer.extend_nodes(n_new)
                extended = True
                self.store.append_tail(n_new, batch.new_node_rows)
                tailed = True
            graph = apply_edge_mutations(graph0, batch)
            resampled = batch.affected_dsts()
            if n_new:
                # the new ids ALWAYS resample: that is what draws their
                # fanout rows and pushes them through every frontier
                # level, so their tail shard commits fully written
                resampled = np.union1d(resampled, new_ids)
            job = self.reinfer.begin_refresh(
                self.store, graph, batch.feat_ids, batch.feat_rows,
                resampled, chunk_rows=chunk_rows)
        except Exception:
            # a bad batch must not silently discard the good mutations
            # drained alongside it — roll back exactly the onboarding
            # structures that were built and put everything back (in
            # original op order), then re-raise (the engine is
            # single-threaded, so no interleaved writes)
            if tailed:
                self.store.pop_tail(n_new)
            if extended:
                self.reinfer.shrink_nodes(n_new)
            self.log.requeue(batch)
            raise
        return _RefreshRec(batch=batch, job=job, graph=graph,
                           n_new=n_new, n_nodes_before=n_before)

    def _rollback_refresh(self, rec: _RefreshRec) -> None:
        """Unwind a refresh whose job aborted mid-chunk (the job itself
        already rolled the store + layer-graph resamples back)."""
        if rec.n_new:
            self.store.pop_tail(rec.n_new)
            self.reinfer.shrink_nodes(rec.n_new)
        self.log.requeue(rec.batch)

    def _finish_refresh(self, rec: _RefreshRec) -> Dict:
        stats = rec.job.finish()
        self.graph = rec.graph
        self.ops_drained += rec.batch.n_ops
        self.n_refreshes += 1
        self.n_onboarded += rec.n_new
        stats["n_onboarded"] = rec.n_new
        self.last_refresh_stats = stats
        if self.qos is not None:
            # the new epoch becomes pinnable for per-tenant views, and
            # its compute cost lands on batch-tenant row budgets first
            self.qos.record_epoch(self.store.version, self.ops_drained,
                                  self.store.snapshot())
            remaining = int(stats["rows_gemm"]) - rec.charged
            if remaining > 0:   # chunked jobs already charged per chunk
                self.qos.charge_refresh(remaining)
        return stats

    # -- preemptible chunked refresh (QoS) ------------------------------
    def _open_refresh_job(self, due) -> None:
        """Open a chunked refresh the QoS loop advances one chunk per
        step.  ``due`` tenants become the job's waiters: their views
        advance when it commits, and until then their new pins defer —
        everyone else keeps gathering at their pinned views between
        chunks."""
        assert self._rjob is None
        self._check_onboarding()
        self._rjob = self._open_refresh(chunk_rows=self.refresh_chunk_rows)
        self.qos.refresh_waiters.update(due)
        if obs.enabled():
            obs.add("qos.refresh_jobs")

    def _advance_refresh_job(self) -> None:
        """Run one chunk of the in-flight job; commit + advance waiter
        views when the last chunk lands."""
        rec = self._rjob
        if not rec.job.done:
            try:
                info = rec.job.step()
            except Exception:
                self._rjob = None
                self.qos.refresh_waiters.clear()
                self._rollback_refresh(rec)
                raise
            self.n_refresh_chunks += 1
            if info["rows_gemm"]:
                # charge as the work lands, not at commit: the DRR
                # credit of the batch tenants absorbs each chunk in the
                # very step it ran, so their next grants shrink NOW
                self.qos.charge_refresh(info["rows_gemm"])
                rec.charged += int(info["rows_gemm"])
        if rec.job.done:
            with obs.span("serve.refresh") as rsp:
                stats = self._finish_refresh(rec)
                if rsp:
                    rsp.set(rows_gemm=int(stats.get("rows_gemm", 0)),
                            n_onboarded=int(stats.get("n_onboarded", 0)),
                            n_chunks=int(stats.get("n_chunks", 0)))
            waiters = sorted(self.qos.refresh_waiters)
            self.qos.refresh_waiters.clear()
            self._rjob = None
            self.qos.advance_views(waiters, self.store.version,
                                   self.ops_drained, refreshed=True)

    def _drain_refresh_job(self) -> None:
        """Complete any in-flight chunked refresh synchronously (public
        ``refresh``/``full_epoch`` entry points must not observe a
        half-applied job)."""
        while self._rjob is not None:
            self._advance_refresh_job()

    def _refresh_holds(self, q: Query) -> bool:
        """While a chunked refresh is in flight, must this query's PIN
        wait for the commit?  Three reasons: (1) its tenant demanded the
        refresh (serving it the old epoch would violate the very SLO
        that triggered the job); (2) it reads tail ids appended by the
        job (unreadable until the commit makes them resolvable); (3) on
        a budgeted store, pinning rows in the job's frontier could
        recompute through mid-flight layer-graph rows (wrong
        neighborhoods before commit).  Pinned queries are never held —
        their snapshots are immutable."""
        rec = self._rjob
        if q.served_version == -2:      # parked by _restart_on_current
            return True
        if q.tenant in self.qos.refresh_waiters:
            return True
        if q.node_ids.size == 0:
            return False
        if int(q.node_ids.max()) >= rec.n_nodes_before:
            return True
        hold = rec.job.hold_rows
        if self.store.recompute is not None and hold.size:
            pos = np.clip(np.searchsorted(hold, q.node_ids),
                          0, hold.size - 1)
            if (hold[pos] == q.node_ids).any():
                return True
        return False

    def full_epoch(self, n_shards: Optional[int] = None) -> Dict:
        """Re-partition epoch: refresh any pending mutations, then
        rebuild the store from a full pass over the CURRENT features —
        folding every onboarded tail partition back into the main 1-D
        partitioning (``n_shards`` defaults to the pre-tail count).
        Contents are bitwise-unchanged (the delta-refresh invariant:
        store rows == a full epoch on the same layer graphs through the
        same executor); the version advances so pinned snapshots of the
        old store keep serving their epoch untouched.  Pending node
        additions fold here REGARDLESS of ``store.onboarding`` — this is
        the re-partition event ``refresh`` defers them to."""
        self._drain_refresh_job()
        if self.log.pending:
            self._refresh()
        st = self.store
        X = st.lookup(np.arange(st.n_nodes, dtype=np.int64), 0)
        levels = self.reinfer.full_levels(X)
        new = store_from_inference(
            X, levels[1:],
            n_shards=n_shards or (st.n_shards - st.n_tail_shards),
            budget_rows=st.budget_rows, evict_policy=st.evict_policy,
            admission=st.admission, onboarding=st.onboarding)
        new.version = st.version + 1
        if st.recompute is not None:
            attach_recompute(new, self.reinfer)
        # poison the swapped-out store: its version would otherwise stay
        # frozen, so an old snapshot's same-version fallback could
        # recompute "its" epoch through layer graphs that LATER
        # refreshes mutate — advance it so such reads SnapshotMiss
        # loudly instead of silently serving cross-epoch bits
        st.version = new.version
        st.recompute = None
        self.store = new
        self.n_full_epochs += 1
        if self.qos is not None:
            self.qos.record_epoch(new.version, self.ops_drained,
                                  new.snapshot())
        return {"version": new.version, "n_shards": new.n_shards,
                "rows_gemm": st.n_nodes * self.reinfer.n_layers}

    # -- serve loop -----------------------------------------------------
    def _admit(self) -> None:
        now = -1
        for i in range(self.B):
            if self.slot_q[i] is None and self.queue:
                q = self.queue.pop(0)
                q.node_ids = np.asarray(q.node_ids, np.int64)
                q.out = np.empty(
                    (q.node_ids.size,
                     self.store.level_dim(q.level % self.store.n_levels)),
                    np.float32)
                self.slot_q[i] = q
                self.cursor[i] = 0
                if q.attrib is not None:
                    if now < 0:
                        now = obs.current().now_ns()
                    q.attrib["wait"] += now - q.attrib["t_enq"]
                    q.attrib["t_slot"] = now

    def step(self) -> bool:
        """Admit, maybe refresh, then one batched gather. Returns False
        when idle.  With QoS, admission/refresh/row-split are delegated
        to the per-tenant scheduler (``_step_qos``)."""
        with obs.span("serve.step") as sp:
            r = (self._step_qos() if self.qos is not None
                 else self._step_fifo())
            if sp:
                sp.set(progressed=r, qos=self.qos is not None)
        if r and self.health is not None:
            # cumulative counters; the monitor diffs them per step
            self.health.on_step(
                pending=self.log.pending,
                evictions=self.store.n_evictions,
                route_local=self.reinfer.n_local_cutovers,
                route_dist=self.reinfer.n_dist_layers)
        return r

    def _step_fifo(self) -> bool:
        self._admit()
        active = [i for i in range(self.B) if self.slot_q[i] is not None]
        if not active:
            return False
        needs_fresh = any(self.slot_q[i].fresh and self.cursor[i] == 0
                          for i in active)
        if self.log.pending and (needs_fresh
                                 or self.log.pending >= self.staleness_bound):
            rt0 = obs.current().now_ns() if obs.enabled() else -1
            self.refresh()
            if rt0 >= 0:
                self._charge_refresh_wait(
                    active, obs.current().now_ns() - rt0)

        # round-robin a fixed row budget across active slots; fuse chunks
        # that share (epoch, level) into one sharded gather
        per_key: Dict[tuple, List] = {}
        budget = self.rows_per_step
        share = max(1, budget // len(active))
        for i in active:
            q = self.slot_q[i]
            take = min(share, q.node_ids.size - self.cursor[i])
            if take <= 0:
                continue
            if q.snap is None:
                # pin the query to the CURRENT epoch: rows gathered after
                # a mid-query refresh still come from this snapshot, so
                # one response never mixes epochs.  Pinning admits every
                # row the query will read FIRST (recompute-on-miss) and
                # only then lets the budget evict — a mid-query eviction
                # can drop the store's pointer but never the snapshot's
                def _pin(q=q):
                    q.snap = self.store.pinned_snapshot(q.node_ids,
                                                        q.level)
                self._timed_pin(q, _pin)
                q.served_version = q.snap.version
                if self.health is not None:
                    self.health.on_staleness(q.tenant, self.log.pending)
                self._observe_wait(q)
            lo = self.cursor[i]
            per_key.setdefault(
                (q.snap.version, q.level % self.store.n_levels), []).append(
                (i, lo, lo + take))
            self.cursor[i] += take
        for (_, level), chunks in per_key.items():
            snap = self.slot_q[chunks[0][0]].snap
            ids = np.concatenate([self.slot_q[i].node_ids[lo:hi]
                                  for i, lo, hi in chunks])
            tg0 = (obs.current().now_ns()
                   if any(self.slot_q[i].attrib is not None
                          for i, _, _ in chunks) else -1)
            gsp = obs.span("serve.gather")
            if gsp:
                gsp.set(rows=int(ids.size), level=level,
                        n_queries=len(chunks))
            with gsp:
                try:
                    rows = snap.lookup(ids, level)    # one sharded gather
                except SnapshotMiss:
                    # same-version queries can still pin DIFFERENT shard
                    # arrays (an eviction + re-admission between their
                    # pins); after an epoch flip the shared snapshot
                    # can't serve the other queries' rows — each query's
                    # own snapshot can, by the pinning guarantee
                    rows = np.concatenate([
                        self.slot_q[i].snap.lookup(
                            self.slot_q[i].node_ids[lo:hi], level)
                        for i, lo, hi in chunks])
            off = 0
            for i, lo, hi in chunks:
                self.slot_q[i].out[lo:hi] = rows[off:off + (hi - lo)]
                off += hi - lo
            if tg0 >= 0:
                self._charge_gather(chunks, obs.current().now_ns() - tg0)
        self.n_gather_steps += 1

        for i in active:
            q = self.slot_q[i]
            if self.cursor[i] >= q.node_ids.size:
                q.done = True
                q.snap = None       # release the pinned epoch's shards
                if q.attrib is not None:
                    self._finish_attrib(q)
                self.n_served += 1
                self.slot_q[i] = None
        return True

    # -- QoS serve loop -------------------------------------------------
    def _pin_qos(self, q: Query) -> None:
        """Pin a query to its TENANT's freshness view: the current epoch
        (admit-then-pin, eviction-safe) when the view is current, or the
        tenant's lagged epoch snapshot — a loose-SLO tenant keeps
        reading older bits while a strict tenant refreshes next to it."""
        st = self.qos.state(q.tenant)
        stale = self.qos.unobserved_of(q.tenant, self.log.pending,
                                       self.ops_drained)

        def _pin():
            nonlocal stale
            if st.view_version == self.store.version:
                q.snap = self.store.pinned_snapshot(q.node_ids, q.level)
                q.served_version = st.view_version
            else:
                snap = self.qos.epoch_snapshot(st.view_version)
                if q.node_ids.size and \
                        int(q.node_ids.max()) >= int(snap.bounds[-1]):
                    # the lagged view predates a tail append: tail ids
                    # resolve only for views at/after the append version,
                    # so this query serves on the CURRENT epoch instead —
                    # fresher than its SLO requires, never staler, and
                    # the tenant's other queries keep their pre-append
                    # bits
                    q.snap = self.store.pinned_snapshot(q.node_ids,
                                                        q.level)
                    q.served_version = self.store.version
                    stale = self.log.pending
                    self.qos.on_view_restart(q.tenant)
                else:
                    q.snap = snap
                    q.served_version = st.view_version

        self._timed_pin(q, _pin)
        self.qos.on_pin(q, stale)
        if self.health is not None:
            self.health.on_staleness(q.tenant, stale)
        self._observe_wait(q)

    def _restart_on_current(self, q: Query) -> None:
        """A lagged view hit rows the old epoch can't serve any more
        (evicted on a budgeted store): restart the query on the CURRENT
        epoch — fresher than its SLO requires, never staler, never
        torn.  Rows regathered after the restart are charged to the
        tenant again (rows_served / tokens / DRR credit): they are real
        gather work, and the fair-share accounting follows the work."""
        if self._rjob is not None:
            # mid-job, "current" is the PRE-commit epoch — restarting on
            # it now would diverge from the inline schedule (and may be
            # unsafe: tail ids / recompute through mid-flight graph
            # rows).  Park the query; it re-pins after the commit.
            # served_version=-2 marks it held so it does not re-pin
            # (and re-miss) every step until then.
            q.snap = None
            q.served_version = -2
            q.cursor = 0
            self.qos.on_defer(q.tenant)
            return
        q.snap = self.store.pinned_snapshot(q.node_ids, q.level)
        q.served_version = self.store.version
        q.cursor = 0
        self.qos.on_view_restart(q.tenant)

    def _step_qos(self) -> bool:
        qos = self.qos
        qos.step_no += 1
        # admission: guaranteed quotas reclaim borrowed slots
        # (preempted queries pause with cursor+snapshot intact), idle
        # quota is lent out work-conserving
        preempt, admit = qos.plan_admission(self.slot_q)
        now = (obs.current().now_ns()
               if (preempt or admit) and obs.enabled() else -1)
        for i in preempt:
            q = self.slot_q[i]
            if obs.enabled():
                obs.add("qos.preemptions")
                obs.add(f"qos.tenant.{q.tenant}.preemptions")
            if q.attrib is not None and now >= 0:
                # pause the in-slot clock; queue time resumes accruing
                if q.attrib["t_slot"] >= 0:
                    q.attrib["slot"] += now - q.attrib["t_slot"]
                    q.attrib["t_slot"] = -1
                q.attrib["t_enq"] = now
            qos.requeue_front(q)
            self.slot_q[i] = None
        for i, q in admit:
            if q.out is None:
                q.out = np.empty(
                    (q.node_ids.size,
                     self.store.level_dim(q.level % self.store.n_levels)),
                    np.float32)
                q.cursor = 0
            if q.attrib is not None and now >= 0:
                q.attrib["wait"] += now - q.attrib["t_enq"]
                q.attrib["t_slot"] = now
            self.slot_q[i] = q
        active = [i for i in range(self.B) if self.slot_q[i] is not None]
        if not active and self._rjob is None:
            return False

        # deadline-driven refresh planning: coalesce the mutation log up
        # to the tightest ACTIVE tenant SLO; only due tenants' views
        # advance (the rest keep their older epoch)
        due = qos.due_tenants(self.slot_q, self.log.pending,
                              self.ops_drained)
        rt0 = (obs.current().now_ns()
               if (self._rjob is not None or due) and obs.enabled()
               else -1)
        if self._rjob is not None:
            # a chunked refresh is in flight: newly-due tenants join its
            # waiters (their pins defer until the commit), and exactly
            # one chunk advances this step, between tenant gathers
            if due:
                qos.refresh_waiters.update(due)
            self._advance_refresh_job()
            if self._rjob is None and self.log.pending:
                # committed — but mutations that arrived DURING the job
                # were frozen out of its inputs, so a tenant they made
                # due is still stale at the committed version.  Open the
                # follow-up job now (its frontier is one job's worth of
                # mutations, so it commits fast) so those pins keep
                # deferring instead of landing on an SLO-violating epoch
                due = qos.due_tenants(self.slot_q, self.log.pending,
                                      self.ops_drained)
                if due:
                    self._open_refresh_job(due)
        elif due:
            refreshed = bool(self.log.pending)
            if refreshed and self.refresh_chunk_rows > 0:
                self._open_refresh_job(due)
                self._advance_refresh_job()  # first chunk rides this step
            else:
                if refreshed:
                    self.refresh()
                qos.advance_views(due, self.store.version,
                                  self.ops_drained, refreshed=refreshed)
        if rt0 >= 0:
            # refresh interference: the chunk (or inline refresh) that
            # ran this step delayed every query already holding a slot
            self._charge_refresh_wait(active,
                                      obs.current().now_ns() - rt0)
        if not active:
            return True            # the job progressed; nothing to gather

        # weighted-fair row budget (DRR + token buckets), then one fused
        # sharded gather per (epoch, level).  Unpinned queries held by
        # the in-flight refresh (waiter tenants, job-appended tail ids,
        # job-frontier rows on a recompute store) sit out this step's
        # allocation — their slots stay claimed, their rows wait for the
        # commit.
        ready = []
        for i in active:
            q = self.slot_q[i]
            if (self._rjob is not None and q.snap is None
                    and self._refresh_holds(q)):
                qos.on_defer(q.tenant)
            else:
                ready.append(i)
        need = {i: self.slot_q[i].node_ids.size - self.slot_q[i].cursor
                for i in ready}
        grants = qos.allocate([(i, self.slot_q[i].tenant, need[i])
                               for i in ready], self.rows_per_step)
        per_key: Dict[tuple, List] = {}
        for i in ready:
            q = self.slot_q[i]
            take = min(grants.get(i, 0), need[i])
            if take <= 0:
                continue
            if q.snap is None:
                self._pin_qos(q)
            lo = q.cursor
            per_key.setdefault(
                (q.served_version, q.level % self.store.n_levels),
                []).append((i, lo, lo + take))
            q.cursor += take
            qos.on_rows(q.tenant, take)
        for (_, level), chunks in per_key.items():
            snap = self.slot_q[chunks[0][0]].snap
            ids = np.concatenate([self.slot_q[i].node_ids[lo:hi]
                                  for i, lo, hi in chunks])
            tg0 = (obs.current().now_ns()
                   if any(self.slot_q[i].attrib is not None
                          for i, _, _ in chunks) else -1)
            gsp = obs.span("serve.gather")
            if gsp:
                gsp.set(rows=int(ids.size), level=level,
                        n_queries=len(chunks))
            with gsp:
                try:
                    rows = snap.lookup(ids, level)
                except SnapshotMiss:
                    rows = None
            if rows is not None:
                off = 0
                for i, lo, hi in chunks:
                    self.slot_q[i].out[lo:hi] = rows[off:off + (hi - lo)]
                    off += hi - lo
            else:
                # same-version queries can pin different shard arrays
                # (see the non-QoS path) — fall back per query; a query
                # whose LAGGED view can't serve its rows restarts on the
                # current epoch
                for i, lo, hi in chunks:
                    q = self.slot_q[i]
                    try:
                        q.out[lo:hi] = q.snap.lookup(
                            q.node_ids[lo:hi], level)
                    except SnapshotMiss:
                        self._restart_on_current(q)
            if tg0 >= 0:
                self._charge_gather(chunks, obs.current().now_ns() - tg0)
        self.n_gather_steps += 1
        qos.account_slots(self.slot_q)

        for i in active:
            q = self.slot_q[i]
            if q.cursor >= q.node_ids.size:
                q.done = True
                q.snap = None       # release the pinned epoch's shards
                qos.on_done(q)
                if q.attrib is not None:
                    self._finish_attrib(q)
                self.n_served += 1
                self.slot_q[i] = None
        return True

    def run(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            queued = (self.qos.queued() if self.qos is not None
                      else len(self.queue))
            if not self.step() and not queued:
                return

    def stats(self) -> Dict[str, float]:
        """Serve counters plus the store's (``store_`` prefix) — which now
        carry the memory model: hits/misses, evictions, recompute counts,
        resident bytes and budget utilization.  With QoS, ``tenants``
        nests per-tenant p50/p95 queue wait, rows served, observed
        staleness vs SLO, refresh charges, and quota utilization."""
        out = {"n_served": self.n_served,
               "n_gather_steps": self.n_gather_steps,
               "n_refreshes": self.n_refreshes,
               "n_refresh_chunks": self.n_refresh_chunks,
               "n_full_epochs": self.n_full_epochs,
               "n_onboarded": self.n_onboarded,
               "store_version": self.store.version,
               "pending_mutations": self.log.pending,
               **{f"store_{k}": v for k, v in self.store.stats().items()}}
        if self.qos is not None:
            out["tenants"] = self.qos.stats()
        return out

    def memory_stats(self) -> Dict:
        """Per-level residency/budget breakdown (see
        ``EmbeddingStore.memory_stats``)."""
        return self.store.memory_stats()
