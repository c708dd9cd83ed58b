"""``Session`` — the port's lifecycle object over the offline pipeline
and the single-process serving tier.

    cfg = DealConfig.load("cfg.json")
    with Session.build(cfg) as s:              # device="cuda" by default
        H = s.infer_all()                      # (N, d) tensor on the card
        eng = s.serve()                        # store + serving engine
        s.apply_mutations().add_edges(src, dst)
        s.refresh()                            # delta re-inference
        print(s.stats())

``build`` runs the same stages as ``repro.api.session.Session``: dataset
-> distributed CSR construction -> layer-wise sampling -> features and
params -> executor (for "dist", a P x M mesh on the session's device).
The features come from the same numpy generator as in the JAX package,
so X is identical in both.  The params come from a
``torch.Generator`` seeded with the graph seed, or from ``params=``
(for example ``core.gnn_models.params_from_numpy`` of the JAX package's
params, which is how the two packages are held against each other).

``serve`` adds the online half as ``repro.api.session.Session`` does:
full epoch (``DeltaReinference.full_levels``, through the bound
executor) -> versioned store (budget / eviction / tail onboarding) ->
recompute-on-miss wiring -> continuous-batching engine with optional
multi-tenant QoS -> the telemetry endpoint and snapshot writer when
``telemetry.http_port >= 0`` or ``telemetry.snapshot_path`` asks for
them.  The store lives in host memory; each layer of a refresh copies
its rows' inputs to the device and the outputs back.  ``dump_trace``
writes the session's spans as a Perfetto trace, ``prometheus_text`` its
metrics.  With ``cluster.n_shards > 0``, ``serve`` instead launches the
cluster tier (``gnnserve.cluster.ClusterDeployment``: shard-worker
processes on the session's device, each building this config's world,
behind an RPC router) and returns its ``ClusterEngine``, the same engine
surface serving the same bytes.
"""
from __future__ import annotations

import copy
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.config import ConfigError, DealConfig
from repro_torch.api.registry import MODELS


class Session:
    """Build once from a validated ``DealConfig`` on one device; drive
    offline inference (``infer_all``) and/or online serving (``serve``);
    tear down with ``close``."""

    def __init__(self, cfg: DealConfig, device="cuda",
                 params: Optional[Dict[str, Any]] = None):
        from repro_torch.core.ops import resolve_device
        self.cfg = cfg
        self.device = resolve_device(device)
        self._closed = False
        self._endpoint = None
        self.timings: Dict[str, float] = {}
        self.telemetry = cfg.telemetry.build()
        self._prev_telemetry = (obs.install(self.telemetry)
                                if self.telemetry is not None else None)
        # session-scoped subset-plan cache counters: stats() reports
        # THIS session's hits/misses, not every session in the process
        from repro_torch.core.partition import install_plan_cache_counters
        self._plan_cache_counters = install_plan_cache_counters()
        self._build_pipeline(params)
        self._H: Optional[torch.Tensor] = None
        self._engine = None
        self._cluster = None
        self.reinfer = None

    @classmethod
    def build(cls, cfg: DealConfig, device="cuda",
              params: Optional[Dict[str, Any]] = None) -> "Session":
        """Validate eagerly (every bad field named) and assemble the
        offline pipeline on ``device``.  ``"cuda"`` raises when no card
        is visible; pass ``"cpu"`` to run the plain versions."""
        cfg.validate()
        return cls(cfg, device=device, params=params)

    # -- pipeline assembly ----------------------------------------------
    def _build_pipeline(self, params) -> None:
        from repro_torch.core.graph import (csr_from_edges_distributed,
                                            make_dataset, rmat_edges)
        from repro_torch.core.sampler import sample_layer_graphs
        cfg = self.cfg
        g, m = cfg.graph, cfg.model

        with obs.span("construct.dataset") as sp:
            t0 = time.perf_counter()
            if g.dataset == "rmat":
                n = int(g.n_nodes * g.scale)
                src, dst = rmat_edges(n, int(n * g.avg_degree),
                                      seed=g.seed)
            else:
                src, dst, n = make_dataset(g.dataset, seed=g.seed,
                                           scale=g.scale)
            self.n_nodes = n
            if sp:
                sp.set(dataset=g.dataset, n_nodes=n, n_edges=src.size)
        self.graph, self.construct_stats = csr_from_edges_distributed(
            src, dst, n, n_workers=g.n_construct_workers)
        self.timings["construct_s"] = time.perf_counter() - t0

        t1 = time.perf_counter()
        with obs.span("sample.layer_graphs") as sp:
            self.layer_graphs = sample_layer_graphs(
                self.graph, fanout=g.fanout, n_layers=m.n_layers,
                seed=g.seed)
            if sp:
                sp.set(n_layers=m.n_layers, fanout=g.fanout)
        self.timings["sample_s"] = time.perf_counter() - t1

        with obs.span("featprep.init") as sp:
            rng = np.random.default_rng(g.seed)
            self.X = rng.standard_normal((n, m.d_feature),
                                         dtype=np.float32)
            if params is None:
                dims = [m.d_feature] * (m.n_layers + 1)
                gen = torch.Generator().manual_seed(g.seed)
                params = MODELS.get(m.name).init(gen, dims, heads=m.heads)
            from repro_torch.core.gnn_models import params_to
            self.params = params_to(params, self.device)
            if sp:
                sp.set(d_feature=m.d_feature, bytes=int(self.X.nbytes))
        with obs.span("session.executor_build",
                      {"executor": cfg.executor.name}
                      if obs.enabled() else None):
            self.executor = cfg.executor.build(cfg.partition, n_nodes=n,
                                               device=self.device)

    # -- offline: all-node inference ------------------------------------
    def infer_all(self) -> torch.Tensor:
        """One full layer-by-layer epoch for ALL nodes through the bound
        executor; a tensor on the session's device (the dist executor's
        shards gathered into it).  Cached."""
        self._check_open()
        if self._H is not None:
            return self._H
        from repro_torch.core.gnn_models import model_spec
        from repro_torch.core.ops import DenseIO, DistExecutor, run_model
        spec = model_spec(self.cfg.model.name, self.params)
        lgs = self.layer_graphs[:len(spec.layers)]
        ex = self.executor
        t0 = time.perf_counter()
        with obs.span("session.infer_all",
                      {"model": self.cfg.model.name}
                      if obs.enabled() else None) as sp:
            if isinstance(ex, DistExecutor):
                need_sddmm = any(op.kind == "attn_scores"
                                 for layer in spec.layers
                                 for op in layer.ops)
                ios = ex.bind(lgs, need_sddmm=need_sddmm)
            else:
                ios = [DenseIO.from_layer_graph(lg, self.device)
                       for lg in lgs]
            H = run_model(ex, spec, ios, self.X)
            if isinstance(ex, DistExecutor):
                H = H.to_global(self.device)
            if H.is_cuda:
                torch.cuda.synchronize(H.device)   # honest infer_s
            if sp:
                sp.set(rows=int(H.shape[0]))
        self.timings["infer_s"] = time.perf_counter() - t0
        if torch.isnan(H).any():
            raise RuntimeError("infer_all produced NaN embeddings")
        self._H = H
        return H

    # -- online: store + serving engine ---------------------------------
    def serve(self):
        """Stand up (once) and return the serving engine: full epoch ->
        versioned store (budget / eviction / tail onboarding) ->
        ``EmbeddingServeEngine`` with the config's QoS schedule.

        With ``cluster.n_shards > 0`` the engine is a router-backed
        ``ClusterEngine`` instead: shard-worker processes are spawned on
        this session's device (each builds the same world from this
        config), readiness is health-checked, and the returned facade
        routes transparently — same surface, same served bytes."""
        self._check_open()
        if self._engine is not None:
            return self._engine
        cfg = self.cfg
        if cfg.cluster.n_shards > 0:
            from repro_torch.gnnserve.cluster import ClusterDeployment
            with obs.span("serve.cluster_launch") as sp:
                self._cluster = ClusterDeployment(cfg, device=self.device)
                if sp:
                    sp.set(n_shards=cfg.cluster.n_shards)
            # the workers paid the epoch; the deployment's ready wait
            # (spawn -> world build -> socket up) is the launch cost
            self.timings["epoch_s"] = self._cluster.ready_wait_s
            self._engine = self._cluster.engine
            return self._engine
        from repro_torch.gnnserve import (DeltaReinference, attach_recompute,
                                          store_from_inference)
        st = cfg.store
        self.reinfer = DeltaReinference(
            [copy.deepcopy(lg) for lg in self.layer_graphs],
            cfg.model.name, self.params,
            sample_seed=cfg.refresh.sample_seed, executor=self.executor,
            local_cutover=cfg.refresh.dist_local_cutover)
        t0 = time.perf_counter()
        with obs.span("serve.epoch") as sp:
            levels = self.reinfer.full_levels(self.X)
            if sp:
                sp.set(n_levels=len(levels))
        self.timings["epoch_s"] = time.perf_counter() - t0
        store = store_from_inference(
            self.X, levels[1:], n_shards=st.n_shards,
            budget_rows=st.budget_rows or None,
            evict_policy=st.evict_policy, admission=st.admission,
            onboarding=st.onboarding)
        if st.budget_rows:
            attach_recompute(store, self.reinfer)
        return self._attach_engine(store)

    def _attach_engine(self, store):
        """Wire a ready store (+ ``self.reinfer``/``self.graph``) into
        the serving engine, its health options and the telemetry
        endpoint.  ``serve()`` calls this after the full epoch;
        checkpoint restore calls it with a restored store instead of
        running an epoch."""
        from repro_torch.gnnserve import EmbeddingServeEngine
        cfg = self.cfg
        q = cfg.qos
        self._engine = EmbeddingServeEngine(
            store, self.reinfer, self.graph,
            batch_slots=q.batch_slots, rows_per_step=q.rows_per_step,
            staleness_bound=q.staleness_bound,
            tenants=q.tenant_registry(), refresh_charge=q.refresh_charge,
            refresh_chunk_rows=cfg.refresh.chunk_rows)
        t = cfg.telemetry
        self._engine.health_opts = {
            "window": t.health_window,
            "error_budget": t.slo_error_budget,
            "burn_threshold": t.burn_threshold,
            "wait_slo_ms": t.wait_slo_ms,
        }
        if self.telemetry is not None and (t.http_port >= 0
                                           or t.snapshot_path):
            from repro_torch.obs.endpoint import TelemetryEndpoint
            self._endpoint = TelemetryEndpoint(
                self, port=t.http_port, snapshot_path=t.snapshot_path,
                snapshot_every_s=t.snapshot_every_s).start()
        return self._engine

    @classmethod
    def from_checkpoint(cls, path, cfg: DealConfig, device="cuda",
                        params: Optional[Dict[str, Any]] = None
                        ) -> "Session":
        """A Session whose serving world comes from a
        ``gnnserve.checkpoint.save_world`` artifact (of either package)
        instead of a fresh full epoch: the offline pipeline still builds
        from ``cfg`` (the checkpoint stores no params), then the
        checkpointed graph, layer graphs and store swap in and the
        engine attaches without recomputing the epoch."""
        cfg.validate()
        if cfg.cluster.n_shards > 0:
            raise ConfigError(
                "cluster.n_shards: from_checkpoint restores a single-"
                "process engine; cluster workers restore their own "
                "checkpoints via the deployment's run_dir")
        session = cls(cfg, device=device, params=params)
        from repro_torch.gnnserve.checkpoint import restore_into_session
        restore_into_session(session, path)
        return session

    @property
    def cluster(self):
        """The live ``ClusterDeployment`` (None in single-process
        mode)."""
        return self._cluster

    @property
    def engine(self):
        """The serving engine (built on first access)."""
        return self.serve()

    @property
    def endpoint(self):
        """The live telemetry endpoint, or None (configure it via
        ``telemetry.http_port`` / ``telemetry.snapshot_path``)."""
        return self._endpoint

    @property
    def store(self):
        """The engine's CURRENT embedding store (a ``full_epoch`` fold
        swaps in a rebuilt one, so never cache this reference)."""
        return self.serve().store

    def apply_mutations(self):
        """The engine's writable mutation log (``add_edges`` /
        ``remove_edges`` / ``update_features`` / ``add_nodes``)."""
        return self.serve().mutate()

    def refresh(self) -> Dict[str, Any]:
        """Drain pending mutations into the store via delta
        re-inference (node onboarding included when
        ``store.onboarding == "tail"``)."""
        return self.serve().refresh()

    def full_epoch(self, n_shards: Optional[int] = None) -> Dict[str, Any]:
        """Re-partition epoch: fold any onboarded tail partitions back
        into the main 1-D partitioning."""
        return self.serve().full_epoch(n_shards)

    # -- observability ----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Pipeline timings + construction stats, plus the serve / store /
        QoS counter tree once the engine exists, with the keys of
        ``repro.api.session.Session.stats``: ``refresh_cutover``,
        ``plan_cache`` (``build_subset_plan_cached``'s hits and misses
        in this session), ``metrics`` (the flat unified view, with
        live telemetry merged on top when enabled), and ``attribution``
        / ``health`` once the engine has served under telemetry.  A
        cluster session returns the router-merged tree (the same
        schema) plus a ``cluster`` subtree: per-shard statuses, restart
        count, router stats."""
        self._check_open()
        from repro_torch.obs import compat
        out: Dict[str, Any] = {"n_nodes": self.n_nodes,
                               "n_edges": self.graph.n_edges,
                               **{f"t_{k}": v
                                  for k, v in self.timings.items()}}
        engine_stats = refresh_stats = cutover = None
        if self._cluster is not None:
            merged = self._cluster.stats()
            out.update(merged)
            engine_stats = {
                k: v for k, v in merged.items()
                if k not in ("attribution", "health", "cluster",
                             "refresh_cutover")}
            refresh_stats = self._engine.last_refresh_stats
            cutover = merged.get("refresh_cutover")
        elif self._engine is not None:
            engine_stats = self._engine.stats()
            refresh_stats = self._engine.last_refresh_stats
            out.update(engine_stats)
            cutover = {
                "threshold": self.reinfer.local_cutover,
                "n_local": self.reinfer.n_local_cutovers,
                "n_dist": self.reinfer.n_dist_layers,
                "n_tail": self.reinfer.n_tail_routed}
            out["refresh_cutover"] = cutover
        out["plan_cache"] = dict(self._plan_cache_counters)
        out["metrics"] = compat.unified_metrics(
            engine_stats=engine_stats,
            construct_stats=self.construct_stats,
            refresh_stats=refresh_stats,
            plan_cache=out["plan_cache"],
            timings=self.timings,
            live=(self.telemetry.metrics.to_dict()
                  if self.telemetry is not None else None),
            cutover=cutover)
        if self._cluster is None and self._engine is not None:
            if self._engine.attrib is not None:
                out["attribution"] = self._engine.attrib.summary()
            if self._engine.health is not None:
                out["health"] = self._engine.health.summary()
        return out

    def dump_trace(self, path) -> Dict[str, Any]:
        """Write the session's span trace as Chrome/Perfetto trace-event
        JSON (load it at https://ui.perfetto.dev), with the metrics
        registry under ``deal_metrics`` and the engine's attribution,
        top query paths and health under ``deal_attribution``,
        ``deal_top_queries`` and ``deal_health``.  Returns the document.
        Needs ``telemetry.enabled: true`` in the config."""
        self._check_open()
        if self.telemetry is None:
            raise ConfigError(
                "dump_trace needs telemetry enabled: set "
                "telemetry.enabled = true in the DealConfig")
        extra: Dict[str, Any] = {}
        attrib = getattr(self._engine, "attrib", None)
        health = getattr(self._engine, "health", None)
        if attrib is not None:
            extra["deal_attribution"] = attrib.summary()
            extra["deal_top_queries"] = attrib.top_paths()
        if health is not None:
            extra["deal_health"] = health.summary()
        return obs.dump_chrome_trace(
            self.telemetry.tracer, path, self.telemetry.metrics,
            process_name=f"deal.{self.cfg.model.name}",
            extra=extra or None)

    def prometheus_text(self) -> str:
        """The metrics registry in Prometheus exposition format (empty
        when telemetry is disabled)."""
        self._check_open()
        if self.telemetry is None:
            return ""
        return obs.prometheus_text(self.telemetry.metrics)

    # -- lifecycle ------------------------------------------------------
    def _check_open(self) -> None:
        if self._closed:
            raise ConfigError("session is closed")

    def close(self) -> None:
        """Stop the telemetry endpoint and the cluster deployment (its
        workers), release the big arrays (graph, features, store,
        engine) and hand the process-current telemetry back to whoever
        held it."""
        if not self._closed:
            if self._endpoint is not None:
                self._endpoint.stop()
                self._endpoint = None
            if self._cluster is not None:
                self._cluster.shutdown()
                self._cluster = None
            if self.telemetry is not None:
                obs.install(self._prev_telemetry)
            from repro_torch.core.partition import \
                uninstall_plan_cache_counters
            uninstall_plan_cache_counters(self._plan_cache_counters)
        self._closed = True
        for name in ("X", "graph", "layer_graphs", "_H", "params",
                     "executor", "_engine", "reinfer"):
            setattr(self, name, None)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
