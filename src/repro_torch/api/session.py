"""``Session`` — the port's lifecycle object over the offline pipeline.

    cfg = DealConfig.load("cfg.json")
    with Session.build(cfg) as s:              # device="cuda" by default
        H = s.infer_all()                      # (N, d) tensor on the card

``build`` runs the same stages as ``repro.api.session.Session``: dataset
-> distributed CSR construction -> layer-wise sampling -> features and
params -> executor.  The features come from the same numpy generator as
in the JAX package, so X is identical in both.  The params come from a
``torch.Generator`` seeded with the graph seed, or from ``params=``
(for example ``core.gnn_models.params_from_numpy`` of the JAX package's
params, which is how the two packages are held against each other).
Serving (``serve``, ``refresh``, ...) is not ported yet.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.config import ConfigError, DealConfig
from repro_torch.api.registry import MODELS


class Session:
    """Build once from a validated ``DealConfig`` on one device; run the
    all-node epoch with ``infer_all``; tear down with ``close``."""

    def __init__(self, cfg: DealConfig, device="cuda",
                 params: Optional[Dict[str, Any]] = None):
        from repro_torch.core.ops import resolve_device
        self.cfg = cfg
        self.device = resolve_device(device)
        self._closed = False
        self.timings: Dict[str, float] = {}
        self.telemetry = cfg.telemetry.build()
        self._prev_telemetry = (obs.install(self.telemetry)
                                if self.telemetry is not None else None)
        self._build_pipeline(params)
        self._H: Optional[torch.Tensor] = None

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
        executor; a tensor on the session's device.  Cached."""
        self._check_open()
        if self._H is not None:
            return self._H
        from repro_torch.core.gnn_models import model_spec
        from repro_torch.core.ops import DenseIO, run_model
        spec = model_spec(self.cfg.model.name, self.params)
        lgs = self.layer_graphs[:len(spec.layers)]
        t0 = time.perf_counter()
        with obs.span("session.infer_all",
                      {"model": self.cfg.model.name}
                      if obs.enabled() else None) as sp:
            ios = [DenseIO.from_layer_graph(lg, self.device) for lg in lgs]
            H = run_model(self.executor, spec, ios, self.X)
            if H.is_cuda:
                torch.cuda.synchronize(H.device)   # honest infer_s
            if sp:
                sp.set(rows=int(H.shape[0]))
        self.timings["infer_s"] = time.perf_counter() - t0
        if torch.isnan(H).any():
            raise RuntimeError("infer_all produced NaN embeddings")
        self._H = H
        return H

    # -- lifecycle ------------------------------------------------------
    def _check_open(self) -> None:
        if self._closed:
            raise ConfigError("session is closed")

    def close(self) -> None:
        """Release the big arrays and hand the process-current telemetry
        back to whoever held it."""
        if not self._closed and self.telemetry is not None:
            obs.install(self._prev_telemetry)
        self._closed = True
        for name in ("X", "graph", "layer_graphs", "_H", "params",
                     "executor"):
            setattr(self, name, None)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
