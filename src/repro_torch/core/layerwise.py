"""The DEAL engine: layer-by-layer all-node inference (§3.2, Fig 4) — the
port's twin of ``repro.core.layerwise``.

The engines are thin drivers over the executor layer (``core.ops``):
each model's layer math is declared once in ``gnn_models.model_spec``
and run against a backend —

  * ``local_*`` — single-card engines; ``executor`` is "cuda" (the
    hand-written kernels, the default) or "ref" (plain PyTorch), on
    ``device`` ("cuda" by default; "cpu" runs the plain versions);
    ``local_rgat_infer`` binds each layer graph's slot relations
    (``DenseIO.bind_typing``) before the layers;
  * ``DistributedLayerwise`` — ``DistExecutor`` on a P x M mesh
    (``launch.mesh``) using the §3.4 primitives and the static CommPlan.

Plus the ego-network baseline (DGI/SALIENT++-style batched inference)
of the Fig 14 comparison: the same math on the same sampled layer
graphs, computed batch by batch over multi-hop dependency frontiers, so
cross-batch redundancy costs real work — the waste DEAL removes.  It
runs through the same executor primitives.  Every GEMM of an executor
has the same row count a call (``core.ops.gemm_rows``) and the kernels
sum each row's slots in order, so on one executor the baseline gives
the bits of ``local_gcn_infer``.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.gnn_models import mean_weights, model_spec
from repro_torch.core.ops import (DenseIO, DistExecutor, get_executor,
                                  run_model)
from repro_torch.core.sampler import LayerGraph


# ----------------------------------------------------------------------
# single-card engines
# ----------------------------------------------------------------------

def _local_infer(model: str, layer_graphs: List[LayerGraph], X, params,
                 activation, executor, device):
    ex = get_executor(executor, device=device)
    spec = model_spec(model, params)
    ios = [DenseIO.from_layer_graph(lg, ex.device)
           for lg in layer_graphs[:len(spec.layers)]]
    if spec.typing is not None:
        for io in ios:
            io.bind_typing(spec.typing)
    return run_model(ex, spec, ios, X, activation=activation)


def local_gcn_infer(layer_graphs, X, params, activation=F.relu,
                    executor="cuda", device="cuda"):
    return _local_infer("gcn", layer_graphs, X, params, activation,
                        executor, device)


def local_gat_infer(layer_graphs, X, params, activation=F.elu,
                    executor="cuda", device="cuda"):
    return _local_infer("gat", layer_graphs, X, params, activation,
                        executor, device)


def local_sage_infer(layer_graphs, X, params, activation=F.relu,
                     executor="cuda", device="cuda"):
    return _local_infer("sage", layer_graphs, X, params, activation,
                        executor, device)


def local_rgat_infer(layer_graphs, X, params, activation=None,
                     executor="cuda", device="cuda"):
    """R-GAT on a typed graph (``params_from_numpy("rgat", ...)``): each
    layer's BatchNorm and ELU, and the head, are the spec's own, so
    ``activation`` must stay None (a second nonlinearity between layers
    would compute another model)."""
    if activation is not None:
        raise ValueError("local_rgat_infer: R-GAT's ELU is the spec's own; "
                         f"activation must be None, got {activation!r}")
    return _local_infer("rgat", layer_graphs, X, params, activation,
                        executor, device)


LOCAL_ENGINES = {"gcn": local_gcn_infer, "gat": local_gat_infer,
                 "sage": local_sage_infer, "rgat": local_rgat_infer}


# ----------------------------------------------------------------------
# ego-network batched baseline (the DGI/SALIENT++-style computation)
# ----------------------------------------------------------------------

def ego_batched_gcn_infer(layer_graphs: List[LayerGraph], X, params,
                          batch_size: int, activation=F.relu,
                          executor="cuda", device="cuda"):
    """The outputs of ``local_gcn_infer``, computed per target batch over
    multi-hop frontiers; returns ``(H, work_rows)``, where ``work_rows``
    sums the rows each layer's GEMM ran over (DEAL's is L * N)."""
    ex = get_executor(executor, device=device)
    dev = ex.device
    X = ex.prepare(X)
    N = layer_graphs[0].n_nodes
    L = len(params["w"])
    out = torch.zeros((N, params["w"][-1].shape[1]), dtype=torch.float32,
                      device=dev)
    work_rows = 0
    for b0 in range(0, N, batch_size):
        targets = np.arange(b0, min(b0 + batch_size, N))
        # dependency frontiers: needed[l] = inputs of layer l
        needed = [None] * (L + 1)
        needed[L] = targets
        for l in range(L - 1, -1, -1):
            lg = layer_graphs[l]
            up = needed[l + 1]
            nbrs = lg.nbr[up][lg.mask[up]]
            needed[l] = np.unique(np.concatenate([up, nbrs]))
        H = X[torch.as_tensor(needed[0], device=dev)]
        cur = needed[0]
        for l, w in enumerate(params["w"]):
            lg = layer_graphs[l]
            nxt = needed[l + 1]
            work_rows += cur.size
            Hw = ex.gemm(H, w)
            # remap the layer graph of `nxt` onto positions in `cur`
            pos = np.searchsorted(cur, lg.nbr[nxt])
            pos = np.clip(pos, 0, cur.size - 1)
            valid = lg.mask[nxt] & (cur[pos] == lg.nbr[nxt])
            wts = torch.as_tensor(mean_weights(lg.mask[nxt]) * valid,
                                  device=dev)
            H = ex.spmm(Hw, wts, DenseIO(pos, valid, device=dev))
            if l < L - 1:
                H = activation(H)
            cur = nxt
        rows = np.searchsorted(needed[L], targets)
        out[torch.as_tensor(targets, device=dev)] = H[
            torch.as_tensor(rows, device=dev)]
    return out, work_rows


# ----------------------------------------------------------------------
# distributed engine
# ----------------------------------------------------------------------

class DistributedLayerwise:
    """DEAL distributed inference: a thin driver binding the model spec
    to a ``DistExecutor`` on a P x M mesh.  ``infer`` returns the global
    embeddings on the mesh's first device."""

    def __init__(self, mesh, layer_graphs: List[LayerGraph], model: str,
                 params, *, spmm_variant: str = "deal",
                 gemm_variant: str = "deal", sddmm_variant: str = "deal",
                 grouped: bool = True):
        self.spec = model_spec(model, params)
        if self.spec.typing is not None or self.spec.head is not None:
            raise ValueError(f"DistributedLayerwise runs gcn, sage and gat; "
                             f"{model} (a typed graph, a head) runs on one "
                             f"card only: LOCAL_ENGINES[{model!r}]")
        self.mesh = mesh
        self.model = model
        self.params = params
        self.layer_graphs = layer_graphs
        self.ex = DistExecutor(mesh, spmm_variant=spmm_variant,
                               gemm_variant=gemm_variant,
                               sddmm_variant=sddmm_variant, grouped=grouped)
        self.P = self.ex.P
        self.M = self.ex.M
        self.ios = self.ex.bind(layer_graphs[:len(self.spec.layers)],
                                need_sddmm=(model == "gat"))
        self.plan = self.ex.plan

    def infer(self, X) -> torch.Tensor:
        return run_model(self.ex, self.spec, self.ios, X).to_global()
