"""GNN models: parameter initializers and the DECLARATIVE layer specs —
the port's twin of ``repro.core.gnn_models``.

The paper evaluates 3-layer GCN and GAT (4 heads).  GAT here uses
dot-product attention (q.k per sampled edge), so edge scoring is the
SDDMM primitive of §3.4.  Heads are laid out head-major in the feature
dim.  Each model's per-layer math is a sequence of declarative ops
(gemm / spmm / attn_scores / edge_softmax / attend / add) over the
slots ``h_tgt`` and ``h_src``, interpreted by ``core.ops`` against an
executor.

Params are plain dicts of tensors with the JAX package's tree shape.
The port draws its own from a ``torch.Generator`` (on the CPU, then
moved, so a seed gives the same params on every device); parity with
``repro`` carries the reference's params across with
``params_from_numpy``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.api.registry import MODELS, register_model


def _normal(gen: torch.Generator, fan_in: int, fan_out: int):
    return torch.randn((fan_in, fan_out), generator=gen,
                       dtype=torch.float32) * (fan_in ** -0.5)


def init_gcn(gen: torch.Generator, dims: List[int]) -> Dict[str, Any]:
    return {"w": [_normal(gen, dims[i], dims[i + 1])
                  for i in range(len(dims) - 1)]}


def init_gat(gen: torch.Generator, dims: List[int],
             heads: int = 4) -> Dict[str, Any]:
    layers = [{name: _normal(gen, dims[i], dims[i + 1])
               for name in ("wq", "wk", "wv")}
              for i in range(len(dims) - 1)]
    return {"layers": layers, "heads": heads}


def init_sage(gen: torch.Generator, dims: List[int]) -> Dict[str, Any]:
    return {"layers": [{name: _normal(gen, dims[i], dims[i + 1])
                        for name in ("w_self", "w_nbr")}
                       for i in range(len(dims) - 1)]}


def params_to(tree, device):
    """The same tree with every array as an f32 tensor on ``device``
    (ints, such as gat's ``heads``, pass through)."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to(v, device) for v in tree]
    if isinstance(tree, np.ndarray):          # copied: may be read-only
        tree = torch.from_numpy(np.array(tree, np.float32))
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=torch.float32)
    return tree


def params_from_numpy(model: str, tree: Dict[str, Any],
                      device) -> Dict[str, Any]:
    """``repro``'s param tree, as numpy arrays, to the port's params on
    ``device``: ``{"w": [...]}`` (gcn), ``{"layers": [{"w_self",
    "w_nbr"}]}`` (sage), ``{"layers": [{"wq", "wk", "wv"}], "heads"}``
    (gat).  Raises if the tree does not have the model's shape."""
    keys = {"gcn": None, "sage": {"w_self", "w_nbr"},
            "gat": {"wq", "wk", "wv"}}
    if model not in keys:
        raise ValueError(f"params_from_numpy: unknown model {model!r}")
    if model == "gcn":
        if set(tree) != {"w"}:
            raise ValueError(f"gcn params need exactly 'w', got {set(tree)}")
    else:
        want_top = {"layers", "heads"} if model == "gat" else {"layers"}
        if set(tree) != want_top or any(set(p) != keys[model]
                                        for p in tree["layers"]):
            raise ValueError(f"{model} params need {want_top} with layers "
                             f"of {sorted(keys[model])}")
    return params_to(tree, device)


def mean_weights(mask: np.ndarray) -> np.ndarray:
    """Mean-aggregation edge weights from a fanout mask."""
    deg = np.maximum(mask.sum(axis=1, keepdims=True), 1)
    return (mask / deg).astype(np.float32)


def masked_softmax(scores, mask):
    s = torch.where(mask, scores, -1e30)
    p = torch.softmax(s, dim=-1)
    return p * mask


def gat_head_scores(q, kf, nbr, mask, heads: int):
    """Per-head dot scores (R, F, h) from full-width q/k; kf rows may
    outnumber q rows."""
    N, D = q.shape
    dh = D // heads
    qh = q.reshape(N, heads, dh)
    kh = kf.reshape(-1, heads, dh)
    kn = kh[nbr.reshape(-1).long()].reshape(nbr.shape + (heads, dh))
    return torch.einsum("nhd,nfhd->nfh", qh, kn) / torch.sqrt(
        torch.tensor(float(dh), dtype=torch.float32, device=q.device))


# ----------------------------------------------------------------------
# declarative layer specs (executed by core.ops)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerOp:
    """One declarative op inside a layer program.

    kind     gemm | spmm | add | attn_scores | edge_softmax | attend
    out      env slot written
    src      env slots read ("h_tgt"/"h_src" are the layer inputs)
    param    weight matrix (gemm only)
    """
    kind: str
    out: str
    src: Tuple[str, ...] = ()
    param: Any = None


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    ops: Tuple[LayerOp, ...]
    out: str = "h"


@dataclasses.dataclass
class ModelSpec:
    """A sequence of LayerSpecs + head count + activation (applied
    between layers, not after the last)."""
    model: str
    layers: List[LayerSpec]
    heads: int
    activation: Callable


@dataclasses.dataclass(frozen=True)
class ModelPlugin:
    """A registered GNN model: ``init(gen, dims, heads) -> params`` and
    ``spec(params) -> ModelSpec``."""
    init: Callable
    spec: Callable


def _gcn_spec(params: Dict[str, Any]) -> ModelSpec:
    layers = [LayerSpec(ops=(
        LayerOp("gemm", "hw", ("h_src",), w),
        LayerOp("spmm", "h", ("hw",)),
    )) for w in params["w"]]
    return ModelSpec("gcn", layers, heads=1, activation=F.relu)


def _sage_spec(params: Dict[str, Any]) -> ModelSpec:
    layers = [LayerSpec(ops=(
        LayerOp("spmm", "agg", ("h_src",)),
        LayerOp("gemm", "own", ("h_tgt",), p["w_self"]),
        LayerOp("gemm", "nb", ("agg",), p["w_nbr"]),
        LayerOp("add", "h", ("own", "nb")),
    )) for p in params["layers"]]
    return ModelSpec("sage", layers, heads=1, activation=F.relu)


def _gat_spec(params: Dict[str, Any]) -> ModelSpec:
    layers = [LayerSpec(ops=(
        LayerOp("gemm", "q", ("h_tgt",), p["wq"]),
        LayerOp("gemm", "k", ("h_src",), p["wk"]),
        LayerOp("gemm", "v", ("h_src",), p["wv"]),
        LayerOp("attn_scores", "s", ("q", "k")),
        LayerOp("edge_softmax", "alpha", ("s",)),
        LayerOp("attend", "h", ("alpha", "v")),
    )) for p in params["layers"]]
    return ModelSpec("gat", layers, heads=int(params.get("heads", 1)),
                     activation=F.elu)


register_model("gcn", ModelPlugin(
    init=lambda gen, dims, heads=1: init_gcn(gen, dims), spec=_gcn_spec))
register_model("sage", ModelPlugin(
    init=lambda gen, dims, heads=1: init_sage(gen, dims), spec=_sage_spec))
register_model("gat", ModelPlugin(
    init=lambda gen, dims, heads=1: init_gat(gen, dims, heads=heads),
    spec=_gat_spec))


def model_spec(model: str, params: Dict[str, Any]) -> ModelSpec:
    """Each model's layer math as data, resolved through the registry."""
    try:
        plugin = MODELS.get(model)
    except KeyError as exc:
        raise ValueError(str(exc)) from None
    return plugin.spec(params)
