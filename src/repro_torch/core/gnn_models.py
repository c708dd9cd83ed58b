"""GNN models: parameter initializers and the DECLARATIVE layer specs —
the port's twin of ``repro.core.gnn_models``.

The paper evaluates 3-layer GCN and GAT (4 heads).  GAT here uses
dot-product attention (q.k per sampled edge), so edge scoring is the
SDDMM primitive of §3.4.  Heads are laid out head-major in the feature
dim.  Each model's per-layer math is a sequence of declarative ops
(gemm / spmm / attn_scores / edge_softmax / attend / add) over the
slots ``h_tgt`` and ``h_src``, interpreted by ``core.ops`` against an
executor.

R-GAT (``rgat``, OGB-LSC MAG240M's relational GAT, arXiv:2103.09430,
``examples/lsc/mag240m/rgnn.py --model rgat``) runs on a typed graph:
node types in contiguous id blocks and a ``GATConv`` a relation, each
with its own projection, additive scores and softmax.  Its layers add
the ``rel_*`` ops (the relations' projections, their scores and
softmax, the attend), a skip ``gemm``, an ``affine`` (the biases and
eval BatchNorm) and ``elu``, in place where a deployment's memory needs
it; its ``ModelSpec`` carries a ``head`` (an MLP over every node, no
graph) and the graph's ``NodeTyping``.  No JAX twin: the plain
reference is the benchmark's (``gnnbench/reference/rgat.py``).

Params are plain dicts of tensors with the JAX package's tree shape.
The port draws its own from a ``torch.Generator`` (on the CPU, then
moved, so a seed gives the same params on every device); parity with
``repro`` carries the reference's params across with
``params_from_numpy``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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
    (gat); for rgat, ``RGAT_LAYER_KEYS`` a layer, ``RGAT_HEAD_KEYS``
    in ``head``, and a typed graph's ``node_offsets`` and
    ``relation_table``, passed through as Python ints (``heads``
    optional).  Raises if the tree does not have the model's shape."""
    keys = {"gcn": None, "sage": {"w_self", "w_nbr"},
            "gat": {"wq", "wk", "wv"}, "rgat": None}
    if model not in keys:
        raise ValueError(f"params_from_numpy: unknown model {model!r}")
    if model == "rgat":
        return _rgat_params(tree, device)
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
# R-GAT's params and typing
# ----------------------------------------------------------------------

RGAT_LAYER_KEYS = frozenset({"w_rel", "a_src", "a_dst", "b_rel", "w_skip",
                             "b_skip", "bn_mean", "bn_var", "bn_weight",
                             "bn_bias"})
RGAT_HEAD_KEYS = frozenset({"w1", "b1", "bn_mean", "bn_var", "bn_weight",
                            "bn_bias", "w2", "b2"})
RGAT_NEGATIVE_SLOPE = 0.2          # GATConv's LeakyReLU
BN_EPS = 1e-5                      # torch's BatchNorm1d


def _rgat_params(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """rgat's tree on ``device``: every array f32, ``heads`` an int, the
    typing's ids as Python ints."""
    top = {"layers", "head", "node_offsets", "relation_table"}
    if (set(tree) - {"heads"} != top or not tree["layers"]
            or any(set(p) != RGAT_LAYER_KEYS for p in tree["layers"])
            or set(tree["head"]) != RGAT_HEAD_KEYS):
        raise ValueError(f"rgat params need {sorted(top)} (and optional "
                         f"'heads') with layers of {sorted(RGAT_LAYER_KEYS)}"
                         f" and a head of {sorted(RGAT_HEAD_KEYS)}")
    out = params_to({"layers": tree["layers"], "head": tree["head"]},
                    device)
    out["heads"] = int(tree.get("heads", 1))
    out["node_offsets"] = [int(x) for x in tree["node_offsets"]]
    out["relation_table"] = [[int(x) for x in row]
                             for row in tree["relation_table"]]
    node_typing(out["node_offsets"], out["relation_table"],
                out["layers"][0]["w_rel"].shape[0])       # checks them
    return out


@dataclasses.dataclass(frozen=True)
class NodeTyping:
    """A typed graph's layout, as the params carry it.  ``offsets``: the
    T + 1 id offsets of the node types' contiguous blocks; ``table``: a
    slot's relation by its target's type (row) and its source's
    (column), -1 where none joins them.  The projected table that R-GAT
    attends over holds, for each relation r and each type st of its
    sources, st's rows projected by r's weight (``blocks``), so that a
    slot of relation r whose source j has type st reads row
    ``base + j - offsets[st]``."""
    offsets: Tuple[int, ...]
    table: Tuple[Tuple[int, ...], ...]
    n_relations: int

    @property
    def blocks(self) -> List[Tuple[int, int, int, int]]:
        """(relation, source type, first table row, rows), in relation
        order, then source type."""
        out, base = [], 0
        for r in range(self.n_relations):
            for st in sorted({s for row in self.table
                              for s, x in enumerate(row) if x == r}):
                rows = self.offsets[st + 1] - self.offsets[st]
                out.append((r, st, base, rows))
                base += rows
        return out

    @property
    def rows(self) -> int:
        """The projected table's rows: each relation's source rows."""
        return sum(b[3] for b in self.blocks)

    def sources(self, dt: int) -> List[Tuple[int, int, int]]:
        """(source type, relation, first table row of its block) for each
        relation whose targets are of type ``dt``."""
        base = {(r, st): b for r, st, b, _ in self.blocks}
        return [(st, r, base[r, st]) for st, r in enumerate(self.table[dt])
                if r >= 0]


def node_typing(offsets: Sequence[int], table: Sequence[Sequence[int]],
                n_relations: int) -> NodeTyping:
    """The ``NodeTyping`` of a tree's ``node_offsets`` and
    ``relation_table``; raises unless the offsets rise from 0, the table
    is T x T and its relations lie in [-1, n_relations)."""
    off = tuple(int(x) for x in offsets)
    tab = tuple(tuple(int(x) for x in row) for row in table)
    T = len(off) - 1
    if (T < 1 or off[0] != 0 or any(b <= a for a, b in zip(off, off[1:]))
            or len(tab) != T or any(len(row) != T for row in tab)
            or any(not -1 <= x < n_relations for row in tab for x in row)):
        raise ValueError(f"node typing: offsets {list(off)} must rise from 0"
                         f" and the relation table be {T} x {T} of "
                         f"relations in [-1, {n_relations}); got "
                         f"{[list(r) for r in tab]}")
    return NodeTyping(off, tab, int(n_relations))


# ----------------------------------------------------------------------
# declarative layer specs (executed by core.ops)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerOp:
    """One declarative op inside a layer program.

    kind     gemm | spmm | add | attn_scores | edge_softmax | attend |
             rel_project | rel_softmax | rel_attend | affine | elu | relu
    out      env slot written
    src      env slots read ("h_tgt"/"h_src" are the layer inputs)
    param    weight matrix (gemm), ``RelProjection`` (rel_project),
             ``RelAttention`` (rel_softmax), ``Affine`` (affine)
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
    between layers, not after the last; None where the layers carry
    their own), an optional ``head`` run after the last layer over every
    row without the graph, and a typed graph's ``typing`` (the layer
    graphs then bind each slot's relation, ``DenseIO.bind_typing``)."""
    model: str
    layers: List[LayerSpec]
    heads: int
    activation: Optional[Callable]
    head: Optional[LayerSpec] = None
    typing: Optional[NodeTyping] = None


@dataclasses.dataclass(frozen=True, eq=False)
class RelProjection:
    """``rel_project``'s param: the relations' stacked weights (R, d_in,
    d_out), each applied to its source types' rows."""
    w: Any
    typing: NodeTyping


@dataclasses.dataclass(frozen=True, eq=False)
class RelAttention:
    """``rel_softmax``'s param: the relations' weights (R, d_in, d_out)
    and their attention vectors ``a_src``, ``a_dst`` (R, heads, d_out /
    heads)."""
    w: Any
    a_src: Any
    a_dst: Any
    typing: NodeTyping


@dataclasses.dataclass(frozen=True, eq=False)
class Affine:
    """``affine``'s param: ``biases``, vectors or stacks of them (summed
    over their leading axes), added to every row, then eval BatchNorm
    where ``bn`` holds its (mean, var, weight, bias)."""
    biases: Tuple[Any, ...]
    bn: Optional[Tuple[Any, Any, Any, Any]] = None


def affine_(x, aff: Affine):
    """``x`` plus the biases, through eval BatchNorm where ``aff.bn`` is
    set, in place: ``x * scale + shift`` with scale = weight / sqrt(var
    + eps) and shift = bias + (biases - mean) * scale, one pass."""
    b = None
    for t in aff.biases:
        t = t.sum(dim=tuple(range(t.dim() - 1))) if t.dim() > 1 else t
        b = t if b is None else b + t
    if aff.bn is None:
        return x.add_(b)
    mean, var, weight, bias = aff.bn
    scale = weight / torch.sqrt(var + BN_EPS)
    shift = bias + (b - mean) * scale
    return torch.addcmul(shift, x, scale, out=x)


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


def _rgat_spec(params: Dict[str, Any]) -> ModelSpec:
    """Each layer: the relations' projections of their source rows, the
    relation-wise scores and softmax, the skip GEMM, the attend added
    into it, the biases and eval BatchNorm, ELU (the last layer's too);
    then the head, Linear, BatchNorm, ReLU, Linear, over every row."""
    typing = node_typing(params["node_offsets"], params["relation_table"],
                         params["layers"][0]["w_rel"].shape[0])
    layers = [LayerSpec(ops=(
        LayerOp("rel_project", "z", ("h_src",),
                RelProjection(p["w_rel"], typing)),
        LayerOp("rel_softmax", "alpha", ("z", "h_tgt"),
                RelAttention(p["w_rel"], p["a_src"], p["a_dst"], typing)),
        LayerOp("gemm", "own", ("h_tgt",), p["w_skip"]),
        LayerOp("rel_attend", "agg", ("z", "alpha", "own")),
        LayerOp("affine", "bn", ("agg",), Affine(
            (p["b_skip"], p["b_rel"]),
            (p["bn_mean"], p["bn_var"], p["bn_weight"], p["bn_bias"]))),
        LayerOp("elu", "h", ("bn",)),
    )) for p in params["layers"]]
    hp = params["head"]
    head = LayerSpec(ops=(
        LayerOp("gemm", "t", ("h_tgt",), hp["w1"]),
        LayerOp("affine", "tn", ("t",), Affine(
            (hp["b1"],),
            (hp["bn_mean"], hp["bn_var"], hp["bn_weight"], hp["bn_bias"]))),
        LayerOp("relu", "a", ("tn",)),
        LayerOp("gemm", "y", ("a",), hp["w2"]),
        LayerOp("affine", "h", ("y",), Affine((hp["b2"],))),
    ))
    return ModelSpec("rgat", layers, heads=int(params.get("heads", 1)),
                     activation=None, head=head, typing=typing)


def _rgat_init(gen, dims, heads=4):
    raise ValueError("rgat's params need a typed graph (node_offsets, "
                     "relation_table), which Session does not generate: "
                     "build them with params_from_numpy")


register_model("gcn", ModelPlugin(
    init=lambda gen, dims, heads=1: init_gcn(gen, dims), spec=_gcn_spec))
register_model("sage", ModelPlugin(
    init=lambda gen, dims, heads=1: init_sage(gen, dims), spec=_sage_spec))
register_model("gat", ModelPlugin(
    init=lambda gen, dims, heads=1: init_gat(gen, dims, heads=heads),
    spec=_gat_spec))
register_model("rgat", ModelPlugin(init=_rgat_init, spec=_rgat_spec))


def model_spec(model: str, params: Dict[str, Any]) -> ModelSpec:
    """Each model's layer math as data, resolved through the registry."""
    try:
        plugin = MODELS.get(model)
    except KeyError as exc:
        raise ValueError(str(exc)) from None
    return plugin.spec(params)
