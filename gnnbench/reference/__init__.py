"""The plain reference of the all-node epoch: plain PyTorch and numpy,
f32 with TF32 off.  It imports nothing of the port and takes nothing
the port made: from the benchmark's own edges, features, params and
sampler seed it works out again the CSR, the layer graphs (``graph``),
the mean or attention weights and every layer (``<model>.py``: its
``PARAMS``, ``layer`` and ``activation``, or its own ``embed``).

``precision="tf32"`` is the control: every GEMM's inputs rounded to
TF32 (10 mantissa bits, to nearest even) before an f32 product, what a
GEMM with TF32 on computes.  It must fail the comparison.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from gnnbench.reference import graph

PRECISIONS = ("f32", "tf32")


def model(name: str):
    """The reference module of a model, ``reference/<name>.py``."""
    return importlib.import_module(f"gnnbench.reference.{name}")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def matmul(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")

    def mm(h, w):
        if precision == "tf32":
            h, w = round_tf32(h), round_tf32(w)
        return torch.matmul(h, w)
    return mm


def embed_all(model_name: str, src: np.ndarray, dst: np.ndarray,
              X: np.ndarray, tree, draws, device, precision: str = "f32"):
    """Every node's embedding after the layers of ``draws`` (the
    sampler's calls, [(fanout, n_layers, seed)], in layer order): (N,
    width) f32 on ``device``.  A model whose module defines
    ``embed(h, layer_graphs, tree, mm)`` owns its forward from the
    features ``h`` on ``device``, the layer graphs as host (nbr, mask)
    pairs and the numpy param tree (a typed graph's ``node_offsets`` and
    ``relation_table`` in it); the others run ``layer`` a layer, with
    ``activation`` between layers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mod = model(model_name)
    mm = matmul(precision)
    indptr, indices = graph.csr(src, dst, X.shape[0], device)
    lgs = [lg for fanout, n, seed in draws
           for lg in graph.sample_layer_graphs(indptr, indices, fanout, n,
                                               seed)]
    del indptr, indices
    h = torch.as_tensor(X, device=device)
    if hasattr(mod, "embed"):
        return mod.embed(h, lgs, tree, mm)
    heads = int(tree.get("heads", 1))
    n_layers = len(lgs)
    for l, (nbr, mask) in enumerate(lgs):
        p = {k: torch.as_tensor(np.asarray(tree["layers"][l][k]),
                                device=device) for k in mod.PARAMS}
        h = mod.layer(h, torch.as_tensor(nbr, device=device).long(),
                      torch.as_tensor(mask, device=device), p, heads, mm)
        if l < n_layers - 1:
            h = mod.activation(h)
    return h
