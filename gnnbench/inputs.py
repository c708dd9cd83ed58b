"""The benchmark's inputs, made from ``--seed``: the edge list, the
features, the params and the sampler's draws.  The same seed gives the same inputs on the same
kind of device.

Each input draws from a seed of its own, spawned from ``--seed``, so
that a change in one input's size leaves the others' draws alone.  The
edges and params are drawn with a ``torch.Generator`` on the device, in
a few large calls, and handed to both sides as host numpy arrays: the
port takes them there (``csr_from_edges_distributed``,
``params_from_numpy``), and the features ``X`` are a host f32 array, as
a job's would be.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from gnnbench import reference

GRAPH500_PROBS = (0.57, 0.19, 0.19, 0.05)


def spawn_seeds(seed: int, n: int = 3):
    """``n`` independent 63-bit seeds from one whole number (any sign or
    size)."""
    ss = np.random.SeedSequence(abs(int(seed)) + (int(seed) < 0) * (1 << 70))
    return [int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for s in ss.spawn(n)]


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def rmat_edges(n_nodes: int, n_edges: int, seed: int, device,
               probs=GRAPH500_PROBS) -> Tuple[np.ndarray, np.ndarray]:
    """RMAT edges (src, dst), int64 host arrays: the algorithm of the
    port's ``core.graph.rmat_edges`` (one uniform draw an edge a bit of
    the id, the quadrant by ``probs``), drawn with torch on ``device``
    so that set-up stays short.  Ids are drawn over the next power of
    two and folded below ``n_nodes``."""
    scale = int(math.ceil(math.log2(n_nodes)))
    a, b, c, _ = probs
    gen = generator(seed, device)
    src = torch.zeros(n_edges, dtype=torch.int64, device=device)
    dst = torch.zeros(n_edges, dtype=torch.int64, device=device)
    for bit in range(scale):
        r = torch.rand(n_edges, generator=gen, device=device,
                       dtype=torch.float64)
        src |= (r >= a + b).long() << bit
        dst |= (((r >= a) & (r < a + b)) | (r >= a + b + c)).long() << bit
        del r
    src %= n_nodes
    dst %= n_nodes
    return src.cpu().numpy(), dst.cpu().numpy()


def features(n_nodes: int, d: int, seed: int, device) -> np.ndarray:
    """X (n_nodes, d): standard normal f32, as a host array."""
    x = torch.randn((n_nodes, d), generator=generator(seed, device),
                    device=device, dtype=torch.float32)
    return x.cpu().numpy()


def layer_dims(cfg: Dict) -> List[int]:
    """The width into each layer and out of the last: ``d_feature``, then
    ``hidden_size`` for each of the ``n_layers``."""
    return [int(cfg["d_feature"])] + [int(cfg["hidden_size"])] * int(
        cfg["n_layers"])


def params(model: str, dims: List[int], heads: int, seed: int,
           device) -> Dict:
    """The model's param tree as numpy arrays, in the tree shape of the
    port's ``params_from_numpy``: ``{"layers": [{name: matrix}]}`` with
    the names of the model's reference (``reference/<model>.py``
    ``PARAMS``), plus ``"heads"`` for gat.  Layer l's matrices are
    (dims[l], dims[l + 1]), normal with standard deviation
    dims[l] ** -0.5: the first layer's drawn in one call, the rest in
    another."""
    names = reference.model(model).PARAMS
    gen = generator(seed, device)
    blocks = []
    for lo, hi in ((0, 1), (1, len(dims) - 1)):
        if hi <= lo:
            continue
        w = torch.randn((hi - lo, len(names), dims[lo], dims[lo + 1]),
                        generator=gen, device=device,
                        dtype=torch.float32) * dims[lo] ** -0.5
        blocks.extend(w.cpu().numpy())
    tree = {"layers": [dict(zip(names, ws)) for ws in blocks]}
    if model == "gat":
        tree["heads"] = heads
    return tree


def sample_draws(fanouts: Sequence[int], seed: int
                 ) -> List[Tuple[int, int, int]]:
    """The sampler's calls for per-layer ``fanouts``: each run of equal
    consecutive fanouts is one draw of that many layers, which shares
    the sampling structure across them, each from a seed of its own
    spawned from ``seed``: [(fanout, n_layers, seed)]."""
    runs: List[List[int]] = []
    for f in fanouts:
        if runs and runs[-1][0] == int(f):
            runs[-1][1] += 1
        else:
            runs.append([int(f), 1])
    return [(f, n, s) for (f, n), s in zip(runs,
                                           spawn_seeds(seed, len(runs)))]


def edges(cfg: Dict, seed: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """The configuration's edge list: ``n_edges`` RMAT edges over
    ``n_nodes``, each also taken in the other direction where the graph
    is ``undirected``."""
    src, dst = rmat_edges(int(cfg["n_nodes"]), int(cfg["n_edges"]), seed,
                          device, tuple(cfg.get("rmat_probs",
                                                GRAPH500_PROBS)))
    if cfg.get("undirected"):
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    return src, dst


def make(cfg: Dict, fanouts: Sequence[int], seed: int, device):
    """Every input of one run for configuration ``cfg`` (its ``n_nodes``,
    ``n_edges``, ``undirected``, ``d_feature``, ``hidden_size``,
    ``n_layers``, ``heads``, ``model``) under per-layer ``fanouts``:
    (src, dst, X, params, draws), the last the sampler's calls that both
    sides make (``sample_draws``)."""
    if len(fanouts) != int(cfg["n_layers"]):
        raise ValueError(f"{len(fanouts)} fanouts for "
                         f"{cfg['n_layers']} layers")
    s_edges, s_x, s_params, s_sample = spawn_seeds(seed, 4)
    src, dst = edges(cfg, s_edges, device)
    X = features(int(cfg["n_nodes"]), int(cfg["d_feature"]), s_x, device)
    tree = params(cfg["model"], layer_dims(cfg), int(cfg.get("heads", 1)),
                  s_params, device)
    return src, dst, X, tree, sample_draws(fanouts, s_sample)
