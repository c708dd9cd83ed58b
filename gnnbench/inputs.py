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

What is particular to a model is its reference module's
(``reference/<model>.py``): one that defines ``param_shapes(cfg)`` has
those leaves drawn (``declared_params``); one that does not has a (width
in, width out) matrix drawn for each of its ``PARAMS`` a layer
(``params``).  A configuration with ``node_types`` is a typed graph: its
nodes are contiguous id blocks, one a type, and its edges are drawn a
relation at a time (``typed_blocks``, ``edges``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

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
               probs=GRAPH500_PROBS, n_dst: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """RMAT edges (src, dst), int64 host arrays: the algorithm of the
    port's ``core.graph.rmat_edges`` (one uniform draw an edge a bit of
    the id, the quadrant by ``probs``), drawn with torch on ``device``
    so that set-up stays short.  Ids are drawn over the next power of
    two and folded below ``n_nodes``; with ``n_dst``, over a rectangle:
    sources below ``n_nodes``, destinations below ``n_dst``."""
    n_dst = n_nodes if n_dst is None else n_dst
    scale = int(math.ceil(math.log2(max(n_nodes, n_dst))))
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
    dst %= n_dst
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
    """The param tree of a model whose reference declares no
    ``param_shapes``, as numpy arrays, in the tree shape of the port's
    ``params_from_numpy``: ``{"layers": [{name: matrix}]}`` with the
    names of the model's reference (``reference/<model>.py``
    ``PARAMS``), plus ``"heads"`` where there are more than one.  Layer
    l's matrices are (dims[l], dims[l + 1]), normal with standard
    deviation dims[l] ** -0.5: the first layer's drawn in one call, the
    rest in another."""
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
    return with_heads({"layers": [dict(zip(names, ws)) for ws in blocks]},
                      heads)


def with_heads(tree: Dict, heads: int) -> Dict:
    """``tree`` with ``"heads"`` where the model has more than one."""
    if heads > 1:
        tree["heads"] = heads
    return tree


def _leaves(spec, path=()):
    """(path, shape, init) of each leaf of a ``param_shapes`` tree, in
    order: dicts in their keys' order, lists in theirs."""
    if isinstance(spec, dict):
        for k, v in spec.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(spec, list):
        for i, v in enumerate(spec):
            yield from _leaves(v, path + (i,))
    else:
        shape, init = spec
        yield path, tuple(int(n) for n in shape), init


def _scale(shape, init) -> float:
    if init == "fan_in":
        if len(shape) < 2:
            raise ValueError(f"fan_in needs a matrix, not shape {shape}")
        return shape[-2] ** -0.5
    return float(init)


def declared_params(spec, seed: int, device) -> Dict:
    """The leaves of a ``param_shapes(cfg)`` tree drawn: each leaf is
    ``(shape, init)``; ``init`` is ``"fan_in"`` (normal with standard
    deviation shape[-2] ** -0.5: a matrix, or a stack of them, scaled by
    its width in), a number (normal with that standard deviation; 0
    gives zeros) or a pair (lo, hi) (uniform in [lo, hi): a norm's
    variance, a scale).  Every normal leaf comes from one call and every
    uniform leaf from another, in the tree's order; the tree comes back
    with numpy f32 arrays in the leaves' places."""
    leaves = list(_leaves(spec))
    uniform = [x for x in leaves if isinstance(x[2], (tuple, list))]
    normal = [x for x in leaves if x not in uniform]
    gen = generator(seed, device)
    out = {}
    for group, draw in ((normal, torch.randn), (uniform, torch.rand)):
        sizes = [math.prod(s) for _, s, _ in group]
        flat = draw(sum(sizes), generator=gen, device=device,
                    dtype=torch.float32)
        for (path, shape, init), a in zip(group, flat.split(sizes)):
            if draw is torch.rand:
                lo, hi = init
                a = a * (hi - lo) + lo
            else:
                a = a * _scale(shape, init)
            out[path] = a.reshape(shape).cpu().numpy()
        del flat

    def build(node, path=()):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v, path + (i,)) for i, v in enumerate(node)]
        return out[path]
    return build(spec)


def typed_blocks(cfg: Dict) -> Optional[Dict]:
    """A typed graph's layout, or None for a configuration without
    ``node_types``: ``node_offsets``, the T + 1 id offsets of the node
    types' blocks in declared order; ``relation_table``, T rows (the
    destination's type) of T relation indices (the source's type; -1
    where no relation joins them), an undirected relation standing in
    both directions; and ``relation_edges``, the edges drawn of each
    relation.  ``node_types`` maps each type to its count and
    ``relations`` lists ``{"src", "dst", "n_edges", "undirected"}``;
    where ``n_nodes`` or ``n_edges`` differ from their sums (a smaller
    run), every block and relation keeps its share of them, each at
    least 1."""
    types = cfg.get("node_types")
    if not types:
        return None
    names = list(types)
    counts = [int(types[t]) for t in names]
    n, total = int(cfg["n_nodes"]), sum(counts)
    offsets = [0]
    for cum in np.cumsum(counts)[:-1]:
        offsets.append(max(offsets[-1] + 1, int(cum) * n // total))
    if offsets[-1] >= n:
        raise ValueError(f"{n} nodes cannot hold {len(names)} node types")
    offsets.append(n)
    rels = cfg["relations"]
    want = [int(r["n_edges"]) for r in rels]
    m = int(cfg.get("n_edges", sum(want)))
    table = [[-1] * len(names) for _ in names]
    for i, r in enumerate(rels):
        s, d = names.index(r["src"]), names.index(r["dst"])
        for dt, st in {(d, s), (s, d)} if r.get("undirected") else {(d, s)}:
            if table[dt][st] != -1:
                raise ValueError(f"relations {table[dt][st]} and {i} both "
                                 f"join {names[st]} to {names[dt]}")
            table[dt][st] = i
    return {"node_offsets": offsets, "relation_table": table,
            "relation_edges": [max(1, e * m // sum(want)) for e in want]}


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
    is ``undirected``.  A typed graph draws each relation's edges over
    its rectangle of source and destination blocks, from a seed of its
    own spawned from ``seed``, taken both ways where the relation is
    undirected, the relations concatenated in declared order."""
    probs = tuple(cfg.get("rmat_probs", GRAPH500_PROBS))
    blocks = typed_blocks(cfg)
    if blocks is None:
        src, dst = rmat_edges(int(cfg["n_nodes"]), int(cfg["n_edges"]),
                              seed, device, probs)
        if cfg.get("undirected"):
            src, dst = (np.concatenate([src, dst]),
                        np.concatenate([dst, src]))
        return src, dst
    names, off = list(cfg["node_types"]), blocks["node_offsets"]
    rels = cfg["relations"]
    parts = []
    for r, m, s in zip(rels, blocks["relation_edges"],
                       spawn_seeds(seed, len(rels))):
        a, b = names.index(r["src"]), names.index(r["dst"])
        src, dst = rmat_edges(off[a + 1] - off[a], m, s, device, probs,
                              n_dst=off[b + 1] - off[b])
        src += off[a]
        dst += off[b]
        parts.append((src, dst))
        if r.get("undirected"):
            parts.append((dst, src))
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def model_params(cfg: Dict, seed: int, device) -> Dict:
    """The param tree of ``cfg``'s model: the leaves its reference
    declares (``param_shapes``), or else a matrix for each of its
    ``PARAMS`` a layer (``params``); ``"heads"`` where there are more
    than one; and a typed graph's ``node_offsets`` and
    ``relation_table`` (``typed_blocks``), as Python ints, so that the
    port, by ``params_from_numpy``, and the reference see the same
    typing."""
    mod = reference.model(cfg["model"])
    heads = int(cfg.get("heads", 1))
    if hasattr(mod, "param_shapes"):
        tree = with_heads(declared_params(mod.param_shapes(cfg), seed,
                                          device), heads)
    else:
        tree = params(cfg["model"], layer_dims(cfg), heads, seed, device)
    blocks = typed_blocks(cfg)
    if blocks is not None:
        tree.update(node_offsets=blocks["node_offsets"],
                    relation_table=blocks["relation_table"])
    return tree


def make(cfg: Dict, fanouts: Sequence[int], seed: int, device):
    """Every input of one run for configuration ``cfg`` (its ``n_nodes``,
    ``n_edges``, ``undirected``, ``d_feature``, ``hidden_size``,
    ``n_layers``, ``heads``, ``model``; a typed graph's ``node_types``
    and ``relations``) under per-layer ``fanouts``: (src, dst, X,
    params, draws), the last the sampler's calls that both sides make
    (``sample_draws``)."""
    if len(fanouts) != int(cfg["n_layers"]):
        raise ValueError(f"{len(fanouts)} fanouts for "
                         f"{cfg['n_layers']} layers")
    s_edges, s_x, s_params, s_sample = spawn_seeds(seed, 4)
    src, dst = edges(cfg, s_edges, device)
    X = features(int(cfg["n_nodes"]), int(cfg["d_feature"]), s_x, device)
    tree = model_params(cfg, s_params, device)
    return src, dst, X, tree, sample_draws(fanouts, s_sample)
