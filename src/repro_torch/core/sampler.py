"""Layer-wise 1-hop sampling — DEAL's sampling contribution (§3.2).

The port's own copy of ``LayerGraph``, ``draw_fixed_fanout``,
``sample_layer_graphs``, the ego-centric baseline ``sample_ego_networks``
and ``frontier_sizes`` from ``repro.core.sampler`` (numpy only); the same
seed gives bitwise the same samples.

For a k-layer model we draw k INDEPENDENT 1-hop neighborhoods per node and
store each layer's samples for all nodes together as one layer graph
``G_l``, represented as a fixed-fanout neighbor matrix (N, F) + mask — the
static-shape adaptation of the paper's per-layer edge lists.

The "column-wise" sharing of §3.2 (reusing the per-node sampling structure
across the k layers) is realized by building the per-node CSR row view once
and drawing all k layers from it in one vectorized pass.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.graph import Graph


@dataclasses.dataclass
class LayerGraph:
    """One layer's 1-hop ego networks of ALL nodes, fixed fanout."""
    nbr: np.ndarray     # (N, F) int32 — global in-neighbor ids (0 if none)
    mask: np.ndarray    # (N, F) bool
    fanout: int

    @property
    def n_nodes(self) -> int:
        return self.nbr.shape[0]


def draw_fixed_fanout(deg: np.ndarray, starts: np.ndarray,
                      indices: np.ndarray, n_edges: int, fanout: int,
                      rng: np.random.Generator
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """One fixed-fanout draw for the rows described by (deg, starts):
    uniform with replacement where deg > fanout, each neighbor once
    otherwise.  Every id stays in range (``np.minimum`` below): the
    CUDA kernels gather without bounds checks."""
    has = deg > 0
    draw = rng.integers(0, np.maximum(deg, 1)[:, None],
                        size=(deg.size, fanout))
    take_all = deg[:, None] <= fanout      # small rows: take each nbr once
    seqidx = np.arange(fanout)[None, :]
    draw = np.where(take_all,
                    np.minimum(seqidx, np.maximum(deg - 1, 0)[:, None]),
                    draw)
    idx = starts[:, None] + draw
    nbr = indices[np.minimum(idx, max(n_edges - 1, 0))].astype(np.int32)
    mask = has[:, None] & ((seqidx < deg[:, None])
                           | (deg[:, None] > fanout))
    return nbr, mask


def sample_layer_graphs(g: Graph, fanout: int, n_layers: int,
                        seed: int = 0) -> List[LayerGraph]:
    """Sample k 1-hop layer graphs for all nodes, sharing the per-node
    sampling structure (degree/row offsets) across layers."""
    rng = np.random.default_rng(seed)
    deg = g.degrees()                      # the shared sampling structure:
    starts = g.indptr[:-1]                 # built ONCE, reused k times
    out = []
    for l in range(n_layers):
        with obs.span("sample.layer") as sp:
            nbr, mask = draw_fixed_fanout(deg, starts, g.indices,
                                          g.n_edges, fanout, rng)
            out.append(LayerGraph(nbr=nbr, mask=mask, fanout=fanout))
            if sp:
                sp.set(layer=l, rows=int(nbr.shape[0]), fanout=fanout)
    return out


def sample_ego_networks(g: Graph, targets: np.ndarray, fanout: int,
                        n_layers: int, seed: int = 0
                        ) -> List[List[np.ndarray]]:
    """Ego-centric baseline: per-target multi-hop frontier expansion
    (pointer-chasing).  Returns, per target, the node set of each hop."""
    rng = np.random.default_rng(seed)
    egos = []
    for t in targets:
        frontier = np.array([t], np.int64)
        hops = [frontier]
        for _ in range(n_layers):
            nxt = []
            for v in frontier:
                nbrs = g.neighbors(v)
                if nbrs.size == 0:
                    continue
                if nbrs.size > fanout:
                    nbrs = rng.choice(nbrs, size=fanout, replace=False)
                nxt.append(nbrs)
            frontier = (np.unique(np.concatenate(nxt))
                        if nxt else np.empty(0, np.int64))
            hops.append(frontier)
        egos.append(hops)
    return egos


def frontier_sizes(layer_graphs: List[LayerGraph],
                   targets: np.ndarray) -> List[np.ndarray]:
    """Dependency frontiers of a target batch under the LAYER graphs
    (used by the sharing-ratio analytics and the batched baseline)."""
    frontier = np.unique(targets)
    out = [frontier]
    for lg in layer_graphs:
        nbrs = lg.nbr[frontier][lg.mask[frontier]]
        frontier = np.unique(np.concatenate([frontier, nbrs]))
        out.append(frontier)
    return out
