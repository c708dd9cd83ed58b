"""Sharing-ratio analytics (Table 5, Fig 5, Observation #2) — the port's
copy of ``repro.core.sharing``, in numpy over the port's ``LayerGraph``:
the same numbers from the same layer graphs.

Cost model: one unit of work = one node's per-layer computation (GEMM row +
aggregation).  For a k-layer model over targets T:
  no-sharing cost   C_max  = sum_t sum_l |frontier_l(t)|   (every ego alone)
  DEAL cost         C_min  = k * N                          (each row once)
  batched (DGI)     C(B)   = sum_batches sum_l |frontier_l(batch)|
  P3-style          outermost-hop dedup only
  SALIENT++-style   cache of the hottest nodes absorbs repeated rows

sharing_ratio = (C_max - C) / (C_max - C_min)  — DEAL == 1.0 by design.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.sampler import LayerGraph


def _frontiers(layer_graphs: List[LayerGraph], targets: np.ndarray
               ) -> List[np.ndarray]:
    """needed[l] = nodes whose layer-l INPUT must be computed (l=0..k-1
    consume, plus the final target set)."""
    L = len(layer_graphs)
    needed = [None] * (L + 1)
    needed[L] = np.unique(targets)
    for l in range(L - 1, -1, -1):
        lg = layer_graphs[l]
        up = needed[l + 1]
        nbrs = lg.nbr[up][lg.mask[up]]
        needed[l] = np.unique(np.concatenate([up, nbrs]))
    return needed


def batched_cost(layer_graphs: List[LayerGraph], batch_size: int) -> int:
    N = layer_graphs[0].n_nodes
    total = 0
    for b0 in range(0, N, batch_size):
        t = np.arange(b0, min(b0 + batch_size, N))
        needed = _frontiers(layer_graphs, t)
        total += sum(f.size for f in needed[:-1])
    return total


def nosharing_cost(layer_graphs: List[LayerGraph],
                   sample_targets: int = 256, seed: int = 0) -> float:
    """Estimated from a target sample (exact is O(N * ego size))."""
    N = layer_graphs[0].n_nodes
    rng = np.random.default_rng(seed)
    t = rng.choice(N, size=min(sample_targets, N), replace=False)
    per_target = [sum(f.size for f in _frontiers(layer_graphs,
                                                 np.array([v]))[:-1])
                  for v in t]
    return float(np.mean(per_target)) * N


def p3_cost(layer_graphs: List[LayerGraph], batch_size: int,
            sample_targets: int = 256, seed: int = 0) -> float:
    """P3 shares only the OUTERMOST hop within a batch; inner hops are
    computed per ego network (hybrid parallelism redundancy) [41]."""
    N = layer_graphs[0].n_nodes
    rng = np.random.default_rng(seed)
    t = rng.choice(N, size=min(sample_targets, N), replace=False)
    inner = [sum(f.size for f in _frontiers(layer_graphs,
                                            np.array([v]))[1:-1])
             for v in t]
    inner_total = float(np.mean(inner)) * N
    outer_total = 0.0
    for b0 in range(0, N, batch_size):
        tb = np.arange(b0, min(b0 + batch_size, N))
        outer_total += _frontiers(layer_graphs, tb)[0].size
    return inner_total + outer_total


def salientpp_cost(layer_graphs: List[LayerGraph], batch_size: int,
                   cache_fraction: float = 0.1) -> float:
    """SALIENT++-style: per-batch ego compute, but rows of the
    cache_fraction hottest nodes are free after first use [47]."""
    N = layer_graphs[0].n_nodes
    # hotness = in-degree under the sampled layer graphs
    counts = np.zeros(N, np.int64)
    for lg in layer_graphs:
        np.add.at(counts, lg.nbr[lg.mask], 1)
    hot = set(np.argsort(-counts)[:int(N * cache_fraction)].tolist())
    total = 0.0
    seen_hot = set()
    for b0 in range(0, N, batch_size):
        t = np.arange(b0, min(b0 + batch_size, N))
        needed = _frontiers(layer_graphs, t)
        for f in needed[:-1]:
            for v in f:
                if v in hot:
                    if v in seen_hot:
                        continue
                    seen_hot.add(v)
                total += 1
    return total


def sharing_table(layer_graphs: List[LayerGraph], batch_size: int
                  ) -> Dict[str, float]:
    N = layer_graphs[0].n_nodes
    L = len(layer_graphs)
    c_min = float(L * N)
    c_max = nosharing_cost(layer_graphs)
    span = max(c_max - c_min, 1.0)

    def ratio(c):
        return float(np.clip((c_max - c) / span, 0.0, 1.0))

    return {
        "deal": 1.0,
        "dgi_batched": ratio(batched_cost(layer_graphs, batch_size)),
        "p3": ratio(p3_cost(layer_graphs, batch_size)),
        "salientpp": ratio(salientpp_cost(layer_graphs, batch_size)),
        "c_max": c_max, "c_min": c_min,
    }


def sharing_vs_batch_size(layer_graphs: List[LayerGraph],
                          fractions=(0.01, 0.05, 0.25, 0.5, 1.0)
                          ) -> Dict[float, float]:
    """Fig 5: leveraged sharing vs batch size (fraction of all nodes)."""
    N = layer_graphs[0].n_nodes
    c_min = float(len(layer_graphs) * N)
    c_max = nosharing_cost(layer_graphs)
    out = {}
    for f in fractions:
        b = max(1, int(N * f))
        c = batched_cost(layer_graphs, b)
        out[f] = float(np.clip((c_max - c) / max(c_max - c_min, 1.0),
                               0.0, 1.0))
    return out
