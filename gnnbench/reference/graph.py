"""The reference's graph: the CSR over in-edges and the layer graphs,
worked out again from the edge list.

``csr`` is one stable sort of the edges by destination (torch, on any
device).  ``sample_layer_graphs`` is a frozen copy of the port's
layer-wise sampler: the same numpy generator draws in the same order, so
that from the same CSR and seed it draws the same neighbours.  The draws
are part of the output the benchmark checks: a port whose sampler draws
otherwise fails ``correct``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def csr(src: np.ndarray, dst: np.ndarray, n_nodes: int, device
        ) -> Tuple[np.ndarray, np.ndarray]:
    """(indptr (n+1,) int64, indices (E,) int32) as host arrays: row v
    lists the sources of v's in-edges in edge-list order."""
    d = torch.as_tensor(dst, device=device)
    order = torch.sort(d, stable=True).indices
    indices = torch.as_tensor(src, device=device)[order].to(torch.int32)
    indptr = torch.zeros(n_nodes + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(d, minlength=n_nodes), 0)
    return indptr.cpu().numpy(), indices.cpu().numpy()


def draw_fixed_fanout(deg, starts, indices, n_edges, fanout, rng):
    """One layer's draw: uniform with replacement where deg > fanout,
    each neighbour once in CSR order otherwise; (nbr int32, mask)."""
    has = deg > 0
    draw = rng.integers(0, np.maximum(deg, 1)[:, None],
                        size=(deg.size, fanout))
    take_all = deg[:, None] <= fanout
    seqidx = np.arange(fanout)[None, :]
    draw = np.where(take_all,
                    np.minimum(seqidx, np.maximum(deg - 1, 0)[:, None]),
                    draw)
    idx = starts[:, None] + draw
    nbr = indices[np.minimum(idx, max(n_edges - 1, 0))].astype(np.int32)
    mask = has[:, None] & ((seqidx < deg[:, None])
                           | (deg[:, None] > fanout))
    return nbr, mask


def sample_layer_graphs(indptr: np.ndarray, indices: np.ndarray,
                        fanout: int, n_layers: int, seed: int
                        ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n_layers`` independent fixed-fanout draws for every node, from
    one ``np.random.default_rng(seed)``: [(nbr, mask)] per layer.  A
    graph whose layers have fanouts of their own is sampled by one call a
    run of equal fanouts, each with its seed."""
    rng = np.random.default_rng(seed)
    deg = np.diff(indptr)
    starts = indptr[:-1]
    return [draw_fixed_fanout(deg, starts, indices, indices.shape[0],
                              fanout, rng) for _ in range(n_layers)]
