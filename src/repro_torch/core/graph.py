"""Graph substrate: CSR construction (stage 1 of Fig 2), RMAT, datasets.

The port's own copy of ``repro.core.graph`` (numpy only): the same seed
gives bitwise the same edge lists and CSR.

Construction is a host/file-system task in the paper too (their cluster
builds CSR from an on-disk edge list before any GNN compute); we implement
both the single-machine baseline (DistDGL-style, Fig 20 baseline) and DEAL's
distributed builder, modeled as chunk-parallel passes with counted exchange
volumes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch import obs


@dataclasses.dataclass
class Graph:
    """CSR over in-edges: row v lists the in-neighbors of v."""
    indptr: np.ndarray      # (N+1,) int64
    indices: np.ndarray     # (E,)  int32
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]


def csr_from_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> Graph:
    """Single-machine baseline: one global counting sort by dst."""
    counts = np.bincount(dst, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    order = np.argsort(dst, kind="stable")
    return Graph(indptr=indptr, indices=src[order].astype(np.int32),
                 n_nodes=n_nodes)


def csr_from_edges_distributed(src: np.ndarray, dst: np.ndarray,
                               n_nodes: int, n_workers: int = 4,
                               chunk_edges: int = 1 << 20
                               ) -> Tuple[Graph, Dict[str, float]]:
    """DEAL's distributed construction (modeled on one host).

    Each worker reads a disjoint chunk range of the edge list, histograms by
    destination partition and "ships" edges to the owning worker (we count
    the exchanged bytes); each worker then builds its local CSR
    independently.  The returned graph is the concatenation of local CSRs
    (node ranges are contiguous, so indptr/indices concatenate directly).
    """
    t0 = time.perf_counter()
    E = src.shape[0]
    bounds = np.linspace(0, n_nodes, n_workers + 1).astype(np.int64)
    part_of = np.searchsorted(bounds, dst, side="right") - 1
    exchanged = 0

    # pass 1 (parallel in production): per-chunk shuffle by owner
    buckets_src = [[] for _ in range(n_workers)]
    buckets_dst = [[] for _ in range(n_workers)]
    reader_bounds = np.linspace(0, E, n_workers + 1).astype(np.int64)
    shuffle_worker_s = []
    with obs.span("construct.shuffle") as sp:
        for w in range(n_workers):
            tw = time.perf_counter()
            lo, hi = reader_bounds[w], reader_bounds[w + 1]
            for c0 in range(lo, hi, chunk_edges):
                c1 = min(c0 + chunk_edges, hi)
                p = part_of[c0:c1]
                for q in range(n_workers):
                    sel = p == q
                    if not sel.any():
                        continue
                    buckets_src[q].append(src[c0:c1][sel])
                    buckets_dst[q].append(dst[c0:c1][sel])
                    if q != w:          # cross-worker traffic
                        exchanged += int(sel.sum()) * 8
            shuffle_worker_s.append(time.perf_counter() - tw)
        if sp:
            sp.set(n_workers=n_workers, exchanged_bytes=exchanged)
    obs.add("construct.exchanged_bytes", exchanged)
    t_shuffle = time.perf_counter() - t0

    # pass 2: local CSR build per worker
    t1 = time.perf_counter()
    indptr = np.zeros(n_nodes + 1, np.int64)
    chunks = []
    build_worker_s = []
    with obs.span("construct.local_build",
                  {"n_workers": n_workers} if obs.enabled() else None):
        for q in range(n_workers):
            tw = time.perf_counter()
            lo, hi = bounds[q], bounds[q + 1]
            s = (np.concatenate(buckets_src[q]) if buckets_src[q]
                 else np.empty(0, src.dtype))
            d = (np.concatenate(buckets_dst[q]) if buckets_dst[q]
                 else np.empty(0, dst.dtype))
            local = d - lo
            counts = np.bincount(local, minlength=hi - lo)
            indptr[lo + 1:hi + 1] = counts
            order = np.argsort(local, kind="stable")
            chunks.append(s[order].astype(np.int32))
            build_worker_s.append(time.perf_counter() - tw)
        np.cumsum(indptr, out=indptr)
        g = Graph(indptr=indptr, indices=np.concatenate(chunks),
                  n_nodes=n_nodes)
    # modeled wall time on a real cluster: slowest worker per parallel
    # phase + network (workers here run sequentially on one host).
    net_bw = 25e9 / 8                    # the paper's 25 Gbps Ethernet
    modeled = (max(shuffle_worker_s) + max(build_worker_s)
               + exchanged / net_bw)
    stats = {"shuffle_s": t_shuffle, "build_s": time.perf_counter() - t1,
             "exchanged_bytes": float(exchanged), "n_workers": n_workers,
             "modeled_parallel_s": modeled,
             "worker_shuffle_s": shuffle_worker_s,
             "worker_build_s": build_worker_s}
    return g, stats


# ----------------------------------------------------------------------
# generators / datasets
# ----------------------------------------------------------------------

def rmat_edges(n_nodes: int, n_edges: int, seed: int = 0,
               probs=(0.57, 0.19, 0.19, 0.05)) -> Tuple[np.ndarray, np.ndarray]:
    """RMAT [63] with the paper's edge probabilities; n_nodes = 2^k."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(n_nodes)))
    a, b, c, d = probs
    src = np.zeros(n_edges, np.int64)
    dst = np.zeros(n_edges, np.int64)
    for bit in range(scale):
        r = rng.random(n_edges)
        quad_src = (r >= a + b).astype(np.int64)     # lower half quads
        quad_dst = ((r >= a) & (r < a + b) | (r >= a + b + c)).astype(np.int64)
        src |= quad_src << bit
        dst |= quad_dst << bit
    src %= n_nodes
    dst %= n_nodes
    return src, dst


def planted_partition(n_nodes: int, n_comm: int, p_in: float, p_out: float,
                      seed: int = 0):
    """Community graph for the Table-6 accuracy study.

    Returns (src, dst, labels)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_comm, n_nodes)
    deg = 16
    n_edges = n_nodes * deg
    src = rng.integers(0, n_nodes, n_edges)
    same = rng.random(n_edges) < p_in / (p_in + p_out)
    # intra-community destinations: uniform over the src's community
    members = np.full((n_comm, n_nodes), 0, np.int64)
    sizes = np.zeros(n_comm, np.int64)
    for c in range(n_comm):
        idx = np.where(labels == c)[0]
        members[c, :idx.size] = idx
        sizes[c] = idx.size
    comm = labels[src]
    pick = rng.integers(0, np.maximum(sizes[comm], 1))
    dst_same = members[comm, pick]
    dst_rand = rng.integers(0, n_nodes, n_edges)
    dst = np.where(same, dst_same, dst_rand)
    return src.astype(np.int64), dst.astype(np.int64), labels


_DATASETS = {
    # laptop-scale stand-ins preserving the density character of Table 4
    # name: (n_nodes, avg_degree)
    "ogbn-products": (8_192, 51),      # sparse-ish co-purchase
    "social-spammer": (4_096, 153),    # dense multi-relation
    "ogbn-papers100M": (16_384, 14),   # large & sparse citation
}


def make_dataset(name: str, seed: int = 0,
                 scale: float = 1.0) -> Tuple[np.ndarray, np.ndarray, int]:
    """Synthetic edge list with the named dataset's density character."""
    n, deg = _DATASETS[name]
    n = int(n * scale)
    e = int(n * deg)
    src, dst = rmat_edges(n, e, seed=seed)
    return src, dst, n


def truncate_to_multiple(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                         mult: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Trim the node count to a multiple of ``mult`` (the P*M mesh needs
    n % P == 0) and drop edges touching the removed tail."""
    n = n_nodes - n_nodes % mult
    keep = (src < n) & (dst < n)
    return src[keep], dst[keep], n


def dataset_names():
    return list(_DATASETS)
