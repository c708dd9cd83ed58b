"""1-D graph + feature collaborative partition and the static CommPlan —
the port's copy of ``repro.core.partition`` (numpy only; the port imports
nothing of ``repro``), array for array the same plans.

DEAL's protocol ("send the non-zero column IDs, receive those H' rows") is
negotiated at run time on CPUs; here, as in the JAX package, the
partitioner resolves the negotiation AT PARTITION TIME: for every
(dst-partition p, ring step k) it precomputes the unique-row request set
and the edge-entry lists that consume the received buffer.  The graph is
a static input of all-node inference, so this loses no generality — it IS
the paper's ID exchange, hoisted to the plan.

Group structure == the paper's partitioned communication (§3.5): group 0 is
the local tile (Fig 11 "local first"), group k>0 holds the edges whose
source lives k hops around the data-axis ring.  ``core.primitives`` turns
a plan into each shard's receive layout.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.core.sampler import LayerGraph


@dataclasses.dataclass
class LayerPlan:
    """Static comm plan for one layer graph on a P x M grid."""
    P: int
    n_local: int                 # nodes per partition
    fanout: int
    # ring step k: device p sends rows send_local[p, k] to peer (p-k)%P and
    # receives the rows it requested from peer (p+k)%P.
    send_local: np.ndarray       # (P, P, R) int32, row ids local to sender
    send_count: np.ndarray       # (P, P)   int32 (valid prefix of R)
    # consuming the received buffer (k=0 consumes H_local directly):
    edge_dst: np.ndarray         # (P, P, E) int32 — local dst row
    edge_slot: np.ndarray        # (P, P, E) int32 — fanout slot of the edge
    edge_pos: np.ndarray         # (P, P, E) int32 — row in the recv buffer
    edge_mask: np.ndarray        # (P, P, E) bool
    # mirror for the graph-exchange baseline: at step k device q gathers the
    # per-edge source rows for peer (q-k)%P (duplicates included).
    mirror_src: np.ndarray       # (P, P, E) int32 — row local to the sender

    @property
    def max_request(self) -> int:
        return self.send_local.shape[-1]

    @property
    def max_entries(self) -> int:
        return self.edge_dst.shape[-1]


@dataclasses.dataclass
class PartitionPlan:
    n_nodes: int
    P: int
    M: int
    bounds: np.ndarray           # (P+1,)
    layers: List[LayerPlan]
    nbr_local: List[np.ndarray]  # per layer (P, n_local, F) partition-local view
    mask_local: List[np.ndarray]


def partition_nodes(n_nodes: int, P: int) -> np.ndarray:
    """1-D contiguous equal ranges (paper §3.3).  n_nodes must divide by
    P (equal shards); raises ValueError otherwise."""
    if n_nodes % P != 0:
        raise ValueError(f"{n_nodes} nodes do not split into {P} equal "
                         "partitions")
    return (np.arange(P + 1) * (n_nodes // P)).astype(np.int64)


def build_plan(layer_graphs: List[LayerGraph], P: int, M: int
               ) -> PartitionPlan:
    n = layer_graphs[0].n_nodes
    bounds = partition_nodes(n, P)
    n_local = n // P
    layers, nbrs, masks = [], [], []
    for lg in layer_graphs:
        layers.append(_layer_plan(lg, bounds, P))
        nbrs.append(lg.nbr.reshape(P, n_local, lg.fanout))
        masks.append(lg.mask.reshape(P, n_local, lg.fanout))
    return PartitionPlan(n_nodes=n, P=P, M=M, bounds=bounds, layers=layers,
                         nbr_local=nbrs, mask_local=masks)


def _layer_plan(lg: LayerGraph, bounds: np.ndarray, P: int) -> LayerPlan:
    n = lg.n_nodes
    n_local = n // P
    F = lg.fanout
    owner = np.searchsorted(bounds, lg.nbr, side="right") - 1

    req: List[List[np.ndarray]] = [[None] * P for _ in range(P)]
    entries = [[None] * P for _ in range(P)]
    for p in range(P):
        rows = slice(p * n_local, (p + 1) * n_local)
        nbr_p, mask_p, own_p = lg.nbr[rows], lg.mask[rows], owner[rows]
        for k in range(P):
            q = (p + k) % P
            sel = mask_p & (own_p == q)
            dst_loc, slot = np.nonzero(sel)
            ids = nbr_p[sel]
            if k == 0:
                # local group: positions index H_local directly
                uniq = np.empty(0, np.int64)
                pos = (ids - bounds[q]).astype(np.int64)
            else:
                uniq, pos = np.unique(ids, return_inverse=True)
                uniq = uniq - bounds[q]       # local to the source partition
            req[p][k] = uniq
            entries[p][k] = (dst_loc.astype(np.int32),
                             slot.astype(np.int32), pos.astype(np.int32),
                             (ids - bounds[q]).astype(np.int32))
    R = max(1, max(r.size for row in req for r in row))
    E = max(1, max(e[0].size for row in entries for e in row))

    send_local = np.zeros((P, P, R), np.int32)
    send_count = np.zeros((P, P), np.int32)
    edge_dst = np.zeros((P, P, E), np.int32)
    edge_slot = np.zeros((P, P, E), np.int32)
    edge_pos = np.zeros((P, P, E), np.int32)
    edge_mask = np.zeros((P, P, E), bool)
    mirror_src = np.zeros((P, P, E), np.int32)
    for p in range(P):
        for k in range(P):
            d, s, pos, src_loc = entries[p][k]
            m = d.size
            edge_dst[p, k, :m] = d
            edge_slot[p, k, :m] = s
            edge_pos[p, k, :m] = pos
            edge_mask[p, k, :m] = True
            # sender (p+k)%P ships these rows to p at ring step k:
            sender = (p + k) % P
            r = req[p][k]
            send_local[sender, k, :r.size] = r
            send_count[sender, k] = r.size
            mirror_src[sender, k, :m] = src_loc
    return LayerPlan(P=P, n_local=n_local, fanout=F, send_local=send_local,
                     send_count=send_count, edge_dst=edge_dst,
                     edge_slot=edge_slot, edge_pos=edge_pos,
                     edge_mask=edge_mask, mirror_src=mirror_src)


# ----------------------------------------------------------------------
# row-subset (frontier) plans — the distributed-delta-refresh machinery
# ----------------------------------------------------------------------

def pad_bucket(n: int, floor: int = 8) -> int:
    """Pad bucket: next power of two, floored.  The JAX package pads to
    share compiled shapes; the port pads the same way so its plans equal
    the JAX package's array for array (pad rows carry all-False masks and
    never reach a real row's bits)."""
    return max(floor, 1 << max(0, int(n - 1).bit_length()))


@dataclasses.dataclass
class SubsetPlan:
    """Static comm plan for ONE layer restricted to a row subset, with the
    frontier split per partition by the SAME 1-D ownership as the full
    plan (so per-row reduction order — and therefore bitwise output —
    matches a full epoch through the same primitives).

    Row space: each partition p computes its own frontier rows, padded to
    a common pow2 bucket ``Rmax``; source rows are each partition's
    universe of requested ids, padded to ``Umax``.  ``edge_pos[p, 0]``
    indexes the LOCAL source tile (k == 0 consumes it directly);
    ``edge_pos[p, k>0]`` indexes the ring-step recv buffer, exactly like
    ``LayerPlan``.
    """
    P: int
    fanout: int
    row_ids: np.ndarray       # (P, Rmax) int64 global target ids (pads = 0)
    row_mask: np.ndarray      # (P, Rmax, F) bool fanout masks (False on pads)
    src_ids: np.ndarray       # (P, Umax) int64 global source ids per owner
    send_local: np.ndarray    # (P, P, R) int32 positions in sender src tile
    edge_dst: np.ndarray      # (P, P, E) int32 local target row
    edge_slot: np.ndarray     # (P, P, E) int32
    edge_pos: np.ndarray      # (P, P, E) int32
    edge_mask: np.ndarray     # (P, P, E) bool
    take: np.ndarray          # indices of real rows in the flat (P*Rmax) out
    n_src_rows: int           # unpadded universe total (work accounting)


def build_subset_plan(lg: LayerGraph, rows: np.ndarray, P: int,
                      *, m_align: int = 1, floor: int = 8,
                      n_nodes: Optional[int] = None) -> SubsetPlan:
    """Comm plan for recomputing ``rows`` of one layer on a P-way data
    axis.  ``rows`` must be sorted unique global ids; ``m_align`` forces
    the row buckets to a multiple of the model-axis size (the tiled
    all-to-all GEMM splits rows M ways).

    ``n_nodes`` overrides the partitioned node count: a tail-grown layer
    graph (incremental onboarding) keeps the ORIGINAL main-partition
    geometry — callers route rows that touch the tail elsewhere, and the
    plan here must keep deriving the same 1-D ownership (and therefore
    the same per-row reduction order) as before the growth."""
    rows = np.asarray(rows, np.int64)
    n, F = int(n_nodes or lg.n_nodes), lg.fanout
    if rows.size and int(rows[-1]) >= n:
        raise ValueError("subset rows outside the partitioned range (route "
                         "tail rows to a local executor)")
    bounds = partition_nodes(n, P)
    floor = pad_bucket(max(floor, m_align))
    split = np.searchsorted(rows, bounds)
    counts = np.diff(split)
    Rmax = pad_bucket(int(counts.max()), floor)

    nbr_r, mask_r = lg.nbr[rows], lg.mask[rows]
    owner = np.searchsorted(bounds, nbr_r, side="right") - 1

    # per-owner source universes (union over all requesting partitions)
    uni: List[np.ndarray] = []
    for q in range(P):
        ids = nbr_r[mask_r & (owner == q)]
        uni.append(np.unique(ids.astype(np.int64)))
    Umax = pad_bucket(max(1, max(u.size for u in uni)), floor)
    src_ids = np.zeros((P, Umax), np.int64)
    for q in range(P):
        src_ids[q, :uni[q].size] = uni[q]
        # pad with ids already being read: pad values never reach real
        # outputs, but on a budgeted store a pad pointing at an evicted
        # row would trigger a spurious recompute (see gnnserve.delta)
        src_ids[q, uni[q].size:] = uni[q][0] if uni[q].size else rows[0]

    req: List[List[np.ndarray]] = [[None] * P for _ in range(P)]
    entries = [[None] * P for _ in range(P)]
    for p in range(P):
        sl = slice(split[p], split[p + 1])
        nbr_p, mask_p, own_p = nbr_r[sl], mask_r[sl], owner[sl]
        for k in range(P):
            q = (p + k) % P
            sel = mask_p & (own_p == q)
            dst_loc, slot = np.nonzero(sel)
            ids = nbr_p[sel].astype(np.int64)
            if k == 0:
                # local group: positions index the local source tile
                uniq = np.empty(0, np.int64)
                pos = np.searchsorted(uni[q], ids)
            else:
                uniq_ids, pos = np.unique(ids, return_inverse=True)
                uniq = np.searchsorted(uni[q], uniq_ids)
            req[p][k] = uniq
            entries[p][k] = (dst_loc.astype(np.int32),
                             slot.astype(np.int32), pos.astype(np.int32))
    R = pad_bucket(max(1, max(r.size for row in req for r in row)), floor)
    E = pad_bucket(max(1, max(e[0].size for row in entries for e in row)),
                   floor)

    send_local = np.zeros((P, P, R), np.int32)
    edge_dst = np.zeros((P, P, E), np.int32)
    edge_slot = np.zeros((P, P, E), np.int32)
    edge_pos = np.zeros((P, P, E), np.int32)
    edge_mask = np.zeros((P, P, E), bool)
    row_ids = np.zeros((P, Rmax), np.int64)
    row_mask = np.zeros((P, Rmax, F), bool)
    take = []
    for p in range(P):
        c = int(counts[p])
        row_ids[p, :c] = rows[split[p]:split[p + 1]]
        row_ids[p, c:] = rows[split[p]] if c else rows[0]   # see src_ids
        row_mask[p, :c] = mask_r[split[p]:split[p + 1]]
        take.append(p * Rmax + np.arange(c))
        for k in range(P):
            d, s, pos = entries[p][k]
            m = d.size
            edge_dst[p, k, :m] = d
            edge_slot[p, k, :m] = s
            edge_pos[p, k, :m] = pos
            edge_mask[p, k, :m] = True
            r = req[p][k]
            send_local[(p + k) % P, k, :r.size] = r
    return SubsetPlan(P=P, fanout=F, row_ids=row_ids, row_mask=row_mask,
                      src_ids=src_ids, send_local=send_local,
                      edge_dst=edge_dst, edge_slot=edge_slot,
                      edge_pos=edge_pos, edge_mask=edge_mask,
                      take=np.concatenate(take) if take else
                      np.empty(0, np.int64),
                      n_src_rows=int(sum(u.size for u in uni)))


# -- frontier-signature plan cache -------------------------------------
#
# ``build_subset_plan`` is pure numpy and runs per refreshed layer; a hot
# frontier hit repeatedly by recompute-on-miss (the budgeted store's
# eviction escape hatch) would otherwise rebuild the identical plan every
# time (ROADMAP: subset-plan build off the hot path).  Plans are cached
# ON the layer graph keyed by the frontier signature — a hash of the
# sorted row ids plus everything the partition bounds derive from
# (P / n_nodes / m_align / floor).  ``resample_rows`` mutates the layer
# graph in place, so it must call ``invalidate_subset_plans``.

SUBSET_PLAN_CACHE = {"hits": 0, "misses": 0}   # process-global aggregate
_COUNTER_SCOPES: List[dict] = []
_SUBSET_CACHE_ATTR = "_subset_plan_cache"
_SUBSET_CACHE_CAP = 64          # plans are small; bound pathological churn


def install_plan_cache_counters() -> dict:
    """Open a fresh hit/miss counter scope and return it.

    Counts are mirrored into every installed scope AND the process-global
    aggregate, so a `Session` can report its own cache behaviour without
    seeing traffic from other sessions in the same process (config
    sweeps, the test suite).  Pair with ``uninstall_plan_cache_counters``."""
    c = {"hits": 0, "misses": 0}
    _COUNTER_SCOPES.append(c)
    return c


def uninstall_plan_cache_counters(counters: dict) -> None:
    try:
        _COUNTER_SCOPES.remove(counters)
    except ValueError:
        pass                     # idempotent: double-close is fine


def subset_plan_cache_stats() -> dict:
    """Compat alias: innermost installed scope, else the global aggregate."""
    return dict(_COUNTER_SCOPES[-1] if _COUNTER_SCOPES else SUBSET_PLAN_CACHE)


def _count_plan_cache(key: str) -> None:
    SUBSET_PLAN_CACHE[key] += 1
    for c in _COUNTER_SCOPES:
        c[key] += 1
    obs.add(f"plan_cache.{key}")


def invalidate_subset_plans(lg: LayerGraph) -> None:
    """Drop cached frontier plans after an in-place layer-graph mutation."""
    getattr(lg, _SUBSET_CACHE_ATTR, {}).clear()


def build_subset_plan_cached(lg: LayerGraph, rows: np.ndarray, P: int,
                             *, m_align: int = 1, floor: int = 8,
                             n_nodes: Optional[int] = None) -> SubsetPlan:
    """``build_subset_plan`` memoized per (layer graph, frontier
    signature).  Safe because plans depend only on (lg.nbr, lg.mask,
    rows, P, n_nodes, m_align, floor) and every nbr/mask mutation goes
    through ``resample_rows`` -> ``invalidate_subset_plans``."""
    rows = np.asarray(rows, np.int64)
    n = int(n_nodes or lg.n_nodes)
    cache = getattr(lg, _SUBSET_CACHE_ATTR, None)
    if cache is None:
        cache = {}
        setattr(lg, _SUBSET_CACHE_ATTR, cache)
    # the row bytes themselves, not their hash: a 64-bit hash collision
    # would silently return another frontier's exchange plan, and the
    # key bytes are tiny next to the cached plan arrays
    key = (P, m_align, floor, n, rows.tobytes())
    plan = cache.get(key)
    if plan is not None:
        _count_plan_cache("hits")
        return plan
    _count_plan_cache("misses")
    if len(cache) >= _SUBSET_CACHE_CAP:
        cache.pop(next(iter(cache)))    # FIFO drop-one: clearing all
        # would also evict the hot frontier the cache exists to keep
    with obs.span("dist.subset_plan_build") as sp:
        plan = build_subset_plan(lg, rows, P, m_align=m_align,
                                 floor=floor, n_nodes=n)
        if sp:
            sp.set(rows=int(rows.size), P=P)
    cache[key] = plan
    return plan


def comm_volume(plan: PartitionPlan, d_feature: int, bytes_per: int = 4
                ) -> dict:
    """Analytic per-layer communication volumes (Tables 1-3 checks)."""
    out = {}
    for i, lp in enumerate(plan.layers):
        deal = int(lp.send_count[:, 1:].sum()) * (d_feature // plan.M)
        dup_edges = int(lp.edge_mask[:, 1:].sum())
        graph_exch = dup_edges * (d_feature // plan.M)
        out[f"layer{i}"] = {
            "deal_feature_exchange_B": deal * bytes_per,
            "graph_exchange_B": graph_exch * bytes_per,
            "unique_rows": int(lp.send_count[:, 1:].sum()),
            "duplicated_edge_rows": dup_edges,
        }
    return out
