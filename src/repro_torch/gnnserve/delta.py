"""Incremental delta re-inference over the layerwise engine's output.

A mutation batch dirties two kinds of state: level-0 rows (feature
updates) and sampled layer-graph rows (edge churn re-samples the
destinations' fixed-fanout rows, deterministically, from the spliced
CSR).  Because DEAL's layer graphs are static between refreshes, the
forward-affected set is computable in closed form BEFORE any compute
(the port's twin of ``repro.gnnserve.delta``):

    dirty_0   = feature-updated nodes
    dirty_l+1 = resampled_rows  ∪  dirty_l  ∪  consumers_l(dirty_l)

where ``consumers_l`` is the REVERSE of layer l's fanout matrix (who
sampled me?) — the same frontier machinery as ``core.sharing``'s
backward dependency walk, run forward.  Re-inference then re-runs ONLY
those rows through the bound executor (``core.ops``); the rows' inputs
are gathered from the store on the host, copied to the executor's
device(s), and the outputs copied back.  The layer math comes from the
same declarative spec as the offline epoch, and the backend is
selectable —

  ref / cuda   single-device row-subset mode: neighbor ids translated
               onto the gathered universe through a scratch table (the
               gather_spmm kernel on "cuda");
  dist         ``DistExecutor.run_rows``: the frontier is split per
               partition and recomputed through the §3.4 primitives on
               the mesh (a per-refresh SubsetPlan built over the same
               1-D ownership as the full CommPlan).  Rows that are or
               read a tail-onboarded node, and (with a local cutover)
               small frontiers, route to the local executor: "cuda" on
               a card, "ref" on the CPU (``core.ops.local_executor_name``).

A delta-refreshed row is BITWISE equal to a from-scratch epoch through
the SAME executor: the CUDA kernels compute a row from that row's inputs
alone, in an order fixed by the shapes' widths, never by the number of
rows in the launch, and GEMM runs at a fixed row count a call
(``core.ops.gemm_rows``).  The plain versions keep it on the CPU, where
the tests check it.

Neighbor ids stay in range, masked slots included: the universe table
maps every id outside the universe to position 0, and the CUDA kernels
gather without bounds checks.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.gnn_models import model_spec
from repro_torch.core.graph import Graph
from repro_torch.core.ops import (DenseIO, get_executor,
                                  local_executor_name, run_layer)
from repro_torch.core.partition import invalidate_subset_plans, pad_bucket
from repro_torch.core.sampler import LayerGraph
from repro_torch.gnnserve.store import EmbeddingStore


# ----------------------------------------------------------------------
# content-addressed row hashing (splitmix64, vectorized)
# ----------------------------------------------------------------------

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX_B = np.uint64(0xBF58476D1CE4E5B9)
_MIX_C = np.uint64(0x94D049BB133111EB)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over uint64 arrays (wrapping arithmetic) —
    the counter-based generator behind ``resample_rows``'s per-row
    independent streams.  A hash, not a crypto primitive."""
    x = x + _GOLDEN
    x ^= x >> np.uint64(30)
    x *= _MIX_B
    x ^= x >> np.uint64(27)
    x *= _MIX_C
    x ^= x >> np.uint64(31)
    return x


# ----------------------------------------------------------------------
# reverse fanout index: node u -> rows that sample u
# ----------------------------------------------------------------------

@dataclasses.dataclass
class ReverseIndex:
    indptr: np.ndarray     # (N+1,)
    rows: np.ndarray       # (#masked edges,) consumer row ids, grouped by src

    def consumers(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return np.empty(0, np.int64)
        # vectorized multi-span gather (this runs per layer per refresh)
        starts = self.indptr[ids]
        counts = self.indptr[ids + 1] - starts
        total = int(counts.sum())
        if total == 0:
            return np.empty(0, np.int64)
        offsets = np.repeat(starts - np.concatenate(
            [[0], np.cumsum(counts)[:-1]]), counts)
        return np.unique(self.rows[np.arange(total) + offsets])


def build_reverse_index(lg: LayerGraph) -> ReverseIndex:
    dst_rows, _ = np.nonzero(lg.mask)
    src = lg.nbr[lg.mask]
    order = np.argsort(src, kind="stable")
    counts = np.bincount(src, minlength=lg.n_nodes)
    indptr = np.zeros(lg.n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return ReverseIndex(indptr=indptr, rows=dst_rows[order].astype(np.int64))


def splice_reverse_index(rev: ReverseIndex, rows: np.ndarray,
                         old_nbr: np.ndarray, old_mask: np.ndarray,
                         new_nbr: np.ndarray, new_mask: np.ndarray
                         ) -> ReverseIndex:
    """Splice the resampled ``rows``' old/new entries into an existing
    reverse index, EXACTLY equal to ``build_reverse_index`` on the
    mutated layer graph — sorting work is O(changed log changed) plus a
    few flat C array passes for the bulk moves, instead of the rebuild's
    full N*F nonzero + E log E argsort.

    The trick: a resampled row's old entries are precisely every
    occurrence of its id in ``rev.rows`` (one global delete mask), and
    because spans are source-ascending with row-sorted contents, the
    composite key ``src * (N+1) + row`` is GLOBALLY sorted — so the new
    entries' merge positions come from one ``searchsorted`` and one
    ``insert``, value-level merge included.

    ``old_nbr/old_mask`` are the rows' pre-resample fanout slices (the
    same copies ``DeltaReinference.refresh`` snapshots for rollback);
    ``new_nbr/new_mask`` their post-resample state.
    """
    rows = np.asarray(rows, np.int64)
    if rows.size == 0:
        return rev
    n_nodes = rev.indptr.size - 1
    old_src = old_nbr[old_mask].astype(np.int64)
    new_src = new_nbr[new_mask].astype(np.int64)

    # delete: every occurrence of a resampled consumer row
    keep = ~np.isin(rev.rows, rows)
    kept = rev.rows[keep]
    assert int((~keep).sum()) == int(old_mask.sum()), \
        "reverse index inconsistent with the rows' pre-resample state"
    src_kept = np.repeat(np.arange(n_nodes, dtype=np.int64),
                         np.diff(rev.indptr))[keep]

    # insert: new (src, row) pairs, value-level merged via composite key
    new_rows_rep = np.repeat(rows, new_mask.sum(axis=1))
    order = np.lexsort((new_rows_rep, new_src))
    ns, nr = new_src[order], new_rows_rep[order]
    stride = np.int64(n_nodes + 1)
    pos = np.searchsorted(src_kept * stride + kept, ns * stride + nr)
    out = np.insert(kept, pos, nr)

    counts = (np.diff(rev.indptr)
              - np.bincount(old_src, minlength=n_nodes)
              + np.bincount(new_src, minlength=n_nodes))
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    assert out.size == indptr[-1], "reverse-index splice drifted"
    return ReverseIndex(indptr=indptr, rows=out)


def resample_rows(g: Graph, layer_graphs: Sequence[LayerGraph],
                  rows: np.ndarray, seed: int) -> None:
    """Deterministically re-draw the given rows of every layer graph from
    the (mutated) CSR, in place — mirrors ``sampler.sample_layer_graphs``
    restricted to a row subset.

    Seeding is CONTENT-ADDRESSED per row: row r's draw is a pure
    function of (seed, r, layer index, r's CSR neighborhood bytes) — NOT
    of which refresh batch r happened to ride in.  That makes refresh
    *batching-invariant*: folding one mutation stream in one big batch
    or many small ones lands on bitwise-identical layer graphs (and,
    via the per-refresh full-epoch equivalence, identical store bytes)
    whenever the final CSR matches.  The QoS engine's per-tenant
    freshness views rely on this — a loose-SLO tenant coalescing at its
    own deadlines must read the same bits a single-tenant engine at
    that SLO would produce, even while a strict tenant forces extra
    intermediate refreshes on the shared store.
    """
    rows = np.asarray(rows, np.int64)
    if rows.size == 0:
        return
    deg = np.diff(g.indptr)[rows]
    starts = g.indptr[:-1][rows]
    crc = np.fromiter(
        (zlib.crc32(g.indices[g.indptr[r]:g.indptr[r + 1]].tobytes())
         for r in rows.tolist()), np.uint64, rows.size)
    key = _mix64(_mix64(_mix64(np.full(rows.size,
                                       int(seed) & 0xFFFFFFFFFFFFFFFF,
                                       np.uint64))
                        ^ rows.astype(np.uint64)) ^ crc)
    has = deg > 0
    maxdeg = np.maximum(deg, 1).astype(np.uint64)[:, None]
    for l, lg in enumerate(layer_graphs):
        F = lg.fanout
        lane = _mix64(_mix64(np.full(F, l + 1, np.uint64) * _GOLDEN)
                      + np.arange(F, dtype=np.uint64))
        # counter-based uniform draw: the vectorized stand-in for
        # draw_fixed_fanout's rng.integers (same take-all / mask
        # semantics below; modulo bias is ~deg/2^64, nil)
        draw = (_mix64(key[:, None] ^ lane[None, :])
                % maxdeg).astype(np.int64)
        take_all = deg[:, None] <= F        # small rows: each nbr once
        seqidx = np.arange(F)[None, :]
        draw = np.where(take_all,
                        np.minimum(seqidx, np.maximum(deg - 1, 0)[:, None]),
                        draw)
        idx = starts[:, None] + draw
        lg.nbr[rows] = g.indices[np.minimum(idx, max(g.n_edges - 1, 0))] \
            .astype(np.int32)
        lg.mask[rows] = has[:, None] & ((seqidx < deg[:, None])
                                        | (deg[:, None] > F))
        invalidate_subset_plans(lg)     # cached frontier plans are stale


def forward_frontier(rev: Sequence[ReverseIndex], feat_dirty: np.ndarray,
                     resampled: np.ndarray, n_layers: int
                     ) -> List[np.ndarray]:
    """frontier[l] = rows whose level-(l+1) value must be recomputed."""
    feat_dirty = np.asarray(feat_dirty, np.int64)
    resampled = np.asarray(resampled, np.int64)
    out, dirty = [], feat_dirty
    for l in range(n_layers):
        dirty = np.unique(np.concatenate(
            [resampled, dirty, rev[l].consumers(dirty)]))
        out.append(dirty)
    return out


# ----------------------------------------------------------------------
# delta re-inference
# ----------------------------------------------------------------------

def _pow2(n: int, floor: int = 256) -> int:
    """Pad bucket, floored high.  The JAX package pads for its compile
    cache; the port keeps the same padding because its pad ids are rows
    being read, which the store's hit counters count, so ``stats()``
    stays the JAX package's."""
    return pad_bucket(n, floor)


def _remap(nbr_rows: np.ndarray, mask_rows: np.ndarray, universe: np.ndarray):
    """Map global neighbor ids onto positions in `universe`; masked slots
    pin to position 0 (see module docstring)."""
    pos = np.searchsorted(universe, nbr_rows)
    pos = np.where(mask_rows, pos, 0)
    return np.clip(pos, 0, max(universe.size - 1, 0)).astype(np.int32)


class DeltaReinference:
    """Row-subset re-inference bound to one model + its layer graphs.

    ``layer_graphs`` are held by reference and mutated in place by
    ``resample_rows``; reverse indexes for mutated layers are rebuilt
    lazily at the next refresh.  ``executor`` is an executor instance
    (a ``DistExecutor`` for mesh refresh), or a registered name ("ref" |
    "cuda") built on ``device``.
    """

    def __init__(self, layer_graphs: Sequence[LayerGraph], model: str,
                 params, *, sample_seed: int = 0, executor="ref",
                 local_cutover: int = 0, device="cuda"):
        # model resolves through the registry below (model_spec raises
        # with every registered name on a typo)
        self.layer_graphs = list(layer_graphs)
        self.model = model
        self.params = params
        self.spec = model_spec(model, params)
        self.executor = get_executor(executor, device=device)
        self.sample_seed = sample_seed
        self.rows_gemm = 0
        self.rev_rebuilds = 0
        self.rev_splices = 0
        # frontier-size cutover (dist executor only): a layer whose
        # universe (rows_gemm unit) is below the threshold routes to a
        # lazily-built LOCAL executor instead of the mesh — the mesh's
        # messages and a cold subset plan dominate tiny frontiers.  0 =
        # off (the default: routing changes which reduction produced the
        # bits, so dist-vs-dist bitwise equivalence only holds with the
        # cutover disabled or thresholds equal).
        self.local_cutover = int(local_cutover)
        self.n_local_cutovers = 0
        self.n_dist_layers = 0
        # main-partition extent for the dist executor: tail-onboarded
        # rows (ids >= n_main) never fit the `n % P == 0` subset-plan
        # geometry, so any row that IS or READS a tail node routes
        # through the local executor instead (see _layer_rows_dist).
        # Frozen for the lifetime of this instance — re-partitioning the
        # grown graph would change per-row reduction orders and break
        # bitwise equality with the epochs already served.
        self.n_main = (int(self.layer_graphs[0].n_nodes)
                       if self.layer_graphs else 0)
        self.n_tail_routed = 0
        self._local_ex = None
        self._table_pool: List[np.ndarray] = []
        self._rev: List[Optional[ReverseIndex]] = \
            [None] * len(self.layer_graphs)

    @property
    def n_layers(self) -> int:
        return len(self.spec.layers)

    def _reverse(self, l: int) -> ReverseIndex:
        if self._rev[l] is None:
            self._rev[l] = build_reverse_index(self.layer_graphs[l])
            self.rev_rebuilds += 1
        return self._rev[l]

    def _local_executor(self):
        """The single-device executor that tail rows and (with a cutover)
        tiny dist frontiers route to, on the mesh's first device."""
        if self._local_ex is None:
            dev = self.executor.device
            self._local_ex = get_executor(local_executor_name(dev),
                                          device=dev)
        return self._local_ex

    def _scratch_table(self, n: int) -> np.ndarray:
        """Node-count-sized int32 scratch for the fused id translation,
        drawn from a pool (``_layer_rows`` returns it after resetting
        its touched entries to 0, so stale ids always map to a valid
        position).  A pool rather than one persistent buffer because
        recompute-on-miss re-enters ``_layer_rows`` mid-layer on a
        budgeted store — the outer layer's table must survive the inner
        call."""
        while self._table_pool:
            t = self._table_pool.pop()
            if t.size >= n:
                return t
        return np.zeros(max(n, 1), np.int32)

    # -- incremental node onboarding ------------------------------------
    def extend_nodes(self, n_new: int) -> None:
        """Grow every layer graph (and any cached reverse index) by
        ``n_new`` brand-new rows with empty neighborhoods.  The new rows
        MUST ride the next refresh's ``resampled`` set — that refresh
        draws their fanout from the grown CSR and writes their levels
        through the staging overlay before anything reads them."""
        for l, lg in enumerate(self.layer_graphs):
            lg.nbr = np.concatenate(
                [lg.nbr, np.zeros((n_new, lg.fanout), np.int32)])
            lg.mask = np.concatenate(
                [lg.mask, np.zeros((n_new, lg.fanout), bool)])
            invalidate_subset_plans(lg)
            rev = self._rev[l]
            if rev is not None:
                # fresh rows have no consumers yet; extending indptr in
                # place keeps the splice path O(changed) at the refresh
                rev.indptr = np.concatenate(
                    [rev.indptr,
                     np.full(n_new, rev.indptr[-1], np.int64)])

    def shrink_nodes(self, n_new: int) -> None:
        """Inverse of ``extend_nodes`` — the engine's rollback when an
        onboarding refresh fails before commit."""
        for lg in self.layer_graphs:
            lg.nbr = lg.nbr[:-n_new]
            lg.mask = lg.mask[:-n_new]
            invalidate_subset_plans(lg)
        # a failed refresh already dropped the cached reverse indexes;
        # dropping again is cheap insurance against size drift
        self._rev = [None] * len(self.layer_graphs)

    # -- full epoch -----------------------------------------------------
    def full_levels(self, X: np.ndarray) -> List[np.ndarray]:
        """Run a full epoch, returning every level as the store keeps it:
        [X, input-of-layer-2, ..., final embedding]."""
        L = self.n_layers
        levels = [np.asarray(X, np.float32)]
        ids = np.arange(levels[0].shape[0], dtype=np.int64)
        for l in range(L):
            with obs.span("epoch.layer") as sp:
                H = self._layer_rows(l, ids,
                                     lambda lvl, want: levels[lvl][want])
                if sp:
                    sp.set(layer=l, rows=int(ids.size))
            levels.append(H)
        return levels

    # -- one layer over a row subset ------------------------------------
    def _layer_rows(self, l: int, rows: np.ndarray, read_level) -> np.ndarray:
        """Recompute layer l's output for `rows` through the bound
        executor; `read_level(level, ids)` supplies input rows (the
        store's staged view during a refresh)."""
        ex = self.executor
        if getattr(ex, "name", None) == "dist":
            return self._layer_rows_dist(l, rows, read_level, ex)
        return self._layer_rows_single(l, rows, read_level, ex)

    def _layer_rows_dist(self, l: int, rows: np.ndarray, read_level,
                         ex) -> np.ndarray:
        """Dist dispatch with tail-partition routing: rows that are, or
        sample, a tail-onboarded node (id >= n_main) cannot enter the
        ``n % P == 0`` subset-plan geometry without re-partitioning (and
        re-partitioning would change reduction orders, i.e. bits), so
        they route through the local executor; the remaining rows keep
        the frozen main geometry.  Outputs merge order-preserving."""
        lg = self.layer_graphs[l]
        n_main = self.n_main
        if lg.n_nodes > n_main:
            touches = rows >= n_main
            if rows.size:
                touches = touches | (
                    (lg.nbr[rows] >= n_main) & lg.mask[rows]).any(axis=1)
            if touches.any():
                tail_rows = rows[touches]
                main_rows = rows[~touches]
                self.n_tail_routed += int(tail_rows.size)
                with obs.span("refresh.route") as sp:
                    if sp:
                        sp.set(route="tail-local", layer=l,
                               rows=int(tail_rows.size), n_main=n_main)
                h_tail = self._layer_rows_single(
                    l, tail_rows, read_level, self._local_executor())
                if main_rows.size == 0:
                    return h_tail
                h_main = self._layer_rows_dist_main(
                    l, main_rows, read_level, ex)
                out = np.empty((rows.size, h_tail.shape[1]), h_tail.dtype)
                out[touches] = h_tail
                out[~touches] = h_main
                return out
        return self._layer_rows_dist_main(l, rows, read_level, ex)

    def _layer_rows_dist_main(self, l: int, rows: np.ndarray, read_level,
                              ex) -> np.ndarray:
        lg = self.layer_graphs[l]
        spec = self.spec
        layer = spec.layers[l]
        nbrs = lg.nbr[rows][lg.mask[rows]]
        U = np.unique(np.concatenate([rows, nbrs.astype(np.int64)]))
        if self.local_cutover and U.size < self.local_cutover:
            # tiny frontier: the mesh's messages and a cold subset plan
            # cost more than computing it on one device
            self.n_local_cutovers += 1
            with obs.span("refresh.route") as sp:
                if sp:
                    sp.set(route="local", layer=l,
                           rows=int(rows.size), universe=int(U.size),
                           threshold=self.local_cutover)
            return self._layer_rows_single(l, rows, read_level,
                                           self._local_executor())
        self.n_dist_layers += 1
        if self.local_cutover:
            with obs.span("refresh.route") as sp:
                if sp:
                    sp.set(route="dist", layer=l,
                           rows=int(rows.size),
                           universe=int(U.size),
                           threshold=self.local_cutover)
        h, take, n_src = ex.run_rows(
            layer, lg, rows, read_level, l, spec.heads,
            n_nodes=self.n_main if lg.n_nodes > self.n_main else None)
        self.rows_gemm += n_src
        if l < self.n_layers - 1:
            h = spec.activation(h)
        # the copy to the host waits for every shard's stream
        return h.to_global("cpu").numpy()[take]

    def _layer_rows_single(self, l: int, rows: np.ndarray, read_level,
                           ex) -> np.ndarray:
        """Single-device layer body.  Row/universe counts are padded to
        power-of-two buckets, as in the JAX package (see ``_pow2``).
        Padding rows repeat a real row with an all-False mask, so real
        rows stay bitwise-identical and the pad is sliced off on return.
        """
        lg = self.layer_graphs[l]
        L = self.n_layers
        spec = self.spec
        layer = spec.layers[l]

        F = lg.fanout
        nbrs = lg.nbr[rows][lg.mask[rows]]
        U = np.unique(np.concatenate([rows, nbrs.astype(np.int64)]))

        R, Rp = rows.size, _pow2(rows.size)
        Up = _pow2(U.size)
        # FUSED id translation: instead of densely remapping every
        # neighbor slot onto universe positions (an O(R*F log U)
        # searchsorted), hand the executor the GLOBAL neighbor ids plus
        # a scratch table with table[U] = universe positions — the
        # translation rides the layer's gather (the gather_spmm kernel on
        # the cuda executor, a lazy index on ref).  Ids outside U (stale masked
        # slots, pad rows) read the scratch's resting 0, exactly the
        # position-0 pin `_remap` applied, so the bits cannot change.
        table = self._scratch_table(lg.nbr.shape[0])
        table[U] = np.arange(U.size, dtype=np.int32)
        nbr_np = np.zeros((Rp, F), np.int32)
        nbr_np[:R] = lg.nbr[rows]
        mask_np = np.zeros((Rp, F), bool)
        mask_np[:R] = lg.mask[rows]
        # pad with rows already being read (NOT row 0): on a budgeted
        # store a pad id pointing at an evicted row would trigger a
        # spurious recompute; pad values never reach real outputs
        rows_p = np.concatenate([rows, np.full(Rp - R, rows[0], np.int64)])
        U_p = np.concatenate([U, np.full(Up - U.size, U[0], np.int64)])
        self.rows_gemm += int(U.size)

        dev = ex.device
        try:
            io = DenseIO(nbr_np, mask_np, table=table, device=dev)
            h_src = torch.as_tensor(read_level(l, U_p), device=dev)
            h_tgt = lambda: torch.as_tensor(  # noqa: E731
                read_level(l, rows_p), device=dev)
            h = run_layer(ex, layer, io, h_tgt, h_src, spec.heads)
            if l < L - 1:
                h = spec.activation(h)
            # the copy back to the host waits for the device's stream
            out = h[:R].cpu().numpy()
        finally:
            # reset AFTER the compute is done: torch.as_tensor aliases
            # the scratch buffer on the CPU, so an early reset would
            # corrupt the very table the ops are reading
            table[U] = 0
            self._table_pool.append(table)
        return out

    # -- row-level recompute (decoupled from mutation batches) ----------
    def recompute_rows(self, store: EmbeddingStore, level: int,
                       ids: np.ndarray, *, staged: bool = False
                       ) -> np.ndarray:
        """Rebuild store level ``level`` (1..L) for ``ids`` from the
        lowest resident levels: one ``_layer_rows`` pass whose inputs
        read through the store — a non-resident input row recurses into
        the store's own recompute-on-miss path, terminating at level 0
        (the pinned features).  Bitwise-equal to the rows a never-evicted
        store would hold, because it is the SAME executor, reduction
        order, and activation as the epoch that produced them.

        ``staged=True`` reads through the open overlay (a mid-refresh
        miss); with ``staged=False`` between ``resample_rows`` and
        ``commit`` the result is undefined for frontier rows — the
        single-threaded engine never does that.
        """
        assert 1 <= level <= self.n_layers, level
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return np.empty((0, store.level_dim(level)), np.float32)
        assert ids.size == 1 or (np.diff(ids) > 0).all(), \
            "ids must be sorted unique (the frontier-split plans need it)"
        read = (store.lookup_staged if staged else
                lambda want, lvl: store._gather(
                    np.asarray(want, np.int64), lvl, staged=False))
        return self._layer_rows(level - 1, ids,
                                lambda lvl, want: read(want, lvl))

    # -- the refresh ----------------------------------------------------
    def begin_refresh(self, store: EmbeddingStore, g_new: Graph,
                      feat_ids: np.ndarray, feat_rows: np.ndarray,
                      resampled: np.ndarray, *, chunk_rows: int = 0
                      ) -> "RefreshJob":
        """Open an incremental refresh: run the cheap prologue eagerly
        (resample dirty rows, splice reverse indexes, walk the forward
        frontier, open the staging overlay, write feature rows) and
        return a :class:`RefreshJob` whose ``step()`` calls run the
        frontier compute one row chunk at a time.  Nothing is visible to
        readers until ``finish()`` commits.

        Chunking is bitwise-invariant: a row's output depends only on
        its own (already fully written) lower level, never on which rows
        share the batch, and the content-addressed resample seeds carry
        no chunk/batch term — so any ``chunk_rows`` produces the exact
        bits of the one-shot :meth:`refresh`.
        """
        resampled = np.asarray(resampled, np.int64)
        feat_ids = np.asarray(feat_ids, np.int64)
        self.rows_gemm = 0

        # snapshot the rows about to be resampled so a failed refresh can
        # roll the layer graphs back in lockstep with the store abort —
        # otherwise graphs and store drift apart and the skipped rows
        # never re-enter a frontier
        old_rows = ([(lg.nbr[resampled].copy(), lg.mask[resampled].copy())
                     for lg in self.layer_graphs]
                    if resampled.size else None)
        try:
            # content-addressed seeding (no version term): the draw for a
            # row depends only on its final CSR state, so refresh
            # batching never changes the bits (see resample_rows)
            with obs.span("refresh.resample") as sp:
                resample_rows(g_new, self.layer_graphs, resampled,
                              seed=self.sample_seed)
                if sp:
                    sp.set(rows=int(resampled.size))
            if resampled.size:
                # incremental maintenance: splice only the resampled
                # rows' old/new entries into each cached reverse index —
                # O(changed spans), not the O(N*F) rebuild
                for l, lg in enumerate(self.layer_graphs):
                    if self._rev[l] is not None:
                        old_nbr_l, old_mask_l = old_rows[l]
                        self._rev[l] = splice_reverse_index(
                            self._rev[l], resampled, old_nbr_l, old_mask_l,
                            lg.nbr[resampled], lg.mask[resampled])
                        self.rev_splices += 1
            with obs.span("refresh.frontier") as sp:
                frontier = forward_frontier(
                    [self._reverse(l) for l in range(self.n_layers)],
                    feat_ids, resampled, self.n_layers)
                if sp:
                    sp.set(rows=int(sum(f.size for f in frontier)))

            store.begin_update()
            if feat_ids.size:
                store.write_rows(0, feat_ids,
                                 np.asarray(feat_rows, np.float32))
            for l in range(self.n_layers):
                obs.add("delta.frontier_rows", frontier[l].size)
        except Exception:
            store.abort()       # readers stay on the last committed epoch
            if old_rows is not None:
                for lg, (nbr, mask) in zip(self.layer_graphs, old_rows):
                    lg.nbr[resampled] = nbr
                    lg.mask[resampled] = mask
                    # the failed refresh may have cached frontier plans
                    # over the now-rolled-back samples
                    invalidate_subset_plans(lg)
                self._rev = [None] * len(self.layer_graphs)
            raise
        return RefreshJob(self, store, frontier, chunk_rows,
                          resampled=resampled, feat_ids=feat_ids,
                          old_rows=old_rows)

    def refresh(self, store: EmbeddingStore, g_new: Graph,
                feat_ids: np.ndarray, feat_rows: np.ndarray,
                resampled: np.ndarray) -> Dict[str, float]:
        """Apply one mutation batch's compute in one shot: resample dirty
        rows of the layer graphs from `g_new`, walk the forward frontier,
        and rewrite only those store rows.  Commits a new store version.
        Equivalent to draining a :meth:`begin_refresh` job inline."""
        job = self.begin_refresh(store, g_new, feat_ids, feat_rows,
                                 resampled)
        while not job.done:
            job.step()
        return job.finish()


class RefreshJob:
    """One in-flight incremental refresh, split into schedulable chunks.

    The worklist is ordered: layer l+1's frontier reads layer l's staged
    rows through the overlay, so layers cannot interleave — but WITHIN a
    layer each output row depends only on its own inputs, never on its
    chunk-mates, so a layer's frontier splits freely into row chunks.

    Lifecycle: ``step()`` until ``done``, then ``finish()`` to commit;
    ``abort()`` (called automatically if a step raises) rolls the store
    AND the layer-graph resamples back so readers stay on the last
    committed epoch.  ``hold_rows`` is the top-level frontier — the
    monotone superset of every dirty row — which the engine uses to
    fence recompute-on-miss gathers off rows whose graph state is
    mid-flight (recompute through a resampled row before commit would
    replay the wrong neighborhood).
    """

    def __init__(self, reinfer: DeltaReinference, store: EmbeddingStore,
                 frontier: List[np.ndarray], chunk_rows: int, *,
                 resampled: np.ndarray, feat_ids: np.ndarray, old_rows):
        self.reinfer = reinfer
        self.store = store
        self.frontier = frontier
        self._resampled = resampled
        self._feat_ids = feat_ids
        self._old_rows = old_rows
        self.chunk_rows = int(chunk_rows)
        self._work: List[tuple] = []
        for l, rows in enumerate(frontier):
            if rows.size == 0:
                continue
            step = self.chunk_rows if self.chunk_rows > 0 else int(rows.size)
            for lo in range(0, int(rows.size), step):
                self._work.append((l, lo, min(lo + step, int(rows.size))))
        self._idx = 0
        self.n_chunks = len(self._work)
        self.rows_gemm = 0
        self.hold_rows = (frontier[-1] if frontier
                          else np.empty(0, np.int64))
        self._dead = False

    @property
    def done(self) -> bool:
        return self._idx >= self.n_chunks

    def step(self) -> Dict[str, int]:
        """Run one chunk against the staging overlay.  On any failure the
        whole job aborts (store + layer graphs roll back) and re-raises."""
        assert not self._dead, "job already finished/aborted"
        assert not self.done, "no chunks left; call finish()"
        l, lo, hi = self._work[self._idx]
        rows = self.frontier[l][lo:hi]
        ri = self.reinfer
        before = ri.rows_gemm
        try:
            with obs.span("refresh.layer") as sp:
                with obs.span("refresh.chunk") as csp:
                    h = ri._layer_rows(
                        l, rows,
                        lambda lvl, want: self.store.lookup_staged(
                            want, lvl))
                    self.store.write_rows(l + 1, rows, h)
                    if csp:
                        csp.set(layer=l, rows=int(rows.size),
                                chunk=self._idx, n_chunks=self.n_chunks)
                if sp:
                    sp.set(layer=l, rows=int(rows.size))
        except Exception:
            self.abort()
            raise
        self._idx += 1
        # per-chunk work delta off the instance counter, so concurrent
        # recompute-on-miss traffic between chunks doesn't pollute the
        # job's own accounting
        done_gemm = ri.rows_gemm - before
        self.rows_gemm += done_gemm
        return {"layer": l, "rows": int(rows.size),
                "rows_gemm": int(done_gemm),
                "chunk": self._idx, "n_chunks": self.n_chunks}

    def finish(self) -> Dict[str, float]:
        assert not self._dead, "job already finished/aborted"
        assert self.done, "chunks remain; step() until done"
        self._dead = True
        version = self.store.commit()
        ri = self.reinfer
        return {"version": version, "rows_gemm": self.rows_gemm,
                "frontier_sizes": [int(f.size) for f in self.frontier],
                "n_resampled": int(self._resampled.size),
                "n_feat_updates": int(self._feat_ids.size),
                "n_chunks": self.n_chunks,
                "rev_splices": ri.rev_splices,
                "rev_rebuilds": ri.rev_rebuilds,
                "local_cutover": ri.local_cutover,
                "n_local_cutovers": ri.n_local_cutovers,
                "n_dist_layers": ri.n_dist_layers,
                "n_tail_routed": ri.n_tail_routed}

    def abort(self) -> None:
        """Roll back the staged update and the layer-graph resamples."""
        if self._dead:
            return
        self._dead = True
        self.store.abort()      # readers stay on the last committed epoch
        ri = self.reinfer
        if self._old_rows is not None:
            for lg, (nbr, mask) in zip(ri.layer_graphs, self._old_rows):
                lg.nbr[self._resampled] = nbr
                lg.mask[self._resampled] = mask
                # the failed refresh may have cached frontier plans
                # over the now-rolled-back samples
                invalidate_subset_plans(lg)
            ri._rev = [None] * len(ri.layer_graphs)


# ----------------------------------------------------------------------
# recompute-on-miss: the store's eviction escape hatch
# ----------------------------------------------------------------------

class RecomputeOnMiss:
    """Binds a ``DeltaReinference`` to a memory-budgeted store as its
    recompute hook: a ``lookup`` (or mid-refresh ``lookup_staged``) that
    touches evicted rows rebuilds exactly those rows through the bound
    executor and re-admits them.

        store = store_from_inference(X, levels[1:], budget_rows=cap)
        store.recompute = RecomputeOnMiss(ri, store)

    The reinference instance must be the one whose layer graphs track the
    store's epochs (the engine's ``reinfer``) — recompute replays the
    CURRENT layer graphs, which is only bitwise-faithful for rows whose
    graph rows match the committed epoch (always true outside a refresh,
    and true for every non-frontier row inside one).
    """

    def __init__(self, reinfer: DeltaReinference, store: EmbeddingStore):
        self.reinfer = reinfer
        self.store = store

    def __call__(self, level: int, ids: np.ndarray,
                 staged: bool) -> np.ndarray:
        return self.reinfer.recompute_rows(self.store, level, ids,
                                           staged=staged)


def attach_recompute(store: EmbeddingStore,
                     reinfer: DeltaReinference) -> EmbeddingStore:
    """Convenience wiring used by the launchers and benches."""
    store.recompute = RecomputeOnMiss(reinfer, store)
    return store
