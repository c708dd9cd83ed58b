"""Versioned, partition-sharded embedding store with double-buffered swap
and a per-level memory budget (heat/LRU shard eviction, recompute-on-miss)
— the port's copy of ``repro.gnnserve.store`` (numpy; the policies
register into the port's own registries).

The store holds the layerwise engine's output at every level: level 0 is
the raw feature matrix X, level l (1..L) is the INPUT of layer l+1 (i.e.
post-activation for inner layers) and level L is the final embedding —
exactly the tensors ``delta.DeltaReinference`` needs to restart compute
at any layer.  Rows are sharded into P contiguous partitions mirroring
``core.partition``'s 1-D node ranges, so a production deployment maps one
shard per host.

Writers never touch what readers see: ``begin_update`` opens a staging
overlay, ``write_rows`` copies-on-write only the shards it dirties, and
``commit`` swaps the dirty shards in atomically and bumps ``version``
(the double-buffered epoch swap).  ``lookup`` always reads the committed
front; ``lookup_staged`` reads through the overlay (read-your-writes for
the delta engine mid-refresh).

Memory model (the production constraint every full-graph system hits):
``budget_rows`` caps the resident rows of EVERY evictable level (1..L;
level 0 — the features — is pinned, it is the ground truth nothing can
rebuild).  Each (level, shard) keeps a row-level residency bitmap next
to its array; ``evict`` drops a whole shard's array and replaces the
bitmap with a fresh all-False one (snapshots holding the old array+bitmap
pair keep serving it — eviction never writes in place).  A ``lookup``
that touches non-resident rows no longer asserts: it routes the exact
missing row ids through the ``recompute`` hook (``delta.RecomputeOnMiss``
— level-l rows rebuilt from the lowest resident level through the bound
executor, bitwise-equal to a never-evicted store), re-admits them into
the shard, and charges the budget.  Victims are chosen by ``evict_policy``
— a REGISTERED policy name (``api.registry.EVICT_POLICIES``; built-ins
``"heat"``, exponentially-decayed access mass, and ``"lru"``, last-touch
tick, register themselves below), as is ``admission``.  Budget enforcement runs only at the END of a top-level gather /
commit, never mid-recursion, so a recompute can't evict rows it is about
to read.  Admission is scan-resistant by default (``admission=
"probation"``): rows admitted via recompute-on-miss contribute NO heat
until they are touched a second time, so a one-shot full scan cannot
displace the hot working set (``admission="full"`` restores the old
count-every-touch behavior).

Snapshot-vs-eviction ordering: ``pinned_snapshot(ids, level)`` admits any
missing rows FIRST (with enforcement suppressed), captures the shard
array+bitmap pointers, and only then lets the budget evict — so a
mid-query eviction (or a later epoch commit) can never tear a pinned
response.  A plain ``snapshot()`` pins whatever is resident; reading rows
it never pinned falls back to the store while the epoch still matches and
raises ``SnapshotMiss`` after the epoch has moved on (recompute against a
mutated graph could not reproduce the old epoch).

Incremental node onboarding (``onboarding="tail"``): ``append_tail``
adds brand-new nodes as ONE extra shard past the main 1-D partitioning
(features resident, upper levels written by the onboarding delta
refresh); the tail rides budgets/eviction like any shard until
``EmbeddingServeEngine.full_epoch`` folds it back in.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.api.registry import (ADMISSIONS, EVICT_POLICIES,
                                      register_admission,
                                      register_evict_policy)


# ----------------------------------------------------------------------
# registered eviction / admission policies ("heat"/"lru" and
# "probation"/"full" are defaults, not special cases — third parties add
# names via api.registry and select them from StoreSpec)
# ----------------------------------------------------------------------

@register_evict_policy("heat")
def _heat_policy(store: "EmbeddingStore", level: int):
    """Evict the shard with the least exponentially-decayed access mass
    (ties: least-recent, then lowest id)."""
    return lambda s: (store._heat_now(level, s),
                      int(store._last[level, s]), s)


@register_evict_policy("lru")
def _lru_policy(store: "EmbeddingStore", level: int):
    """Evict the least-recently-touched shard."""
    return lambda s: (int(store._last[level, s]), s)


@register_admission("probation")
def _probation_admission(local: np.ndarray,
                         admitted: Optional[np.ndarray]) -> int:
    """Scan resistance: recompute-admitted rows are on probation — the
    admitting touch adds NO heat (any later touch is a hit and counts in
    full), so a one-shot scan leaves its shards stone-cold and the hot
    working set survives the eviction round."""
    if admitted is None or admitted.size == 0:
        return local.size
    return int((~np.isin(local, admitted)).sum())


@register_admission("full")
def _full_admission(local: np.ndarray,
                    admitted: Optional[np.ndarray]) -> int:
    """Count every touch, including the admitting one (the pre-probation
    behavior; scannable)."""
    return local.size


class EvictedRowMiss(RuntimeError):
    """A gather touched evicted rows and no ``recompute`` hook is bound."""


class SnapshotMiss(RuntimeError):
    """A snapshot read touched rows it never pinned, after the store's
    epoch moved on — the old epoch is not reconstructible."""


class StoreSnapshot:
    """Immutable view of one committed epoch.  Shard arrays AND residency
    bitmaps are shared by pointer with the store's front buffer at
    snapshot time; commits and evictions swap pointers (never write in
    place), so reads through a snapshot keep seeing one consistent epoch
    for free.  Rows admitted into a pinned shard later are same-epoch by
    construction (dirty rows always land in swapped shards), so the
    snapshot only ever GAINS rows."""

    def __init__(self, store: "EmbeddingStore"):
        self._front = [list(shards) for shards in store._front]
        self._mask = [list(masks) for masks in store._mask]
        self.bounds = store.bounds
        self.version = store.version
        self._store = store

    def lookup(self, ids: np.ndarray, level: int = -1) -> np.ndarray:
        level = level % len(self._front)
        ids = np.asarray(ids, np.int64)
        st = self._store
        st.n_lookups += 1
        st.rows_gathered += int(ids.size)
        _check_ids(ids, self.bounds)
        out = np.empty((ids.size, st.level_dim(level)), np.float32)
        missing = np.zeros(ids.size, bool)
        owner = np.searchsorted(self.bounds, ids, side="right") - 1
        for s in np.unique(owner):
            sel = owner == s
            local = ids[sel] - self.bounds[s]
            data, mask = self._front[level][s], self._mask[level][s]
            if data is None:
                missing |= sel
                continue
            have = mask[local]
            if have.all():
                out[sel] = data[local]
            else:
                got = np.zeros((local.size, out.shape[1]), np.float32)
                got[have] = data[local[have]]
                out[sel] = got
                miss_sel = sel.copy()
                miss_sel[sel] = ~have
                missing |= miss_sel
        if missing.any():
            if self.version != st.version:
                raise SnapshotMiss(
                    "snapshot read touched rows that were never pinned and "
                    "the store's epoch has advanced; pin the query's rows "
                    "with pinned_snapshot(ids, level) before the commit")
            # same epoch: serve the stragglers through the store (admits
            # them via recompute-on-miss and charges the budget)
            out[missing] = st._gather(ids[missing], level, staged=False)
        return out


def _check_ids(ids: np.ndarray, bounds: np.ndarray) -> None:
    assert ids.size == 0 or (ids.min() >= 0 and ids.max() < bounds[-1]), \
        "node id out of range"      # a negative id would silently wrap


class EmbeddingStore:
    def __init__(self, levels: Sequence[np.ndarray], n_shards: int = 4,
                 *, budget_rows: Optional[int] = None,
                 evict_policy: str = "heat", heat_decay: float = 0.98,
                 admission: str = "probation", onboarding: str = "none"):
        n = levels[0].shape[0]
        assert all(h.shape[0] == n for h in levels), "levels must cover all nodes"
        # eager registry resolution: a typo'd policy name fails at build
        # time with every registered name in the error
        self._victim_policy = EVICT_POLICIES.get(evict_policy)
        self._admit_policy = ADMISSIONS.get(admission)
        assert onboarding in ("none", "tail"), onboarding
        assert budget_rows is None or budget_rows >= 0
        self.n_nodes = n
        self.n_shards = n_shards
        self.bounds = np.linspace(0, n, n_shards + 1).astype(np.int64)
        self._shard_rows = np.diff(self.bounds)
        self._dims = [int(h.shape[1]) for h in levels]
        # front[level][shard] -> (rows, D_level) float32 | None (evicted)
        self._front: List[List[Optional[np.ndarray]]] = [
            [np.ascontiguousarray(h[self.bounds[s]:self.bounds[s + 1]],
                                  dtype=np.float32)
             for s in range(n_shards)]
            for h in levels]
        # residency bitmap per (level, shard); evict swaps in a NEW
        # all-False array so pinned snapshots keep the old pair
        self._mask: List[List[np.ndarray]] = [
            [np.ones(int(self._shard_rows[s]), bool)
             for s in range(n_shards)]
            for _ in levels]
        # bitmap popcounts, maintained incrementally: budget enforcement
        # runs after every top-level gather and must not rescan
        # O(n_levels * n_nodes) bitmap bytes each time
        self._res = np.tile(self._shard_rows, (len(levels), 1))
        # staging overlay: {(level, shard): array (+ bitmap)}; None when
        # no update open
        self._staged: Optional[Dict[tuple, np.ndarray]] = None
        self._staged_mask: Optional[Dict[tuple, np.ndarray]] = None
        # memory budget + shard heat (eviction policy inputs)
        self.budget_rows = budget_rows
        self.evict_policy = evict_policy
        self.heat_decay = heat_decay
        self.admission = admission
        self.onboarding = onboarding
        self.n_tail_shards = 0      # appended-but-not-yet-folded shards
        self._heat = np.zeros((len(levels), n_shards))
        self._last = np.zeros((len(levels), n_shards), np.int64)
        self._tick = 0
        self._gather_depth = 0
        self._recompute_depth = 0
        # recompute-on-miss hook: (level, sorted-unique global ids,
        # staged) -> (len(ids), D_level) rows, bitwise-equal to what a
        # never-evicted store would hold for that view
        self.recompute: Optional[Callable] = None
        self.version = 0
        self.n_lookups = 0
        self.rows_gathered = 0
        self.n_swaps = 0
        self.hits = 0               # rows served from resident shards
        self.misses = 0             # rows that had to be recomputed
        self.n_evictions = 0        # shards dropped
        self.rows_evicted = 0
        self.n_recomputes = 0       # hook invocations (nested included)
        self.n_recompute_spans = 0  # outermost invocations (timed ones)
        self.rows_recomputed = 0
        self.recompute_s = 0.0      # cumulative outermost wall time
        self._enforce_budget()      # a tight budget evicts at build time

    @property
    def n_levels(self) -> int:
        return len(self._front)

    def level_dim(self, level: int) -> int:
        return self._dims[level]

    # -- read path ------------------------------------------------------
    def _owner(self, ids: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.bounds, ids, side="right") - 1

    def _view_shard(self, level: int, s: int, staged: bool):
        key = (level, s)
        if staged and self._staged is not None and key in self._staged:
            return self._staged[key], self._staged_mask[key]
        return self._front[level][s], self._mask[level][s]

    def _materialize_staged(self, level: int, s: int):
        """Copy-on-write a shard into the open overlay (write or
        staged-miss admission; the front must stay untouched so an abort
        is a pure pointer drop)."""
        key = (level, s)
        if key not in self._staged:
            data = self._front[level][s]
            self._staged[key] = (data.copy() if data is not None else
                                 np.zeros((int(self._shard_rows[s]),
                                           self._dims[level]), np.float32))
            self._staged_mask[key] = self._mask[level][s].copy()
        return self._staged[key], self._staged_mask[key]

    def _ensure(self, level: int, s: int, local: np.ndarray, staged: bool):
        """Make ``local`` rows of (level, shard) resident in the given
        view, recomputing misses through the hook.  Returns
        (data, mask, admitted-local-ids-or-None)."""
        data, mask = self._view_shard(level, s, staged)
        have = mask[local] if data is not None else np.zeros(local.size, bool)
        n_hit = int(have.sum())
        self.hits += n_hit
        self.misses += local.size - n_hit
        if obs.enabled():
            obs.add("store.hits", n_hit)
            obs.add("store.misses", local.size - n_hit)
        if n_hit == local.size:
            return data, mask, None
        need = np.unique(local[~have])
        if self.recompute is None:
            raise EvictedRowMiss(
                f"level {level} shard {s}: {need.size} rows not resident "
                "and no recompute hook bound (store.recompute — see "
                "gnnserve.delta.RecomputeOnMiss)")
        assert level > 0, "level 0 (features) must never be evicted"
        t0 = time.perf_counter()
        self._recompute_depth += 1
        try:
            with obs.span("store.recompute") as rsp:
                rows = np.asarray(
                    self.recompute(level, need + self.bounds[s], staged),
                    np.float32)
                if rsp:
                    rsp.set(level=level, shard=s, rows=int(need.size))
        finally:
            self._recompute_depth -= 1
        if self._recompute_depth == 0:
            # outermost calls only: nested recursion (lower-level inputs
            # rebuilt on the way) is already inside this wall time —
            # per-recompute latency is recompute_s / n_recompute_spans
            self.recompute_s += time.perf_counter() - t0
            self.n_recompute_spans += 1
        self.n_recomputes += 1
        self.rows_recomputed += int(need.size)
        if obs.enabled():
            obs.add("store.recomputes")
            obs.add("store.rows_recomputed", need.size)
        if staged and self._staged is not None:
            # an overlay read must never leak in-progress values into the
            # committed front (an abort would leave them behind) — admit
            # into a copy-on-write staged shard instead
            data, mask = self._materialize_staged(level, s)
        else:
            if data is None:
                data = np.zeros((int(self._shard_rows[s]),
                                 self._dims[level]), np.float32)
                self._front[level][s] = data
            self._res[level, s] += need.size        # front admission
        data[need] = rows
        mask[need] = True
        return data, mask, need

    def _gather(self, ids: np.ndarray, level: int,
                staged: bool) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        _check_ids(ids, self.bounds)
        self._tick += 1
        out = np.empty((ids.size, self._dims[level]), np.float32)
        owner = self._owner(ids)
        self._gather_depth += 1
        try:
            with obs.span("store.gather") as gsp:
                for s in np.unique(owner):
                    sel = owner == s
                    local = ids[sel] - self.bounds[s]
                    data, mask, admitted = self._ensure(level, int(s),
                                                        local, staged)
                    out[sel] = data[local]
                    # the registered admission policy decides how much
                    # heat this touch contributes (_probation_admission)
                    w = (self._admit_policy(local, admitted)
                         if level > 0 and not staged else local.size)
                    self._heat[level, s] = self._heat_now(level, int(s)) + w
                    self._last[level, s] = self._tick
                if gsp:
                    gsp.set(rows=int(ids.size), level=level,
                            staged=staged)
        finally:
            self._gather_depth -= 1
        if self._gather_depth == 0:
            self._enforce_budget()
        return out

    def lookup(self, ids: np.ndarray, level: int = -1) -> np.ndarray:
        """Committed (front-buffer) rows; what the serve engine reads.
        Non-resident rows are rebuilt through the recompute hook."""
        level = level % self.n_levels
        self.n_lookups += 1
        self.rows_gathered += int(np.asarray(ids).size)
        return self._gather(ids, level, staged=False)

    def lookup_staged(self, ids: np.ndarray, level: int = -1) -> np.ndarray:
        """Read-through the open staging overlay (delta refresh only).
        Misses are admitted into copy-on-write staged shards, never the
        front — an abort discards them with the rest of the overlay."""
        return self._gather(ids, level % self.n_levels, staged=True)

    def snapshot(self) -> StoreSnapshot:
        """Pin the current committed epoch (cheap: pointer copies)."""
        return StoreSnapshot(self)

    def ensure_resident(self, ids: np.ndarray, level: int = -1) -> None:
        """Admit any non-resident rows of ``ids`` (recompute-on-miss)."""
        self._gather(np.asarray(ids, np.int64), level % self.n_levels,
                     staged=False)

    def pinned_snapshot(self, ids: np.ndarray, level: int = -1
                        ) -> StoreSnapshot:
        """Admit ``ids`` at ``level`` and pin the epoch in one step:
        budget enforcement is suppressed until AFTER the snapshot captures
        the shard pointers, so an eviction racing the pin can never drop
        rows the snapshot is about to serve."""
        self._gather_depth += 1
        try:
            self._gather(np.asarray(ids, np.int64),
                         level % self.n_levels, staged=False)
            snap = StoreSnapshot(self)
        finally:
            self._gather_depth -= 1
        self._enforce_budget()
        return snap

    # -- incremental node onboarding (tail partition) -------------------
    def append_tail(self, n_new: int,
                    feat_rows: Optional[np.ndarray] = None) -> np.ndarray:
        """Append a TAIL PARTITION of ``n_new`` brand-new nodes: one
        extra shard covering [n, n + n_new), so node additions serve via
        delta refresh instead of forcing an offline re-partition.

        Level 0 (features) becomes resident immediately — ``feat_rows``
        or zeros.  Levels 1..L start NON-resident: the onboarding delta
        refresh (which always carries the new ids in its resampled set)
        writes them through the staging overlay before any read, layer
        by layer.  The tail then behaves like any other shard — budget
        enforcement, eviction, recompute-on-miss — until a full epoch
        folds it into the main 1-D partitioning
        (``EmbeddingServeEngine.full_epoch``).  Returns the new ids."""
        assert self._staged is None, \
            "no update may be open across a tail append"
        assert n_new > 0
        # validate the features BEFORE touching any store state: a bad
        # shape must fail with the store untouched (the engine's
        # rollback assumes append_tail is all-or-nothing)
        feat = np.zeros((n_new, self._dims[0]), np.float32)
        if feat_rows is not None:
            feat_rows = np.asarray(feat_rows, np.float32)
            assert feat_rows.shape == (n_new, self._dims[0]), \
                (f"tail features must be ({n_new}, {self._dims[0]}), "
                 f"got {feat_rows.shape}")
            feat[:] = feat_rows
        n0 = self.n_nodes
        self.n_nodes = n0 + int(n_new)
        self.bounds = np.concatenate(
            [self.bounds, [self.n_nodes]]).astype(np.int64)
        self._shard_rows = np.diff(self.bounds)
        self._front[0].append(feat)
        self._mask[0].append(np.ones(n_new, bool))
        for level in range(1, self.n_levels):
            self._front[level].append(None)
            self._mask[level].append(np.zeros(n_new, bool))
        res_col = np.zeros((self.n_levels, 1), self._res.dtype)
        res_col[0, 0] = n_new
        self._res = np.concatenate([self._res, res_col], axis=1)
        self._heat = np.concatenate(
            [self._heat, np.zeros((self.n_levels, 1))], axis=1)
        self._last = np.concatenate(
            [self._last, np.full((self.n_levels, 1), self._tick,
                                 np.int64)], axis=1)
        self.n_shards += 1
        self.n_tail_shards += 1
        return np.arange(n0, self.n_nodes, dtype=np.int64)

    def pop_tail(self, n_new: int) -> None:
        """Inverse of ``append_tail`` — the engine's rollback when the
        onboarding refresh fails.  Only valid while the appended tail is
        still the LAST shard and no update is open."""
        assert self._staged is None, "abort the open update first"
        assert self.n_tail_shards > 0 and self._shard_rows[-1] == n_new, \
            "pop_tail must exactly undo the last append_tail"
        self.n_nodes -= int(n_new)
        self.bounds = self.bounds[:-1]
        self._shard_rows = np.diff(self.bounds)
        for level in range(self.n_levels):
            self._front[level].pop()
            self._mask[level].pop()
        self._res = self._res[:, :-1]
        self._heat = self._heat[:, :-1]
        self._last = self._last[:, :-1]
        self.n_shards -= 1
        self.n_tail_shards -= 1

    # -- eviction -------------------------------------------------------
    def _heat_now(self, level: int, s: int) -> float:
        return float(self._heat[level, s]
                     * self.heat_decay ** (self._tick - self._last[level, s]))

    def resident_rows(self, level: int) -> int:
        return int(self._res[level].sum())

    def evict(self, level: int, s: int) -> int:
        """Drop one shard's array; the residency bitmap is REPLACED with
        a fresh all-False one (snapshots keep the old array+bitmap pair).
        Level 0 is pinned.  Returns the number of rows evicted."""
        level = level % self.n_levels
        assert level > 0, "level 0 (features) is pinned"
        if self._front[level][s] is None:
            return 0
        n = int(self._res[level, s])
        with obs.span("store.evict") as sp:
            self._front[level][s] = None
            self._mask[level][s] = np.zeros(int(self._shard_rows[s]),
                                            bool)
            self._res[level, s] = 0
            self._heat[level, s] = 0.0
            if sp:
                sp.set(level=level, shard=s, rows=n)
                obs.add("store.evictions")
                obs.add("store.rows_evicted", n)
        self.n_evictions += 1
        self.rows_evicted += n
        return n

    def _victim_key(self, level: int):
        return self._victim_policy(self, level)

    def _enforce_budget(self) -> None:
        if self.budget_rows is None:
            return
        for level in range(1, self.n_levels):
            total = int(self._res[level].sum())
            while total > self.budget_rows:
                cand = [s for s in range(self.n_shards)
                        if self._res[level, s] > 0]
                victim = min(cand, key=self._victim_key(level))
                total -= self.evict(level, victim)

    # -- write path -----------------------------------------------------
    def begin_update(self) -> None:
        assert self._staged is None, "update already open"
        self._staged = {}
        self._staged_mask = {}

    def write_rows(self, level: int, ids: np.ndarray, rows: np.ndarray) -> None:
        assert self._staged is not None, "begin_update first"
        level = level % self.n_levels
        ids = np.asarray(ids, np.int64)
        owner = self._owner(ids)
        for s in np.unique(owner):
            data, mask = self._materialize_staged(level, int(s))
            sel = owner == s
            local = ids[sel] - self.bounds[s]
            data[local] = rows[sel]
            mask[local] = True

    def commit(self) -> int:
        """Swap dirtied shards into the front buffer; readers see the new
        epoch atomically (per-shard pointer swap, no row copies)."""
        assert self._staged is not None, "no update open"
        for (level, s), shard in self._staged.items():
            self._front[level][s] = shard
            self._mask[level][s] = self._staged_mask[(level, s)]
            # popcount only the swapped (dirty) shards
            self._res[level, s] = int(self._mask[level][s].sum())
        self._staged = None
        self._staged_mask = None
        self.version += 1
        self.n_swaps += 1
        self._enforce_budget()
        return self.version

    def abort(self) -> None:
        self._staged = None
        self._staged_mask = None

    # -- diagnostics ----------------------------------------------------
    def memory_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-level residency: rows resident, bytes resident, and budget
        utilization (1.0 == at budget; level 0 reports util 0, pinned)."""
        out = {}
        for level in range(self.n_levels):
            res = self.resident_rows(level)
            cap = (self.budget_rows if (self.budget_rows is not None
                                        and level > 0) else self.n_nodes)
            out[f"level{level}"] = {
                "resident_rows": res,
                "total_rows": self.n_nodes,
                "resident_bytes": res * self._dims[level] * 4,
                "budget_rows": cap,
                "budget_util": res / max(cap, 1) if level > 0 else 0.0,
            }
        return out

    def stats(self) -> Dict[str, float]:
        mem = self.memory_stats()
        evictable = [mem[f"level{l}"] for l in range(1, self.n_levels)]
        resident_bytes = sum(v["resident_bytes"] for v in mem.values())
        budget_total = sum(v["budget_rows"] for v in evictable)
        resident_ev = sum(v["resident_rows"] for v in evictable)
        return {"version": self.version, "n_lookups": self.n_lookups,
                "rows_gathered": self.rows_gathered, "n_swaps": self.n_swaps,
                "n_shards": self.n_shards, "n_levels": self.n_levels,
                "n_tail_shards": self.n_tail_shards,
                "hits": self.hits, "misses": self.misses,
                "hit_rate": self.hits / max(self.hits + self.misses, 1),
                "n_evictions": self.n_evictions,
                "rows_evicted": self.rows_evicted,
                "n_recomputes": self.n_recomputes,
                "n_recompute_spans": self.n_recompute_spans,
                "rows_recomputed": self.rows_recomputed,
                "recompute_s": self.recompute_s,
                "resident_bytes": resident_bytes,
                "budget_rows": (-1 if self.budget_rows is None
                                else self.budget_rows),
                "budget_util": resident_ev / max(budget_total, 1)}

    # -- checkpoint -----------------------------------------------------
    def state_arrays(self, prefix: str = "") -> Dict[str, np.ndarray]:
        """The committed front as a flat ``{name: array}`` dict (npz-
        ready): bounds, per-(level, shard) data + residency bitmaps
        (evicted shards simply have no data entry), and the heat/LRU
        policy state, plus one JSON metadata blob.  No update may be
        open — the staging overlay is a writer-private transient."""
        assert self._staged is None, \
            "commit or abort the open update before checkpointing"
        meta = {"version": self.version, "n_nodes": int(self.n_nodes),
                "n_shards": self.n_shards,
                "n_tail_shards": self.n_tail_shards,
                "dims": self._dims,
                "budget_rows": (-1 if self.budget_rows is None
                                else int(self.budget_rows)),
                "evict_policy": self.evict_policy,
                "heat_decay": self.heat_decay,
                "admission": self.admission,
                "onboarding": self.onboarding,
                "tick": int(self._tick)}
        out = {f"{prefix}meta": np.frombuffer(
                   json.dumps(meta, sort_keys=True).encode(), np.uint8),
               f"{prefix}bounds": self.bounds,
               f"{prefix}heat": self._heat,
               f"{prefix}last": self._last}
        for level in range(self.n_levels):
            for s in range(self.n_shards):
                data = self._front[level][s]
                if data is not None:
                    out[f"{prefix}d{level}_{s}"] = data
                out[f"{prefix}m{level}_{s}"] = self._mask[level][s]
        return out

    @classmethod
    def from_state_arrays(cls, arrays, prefix: str = ""
                          ) -> "EmbeddingStore":
        """Inverse of ``state_arrays``: rebuild the store object field
        by field — residency (which shards are evicted, which rows are
        admitted) restores exactly, so a restored store serves bitwise
        the same rows as the one that was dumped.  The recompute hook is
        not serialized; re-attach it (``delta.attach_recompute``) on
        budgeted stores."""
        meta = json.loads(bytes(np.asarray(arrays[f"{prefix}meta"],
                                           np.uint8)).decode())
        st = cls.__new__(cls)
        st._victim_policy = EVICT_POLICIES.get(meta["evict_policy"])
        st._admit_policy = ADMISSIONS.get(meta["admission"])
        st.n_nodes = int(meta["n_nodes"])
        st.n_shards = int(meta["n_shards"])
        st.n_tail_shards = int(meta["n_tail_shards"])
        st.bounds = np.asarray(arrays[f"{prefix}bounds"], np.int64).copy()
        st._shard_rows = np.diff(st.bounds)
        st._dims = [int(d) for d in meta["dims"]]
        st._front = []
        st._mask = []
        for level in range(len(st._dims)):
            row_d, row_m = [], []
            for s in range(st.n_shards):
                key = f"{prefix}d{level}_{s}"
                row_d.append(np.asarray(arrays[key], np.float32).copy()
                             if key in arrays else None)
                row_m.append(np.asarray(arrays[f"{prefix}m{level}_{s}"],
                                        bool).copy())
            st._front.append(row_d)
            st._mask.append(row_m)
        st._res = np.array([[int(m.sum()) for m in st._mask[level]]
                            for level in range(len(st._dims))], np.int64)
        st._staged = None
        st._staged_mask = None
        st.budget_rows = (None if meta["budget_rows"] < 0
                          else int(meta["budget_rows"]))
        st.evict_policy = meta["evict_policy"]
        st.heat_decay = float(meta["heat_decay"])
        st.admission = meta["admission"]
        st.onboarding = meta["onboarding"]
        st._heat = np.asarray(arrays[f"{prefix}heat"], np.float64).copy()
        st._last = np.asarray(arrays[f"{prefix}last"], np.int64).copy()
        st._tick = int(meta["tick"])
        st._gather_depth = 0
        st._recompute_depth = 0
        st.recompute = None
        st.version = int(meta["version"])
        st.n_lookups = 0
        st.rows_gathered = 0
        st.n_swaps = 0
        st.hits = 0
        st.misses = 0
        st.n_evictions = 0
        st.rows_evicted = 0
        st.n_recomputes = 0
        st.n_recompute_spans = 0
        st.rows_recomputed = 0
        st.recompute_s = 0.0
        return st

    def dump(self, path) -> None:
        """Write the committed front to one ``.npz`` checkpoint.  The
        restart story every scale-out deployment needs: ``load`` (or
        ``Session.from_checkpoint``) rebuilds this exact epoch without
        re-running the inference that produced it."""
        arrays = self.state_arrays()
        with open(path, "wb") as f:
            np.savez_compressed(f, **arrays)

    @classmethod
    def load(cls, path) -> "EmbeddingStore":
        """Rebuild a dumped store (see ``dump``)."""
        with np.load(path) as z:
            return cls.from_state_arrays(z)


def store_from_inference(X: np.ndarray, level_outputs: Sequence[np.ndarray],
                         n_shards: int = 4, *,
                         budget_rows: Optional[int] = None,
                         evict_policy: str = "heat",
                         admission: str = "probation",
                         onboarding: str = "none") -> EmbeddingStore:
    """Build the store from a full epoch: X plus each layer's output as
    consumed by the next layer (see DeltaReinference.full_levels)."""
    return EmbeddingStore([np.asarray(X, np.float32)]
                          + [np.asarray(h, np.float32)
                             for h in level_outputs], n_shards=n_shards,
                          budget_rows=budget_rows,
                          evict_policy=evict_policy, admission=admission,
                          onboarding=onboarding)
