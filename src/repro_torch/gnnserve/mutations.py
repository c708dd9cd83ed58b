"""Edge/node mutation log and a CSR delta overlay over ``core.graph`` —
the port's copy of ``repro.gnnserve.mutations`` (numpy).

Online traffic mutates the graph between epochs: edges appear/disappear
and node features change.  Rebuilding the CSR per mutation batch would
cost O(E); the overlay records per-destination adds/removes and splices
ONLY the affected rows at ``materialize`` time, so the cost is
O(sum of affected row lengths) plus two bulk copies — the same
"touch only what changed" principle the delta re-inference applies to
compute.

Node additions are recorded (``add_nodes``, optionally with the new
rows' features).  With ``store.onboarding == "tail"`` the engine
onboards them incrementally: ``grow_graph`` appends empty CSR rows, the
store appends a tail partition, and the new ids ride the next delta
refresh's resampled set — no re-partition until the next full epoch
folds the tail in.  Without tail onboarding the engine still refuses
them (growing N invalidates the static partition bounds).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.graph import Graph


@dataclasses.dataclass
class MutationBatch:
    """One drained batch of mutations, ready to apply.

    ``edge_ops`` preserves the client's edge-op ORDER (("add"|"del", src,
    dst)); the add_*/del_* arrays are order-free projections of it for
    analytics and requeueing.
    """
    add_src: np.ndarray
    add_dst: np.ndarray
    del_src: np.ndarray
    del_dst: np.ndarray
    feat_ids: np.ndarray
    feat_rows: np.ndarray          # (len(feat_ids), D)
    edge_ops: List[tuple] = dataclasses.field(default_factory=list)
    n_new_nodes: int = 0
    # (n_new_nodes, D) features for the onboarded nodes, or None (zeros)
    new_node_rows: np.ndarray = None

    @property
    def n_edge_ops(self) -> int:
        return int(self.add_src.size + self.del_src.size)

    @property
    def n_ops(self) -> int:
        """Pending-count contribution of this batch (edge ops + distinct
        feature rows + node adds) — what the engine's staleness/SLO
        accounting folds into ``ops_drained`` on a successful refresh.
        NOTE: repeated feature updates of the SAME id inside one undrained
        window collapse (last-writer-wins), matching ``MutationLog.pending``."""
        return self.n_edge_ops + int(self.feat_ids.size) + self.n_new_nodes

    def affected_dsts(self) -> np.ndarray:
        """Destinations whose CSR row (in-neighborhood) changes."""
        return np.unique(np.concatenate([self.add_dst, self.del_dst]
                                        ).astype(np.int64))


class MutationLog:
    """Append-only log; the engine drains it at each refresh."""

    def __init__(self):
        # one ordered stream: ("add"|"del", src, dst) — intra-batch
        # add-then-remove of the same edge must net out to a no-op
        self._edges: List[tuple] = []
        self._feat: Dict[int, np.ndarray] = {}   # last-writer-wins
        self._new_nodes = 0
        self._node_adds: List[tuple] = []        # (k, rows-or-None)

    def add_edge(self, src: int, dst: int) -> None:
        self._edges.append(("add", int(src), int(dst)))

    def add_edges(self, src: np.ndarray, dst: np.ndarray) -> None:
        self._edges.extend(("add", int(s), int(d)) for s, d in
                           zip(np.asarray(src), np.asarray(dst)))

    def remove_edge(self, src: int, dst: int) -> None:
        self._edges.append(("del", int(src), int(dst)))

    def remove_edges(self, src: np.ndarray, dst: np.ndarray) -> None:
        self._edges.extend(("del", int(s), int(d)) for s, d in
                           zip(np.asarray(src), np.asarray(dst)))

    def update_features(self, ids: np.ndarray, rows: np.ndarray) -> None:
        for i, r in zip(np.asarray(ids).tolist(), np.asarray(rows)):
            self._feat[int(i)] = np.asarray(r, np.float32)

    def add_nodes(self, k: int, rows: np.ndarray = None) -> None:
        """Record ``k`` brand-new nodes, optionally with their (k, D)
        feature rows (zeros otherwise).  Ids are assigned contiguously
        past the current node count at refresh time."""
        k = int(k)
        if rows is not None:
            rows = np.asarray(rows, np.float32)
            assert rows.shape[0] == k, "need one feature row per new node"
        self._node_adds.append((k, rows))
        self._new_nodes += k

    @property
    def pending(self) -> int:
        return len(self._edges) + len(self._feat) + self._new_nodes

    @property
    def pending_node_adds(self) -> int:
        """Node additions not yet folded — the NEXT new node gets id
        ``graph.n_nodes + pending_node_adds`` at refresh time."""
        return self._new_nodes

    @property
    def has_node_adds(self) -> bool:
        return self._new_nodes > 0

    def requeue(self, batch: MutationBatch) -> None:
        """Put a drained batch BACK (a failed refresh must not discard
        the good mutations drained alongside a bad one).  Edge ops replay
        from ``batch.edge_ops`` in their original order — rebuilding from
        the add_*/del_* projections would reorder del-then-add of the
        same edge into add-then-del and flip its net effect."""
        for kind, s, d in batch.edge_ops:
            (self.add_edge if kind == "add" else self.remove_edge)(s, d)
        if batch.feat_ids.size:
            self.update_features(batch.feat_ids, batch.feat_rows)
        if batch.n_new_nodes:
            self.add_nodes(batch.n_new_nodes, batch.new_node_rows)

    def drain(self) -> MutationBatch:
        def _cols(kind):
            pairs = [(s, d) for k, s, d in self._edges if k == kind]
            if not pairs:
                return (np.empty(0, np.int64), np.empty(0, np.int64))
            a = np.asarray(pairs, np.int64)
            return a[:, 0], a[:, 1]

        add_src, add_dst = _cols("add")
        del_src, del_dst = _cols("del")
        ids = np.fromiter(self._feat.keys(), np.int64, len(self._feat))
        rows = (np.stack([self._feat[int(i)] for i in ids])
                if ids.size else np.empty((0, 0), np.float32))
        new_rows = None
        if any(r is not None for _, r in self._node_adds):
            d = next(r.shape[1] for _, r in self._node_adds
                     if r is not None)
            new_rows = np.concatenate(
                [r if r is not None else np.zeros((k, d), np.float32)
                 for k, r in self._node_adds])
        batch = MutationBatch(add_src=add_src, add_dst=add_dst,
                              del_src=del_src, del_dst=del_dst,
                              feat_ids=ids, feat_rows=rows,
                              edge_ops=list(self._edges),
                              n_new_nodes=self._new_nodes,
                              new_node_rows=new_rows)
        self._edges, self._feat = [], {}
        self._new_nodes = 0
        self._node_adds = []
        return batch


def grow_graph(g: Graph, n_new: int) -> Graph:
    """A NEW graph with ``n_new`` appended nodes and empty CSR rows —
    the structural half of incremental node onboarding (edges touching
    the new ids then splice in via ``apply_edge_mutations``)."""
    assert n_new > 0
    indptr = np.concatenate(
        [g.indptr, np.full(n_new, g.indptr[-1], np.int64)])
    # indices are shared, not copied: the grown rows are empty, and
    # apply_edge_mutations never writes into its input's indices
    return Graph(indptr=indptr, indices=g.indices,
                 n_nodes=g.n_nodes + int(n_new))


def apply_edge_mutations(g: Graph, batch: MutationBatch) -> Graph:
    """Splice the batch into a NEW Graph, touching only affected rows.

    Ops replay per destination IN LOG ORDER: adds append to the row,
    removals delete the first matching occurrence (multigraph CSR
    semantics) — so add-then-remove of the same edge inside one batch
    nets out to a no-op.  Removing an absent edge is a no-op.
    """
    affected = batch.affected_dsts()
    if affected.size == 0:
        return Graph(indptr=g.indptr.copy(), indices=g.indices.copy(),
                     n_nodes=g.n_nodes)
    assert affected.min() >= 0 and affected.max() < g.n_nodes, \
        "edge mutation references an unknown node"
    for arr in (batch.add_src, batch.del_src):
        assert arr.size == 0 or (arr.min() >= 0 and arr.max() < g.n_nodes), \
            "edge mutation references an unknown source node"

    ops: Dict[int, List[tuple]] = {}
    for kind, s, d in batch.edge_ops:
        ops.setdefault(int(d), []).append((kind, int(s)))

    new_rows: Dict[int, np.ndarray] = {}
    for v in affected:
        row = g.neighbors(int(v)).tolist()
        for kind, s in ops.get(int(v), ()):
            if kind == "add":
                row.append(s)
            else:
                try:
                    row.remove(s)
                except ValueError:
                    pass                    # removing an absent edge
        new_rows[int(v)] = np.asarray(row, np.int32)

    deg = g.degrees().astype(np.int64)
    for v, row in new_rows.items():
        deg[v] = row.size
    indptr = np.zeros(g.n_nodes + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = np.empty(indptr[-1], np.int32)
    # bulk-copy the untouched spans between affected rows, splice the rest
    prev = 0
    for v in affected:
        v = int(v)
        indices[indptr[prev]:indptr[v]] = g.indices[g.indptr[prev]:g.indptr[v]]
        indices[indptr[v]:indptr[v + 1]] = new_rows[v]
        prev = v + 1
    indices[indptr[prev]:] = g.indices[g.indptr[prev]:]
    return Graph(indptr=indptr, indices=indices, n_nodes=g.n_nodes)
