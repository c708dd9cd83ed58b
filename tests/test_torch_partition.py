"""The port's partitioner (``repro_torch.core.partition``) against
``repro.core.partition``: full and row-subset plans equal array for
array, on the conftest graphs, for (P, M) in {(1, 1), (2, 1), (4, 2),
(2, 4)}, with a tail-grown layer graph's ``n_nodes`` geometry; and the
six invariants of tests/test_partition.py on the port's plans (edge
coverage, receive buffers, unique rows, bad partitions, cache hits and
invalidation, invalidation on resample)."""
import copy

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import partition as jpart  # noqa: E402
from repro_torch.core import partition as tpart  # noqa: E402
from repro_torch.core.graph import csr_from_edges, rmat_edges  # noqa: E402
from repro_torch.core.sampler import sample_layer_graphs  # noqa: E402

MESHES = [(1, 1), (2, 1), (4, 2), (2, 4)]


@pytest.fixture(scope="module")
def graph():
    src, dst = rmat_edges(256, 2048, seed=7)
    return csr_from_edges(src, dst, 256)


@pytest.fixture(scope="module")
def lgs(graph, layer_graphs):
    """The port's layer graphs of conftest's graph: repro's, bit for bit."""
    out = sample_layer_graphs(graph, fanout=8, n_layers=3, seed=3)
    for a, b in zip(out, layer_graphs):
        np.testing.assert_array_equal(a.nbr, b.nbr)
        np.testing.assert_array_equal(a.mask, b.mask)
    return out


def _same_fields(a, b):
    import dataclasses
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
            assert va.dtype == vb.dtype, f.name
        elif isinstance(vb, list):
            assert len(va) == len(vb)
            for x, y in zip(va, vb):
                if isinstance(y, np.ndarray):
                    np.testing.assert_array_equal(x, y, err_msg=f.name)
                else:
                    _same_fields(x, y)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("P,M", MESHES)
def test_build_plan_equals_repro(P, M, lgs, layer_graphs):
    _same_fields(tpart.build_plan(lgs, P, M),
                 jpart.build_plan(layer_graphs, P, M))
    for a, b in zip(tpart.comm_volume(tpart.build_plan(lgs, P, M), 64)
                    .items(),
                    jpart.comm_volume(jpart.build_plan(layer_graphs, P, M),
                                      64).items()):
        assert a == b


@pytest.mark.parametrize("P,M", MESHES)
@pytest.mark.parametrize("tail", [0, 5])
def test_build_subset_plan_equals_repro(P, M, tail, lgs, layer_graphs):
    """Frontiers of several sizes; with ``tail`` rows appended to the
    layer graph (onboarding), ``n_nodes`` keeps the main geometry."""
    rng = np.random.default_rng(P * 10 + M + tail)
    for li in range(3):
        ours, theirs = copy.deepcopy(lgs[li]), copy.deepcopy(layer_graphs[li])
        if tail:
            for lg in (ours, theirs):
                lg.nbr = np.concatenate(
                    [lg.nbr, np.zeros((tail, lg.fanout), np.int32)])
                lg.mask = np.concatenate(
                    [lg.mask, np.zeros((tail, lg.fanout), bool)])
        n_nodes = 256 if tail else None
        for size in (1, 7, 100, 256):
            rows = np.sort(rng.choice(256, size, replace=False))
            kw = dict(m_align=M, floor=8, n_nodes=n_nodes)
            _same_fields(tpart.build_subset_plan(ours, rows, P, **kw),
                         jpart.build_subset_plan(theirs, rows, P, **kw))
    assert tpart.pad_bucket(100) == jpart.pad_bucket(100) == 128


@pytest.mark.parametrize("P,M", [(2, 1), (4, 2), (8, 2)])
def test_edge_coverage(P, M, lgs):
    plan = tpart.build_plan(lgs, P, M)
    for li, lp in enumerate(plan.layers):
        lg = lgs[li]
        covered = np.zeros(lg.nbr.shape, bool)
        for p in range(P):
            for k in range(P):
                m = lp.edge_mask[p, k]
                d = lp.edge_dst[p, k][m] + p * lp.n_local
                s = lp.edge_slot[p, k][m]
                assert not covered[d, s].any(), "edge in two groups"
                covered[d, s] = True
        assert np.array_equal(covered, lg.mask)


@pytest.mark.parametrize("P", [2, 4])
def test_recv_buffer_resolves_to_right_rows(P, lgs):
    """edge_pos into the (sent) request buffer reproduces the global
    neighbor id."""
    plan = tpart.build_plan(lgs, P, 1)
    n_local = plan.layers[0].n_local
    for li, lp in enumerate(plan.layers):
        lg = lgs[li]
        for p in range(P):
            for k in range(1, P):
                q = (p + k) % P
                cnt = lp.send_count[q, k]
                buf_global = lp.send_local[q, k][:cnt] + q * n_local
                m = lp.edge_mask[p, k]
                got = buf_global[lp.edge_pos[p, k][m]]
                want = lg.nbr[lp.edge_dst[p, k][m] + p * n_local,
                              lp.edge_slot[p, k][m]]
                assert np.array_equal(got, want)


def test_unique_rows_fewer_than_edges(lgs):
    """DEAL's win: requested unique rows <= duplicated per-edge rows."""
    vols = tpart.comm_volume(tpart.build_plan(lgs, 4, 2), d_feature=64)
    for v in vols.values():
        assert v["unique_rows"] <= v["duplicated_edge_rows"]
        assert v["deal_feature_exchange_B"] <= v["graph_exchange_B"]


def test_bad_partition_rejected(lgs):
    with pytest.raises(ValueError, match="7 equal partitions"):
        tpart.build_plan(lgs, 7, 1)          # 256 % 7 != 0
    with pytest.raises(ValueError, match="tail rows"):
        tpart.build_subset_plan(lgs[0], np.array([3, 300]), 4,
                                n_nodes=256)


def test_subset_plan_cache_hits_and_invalidation(lgs):
    """The same hot frontier reuses its cached plan (signature: sorted
    row ids + partition geometry), counted in every installed scope and
    the process aggregate; an in-place resample invalidates it."""
    lg = copy.deepcopy(lgs[0])
    rows = np.arange(0, lg.n_nodes, 3, dtype=np.int64)
    scope = tpart.install_plan_cache_counters()
    try:
        before = dict(tpart.SUBSET_PLAN_CACHE)
        p1 = tpart.build_subset_plan_cached(lg, rows, 4)
        assert tpart.SUBSET_PLAN_CACHE["misses"] == before["misses"] + 1
        p2 = tpart.build_subset_plan_cached(lg, rows, 4)
        assert tpart.SUBSET_PLAN_CACHE["hits"] == before["hits"] + 1
        assert p2 is p1
        assert scope == {"hits": 1, "misses": 1}
        assert tpart.subset_plan_cache_stats() == scope
        fresh = tpart.build_subset_plan(lg, rows, 4)
        np.testing.assert_array_equal(p1.row_ids, fresh.row_ids)
        np.testing.assert_array_equal(p1.edge_pos, fresh.edge_pos)
        np.testing.assert_array_equal(p1.send_local, fresh.send_local)
        assert tpart.build_subset_plan_cached(lg, rows[:-1], 4) is not p1
        assert tpart.build_subset_plan_cached(lg, rows, 2) is not p1
        assert tpart.build_subset_plan_cached(lg, rows, 4) is p1
        tpart.invalidate_subset_plans(lg)
        assert tpart.build_subset_plan_cached(lg, rows, 4) is not p1
    finally:
        tpart.uninstall_plan_cache_counters(scope)
        tpart.uninstall_plan_cache_counters(scope)     # idempotent


def test_resample_rows_invalidates_subset_plans(lgs, graph):
    """The delta engine's resample path must not serve stale plans."""
    from repro_torch.gnnserve import resample_rows
    ours = [copy.deepcopy(lg) for lg in lgs]
    rows = np.arange(0, ours[0].n_nodes, 2, dtype=np.int64)
    p1 = tpart.build_subset_plan_cached(ours[0], rows, 4)
    resample_rows(graph, ours, rows[:5], seed=9)
    assert tpart.build_subset_plan_cached(ours[0], rows, 4) is not p1
