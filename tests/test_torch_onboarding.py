"""Incremental node onboarding in the port: tail partitions in the
store, delta refresh over grown layer graphs, the fold at the next full
epoch and the failure rollback, each against ``repro`` on the same
mutations (equal layer graphs, stats and versions; rows within atol
1e-4, rtol 3e-3) and against a full epoch through the same executor
(bitwise).  Mirrors ``tests/test_onboarding.py``."""
import copy

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
from repro_torch import gnnserve as tgs  # noqa: E402
from repro_torch.api import DealConfig, Session  # noqa: E402
from repro_torch.core.gnn_models import params_from_numpy  # noqa: E402

N, D, LAYERS, FANOUT = 256, 16, 3, 4
ATOL, RTOL = 1e-4, 3e-3


def _cfg(executor="ref", onboarding="tail", budget_rows=0, **extra):
    d = {"graph": {"dataset": "rmat", "n_nodes": N, "avg_degree": 8,
                   "fanout": FANOUT},
         "model": {"name": "gcn", "n_layers": LAYERS, "d_feature": D},
         "executor": {"name": executor},
         "store": {"onboarding": onboarding, "budget_rows": budget_rows},
         "qos": {"staleness_bound": 4, "rows_per_step": 64}}
    d.update(extra)
    return d


def _pair(executor="ref", **kw):
    """repro's serving Session and the port's over one config; the port
    takes the reference's params."""
    js = japi.Session.build(japi.DealConfig.from_dict(_cfg(**kw)))
    jp = jax.tree_util.tree_map(np.asarray, js.params)
    ts = Session.build(DealConfig.from_dict(_cfg(executor, **kw)),
                       device="cpu", params=params_from_numpy("gcn", jp,
                                                              "cpu"))
    ts.serve(), js.serve()
    return ts, js


def _onboard(s, k, seed=1):
    """k new nodes with features, wired into the graph both ways."""
    rng = np.random.default_rng(seed)
    n = s.store.n_nodes
    rows = rng.standard_normal((k, D), dtype=np.float32)
    log = s.apply_mutations()
    log.add_nodes(k, rows)
    new = np.arange(n, n + k)
    log.add_edges(rng.integers(0, n, 2 * k), np.repeat(new, 2))
    log.add_edges(new, rng.integers(0, n, k))
    return rows


def _levels(store):
    ids = np.arange(store.n_nodes)
    return [store.lookup(ids, lvl) for lvl in range(store.n_levels)]


def _oracle(s):
    """A full epoch over the session's CURRENT layer graphs, through its
    executor: the bitwise reference for every onboarded store."""
    X = s.store.lookup(np.arange(s.store.n_nodes), 0)
    return tgs.DeltaReinference(copy.deepcopy(s.reinfer.layer_graphs),
                                "gcn", s.params,
                                executor=s.executor).full_levels(X)


def _same_world(ts, js):
    for a, b in zip(ts.reinfer.layer_graphs, js.reinfer.layer_graphs):
        np.testing.assert_array_equal(a.nbr, b.nbr)
        np.testing.assert_array_equal(a.mask, b.mask)
    st, jst = ts.store, js.store
    assert (st.n_nodes, st.n_shards, st.n_tail_shards, st.version) == (
        jst.n_nodes, jst.n_shards, jst.n_tail_shards, jst.version)
    np.testing.assert_array_equal(st.bounds, jst.bounds)
    for a, b in zip(_levels(st), _levels(jst)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("executor", ["ref", "cuda"])
def test_tail_onboarding_matches_repro_and_full_epoch(executor):
    ts, js = _pair(executor)
    with ts, js:
        rows = _onboard(ts, 3)
        _onboard(js, 3)
        stats, jstats = ts.refresh(), js.refresh()
        assert stats == jstats and stats["n_onboarded"] == 3
        assert ts.store.n_tail_shards == 1
        np.testing.assert_array_equal(
            ts.store.lookup(np.arange(N, N + 3), 0), rows)
        _same_world(ts, js)
        got = _levels(ts.store)
        for lvl, want in enumerate(_oracle(ts)):
            np.testing.assert_array_equal(got[lvl], want)


@pytest.mark.parametrize("executor", ["ref", "cuda"])
def test_repeated_onboarding_and_full_epoch_fold(executor):
    """Two onboarding batches make two tails; queries over old and new
    ids serve the oracle's bytes; ``full_epoch`` folds the tails back
    into the main partitioning bitwise, as repro does."""
    ts, js = _pair(executor)
    with ts, js:
        for seed, k in ((1, 2), (2, 3)):
            for s in (ts, js):
                _onboard(s, k, seed=seed)
                s.refresh()
        assert ts.store.n_tail_shards == 2
        q = tgs.Query(uid=0, node_ids=np.arange(N - 2, N + 5))
        ts.engine.submit(q)
        ts.engine.run()
        oracle = _oracle(ts)
        np.testing.assert_array_equal(q.out, oracle[-1][N - 2:N + 5])
        fold, jfold = ts.full_epoch(), js.full_epoch()
        assert fold == jfold
        assert ts.store.n_tail_shards == 0 and ts.store.n_shards == 4
        got = _levels(ts.store)
        for lvl in range(1, LAYERS + 1):
            np.testing.assert_array_equal(got[lvl], oracle[lvl])
        _same_world(ts, js)


def test_onboarding_on_budgeted_store_recomputes_tail():
    ts, js = _pair("cuda", budget_rows=64)
    with ts, js:
        for s in (ts, js):
            _onboard(s, 3)
            s.refresh()
        ids = np.arange(N + 3)
        oracle = _oracle(ts)                  # reads level 0 of the store
        js.store.lookup(ids, 0)
        for lvl in range(1, LAYERS + 1):
            js.store.lookup(ids, lvl)
            np.testing.assert_array_equal(ts.store.lookup(ids, lvl),
                                          oracle[lvl])
        st, jst = ts.store.stats(), js.store.stats()
        assert st["n_recomputes"] > 0
        for key in ("hits", "misses", "n_evictions", "rows_recomputed"):
            assert st[key] == jst[key], key


def test_refuses_without_tail_onboarding_like_repro():
    ts, js = _pair(onboarding="none")
    with ts, js:
        for s in (ts, js):
            s.apply_mutations().add_nodes(2)
            with pytest.raises(NotImplementedError):
                s.refresh()
            assert s.engine.log.pending > 0 and s.store.n_nodes == N
        ts.full_epoch(), js.full_epoch()     # the re-partition event
        assert ts.store.n_nodes == js.store.n_nodes == N + 2


def test_failed_onboarding_rolls_back_everything():
    ts, js = _pair("cuda")
    with ts, js:
        eng = ts.engine
        eng.mutate().add_nodes(2)
        eng.mutate().add_edges(np.array([N + 100]), np.array([0]))
        pending = eng.log.pending
        with pytest.raises(AssertionError):
            eng.refresh()
        st = eng.store
        assert st.n_nodes == N and st.n_shards == 4
        assert eng.reinfer.layer_graphs[0].nbr.shape[0] == N
        assert eng.log.pending == pending and eng.graph.n_nodes == N
