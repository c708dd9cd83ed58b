"""The port's serving tier against ``repro.gnnserve`` on the same inputs:
mutation splices, resampled layer graphs, reverse indexes, frontiers,
store versions and ``stats()`` trees equal the JAX package's exactly
(the code is numpy); served rows agree within atol 1e-4, rtol 3e-3
through "ref" and through the "cuda" executor on CPU tensors (its plain
versions).  Port-internal, bitwise: a delta refresh equals a full epoch
through the same executor, and a budgeted store serves the bytes of an
unbudgeted one.  Mirrors ``tests/test_gnnserve.py`` and
``tests/test_gnnserve_evict.py``."""
import copy

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
import repro.gnnserve as jgs  # noqa: E402
from repro.core.gnn_models import init_gat, init_gcn, init_sage  # noqa
from repro.core.graph import csr_from_edges as jcsr  # noqa: E402
from repro.core.graph import rmat_edges as jrmat  # noqa: E402
from repro.core.sampler import sample_layer_graphs as jsample  # noqa: E402
from repro_torch import gnnserve as tgs  # noqa: E402
from repro_torch.api import ConfigError, DealConfig, Session  # noqa: E402
from repro_torch.core.gnn_models import params_from_numpy  # noqa: E402
from repro_torch.core.graph import csr_from_edges, rmat_edges  # noqa: E402
from repro_torch.core.ops import CudaExecutor, RefExecutor  # noqa: E402
from repro_torch.core.sampler import sample_layer_graphs  # noqa: E402

N, D, L, FANOUT = 256, 16, 2, 6
ATOL, RTOL = 1e-4, 3e-3
EXECUTORS = {"ref": lambda: RefExecutor("cpu"),
             "cuda": lambda: CudaExecutor("cpu")}


@pytest.fixture(scope="module")
def world():
    """(port graph, JAX graph, src, dst, port layer graphs, JAX layer
    graphs, X): the same arrays built by each package's own code."""
    src, dst = rmat_edges(N, N * 8, seed=5)
    jsrc, jdst = jrmat(N, N * 8, seed=5)
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(dst, jdst)
    g, jg = csr_from_edges(src, dst, N), jcsr(src, dst, N)
    lgs = sample_layer_graphs(g, fanout=FANOUT, n_layers=L, seed=2)
    jlgs = jsample(jg, fanout=FANOUT, n_layers=L, seed=2)
    for a, b in zip(lgs, jlgs):
        np.testing.assert_array_equal(a.nbr, b.nbr)
        np.testing.assert_array_equal(a.mask, b.mask)
    X = np.random.default_rng(4).standard_normal((N, D), dtype=np.float32)
    return g, jg, src, dst, lgs, jlgs, X


def _params(model):
    """JAX params (to numpy) and the same values as the port's."""
    key = jax.random.PRNGKey(0)
    dims = [D] * (L + 1)
    jp = {"gcn": lambda: init_gcn(key, dims),
          "sage": lambda: init_sage(key, dims),
          "gat": lambda: init_gat(key, dims, heads=4)}[model]()
    jp = jax.tree_util.tree_map(
        lambda x: np.asarray(x) if hasattr(x, "shape") else x, jp)
    return jp, params_from_numpy(model, jp, "cpu")


def _drain_pair(rng, src, dst, **kw):
    """The same drained batch from the port's log and the JAX one's."""
    pick = rng.choice(src.size, kw.get("n_edge", 8), replace=False)
    n_edge, n_feat = kw.get("n_edge", 8), kw.get("n_feat", 3)
    add = (rng.integers(0, N, n_edge), rng.integers(0, N, n_edge))
    fid = rng.choice(N, n_feat, replace=False)
    rows = rng.standard_normal((n_feat, D), dtype=np.float32)
    out = []
    for mod in (tgs, jgs):
        log = mod.MutationLog()
        log.add_edges(*add)
        log.remove_edges(src[pick], dst[pick])
        if n_feat:
            log.update_features(fid, rows)
        out.append(log.drain())
    return out


def _build(pkg, lgs, X, model, params, executor, budget=None):
    ri = pkg.DeltaReinference([copy.deepcopy(lg) for lg in lgs], model,
                              params, executor=executor)
    store = pkg.store_from_inference(X, ri.full_levels(X)[1:], n_shards=4,
                                     budget_rows=budget)
    if budget is not None:
        pkg.attach_recompute(store, ri)
    return ri, store


def _all_levels(store):
    ids = np.arange(store.n_nodes)
    return [store.lookup(ids, lvl) for lvl in range(store.n_levels)]


# ----------------------------------------------------------------------
# numpy parity: mutations, resampling, reverse index, frontier, store
# ----------------------------------------------------------------------

def test_mutation_batches_and_splices_match_repro(world):
    g, jg, src, dst, *_ = world
    rng = np.random.default_rng(5)
    for _ in range(3):
        b, jb = _drain_pair(rng, src, dst, n_edge=32)
        for f in ("add_src", "add_dst", "del_src", "del_dst", "feat_ids",
                  "feat_rows"):
            np.testing.assert_array_equal(getattr(b, f), getattr(jb, f))
        assert b.edge_ops == jb.edge_ops and b.n_ops == jb.n_ops
        g, jg = tgs.apply_edge_mutations(g, b), jgs.apply_edge_mutations(
            jg, jb)
        np.testing.assert_array_equal(g.indptr, jg.indptr)
        np.testing.assert_array_equal(g.indices, jg.indices)
    grown, jgrown = tgs.grow_graph(g, 3), jgs.grow_graph(jg, 3)
    assert grown.n_nodes == jgrown.n_nodes == N + 3
    np.testing.assert_array_equal(grown.indptr, jgrown.indptr)


def test_resample_reverse_index_and_frontier_match_repro(world):
    g, jg, src, dst, lgs, jlgs, _ = world
    lgs, jlgs = copy.deepcopy(lgs), copy.deepcopy(jlgs)
    rev = [tgs.build_reverse_index(lg) for lg in lgs]
    rng = np.random.default_rng(3)
    for _ in range(3):
        b, jb = _drain_pair(rng, src, dst, n_edge=12)
        g, jg = tgs.apply_edge_mutations(g, b), jgs.apply_edge_mutations(
            jg, jb)
        rows = b.affected_dsts()
        old = [(lg.nbr[rows].copy(), lg.mask[rows].copy()) for lg in lgs]
        tgs.resample_rows(g, lgs, rows, seed=7)
        jgs.resample_rows(jg, jlgs, jb.affected_dsts(), seed=7)
        for l, (lg, jlg) in enumerate(zip(lgs, jlgs)):
            np.testing.assert_array_equal(lg.nbr, jlg.nbr)
            np.testing.assert_array_equal(lg.mask, jlg.mask)
            rev[l] = tgs.splice_reverse_index(rev[l], rows, *old[l],
                                              lg.nbr[rows], lg.mask[rows])
            fresh = jgs.build_reverse_index(jlg)
            np.testing.assert_array_equal(rev[l].indptr, fresh.indptr)
            np.testing.assert_array_equal(rev[l].rows, fresh.rows)
        front = tgs.forward_frontier(rev, b.feat_ids, rows, L)
        jfront = jgs.forward_frontier(
            [jgs.build_reverse_index(lg) for lg in jlgs], jb.feat_ids,
            jb.affected_dsts(), L)
        for a, c in zip(front, jfront):
            np.testing.assert_array_equal(a, c)


def test_store_semantics_and_stats_match_repro(world):
    *_, X = world
    h1 = np.arange(N * 8, dtype=np.float32).reshape(N, 8)
    stores = [pkg.EmbeddingStore([X, h1], n_shards=4)
              for pkg in (tgs, jgs)]
    ids = np.array([0, 17, 200, N - 1])
    for st in stores:
        st.begin_update()
        st.write_rows(1, ids, np.full((ids.size, 8), -5.0, np.float32))
        assert (st.lookup(ids, 1) == h1[ids]).all()     # front buffer
        assert (st.lookup_staged(ids, 1) == -5.0).all()
        st.commit()
        st.begin_update()
        st.write_rows(1, ids, np.zeros((ids.size, 8), np.float32))
        st.abort()
        st.lookup(np.arange(0, N, 3), 1)
    a, b = stores
    assert a.version == b.version == 1
    np.testing.assert_array_equal(a.lookup(np.arange(N), 1),
                                  b.lookup(np.arange(N), 1))
    assert a.stats() == b.stats()


# ----------------------------------------------------------------------
# delta refresh
# ----------------------------------------------------------------------

@pytest.mark.parametrize("executor", ["ref", "cuda"])
@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_delta_refresh_matches_repro_and_full_epoch(world, model,
                                                    executor):
    g, jg, src, dst, lgs, jlgs, X = world
    jp, tp = _params(model)
    ri, store = _build(tgs, lgs, X, model, tp, EXECUTORS[executor]())
    jri, jstore = _build(jgs, jlgs, X, model, jp, "ref")
    for a, b in zip(_all_levels(store), _all_levels(jstore)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
    rng = np.random.default_rng(11)
    for _ in range(2):
        b, jb = _drain_pair(rng, src, dst)
        g, jg = tgs.apply_edge_mutations(g, b), jgs.apply_edge_mutations(
            jg, jb)
        st = ri.refresh(store, g, b.feat_ids, b.feat_rows,
                        b.affected_dsts())
        jst = jri.refresh(jstore, jg, jb.feat_ids, jb.feat_rows,
                          jb.affected_dsts())
        assert st == jst                    # versions, frontiers, counters
    for lg, jlg in zip(ri.layer_graphs, jri.layer_graphs):
        np.testing.assert_array_equal(lg.nbr, jlg.nbr)
        np.testing.assert_array_equal(lg.mask, jlg.mask)
    got = _all_levels(store)
    for a, c in zip(got, _all_levels(jstore)):
        np.testing.assert_allclose(a, c, atol=ATOL, rtol=RTOL)
    # port-internal: the refreshed store is bitwise a fresh full epoch
    # over the same mutated layer graphs through the same executor
    oracle = tgs.DeltaReinference(copy.deepcopy(ri.layer_graphs), model,
                                  tp, executor=ri.executor).full_levels(
        got[0])
    for lvl in range(1, L + 1):
        np.testing.assert_array_equal(got[lvl], oracle[lvl])
    assert store.stats() == jstore.stats()


def test_refresh_batching_is_invariant(world):
    """One mutation stream folded in one batch or in two lands on the
    same store bytes (content-addressed resampling)."""
    g, _, src, dst, lgs, _, X = world
    _, tp = _params("gcn")
    rng = np.random.default_rng(41)
    batches = [_drain_pair(rng, src, dst)[0] for _ in range(2)]

    def fold(seq):
        ri, store = _build(tgs, lgs, X, "gcn", tp, CudaExecutor("cpu"))
        gm = g
        for b in seq:
            gm = tgs.apply_edge_mutations(gm, b)
            ri.refresh(store, gm, b.feat_ids, b.feat_rows,
                       b.affected_dsts())
        return _all_levels(store)

    big = tgs.MutationLog()
    for b in batches:
        big.requeue(b)
    for a, c in zip(fold(batches), fold([big.drain()])):
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("executor", ["ref", "cuda"])
@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
@pytest.mark.parametrize("frac", [0.25, 0.5])
def test_budgeted_store_bitwise_equal(world, model, executor, frac):
    """A store capped at 25% / 50% of each level serves the bytes of an
    unbudgeted one, before and after a refresh whose staged reads miss,
    with the JAX package's hit, miss and eviction counts."""
    g, jg, src, dst, lgs, jlgs, X = world
    jp, tp = _params(model)
    cap = int(N * frac)
    ri0, full = _build(tgs, lgs, X, model, tp, EXECUTORS[executor]())
    ri, st = _build(tgs, lgs, X, model, tp, EXECUTORS[executor](), cap)
    jri, jst = _build(jgs, jlgs, X, model, jp, "ref", cap)
    rng = np.random.default_rng(2)
    probe = rng.choice(N, 64, replace=False)
    for s in (full, st, jst):
        s.lookup(probe, -1)
    b, jb = _drain_pair(rng, src, dst)
    g2, jg2 = tgs.apply_edge_mutations(g, b), jgs.apply_edge_mutations(
        jg, jb)
    for r, s in ((ri0, full), (ri, st)):
        r.refresh(s, g2, b.feat_ids, b.feat_rows, b.affected_dsts())
    jri.refresh(jst, jg2, jb.feat_ids, jb.feat_rows, jb.affected_dsts())
    for lvl in range(L + 1):
        ids = rng.permutation(N)
        np.testing.assert_array_equal(st.lookup(ids, lvl),
                                      full.lookup(ids, lvl))
        jst.lookup(ids, lvl)
    s, js = st.stats(), jst.stats()
    assert s["n_evictions"] > 0 and s["n_recomputes"] > 0
    assert _strip_times(s) == _strip_times(js)


# ----------------------------------------------------------------------
# the engine and the Session surface
# ----------------------------------------------------------------------

def _cfg(model="gcn", executor="ref", **sections):
    d = {"graph": {"dataset": "rmat", "n_nodes": 256, "avg_degree": 8,
                   "fanout": 4},
         "model": {"name": model, "n_layers": 2,
                   "d_feature": 32 if model == "gat" else 16,
                   "heads": 4 if model == "gat" else 1},
         "executor": {"name": executor},
         "qos": {"staleness_bound": 6, "batch_slots": 3,
                 "rows_per_step": 48}}
    d.update(sections)
    return d


def _session_pair(d, executor="ref"):
    """repro's Session and the port's over one config; the port takes
    the reference's params."""
    js = japi.Session.build(japi.DealConfig.from_dict(d))
    jp = jax.tree_util.tree_map(
        lambda x: np.asarray(x) if hasattr(x, "shape") else x, js.params)
    d = dict(d, executor={"name": executor})
    ts = Session.build(DealConfig.from_dict(d), device="cpu",
                       params=params_from_numpy(d["model"]["name"], jp,
                                                "cpu"))
    return ts, js


def _drive(s, seed, n_ticks=4, d=16):
    """Queries and mutations through one session; returns the queries."""
    eng = s.serve()
    rng = np.random.default_rng(seed)
    mod = tgs if isinstance(s, Session) else jgs
    n = s.n_nodes
    qs = []
    for t in range(n_ticks):
        m = s.apply_mutations()
        m.add_edges(rng.integers(0, n, 3), rng.integers(0, n, 3))
        m.update_features(rng.choice(n, 2, replace=False),
                          rng.standard_normal((2, d), dtype=np.float32))
        for i in range(3):
            q = mod.Query(uid=len(qs), node_ids=rng.choice(n, 40,
                                                           replace=False))
            qs.append(q)
            eng.submit(q)
        eng.run()
    s.refresh()
    return qs


def _strip_times(tree):
    """A stats tree without wall-clock values (timings, *_ms, *_s)."""
    if isinstance(tree, dict):
        return {k: _strip_times(v) for k, v in tree.items()
                if not (k.startswith("t_") or k.endswith("_ms")
                        or k.endswith("_s") or "_ms." in k
                        or k.startswith("construct."))}
    return tree


@pytest.mark.parametrize("executor", ["ref", "cuda"])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_session_serves_like_repro(model, executor):
    """serve -> mutations -> staleness-driven refreshes -> queries: the
    same schedule, versions and stats tree as repro, rows within
    tolerance."""
    d = _cfg(model)
    ts, js = _session_pair(d, executor)
    with ts, js:
        width = d["model"]["d_feature"]
        tq, jq = _drive(ts, 3, d=width), _drive(js, 3, d=width)
        for a, b in zip(tq, jq):
            assert a.done and b.done
            assert a.served_version == b.served_version
            np.testing.assert_allclose(a.out, b.out, atol=ATOL, rtol=RTOL)
        assert ts.store.version == js.store.version > 0
        assert _strip_times(ts.stats()) == _strip_times(js.stats())
        levels = _all_levels(ts.store)
        oracle = tgs.DeltaReinference(
            copy.deepcopy(ts.reinfer.layer_graphs), model, ts.params,
            executor=ts.executor).full_levels(levels[0])
        for lvl in range(1, len(levels)):
            np.testing.assert_array_equal(levels[lvl], oracle[lvl])


def test_engine_staleness_and_mid_query_refresh(world):
    """Below the bound serving stays stale; crossing it refreshes before
    the next gather; a refresh landing mid-query serves one epoch."""
    g, _, src, dst, lgs, _, X = world
    _, tp = _params("gcn")
    ri, store = _build(tgs, lgs, X, "gcn", tp, CudaExecutor("cpu"))
    levels = _all_levels(store)
    eng = tgs.EmbeddingServeEngine(store, ri, g, batch_slots=3,
                                   rows_per_step=16, staleness_bound=4)
    rng = np.random.default_rng(9)
    eng.mutate().add_edges(rng.integers(0, N, 2), rng.integers(0, N, 2))
    q1 = tgs.Query(uid=0, node_ids=np.arange(64))
    eng.submit(q1)
    eng.step()                                   # rows 0..15 at v0
    eng.mutate().add_edges(rng.integers(0, N, 5), rng.integers(0, N, 5))
    eng.run()
    assert eng.n_refreshes == 1 and eng.store.version == 1
    assert q1.served_version == 0
    np.testing.assert_array_equal(q1.out, levels[-1][q1.node_ids])
    q2 = tgs.Query(uid=1, node_ids=np.arange(50), fresh=True)
    eng.submit(q2)
    eng.run()
    assert q2.served_version == 1 and eng.staleness == 0


def test_failed_refresh_preserves_log_and_rolls_back(world):
    g, _, src, dst, lgs, _, X = world
    _, tp = _params("gcn")
    ri, store = _build(tgs, lgs, X, "gcn", tp, CudaExecutor("cpu"))
    eng = tgs.EmbeddingServeEngine(store, ri, g, staleness_bound=1)
    eng.mutate().add_edge(N + 5, 0)                 # invalid source id
    eng.mutate().update_features(np.array([1, 2]),
                                 np.ones((2, D), np.float32))
    before = eng.staleness
    with pytest.raises(AssertionError):
        eng.refresh()
    assert eng.staleness == before and eng.store.version == 0
    log = tgs.MutationLog()
    log.add_edges(np.array([5, 6]), np.array([7, 8]))
    b = log.drain()
    g2 = tgs.apply_edge_mutations(g, b)
    with pytest.raises((ValueError, RuntimeError)):
        ri.refresh(store, g2, np.array([0]), np.zeros((1, 99), np.float32),
                   b.affected_dsts())
    ri.refresh(store, g2, b.feat_ids, b.feat_rows, b.affected_dsts())
    got = _all_levels(store)
    oracle = tgs.DeltaReinference(ri.layer_graphs, "gcn", tp,
                                  executor=ri.executor).full_levels(got[0])
    for lvl in range(1, L + 1):
        np.testing.assert_array_equal(got[lvl], oracle[lvl])


def test_serve_without_a_card_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DealConfig.from_dict(_cfg("gcn", "cuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Session.build(cfg).serve()
    _, tp = _params("gcn")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgs.DeltaReinference([], "gcn", tp, executor="cuda")
    with Session.build(cfg, device="cpu") as s:
        eng = s.serve()
        assert s.engine is eng and s.cluster is None and s.endpoint is None
        assert s.store is eng.store and s.store.version == 0


def test_what_is_not_ported_raises_naming_its_roadmap_item(tmp_path):
    """Every serving surface of the JAX package is ported now.  Without
    telemetry ``dump_trace`` raises a ConfigError and
    ``prometheus_text`` is empty; with it ``serve()`` starts the
    endpoint.  A cluster config's ``serve()`` launches the cluster tier
    (items 7 and 8 of the roadmap): a router-backed engine over two
    worker processes, the merged stats with their ``cluster`` subtree,
    and ``close()`` shuts the workers down."""
    from repro_torch.gnnserve.cluster import ClusterEngine
    with Session.build(DealConfig.from_dict(_cfg()), device="cpu") as s:
        with pytest.raises(ConfigError, match="telemetry"):
            s.dump_trace("/dev/null")
        assert s.prometheus_text() == ""
    d = _cfg(cluster={"n_shards": 2, "run_dir": str(tmp_path)})
    with Session.build(DealConfig.from_dict(d), device="cpu") as s:
        eng = s.serve()
        assert isinstance(eng, ClusterEngine) and s.cluster is not None
        assert s.engine is eng and s.cluster.device == "cpu"
        st = s.stats()
        assert st["cluster"]["n_shards"] == 2
        assert s.timings["epoch_s"] == s.cluster.ready_wait_s > 0
        procs = list(s.cluster.procs)
    assert s.cluster is None
    assert all(p.poll() is not None for p in procs)
    d = _cfg(telemetry={"enabled": True, "http_port": 0})
    with Session.build(DealConfig.from_dict(d), device="cpu") as s:
        s.serve()
        assert s.endpoint is not None and s.endpoint.port
    assert s.endpoint is None
    # the distributed executor (item 5) is ported: by name it needs a
    # mesh, as in the JAX package
    _, tp = _params("gcn")
    with pytest.raises(ValueError, match="needs a mesh"):
        tgs.DeltaReinference([], "gcn", tp, executor="dist", device="cpu")


def test_serving_validation_matches_repro():
    bad = {"store": {"n_shards": 0, "evict_policy": "nope",
                     "onboarding": "head"},
           "qos": {"batch_slots": 0, "tenants": [{"name": "a"},
                                                 {"name": "a"}]},
           "refresh": {"chunk_rows": -1},
           "telemetry": {"health_window": 1},
           "cluster": {"n_shards": -1}}
    msgs = []
    for mod in (japi, __import__("repro_torch.api", fromlist=["x"])):
        with pytest.raises(mod.ConfigError) as ei:
            mod.DealConfig.from_dict(_cfg(**bad)).validate()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    for frag in ("store.n_shards", "store.evict_policy", "store.onboarding",
                 "qos.batch_slots", "qos.tenants[1].name",
                 "refresh.chunk_rows", "telemetry.health_window",
                 "cluster.n_shards"):
        assert frag in msgs[1], frag


def test_telemetry_counts_the_serving_tier():
    """With telemetry on, the serving tier's counters, histograms and
    health land in stats() as in repro (names only: times differ),
    besides the histograms of the binding's ``io.*`` spans, which the
    JAX package lacks."""
    d = _cfg(telemetry={"enabled": True, "clock": "fake"})
    ts, js = _session_pair(d)
    with ts, js:
        _drive(ts, 5), _drive(js, 5)
        t, j = ts.stats(), js.stats()
        assert set(t) == set(j)
        ours = {m for m in t["metrics"] if not m.startswith("io.")}
        assert ours == set(j["metrics"])
        assert {m.split("_ms.")[0] for m in set(t["metrics"]) - ours} == {
            "io.bind", "io.mean_w"}
        assert t["attribution"].keys() == j["attribution"].keys()
        assert t["metrics"]["serve.submitted"] == j["metrics"][
            "serve.submitted"] > 0
