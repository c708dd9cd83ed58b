"""The port's distributed executor on a CPU mesh in one process (no
forced host devices, no subprocess), at N = 256 on the conftest graphs.
Mirrors tests/helpers/dist_check.py: ``DistributedLayerwise`` against
``repro.core.layerwise.local_*_infer`` with repro's params carried
across (GAT with one head: dist GAT scores with the full-width dot);
the delta refresh, the budgeted store, the chunked refresh and tail
onboarding through the mesh, each bitwise a full epoch through the same
executor and within atol 1e-4, rtol 3e-3 of ``repro.gnnserve`` on
"ref"; plus a dist ``Session`` against repro's, the local cutover's
routes and counters, and the config's geometry errors."""
import copy

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
import repro.gnnserve as jgs  # noqa: E402
from repro.core import layerwise as jlw  # noqa: E402
from repro.core.gnn_models import init_gat, init_gcn, init_sage  # noqa
from repro_torch import gnnserve as tgs  # noqa: E402
from repro_torch.api import (ConfigError, DealConfig, ExecutorSpec,  # noqa
                             PartitionSpec, Session)
from repro_torch.core.gnn_models import params_from_numpy  # noqa: E402
from repro_torch.core.graph import Graph  # noqa: E402
from repro_torch.core.layerwise import DistributedLayerwise  # noqa: E402
from repro_torch.core.ops import DistExecutor  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402

N, D = 256, 32
ATOL, RTOL = 1e-4, 3e-3
MODELS = ("gcn", "sage", "gat")


@pytest.fixture(scope="module")
def world(small_graph, layer_graphs):
    """(port graph, port layer graphs, repro graph, repro layer graphs,
    X): conftest's graph, the same arrays in both packages' types."""
    from repro_torch.core.sampler import LayerGraph
    g = Graph(indptr=small_graph.indptr.copy(),
              indices=small_graph.indices.copy(), n_nodes=N)
    lgs = [LayerGraph(nbr=lg.nbr.copy(), mask=lg.mask.copy(),
                      fanout=lg.fanout) for lg in layer_graphs]
    X = np.random.default_rng(0).standard_normal((N, D), dtype=np.float32)
    return g, lgs, small_graph, layer_graphs, X


def _params(model, dims, heads=1, seed=4):
    """repro's params (numpy) and the port's copy of them."""
    key = jax.random.PRNGKey(seed)
    jp = {"gcn": lambda: init_gcn(key, dims),
          "sage": lambda: init_sage(key, dims),
          "gat": lambda: init_gat(key, dims, heads=heads)}[model]()
    jp = jax.tree_util.tree_map(
        lambda x: np.asarray(x) if hasattr(x, "shape") else x, jp)
    return jp, params_from_numpy(model, jp, "cpu")


def _dex(P=4, M=2, **kw):
    return DistExecutor(make_host_mesh(P, M, device="cpu"), **kw)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


# ----------------------------------------------------------------------
# offline: the distributed engine
# ----------------------------------------------------------------------

@pytest.mark.parametrize("P,M", [(4, 2), (2, 4)])
@pytest.mark.parametrize("model", MODELS)
def test_distributed_layerwise_matches_repros_local_engines(P, M, model,
                                                            world):
    _, lgs, _, jlgs, X = world
    jp, tp = _params(model, [D, 64, 32, 16])
    want = jlw.LOCAL_ENGINES[model](jlgs, X, jp)
    eng = DistributedLayerwise(make_host_mesh(P, M, device="cpu"), lgs,
                               model, tp)
    got = eng.infer(X)
    assert got.shape == (N, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=0)
    # gat: the sddmm variant keeps the deal layout when spmm changes
    if model == "gat":
        eng2 = DistributedLayerwise(make_host_mesh(P, M, device="cpu"),
                                    lgs, model, tp,
                                    spmm_variant="graph_exchange")
        np.testing.assert_allclose(eng2.infer(X).numpy(),
                                   np.asarray(want), atol=5e-5, rtol=0)


def test_dist_gat_heads_are_heads_one(world):
    """Dist GAT scores with the full-width dot whatever ``heads`` is
    (M % heads == 0): 4 heads on 2 x 4 are bitwise 1 head."""
    _, lgs, _, _, X = world
    _, tp1 = _params("gat", [D, 32, 16], heads=1)
    tp4 = dict(tp1, heads=4)
    mesh = make_host_mesh(2, 4, device="cpu")
    h1 = DistributedLayerwise(mesh, lgs, "gat", tp1).infer(X)
    h4 = DistributedLayerwise(mesh, lgs, "gat", tp4).infer(X)
    assert torch.equal(h1, h4)
    with pytest.raises(ValueError, match="must divide the model axis"):
        DistributedLayerwise(make_host_mesh(4, 2, device="cpu"), lgs,
                             "gat", tp4).infer(X)


def _cfg(model="gcn", executor="ref", p=4, m=2, **extra):
    d = {"graph": {"dataset": "rmat", "n_nodes": N, "avg_degree": 8,
                   "fanout": 4},
         "model": {"name": model, "n_layers": 2, "d_feature": 16},
         "partition": {"p": p, "m": m},
         "executor": {"name": executor},
         "qos": {"staleness_bound": 4, "rows_per_step": 64}}
    d.update(extra)
    return d


@pytest.mark.parametrize("model", MODELS)
def test_dist_session_matches_repros_session(model):
    with japi.Session.build(japi.DealConfig.from_dict(_cfg(model))) as js:
        H_jax = np.asarray(js.infer_all())
        jp = jax.tree_util.tree_map(
            lambda x: np.asarray(x) if hasattr(x, "shape") else x,
            js.params)
    cfg = DealConfig.from_dict(_cfg(model, "dist"))
    with Session.build(cfg, device="cpu",
                       params=params_from_numpy(model, jp, "cpu")) as s:
        assert s.executor.name == "dist" and s.executor.P == 4
        H = s.infer_all()
        assert isinstance(H, torch.Tensor) and H.shape == H_jax.shape
        _close(H, H_jax)
        assert s.executor.plan is not None
        assert s.stats()["plan_cache"] == {"hits": 0, "misses": 0}


# ----------------------------------------------------------------------
# serving: ports of dist_check.py's mesh refresh checks
# ----------------------------------------------------------------------

def _batch(rng, n_edges, n_feat, pair):
    """One mutation batch, identical in both packages' logs."""
    src, dst = rng.integers(0, N, n_edges), rng.integers(0, N, n_edges)
    fid = rng.choice(N, n_feat, replace=False)
    rows = rng.standard_normal((n_feat, D)).astype(np.float32)
    out = []
    for gs in pair:
        log = gs.MutationLog()
        log.add_edges(src, dst)
        log.update_features(fid, rows)
        out.append(log.drain())
    return out


def _worlds(world, model, executor, budget_rows=None):
    """The port's DeltaReinference + store through ``executor`` and
    repro's through "ref", over copies of the same layer graphs."""
    g, lgs, jg, jlgs, X = world
    jp, tp = _params(model, [D, D, 16])
    ri = tgs.DeltaReinference([copy.deepcopy(lg) for lg in lgs], model, tp,
                              executor=executor)
    store = tgs.store_from_inference(X, ri.full_levels(X)[1:], n_shards=4,
                                     budget_rows=budget_rows)
    if budget_rows:
        tgs.attach_recompute(store, ri)
    jri = jgs.DeltaReinference([copy.deepcopy(lg) for lg in jlgs], model,
                               jp)
    jstore = jgs.store_from_inference(X, jri.full_levels(X)[1:],
                                      n_shards=4)
    return (ri, store, tp), (jri, jstore)


@pytest.mark.parametrize("model", MODELS)
def test_dist_delta_refresh_is_bitwise_a_dist_full_epoch(model, world):
    """check_dist_delta: every level of the refreshed store equals a
    full epoch over the mutated graphs through the same mesh."""
    g, _, jg, _, X = world
    dex = _dex()
    (ri, store, tp), (jri, jstore) = _worlds(world, model, dex)
    batch, jbatch = _batch(np.random.default_rng(3), 8, 3, (tgs, jgs))
    stats = ri.refresh(store, tgs.apply_edge_mutations(g, batch),
                       batch.feat_ids, batch.feat_rows,
                       batch.affected_dsts())
    jri.refresh(jstore, jgs.apply_edge_mutations(jg, jbatch),
                jbatch.feat_ids, jbatch.feat_rows, jbatch.affected_dsts())
    assert 0 < stats["frontier_sizes"][-1] < N
    assert stats["n_dist_layers"] == ri.n_dist_layers > 0
    X2 = X.copy()
    X2[batch.feat_ids] = batch.feat_rows
    oracle = tgs.DeltaReinference(ri.layer_graphs, model, tp,
                                  executor=dex).full_levels(X2)
    for lvl in (1, 2):
        got = store.lookup(np.arange(N), lvl)
        assert (got == oracle[lvl]).all(), lvl
        _close(got, jstore.lookup(np.arange(N), lvl))


@pytest.mark.parametrize("model", MODELS)
def test_dist_budgeted_store_is_bitwise_the_unbudgeted(model, world):
    """check_evict_equivalence: residency capped at 50% then 25%;
    sampled lookups and a lockstep refresh (staged misses recompute
    through ``run_rows``) serve the unbudgeted store's bytes."""
    g, _, jg, _, X = world
    dex = _dex()
    (ri_o, oracle, _), (jri, jstore) = _worlds(world, model, dex)
    (ri_b, store, _), _ = _worlds(world, model, dex, budget_rows=N // 2)
    rng = np.random.default_rng(11)

    def sampled_equal():
        ids = np.sort(rng.choice(N, 96, replace=False))
        for lvl in (1, 2):
            got = store.lookup(ids, lvl)
            assert (got == oracle.lookup(ids, lvl)).all()
            _close(got, jstore.lookup(ids, lvl))
        st = store.stats()
        assert st["n_evictions"] > 0 and st["misses"] > 0

    sampled_equal()
    batch, jbatch = _batch(rng, 8, 3, (tgs, jgs))
    g2 = tgs.apply_edge_mutations(g, batch)
    for ri, st in ((ri_o, oracle), (ri_b, store)):
        ri.refresh(st, g2, batch.feat_ids, batch.feat_rows,
                   batch.affected_dsts())
    jri.refresh(jstore, jgs.apply_edge_mutations(jg, jbatch),
                jbatch.feat_ids, jbatch.feat_rows, jbatch.affected_dsts())
    sampled_equal()
    store.budget_rows = N // 4
    store._enforce_budget()
    sampled_equal()


def test_dist_chunked_refresh_is_bitwise_the_inline_refresh(world):
    """check_chunked_refresh: 13 rows a chunk on the mesh commit the
    one-shot refresh's bytes."""
    g, _, jg, _, X = world
    dex = _dex()
    batch, jbatch = _batch(np.random.default_rng(17), 12, 6, (tgs, jgs))
    g2 = tgs.apply_edge_mutations(g, batch)
    stores = {}
    for chunk in (0, 13):
        (ri, store, _), (jri, jstore) = _worlds(world, "gcn", dex)
        job = ri.begin_refresh(store, g2, batch.feat_ids, batch.feat_rows,
                               batch.affected_dsts(), chunk_rows=chunk)
        while not job.done:
            job.step()
        stats = job.finish()
        assert (stats["n_chunks"] > 2) == bool(chunk)
        stores[chunk] = store
    jri.refresh(jstore, jgs.apply_edge_mutations(jg, jbatch),
                jbatch.feat_ids, jbatch.feat_rows, jbatch.affected_dsts())
    for lvl in (1, 2):
        got = stores[13].lookup(np.arange(N), lvl)
        assert (got == stores[0].lookup(np.arange(N), lvl)).all()
        _close(got, jstore.lookup(np.arange(N), lvl))


def _onboard(eng, rng, k):
    n = eng.store.n_nodes
    eng.mutate().add_nodes(k, rng.standard_normal((k, D)).astype(
        np.float32))
    new = np.arange(n, n + k)
    eng.mutate().add_edges(rng.integers(0, n, 2 * k), np.repeat(new, 2))
    eng.mutate().add_edges(new, rng.integers(0, n, k))


def test_dist_tail_onboarding_routes_tail_rows_locally(world):
    """check_tail_onboarding: tail rows (and rows sampling them) route
    to the local executor, main rows stay on the mesh; the refreshed
    store is bitwise a full routed epoch, the fold keeps it, and repro's
    engine on "ref" agrees within tolerance."""
    g, lgs, jg, jlgs, X = world
    jp, tp = _params("gcn", [D, D, 16], seed=5)
    engines = []
    for gs, graph, layer_graphs, params, ex in (
            (tgs, g, lgs, tp, _dex()), (jgs, jg, jlgs, jp, "ref")):
        ri = gs.DeltaReinference([copy.deepcopy(lg) for lg in
                                  layer_graphs], "gcn", params, executor=ex)
        store = gs.store_from_inference(X, ri.full_levels(X)[1:],
                                        n_shards=4, onboarding="tail")
        eng = gs.EmbeddingServeEngine(store, ri, graph, staleness_bound=4)
        _onboard(eng, np.random.default_rng(23), 3)
        assert eng.refresh()["n_onboarded"] == 3
        engines.append(eng)
    eng, jeng = engines
    ri = eng.reinfer
    assert ri.n_tail_routed > 0 and ri.n_dist_layers > 0
    ids = np.arange(N + 3)
    oracle = ri.full_levels(eng.store.lookup(ids, 0))
    for lvl in (1, 2):
        assert (eng.store.lookup(ids, lvl) == oracle[lvl]).all()
        _close(eng.store.lookup(ids, lvl), jeng.store.lookup(ids, lvl))
    eng.full_epoch()
    assert eng.store.n_tail_shards == 0
    assert (eng.store.lookup(ids, -1) == oracle[-1]).all()


# ----------------------------------------------------------------------
# the Session's serving tier on the mesh, the cutover, the config
# ----------------------------------------------------------------------

def test_dist_session_serves_and_refreshes_on_a_mesh():
    """A 4 x 2 dist Session serves, refreshes with tail onboarding, and
    stays within tolerance of repro's Session on "ref"."""
    kw = {"store": {"onboarding": "tail"}}
    js = japi.Session.build(japi.DealConfig.from_dict(_cfg(**kw)))
    jp = jax.tree_util.tree_map(np.asarray, js.params)
    ts = Session.build(DealConfig.from_dict(_cfg(executor="dist", **kw)),
                       device="cpu", params=params_from_numpy("gcn", jp,
                                                              "cpu"))
    with ts, js:
        for s in (ts, js):
            s.serve()
            rng = np.random.default_rng(1)
            log = s.apply_mutations()
            log.add_nodes(2, rng.standard_normal((2, 16), dtype=np.float32))
            log.add_edges(rng.integers(0, N, 16), rng.integers(0, N + 2, 16))
            s.refresh()
        ids = np.arange(N + 2)
        for lvl in range(3):
            _close(ts.store.lookup(ids, lvl), js.store.lookup(ids, lvl))
        cut = ts.stats()["refresh_cutover"]
        assert cut["n_dist"] > 0 and cut["n_tail"] > 0
        assert ts.stats()["plan_cache"]["misses"] > 0


def test_local_cutover_routes_small_frontiers_off_the_mesh(world):
    """A cutover above the first layer's universe and at most the last
    layer's frontier routes layer 0 to the local executor and the last
    to the mesh, with their ``refresh.route`` spans and counters; the
    result agrees with the uncut mesh refresh within tolerance."""
    from repro_torch import obs
    g, lgs, _, _, X = world
    jp, tp = _params("gcn", [D, D, 16])
    batch, _ = _batch(np.random.default_rng(3), 4, 2, (tgs, jgs))
    g2 = tgs.apply_edge_mutations(g, batch)
    stores, ris = [], []
    for cutover in (0, None):
        ri = tgs.DeltaReinference([copy.deepcopy(lg) for lg in lgs], "gcn",
                                  tp, executor=_dex())
        store = tgs.store_from_inference(X, ri.full_levels(X)[1:],
                                         n_shards=4)
        if cutover is None:              # the uncut run's last frontier
            ri.local_cutover = stores[0][1]["frontier_sizes"][-1]
        before = (ri.n_local_cutovers, ri.n_dist_layers)
        tel = obs.Telemetry()
        with obs.use(tel):
            stats = ri.refresh(store, g2, batch.feat_ids, batch.feat_rows,
                               batch.affected_dsts())
        stores.append((store, stats, tel))
        ris.append((ri.n_local_cutovers - before[0],
                    ri.n_dist_layers - before[1]))
    (s0, st0, _), (s1, st1, tel) = stores
    assert ris == [(0, 2), (1, 1)]          # (local, dist) layers
    assert st1["n_local_cutovers"] == 1 and st1["local_cutover"] > 0
    routes = [a["route"] for name, _, _, _, a in
              tel.tracer.events_in_order() if name == "refresh.route"]
    assert routes == ["local", "dist"]
    for lvl in (1, 2):
        _close(s1.lookup(np.arange(N), lvl), s0.lookup(np.arange(N), lvl))


def test_dist_geometry_errors_name_the_field(monkeypatch):
    with pytest.raises(ConfigError, match="partition.p: 3 must divide"):
        ExecutorSpec(name="dist").build(PartitionSpec(p=3, m=1),
                                        n_nodes=N, device="cpu")
    with pytest.raises(ConfigError, match="partition.m: 3 must be a power"):
        ExecutorSpec(name="dist").build(PartitionSpec(p=2, m=3),
                                        n_nodes=N, device="cpu")
    bad = DealConfig.from_dict(_cfg(executor="dist",
                                    cluster={"n_shards": 2}))
    with pytest.raises(ConfigError, match="cluster.n_shards"):
        bad.validate()
    # a trivial mesh is a one-shard DistExecutor, not the plain versions
    ex = ExecutorSpec(name="dist").build(PartitionSpec(p=1, m=1),
                                         n_nodes=N, device="cpu")
    assert ex.name == "dist" and (ex.P, ex.M) == (1, 1)
    with pytest.raises(ValueError, match="needs a mesh"):
        from repro_torch.core.ops import get_executor
        get_executor("dist", device="cpu")
    # the mesh, like every entry point, defaults to the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_mesh(2, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExecutorSpec(name="dist").build(PartitionSpec(p=2, m=1), n_nodes=N)
