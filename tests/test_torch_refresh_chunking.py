"""Chunked refresh in the port: a ``RefreshJob`` stepped one row chunk
at a time commits, bitwise, the bytes of the inline refresh through the
same executor, with the JAX package's chunk counts and frontiers; a
chunked QoS engine serves what an inline one serves; abort rolls back
store and layer graphs.  Mirrors ``tests/test_refresh_chunking.py``."""
import copy

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.gnnserve as jgs  # noqa: E402
from repro.core.gnn_models import init_gcn  # noqa: E402
from repro_torch import gnnserve as tgs  # noqa: E402
from repro_torch.core.gnn_models import params_from_numpy  # noqa: E402
from repro_torch.core.graph import csr_from_edges, rmat_edges  # noqa: E402
from repro_torch.core.ops import CudaExecutor, RefExecutor  # noqa: E402
from repro_torch.core.sampler import sample_layer_graphs  # noqa: E402

N, D, L, FANOUT = 384, 16, 3, 6
ATOL, RTOL = 1e-4, 3e-3
EXECUTORS = {"ref": RefExecutor, "cuda": CudaExecutor}


@pytest.fixture(scope="module")
def world():
    src, dst = rmat_edges(N, N * 8, seed=21)
    g = csr_from_edges(src, dst, N)
    lgs = sample_layer_graphs(g, fanout=FANOUT, n_layers=L, seed=4)
    X = np.random.default_rng(6).standard_normal((N, D), dtype=np.float32)
    jp = jax.tree_util.tree_map(np.asarray, init_gcn(jax.random.PRNGKey(2),
                                                     [D] * (L + 1)))
    return g, src, dst, lgs, X, jp


def _fresh(world, executor="cuda", pkg=tgs):
    g, src, dst, lgs, X, jp = world
    if pkg is tgs:
        params, ex = (params_from_numpy("gcn", jp, "cpu"),
                      EXECUTORS[executor]("cpu"))
    else:
        params, ex = jp, "ref"
    ri = pkg.DeltaReinference([copy.deepcopy(lg) for lg in lgs], "gcn",
                              params, executor=ex)
    store = pkg.store_from_inference(X, ri.full_levels(X)[1:], n_shards=4)
    return ri, store


def _batch(world, seed, pkg=tgs, n_edge=24, n_feat=16):
    g, src, dst, *_ = world
    rng = np.random.default_rng(seed)
    log = pkg.MutationLog()
    log.add_edges(rng.integers(0, N, n_edge), rng.integers(0, N, n_edge))
    pick = rng.choice(src.size, n_edge, replace=False)
    log.remove_edges(src[pick], dst[pick])
    log.update_features(rng.choice(N, n_feat, replace=False),
                        rng.standard_normal((n_feat, D), dtype=np.float32))
    batch = log.drain()
    return batch, pkg.apply_edge_mutations(g, batch)


def _run_job(ri, store, g2, batch, chunk):
    job = ri.begin_refresh(store, g2, batch.feat_ids, batch.feat_rows,
                           batch.affected_dsts(), chunk_rows=chunk)
    n_steps = 0
    while not job.done:
        info = job.step()
        n_steps += 1
        assert info["rows"] <= chunk
    stats = job.finish()
    assert stats["n_chunks"] == n_steps
    return stats


@pytest.mark.parametrize("executor", ["ref", "cuda"])
@pytest.mark.parametrize("chunk", [7, 64, 10 ** 9])
def test_chunked_refresh_bitwise_equals_inline(world, executor, chunk):
    """Any chunk size commits the exact bytes of the one-shot refresh;
    the chunk count, frontiers and version are the JAX package's, and
    the rows agree with it within tolerance."""
    batch, g2 = _batch(world, 31)
    ri_a, store_a = _fresh(world, executor)
    stats_a = ri_a.refresh(store_a, g2, batch.feat_ids, batch.feat_rows,
                           batch.affected_dsts())
    ri_b, store_b = _fresh(world, executor)
    stats_b = _run_job(ri_b, store_b, g2, batch, chunk)
    jbatch, jg2 = _batch(world, 31, pkg=jgs)
    jri, jstore = _fresh(world, pkg=jgs)
    jstats = _run_job(jri, jstore, jg2, jbatch, chunk)
    assert stats_b == jstats
    assert stats_b["version"] == stats_a["version"] == 1
    assert stats_b["frontier_sizes"] == stats_a["frontier_sizes"]
    if chunk < N:
        assert stats_b["n_chunks"] > stats_a["n_chunks"]
    all_ids = np.arange(N)
    for lvl in range(1, L + 1):
        got = store_b.lookup(all_ids, lvl)
        np.testing.assert_array_equal(got, store_a.lookup(all_ids, lvl))
        np.testing.assert_allclose(got, jstore.lookup(all_ids, lvl),
                                   atol=ATOL, rtol=RTOL)


def test_refresh_job_abort_rolls_back_store_and_graphs(world):
    batch, g2 = _batch(world, 51)
    ri, store = _fresh(world)
    before = store.lookup(np.arange(N), -1).copy()
    nbr0 = ri.layer_graphs[0].nbr.copy()
    job = ri.begin_refresh(store, g2, batch.feat_ids, batch.feat_rows,
                           batch.affected_dsts(), chunk_rows=16)
    job.step()
    job.abort()
    assert store.version == 0
    np.testing.assert_array_equal(store.lookup(np.arange(N), -1), before)
    np.testing.assert_array_equal(ri.layer_graphs[0].nbr, nbr0)
    with pytest.raises(AssertionError):
        job.step()
    ri2, store2 = _fresh(world)
    ri2.refresh(store2, g2, batch.feat_ids, batch.feat_rows,
                batch.affected_dsts())
    ri.refresh(store, g2, batch.feat_ids, batch.feat_rows,
               batch.affected_dsts())
    np.testing.assert_array_equal(store.lookup(np.arange(N), -1),
                                  store2.lookup(np.arange(N), -1))


def _engine(world, pkg, chunk_rows, executor="cuda"):
    ri, store = _fresh(world, executor, pkg)
    return pkg.EmbeddingServeEngine(
        store, ri, world[0], batch_slots=4, rows_per_step=64,
        tenants=pkg.parse_tenants("ui:4:2:0:4,batch:1:1:0:64"),
        refresh_chunk_rows=chunk_rows)


@pytest.mark.parametrize("executor", ["ref", "cuda"])
def test_chunked_engine_bitwise_equals_inline_engine(world, executor):
    """The same tick-drained traffic through a chunked and an inline QoS
    engine of the port, and a chunked one of the JAX package: every
    query's version agrees, the port's two bitwise, the JAX package's
    within tolerance."""
    engines = [_engine(world, tgs, 0, executor),
               _engine(world, tgs, 16, executor), _engine(world, jgs, 16)]
    rng = np.random.default_rng(71)
    triples = []
    for tick in range(10):
        ids = {"ui": rng.integers(0, N, 24), "batch": rng.integers(0, N, 96)}
        qs = []
        for eng in engines:
            mod = tgs if isinstance(eng, tgs.EmbeddingServeEngine) else jgs
            row = [mod.Query(uid=tick, node_ids=ids[name], tenant=name)
                   for name in ("ui", "batch")]
            for q in row:
                eng.submit(q)
            qs.append(row)
        s_e, d_e = rng.integers(0, N, 3), rng.integers(0, N, 3)
        fid = rng.choice(N, 4, replace=False)
        frows = rng.standard_normal((4, D), dtype=np.float32)
        for eng in engines:
            eng.mutate().add_edges(s_e, d_e)
            eng.mutate().update_features(fid, frows)
            eng.run()
        triples += list(zip(*qs))
    inline, chunked, jchunked = engines
    assert inline.n_refreshes == chunked.n_refreshes > 0
    assert chunked.n_refresh_chunks == jchunked.n_refresh_chunks \
        > chunked.n_refreshes
    for qi, qc, qj in triples:
        assert qi.served_version == qc.served_version == qj.served_version
        np.testing.assert_array_equal(qi.out, qc.out)
        np.testing.assert_allclose(qc.out, qj.out, atol=ATOL, rtol=RTOL)
    for lvl in range(1, L + 1):
        np.testing.assert_array_equal(inline.store.lookup(np.arange(N), lvl),
                                      chunked.store.lookup(np.arange(N),
                                                           lvl))


def test_chunk_spans_and_counters_emitted(world):
    """Under telemetry each chunk emits a ``refresh.chunk`` span inside a
    ``refresh.layer`` span, and the frontier rows are counted, with the
    names the JAX package uses."""
    from repro_torch import obs
    batch, g2 = _batch(world, 61)
    ri, store = _fresh(world)
    tel = obs.Telemetry()
    with obs.use(tel):
        stats = _run_job(ri, store, g2, batch, 32)
    names = [ev[0] for ev in tel.tracer.events_in_order()]
    assert names.count("refresh.chunk") == stats["n_chunks"]
    assert names.count("refresh.layer") == stats["n_chunks"]
    assert "refresh.resample" in names and "refresh.frontier" in names
    assert tel.counters["delta.frontier_rows"] == sum(
        stats["frontier_sizes"])
