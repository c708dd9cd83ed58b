"""The port's QoS scheduler, store and mutation log against the JAX
package's, op for op on the same inputs (the code is numpy, so the
results are equal exactly), and the multi-tenant engine end to end:
the same schedule, versions and tenant stats as ``repro``, rows within
atol 1e-4, rtol 3e-3, and each tenant's reads bitwise a solo engine's
at its SLO.  Mirrors ``tests/test_gnnserve_qos.py`` and
``tests/test_gnnserve_properties.py``."""
import copy

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
import repro.gnnserve as jgs  # noqa: E402
from repro.core.gnn_models import init_gcn  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import gnnserve as tgs  # noqa: E402
from repro_torch.core.gnn_models import params_from_numpy  # noqa: E402
from repro_torch.core.graph import csr_from_edges, rmat_edges  # noqa: E402
from repro_torch.core.ops import CudaExecutor, RefExecutor  # noqa: E402
from repro_torch.core.sampler import sample_layer_graphs  # noqa: E402

N, D, L, FANOUT = 256, 16, 2, 4
ATOL, RTOL = 1e-4, 3e-3
TENANTS = "ui:4:2:0:4,batch:1:1:0:64"


@pytest.fixture(scope="module")
def world():
    src, dst = rmat_edges(N, N * 6, seed=5)
    g = csr_from_edges(src, dst, N)
    lgs = sample_layer_graphs(g, fanout=FANOUT, n_layers=L, seed=2)
    X = np.random.default_rng(3).standard_normal((N, D), dtype=np.float32)
    jp = jax.tree_util.tree_map(np.asarray, init_gcn(jax.random.PRNGKey(0),
                                                     [D] * (L + 1)))
    return g, lgs, X, jp


def _engine(pkg, world, *, tenants=None, bound=64, executor="ref"):
    """One engine of ``pkg`` (the port's ``tgs`` or ``jgs``) over the
    world; both packages' numpy graphs are interchangeable."""
    g, lgs, X, jp = world
    params = jp
    if pkg is tgs:
        params = params_from_numpy("gcn", jp, "cpu")
        executor = {"ref": RefExecutor, "cuda": CudaExecutor}[executor](
            "cpu")
    ri = pkg.DeltaReinference([copy.deepcopy(lg) for lg in lgs], "gcn",
                              params, executor=executor)
    store = pkg.store_from_inference(X, ri.full_levels(X)[1:], n_shards=4)
    reg = pkg.parse_tenants(tenants) if tenants else None
    return pkg.EmbeddingServeEngine(store, ri, g, batch_slots=4,
                                    rows_per_step=64, staleness_bound=bound,
                                    tenants=reg)


def _drive(engines, seed, ticks=10, tenants=True):
    """The same tick-drained traffic through each engine: per engine, the
    queries in submission order."""
    rng = np.random.default_rng(seed)
    out = [[] for _ in engines]
    for tick in range(ticks):
        ids = {"ui": rng.integers(0, N, 24), "batch": rng.integers(0, N, 96)}
        s_e, d_e = rng.integers(0, N, 3), rng.integers(0, N, 3)
        for i, eng in enumerate(engines):
            mod = tgs if isinstance(eng, tgs.EmbeddingServeEngine) else jgs
            for name in ("ui", "batch"):
                q = mod.Query(uid=tick, node_ids=ids[name],
                              tenant=name if tenants else "default")
                eng.submit(q)
                out[i].append(q)
            eng.mutate().add_edges(s_e, d_e)
            eng.run()
    return out


def _strip_times(tree):
    if isinstance(tree, dict):
        return {k: _strip_times(v) for k, v in tree.items()
                if not (k.endswith("_ms") or k.endswith("_s"))}
    return tree


# ----------------------------------------------------------------------
# parsing and the scheduler alone
# ----------------------------------------------------------------------

def test_parse_tenants_matches_repro():
    text = "ui:4:2:0:8,batch:1.5:1:96:512"
    reg, jreg = tgs.parse_tenants(text), jgs.parse_tenants(text)
    assert reg.names == jreg.names == ["ui", "batch"]
    for name in reg.names:
        assert vars(reg[name]) == vars(jreg[name])
    assert reg.total_quota == jreg.total_quota == 3
    assert tapi.tenants_from_string(text) == japi.tenants_from_string(text)
    for bad in ("ui:4:2:0", "a:0:1:0:8"):
        with pytest.raises(tapi.ConfigError) as ei:
            tapi.tenants_from_string(bad)
        with pytest.raises(japi.ConfigError) as ej:
            japi.tenants_from_string(bad)
        assert str(ei.value) == str(ej.value)
    with pytest.raises(AssertionError):
        tgs.QoSScheduler(tgs.parse_tenants("a:1:3:0:8,b:1:2:0:8"),
                         batch_slots=4, rows_per_step=64)


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_grants_match_repro(seed):
    """Random demands and refresh charges: every grant, token balance and
    stats entry equals the JAX scheduler's."""
    rng = np.random.default_rng(seed)
    n_t = int(rng.integers(1, 4))
    B = int(rng.integers(n_t, 7))
    budget = int(rng.integers(4, 200))
    specs = [dict(name=f"t{i}", priority=float(rng.integers(1, 8)),
                  slot_quota=1, rate=float(rng.choice([0, 0, 4, 16])),
                  staleness_slo=8) for i in range(n_t)]
    scheds = [pkg.QoSScheduler(pkg.TenantRegistry(
        [pkg.TenantSpec(**s) for s in specs]), batch_slots=B,
        rows_per_step=budget) for pkg in (tgs, jgs)]
    for _ in range(20):
        charge = (float(rng.integers(0, 4 * budget))
                  if rng.random() < 0.3 else None)
        active, used = [], set()
        for _ in range(int(rng.integers(1, B + 1))):
            slot = int(rng.integers(0, B))
            if slot not in used:
                used.add(slot)
                active.append((slot, f"t{int(rng.integers(0, n_t))}",
                               int(rng.integers(0, 3 * budget))))
        grants = []
        for sch in scheds:
            if charge is not None:
                sch.charge_refresh(charge)
            grants.append(sch.allocate(list(active), budget))
        assert grants[0] == grants[1]
        for s in specs:
            assert (scheds[0].state(s["name"]).tokens
                    == scheds[1].state(s["name"]).tokens)
    assert scheds[0].stats() == scheds[1].stats()


# ----------------------------------------------------------------------
# the multi-tenant engine
# ----------------------------------------------------------------------

@pytest.mark.parametrize("executor", ["ref", "cuda"])
def test_qos_engine_matches_repro(world, executor):
    eng = _engine(tgs, world, tenants=TENANTS, executor=executor)
    jeng = _engine(jgs, world, tenants=TENANTS)
    qs, jqs = _drive([eng, jeng], seed=17)
    assert eng.n_refreshes == jeng.n_refreshes > 0
    for q, jq in zip(qs, jqs):
        assert q.done and jq.done
        assert (q.served_version, q.tenant) == (jq.served_version,
                                                jq.tenant)
        np.testing.assert_allclose(q.out, jq.out, atol=ATOL, rtol=RTOL)
    assert _strip_times(eng.stats()) == _strip_times(jeng.stats())


@pytest.mark.parametrize("executor", ["ref", "cuda"])
def test_tenant_bitwise_equals_solo_run(world, executor):
    """Each tenant reads, bitwise, what a single-tenant engine at its
    SLO serves (lagged per-tenant views over one shared store)."""
    multi = _engine(tgs, world, tenants=TENANTS, executor=executor)
    solos = {name: _engine(tgs, world, bound=slo, executor=executor)
             for name, slo in (("ui", 4), ("batch", 64))}
    rng = np.random.default_rng(17)
    pairs = []
    for tick in range(12):
        ids = {"ui": rng.integers(0, N, 24), "batch": rng.integers(0, N, 96)}
        for name in ("ui", "batch"):
            qm = tgs.Query(uid=tick, node_ids=ids[name], tenant=name)
            qs = tgs.Query(uid=tick, node_ids=ids[name])
            multi.submit(qm)
            solos[name].submit(qs)
            pairs.append((qm, qs))
        s_e, d_e = rng.integers(0, N, 2), rng.integers(0, N, 2)
        for e in (multi, *solos.values()):
            e.mutate().add_edges(s_e, d_e)
            e.run()
    assert multi.n_refreshes > 0
    for qm, qs in pairs:
        assert qm.served_version == qs.served_version
        np.testing.assert_array_equal(qm.out, qs.out)


def test_unknown_tenant_rejected_like_repro(world):
    for pkg in (tgs, jgs):
        eng = _engine(pkg, world, tenants=TENANTS)
        with pytest.raises(KeyError, match="unknown tenant 'nobody'"):
            eng.submit(pkg.Query(uid=0, node_ids=np.arange(4),
                                 tenant="nobody"))


# ----------------------------------------------------------------------
# store and mutation log under random operation sequences
# ----------------------------------------------------------------------

def _store_ops(rng, n_ops=40):
    """A random op sequence as data, replayable on either store."""
    ops = []
    for _ in range(n_ops):
        op = str(rng.choice(["lookup", "staged_lookup", "begin", "write",
                             "commit", "abort", "evict", "snapshot",
                             "snap_read"]))
        k = int(rng.integers(1, 32))
        ops.append((op, rng.integers(0, 64, k), int(rng.integers(0, 3)),
                    int(rng.integers(1, 3)), int(rng.integers(0, 4)),
                    rng.standard_normal((k, 4)).astype(np.float32)))
    return ops


def _replay_store(pkg, levels, budget, policy, ops):
    """Run ``ops`` on a budgeted store of ``pkg``; returns every value it
    served or raised, in order, and its final stats."""
    store = pkg.EmbeddingStore([a.copy() for a in levels], n_shards=4,
                               budget_rows=budget, evict_policy=policy)
    truth = {"c": [a.copy() for a in levels], "s": None}
    store.recompute = lambda level, ids, staged: (
        truth["s"] if staged and truth["s"] is not None
        else truth["c"])[level][ids]
    seen, snaps = [], []
    for op, ids, level, lvl1, shard, rows in ops:
        open_ = store._staged is not None
        if op == "lookup":
            seen.append(store.lookup(ids, level))
        elif op == "staged_lookup" and open_:
            seen.append(store.lookup_staged(ids, level))
        elif op == "begin" and not open_:
            store.begin_update()
            truth["s"] = [a.copy() for a in truth["c"]]
        elif op == "write" and open_:
            u = np.unique(ids)
            store.write_rows(level, u, rows[:u.size])
            truth["s"][level][u] = rows[:u.size]
        elif op == "commit" and open_:
            store.commit()
            truth["c"], truth["s"] = truth["s"], None
        elif op == "abort" and open_:
            store.abort()
            truth["s"] = None
        elif op == "evict":
            store.evict(lvl1, shard)
        elif op == "snapshot":
            u = np.unique(ids)
            snaps.append((store.pinned_snapshot(u, level), u, level))
        elif op == "snap_read" and snaps:
            snap, u, lvl = snaps[shard % len(snaps)]
            seen.append(snap.lookup(u, lvl))
            try:
                seen.append(snap.lookup(ids, level))
            except pkg.SnapshotMiss:
                seen.append("miss")
    seen += [store.lookup(np.arange(64), lvl) for lvl in range(3)]
    return seen, store.version, _strip_times(store.stats())


@pytest.mark.parametrize("policy", ["heat", "lru"])
@pytest.mark.parametrize("seed", range(3))
def test_store_op_sequences_match_repro(policy, seed):
    rng = np.random.default_rng(seed)
    levels = [rng.standard_normal((64, 4)).astype(np.float32)
              for _ in range(3)]
    budget = int(rng.integers(16, 64))
    ops = _store_ops(rng)
    got = _replay_store(tgs, levels, budget, policy, ops)
    want = _replay_store(jgs, levels, budget, policy, ops)
    assert len(got[0]) == len(want[0])
    for a, b in zip(got[0], want[0]):
        if isinstance(a, str) or isinstance(b, str):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
    assert got[1:] == want[1:]


@pytest.mark.parametrize("seed", range(3))
def test_mutation_log_drain_requeue_matches_repro(seed):
    rng = np.random.default_rng(seed)
    pairs = [(int(rng.integers(0, 32)), int(rng.integers(0, 32)),
              bool(rng.random() < 0.5)) for _ in range(30)]
    feat = (rng.integers(0, 32, 4),
            rng.standard_normal((4, D)).astype(np.float32))
    batches = []
    for pkg in (tgs, jgs):
        log = pkg.MutationLog()
        for s, d, add in pairs:
            (log.add_edge if add else log.remove_edge)(s, d)
        log.update_features(*feat)
        log.add_nodes(2, np.ones((2, D), np.float32))
        pending = log.pending
        b1 = log.drain()
        log.requeue(b1)
        assert log.pending == pending
        batches.append(log.drain())
    a, b = batches
    assert a.edge_ops == b.edge_ops and a.n_ops == b.n_ops
    np.testing.assert_array_equal(a.feat_ids, b.feat_ids)
    np.testing.assert_array_equal(a.feat_rows, b.feat_rows)
    np.testing.assert_array_equal(a.new_node_rows, b.new_node_rows)
