"""World checkpoints across the two packages: the port writes the JAX
package's ``.npz`` format, so a world saved by either restores in the
other and serves the same bytes; ``Session.from_checkpoint`` serves
bitwise what the saved engine served.  Mirrors
``tests/test_checkpoint.py``."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
import repro.gnnserve.checkpoint as jck  # noqa: E402
from repro.gnnserve.engine import Query as JQuery  # noqa: E402
from repro_torch.api import ConfigError, DealConfig, Session  # noqa: E402
from repro_torch.core.gnn_models import params_from_numpy  # noqa: E402
from repro_torch.gnnserve import Query  # noqa: E402
from repro_torch.gnnserve import checkpoint as tck  # noqa: E402

D, N = 16, 160


def _cfg(*, budget_rows=0, executor="ref"):
    return {"graph": {"dataset": "rmat", "n_nodes": N, "avg_degree": 4,
                      "fanout": 4, "seed": 5},
            "model": {"name": "gcn", "n_layers": 2, "d_feature": D},
            "executor": {"name": executor},
            "store": {"onboarding": "tail", "budget_rows": budget_rows},
            "qos": {"staleness_bound": 4}}


def _jax_params():
    with japi.Session.build(japi.DealConfig.from_dict(_cfg())) as s:
        return jax.tree_util.tree_map(np.asarray, s.params)


def _port(d, **kw):
    return Session.build(DealConfig.from_dict(d), device="cpu",
                         params=params_from_numpy("gcn", _jax_params(),
                                                  "cpu"), **kw)


def _churn(eng, query, *, ticks=4, seed=9):
    r = np.random.default_rng(seed)
    for t in range(ticks):
        log = eng.mutate()
        for _ in range(4):
            a, b = r.integers(0, N, 2)
            log.add_edge(int(a), int(b))
        ids = np.unique(r.integers(0, N, 3).astype(np.int64))
        log.update_features(ids, r.standard_normal((ids.size, D))
                            .astype(np.float32))
        eng.submit(query(t, r.integers(0, N, 10).astype(np.int64)))
        eng.run()


def _serve(eng, query):
    q = query(100, np.arange(0, 120, dtype=np.int64))
    eng.submit(q)
    eng.run()
    return q.out.copy(), q.served_version


@pytest.mark.parametrize("budget_rows", [0, 64])
def test_from_checkpoint_serves_bitwise(tmp_path, budget_rows):
    d = _cfg(budget_rows=budget_rows, executor="cuda")
    path = tmp_path / "world.npz"
    with _port(d) as s:
        eng = s.serve()
        _churn(eng, Query)
        meta = tck.save_world(path, eng, committed_seq=7)
        counters = (eng.n_refreshes, eng.ops_drained, eng.n_full_epochs)
        want = _serve(eng, Query)
    assert tck.peek_meta(path) == meta and meta["committed_seq"] == 7
    with Session.from_checkpoint(path, DealConfig.from_dict(d),
                                 device="cpu",
                                 params=params_from_numpy(
                                     "gcn", _jax_params(), "cpu")) as s2:
        eng2 = s2.engine
        assert (eng2.n_refreshes, eng2.ops_drained,
                eng2.n_full_epochs) == counters
        got = _serve(eng2, Query)
        assert got[1] == want[1] and np.array_equal(got[0], want[0])
        _churn(eng2, Query, ticks=2, seed=13)     # keeps serving
        assert s2.stats()["store_version"] > want[1]


def test_jax_world_restores_in_the_port(tmp_path):
    """A world saved by ``repro.gnnserve.checkpoint.save_world`` restores
    in the port and serves the same bytes."""
    path = tmp_path / "jax_world.npz"
    with japi.Session.build(japi.DealConfig.from_dict(_cfg())) as js:
        eng = js.serve()
        _churn(eng, JQuery)
        jck.save_world(path, eng)
        want = _serve(eng, JQuery)
    with Session.from_checkpoint(path,
                                 DealConfig.from_dict(_cfg(executor="cuda")),
                                 device="cpu",
                                 params=params_from_numpy(
                                     "gcn", _jax_params(), "cpu")) as s:
        got = _serve(s.engine, Query)
        assert got[1] == want[1] and np.array_equal(got[0], want[0])


def test_port_world_restores_in_jax(tmp_path):
    """And the other way round: the port's artifact loads in the JAX
    package, whose restored engine serves the same bytes."""
    path = tmp_path / "port_world.npz"
    with _port(_cfg(executor="cuda")) as s:
        eng = s.serve()
        _churn(eng, Query)
        tck.save_world(path, eng)
        want = _serve(eng, Query)
        lgs = [lg.nbr.copy() for lg in eng.reinfer.layer_graphs]
    meta, graph, jlgs, store = jck.load_world(path)
    assert meta["format"] == tck.FORMAT == jck.FORMAT
    for a, b in zip(lgs, jlgs):
        np.testing.assert_array_equal(a, b.nbr)
    with japi.Session.from_checkpoint(
            path, japi.DealConfig.from_dict(_cfg())) as js:
        got = _serve(js.engine, JQuery)
        assert got[1] == want[1] and np.array_equal(got[0], want[0])


def test_from_checkpoint_rejects_cluster_configs(tmp_path):
    path = tmp_path / "world.npz"
    with _port(_cfg()) as s:
        tck.save_world(path, s.serve())
        with pytest.raises(AssertionError):
            tck.restore_into_session(s, path)   # engine already attached
    d = _cfg()
    d["cluster"] = {"n_shards": 2}
    with pytest.raises(ConfigError, match="cluster"):
        Session.from_checkpoint(path, DealConfig.from_dict(d),
                                device="cpu")
