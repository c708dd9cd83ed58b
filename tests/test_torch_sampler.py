"""The port's sampler (``repro_torch.core.sampler``) against
``repro.core.sampler``, mirroring ``tests/test_sampler.py``: sampled
neighbors are true in-neighbors, small rows take every neighbor, layers
are independent, draws are deterministic, and the ego baseline and the
layer-graph frontiers (``test_ego_baseline_and_frontiers``) — each also
bitwise the JAX package's from the same seed.  Then the deprecated
``launch.infer_gnn.run`` shim, bitwise ``Session.infer_all`` on the CPU,
as ``tests/test_api.py`` proves it for JAX."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import graph as jgraph  # noqa: E402
from repro.core import sampler as jsampler  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import sampler as tsampler  # noqa: E402


@pytest.fixture(scope="module")
def graphs():
    """The conftest's small graph, built by each package."""
    src, dst = jgraph.rmat_edges(256, 2048, seed=7)
    tsrc, tdst = tgraph.rmat_edges(256, 2048, seed=7)
    np.testing.assert_array_equal(src, tsrc)
    np.testing.assert_array_equal(dst, tdst)
    return (jgraph.csr_from_edges(src, dst, 256),
            tgraph.csr_from_edges(src, dst, 256))


@pytest.fixture(scope="module")
def layer_graphs(graphs):
    return tsampler.sample_layer_graphs(graphs[1], fanout=8, n_layers=3,
                                        seed=3)


def test_layer_graphs_equal_jax_bitwise(graphs, layer_graphs):
    want = jsampler.sample_layer_graphs(graphs[0], fanout=8, n_layers=3,
                                        seed=3)
    for a, b in zip(layer_graphs, want):
        np.testing.assert_array_equal(a.nbr, b.nbr)
        np.testing.assert_array_equal(a.mask, b.mask)


def test_sampled_neighbors_are_real(graphs, layer_graphs):
    g = graphs[1]
    for lg in layer_graphs:
        for v in range(0, g.n_nodes, 17):
            true = set(g.neighbors(v).tolist())
            got = lg.nbr[v][lg.mask[v]]
            if not true:
                assert not lg.mask[v].any()
            else:
                assert set(got.tolist()) <= true


def test_small_rows_take_every_neighbor(graphs, layer_graphs):
    g = graphs[1]
    deg = g.degrees()
    lg = layer_graphs[0]
    for v in np.where((deg > 0) & (deg <= lg.fanout))[0][:50]:
        got = sorted(set(lg.nbr[v][lg.mask[v]].tolist()))
        assert got == sorted(set(g.neighbors(v).tolist()))


def test_layers_are_independent(graphs):
    lgs = tsampler.sample_layer_graphs(graphs[1], fanout=4, n_layers=2,
                                       seed=0)
    assert not np.array_equal(lgs[0].nbr, lgs[1].nbr)


def test_deterministic(graphs):
    a = tsampler.sample_layer_graphs(graphs[1], fanout=4, n_layers=2, seed=5)
    b = tsampler.sample_layer_graphs(graphs[1], fanout=4, n_layers=2, seed=5)
    assert np.array_equal(a[0].nbr, b[0].nbr)
    assert np.array_equal(a[1].mask, b[1].mask)


def test_ego_baseline_and_frontiers(graphs, layer_graphs):
    targets = np.arange(8)
    egos = tsampler.sample_ego_networks(graphs[1], targets, fanout=4,
                                        n_layers=2)
    assert len(egos) == 8 and all(len(h) == 3 for h in egos)
    fr = tsampler.frontier_sizes(layer_graphs[:2], targets)
    assert fr[0].size <= fr[1].size <= fr[2].size


@pytest.mark.parametrize("fanout,n_layers,seed", [(4, 2, 0), (2, 3, 9)])
def test_ego_networks_equal_jax_bitwise(graphs, fanout, n_layers, seed):
    targets = np.array([0, 5, 17, 200, 255, 5])
    want = jsampler.sample_ego_networks(graphs[0], targets, fanout,
                                        n_layers, seed=seed)
    got = tsampler.sample_ego_networks(graphs[1], targets, fanout,
                                       n_layers, seed=seed)
    assert len(got) == len(want)
    for hops, jhops in zip(got, want):
        assert len(hops) == len(jhops) == n_layers + 1
        for a, b in zip(hops, jhops):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("targets", [np.arange(8), np.array([3, 3, 100]),
                                     np.array([], np.int64)])
def test_frontier_sizes_equal_jax(graphs, layer_graphs, targets):
    want = jsampler.frontier_sizes(
        jsampler.sample_layer_graphs(graphs[0], fanout=8, n_layers=3,
                                     seed=3), targets)
    got = tsampler.frontier_sizes(layer_graphs, targets)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


SCALE = 256 / 8192          # tests/test_api.py: ogbn-products at 256 nodes


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_infer_gnn_shim_equals_session_bitwise(model):
    """``run(..., distributed=False)`` maps "dist" to "ref" as JAX does,
    and returns bitwise what a Session built from the same config
    returns."""
    from repro_torch.api import (DealConfig, ExecutorSpec, GraphSpec,
                                 ModelSpec, PartitionSpec, Session)
    from repro_torch.launch.infer_gnn import run
    H = run("ogbn-products", model, p=2, m=1, fanout=4, n_layers=2,
            d_feature=16, distributed=False, scale=SCALE, device="cpu")
    cfg = DealConfig(
        graph=GraphSpec(dataset="ogbn-products", scale=SCALE, fanout=4,
                        seed=0, n_construct_workers=2),
        model=ModelSpec(name=model, n_layers=2, d_feature=16),
        partition=PartitionSpec(p=2, m=1),
        executor=ExecutorSpec(name="ref"))
    with Session.build(cfg, device="cpu") as s:
        want = s.infer_all()
        assert s.executor.name == "ref"
    assert H.shape == want.shape and H.device.type == "cpu"
    assert bool((H == want).all())


def test_infer_gnn_shim_defaults_to_the_card():
    """Without ``device`` the shim asks for "cuda", which raises on a
    machine without a card (and runs there on one)."""
    import torch
    from repro_torch.launch.infer_gnn import run
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run("ogbn-products", "gcn", fanout=4, n_layers=2, d_feature=16,
            distributed=False, scale=SCALE)
