"""The port's own copies of the numpy graph build and sampler give
bitwise the same edge lists, CSR and layer graphs as ``repro``'s."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import graph as jgraph  # noqa: E402
from repro.core import sampler as jsampler  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import sampler as tsampler  # noqa: E402


def _same_graph(a, b):
    assert a.n_nodes == b.n_nodes
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indptr.dtype == b.indptr.dtype
    assert a.indices.dtype == b.indices.dtype


def test_rmat_and_csr_match(small_graph):
    src, dst = tgraph.rmat_edges(256, 2048, seed=7)
    jsrc, jdst = jgraph.rmat_edges(256, 2048, seed=7)
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(dst, jdst)
    _same_graph(tgraph.csr_from_edges(src, dst, 256), small_graph)


@pytest.mark.parametrize("n_workers,chunk", [(1, 1 << 20), (3, 100),
                                             (4, 517)])
def test_distributed_csr_matches(n_workers, chunk):
    src, dst = tgraph.rmat_edges(512, 4096, seed=3)
    g, stats = tgraph.csr_from_edges_distributed(
        src, dst, 512, n_workers=n_workers, chunk_edges=chunk)
    jg, jstats = jgraph.csr_from_edges_distributed(
        src, dst, 512, n_workers=n_workers, chunk_edges=chunk)
    _same_graph(g, jg)
    assert stats["exchanged_bytes"] == jstats["exchanged_bytes"]
    # and the distributed build is the single-machine CSR
    _same_graph(g, tgraph.csr_from_edges(src, dst, 512))


@pytest.mark.parametrize("name", ["ogbn-products", "social-spammer",
                                  "ogbn-papers100M"])
def test_datasets_match(name):
    got = tgraph.make_dataset(name, seed=1, scale=1 / 32)
    want = jgraph.make_dataset(name, seed=1, scale=1 / 32)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert tgraph.dataset_names() == jgraph.dataset_names()


@pytest.mark.parametrize("fanout,n_layers,seed", [(8, 3, 3), (4, 2, 0),
                                                  (16, 1, 9)])
def test_layer_graphs_match(small_graph, fanout, n_layers, seed):
    got = tsampler.sample_layer_graphs(small_graph, fanout, n_layers,
                                       seed=seed)
    want = jsampler.sample_layer_graphs(small_graph, fanout, n_layers,
                                        seed=seed)
    assert len(got) == len(want) == n_layers
    for a, b in zip(got, want):
        assert a.fanout == b.fanout and a.n_nodes == b.n_nodes
        assert a.nbr.dtype == b.nbr.dtype == np.int32
        np.testing.assert_array_equal(a.nbr, b.nbr)
        np.testing.assert_array_equal(a.mask, b.mask)
        # every id is in range, masked slots included: the kernels
        # gather without bounds checks
        assert a.nbr.min() >= 0 and a.nbr.max() < small_graph.n_nodes


def test_draw_fixed_fanout_matches_on_isolated_rows():
    deg = np.array([0, 1, 3, 9, 0], np.int64)
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    indices = np.arange(int(deg.sum()), dtype=np.int32)
    got = tsampler.draw_fixed_fanout(deg, starts, indices, indices.size, 4,
                                     np.random.default_rng(2))
    want = jsampler.draw_fixed_fanout(deg, starts, indices, indices.size, 4,
                                      np.random.default_rng(2))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not got[1][0].any() and not got[1][4].any()
