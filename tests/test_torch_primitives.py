"""The port's §3.4 primitives (``repro_torch.core.primitives``) on a CPU
mesh in one process: every GEMM, SPMM and SDDMM variant against
``repro.kernels.ref`` on the same numpy inputs, at the tolerances of
tests/helpers/dist_check.py (GEMM 5e-5, SPMM 2e-5, SDDMM 2e-4), through
the kernels' wrappers ("cuda", which run their plain versions on the
CPU) and the plain versions ("ref"); the bytes each collective copies
against the analytic volumes; and the ``Sharded`` container."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import primitives as prim  # noqa: E402
from repro_torch.core.gnn_models import mean_weights  # noqa: E402
from repro_torch.core.ops import DistExecutor, gemm_rows  # noqa: E402
from repro_torch.core.partition import build_plan, comm_volume  # noqa
from repro_torch.core.sampler import sample_layer_graphs  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402

MESHES = [(1, 1), (2, 1), (4, 2), (2, 4)]
N, D = 256, 64


@pytest.fixture(scope="module")
def world(small_graph):
    """conftest's graph, one layer graph, and X, W, q from a seed."""
    from repro_torch.core.graph import Graph
    g = Graph(indptr=small_graph.indptr, indices=small_graph.indices,
              n_nodes=small_graph.n_nodes)
    lg = sample_layer_graphs(g, fanout=8, n_layers=1, seed=0)[0]
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D), dtype=np.float32)
    W = rng.standard_normal((D, 32), dtype=np.float32) * 0.1
    q = rng.standard_normal((N, D), dtype=np.float32)
    return lg, X, W, q


def _ex(P, M, **kw):
    return DistExecutor(make_host_mesh(P, M, device="cpu"), **kw)


@pytest.mark.parametrize("P,M", MESHES)
@pytest.mark.parametrize("variant", ["deal", "deal_ring", "cagnet"])
def test_gemm_variants_match_repro(P, M, variant, world):
    _, X, W, _ = world
    ex = _ex(P, M, gemm_variant=variant)
    got = ex.gemm(ex.prepare(X), torch.from_numpy(W)).to_global("cpu")
    want = np.asarray(jref.gemm_ref(jnp.asarray(X), jnp.asarray(W)))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)
    # bytes: deal's two tiled all-to-alls move (M-1)/M of H and of the
    # output; cagnet's reduce-scatter M-1 column slices of its partials
    nd, nd_out = N * D * 4, N * W.shape[1] * 4
    want_bytes = {"deal": (nd + nd_out) * (M - 1) // M,
                  "deal_ring": (nd + nd_out) * (M - 1) // M,
                  "cagnet": nd_out * (M - 1)}[variant]
    assert ex.comm["gemm"] == want_bytes


def test_gemm_deal_is_bitwise_one_devices_gemm(world):
    """Every row of the DEAL GEMM is one ``gemm_rows`` product of the
    full-width row: the bits of the single-device executors."""
    _, X, W, _ = world
    ex = _ex(4, 2)
    got = ex.gemm(ex.prepare(X), torch.from_numpy(W)).to_global("cpu")
    assert torch.equal(got, gemm_rows(torch.from_numpy(X),
                                      torch.from_numpy(W)))


@pytest.mark.parametrize("P,M", MESHES)
@pytest.mark.parametrize("variant,grouped", [
    ("deal", True), ("deal", False), ("graph_exchange", True),
    ("allgather", True)])
@pytest.mark.parametrize("kernels", ["cuda", "ref"])
def test_spmm_variants_match_repro(P, M, variant, grouped, kernels, world):
    lg, X, _, _ = world
    ex = _ex(P, M, spmm_variant=variant, grouped=grouped, kernels=kernels)
    io = ex.bind([lg])[0]
    got = ex.spmm(ex.prepare(X), io.mean_w, io).to_global("cpu")
    w = mean_weights(lg.mask)
    want = np.asarray(jref.spmm_ref(jnp.asarray(X), jnp.asarray(w),
                                    jnp.asarray(lg.nbr),
                                    jnp.asarray(lg.mask)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    vol = comm_volume(build_plan([lg], P, M), D)["layer0"]
    if variant == "deal":
        # the unpadded rows DEAL ships, over all M column shards
        assert ex.comm["spmm"] == M * vol["deal_feature_exchange_B"]
        assert ex.comm["spmm_padded"] >= ex.comm["spmm"]
    elif variant == "graph_exchange":
        assert ex.comm["spmm"] == M * vol["graph_exchange_B"]
    else:
        assert ex.comm["spmm"] == (P - 1) * N * D * 4


@pytest.mark.parametrize("P,M", MESHES)
@pytest.mark.parametrize("variant", ["deal", "dup"])
@pytest.mark.parametrize("grouped", [True, False])
def test_sddmm_variants_match_repro(P, M, variant, grouped, world):
    lg, X, _, q = world
    ex = _ex(P, M, sddmm_variant=variant, grouped=grouped)
    io = ex.bind([lg], need_sddmm=True)[0]
    xch = prim.Exchange(ex.mesh)
    got = prim.sddmm_ring(ex.prepare(q), ex.prepare(X), io.deal, xch,
                          grouped, "cuda", variant)
    want = np.asarray(jref.sddmm_ref(jnp.asarray(q), jnp.asarray(X),
                                     jnp.asarray(lg.nbr),
                                     jnp.asarray(lg.mask)))
    for p in range(P):
        for m in range(M):              # every shard holds the scores
            blk = got.blocks[p][m].numpy()
            np.testing.assert_allclose(blk, want[p * N // P:
                                                 (p + 1) * N // P],
                                       atol=2e-4, rtol=0)
            assert (blk[~lg.mask[p * N // P:(p + 1) * N // P]] == 0).all()


def test_grouped_and_monolithic_sddmm_are_bitwise(world):
    """Each slot's score comes from one group (+0.0 elsewhere), so the
    grouped sum is exact: both schedules give the same bits."""
    lg, X, _, q = world
    outs = []
    for grouped in (True, False):
        ex = _ex(4, 2, grouped=grouped)
        io = ex.bind([lg], need_sddmm=True)[0]
        s = ex.attn_scores(ex.prepare(q), ex.prepare(X), io, 1)
        outs.append(s.to_global("cpu"))
    assert torch.equal(outs[0], outs[1])


def test_gat_scores_need_heads_to_divide_m(world):
    lg, X, _, q = world
    ex = _ex(2, 2)
    io = ex.bind([lg], need_sddmm=True)[0]
    with pytest.raises(ValueError, match="must divide the model axis"):
        ex.attn_scores(ex.prepare(q), ex.prepare(X), io, 4)


def test_sharded_maps_elementwise_functions_blockwise(world):
    _, X, _, _ = world
    mesh = make_host_mesh(4, 2, device="cpu")
    H = prim.shard_rows(mesh, X)
    assert tuple(H.shape) == (N, D) and len(H.blocks[3]) == 2
    assert H.blocks[1][1].shape == (N // 4, D // 2)
    relu = torch.nn.functional.relu(H)
    assert isinstance(relu, prim.Sharded)
    assert torch.equal(relu.to_global(), torch.relu(torch.from_numpy(X)))
    assert torch.equal((H + H).to_global(), torch.from_numpy(X) * 2)
    w = prim.shard_rows(mesh, np.ones((N, 8), np.float32), split_cols=False)
    assert w.blocks[0][0] is w.blocks[0][1]     # one tensor per device
    assert tuple(w.shape) == (N, 8)
    with pytest.raises(ValueError, match="does not split"):
        prim.shard_rows(mesh, X[:255])


def test_executor_refuses_unknown_variants():
    for kw in ({"spmm_variant": "ring"}, {"gemm_variant": "x"},
               {"sddmm_variant": "y"}, {"kernels": "pallas"}):
        with pytest.raises(ValueError, match="is not one of"):
            _ex(2, 1, **kw)
