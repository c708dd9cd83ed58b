"""The port's layer-wise engines, ego-batched baseline and sharing
analytics against ``repro`` (mirrors tests/test_layerwise.py): the
baseline equals the layer-wise engine and smaller batches do strictly
more work; the three local engines agree with repro's (atol 1e-4, rtol
3e-3) with repro's params carried across; the sharing tables and the
feature loaders give repro's numbers exactly."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import feature_prep as jfp  # noqa: E402
from repro.core import layerwise as jlw  # noqa: E402
from repro.core import sharing as jsharing  # noqa: E402
from repro.core.gnn_models import init_gat, init_gcn, init_sage  # noqa
from repro_torch.core import feature_prep as tfp  # noqa: E402
from repro_torch.core import sharing  # noqa: E402
from repro_torch.core.gnn_models import params_from_numpy  # noqa: E402
from repro_torch.core.graph import csr_from_edges, rmat_edges  # noqa: E402
from repro_torch.core.layerwise import (LOCAL_ENGINES,  # noqa: E402
                                        ego_batched_gcn_infer,
                                        local_gcn_infer)
from repro_torch.core.sampler import sample_layer_graphs  # noqa: E402

ATOL, RTOL = 1e-4, 3e-3


@pytest.fixture(scope="module")
def lgs(layer_graphs):
    """The port's layer graphs of conftest's graph: repro's, bit for bit."""
    src, dst = rmat_edges(256, 2048, seed=7)
    out = sample_layer_graphs(csr_from_edges(src, dst, 256), fanout=8,
                              n_layers=3, seed=3)
    for a, b in zip(out, layer_graphs):
        np.testing.assert_array_equal(a.nbr, b.nbr)
        np.testing.assert_array_equal(a.mask, b.mask)
    return out


@pytest.fixture(scope="module")
def feats(lgs):
    rng = np.random.default_rng(1)
    return rng.standard_normal((lgs[0].n_nodes, 32), dtype=np.float32)


def _params(model, dims=(32, 32, 16)):
    key = jax.random.PRNGKey(0)
    jp = {"gcn": lambda: init_gcn(key, list(dims)),
          "gat": lambda: init_gat(key, list(dims), heads=4),
          "sage": lambda: init_sage(key, list(dims))}[model]()
    jp = jax.tree_util.tree_map(
        lambda x: np.asarray(x) if hasattr(x, "shape") else x, jp)
    return jp, params_from_numpy(model, jp, "cpu")


@pytest.mark.parametrize("executor", ["ref", "cuda"])
@pytest.mark.parametrize("batch_size", [16, 64, 256])
def test_ego_batched_matches_layerwise(lgs, feats, executor, batch_size):
    """The baseline gives the layer-wise engine's embeddings; through
    the cuda executor's code path bitwise (every GEMM call has the same
    row count and every row sums its slots in order)."""
    _, params = _params("gcn")
    want = local_gcn_infer(lgs[:2], feats, params, executor=executor,
                           device="cpu")
    got, work = ego_batched_gcn_infer(lgs[:2], feats, params,
                                      batch_size=batch_size,
                                      executor=executor, device="cpu")
    assert got.shape == want.shape and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(got, want)
    # the same work as repro's baseline, and the same embeddings
    jp, _ = _params("gcn")
    jgot, jwork = jlw.ego_batched_gcn_infer(lgs[:2], feats, jp,
                                            batch_size=batch_size)
    assert work == jwork
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=ATOL,
                               rtol=RTOL)


def test_ego_batched_redundancy(lgs, feats):
    """Smaller batches -> strictly more GEMM rows than DEAL's k*N."""
    _, params = _params("gcn")
    N = lgs[0].n_nodes
    _, work_small = ego_batched_gcn_infer(lgs[:2], feats, params,
                                          batch_size=16, device="cpu")
    _, work_big = ego_batched_gcn_infer(lgs[:2], feats, params,
                                        batch_size=N, device="cpu")
    assert work_small > work_big >= 2 * N


@pytest.mark.parametrize("executor", ["ref", "cuda"])
@pytest.mark.parametrize("model", ["gcn", "gat", "sage"])
def test_local_engines_match_repro(model, lgs, feats, executor):
    jp, params = _params(model)
    want = np.asarray(jlw.LOCAL_ENGINES[model](lgs[:2], feats, jp))
    H = LOCAL_ENGINES[model](lgs[:2], feats, params, executor=executor,
                             device="cpu")
    assert tuple(H.shape) == (lgs[0].n_nodes, 16)
    assert bool(torch.isfinite(H).all())
    np.testing.assert_allclose(H.numpy(), want, atol=ATOL, rtol=RTOL)


def test_local_engines_take_an_executor_instance_and_reject_names(lgs,
                                                                  feats):
    from repro_torch.core.ops import RefExecutor
    _, params = _params("gcn")
    a = local_gcn_infer(lgs[:2], feats, params, executor=RefExecutor("cpu"))
    b = local_gcn_infer(lgs[:2], feats, params, executor="ref",
                        device="cpu")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="registered"):
        local_gcn_infer(lgs[:2], feats, params, executor="pallas",
                        device="cpu")


def test_local_engine_needs_a_card_unless_asked_for_the_cpu(lgs, feats):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    _, params = _params("gcn")
    with pytest.raises(RuntimeError, match="CUDA"):
        local_gcn_infer(lgs[:2], feats, params)


def test_sharing_analytics_equal_repro(lgs):
    t = sharing.sharing_table(lgs, batch_size=32)
    assert t == jsharing.sharing_table(lgs, batch_size=32)
    assert t["deal"] == 1.0
    assert 0.0 <= t["p3"] <= t["dgi_batched"] <= 1.0
    fractions = (0.05, 0.25, 1.0)
    curve = sharing.sharing_vs_batch_size(lgs, fractions=fractions)
    assert curve == jsharing.sharing_vs_batch_size(lgs, fractions=fractions)
    vals = list(curve.values())
    assert vals == sorted(vals)
    assert vals[-1] > 0.99


@pytest.mark.parametrize("fn,args", [
    ("batched_cost", (16,)), ("nosharing_cost", ()), ("p3_cost", (16,)),
    ("salientpp_cost", (16,))])
def test_sharing_cost_models_equal_repro(lgs, fn, args):
    assert getattr(sharing, fn)(lgs, *args) == \
        getattr(jsharing, fn)(lgs, *args)


def test_feature_prep_equivalence(tmp_path):
    N, D, M = 256, 16, 4
    files, feats = tfp.write_feature_files(str(tmp_path), N, D, n_files=8)
    w = np.random.default_rng(0).standard_normal((D, 8)).astype(np.float32)
    x1, s1 = tfp.scan_all_load(files, M, N, D)
    x2, s2 = tfp.redistribute_load(files, M, N, D)
    np.testing.assert_array_equal(x1, feats)
    np.testing.assert_array_equal(x2, feats)
    h1, s3 = tfp.fused_load(files, M, N, D, w)
    np.testing.assert_allclose(h1, feats @ w, atol=1e-5)
    assert s1["file_rows"] == M * N
    assert s2["file_rows"] == N
    assert s3["net_rows"] == 0
    # repro's loaders: the same outputs and byte counts
    for ours, theirs, out in ((s1, jfp.scan_all_load(files, M, N, D), x1),
                              (s2, jfp.redistribute_load(files, M, N, D),
                               x2),
                              (s3, jfp.fused_load(files, M, N, D, w), h1)):
        np.testing.assert_array_equal(out, theirs[0])
        assert ours["file_rows"] == theirs[1]["file_rows"]
        assert ours["net_rows"] == theirs[1]["net_rows"]
    np.testing.assert_array_equal(s3["table"], theirs[1]["table"])
