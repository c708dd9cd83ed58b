"""The port's layer programs and executors against ``repro``'s.

``run_layer`` for gcn, sage and gat (1 and 4 heads) through the port's
``RefExecutor`` and ``CudaExecutor`` (on CPU tensors: the plain versions
behind the same executor code) against ``repro``'s ``RefExecutor`` and
``PallasExecutor(use_kernel=True)`` (Pallas in interpret mode), with the
reference's params carried across by ``params_from_numpy``.  Shapes are
non-aligned, as in tests/test_kernels.py:186.  Plus the fused / unfused
switches, and the §3.5 fused feature prep."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import feature_prep as jfp  # noqa: E402
from repro.core import gnn_models as jgm  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro_torch.core import feature_prep as tfp  # noqa: E402
from repro_torch.core import gnn_models as tgm  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402

# the executor-level tolerance of tests/test_kernels.py:235
ATOL, RTOL = 1e-4, 3e-3
INITS = {"gcn": lambda k, d, h: jgm.init_gcn(k, d),
         "sage": lambda k, d, h: jgm.init_sage(k, d),
         "gat": lambda k, d, h: jgm.init_gat(k, d, heads=h)}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if hasattr(x, "shape") else x, tree)


def _world(model, heads, R, U, D, F, seed=0):
    """One layer's inputs for both packages: params, io, h_tgt, h_src."""
    rng = np.random.default_rng(seed)
    jparams = INITS[model](jax.random.PRNGKey(seed), [D, D], heads)
    tparams = tgm.params_from_numpy(model, _numpy_tree(jparams), "cpu")
    nbr = rng.integers(0, U, (R, F)).astype(np.int32)
    mask = rng.random((R, F)) > 0.25
    mask[0] = False                              # an isolated row
    h_src = rng.standard_normal((U, D)).astype(np.float32)
    h_tgt = rng.standard_normal((R, D)).astype(np.float32)
    return (jgm.model_spec(model, jparams).layers[0],
            tgm.model_spec(model, tparams).layers[0],
            jops.DenseIO(nbr, mask), tops.DenseIO(nbr, mask, device="cpu"),
            h_tgt, h_src)


CASES = [("gcn", 1), ("sage", 1), ("gat", 1), ("gat", 4)]
SHAPES = [(23, 37, 20, 6), (50, 50, 32, 8)]


@pytest.mark.parametrize("model,heads", CASES)
@pytest.mark.parametrize("R,U,D,F", SHAPES)
def test_run_layer_matches_repro(model, heads, R, U, D, F):
    jl, tl, jio, tio, h_tgt, h_src = _world(model, heads, R, U, D, F)
    want_ref = np.asarray(jops.run_layer(
        jops.RefExecutor(), jl, jio, jnp.asarray(h_tgt),
        jnp.asarray(h_src), heads))
    want_pallas = np.asarray(jops.run_layer(
        jops.PallasExecutor(use_kernel=True), jl, jio, jnp.asarray(h_tgt),
        jnp.asarray(h_src), heads))
    for ex in (tops.RefExecutor("cpu"), tops.CudaExecutor("cpu")):
        got = tops.run_layer(ex, tl, tio, torch.from_numpy(h_tgt),
                             torch.from_numpy(h_src), heads).numpy()
        assert got.shape == (R, D)
        np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got, want_pallas, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("R,U,D,F", SHAPES)
def test_fused_attention_matches_unfused(heads, R, U, D, F):
    """The peephole fires only on the fused executor, and the fused
    layer agrees with the per-head sddmm + softmax path within 1e-6."""
    _, tl, _, tio, h_tgt, h_src = _world("gat", heads, R, U, D, F, seed=1)
    fused = tops.CudaExecutor("cpu", fused_attention=True)
    unfused = tops.CudaExecutor("cpu", fused_attention=False)
    assert fused.attn_scores_softmax is not None
    assert unfused.attn_scores_softmax is None
    args = (tio, torch.from_numpy(h_tgt), torch.from_numpy(h_src), heads)
    np.testing.assert_allclose(tops.run_layer(fused, tl, *args).numpy(),
                               tops.run_layer(unfused, tl, *args).numpy(),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("heads", [1, 4])
def test_cuda_attn_scores_match_ref_on_strided_views(heads):
    """q and k as column slices of one wider projection (row-strided):
    CudaExecutor hands each head's slice to sddmm uncopied, and on the
    CPU its scores equal RefExecutor's at the live slots (the softmax
    fills the masked ones; sddmm leaves 0 there)."""
    rng = np.random.default_rng(6)
    R, U, D, F = 23, 37, 32, 6
    nbr = rng.integers(0, U, (R, F)).astype(np.int32)
    mask = rng.random((R, F)) > 0.25
    io = tops.DenseIO(nbr, mask, device="cpu")
    proj = torch.from_numpy(
        rng.standard_normal((U, 3 * D)).astype(np.float32))
    q, k = proj[:R, :D], proj[:, D:2 * D]
    assert not q.is_contiguous() and not k.is_contiguous()
    got = tops.CudaExecutor("cpu").attn_scores(q, k, io, heads)
    want = tops.RefExecutor("cpu").attn_scores(q.contiguous(),
                                               k.contiguous(), io, heads)
    assert got.shape == (R, F, heads)
    live = torch.from_numpy(mask)
    np.testing.assert_allclose(got[live].numpy(), want[live].numpy(),
                               atol=1e-6, rtol=1e-6)
    assert bool((got[~live] == 0).all())


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("fused_table", [False, True])
def test_attend_is_one_spmm_matching_pallas(monkeypatch, heads, fused_table):
    """CudaExecutor.attend is one spmm over all heads (alpha (R, F, heads)
    read in place, no copies, no cat), equal on the CPU to repro's
    PallasExecutor(use_kernel=True).attend, which runs one Pallas spmm
    per head in interpret mode."""
    rng = np.random.default_rng(heads + 2 * fused_table)
    R, U, D, F = 24, 40, 32, 6
    nbr = rng.integers(0, U, (R, F)).astype(np.int32)
    mask = rng.random((R, F)) > 0.25
    mask[0] = False
    table = rng.permutation(U).astype(np.int32) if fused_table else None
    alpha = rng.random((R, F, heads)).astype(np.float32)
    v = rng.standard_normal((U, D)).astype(np.float32)
    want = np.asarray(jops.PallasExecutor(use_kernel=True).attend(
        jnp.asarray(alpha), jnp.asarray(v),
        jops.DenseIO(nbr, mask, table=table), heads))
    calls = []
    for name in ("spmm", "gather_spmm"):
        fn = getattr(tops.kops, name)
        monkeypatch.setattr(tops.kops, name,
                            lambda *a, fn=fn, name=name: calls.append(name)
                            or fn(*a))
    tio = tops.DenseIO(nbr, mask, table=table, device="cpu")
    got = tops.CudaExecutor("cpu").attend(torch.from_numpy(alpha),
                                          torch.from_numpy(v), tio, heads)
    assert calls == ["gather_spmm" if fused_table else "spmm"]
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * F, rtol=3e-2)
    assert (got.numpy()[0] == 0).all()


@pytest.mark.parametrize("model", ["gcn", "sage"])
def test_fused_gather_matches_unfused_bitwise(model):
    rng = np.random.default_rng(4)
    R, U, D, F = 50, 61, 32, 8
    nbr = rng.integers(0, U, (R, F)).astype(np.int32)
    mask = rng.random((R, F)) > 0.25
    io = tops.DenseIO(nbr, mask, table=rng.permutation(U), device="cpu")
    h = torch.from_numpy(rng.standard_normal((U, D)).astype(np.float32))
    got = [tops.CudaExecutor("cpu", fused_gather=fg).spmm(h, io.mean_w, io)
           for fg in (True, False)]
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0], tops.RefExecutor("cpu").spmm(h, io.mean_w,
                                                             io))


def test_dense_io_table_is_int32_and_resolves_like_repro():
    rng = np.random.default_rng(2)
    nbr = rng.integers(0, 30, (10, 4)).astype(np.int32)
    mask = rng.random((10, 4)) > 0.5
    table = rng.permutation(30).astype(np.int64)   # the loader's dtype
    tio = tops.DenseIO(nbr, mask, table=table, device="cpu")
    jio = jops.DenseIO(nbr, mask, table=table)
    assert tio.table.dtype == torch.int32
    np.testing.assert_array_equal(tio.nbr_resolved.numpy(),
                                  np.asarray(jio.nbr_resolved))
    np.testing.assert_array_equal(tio.mean_w.numpy(), np.asarray(jio.mean_w))


@pytest.mark.parametrize("model,heads", CASES)
def test_params_from_numpy_round_trip(model, heads):
    jparams = _numpy_tree(INITS[model](jax.random.PRNGKey(3), [8, 8, 8],
                                       heads))
    got = tgm.params_from_numpy(model, jparams, "cpu")
    flat_j = jax.tree_util.tree_leaves(jparams)
    flat_t = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x: x.numpy() if hasattr(x, "numpy")
                               else x, got))
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tgm.params_from_numpy("sage" if model != "sage" else "gcn",
                              jparams, "cpu")


def test_port_init_is_seeded_and_shaped():
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    a = tgm.init_gat(gen(), [16, 16, 16], heads=4)
    b = tgm.init_gat(gen(), [16, 16, 16], heads=4)
    assert a["heads"] == 4 and len(a["layers"]) == 2
    for la, lb in zip(a["layers"], b["layers"]):
        for k in ("wq", "wk", "wv"):
            assert la[k].shape == (16, 16) and torch.equal(la[k], lb[k])
    assert tgm.init_sage(gen(), [4, 8])["layers"][0]["w_nbr"].shape == (4, 8)
    assert tgm.init_gcn(gen(), [4, 8, 2])["w"][1].shape == (8, 2)


@pytest.fixture(scope="module")
def feature_files(tmp_path_factory):
    N, D = 256, 16
    tdir = tmp_path_factory.mktemp("port_feats")
    jdir = tmp_path_factory.mktemp("jax_feats")
    files, feats = tfp.write_feature_files(str(tdir), N, D, n_files=8,
                                           seed=0)
    jfiles, jfeats = jfp.write_feature_files(str(jdir), N, D, n_files=8,
                                             seed=0)
    np.testing.assert_array_equal(feats, jfeats)
    return files, feats, N, D


def test_fused_load_spmm_matches_repro(feature_files, layer_graphs):
    files, feats, N, D = feature_files
    w = np.random.default_rng(0).standard_normal((D, 8)).astype(np.float32)
    lg = layer_graphs[0]
    want, jstats = jfp.fused_load_spmm(files, 4, N, D, w, lg,
                                       jops.PallasExecutor(use_kernel=True))
    for ex in (tops.CudaExecutor("cpu"), tops.RefExecutor("cpu")):
        got, stats = tfp.fused_load_spmm(files, 4, N, D, w, lg, ex)
        assert got.shape == (N, 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(stats["table"], jstats["table"])
        assert stats["file_rows"] == N and stats["net_rows"] == 0
    # the fused route equals the unfused one over node-ordered rows
    ex = tops.CudaExecutor("cpu")
    io = tops.DenseIO.from_layer_graph(lg, device="cpu")
    unfused = ex.spmm(ex.gemm(ex.prepare(feats), w), io.mean_w, io)
    got, _ = tfp.fused_load_spmm(files, 4, N, D, w, lg, ex)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("fault", ["missing", "duplicate", "out_of_range"])
def test_fused_load_spmm_refuses_files_without_every_id(tmp_path, fault,
                                                        layer_graphs):
    N, D = 256, 16
    files, _ = tfp.write_feature_files(str(tmp_path), N, D, n_files=8,
                                       seed=0)
    z = np.load(files[0])
    ids, rows = z["ids"].copy(), z["rows"]
    if fault == "missing":
        ids, rows = ids[1:], rows[1:]
    elif fault == "duplicate":
        ids[0] = ids[1]
    else:
        ids[0] = N
    np.savez(files[0], ids=ids, rows=rows)
    w = np.ones((D, 8), np.float32)
    with pytest.raises(ValueError, match="each of the 256 node ids once"):
        tfp.fused_load_spmm(files, 4, N, D, w, layer_graphs[0],
                            tops.CudaExecutor("cpu"))


@pytest.mark.parametrize("M", [1, 300, 16384, 16385, 40000])
def test_gemm_rows_bits_do_not_depend_on_the_row_count(M):
    """gemm_rows computes every row in a torch.matmul call of GEMM_ROWS
    rows, so the rows of any subset carry the bits of the full call (the
    invariant delta refresh needs), and it is the plain GEMM within
    rounding."""
    from repro_torch.core.ops import gemm_rows
    from repro_torch.kernels.ref import gemm_ref
    rng = np.random.default_rng(M)
    h = torch.from_numpy(rng.standard_normal((40000, 24), np.float32))
    w = torch.from_numpy(rng.standard_normal((24, 16), np.float32))
    full = gemm_rows(h, w)
    idx = torch.from_numpy(rng.choice(40000, M, replace=False))
    assert torch.equal(gemm_rows(h[idx], w), full[idx])
    np.testing.assert_allclose(full.numpy(), gemm_ref(h, w).numpy(),
                               atol=1e-5, rtol=1e-5)
