"""The port's feature-prep loaders (mirrors tests/test_feature_prep.py):
the fused loader is a drop-in for redistribute numerically while its
accounting shows the shuffle pass is gone (Fig 13 / Fig 21), each loader
gives repro's outputs and row counts exactly, and the fully fused
loader is bitwise the materialized pipeline through the same
executor."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import feature_prep as jfp  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.feature_prep import (fused_load,  # noqa: E402
                                           fused_load_spmm,
                                           redistribute_load, scan_all_load,
                                           write_feature_files)

N, D, OUT, M = 256, 16, 8, 4


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    path = tmp_path_factory.mktemp("feats")
    files, feats = write_feature_files(str(path), N, D, n_files=8, seed=0)
    w = np.random.default_rng(0).standard_normal((D, OUT)).astype(np.float32)
    return files, feats, w


def test_fused_matches_redistribute_numerically(prepared):
    files, feats, w = prepared
    x_redist, _ = redistribute_load(files, M, N, D)
    h_fused, stats = fused_load(files, M, N, D, w)
    np.testing.assert_allclose(h_fused, x_redist @ w, atol=1e-5, rtol=1e-5)
    assert stats["table"].shape == (N,)
    assert np.array_equal(np.sort(stats["table"]), np.arange(N))


def test_fused_byte_counts_skip_shuffle(prepared):
    files, feats, w = prepared
    _, s_redist = redistribute_load(files, M, N, D)
    _, s_fused = fused_load(files, M, N, D, w)
    assert s_fused["file_rows"] == s_redist["file_rows"] == N
    assert s_redist["net_rows"] > 0
    assert s_fused["net_rows"] == 0


def test_scan_all_reads_everything_m_times(prepared):
    files, feats, w = prepared
    x, s = scan_all_load(files, M, N, D)
    np.testing.assert_array_equal(x, feats)
    assert s["file_rows"] == M * N and s["net_rows"] == 0


@pytest.mark.parametrize("n_machines", [1, 3, 4, 8])
@pytest.mark.parametrize("loader", ["scan_all_load", "redistribute_load",
                                    "fused_load"])
def test_loaders_equal_repro(prepared, loader, n_machines):
    files, feats, w = prepared
    args = (files, n_machines, N, D) + ((w,) if loader == "fused_load"
                                        else ())
    out, stats = globals()[loader](*args)
    jout, jstats = getattr(jfp, loader)(*args)
    np.testing.assert_array_equal(out, jout)
    assert set(stats) == set(jstats)
    for key in ("file_rows", "net_rows"):
        assert stats[key] == jstats[key]
    if "table" in stats:
        np.testing.assert_array_equal(stats["table"], jstats["table"])


@pytest.mark.parametrize("loader,name", [
    ("scan_all_load", "scan_all"), ("redistribute_load", "redistribute"),
    ("fused_load", "fused")])
def test_loader_spans_and_counters(prepared, loader, name):
    """Each loader runs under ``featprep.<name>`` with its file and
    network rows counted, under the JAX package's names."""
    files, feats, w = prepared
    args = (files, M, N, D) + ((w,) if loader == "fused_load" else ())
    tel = obs.Telemetry(clock=obs.FakeClock())
    with obs.use(tel):
        _, stats = globals()[loader](*args)
    (ev,) = tel.tracer.events_in_order()
    assert ev[0] == f"featprep.{name}" and ev[4] == {"n_machines": M}
    assert tel.counters == {f"featprep.{name}.file_rows": stats["file_rows"],
                            f"featprep.{name}.net_rows": stats["net_rows"]}


@pytest.fixture(scope="module")
def layer1():
    from repro_torch.core.graph import csr_from_edges, rmat_edges
    from repro_torch.core.sampler import sample_layer_graphs
    src, dst = rmat_edges(N, N * 8, seed=3)
    g = csr_from_edges(src, dst, N)
    return sample_layer_graphs(g, fanout=4, n_layers=1, seed=1)[0]


@pytest.mark.parametrize("executor", ["ref", "cuda"])
def test_fused_spmm_bitwise_and_shuffle_free(prepared, layer1, executor):
    """The fully fused loader (loader-order GEMM + table-indirect
    aggregation) is bitwise the materialized pipeline through the same
    executor, and pays no shuffle traffic."""
    from repro_torch.core.ops import DenseIO, get_executor
    files, feats, w = prepared
    ex = get_executor(executor, device="cpu")
    agg, stats = fused_load_spmm(files, M, N, D, w, layer1, ex)
    io = DenseIO.from_layer_graph(layer1, "cpu")
    want = ex.spmm(ex.gemm(ex.prepare(feats), w), io.mean_w, io)
    assert torch.equal(agg, want)
    assert stats["net_rows"] == 0 and stats["file_rows"] == N
    assert np.array_equal(np.sort(stats["table"]), np.arange(N))
