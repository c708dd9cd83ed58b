"""The port's block-size table and autotuner (``repro_torch.tuning``)
against the JAX package's (``repro.tuning``): the mirrors of
``tests/test_kernels.py::test_autotune_roundtrip`` and
``::test_executor_consults_block_table``, the shared key format and
JSON file, the port's own grids and default table, and a tuned session
bitwise an untuned one on the CPU (the wrappers' plain versions there;
``tests/test_torch_gpu.py`` holds the kernels' tilings on the card)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import tuning as jtuning  # noqa: E402
from repro_torch import tuning  # noqa: E402
from repro_torch.api import (ConfigError, DealConfig, ExecutorSpec,  # noqa
                             GraphSpec, ModelSpec, Session)
from repro_torch.core.ops import CudaExecutor, DenseIO  # noqa: E402
from repro_torch.kernels.spmm import check_tiling  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_autotune_roundtrip(tmp_path, monkeypatch):
    """ensure_tuned searches the candidate grid once (injected timer),
    persists the winner, serves later calls from the file, and re-runs
    only under REPRO_TUNING=autotune."""
    monkeypatch.delenv("REPRO_TUNING", raising=False)
    path = tmp_path / "blocks.json"
    table = tuning.BlockTable(path=path)
    current, seen = {}, []

    def make_call(blocks):
        def fn():
            current.clear()
            current.update(blocks)
        return fn

    def timer(fn, repeats):
        fn()
        seen.append(dict(current))
        # (4, 16) always wins
        return (abs(current["block_rows"] - 4)
                + abs(current["block_cols"] - 16) + 1.0)

    blocks = tuning.ensure_tuned(table, "spmm", make_call, N=100,
                                 timer=timer)
    assert blocks == {"block_rows": 4, "block_cols": 16}
    assert path.exists() and seen     # searched and persisted
    # every tiling of the grid was tried
    grid = tuning.KERNEL_GRIDS["spmm"]
    assert sorted((c["block_rows"], c["block_cols"]) for c in seen) == \
        sorted((r, c) for r in grid["block_rows"]
               for c in grid["block_cols"])

    # a fresh load serves the whole shape bucket without re-searching
    t2 = tuning.BlockTable.load(path)
    n_calls = len(seen)
    assert tuning.ensure_tuned(t2, "spmm", make_call, N=100,
                               timer=timer) == blocks
    assert tuning.ensure_tuned(t2, "spmm", make_call, N=128,
                               timer=timer) == blocks
    assert len(seen) == n_calls
    assert t2.lookup("spmm", N=100) == blocks   # `us` stays out of lookup

    # forcing invalidates the persisted winner
    monkeypatch.setenv("REPRO_TUNING", "autotune")
    assert tuning.autotune_forced()
    tuning.ensure_tuned(t2, "spmm", make_call, N=100, timer=timer)
    assert len(seen) > n_calls


def _dense_io(rng, R, U, F, table=True):
    nbr = rng.integers(0, U, (R, F)).astype(np.int32)
    mask = rng.random((R, F)) > 0.25
    tbl = rng.permutation(U).astype(np.int32) if table else None
    return DenseIO(nbr, mask, table=tbl, device="cpu")


def test_executor_consults_block_table(rng):
    """A bound BlockTable sets the tiling per (kernel, shape bucket,
    dtype), a miss keeps the wrapper's default, and tuned equals
    untuned bitwise (a tiling never changes a row's order of sums)."""
    N, U, D, F = 64, 64, 128, 8
    tb = tuning.BlockTable()
    tb.put("gather_spmm", N=N, D=D, backend="cpu",
           blocks={"block_rows": 16, "block_cols": 8})
    ex = CudaExecutor(device="cpu", block_table=tb)
    assert ex._pick_blocks("gather_spmm", N, D, torch.float32) == \
        {"block_rows": 16, "block_cols": 8}
    assert ex._pick_blocks("spmm", N, D, torch.float32) == {}
    # a card's entry does not serve the CPU executor
    tb.put("spmm", N=N, D=D, backend="cuda",
           blocks={"block_rows": 2, "block_cols": 32})
    assert CudaExecutor(device="cpu", block_table=tb)._pick_blocks(
        "spmm", N, D, torch.float32) == {}

    io = _dense_io(rng, N, U, F)
    h = torch.from_numpy(rng.standard_normal((U, D)).astype(np.float32))
    got = ex.spmm(h, io.mean_w, io)
    base = CudaExecutor(device="cpu").spmm(h, io.mean_w, io)
    assert torch.equal(got, base)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 100, 128, 129, 4096,
                               1_048_576, 1_048_577])
def test_shape_bucket_and_keys_match_jax(n):
    assert tuning.shape_bucket(n) == jtuning.shape_bucket(n)
    for kernel, backend, dtype, d in (("spmm", "cuda", "float32", 128),
                                      ("gather_spmm", "cpu", "bfloat16",
                                       20)):
        assert tuning.table_key(kernel, backend, dtype, n, d) == \
            jtuning.table_key(kernel, backend, dtype, n, d)


def test_port_table_loads_in_the_jax_package(tmp_path):
    """The same JSON: a table the port writes loads with
    ``repro.tuning.BlockTable.load`` and answers the same lookups, and
    the other way round."""
    path = tmp_path / "t.json"
    t = tuning.BlockTable(path=path)
    key = t.put("spmm", N=1_048_576, D=128, backend="cuda",
                blocks={"block_rows": 4, "block_cols": 32}, us=412.34)
    assert key == "spmm/cuda/float32/n1048576/d128"
    t.save()
    j = jtuning.BlockTable.load(path)
    assert j.entries == t.entries == {
        key: {"block_rows": 4, "block_cols": 32, "us": 412.3}}
    assert j.lookup("spmm", N=1_000_000, D=128, backend="cuda") == \
        t.lookup("spmm", N=1_000_000, D=128, backend="cuda") == \
        {"block_rows": 4, "block_cols": 32}
    j.put("gather_spmm", N=64, D=128, backend="cuda",
          blocks={"block_n": 16})
    j.save()
    assert tuning.BlockTable.load(path).entries == j.entries


def test_default_table_is_the_ports_own(tmp_path):
    assert tuning.DEFAULT_TABLE_PATH.name == "tuned_blocks_torch.json"
    assert tuning.DEFAULT_TABLE_PATH != jtuning.DEFAULT_TABLE_PATH
    assert tuning.DEFAULT_TABLE_PATH.parent == \
        jtuning.DEFAULT_TABLE_PATH.parent           # configs/
    got = tuning.resolve_block_table("default")
    assert got.path == tuning.DEFAULT_TABLE_PATH
    assert tuning.resolve_block_table(None) is None
    assert tuning.resolve_block_table("none") is None
    assert tuning.resolve_block_table(got) is got
    p = tmp_path / "x.json"
    p.write_text(json.dumps({"spmm/cpu/float32/n8/d8": {"block_rows": 1,
                                                        "block_cols": 8}}))
    assert tuning.resolve_block_table(str(p)).lookup(
        "spmm", N=3, D=5, backend="cpu") == {"block_rows": 1,
                                             "block_cols": 8}
    # the executor spec reaches the same table
    ex = ExecutorSpec(name="cuda", block_table="default").build(
        device="cpu")
    assert ex._blocks.path == tuning.DEFAULT_TABLE_PATH


def test_candidates_are_pruned_by_the_wrappers_check(monkeypatch):
    """The grid is the wrappers' knobs, pruned up front by the wrapper's
    own tiling check; a kernel whose wrapper takes no tiling has no
    grid."""
    assert set(tuning.KERNEL_GRIDS) == {"spmm", "gather_spmm"}
    for kernel in ("spmm", "gather_spmm"):
        for c in tuning.candidates(kernel, 1_048_576, 128):
            check_tiling(kernel, c["block_rows"], c["block_cols"])
    monkeypatch.setitem(tuning.KERNEL_GRIDS, "spmm",
                        {"block_rows": (0, 2, 64), "block_cols": (32,)})
    assert tuning.candidates("spmm", 1000, 128) == [
        {"block_rows": 2, "block_cols": 32}]      # 0 and 64 x 32 refused
    for kernel in ("gat_attention", "sddmm", "flash_attention"):
        with pytest.raises(ValueError, match="no tiling grid"):
            tuning.candidates(kernel, 1000, 128)
    for bad in ((0, 8), (8, 0), (64, 32)):
        with pytest.raises(ValueError, match="1024 threads"):
            check_tiling("spmm", *bad)


def test_a_failing_launch_ends_the_search():
    """No candidate is skipped because its launch raised (the JAX search
    skips it): the error reaches the caller."""
    def make_call(blocks):
        def fn():
            if blocks["block_rows"] == 4:
                raise RuntimeError("injected launch failure")
        return fn

    with pytest.raises(RuntimeError, match="injected"):
        tuning.autotune_op(tuning.BlockTable(), "spmm", make_call, N=64,
                           timer=lambda fn, repeats: (fn(), 1.0)[1])


def _cfg(**executor):
    return DealConfig(
        graph=GraphSpec(dataset="rmat", n_nodes=96, avg_degree=4,
                        fanout=4, seed=2),
        model=ModelSpec(name="gcn", n_layers=2, d_feature=16),
        executor=ExecutorSpec(name="cuda", **executor))


def test_tuned_session_is_bitwise_untuned_on_the_cpu(tmp_path):
    path = tmp_path / "tuned.json"
    t = tuning.BlockTable(path=path)
    for kernel in ("spmm", "gather_spmm"):
        t.put(kernel, N=96, D=16, backend="cpu",
              blocks={"block_rows": 8, "block_cols": 16})
    t.save()
    with Session.build(_cfg(block_table=str(path)), device="cpu") as s:
        assert s.executor._pick_blocks("spmm", 96, 16, torch.float32) == \
            {"block_rows": 8, "block_cols": 16}
        tuned = s.infer_all()
    with Session.build(_cfg(), device="cpu") as s:
        assert s.executor._blocks is None
        untuned = s.infer_all()
    assert torch.equal(tuned, untuned)


def test_block_table_validation_matches_jax():
    """A str or None, as the JAX package validates it; the executors
    that take no tiling refuse a table when they are built."""
    from repro.api.config import DealConfig as JDealConfig
    d = {"executor": {"name": "cuda", "block_table": 7}}
    with pytest.raises(ConfigError, match="executor.block_table: must be "
                       "a str or None, got 7"):
        DealConfig.from_dict(d).validate()
    with pytest.raises(Exception, match="executor.block_table: must be "
                       "a str or None, got 7"):
        JDealConfig.from_dict({"executor": {"name": "pallas",
                                            "block_table": 7}}).validate()
    DealConfig.from_dict({"executor": {"name": "cuda",
                                       "block_table": "default"}}).validate()
    for name in ("ref", "dist"):
        with pytest.raises(ConfigError, match="takes no tiling"):
            ExecutorSpec(name=name, block_table="default").build(
                device="cpu")


def test_the_committed_default_table_holds_grid_tilings():
    """``configs/tuned_blocks_torch.json`` (the winners of
    ``chip_smoke.py``'s [tune] on the card) loads in both packages, keys
    only the kernels with a grid, and every entry is a tiling the
    wrapper takes from that grid."""
    table = tuning.BlockTable.load()
    assert table.entries, "the port's default table is missing"
    assert jtuning.BlockTable.load(tuning.DEFAULT_TABLE_PATH).entries == \
        table.entries
    for key, entry in table.entries.items():
        kernel, backend, dtype, n, d = key.split("/")
        assert kernel in tuning.KERNEL_GRIDS and backend == "cuda"
        blocks = {k: v for k, v in entry.items() if k.startswith("block_")}
        assert blocks in tuning.candidates(kernel, int(n[1:]), int(d[1:]))
        assert entry["us"] > 0
