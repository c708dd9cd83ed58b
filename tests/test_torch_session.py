"""The port's public surface against ``repro``'s: ``Session.infer_all``
parity for gcn, sage and gat with the reference's params carried across,
the config tree's round-trip and validation against the port's own
registries, the launcher's ``--dump-config``/``--config`` round-trip,
and the rule that a missing card raises unless the caller asks for the
CPU."""
import pathlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
from repro.api.registry import EXECUTORS as JAX_EXECUTORS  # noqa: E402
from repro_torch.api import (ConfigError, DealConfig, ExecutorSpec,  # noqa
                             GraphSpec, ModelSpec, Session)
from repro_torch.core.gnn_models import params_from_numpy  # noqa: E402
from repro_torch.launch import infer_gnn  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs" / "examples" / "smoke.json"
ATOL, RTOL = 1e-4, 3e-3

SMALL = {
    "gcn": {"name": "gcn", "n_layers": 2, "d_feature": 16},
    "sage": {"name": "sage", "n_layers": 3, "d_feature": 16},
    "gat": {"name": "gat", "n_layers": 2, "d_feature": 32, "heads": 4},
}


def _cfg_dict(model, executor="ref"):
    return {"graph": {"dataset": "rmat", "n_nodes": 256, "avg_degree": 8,
                      "fanout": 4},
            "model": SMALL[model], "executor": {"name": executor}}


@pytest.fixture(scope="module")
def jax_worlds():
    """repro's Session per model: (embeddings, X, layer graphs, params)."""
    out = {}
    for model in SMALL:
        with japi.Session.build(
                japi.DealConfig.from_dict(_cfg_dict(model))) as s:
            H = np.asarray(s.infer_all())
            params = jax.tree_util.tree_map(
                lambda x: np.asarray(x) if hasattr(x, "shape") else x,
                s.params)
            out[model] = (H, s.X.copy(), s.layer_graphs, params)
    return out


@pytest.mark.parametrize("executor", ["cuda", "ref"])
@pytest.mark.parametrize("model", list(SMALL))
def test_infer_all_matches_repro(jax_worlds, model, executor):
    H_jax, X, lgs, jparams = jax_worlds[model]
    cfg = DealConfig.from_dict(_cfg_dict(model, executor))
    params = params_from_numpy(model, jparams, "cpu")
    with Session.build(cfg, device="cpu", params=params) as s:
        np.testing.assert_array_equal(s.X, X)
        for a, b in zip(s.layer_graphs, lgs):
            np.testing.assert_array_equal(a.nbr, b.nbr)
            np.testing.assert_array_equal(a.mask, b.mask)
        H = s.infer_all()
        assert isinstance(H, torch.Tensor) and H.device.type == "cpu"
        assert s.executor.name == executor
        assert s.infer_all() is H                   # cached
        np.testing.assert_allclose(H.numpy(), H_jax, atol=ATOL, rtol=RTOL)


def test_port_params_are_seeded():
    """Without params= the port draws its own from torch.Generator(seed):
    the same config gives the same embeddings."""
    cfg = DealConfig.from_dict(_cfg_dict("gat", "cuda"))
    runs = []
    for _ in range(2):
        with Session.build(cfg, device="cpu") as s:
            runs.append(s.infer_all())
            assert torch.isfinite(runs[-1]).all()
    assert torch.equal(runs[0], runs[1])


def test_missing_card_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DealConfig.from_dict(_cfg_dict("gcn", "cuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Session.build(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer_gnn.main(["--config", str(SMOKE)])
    from repro_torch.core.ops import CudaExecutor, RefExecutor
    for ex in (CudaExecutor, RefExecutor):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            ex()
    with Session.build(cfg, device="cpu") as s:
        assert s.device.type == "cpu"


def test_smoke_config_loads_and_round_trips_like_repro():
    cfg = DealConfig.load(SMOKE).validate()
    assert DealConfig.from_json(cfg.to_json()) == cfg
    # the two packages read and write the same JSON
    assert cfg.to_json() == japi.DealConfig.load(SMOKE).to_json()


def test_launcher_dump_and_config_round_trip(tmp_path, capsys):
    out = tmp_path / "rt.json"
    assert infer_gnn.main(["--config", str(SMOKE), "--dump-config",
                           str(out), "--device", "cpu"]) is None
    assert DealConfig.load(out) == DealConfig.load(SMOKE)
    assert out.read_text() == DealConfig.load(SMOKE).to_json() + "\n"
    H = infer_gnn.main(["--config", str(out), "--device", "cpu"])
    assert tuple(H.shape) == (1024, 64) and torch.isfinite(H).all()
    printed = capsys.readouterr().out
    assert "[infer] embeddings (1024, 64)" in printed
    assert "executor=ref, device=cpu" in printed


def test_end_to_end_pipeline_local():
    """tests/test_system.py's local pipeline through the port's launcher
    flags: edge list -> distributed CSR -> sample -> all-node inference
    on one device (``--local``: the plain versions on the CPU; without it
    the launcher's default is the dist mesh, as the JAX launcher's)."""
    H = infer_gnn.main(["--dataset", "ogbn-products", "--model", "gcn",
                        "--p", "2", "--fanout", "4", "--layers", "2",
                        "--d-feature", "16", "--device", "cpu", "--local"])
    assert H.shape[1] == 16 and torch.isfinite(H).all()


def test_validation_uses_the_ports_registries():
    bad = DealConfig(graph=GraphSpec(dataset="nope", fanout=0),
                     model=ModelSpec(name="wat", heads=3, d_feature=16),
                     executor=ExecutorSpec(name="pallas", block_table=7))
    with pytest.raises(ConfigError) as ei:
        bad.validate()
    msg = str(ei.value)
    for frag in ("graph.dataset", "graph.fanout", "model.name",
                 "model.heads", "executor.name", "executor.block_table",
                 "registered: cuda, dist, ref"):
        assert frag in msg, frag
    with pytest.raises(ConfigError, match="unknown field"):
        DealConfig.from_dict({"graph": {"fanuot": 4}})
    # the port never registers into the JAX package's registries
    assert "cuda" not in JAX_EXECUTORS


@pytest.mark.parametrize("spec,match", [
    (ExecutorSpec(name="pallas"), "the port has: cuda, dist, ref"),
    (ExecutorSpec(name="nope"), "registered: cuda, dist, ref"),
    (ExecutorSpec(name="ref", block_table="default"), "block_table"),
])
def test_executor_spec_build_refuses_what_the_port_lacks(spec, match):
    """The JAX package's executor the port replaces, an unknown name, and
    a tuned block table on an executor that takes no tiling (the "cuda"
    executor takes one: tests/test_torch_tuning.py)."""
    with pytest.raises(ConfigError, match=match):
        spec.build(device="cpu")


def test_executor_spec_build_passes_options():
    ex = ExecutorSpec(name="cuda", fused_gather=False,
                      options={"fused_attention": False}).build(device="cpu")
    assert ex.name == "cuda" and not ex.fused_gather
    assert ex.attn_scores_softmax is None


def test_telemetry_records_the_same_span_names():
    """The port's spans carry repro's names: the same set for a gcn run
    through "ref", besides the binding's ``io.*`` spans that the JAX
    package lacks, and the fused attention span for gat on "cuda"."""
    from repro_torch import obs
    d = _cfg_dict("gcn")
    d["telemetry"] = {"enabled": True, "clock": "fake"}
    with japi.Session.build(japi.DealConfig.from_dict(d)) as s:
        s.infer_all()
        want = {ev[0] for ev in s.telemetry.tracer.events}
    with Session.build(DealConfig.from_dict(d), device="cpu") as s:
        s.infer_all()
        got = {ev[0] for ev in s.telemetry.tracer.events_in_order()}
        assert got - want == {"io.bind", "io.mean_w", "io.prepare"}
        assert got & want == want
    d = _cfg_dict("gat", "cuda")
    d["telemetry"] = {"enabled": True, "clock": "fake"}
    prev = obs.current()
    with Session.build(DealConfig.from_dict(d), device="cpu") as s:
        s.infer_all()
        names = {ev[0] for ev in s.telemetry.tracer.events_in_order()}
        assert obs.current() is s.telemetry
    assert obs.current() is prev
    for name in ("construct.dataset", "construct.shuffle", "sample.layer",
                 "sample.layer_graphs", "featprep.init",
                 "session.executor_build", "session.infer_all",
                 "ops.gemm", "ops.attn_scores_softmax", "ops.attend"):
        assert name in names, name
