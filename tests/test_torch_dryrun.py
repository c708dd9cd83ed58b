"""The port's dry-run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.roofline``): the trace's FLOPs to the FLOP on a reduced
dense config, its byte and peak counters on a toy function, a
full-width deepseek-v2 decode placed on the 16 x 16 meta mesh without
allocating, with its collective bytes,
records through ``report.build_rows``, the CLI writing only under
``results/dryrun_torch/``, and the roofline's formulas against the JAX
package's, up to the ratio of the two hardware tables."""
import dataclasses
import json
import subprocess
import sys
import pathlib

import pytest

torch = pytest.importorskip("torch")
import repro.configs as jconfigs  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.configs import InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.roofline import analysis as tanalysis  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from repro_torch.serve.step import prefill_step  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S = 2, 64


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the tests share the CPU with other
    pytest workers, where PyTorch's OpenMP threads spin while they
    wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small():
    return dataclasses.replace(tconfigs.get_config("smollm-360m").reduced(),
                               dtype="float32")


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_flops_are_exact_on_a_reduced_dense_config(kind):
    """Every matmul of the step, written out: q, k, v and o projections,
    the attention's scores and weighted sum (prefill: the flash kernel's
    op over the S (S + 1) / 2 pairs its causal mask keeps; decode: the
    plain decode attention over the cache's S keys), the SwiGLU's three
    projections, and the unembedding of the last position."""
    cfg = _small()
    D, H, K, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                   cfg.resolved_head_dim)
    F, V, L = cfg.d_ff, cfg.vocab_size, cfg.n_layers
    rec = dryrun.dry_run(cfg, InputShape("t", S, B, kind), "card")
    T = B * S if kind == "prefill" else B
    proj = 2 * T * D * H * hd + 2 * 2 * T * D * K * hd + 2 * T * H * hd * D
    mlp = 3 * 2 * T * D * F
    att = (B * H * S * (S + 1) // 2 * (2 * hd + 2 * hd) if kind == "prefill"
           else 2 * 2 * B * H * 1 * S * hd)
    assert rec["cost_analysis"]["flops_global"] == L * (proj + mlp + att) \
        + 2 * B * D * V
    assert rec["cost_analysis"]["flops"] == rec["cost_analysis"][
        "flops_global"]                                   # one chip
    assert rec["status"] == "ok" and rec["attn_backend"] == "cuda"
    assert rec["collectives"]["total"] == 0
    ma = rec["memory_analysis"]
    params = sum(p.numel() * 4 for p in dryrun.step_arguments(
        cfg, InputShape("t", S, B, kind), dryrun.MESHES["card"]())[1][0]
        .parameters())
    cache = 2 * L * B * S * K * hd * 4
    if kind == "prefill":
        assert ma["argument_size_in_bytes"] == params + B * S * 4
        assert ma["output_size_in_bytes"] == B * V * 4 + cache
        assert ma["alias_size_in_bytes"] == 0
    else:
        assert ma["argument_size_in_bytes"] == params + cache + B * 4 + 4
        assert ma["alias_size_in_bytes"] == cache
    assert ma["temp_size_in_bytes"] > 0


def test_trace_counter_counts_bytes_and_the_peak():
    x = torch.empty(1000, device="meta")
    with dryrun.TraceCounter() as tc:
        y = (x + 1) * 2          # two new 4,000-byte storages, one freed
        z = y.view(10, 100)      # a view: no bytes, no storage
        z.add_(1)                # in place: read and written, no storage
    assert tc.bytes_accessed == 4 * 4000 + 2 * 4000
    assert tc.peak == 8000 and tc.live == 4000
    del y, z


def test_meta_tensors_reach_no_kernel():
    """On a meta tensor the flash wrapper launches no kernel: the
    dry-run's step names the kernel's path ("cuda"), and a "cuda"
    prefill runs one shape-only op a layer and launches nothing; the
    kernel's launcher still refuses any device but a card."""
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ops as kops
    cfg = _small()
    fn, args, *_ = dryrun.step_arguments(cfg, InputShape("t", S, B,
                                                        "prefill"),
                                         dryrun.MESHES["card"]())
    kops.reset_launch_counts()
    logits, cache = prefill_step(cfg, *args, attn_backend="cuda")
    assert logits.is_meta and cache["k"].is_meta
    assert kops.launch_counts()["flash_attention"] == 0
    assert fn.keywords["attn_backend"] == "cuda"
    q = args[0].embed.new_empty((B, S, 2, 8))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tflash._launch(q, q, q, q_offset=0, causal=True, window=None,
                       scale=1.0)


PROBE = r"""
import resource, json
from repro_torch.launch import dryrun
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
rec = dryrun.run_combo("deepseek-v2-236b", "decode_32k", "single")
after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(json.dumps({"growth_kib": after - before, "rec": rec}))
"""


def test_full_width_deepseek_decode_on_the_production_mesh_allocates_nothing():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["growth_kib"] < 2 * 1024 * 1024
    rec = out["rec"]
    assert rec["n_chips"] == 256 and rec["status"] == "ok"
    coll = rec["collectives"]
    assert isinstance(coll["total"], int) and coll["total"] > 0
    # decode gathers each layer's params and each latent cache whole to
    # the home (shard 0), which receives every byte of the step
    assert coll["home"] == coll["total"] == coll["all-gather"] + coll[
        "collective-permute"]
    assert rec["roofline"]["collective_s"] == coll["total"] / tanalysis.HW[
        "link_bw"]
    # 471 GB of bf16 params (and 4 x 128 x 32k latents) over 256 chips
    assert 1.5e9 < rec["memory_analysis"]["argument_size_in_bytes"] < 4e9
    cfg = tconfigs.get_config("deepseek-v2-236b")
    assert rec["model_flops_global"] == 2.0 * cfg.active_param_count() * 128


def test_a_record_round_trips_through_the_report(tmp_path):
    rec = dryrun.dry_run(_small(), InputShape("t", S, B, "prefill"), "card")
    (tmp_path / "smollm-360m__t__card.json").write_text(json.dumps(rec))
    (tmp_path / "x__t__card.json").write_text(json.dumps(
        {"status": "error"}))
    recs = report.load("card", results=tmp_path)
    assert recs == [rec]
    [row] = report.build_rows("card", recs)
    hw = tanalysis.HW
    assert row["compute_s"] == rec["cost_analysis"]["flops"] / hw[
        "peak_flops_bf16"]
    assert row["memory_s"] == rec["cost_analysis"]["bytes_accessed"] / hw[
        "hbm_bw"]
    assert row["collective_s"] == 0 and row["scan_corr"] == 1
    assert row["dominant"] == rec["roofline"]["dominant"]
    assert row["useful_ratio"] == rec["model_flops_ratio"]
    assert row["fits"] and row["chips"] == 1
    md = report.markdown([row])
    assert "| smollm-360m | t | 1 |" in md and md.count("\n") == 2
    single = dryrun.dry_run(_small(), InputShape("u", S, B, "decode"),
                            "single")
    [srow] = report.build_rows("single", [single])
    assert srow["collective_s"] == single["collectives"]["total"] / hw[
        "link_bw"] > 0 and "n/a" not in report.markdown([srow])
    joined = report.markdown_joined({"card": [row], "single": [srow]})
    lines = joined.splitlines()
    assert len(lines) == 4 and lines[0].count("|") == 3 + 4 * 2 + 1
    cells = [[c.strip() for c in line.split("|")[1:-1]]
             for line in lines[2:]]
    assert cells[0][:2] == ["smollm-360m", "t"]
    assert cells[0][7:] == ["-"] * 4 and "-" not in cells[0][3:7]
    assert cells[1][:2] == ["smollm-360m", "u"]
    assert cells[1][3:7] == ["-"] * 4 and cells[1][10] == "yes"


def test_cli_writes_only_under_results_dryrun_torch(tmp_path, monkeypatch,
                                                    capsys):
    assert dryrun.RESULTS == ROOT / "results" / "dryrun_torch"
    assert report.RESULTS == dryrun.RESULTS
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path / "dryrun_torch")
    argv = ["--arch", "whisper-base", "--shape", "decode_32k", "--mesh",
            "card"]
    dryrun.main(argv)
    assert "done: ok=1 fail=0 skip=0" in capsys.readouterr().out
    dryrun.main(argv)
    assert "done: ok=0 fail=0 skip=1" in capsys.readouterr().out
    files = [p.relative_to(tmp_path) for p in tmp_path.rglob("*.json")]
    assert files == [pathlib.Path(
        "dryrun_torch/whisper-base__decode_32k__card.json")]


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_roofline_formulas_match_jax_up_to_the_hardware(arch):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jhw, thw = janalysis.HW, tanalysis.HW
    for sh in tconfigs.applicable_shapes(tc):
        mf = tanalysis.model_flops(tc, sh)
        assert mf == janalysis.model_flops(jc, jconfigs.get_shape(sh.name))
        for n, glob in ((256, True), (512, False)):
            kw = dict(total_flops=mf, total_bytes=mf / 7,
                      collective_bytes_per_chip=mf / 1e4, n_chips=n,
                      flops_are_global=glob)
            j = janalysis.roofline_terms(**kw)
            t = tanalysis.roofline_terms(**kw)
            assert t.flops_per_chip == j.flops_per_chip
            assert t.bytes_per_chip == j.bytes_per_chip
            assert t.compute_s == pytest.approx(
                j.compute_s * jhw["peak_flops_bf16"]
                / thw["peak_flops_bf16"], rel=1e-12)
            assert t.memory_s == pytest.approx(
                j.memory_s * jhw["hbm_bw"] / thw["hbm_bw"], rel=1e-12)
            assert t.collective_s == pytest.approx(
                j.collective_s * jhw["ici_bw"] / thw["link_bw"], rel=1e-12)
        t = tanalysis.roofline_terms(total_flops=mf, total_bytes=1.0,
                                     collective_bytes_per_chip=None,
                                     n_chips=256)
        assert t.collective_s is None and t.dominant == "compute"
    assert tanalysis.SOURCE == "NVIDIA H100 SXM5 80GB HBM3, 700 W, data sheet"
    assert (thw["peak_flops_bf16"], thw["peak_flops_f32"], thw["hbm_bw"],
            thw["link_bw"], thw["hbm_bytes"]) == (989e12, 67e12, 3.35e12,
                                                  450e9, 80e9)
