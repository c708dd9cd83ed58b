"""The port imports neither ``jax`` nor anything of ``repro``: a fresh
interpreter whose import system refuses both imports every
``repro_torch`` module, and ``chip_smoke`` without running it."""
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert callable(chip_smoke.main)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax_or_repro():
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20


NEW_NAMES = {   # the moe, ssm, hybrid and audio families and item 18's twins
    "repro_torch.models.moe": ("moe_block", "MoE", "init_moe_params"),
    "repro_torch.models.ssm": ("ssd_chunked", "mamba2_block", "mamba2_decode",
                               "init_ssm_params", "init_ssm_cache", "SSM",
                               "SSMCache"),
    "repro_torch.models.layers": ("layer_norm", "gelu_mlp",
                                  "sinusoidal_positions"),
    "repro_torch.models.attention": ("mla_prefill", "mla_decode",
                                     "mla_new_cache_entries"),
    "repro_torch.models.transformer": ("MLA", "MoEBlock", "SuperBlock",
                                       "MambaBlock", "LoRA", "EncBlock",
                                       "DecBlock", "encode_audio"),
    "repro_torch.core.sampler": ("sample_ego_networks", "frontier_sizes"),
    "repro_torch.launch.infer_gnn": ("run",),
}


def test_moe_mla_and_sampler_twins_import_without_jax_or_repro():
    """The modules and names this slice adds, under the same refusing
    import hook as the probe above."""
    names = repr(NEW_NAMES)
    code = PROBE.split("import repro_torch\n")[0] + (
        "import importlib\n"
        f"for mod, attrs in {names}.items():\n"
        "    m = importlib.import_module(mod)\n"
        "    assert all(callable(getattr(m, a)) for a in attrs), mod\n"
        "print('ok')\n")
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"


def _imports(path):
    """Every (line, module) that an ``import`` or ``from ... import`` in
    the file names, at any depth (function bodies included)."""
    import ast
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, node.module or ""))
    return out


def test_no_import_of_jax_or_repro_at_any_depth():
    """The import probe above runs module bodies only; an import inside a
    function (the serving code keeps its lazy ones there) is caught by
    reading every source of the port and ``chip_smoke.py``."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 40
    bad = [f"{p.relative_to(ROOT)}:{line}: {mod}"
           for p in files for line, mod in _imports(p)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    # the walk sees lazy imports: the serving tier has some
    session = ROOT / "src" / "repro_torch" / "api" / "session.py"
    assert any(mod.startswith("repro_torch.gnnserve")
               for _, mod in _imports(session))


def test_torch_examples_import_neither_jax_nor_repro():
    files = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(files) >= 4
    bad = [f"{p.relative_to(ROOT)}:{line}: {mod}"
           for p in files for line, mod in _imports(p)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    assert all(any(mod.startswith("repro_torch") for _, mod in _imports(p))
               for p in files)


def _span_names(root):
    """Every span name a package's sources record by a literal: the first
    argument of ``obs.span``, ``tel.span`` or ``tracer.record`` calls
    (``"ops." + kind`` counts as ``ops.``)."""
    import ast
    names = set()
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if not (isinstance(node, ast.Call) and node.args
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("span", "record")):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.BinOp):
                arg = arg.left
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value)
    return names


IO_SPANS = {"io.bind", "io.mean_w", "io.prepare", "io.rel"}


def test_span_names_missing_from_the_port_are_items_5_and_8():
    """Every span of the JAX package is recorded by the port too: the
    cluster tier's (item 8: ``serve.cluster_launch``) and the distributed
    executor's (item 5: ``dist.*`` and the refresh's dist-vs-local
    ``refresh.route``) included.  (``refresh.subset_plan`` appears in
    the JAX package's docstrings only: no call records it.)  The port's
    one addition is the binding's ``io.*`` spans (``core.ops``: the
    ``DenseIO`` build, its mean weights, ``prepare``, R-GAT's slot
    relations), which the JAX package lacks."""
    ours = _span_names(ROOT / "src" / "repro_torch")
    theirs = _span_names(ROOT / "src" / "repro")
    assert theirs - ours == set()
    assert "serve.cluster_launch" in ours
    assert "refresh.subset_plan" not in theirs
    dist = {n for n in theirs if n.startswith("dist.")}
    assert dist == {"dist.bind", "dist.subset_plan", "dist.exchange",
                    "dist.subset_plan_build"}
    assert dist | {"refresh.route"} <= ours
    for name in ("serve.tick", "serve.drain", "featprep.scan_all",
                 "featprep.redistribute", "featprep.fused", "serve.query",
                 "health.alert", "qos.grant", "qos.preempt", "ops."):
        assert name in ours, name
    assert ours - theirs == IO_SPANS, ours - theirs


ITEM_17_NAMES = {   # the dry-run, the roofline, the rules and mesh paths
    "repro_torch.sharding.specs": ("param_specs", "cache_specs",
                                   "batch_specs", "per_chip_bytes",
                                   "logical_axes", "shard_if_divisible"),
    "repro_torch.sharding.context": ("sharding_context", "current_mesh"),
    "repro_torch.roofline.analysis": ("roofline_terms", "model_flops"),
    "repro_torch.roofline.report": ("build_rows", "markdown", "main"),
    "repro_torch.launch.inputs": ("input_specs", "step_arguments"),
    "repro_torch.launch.dryrun": ("dry_run", "run_combo", "main"),
    "repro_torch.launch.mesh": ("make_production_mesh", "check_mesh"),
    "repro_torch.models.transformer": ("abstract_params", "abstract_cache"),
    "repro_torch.train.optimizer": ("abstract_opt_state",),
    "repro_torch.tuning": ("flags", "on"),
    "repro_torch.models.moe": ("_moe_block_ep", "route"),
    "repro_torch.models.attention": ("cp_decode_attention",),
}


def test_dryrun_roofline_and_sharding_twins_import_without_jax_or_repro():
    """The modules and names of the dry-run slice, under the refusing
    import hook of the probe above."""
    code = PROBE.split("import repro_torch\n")[0] + (
        "import importlib\n"
        f"for mod, attrs in {ITEM_17_NAMES!r}.items():\n"
        "    m = importlib.import_module(mod)\n"
        "    assert all(callable(getattr(m, a)) for a in attrs), mod\n"
        "print('ok')\n")
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok"
