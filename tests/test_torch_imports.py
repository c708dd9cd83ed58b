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
