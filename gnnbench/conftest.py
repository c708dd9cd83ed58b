"""Fixtures of the benchmark's own tests: the repository's ``src`` on
the path, the benchmark's file, and a card for the tests marked
``gpu`` (decided here, never at import)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


def cells():
    """The cells of ``BENCHMARK.json``, read at collection to parametrize
    tests over them."""
    import json
    return [w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def tiny(n_nodes: int = 1024, **widths):
    """Overrides that shrink any cell's configuration to ``n_nodes`` at
    about 6 in-edges a node; ``widths`` (``d_feature``, ``hidden_size``)
    default to 16 into 32, so that layers are not square."""
    return {"n_nodes": n_nodes, "n_edges": 6 * n_nodes, "d_feature": 16,
            "hidden_size": 32, **widths}


@pytest.fixture(scope="session")
def bench():
    from gnnbench import harness
    return harness.load_json(ROOT / "BENCHMARK.json")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU mode)")
    return torch.device("cuda")
