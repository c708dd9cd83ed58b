"""The plain reference against the port at a tiny size on the CPU: the
same CSR, the same layer graphs (the sampler's draws), and the
embeddings of the port's "ref" executor; and the reference imports
nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gnnbench import inputs, reference, yardstick
from gnnbench.reference import graph as rgraph

HERE = Path(__file__).resolve().parent


def _cfg(model, heads):
    return {"model": model, "n_nodes": 512, "n_edges": 512 * 9,
            "d_feature": 16, "hidden_size": 32, "n_layers": 3,
            "heads": heads}


def _port_layer_graphs(src, dst, n, draws):
    from repro_torch.core.graph import csr_from_edges_distributed
    from repro_torch.core.sampler import sample_layer_graphs
    g, _ = csr_from_edges_distributed(src, dst, n)
    return g, [lg for fanout, k, seed in draws
               for lg in sample_layer_graphs(g, fanout, k, seed)]


@pytest.mark.parametrize("fanouts", [(8, 8, 8), (25, 25, 25), (25, 10, 10)])
def test_csr_and_layer_graphs_equal_the_ports(fanouts):
    src, dst, _, _, draws = inputs.make(_cfg("sage", 1), fanouts, 4, "cpu")
    g, port = _port_layer_graphs(src, dst, 512, draws)
    indptr, indices = rgraph.csr(src, dst, 512, "cpu")
    assert np.array_equal(indptr, g.indptr)
    assert np.array_equal(indices, g.indices)
    mine = [lg for fanout, k, seed in draws
            for lg in rgraph.sample_layer_graphs(indptr, indices, fanout, k,
                                                 seed)]
    assert [lg.nbr.shape[1] for lg in port] == list(fanouts)
    for lg, (nbr, mask) in zip(port, mine):
        assert np.array_equal(lg.nbr, nbr)
        assert np.array_equal(lg.mask, mask)


@pytest.mark.parametrize("model,heads,fanouts", [("sage", 1, (8, 8, 8)),
                                                 ("sage", 1, (25, 25, 25)),
                                                 ("sage", 1, (25, 10, 5)),
                                                 ("gat", 4, (8, 8, 8)),
                                                 ("gat", 4, (10, 10, 10))])
def test_reference_matches_the_ports_ref_executor(model, heads, fanouts):
    from repro_torch.core.gnn_models import params_from_numpy
    from repro_torch.core.layerwise import LOCAL_ENGINES
    src, dst, X, tree, draws = inputs.make(_cfg(model, heads), fanouts, 9,
                                           "cpu")
    _, lgs = _port_layer_graphs(src, dst, 512, draws)
    got = LOCAL_ENGINES[model](lgs, X, params_from_numpy(model, tree, "cpu"),
                               executor="ref", device="cpu")
    want = reference.embed_all(model, src, dst, X, tree, draws, "cpu")
    assert tuple(want.shape) == (512, 32)
    err = yardstick.errors(got, want)
    assert err["rel_l2"] < 1e-6 and err["max_err"] < 1e-5, err


def test_tf32_control_reads_far_above_the_reference():
    src, dst, X, tree, draws = inputs.make(_cfg("sage", 1), (8, 8, 8), 3,
                                           "cpu")
    f32 = reference.embed_all("sage", src, dst, X, tree, draws, "cpu")
    tf32 = reference.embed_all("sage", src, dst, X, tree, draws, "cpu",
                               "tf32")
    assert yardstick.errors(tf32, f32)["rel_l2"] > 1e-4


def _imported_tops(path: Path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_only_torch_and_numpy(path):
    assert _imported_tops(path) <= {"__future__", "importlib", "math",
                                    "typing", "numpy", "torch", "gnnbench"}


def test_reference_loads_nothing_of_the_port():
    probe = ("import sys, gnnbench.reference as r, gnnbench.reference.sage, "
             "gnnbench.reference.gat\n"
             "tops = {m.split('.')[0] for m in sys.modules}\n"
             "print(sorted(tops & {'repro_torch', 'repro', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
