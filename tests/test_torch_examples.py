"""Each ``examples/torch_*.py`` runs on the CPU at its smallest size, in a
subprocess, and prints what its walkthrough promises; without a card the
default device raises instead of falling back to the CPU."""
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (example, extra arguments, a line fragment its run must print)
CASES = [
    ("torch_quickstart.py", ["--nodes", "256"],
     "only the plain version ran"),
    ("torch_allnode_inference.py", ["--local", "--scale", "0.03125"],
     "embeddings (256, 64) for ALL nodes"),
    ("torch_embedding_service.py", [],
     "every tenant bitwise-equal to its solo-SLO engine"),
    ("torch_serve_llm.py", ["--requests", "3", "--max-new", "4"],
     "served 3 requests, 12 tokens"),
    ("torch_serve_llm.py", ["--arch", "mamba2-1.3b", "--requests", "3",
                            "--max-new", "4"],
     "served 3 requests, 12 tokens"),
    ("torch_serve_llm.py", ["--arch", "zamba2-7b", "--requests", "3",
                            "--max-new", "4"],
     "served 3 requests, 12 tokens"),
    ("torch_train_lm.py", ["--tiny", "--steps", "3", "--seq", "32"],
     "saved build/lm100m_torch.npz"),
]


def _run(name, args):
    # one intra-op thread: the examples' CPU sizes are small, and the
    # tests share the CPU with other pytest workers
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, str(ROOT / "examples" / name),
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("name,args,expect", CASES)
def test_example_runs_on_the_cpu(name, args, expect):
    proc = _run(name, [*args, "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert expect in proc.stdout, proc.stdout[-3000:]


@pytest.mark.parametrize("name,args,expect", CASES)
def test_example_without_a_card_raises(name, args, expect):
    proc = _run(name, args)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr, proc.stderr[-3000:]


def test_allnode_mesh_mode_names_the_roadmap_item():
    """The mesh mode (ROADMAP Queue 1 item 5, ported) runs the P x M
    shards in the example's one process: no respawn."""
    proc = _run("torch_allnode_inference.py",
                ["--scale", "0.03125", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert ("embeddings (256, 64) for ALL nodes" in proc.stdout
            and "executor=dist" in proc.stdout
            and "Mesh(4 x 2 on cpu)" in proc.stdout), proc.stdout[-3000:]
