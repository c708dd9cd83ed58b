"""How far the port's and ``repro``'s bf16 prefills are from the exact
result: ``repro``'s prefill in f32 on the same bf16 params and inputs
(``torch_parity.f32_oracle``), for the rows the parity tests hold that
way, on the CPU.

    PYTHONPATH=src python tests/helpers/bf16_oracle.py [--seeds 2 3 4]

Per row and params seed: the max and the 99.9th percentile of |error| of
the final-norm hidden states and of the logits, the port's beside
``repro``'s.  The dense and moe rows take the JAX init (the Queue 3
rows of tests/test_torch_transformer.py), the others every parameter
drawn from the seed (``torch_parity.random_params``); tokens come from
``default_rng(3)``: 2 x 40 (whisper: 2 x 10 over 13 frames).  About a
minute a seed.  ``errors`` serves
tests/test_torch_transformer.py's oracle test at seed 2.
"""
import argparse
import pathlib
import sys

import numpy as np

import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from torch_parity import (configs, f32_oracle,  # noqa: E402
                          random_params, to_np)

import repro.configs as jconfigs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ROWS = (("granite-8b", None), ("deepseek-v2-236b", None),
        ("mamba2-1.3b", None), ("zamba2-7b", 2), ("zamba2-7b", 5),
        ("whisper-base", None))


def errors(arch, n_layers, seed, hidden=True):
    """((max, p99.9) of the port's |error|, the same of ``repro``'s) from
    the f32 oracle, for the final-norm hidden states or the logits."""
    changes = {} if n_layers is None else {"n_layers": n_layers}
    jc, tc = configs(jconfigs, tconfigs, arch, "bfloat16", **changes)
    if arch in ("granite-8b", "deepseek-v2-236b"):
        jp = jtf.init_params(jc, jax.random.PRNGKey(seed))
        tree = jax.tree.map(np.asarray, jp)
    else:
        jp, tree = random_params(jtf.init_params(jc, jax.random.PRNGKey(0)),
                                 seed)
    tp = ttf.params_from_numpy(tc, tree, device="cpu")
    rng = np.random.default_rng(3)
    if tc.family == "audio":
        frames = jnp.asarray(rng.standard_normal((2, 13, tc.frontend_dim)),
                             jnp.bfloat16)
        tokens = rng.integers(0, tc.vocab_size, (2, 10))
        jb = {"frames": frames, "tokens": jnp.asarray(tokens)}
        tb = {"frames": torch.tensor(to_np(frames)).to(torch.bfloat16),
              "tokens": torch.from_numpy(tokens)}
    else:
        tokens = rng.integers(0, tc.vocab_size, (2, 40))
        jb, tb = {"tokens": jnp.asarray(tokens)}, {
            "tokens": torch.from_numpy(tokens)}
    got, _ = ttf.forward(tc, tp, tb, return_hidden=hidden)
    assert got.dtype == (torch.bfloat16 if hidden else torch.float32)
    o = to_np(f32_oracle(jtf, jc, jp, jb, return_hidden=hidden)[0])
    j = to_np(jtf.forward(jc, jp, jb, mode="prefill", return_hidden=hidden,
                          remat=False)[0])
    return tuple((float(e.max()), float(np.quantile(e, 0.999)))
                 for e in (np.abs(to_np(got) - o), np.abs(j - o)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[2])
    args = ap.parse_args()
    for arch, n_layers in ROWS:
        for seed in args.seeds:
            for what in ("hidden", "logits"):
                (tm, tq), (jm, jq) = errors(arch, n_layers, seed,
                                            what == "hidden")
                ok = tm <= jm and tq <= jq
                print(f"{arch}{'' if n_layers is None else f' {n_layers}L'} "
                      f"seed {seed} {what}: port max {tm:.5f} p99.9 "
                      f"{tq:.5f}; repro max {jm:.5f} p99.9 {jq:.5f}"
                      f"{'' if ok else '  (port farther)'}", flush=True)


if __name__ == "__main__":
    main()
