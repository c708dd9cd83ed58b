#!/usr/bin/env python3
"""Time the LLM prefill of two or more checkouts of the port in turns on
one NVIDIA card: smollm-360m at full width (32 layers, B=4 x S=2048) and
deepseek-v2-236b cut to 3 layers (B=2 x S=2048), each in f32 and bf16,
through ``serve.step.prefill_step`` on the flash kernels: the shapes and
weights (seed 0) of chip_smoke.py's [llm] and [moe] phases.

    python3 tools/llm_prefill_ab.py DIR [DIR ...] [--reps 10]

Each DIR is the root of a checkout, whose ``src/`` is imported.  They run
in the order given, each in a process of its own (every checkout's
package is ``repro_torch``), so list them as A B B A to tell a drift of
the card or the host from the change.  Each process builds its
checkout's kernels into that checkout's ``build/``, draws the weights,
runs two prefills to warm up, then ``--reps`` more timed from the host
(wall: launch to synchronize) and three timed on the device after a
half-second sleep of the stream, so the host queues the work ahead of it
(chip_smoke.py's ``_device_ms``: an upper bound on the device time).
Prints the card's name and power limit, one line a run and cell, the
mean of each DIR's runs, and a JSON object of every time last.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CELLS = (("smollm-360m", None, 4), ("deepseek-v2-236b", 3, 2))   # arch,
S = 2048                                     # layers (None: all), batch
DTYPES = ("float32", "bfloat16")


def _device_ms(torch, fn):
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000_000)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def one(root: Path, reps: int) -> dict:
    """Every cell's times for the checkout at ``root`` (run in a process
    of its own)."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serve.step import prefill_step
    out = {}
    for arch, n_layers, B in CELLS:
        base = get_config(arch)
        if n_layers is not None:
            base = dataclasses.replace(base, n_layers=n_layers)
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, base.vocab_size, (B, S)), device="cuda")
        for dtype in DTYPES:
            cfg = dataclasses.replace(base, dtype=dtype)
            params = transformer.init_params(cfg, 0, device="cuda")

            def fn():
                return prefill_step(cfg, params, {"tokens": tokens},
                                    attn_backend="cuda")

            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            wall = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) * 1e3)
            dev = [_device_ms(torch, fn) for _ in range(3)]
            out[f"{arch} {cfg.n_layers}L {B}x{S} {dtype}"] = {
                "wall_ms": statistics.median(wall),
                "device_ms": statistics.median(dev)}
            del params
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print("AB " + json.dumps(one(args.dirs[0].resolve(), args.reps)),
              flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = []
    for d in args.dirs:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, __file__, "--one", "--reps", str(args.reps),
             str(d)], capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            return 1
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("AB ")][-1]
        times = json.loads(line[3:])
        runs.append({"dir": str(d), "times": times})
        for cell, t in times.items():
            print(f"{d}: {cell}: wall {t['wall_ms']:.2f} ms, device at most "
                  f"{t['device_ms']:.2f} ms", flush=True)
        print(f"{d}: {time.perf_counter() - t0:.1f} s", flush=True)
    for d in dict.fromkeys(str(d) for d in args.dirs):
        mine = [r["times"] for r in runs if r["dir"] == d]
        for cell in mine[0]:
            w = statistics.mean(t[cell]["wall_ms"] for t in mine)
            v = statistics.mean(t[cell]["device_ms"] for t in mine)
            print(f"mean of {len(mine)} runs of {d}: {cell}: wall {w:.2f} "
                  f"ms, device at most {v:.2f} ms", flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
