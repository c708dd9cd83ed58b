#!/usr/bin/env python3
"""Time the bf16 tensor-core flash kernel's MLA tile with two and with
three k/v stages, and the tile MLA took before it had one, on one NVIDIA
card.

    python3 tools/flash_tc_stages.py [--rounds 3]

``csrc/flash_attention_sm90.cu`` takes MLA's shape (hd <= 192, vd <= 128)
with the tile <192, 128, 64, DEAL_TC_MLA_STAGES>.  At three stages (the
default) the kernel overlaps a tile's q . k^T with the last tile's P . v
and ping-pongs its two consumer warpgroups; at two it does neither; at 0
there is no MLA tile and the shape takes <256, 256, 64, 2> (q, k, v and
O all held at 256 columns).  This builds the shipped source three times
into ``build/tools/`` (``-DDEAL_TC_MLA_STAGES=0``, ``=2`` and ``=3``, the
build's flags otherwise, in parallel), prints ptxas's registers and
spills for the tile MLA takes, holds each against the plain version
(``ref.gqa_attention_ref``, chip_smoke.py's bf16 flash tolerance) and
times them in turns, CUDA-event medians of 20 launches, at deepseek-v2's
prefill attention: B=2, S=2048, H=K=128, hd 192 (nope 128 + rope 64),
vd 128 (a view of the kv projection), causal.  Prints a JSON object of
every time last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STAGES = (0, 2, 3)
LABEL = {0: "<256, 256, 64, 2> (no MLA tile)", 2: "<192, 128, 64, 2>",
         3: "<192, 128, 64, 3> (shipped)"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_tc_stages: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import FLASH_BF16_TOL, time_ms
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_attention import tma_strides

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "flash_attention_sm90.cu"

    def compile_(n):
        path = out_dir / f"flash_tc_stages{n}.so"
        log = subprocess.run([build.nvcc(), *build.NVCC_FLAGS,
                              f"-DDEAL_TC_MLA_STAGES={n}", "-o", str(path),
                              str(src)], capture_output=True, text=True)
        return n, path, log

    with ThreadPoolExecutor(len(STAGES)) as pool:
        built = list(pool.map(compile_, STAGES))
    libs = {}
    for n, path, log in built:
        text = log.stdout + log.stderr
        if log.returncode != 0:
            print(text, file=sys.stderr)
            return 1
        lines = text.splitlines()
        for i, line in enumerate(lines):
            mla = "ILi192ELi128E" if n else "ILi256ELi256E"
            if "Compiling entry" in line and mla in line:
                print(f"[build] {LABEL[n]}: " + " ".join(
                    s.split(":")[-1].strip() for s in lines[i + 1:i + 5]
                    if "registers" in s or "spill" in s), flush=True)
        lib = ctypes.CDLL(str(path))
        fn = lib.deal_flash_attention_tc
        fn.argtypes = build.SIGNATURES["flash_attention_sm90"][
            "deal_flash_attention_tc"]
        fn.restype = ctypes.c_int
        libs[n] = fn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    B, S, H, nd, rd, vd = 2, 2048, 128, 128, 64, 128
    hd = nd + rd
    q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    kv = torch.randn((B, S, H, nd + vd), generator=gen, device=dev).to(
        torch.bfloat16)
    k = torch.cat([kv[..., :nd], torch.randn(
        (B, S, 1, rd), generator=gen, device=dev).to(torch.bfloat16).expand(
            B, S, H, rd)], dim=-1)
    v = kv[..., nd:]
    scale = hd ** -0.5
    strides = [s for name, t in (("q", q), ("k", k), ("v", v))
               for s in tma_strides(t, name)]
    want = ref.gqa_attention_ref(q, k, v, causal=True, scale=scale)

    def runner(fn):
        def run():
            out = torch.empty((B, S, H, vd), dtype=torch.bfloat16,
                              device=dev)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), B, H, H, S, S, hd, vd, *strides, 1, 0,
                     0, 0, scale, 1, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"cudaError {err}")
            return out
        return run

    runs = {n: runner(fn) for n, fn in libs.items()}
    atol, rtol = FLASH_BF16_TOL
    for n, run in runs.items():
        got = run().float()
        bad = int(((got - want.float()).abs()
                   > atol + rtol * want.float().abs()).sum())
        err = float((got - want.float()).abs().max())
        print(f"[check] {LABEL[n]}: max err {err:.3e}, {bad} outside atol "
              f"{atol} rtol {rtol}", flush=True)
        if bad:
            return 1
    del want
    flops = B * H * S * (S + 1) // 2 * 2 * (hd + vd)
    times = {n: [] for n in runs}
    for rnd in range(args.rounds):
        order = list(runs) if rnd % 2 == 0 else list(reversed(list(runs)))
        for n in order:
            ms = time_ms(torch, runs[n])
            times[n].append(ms)
            print(f"[time] round {rnd} {LABEL[n]}: {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s)", flush=True)
    print(json.dumps({"flash_tc_stages": {LABEL[n]: t
                                          for n, t in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
