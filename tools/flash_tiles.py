#!/usr/bin/env python3
"""Time tile variants of the f32 flash kernel against each other and
against the kernel the port ships, on one NVIDIA card.

    python3 tools/flash_tiles.py [--rounds 2]

``tools/flash_tiles.cu`` includes ``csrc/flash_attention.cu`` as it is
and instantiates its kernel at other tiles: (hd_pad, TM, TN, TY, UD,
UP), a block of 16 x TY threads on TY * TM query rows and tiles of 16 *
TN keys, each thread TM rows x TN keys of the scores, UD column steps
of q . K and UP keys of P . V unrolled together.  Each variant is
held against the plain version (``ref.gqa_attention_ref``) at the f32
flash tolerance (atol 2e-5, rtol 3e-2) before it is timed, beside the
shipped entry.

Shapes, causal, f32: hd 64 at smollm-360m's prefill (B=4, S=2048, 15
query heads over 5 kv heads, as ``chip_smoke.py`` runs it), hd 128 at
qwen2.5-14b's heads (B=1, S=4096, 40 over 8), hd 256 at gemma3-4b's
(B=1, S=4096, 8 over 4).  Times are CUDA-event medians of 20 launches
after warm-up; the variants take turns within each round.  Prints
ptxas's registers and spills for each variant, one line a case and
variant, and a JSON object of every time last.  The shipped tiles are
the fastest of those that spill nothing at hd <= 128.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "tools" / "flash_tiles.cu"
N_VARIANTS = 11
CASES = {   # hd: (B, S, H, K), causal
    64: (4, 2048, 15, 5),
    128: (1, 4096, 40, 8),
    256: (1, 4096, 8, 4),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_tiles: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import ATOL, time_ms
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_attention import flash_attention_gqa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "flash_tiles.so"
    log = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o",
                          str(lib_path), str(SOURCE)], capture_output=True,
                         text=True)
    if log.returncode != 0:
        print(log.stdout + log.stderr, file=sys.stderr)
        return 1
    report = []
    for line in (log.stdout + log.stderr).splitlines():
        if "Compiling entry function" in line:
            report.append(line.split("TileILi")[-1].split("EEEEv")[0]
                          .replace("ELi", ",") + ":")
        elif report and ("registers" in line or "spill stores" in line):
            report[-1] += " " + line.split(":")[-1].strip()
    print("[build] " + "\n[build] ".join(report), flush=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
    lib.flash_tile.argtypes = [P, P, P, P, I, I, I, I, I, I, P, I, I, L, L,
                               F, I, P]
    lib.flash_tile.restype = I
    lib.flash_tile_shape.argtypes = [I, P]
    shapes = {}
    for var in range(N_VARIANTS):
        s6 = (ctypes.c_int * 6)()
        lib.flash_tile_shape(var, s6)
        shapes[var] = tuple(s6)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    variants = {}
    for hd, (B, S, H, K) in CASES.items():
        q, k, v = (torch.randn((B, S, n, hd), generator=gen, device=dev)
                   for n in (H, K, K))
        strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                         *v.stride()[:3])

        def variant(var, q=q, k=k, v=v, strides=strides, B=B, S=S, H=H,
                    K=K, hd=hd):
            def run():
                out = torch.empty_like(q)
                err = lib.flash_tile(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), B, H, K, S, S, hd, strides, 1, 0, 0, 0,
                    1.0 / math.sqrt(hd), var,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"flash_tile({var}): cudaError {err}")
                return out
            return run

        want = ref.gqa_attention_ref(q, k, v, causal=True)
        case = f"hd {hd} (B={B} S={S} H={H} K={K} causal)"
        variants[case] = {"shipped": lambda q=q, k=k, v=v:
                          flash_attention_gqa(q, k, v, causal=True)}
        for var, shp in shapes.items():
            if shp[0] != hd:
                continue
            fn = variant(var)
            got = fn()
            err = float((got - want).abs().max())
            lim = ATOL["float32"] + 3e-2 * want.abs()
            if bool(((got - want).abs() > lim).any()):
                print(f"flash_tiles: {case} variant {shp}: max err {err:.3e} "
                      "outside atol 2e-5, rtol 3e-2", file=sys.stderr)
                return 1
            variants[case][f"tile {shp}"] = fn
            print(f"[check] {case} tile {shp}: max err {err:.3e}",
                  flush=True)
        del want

    times = {case: {name: [] for name in vs} for case, vs in variants.items()}
    for rnd in range(args.rounds):
        for case, vs in variants.items():
            for name, fn in vs.items():
                ms = time_ms(torch, fn)
                times[case][name].append(ms)
                print(f"[time] round {rnd} {case} {name}: {ms:.4f} ms",
                      flush=True)
    print(json.dumps({"flash_tiles": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
