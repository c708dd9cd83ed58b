#!/usr/bin/env python3
"""Time two designs of the fanout-gather SPMM against the kernel the port
ships, at the main path's shapes, on one NVIDIA card.

    python3 tools/spmm_designs.py [--rounds 2]

The shipped kernel is ``csrc/spmm.cu`` (a thread per (row, 16-byte chunk)
walking the row's slots, live ones only), called through
``repro_torch.kernels.ops``.  The two designs are in
``tools/spmm_designs.cu``: "regs", a warp per group of 32 / F rows with a
ballot of the live slots and every live chunk loaded into registers
before any sum (``it`` loads a lane at a time), and "bulk", the same
group read with Hopper's bulk asynchronous copy into shared memory in a
two-stage pipeline of persistent warps.  Each design's output is held
bitwise against the shipped kernel's before it is timed.

Shapes: the ogbn-papers100M stand-in of ``chip_smoke.py`` (N = R =
1,048,576, fanout 8), f32, at D = 128 (``spmm``, ``gather_spmm`` with a
table, and GAT's attend with w a strided (R, 8, 4) view) and at D = 32
(one head of the attend, as it ran before all heads went in one launch).
Times are CUDA-event medians of 20 launches after warm-up; the variants
take turns within each round.  Prints one line a case and variant, and
a JSON object of every time last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "tools" / "spmm_designs.cu"
REGS = [(4, 4), (8, 4), (16, 4), (8, 8)]        # (loads a lane, warps)
BULK = [1, 2, 4]                                 # warps a block


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("spmm_designs: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import FANOUT, N_NODES_SCALE, time_ms
    from repro_torch.core.graph import csr_from_edges_distributed, \
        make_dataset
    from repro_torch.core.sampler import sample_layer_graphs
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "spmm_designs.so"
    log = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o",
                          str(lib_path), str(SOURCE)], capture_output=True,
                         text=True)
    if log.returncode != 0:
        print(log.stdout + log.stderr, file=sys.stderr)
        return 1
    regs = [line.strip() for line in (log.stdout + log.stderr).splitlines()
            if "registers" in line or "spill" in line]
    print("[build] " + "; ".join(regs), flush=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.spmm_design.argtypes = [I, P, P, P, L, L, L, P, P, P, L, I, I, I,
                                I, I, P]
    lib.spmm_design.restype = I

    src_e, dst_e, n = make_dataset("ogbn-papers100M", seed=0,
                                   scale=N_NODES_SCALE)
    g, _ = csr_from_edges_distributed(src_e, dst_e, n)
    lg = sample_layer_graphs(g, FANOUT, 1, seed=0)[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    nbr = torch.as_tensor(lg.nbr, device=dev)
    mask = torch.as_tensor(lg.mask, device=dev)
    R, F = nbr.shape
    table = torch.randperm(R, generator=gen, device=dev).to(torch.int32)
    h = torch.randn((R, 128), generator=gen, device=dev)
    h32 = torch.randn((R, 32), generator=gen, device=dev)
    w = torch.randn((R, F), generator=gen, device=dev)
    alpha = torch.rand((R, 4, F), generator=gen, device=dev).transpose(1, 2)
    print(f"[graph] R={R} F={F}: {int(mask.sum())} live slots of {R * F}",
          flush=True)

    cases = {   # name: (h, table, w)
        "spmm D=128": (h, None, w),
        "gather_spmm D=128": (h, table, w),
        "heads-weighted D=128": (h, None, alpha),
        "spmm D=32": (h32, None, w),
    }

    def shipped(hh, tbl, ww):
        if tbl is None:
            return lambda: kops.spmm(hh, ww, nbr, mask)
        return lambda: kops.gather_spmm(hh, tbl, ww, nbr, mask)

    def design(which, it, warps, hh, tbl, ww):
        heads = ww.shape[2] if ww.dim() == 3 else 1
        strides = ww.stride() if ww.dim() == 3 else ww.stride() + (0,)

        def run():
            out = torch.empty((R, hh.shape[1]), device=dev)
            err = lib.spmm_design(
                which, hh.data_ptr(), None if tbl is None else
                tbl.data_ptr(), ww.data_ptr(), *strides, mask.data_ptr(),
                nbr.data_ptr(), out.data_ptr(), R, F, hh.shape[1], heads,
                warps, it, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"spmm_design({which}): cudaError {err}")
            return out
        return run

    variants = {}
    for case, (hh, tbl, ww) in cases.items():
        want = shipped(hh, tbl, ww)()
        variants[case] = {"shipped": shipped(hh, tbl, ww)}
        for it, warps in REGS:
            variants[case][f"regs it={it} warps={warps}"] = design(
                0, it, warps, hh, tbl, ww)
        for warps in BULK:
            variants[case][f"bulk warps={warps}"] = design(
                1, 0, warps, hh, tbl, ww)
        for name, fn in variants[case].items():
            if not torch.equal(fn(), want):
                print(f"spmm_designs: {case} {name} differs from the "
                      "shipped kernel", file=sys.stderr)
                return 1
        print(f"[check] {case}: every variant bitwise the shipped kernel",
              flush=True)

    times = {case: {name: [] for name in vs} for case, vs in variants.items()}
    for rnd in range(args.rounds):
        for case, vs in variants.items():
            for name, fn in vs.items():
                ms = time_ms(torch, fn)
                times[case][name].append(ms)
                print(f"[time] round {rnd} {case} {name}: {ms:.4f} ms",
                      flush=True)
    print(json.dumps({"spmm_designs": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
