#!/usr/bin/env python3
"""Time host-to-card copies on one NVIDIA card: the binding's plain
pageable copy beside a pinned DMA, the host's copy into pinned memory,
and the staging ring (``repro_torch.core.ops.StageRing``) over its
buffer counts and buffer sizes.

    python3 tools/h2d_copy.py [--cells <workload> ...] [--no-arrays] [--out F]

torch's own thread pool is held to one thread after the first host
measurement, as ``gnnbench/run.py`` holds it.  Arrays, in host memory
filled with random bits (read back from the card, so every page is
touched and none is pinned):

- ``x4g``: 4 GiB of f32;
- ``gat_mask``: ``gat-products``' layer-graph mask, 2,449,029 x 10 bool;
- ``sage_nbr``: ``sage-papers100m``'s ``nbr``, 2^23 x 25 int32;
- ``rgat_x``: ``rgat-mag240m``'s X, 2^22 x 768 f32 (12 GiB).

For each, in GB/s (bytes over the host clock from the call to a
synchronize, median of the repeats):

- ``pageable``: ``torch.as_tensor(a, device="cuda")``;
- ``pinned``: a pinned host tensor's ``copy_`` to the card (at most 4
  GiB of it, so ``rgat_x`` reads the 4-GiB rate);
- ``host``: the array copied into one pinned buffer of the ring's chunk,
  a chunk at a time, with no DMA, by torch's ``copy_`` with torch's
  default threads and with one;
- ``ring``: the module's ring, its result held bitwise to
  ``torch.as_tensor``'s, and an int64 -> int32 conversion held the same.

On ``x4g`` also the ring at C in 4-32 MiB by K in 2-4, twice, the
second pass in the reverse order.  Then the threshold: plain against
the module's ring from 64 KiB to 64 MiB of f32.  ``--cells``: each
benchmark cell set up at its full size (``gnnbench.harness.set_up``,
seed 33), its first epoch's time, then one epoch under telemetry:
``io.h2d_bytes``, ``io.h2d_staged_bytes`` and their ratio.  Prints the
card's name and power limit, one line a measurement, and a JSON object
last (also written to ``--out``, ``build/h2d_copy.json`` by default).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MIB = 1 << 20
SHAPES = {"x4g": ((1 << 28, 4), "float32"),
          "gat_mask": ((2449029, 10), "bool"),
          "sage_nbr": ((1 << 23, 25), "int32"),
          "rgat_x": ((1 << 22, 768), "float32")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="*", default=[])
    ap.add_argument("--no-arrays", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "build" / "h2d_copy.json"))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("h2d_copy: no CUDA device", file=sys.stderr)
        return 1
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    from repro_torch import obs
    from repro_torch.core import ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    threads = torch.get_num_threads()
    print(f"{card}; torch {torch.__version__}, {threads} threads of "
          f"{os.cpu_count()} cores; ring K={ops.STAGE_BUFFERS} C="
          f"{ops.STAGE_CHUNK // MIB} MiB on {ops.STAGE_THREADS} threads, "
          f"threshold {ops.STAGE_MIN_BYTES} bytes", flush=True)

    def timed(fn, reps):
        """Median seconds of ``fn`` to a synchronize, after one warm-up."""
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    def host_array(shape, dtype):
        n = int(np.prod(shape))
        if dtype == "bool":
            t = torch.rand(n, device=dev) < 0.25
        else:
            t = torch.empty(n, dtype=torch.int32, device=dev).random_()
        a = t.cpu().numpy().reshape(shape)
        return a.view(np.float32) if dtype == "float32" else a

    def same(x, y):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        return bool(torch.equal(x, y))

    def gbs(nbytes, s):
        return nbytes / s / 1e9

    rings = {}

    def ring(k=ops.STAGE_BUFFERS, c=ops.STAGE_CHUNK):
        if (k, c) not in rings:
            rings[(k, c)] = ops.StageRing(dev, k, c)
        return rings[(k, c)]

    def host_rate(src, n_threads):
        """The host's copy alone, by torch's copy_ on ``n_threads``."""
        buf = torch.empty(ops.STAGE_CHUNK, dtype=torch.uint8,
                          pin_memory=True)
        raw = src.reshape(-1).view(torch.uint8)
        plan = ops.chunk_plan(raw.numel(), 1, ops.STAGE_CHUNK)
        before = torch.get_num_threads()
        torch.set_num_threads(n_threads)
        try:
            def run():
                for a, b in plan:
                    buf[:b - a].copy_(raw[a:b])
            return gbs(raw.numel(), timed(run, 3))
        finally:
            torch.set_num_threads(before)

    out = {"card": card, "torch": torch.__version__, "threads": threads,
           "cores": os.cpu_count(), "K": ops.STAGE_BUFFERS,
           "C_mib": ops.STAGE_CHUNK // MIB, "T": ops.STAGE_THREADS,
           "min_bytes": ops.STAGE_MIN_BYTES, "arrays": {}, "grid": [],
           "threshold": [], "cells": {}}
    ok = True
    for name, (shape, dtype) in ({} if args.no_arrays else SHAPES).items():
        a = host_array(shape, dtype)
        src = torch.as_tensor(a)
        nbytes = a.nbytes
        reps = 3 if nbytes > (1 << 30) else 10
        row = {"shape": list(shape), "dtype": dtype, "bytes": nbytes,
               "host_torch_gbs": host_rate(src, threads),
               "host_torch_1thread_gbs": host_rate(src, 1)}
        torch.set_num_threads(1)
        row["pageable_gbs"] = gbs(nbytes, timed(
            lambda: torch.as_tensor(a, device=dev), reps))
        pn = min(nbytes, 4 << 30)
        pin = torch.empty(pn, dtype=torch.uint8, pin_memory=True)
        pin.copy_(src.reshape(-1).view(torch.uint8)[:pn])
        d = torch.empty(pn, dtype=torch.uint8, device=dev)
        row["pinned_gbs"] = gbs(pn, timed(
            lambda: d.copy_(pin, non_blocking=True), reps))
        del pin, d
        if name == "x4g":
            grid = [(k, c) for c in (4, 8, 16, 32) for k in (2, 3, 4)]
            for k, c in grid + grid[::-1]:
                r = ring(k, c * MIB)
                g = gbs(nbytes, timed(lambda: r.copy(src, src.dtype), 3))
                out["grid"].append({"K": k, "C_mib": c, "gbs": g})
                print(f"[grid] K={k} C={c} MiB: {g:.2f} GB/s", flush=True)
        r = ring()
        row["ring_gbs"] = gbs(nbytes, timed(lambda: r.copy(src, src.dtype),
                                            reps))
        plain = torch.as_tensor(a, device=dev)
        row["bitwise"] = same(r.copy(src, src.dtype), plain)
        del plain
        if dtype == "int32":            # the loader's int64 ids, as int32
            a64 = a.astype(np.int64)
            plain = torch.as_tensor(a64, dtype=torch.int32, device=dev)
            row["bitwise_int64_to_int32"] = same(
                r.copy(torch.as_tensor(a64), torch.int32), plain)
            ok &= row["bitwise_int64_to_int32"]
            del a64, plain
        ok &= row["bitwise"]
        torch.cuda.empty_cache()
        out["arrays"][name] = row
        print(f"[{name}] {nbytes / 2 ** 30:.4f} GiB {dtype}: pageable "
              f"{row['pageable_gbs']:.2f}, pinned {row['pinned_gbs']:.2f}, "
              f"host by torch {row['host_torch_gbs']:.2f} ({threads} "
              f"threads; 1 thread {row['host_torch_1thread_gbs']:.2f}), ring "
              f"{row['ring_gbs']:.2f} GB/s; bitwise {row['bitwise']}"
              + (f", int64 -> int32 {row['bitwise_int64_to_int32']}"
                 if "bitwise_int64_to_int32" in row else ""), flush=True)
        del a, src
    torch.set_num_threads(1)
    for p in ([] if args.no_arrays else range(16, 27)):
        nbytes = 1 << p
        a = host_array((nbytes // 4,), "float32")
        src = torch.as_tensor(a)
        r = ring()
        plain_s = timed(lambda: torch.as_tensor(a, device=dev), 20)
        ring_s = timed(lambda: r.copy(src, src.dtype), 20)
        out["threshold"].append({"bytes": nbytes,
                                 "pageable_gbs": gbs(nbytes, plain_s),
                                 "ring_gbs": gbs(nbytes, ring_s)})
        print(f"[threshold] {nbytes // 1024} KiB: pageable "
              f"{gbs(nbytes, plain_s):.2f}, ring {gbs(nbytes, ring_s):.2f} "
              "GB/s", flush=True)
    rings.clear()
    if args.cells:
        from gnnbench import harness
        bench = harness.load_json(ROOT / "BENCHMARK.json")
    for workload in args.cells:
        prog = harness.set_up(harness.load_cell(bench, workload), 33, dev)
        t0 = time.perf_counter()
        prog.epoch()
        first_s = time.perf_counter() - t0
        tel = obs.Telemetry(enabled=True)
        with obs.use(tel):
            t0 = time.perf_counter()
            prog.epoch()
            second_s = time.perf_counter() - t0
        h2d = tel.counters.get("io.h2d_bytes", 0.0)
        staged = tel.counters.get("io.h2d_staged_bytes", 0.0)
        out["cells"][workload] = {"first_epoch_s": first_s,
                                  "telemetry_epoch_s": second_s,
                                  "h2d_bytes": h2d, "staged_bytes": staged,
                                  "staged_share": staged / h2d}
        print(f"[cell] {workload}: first epoch {first_s:.3f} s, one under "
              f"telemetry {second_s:.3f} s; io.h2d_bytes {h2d:.0f}, "
              f"io.h2d_staged_bytes {staged:.0f}, share "
              f"{staged / h2d:.6f}", flush=True)
        del prog
        torch.cuda.empty_cache()
    out["ok"] = bool(ok)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
