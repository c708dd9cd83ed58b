#!/usr/bin/env python3
"""Time the mean-weights kernel at the GraphSAGE cell's shapes on one
NVIDIA card, beside its bound, its plain version and the host route it
replaced.

    python3 tools/mean_weights_time.py [--rows 8388608] [--fanouts 25 10]

For each fanout F, a random (rows, F) mask on the card at the live share
of ``gnnbench``'s ``sage-papers.s25-10`` layer graphs (14.1% at F = 25,
21.6% at F = 10; any other F: 20%), then:

- the kernel (``kops.mean_weights``, ``mean_weights_kernel`` in
  ``csrc/spmm.cu``) held bitwise against numpy's
  ``core.gnn_models.mean_weights`` of the same mask;
- its time, the CUDA-event median of 50 launches after warm-up (the
  mask, at least 84 MB, does not fit the 50-MB L2), beside its bound:
  R * F bytes read and R * F * 4 written at 3.35 TB/s;
- the plain version (``ref.mean_weights_ref``) on the card, by events,
  and the one-line f32 form ``torch.where(mask, 1 / deg, 0)`` (bitwise
  numpy's for degrees up to 4096), by events, with its bits checked;
- the host route the binding took before: numpy's weights and their
  pageable copy to the card, by the host clock to a synchronize.

Prints the card's name and power limit, the compiler's register report
of the ``spmm`` library, one line a fanout, and a JSON object last.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LIVE = {25: 0.141, 10: 0.216}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=2 ** 23)
    ap.add_argument("--fanouts", type=int, nargs="+", default=[25, 10])
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("mean_weights_time: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bound, time_ms
    from repro_torch.core.gnn_models import mean_weights
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ops as kops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    logs = build.build_all()
    print("[build] " + "; ".join(
        line.strip() for line in logs.get("spmm", "").splitlines()
        if "registers" in line or "spill" in line or "Compiling" in line),
        flush=True)
    dev = torch.device("cuda")
    rows = []
    for F in args.fanouts:
        g = torch.Generator(device=dev).manual_seed(F)
        mask = torch.rand((args.rows, F), generator=g, device=dev) < LIVE.get(
            F, 0.2)
        mask_np = mask.cpu().numpy()
        want = mean_weights(mask_np)
        got = kops.mean_weights(mask).cpu().numpy()
        bitwise = bool(np.array_equal(got.view(np.uint32),
                                      want.view(np.uint32)))
        ms = time_ms(torch, lambda: kops.mean_weights(mask), reps=50,
                     warmup=5)
        plain_ms = time_ms(torch, lambda: ref.mean_weights_ref(mask), reps=5,
                           warmup=1)

        def where():
            deg = mask.sum(dim=1, keepdim=True).clamp_(min=1)
            return torch.where(mask, 1.0 / deg.float(), 0.0)
        where_bitwise = bool(np.array_equal(
            where().cpu().numpy().view(np.uint32), want.view(np.uint32)))
        where_ms = time_ms(torch, where, reps=20, warmup=3)
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            torch.as_tensor(mean_weights(mask_np), device=dev)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        bound_ms, by = bound(args.rows * F * 5, 0)
        row = {"rows": args.rows, "fanout": F,
               "live_share": float(mask_np.mean()), "bitwise": bitwise,
               "ms": ms, "bound_ms": bound_ms, "bound_by": by,
               "roofline_pct": 100.0 * bound_ms / ms, "plain_ms": plain_ms,
               "where_ms": where_ms, "where_bitwise": where_bitwise,
               "host_route_ms": statistics.median(host)}
        print(f"[mean_weights] F={F}: bitwise {bitwise}, {ms:.4f} ms "
              f"(bound {bound_ms:.4f}, {row['roofline_pct']:.1f}%), plain "
              f"{plain_ms:.3f} ms, torch.where {where_ms:.3f} ms (bitwise "
              f"{where_bitwise}), numpy + pageable copy "
              f"{row['host_route_ms']:.1f} ms", flush=True)
        rows.append(row)
        del mask, mask_np, want, got
    print(json.dumps({"card": card, "mean_weights": rows}))
    return 0 if all(r["bitwise"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
