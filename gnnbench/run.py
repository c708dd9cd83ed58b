"""Run one cell of the port's benchmark once, on the card, and print its
result as the last line of standard output.

    python3 gnnbench/run.py --workload sage-papers.s25-10 --seed 7 --seconds 20 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (``BENCHMARK.json``).  The numbers compared with the
plain reference, each beside its limit, come last: as the result's
``checks`` and as the last lines of standard error.  Without a CUDA card,
or with fewer cards than the cell asks for, with a file missing, or with
JAX or the JAX package loaded, the run prints no result and exits 2.
"""
import time

T_START = time.perf_counter()       # before the heavy imports: set-up

import argparse                      # noqa: E402
import json                          # noqa: E402
import os                            # noqa: E402
import sys                           # noqa: E402
from pathlib import Path             # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "gnnbench" / "cache"


def pin_environment() -> None:
    """Before torch is imported: every build and kernel cache at a fixed
    path inside the checkout (the port's own kernels build into
    ``build/kernels/``), and one CPU thread for torch's and the BLAS
    libraries' pools.  The epoch's host work is single-threaded numpy
    and copies; with torch's default pool of 8 threads on an 8-core
    H100 host, runs of one seed spread over 2.03-2.58 M nodes/s, some
    epochs taking 0.6-0.74 s among 0.4-s ones; with one, 2.43-2.65 M."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    pin_environment()
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from gnnbench import harness
    try:
        bench = harness.load_json(ROOT / "BENCHMARK.json")
        out = harness.run_cell(bench, args.workload, args.seed,
                               args.seconds, bool(args.trace),
                               t_start=T_START)
    except (harness.BenchError, FileNotFoundError, ImportError) as exc:
        print(f"gnnbench: {exc}", file=sys.stderr)
        return 2
    print(json.dumps(out), flush=True)
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
