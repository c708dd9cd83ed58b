"""The readings that the limits of ``correct`` are set from, at a cell's
own size, in one process:

    python3 gnnbench/control.py --workload sage-papers.s25-10 --seeds 1 2 3 ... --control-seeds 1 2 3

For each of ``--seeds`` the program is set up as a run sets it up, runs
two epochs through the window's call, and its last epoch is compared with
the plain reference in f32 (the program's reading).  For each of
``--control-seeds`` the reference computed with its GEMMs in TF32 is
compared with the same f32 reference (the control's reading), and it has
to read well above the program.  One JSON line a reading; the last line
holds, for each compared number, the program's largest reading (the
lower end of its limit) and the control's smallest (the upper end).
The benchmark's own runs do not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(bench, workload, seeds, control_seeds, device="cuda",
             cfg_overrides=None, log=print):
    """[(side, seed, errors)] for the program on ``seeds`` and the
    control on ``control_seeds``, and the summary {number: {"lower",
    "upper"}}."""
    import torch
    from gnnbench import harness, yardstick
    cell = harness.load_cell(bench, workload)
    cell.cfg.update(cfg_overrides or {})
    dev = torch.device(device)
    if dev.type == "cuda":
        harness.require_cards(cell.chips)
    out = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        t = time.perf_counter()
        prog = harness.set_up(cell, seed, dev)
        H = None
        for _ in range(2):
            H = None
            H = prog.epoch()
        prog.free()
        want = prog.reference()
        if seed in seeds:
            out.append(("program", seed, yardstick.errors(H, want)))
            log(json.dumps({"side": "program", "seed": seed,
                            **out[-1][2]}))
        del H
        if seed in control_seeds:
            out.append(("control", seed,
                        yardstick.errors(prog.reference("tf32"), want)))
            log(json.dumps({"side": "control", "seed": seed,
                            **out[-1][2]}))
        del want, prog
        log(json.dumps({"seed": seed, "seconds": time.perf_counter() - t}))
    summary = {}
    for name in ("rel_l2", "max_err"):
        prog_r = [e[name] for side, _, e in out if side == "program"]
        ctrl_r = [e[name] for side, _, e in out if side == "control"]
        summary[name] = {"lower": max(prog_r) if prog_r else None,
                         "upper": min(ctrl_r) if ctrl_r else None}
    return out, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from gnnbench.run import pin_environment
    pin_environment()
    from gnnbench import harness
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    _, summary = readings(bench, args.workload, args.seeds,
                          args.control_seeds,
                          log=lambda s: print(s, flush=True))
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
