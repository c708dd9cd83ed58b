"""The roofline table of the dry-run's records — the twin of
``repro.roofline.report``, over ``results/dryrun_torch/``.

  PYTHONPATH=src python -m repro_torch.roofline.report [--mesh card] [--md]
  PYTHONPATH=src python -m repro_torch.roofline.report --mesh card,single --md

JAX multiplies its costs by ``scan_correction`` because XLA's CPU cost
analysis counts a scanned layer body once.  The port's trace runs every
layer, so its counts are whole already and the correction is 1: nothing
is multiplied (``scan_corr`` stays in the rows, at 1).  The collective
term is 0 on ``card`` and, on the production meshes, the bytes the
busiest shard receives in the port's placed step over the link's rate
(``launch.dryrun``'s ``collectives``; ``coll_by_kind`` holds them by
JAX's kinds).  ``fits`` says whether a chip's arguments and temp bytes
fit the card's 80 GB of HBM.  ``--coll`` prints, a row an (arch,
shape), a chip's arguments, temp and collective bytes by kind and the
dominant term on each mesh named.
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List, Optional

from repro_torch.roofline.analysis import HW

JAX_KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
             "collective-permute")

RESULTS = (pathlib.Path(__file__).resolve().parents[3] / "results"
           / "dryrun_torch")


def load(mesh: str, results: pathlib.Path = RESULTS) -> List[Dict]:
    recs = []
    for f in sorted(results.glob(f"*__{mesh}.json")):
        d = json.loads(f.read_text())
        if d.get("status") == "ok":
            recs.append(d)
    return recs


def fmt_s(x: Optional[float]) -> str:
    if x is None:
        return "n/a"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def build_rows(mesh: str, records: Optional[List[Dict]] = None):
    """One row a record (``load(mesh)``'s, or ``records``)."""
    rows = []
    for d in (load(mesh) if records is None else records):
        ca, ma = d["cost_analysis"], d["memory_analysis"]
        coll = d["collectives"]["total"]
        compute_s = ca["flops"] / HW["peak_flops_bf16"]
        memory_s = ca["bytes_accessed"] / HW["hbm_bw"]
        coll_s = None if coll is None else coll / HW["link_bw"]
        terms = {"compute": compute_s, "memory": memory_s,
                 "collective": coll_s}
        dom = max((k for k, v in terms.items() if v is not None),
                  key=terms.get)
        mf = d["model_flops_global"]
        fl = ca["flops_global"]
        temp = ma["temp_size_in_bytes"]
        args = ma["argument_size_in_bytes"]
        rows.append({
            "arch": d["arch"], "shape": d["shape"], "mesh": d["mesh"],
            "chips": d["n_chips"], "compute_s": compute_s,
            "memory_s": memory_s, "collective_s": coll_s, "dominant": dom,
            "model_flops": mf, "hlo_flops_global": fl,
            "useful_ratio": mf / fl if fl else float("nan"),
            "temp_gb": temp / 1e9, "args_gb": args / 1e9,
            "fits": args + temp <= HW["hbm_bytes"],
            "coll_by_kind": {k: d["collectives"].get(k, 0)
                             for k in JAX_KINDS},
            "coll_gb": (coll or 0) / 1e9, "scan_corr": 1,
        })
    return rows


def markdown(rows) -> str:
    out = ["| arch | shape | chips | compute | memory | collective | "
           "dominant | useful-FLOP ratio | temp/chip | args/chip | "
           "fits 80 GB |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['chips']} | "
            f"{fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} | "
            f"{fmt_s(r['collective_s'])} | **{r['dominant']}** | "
            f"{r['useful_ratio']:.2f} | {r['temp_gb']:.1f} GB | "
            f"{r['args_gb']:.2f} GB | {'yes' if r['fits'] else 'no'} |")
    return "\n".join(out)


def markdown_collectives(rows_by_mesh: Dict[str, List[Dict]]) -> str:
    """A row an (arch, shape): a chip's arguments and temp, the
    collective bytes a chip by JAX's kinds (GB) and the dominant term,
    each cell the meshes' values in order, joined by " / " ("-" where a
    mesh has no record of it)."""
    meshes = list(rows_by_mesh)
    keyed = {m: {(r["arch"], r["shape"]): r for r in rows}
             for m, rows in rows_by_mesh.items()}
    combos = sorted(set().union(*map(set, keyed.values())))
    cols = [("args/chip GB", lambda r: f"{r['args_gb']:.2f}"),
            ("temp/chip GB", lambda r: f"{r['temp_gb']:.2f}")]
    cols += [(k, lambda r, k=k: f"{r['coll_by_kind'][k] / 1e9:.3f}")
             for k in JAX_KINDS]
    cols += [("dominant", lambda r: r["dominant"])]
    out = [f"| arch | shape ({' / '.join(meshes)}) | "
           + " | ".join(c for c, _ in cols) + " |",
           "|---|---|" + "---|" * len(cols)]
    for combo in combos:
        rs = [keyed[m].get(combo) for m in meshes]
        out.append(f"| {combo[0]} | {combo[1]} | " + " | ".join(
            " / ".join("-" if r is None else f(r) for r in rs)
            for _, f in cols) + " |")
    return "\n".join(out)


def markdown_joined(rows_by_mesh: Dict[str, List[Dict]]) -> str:
    """One row an (arch, shape), a group of columns a mesh ("-" where a
    mesh has no record of it)."""
    meshes = list(rows_by_mesh)
    keyed = {m: {(r["arch"], r["shape"]): r for r in rows}
             for m, rows in rows_by_mesh.items()}
    combos = sorted(set().union(*map(set, keyed.values())))
    out = ["| arch | shape | useful-FLOP ratio | " + " | ".join(
               f"{m}: compute | {m}: memory | {m}: temp + args a chip | "
               f"{m}: fits" for m in meshes) + " |",
           "|---|---|---|" + "---|" * (4 * len(meshes))]
    for combo in combos:
        r0 = next(keyed[m][combo] for m in meshes if combo in keyed[m])
        cells = []
        for m in meshes:
            r = keyed[m].get(combo)
            cells += (["-"] * 4 if r is None else [
                fmt_s(r["compute_s"]), fmt_s(r["memory_s"]),
                f"{r['temp_gb']:.2f} + {r['args_gb']:.2f} GB",
                "yes" if r["fits"] else "no"])
        out.append(f"| {combo[0]} | {combo[1]} | "
                   f"{r0['useful_ratio']:.2f} | " + " | ".join(cells) + " |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single",
                    help="card, single or multi; several joined by commas "
                         "(with --md: one table, a column group a mesh)")
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--coll", action="store_true",
                    help="the collective bytes by kind, a row a record")
    args = ap.parse_args(argv)
    meshes = args.mesh.split(",")
    if args.coll:
        print(markdown_collectives({m: build_rows(m) for m in meshes}))
        return
    if len(meshes) > 1:
        if not args.md:
            ap.error("several meshes need --md")
        print(markdown_joined({m: build_rows(m) for m in meshes}))
        return
    rows = build_rows(args.mesh)
    if args.md:
        print(markdown(rows))
        return
    for r in rows:
        print(f"{r['arch']:28s} {r['shape']:12s} {r['chips']:4d} "
              f"c={fmt_s(r['compute_s']):>8s} m={fmt_s(r['memory_s']):>8s} "
              f"x={fmt_s(r['collective_s']):>8s} dom={r['dominant']:10s} "
              f"useful={r['useful_ratio']:.2f} temp={r['temp_gb']:.1f}GB "
              f"fits={r['fits']}")


if __name__ == "__main__":
    main()
