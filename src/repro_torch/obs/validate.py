"""Schema + coverage validation for dumped Chrome/Perfetto traces — the
port's copy of ``repro.obs.validate``, with the same rules and
``DEFAULT_CATS``.

    PYTHONPATH=src python -m repro_torch.obs.validate TRACE.json \
        [--min-coverage 0.9] \
        [--require-cats construct,sample,featprep,ops,serve,refresh,store] \
        [--require-spans refresh.chunk,refresh.layer]

It checks a ``Session.dump_trace`` output for:

  * structural schema — the trace-event envelope Perfetto loads:
    ``traceEvents`` list, ``ph: "X"`` events with string names and
    numeric non-negative ts/dur, pid/tid present;
  * stage attribution — every required category (a span name's prefix
    before the first dot) appears at least once, so sampling / feature
    prep / per-layer ops / serve / refresh are each individually
    attributed, not lumped into one blob;
  * span inventory — every EXACT span name in ``--require-spans``
    appears at least once; categories are too coarse for the
    chunked-refresh path (``refresh.chunk`` / ``refresh.layer`` /
    ``refresh.route`` all share the ``refresh`` category with the
    plain inline-refresh spans, so only a name-level check proves the
    preemptible path actually ran and got traced);
  * coverage — the interval UNION of all spans must cover at least
    ``--min-coverage`` of the traced window (earliest start to latest
    end): the trace explains where the wall time went.

Exit code 0 with a one-line summary on success; every violation is
listed on stderr and the exit code is 1 otherwise.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

DEFAULT_CATS = "construct,sample,featprep,ops,serve,refresh,store"


def validate_trace(doc: dict, min_coverage: float = 0.9,
                   require_cats: Tuple[str, ...] = (),
                   require_spans: Tuple[str, ...] = ()
                   ) -> Tuple[List[str], Dict[str, float]]:
    """Returns (problems, summary).  Empty problems == valid."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ([f"trace root must be a JSON object, got "
                 f"{type(doc).__name__}"], {})
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return (["traceEvents: missing or not a list"], {})

    names = set()
    spans = []       # (ts, dur, cat) in us
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"traceEvents[{i}]: not an object")
            continue
        ph = ev.get("ph")
        if ph == "M":
            continue                         # metadata events are free-form
        if ph != "X":
            problems.append(f"traceEvents[{i}]: ph must be 'X' or 'M', "
                            f"got {ph!r}")
            continue
        name = ev.get("name")
        if not isinstance(name, str) or not name:
            problems.append(f"traceEvents[{i}]: missing span name")
            continue
        ts, dur = ev.get("ts"), ev.get("dur")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"traceEvents[{i}] ({name}): bad ts {ts!r}")
            continue
        if not isinstance(dur, (int, float)) or dur < 0:
            problems.append(f"traceEvents[{i}] ({name}): bad dur {dur!r}")
            continue
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                problems.append(f"traceEvents[{i}] ({name}): missing {key}")
        names.add(name)
        spans.append((float(ts), float(dur),
                      ev.get("cat") or name.split(".", 1)[0]))

    if not spans:
        problems.append("trace contains no complete ('X') span events")
        return (problems, {"n_spans": 0, "coverage": 0.0})

    cats = {c for _, _, c in spans}
    for want in require_cats:
        if want and want not in cats:
            problems.append(
                f"required stage category {want!r} has no spans "
                f"(present: {', '.join(sorted(cats))})")
    for want in require_spans:
        if want and want not in names:
            prefix = want.split(".", 1)[0]
            near = sorted(n for n in names if n.startswith(prefix))
            problems.append(
                f"required span {want!r} never recorded "
                f"(nearest by prefix: {', '.join(near) or 'none'})")

    lo = min(ts for ts, _, _ in spans)
    hi = max(ts + dur for ts, dur, _ in spans)
    iv = sorted((ts, ts + dur) for ts, dur, _ in spans)
    covered, cur_lo, cur_hi = 0.0, iv[0][0], iv[0][1]
    for a, b in iv[1:]:
        if a > cur_hi:
            covered += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    covered += cur_hi - cur_lo
    coverage = covered / max(hi - lo, 1e-12)
    if coverage < min_coverage:
        problems.append(f"span coverage {coverage:.3f} of the traced "
                        f"window is below the required {min_coverage:g}")

    return (problems, {"n_spans": len(spans), "coverage": coverage,
                       "window_ms": (hi - lo) / 1e3,
                       "n_categories": len(cats)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate a dumped repro_torch.obs Chrome/Perfetto "
                    "trace")
    ap.add_argument("trace", help="trace JSON file (Session.dump_trace)")
    ap.add_argument("--min-coverage", type=float, default=0.9,
                    help="required span-union fraction of the traced "
                         "window (default 0.9)")
    ap.add_argument("--require-cats", default=DEFAULT_CATS,
                    help="comma list of span-name prefixes that must "
                         f"each appear (default: {DEFAULT_CATS}; '' "
                         "disables the check)")
    ap.add_argument("--require-spans", default="",
                    help="comma list of EXACT span names that must each "
                         "appear (e.g. refresh.chunk,refresh.layer for "
                         "the chunked-refresh path; '' disables)")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        doc = json.load(f)
    cats = tuple(c for c in args.require_cats.split(",") if c)
    span_names = tuple(s for s in args.require_spans.split(",") if s)
    problems, summary = validate_trace(doc, args.min_coverage, cats,
                                       span_names)
    if problems:
        for p in problems:
            print(f"INVALID: {p}", file=sys.stderr)
        return 1
    print(f"OK: {summary['n_spans']} spans over "
          f"{summary['window_ms']:.1f}ms, coverage "
          f"{summary['coverage']:.3f}, {summary['n_categories']} stage "
          "categories")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
