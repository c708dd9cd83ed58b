"""Post-run serving-tier health report + bench trajectory gate — the
port's copy of ``repro.obs.report``.

Report mode — render one dumped trace (``Session.dump_trace`` output)
as an operator-readable text report:

    PYTHONPATH=src python -m repro_torch.obs.report TRACE.json \
        [--top-k 10] [--check]

Sections: the span-stage breakdown (count/total/max per span name), the
top-k per-query critical paths (the engine's ``serve.query`` events,
slowest first, with their segment ledgers), the per-tenant attribution
tables (the ``deal_attribution`` payload ``Session.dump_trace`` embeds),
and every ``health.alert`` event.  ``--check`` exits non-zero unless the
trace parses, contains spans, and — when query events are present —
every tenant's attribution closes within the 5% reconciliation bound.

Trajectory mode — gate a bench history file in the JAX package's
``TRAJECTORY.json`` format (a list of entries, one per bench run).  The
port writes no such file; the gate reads only the path it is given:

    PYTHONPATH=src python -m repro_torch.obs.report \
        --trajectory PATH [--last-n 8] [--share-tolerance 0.3] \
        [--min-share 0.1]

The gate compares the LATEST entry against the median of the previous
up-to-N entries with the same (executor, smoke) key, per bench and per
span stage.  It compares each stage's SHARE of its bench's total span
time rather than absolute ms — shares survive machine changes while
still catching the regression class that matters: a stage suddenly
dominating the end-to-end profile.  A stage regresses when its share
grew by more than ``--share-tolerance`` (absolute) AND ended above
``--min-share``; a bench that newly failed always regresses.  With
fewer than 2 comparable entries the gate passes (the seed run), and
identical entries always pass — the gate passes against itself.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Tuple

from repro_torch.obs.health import SEGMENTS

# attribution must close within 5% of measured end-to-end wall time
ATTRIBUTION_TOLERANCE = 0.05


# ----------------------------------------------------------------------
# trace report
# ----------------------------------------------------------------------

def load_trace(path) -> dict:
    with open(path) as f:
        return json.load(f)


def _spans(doc: dict) -> List[dict]:
    return [ev for ev in doc.get("traceEvents", [])
            if isinstance(ev, dict) and ev.get("ph") == "X"]


def _fmt_row(cells, widths) -> str:
    return "  ".join(str(c).rjust(w) if i else str(c).ljust(w)
                     for i, (c, w) in enumerate(zip(cells, widths)))


def _table(headers, rows) -> List[str]:
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows))
              if rows else len(str(h)) for i, h in enumerate(headers)]
    out = [_fmt_row(headers, widths),
           _fmt_row(["-" * w for w in widths], widths)]
    out += [_fmt_row(r, widths) for r in rows]
    return out


def stage_breakdown(doc: dict) -> Dict[str, Dict[str, float]]:
    """Per span name: count, total_ms, max_ms (ts/dur are us)."""
    agg: Dict[str, Dict[str, float]] = {}
    for ev in _spans(doc):
        a = agg.setdefault(ev["name"],
                           {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
        a["count"] += 1
        ms = float(ev.get("dur", 0)) / 1e3
        a["total_ms"] += ms
        a["max_ms"] = max(a["max_ms"], ms)
    return agg


def query_events(doc: dict) -> List[dict]:
    """The engine's per-query critical-path events, slowest first."""
    out = [ev for ev in _spans(doc) if ev["name"] == "serve.query"]
    out.sort(key=lambda ev: -float(ev.get("dur", 0)))
    return out


def alert_events(doc: dict) -> List[dict]:
    return [ev for ev in _spans(doc) if ev["name"] == "health.alert"]


def render_report(doc: dict, top_k: int = 10) -> str:
    lines: List[str] = []
    spans = _spans(doc)
    lines.append("== serving-tier health report ==")
    lines.append(f"{len(spans)} spans"
                 + (f", {doc['deal_dropped_spans']} dropped (ring "
                    "buffer wrapped)" if doc.get("deal_dropped_spans")
                    else ""))

    agg = stage_breakdown(doc)
    lines.append("")
    lines.append("-- stage breakdown (by total time) --")
    rows = [(n, a["count"], f"{a['total_ms']:.2f}", f"{a['max_ms']:.2f}")
            for n, a in sorted(agg.items(),
                               key=lambda kv: -kv[1]["total_ms"])]
    lines += _table(("span", "count", "total_ms", "max_ms"), rows)

    qevents = query_events(doc)
    if qevents:
        lines.append("")
        lines.append(f"-- top-{min(top_k, len(qevents))} critical paths "
                     f"(of {len(qevents)} served queries) --")
        rows = []
        for ev in qevents[:top_k]:
            args = ev.get("args", {})
            rows.append((f"{args.get('tenant', '?')}/"
                         f"{args.get('uid', '?')}",
                         f"{float(ev.get('dur', 0)) / 1e3:.2f}",
                         *(f"{args.get(f'{s}_ms', 0):.2f}"
                           for s in SEGMENTS)))
        lines += _table(("query", "e2e_ms", *SEGMENTS), rows)

    attribution = doc.get("deal_attribution")
    if attribution:
        lines.append("")
        lines.append("-- per-tenant attribution (latency budget) --")
        rows = []
        for tenant, a in sorted(attribution.items()):
            rows.append((tenant, a["n_queries"],
                         f"{a['e2e_ms']['p50']:.2f}",
                         f"{a['e2e_ms']['p95']:.2f}",
                         *(f"{100 * a['segments_frac'][s]:.1f}%"
                           for s in SEGMENTS),
                         f"{a['attributed_frac']:.3f}"))
        lines += _table(("tenant", "queries", "p50_ms", "p95_ms",
                         *SEGMENTS, "attributed"), rows)

    health = doc.get("deal_health")
    alerts = alert_events(doc)
    lines.append("")
    if alerts or (health and health.get("alerts")):
        lines.append(f"-- health alerts ({len(alerts)}) --")
        seen = alerts or [{"args": a, "ts": None}
                          for a in health.get("alerts", [])]
        for ev in seen:
            a = ev.get("args", {})
            detail = {k: v for k, v in a.items()
                      if k not in ("kind", "subject", "depth")}
            when = ("" if ev.get("ts") is None
                    else f" @ {float(ev['ts']) / 1e3:.1f}ms")
            lines.append(f"ALERT {a.get('kind', '?')} "
                         f"[{a.get('subject', '?')}]{when} {detail}")
        if health and health.get("burn_rate"):
            lines.append("burn rates: " + ", ".join(
                f"{t}={b:.2f}" for t, b in
                sorted(health["burn_rate"].items())))
    else:
        lines.append("-- health: no alerts --")
    return "\n".join(lines) + "\n"


def check_trace(doc: dict, top_k: int = 10) -> List[str]:
    """The ``--check`` gate: structural problems in a rendered report's
    inputs (empty list == healthy)."""
    problems: List[str] = []
    if not _spans(doc):
        problems.append("trace contains no span events")
        return problems
    try:
        render_report(doc, top_k)
    except Exception as exc:        # report must never crash on real dumps
        problems.append(f"report rendering failed: {exc!r}")
    attribution = doc.get("deal_attribution") or {}
    for tenant, a in sorted(attribution.items()):
        frac = a.get("attributed_frac", 0.0)
        if abs(frac - 1.0) > ATTRIBUTION_TOLERANCE:
            problems.append(
                f"tenant {tenant!r}: attribution closes at "
                f"{frac:.3f} of measured e2e (must be within "
                f"{ATTRIBUTION_TOLERANCE:.0%})")
    if query_events(doc) and not attribution:
        problems.append("serve.query events present but no "
                        "deal_attribution payload (dump_trace drift?)")
    return problems


# ----------------------------------------------------------------------
# bench trajectory
# ----------------------------------------------------------------------

def load_trajectory(path) -> List[dict]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return []
    return doc if isinstance(doc, list) else []


def _stage_shares(bench: dict) -> Dict[str, float]:
    stages = bench.get("stages", {})
    total = sum(float(s.get("total_ms", 0)) for s in stages.values())
    if total <= 0:
        return {}
    return {name: float(s.get("total_ms", 0)) / total
            for name, s in stages.items()}


def _median(vals: List[float]) -> float:
    vs = sorted(vals)
    n = len(vs)
    return vs[n // 2] if n % 2 else 0.5 * (vs[n // 2 - 1] + vs[n // 2])


def check_trajectory(entries: List[dict], *, last_n: int = 8,
                     share_tolerance: float = 0.3,
                     min_share: float = 0.1
                     ) -> Tuple[List[str], Dict[str, Any]]:
    """Gate the LATEST entry against the median stage shares of the
    previous up-to-``last_n`` entries with the same (executor, smoke)
    key.  Returns (problems, summary); no baseline == pass."""
    if not entries:
        return [], {"n_entries": 0, "compared": 0, "verdict": "empty"}
    latest = entries[-1]
    problems: List[str] = []
    for bench in sorted(latest.get("failures", [])):
        problems.append(f"bench {bench!r} failed in the latest run")
    key = (latest.get("executor"), latest.get("smoke"))
    baseline = [e for e in entries[:-1]
                if (e.get("executor"), e.get("smoke")) == key
                and not e.get("failures")][-last_n:]
    compared = 0
    if baseline:
        base_shares: Dict[str, Dict[str, List[float]]] = {}
        for e in baseline:
            for bkey, bench in e.get("benches", {}).items():
                for stage, share in _stage_shares(bench).items():
                    base_shares.setdefault(bkey, {}).setdefault(
                        stage, []).append(share)
        for bkey, bench in sorted(latest.get("benches", {}).items()):
            for stage, share in sorted(_stage_shares(bench).items()):
                hist = base_shares.get(bkey, {}).get(stage)
                if not hist:
                    continue            # new stage: informational only
                compared += 1
                med = _median(hist)
                if share > med + share_tolerance and share > min_share:
                    problems.append(
                        f"{bkey}/{stage}: stage share grew to "
                        f"{share:.2f} of the bench profile (median of "
                        f"last {len(hist)}: {med:.2f}, tolerance "
                        f"+{share_tolerance:g})")
    return problems, {"n_entries": len(entries),
                      "n_baseline": len(baseline), "compared": compared,
                      "verdict": "fail" if problems else "ok"}


def render_trajectory(entries: List[dict], last_n: int = 8) -> str:
    lines = [f"== bench trajectory ({len(entries)} entries) =="]
    for e in entries[-last_n:]:
        benches = e.get("benches", {})
        total = sum(sum(float(s.get("total_ms", 0))
                        for s in b.get("stages", {}).values())
                    for b in benches.values())
        fails = e.get("failures", [])
        lines.append(
            f"ts={e.get('ts', '?')} git={e.get('git', '?')} "
            f"executor={e.get('executor', '?')} "
            f"smoke={e.get('smoke', '?')} benches={len(benches)} "
            f"span_total={total:.0f}ms"
            + (f" FAILURES={fails}" if fails else ""))
    return "\n".join(lines) + "\n"


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render a serving-tier health report from a dumped "
                    "trace, or gate the tracked bench trajectory")
    ap.add_argument("trace", nargs="?",
                    help="trace JSON (Session.dump_trace output)")
    ap.add_argument("--top-k", type=int, default=10,
                    help="critical paths to render (default 10)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless the trace renders and every "
                         "tenant's attribution closes within "
                         f"{ATTRIBUTION_TOLERANCE:.0%}")
    ap.add_argument("--trajectory", metavar="PATH",
                    help="gate a bench trajectory file instead of "
                         "rendering a trace")
    ap.add_argument("--last-n", type=int, default=8,
                    help="baseline entries for the trajectory gate "
                         "(default 8)")
    ap.add_argument("--share-tolerance", type=float, default=0.3,
                    help="allowed absolute growth of a stage's share of "
                         "its bench profile (default 0.3)")
    ap.add_argument("--min-share", type=float, default=0.1,
                    help="stages below this share never regress "
                         "(default 0.1)")
    args = ap.parse_args(argv)

    if args.trajectory:
        entries = load_trajectory(args.trajectory)
        sys.stdout.write(render_trajectory(entries, args.last_n))
        problems, summary = check_trajectory(
            entries, last_n=args.last_n,
            share_tolerance=args.share_tolerance,
            min_share=args.min_share)
        for p in problems:
            print(f"REGRESSION: {p}", file=sys.stderr)
        print(f"gate: {summary['verdict']} "
              f"({summary.get('compared', 0)} stage shares compared "
              f"against {summary.get('n_baseline', 0)} baseline entries)")
        return 1 if problems else 0

    if not args.trace:
        ap.error("a trace path or --trajectory is required")
    doc = load_trace(args.trace)
    sys.stdout.write(render_report(doc, args.top_k))
    if args.check:
        problems = check_trace(doc, args.top_k)
        for p in problems:
            print(f"CHECK FAILED: {p}", file=sys.stderr)
        if problems:
            return 1
        print("check: ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
