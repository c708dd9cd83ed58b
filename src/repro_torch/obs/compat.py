"""Legacy ``stats()`` dicts -> the unified metric naming scheme (the
port's copy of ``repro.obs.compat``, the same names).

``EmbeddingStore.stats()``, ``EmbeddingServeEngine.stats()`` and
``QoSScheduler.stats()`` each grew their own key shapes (flat, ``store_``
prefixed, and nested-per-tenant respectively).  Those dicts stay exactly
as they are — they are the compatibility alias existing callers
(launchers, benches, tests) keep reading — and this module derives the
ONE flat unified view from them:

    serve.queries, serve.gather_steps, serve.refreshes, ...
    store.evictions, store.hits, store.misses, store.recompute_ms, ...
    qos.tenant.<name>.p95_wait_steps, .rows_served, .preemptions, ...
    plan_cache.hits / plan_cache.misses
    construct.exchanged_bytes, construct.shuffle_ms, ...
    delta.frontier_rows, delta.rows_gemm, ...

``Session.stats()["metrics"]`` is this translation merged UNDER the live
telemetry registry (real measured histograms win over derived counters
when both exist).  Counter-style names map 1:1; times are normalized to
milliseconds (``_ms`` suffix, like every span-derived histogram).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

# unified name -> legacy EmbeddingStore.stats() key (values copied as-is)
STORE_MAP = {
    "store.version": "version",
    "store.lookups": "n_lookups",
    "store.rows_gathered": "rows_gathered",
    "store.swaps": "n_swaps",
    "store.shards": "n_shards",
    "store.levels": "n_levels",
    "store.tail_shards": "n_tail_shards",
    "store.hits": "hits",
    "store.misses": "misses",
    "store.hit_rate": "hit_rate",
    "store.evictions": "n_evictions",
    "store.rows_evicted": "rows_evicted",
    "store.recomputes": "n_recomputes",
    "store.recompute_spans": "n_recompute_spans",
    "store.rows_recomputed": "rows_recomputed",
    "store.resident_bytes": "resident_bytes",
    "store.budget_rows": "budget_rows",
    "store.budget_util": "budget_util",
}

# unified name -> legacy engine.stats() key (the non-store, non-tenant part)
ENGINE_MAP = {
    "serve.queries": "n_served",
    "serve.gather_steps": "n_gather_steps",
    "serve.refreshes": "n_refreshes",
    "serve.refresh_chunks": "n_refresh_chunks",
    "serve.full_epochs": "n_full_epochs",
    "serve.onboarded": "n_onboarded",
    "serve.pending_mutations": "pending_mutations",
}

# unified name -> Session.stats()["refresh_cutover"] key (the dist
# executor's dist-vs-local routing counters and its tail-row routing;
# 0 in the port until that executor is ported)
CUTOVER_MAP = {
    "refresh.cutover_threshold": "threshold",
    "refresh.route_local": "n_local",
    "refresh.route_dist": "n_dist",
    "refresh.route_tail_rows": "n_tail",
}

# unified per-tenant suffix -> legacy QoSScheduler.stats() tenant key.
# These step-denominated waits are the derived alias; the wall-clock
# ``qos.tenant.<name>.wait_ms`` histogram comes from live telemetry.
TENANT_MAP = {
    "n_served": "n_served",
    "rows_served": "rows_served",
    "p50_wait_steps": "wait_p50_steps",
    "p95_wait_steps": "wait_p95_steps",
    "staleness_p95": "staleness_p95",
    "staleness_max": "staleness_max",
    "staleness_slo": "staleness_slo",
    "slo_violations": "slo_violations",
    "refresh_rows_charged": "refresh_rows_charged",
    "refresh_triggers": "n_refresh_triggers",
    "quota_util": "quota_util",
    "preemptions": "n_preemptions",
    "view_restarts": "n_view_restarts",
    "deferred_pins": "n_deferred_pins",
    "view_version": "view_version",
}

# the tenant fields external consumers read (the JAX package's QoS bench
# and serving launcher) — the key-drift guard pins QoSScheduler.stats()
# to at least this contract
TENANT_CONSUMED_FIELDS = frozenset(
    ["n_served", "rows_served", "wait_p50_steps", "wait_p95_steps",
     "staleness_max", "staleness_slo", "slo_violations",
     "refresh_rows_charged", "quota_util", "n_preemptions"])


def unified_from_engine(engine_stats: Dict[str, Any]) -> Dict[str, float]:
    """Flatten one ``EmbeddingServeEngine.stats()`` dict (which embeds
    the store's stats under ``store_`` and tenants under ``tenants``)
    onto the unified names."""
    out: Dict[str, float] = {}
    for uni, legacy in ENGINE_MAP.items():
        if legacy in engine_stats:
            out[uni] = engine_stats[legacy]
    for uni, legacy in STORE_MAP.items():
        key = f"store_{legacy}"
        if key in engine_stats:
            out[uni] = engine_stats[key]
    if "store_recompute_s" in engine_stats:
        out["store.recompute_ms"] = engine_stats["store_recompute_s"] * 1e3
    for name, t in engine_stats.get("tenants", {}).items():
        for uni, legacy in TENANT_MAP.items():
            if legacy in t:
                out[f"qos.tenant.{name}.{uni}"] = t[legacy]
    return out


def unified_from_store(store_stats: Dict[str, Any]) -> Dict[str, float]:
    """Same translation for a bare ``EmbeddingStore.stats()`` dict."""
    out = {uni: store_stats[legacy] for uni, legacy in STORE_MAP.items()
           if legacy in store_stats}
    if "recompute_s" in store_stats:
        out["store.recompute_ms"] = store_stats["recompute_s"] * 1e3
    return out


def unified_from_construct(construct_stats: Dict[str, Any]
                           ) -> Dict[str, float]:
    """``csr_from_edges_distributed`` stats -> unified names."""
    out: Dict[str, float] = {}
    if "exchanged_bytes" in construct_stats:
        out["construct.exchanged_bytes"] = construct_stats["exchanged_bytes"]
    for uni, legacy in (("construct.shuffle_ms", "shuffle_s"),
                        ("construct.build_ms", "build_s"),
                        ("construct.modeled_parallel_ms",
                         "modeled_parallel_s")):
        if legacy in construct_stats:
            out[uni] = construct_stats[legacy] * 1e3
    if "n_workers" in construct_stats:
        out["construct.workers"] = construct_stats["n_workers"]
    return out


def unified_from_refresh(refresh_stats: Dict[str, Any]) -> Dict[str, float]:
    """The LAST refresh's ``DeltaReinference.refresh`` result -> unified
    names (cumulative frontier counters live in telemetry; this is the
    latest-refresh gauge view)."""
    out: Dict[str, float] = {}
    if "rows_gemm" in refresh_stats:
        out["delta.rows_gemm"] = refresh_stats["rows_gemm"]
    for uni, legacy in (("delta.resampled", "n_resampled"),
                        ("delta.feat_updates", "n_feat_updates"),
                        ("delta.rev_splices", "rev_splices"),
                        ("delta.rev_rebuilds", "rev_rebuilds"),
                        ("delta.chunks", "n_chunks"),
                        ("delta.tail_routed", "n_tail_routed"),
                        ("delta.onboarded", "n_onboarded")):
        if legacy in refresh_stats:
            out[uni] = refresh_stats[legacy]
    if "local_cutover" in refresh_stats:
        out["delta.local_cutover"] = int(bool(refresh_stats["local_cutover"]))
    for l, n in enumerate(refresh_stats.get("frontier_sizes", [])):
        out[f"delta.frontier_rows.layer{l}"] = n
    return out


def unified_from_cutover(cutover: Dict[str, Any]) -> Dict[str, float]:
    """``Session.stats()["refresh_cutover"]`` -> unified names."""
    return {uni: cutover[legacy] for uni, legacy in CUTOVER_MAP.items()
            if legacy in cutover}


# Session.stats() keys that are structural containers or derived views
# rather than metric leaves: each one is either translated by a dedicated
# map above, merged from the live registry, or an aggregate the report
# CLI consumes wholesale.  Anything outside these AND the maps is key
# drift — ``unified_from_session`` returns it as unmapped so the guard
# test fails loudly instead of the unified view silently thinning out.
SESSION_PASSTHROUGH = frozenset([
    "metrics",          # already the unified view
    "attribution",      # per-tenant critical-path aggregate (report CLI)
    "health",           # HealthMonitor summary (alert list + burn rates)
])
SESSION_SCALARS = {
    "n_nodes": "session.n_nodes",
    "n_edges": "session.n_edges",
}


def unified_from_session(stats: Dict[str, Any]
                         ) -> Tuple[Dict[str, float], List[str]]:
    """Walk a full ``Session.stats()`` tree and resolve EVERY leaf to a
    registered unified metric name.  Returns ``(unified, unmapped)`` —
    the guard test asserts ``unmapped == []`` so new stats keys cannot
    land without a naming-scheme entry."""
    unified: Dict[str, float] = {}
    unmapped: List[str] = []
    for k, v in stats.items():
        if k in SESSION_PASSTHROUGH:
            continue
        if k in SESSION_SCALARS:
            unified[SESSION_SCALARS[k]] = v
        elif k.startswith("t_") and isinstance(v, (int, float)):
            unified[f"session.{k[2:].removesuffix('_s')}_ms"] = v * 1e3
        elif k == "plan_cache" and isinstance(v, dict):
            for kk, vv in v.items():
                if kk in ("hits", "misses"):
                    unified[f"plan_cache.{kk}"] = vv
                else:
                    unmapped.append(f"plan_cache.{kk}")
        elif k == "refresh_cutover" and isinstance(v, dict):
            unified.update(unified_from_cutover(v))
            known = set(CUTOVER_MAP.values())
            unmapped.extend(f"refresh_cutover.{kk}" for kk in v
                            if kk not in known)
        elif k == "tenants" and isinstance(v, dict):
            rev = {legacy: uni for uni, legacy in TENANT_MAP.items()}
            for name, t in v.items():
                for kk, vv in t.items():
                    if kk in rev:
                        unified[f"qos.tenant.{name}.{rev[kk]}"] = vv
                    else:
                        unmapped.append(f"tenants.{name}.{kk}")
        elif k == "store_recompute_s":
            unified["store.recompute_ms"] = v * 1e3
        elif k.startswith("store_"):
            rev = {legacy: uni for uni, legacy in STORE_MAP.items()}
            legacy = k[len("store_"):]
            if legacy in rev:
                unified[rev[legacy]] = v
            else:
                unmapped.append(k)
        else:
            rev = {legacy: uni for uni, legacy in ENGINE_MAP.items()}
            if k in rev:
                unified[rev[k]] = v
            else:
                unmapped.append(k)
    return unified, unmapped


def unified_metrics(engine_stats: Optional[Dict[str, Any]] = None,
                    construct_stats: Optional[Dict[str, Any]] = None,
                    refresh_stats: Optional[Dict[str, Any]] = None,
                    plan_cache: Optional[Dict[str, int]] = None,
                    timings: Optional[Dict[str, float]] = None,
                    live: Optional[Dict[str, float]] = None,
                    cutover: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, float]:
    """The whole unified view: every legacy shape translated, then the
    LIVE telemetry registry merged on top (measured beats derived)."""
    out: Dict[str, float] = {}
    if construct_stats:
        out.update(unified_from_construct(construct_stats))
    if engine_stats:
        out.update(unified_from_engine(engine_stats))
    if refresh_stats:
        out.update(unified_from_refresh(refresh_stats))
    if cutover:
        out.update(unified_from_cutover(cutover))
    if plan_cache:
        out["plan_cache.hits"] = plan_cache.get("hits", 0)
        out["plan_cache.misses"] = plan_cache.get("misses", 0)
    for k, v in (timings or {}).items():
        out[f"session.{k.removesuffix('_s')}_ms"] = v * 1e3
    out.update(live or {})
    return dict(sorted(out.items()))
