"""Online embedding service launcher for the port (gnnserve end to end) —
the twin of ``repro.launch.serve_embeddings``.

A thin client of the public API: argparse -> ``DealConfig`` ->
``api.Session.serve()`` (which owns the offline epoch, the versioned
store with budget/eviction/onboarding, recompute-on-miss wiring, and
the continuous-batching engine with optional multi-tenant QoS).  The
driver loop here only generates traffic and prints stats.

  PYTHONPATH=src python -m repro_torch.launch.serve_embeddings \
      --dataset ogbn-products --model gcn --ticks 50 \
      --mutations-per-tick 8 --staleness-bound 64       # on the card

  # one JSON artifact reproduces the whole pipeline; a trace to check
  PYTHONPATH=src python -m repro_torch.launch.serve_embeddings \
      --config configs/examples/smoke.json --ticks 5 --device cpu \
      --trace trace.json
  PYTHONPATH=src python -m repro_torch.obs.validate trace.json

``--executor`` is "cuda" (the hand-written kernels, the default), "ref"
(plain PyTorch) or "dist": the epoch AND every delta refresh through
the distributed executor (per-partition frontier split on a ``--p`` x
``--m`` mesh of shards in this process); ``--device cuda`` (the default)
raises without a card, ``--device cpu`` runs the plain versions.

``--cluster-shards N`` serves through the multi-process cluster tier: N
shard-worker processes on the same device behind the RPC router.
``--kill-shard i`` is its failure drill: SIGKILL shard i halfway through
the drive, restart it, and require every shard's store digests to be
equal (checkpoint + WAL replay) before the drive finishes.

  PYTHONPATH=src python -m repro_torch.launch.serve_embeddings \
      --config configs/examples/smoke.json --ticks 6 --device cpu \
      --cluster-shards 2 --kill-shard 1

``--budget-rows R --evict-policy {lru,heat}`` caps each evictable store
level at R resident rows (recompute-on-miss rebuilds evicted rows,
bitwise-equal to an unbudgeted store).

``--onboarding tail --nodes-per-tick K`` onboards K brand-new nodes per
tick through the tail-partition path.

``--tenants "name:priority:slot_quota:rate:slo,..."`` turns on
multi-tenant QoS scheduling (``gnnserve.qos``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import obs
from repro_torch.api import (ClusterSpec, ConfigError, DealConfig,
                             ExecutorSpec, GraphSpec, ModelSpec,
                             PartitionSpec, QoSSpec, RefreshSpec, Session,
                             StoreSpec, tenants_from_string)
from repro_torch.gnnserve import EmbeddingServeEngine, Query, TenantRegistry


def _tenant_dicts(tenants: TenantRegistry):
    return tuple({"name": t.name, "priority": t.priority,
                  "slot_quota": t.slot_quota, "rate": t.rate,
                  "staleness_slo": t.staleness_slo} for t in tenants)


def _serve_session(cfg: DealConfig, device="cuda") -> Session:
    s = None
    try:
        s = Session.build(cfg, device=device)
        eng = s.serve()
    except BaseException as e:
        if s is not None:           # stop the endpoint, hand back obs
            s.close()
        if isinstance(e, ConfigError):
            raise SystemExit(str(e))
        raise
    st = cfg.store
    print(f"[epoch0] {s.n_nodes} nodes x {cfg.model.n_layers} layers in "
          f"{s.timings['epoch_s']:.2f}s (executor={s.executor.name}, "
          f"device={s.device})")
    if st.budget_rows:
        print(f"[budget] {st.budget_rows}/{s.n_nodes} rows per level "
              f"resident ({st.evict_policy} eviction, recompute-on-miss)")
    if st.onboarding == "tail":
        print("[onboard] node additions append a tail partition "
              "(delta-refresh served, folded at the next full epoch)")
    if eng.qos is not None:
        print("[qos] tenants: " + ", ".join(
            f"{t.name}(prio={t.priority:g} quota={t.slot_quota} "
            f"rate={t.rate:g} slo={t.staleness_slo})"
            for t in eng.qos.registry))
    if s.endpoint is not None and s.endpoint.port is not None:
        print(f"[telemetry] scrape http://127.0.0.1:{s.endpoint.port}"
              "/metrics, /healthz, /stats")
    if s.cluster is not None:
        print(f"[cluster] {cfg.cluster.n_shards} shard workers behind "
              f"the router (ready in {s.cluster.ready_wait_s:.2f}s, "
              f"run dir {s.cluster.run_dir})")
    return s


def build_service(dataset: str, model: str, *, fanout: int = 8,
                  n_layers: int = 3, d_feature: int = 64, n_shards: int = 4,
                  staleness_bound: int = 64, seed: int = 0,
                  executor: str = "cuda", p: int = 4, m: int = 2,
                  budget_rows: int = 0, evict_policy: str = "heat",
                  scale: float = 1.0, tenants: TenantRegistry = None,
                  device="cuda") -> EmbeddingServeEngine:
    """The pre-API entry point of the JAX package, kept as a shim:
    builds the equivalent ``DealConfig`` and returns
    ``Session.serve()``'s engine, which serves bitwise the rows of a
    ``Session`` built from that config."""
    cfg = DealConfig(
        graph=GraphSpec(dataset=dataset, scale=scale, fanout=fanout,
                        seed=seed, n_construct_workers=4),
        model=ModelSpec(name=model, n_layers=n_layers,
                        d_feature=d_feature),
        partition=PartitionSpec(p=p, m=m),
        executor=ExecutorSpec(name=executor, fallback_to_ref=False),
        store=StoreSpec(n_shards=n_shards, budget_rows=budget_rows,
                        evict_policy=evict_policy),
        qos=QoSSpec(staleness_bound=staleness_bound,
                    tenants=_tenant_dicts(tenants) if tenants else ()))
    return _serve_session(cfg, device).engine


def drive(eng: EmbeddingServeEngine, *, ticks: int = 50,
          queries_per_tick: int = 4, rows_per_query: int = 128,
          mutations_per_tick: int = 8, nodes_per_tick: int = 0,
          seed: int = 0) -> None:
    """``ticks`` serve steps, each under a ``serve.tick`` span: queries
    (with QoS, the first tenant's interactive-sized, the others' 8x
    scans), edge mutations and node adds, then one engine step; then
    the queue drained under ``serve.drain``.  Prints the run's stats."""
    rng = np.random.default_rng(seed)
    names = eng.qos.registry.names if eng.qos is not None else [None]
    uid = 0
    t0 = time.time()
    for tick in range(ticks):
        with obs.span("serve.tick") as tsp:
            n = eng.store.n_nodes       # grows under tail onboarding
            for j in range(queries_per_tick):
                name = names[j % len(names)]
                rows = (rows_per_query if name in (None, names[0])
                        else 8 * rows_per_query)
                q = Query(uid=uid, node_ids=rng.integers(0, n, rows))
                if name is not None:
                    q.tenant = name
                eng.submit(q)
                uid += 1
            if mutations_per_tick:
                k = mutations_per_tick
                eng.mutate().add_edges(rng.integers(0, n, k),
                                       rng.integers(0, n, k))
            if nodes_per_tick:
                d = eng.store.level_dim(0)
                # ids are assigned at refresh time, after earlier pending
                # adds: offset by them so each tick wires its own nodes
                start = n + eng.log.pending_node_adds
                eng.mutate().add_nodes(
                    nodes_per_tick,
                    rng.standard_normal((nodes_per_tick, d),
                                        dtype=np.float32))
                eng.mutate().add_edges(
                    rng.integers(0, n, nodes_per_tick),
                    np.arange(start, start + nodes_per_tick))
            eng.step()
            if tsp:
                tsp.set(tick=tick)
    with obs.span("serve.drain"):
        eng.run()
    dt = time.time() - t0
    n = eng.store.n_nodes
    s = eng.stats()
    refresh = eng.last_refresh_stats
    print(f"[serve] {s['n_served']} queries in {dt:.2f}s "
          f"({s['n_served']/max(dt,1e-9):.0f} q/s), "
          f"{s['n_gather_steps']} gather steps, "
          f"{s['n_refreshes']} delta refreshes "
          f"-> store v{s['store_version']}")
    if refresh:
        print(f"[fresh] last refresh frontier {refresh['frontier_sizes']} "
              f"of {n} rows, {refresh['rows_gemm']} gemm rows "
              f"(full epoch = {n * eng.reinfer.n_layers})")
    if s["n_onboarded"]:
        print(f"[onboard] {s['n_onboarded']} nodes added via "
              f"{s['store_n_tail_shards']} tail partition(s) "
              f"(store grew to {n} rows, no re-partition)")
    bound = ("per-tenant SLOs, tightest "
             + str(min(t.staleness_slo for t in eng.qos.registry))
             if eng.qos is not None else f"bound {eng.staleness_bound}")
    print(f"[stale] pending mutations at exit: {s['pending_mutations']} "
          f"({bound})")
    if eng.qos is not None:
        for name, t in s["tenants"].items():
            print(f"[qos] {name}: served {t['n_served']} "
                  f"({t['rows_served']} rows), wait p50/p95 "
                  f"{t['wait_p50_steps']:.0f}/{t['wait_p95_steps']:.1f} "
                  f"steps, staleness max {t['staleness_max']:.0f} "
                  f"(slo {t['staleness_slo']:.0f}, "
                  f"{t['slo_violations']} violations), "
                  f"refresh charge {t['refresh_rows_charged']:.0f} rows, "
                  f"quota util {t['quota_util']:.2f}, "
                  f"{t['n_preemptions']} preemptions")
    if eng.store.budget_rows is not None:
        mem = eng.memory_stats()
        per_level = " ".join(
            f"L{i}:{v['resident_bytes']/2**20:.2f}MB"
            for i, v in enumerate(mem.values()))
        print(f"[mem] resident {per_level} | util "
              f"{s['store_budget_util']:.2f} | hit-rate "
              f"{s['store_hit_rate']:.3f} ({s['store_misses']} misses, "
              f"{s['store_n_evictions']} evictions, "
              f"{s['store_rows_recomputed']} rows recomputed in "
              f"{s['store_recompute_s']*1e3:.0f}ms)")


def config_from_args(args) -> DealConfig:
    return DealConfig(
        graph=GraphSpec(dataset=args.dataset, scale=args.scale,
                        fanout=args.fanout, seed=args.seed,
                        n_construct_workers=4),
        model=ModelSpec(name=args.model, n_layers=args.layers,
                        d_feature=args.d_feature),
        partition=PartitionSpec(p=args.p, m=args.m),
        executor=ExecutorSpec(name=args.executor, fallback_to_ref=False),
        store=StoreSpec(n_shards=args.n_shards,
                        budget_rows=args.budget_rows,
                        evict_policy=args.evict_policy,
                        onboarding=args.onboarding),
        qos=QoSSpec(staleness_bound=args.staleness_bound,
                    tenants=(tenants_from_string(args.tenants)
                             if args.tenants else ())),
        refresh=RefreshSpec(chunk_rows=args.chunk_rows),
        cluster=ClusterSpec(n_shards=args.cluster_shards))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, metavar="CFG.json",
                    help="load the full DealConfig from a JSON artifact "
                         "(overrides every pipeline flag)")
    ap.add_argument("--dump-config", default=None, metavar="OUT.json",
                    help="write the effective DealConfig ('-' = stdout) "
                         "and exit without running")
    ap.add_argument("--dataset", default="ogbn-products")
    ap.add_argument("--model", default="gcn")
    ap.add_argument("--fanout", type=int, default=8)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--d-feature", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-shards", type=int, default=4)
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--queries-per-tick", type=int, default=4)
    ap.add_argument("--mutations-per-tick", type=int, default=8)
    ap.add_argument("--nodes-per-tick", type=int, default=0,
                    help="onboard this many NEW nodes per tick "
                         "(needs --onboarding tail)")
    ap.add_argument("--staleness-bound", type=int, default=64)
    ap.add_argument("--executor", default="cuda",
                    help="delta-refresh backend: cuda kernels / ref plain "
                         "PyTorch / dist mesh (or any registered "
                         "executor)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--p", type=int, default=4, help="graph partitions")
    ap.add_argument("--m", type=int, default=2, help="feature partitions")
    ap.add_argument("--budget-rows", type=int, default=0,
                    help="resident-row cap per evictable level (0 = "
                         "unbudgeted); misses recompute via the delta "
                         "engine")
    ap.add_argument("--evict-policy", default="heat",
                    help="victim selection for over-budget levels "
                         "(heat / lru or any registered policy)")
    ap.add_argument("--onboarding", default="none",
                    choices=["none", "tail"],
                    help="tail: node additions append a tail partition "
                         "served via delta refresh")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="scale the dataset's node count")
    ap.add_argument("--chunk-rows", type=int, default=0,
                    help="preemptible refresh under QoS: split the delta "
                         "frontier into chunks of this many rows and "
                         "interleave them with tenant gathers (0 = "
                         "inline refresh); bitwise-invariant")
    ap.add_argument("--tenants", default=None,
                    help="multi-tenant QoS: 'name:priority:slot_quota:"
                         "rate:slo,...' (rate 0 = unlimited rows/step); "
                         "replaces the global --staleness-bound")
    ap.add_argument("--trace", default=None, metavar="TRACE.json",
                    help="enable telemetry and write a Chrome/Perfetto "
                         "trace of the whole run (construct -> epoch -> "
                         "serve loop) on exit; load at ui.perfetto.dev")
    ap.add_argument("--cluster-shards", type=int, default=0,
                    help="serve through the multi-process cluster tier: "
                         "spawn this many shard-worker processes behind "
                         "the RPC router (0 = single-process)")
    ap.add_argument("--kill-shard", type=int, default=-1,
                    help="cluster failure drill: SIGKILL this shard "
                         "halfway through the drive, restart it, and "
                         "require it to rejoin bitwise-equal via "
                         "checkpoint + WAL replay")
    return ap


def kill_drill(s: Session, shard: int) -> None:
    """SIGKILL one worker of the session's cluster, restart it, and
    require every shard's store digests to be equal (it restored its
    checkpoint and replayed its WAL segment).  Raises SystemExit when
    they differ."""
    dep = s.cluster
    dep.kill_worker(shard)
    dep.restart_worker(shard)
    digs = dep.router.digests()
    if any(d["digests"] != digs[0]["digests"] for d in digs[1:]):
        raise SystemExit(f"shard {shard} did NOT rejoin bitwise-equal "
                         "after checkpoint + WAL replay")
    st = dep.router.statuses()[shard]
    print(f"[cluster] killed shard {shard}; its restart restored its "
          f"checkpoint (restored={st['restored']}), replayed "
          f"{st['replayed']} WAL entries and rejoined bitwise-equal "
          f"({len(digs)} shard digests match)")


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        cfg = (DealConfig.load(args.config) if args.config
               else config_from_args(args))
        cfg.validate()
    except ConfigError as e:
        raise SystemExit(str(e))
    if args.dump_config:
        if args.dump_config == "-":
            print(cfg.to_json())
        else:
            cfg.dump(args.dump_config)
            print(f"[config] wrote {args.dump_config}")
        return
    if args.nodes_per_tick and cfg.store.onboarding != "tail":
        raise SystemExit("--nodes-per-tick needs --onboarding tail "
                         "(or store.onboarding=\"tail\" in --config)")
    if args.trace:
        cfg.telemetry.enabled = True
    if args.cluster_shards:
        cfg.cluster.n_shards = args.cluster_shards
    if args.kill_shard >= 0 and not (
            0 <= args.kill_shard < cfg.cluster.n_shards):
        raise SystemExit("--kill-shard needs a cluster shard index "
                         "(--cluster-shards or cluster.n_shards in "
                         "--config)")
    s = _serve_session(cfg, args.device)
    with s:
        drive_kw = dict(queries_per_tick=args.queries_per_tick,
                        mutations_per_tick=args.mutations_per_tick,
                        nodes_per_tick=args.nodes_per_tick)
        if args.kill_shard >= 0:
            # kill one worker mid-stream, prove the rejoin is bitwise,
            # then finish the drive
            head = max(1, args.ticks // 2)
            drive(s.engine, ticks=head, **drive_kw)
            kill_drill(s, args.kill_shard)
            drive(s.engine, ticks=args.ticks - head, **drive_kw)
        else:
            drive(s.engine, ticks=args.ticks, **drive_kw)
        if args.trace:
            doc = s.dump_trace(args.trace)
            tr = s.telemetry.tracer
            lo, hi = tr.window_ns()
            print(f"[trace] wrote {args.trace}: "
                  f"{len(doc['traceEvents'])} events, "
                  f"coverage {tr.coverage():.2f} over "
                  f"{(hi - lo) / 1e6:.0f}ms")


if __name__ == "__main__":
    main()
