"""Minimal gnnserve walkthrough on the PyTorch port, as a thin client of
its public API (the twin of ``examples/embedding_service.py``):
one declarative ``DealConfig`` drives everything — serve embeddings,
mutate the graph, watch the staleness bound trigger an incremental
refresh; rerun the same traffic on a memory-budgeted store (50%
resident rows, heat eviction) and check it serves bitwise-identical
rows via recompute-on-miss; onboard brand-new nodes through a tail
partition and fold them in with a full epoch; end with a multi-tenant
QoS replay where each tenant's rows are bitwise what a single-tenant
engine at its own SLO would have served.

Because every Session draws all randomness from the config's seeds, the
budgeted / solo / multi-tenant engines are built as SEPARATE Sessions
from (near-)equal configs and still live in bitwise-identical worlds.

The sessions run the "cuda" executor (the hand-written kernels) on the
card, or their plain versions with ``--device cpu``.

  PYTHONPATH=src python examples/torch_embedding_service.py      # card
  PYTHONPATH=src python examples/torch_embedding_service.py --device cpu
"""
import argparse
import dataclasses
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import (DealConfig, ExecutorSpec,  # noqa: E402
                             GraphSpec, ModelSpec, QoSSpec, Session,
                             StoreSpec, tenants_from_string)
from repro_torch.gnnserve import Query  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (default; fails without a card) or cpu")
DEVICE = ap.parse_args().device

N, D, LAYERS = 1024, 32, 3

BASE = DealConfig(
    graph=GraphSpec(dataset="rmat", n_nodes=N, avg_degree=16, fanout=8),
    model=ModelSpec(name="gcn", n_layers=LAYERS, d_feature=D),
    executor=ExecutorSpec(name="cuda"),
    qos=QoSSpec(staleness_bound=8))

# offline pipeline + online engine, from one config
sess = Session.build(BASE, device=DEVICE)
eng = sess.serve()

q = Query(uid=0, node_ids=np.arange(16))
eng.submit(q)
eng.run()
print(f"served v{q.served_version} ({sess.executor.name} executor on "
      f"{sess.device}): first row head "
      f"{np.round(q.out[0, :4], 3)}")

# mutate past the bound: 10 new edges into node 0's neighborhood
sess.apply_mutations().add_edges(
    np.random.default_rng(1).integers(0, N, 10), np.zeros(10, np.int64))
print(f"pending mutations: {eng.staleness} (bound {eng.staleness_bound})")

q2 = Query(uid=1, node_ids=np.arange(16))
eng.submit(q2)
eng.run()                         # bound tripped -> delta refresh inline
st = eng.last_refresh_stats
print(f"served v{q2.served_version} after delta refresh: frontier "
      f"{st['frontier_sizes']} of {N} rows "
      f"({st['rows_gemm']} gemm rows vs {N * LAYERS} for a full epoch)")
print(f"node 0 embedding moved: "
      f"{not np.array_equal(q.out[0], q2.out[0])}")
assert eng.store.version == 1 and eng.n_refreshes == 1

# memory-budgeted replay: same config + a 50% budget; a SEPARATE
# Session is the same world, so rows must match bit for bit
cfg_b = dataclasses.replace(
    BASE, store=StoreSpec(budget_rows=N // 2, evict_policy="heat"))
eng_b = Session.build(cfg_b, device=DEVICE).serve()
eng_b.mutate().add_edges(np.random.default_rng(1).integers(0, N, 10),
                         np.zeros(10, np.int64))
q3 = Query(uid=2, node_ids=np.arange(16))
eng_b.submit(q3)
eng_b.run()
assert np.array_equal(q3.out, q2.out), "budgeted store must serve the " \
    "same bits"
s = eng_b.stats()
mem = eng_b.memory_stats()
print(f"budgeted(50%): identical rows; hit-rate {s['store_hit_rate']:.2f}, "
      f"{s['store_n_evictions']} evictions, "
      f"{s['store_rows_recomputed']} rows recomputed; resident "
      + " ".join(f"L{i}:{v['resident_bytes']//1024}KB"
                 for i, v in enumerate(mem.values())))

# ---------------------------------------------------------------------
# incremental node onboarding: add 4 nodes with features + edges, serve
# them via a tail partition, then fold with a full (re-partition) epoch
# ---------------------------------------------------------------------
cfg_o = dataclasses.replace(BASE, store=StoreSpec(onboarding="tail"))
sess_o = Session.build(cfg_o, device=DEVICE)
eng_o = sess_o.serve()
rng = np.random.default_rng(5)
eng_o.mutate().add_nodes(4, rng.standard_normal((4, D), dtype=np.float32))
eng_o.mutate().add_edges(rng.integers(0, N, 8),
                         np.repeat(np.arange(N, N + 4), 2))
q4 = Query(uid=3, node_ids=np.arange(N - 2, N + 4), fresh=True)
eng_o.submit(q4)
eng_o.run()
assert eng_o.store.n_nodes == N + 4 and eng_o.store.n_tail_shards == 1
print(f"onboarded 4 nodes via tail partition (store v"
      f"{eng_o.store.version}, {eng_o.store.n_shards} shards); new-node "
      f"row head {np.round(q4.out[-1, :3], 3)}")
fold = eng_o.full_epoch()
assert eng_o.store.n_tail_shards == 0
assert np.array_equal(eng_o.store.lookup(q4.node_ids, -1), q4.out), \
    "folding the tail must not change any served bits"
print(f"folded into {fold['n_shards']} main partitions at v"
      f"{fold['version']}: bitwise-unchanged")

# ---------------------------------------------------------------------
# multi-tenant QoS replay: a strict interactive tenant and a loose batch
# tenant share one engine; solo engines at each tenant's SLO are driven
# with the same schedule as the bitwise oracle
# ---------------------------------------------------------------------
eng_q = Session.build(dataclasses.replace(
    BASE, qos=QoSSpec(batch_slots=4, rows_per_step=128,
                      tenants=tenants_from_string(
                          "ui:4:2:0:4,batch:1:1:64:1000"))),
    device=DEVICE).serve()
solo = {name: Session.build(dataclasses.replace(
            BASE, qos=QoSSpec(staleness_bound=slo, batch_slots=4,
                              rows_per_step=128)), device=DEVICE).serve()
        for name, slo in (("ui", 4), ("batch", 1000))}

rng = np.random.default_rng(7)
pairs = []
for tick in range(8):
    ids_ui = rng.integers(0, N, 32)
    ids_batch = rng.integers(0, N, 256)
    qm_ui = Query(uid=100 + tick, node_ids=ids_ui, tenant="ui")
    qm_b = Query(uid=200 + tick, node_ids=ids_batch, tenant="batch")
    qs_ui = Query(uid=tick, node_ids=ids_ui)
    qs_b = Query(uid=tick, node_ids=ids_batch)
    eng_q.submit(qm_ui), eng_q.submit(qm_b)
    solo["ui"].submit(qs_ui), solo["batch"].submit(qs_b)
    s_e, d_e = rng.integers(0, N, 3), rng.integers(0, N, 3)
    for e in (eng_q, solo["ui"], solo["batch"]):
        e.mutate().add_edges(s_e, d_e)
        e.run()
    pairs += [(qm_ui, qs_ui), (qm_b, qs_b)]
for qm, qs in pairs:
    assert np.array_equal(qm.out, qs.out), \
        f"tenant {qm.tenant} diverged from its solo-SLO run"
ts = eng_q.stats()["tenants"]
print(f"qos: ui v{ts['ui']['view_version']:.0f} "
      f"(staleness max {ts['ui']['staleness_max']:.0f} <= slo 4, "
      f"{eng_q.n_refreshes} refreshes it triggered) while batch lagged at "
      f"v{ts['batch']['view_version']:.0f}; every tenant bitwise-equal to "
      f"its solo-SLO engine")
