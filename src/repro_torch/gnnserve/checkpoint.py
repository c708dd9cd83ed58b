"""World checkpoints: everything a serving process needs to rejoin an
epoch without recomputing it.  The same ``.npz`` format as
``repro.gnnserve.checkpoint`` (``FORMAT``, the ``world_meta`` JSON), so
a world saved by either package loads in the other.

``EmbeddingStore.dump``/``load`` cover the store alone; a *restart*
needs more — the mutated CSR, the (possibly grown and resampled) layer
graphs, and the engine counters that drive staleness accounting — or
the rebuilt process would re-derive its world from the config's seeds
and silently lose every mutation folded since build time.  One
``save_world`` artifact (a single ``.npz``) captures:

  * the store's committed front (``EmbeddingStore.state_arrays``),
  * the engine's CURRENT graph (indptr/indices — post edge splices),
  * every layer graph (nbr/mask/fanout — post resamples and tail
    growth),
  * engine/refresh counters (``ops_drained``, refresh/epoch counts,
    onboarded extent) and the delta engine's frozen ``n_main`` (the
    main-partition extent the dist tail-routing check keys on, which a
    naive rebuild would wrongly infer from the GROWN node count),
  * an opaque ``committed_seq`` the cluster tier uses to mark how much
    of a shard's mutation log the checkpoint already contains.

``restore_into_session`` is the surgical inverse: given a freshly built
``Session`` (same ``DealConfig``), it swaps in the checkpointed world
and stands up the serving engine WITHOUT running the full epoch —
``Session.from_checkpoint`` is the user-facing wrapper, and the cluster
``ShardWorker`` uses the same path before replaying its WAL segment.

Bitwise contract: a restored world serves exactly the bytes the dumped
one served — store rows restore verbatim (residency included), layer
graphs restore verbatim (so recompute-on-miss and later delta refreshes
re-derive identical rows), and the engine's counters resume where they
stopped (so refresh scheduling decisions continue unchanged).
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.sampler import LayerGraph
from repro_torch.gnnserve.store import EmbeddingStore

FORMAT = 1


def save_world(path, engine, *, committed_seq: int = 0) -> Dict:
    """Dump one serving engine's world to ``path`` (.npz).  Returns the
    metadata dict that was embedded."""
    reinfer = engine.reinfer
    meta = {"format": FORMAT,
            "committed_seq": int(committed_seq),
            "n_main": int(reinfer.n_main),
            "n_layer_graphs": len(reinfer.layer_graphs),
            "fanouts": [int(lg.fanout) for lg in reinfer.layer_graphs],
            "ops_drained": int(engine.ops_drained),
            "n_refreshes": int(engine.n_refreshes),
            "n_full_epochs": int(engine.n_full_epochs),
            "n_onboarded": int(engine.n_onboarded),
            "n_refresh_chunks": int(engine.n_refresh_chunks)}
    arrays = {"world_meta": np.frombuffer(
                  json.dumps(meta, sort_keys=True).encode(), np.uint8),
              "g_indptr": engine.graph.indptr,
              "g_indices": engine.graph.indices}
    for l, lg in enumerate(reinfer.layer_graphs):
        arrays[f"lg{l}_nbr"] = lg.nbr
        arrays[f"lg{l}_mask"] = lg.mask
    arrays.update(engine.store.state_arrays(prefix="store_"))
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)
    return meta


def peek_meta(path) -> Dict:
    """Read only the metadata blob (``committed_seq`` etc.)."""
    with np.load(path) as z:
        return json.loads(bytes(np.asarray(z["world_meta"],
                                           np.uint8)).decode())


def load_world(path):
    """Load ``(meta, graph, layer_graphs, store)`` from a world
    checkpoint.  The store comes back with no recompute hook bound."""
    with np.load(path) as z:
        meta = json.loads(bytes(np.asarray(z["world_meta"],
                                           np.uint8)).decode())
        assert meta["format"] == FORMAT, \
            f"unknown checkpoint format {meta['format']}"
        graph = Graph(indptr=np.asarray(z["g_indptr"], np.int64).copy(),
                      indices=np.asarray(z["g_indices"], np.int32).copy(),
                      n_nodes=int(z["g_indptr"].shape[0]) - 1)
        lgs = [LayerGraph(nbr=np.asarray(z[f"lg{l}_nbr"], np.int32).copy(),
                          mask=np.asarray(z[f"lg{l}_mask"], bool).copy(),
                          fanout=int(meta["fanouts"][l]))
               for l in range(meta["n_layer_graphs"])]
        store = EmbeddingStore.from_state_arrays(z, prefix="store_")
    return meta, graph, lgs, store


def restore_into_session(session, path) -> Dict:
    """Swap a world checkpoint into a freshly BUILT (not yet serving)
    ``Session``: build the delta engine over the checkpointed layer
    graphs (``n_main`` restored from metadata, NOT inferred from the
    possibly-grown extent), attach the restored store, and stand up the
    serving engine — no full epoch runs.  Returns the checkpoint
    metadata."""
    from repro_torch.gnnserve.delta import DeltaReinference, attach_recompute
    assert session._engine is None, \
        "restore must happen before the session serves"
    meta, graph, lgs, store = load_world(path)
    cfg = session.cfg
    session.graph = graph
    session.reinfer = DeltaReinference(
        lgs, cfg.model.name, session.params,
        sample_seed=cfg.refresh.sample_seed, executor=session.executor,
        local_cutover=cfg.refresh.dist_local_cutover)
    session.reinfer.n_main = int(meta["n_main"])
    if store.budget_rows is not None:
        attach_recompute(store, session.reinfer)
    engine = session._attach_engine(store)
    engine.graph = graph
    engine.ops_drained = int(meta["ops_drained"])
    engine.n_refreshes = int(meta["n_refreshes"])
    engine.n_full_epochs = int(meta["n_full_epochs"])
    engine.n_onboarded = int(meta["n_onboarded"])
    engine.n_refresh_chunks = int(meta["n_refresh_chunks"])
    if engine.qos is not None:
        # per-tenant views restart at the restored epoch: the scheduler
        # state (credits, lagged views) is advisory and rebuilds from
        # traffic; freshness restarts with nothing unobserved
        for name in engine.qos.registry.names:
            st = engine.qos.state(name)
            st.view_version = store.version
            st.ops_at_view = engine.ops_drained
        engine.qos.record_epoch(store.version, engine.ops_drained,
                                store.snapshot())
    return meta


__all__ = ["save_world", "load_world", "peek_meta",
           "restore_into_session", "FORMAT"]
