"""gnnserve — online embedding serving on one card, the port's twin of
``repro.gnnserve`` (single process, and the multi-process cluster tier
in ``gnnserve.cluster``).

The offline pipeline (graph -> layer-wise sampling -> all-node epoch)
produces embeddings for ALL nodes.  gnnserve keeps every level of that
computation and keeps it fresh as the graph mutates, without re-running
full epochs:

  ``store``      Versioned, partition-sharded embedding store holding
                 every level (features, each layer's input, the final
                 embedding) as host numpy arrays.  Writers stage
                 copy-on-write shards; ``commit`` swaps them in
                 atomically.  ``budget_rows`` caps residency per level;
                 cold shards are evicted (heat/LRU) and misses rebuild
                 exactly the missing rows through the delta engine
                 (``RecomputeOnMiss``), bitwise-equal to a never-evicted
                 store.

  ``mutations``  Edge/node mutation log + a CSR splice that touches only
                 the affected rows.

  ``delta``      Incremental re-inference: edge churn re-samples the
                 affected layer-graph rows (content-addressed, so
                 batching never changes the bits), the forward frontier
                 comes from reversed fanout matrices, and only those rows
                 re-run through the bound executor (``core.ops``: "ref"
                 or "cuda", whose kernels then run on row subsets) —
                 bitwise-identical to a full epoch through the same
                 executor.

  ``engine``     Continuous-batching lookup engine: B slots, one fused
                 sharded gather per step, and a staleness bound on
                 pending mutations that triggers a delta refresh, inline
                 or one row chunk a step.

  ``qos``        Multi-tenant scheduling: per-tenant priority, slot
                 quota, token-bucket rate and staleness SLO, with
                 deadline-driven refresh planning and lagged per-tenant
                 epoch views.

Dataflow:  queries ->  engine.step -> store.lookup (front buffer)
           mutations -> MutationLog -> [staleness bound trips]
                     -> apply_edge_mutations -> resample_rows
                     -> forward_frontier -> row-subset re-inference
                     -> store.commit (buffer swap, version += 1)

Node additions onboard incrementally on stores built with
``onboarding="tail"``; ``engine.full_epoch()`` folds tails back in.
The entry point is ``api.Session.serve()``.
"""
from repro_torch.gnnserve.delta import (DeltaReinference, RecomputeOnMiss,
                                        RefreshJob, attach_recompute,
                                        build_reverse_index,
                                        forward_frontier, resample_rows,
                                        splice_reverse_index)
from repro_torch.gnnserve.engine import EmbeddingServeEngine, Query
from repro_torch.gnnserve.mutations import (MutationBatch, MutationLog,
                                            apply_edge_mutations,
                                            grow_graph)
from repro_torch.gnnserve.qos import (QoSScheduler, TenantRegistry,
                                      TenantSpec, parse_tenants)
from repro_torch.gnnserve.store import (EmbeddingStore, EvictedRowMiss,
                                        SnapshotMiss, StoreSnapshot,
                                        store_from_inference)

__all__ = ["DeltaReinference", "RecomputeOnMiss", "RefreshJob",
           "attach_recompute",
           "build_reverse_index", "forward_frontier",
           "resample_rows", "splice_reverse_index",
           "EmbeddingServeEngine", "Query",
           "MutationBatch", "MutationLog", "apply_edge_mutations",
           "grow_graph",
           "QoSScheduler", "TenantRegistry", "TenantSpec", "parse_tenants",
           "EmbeddingStore", "EvictedRowMiss", "SnapshotMiss",
           "StoreSnapshot", "store_from_inference"]
