"""Multi-process serving tier: shard workers + an RPC front-door router
over the store's 1-D partitioning — the port's twin of
``repro.gnnserve.cluster``.

- ``protocol``   — length-prefixed JSON/binary framing (stdlib sockets),
  byte for byte the JAX package's frames
- ``worker``     — ShardWorker: a full-world ``repro_torch`` process on
  the deployment's device, with WAL + replay
- ``router``     — scatter/gather routing, sequenced commits, stat
  merging, aggregated HTTP endpoint
- ``deployment`` — spawn/readiness/heartbeat-wedge lifecycle and the
  drive-compatible ``ClusterEngine`` facade

``api.Session.serve()`` launches a deployment when ``cluster.n_shards >
0``; README, "The cluster tier", shows it on the CPU and on the card.
"""
from repro_torch.gnnserve.cluster.deployment import (ClusterDeployment,
                                                     ClusterEngine,
                                                     WorkerWedged)
from repro_torch.gnnserve.cluster.protocol import (Channel, ProtocolError,
                                                   WorkerError,
                                                   WorkerTimeout, recv_msg,
                                                   send_msg)
from repro_torch.gnnserve.cluster.router import (Router, RouterEndpoint,
                                                 merge_attribution,
                                                 merge_engine_stats,
                                                 merge_health,
                                                 merge_session_stats)
from repro_torch.gnnserve.cluster.worker import Heartbeat, WorkerCore

__all__ = ["Channel", "ClusterDeployment", "ClusterEngine", "Heartbeat",
           "ProtocolError", "Router", "RouterEndpoint", "WorkerCore",
           "WorkerError", "WorkerTimeout", "WorkerWedged",
           "merge_attribution", "merge_engine_stats", "merge_health",
           "merge_session_stats", "recv_msg", "send_msg"]
