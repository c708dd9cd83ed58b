"""Sharding rules and the ambient mesh — the twin of ``repro.sharding``
(``specs``, ``context``; ``compat`` has no counterpart: see
``launch.mesh``)."""
from repro_torch.sharding.specs import (batch_specs, cache_specs,
                                        logical_axes, param_specs,
                                        per_chip_bytes, shard_if_divisible)

__all__ = ["batch_specs", "cache_specs", "logical_axes", "param_specs",
           "per_chip_bytes", "shard_if_divisible"]
