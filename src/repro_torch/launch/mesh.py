"""The (P x M) mesh of the distributed executor — the port's counterpart
of ``repro.launch.mesh.make_host_mesh`` (a ``("data", "model")`` mesh of
JAX devices).

The port's executor is single-controller, as the JAX one is: one process
holds every shard.  A ``Mesh`` is P graph partitions x M feature
partitions of shards, each a ``torch.device`` that holds its own
tensors.  Shards go round-robin over the visible cards, so on one card
all P x M shards share it (every message between them is still a copy
into the receiver's own buffer); on four cards a message between cards
is a peer copy.  On the CPU every shard is ``cpu``.
"""
from __future__ import annotations

from typing import Dict, List

import torch


class Mesh:
    """P x M shards; shard (p, m) lives on ``devices[p * M + m]``."""

    def __init__(self, P: int, M: int, devices: List[torch.device]):
        if P < 1 or M < 1 or len(devices) != P * M:
            raise ValueError(f"a {P} x {M} mesh needs {P * M} devices, "
                             f"got {len(devices)}")
        self.P, self.M = P, M
        self.devices = [torch.device(d) for d in devices]
        self._copy_streams: Dict[torch.device, object] = {}

    @property
    def is_cuda(self) -> bool:
        return self.devices[0].type == "cuda"

    def device(self, p: int, m: int) -> torch.device:
        return self.devices[p * self.M + m]

    def distinct_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices))

    def copy_stream(self, dev: torch.device):
        """The side stream that carries this device's messages (made on
        first use, kept for the mesh's life)."""
        s = self._copy_streams.get(dev)
        if s is None:
            s = torch.cuda.Stream(device=dev)
            self._copy_streams[dev] = s
        return s

    def __repr__(self) -> str:
        return (f"Mesh({self.P} x {self.M} on "
                f"{', '.join(str(d) for d in self.distinct_devices())})")


def make_host_mesh(n_data: int = 1, n_model: int = 1,
                   device="cuda") -> Mesh:
    """An ``n_data`` x ``n_model`` mesh.  ``device="cuda"`` (the default;
    raises without a card) places the shards round-robin over every
    visible card, ``"cuda:i"`` all on card i, ``"cpu"`` on the CPU (the
    tests)."""
    from repro_torch.core.ops import resolve_device
    dev = resolve_device(device)
    n = n_data * n_model
    if dev.type == "cuda" and dev.index is None:
        cards = torch.cuda.device_count()
        devices = [torch.device("cuda", i % cards) for i in range(n)]
    else:
        devices = [dev] * n
    return Mesh(n_data, n_model, devices)
