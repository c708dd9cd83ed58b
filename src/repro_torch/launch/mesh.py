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

A mesh has the JAX mesh's two attributes that the sharding rules
(``sharding.specs``) and the dry-run read: ``axis_names``, ``("data",
"model")``, and ``shape``, {axis: size}.  ``make_production_mesh`` gives
the JAX package's two production meshes, 16 x 16 and 2 x 16 x 16, as
an ``AbstractMesh``: those two attributes and no devices, so the rules
take either kind.  ``make_meta_mesh`` turns one into a ``Mesh`` whose
every shard is the meta device, with the production mesh's axis names
and sizes (``("pod", "data", "model")`` too: P is then the product of
the axes before ``model``, shard (p, m) the flat index p M + m): the
placement and the placed steps run on it without storage, and the
dry-run counts their messages there.  ``repro.sharding.compat`` has no
counterpart: it only bridges JAX versions, and its ``make_mesh`` is this
module's ``make_host_mesh`` and ``make_production_mesh``.

Shard (0, 0)'s device is the mesh's *home*: it holds the embedding
output, the logits and the work of the model's paths that is not split
over the mesh.  ``sharding.placement`` places params, optimizer state and
caches on a mesh by the sharding rules, one block a shard on the shard's
own device; the transformer's mesh paths (``models.moe._moe_block_ep``,
``models.attention.cp_decode_attention``), its decode and prefill on
placed params and ``launch.train.run(mesh=)`` then run across the cards,
and every copy between shards goes through ``core.primitives.Exchange``,
its bytes counted in ``Mesh.sent`` by kind and in ``Mesh.links`` by
kind, sending and receiving shard.  The same code runs with every
shard on one card.  ``check_mesh`` refuses an abstract mesh outside a
trace on the meta device (the production meshes need 256 or 512
devices), and unplaced tensors that are not on the mesh's home.
"""
from __future__ import annotations

import collections
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch

AXES = ("data", "model")


class Mesh:
    """P x M shards; shard (p, m) lives on ``devices[p * M + m]``.
    ``axes`` ({axis: size}, ``model`` last and of size M, the others'
    product P) names the axes; by default ``{"data": P, "model": M}``."""

    def __init__(self, P: int, M: int, devices: List[torch.device],
                 axes: Optional[Dict[str, int]] = None):
        if P < 1 or M < 1 or len(devices) != P * M:
            raise ValueError(f"a {P} x {M} mesh needs {P * M} devices, "
                             f"got {len(devices)}")
        axes = dict(axes or zip(AXES, (P, M)))
        if (list(axes)[-1] != "model" or axes["model"] != M
                or math.prod(axes.values()) != P * M):
            raise ValueError(f"axes {axes} do not make a {P} x {M} mesh "
                             "with 'model' last")
        self.P, self.M = P, M
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape = axes
        self.devices = [torch.device(d) for d in devices]
        self._copy_streams: Dict[torch.device, object] = {}
        # bytes copied between shards, by kind ("params", "tokens", ...)
        self.sent: collections.Counter = collections.Counter()
        # the same bytes by (kind, sending shard, receiving shard), and
        # the rounds of messages (one ``Exchange`` each) by kind
        self.links: collections.Counter = collections.Counter()
        self.rounds: collections.Counter = collections.Counter()
        self.base = 0       # shard 0's index in the mesh a row is of

    @property
    def size(self) -> int:
        return self.P * self.M

    @property
    def is_cuda(self) -> bool:
        return self.devices[0].type == "cuda"

    @property
    def is_meta(self) -> bool:
        return self.devices[0].type == "meta"

    def count(self, kind: str, frm: Optional[int], to: Optional[int],
              nbytes: int) -> None:
        """Add one message's bytes to ``links`` (shards in this mesh's
        order; a row's are counted in its parent's)."""
        self.links[(kind, None if frm is None else self.base + frm,
                    None if to is None else self.base + to)] += nbytes

    def received(self, before=None) -> Dict[str, Dict[int, int]]:
        """{kind: {receiving shard: bytes}} of ``links`` (since the
        ``links`` snapshot ``before``); host memory is left out."""
        out: Dict[str, Dict[int, int]] = {}
        for (kind, frm, to), n in self.links.items():
            n -= (before or {}).get((kind, frm, to), 0)
            if n and to is not None:
                d = out.setdefault(kind, {})
                d[to] = d.get(to, 0) + n
        return out

    @functools.cached_property
    def shard_coords(self) -> List[Dict[str, int]]:
        """``sharding.placement.mesh_coords`` of every shard, in shard
        order."""
        from repro_torch.sharding.placement import mesh_coords
        return [mesh_coords(self, i) for i in range(self.size)]

    def device(self, p: int, m: int) -> torch.device:
        return self.devices[p * self.M + m]

    @property
    def home(self) -> torch.device:
        """Shard (0, 0)'s device."""
        return self.devices[0]

    def row(self, p: int) -> "Mesh":
        """Data shard p's 1 x M shards, sharing this mesh's copy streams
        and byte counts."""
        sub = Mesh(1, self.M, self.devices[p * self.M:(p + 1) * self.M])
        sub._copy_streams, sub.sent = self._copy_streams, self.sent
        sub.links, sub.rounds = self.links, self.rounds
        sub.base = self.base + p * self.M
        return sub

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
        return (f"Mesh({' x '.join(str(n) for n in self.shape.values())} "
                f"on {', '.join(str(d) for d in self.distinct_devices())})")


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


class AbstractMesh:
    """A mesh's axis names and sizes, and no devices: what the sharding
    rules and the dry-run read of a mesh the port cannot build."""

    devices = None

    def __init__(self, shape: Dict[str, int]):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return ("AbstractMesh("
                + " x ".join(f"{a}={n}" for a, n in self.shape.items())
                + ")")


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The JAX package's production meshes: 16 x 16 ``("data",
    "model")``, or 2 x 16 x 16 ``("pod", "data", "model")``."""
    if multi_pod:
        return AbstractMesh({"pod": 2, "data": 16, "model": 16})
    return AbstractMesh({"data": 16, "model": 16})


def make_meta_mesh(mesh) -> Mesh:
    """A ``Mesh`` with ``mesh``'s axis names and sizes (an
    ``AbstractMesh``, a ``Mesh`` or a {axis: size} dict; ``model``
    last) whose every shard is the meta device: placement and the
    placed steps run there without storage, and ``links`` counts their
    messages (the dry-run on the production meshes)."""
    shape = dict(getattr(mesh, "shape", mesh))
    M = shape["model"]
    n = math.prod(shape.values())
    return Mesh(n // M, M, [torch.device("meta")] * n, axes=shape)


def check_mesh(mesh, device) -> None:
    """Raise unless unplaced tensors on ``device`` may run on ``mesh``: a
    ``Mesh`` whose home is ``device`` (the meta device for a
    ``make_meta_mesh`` mesh), or an ``AbstractMesh`` in a trace
    on the meta device (the dry-run).  An abstract mesh outside such a
    trace raises ``NotImplementedError``: it names devices the port does
    not have."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if mesh.devices is None:
        if device.type != "meta":
            raise NotImplementedError(
                f"{mesh!r} needs {mesh.size} devices and holds none: it "
                "runs only as a trace on the meta device")
        return
    if mesh.home != device:
        raise ValueError(f"{mesh!r} has its home on {mesh.home}, the "
                         f"tensors are on {device}")
