"""Tensors placed on a mesh by the sharding rules — the port's counterpart
of ``jax.device_put(x, NamedSharding(mesh, PartitionSpec(*spec)))``.

A ``Placed`` tensor holds one block per shard of a ``launch.mesh.Mesh``:
shard i (= p M + m) holds the slice ``ranges[i]`` of the global tensor
that its spec gives that shard, on ``mesh.devices[i]``, in storage of its
own.  A dimension whose spec entry is None stays whole, so a replicated
leaf has a full copy on every shard, as JAX's replicas occupy every
device.  A spec entry that names several axes (``("pod", "data")``)
splits its dimension over their product, the first axis the major one,
as JAX orders it.  ``block_ranges`` gives the ranges of every shard for
any mesh with ``axis_names`` and ``shape``, the abstract production
meshes included.

  place(t, spec, mesh)                  the blocks of ``t``, copied out
  place_blocks(shape, dtype, spec, mesh, make)
                                        blocks made on their devices
                                        (caches too large for one card)
  place_tree(tree, specs, mesh)         params modules (``place_module``),
                                        dicts and NamedTuples (OptState,
                                        caches, SSMCache) of tensors
  gather(x, dest) / gather_slab(x, fixed, dest)
                                        the whole tensor, or the part
                                        that the shards at the mesh
                                        coordinates ``fixed`` hold, on
                                        shard (or device) ``dest``
  scatter(x, full)                      write every block from ``full``
  move(mesh, kind, t, to, frm)          a copy of ``t`` on shard ``to``
  shard_bytes(tree)                     the bytes each shard holds

Every copy between shards goes through ``core.primitives.Exchange`` (its
stream protocol, with no host sync; only the streams of the copies'
senders and receivers are ordered), and its bytes are added to
``mesh.sent[kind]``: "place" for placement, "params" for params
gathered to the card that computes with them, "grads" for the gradients'
reduction, and the kinds the model's mesh paths name for their
activations ("tokens", "partials", "softmax", "entries", "replicas").
Each message also names its sending and receiving shard (``frm``,
``to``: indices in the mesh's shard order, None for host memory), and
``mesh.links[(kind, frm, to)]`` adds its bytes: the callers know the
shards, where a device would not tell them apart (every shard of a
one-card or a meta mesh shares one).  A gather whose receiving shard
holds a block that covers the part asked for returns that block itself
and copies nothing.

A message's buffers may be given as ``View``s, made only where the copy
is made: on a meta mesh (``launch.mesh.make_meta_mesh``, the dry-run's
production meshes) ``send`` counts each message from its shape and
copies nothing, so placement and the placed steps run there without
storage and without one aten op a message.

A placed params module (``place_module``) keeps the module's structure
and class with a ``Placed`` in each parameter's slot; ``materialize``
gives the module with them gathered, its copies made together
(``batched``).  The model code gathers the layer it is about to run
onto the card that runs it (FSDP-style) and drops it after.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import copy
import math
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, \
    Sequence, Tuple

import torch
from torch import nn

Range = Tuple[Tuple[int, int], ...]


class View(NamedTuple):
    """``base[index]``, viewed as ``shape`` where given: a message's
    buffer, made only where its copy is made."""
    base: torch.Tensor
    index: tuple
    shape: Optional[Tuple[int, ...]] = None


def _resolve(x) -> torch.Tensor:
    if not isinstance(x, View):
        return x
    t = x.base[x.index]
    return t if x.shape is None else t.view(x.shape)


def _device(x) -> torch.device:
    return (x.base if isinstance(x, View) else x).device


def _msg_bytes(x) -> int:
    """The bytes of a tensor or a ``View`` (from the shapes alone)."""
    if not isinstance(x, View):
        return x.numel() * x.element_size()
    n = 1
    for d, dim in enumerate(x.base.shape):
        if d >= len(x.index):
            n *= dim
        elif isinstance(x.index[d], slice):
            n *= len(range(*x.index[d].indices(dim)))
    return n * x.base.element_size()


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_coords(mesh, i: int) -> Dict[str, int]:
    """{axis: index} of the mesh's i-th device (row-major over
    ``axis_names``, as JAX's ``mesh.devices.flat``)."""
    out = {}
    for a in reversed(mesh.axis_names):
        out[a] = i % mesh.shape[a]
        i //= mesh.shape[a]
    return out


def block_ranges(shape: Sequence[int], spec, mesh) -> List[Range]:
    """((start, stop) per dimension) of every device of ``mesh``, in its
    device order: JAX's ``NamedSharding(mesh, P(*spec))
    .devices_indices_map(shape)``."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not fit shape {tuple(shape)}")
    size = math.prod(mesh.shape.values())
    out = []
    for i in range(size):
        c = mesh_coords(mesh, i)
        rng = []
        for dim, entry in zip(shape, spec):
            axes = _axes(entry)
            n = math.prod(mesh.shape[a] for a in axes)
            if dim % n:
                raise ValueError(f"dimension {dim} does not split over "
                                 f"{axes} ({n} ways)")
            k = 0
            for a in axes:                  # the first axis is the major
                k = k * mesh.shape[a] + c[a]
            step = dim // n
            rng.append((k * step, (k + 1) * step))
        out.append(tuple(rng))
    return out


def _slices(rng: Range, origin: Optional[Sequence[int]] = None):
    origin = origin or (0,) * len(rng)
    return tuple(slice(a - o, b - o) for (a, b), o in zip(rng, origin))


# the copies ``send`` queues inside ``batched()``
_PENDING: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_pending_sends", default=None)


@contextlib.contextmanager
def batched():
    """Queue the messages that ``send`` is given inside, and make them at
    the end through one ``Exchange`` a (mesh, kind): a module's gathers
    become one round of events and waits, not one a tensor.  Nothing
    inside may read a tensor those copies fill."""
    if _PENDING.get() is not None:
        yield
        return
    pending: list = []
    token = _PENDING.set(pending)
    try:
        yield
    finally:
        _PENDING.reset(token)
    groups: Dict = {}
    for mesh, kind, msgs in pending:
        groups.setdefault((id(mesh), kind), (mesh, kind, []))[2].extend(
            msgs)
    for mesh, kind, msgs in groups.values():
        send(mesh, kind, msgs)


def send(mesh, kind: str, msgs) -> None:
    """Make each message (dst, src, frm, to) through one ``Exchange`` (dst
    the receiver's buffer, src on the sender's device, either a tensor
    or a ``View``; frm and to the sending and receiving shard) and count
    its bytes under ``kind``: in ``mesh.sent`` and ``mesh.links``.  A
    message with one end in host memory on a mesh of cards (placing a
    tensor from the host, gathering one to it) is a plain copy in stream
    order, not a message between shards.  On a meta mesh the messages
    are counted and nothing is copied."""
    from repro_torch.core.primitives import Exchange
    msgs = list(msgs)
    pending = _PENDING.get()
    if pending is not None:
        pending.append((mesh, kind, msgs))
        return
    if mesh.is_cuda:
        for d, s, _, _ in msgs:
            if "cpu" in (_device(d).type, _device(s).type):
                _resolve(d).copy_(_resolve(s))
        msgs = [m for m in msgs if "cpu" not in (_device(m[0]).type,
                                                _device(m[1]).type)]
    if not msgs:
        return
    mesh.rounds[kind] += 1
    if mesh.is_meta:
        for dst, _, frm, to in msgs:
            n = _msg_bytes(dst)
            mesh.sent[kind] += n
            mesh.count(kind, frm, to, n)
        return
    pairs = [(_resolve(d), _resolve(s)) for d, s, _, _ in msgs]
    ex = Exchange(mesh, [t.device for pair in pairs for t in pair])
    ex.begin()
    for (dst, src), (_, _, frm, to) in zip(pairs, msgs):
        ex.send(dst, src)
        mesh.count(kind, frm, to, dst.numel() * dst.element_size())
    ex.wait(ex.mark())
    mesh.sent[kind] += ex.bytes


def move(mesh, kind: str, src: torch.Tensor, to: int,
         frm: int) -> torch.Tensor:
    """A copy of ``src`` (on shard ``frm``) on shard ``to``'s device,
    through an ``Exchange`` (a real copy even on the same device: a
    message between two shards)."""
    dst = torch.empty(src.shape, dtype=src.dtype, device=mesh.devices[to])
    send(mesh, kind, [(dst, src, frm, to)])
    return dst


class Placed:
    """A tensor of ``shape`` placed on ``mesh`` by ``spec``: ``blocks[i]``
    is shard i's slice ``ranges[i]`` on ``mesh.devices[i]``."""

    def __init__(self, mesh, spec, shape, dtype, blocks: List[torch.Tensor],
                 ranges: Optional[List[Range]] = None):
        self.mesh, self.spec = mesh, tuple(spec)
        self.shape, self.dtype = torch.Size(shape), dtype
        self.blocks = blocks
        self.ranges = ranges or block_ranges(self.shape, self.spec, mesh)

    def __getitem__(self, i) -> "Placed":
        """The slice at index ``i`` (an int, or a tuple of them) of
        leading dimensions that no axis splits (a layer of a stacked
        cache; llama4's ``[super-block, layer]``), as views of the
        blocks."""
        n = len(i) if isinstance(i, tuple) else 1
        if any(e is not None for e in self.spec[:n]):
            raise ValueError(f"index a split dimension of spec {self.spec}")
        return Placed(self.mesh, self.spec[n:], self.shape[n:], self.dtype,
                      [b[i] for b in self.blocks],
                      [r[n:] for r in self.ranges])

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self) -> str:
        return (f"Placed({tuple(self.shape)}, {self.dtype}, spec "
                f"{self.spec}, on {self.mesh!r})")


def place_blocks(shape, dtype, spec, mesh,
                 make: Callable[[int, Tuple[int, ...], torch.device],
                                torch.Tensor]) -> Placed:
    """A ``Placed`` whose block i is ``make(i, block shape, device)``: each
    block made on its own device (a cache drawn there from a generator
    seeded by the shard's index)."""
    ranges = block_ranges(shape, spec, mesh)
    blocks = []
    for i, (rng, dev) in enumerate(zip(ranges, mesh.devices)):
        bshape = tuple(b - a for a, b in rng)
        t = make(i, bshape, dev)
        if tuple(t.shape) != bshape or t.device != dev or t.dtype != dtype:
            raise ValueError(f"block {i}: made {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, wanted {bshape} {dtype} on "
                             f"{dev}")
        blocks.append(t)
    return Placed(mesh, spec, shape, dtype, blocks, ranges)


def place(t: torch.Tensor, spec, mesh, kind: str = "place") -> Placed:
    """``t``'s blocks, each copied into storage of its own on its shard's
    device (``jax.device_put`` with a ``NamedSharding``)."""
    t = t.detach()
    ranges = block_ranges(t.shape, spec, mesh)
    blocks = [torch.empty(tuple(b - a for a, b in rng), dtype=t.dtype,
                          device=dev)
              for rng, dev in zip(ranges, mesh.devices)]
    send(mesh, kind, [(b, View(t, _slices(rng)), None, i)
                      for i, (b, rng) in enumerate(zip(blocks, ranges))])
    return Placed(mesh, spec, t.shape, t.dtype, blocks, ranges)


def _shards_at(x: Placed, fixed: Dict[str, int]) -> List[int]:
    coords = x.mesh.shard_coords
    return [i for i in range(len(x.blocks))
            if all(coords[i][a] == v for a, v in fixed.items())]


def _receiver(mesh, dest):
    """(receiving shard, its device) of ``dest``: a shard index, or a
    device (its first shard on the mesh; None for one off the mesh, the
    host)."""
    if isinstance(dest, int):
        return dest, mesh.devices[dest]
    device = torch.device(dest)
    to = next((i for i, d in enumerate(mesh.devices) if d == device), None)
    return to, device


def gather_slab(x: Placed, fixed: Dict[str, int], dest,
                kind: str = "params") -> torch.Tensor:
    """The part of ``x`` that the shards at mesh coordinates ``fixed``
    ({axis: index}) hold, assembled on ``dest``: a shard index, or a
    device (received by its first shard on the mesh).  Over every other
    axis it is gathered.  ``fixed={}`` is the whole tensor.  If the
    receiving shard holds a block that covers it (off the mesh: a shard
    on that device), that block is returned and nothing copied."""
    to, device = _receiver(x.mesh, dest)
    shards = _shards_at(x, fixed)
    uniq: Dict[Range, List[int]] = {}
    for i in shards:
        uniq.setdefault(x.ranges[i], []).append(i)
    lo = [min(r[d][0] for r in uniq) for d in range(x.ndim)]
    hi = [max(r[d][1] for r in uniq) for d in range(x.ndim)]
    if len(uniq) == 1:
        if to is not None and to in shards:
            return x.blocks[to]
        for i in shards:
            if to is None and x.mesh.devices[i] == device:
                return x.blocks[i]
    out = torch.empty([b - a for a, b in zip(lo, hi)], dtype=x.dtype,
                      device=device)
    msgs = []
    for rng, idx in uniq.items():
        # the receiver's own block first, then a replica on its device
        near = ([i for i in idx if i == to]
                or [i for i in idx if x.mesh.devices[i] == device])
        frm = (near or idx)[0]
        msgs.append((View(out, _slices(rng, lo)), x.blocks[frm], frm, to))
    send(x.mesh, kind, msgs)
    return out


def gather(x, dest=None, kind: str = "params") -> torch.Tensor:
    """The whole tensor on ``dest`` (a shard index or a device; default:
    shard 0, the mesh's home); a plain tensor is returned as it is."""
    if not isinstance(x, Placed):
        return x
    return gather_slab(x, {}, 0 if dest is None else dest, kind)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` is ``b``'s storage at the same place and shape (a
    meta tensor has no address: only the object itself)."""
    return a is b or (a.device.type != "meta" and a.data_ptr() == b.data_ptr()
                      and a.shape == b.shape)


def scatter(x: Placed, full: torch.Tensor, kind: str = "replicas",
            frm: int = 0) -> None:
    """Write every block of ``x`` from the whole tensor ``full`` on shard
    ``frm`` (a block that is ``full``'s own storage is left as it is):
    replicas updated the same way."""
    send(x.mesh, kind, [(b, View(full, _slices(rng)), frm, i)
                        for i, (b, rng) in enumerate(zip(x.blocks, x.ranges))
                        if not _same(b, full)])


def write_rows(x: Placed, new: torch.Tensor, pos: Sequence[int],
               kind: str = "entries", frm: int = 0) -> None:
    """Write ``new`` (B, 1, ...) on shard ``frm`` into a (B, S, ...)
    placed cache at each row's position ``pos[b]`` (host ints, already
    clamped into [0, S)): into every block whose ranges hold (b,
    pos[b]), its slice of the trailing dimensions, in the cache's
    dtype."""
    msgs = []
    for i, (blk, rng) in enumerate(zip(x.blocks, x.ranges)):
        (b0, b1), (s0, s1), rest = rng[0], rng[1], rng[2:]
        for b in range(b0, b1):
            if s0 <= pos[b] < s1:
                msgs.append((View(blk, (b - b0, pos[b] - s0)),
                             View(new, (b, 0) + _slices(rest)), frm, i))
    send(x.mesh, kind, msgs)


# ----------------------------------------------------------------------
# trees
# ----------------------------------------------------------------------

def _clone(module: nn.Module, fn, prefix: str = "") -> nn.Module:
    """A copy of ``module``'s structure with each parameter ``t`` (full
    name ``n``) replaced by ``fn(n, t)``."""
    new = copy.copy(module)
    new._parameters = {k: None if v is None else fn(prefix + k, v)
                       for k, v in module._parameters.items()}
    new._modules = {k: None if c is None else _clone(c, fn, f"{prefix}{k}.")
                    for k, c in module._modules.items()}
    return new


def materialize(module: nn.Module, device=None,
                fn: Optional[Callable] = None) -> nn.Module:
    """``module`` with every ``Placed`` parameter gathered to ``device``
    (default the mesh's home), or replaced by ``fn(name, placed)`` where
    given; plain parameters stay as they are."""
    fn = fn or (lambda n, x: gather(x, device))
    with batched():
        return _clone(module, lambda n, x: fn(n, x) if isinstance(
            x, Placed) else x)


def has_placed(module: nn.Module) -> bool:
    """Whether ``module``'s (first) parameter is placed."""
    return isinstance(next(module.parameters(), None), Placed)


def place_module(module: nn.Module, specs: Dict[str, tuple], mesh,
                 kind: str = "place") -> nn.Module:
    """``module``'s structure with each parameter replaced by its
    ``Placed`` blocks by ``specs`` ({name: spec}: ``sharding.param_specs``):
    attribute reads give the ``Placed``, ``named_parameters()`` yields
    them, ``isinstance`` sees the module's own class."""
    return _clone(module, lambda n, t: place(t, specs[n], mesh, kind))


def place_tree(tree, specs, mesh, kind: str = "place"):
    """Place every leaf of ``tree`` by the spec at the same place in
    ``specs``: an ``nn.Module`` (with {name: spec}) as ``place_module``
    places it; dicts and NamedTuples keep their structure."""
    if isinstance(tree, nn.Module):
        return place_module(tree, specs, mesh, kind)
    if isinstance(tree, torch.Tensor):
        return place(tree, specs, mesh, kind)
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], mesh, kind)
                for k, v in tree.items()}
    return type(tree)(*(place_tree(v, s, mesh, kind)
                        for v, s in zip(tree, specs, strict=True)))


def gather_tree(tree, device=None):
    """The inverse of ``place_tree``: plain tensors on ``device`` (default
    the home), each storage of its own (never a block of the tree)."""
    if isinstance(tree, nn.Module):
        return materialize(tree, device, fn=lambda n, x: gather_tree(
            x, device))
    if isinstance(tree, Placed):
        out = gather(tree, 0 if device is None else device, kind="gather")
        return out.clone() if any(out is b for b in tree.blocks) else out
    if isinstance(tree, torch.Tensor):
        return tree if device is None else tree.to(device)
    if isinstance(tree, dict):
        return {k: gather_tree(v, device) for k, v in tree.items()}
    return type(tree)(*(gather_tree(v, device) for v in tree))


def _leaves(tree) -> Iterable[Placed]:
    if isinstance(tree, nn.Module):
        yield from (x for x in tree.parameters() if isinstance(x, Placed))
    elif isinstance(tree, Placed):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)


def shard_bytes(tree) -> List[int]:
    """The bytes each shard's blocks of ``tree``'s placed leaves hold, in
    the mesh's shard order (``sharding.per_chip_bytes`` for each)."""
    out: Optional[List[int]] = None
    for x in _leaves(tree):
        if out is None:
            out = [0] * len(x.blocks)
        for i, b in enumerate(x.blocks):
            out[i] += b.numel() * b.element_size()
    return out or []


def device_bytes(tree) -> Dict[torch.device, int]:
    """The bytes of ``tree``'s placed leaves on each device."""
    out: Dict[torch.device, int] = collections.Counter()
    for x in _leaves(tree):
        for b, dev in zip(x.blocks, x.mesh.devices):
            out[dev] += b.numel() * b.element_size()
    return dict(out)
