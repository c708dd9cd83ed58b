"""DEAL's distributed GNN primitives (§3.4) on a single-controller mesh,
plus the paper's baselines (CAGNET-style GEMM, graph-exchange SPMM,
SDDMM approach (i), monolithic all-gather SPMM) — the port's counterpart
of ``repro.core.primitives``.

The JAX package runs each shard's body under ``shard_map`` on its own
device of a ``("data", "model")`` mesh, with ``jax.lax`` collectives.
Here one process holds the P x M shards of a ``launch.mesh.Mesh`` and
the collectives are explicit copies between them: the ring ``ppermute``
of requested rows (SPMM, SDDMM), the tiled all-to-alls (GEMM),
``psum`` / ``psum_scatter`` and ``all_gather``.  Every message is a real
copy into the receiver's own buffer, even when both shards sit on one
card, and its bytes are counted (``Exchange.bytes``).  On CUDA the
messages run on each device's copy stream (``Mesh.copy_stream``),
ordered against the compute streams by events, with no host sync.

Each shard's compute goes through the port's kernels (``kernels="cuda"``)
or their plain versions (``"ref"``).  Aggregation never scatters: a
shard's [local rows; ring buffer 1; ...; P-1] concatenation is indexed
by a per-slot position table (``RingLayout``) and summed by ``spmm``,
which adds a row's slots in order with no atomics.  Grouped mode (§3.5,
Fig 11) launches one spmm per ring group, masked to that group's slots,
and adds the partials in group order, local group first; ring stage
k+1's copies are issued before group k's kernel, so they overlap it.
Monolithic mode issues every copy first, then one launch.  An edge's
group is fixed by the owners of its ends, so a full plan and a row-subset
plan sum a row in the same order: a delta refresh through the mesh is
bitwise a full epoch through it.  GEMM runs through ``core.ops.gemm_rows``
(fixed row count a call), so a row's GEMM bits do not depend on the
shard's row count either.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.launch.mesh import Mesh

KERNELS = ("cuda", "ref")
GEMM_VARIANTS = ("deal", "deal_ring", "cagnet")
SPMM_VARIANTS = ("deal", "graph_exchange", "allgather")
SDDMM_VARIANTS = ("deal", "dup")


def spmm_fn(kernels: str) -> Callable:
    """The per-shard aggregation: the kernel's wrapper ("cuda") or its
    plain version ("ref"), named as the executors are."""
    return kops.spmm if kernels == "cuda" else ref.spmm_ref


def sddmm_fn(kernels: str) -> Callable:
    return kops.sddmm if kernels == "cuda" else ref.sddmm_ref


# ----------------------------------------------------------------------
# sharded values
# ----------------------------------------------------------------------

class Sharded:
    """A global 2-D value split over a mesh: ``blocks[p][m]`` lives on
    ``mesh.device(p, m)``.  Rows split P ways (partition p holds rows
    [p * n_loc, (p + 1) * n_loc)); columns split M ways when
    ``split_cols`` (features, JAX's ``P("data", "model")``), else each
    of a partition's M shards holds the full width (edge weights and
    scores, ``P("data", None)``).

    ``a + b`` adds blockwise, and torch functions of one or more
    ``Sharded`` of the same split map blockwise (``__torch_function__``):
    this is how ``run_model``'s activation and the ``add`` op run on a
    mesh without gathering.  Only elementwise functions belong there."""

    def __init__(self, mesh: Mesh, blocks, split_cols: bool = True):
        self.mesh = mesh
        self.blocks = blocks
        self.split_cols = split_cols

    @property
    def shape(self):
        rows = sum(self.blocks[p][0].shape[0] for p in range(self.mesh.P))
        cols = (sum(b.shape[1] for b in self.blocks[0]) if self.split_cols
                else self.blocks[0][0].shape[1])
        return torch.Size((rows, cols))

    @property
    def dtype(self):
        return self.blocks[0][0].dtype

    def map(self, fn) -> "Sharded":
        return Sharded(self.mesh, [[fn(b) for b in row] for row in
                                   self.blocks], self.split_cols)

    def __add__(self, other: "Sharded") -> "Sharded":
        return Sharded(self.mesh, [[a + b for a, b in zip(ra, rb)]
                                   for ra, rb in zip(self.blocks,
                                                     other.blocks)],
                       self.split_cols)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        first = next(a for a in args if isinstance(a, Sharded))

        def block(p, m):
            return func(*[a.blocks[p][m] if isinstance(a, Sharded) else a
                          for a in args], **kwargs)
        return Sharded(first.mesh, [[block(p, m) for m in range(
            first.mesh.M)] for p in range(first.mesh.P)], first.split_cols)

    def synchronize(self) -> None:
        for dev in self.mesh.distinct_devices():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def to_global(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: shard (0, 0)'s)."""
        dev = torch.device(device) if device is not None else \
            self.mesh.devices[0]
        rows = []
        for row in self.blocks:
            parts = row if self.split_cols else row[:1]
            rows.append(torch.cat([b.to(dev) for b in parts], dim=1))
        return torch.cat(rows, dim=0)


def shard_rows(mesh: Mesh, x, split_cols: bool = True) -> Sharded:
    """Place a global (N, D) array (numpy or tensor) on the mesh: N must
    split P ways and, for ``split_cols``, D M ways.  Blocks that would be
    identical on one device (a replicated value's M shards there) are one
    tensor, read only."""
    P, M = mesh.P, mesh.M
    N, D = x.shape[0], x.shape[1]
    if N % P or (split_cols and D % M):
        raise ValueError(f"a ({N}, {D}) value does not split over a "
                         f"{P} x {M} mesh")
    n, d = N // P, (D // M if split_cols else D)
    blocks = []
    for p in range(P):
        row, seen = [], {}
        for m in range(M):
            dev = mesh.device(p, m)
            cols = slice(m * d, (m + 1) * d) if split_cols else slice(None)
            if not split_cols and dev in seen:
                row.append(seen[dev])
                continue
            part = x[p * n:(p + 1) * n, cols]
            if isinstance(part, np.ndarray):
                t = torch.from_numpy(np.ascontiguousarray(part)).to(dev)
            else:
                t = part.to(dev).contiguous()
            seen[dev] = t
            row.append(t)
        blocks.append(row)
    return Sharded(mesh, blocks, split_cols)


# ----------------------------------------------------------------------
# messages
# ----------------------------------------------------------------------

class Exchange:
    """The messages of one collective, and their bytes.

    Protocol: allocate every receive buffer on the compute streams, then
    ``begin()`` (each copy stream waits for its device's compute stream),
    ``send`` the messages, ``mark()`` after a stage and ``wait(mark)``
    before its consumer (each compute stream waits for its copy stream).
    Every message is packed on its sender's copy stream and copied into
    the receiver's buffer there; on the CPU everything runs in order.
    ``devices`` (default: every device of the mesh) are the devices whose
    streams the exchange orders: the senders and receivers of its
    messages, so that the others' queues are left alone."""

    def __init__(self, mesh: Mesh, devices=None):
        self.mesh = mesh
        self.bytes = 0
        self.devices = (mesh.distinct_devices() if devices is None
                        else list(dict.fromkeys(devices)))

    def begin(self) -> None:
        if self.mesh.is_cuda:
            for dev in self.devices:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                self.mesh.copy_stream(dev).wait_event(ev)

    def send(self, dst: torch.Tensor, src: torch.Tensor,
             idx: Optional[torch.Tensor] = None) -> None:
        """dst (a contiguous view of the receiver's buffer) <- src[idx]
        (or src), src on the sender's device."""
        self.bytes += dst.numel() * dst.element_size()
        if not self.mesh.is_cuda:
            dst.copy_(src if idx is None else src.index_select(0, idx))
            return
        with torch.cuda.stream(self.mesh.copy_stream(src.device)), \
                torch.cuda.stream(self.mesh.copy_stream(dst.device)):
            part = (src if idx is None else src.index_select(0, idx))
            dst.copy_(part.contiguous(), non_blocking=True)

    def mark(self) -> Dict[torch.device, object]:
        if not self.mesh.is_cuda:
            return {}
        marks = {}
        for dev in self.devices:
            ev = torch.cuda.Event()
            ev.record(self.mesh.copy_stream(dev))
            marks[dev] = ev
        return marks

    def wait(self, marks) -> None:
        for dev, ev in marks.items():
            torch.cuda.current_stream(dev).wait_event(ev)

    def fence(self) -> None:
        self.wait(self.mark())


def _grid(mesh: Mesh, fn) -> List[list]:
    return [[fn(p, m) for m in range(mesh.M)] for p in range(mesh.P)]


def _empty(mesh: Mesh, p: int, m: int, shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=mesh.device(p, m))


# ----------------------------------------------------------------------
# receive layouts
# ----------------------------------------------------------------------

@dataclasses.dataclass
class RingLayout:
    """Partition p's receive layout for one layer (the same on each of
    its M column shards).  Its buffer is [the u_loc local source rows;
    stage 1's counts[1] rows; ...; stage P-1's], stage k's rows coming
    from partition (p + k) % P, which packs its local rows ``src[k]``.
    ``pos[i, f]`` is slot f of output row i's row in that buffer,
    ``grp[i, f]`` its ring group (-1 on a dead slot).  ``pad_rows`` is
    what the JAX package's static shapes ship for the same exchange."""
    u_loc: int
    counts: List[int]
    src: List[np.ndarray]
    pos: np.ndarray
    grp: np.ndarray
    pad_rows: int

    def __post_init__(self):
        self._dev: Dict = {}
        self._idx: Dict = {}

    @property
    def offsets(self) -> List[int]:
        out, off = [0], self.u_loc
        for c in self.counts[1:]:
            out.append(off)
            off += c
        return out

    @property
    def n_recv(self) -> int:
        return int(sum(self.counts[1:]))

    def on(self, dev):
        """(pos, per-group masks, live mask) as tensors on ``dev``."""
        got = self._dev.get(dev)
        if got is None:
            grp = torch.from_numpy(self.grp).to(dev)
            got = (torch.from_numpy(self.pos).to(dev),
                   [grp == k for k in range(len(self.counts))], grp >= 0)
            self._dev[dev] = got
        return got

    def src_idx(self, k: int, dev) -> torch.Tensor:
        key = (k, dev)
        t = self._idx.get(key)
        if t is None:
            t = torch.from_numpy(self.src[k]).to(dev)
            self._idx[key] = t
        return t


def ring_layouts(plan, r_loc: int, u_loc: int, fanout: int,
                 mirror_src: Optional[np.ndarray] = None
                 ) -> List[RingLayout]:
    """Each partition's ``RingLayout`` from a ``partition.LayerPlan`` or
    ``SubsetPlan`` (their send_local / edge_* arrays).  With
    ``mirror_src`` the layout is the graph-exchange baseline's: stage k
    ships one row per edge (duplicates included) in plan order."""
    P = plan.send_local.shape[0]
    out = []
    for p in range(P):
        pos = np.zeros((r_loc, fanout), np.int32)
        grp = np.full((r_loc, fanout), -1, np.int8)
        counts, src, off = [0], [np.empty(0, np.int64)], u_loc
        for k in range(P):
            live = plan.edge_mask[p, k]
            d = plan.edge_dst[p, k][live]
            s = plan.edge_slot[p, k][live]
            e = plan.edge_pos[p, k][live]
            grp[d, s] = k
            if k == 0:
                pos[d, s] = e              # local rows, read in place
                continue
            sender = (p + k) % P
            if mirror_src is None:
                c = int(e.max()) + 1 if e.size else 0
                rows = plan.send_local[sender, k, :c]
                pos[d, s] = off + e
            else:
                c = int(d.size)
                rows = mirror_src[sender, k, :c]
                pos[d, s] = off + np.arange(c, dtype=np.int32)
            counts.append(c)
            src.append(rows.astype(np.int64))
            off += c
        width = (plan.edge_dst.shape[-1] if mirror_src is not None
                 else plan.send_local.shape[-1])
        out.append(RingLayout(u_loc=u_loc, counts=counts, src=src, pos=pos,
                              grp=grp, pad_rows=(P - 1) * width))
    return out


def gather_layouts(nbr_local: np.ndarray, mask_local: np.ndarray
                   ) -> List[RingLayout]:
    """The all-gather baseline's layouts: positions are global ids into
    the gathered (N, d) tile, one group."""
    return [RingLayout(u_loc=0, counts=[0], src=[np.empty(0, np.int64)],
                       pos=np.ascontiguousarray(nbr, np.int32),
                       grp=np.where(mask, 0, -1).astype(np.int8),
                       pad_rows=0)
            for nbr, mask in zip(nbr_local, mask_local)]


# ----------------------------------------------------------------------
# the ring (SPMM, SDDMM)
# ----------------------------------------------------------------------

def ring(H: Sharded, layouts: List[RingLayout], xch: Exchange,
         grouped: bool, launch: Callable) -> List[list]:
    """Run the ring exchange of H's rows and ``launch(p, m, buf, mask,
    pos)`` over each shard's buffer: per group in grouped mode (partials
    added in group order), once over the live mask in monolithic mode.
    Returns the per-shard results."""
    mesh = H.mesh
    P = mesh.P
    # the layouts' index tensors reach the devices on the compute
    # streams, before begin(): the copy streams then see them complete
    for p in range(P):
        for m in range(mesh.M):
            layouts[p].on(mesh.device(p, m))
            for k in range(1, P):
                if layouts[p].counts[k]:
                    layouts[p].src_idx(k, mesh.device((p + k) % P, m))

    def buffer(p, m):
        h, lay = H.blocks[p][m], layouts[p]
        if lay.n_recv == 0:
            return h
        buf = _empty(mesh, p, m, (lay.u_loc + lay.n_recv, h.shape[1]),
                     h.dtype)
        buf[:lay.u_loc].copy_(h)
        # the plain versions read every slot (times 0.0 off the group):
        # regions not received yet must hold finite values
        buf[lay.u_loc:].zero_()
        return buf
    bufs = _grid(mesh, buffer)
    xch.begin()

    def issue(k):
        for p in range(P):
            lay = layouts[p]
            c, off = lay.counts[k], lay.offsets[k]
            if not c:
                continue
            q = (p + k) % P
            for m in range(mesh.M):
                src = H.blocks[q][m]
                xch.send(bufs[p][m][off:off + c], src,
                         lay.src_idx(k, src.device))
        return xch.mark()

    out = [[None] * mesh.M for _ in range(P)]
    if not grouped:
        for k in range(1, P):
            issue(k)
        xch.fence()
        for p in range(P):
            for m in range(mesh.M):
                pos, _, live = layouts[p].on(mesh.device(p, m))
                out[p][m] = launch(p, m, bufs[p][m], live, pos)
        return out
    marks = {}
    for k in range(P):
        if k + 1 < P:
            marks[k + 1] = issue(k + 1)     # in flight during group k
        if k:
            xch.wait(marks[k])
        for p in range(P):
            if k and not layouts[p].counts[k]:
                continue                    # no slot of p in this group
            for m in range(mesh.M):
                pos, masks, _ = layouts[p].on(mesh.device(p, m))
                part = launch(p, m, bufs[p][m], masks[k], pos)
                out[p][m] = part if out[p][m] is None else out[p][m] + part
    return out


def spmm_ring(H: Sharded, w: Sharded, layouts: List[RingLayout],
              xch: Exchange, grouped: bool, kernels: str) -> Sharded:
    """DEAL SPMM (unique-row ring) or, with graph-exchange layouts, the
    'exchange G0' baseline: each shard aggregates its buffer through
    ``spmm``.  w is row-sharded, replicated over the model axis."""
    fn = spmm_fn(kernels)

    def launch(p, m, buf, mask, pos):
        return fn(buf, w.blocks[p][m], pos, mask)
    return Sharded(H.mesh, ring(H, layouts, xch, grouped, launch))


def spmm_allgather(H: Sharded, w: Sharded, layouts: List[RingLayout],
                   xch: Exchange, kernels: str) -> Sharded:
    """Graph-partition-only baseline (Fig 3b): every shard all-gathers
    its feature column over the data axis, then aggregates by global id
    (the memory blowup DEAL avoids)."""
    mesh, P = H.mesh, H.mesh.P
    n = [H.blocks[p][0].shape[0] for p in range(P)]
    starts = np.concatenate([[0], np.cumsum(n)])

    def full(p, m):
        return _empty(mesh, p, m, (int(starts[-1]), H.blocks[p][m].shape[1]),
                      H.dtype)
    fulls = _grid(mesh, full)
    for p in range(P):
        for m in range(mesh.M):
            fulls[p][m][starts[p]:starts[p + 1]].copy_(H.blocks[p][m])
    xch.begin()
    for p in range(P):
        for m in range(mesh.M):
            for q in range(P):
                if q != p:
                    xch.send(fulls[p][m][starts[q]:starts[q + 1]],
                             H.blocks[q][m])
    xch.fence()
    fn = spmm_fn(kernels)

    def agg(p, m):
        pos, _, live = layouts[p].on(mesh.device(p, m))
        return fn(fulls[p][m], w.blocks[p][m], pos, live)
    return Sharded(mesh, _grid(mesh, agg))


def sddmm_ring(q: Sharded, k: Sharded, layouts: List[RingLayout],
               xch: Exchange, grouped: bool, kernels: str,
               variant: str = "deal") -> Sharded:
    """Edge scores e[i, f] = <q[i], k[nbr[i, f]]> on every live slot,
    row-sharded (each column shard holds the full (r_loc, F) scores).

    "deal", approach (ii): partial dots over each shard's D/M columns
    through ``sddmm`` (+0.0 on the slots of other groups, so the group
    sum is exact), then the edge scalars summed over the model axis in
    shard order (psum: results move, not features).  "dup", approach
    (i): all-gather the full columns over the model axis, then full
    dots; no result exchange."""
    mesh = q.mesh
    fn = sddmm_fn(kernels)
    if variant == "dup":
        q, k = all_gather_cols(q, xch), all_gather_cols(k, xch)

    def launch(p, m, buf, mask, pos):
        return fn(q.blocks[p][m], buf, pos, mask)
    parts = ring(k, layouts, xch, grouped, launch)
    if variant == "dup":
        return Sharded(mesh, parts, split_cols=False)
    return Sharded(mesh, psum_model(mesh, parts, xch), split_cols=False)


# ----------------------------------------------------------------------
# model-axis collectives (GEMM, SDDMM)
# ----------------------------------------------------------------------

def psum_model(mesh: Mesh, parts: List[list], xch: Exchange,
               cols: Optional[Callable] = None) -> List[list]:
    """Sum ``parts[p][m']`` over the model axis in shard order m' = 0,
    1, ... on every shard (p, m), so every shard gets the same bits.
    With ``cols(m)`` (a column slice) each shard receives and sums only
    its slice: ``psum_scatter``."""
    M = mesh.M

    def piece(t, m):
        return t if cols is None else t[:, cols(m)]

    def recv(p, m):
        return [None if j == m else _empty(mesh, p, m, piece(parts[p][j], m)
                                           .shape, parts[p][j].dtype)
                for j in range(M)]
    bufs = _grid(mesh, recv)
    xch.begin()
    for p in range(mesh.P):
        for m in range(M):
            for j in range(M):
                if j != m:
                    xch.send(bufs[p][m][j], piece(parts[p][j], m))
    xch.fence()

    def total(p, m):
        acc = None
        for j in range(M):
            t = piece(parts[p][m], m) if j == m else bufs[p][m][j]
            acc = t if acc is None else acc + t
        return acc
    return _grid(mesh, total)


def all_gather_cols(X: Sharded, xch: Exchange) -> Sharded:
    """Every shard (p, m) gets partition p's full-width rows (each
    column block from its own shard): the model-axis ``all_gather``."""
    mesh = X.mesh
    widths = [b.shape[1] for b in X.blocks[0]]
    starts = np.concatenate([[0], np.cumsum(widths)])

    def full(p, m):
        t = _empty(mesh, p, m, (X.blocks[p][m].shape[0], int(starts[-1])),
                   X.dtype)
        t[:, starts[m]:starts[m + 1]].copy_(X.blocks[p][m])
        return t
    fulls = _grid(mesh, full)
    parts = _grid(mesh, lambda p, m: [None if j == m else _empty(
        mesh, p, m, X.blocks[p][j].shape, X.dtype) for j in range(mesh.M)])
    xch.begin()
    for p in range(mesh.P):
        for m in range(mesh.M):
            for j in range(mesh.M):
                if j != m:
                    xch.send(parts[p][m][j], X.blocks[p][j])
    xch.fence()
    for p in range(mesh.P):
        for m in range(mesh.M):
            for j in range(mesh.M):
                if j != m:
                    fulls[p][m][:, starts[j]:starts[j + 1]].copy_(
                        parts[p][m][j])
    return Sharded(mesh, fulls, split_cols=False)


def _row_blocks(mesh: Mesh, H: Sharded) -> int:
    n = H.blocks[0][0].shape[0]
    if n % mesh.M:
        raise ValueError(f"{n} rows a partition do not split over "
                         f"{mesh.M} model shards")
    return n // mesh.M


def _all_to_all_back(mesh: Mesh, Y: List[list], xch: Exchange) -> Sharded:
    """Shard (p, m) holds rows block m of partition p at full output
    width; return the ("data", "model") layout: shard (p, m) gets every
    rows block's column block m, in row order (a tiled all_to_all)."""
    M = mesh.M
    d_out = Y[0][0].shape[1]
    if d_out % M:
        raise ValueError(f"output width {d_out} does not split over {M} "
                         "model shards")
    dc = d_out // M

    def recv(p, m):
        r = Y[p][m].shape[0]
        return _empty(mesh, p, m, (r * M, dc), Y[p][m].dtype)
    outs = _grid(mesh, recv)
    for p in range(mesh.P):
        for m in range(M):
            r = Y[p][m].shape[0]
            cols = slice(m * dc, (m + 1) * dc)
            outs[p][m][m * r:(m + 1) * r].copy_(Y[p][m][:, cols])
    xch.begin()
    for p in range(mesh.P):
        for m in range(M):
            for j in range(M):
                if j != m:
                    r = Y[p][j].shape[0]
                    xch.send(outs[p][m][j * r:(j + 1) * r],
                             Y[p][j][:, m * dc:(m + 1) * dc])
    xch.fence()
    return Sharded(mesh, outs)


def gemm(H: Sharded, W: torch.Tensor, xch: Exchange, variant: str,
         gemm_rows: Callable) -> Sharded:
    """H (n, D) on the ("data", "model") layout times the replicated W
    (D, D_out), in the same layout.

    "deal" (Fig 7b): a tiled all-to-all gives shard m full-width rows
    block m, one GEMM with W, and an all-to-all back: every row is one
    ``gemm_rows`` product, bitwise a single card's.  "deal_ring": the
    M-1 stage ring of Fig 7b, accumulating each arriving column block
    against its W rows.  "cagnet" (Fig 7a): full-width partial products
    of each column block, then a reduce-scatter over the model axis."""
    mesh, M = H.mesh, H.mesh.M
    widths = [b.shape[1] for b in H.blocks[0]]
    starts = np.concatenate([[0], np.cumsum(widths)])

    def w_on(p, m, j=None):
        w = W if j is None else W[starts[j]:starts[j + 1]]
        return w.to(mesh.device(p, m))

    if variant == "cagnet":
        if W.shape[1] % M:
            raise ValueError(f"output width {W.shape[1]} does not split "
                             f"over {M} model shards")
        parts = _grid(mesh, lambda p, m: gemm_rows(H.blocks[p][m],
                                                   w_on(p, m, m)))
        dc = W.shape[1] // M
        return Sharded(mesh, psum_model(
            mesh, parts, xch, cols=lambda m: slice(m * dc, (m + 1) * dc)))

    r = _row_blocks(mesh, H)
    recv = _grid(mesh, lambda p, m: [None if j == m else _empty(
        mesh, p, m, (r, widths[j]), H.dtype) for j in range(M)])
    xch.begin()
    for p in range(mesh.P):
        for m in range(M):
            for j in range(M):
                if j != m:
                    xch.send(recv[p][m][j],
                             H.blocks[p][j][m * r:(m + 1) * r])
    xch.fence()

    def block(p, m, j):
        return H.blocks[p][m][m * r:(m + 1) * r] if j == m else recv[p][m][j]

    def product(p, m):
        if variant == "deal":
            full = (block(p, m, m) if M == 1 else
                    torch.cat([block(p, m, j) for j in range(M)], dim=1))
            return gemm_rows(full, w_on(p, m))
        acc = None                     # deal_ring: stage k's block came
        for k in range(M):             # from shard (m - k) % M
            j = (m - k) % M
            t = gemm_rows(block(p, m, j), w_on(p, m, j))
            acc = t if acc is None else acc + t
        return acc
    return _all_to_all_back(mesh, _grid(mesh, product), xch)

