"""The layer-op executor layer — the port's twin of ``repro.core.ops``.

One layer's semantics, the GEMM -> SPMM / SDDMM dataflow over a sampled
layer graph (Deal §3.4), is declared once per model in
``gnn_models.model_spec`` and executed here against a backend:

  ``RefExecutor``   ("ref")  the plain PyTorch versions (``kernels.ref``).
  ``CudaExecutor``  ("cuda") the hand-written CUDA kernels, the
                    counterpart of ``repro``'s ``PallasExecutor``: fused
                    gather+spmm and fused attention switches, and
                    ``attend`` as one spmm over all heads.  The kernels
                    mask ragged rows and columns themselves, so nothing
                    is padded.
  ``DistExecutor``  ("dist") the §3.4 primitives (``core.primitives``)
                    on a P x M ``launch.mesh.Mesh`` with the static
                    CommPlan — plus a ROW-SUBSET mode (``run_rows``) that
                    executes one layer for a frontier of rows, split per
                    partition (the distributed delta refresh).  Values
                    on the mesh are ``primitives.Sharded``.

"ref" and "cuda" live on one device, "dist" on its mesh's.  On a CUDA
device the kernels run; on the CPU the same executor code runs the plain
versions (the wrappers dispatch on the tensors' device), which is how
the tests reach it.
GEMM is ``torch.matmul`` in full f32: ``resolve_device`` turns TF32
off for matmuls and cuDNN when it selects a CUDA device.  Every GEMM
call has the same number of rows (``GEMM_ROWS``; see ``gemm_rows``), so
a row's bits never depend on how many rows share the call: a delta
refresh of a few rows then equals the full epoch bitwise.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs, tuning
from repro_torch.api.registry import EXECUTORS, register_executor
from repro_torch.core import primitives as prim
from repro_torch.core.gnn_models import (RGAT_NEGATIVE_SLOPE, LayerSpec,
                                         ModelSpec, NodeTyping, RelAttention,
                                         RelProjection, affine_,
                                         gat_head_scores, masked_softmax,
                                         mean_weights)
from repro_torch.core.partition import build_plan, build_subset_plan_cached
from repro_torch.core.primitives import Sharded
from repro_torch.core.sampler import LayerGraph
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default)
    raises when no card is visible: the port never drops to the CPU
    unless asked.  Selecting CUDA turns TF32 off, so f32 GEMMs run in
    full f32 like the JAX package's.  ``"meta"`` (shapes without
    storage: the dry-run's abstract trees) is taken as it is; nothing
    runs there."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device=\"cpu\" to run the "
                "plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    return dev


# ----------------------------------------------------------------------
# GEMM with bits that do not depend on the row count
# ----------------------------------------------------------------------

# rows of every torch.matmul call that gemm_rows makes.  cuBLAS picks its
# kernel by shape, so a row of an f32 (M, 128) @ (128, 128) product can
# change its bits with M (chip_smoke.py's first [serve] line prints at
# which M it does on the card); a fixed row count a call removes M from
# the bits, and a large one keeps the launches few
GEMM_ROWS = 16384
# rows of each call of R-GAT's attend (``rel_attend``): a call's (rows,
# 1024) f32 output is 1 GiB, not the 16 GiB of a whole 2^22-node layer
ATTEND_ROWS = 1 << 18


def gemm_rows(h, w, out=None):
    """``ref.gemm_ref(h, w)`` computed as ``torch.matmul`` calls of
    exactly ``GEMM_ROWS`` rows each (the last block zero-padded), so
    every row goes through the same library kernel whatever the number
    of rows: bitwise invariant to M by construction.  ``out``: an f32
    (M, width) tensor with contiguous rows to write into (a block of
    R-GAT's projected table) in place of a new one."""
    hf, wf = h.float(), w.float()
    M = hf.shape[0]
    if out is None:
        out = torch.empty((M, wf.shape[1]), dtype=torch.float32,
                          device=hf.device)
    whole = M - M % GEMM_ROWS
    for i in range(0, whole, GEMM_ROWS):
        torch.matmul(hf[i:i + GEMM_ROWS], wf, out=out[i:i + GEMM_ROWS])
    if whole < M:
        pad = torch.zeros((GEMM_ROWS, hf.shape[1]), dtype=torch.float32,
                          device=hf.device)
        pad[:M - whole] = hf[whole:]
        out[whole:] = torch.matmul(pad, wf)[:M - whole]
    return out.to(h.dtype)


# ----------------------------------------------------------------------
# the staging ring: host arrays to a card through page-locked buffers
# ----------------------------------------------------------------------

# STAGE_BUFFERS page-locked host buffers of STAGE_CHUNK bytes each, chosen
# by tools/h2d_copy.py on the card (PERF.md §5): their product is pinned,
# once a process and device, and nothing on the device
STAGE_BUFFERS = 2
STAGE_CHUNK = 16 << 20
# torch's CPU threads for the host's copy into the buffers, at the least:
# one thread copies at a fifth of what eight do on an H100's host, and the
# benchmark (gnnbench/run.py) holds torch's pool to one
STAGE_THREADS = 8
# host arrays of fewer bytes (as bound) keep the plain pageable copy
STAGE_MIN_BYTES = 8 << 20


def chunk_plan(n: int, itemsize: int, chunk_bytes: int):
    """The ring's chunks of an n-element array of ``itemsize``-byte
    elements: (start, stop) element ranges of at most ``chunk_bytes``
    bytes each, in order, covering [0, n) once."""
    step = max(chunk_bytes // itemsize, 1)
    return [(i, min(i + step, n)) for i in range(0, n, step)]


class StageRing:
    """``buffers`` page-locked host buffers of ``chunk`` bytes on one CUDA
    device, an event a buffer and a copy stream of its own.  ``copy``
    deals a host array's chunks to the buffers in turn: torch's
    multi-threaded copy of a chunk into a buffer whose last DMA is done
    overlaps the DMAs of the chunks before it."""

    def __init__(self, device: torch.device, buffers: int = STAGE_BUFFERS,
                 chunk: int = STAGE_CHUNK):
        self.device = device
        self.chunk = chunk
        self.bufs = [torch.empty(chunk, dtype=torch.uint8, pin_memory=True)
                     for _ in range(buffers)]
        self.events = [torch.cuda.Event() for _ in range(buffers)]
        self.stream = torch.cuda.Stream(device)
        self.lock = threading.Lock()

    def copy(self, src: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """A C-contiguous CPU tensor as a new ``dtype`` tensor on the
        device, bitwise ``torch.as_tensor``'s: a conversion runs in the
        host's copy, a chunk at a time, so the bytes that cross the link
        are the result's own.  The host's copies run on at least
        ``STAGE_THREADS`` of torch's threads (the caller's count is put
        back after).  The result is allocated on the current stream,
        which waits for the copies; the host does not."""
        out = torch.empty(src.shape, dtype=dtype, device=self.device)
        flat, dst = src.reshape(-1), out.view(-1)
        size = out.element_size()
        cur = torch.cuda.current_stream(self.device)
        threads = torch.get_num_threads()
        with self.lock, torch.cuda.stream(self.stream):
            torch.set_num_threads(max(threads, STAGE_THREADS))
            try:
                self.stream.wait_stream(cur)   # out's block may be reused
                for i, (a, b) in enumerate(chunk_plan(flat.numel(), size,
                                                      self.chunk)):
                    k = i % len(self.bufs)
                    self.events[k].synchronize()   # its last DMA is done
                    buf = self.bufs[k][:(b - a) * size].view(dtype)
                    buf.copy_(flat[a:b])
                    dst[a:b].copy_(buf, non_blocking=True)
                    self.events[k].record(self.stream)
                cur.wait_stream(self.stream)
            finally:
                torch.set_num_threads(threads)
        return out


_RINGS: Dict[int, StageRing] = {}


def _ring(device: torch.device) -> StageRing:
    """The process's ring for a CUDA device, made at its first use."""
    idx = torch.cuda.current_device() if device.index is None \
        else device.index
    if idx not in _RINGS:
        _RINGS[idx] = StageRing(torch.device("cuda", idx))
    return _RINGS[idx]


def _stage_source(a, device: torch.device, dtype) -> Optional[torch.Tensor]:
    """``a`` as a CPU tensor (sharing its memory) where the ring takes
    its copy: a C-contiguous numpy array or CPU tensor bound to a CUDA
    device at ``STAGE_MIN_BYTES`` bytes or more; None where the plain
    copy does."""
    if device.type != "cuda":
        return None
    if isinstance(a, np.ndarray):
        if not a.flags.c_contiguous:
            return None
        src = torch.as_tensor(a)
    elif (isinstance(a, torch.Tensor) and a.device.type == "cpu"
          and a.is_contiguous()):
        src = a
    else:
        return None
    itemsize = (dtype or src.dtype).itemsize
    return src if src.numel() * itemsize >= STAGE_MIN_BYTES else None


# ----------------------------------------------------------------------
# graph binding
# ----------------------------------------------------------------------

def _h2d(a, t: torch.Tensor) -> bool:
    """True where making ``t`` from ``a`` copied host memory (a numpy
    array, a CPU tensor) to a CUDA device."""
    return t.is_cuda and (not isinstance(a, torch.Tensor)
                          or a.device.type == "cpu")


def _bind(a, device: torch.device, dtype=None):
    """``torch.as_tensor(a, dtype=dtype, device=device)`` and the bytes
    it copied from host memory to a CUDA device, added to the
    ``io.h2d_bytes`` counter where the copy is issued (0 on the CPU, or
    where ``a`` is on the device already).  A host array the ring takes
    (``_stage_source``) crosses through it, bitwise the same, and its
    bytes are added to ``io.h2d_staged_bytes`` too."""
    src = _stage_source(a, device, dtype)
    if src is not None:
        t = _ring(device).copy(src, dtype or src.dtype)
        n = t.numel() * t.element_size()
        obs.add("io.h2d_bytes", n)
        obs.add("io.h2d_staged_bytes", n)
        return t, n
    t = torch.as_tensor(a, dtype=dtype, device=device)
    if not _h2d(a, t):
        return t, 0
    n = t.numel() * t.element_size()
    obs.add("io.h2d_bytes", n)
    return t, n


def _io_end(sp, device: torch.device, **attrs) -> None:
    """A recording ``io.*`` span's end: on the host's clock, wait for the
    device, so that the span holds its own copies; then its attrs."""
    if device.type == "cuda" and not obs.profiling():
        torch.cuda.synchronize(device)
    sp.set(**attrs)


class DenseIO:
    """Graph binding: a fixed-fanout neighbor matrix whose ids index the
    source rows directly, on one device (``"cuda"`` by default, which
    raises without a card, like every entry point of the port).

    An optional ``table`` adds one level of indirection — ``nbr`` ids
    index ``table`` and ``table[id]`` indexes the source rows (loader
    order in the §3.5 fused feature prep).  The fused gather kernel
    consumes ``table`` directly; everything else reads ``nbr_resolved``,
    which materializes the translation lazily (bitwise the same)."""

    def __init__(self, nbr: np.ndarray, mask: np.ndarray, table=None,
                 device="cuda"):
        self.device = resolve_device(device)
        with obs.span("io.bind") as sp:
            self.nbr_np = np.asarray(nbr)
            self.nbr, n_nbr = _bind(self.nbr_np, self.device, torch.int32)
            self.mask, n_mask = _bind(np.asarray(mask), self.device,
                                      torch.bool)
            self.table, n_table = None, 0
            if table is not None:
                # the loader's table is int64; the kernels read int32 ids
                self.table, n_table = _bind(np.asarray(table), self.device)
                self.table = self.table.to(torch.int32)
            if sp:
                _io_end(sp, self.device, rows=int(self.nbr_np.shape[0]),
                        fanout=int(self.nbr_np.shape[1]),
                        h2d_bytes=n_nbr + n_mask + n_table)
        self._nbr_resolved = None
        self._mean_w = None
        self.rel = self.tid = None

    def bind_typing(self, typing: NodeTyping) -> None:
        """A typed graph's slots: each one's relation ``rel`` (R, F) int8
        and its row of the projected table ``tid`` (R, F) int32
        (``slot_relations``), worked out on the device from the bound
        ``nbr`` and ``mask``, in an ``io.rel`` span that copies
        nothing."""
        with obs.span("io.rel") as sp:
            self.rel, self.tid = slot_relations(self.nbr_resolved,
                                                self.mask, typing)
            if sp:
                _io_end(sp, self.device, rows=int(self.mask.shape[0]),
                        h2d_bytes=0)

    @classmethod
    def from_layer_graph(cls, lg: LayerGraph, device="cuda") -> "DenseIO":
        return cls(lg.nbr, lg.mask, device=device)

    @property
    def nbr_resolved(self):
        """``nbr`` with the table applied (identity without a table)."""
        if self.table is None:
            return self.nbr
        if self._nbr_resolved is None:
            self._nbr_resolved = self.table[self.nbr.long()]
        return self._nbr_resolved

    @property
    def mean_w(self):
        """Mean-aggregation edge weights (lazy: gat never reads them),
        built from the bound mask on its device (``kops.mean_weights``),
        so nothing is copied from the host."""
        if self._mean_w is None:
            with obs.span("io.mean_w") as sp:
                self._mean_w = kops.mean_weights(self.mask)
                if sp:
                    _io_end(sp, self.device, rows=int(self.mask.shape[0]),
                            h2d_bytes=0)
        return self._mean_w


def slot_relations(nbr, mask, typing: NodeTyping):
    """Each slot's relation and its row in R-GAT's projected table, on
    ``nbr``'s device, from the type blocks of its two ends: row i (the
    target, node i) of type dt and source j = nbr[i, f] of type st give
    relation r = ``typing.table[dt][st]`` and row ``base + j -
    offsets[st]`` of r's block for st (``NodeTyping.blocks``).  Returns
    (rel (R, F) int8, -1 on a masked slot or one of no relation; tid (R,
    F) int32, 0 there).  Elementwise ops with the offsets as Python
    scalars: nothing is copied from the host."""
    R = nbr.shape[0]
    rel = torch.full(nbr.shape, -1, dtype=torch.int8, device=nbr.device)
    tid = torch.zeros(nbr.shape, dtype=torch.int32, device=nbr.device)
    off = typing.offsets
    for dt in range(len(off) - 1):
        a, b = min(off[dt], R), min(off[dt + 1], R)
        if a >= b:
            continue
        nb, live = nbr[a:b], mask[a:b]
        for st, r, base in typing.sources(dt):
            sel = live & (nb >= off[st]) & (nb < off[st + 1])
            rel[a:b].masked_fill_(sel, r)
            tid[a:b] = torch.where(sel, nb + (base - off[st]), tid[a:b])
    return rel, tid


# ----------------------------------------------------------------------
# spec interpreter
# ----------------------------------------------------------------------

def _fusable_attn_pair(ex, layer: LayerSpec, i: int) -> bool:
    """True when ops[i] is an (attn_scores -> edge_softmax) pair the
    executor can collapse into one ``attn_scores_softmax`` call: the
    softmax must be the ONLY consumer of the raw scores."""
    ops = layer.ops
    if (getattr(ex, "attn_scores_softmax", None) is None
            or ops[i].kind != "attn_scores" or i + 1 >= len(ops)
            or ops[i + 1].kind != "edge_softmax"
            or ops[i + 1].src[0] != ops[i].out):
        return False
    readers = [op for j, op in enumerate(ops)
               if j != i + 1 and ops[i].out in op.src]
    return not readers and layer.out != ops[i].out


def run_layer(ex, layer: LayerSpec, io, h_tgt, h_src, heads: int = 1):
    """Execute one LayerSpec.  ``h_tgt``/``h_src`` may be zero-arg
    callables, resolved on first use.

    Peephole: an (attn_scores -> edge_softmax) pair collapses into one
    ``attn_scores_softmax`` call when the executor exposes it (the fused
    attention kernel): the (R, F, heads) scores never reach memory."""
    env: Dict[str, Any] = {"h_tgt": h_tgt, "h_src": h_src}

    def get(name):
        v = env[name]
        if callable(v):
            v = v()
            env[name] = v
        return v

    skip = -1
    for i, op in enumerate(layer.ops):
        if i == skip:
            continue
        kind = op.kind
        out_slot = op.out
        if _fusable_attn_pair(ex, layer, i):
            kind = "attn_scores_softmax"
            out_slot = layer.ops[i + 1].out
            skip = i + 1
        with obs.span("ops." + kind) as sp:
            if kind == "gemm":
                out = ex.gemm(get(op.src[0]), op.param)
            elif kind == "spmm":
                out = ex.spmm(get(op.src[0]), io.mean_w, io)
            elif kind == "add":
                out = get(op.src[0]) + get(op.src[1])
            elif kind == "attn_scores":
                out = ex.attn_scores(get(op.src[0]), get(op.src[1]), io,
                                     heads)
            elif kind == "attn_scores_softmax":
                out = ex.attn_scores_softmax(get(op.src[0]),
                                             get(op.src[1]), io, heads)
            elif kind == "edge_softmax":
                out = ex.edge_softmax(get(op.src[0]), io)
            elif kind == "attend":
                out = ex.attend(get(op.src[0]), get(op.src[1]), io, heads)
            elif kind == "rel_project":
                out = ex.rel_project(get(op.src[0]), op.param)
            elif kind == "rel_softmax":
                out = ex.rel_softmax(get(op.src[0]), get(op.src[1]),
                                     op.param, io, heads)
            elif kind == "rel_attend":
                out = ex.rel_attend(get(op.src[0]), get(op.src[1]),
                                    get(op.src[2]), io)
            elif kind == "affine":
                out = affine_(get(op.src[0]), op.param)
            elif kind == "elu":
                out = torch.nn.functional.elu(get(op.src[0]), inplace=True)
            elif kind == "relu":
                out = torch.relu_(get(op.src[0]))
            else:
                raise ValueError(f"unknown layer op {kind!r}")
            if sp:
                # make the span honest under async launches, unless a
                # profiler's trace holds the device's time; value-neutral
                if not obs.profiling():
                    if isinstance(out, Sharded):
                        out.synchronize()
                    elif out.is_cuda:
                        torch.cuda.synchronize(out.device)
                sp.set(executor=getattr(ex, "name", type(ex).__name__),
                       rows=int(out.shape[0]))
        env[out_slot] = out
    return env[layer.out]


def run_model(ex, spec: ModelSpec, ios: Sequence, X,
              activation: Optional[Callable] = None):
    """Full forward pass: layer l reads/writes the same row set
    (h_src == h_tgt == H), activation between layers (none where the
    spec's layers carry their own), then the spec's ``head``."""
    act = activation or spec.activation
    H = ex.prepare(X)
    L = len(spec.layers)
    for l, layer in enumerate(spec.layers):
        H = run_layer(ex, layer, ios[l], H, H, spec.heads)
        if l < L - 1 and act is not None:
            H = act(H)
    if spec.head is not None:
        H = run_layer(ex, spec.head, None, H, H, spec.heads)
    return H


# ----------------------------------------------------------------------
# executors
# ----------------------------------------------------------------------

class RefExecutor:
    """The plain PyTorch versions, op for op ``repro``'s RefExecutor."""

    name = "ref"

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def prepare(self, X):
        with obs.span("io.prepare") as sp:
            H, n = _bind(X, self.device)
            if sp:
                _io_end(sp, self.device, rows=int(H.shape[0]), h2d_bytes=n)
        return H

    def gemm(self, H, W):
        return gemm_rows(H, torch.as_tensor(W, device=self.device))

    def spmm(self, H_src, w_edge, io: DenseIO):
        return ref.spmm_ref(H_src, w_edge, io.nbr_resolved, io.mask)

    def attn_scores(self, q, k, io: DenseIO, heads: int):
        """Per-head scaled dot scores (R, F, h)."""
        return gat_head_scores(q, k, io.nbr_resolved, io.mask, heads)

    def edge_softmax(self, s, io: DenseIO):
        return masked_softmax(s.transpose(1, 2),
                              io.mask[:, None, :]).transpose(1, 2)

    def attend(self, alpha, v, io: DenseIO, heads: int):
        D = v.shape[-1]
        dh = D // heads
        vn = v.reshape(-1, heads, dh)[io.nbr_resolved.reshape(-1).long()]
        vn = vn.reshape(io.nbr.shape + (heads, dh))
        return torch.einsum("nfh,nfhd->nhd", alpha, vn).reshape(
            alpha.shape[0], D)

    # -- R-GAT: the relations' projections, scores and attend ----------
    def rel_project(self, h, proj: RelProjection):
        """The projected table: for each block of ``typing.blocks``,
        relation r's weight over its source type's rows of ``h``, through
        ``gemm_rows`` into the table's rows; the rows projected are
        added to the ``ops.rel_rows`` counter."""
        typ, w = proj.typing, proj.w
        z = torch.empty((typ.rows, w.shape[2]), dtype=torch.float32,
                        device=h.device)
        for r, st, base, rows in typ.blocks:
            a = typ.offsets[st]
            gemm_rows(h[a:a + rows], w[r], out=z[base:base + rows])
        obs.add("ops.rel_rows", typ.rows)
        return z

    def rel_softmax(self, z, h, att: RelAttention, io: DenseIO,
                    heads: int):
        """alpha (R, F, heads): each table row's source score per head,
        <z_h, a_src[r, h]> (``gemm_rows`` by a block-diagonal (d_out,
        heads) matrix), each row's target score of each relation,
        <(h W_r)_h, a_dst[r, h]> = h (W_r a_dst[r, h]) (``gemm_rows`` by
        the folded (d_in, R x heads) matrix), then the relation-wise
        softmax of their LeakyReLU (``rel_alpha``)."""
        if io.rel is None:
            raise ValueError("rel_softmax: the layer graph has no relations"
                             " bound (DenseIO.bind_typing)")
        typ = att.typing
        R, d_in, d_out = att.w.shape
        dh = d_out // heads
        eye = torch.eye(heads, dtype=torch.float32, device=z.device)
        s_src = torch.empty((typ.rows, heads), dtype=torch.float32,
                            device=z.device)
        for r, _, base, rows in typ.blocks:
            a = (att.a_src[r][:, :, None] * eye[:, None, :]).reshape(
                d_out, heads)
            gemm_rows(z[base:base + rows], a, out=s_src[base:base + rows])
        v = torch.einsum("rdhk,rhk->drh", att.w.reshape(R, d_in, heads, dh),
                         att.a_dst).reshape(d_in, R * heads)
        s_dst = gemm_rows(h, v).reshape(-1, R, heads)
        return self.rel_alpha(s_src, s_dst, io)

    def rel_alpha(self, s_src, s_dst, io: DenseIO):
        return ref.rgat_attention_ref(s_src, s_dst, io.tid, io.rel, io.mask,
                                      RGAT_NEGATIVE_SLOPE)

    def rel_attend(self, z, alpha, out, io: DenseIO):
        """``out`` += each row's heads-weighted sum of its slots' table
        rows, in place, ``ATTEND_ROWS`` rows a call, so that one call's
        output, not the whole attend, sits beside ``out``."""
        R = io.tid.shape[0]
        for r0 in range(0, R, ATTEND_ROWS):
            r1 = min(r0 + ATTEND_ROWS, R)
            out[r0:r1] += self.attend_rows(z, alpha[r0:r1], io.tid[r0:r1],
                                           io.mask[r0:r1])
        return out

    def attend_rows(self, z, alpha, tid, mask):
        return ref.spmm_heads_ref(z, alpha, tid, mask)


class CudaExecutor(RefExecutor):
    """Routes spmm / sddmm / attention through the CUDA kernels — the
    counterpart of ``repro``'s PallasExecutor.  GEMM stays on
    ``torch.matmul`` (``gemm_rows``).

    ``fused_gather``: consume ``DenseIO.table`` in the gather_spmm kernel
    instead of materializing ``nbr_resolved`` (bitwise the same).
    ``fused_attention``: collapse GAT's attn_scores -> edge_softmax into
    the one-pass gat_attention kernel through the ``run_layer``
    peephole; off, scores come from one sddmm launch per head.
    ``block_table``: a ``tuning.BlockTable`` source ("default" = the
    port's ``configs/tuned_blocks_torch.json``, a path, or a table)
    consulted per (kernel, shape bucket, dtype) for the spmm and
    gather_spmm tilings; a miss keeps the wrapper's default tiling.  A
    tiling never changes a row's order of sums, so tuned and untuned
    are bitwise the same.

    On a CUDA device the constructor builds the kernels that are not
    built yet (``kernels.build.build_all``), so the nvcc time falls in
    the caller's span (``session.executor_build``), not in the first
    launch's."""

    name = "cuda"

    def __init__(self, device="cuda", fused_gather: bool = True,
                 fused_attention: bool = True, block_table=None):
        super().__init__(device)
        self.fused_gather = fused_gather
        self.fused_attention = fused_attention
        self._blocks = tuning.resolve_block_table(block_table)
        self._block_memo: Dict[tuple, Dict[str, int]] = {}
        if self.device.type == "cuda":
            from repro_torch.kernels import build
            build.build_all()

    def _pick_blocks(self, kernel: str, R: int, D: int,
                     dtype) -> Dict[str, int]:
        """The tiling keywords for one launch: the table's entry for the
        call's shape bucket, or {} (the wrapper's default tiling) when
        no table is bound or the key misses.  Memoized per bucket."""
        if self._blocks is None:
            return {}
        dtype = str(dtype).replace("torch.", "")
        key = (kernel, tuning.shape_bucket(R), tuning.shape_bucket(D),
               dtype)
        got = self._block_memo.get(key)
        if got is None:
            got = self._blocks.lookup(kernel, N=R, D=D, dtype=dtype,
                                      backend=self.device.type) or {}
            self._block_memo[key] = got
        return got

    def spmm(self, H_src, w_edge, io: DenseIO):
        R, D = io.nbr.shape[0], H_src.shape[1]
        if self.fused_gather and io.table is not None:
            return kops.gather_spmm(
                H_src, io.table, w_edge, io.nbr, io.mask,
                **self._pick_blocks("gather_spmm", R, D, H_src.dtype))
        return kops.spmm(H_src, w_edge, io.nbr_resolved, io.mask,
                         **self._pick_blocks("spmm", R, D, H_src.dtype))

    def attn_scores(self, q, k, io: DenseIO, heads: int):
        """Unfused scores: one sddmm per head over head-major column
        slices (row-strided views, which the kernel reads in place),
        stacked to (R, F, h) and scaled."""
        dh = q.shape[1] // heads
        per_head = [kops.sddmm(q[:, h * dh:(h + 1) * dh],
                               k[:, h * dh:(h + 1) * dh],
                               io.nbr_resolved, io.mask)
                    for h in range(heads)]
        s = torch.stack(per_head, dim=-1)
        return s / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32,
                                           device=s.device))

    @property
    def attn_scores_softmax(self):
        """The fused entry the ``run_layer`` peephole probes for; None
        (= disabled) when fusion is off."""
        if not self.fused_attention:
            return None
        return self._attn_scores_softmax

    def _attn_scores_softmax(self, q, k, io: DenseIO, heads: int):
        return kops.gat_attention(q, k, io.nbr_resolved, io.mask,
                                  heads=heads)

    def attend(self, alpha, v, io: DenseIO, heads: int):
        """One spmm over all heads: alpha (R, F, heads), read through its
        strides, weighs each head's block of v's columns (bitwise the
        per-head launches)."""
        return self.spmm(v, alpha, io)

    def rel_alpha(self, s_src, s_dst, io: DenseIO):
        return kops.rgat_attention(s_src, s_dst, io.tid, io.rel, io.mask,
                                   RGAT_NEGATIVE_SLOPE)

    def attend_rows(self, z, alpha, tid, mask):
        """The heads-weighted spmm over the projected table."""
        return kops.spmm(z, alpha, tid, mask,
                         **self._pick_blocks("spmm", tid.shape[0],
                                             z.shape[1], z.dtype))


# ----------------------------------------------------------------------
# DistExecutor — the §3.4 primitives + CommPlan, full or row-subset
# ----------------------------------------------------------------------

@dataclasses.dataclass
class DistIO:
    """Graph binding for DistExecutor: one layer's receive layouts per
    partition (``deal``: the unique-row ring, which SDDMM always uses;
    ``spmm``: the SPMM variant's own, the same object for "deal") and its
    mean edge weights and live mask, row-sharded over the mesh."""
    deal: Optional[List[prim.RingLayout]]
    spmm: List[prim.RingLayout]
    mean_w: Sharded
    mask: Sharded


class DistExecutor:
    """Deal's distributed backend on a P x M mesh (``launch.mesh``).

    Full-graph mode: ``bind`` builds the static CommPlan for a list of
    layer graphs and returns per-layer ``DistIO``s.  Row-subset mode:
    ``run_rows`` executes ONE layer for a frontier of rows, splitting
    the frontier per partition by the same 1-D ownership as the full
    plan, so a row's bits are those of a full epoch through this
    executor.

    ``kernels`` is "cuda" (each shard's spmm / sddmm through the
    kernels' wrappers, which launch on a CUDA device) or "ref" (their
    plain versions on any device).  ``comm`` counts the bytes every
    primitive's messages moved (``spmm``, ``sddmm``, ``gemm``) and, for
    SPMM, what the JAX package's padded static shapes would move
    (``spmm_padded``).

    GAT note: edge scores use the full-width dot (heads=1 semantics; the
    sum over the model axis assembles the full-D product), as in the
    JAX package; ``heads`` must divide M.
    """

    name = "dist"

    def __init__(self, mesh, *, spmm_variant: str = "deal",
                 gemm_variant: str = "deal", sddmm_variant: str = "deal",
                 grouped: bool = True, subset_floor: int = 64,
                 kernels: str = "cuda"):
        for what, v, ok in (("spmm_variant", spmm_variant,
                             prim.SPMM_VARIANTS),
                            ("gemm_variant", gemm_variant,
                             prim.GEMM_VARIANTS),
                            ("sddmm_variant", sddmm_variant,
                             prim.SDDMM_VARIANTS),
                            ("kernels", kernels, prim.KERNELS)):
            if v not in ok:
                raise ValueError(f"{what}: {v!r} is not one of {ok}")
        self.mesh = mesh
        self.P, self.M = mesh.P, mesh.M
        self.device = mesh.devices[0]
        # pow2-bucket floor for row-subset plans (the JAX package's
        # compile-cache knob, kept so the plans equal its own)
        self.subset_floor = subset_floor
        self.spmm_variant = spmm_variant
        self.gemm_variant = gemm_variant
        self.sddmm_variant = sddmm_variant
        self.grouped = grouped
        self.kernels = kernels
        self.comm = collections.Counter()
        self.plan = None
        if mesh.is_cuda and kernels == "cuda":
            from repro_torch.kernels import build
            build.build_all()

    def _xch(self):
        return prim.Exchange(self.mesh)

    def _io(self, plan, r_loc: int, u_loc: int, fanout: int,
            mask: np.ndarray, need_sddmm: bool, nbr=None,
            mirror_src=None) -> DistIO:
        """One layer's binding from a LayerPlan or SubsetPlan; ``mask``
        is the (rows, F) live mask of the output rows."""
        v = self.spmm_variant
        deal = (prim.ring_layouts(plan, r_loc, u_loc, fanout)
                if v == "deal" or need_sddmm else None)
        if v == "graph_exchange":
            spmm = prim.ring_layouts(plan, r_loc, u_loc, fanout,
                                     mirror_src=mirror_src)
        elif v == "allgather":
            spmm = prim.gather_layouts(*nbr)
        else:
            spmm = deal
        return DistIO(deal=deal, spmm=spmm,
                      mean_w=prim.shard_rows(self.mesh, mean_weights(mask),
                                             split_cols=False),
                      mask=prim.shard_rows(self.mesh, mask,
                                           split_cols=False))

    # -- full-graph binding ---------------------------------------------
    def bind(self, layer_graphs: Sequence[LayerGraph],
             need_sddmm: bool = False) -> List[DistIO]:
        with obs.span("dist.bind") as bsp:
            self.plan = build_plan(list(layer_graphs), self.P, self.M)
            ios = []
            for l, lp in enumerate(self.plan.layers):
                lg = layer_graphs[l]
                ios.append(self._io(
                    lp, lp.n_local, lp.n_local, lp.fanout, lg.mask,
                    need_sddmm,
                    nbr=(self.plan.nbr_local[l], self.plan.mask_local[l]),
                    mirror_src=lp.mirror_src))
            if bsp:
                bsp.set(n_layers=len(ios), P=self.P, M=self.M)
        return ios

    # -- executor primitives --------------------------------------------
    def prepare(self, X):
        return prim.shard_rows(self.mesh, X)

    def gemm(self, H, W):
        xch = self._xch()
        out = prim.gemm(H, torch.as_tensor(W), xch, self.gemm_variant,
                        gemm_rows)
        self.comm["gemm"] += xch.bytes
        return out

    def spmm(self, H_src, w_edge, io: DistIO):
        xch = self._xch()
        if self.spmm_variant == "allgather":
            out = prim.spmm_allgather(H_src, w_edge, io.spmm, xch,
                                      self.kernels)
        else:
            out = prim.spmm_ring(H_src, w_edge, io.spmm, xch, self.grouped,
                                 self.kernels)
        self.comm["spmm"] += xch.bytes
        width = sum(b.shape[1] for b in H_src.blocks[0])
        self.comm["spmm_padded"] += sum(
            lay.pad_rows for lay in io.spmm) * width * \
            H_src.blocks[0][0].element_size()
        return out

    def attn_scores(self, q, k, io: DistIO, heads: int):
        if self.M % heads:
            raise ValueError(f"heads={heads} must divide the model axis "
                             f"M={self.M} (feature parts align to heads)")
        xch = self._xch()
        s = prim.sddmm_ring(q, k, io.deal, xch, self.grouped, self.kernels,
                            self.sddmm_variant)
        self.comm["sddmm"] += xch.bytes
        scale = math.sqrt(q.shape[1])      # the full width: heads=1
        return s.map(lambda b: b / scale)

    def edge_softmax(self, s, io: DistIO):
        return Sharded(self.mesh, [[masked_softmax(b, mb) for b, mb in
                                    zip(rs, rm)] for rs, rm in
                                   zip(s.blocks, io.mask.blocks)],
                       split_cols=False)

    def attend(self, alpha, v, io: DistIO, heads: int):
        return self.spmm(v, alpha, io)

    # -- row-subset mode (distributed delta refresh) --------------------
    def run_rows(self, layer: LayerSpec, lg: LayerGraph, rows: np.ndarray,
                 read_level: Callable, level: int, heads: int = 1,
                 *, n_nodes: Optional[int] = None):
        """Execute ``layer`` for the sorted row subset ``rows``, frontier
        split per partition.  ``read_level(level, ids)`` supplies input
        rows (the store's staged view during a refresh).  Returns the
        (pre-activation) padded output as a ``Sharded`` plus (take,
        n_src): the real rows' indices into its global rows and the
        universe-row work count.

        ``n_nodes`` pins the partition geometry to the pre-growth main
        range when the layer graph has an unfolded tail appended — every
        row (and masked neighbour) passed here must stay below it."""
        if self.spmm_variant != "deal":
            raise ValueError("row-subset mode needs the unique-row "
                             "exchange plan (spmm_variant=\"deal\")")
        if self.M & (self.M - 1):
            raise ValueError(f"model axis M={self.M} must be a power of "
                             "two (pad buckets)")
        with obs.span("dist.subset_plan") as psp:
            sp = build_subset_plan_cached(lg, rows, self.P,
                                          m_align=self.M,
                                          floor=self.subset_floor,
                                          n_nodes=n_nodes)
            if psp:
                psp.set(rows=int(rows.size), src_rows=int(sp.n_src_rows),
                        level=level)
        r_loc, u_loc = sp.row_ids.shape[1], sp.src_ids.shape[1]
        io = self._io(sp, r_loc, u_loc, sp.fanout,
                      sp.row_mask.reshape(-1, sp.fanout), True)
        with obs.span("dist.exchange") as xsp:
            src_rows = read_level(level, sp.src_ids.reshape(-1))
            H_src = self.prepare(src_rows)
            if xsp:
                nbytes = int(np.asarray(src_rows).nbytes)
                xsp.set(bytes=nbytes, rows=int(sp.n_src_rows),
                        level=level)
                obs.add("dist.exchanged_bytes", nbytes)
                obs.add("dist.src_rows", int(sp.n_src_rows))
        h_tgt = lambda: self.prepare(                    # noqa: E731
            read_level(level, sp.row_ids.reshape(-1)))
        H = run_layer(self, layer, io, h_tgt, H_src, heads)
        return H, sp.take, sp.n_src_rows


# ----------------------------------------------------------------------
# factory — backends resolve through the port's executor registry
# ----------------------------------------------------------------------

def _make_dist(device="cuda", mesh=None, **kw):
    if mesh is None:
        raise ValueError("dist executor needs a mesh= argument "
                         "(launch.mesh.make_host_mesh)")
    return DistExecutor(mesh, **kw)


register_executor("ref", lambda device="cuda", **kw: RefExecutor(device,
                                                                 **kw))
register_executor("cuda", lambda device="cuda", **kw: CudaExecutor(device,
                                                                   **kw))
register_executor("dist", _make_dist)


def local_executor_name(device) -> str:
    """The single-device executor that stands in for the mesh where the
    JAX package uses its jnp "ref" (the refresh's local cutover and tail
    route): the kernels ("cuda") on a card, the plain versions ("ref")
    on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "ref"


def get_executor(executor="cuda", *, device="cuda", mesh=None, **kw):
    """Resolve a registered executor name ("cuda" | "ref" | "dist" |
    anything added via ``api.registry.register_executor``) into an
    instance on ``device`` ("dist": on ``mesh``), or pass an instance
    through.  Unknown names raise with every registered name listed."""
    if not isinstance(executor, str):
        return executor
    try:
        factory = EXECUTORS.get(executor)
    except KeyError as exc:
        raise ValueError(exc.args[0]) from None
    if mesh is not None:
        kw["mesh"] = mesh
    return factory(device=device, **kw)
