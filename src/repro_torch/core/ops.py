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

Every executor lives on one device.  On a CUDA device the kernels run;
on the CPU the same executor code runs the plain versions (the wrappers
dispatch on the tensors' device), which is how the tests reach it.
GEMM is ``torch.matmul`` in full f32: ``resolve_device`` turns TF32
off for matmuls and cuDNN when it selects a CUDA device.  Every GEMM
call has the same number of rows (``GEMM_ROWS``; see ``gemm_rows``), so
a row's bits never depend on how many rows share the call: a delta
refresh of a few rows then equals the full epoch bitwise.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.registry import EXECUTORS, register_executor
from repro_torch.core.gnn_models import (LayerSpec, ModelSpec,
                                         gat_head_scores, masked_softmax,
                                         mean_weights)
from repro_torch.core.sampler import LayerGraph
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default)
    raises when no card is visible: the port never drops to the CPU
    unless asked.  Selecting CUDA turns TF32 off, so f32 GEMMs run in
    full f32 like the JAX package's."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device=\"cpu\" to run the "
                "plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
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


def gemm_rows(h, w):
    """``ref.gemm_ref(h, w)`` computed as ``torch.matmul`` calls of
    exactly ``GEMM_ROWS`` rows each (the last block zero-padded), so
    every row goes through the same library kernel whatever the number
    of rows: bitwise invariant to M by construction."""
    hf, wf = h.float(), w.float()
    M = hf.shape[0]
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
# graph binding
# ----------------------------------------------------------------------

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
        self.nbr_np = np.asarray(nbr)
        self.mask_np = np.asarray(mask)
        self.nbr = torch.as_tensor(self.nbr_np, dtype=torch.int32,
                                   device=self.device)
        self.mask = torch.as_tensor(self.mask_np, dtype=torch.bool,
                                    device=self.device)
        # the loader's table is int64; the kernels read int32 ids
        self.table = (None if table is None else torch.as_tensor(
            np.asarray(table), device=self.device).to(torch.int32))
        self._nbr_resolved = None
        self._mean_w = None

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
        """Mean-aggregation edge weights (lazy: gat never reads them)."""
        if self._mean_w is None:
            self._mean_w = torch.as_tensor(mean_weights(self.mask_np),
                                           device=self.device)
        return self._mean_w


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
            else:
                raise ValueError(f"unknown layer op {kind!r}")
            if sp:
                # make the span honest under async launches; value-neutral
                if out.is_cuda:
                    torch.cuda.synchronize(out.device)
                sp.set(executor=getattr(ex, "name", type(ex).__name__),
                       rows=int(out.shape[0]))
        env[out_slot] = out
    return env[layer.out]


def run_model(ex, spec: ModelSpec, ios: Sequence, X,
              activation: Optional[Callable] = None):
    """Full forward pass: layer l reads/writes the same row set
    (h_src == h_tgt == H), activation between layers."""
    act = activation or spec.activation
    H = ex.prepare(X)
    L = len(spec.layers)
    for l, layer in enumerate(spec.layers):
        H = run_layer(ex, layer, ios[l], H, H, spec.heads)
        if l < L - 1:
            H = act(H)
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
        return torch.as_tensor(X, device=self.device)

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


class CudaExecutor(RefExecutor):
    """Routes spmm / sddmm / attention through the CUDA kernels — the
    counterpart of ``repro``'s PallasExecutor.  GEMM stays on
    ``torch.matmul`` (``gemm_rows``).

    ``fused_gather``: consume ``DenseIO.table`` in the gather_spmm kernel
    instead of materializing ``nbr_resolved`` (bitwise the same).
    ``fused_attention``: collapse GAT's attn_scores -> edge_softmax into
    the one-pass gat_attention kernel through the ``run_layer``
    peephole; off, scores come from one sddmm launch per head.

    On a CUDA device the constructor builds the kernels that are not
    built yet (``kernels.build.build_all``), so the nvcc time falls in
    the caller's span (``session.executor_build``), not in the first
    launch's."""

    name = "cuda"

    def __init__(self, device="cuda", fused_gather: bool = True,
                 fused_attention: bool = True):
        super().__init__(device)
        self.fused_gather = fused_gather
        self.fused_attention = fused_attention
        if self.device.type == "cuda":
            from repro_torch.kernels import build
            build.build_all()

    def spmm(self, H_src, w_edge, io: DenseIO):
        if self.fused_gather and io.table is not None:
            return kops.gather_spmm(H_src, io.table, w_edge, io.nbr,
                                    io.mask)
        return kops.spmm(H_src, w_edge, io.nbr_resolved, io.mask)

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


# ----------------------------------------------------------------------
# factory — backends resolve through the port's executor registry
# ----------------------------------------------------------------------

register_executor("ref", lambda device="cuda", **kw: RefExecutor(device,
                                                                 **kw))
register_executor("cuda", lambda device="cuda", **kw: CudaExecutor(device,
                                                                   **kw))


def get_executor(executor="cuda", *, device="cuda", **kw):
    """Resolve a registered executor name ("cuda" | "ref" | anything
    added via ``api.registry.register_executor``) into an instance on
    ``device``, or pass an instance through.  Unknown names raise with
    every registered name listed."""
    if not isinstance(executor, str):
        return executor
    try:
        factory = EXECUTORS.get(executor)
    except KeyError as exc:
        raise ValueError(exc.args[0]) from None
    return factory(device=device, **kw)
