"""``flash_attention``: softmax attention with an online (m, l, acc)
rescale over tiles of keys, accumulated in f32.

    out = softmax(q . k^T * scale [causal, window]) . v

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention`` (``pallas_call``
at line 65) with two CUDA kernels, one per dtype (``route``), each for
any hd up to 256, and a v head dim ``vd`` (1..256) that may differ from
q's (MLA: hd 192, vd 128):

- bf16: ``csrc/flash_attention_sm90.cu``, both products on the tensor
  cores (``wgmma``), q, k and v read by TMA;
- f32: ``csrc/flash_attention.cu``, f32 FMAs outside the tensor cores
  (f32 GEMM math stays full f32 in this port: no TF32), blocked as a
  SIMT SGEMM: a block takes 64 query rows of one (batch, head), each
  thread a TM x TN tile of the scores and TM rows of the accumulator in
  registers, K and V tiles copied into shared memory by ``cp.async``
  while the previous product runs (the tiles by head dim:
  ``simt_tiling``).

Each entry serves two signatures:

- ``flash_attention(q, k, v, *, causal)``: the Pallas one, q (BH, Sq, hd),
  k and v (BH, Skv, hd), scale 1/sqrt(hd);
- ``flash_attention_gqa(q, k, v, *, q_offset, causal, window, scale)``: the
  one of ``models/attention.py::flash_attention_jnp``, q (B, Sq, H, hd), k
  (B, Skv, K, hd) and v (B, Skv, K, vd), query head h reading kv head
  h // (H // K); the output is (B, Sq, H, vd).

The kernels read all three through their strides (the head dimension
contiguous), so neither GQA nor the heads-in-the-middle layout is copied,
and they mask ragged Sq and Skv themselves.  The tensor-core kernel reads
through TMA, which needs every base address 16-byte aligned and every
outer stride a multiple of 8 elements: the wrapper raises on a bf16 view
that breaks this (``tma_strides``) and never re-routes it.  On CPU
tensors the wrappers return the plain version,
``ref.gqa_attention_ref`` (the Pallas signature on a one-head view).
``flash_attention.launches`` counts kernel launches through either
signature and either kernel; ``flash_attention.launches_tc`` counts the
tensor-core kernel's alone.

Training: the TPU kernel has no backward (no ``custom_vjp``); the JAX
trainer differentiates ``flash_attention_jnp``, whose kv step sits under
``jax.checkpoint``, so its backward recomputes the scores block by
block.  Here, when grad mode is on and q, k or v requires grad, both
signatures go through ``FlashAttentionFn``: its forward is the kernel
(the plain version on the CPU), and its backward recomputes the plain
version in chunks of ``BACKWARD_ROWS`` query rows and differentiates
that.  ``_launch`` raises on a tensor that requires grad with grad mode
on, so no kernel result reaches autograd without that backward.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.spmm import FLOAT_CODES

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
SOURCE_TC = "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"
REPLACES = "src/repro/kernels/flash_attention.py:65"
MAX_HEAD_DIM = 256
BACKWARD_ROWS = 512                # query rows a chunk of the backward
_GRID_Y_MAX = 65535                # row tiles a launch, gridDim.y's most


class SimtTiling(NamedTuple):
    """A tile of the f32 kernel: query rows a block, keys a tile, threads
    a block, a thread's rows x keys of the scores, and the block's shared
    memory in bytes (q, one K and one V buffer, P)."""
    rows: int
    keys: int
    threads: int
    tm: int
    tn: int
    smem: int


def simt_tiling(hd: int, vd: Optional[int] = None) -> SimtTiling:
    """The tile ``csrc/flash_attention.cu`` takes for q's head dim ``hd``
    and v's ``vd`` (each 1..256; ``vd`` defaults to ``hd``), as its
    ``Tile64`` / ``Tile128`` / ``Tile256`` / ``Tile256v128`` and
    ``rows_for`` choose it: by max(hd, vd), with V held at 128 columns
    when that is above 128 and vd is not (MLA)."""
    vd = hd if vd is None else vd
    for name, d in (("head dim", hd), ("v head dim", vd)):
        if not 1 <= d <= MAX_HEAD_DIM:
            raise ValueError(f"flash_attention: {name} {d} outside "
                             f"1..{MAX_HEAD_DIM}")
    w = max(hd, vd)
    hdp, tm, tn, ty = ((64, 8, 4, 8) if w <= 64 else
                       (128, 8, 2, 8) if w <= 128 else (256, 4, 4, 16))
    vdp = 128 if hdp == 256 and vd <= 128 else hdp
    rows, keys = ty * tm, 16 * tn
    words = ((rows + keys) * (hdp + 4) + keys * (vdp + 4)
             + keys * (rows + 4))
    return SimtTiling(rows, keys, 16 * ty, tm, tn, 4 * words)


def max_query_rows(hd: int, vd: Optional[int] = None) -> int:
    """The longest Sq one f32 launch takes: gridDim.y row tiles."""
    return _GRID_Y_MAX * simt_tiling(hd, vd).rows


def route(dtype: torch.dtype, device: torch.device) -> str:
    """Which version a call takes: "plain" for CPU tensors, else "tc"
    (the tensor-core kernel) for bf16 and "simt" (the f32-FMA kernel) for
    f32."""
    if device.type == "cpu":
        return "plain"
    return "tc" if dtype == torch.bfloat16 else "simt"


def tma_strides(t: torch.Tensor, name: str):
    """The (batch, seq, head) strides of a (B, S, heads, hd) view in
    elements, as the tensor-core kernel's tensor maps take them.  TMA
    needs a 16-byte aligned base and strides that are multiples of 16
    bytes (8 bf16); the stride of a dimension of size 1 is never stepped
    along, so it is replaced by a contiguous one.  Raises ValueError on
    anything else."""
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name}'s base address is not "
                         "16-byte aligned, which the bf16 tensor-core "
                         "kernel's TMA loads need")
    _, S, H, hd = t.shape
    hd8 = -(-hd // 8) * 8
    natural = (S * H * hd8, H * hd8, hd8)
    strides = [s if n > 1 else c
               for n, s, c in zip(t.shape[:3], t.stride()[:3], natural)]
    if any(s % 8 for s in strides):
        raise ValueError(f"flash_attention: {name}'s strides "
                         f"{tuple(t.stride())} are not multiples of 8 "
                         "elements (16 bytes), which the bf16 tensor-core "
                         "kernel's TMA loads need")
    return strides


def _check(q, k, v, ndim: int):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != ndim:
            raise ValueError(f"flash_attention: {name} must be {ndim}-D, "
                             f"got {tuple(t.shape)}")
    if not (q.shape[0] == k.shape[0] == v.shape[0]
            and k.shape[:-1] == v.shape[:-1]
            and q.shape[-1] == k.shape[-1]):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if ndim == 4 and q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: {q.shape[2]} query heads are "
                         f"not a multiple of {k.shape[2]} kv heads")
    if not 1 <= v.shape[-1] <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: v head dim {v.shape[-1]} "
                         f"outside 1..{MAX_HEAD_DIM}")


def _launch(q, k, v, *, q_offset: int, causal: bool,
            window: Optional[int], scale: float):
    """Run the kernel on (B, S, H, hd) views of q and k and a (B, S, K,
    vd) view of v; returns a new contiguous (B, Sq, H, vd) tensor in q's
    dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if _needs_grad(q, k, v):
        raise RuntimeError("flash_attention: the kernel's result has no "
                           "backward of its own; an input that requires "
                           "grad goes through FlashAttentionFn")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"expected {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: q is {q.dtype} but {name} is "
                            f"{t.dtype}")
    if q.dtype not in FLOAT_CODES:
        raise TypeError(f"flash_attention: q must be one of "
                        f"{tuple(FLOAT_CODES)}, got {q.dtype}")
    B, Sq, H, hd = q.shape
    vd = v.shape[-1]
    Skv, K = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} > {MAX_HEAD_DIM}")
    if Skv == 0:
        raise ValueError("flash_attention: no keys (Skv = 0)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dimension of q, k and v "
                         "must be contiguous")
    tc = route(q.dtype, q.device) == "tc"
    if not tc and Sq > max_query_rows(hd, vd):
        raise ValueError(f"flash_attention: Sq={Sq} passes the f32 "
                         f"kernel's {max_query_rows(hd, vd)} rows a launch")
    if tc:
        strides = [s for name, t in (("q", q), ("k", k), ("v", v))
                   for s in tma_strides(t, name)]
    else:
        strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]]
    out = torch.empty((B, Sq, H, vd), dtype=q.dtype, device=q.device)
    if B * Sq == 0:
        return out
    if tc:
        entry = build.library("flash_attention_sm90").deal_flash_attention_tc
    else:
        entry = build.library("flash_attention").deal_flash_attention
    with torch.cuda.device(q.device):
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, K, Sq, Skv, hd, vd, *strides, int(causal),
            int(window is not None), int(window or 0), int(q_offset),
            float(scale), FLOAT_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.launches_tc += int(tc)
    return out


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _forward(q, k, v, q_offset: int, causal: bool, window: Optional[int],
             scale: float):
    """(B, S, heads, hd) views: the kernel for CUDA tensors, the plain
    version for CPU ones."""
    if q.device.type == "cpu":
        return ref.gqa_attention_ref(q, k, v, q_offset=q_offset,
                                     causal=causal, window=window,
                                     scale=scale)
    return _launch(q, k, v, q_offset=q_offset, causal=causal, window=window,
                   scale=scale)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with the kernel's forward and the plain version's
    gradient.  q (B, Sq, H, hd), k (B, Skv, K, hd), v (B, Skv, K, vd).

    The forward launches the kernel, as prefill does, and saves q, k and
    v.  The backward recomputes ``ref.gqa_attention_ref`` in f32 under
    autograd, ``BACKWARD_ROWS`` query rows at a time (with
    ``q_offset`` >= 0, a causal chunk reads only the keys up to its last
    row: the rest are masked to an exact zero weight), and returns its
    gradients, k's and v's summed over the chunks in f32 and cast once.
    That is what the JAX trainer does with ``flash_attention_jnp``: it
    differentiates the plain function and recomputes its blocks in the
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (q_offset, causal, window, scale)
        return _forward(q, k, v, q_offset, causal, window, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        q_offset, causal, window, scale = ctx.opts
        Sq, Skv = q.shape[1], k.shape[1]
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for s in range(0, Sq, BACKWARD_ROWS):
            e = min(s + BACKWARD_ROWS, Sq)
            n = Skv
            if causal and q_offset >= 0:
                n = min(Skv, q_offset + e)
            with torch.enable_grad():
                qc = q[:, s:e].detach().float().requires_grad_()
                kc = k[:, :n].detach().float().requires_grad_()
                vc = v[:, :n].detach().float().requires_grad_()
                out = ref.gqa_attention_ref(qc, kc, vc, q_offset=q_offset + s,
                                            causal=causal, window=window,
                                            scale=scale)
                gq, gk, gv = torch.autograd.grad(out, (qc, kc, vc),
                                                 g[:, s:e].float())
            dq[:, s:e] = gq
            dk[:, :n] += gk
            dv[:, :n] += gv
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """The Pallas signature: q (BH, Sq, hd); k, v (BH, Skv, hd), f32 or
    bf16.  Returns (BH, Sq, hd) in q's dtype.  ``block_q`` and
    ``block_k`` are the TPU kernel's tiles; they do not change the
    result, and the CUDA kernel's tiles are its own."""
    del block_q, block_k
    _check(q, k, v, 3)
    return flash_attention_gqa(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal)[:, :, 0]


flash_attention.launches = 0
flash_attention.launches_tc = 0


def flash_attention_gqa(q, k, v, *, q_offset: int = 0, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """The GQA signature of ``flash_attention_jnp``: q (B, Sq, H, hd); k
    (B, Skv, K, hd) and v (B, Skv, K, vd) with H % K == 0; query positions
    start at ``q_offset``; ``window`` keeps keys with q_pos - kv_pos <
    window; the scale defaults to 1/sqrt(hd).  Returns (B, Sq, H, vd) in
    q's dtype, through ``FlashAttentionFn`` when it needs a gradient."""
    _check(q, k, v, 4)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, q_offset, causal, window,
                                      scale)
    return _forward(q, k, v, q_offset, causal, window, scale)
