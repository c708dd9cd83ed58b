"""``gat_attention``: per-head scaled dot scores and the masked edge
softmax over the fanout in one pass (GAT attention).

    alpha[i,f,h] = softmax_f(<q_h[i], k_h[nbr[i,f]]> / sqrt(dh))

Masked slots are filled with -1e30 before the softmax and zeroed after
it.  Replaces the Pallas TPU kernel
``src/repro/kernels/gat_attention.py::gat_attention`` (``pallas_call``
at line 70) with the kernels in ``csrc/gat_attention.cu``: the narrow
one (F <= 32, heads a power of two up to 32: a lane a slot, the (slot,
chunk) gathers in registers) and the wide one for every other shape
(the live slots' k rows copied coalesced into shared memory a pass at a
time, all of a pass's copies in flight, then a lane per (slot, head)
pair summing its dot in column order), chosen by shape alone
(``kernel_for``).  On a CPU tensor
the wrapper returns the plain version, ``ref.gat_attention_ref``.
``gat_attention.launches`` counts kernel launches, and
``gat_attention.launches_wide`` those of them on the wide kernel.

``rgat_attention`` is R-GAT's relation-wise attention (additive scores,
a softmax a relation) on the narrow kernel's layout: it replaces no TPU
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.spmm import FLOAT_CODES, check_shapes

SOURCE = "src/repro_torch/kernels/csrc/gat_attention.cu"
REPLACES = "src/repro/kernels/gat_attention.py:70"

WARPS = 8                          # warps a block, at most
_SMEM_MAX = 232448                 # a block's shared memory, 227 KB
_DTYPES = {"q": tuple(FLOAT_CODES), "k": tuple(FLOAT_CODES),
           "nbr": (torch.int32,), "mask": (torch.bool,)}


def check_qk(q, k, nbr, mask):
    check_shapes(q, nbr, mask)
    if k.dim() != 2 or k.shape[1] != q.shape[1]:
        raise ValueError(f"k must be (U, {q.shape[1]}), got "
                         f"{tuple(k.shape)}")
    if nbr.shape[0] != q.shape[0]:
        raise ValueError(f"nbr has {nbr.shape[0]} rows, q {q.shape[0]}")


def warp_words(F: int, D: int, heads: int, itemsize: int,
               softmax: bool) -> int:
    """Shared memory of one warp in 4-byte words, as ``warp_words`` in
    ``csrc/gat_attention.cu``.  A warp serves 32 / F2 rows (F2: F rounded
    up to a power of two) and holds their q rows, the chunk partials of
    up to 32 live slots (chunks of 16 bytes where the head width allows,
    else of one column; 33 words a chunk), the slots' k rows and lanes,
    and one row's softmax values a lane."""
    vec = 16 // itemsize
    cols = vec if (D // heads) % vec == 0 else 1
    f2 = 1 << max(F - 1, 0).bit_length()
    words = 32 // f2 * D + 33 * (D // cols) + 64 + (
        max(32, f2 * heads) if softmax else 0)
    return -(-words // 4) * 4                      # 16-byte aligned


_PASS_WORDS = 2048                 # a wide pass's k rows, at most ~8 KB


def wide_pitch16(D: int, itemsize: int) -> int:
    """16-byte units between two q or k rows in the wide kernel's shared
    memory: the row's bytes rounded up, made odd, so that the lanes of one
    dot step read distinct bank quads."""
    return -(-D * itemsize // 16) | 1


def wide_rows(F: int) -> int:
    """Rows one warp of the wide kernel serves: 32 / F2 (F2: F rounded up
    to a power of two) for F <= 32, else one."""
    return 32 // (1 << max(F - 1, 0).bit_length()) if F <= 32 else 1


def wide_pass(D: int, heads: int, itemsize: int) -> int:
    """k rows the wide kernel gathers in one pass: enough slots for 32
    (slot, head) pairs, at most about 8 KB of rows, 1 to 32."""
    fit = _PASS_WORDS // (4 * wide_pitch16(D, itemsize))
    return max(1, min(32, -(-32 // heads), fit))


def wide_words(F: int, D: int, heads: int, itemsize: int,
               softmax: bool) -> int:
    """Shared memory of one warp of the wide kernel in 4-byte words, as
    ``wide_words`` in ``csrc/gat_attention.cu``: a pass of k rows and
    the warp's q rows (each ``wide_pitch16`` units), the live
    list of a window of up to 64 slots (ids and positions), and for the
    softmax the rows' F x heads scores and, for F > 32, the slot of each
    live score (each 16-byte aligned)."""
    rows = wide_rows(F)
    return ((wide_pass(D, heads, itemsize) + rows) * 4
            * wide_pitch16(D, itemsize) + 2 * (32 if F <= 32 else 64)
            + (-(-rows * F * heads // 4) * 4 if softmax else 0)
            + (-(-F // 4) * 4 if softmax and F > 32 else 0))


def kernel_for(F: int, D: int, heads: int, itemsize: int,
               softmax: bool) -> str:
    """Which kernel of ``csrc/gat_attention.cu`` takes the shape, as its
    C ``launch`` chooses: "narrow" (a lane a slot: F <= 32, heads a
    power of two up to 32, one warp's shared memory within 227 KB), else
    "wide" (a warp per 32 / F2 rows, one for F > 32, with the live slots'
    k rows gathered into shared memory a pass at a time).  Dispatch by
    shape, not a fallback."""
    if (F <= 32 and heads <= 32 and not heads & (heads - 1)
            and 4 * warp_words(F, D, heads, itemsize, softmax)
            <= _SMEM_MAX):
        return "narrow"
    return "wide"


def block_warps(what, F, D, heads, itemsize, softmax):
    """Warps a block holds for the kernel ``kernel_for`` picks: WARPS, or
    fewer where their shared memory would pass 227 KB.  Raises where one
    warp's shared memory alone would pass it, or without a column."""
    if D < 1:
        raise ValueError(f"{what}: D={D}, the kernel needs a column")
    if kernel_for(F, D, heads, itemsize, softmax) == "narrow":
        words = warp_words(F, D, heads, itemsize, softmax)
    else:
        words = wide_words(F, D, heads, itemsize, softmax)
    warps = min(WARPS, _SMEM_MAX // max(4 * words, 1))
    if warps < 1:
        raise ValueError(f"{what}: D={D}, F={F}, heads={heads} need "
                         f"{4 * words} bytes of shared memory a warp, more "
                         "than a block's 227 KB")
    return warps


def launch_rows(what, q, k, nbr, mask, out, heads: int, softmax: bool):
    """Launch a kernel of gat_attention.cu on the current stream through
    ``deal_gat_attention`` (``softmax``; q and k contiguous) or
    ``deal_sddmm`` (one head; q and k may be row-strided views).
    Returns the kernel launched ("narrow" or "wide"), or None when there
    was nothing to compute."""
    build.check_args(what, {"q": q, "k": k, "nbr": nbr, "mask": mask},
                     _DTYPES, row_strided=() if softmax else ("q", "k"))
    if k.dtype != q.dtype:
        raise TypeError(f"{what}: q is {q.dtype} but k is {k.dtype}")
    N, F = nbr.shape
    D = q.shape[1]
    warps = block_warps(what, F, D, heads, q.element_size(), softmax)
    if N == 0 or F == 0:
        return None
    lib = build.library("gat_attention")
    if softmax:
        fn, extra = lib.deal_gat_attention, (heads,)
    else:
        fn, extra = lib.deal_sddmm, (q.stride(0), k.stride(0))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), nbr.data_ptr(),
                 mask.data_ptr(), out.data_ptr(), N, F, D, *extra,
                 FLOAT_CODES[q.dtype], warps,
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, what)
    return kernel_for(F, D, heads, q.element_size(), softmax)


def gat_attention(q, k, nbr, mask, heads: int = 1):
    """q: (N, D) head-major; k: (U, D) source rows, same dtype (f32 or
    bf16); nbr (int32, ids in [0, U)) and mask (bool): (N, F).  Returns
    the normalized attention (N, F, heads) f32."""
    check_qk(q, k, nbr, mask)
    if heads < 1 or q.shape[1] % heads:
        raise ValueError(f"heads={heads} must divide D={q.shape[1]}")
    if q.device.type == "cpu":
        return ref.gat_attention_ref(q, k, nbr, mask, heads)
    if q.device.type != "cuda":
        raise ValueError(f"gat_attention: no kernel for device {q.device}")
    out = torch.empty(nbr.shape + (heads,), dtype=torch.float32,
                      device=q.device)
    kind = launch_rows("gat_attention", q, k, nbr, mask, out, heads,
                       softmax=True)
    gat_attention.launches += kind is not None
    gat_attention.launches_wide += kind == "wide"
    return out


gat_attention.launches = 0
gat_attention.launches_wide = 0


RGAT_HEADS = (4,)                  # the heads rgat_attention_kernel holds
_RGAT_DTYPES = {"s_src": (torch.float32,), "s_dst": (torch.float32,),
                "tid": (torch.int32,), "rel": (torch.int8,),
                "mask": (torch.bool,)}


def rgat_attention(s_src, s_dst, tid, rel, mask,
                   negative_slope: float = 0.2):
    """R-GAT's relation-wise attention (``rgat_attention_kernel`` of
    ``csrc/gat_attention.cu``; it replaces no TPU kernel): for slot f of
    row i, of relation g = rel[i, f] and head h,

        alpha[i, f, h] = softmax over i's live slots of relation g of
                         LeakyReLU(s_src[tid[i, f], h] + s_dst[i, g, h])

    and 0 on a masked slot or one of no relation (g = -1).  s_src (U,
    heads) f32, a score per projected table row; s_dst (R, n_rel, heads)
    f32, each row's target score of each relation; tid (int32, ids in [0,
    U)), rel (int8) and mask (bool): (R, F).  Returns (R, F, heads) f32.
    On a CPU tensor, the plain version ``ref.rgat_attention_ref``; the
    kernel takes F <= 32, heads in ``RGAT_HEADS`` (a lane a slot, the
    heads in its registers) and s_src and s_dst starting on a 16-byte
    boundary (a slot's heads move as one float4), and raises otherwise.
    ``rgat_attention.launches`` counts launches."""
    R, F = tid.shape if tid.dim() == 2 else (None, None)
    if (R is None or rel.shape != tid.shape or mask.shape != tid.shape
            or s_src.dim() != 2 or s_dst.dim() != 3 or s_dst.shape[0] != R
            or s_dst.shape[2] != s_src.shape[1]):
        raise ValueError(
            "rgat_attention: tid, rel and mask must be (R, F), s_src (U, "
            "heads) and s_dst (R, n_rel, heads); got "
            f"{tuple(tid.shape)}, {tuple(rel.shape)}, {tuple(mask.shape)}, "
            f"{tuple(s_src.shape)}, {tuple(s_dst.shape)}")
    if tid.device.type == "cpu":
        return ref.rgat_attention_ref(s_src, s_dst, tid, rel, mask,
                                      negative_slope)
    if tid.device.type != "cuda":
        raise ValueError(f"rgat_attention: no kernel for device "
                         f"{tid.device}")
    heads, n_rel = s_src.shape[1], s_dst.shape[1]
    if F > 32 or heads not in RGAT_HEADS or not 1 <= n_rel <= 127:
        raise ValueError(f"rgat_attention: the kernel takes F <= 32, heads "
                         f"in {RGAT_HEADS} and 1 to 127 relations; got "
                         f"F={F}, heads={heads}, {n_rel} relations")
    build.check_args("rgat_attention",
                     {"s_src": s_src, "s_dst": s_dst, "tid": tid,
                      "rel": rel, "mask": mask}, _RGAT_DTYPES)
    out = torch.empty((R, F, heads), dtype=torch.float32, device=tid.device)
    for name, t in (("s_src", s_src), ("s_dst", s_dst), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"rgat_attention: {name} must start on a "
                             "16-byte boundary (the kernel moves a slot's "
                             "4 heads as one float4); pass a fresh tensor")
    if R == 0 or F == 0:
        return out
    lib = build.library("gat_attention")
    with torch.cuda.device(tid.device):
        err = lib.deal_rgat_attention(
            s_src.data_ptr(), s_dst.data_ptr(), tid.data_ptr(),
            rel.data_ptr(), mask.data_ptr(), out.data_ptr(), R, F, heads,
            n_rel, float(negative_slope), WARPS,
            torch.cuda.current_stream(tid.device).cuda_stream)
    build.check(err, "rgat_attention")
    rgat_attention.launches += 1
    return out


rgat_attention.launches = 0
