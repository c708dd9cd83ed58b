"""``gat_attention``: per-head scaled dot scores and the masked edge
softmax over the fanout in one pass (GAT attention).

    alpha[i,f,h] = softmax_f(<q_h[i], k_h[nbr[i,f]]> / sqrt(dh))

Masked slots are filled with -1e30 before the softmax and zeroed after
it.  Replaces the Pallas TPU kernel
``src/repro/kernels/gat_attention.py::gat_attention`` (``pallas_call``
at line 70) with the kernel in ``csrc/gat_attention.cu``.  On a CPU
tensor the wrapper returns the plain version,
``ref.gat_attention_ref``.  ``gat_attention.launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.spmm import FLOAT_CODES, check_shapes

SOURCE = "src/repro_torch/kernels/csrc/gat_attention.cu"
REPLACES = "src/repro/kernels/gat_attention.py:70"

WARPS = 8                          # rows (one warp each) per block
_SMEM_MAX = 48 * 1024              # static launch limit, no opt-in
_DTYPES = {"q": tuple(FLOAT_CODES), "k": tuple(FLOAT_CODES),
           "nbr": (torch.int32,), "mask": (torch.bool,)}


def check_qk(q, k, nbr, mask):
    check_shapes(q, nbr, mask)
    if k.dim() != 2 or k.shape[1] != q.shape[1]:
        raise ValueError(f"k must be (U, {q.shape[1]}), got "
                         f"{tuple(k.shape)}")
    if nbr.shape[0] != q.shape[0]:
        raise ValueError(f"nbr has {nbr.shape[0]} rows, q {q.shape[0]}")


def launch_rows(what, fn, q, k, nbr, mask, out, heads, extra):
    """Launch one of the warp-per-row kernels of gat_attention.cu on the
    current stream; ``extra`` are the arguments between D and dtype."""
    build.check_args(what, {"q": q, "k": k, "nbr": nbr, "mask": mask},
                     _DTYPES)
    if k.dtype != q.dtype:
        raise TypeError(f"{what}: q is {q.dtype} but k is {k.dtype}")
    N, F = nbr.shape
    D = q.shape[1]
    if N == 0:
        return False
    if WARPS * (D + F * heads) * 4 > _SMEM_MAX:
        raise ValueError(f"{what}: D={D}, F={F}, heads={heads} need more "
                         "than 48 KB of shared memory per block")
    lib = build.library("gat_attention")
    with torch.cuda.device(q.device):
        err = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
            out.data_ptr(), N, F, D, *extra, FLOAT_CODES[q.dtype], WARPS,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, what)
    return True


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
    launched = launch_rows("gat_attention", "deal_gat_attention", q, k,
                           nbr, mask, out, heads, (heads,))
    gat_attention.launches += launched
    return out


gat_attention.launches = 0
