"""``spmm``: fanout-gather SPMM, the layer-graph aggregation.

    out[i] = sum_f w[i,f] * mask[i,f] * h[nbr[i,f]]

with w (R, F), or (R, F, heads) weighing each head's block of columns.
Replaces the Pallas TPU kernel ``src/repro/kernels/spmm.py::spmm``
(``pallas_call`` at line 78) with the CUDA kernel in ``csrc/spmm.cu``,
which says what bounds it (bytes) and how it is laid out.  On a CUDA
tensor the wrapper launches the kernel or raises; on a CPU tensor it
returns the plain version, ``ref.spmm_ref`` (``ref.spmm_heads_ref``
for (R, F, heads) weights: per head, concatenated).  ``spmm.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

SOURCE = "src/repro_torch/kernels/csrc/spmm.cu"
REPLACES = "src/repro/kernels/spmm.py:78"

FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPES = {"h": tuple(FLOAT_CODES), "w": (torch.float32,),
           "nbr": (torch.int32,), "mask": (torch.bool,),
           "table": (torch.int32,)}


def check_shapes(h, nbr, mask, w=None):
    """h is (N, D); nbr and mask are (R, F); w, if given, is (R, F) or
    (R, F, heads) with heads dividing D."""
    if h.dim() != 2:
        raise ValueError(f"features must be (N, D), got {tuple(h.shape)}")
    if nbr.dim() != 2 or mask.shape != nbr.shape:
        raise ValueError(f"nbr and mask must both be (R, F); got "
                         f"{tuple(nbr.shape)} and {tuple(mask.shape)}")
    if w is None:
        return
    if w.dim() not in (2, 3) or w.shape[:2] != nbr.shape:
        raise ValueError(f"w must be (R, F) = {tuple(nbr.shape)} or (R, F, "
                         f"heads); got {tuple(w.shape)}")
    if w.dim() == 3 and (w.shape[2] < 1 or h.shape[1] % w.shape[2]):
        raise ValueError(f"w has heads={w.shape[2]}, which must divide "
                         f"D={h.shape[1]}")


def default_tiling(D: int, vec: int):
    """(block_rows, block_cols): block_cols threads over a row's
    vec-wide chunks (at most a warp), rows filling 64 threads -- on the
    card, at the main path's shapes, 64-thread blocks were a little
    faster than 256-thread ones (PERF.md)."""
    nvec = -(-D // vec)
    block_cols = 1
    while block_cols < min(nvec, 32):
        block_cols *= 2
    return max(64 // block_cols, 1), block_cols


def check_tiling(what, block_rows: int, block_cols: int) -> None:
    """Raise unless (block_rows, block_cols) is a tiling the kernel
    takes: at least one row and one chunk, at most 1024 threads a
    block.  The autotuner prunes its grid with this check."""
    if block_rows < 1 or block_cols < 1 or block_rows * block_cols > 1024:
        raise ValueError(f"{what}: tiling ({block_rows}, {block_cols}); "
                         "the kernel takes at most 1024 threads a block")


def launch_spmm(what, h, table, w, nbr, mask, block_rows, block_cols):
    """Launch ``deal_spmm`` (``table`` None for plain spmm) on the
    current stream of h's device.  Returns (out (R, D), launched)."""
    named = {"h": h, "w": w, "nbr": nbr, "mask": mask}
    if table is not None:
        named["table"] = table
    build.check_args(what, named, _DTYPES, strided=("w",))
    R, F = nbr.shape
    D = h.shape[1]
    heads = w.shape[2] if w.dim() == 3 else 1
    vec = 16 // h.element_size()          # 16-byte chunks where a head's
    if (D // heads) % vec:                # columns allow them, else one
        vec = 1
    rows, cols = default_tiling(D, vec)
    rows, cols = block_rows or rows, block_cols or cols
    check_tiling(what, rows, cols)
    out = torch.empty((R, D), dtype=h.dtype, device=h.device)
    if R == 0 or D == 0:
        return out, False
    strides = w.stride() if w.dim() == 3 else w.stride() + (0,)
    lib = build.library("spmm")
    with torch.cuda.device(h.device):
        err = lib.deal_spmm(
            h.data_ptr(), None if table is None else table.data_ptr(),
            w.data_ptr(), *strides, mask.data_ptr(), nbr.data_ptr(),
            out.data_ptr(), R, F, D, heads, FLOAT_CODES[h.dtype], rows,
            cols, torch.cuda.current_stream(h.device).cuda_stream)
    build.check(err, what)
    return out, True


def spmm(h, w, nbr, mask, *, block_rows=None, block_cols=None):
    """out[i] = sum_f w[i,f]*mask[i,f]*h[nbr[i,f]].

    h: (N, D) f32/bf16 source rows; mask (bool) and nbr (int32) are
    (R, F), with ids in [0, N).  w (f32, any strides) is (R, F), or
    (R, F, heads): head k's weights on h's k-th block of D / heads
    columns (GAT's attend, all heads in one launch).  Returns (R, D) in
    h's dtype.  ``block_rows``/``block_cols`` set the CUDA tiling, rows
    and chunks of a row a block (None: the default); the output is
    bitwise the same for every tiling."""
    check_shapes(h, nbr, mask, w)
    if h.device.type == "cpu":
        return ref.spmm_heads_ref(h, w, nbr, mask)
    if h.device.type != "cuda":
        raise ValueError(f"spmm: no kernel for device {h.device}")
    out, launched = launch_spmm("spmm", h, None, w, nbr, mask, block_rows,
                                block_cols)
    spmm.launches += launched
    return out


spmm.launches = 0
