"""``mean_weights``: the mean-aggregation edge weights of a fanout mask,

    w[r, f] = mask[r, f] / max(sum_f mask[r, f], 1)          (R, F) f32,

bitwise what numpy's ``core.gnn_models.mean_weights`` gives.  Replaces no
TPU kernel: it replaces that numpy function on the binding's path, so
the weights are built on the card that holds the mask instead of on the
host and copied there.  The CUDA kernel is ``mean_weights_kernel`` in
``csrc/spmm.cu`` (the ``spmm`` library), which says what bounds it
(bytes) and how it is laid out.  On a CUDA tensor the wrapper launches
it or raises; on a CPU tensor it returns the plain version,
``ref.mean_weights_ref``.  ``mean_weights.launches`` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

TILE_SLOTS = 8192      # mask bytes a block aims to take
MAX_FANOUT = 8192      # a tile of 4 rows and its floats fit 48 KiB


def tile_rows(F: int) -> int:
    """Rows a block takes, holding about ``TILE_SLOTS`` slots: a multiple
    of 16, so that every tile's mask bytes start 16-byte aligned (its
    16-byte loads) whatever F is; at fanouts above TILE_SLOTS / 16, a
    multiple of 4, at least 4, so that each tile's output starts 16-byte
    aligned."""
    rows = TILE_SLOTS // F
    return rows // 16 * 16 if rows >= 16 else max(4, rows // 4 * 4)


def mean_weights(mask):
    """The (R, F) f32 mean weights of a bool (R, F) mask, on its
    device."""
    if mask.dim() != 2:
        raise ValueError(f"mask must be (R, F), got {tuple(mask.shape)}")
    if mask.device.type == "cpu":
        return ref.mean_weights_ref(mask)
    if mask.device.type != "cuda":
        raise ValueError(f"mean_weights: no kernel for device {mask.device}")
    build.check_args("mean_weights", {"mask": mask}, {"mask": (torch.bool,)})
    R, F = mask.shape
    if F > MAX_FANOUT:
        raise ValueError(f"mean_weights: fanout {F} above the kernel's "
                         f"{MAX_FANOUT}")
    out = torch.empty((R, F), dtype=torch.float32, device=mask.device)
    if R == 0 or F == 0:
        return out
    lib = build.library("spmm")
    with torch.cuda.device(mask.device):
        err = lib.deal_mean_weights(
            mask.data_ptr(), out.data_ptr(), R, F, tile_rows(F),
            torch.cuda.current_stream(mask.device).cuda_stream)
    build.check(err, "mean_weights")
    mean_weights.launches += 1
    return out


mean_weights.launches = 0
