"""The yardstick: the card's peaks, the operations and bytes of each
kernel call and of a whole epoch, computed from shapes, and the
comparison that decides ``correct``.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit
(dense): 67 TFLOP/s f32 outside the tensor cores, the precision the
port's f32 GEMMs run in with TF32 off, and 3.35 TB/s of HBM3.

What differs between models (each layer's widths, the GEMMs and passes
over the live slots a layer, or a model's own epoch FLOPs) is declared
by its reference module, ``reference/<model>.py``.

A kernel's bytes count each input byte it needs once and each output
byte once, what the layer graph's data needs: every mask byte, ``nbr``
and weight of the live slots, each distinct gathered row once and the
output (the arithmetic of the port's kernel table in ``PERF.md``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gnnbench import inputs, reference

PEAK_FLOPS_F32 = 67e12       # FLOP/s, f32 without the tensor cores
HBM_BYTES_PER_S = 3.35e12    # B/s


def layer_stats(nbr, mask) -> Dict[str, int]:
    """What a layer graph's data asks of its kernels: rows R, fanout F,
    live slots ``nnz``, distinct source rows of the live slots ``uniq``
    and rows with a live slot ``live_rows``.  ``nbr``/``mask`` are
    numpy or torch (counted on their device)."""
    nbr, mask = torch.as_tensor(nbr), torch.as_tensor(mask)
    R, F = nbr.shape
    return {"R": int(R), "F": int(F), "nnz": int(mask.sum()),
            "uniq": int(torch.unique(nbr[mask]).numel()),
            "live_rows": int(mask.any(dim=1).sum())}


def spmm_bytes(st: Dict[str, int], D: int, heads: int = 1,
               itemsize: int = 4) -> int:
    """``spmm``: every mask byte, nbr (int32) and f32 weight of each
    live slot (``heads`` weights a slot for GAT's attend), each distinct
    gathered row once, the (R, D) output."""
    return (st["R"] * st["F"] + st["nnz"] * (4 + 4 * heads)
            + st["uniq"] * D * itemsize + st["R"] * D * itemsize)


def gat_attention_bytes(st: Dict[str, int], D: int, heads: int,
                        itemsize: int = 4) -> int:
    """``gat_attention``: q of the rows with a live slot, each distinct
    k row once, every mask byte, nbr of the live slots, and the f32
    (R, F, heads) attention written."""
    return (st["live_rows"] * D * itemsize + st["uniq"] * D * itemsize
            + st["R"] * st["F"] + st["nnz"] * 4
            + st["R"] * st["F"] * heads * 4)


def kernel_flops(st: Dict[str, int], D: int) -> int:
    """A multiply and an add per live slot and column (spmm's weighted
    sum, gat_attention's dots)."""
    return 2 * st["nnz"] * D


def bound_s(bytes_: int, flops: int) -> float:
    """The least time the card could take: the larger of bytes over the
    HBM rate and operations over the f32 peak."""
    return max(bytes_ / HBM_BYTES_PER_S, flops / PEAK_FLOPS_F32)


def layer_widths(cfg: Dict) -> List[Tuple[int, int]]:
    """Each layer's (width in, width out) for configuration ``cfg``: its
    model's own (``reference/<model>.py`` ``layer_widths(cfg)``) where
    it declares them, else ``d_feature`` into the first and
    ``hidden_size`` out of each."""
    mod = reference.model(cfg["model"]) if "model" in cfg else None
    if hasattr(mod, "layer_widths"):
        return [(int(a), int(b)) for a, b in mod.layer_widths(cfg)]
    dims = inputs.layer_dims(cfg)
    return list(zip(dims[:-1], dims[1:]))


def slot_width(model: str, d_in: int, d_out: int) -> int:
    """The width of a layer's passes over its live slots, as the model's
    reference declares it (``SLOT_WIDTH``): ``"in"`` where it aggregates
    its input before its GEMMs (sage), ``"out"`` where it scores and
    attends over their outputs (gat)."""
    return {"in": d_in, "out": d_out}[reference.model(model).SLOT_WIDTH]


def epoch_flops(model: str, n_nodes: int, widths, stats,
                cfg: Optional[Dict] = None) -> int:
    """The model FLOPs of one all-node epoch.  A model's reference that
    defines ``epoch_flops(cfg, n_nodes, widths, stats)`` gives its own;
    for the others, per layer of ``widths`` (d_in, d_out), each of its
    ``GEMMS_PER_LAYER`` (N, d_in) x (d_in, d_out) GEMMs 2 N d_in d_out,
    and each of its ``SLOT_PASSES_PER_LAYER`` passes over the live slots
    2 nnz d at its ``slot_width``."""
    mod = reference.model(model)
    if hasattr(mod, "epoch_flops"):
        return int(mod.epoch_flops(cfg, n_nodes, widths, stats))
    return sum(mod.GEMMS_PER_LAYER * 2 * n_nodes * di * do
               + mod.SLOT_PASSES_PER_LAYER * 2 * st["nnz"]
               * slot_width(model, di, do)
               for (di, do), st in zip(widths, stats))


# ----------------------------------------------------------------------
# the comparison that decides ``correct``
# ----------------------------------------------------------------------

BLOCK_ROWS = 1 << 18


def errors(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """``rel_l2``: ||got - want|| / ||want|| over every element;
    ``max_err``: the largest |got - want| over the rms of ``want``.
    Both are inf where ``got`` has a non-finite value or the wrong
    shape."""
    if tuple(got.shape) != tuple(want.shape):
        return {"rel_l2": float("inf"), "max_err": float("inf")}
    diff2 = want2 = 0.0
    worst = 0.0
    finite = True
    for r0 in range(0, want.shape[0], BLOCK_ROWS):
        g = got[r0:r0 + BLOCK_ROWS].to(want.device, torch.float32)
        w = want[r0:r0 + BLOCK_ROWS].to(torch.float64)
        finite &= bool(torch.isfinite(g).all())
        d = g.to(torch.float64) - w
        diff2 += float((d * d).sum())
        want2 += float((w * w).sum())
        worst = max(worst, float(d.abs().max()))
    if not finite:
        return {"rel_l2": float("inf"), "max_err": float("inf")}
    rms = np.sqrt(want2 / max(want.numel(), 1))
    return {"rel_l2": float(np.sqrt(diff2 / max(want2, 1e-300))),
            "max_err": float(worst / max(rms, 1e-300))}


def judge(errs: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every compared number at or under its limit;
    ``checks`` maps each name to its number and its limit."""
    checks = {name: {"value": errs[name], "limit": float(lim)}
              for name, lim in limits.items()}
    ok = bool(limits) and all(c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks
