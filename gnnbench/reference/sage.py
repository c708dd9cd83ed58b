"""GraphSAGE-mean (arXiv:1706.02216), one layer, in plain PyTorch f32:

    h'[i] = h[i] W_self + (mean over i's live sampled slots of h[nbr]) W_nbr

ReLU between layers, none after the last.  The mean's weight of a live
slot is 1 / (its row's live slots), summed in slot order.
"""
from __future__ import annotations

import torch

PARAMS = ("w_self", "w_nbr")
# what ``yardstick.epoch_flops`` counts a layer: a GEMM a param; the
# passes over the live slots (its aggregation, at the width of its
# input, before its GEMMs)
GEMMS_PER_LAYER = 2
SLOT_PASSES_PER_LAYER = 1
SLOT_WIDTH = "in"


def activation(h):
    return torch.relu(h)


def mean_weights(mask):
    """(N, F) f32: 1 / live slots of the row on a live slot, else 0."""
    deg = mask.sum(dim=1, keepdim=True).clamp(min=1)
    return mask.to(torch.float32) / deg.to(torch.float32)


def layer(h, nbr, mask, p, heads, mm):
    w = mean_weights(mask)
    agg = torch.zeros_like(h)
    for f in range(nbr.shape[1]):
        agg += w[:, f, None] * h[nbr[:, f]]
    return mm(h, p["w_self"]) + mm(agg, p["w_nbr"])
