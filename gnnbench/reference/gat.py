"""GAT (arXiv:1710.10903) with scaled dot-product scores, one layer, in
plain PyTorch f32, as the port declares it: per head k of width dh,

    q = h Wq, k = h Wk, v = h Wv
    alpha[i,f,k] = softmax over i's live slots f of <q_k[i], k_k[nbr[i,f]]> / sqrt(dh)
    h'[i]_k = sum_f alpha[i,f,k] v_k[nbr[i,f]]

ELU between layers, none after the last.  Heads are blocks of dh
columns, head-major.  Computed in blocks of rows so that it fits.
"""
from __future__ import annotations

import math

import torch

PARAMS = ("wq", "wk", "wv")
# what ``yardstick.epoch_flops`` counts a layer: a GEMM a param; the
# passes over the live slots (its scores and its attend, over its
# GEMMs' outputs)
GEMMS_PER_LAYER = 3
SLOT_PASSES_PER_LAYER = 2
SLOT_WIDTH = "out"
BLOCK_ROWS = 1 << 16


def activation(h):
    return torch.nn.functional.elu(h)


def layer(h, nbr, mask, p, heads, mm):
    q, k, v = mm(h, p["wq"]), mm(h, p["wk"]), mm(h, p["wv"])
    N, D = q.shape
    dh = D // heads
    kh, vh = k.reshape(-1, heads, dh), v.reshape(-1, heads, dh)
    out = torch.empty_like(q)
    for r0 in range(0, N, BLOCK_ROWS):
        r = slice(r0, min(r0 + BLOCK_ROWS, N))
        ids, m = nbr[r], mask[r][:, :, None]
        qh = q[r].reshape(-1, 1, heads, dh)
        s = (qh * kh[ids]).sum(dim=-1) / math.sqrt(dh)        # (b, F, heads)
        alpha = torch.softmax(torch.where(m, s, -1e30), dim=1) * m
        out[r] = (alpha[..., None] * vh[ids]).sum(dim=1).reshape(-1, D)
    return out
