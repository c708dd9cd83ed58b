"""Plain PyTorch versions of the kernels — twins of ``repro.kernels.ref``.

Each is the function its CUDA kernel computes, written with tensor ops:
the wrappers call it for CPU tensors, ``RefExecutor`` runs on it, and
``chip_smoke.py`` holds each kernel against it on the card.  Indexing
in torch needs int64, so the int32 ids are widened here; the kernels
read them as int32.
"""
from __future__ import annotations

import torch


def gemm_ref(h, w):
    """out = h @ w, accumulated in f32, cast back to h.dtype."""
    return torch.matmul(h.float(), w.float()).to(h.dtype)


def spmm_ref(h, w, nbr, mask):
    """out[i] = sum_f w[i,f] * mask[i,f] * h[nbr[i,f]].  h:(N,D) nbr:(R,F)."""
    vals = h[nbr.reshape(-1).long()].float()
    vals = vals.reshape(nbr.shape + (h.shape[-1],))
    coef = (w * mask).float()[..., None]
    return (vals * coef).sum(dim=1).to(h.dtype)


def sddmm_ref(q, k, nbr, mask):
    """e[i,f] = <q[i], k[nbr[i,f]]> * mask[i,f].  q:(R,D) k:(U,D)."""
    vals = k[nbr.reshape(-1).long()].reshape(
        nbr.shape + (k.shape[-1],)).float()
    out = (q[:, None, :].float() * vals).sum(-1)
    return (out * mask).float()


def gather_spmm_ref(h, table, w, nbr, mask):
    """out[i] = sum_f w[i,f] * mask[i,f] * h[table[nbr[i,f]]] — resolving
    the ids and calling ``spmm_ref`` (masked slots may map anywhere in
    range: their coefficient is exactly 0.0)."""
    idx = table.long()[nbr.reshape(-1).long()].reshape(nbr.shape)
    return spmm_ref(h, w, idx, mask)


def gat_attention_ref(q, k, nbr, mask, heads: int):
    """Per-head scaled dot scores + masked edge softmax over the fanout:
    alpha (R, F, heads) f32, with the same -1e30 fill as
    ``core.gnn_models.masked_softmax``."""
    N, D = q.shape
    dh = D // heads
    qh = q.reshape(N, heads, dh).float()
    kh = k.reshape(-1, heads, dh).float()
    kn = kh[nbr.reshape(-1).long()].reshape(nbr.shape + (heads, dh))
    s = torch.einsum("nhd,nfhd->nfh", qh, kn) / torch.sqrt(
        torch.tensor(float(dh), dtype=torch.float32, device=q.device))
    m = mask[:, :, None]
    p = torch.softmax(torch.where(m, s, -1e30), dim=1)
    return p * m
