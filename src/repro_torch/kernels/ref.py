"""Plain PyTorch versions of the kernels — twins of ``repro.kernels.ref``.

Each is the function its CUDA kernel computes, written with tensor ops:
the wrappers call it for CPU tensors, ``RefExecutor`` runs on it, and
``chip_smoke.py`` holds each kernel against it on the card.  Indexing
in torch needs int64, so the int32 ids are widened here; the kernels
read them as int32.
"""
from __future__ import annotations

import math

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


def mean_weights_ref(mask):
    """w[r, f] = mask[r, f] / max(live slots of row r, 1), (R, F) f32:
    numpy's ``core.gnn_models.mean_weights``, dividing in f64 and
    rounding to f32, so the bits are numpy's."""
    deg = mask.sum(dim=1, keepdim=True).clamp_(min=1)
    return (mask / deg.double()).float()


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


def spmm_heads_ref(h, w, nbr, mask):
    """``spmm_ref`` with w (R, F), or (R, F, heads): head k's weights
    w[..., k] on h's k-th block of D / heads columns, the blocks
    concatenated -- what one spmm per head computes in GAT's attend."""
    if w.dim() == 2:
        return spmm_ref(h, w, nbr, mask)
    dh = h.shape[1] // w.shape[2]
    return torch.cat([spmm_ref(h[:, k * dh:(k + 1) * dh], w[..., k], nbr,
                               mask) for k in range(w.shape[2])], dim=1)


def gather_spmm_heads_ref(h, table, w, nbr, mask):
    """``gather_spmm_ref`` with w (R, F) or (R, F, heads), as
    ``spmm_heads_ref``."""
    idx = table.long()[nbr.reshape(-1).long()].reshape(nbr.shape)
    return spmm_heads_ref(h, w, idx, mask)


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


def rgat_attention_ref(s_src, s_dst, tid, rel, mask,
                       negative_slope: float = 0.2):
    """R-GAT's relation-wise attention: for slot f of row i, of relation
    g = rel[i, f] (-1: none) and head h,
    e = LeakyReLU(s_src[tid[i, f], h] + s_dst[i, g, h]) and alpha[i, f, h]
    the softmax of e over i's live slots of relation g, 0 on a masked slot
    or one of no relation: (R, F, heads) f32.  s_src (U, heads), s_dst
    (R, n_rel, heads)."""
    R, F = tid.shape
    n_rel, heads = s_dst.shape[1], s_dst.shape[2]
    g = rel.long()
    live = mask & (g >= 0) & (g < n_rel)
    gi = torch.where(live, g, 0)
    ti = torch.where(live, tid.long(), 0)
    e = s_src.float()[ti.reshape(-1)].reshape(R, F, heads) + torch.gather(
        s_dst.float(), 1, gi[..., None].expand(R, F, heads))
    e = torch.nn.functional.leaky_relu(e, negative_slope)
    alpha = torch.zeros((R, F, heads), dtype=torch.float32,
                        device=e.device)
    for k in range(n_rel):
        m = (live & (gi == k))[..., None]
        p = torch.softmax(torch.where(m, e, -1e30), dim=1)
        alpha = torch.where(m, p, alpha)
    return alpha


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q: (BH, Sq, hd); k, v: (BH, Skv, hd).  Plain softmax attention in
    f32 (scores scaled by 1/sqrt(hd), -1e30 above the diagonal when
    ``causal``), cast back to q.dtype."""
    Sq, hd = q.shape[1], q.shape[2]
    s = torch.einsum("bqd,bsd->bqs", q.float(), k.float()) * (
        1.0 / math.sqrt(hd))
    if causal:
        pos = torch.arange(k.shape[1], device=q.device)
        m = pos[None, :] <= torch.arange(Sq, device=q.device)[:, None]
        s = torch.where(m[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqs,bsd->bqd", p, v.float()).to(q.dtype)


def gqa_attention_ref(q, k, v, *, q_offset: int = 0, causal: bool = True,
                      window=None, kv_valid_len=None, scale=None):
    """Unchunked GQA attention in f32, the plain version of the flash
    kernel's GQA signature (``repro.models.attention.simple_attention``).
    q: (B, Sq, H, hd); k, v: (B, Skv, K, hd), query head h reading kv
    head h // (H // K).  Masked scores are -1e30, so a row with no live
    key gets the uniform mean of v."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q.reshape(B, Sq, K, H // K, hd).float() * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Skv, device=q.device)
    m = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        m &= kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= (q_pos[:, None] - kv_pos[None, :]) < window
    if kv_valid_len is not None:
        m &= (kv_pos < kv_valid_len)[None, :]
    p = torch.softmax(torch.where(m, s, -1e30), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)
