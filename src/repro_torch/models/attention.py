"""GQA attention for prefill and decode — twins of
``repro.models.attention``.

- ``simple_attention``: unchunked GQA attention in f32, the plain
  version (``kernels.ref.gqa_attention_ref``).
- ``flash_attention``: the counterpart of ``flash_attention_jnp``, with its
  (B, S, H, hd) / (B, S, K, hd) layout and its ``q_offset``, ``causal``,
  ``window`` and ``scale``.  ``backend`` names the executor, as the GNN
  executors are named: ``"cuda"`` calls the hand-written kernel's wrapper
  (``kernels.flash_attention.flash_attention_gqa``: the kernel for CUDA
  tensors, the plain version for CPU ones), ``"ref"`` the plain version
  on any device.  It is the caller's choice, never a fallback.
- ``decode_attention``: one new token against a (B, S, K, hd) cache with
  a per-slot ``cache_len``, in plain PyTorch (JAX computes it with
  ``jnp`` outside any kernel).

MLA (``mla_prefill``, ``mla_decode``) and the sequence-parallel
``cp_decode_attention`` are ROADMAP.md Queue 1 items 11 and 17.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref

BACKENDS = ("cuda", "ref")
_NEG_INF = -1e30

simple_attention = ref.gqa_attention_ref


def flash_attention(q, k, v, *, q_offset: int = 0, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None, backend: str = "cuda"):
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) with H % K == 0.  Returns
    (B, Sq, H, hd) in q's dtype."""
    if backend == "cuda":
        return _flash.flash_attention_gqa(q, k, v, q_offset=q_offset,
                                          causal=causal, window=window,
                                          scale=scale)
    if backend == "ref":
        return simple_attention(q, k, v, q_offset=q_offset, causal=causal,
                                window=window, scale=scale)
    raise ValueError(f"unknown attention backend {backend!r}; choose one "
                     f"of {BACKENDS}")


def decode_attention(q, k_cache, v_cache, *, cache_len,
                     window: Optional[int] = None,
                     scale: Optional[float] = None):
    """One-token GQA decode.  q: (B, 1, H, hd); caches (B, S, K, hd).
    ``cache_len``: valid entries per sequence, an int or a (B,) tensor
    (continuous batching: slots at different lengths); the new token
    sits at cache_len - 1."""
    B, Sq, H, hd = q.shape
    if Sq != 1:
        raise ValueError(f"decode_attention takes one token, got {Sq}")
    S, K = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q.reshape(B, K, H // K, hd).float() * scale
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    kv_pos = torch.arange(S, device=q.device)
    clen = torch.as_tensor(cache_len, device=q.device).broadcast_to(
        (B,))[:, None]
    msk = kv_pos[None, :] < clen
    if window is not None:
        msk &= (clen - 1 - kv_pos[None, :]) < window
    p = torch.softmax(torch.where(msk[:, None, None, :], s, _NEG_INF),
                      dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)
