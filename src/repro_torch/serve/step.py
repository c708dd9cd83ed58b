"""prefill_step / serve_step — the inference entry points (twins of
``repro.serve.step``).

prefill: the full-sequence forward; returns the last position's logits
and the filled cache (never materializes (B, S, V)).  Its attention runs
on ``attn_backend`` ("cuda", the default: the flash kernel; "ref": the
plain version).
serve_step (decode): one new token per slot against the cache.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def prefill_step(cfg: ModelConfig, params, batch: Dict[str, Any], *,
                 attn_backend: str = "cuda"):
    """batch = {"tokens": (B, S) int}, and for audio (whisper) also
    "frames": (B, S_enc, frontend_dim), for vlm (llava-next) also
    "patches": (B, n_img, frontend_dim), projected before the tokens (the
    cache then covers n_img + S positions).  Returns (logits (B, 1, V) f32,
    the filled cache, ``transformer.init_cache``'s keys and shapes:
    dense {"k", "v"}: (L, B, S, K, hd); llama4 {"k", "v"}: (L / 2, 2, B,
    S, K, hd); deepseek-v2 MLA's latents; ssm {"ssm": SSMCache}; hybrid
    {"k", "v", "mamba", "tail"}; audio {"k", "v", "cross_k",
    "cross_v"})."""
    hidden, _, cache = transformer.forward(
        cfg, params, batch, mode="prefill", return_cache=True,
        return_hidden=True, attn_backend=attn_backend)
    return transformer.unembed(cfg, params, hidden[:, -1:]), cache


def serve_step(cfg: ModelConfig, params, cache, batch: Dict[str, Any], *,
               attn_backend: str = "cuda"):
    """batch = {"token": (B, 1) int, "pos": an int or (B,) ints}.
    ``attn_backend``: audio's cross-attention route (the other families'
    decode attention is plain PyTorch)."""
    return transformer.decode_step(cfg, params, cache, batch,
                                   attn_backend=attn_backend)
