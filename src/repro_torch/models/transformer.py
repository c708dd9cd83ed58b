"""The dense decoder family — the twin of ``repro.models.transformer`` for
``family == "dense"`` (smollm-360m, granite-8b, qwen2.5-14b, gemma3-4b).

Parameters are ``nn.Module`` containers whose attributes carry the JAX
tree's names (``params.blocks[l].attn.wq``), with weights stored as
(d_in, d_out) so that a projection is ``x @ w``.  JAX stacks the blocks
along a leading layer axis and scans over them; here ``blocks`` is a
``ModuleList`` and the stack is a Python loop.  Every function takes the
same arguments as its JAX twin; the prefill adds ``attn_backend`` (see
``models.attention.flash_attention``).

  init_params(cfg, seed, device=)            weights from a torch.Generator
  params_from_numpy(cfg, tree, device=)      the JAX params, as numpy arrays
  forward(cfg, params, batch, mode="prefill", return_cache, return_hidden)
  decode_step(cfg, params, cache, batch)     one token per slot, in place
  init_cache(cfg, batch, seq, device=)

The other families raise ``NotImplementedError`` naming the ROADMAP.md
item that ports them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ops import resolve_device
from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.layers import (apply_rope, embed_tokens, rms_norm,
                                       rope, rope_angles, swiglu_mlp)

_BIG_WINDOW = 1 << 30
# ROADMAP.md Queue 1 items that port the other families
_PORTED_BY = {"moe": 10, "ssm": 12, "hybrid": 13, "audio": 14, "vlm": 15}


def require_dense(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is of the one family ported so far."""
    if cfg.family == "dense" and cfg.mla is None:
        return
    item = 11 if cfg.mla is not None else _PORTED_BY.get(cfg.family)
    raise NotImplementedError(
        f"{cfg.arch_id}: the {cfg.family!r} family is not ported to "
        f"repro_torch yet (ROADMAP.md Queue 1 item {item})")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


# ======================================================================
# layer metadata (static per config)
# ======================================================================

def layer_meta(cfg: ModelConfig) -> Tuple[List[int], List[float]]:
    """Per-layer window and rope theta of the dense stack."""
    windows, thetas = [], []
    for l in range(cfg.n_layers):
        is_global = (cfg.global_interval == 0
                     or (l + 1) % cfg.global_interval == 0)
        if cfg.sliding_window is not None and not is_global:
            windows.append(cfg.sliding_window)
            thetas.append(10_000.0)          # gemma3: local layers use 10k
        else:
            windows.append(_BIG_WINDOW)
            thetas.append(cfg.rope_theta)
    return windows, thetas


# ======================================================================
# parameters
# ======================================================================

def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Attention(nn.Module):
    """wq (D, H*hd), wk and wv (D, K*hd), wo (H*hd, D); bq, bk, bv when
    ``cfg.qkv_bias``."""

    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(_param, (wq, wk, wv, wo))
        self.bq, self.bk, self.bv = (None if b is None else _param(b)
                                     for b in (bq, bk, bv))


class SwiGLU(nn.Module):
    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = map(_param,
                                                  (w_gate, w_up, w_down))


class DenseBlock(nn.Module):
    def __init__(self, pre_attn_norm, attn: Attention, pre_mlp_norm,
                 mlp: SwiGLU):
        super().__init__()
        self.pre_attn_norm = _param(pre_attn_norm)
        self.attn = attn
        self.pre_mlp_norm = _param(pre_mlp_norm)
        self.mlp = mlp


class DenseLM(nn.Module):
    """embed (V, D), final_norm (D,), lm_head (D, V) unless tied, and
    ``blocks``, one ``DenseBlock`` per layer."""

    def __init__(self, embed, final_norm, blocks: List[DenseBlock],
                 lm_head=None):
        super().__init__()
        self.embed = _param(embed)
        self.final_norm = _param(final_norm)
        self.lm_head = None if lm_head is None else _param(lm_head)
        self.blocks = nn.ModuleList(blocks)


def _normal(gen, shape, dtype):
    """normal(0.02), as ``jax.nn.initializers.normal(0.02)``."""
    return (torch.randn(shape, generator=gen, device=gen.device) * 0.02).to(
        dtype)


def _init_attn(gen, cfg: ModelConfig, dtype) -> Attention:
    D, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    w = [_normal(gen, s, dtype) for s in ((D, H * hd), (D, K * hd),
                                          (D, K * hd), (H * hd, D))]
    b = [None] * 3
    if cfg.qkv_bias:
        b = [torch.zeros(n, dtype=dtype, device=gen.device)
             for n in (H * hd, K * hd, K * hd)]
    return Attention(*w, *b)


def _init_mlp(gen, cfg: ModelConfig, dtype, d_ff=None) -> SwiGLU:
    D, F = cfg.d_model, d_ff or cfg.d_ff
    return SwiGLU(*(_normal(gen, s, dtype) for s in ((D, F), (D, F),
                                                      (F, D))))


def _init_dense_block(gen, cfg: ModelConfig, dtype) -> DenseBlock:
    zeros = torch.zeros(cfg.d_model, dtype=dtype, device=gen.device)
    return DenseBlock(zeros, _init_attn(gen, cfg, dtype), zeros.clone(),
                      _init_mlp(gen, cfg, dtype))


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> DenseLM:
    """Random weights in ``cfg.dtype`` from a ``torch.Generator`` on
    ``device`` seeded with ``seed``: normal(0.02) projections and
    embeddings, zero norm scales and biases, as the JAX package draws
    them (its numbers differ: ``jax.random`` is another generator).
    ``"cuda"`` raises when no card is visible."""
    require_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = torch_dtype(cfg)
    embed = _normal(gen, (cfg.vocab_size, cfg.d_model), dtype)
    lm_head = (None if cfg.tie_embeddings else
               _normal(gen, (cfg.d_model, cfg.vocab_size), dtype))
    blocks = [_init_dense_block(gen, cfg, dtype)
              for _ in range(cfg.n_layers)]
    return DenseLM(embed, torch.zeros(cfg.d_model, dtype=dtype, device=dev),
                   blocks, lm_head)


def _from_numpy(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def params_from_numpy(cfg: ModelConfig, tree: Dict, *,
                      device="cuda") -> DenseLM:
    """The JAX package's params tree, as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), as the port's modules on
    ``device``.  JAX stacks the blocks along a leading layer axis; this
    takes layer l of every leaf for ``blocks[l]``.  Raises if the tree
    does not have the config's shape."""
    require_dense(cfg)
    dev = resolve_device(device)
    top = {"embed", "final_norm", "blocks"} | (
        set() if cfg.tie_embeddings else {"lm_head"})
    attn_keys = {"wq", "wk", "wv", "wo"} | (
        {"bq", "bk", "bv"} if cfg.qkv_bias else set())
    b = tree.get("blocks", {})
    if (set(tree) != top
            or set(b) != {"pre_attn_norm", "attn", "pre_mlp_norm", "mlp"}
            or set(b["attn"]) != attn_keys
            or set(b["mlp"]) != {"w_gate", "w_up", "w_down"}):
        raise ValueError(f"{cfg.arch_id}: params tree does not have the "
                         "dense family's keys")
    L = np.asarray(b["pre_attn_norm"]).shape[0]
    if L != cfg.n_layers:
        raise ValueError(f"{cfg.arch_id}: params stack {L} layers, the "
                         f"config {cfg.n_layers}")

    def t(a, l):
        return _from_numpy(np.asarray(a)[l], dev)

    blocks = []
    for l in range(L):
        attn = Attention(**{k: t(v, l) for k, v in b["attn"].items()})
        mlp = SwiGLU(**{k: t(v, l) for k, v in b["mlp"].items()})
        blocks.append(DenseBlock(t(b["pre_attn_norm"], l), attn,
                                 t(b["pre_mlp_norm"], l), mlp))
    lm_head = (None if cfg.tie_embeddings
               else _from_numpy(tree["lm_head"], dev))
    return DenseLM(_from_numpy(tree["embed"], dev),
                   _from_numpy(tree["final_norm"], dev), blocks, lm_head)


# ======================================================================
# attention sub-blocks
# ======================================================================

def _qkv(x, p: Attention, cfg: ModelConfig):
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (q.reshape(B, S, cfg.n_heads, hd),
            k.reshape(B, S, cfg.n_kv_heads, hd),
            v.reshape(B, S, cfg.n_kv_heads, hd))


def _gqa_full(x, p: Attention, cfg: ModelConfig, rot, window,
              causal: bool = True, backend: str = "cuda"):
    """Full-sequence GQA attention (prefill).  ``rot`` is the layer's
    rope (cos, sin) from ``rope_angles``, or None.  Returns (out, k, v)."""
    q, k, v = _qkv(x, p, cfg)
    if rot is not None:
        q = apply_rope(q, *rot)
        k = apply_rope(k, *rot)
    o = flash_attention(q, k, v, causal=causal, window=window,
                        backend=backend)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ p.wo, k, v


def _update_cache(cache, new, pos):
    """Write ``new`` (B, 1, ...) into ``cache`` (B, S, ...) at each
    sequence's ``pos`` (an int or a (B,) tensor), in place, and return
    the cache.  The start is clamped into [0, S - 1], as
    ``lax.dynamic_update_slice`` clamps it: a pos >= S rewrites the last
    entry (torch indexing would raise instead)."""
    B, S = cache.shape[:2]
    pos = torch.as_tensor(pos, device=cache.device).long()
    pos = pos.broadcast_to((B,)).clamp(0, S - 1)
    cache[torch.arange(B, device=cache.device), pos] = new[:, 0].to(
        cache.dtype)
    return cache


def _gqa_decode(x, p: Attention, cfg: ModelConfig, pos, theta, window, kc,
                vc):
    """One-token GQA decode; writes (kc, vc) in place at per-sequence
    ``pos`` (an int or a (B,) tensor: continuous-batching slots may
    differ)."""
    q, k, v = _qkv(x, p, cfg)
    B = x.shape[0]
    pos_vec = torch.as_tensor(pos, device=x.device).long().broadcast_to(
        (B,))
    if theta is not None:
        q = rope(q, pos_vec[:, None], theta)
        k = rope(k, pos_vec[:, None], theta)
    kc = _update_cache(kc, k, pos_vec)
    vc = _update_cache(vc, v, pos_vec)
    o = decode_attention(q, kc, vc, cache_len=pos_vec + 1, window=window)
    return o.reshape(B, 1, -1) @ p.wo, kc, vc


# ======================================================================
# forward (prefill)
# ======================================================================

def forward(cfg: ModelConfig, params: DenseLM, batch: Dict, *,
            mode: str = "prefill", return_cache: bool = False,
            return_hidden: bool = False, attn_backend: str = "cuda"):
    """Returns (logits_or_hidden, aux_loss[, cache]).  batch =
    {"tokens": (B, S) int}.  ``return_hidden=True`` skips the
    unembedding and returns the final-norm hidden states; the cache is
    {"k", "v"}: (L, B, S, K, hd)."""
    require_dense(cfg)
    if mode != "prefill":
        raise NotImplementedError(
            f"forward mode {mode!r}: training is not ported to repro_torch "
            "yet (ROADMAP.md Queue 1 item 16)")
    x, positions = _embed_inputs(cfg, params, batch)
    x, aux, cache = _dense_stack(cfg, params, x, positions, return_cache,
                                 attn_backend)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    out = x if return_hidden else unembed(cfg, params, x)
    if return_cache:
        return out, aux, cache
    return out, aux


def unembed(cfg: ModelConfig, params: DenseLM, x):
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return (x @ head).float()


def _embed_scale(cfg: ModelConfig) -> Optional[float]:
    return cfg.d_model ** 0.5 if cfg.arch_id.startswith("gemma") else None


def _embed_inputs(cfg: ModelConfig, params: DenseLM, batch: Dict):
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device)
    x = embed_tokens(params.embed, tokens, _embed_scale(cfg))
    return x, torch.arange(x.shape[1], device=x.device)


def _dense_stack(cfg: ModelConfig, params: DenseLM, x, positions,
                 return_cache: bool, attn_backend: str):
    windows, thetas = layer_meta(cfg)
    cache = None
    if return_cache:
        B, S = x.shape[:2]
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache = {"k": torch.empty(shape, dtype=x.dtype, device=x.device),
                 "v": torch.empty(shape, dtype=x.dtype, device=x.device)}
    # one rope table per theta for the whole stack: the prefill is bound
    # by the host's operator launches once attention is on the tensor cores
    rots = {t: rope_angles(positions, t, cfg.resolved_head_dim)
            for t in set(thetas) if t is not None}
    h = x
    for l, (p, window, theta) in enumerate(zip(params.blocks, windows,
                                               thetas)):
        a, k, v = _gqa_full(rms_norm(h, p.pre_attn_norm, cfg.norm_eps),
                            p.attn, cfg, rots.get(theta), window,
                            backend=attn_backend)
        h = h + a
        h = h + swiglu_mlp(rms_norm(h, p.pre_mlp_norm, cfg.norm_eps),
                           p.mlp.w_gate, p.mlp.w_up, p.mlp.w_down)
        if return_cache:
            cache["k"][l] = k
            cache["v"][l] = v
    return h, torch.zeros((), device=x.device), cache


# ======================================================================
# KV cache and the decode step
# ======================================================================

def init_cache(cfg: ModelConfig, batch: int, seq: int, *, device="cuda"):
    """Zeroed {"k", "v"}: (L, batch, seq, K, hd) in ``cfg.dtype``."""
    require_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=torch_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=torch_dtype(cfg), device=dev)}


def decode_step(cfg: ModelConfig, params: DenseLM, cache: Dict, batch: Dict):
    """batch = {"token": (B, 1) int, "pos": an int or (B,) ints}.

    Returns (logits (B, 1, V) f32, cache).  Unlike JAX, which returns a
    new cache, the step writes each layer's new entries into ``cache``
    in place (saving a copy of the whole cache per token) and returns
    the same dict."""
    require_dense(cfg)
    dev = params.embed.device
    token = torch.as_tensor(batch["token"], device=dev)
    pos = torch.as_tensor(batch["pos"], device=dev)
    x = embed_tokens(params.embed, token, _embed_scale(cfg))
    windows, thetas = layer_meta(cfg)
    for l, (p, window, theta) in enumerate(zip(params.blocks, windows,
                                               thetas)):
        a, _, _ = _gqa_decode(rms_norm(x, p.pre_attn_norm, cfg.norm_eps),
                              p.attn, cfg, pos, theta, window,
                              cache["k"][l], cache["v"][l])
        x = x + a
        x = x + swiglu_mlp(rms_norm(x, p.pre_mlp_norm, cfg.norm_eps),
                           p.mlp.w_gate, p.mlp.w_up, p.mlp.w_down)
    x = _final_norm_decode(cfg, params, x)
    return unembed(cfg, params, x), cache


def _final_norm_decode(cfg: ModelConfig, params: DenseLM, x):
    return rms_norm(x, params.final_norm, cfg.norm_eps)
