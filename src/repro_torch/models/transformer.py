"""The decoder families ported so far — the twin of
``repro.models.transformer`` for ``family == "dense"`` (smollm-360m,
granite-8b, qwen2.5-14b, gemma3-4b) and ``family == "moe"`` in both of
its layouts:

- deepseek-v2-236b: MLA attention in every layer, ``first_blocks`` (the
  dense-first layers, a SwiGLU MLP) then ``blocks`` (an MoE each); its
  cache is MLA's latents, {"first_c_kv", "first_k_rope", "c_kv",
  "k_rope"}: (layers, B, S, kv_lora) and (layers, B, S, rope);
- llama4-maverick-400b-a17b: GQA attention, ``super_blocks`` of (a dense
  layer, an MoE layer); its cache {"k", "v"} is (L / 2, 2, B, S, K, hd).

Parameters are ``nn.Module`` containers whose attributes carry the JAX
tree's names (``params.blocks[l].attn.wq``), with weights stored as
(d_in, d_out) so that a projection is ``x @ w``.  JAX stacks the blocks
along a leading layer axis and scans over them; here each stack is a
``ModuleList`` and the scan a Python loop.  Every function takes the
same arguments as its JAX twin; the prefill adds ``attn_backend`` (see
``models.attention.flash_attention``).

  init_params(cfg, seed, device=)            weights from a torch.Generator
  params_from_numpy(cfg, tree, device=)      the JAX params, as numpy arrays
  forward(cfg, params, batch, mode="prefill", return_cache, return_hidden)
  decode_step(cfg, params, cache, batch)     one token per slot, in place
  init_cache(cfg, batch, seq, device=)

The other families raise ``NotImplementedError`` naming the ROADMAP.md
item that ports them.  Training (``mode="train"``) is item 16.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ops import resolve_device
from repro_torch.models.attention import (decode_attention, flash_attention,
                                          mla_decode, mla_new_cache_entries,
                                          mla_prefill)
from repro_torch.models.layers import (apply_rope, embed_tokens, rms_norm,
                                       rope, rope_angles, swiglu_mlp)
from repro_torch.models.moe import MoE, init_moe_params, moe_block

_BIG_WINDOW = 1 << 30
# ROADMAP.md Queue 1 items that port the other families
_PORTED_BY = {"ssm": 12, "hybrid": 13, "audio": 14, "vlm": 15}


def require_ported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is of a family ported so far: dense (without
    MLA) or moe (either layout)."""
    if cfg.family == "moe" or (cfg.family == "dense" and cfg.mla is None):
        return
    item = _PORTED_BY.get(cfg.family)
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


class MLA(nn.Module):
    """wq_a (D, qr), q_norm (qr,), wq_b (qr, H (nope + rope)), wkv_a (D,
    kvr + rope), kv_norm (kvr,), wkv_b (kvr, H (nope + v)), wo (H v, D)."""

    def __init__(self, wq_a, q_norm, wq_b, wkv_a, kv_norm, wkv_b, wo):
        super().__init__()
        (self.wq_a, self.q_norm, self.wq_b, self.wkv_a, self.kv_norm,
         self.wkv_b, self.wo) = map(_param, (wq_a, q_norm, wq_b, wkv_a,
                                             kv_norm, wkv_b, wo))


class SwiGLU(nn.Module):
    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up, self.w_down = map(_param,
                                                  (w_gate, w_up, w_down))


class AttnNorms(nn.Module):
    """A layer's attention (``Attention`` or ``MLA``) and its two norms:
    llama4's ``moe_attn``, and the part every block shares."""

    def __init__(self, pre_attn_norm, attn: nn.Module, pre_mlp_norm):
        super().__init__()
        self.pre_attn_norm = _param(pre_attn_norm)
        self.attn = attn
        self.pre_mlp_norm = _param(pre_mlp_norm)


class DenseBlock(AttnNorms):
    def __init__(self, pre_attn_norm, attn: nn.Module, pre_mlp_norm,
                 mlp: SwiGLU):
        super().__init__(pre_attn_norm, attn, pre_mlp_norm)
        self.mlp = mlp


class MoEBlock(AttnNorms):
    """deepseek-v2's MoE layer: MLA attention, then the experts."""

    def __init__(self, pre_attn_norm, attn: nn.Module, pre_mlp_norm,
                 moe: MoE):
        super().__init__(pre_attn_norm, attn, pre_mlp_norm)
        self.moe = moe


class SuperBlock(nn.Module):
    """llama4's pair of layers: ``dense`` (a DenseBlock), then
    ``moe_attn`` (attention and norms) with ``moe``."""

    def __init__(self, dense: DenseBlock, moe_attn: AttnNorms, moe: MoE):
        super().__init__()
        self.dense, self.moe_attn, self.moe = dense, moe_attn, moe


class LM(nn.Module):
    """embed (V, D), final_norm (D,), lm_head (D, V) unless tied, and the
    family's layer stacks, each a ``ModuleList``: dense ``blocks``
    (``DenseBlock``); deepseek-v2 ``first_blocks`` (``DenseBlock``) and
    ``blocks`` (``MoEBlock``); llama4 ``super_blocks``
    (``SuperBlock``)."""

    def __init__(self, embed, final_norm, lm_head=None, **stacks):
        super().__init__()
        self.embed = _param(embed)
        self.final_norm = _param(final_norm)
        self.lm_head = None if lm_head is None else _param(lm_head)
        for name, blocks in stacks.items():
            setattr(self, name, nn.ModuleList(blocks))


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


def _init_mla(gen, cfg: ModelConfig, dtype) -> MLA:
    a, D, H = cfg.mla, cfg.d_model, cfg.n_heads

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=gen.device)

    return MLA(
        _normal(gen, (D, a.q_lora_rank), dtype), zeros(a.q_lora_rank),
        _normal(gen, (a.q_lora_rank,
                      H * (a.nope_head_dim + a.rope_head_dim)), dtype),
        _normal(gen, (D, a.kv_lora_rank + a.rope_head_dim), dtype),
        zeros(a.kv_lora_rank),
        _normal(gen, (a.kv_lora_rank,
                      H * (a.nope_head_dim + a.v_head_dim)), dtype),
        _normal(gen, (H * a.v_head_dim, D), dtype))


def _init_mlp(gen, cfg: ModelConfig, dtype, d_ff=None) -> SwiGLU:
    D, F = cfg.d_model, d_ff or cfg.d_ff
    return SwiGLU(*(_normal(gen, s, dtype) for s in ((D, F), (D, F),
                                                      (F, D))))


def _norms(cfg: ModelConfig, dtype, dev):
    return (torch.zeros(cfg.d_model, dtype=dtype, device=dev),
            torch.zeros(cfg.d_model, dtype=dtype, device=dev))


def _init_dense_block(gen, cfg: ModelConfig, dtype, d_ff=None,
                      attn=None) -> DenseBlock:
    n1, n2 = _norms(cfg, dtype, gen.device)
    attn = attn if attn is not None else _init_attn(gen, cfg, dtype)
    return DenseBlock(n1, attn, n2, _init_mlp(gen, cfg, dtype, d_ff))


def _moe_layout(cfg: ModelConfig) -> str:
    """"first_dense" (deepseek-v2) or "interleaved" (llama4), with the
    JAX package's asserts on the config raised as ValueError."""
    m = cfg.moe
    if m.first_dense_layers:
        if m.period != 1:
            raise ValueError(f"{cfg.arch_id}: first-dense MoE needs period 1")
        return "first_dense"
    if m.period != 2 or cfg.n_layers % 2:
        raise ValueError(f"{cfg.arch_id}: interleaved MoE needs period 2 "
                         "and an even layer count")
    return "interleaved"


def _init_moe_arch(gen, cfg: ModelConfig, dtype) -> Dict[str, list]:
    m, dev = cfg.moe, gen.device
    if _moe_layout(cfg) == "first_dense":
        first = [_init_dense_block(gen, cfg, dtype, m.d_ff_dense,
                                   attn=_init_mla(gen, cfg, dtype))
                 for _ in range(m.first_dense_layers)]
        blocks = []
        for _ in range(cfg.n_layers - m.first_dense_layers):
            n1, n2 = _norms(cfg, dtype, dev)
            blocks.append(MoEBlock(n1, _init_mla(gen, cfg, dtype), n2,
                                   init_moe_params(gen, cfg, dtype)))
        return {"first_blocks": first, "blocks": blocks}
    supers = []
    for _ in range(cfg.n_layers // 2):
        dense = _init_dense_block(gen, cfg, dtype, m.d_ff_dense or cfg.d_ff)
        n1, n2 = _norms(cfg, dtype, dev)
        supers.append(SuperBlock(dense,
                                 AttnNorms(n1, _init_attn(gen, cfg, dtype),
                                           n2),
                                 init_moe_params(gen, cfg, dtype)))
    return {"super_blocks": supers}


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> LM:
    """Random weights in ``cfg.dtype`` from a ``torch.Generator`` on
    ``device`` seeded with ``seed``: normal(0.02) projections, embeddings
    and experts (the router in f32), zero norm scales and biases, as the
    JAX package draws them (its numbers differ: ``jax.random`` is another
    generator).  ``"cuda"`` raises when no card is visible."""
    require_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = torch_dtype(cfg)
    embed = _normal(gen, (cfg.vocab_size, cfg.d_model), dtype)
    lm_head = (None if cfg.tie_embeddings else
               _normal(gen, (cfg.d_model, cfg.vocab_size), dtype))
    if cfg.family == "moe":
        stacks = _init_moe_arch(gen, cfg, dtype)
    else:
        stacks = {"blocks": [_init_dense_block(gen, cfg, dtype)
                             for _ in range(cfg.n_layers)]}
    return LM(embed, torch.zeros(cfg.d_model, dtype=dtype, device=dev),
              lm_head, **stacks)


def _from_numpy(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def _attn_from(d) -> nn.Module:
    return MLA(**d) if "wq_a" in d else Attention(**d)


def _dense_block_from(d) -> DenseBlock:
    return DenseBlock(d["pre_attn_norm"], _attn_from(d["attn"]),
                      d["pre_mlp_norm"], SwiGLU(**d["mlp"]))


def _moe_block_from(d) -> MoEBlock:
    return MoEBlock(d["pre_attn_norm"], _attn_from(d["attn"]),
                    d["pre_mlp_norm"], MoE(**d["moe"]))


def _super_block_from(d) -> SuperBlock:
    ma = d["moe_attn"]
    return SuperBlock(_dense_block_from(d["dense"]),
                      AttnNorms(ma["pre_attn_norm"], _attn_from(ma["attn"]),
                                ma["pre_mlp_norm"]), MoE(**d["moe"]))


def _stack_schemas(cfg: ModelConfig):
    """{stack name: (its keys, nested, leaves None; its layer count; the
    function that makes one block from a layer's tensors)}."""
    keys = dict.fromkeys
    gqa = keys(["wq", "wk", "wv", "wo"]
               + (["bq", "bk", "bv"] if cfg.qkv_bias else []))
    mlp = keys(["w_gate", "w_up", "w_down"])

    def block(attn, **tail):
        return {"pre_attn_norm": None, "attn": attn, "pre_mlp_norm": None,
                **tail}

    if cfg.family != "moe":
        return {"blocks": (block(gqa, mlp=mlp), cfg.n_layers,
                           _dense_block_from)}
    m = cfg.moe
    moe = keys(["router", "w_gate", "w_up", "w_down"]
               + ([f"shared_{w}" for w in mlp] if m.n_shared_experts
                  else []))
    if _moe_layout(cfg) == "first_dense":
        mla = keys(["wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b",
                    "wo"])
        nf = m.first_dense_layers
        return {"first_blocks": (block(mla, mlp=mlp), nf,
                                 _dense_block_from),
                "blocks": (block(mla, moe=moe), cfg.n_layers - nf,
                           _moe_block_from)}
    return {"super_blocks": ({"dense": block(gqa, mlp=mlp),
                              "moe_attn": block(gqa), "moe": moe},
                             cfg.n_layers // 2, _super_block_from)}


def _n_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def _keys(tree):
    return ({k: _keys(v) for k, v in tree.items()}
            if isinstance(tree, dict) else None)


def _layer(tree, l, dev):
    """Layer ``l`` of every leaf of a stacked (numpy) tree, as tensors."""
    if isinstance(tree, dict):
        return {k: _layer(v, l, dev) for k, v in tree.items()}
    return _from_numpy(np.asarray(tree)[l], dev)


def params_from_numpy(cfg: ModelConfig, tree: Dict, *,
                      device="cuda") -> LM:
    """The JAX package's params tree, as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), as the port's modules on
    ``device``.  JAX stacks each stack's blocks along a leading layer
    axis; this takes layer l of every leaf for ``<stack>[l]``.  Raises if
    the tree does not have the config's keys or layer counts."""
    require_ported(cfg)
    dev = resolve_device(device)
    schemas = _stack_schemas(cfg)
    top = {"embed": None, "final_norm": None,
           **({} if cfg.tie_embeddings else {"lm_head": None}),
           **{name: sch for name, (sch, _, _) in schemas.items()}}
    if _keys(tree) != top:
        raise ValueError(f"{cfg.arch_id}: params tree does not have the "
                         f"{cfg.family} family's keys")
    stacks = {}
    for name, (_, n, build) in schemas.items():
        L = _n_layers(tree[name])
        if L != n:
            raise ValueError(f"{cfg.arch_id}: params stack {L} layers in "
                             f"{name}, the config {n}")
        stacks[name] = [build(_layer(tree[name], l, dev)) for l in range(L)]
    lm_head = (None if cfg.tie_embeddings
               else _from_numpy(tree["lm_head"], dev))
    return LM(_from_numpy(tree["embed"], dev),
              _from_numpy(tree["final_norm"], dev), lm_head, **stacks)


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

def forward(cfg: ModelConfig, params: LM, batch: Dict, *,
            mode: str = "prefill", return_cache: bool = False,
            return_hidden: bool = False, attn_backend: str = "cuda"):
    """Returns (logits_or_hidden, aux_loss[, cache]).  batch =
    {"tokens": (B, S) int}.  ``return_hidden=True`` skips the
    unembedding and returns the final-norm hidden states; the cache has
    ``init_cache``'s keys and shapes (dense: {"k", "v"}: (L, B, S, K,
    hd)).  aux_loss is the MoE layers' summed Switch loss (f32; 0 for
    dense)."""
    require_ported(cfg)
    if mode != "prefill":
        raise NotImplementedError(
            f"forward mode {mode!r}: training is not ported to repro_torch "
            "yet (ROADMAP.md Queue 1 item 16)")
    x, positions = _embed_inputs(cfg, params, batch)
    stack = _moe_stack if cfg.family == "moe" else _dense_stack
    x, aux, cache = stack(cfg, params, x, positions, return_cache,
                          attn_backend)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    out = x if return_hidden else unembed(cfg, params, x)
    if return_cache:
        return out, aux, cache
    return out, aux


def unembed(cfg: ModelConfig, params: LM, x):
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return (x @ head).float()


def _embed_scale(cfg: ModelConfig) -> Optional[float]:
    return cfg.d_model ** 0.5 if cfg.arch_id.startswith("gemma") else None


def _embed_inputs(cfg: ModelConfig, params: LM, batch: Dict):
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device)
    x = embed_tokens(params.embed, tokens, _embed_scale(cfg))
    return x, torch.arange(x.shape[1], device=x.device)


def _dense_stack(cfg: ModelConfig, params: LM, x, positions,
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


def _cache_shapes(cfg: ModelConfig, batch: int, seq: int):
    """{name: shape} of the family's cache."""
    hd, K = cfg.resolved_head_dim, cfg.n_kv_heads
    if cfg.family != "moe":
        return {n: (cfg.n_layers, batch, seq, K, hd) for n in ("k", "v")}
    if _moe_layout(cfg) == "interleaved":
        return {n: (cfg.n_layers // 2, 2, batch, seq, K, hd)
                for n in ("k", "v")}
    a = cfg.mla
    nf = cfg.moe.first_dense_layers
    out = {}
    for pre, n in (("first_", nf), ("", cfg.n_layers - nf)):
        out[pre + "c_kv"] = (n, batch, seq, a.kv_lora_rank)
        out[pre + "k_rope"] = (n, batch, seq, a.rope_head_dim)
    return out


def _moe_stack(cfg: ModelConfig, params: LM, x, positions,
               return_cache: bool, attn_backend: str):
    """Both MoE layouts (``_moe_stack`` of the JAX package): deepseek-v2's
    MLA layers, dense-first then MoE, and llama4's (dense, MoE)
    super-blocks.  Returns (h, summed aux loss f32, cache)."""
    B, S = x.shape[:2]
    cache = None
    if return_cache:
        cache = {n: torch.empty(shape, dtype=x.dtype, device=x.device)
                 for n, shape in _cache_shapes(cfg, B, S).items()}
    eps = cfg.norm_eps
    aux = torch.zeros((), device=x.device)
    h = x
    if _moe_layout(cfg) == "first_dense":
        for pre, stack in (("first_", params.first_blocks),
                           ("", params.blocks)):
            for l, p in enumerate(stack):
                a, ckv, krope = mla_prefill(
                    rms_norm(h, p.pre_attn_norm, eps), p.attn, cfg,
                    positions, backend=attn_backend)
                h = h + a
                hn = rms_norm(h, p.pre_mlp_norm, eps)
                if isinstance(p, MoEBlock):
                    mo, a_l = moe_block(hn, p.moe, cfg)
                    h, aux = h + mo, aux + a_l
                else:
                    h = h + swiglu_mlp(hn, p.mlp.w_gate, p.mlp.w_up,
                                       p.mlp.w_down)
                if return_cache:
                    cache[pre + "c_kv"][l] = ckv
                    cache[pre + "k_rope"][l] = krope
        return h, aux, cache
    rot = rope_angles(positions, cfg.rope_theta, cfg.resolved_head_dim)
    for i, p in enumerate(params.super_blocks):
        d, ma = p.dense, p.moe_attn
        a, k1, v1 = _gqa_full(rms_norm(h, d.pre_attn_norm, eps), d.attn,
                              cfg, rot, _BIG_WINDOW, backend=attn_backend)
        h = h + a
        h = h + swiglu_mlp(rms_norm(h, d.pre_mlp_norm, eps), d.mlp.w_gate,
                           d.mlp.w_up, d.mlp.w_down)
        a, k2, v2 = _gqa_full(rms_norm(h, ma.pre_attn_norm, eps), ma.attn,
                              cfg, rot, _BIG_WINDOW, backend=attn_backend)
        h = h + a
        mo, a_l = moe_block(rms_norm(h, ma.pre_mlp_norm, eps), p.moe, cfg)
        h, aux = h + mo, aux + a_l
        if return_cache:
            cache["k"][i, 0], cache["k"][i, 1] = k1, k2
            cache["v"][i, 0], cache["v"][i, 1] = v1, v2
    return h, aux, cache


# ======================================================================
# KV cache and the decode step
# ======================================================================

def init_cache(cfg: ModelConfig, batch: int, seq: int, *, device="cuda"):
    """The zeroed cache in ``cfg.dtype``: dense {"k", "v"}: (L, batch,
    seq, K, hd); llama4 {"k", "v"}: (L / 2, 2, batch, seq, K, hd);
    deepseek-v2 {"first_c_kv", "c_kv"}: (layers, batch, seq, kv_lora)
    and {"first_k_rope", "k_rope"}: (layers, batch, seq, rope)."""
    require_ported(cfg)
    dev = resolve_device(device)
    return {n: torch.zeros(shape, dtype=torch_dtype(cfg), device=dev)
            for n, shape in _cache_shapes(cfg, batch, seq).items()}


def decode_step(cfg: ModelConfig, params: LM, cache: Dict, batch: Dict):
    """batch = {"token": (B, 1) int, "pos": an int or (B,) ints}.

    Returns (logits (B, 1, V) f32, cache).  Unlike JAX, which returns a
    new cache, the step writes each layer's new entries into ``cache``
    in place (saving a copy of the whole cache per token) and returns
    the same dict."""
    require_ported(cfg)
    dev = params.embed.device
    token = torch.as_tensor(batch["token"], device=dev)
    pos = torch.as_tensor(batch["pos"], device=dev)
    x = embed_tokens(params.embed, token, _embed_scale(cfg))
    if cfg.family == "moe":
        x = _moe_decode(cfg, params, cache, x, pos)
        x = _final_norm_decode(cfg, params, x)
        return unembed(cfg, params, x), cache
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


def _final_norm_decode(cfg: ModelConfig, params: LM, x):
    return rms_norm(x, params.final_norm, cfg.norm_eps)


def _moe_decode(cfg: ModelConfig, params: LM, cache: Dict, x, pos):
    """Both MoE layouts' decode (``_moe_decode`` of the JAX package),
    writing the caches in place: deepseek-v2's absorbed MLA decode over
    the latent caches, llama4's GQA decode per super-block.  The MoE
    routes the B new tokens at the capacity of B tokens."""
    eps = cfg.norm_eps
    h = x
    if _moe_layout(cfg) == "first_dense":
        B = x.shape[0]
        pos_vec = pos.long().broadcast_to((B,))
        for pre, stack in (("first_", params.first_blocks),
                           ("", params.blocks)):
            for l, p in enumerate(stack):
                hn = rms_norm(h, p.pre_attn_norm, eps)
                ckv, krope = mla_new_cache_entries(hn, p.attn, cfg, pos_vec)
                ckv_c = _update_cache(cache[pre + "c_kv"][l], ckv, pos_vec)
                kr_c = _update_cache(cache[pre + "k_rope"][l], krope,
                                     pos_vec)
                h = h + mla_decode(hn, p.attn, cfg, ckv_c, kr_c,
                                   pos_vec + 1, pos_vec)
                hn = rms_norm(h, p.pre_mlp_norm, eps)
                if isinstance(p, MoEBlock):
                    h = h + moe_block(hn, p.moe, cfg)[0]
                else:
                    h = h + swiglu_mlp(hn, p.mlp.w_gate, p.mlp.w_up,
                                       p.mlp.w_down)
        return h
    for i, p in enumerate(params.super_blocks):
        d, ma = p.dense, p.moe_attn
        a, _, _ = _gqa_decode(rms_norm(h, d.pre_attn_norm, eps), d.attn,
                              cfg, pos, cfg.rope_theta, _BIG_WINDOW,
                              cache["k"][i, 0], cache["v"][i, 0])
        h = h + a
        h = h + swiglu_mlp(rms_norm(h, d.pre_mlp_norm, eps), d.mlp.w_gate,
                           d.mlp.w_up, d.mlp.w_down)
        a, _, _ = _gqa_decode(rms_norm(h, ma.pre_attn_norm, eps), ma.attn,
                              cfg, pos, cfg.rope_theta, _BIG_WINDOW,
                              cache["k"][i, 1], cache["v"][i, 1])
        h = h + a
        h = h + moe_block(rms_norm(h, ma.pre_mlp_norm, eps), p.moe, cfg)[0]
    return h
