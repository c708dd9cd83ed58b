"""The decoder families and the encoder-decoder — the twin of
``repro.models.transformer`` for every family:

- dense (smollm-360m, granite-8b, qwen2.5-14b, gemma3-4b): {"k", "v"}:
  (L, B, S, K, hd);
- moe, deepseek-v2-236b: MLA attention in every layer, ``first_blocks``
  (the dense-first layers, a SwiGLU MLP) then ``blocks`` (an MoE each);
  its cache is MLA's latents, {"first_c_kv", "first_k_rope", "c_kv",
  "k_rope"}: (layers, B, S, kv_lora) and (layers, B, S, rope);
- moe, llama4-maverick-400b-a17b: GQA attention, ``super_blocks`` of (a
  dense layer, an MoE layer); its cache {"k", "v"} is (L / 2, 2, B, S,
  K, hd);
- ssm (mamba2-1.3b): ``blocks`` of Mamba-2 (``models.ssm``); its cache
  {"ssm": SSMCache(conv (L, B, d_conv - 1, conv_dim) in the model dtype,
  state (L, B, H, N, P) in f32)};
- hybrid (zamba2-7b): ``mamba_blocks`` (n_super x inner Mamba-2 layers),
  each super-block followed by the one ``shared_attn`` block whose q, k
  and v take that super-block's ``lora`` delta, then ``tail_blocks``
  (n_layers - n_super inner Mamba-2 layers); its cache {"k", "v"}:
  (n_super, B, S, K, hd), {"mamba": SSMCache((n_super, inner, B, ...)),
  "tail": SSMCache((tail, B, ...))};
- audio (whisper-base): a LayerNorm encoder over the stub frontend's
  frames (``projector``, non-causal attention), a decoder whose layers
  self-attend (causal) and cross-attend to the encoder's output
  (non-causal, Sq != Skv), biased attention, GELU MLPs; its cache {"k",
  "v"}: (L, B, S, K, hd), {"cross_k", "cross_v"}: (L, B, enc_len, K,
  hd);
- vlm (llava-next-34b): the dense stack over the stub projector's patch
  embeddings (``patches @ projector``) followed by the text tokens; its
  cache is the dense one, over image and text positions.

Parameters are ``nn.Module`` containers whose attributes carry the JAX
tree's names (``params.blocks[l].attn.wq``), with weights stored as
(d_in, d_out) so that a projection is ``x @ w``.  JAX stacks the blocks
along a leading layer axis (two for ``mamba_blocks``) and scans over
them; here each stack is a ``ModuleList`` and the scan a Python loop.
Every function takes the same arguments as its JAX twin; the prefill
and the decode step add ``attn_backend`` (see
``models.attention.flash_attention``).

  init_params(cfg, seed, device=)            weights from a torch.Generator
  params_from_numpy(cfg, tree, device=)      the JAX params, as numpy arrays
  params_to_numpy(cfg, params)               the inverse, JAX's stacked tree
  forward(cfg, params, batch, mode="prefill", return_cache, return_hidden,
          remat)                             train (checkpointed) / prefill
  decode_step(cfg, params, cache, batch)     one token per slot, in place
  init_cache(cfg, batch, seq, enc_len=None, device=)

Parameters are made with ``requires_grad=False``: inference builds no
graph.  The trainer (``train.step``) turns them on with
``requires_grad_(True)``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ops import resolve_device
from repro_torch.models.attention import (decode_attention, flash_attention,
                                          mla_decode, mla_new_cache_entries,
                                          mla_prefill)
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_rope, embed_tokens, gelu_mlp,
                                       layer_norm, rms_norm, rope,
                                       rope_angles, sinusoidal_positions,
                                       swiglu_mlp)
from repro_torch.models.moe import MoE, init_moe_params, moe_block
from repro_torch.models.ssm import SSM, SSMCache

_BIG_WINDOW = 1 << 30
MODES = ("train", "prefill")


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


class MambaBlock(nn.Module):
    """A Mamba-2 layer: ``pre_norm`` (D,) and ``ssm`` (``models.ssm.SSM``)."""

    def __init__(self, pre_norm, ssm: SSM):
        super().__init__()
        self.pre_norm = _param(pre_norm)
        self.ssm = ssm


class LoRA(nn.Module):
    """zamba2's per-super-block delta on the shared attention's q, k and
    v: a_q, a_k, a_v (D, r); b_q (r, H hd), b_k and b_v (r, K hd)."""

    def __init__(self, a_q, b_q, a_k, b_k, a_v, b_v):
        super().__init__()
        (self.a_q, self.b_q, self.a_k, self.b_k, self.a_v,
         self.b_v) = map(_param, (a_q, b_q, a_k, b_k, a_v, b_v))


class LN(nn.Module):
    """A LayerNorm's scale and bias, (D,) each."""

    def __init__(self, scale, bias):
        super().__init__()
        self.scale, self.bias = _param(scale), _param(bias)


class GeluMLP(nn.Module):
    """w_in (D, F), b_in (F,), w_out (F, D), b_out (D,)."""

    def __init__(self, w_in, b_in, w_out, b_out):
        super().__init__()
        self.w_in, self.b_in, self.w_out, self.b_out = map(
            _param, (w_in, b_in, w_out, b_out))


class EncBlock(nn.Module):
    """whisper's encoder layer: ln1, attn (biased), ln2, mlp (GELU)."""

    def __init__(self, ln1: LN, attn: Attention, ln2: LN, mlp: GeluMLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class DecBlock(nn.Module):
    """whisper's decoder layer: ln1, self_attn, ln2, cross_attn, ln3,
    mlp."""

    def __init__(self, ln1: LN, self_attn: Attention, ln2: LN,
                 cross_attn: Attention, ln3: LN, mlp: GeluMLP):
        super().__init__()
        self.ln1, self.self_attn, self.ln2 = ln1, self_attn, ln2
        self.cross_attn, self.ln3, self.mlp = cross_attn, ln3, mlp


def _module_list(blocks) -> nn.ModuleList:
    return nn.ModuleList(_module_list(b) if isinstance(b, list) else b
                         for b in blocks)


class LM(nn.Module):
    """embed (V, D), final_norm (D,), lm_head (D, V) unless tied,
    projector (frontend_dim, D) for audio and vlm, and the family's
    parts: each layer stack a ``ModuleList`` (a list of lists a
    ``ModuleList`` of them), a single block as it is.  dense ``blocks`` (``DenseBlock``);
    deepseek-v2 ``first_blocks`` (``DenseBlock``) and ``blocks``
    (``MoEBlock``); llama4 ``super_blocks`` (``SuperBlock``); ssm
    ``blocks`` (``MambaBlock``); hybrid ``mamba_blocks`` (n_super lists
    of ``MambaBlock``), ``tail_blocks``, ``shared_attn`` (one
    ``DenseBlock``) and ``lora`` (``LoRA``, one a super-block); audio
    ``enc_blocks`` (``EncBlock``), ``enc_final_ln``, ``dec_blocks``
    (``DecBlock``) and ``dec_final_ln`` (``LN``); vlm's ``blocks`` are
    dense."""

    def __init__(self, embed, final_norm, lm_head=None, projector=None,
                 **parts):
        super().__init__()
        self.embed = _param(embed)
        self.final_norm = _param(final_norm)
        self.lm_head = None if lm_head is None else _param(lm_head)
        self.projector = None if projector is None else _param(projector)
        for name, part in parts.items():
            setattr(self, name, part if isinstance(part, nn.Module)
                    else _module_list(part))


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


def _hybrid_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_super, inner): super-blocks of ``attn_interval`` Mamba-2 layers;
    the n_layers - n_super inner left over are the tail."""
    inner = cfg.attn_interval
    return cfg.n_layers // inner, inner


def _init_mamba_block(gen, cfg: ModelConfig, dtype) -> MambaBlock:
    return MambaBlock(torch.zeros(cfg.d_model, dtype=dtype,
                                  device=gen.device),
                      ssm_mod.init_ssm_params(gen, cfg, dtype))


def _init_hybrid_arch(gen, cfg: ModelConfig, dtype) -> Dict:
    """zamba2: n_super super-blocks of (inner Mamba-2 layers, the shared
    attention with that super-block's LoRA), then the tail."""
    n_super, inner = _hybrid_layout(cfg)
    tail = cfg.n_layers - n_super * inner
    hd, H, K, D = (cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads,
                   cfg.d_model)
    r = cfg.shared_attn_lora_rank

    def lora():
        zeros = [torch.zeros((r, n * hd), dtype=dtype, device=gen.device)
                 for n in (H, K, K)]
        return LoRA(_normal(gen, (D, r), dtype), zeros[0],
                    _normal(gen, (D, r), dtype), zeros[1],
                    _normal(gen, (D, r), dtype), zeros[2])

    return {"mamba_blocks": [[_init_mamba_block(gen, cfg, dtype)
                              for _ in range(inner)]
                             for _ in range(n_super)],
            "tail_blocks": [_init_mamba_block(gen, cfg, dtype)
                            for _ in range(tail)],
            "shared_attn": _init_dense_block(gen, cfg, dtype),
            "lora": [lora() for _ in range(n_super)]}


def _init_audio_arch(gen, cfg: ModelConfig, dtype) -> Dict:
    """whisper: LayerNorm encoder and decoder with biased attention and
    GELU MLPs (LayerNorm scales one, biases zero)."""
    D, F, dev = cfg.d_model, cfg.d_ff, gen.device

    def ln():
        return LN(torch.ones(D, dtype=dtype, device=dev),
                  torch.zeros(D, dtype=dtype, device=dev))

    def gmlp():
        return GeluMLP(_normal(gen, (D, F), dtype),
                       torch.zeros(F, dtype=dtype, device=dev),
                       _normal(gen, (F, D), dtype),
                       torch.zeros(D, dtype=dtype, device=dev))

    return {"enc_blocks": [EncBlock(ln(), _init_attn(gen, cfg, dtype), ln(),
                                    gmlp())
                           for _ in range(cfg.n_encoder_layers)],
            "enc_final_ln": ln(),
            "dec_blocks": [DecBlock(ln(), _init_attn(gen, cfg, dtype), ln(),
                                    _init_attn(gen, cfg, dtype), ln(),
                                    gmlp())
                           for _ in range(cfg.n_layers)],
            "dec_final_ln": ln()}


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> LM:
    """Random weights in ``cfg.dtype`` from a ``torch.Generator`` on
    ``device`` seeded with ``seed``: normal(0.02) projections, embeddings,
    experts (the router in f32), LoRA a's and the frontend's projector; zero
    norm scales, biases and LoRA b's; LayerNorm scales one; the SSM's
    dt_bias and A_log zero and D_skip one (f32): as the JAX package draws
    them (its numbers differ: ``jax.random`` is another generator).
    ``"cuda"`` raises when no card is visible."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = torch_dtype(cfg)
    embed = _normal(gen, (cfg.vocab_size, cfg.d_model), dtype)
    lm_head = (None if cfg.tie_embeddings else
               _normal(gen, (cfg.d_model, cfg.vocab_size), dtype))
    projector = (None if cfg.frontend is None else
                 _normal(gen, (cfg.frontend_dim, cfg.d_model), dtype))
    if cfg.family == "moe":
        parts = _init_moe_arch(gen, cfg, dtype)
    elif cfg.family == "ssm":
        parts = {"blocks": [_init_mamba_block(gen, cfg, dtype)
                            for _ in range(cfg.n_layers)]}
    elif cfg.family == "hybrid":
        parts = _init_hybrid_arch(gen, cfg, dtype)
    elif cfg.family == "audio":
        parts = _init_audio_arch(gen, cfg, dtype)
    else:
        parts = {"blocks": [_init_dense_block(gen, cfg, dtype)
                            for _ in range(cfg.n_layers)]}
    return LM(embed, torch.zeros(cfg.d_model, dtype=dtype, device=dev),
              lm_head, projector, **parts)


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


def _mamba_block_from(d) -> MambaBlock:
    return MambaBlock(d["pre_norm"], SSM(**d["ssm"]))


def _enc_block_from(d) -> EncBlock:
    return EncBlock(LN(**d["ln1"]), Attention(**d["attn"]), LN(**d["ln2"]),
                    GeluMLP(**d["mlp"]))


def _dec_block_from(d) -> DecBlock:
    return DecBlock(LN(**d["ln1"]), Attention(**d["self_attn"]),
                    LN(**d["ln2"]), Attention(**d["cross_attn"]),
                    LN(**d["ln3"]), GeluMLP(**d["mlp"]))


def _part_schemas(cfg: ModelConfig):
    """{part name: (its keys, nested, leaves None; its layer count: an
    int for a stack over one leading axis, a pair for two (hybrid
    ``mamba_blocks``), None for one unstacked block; the function that
    makes one block from a layer's tensors)}."""
    keys = dict.fromkeys
    gqa = keys(["wq", "wk", "wv", "wo"]
               + (["bq", "bk", "bv"] if cfg.qkv_bias else []))
    mlp = keys(["w_gate", "w_up", "w_down"])

    def block(attn, **tail):
        return {"pre_attn_norm": None, "attn": attn, "pre_mlp_norm": None,
                **tail}

    mamba = {"pre_norm": None,
             "ssm": keys(["w_xz", "w_bc", "w_dt", "dt_bias", "conv",
                          "A_log", "D_skip", "norm", "w_out"])}
    if cfg.family == "ssm":
        return {"blocks": (mamba, cfg.n_layers, _mamba_block_from)}
    if cfg.family == "hybrid":
        n_super, inner = _hybrid_layout(cfg)
        lora = keys(["a_q", "b_q", "a_k", "b_k", "a_v", "b_v"])
        return {"mamba_blocks": (mamba, (n_super, inner), _mamba_block_from),
                "tail_blocks": (mamba, cfg.n_layers - n_super * inner,
                                _mamba_block_from),
                "shared_attn": (block(gqa, mlp=mlp), None,
                                _dense_block_from),
                "lora": (lora, n_super, lambda d: LoRA(**d))}
    if cfg.family == "audio":
        ln = keys(["scale", "bias"])
        gmlp = keys(["w_in", "b_in", "w_out", "b_out"])
        return {"enc_blocks": ({"ln1": ln, "attn": gqa, "ln2": ln,
                                "mlp": gmlp}, cfg.n_encoder_layers,
                               _enc_block_from),
                "enc_final_ln": (ln, None, lambda d: LN(**d)),
                "dec_blocks": ({"ln1": ln, "self_attn": gqa, "ln2": ln,
                                "cross_attn": gqa, "ln3": ln, "mlp": gmlp},
                               cfg.n_layers, _dec_block_from),
                "dec_final_ln": (ln, None, lambda d: LN(**d))}
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


def _top_keys(cfg: ModelConfig) -> List[str]:
    """The params tree's leaves outside every block."""
    return (["embed", "final_norm"]
            + ([] if cfg.tie_embeddings else ["lm_head"])
            + ([] if cfg.frontend is None else ["projector"]))


def _lead_shape(tree, n_axes: int) -> Tuple[int, ...]:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tuple(np.asarray(tree).shape[:n_axes])


def _keys(tree):
    return ({k: _keys(v) for k, v in tree.items()}
            if isinstance(tree, dict) else None)


def _layer(tree, l, dev):
    """Layer ``l`` (an index, a pair of them, or () for the whole leaf)
    of every leaf of a stacked (numpy) tree, as tensors."""
    if isinstance(tree, dict):
        return {k: _layer(v, l, dev) for k, v in tree.items()}
    return _from_numpy(np.asarray(tree)[l], dev)


def params_from_numpy(cfg: ModelConfig, tree: Dict, *,
                      device="cuda") -> LM:
    """The JAX package's params tree, as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), as the port's modules on
    ``device``.  JAX stacks each stack's blocks along a leading layer
    axis (hybrid ``mamba_blocks`` along two: super-block, then layer);
    this takes layer l of every leaf for ``<stack>[l]`` (``[i][j]``).
    Raises if the tree does not have the config's keys or layer
    counts."""
    dev = resolve_device(device)
    schemas = _part_schemas(cfg)
    top = {**dict.fromkeys(_top_keys(cfg)),
           **{name: sch for name, (sch, _, _) in schemas.items()}}
    if _keys(tree) != top:
        raise ValueError(f"{cfg.arch_id}: params tree does not have the "
                         f"{cfg.family} family's keys")
    parts = {}
    for name, (_, n, build) in schemas.items():
        if n is None:
            parts[name] = build(_layer(tree[name], (), dev))
            continue
        want = n if isinstance(n, tuple) else (n,)
        got = _lead_shape(tree[name], len(want))
        if got != want:
            raise ValueError(f"{cfg.arch_id}: params stack {got} layers in "
                             f"{name}, the config {want}")
        if len(want) == 2:
            parts[name] = [[build(_layer(tree[name], (i, j), dev))
                            for j in range(want[1])]
                           for i in range(want[0])]
        else:
            parts[name] = [build(_layer(tree[name], l, dev))
                           for l in range(n)]
    lm_head = (None if cfg.tie_embeddings
               else _from_numpy(tree["lm_head"], dev))
    projector = (None if cfg.frontend is None
                 else _from_numpy(tree["projector"], dev))
    return LM(_from_numpy(tree["embed"], dev),
              _from_numpy(tree["final_norm"], dev), lm_head, projector,
              **parts)


def _leaf_paths(schema, pre=()):
    for k, v in schema.items():
        if v is None:
            yield pre + (k,)
        else:
            yield from _leaf_paths(v, pre + (k,))


class LayoutEntry(NamedTuple):
    """A leaf of the JAX params tree: its leading layer axes (() for a
    leaf JAX does not stack), the port's parameter names that fill it in
    layer order (row-major over ``lead``), and for a stack with no layers
    (zamba2 whose layers divide into super-blocks: an empty tail) the
    name of a parameter of the same shape elsewhere."""
    lead: Tuple[int, ...]
    names: List[str]
    proto: Optional[str]


def jax_layout(cfg: ModelConfig) -> Dict[Tuple[str, ...], LayoutEntry]:
    """{the path of a leaf in the JAX package's params tree: where the
    port keeps it}.  A stacked leaf (L, ...) is the port's parameter
    ``<stack>.<l>.<path>`` for each layer l (hybrid ``mamba_blocks``
    (n_super, inner, ...): ``mamba_blocks.<i>.<j>.<path>``); the others
    are the parameter of the same name."""
    out = {(k,): LayoutEntry((), [k], None) for k in _top_keys(cfg)}
    schemas = _part_schemas(cfg)
    leads = {part: () if n is None else n if isinstance(n, tuple) else (n,)
             for part, (_, n, _) in schemas.items()}
    for part, (schema, _, _) in schemas.items():
        lead, proto = leads[part], None
        if 0 in lead:        # the first layer of a stack of the same blocks
            proto = next(other + ".0" * len(leads[other])
                         for other, (o_schema, _, _) in schemas.items()
                         if o_schema == schema and 0 not in leads[other])
        for path in _leaf_paths(schema):
            leaf = ".".join(path)
            names = [".".join((part, *map(str, idx), leaf))
                     for idx in np.ndindex(*lead)]
            out[(part,) + path] = LayoutEntry(
                lead, names, proto and f"{proto}.{leaf}")
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(cfg: ModelConfig, params) -> Dict:
    """The inverse of ``params_from_numpy``: the JAX package's params
    tree as numpy arrays, each stack's layers stacked along its leading
    axes again (hybrid ``mamba_blocks`` along two; an empty stack as
    zeros of length 0).  ``params`` is the ``LM`` or any {parameter name:
    tensor} with its names (gradients, optimizer moments).  bf16 comes
    out as f32, exactly: numpy has no bf16 (the JAX package's
    checkpoints store it so)."""
    named = (dict(params.named_parameters()) if isinstance(params, nn.Module)
             else params)
    tree: Dict = {}
    for path, e in jax_layout(cfg).items():
        if e.names:
            arr = np.stack([_to_numpy(named[n]) for n in e.names]).reshape(
                e.lead + tuple(named[e.names[0]].shape))
        else:
            p = _to_numpy(named[e.proto])
            arr = np.zeros(e.lead + p.shape, p.dtype)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return tree


# ======================================================================
# attention sub-blocks
# ======================================================================

def _qkv(x, p: Attention, cfg: ModelConfig, lora: Optional[LoRA] = None):
    """q, k and v as (B, S, heads, hd).  zamba2's ``lora`` adds (x @ a) @
    b to each, the order in which XLA contracts JAX's ``einsum("bsd,dr,
    re->bse")`` at these shapes (in bf16 the (B, S, r) product rounds to
    bf16 before the second GEMM, as there)."""
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if lora is not None:
        q = q + (x @ lora.a_q) @ lora.b_q
        k = k + (x @ lora.a_k) @ lora.b_k
        v = v + (x @ lora.a_v) @ lora.b_v
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (q.reshape(B, S, cfg.n_heads, hd),
            k.reshape(B, S, cfg.n_kv_heads, hd),
            v.reshape(B, S, cfg.n_kv_heads, hd))


def _gqa_full(x, p: Attention, cfg: ModelConfig, rot, window,
              causal: bool = True, backend: str = "cuda",
              lora: Optional[LoRA] = None):
    """Full-sequence GQA attention (prefill).  ``rot`` is the layer's
    rope (cos, sin) from ``rope_angles``, or None.  Returns (out, k, v)."""
    q, k, v = _qkv(x, p, cfg, lora)
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
                vc, lora: Optional[LoRA] = None):
    """One-token GQA decode; writes (kc, vc) in place at per-sequence
    ``pos`` (an int or a (B,) tensor: continuous-batching slots may
    differ)."""
    q, k, v = _qkv(x, p, cfg, lora)
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


def _cross_attn(x, p: Attention, cfg: ModelConfig, k, v,
                backend: str = "cuda"):
    """The decoder's queries against the encoder's (k, v): non-causal,
    Sq (the decoder's tokens, 1 in decode) != Skv (the frames)."""
    B, S, _ = x.shape
    q = x @ p.wq
    if cfg.qkv_bias:
        q = q + p.bq
    q = q.reshape(B, S, cfg.n_heads, cfg.resolved_head_dim)
    o = flash_attention(q, k, v, causal=False, backend=backend)
    return o.reshape(B, S, -1) @ p.wo


def _cross_kv(enc_out, p: Attention, cfg: ModelConfig):
    """The cross-attention's (k, v), (B, S_enc, K, hd) each."""
    B, S, _ = enc_out.shape
    k, v = enc_out @ p.wk, enc_out @ p.wv
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    shape = (B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    return k.reshape(shape), v.reshape(shape)


# ======================================================================
# forward (train / prefill)
# ======================================================================

def _add(h, a, last: bool):
    """The residual add ``h + a``.  A stack's last one is kept in f32 for
    the final norm to read: its rounding to bf16 is the one the final
    norm magnifies most (ROADMAP.md Queue 3).  In f32 it is ``h + a``."""
    return h.float() + a if last else h + a


def _body(remat: bool, fn, *args):
    """``fn(*args)``, one layer (or super-block) body; with ``remat``
    under ``torch.utils.checkpoint`` (non-reentrant): its activations are
    dropped after the forward and recomputed in the backward, as
    ``jax.checkpoint`` does with the JAX package's scanned bodies."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def forward(cfg: ModelConfig, params: LM, batch: Dict, *,
            mode: str = "prefill", return_cache: bool = False,
            return_hidden: bool = False, attn_backend: str = "cuda",
            remat: bool = True):
    """Returns (logits_or_hidden, aux_loss[, cache]).  batch =
    {"tokens": (B, S) int}; audio also "frames": (B, S_enc,
    frontend_dim), the stub frontend's frame embeddings (taken in the
    model's dtype); vlm also "patches": (B, n_img, frontend_dim), the
    stub vision encoder's patch embeddings, whose projections come
    before the tokens (positions cover both).  ``return_hidden=True``
    skips the unembedding and returns the final-norm hidden states; the
    cache has ``init_cache``'s keys and shapes (dense and vlm: {"k",
    "v"}: (L, B, S, K, hd); audio's cross_k and cross_v have S_enc
    rows).  aux_loss is the MoE layers' summed Switch loss (f32; 0 for
    the other families).

    ``mode``: "prefill" (the port's default: its callers are inference)
    or "train" (the JAX package's default), where ``remat`` runs each
    layer body as JAX's ``_maybe_remat`` does (dense and vlm layers,
    deepseek-v2's dense-first and MoE layers, llama4's super-blocks,
    mamba layers, zamba2's super-blocks, whisper's decoder layers) under
    ``torch.utils.checkpoint``.  Train mode builds no cache."""
    if mode not in MODES:
        raise ValueError(f"forward mode {mode!r}: choose one of {MODES}")
    if mode == "train" and return_cache:
        raise ValueError("forward mode 'train' builds no cache")
    remat = remat and mode == "train"
    if cfg.family == "audio":
        return _audio_forward(cfg, params, batch, return_cache=return_cache,
                              return_hidden=return_hidden,
                              attn_backend=attn_backend, remat=remat)
    x, positions = _embed_inputs(cfg, params, batch)
    stack = {"moe": _moe_stack, "ssm": _ssm_stack,
             "hybrid": _hybrid_stack}.get(cfg.family, _dense_stack)
    x, aux, cache = stack(cfg, params, x, positions, return_cache,
                          attn_backend, remat)
    x = rms_norm(x, params.final_norm, cfg.norm_eps).to(params.embed.dtype)
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
    """The token embeddings, after vlm's projected patches: JAX's
    ``einsum("bnf,fd->bnd")`` in the promoted type of the patches and
    the projector, then cast to the embeddings' dtype."""
    dev = params.embed.device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    x = embed_tokens(params.embed, tokens, _embed_scale(cfg))
    if cfg.frontend == "vision":
        patches = torch.as_tensor(batch["patches"], device=dev)
        dt = torch.promote_types(patches.dtype, params.projector.dtype)
        img = patches.to(dt) @ params.projector.to(dt)
        x = torch.cat([img.to(x.dtype), x], dim=1)
    return x, torch.arange(x.shape[1], device=x.device)


def _dense_layer(cfg: ModelConfig, p: DenseBlock, h, rot, window,
                 attn_backend: str, last: bool):
    a, k, v = _gqa_full(rms_norm(h, p.pre_attn_norm, cfg.norm_eps), p.attn,
                        cfg, rot, window, backend=attn_backend)
    h = h + a
    h = _add(h, swiglu_mlp(rms_norm(h, p.pre_mlp_norm, cfg.norm_eps),
                           p.mlp.w_gate, p.mlp.w_up, p.mlp.w_down), last)
    return h, k, v


def _dense_stack(cfg: ModelConfig, params: LM, x, positions,
                 return_cache: bool, attn_backend: str, remat: bool):
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
        h, k, v = _body(remat, _dense_layer, cfg, p, h, rots.get(theta),
                        window, attn_backend, l == len(params.blocks) - 1)
        if return_cache:
            cache["k"][l] = k
            cache["v"][l] = v
    return h, torch.zeros((), device=x.device), cache


def _cache_shapes(cfg: ModelConfig, batch: int, seq: int,
                 enc_len: Optional[int] = None):
    """{name: shape} of the family's attention cache, all in the model's
    dtype (the ssm and hybrid families' recurrent caches are
    ``_ssm_caches``')."""
    hd, K = cfg.resolved_head_dim, cfg.n_kv_heads
    if cfg.family == "ssm":
        return {}
    if cfg.family == "hybrid":
        n_super, _ = _hybrid_layout(cfg)
        return {n: (n_super, batch, seq, K, hd) for n in ("k", "v")}
    if cfg.family == "audio":
        enc_len = enc_len or cfg.n_frontend_tokens
        L = cfg.n_layers
        return {"k": (L, batch, seq, K, hd), "v": (L, batch, seq, K, hd),
                "cross_k": (L, batch, enc_len, K, hd),
                "cross_v": (L, batch, enc_len, K, hd)}
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


def _ssm_caches(cfg: ModelConfig, batch: int, dtype, dev) -> Dict:
    """The zeroed recurrent caches: ssm {"ssm"} over its L layers; hybrid
    {"mamba"} over (n_super, inner) and {"tail"} over its tail layers.
    Each an ``SSMCache``: conv in ``dtype``, state in f32."""
    if cfg.family == "ssm":
        return {"ssm": ssm_mod.init_ssm_cache(batch, cfg, dtype,
                                              lead=(cfg.n_layers,),
                                              device=dev)}
    if cfg.family == "hybrid":
        n_super, inner = _hybrid_layout(cfg)
        tail = cfg.n_layers - n_super * inner
        return {"mamba": ssm_mod.init_ssm_cache(
                    batch, cfg, dtype, lead=(n_super, inner), device=dev),
                "tail": ssm_mod.init_ssm_cache(batch, cfg, dtype,
                                               lead=(tail,), device=dev)}
    return {}


def _moe_layer(cfg: ModelConfig, p, h, positions, attn_backend: str,
               last: bool):
    """deepseek-v2's layer: MLA, then its MoE (``MoEBlock``) or SwiGLU
    MLP (dense-first).  Returns (h, aux, c_kv, k_rope)."""
    eps = cfg.norm_eps
    a, ckv, krope = mla_prefill(rms_norm(h, p.pre_attn_norm, eps), p.attn,
                                cfg, positions, backend=attn_backend)
    h = h + a
    hn = rms_norm(h, p.pre_mlp_norm, eps)
    aux = torch.zeros((), device=h.device)
    if isinstance(p, MoEBlock):
        mo, aux = moe_block(hn, p.moe, cfg)
    else:
        mo = swiglu_mlp(hn, p.mlp.w_gate, p.mlp.w_up, p.mlp.w_down)
    return _add(h, mo, last), aux, ckv, krope


def _super_layer(cfg: ModelConfig, p: SuperBlock, h, rot,
                 attn_backend: str, last: bool):
    """llama4's super-block: a dense layer, then attention and the MoE.
    Returns (h, aux, k1, v1, k2, v2)."""
    eps = cfg.norm_eps
    d, ma = p.dense, p.moe_attn
    a, k1, v1 = _gqa_full(rms_norm(h, d.pre_attn_norm, eps), d.attn, cfg,
                          rot, _BIG_WINDOW, backend=attn_backend)
    h = h + a
    h = h + swiglu_mlp(rms_norm(h, d.pre_mlp_norm, eps), d.mlp.w_gate,
                       d.mlp.w_up, d.mlp.w_down)
    a, k2, v2 = _gqa_full(rms_norm(h, ma.pre_attn_norm, eps), ma.attn, cfg,
                          rot, _BIG_WINDOW, backend=attn_backend)
    h = h + a
    mo, aux = moe_block(rms_norm(h, ma.pre_mlp_norm, eps), p.moe, cfg)
    return _add(h, mo, last), aux, k1, v1, k2, v2


def _moe_stack(cfg: ModelConfig, params: LM, x, positions,
               return_cache: bool, attn_backend: str, remat: bool):
    """Both MoE layouts (``_moe_stack`` of the JAX package): deepseek-v2's
    MLA layers, dense-first then MoE, and llama4's (dense, MoE)
    super-blocks.  Returns (h, summed aux loss f32, cache)."""
    B, S = x.shape[:2]
    cache = None
    if return_cache:
        cache = {n: torch.empty(shape, dtype=x.dtype, device=x.device)
                 for n, shape in _cache_shapes(cfg, B, S).items()}
    aux = torch.zeros((), device=x.device)
    h = x
    if _moe_layout(cfg) == "first_dense":
        final = [*params.first_blocks, *params.blocks][-1]
        for pre, stack in (("first_", params.first_blocks),
                           ("", params.blocks)):
            for l, p in enumerate(stack):
                h, a_l, ckv, krope = _body(remat, _moe_layer, cfg, p, h,
                                           positions, attn_backend,
                                           p is final)
                aux = aux + a_l
                if return_cache:
                    cache[pre + "c_kv"][l] = ckv
                    cache[pre + "k_rope"][l] = krope
        return h, aux, cache
    rot = rope_angles(positions, cfg.rope_theta, cfg.resolved_head_dim)
    for i, p in enumerate(params.super_blocks):
        h, a_l, k1, v1, k2, v2 = _body(
            remat, _super_layer, cfg, p, h, rot, attn_backend,
            i == len(params.super_blocks) - 1)
        aux = aux + a_l
        if return_cache:
            cache["k"][i, 0], cache["k"][i, 1] = k1, k2
            cache["v"][i, 0], cache["v"][i, 1] = v1, v2
    return h, aux, cache


def _mamba_layer(cfg: ModelConfig, p: MambaBlock, h, last: bool,
                 return_state: bool):
    o = ssm_mod.mamba2_block(rms_norm(h, p.pre_norm, cfg.norm_eps), p.ssm,
                             cfg, return_state=return_state)
    if return_state:
        o, c = o
        return _add(h, o, last), c
    return _add(h, o, last), None


def _mamba_layers(cfg: ModelConfig, blocks, h, caches: Optional[SSMCache],
                  last: bool = False, remat: bool = False):
    """Mamba-2 over ``blocks``, each with its pre-norm and residual
    (``last``: these layers end the stack; ``remat``: each layer under
    checkpoint); writes layer l's final conv inputs and state into
    ``caches`` (an ``SSMCache`` stacked over these layers) when given."""
    for l, p in enumerate(blocks):
        h, c = _body(remat, _mamba_layer, cfg, p, h,
                     last and l == len(blocks) - 1, caches is not None)
        if caches is not None:
            caches.conv[l] = c.conv
            caches.state[l] = c.state
    return h


def _ssm_stack(cfg: ModelConfig, params: LM, x, positions,
               return_cache: bool, attn_backend: str, remat: bool):
    """mamba2: the Mamba-2 layers (no attention: ``attn_backend`` and
    ``positions`` unused).  Returns (h, 0, cache)."""
    B = x.shape[0]
    cache = (_ssm_caches(cfg, B, x.dtype, x.device) if return_cache
             else None)
    h = _mamba_layers(cfg, params.blocks, x,
                      cache["ssm"] if return_cache else None, last=True,
                      remat=remat)
    return h, torch.zeros((), device=x.device), cache


def _hybrid_super(cfg: ModelConfig, blocks, shared: DenseBlock, lora: LoRA,
                  h, rot, attn_backend: str, last: bool,
                  caches: Optional[SSMCache]):
    """zamba2's super-block: its Mamba-2 layers, then the shared
    attention block with the super-block's LoRA (causal, rope).  Returns
    (h, k, v)."""
    eps = cfg.norm_eps
    h = _mamba_layers(cfg, blocks, h, caches)
    a, k, v = _gqa_full(rms_norm(h, shared.pre_attn_norm, eps), shared.attn,
                        cfg, rot, _BIG_WINDOW, backend=attn_backend,
                        lora=lora)
    h = h + a
    h = _add(h, swiglu_mlp(rms_norm(h, shared.pre_mlp_norm, eps),
                           shared.mlp.w_gate, shared.mlp.w_up,
                           shared.mlp.w_down), last)
    return h, k, v


def _hybrid_stack(cfg: ModelConfig, params: LM, x, positions,
                  return_cache: bool, attn_backend: str, remat: bool):
    """zamba2: the super-blocks (each one checkpointed whole under
    ``remat``, as JAX's), then the tail's Mamba-2 layers (not, as
    JAX's).  Returns (h, 0, cache)."""
    n_super, _ = _hybrid_layout(cfg)
    B, S = x.shape[:2]
    cache = None
    if return_cache:
        cache = {n: torch.empty(shape, dtype=x.dtype, device=x.device)
                 for n, shape in _cache_shapes(cfg, B, S).items()}
        cache.update(_ssm_caches(cfg, B, x.dtype, x.device))
    rot = rope_angles(positions, cfg.rope_theta, cfg.resolved_head_dim)
    h = x
    for i in range(n_super):
        h, k, v = _body(
            remat, _hybrid_super, cfg, params.mamba_blocks[i],
            params.shared_attn, params.lora[i], h, rot, attn_backend,
            i == n_super - 1 and not len(params.tail_blocks),
            None if cache is None else SSMCache(cache["mamba"].conv[i],
                                                cache["mamba"].state[i]))
        if return_cache:
            cache["k"][i] = k
            cache["v"][i] = v
    h = _mamba_layers(cfg, params.tail_blocks, h,
                      cache["tail"] if return_cache else None, last=True)
    return h, torch.zeros((), device=x.device), cache


def _ln(x, p: LN):
    return layer_norm(x, p.scale, p.bias)


def _gelu(x, p: GeluMLP):
    return gelu_mlp(x, p.w_in, p.b_in, p.w_out, p.b_out)


def encode_audio(cfg: ModelConfig, params: LM, frames,
                 attn_backend: str = "cuda"):
    """whisper's encoder over the stub frontend's frame embeddings (B,
    S_enc, frontend_dim): the projector, sinusoidal positions, then per
    layer non-causal self-attention and a GELU MLP; the final LayerNorm.
    The frames are taken in the model's dtype (JAX would promote the
    encoder to f32 for f32 frames under a bf16 model)."""
    x = frames.to(params.projector.dtype) @ params.projector
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(x.dtype)[None]
    for p in params.enc_blocks:
        a, _, _ = _gqa_full(_ln(x, p.ln1), p.attn, cfg, None, _BIG_WINDOW,
                            causal=False, backend=attn_backend)
        x = x + a
        x = x + _gelu(_ln(x, p.ln2), p.mlp)
    return _ln(x, params.enc_final_ln)


def _dec_layer(cfg: ModelConfig, p: DecBlock, x, enc_out,
               attn_backend: str, last: bool):
    """whisper's decoder layer.  Returns (x, k, v, cross k, cross v)."""
    a, k, v = _gqa_full(_ln(x, p.ln1), p.self_attn, cfg, None, _BIG_WINDOW,
                        backend=attn_backend)
    x = x + a
    ck, cv = _cross_kv(enc_out, p.cross_attn, cfg)
    x = x + _cross_attn(_ln(x, p.ln2), p.cross_attn, cfg, ck, cv,
                        attn_backend)
    return _add(x, _gelu(_ln(x, p.ln3), p.mlp), last), k, v, ck, cv


def _audio_forward(cfg: ModelConfig, params: LM, batch: Dict, *,
                   return_cache: bool, return_hidden: bool,
                   attn_backend: str, remat: bool):
    """whisper's forward: the encoder (never checkpointed, as in JAX),
    then per decoder layer (under ``remat``, checkpointed) causal
    self-attention (no rope: sinusoidal positions on the embeddings),
    non-causal cross-attention to the encoder's output and a GELU MLP;
    the final LayerNorm (``final_norm`` is unused, as in JAX)."""
    dev = params.embed.device
    enc_out = encode_audio(cfg, params,
                           torch.as_tensor(batch["frames"], device=dev),
                           attn_backend)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    x = embed_tokens(params.embed, tokens)
    B, S = x.shape[:2]
    x = x + sinusoidal_positions(S, cfg.d_model, dev).to(x.dtype)[None]
    cache = None
    if return_cache:
        cache = {n: torch.empty(shape, dtype=x.dtype, device=dev)
                 for n, shape in _cache_shapes(cfg, B, S,
                                               enc_out.shape[1]).items()}
    for l, p in enumerate(params.dec_blocks):
        x, k, v, ck, cv = _body(remat, _dec_layer, cfg, p, x, enc_out,
                                attn_backend,
                                l == len(params.dec_blocks) - 1)
        if return_cache:
            cache["k"][l], cache["v"][l] = k, v
            cache["cross_k"][l], cache["cross_v"][l] = ck, cv
    x = _ln(x, params.dec_final_ln).to(params.embed.dtype)
    out = x if return_hidden else unembed(cfg, params, x)
    zero = torch.zeros((), device=dev)
    return (out, zero, cache) if return_cache else (out, zero)


# ======================================================================
# KV cache and the decode step
# ======================================================================

def init_cache(cfg: ModelConfig, batch: int, seq: int,
               enc_len: Optional[int] = None, *, device="cuda"):
    """The zeroed cache in ``cfg.dtype`` (the SSM states in f32): dense
    {"k", "v"}: (L, batch, seq, K, hd); llama4 {"k", "v"}: (L / 2, 2,
    batch, seq, K, hd); deepseek-v2 {"first_c_kv", "c_kv"}: (layers,
    batch, seq, kv_lora) and {"first_k_rope", "k_rope"}: (layers, batch,
    seq, rope); ssm {"ssm": SSMCache}; hybrid {"k", "v"}: (n_super,
    batch, seq, K, hd), {"mamba", "tail": SSMCache}; audio {"k", "v"}
    and {"cross_k", "cross_v"} with ``enc_len`` rows (default the
    config's ``n_frontend_tokens``)."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    cache = {n: torch.zeros(shape, dtype=dtype, device=dev)
             for n, shape in _cache_shapes(cfg, batch, seq,
                                           enc_len).items()}
    cache.update(_ssm_caches(cfg, batch, dtype, dev))
    return cache


def decode_step(cfg: ModelConfig, params: LM, cache: Dict, batch: Dict, *,
                attn_backend: str = "cuda"):
    """batch = {"token": (B, 1) int, "pos": an int or (B,) ints}.

    Returns (logits (B, 1, V) f32, cache).  Unlike JAX, which returns a
    new cache, the step writes each layer's new entries into ``cache``
    in place (saving a copy of the whole cache per token) and returns
    the same dict.  ``attn_backend`` is audio's cross-attention route
    (the flash kernel, "cuda", or its plain version, "ref"); the other
    families' decode attention is plain PyTorch, as in JAX."""
    dev = params.embed.device
    token = torch.as_tensor(batch["token"], device=dev)
    pos = torch.as_tensor(batch["pos"], device=dev)
    x = embed_tokens(params.embed, token, _embed_scale(cfg))
    if cfg.family == "moe":
        x = _moe_decode(cfg, params, cache, x, pos)
    elif cfg.family == "ssm":
        x = _mamba_decode(cfg, params.blocks, cache["ssm"], x, last=True)
    elif cfg.family == "hybrid":
        x = _hybrid_decode(cfg, params, cache, x, pos)
    elif cfg.family == "audio":
        x = _audio_decode(cfg, params, cache, x, pos, attn_backend)
    else:
        x = _dense_decode(cfg, params, cache, x, pos)
    x = _final_norm_decode(cfg, params, x).to(params.embed.dtype)
    return unembed(cfg, params, x), cache


def _dense_decode(cfg: ModelConfig, params: LM, cache: Dict, x, pos):
    windows, thetas = layer_meta(cfg)
    for l, (p, window, theta) in enumerate(zip(params.blocks, windows,
                                               thetas)):
        a, _, _ = _gqa_decode(rms_norm(x, p.pre_attn_norm, cfg.norm_eps),
                              p.attn, cfg, pos, theta, window,
                              cache["k"][l], cache["v"][l])
        x = x + a
        x = _add(x, swiglu_mlp(rms_norm(x, p.pre_mlp_norm, cfg.norm_eps),
                               p.mlp.w_gate, p.mlp.w_up, p.mlp.w_down),
                 l == len(params.blocks) - 1)
    return x


def _final_norm_decode(cfg: ModelConfig, params: LM, x):
    if cfg.family == "audio":
        return _ln(x, params.dec_final_ln)
    return rms_norm(x, params.final_norm, cfg.norm_eps)


def _mamba_decode(cfg: ModelConfig, blocks, caches: SSMCache, h,
                  last: bool = False):
    """One token through Mamba-2 ``blocks``, each layer's conv window and
    state written into ``caches`` (stacked over these layers) in place
    (``last``: these layers end the stack).
    The recurrence has no positions: a slot's state advances whatever
    token it is fed."""
    for l, p in enumerate(blocks):
        c = SSMCache(caches.conv[l], caches.state[l])
        o, new = ssm_mod.mamba2_decode(rms_norm(h, p.pre_norm, cfg.norm_eps),
                                       p.ssm, cfg, c)
        c.conv.copy_(new.conv)
        c.state.copy_(new.state)
        h = _add(h, o, last and l == len(blocks) - 1)
    return h


def _hybrid_decode(cfg: ModelConfig, params: LM, cache: Dict, x, pos):
    """zamba2's decode: per super-block its Mamba-2 layers, then the
    shared attention's GQA decode with the super-block's LoRA; then the
    tail."""
    n_super, _ = _hybrid_layout(cfg)
    shared, eps = params.shared_attn, cfg.norm_eps
    h = x
    for i in range(n_super):
        h = _mamba_decode(cfg, params.mamba_blocks[i],
                          SSMCache(cache["mamba"].conv[i],
                                   cache["mamba"].state[i]), h)
        a, _, _ = _gqa_decode(rms_norm(h, shared.pre_attn_norm, eps),
                              shared.attn, cfg, pos, cfg.rope_theta,
                              _BIG_WINDOW, cache["k"][i], cache["v"][i],
                              lora=params.lora[i])
        h = h + a
        h = _add(h, swiglu_mlp(rms_norm(h, shared.pre_mlp_norm, eps),
                               shared.mlp.w_gate, shared.mlp.w_up,
                               shared.mlp.w_down),
                 i == n_super - 1 and not len(params.tail_blocks))
    return _mamba_decode(cfg, params.tail_blocks, cache["tail"], h,
                         last=True)


def _audio_decode(cfg: ModelConfig, params: LM, cache: Dict, x, pos,
                  attn_backend: str):
    """whisper's decode: the sinusoidal position of each slot's ``pos``,
    then per decoder layer the self-attention's GQA decode (no rope), the
    cross-attention of the one new token against the layer's cached
    encoder (k, v) (non-causal, through ``attn_backend``) and the MLP.
    The cross caches are read, never written."""
    B = x.shape[0]
    pos_vec = pos.long().broadcast_to((B,))
    table = sinusoidal_positions(cache["k"].shape[2], cfg.d_model, x.device)
    h = x + table[pos_vec][:, None].to(x.dtype)
    for l, p in enumerate(params.dec_blocks):
        a, _, _ = _gqa_decode(_ln(h, p.ln1), p.self_attn, cfg, pos, None,
                              _BIG_WINDOW, cache["k"][l], cache["v"][l])
        h = h + a
        h = h + _cross_attn(_ln(h, p.ln2), p.cross_attn, cfg,
                            cache["cross_k"][l], cache["cross_v"][l],
                            attn_backend)
        h = _add(h, _gelu(_ln(h, p.ln3), p.mlp),
                 l == len(params.dec_blocks) - 1)
    return h


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
        final = [*params.first_blocks, *params.blocks][-1]
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
                    mo = moe_block(hn, p.moe, cfg)[0]
                else:
                    mo = swiglu_mlp(hn, p.mlp.w_gate, p.mlp.w_up,
                                    p.mlp.w_down)
                h = _add(h, mo, p is final)
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
        h = _add(h, moe_block(rms_norm(h, ma.pre_mlp_norm, eps), p.moe,
                              cfg)[0], i == len(params.super_blocks) - 1)
    return h
