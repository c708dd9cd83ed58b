"""Config dataclasses for the architecture zoo and the input-shape suite.

Every assigned architecture gets one file in this package instantiating
:class:`ModelConfig` with the exact assigned numbers (source cited in the
file header).  ``reduced()`` derives the CPU smoke-test variant (<=2 layers,
d_model<=512, <=4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    top_k: int = 1
    n_shared_experts: int = 0
    d_ff_expert: int = 0          # per-expert hidden size
    period: int = 1               # MoE every `period` layers (1 = every layer)
    first_dense_layers: int = 0   # leading dense layers (deepseek-v2)
    capacity_factor: float = 1.25
    d_ff_dense: int = 0           # hidden size of the interleaved dense MLPs


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention dims [arXiv:2405.04434]."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD dims [arXiv:2405.21060]."""
    d_state: int = 128
    d_inner: int = 0              # = expand * d_model
    n_heads: int = 0              # d_inner // head_dim
    head_dim: int = 64
    d_conv: int = 4
    chunk_size: int = 256
    n_groups: int = 1             # B/C groups


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    source: str                   # citation for the numbers
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- sliding-window / local-global pattern (gemma3) ---
    sliding_window: Optional[int] = None
    global_interval: int = 0      # every Nth layer is global (0 = all global)
    # --- MoE ---
    moe: Optional[MoEConfig] = None
    # --- MLA (replaces GQA when set) ---
    mla: Optional[MLAConfig] = None
    # --- SSM / hybrid ---
    ssm: Optional[SSMConfig] = None
    attn_interval: int = 0        # hybrid: shared attn block every N ssm layers
    shared_attn_lora_rank: int = 0
    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    # --- modality frontend stub ---
    frontend: Optional[str] = None   # 'audio' | 'vision'
    frontend_dim: int = 0            # raw embedding dim fed to the projector
    n_frontend_tokens: int = 0       # image/audio token budget inside the sequence
    # --- numerics ---
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM, hybrid, or sliding-window dense)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def has_decode(self) -> bool:
        """Encoder-only archs have no decode step; all assigned archs decode."""
        return True

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for rooflines."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for layer in range(self.n_layers):
            n += self._layer_params(layer)
        if self.is_encoder_decoder:
            for _ in range(self.n_encoder_layers):
                n += self._attn_params() + 2 * self.d_ff * d + d * self.d_ff
        if self.frontend:
            n += self.frontend_dim * d  # projector stub
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        m = self.moe
        for layer in range(self.n_layers):
            n += self._attn_params()
            if self._is_moe_layer(layer):
                active = m.top_k + m.n_shared_experts
                n += active * 3 * d * m.d_ff_expert + d * m.n_experts  # + router
            else:
                n += 3 * d * (m.d_ff_dense or self.d_ff)
        return n

    def _is_moe_layer(self, layer: int) -> bool:
        if self.moe is None:
            return False
        if layer < self.moe.first_dense_layers:
            return False
        return (layer - self.moe.first_dense_layers) % self.moe.period == 0

    def _attn_params(self) -> int:
        d = self.d_model
        hd = self.resolved_head_dim
        if self.mla is not None:
            a = self.mla
            qh = a.nope_head_dim + a.rope_head_dim
            n = d * a.q_lora_rank + a.q_lora_rank * self.n_heads * qh
            n += d * (a.kv_lora_rank + a.rope_head_dim)
            n += a.kv_lora_rank * self.n_heads * (a.nope_head_dim + a.v_head_dim)
            n += self.n_heads * a.v_head_dim * d
            return n
        return d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d

    def _layer_params(self, layer: int) -> int:
        d = self.d_model
        if self.family == "ssm":
            s = self.ssm
            return 2 * d * s.d_inner + s.d_inner * d + s.d_inner * (2 * s.d_state)
        n = 0
        is_ssm_layer = self.family == "hybrid" and not self._is_hybrid_attn(layer)
        if is_ssm_layer:
            s = self.ssm
            n += 2 * d * s.d_inner + s.d_inner * d + s.d_inner * (2 * s.d_state)
        else:
            n += self._attn_params()
        if self.moe is not None and self._is_moe_layer(layer):
            m = self.moe
            n += (m.n_experts + m.n_shared_experts) * 3 * d * m.d_ff_expert
            n += d * m.n_experts
        elif not is_ssm_layer and self.d_ff:
            n += 3 * d * self.d_ff
        return n

    def _is_hybrid_attn(self, layer: int) -> bool:
        return self.attn_interval > 0 and (layer + 1) % self.attn_interval == 0

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        changes = dict(
            n_layers=2,
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_encoder_layers=min(self.n_encoder_layers, 2),
            frontend_dim=min(self.frontend_dim, 128) if self.frontend_dim else 0,
            n_frontend_tokens=min(self.n_frontend_tokens, 16),
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else None,
            global_interval=min(self.global_interval, 2) if self.global_interval else 0,
            attn_interval=min(self.attn_interval, 2) if self.attn_interval else 0,
            shared_attn_lora_rank=min(self.shared_attn_lora_rank, 8)
            if self.shared_attn_lora_rank else 0,
        )
        if self.n_kv_heads == self.n_heads:     # MHA stays MHA
            changes["n_kv_heads"] = changes["n_heads"]
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                d_ff_expert=128, first_dense_layers=min(self.moe.first_dense_layers, 1),
                period=min(self.moe.period, 2) if self.moe.period > 1 else 1,
                d_ff_dense=min(self.moe.d_ff_dense, 256) if self.moe.d_ff_dense else 0,
            )
        if self.mla is not None:
            changes["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                       rope_head_dim=16, nope_head_dim=32,
                                       v_head_dim=32)
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, d_inner=2 * changes["d_model"],
                n_heads=(2 * changes["d_model"]) // 32, head_dim=32,
                chunk_size=16)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # 'train' | 'prefill' | 'decode'


INPUT_SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4_096, 256, "train"),
    InputShape("prefill_32k", 32_768, 32, "prefill"),
    InputShape("decode_32k", 32_768, 128, "decode"),
    InputShape("long_500k", 524_288, 1, "decode"),
)

SHAPES = {s.name: s for s in INPUT_SHAPES}
