"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.

Source: [arXiv:2411.15242]: 81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000 ssm_state=64.  A single shared attention block (with
per-invocation LoRA deltas) is applied every 6 Mamba2 layers.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32_000,
    ssm=SSMConfig(d_state=64, d_inner=7168, n_heads=112, head_dim=64,
                  d_conv=4, chunk_size=256),
    attn_interval=6,             # shared attn block every 6 ssm layers
    shared_attn_lora_rank=128,
)
