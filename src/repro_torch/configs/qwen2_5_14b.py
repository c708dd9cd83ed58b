"""qwen2.5-14b [dense] — GQA with QKV bias.

Source: [hf:Qwen/Qwen2.5-0.5B] family card at the assigned 14B shape:
48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064, QKV bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-14b",
    family="dense",
    source="hf:Qwen/Qwen2.5-0.5B",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152_064,
    rope_theta=1_000_000.0,
    qkv_bias=True,
)
