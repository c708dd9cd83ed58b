"""gemma3-4b [dense] — 5:1 local:global attention, 128k context.

Source: [hf:google/gemma-3-1b-pt] family card, scaled to the assigned 4B shape:
34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, head_dim=256,
sliding_window=1024, every 6th layer global.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-4b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262_144,
    rope_theta=1_000_000.0,
    sliding_window=1024,
    global_interval=6,       # 5 local : 1 global
    tie_embeddings=True,
)
