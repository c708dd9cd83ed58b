"""granite-8b [dense] — llama-arch, code model.

Source: [arXiv:2405.04324]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-8b",
    family="dense",
    source="arXiv:2405.04324",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49_152,
    rope_theta=10_000_000.0,
    tie_embeddings=True,
)
