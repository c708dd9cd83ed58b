"""smollm-360m [dense] — llama-arch small model.

Source: [hf:HuggingFaceTB/SmolLM-135M] family card, assigned 360M shape:
32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-360m",
    family="dense",
    source="hf:HuggingFaceTB/SmolLM-135M",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49_152,
    tie_embeddings=True,
)
