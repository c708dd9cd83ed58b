"""whisper-base [audio] — encoder-decoder; conv/mel frontend is a STUB.

Source: [arXiv:2212.04356]: 6L (enc) + 6L (dec) d_model=512 8H d_ff=2048
vocab=51865.  input_specs() supplies precomputed frame embeddings (the mel +
conv feature extractor is the allowed stub).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-base",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=6,                  # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51_865,
    qkv_bias=True,
    is_encoder_decoder=True,
    n_encoder_layers=6,
    frontend="audio",
    frontend_dim=512,            # post-conv frame embedding dim
    n_frontend_tokens=1500,      # 30s audio -> 1500 frames
)
