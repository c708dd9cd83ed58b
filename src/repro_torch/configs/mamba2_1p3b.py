"""mamba2-1.3b [ssm] — attention-free, SSD (state-space duality).

Source: [arXiv:2405.21060]: 48L d_model=2048 d_ff=0 vocab=50280
ssm_state=128, expand=2 (d_inner=4096), head_dim=64 (64 heads).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-1.3b",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=48,
    d_model=2048,
    n_heads=1,                   # attn-free; unused
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50_280,
    ssm=SSMConfig(d_state=128, d_inner=4096, n_heads=64, head_dim=64,
                  d_conv=4, chunk_size=256),
    tie_embeddings=True,
)
