"""llava-next-34b [vlm] — anyres tiling; ViT encoder + projector are STUBS.

Source: [hf:llava-hf/llava-v1.6-mistral-7b-hf] family card at the assigned
34B backbone shape: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
input_specs() supplies precomputed patch embeddings (anyres: base 576 patches
+ up to 4 tiles -> 2880 image tokens).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-34b",
    family="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
    frontend="vision",
    frontend_dim=1024,           # CLIP/SigLIP patch embedding dim
    n_frontend_tokens=2880,      # anyres: 576 base + 4x576 tiles
)
