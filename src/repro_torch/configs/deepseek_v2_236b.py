"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed top-6.

Source: [arXiv:2405.04434]: 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400; MLA q_lora=1536 kv_lora=512 rope_dim=64 nope_dim=128 v_dim=128;
first layer dense with d_ff=12288.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,              # MLA: all heads share the latent kv
    head_dim=192,                # nope 128 + rope 64
    d_ff=12288,                  # dense first-layer hidden size
    vocab_size=102_400,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(
        n_experts=160,
        top_k=6,
        n_shared_experts=2,
        d_ff_expert=1536,
        period=1,
        first_dense_layers=1,
        d_ff_dense=12288,
    ),
)
