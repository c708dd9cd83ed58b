"""llama4-maverick-400b-a17b [moe] — interleaved MoE, early fusion.

Source: [hf:meta-llama/Llama-4-Scout-17B-16E] family card, assigned Maverick
shape: 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, 128 routed
experts top-1 + 1 shared expert, MoE every other layer (interleave step 2,
matching the ~400B-total / 17B-active budget).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,                   # dense-layer hidden size
    vocab_size=202_048,
    rope_theta=500_000.0,
    moe=MoEConfig(
        n_experts=128,
        top_k=1,
        n_shared_experts=1,
        d_ff_expert=8192,
        period=2,                # MoE every other layer
        d_ff_dense=16384,        # interleaved dense MLPs
    ),
)
