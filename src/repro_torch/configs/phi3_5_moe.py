"""phi3.5-moe-42b-a6.6b — MoE, 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32_064,
    layer_pattern=(("attn", "moe"),),
    mlp_type="swiglu",
    norm_type="layernorm",
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_expert=6400),
    notes="16 experts top-2, no shared experts.",
)
