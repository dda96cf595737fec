"""deepseek-moe-16b — MoE, 28L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=102400, 2 shared + 64 routed top-6 fine-grained [arXiv:2401.06066].

Deviation noted in DESIGN.md: the HF model uses a dense first layer
(d_ff=10944); we apply the MoE pattern uniformly so the period stays 1."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102_400,
    layer_pattern=(("attn", "moe"),),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408),
    notes="fine-grained experts (d_expert=1408), 2 shared always-on.",
)
