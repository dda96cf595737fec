"""jamba-1.5-large-398b — hybrid, 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, Mamba:attention 7:1 interleave, MoE 16e top-2 every
other layer [arXiv:2403.19887]."""
from repro_torch.configs.base import ModelConfig, MambaConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    # Jamba period: 8 layers = 7 Mamba + 1 attention (index 3), MoE on odd.
    layer_pattern=(
        ("mamba", "dense"), ("mamba", "moe"),
        ("mamba", "dense"), ("attn", "moe"),
        ("mamba", "dense"), ("mamba", "moe"),
        ("mamba", "dense"), ("mamba", "moe"),
    ),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_expert=24_576),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    notes="hybrid: KV cache only for 1-in-8 layers; long_500k runnable "
          "(attention KV sharded over sequence, Mamba state O(1)).",
)
