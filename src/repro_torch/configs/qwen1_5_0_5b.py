"""qwen1.5-0.5b — dense, 24L d_model=1024 16H (kv=16) d_ff=2816
vocab=151936, QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151_936,
    layer_pattern=(("attn", "dense"),),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    notes="QKV bias; tied embeddings; MHA (kv == q heads).",
)
