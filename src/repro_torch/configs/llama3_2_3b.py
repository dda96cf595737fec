"""llama3.2-3b — dense, 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-3B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128_256,
    layer_pattern=(("attn", "dense"),),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    tie_embeddings=True,
    rope_theta=500_000.0,
    notes="small llama3: GQA kv=8, RoPE theta 500k, tied embeddings.",
)
