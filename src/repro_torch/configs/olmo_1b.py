"""olmo-1b — dense, 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304,
non-parametric LayerNorm [arXiv:2402.00838]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50_304,
    layer_pattern=(("attn", "dense"),),
    mlp_type="swiglu",
    norm_type="nonparam_ln",
    tie_embeddings=True,
    rope_theta=10_000.0,
    notes="non-parametric LN (no learnable scale/bias).",
)
