"""nemotron-4-340b — dense, 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000, squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73_728,
    vocab_size=256_000,
    layer_pattern=(("attn", "dense"),),
    mlp_type="relu2",
    norm_type="layernorm",
    rope_theta=10_000.0,
    notes="squared-ReLU MLP (no gate); GQA kv=8; largest dense arch.",
)
