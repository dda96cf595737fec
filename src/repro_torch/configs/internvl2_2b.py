"""internvl2-2b — VLM, 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553: InternViT frontend (stub) + InternLM2-1.8B-style decoder
[arXiv:2404.16821].

The vision tower is a stub per the assignment: ``input_specs`` supplies
projector-output patch embeddings (B, 256, d_model) prepended to the text."""
from repro_torch.configs.base import ModelConfig

N_PATCHES = 256

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92_553,
    layer_pattern=(("attn", "dense"),),
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=1_000_000.0,
    frontend="vision_patches",
    notes="decoder backbone only; 256 patch embeddings prepended.",
)
