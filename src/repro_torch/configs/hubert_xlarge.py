"""hubert-xlarge — audio, encoder-only, 48L d_model=1280 16H d_ff=5120
vocab=504 (masked-unit prediction targets) [arXiv:2106.07447].

The CNN waveform frontend is a stub: ``input_specs`` provides precomputed
frame embeddings (B, S, d_model), per the assignment."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    layer_pattern=(("attn", "dense"),),
    mlp_type="gelu",
    norm_type="layernorm",
    encoder_only=True,
    frontend="audio_frames",
    notes="encoder-only (bidirectional attention); no decode shapes.",
)
