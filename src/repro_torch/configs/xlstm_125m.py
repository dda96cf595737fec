"""xlstm-125m — SSM family, 12L d_model=768 4H vocab=50304, sLSTM + mLSTM
blocks (d_ff=0: projections live inside the xLSTM blocks)
[arXiv:2405.04517]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    # 3:1 mLSTM:sLSTM interleave; no separate FFN (pattern mlp='none').
    layer_pattern=(("mlstm", "none"), ("mlstm", "none"),
                   ("mlstm", "none"), ("slstm", "none")),
    mlp_type="gelu",
    norm_type="layernorm",
    tie_embeddings=True,
    xlstm_proj_factor=2.0,
    notes="attention-free; O(1) decode state; long_500k runnable.",
)
