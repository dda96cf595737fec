"""moonlight-16b-a3b — MoE with latent attention (DeepSeek-V3's layer),
27L d_model=2048 16H, MLA (kv rank 512, q/k heads 128 + 64 RoPE, value
heads 128, no query LoRA), 1 leading dense layer (d_ff=11264) then 26 MoE
layers of 64 routed experts (1408 wide, top-6, sigmoid scores with a
balancing bias, gates renormalised and scaled by 2.446) and 2 shared,
vocab=163840, rope_theta=50000 [hf:moonshotai/Moonlight-16B-A3B;
arXiv:2502.16982, arXiv:2412.19437].

Departures from the published model:

- RoPE rotates the two halves of the 64-wide slice (the port's layout);
  HF's ``deepseek_v3`` rotates interleaved pairs, a fixed permutation of
  the slice's columns.
- Expert capacity 1.25 x top_k x T / 64 slots an expert (the port's
  dispatch, queue order (t, k)); the published model is dropless.
- The balance loss's weight (0.001, the ``deepseek_v3`` configuration
  class's default) and the bias's update speed (0.001, DeepSeek-V3's
  setting for most of its pre-training) are not in the published file.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonlight-16b-a3b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11264,
    vocab_size=163_840,
    layer_pattern=(("mla", "moe"),),
    dense_prefix=1,
    head_dim=192,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=50_000.0,
    max_seq_len=8192,
    mla=MLAConfig(kv_rank=512, nope_dim=128, rope_dim=64, v_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408,
                  scoring="sigmoid", routed_scale=2.446, aux_weight=0.001,
                  bias_update_speed=0.001),
    notes="latent attention, sigmoid router with a balancing bias, "
          "1 leading dense layer.",
)
