"""Model configuration schema shared by all eleven architectures.

A model is a stack of ``n_layers`` blocks described by a repeating
``layer_pattern`` of (mixer, mlp) pairs — the *period*. Scan-over-layers
iterates periods (keeps HLO size O(period), compile time flat in depth):

  mixer ∈ {"attn", "mla", "mamba", "slstm", "mlstm"}
  mlp   ∈ {"dense", "moe", "none"}

Dense transformers have pattern ``(("attn","dense"),)``; Jamba's 1:7
attention:Mamba interleave with MoE every other layer is an 8-entry pattern.
``dense_prefix`` leading layers (DeepSeek's ``first_k_dense_replace``) run
the pattern's first mixer with a dense MLP of ``d_ff`` before the periods
start. ``"mla"`` is DeepSeek-V2/V3's latent attention (:class:`MLAConfig`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

Mixer = str
Mlp = str


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block settings: expert count, routing top-k,
    shared experts, expert width and dispatch capacity."""
    n_experts: int
    top_k: int
    n_shared: int = 0            # always-on shared experts (DeepSeekMoE)
    d_expert: int = 0            # expert FFN width (0 -> use d_ff)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # "softmax" (the Switch loss over each token's first expert) or
    # "sigmoid" (DeepSeek-V3: gates from sigmoid scores, the top k chosen
    # by score + a balancing bias, the sequence-wise balance loss).
    scoring: str = "softmax"
    routed_scale: float = 1.0    # gates times this (routed_scaling_factor)
    aux_weight: Optional[float] = None   # None: the train step's 0.01
    # gamma of the balancing bias's update (sigmoid scoring only): after
    # each step b_e += gamma * sign(mean load - load_e), outside AdamW.
    bias_update_speed: float = 0.0
    # The experts this chip holds of an expert-parallel group: experts
    # held_offset .. held_offset + n_held - 1 of the n_experts the router
    # scores (0: all of them). The layer routes over all n_experts and
    # computes its held experts' part of the result.
    n_held: int = 0
    held_offset: int = 0

    @property
    def held(self) -> int:
        """How many experts this chip holds (their weight stacks' rows)."""
        return self.n_held or self.n_experts

    @property
    def partial(self) -> bool:
        """Whether the layer holds only part of the experts."""
        return self.held < self.n_experts


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2/V3) without a query LoRA:
    a ``kv_rank``-wide normed latent, per-head no-RoPE key and value parts
    projected up from it, and one ``rope_dim``-wide RoPE key shared by
    every head. q and k heads are ``nope_dim + rope_dim`` wide, value
    heads ``v_dim``."""
    kv_rank: int
    nope_dim: int
    rope_dim: int
    v_dim: int

    @property
    def qk_dim(self) -> int:
        """The q and k head width."""
        return self.nope_dim + self.rope_dim


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """Mamba (selective state-space) block settings."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture: widths, depth, the repeating (mixer, mlp) layer
    pattern, and the execution knobs the model code reads."""
    name: str
    family: str                  # dense | moe | ssm | audio | hybrid | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    layer_pattern: Tuple[Tuple[Mixer, Mlp], ...] = (("attn", "dense"),)
    head_dim: int = 0            # 0 -> d_model // n_heads
    mlp_type: str = "swiglu"     # swiglu | relu2 | gelu
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm | nonparam_ln
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    max_seq_len: int = 32_768
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    mla: Optional[MLAConfig] = None
    dense_prefix: int = 0        # leading dense-MLP layers (d_ff wide)
    frontend: Optional[str] = None      # None | audio_frames | vision_patches
    encoder_only: bool = False
    # xLSTM block projection factor (mLSTM up-projection, paper uses 2).
    xlstm_proj_factor: float = 2.0
    # mLSTM execution: "auto" (chunkwise for S >= 128), "chunkwise",
    # "sequential" (the pre-hillclimb baseline; see EXPERIMENTS.md §Perf A1).
    mlstm_impl: str = "auto"
    # MoE dispatch: "sort" (scatter/gather slots) or "einsum" (GShard
    # one-hot baseline; see EXPERIMENTS.md §Perf B1).
    moe_dispatch: str = "sort"
    # Decode KV-cache write: "scatter" (indexed, in-place) or "onehot"
    # (baseline full-cache blend; see EXPERIMENTS.md §Perf C1).
    kv_update: str = "scatter"
    # Megatron-style sequence parallelism: constrain the residual stream's
    # sequence axis onto the TP mesh axis between blocks, so norms/residual
    # traffic shard 1/TP and the TP all-reduce splits into RS+AG
    # (EXPERIMENTS.md §Perf D). Requires a mesh with a "model" axis.
    seq_parallel: bool = False
    # Notes for DESIGN.md §Arch-applicability (free text, not used by code).
    notes: str = ""

    def __post_init__(self):
        if (self.n_layers - self.dense_prefix) % len(self.layer_pattern) \
                != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern period {len(self.layer_pattern)}")
        for mixer, mlp in self.layer_pattern:
            if mixer not in ("attn", "mla", "mamba", "slstm", "mlstm"):
                raise ValueError(f"unknown mixer {mixer!r}")
            if mlp not in ("dense", "moe", "none"):
                raise ValueError(f"unknown mlp {mlp!r}")
            if mlp == "moe" and self.moe is None:
                raise ValueError(f"{self.name}: moe block without MoEConfig")
            if mixer == "mamba" and self.mamba is None:
                raise ValueError(f"{self.name}: mamba block without MambaConfig")
            if mixer == "mla" and self.mla is None:
                raise ValueError(f"{self.name}: mla block without MLAConfig")

    @property
    def period(self) -> int:
        """Blocks per repeat of ``layer_pattern``."""
        return len(self.layer_pattern)

    @property
    def n_periods(self) -> int:
        """Repeats of ``layer_pattern`` in the stack (after the
        ``dense_prefix`` layers)."""
        return (self.n_layers - self.dense_prefix) // self.period

    @property
    def layer_kinds(self) -> Tuple[Tuple[Mixer, Mlp], ...]:
        """(mixer, mlp) of every layer, in order: the ``dense_prefix``
        layers, then the periods."""
        head = ((self.layer_pattern[0][0], "dense"),) * self.dense_prefix
        return head + tuple(self.layer_pattern) * self.n_periods

    @property
    def resolved_head_dim(self) -> int:
        """``head_dim``, or ``d_model // n_heads`` when it is 0."""
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_expert_resolved(self) -> int:
        """Expert FFN width (``moe.d_expert``, else ``d_ff``)."""
        assert self.moe is not None
        return self.moe.d_expert or self.d_ff

    @property
    def attention_dims(self) -> Tuple[int, int]:
        """(q/k head width, value head width) of the attention mixers."""
        if self.mla is not None:
            return self.mla.qk_dim, self.mla.v_dim
        return self.resolved_head_dim, self.resolved_head_dim

    @property
    def uses_attention(self) -> bool:
        """True when any block of the pattern is (rotary) attention."""
        return any(m in ("attn", "mla") for m, _ in self.layer_pattern)

    @property
    def subquadratic(self) -> bool:
        """True if no full-attention *training* path is quadratic in seq —
        i.e. the long_500k shape is runnable (SSM / hybrid archs)."""
        return all(m != "attn" for m, _ in self.layer_pattern) or \
            self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs and memory
        budgeting in the roofline report)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        q_dim = self.n_heads * hd
        kv_dim = self.n_kv_heads * hd
        total = v * d                       # embed
        if not self.tie_embeddings and not self.encoder_only:
            total += v * d                  # unembed
        if self.encoder_only:
            total += d * v                  # output head
        per_pattern = []
        for mixer, mlp in self.layer_kinds[:self.dense_prefix + self.period]:
            p = 0
            if mixer == "mla":
                m = self.mla
                p += d * self.n_heads * m.qk_dim          # wq
                p += d * (m.kv_rank + m.rope_dim)         # wkv_a
                p += m.kv_rank                            # kv_norm
                p += m.kv_rank * self.n_heads * (m.nope_dim + m.v_dim)
                p += self.n_heads * m.v_dim * d           # wo
            elif mixer == "attn":
                p += d * (q_dim + 2 * kv_dim) + q_dim * d
                if self.qkv_bias:
                    p += q_dim + 2 * kv_dim
            elif mixer == "mamba":
                assert self.mamba is not None
                di = self.mamba.expand * d
                p += d * 2 * di                    # in_proj (x and z)
                p += di * self.mamba.d_conv        # conv
                p += di * (self.mamba.d_state * 2 + 1)   # B, C, dt proj (approx)
                p += di * self.mamba.d_state       # A
                p += di * d                        # out_proj
            elif mixer in ("slstm", "mlstm"):
                dp = int(self.xlstm_proj_factor * d)
                p += d * dp * 2 + dp * d           # up (x2) + down
                p += 4 * dp * dp if mixer == "slstm" else 3 * dp * dp
            if mlp == "dense":
                mult = 3 if self.mlp_type == "swiglu" else 2
                p += mult * d * dff
            elif mlp == "moe":
                assert self.moe is not None
                de = self.d_expert_resolved
                mult = 3 if self.mlp_type == "swiglu" else 2
                p += (self.moe.held + self.moe.n_shared) * mult * d * de
                p += d * self.moe.n_experts        # router
            p += 2 * d if self.norm_type != "nonparam_ln" else 0  # norms
            per_pattern.append(p)
        total += sum(per_pattern[:self.dense_prefix])
        total += self.n_periods * sum(per_pattern[self.dense_prefix:])
        total += d if self.norm_type != "nonparam_ln" else 0      # final norm
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE top-k instead of all experts;
        of a chip's held experts, the top-k's share of them)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        de = self.d_expert_resolved
        mult = 3 if self.mlp_type == "swiglu" else 2
        n_moe_layers = self.n_periods * sum(
            1 for _, mlp in self.layer_pattern if mlp == "moe")
        all_e = n_moe_layers * self.moe.held * mult * self.d_model * de
        expert = mult * self.d_model * de
        act_e = n_moe_layers * (self.moe.top_k * self.moe.held * expert //
                                self.moe.n_experts +
                                self.moe.n_shared * expert)
        shared = n_moe_layers * self.moe.n_shared * mult * self.d_model * de
        return full - (all_e + shared) + act_e
