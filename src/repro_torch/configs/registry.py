"""Architecture registry: ``--arch <id>`` resolution and reduced (smoke)
variants that preserve each architecture's structure."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import (MambaConfig, MLAConfig, ModelConfig,
                                      MoEConfig)
from repro_torch.configs.qwen1_5_0_5b import CONFIG as QWEN
from repro_torch.configs.nemotron_4_340b import CONFIG as NEMOTRON
from repro_torch.configs.olmo_1b import CONFIG as OLMO
from repro_torch.configs.llama3_2_3b import CONFIG as LLAMA
from repro_torch.configs.deepseek_moe_16b import CONFIG as DEEPSEEK
from repro_torch.configs.phi3_5_moe import CONFIG as PHI
from repro_torch.configs.xlstm_125m import CONFIG as XLSTM
from repro_torch.configs.hubert_xlarge import CONFIG as HUBERT
from repro_torch.configs.jamba_1_5_large import CONFIG as JAMBA
from repro_torch.configs.internvl2_2b import CONFIG as INTERNVL
from repro_torch.configs.moonlight_16b_a3b import CONFIG as MOONLIGHT

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in (
    QWEN, NEMOTRON, OLMO, LLAMA, DEEPSEEK, PHI, XLSTM, HUBERT, JAMBA,
    INTERNVL, MOONLIGHT)}


def get(name: str) -> ModelConfig:
    """The registered config named ``name``; KeyError naming the known
    ones otherwise."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> List[str]:
    """Registered architecture names, sorted."""
    return sorted(ARCHS)


def reduced(cfg: ModelConfig, d_model: int = 64, n_periods: int = 2,
            vocab: int = 256) -> ModelConfig:
    """Shrink a config for CPU smoke tests, preserving family, pattern,
    norm/mlp kinds, bias flags, and GQA ratio. A latent-attention config
    keeps its head widths (the attention kernels' (192, 128) pair) and
    gets a 32-wide latent; routing keeps its scoring, scale and bias, and
    a chip's share of the experts stays a share (half of the reduced
    experts)."""
    ratio = max(1, cfg.n_heads // cfg.n_kv_heads)
    n_heads = 4
    n_kv = max(1, n_heads // ratio)
    moe = None
    if cfg.moe is not None:
        # capacity_factor high enough that smoke tests never drop tokens —
        # keeps teacher-forced decode bit-consistent with parallel forward.
        n_exp = min(8, cfg.moe.n_experts)
        moe = dataclasses.replace(
            cfg.moe, n_experts=n_exp, top_k=min(2, cfg.moe.top_k),
            n_shared=min(1, cfg.moe.n_shared),
            d_expert=d_model * 2 if cfg.moe.d_expert else 0,
            capacity_factor=8.0,
            n_held=n_exp // 2 if cfg.moe.partial else 0, held_offset=0)
    mamba = MambaConfig(d_state=8, d_conv=4, expand=2) if cfg.mamba else None
    mla = dataclasses.replace(cfg.mla, kv_rank=32) if cfg.mla else None
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=cfg.dense_prefix + n_periods * cfg.period,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=cfg.mla.qk_dim if cfg.mla else 0,
        mla=mla,
        d_ff=d_model * 4 if cfg.d_ff else 0,
        vocab_size=vocab,
        max_seq_len=512,
        moe=moe,
        mamba=mamba,
    )
