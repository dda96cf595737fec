"""Model assembly for the attention + dense-MLP architectures.

The port of ``repro/models/model.py``. The reference scans over periods
of stacked per-period weights to keep its HLO small; PyTorch runs
eagerly, so here the stack is a loop over layers and ``params["layers"]``
holds one dict of tensors per layer (layer ``p * period + i`` is block
``b{i}`` of period ``p`` in the reference's pytree). Decode state is one
``{"k", "v"}`` cache per layer.

Ported mixers and MLPs: ``attn`` with ``dense`` (or ``none``). The
Mamba, mLSTM and sLSTM mixers, the MoE MLP and sequence parallelism
raise ``NotImplementedError``: their modules are later slices of the
port (``ROADMAP.md`` queue 1 item 7).

Every entry point runs on the card unless the caller passes
``device="cpu"``; ``impl="plain"`` runs the attention kernels' plain
versions instead of the kernels.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (Params, apply_mlp, apply_norm, embed,
                                       init_embedding, init_mlp, init_norm,
                                       rope_tables, unembed)

_ROADMAP = "ROADMAP.md queue 1 item 7"
_NOT_PORTED = {"mamba": "models/ssm.py", "mlstm": "models/ssm.py",
               "slstm": "models/ssm.py", "moe": "models/moe.py"}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet:
    SSM mixers, MoE MLPs and sequence parallelism."""
    for mixer, mlp in cfg.layer_pattern:
        for part in (mixer, mlp):
            if part in _NOT_PORTED:
                raise NotImplementedError(
                    f"{cfg.name}: {part!r} blocks are not ported yet "
                    f"({_NOT_PORTED[part]}, {_ROADMAP})")
    if cfg.seq_parallel:
        raise NotImplementedError(
            f"{cfg.name}: seq_parallel needs the sharding slice "
            f"({_ROADMAP}, Sharding and launch)")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain versions on the CPU")
    return dev


# ------------------------------------------------------------------- init --

def _init_block(gen: torch.Generator, cfg: ModelConfig, mlp: str,
                dtype: torch.dtype) -> Params:
    """One attention block's parameters."""
    dev = gen.device
    p: Params = {"norm1": init_norm(cfg.d_model, cfg.norm_type, dev),
                 "mixer": attn.init_attention(gen, cfg, dtype)}
    if mlp == "dense":
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype)
        p["norm2"] = init_norm(cfg.d_model, cfg.norm_type, dev)
    return p


def init_params(cfg: ModelConfig, seed: int = 0,
                dtype: torch.dtype = torch.bfloat16,
                device="cuda") -> Params:
    """Random parameters from a seeded ``torch.Generator`` on ``device``,
    with the reference's shapes, dtypes and init scales (the numbers
    differ from JAX's: the generators differ; ``convert`` carries the
    reference's own)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    layers: List[Params] = []
    for _ in range(cfg.n_periods):
        for _, mlp in cfg.layer_pattern:
            layers.append(_init_block(gen, cfg, mlp, dtype))
    params: Params = {"layers": layers,
                      "final_norm": init_norm(cfg.d_model, cfg.norm_type,
                                              dev)}
    if cfg.frontend != "audio_frames":
        params["embed"] = init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                         dtype)
    if cfg.encoder_only or cfg.frontend == "audio_frames":
        params["head"] = init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                        dtype)
    elif not cfg.tie_embeddings:
        params["unembed"] = init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                           dtype)
    return params


# ---------------------------------------------------------------- forward --

def _apply_block_seq(bp: Params, h: torch.Tensor, cfg: ModelConfig,
                     mlp: str, positions: torch.Tensor, causal: bool,
                     attention_impl: str, impl: str, rope) -> torch.Tensor:
    """One block over a full sequence."""
    hn = apply_norm(bp["norm1"], h, cfg.norm_type)
    h = h + attn.attention_forward(bp["mixer"], hn, cfg, positions, causal,
                                   attention_impl, impl, rope)
    if mlp == "dense":
        hn = apply_norm(bp["norm2"], h, cfg.norm_type)
        h = h + apply_mlp(bp["mlp"], hn, cfg.mlp_type)
    return h


def _logits(params: Params, cfg: ModelConfig, h: torch.Tensor
            ) -> torch.Tensor:
    """Final norm and the fp32 unembedding (head, tied or separate)."""
    h = apply_norm(params["final_norm"], h, cfg.norm_type)
    if cfg.encoder_only or cfg.frontend == "audio_frames":
        return unembed(params["head"]["table"], h)
    if cfg.tie_embeddings:
        return unembed(params["embed"]["table"], h)
    return unembed(params["unembed"]["table"], h)


def forward(params: Params, cfg: ModelConfig, *,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            attention_impl: str = "auto", remat: bool = False,
            impl: str = "kernel") -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (fp32 logits (B, S, V), aux loss 0).

    ``tokens``: (B, S) integers (LM / VLM text); ``embeds``: (B, S_e, d)
    precomputed frontend embeddings (audio frames / vision patches), cast
    to bf16 as the reference does; for the VLM both are given and the
    patch embeddings come first. ``remat`` (when a gradient is being
    recorded) checkpoints every layer, as the reference checkpoints every
    period: a layer keeps only its input, and its forward runs again in
    the backward pass (the whole layer is recomputed; the reference's
    policy keeps its non-batched dot outputs)."""
    check_supported(cfg)
    parts = []
    if embeds is not None:
        parts.append(embeds.to(torch.bfloat16))
    if tokens is not None:
        parts.append(embed(params["embed"], tokens))
    h = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    causal = not cfg.encoder_only
    remat = remat and torch.is_grad_enabled()
    for layer, (_, mlp) in zip(params["layers"],
                               cfg.layer_pattern * cfg.n_periods):
        args = (layer, h, cfg, mlp, positions, causal, attention_impl, impl,
                rope)
        h = checkpoint(_apply_block_seq, *args, use_reentrant=False) \
            if remat else _apply_block_seq(*args)
    return _logits(params, cfg, h), torch.zeros((), dtype=torch.float32,
                                                device=h.device)


# ----------------------------------------------------------------- decode --

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> List[Dict[str, torch.Tensor]]:
    """One zeroed bf16 ``{"k", "v"}`` cache (batch, max_len, Hk, Dh) per
    layer."""
    check_supported(cfg)
    dev = resolve_device(device)
    return [attn.init_kv_cache(cfg, batch, max_len, device=dev)
            for _ in range(cfg.n_layers)]


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                state: List[Dict[str, torch.Tensor]], pos: torch.Tensor,
                impl: str = "kernel"
                ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """One decode step. tokens: (B, 1) integers; pos: (B,) write
    positions. Returns (fp32 logits (B, 1, V), the updated state): each
    layer's cache is written in place under ``kv_update="scatter"``."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    check_supported(cfg)
    h = embed(params["embed"], tokens)
    rope = rope_tables(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    new_state = []
    for layer, st, (_, mlp) in zip(params["layers"], state,
                                   cfg.layer_pattern * cfg.n_periods):
        hn = apply_norm(layer["norm1"], h, cfg.norm_type)
        mixed, st = attn.decode_attention(layer["mixer"], hn, cfg, st, pos,
                                          impl=impl, rope=rope)
        h = h + mixed
        if mlp == "dense":
            hn = apply_norm(layer["norm2"], h, cfg.norm_type)
            h = h + apply_mlp(layer["mlp"], hn, cfg.mlp_type)
        new_state.append(st)
    return _logits(params, cfg, h), new_state


# ------------------------------------------------------------------ losses --

def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy in fp32; labels < 0 are ignored (or
    ``mask`` selects the counted tokens)."""
    valid = (labels >= 0) if mask is None else mask
    labels = torch.clamp(labels, min=0).long()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    ll = (picked - lse) * valid
    return -(ll.sum() / torch.clamp(valid.sum(), min=1))
