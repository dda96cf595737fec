"""Model assembly for all ten architectures.

The port of ``repro/models/model.py``. The reference scans over periods
of stacked per-period weights to keep its HLO small; PyTorch runs
eagerly, so here the stack is a loop over layers and ``params["layers"]``
holds one dict of tensors per layer (layer ``p * period + i`` is block
``b{i}`` of period ``p`` in the reference's pytree). A block is a mixer
(``attn``, ``mamba``, ``mlstm`` or ``slstm``) and an MLP (``dense``,
``moe`` or ``none``), as ``cfg.layer_pattern`` says. Decode state is one
dict per layer, the lane on axis 0 of every tensor: ``{"k", "v"}`` for
attention, ``{"h", "conv"}`` for Mamba, ``{"C", "n", "m"}`` for mLSTM and
``{"c", "n", "m", "h"}`` for sLSTM.

On a device mesh (parameters and inputs as ``DTensor``s, see
``repro_torch.sharding``) the same code runs per rank on local shards;
with ``cfg.seq_parallel`` the hidden state is redistributed to
sequence-sharded on the ``model`` axis before each block, as the
reference constrains it (``sharding.local.seq_parallel``; the identity
with no mesh).

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
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (Params, apply_mlp, apply_norm, embed,
                                       init_embedding, init_mlp, init_norm,
                                       rope_tables, unembed)
from repro_torch.sharding.local import pick_last, seq_parallel

DecodeState = List[Dict[str, torch.Tensor]]

# The per-mixer decode states' keys, in the reference's tuple order.
_STATE_KEYS = {"mlstm": ("C", "n", "m"), "slstm": ("c", "n", "m", "h")}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain versions on the CPU")
    return dev


def layer_kinds(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """(mixer, mlp) of every layer, in order."""
    return list(cfg.layer_pattern) * cfg.n_periods


# ------------------------------------------------------------------- init --

_INIT_MIXER = {"attn": attn.init_attention, "mamba": ssm.init_mamba,
               "mlstm": ssm.init_mlstm, "slstm": ssm.init_slstm}


def _init_block(gen: torch.Generator, cfg: ModelConfig, mixer: str,
                mlp: str, dtype: torch.dtype) -> Params:
    """One block's parameters."""
    dev = gen.device
    p: Params = {"norm1": init_norm(cfg.d_model, cfg.norm_type, dev),
                 "mixer": _INIT_MIXER[mixer](gen, cfg, dtype)}
    if mlp == "dense":
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype)
    elif mlp == "moe":
        p["mlp"] = moe_mod.init_moe(gen, cfg, dtype)
    if mlp != "none":
        p["norm2"] = init_norm(cfg.d_model, cfg.norm_type, dev)
    return p


def init_params(cfg: ModelConfig, seed: int = 0,
                dtype: torch.dtype = torch.bfloat16,
                device="cuda") -> Params:
    """Random parameters from a seeded ``torch.Generator`` on ``device``,
    with the reference's shapes, dtypes and init scales (the numbers
    differ from JAX's: the generators differ; ``convert`` carries the
    reference's own)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    layers = [_init_block(gen, cfg, mixer, mlp, dtype)
              for mixer, mlp in layer_kinds(cfg)]
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

def _apply_mlp(bp: Params, h: torch.Tensor, cfg: ModelConfig, mlp: str
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's MLP half with its residual: (h, the MoE aux loss or
    None)."""
    if mlp == "none":
        return h, None
    hn = apply_norm(bp["norm2"], h, cfg.norm_type)
    if mlp == "dense":
        return h + apply_mlp(bp["mlp"], hn, cfg.mlp_type), None
    y, aux = moe_mod.moe_forward(bp["mlp"], hn, cfg)
    return h + y, aux


def _apply_block_seq(bp: Params, h: torch.Tensor, cfg: ModelConfig,
                     mixer: str, mlp: str, positions: torch.Tensor,
                     causal: bool, attention_impl: str, impl: str, rope
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block over a full sequence: (h, the fp32 MoE aux loss or
    None)."""
    hn = apply_norm(bp["norm1"], h, cfg.norm_type)
    if mixer == "attn":
        mixed = attn.attention_forward(bp["mixer"], hn, cfg, positions,
                                       causal, attention_impl, impl, rope)
    elif mixer == "mamba":
        mixed, _ = ssm.mamba_forward(bp["mixer"], hn, cfg)
    elif mixer == "mlstm":
        mixed, _ = ssm.mlstm_forward(bp["mixer"], hn, cfg,
                                     impl=cfg.mlstm_impl)
    elif mixer == "slstm":
        mixed, _ = ssm.slstm_forward(bp["mixer"], hn, cfg)
    else:
        raise ValueError(mixer)
    return _apply_mlp(bp, h + mixed, cfg, mlp)


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
    """Full-sequence forward. Returns (fp32 logits (B, S, V), the fp32
    aux loss summed over the MoE layers, 0 without any).

    ``tokens``: (B, S) integers (LM / VLM text); ``embeds``: (B, S_e, d)
    precomputed frontend embeddings (audio frames / vision patches), cast
    to bf16 as the reference does; for the VLM both are given and the
    patch embeddings come first. ``remat`` (when a gradient is being
    recorded) checkpoints every layer, as the reference checkpoints every
    period: a layer keeps only its input, and its forward runs again in
    the backward pass (the whole layer is recomputed; the reference's
    policy keeps its non-batched dot outputs)."""
    parts = []
    if embeds is not None:
        parts.append(embeds.to(torch.bfloat16))
    if tokens is not None:
        parts.append(embed(params["embed"], tokens))
    h = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta) \
        if cfg.uses_attention else None
    causal = not cfg.encoder_only
    remat = remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for layer, (mixer, mlp) in zip(params["layers"], layer_kinds(cfg)):
        if cfg.seq_parallel:
            h = seq_parallel(h)
        args = (layer, h, cfg, mixer, mlp, positions, causal,
                attention_impl, impl, rope)
        h, a = checkpoint(_apply_block_seq, *args, use_reentrant=False) \
            if remat else _apply_block_seq(*args)
        if a is not None:
            aux = aux + a
    return _logits(params, cfg, h), aux


# ----------------------------------------------------------------- decode --

def _init_state(cfg: ModelConfig, mixer: str, batch: int, max_len: int,
                dev: torch.device) -> Dict[str, torch.Tensor]:
    """One layer's zeroed decode state."""
    if mixer == "attn":
        return attn.init_kv_cache(cfg, batch, max_len, device=dev)
    if mixer == "mamba":
        return ssm.init_mamba_state(cfg, batch, dev)
    init = ssm.init_mlstm_state if mixer == "mlstm" else \
        ssm.init_slstm_state
    return dict(zip(_STATE_KEYS[mixer], init(cfg, batch, dev)))


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> DecodeState:
    """One zeroed state dict per layer (see the module docstring): bf16
    (batch, max_len, Hk, Dh) K and V caches for attention, the fp32
    recurrent states (and Mamba's bf16 conv window) otherwise."""
    dev = resolve_device(device)
    return [_init_state(cfg, mixer, batch, max_len, dev)
            for mixer, _ in layer_kinds(cfg)]


def _mixer_step(bp: Params, hn: torch.Tensor, cfg: ModelConfig, mixer: str,
                st: Dict[str, torch.Tensor], pos: torch.Tensor, impl: str,
                rope) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token through one layer's mixer: (output, the layer's new
    state)."""
    if mixer == "attn":
        return attn.decode_attention(bp, hn, cfg, st, pos, impl=impl,
                                     rope=rope)
    if mixer == "mamba":
        return ssm.mamba_step(bp, hn, st, cfg)
    step = ssm.mlstm_step if mixer == "mlstm" else ssm.slstm_step
    keys = _STATE_KEYS[mixer]
    out, new = step(bp, hn, tuple(st[k] for k in keys), cfg)
    return out, dict(zip(keys, new))


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                state: DecodeState, pos: torch.Tensor,
                impl: str = "kernel") -> Tuple[torch.Tensor, DecodeState]:
    """One decode step. tokens: (B, 1) integers; pos: (B,) write
    positions. Returns (fp32 logits (B, 1, V), the updated state): each
    attention layer's cache is written in place under
    ``kv_update="scatter"``; the recurrent states are new tensors."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    h = embed(params["embed"], tokens)
    rope = rope_tables(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta) \
        if cfg.uses_attention else None
    new_state = []
    for layer, st, (mixer, mlp) in zip(params["layers"], state,
                                       layer_kinds(cfg)):
        hn = apply_norm(layer["norm1"], h, cfg.norm_type)
        mixed, st = _mixer_step(layer["mixer"], hn, cfg, mixer, st, pos,
                                impl, rope)
        h, _ = _apply_mlp(layer, h + mixed, cfg, mlp)
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
    picked = pick_last(logits, labels)
    ll = (picked - lse) * valid
    return -(ll.sum() / torch.clamp(valid.sum(), min=1))
