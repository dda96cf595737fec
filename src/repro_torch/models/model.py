"""Model assembly for all eleven architectures.

The port of ``repro/models/model.py``. The reference scans over periods
of stacked per-period weights to keep its HLO small; PyTorch runs
eagerly, so here the stack is a loop over layers and ``params["layers"]``
holds one dict of tensors per layer (layer ``p * period + i`` is block
``b{i}`` of period ``p`` in the reference's pytree). A block is a mixer
(``attn``, ``mla``, ``mamba``, ``mlstm`` or ``slstm``) and an MLP
(``dense``, ``moe`` or ``none``), as ``cfg.layer_kinds`` says (the
pattern's periods after ``cfg.dense_prefix`` dense layers). An MoE layer
with a balancing bias (``moe.bias_update_speed``) keeps it as its leaf
``mlp/bias``, which no gradient reaches; :func:`forward` can hand back
each such layer's expert load for its update. Latent attention has no
decode cache yet: the decode entry points refuse it. Decode state is one
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

import contextlib
import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (Params, apply_mlp, apply_norm, embed,
                                       init_embedding, init_mlp, init_norm,
                                       rope_tables, unembed)
from repro_torch.obs.telemetry import NULL_TELEMETRY, Telemetry
from repro_torch.sharding.local import (is_dtensor, on_all_rows,
                                        on_batch_rows, pick_last,
                                        seq_parallel)

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
    return list(cfg.layer_kinds)


# ------------------------------------------------------------------- init --

_INIT_MIXER = {"attn": attn.init_attention, "mla": mla_mod.init_mla,
               "mamba": ssm.init_mamba,
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

def _apply_mlp(bp: Params, h: torch.Tensor, cfg: ModelConfig, mlp: str,
               telemetry: Telemetry = NULL_TELEMETRY,
               loads: Optional[list] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's MLP half with its residual: (h, the MoE aux loss or
    None); a balanced MoE layer appends its expert load to ``loads``."""
    if mlp == "none":
        return h, None
    hn = apply_norm(bp["norm2"], h, cfg.norm_type)
    if mlp == "dense":
        return h + apply_mlp(bp["mlp"], hn, cfg.mlp_type), None
    y, aux = moe_mod.moe_forward(bp["mlp"], hn, cfg, telemetry, loads)
    return h + y, aux


def _apply_block_seq(bp: Params, h: torch.Tensor, cfg: ModelConfig,
                     mixer: str, mlp: str, positions: torch.Tensor,
                     causal: bool, attention_impl: str, impl: str, rope,
                     telemetry: Telemetry, index: int
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                Optional[torch.Tensor]]:
    """Block ``index`` over a full sequence, in a ``model.layer`` span:
    (h, the fp32 MoE aux loss or None, the layer's expert load (E,) when
    its router has a balancing bias, else None). The load is an output
    of the block, so a checkpointed block's recompute adds nothing.

    A latent-attention block on a mesh runs each half whole on local
    tensors: the mixer half on each rank's batch rows, the MLP half on
    the whole batch where it is an MoE layer (its routing couples every
    token) and on the rows where it is dense. Its few hundred small ops
    then dispatch as plain tensor ops, not through ``DTensor`` on the
    host; on one rank the arithmetic is the unplaced block's."""

    def mix(p: Params, h: torch.Tensor):
        hn = apply_norm(p["norm1"], h, cfg.norm_type)
        if mixer == "attn":
            mixed = attn.attention_forward(p["mixer"], hn, cfg, positions,
                                           causal, attention_impl, impl,
                                           rope)
        elif mixer == "mla":
            mixed = mla_mod.mla_forward(p["mixer"], hn, cfg, positions,
                                        causal, attention_impl, impl, rope,
                                        telemetry)
        elif mixer == "mamba":
            mixed, _ = ssm.mamba_forward(p["mixer"], hn, cfg)
        elif mixer == "mlstm":
            mixed, _ = ssm.mlstm_forward(p["mixer"], hn, cfg,
                                         impl=cfg.mlstm_impl)
        elif mixer == "slstm":
            mixed, _ = ssm.slstm_forward(p["mixer"], hn, cfg)
        else:
            raise ValueError(mixer)
        return h + mixed, ()

    def feed(p: Params, h: torch.Tensor):
        loads: list = []
        h, aux = _apply_mlp(p, h, cfg, mlp, telemetry, loads)
        return (h, aux) + tuple(loads)

    with telemetry.tracer.span("model.layer", layer=index):
        if mixer != "mla" or not is_dtensor(h):
            h, aux, *load = feed(bp, mix(bp, h)[0])
            return h, aux, (load[0] if load else None)
        half = {k: bp[k] for k in ("norm1", "mixer")}
        h = on_batch_rows(mix, h, half, (), 1)[0]
        if mlp == "none":
            return h, None, None
        half = {k: bp[k] for k in ("norm2", "mlp")}
        if mlp == "dense":
            h = on_batch_rows(lambda p, h: (feed(p, h)[0], ()), h, half,
                              (), 1)[0]
            return h, None, None
        h, aux, *load = on_all_rows(
            feed, h, half, 3 if moe_mod.BIAS in bp["mlp"] else 2)
        return h, aux, (load[0] if load else None)


def _remat_contexts(telemetry: Telemetry):
    """``checkpoint``'s ``context_fn``: the forward as it is, and the
    recompute marked on ``telemetry`` so that it counts nothing twice."""
    return contextlib.nullcontext(), telemetry.recompute()


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
            impl: str = "kernel", telemetry: Telemetry = NULL_TELEMETRY,
            loads: Optional[list] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (fp32 logits (B, S, V), the fp32
    aux loss summed over the MoE layers, 0 without any). ``loads``, a
    list, gets the expert load of each MoE layer with a balancing bias,
    in layer order.

    ``tokens``: (B, S) integers (LM / VLM text); ``embeds``: (B, S_e, d)
    precomputed frontend embeddings (audio frames / vision patches), cast
    to bf16 as the reference does; for the VLM both are given and the
    patch embeddings come first. ``remat`` (when a gradient is being
    recorded) checkpoints every layer, as the reference checkpoints every
    period: a layer keeps only its input, and its forward runs again in
    the backward pass (the whole layer is recomputed; the reference's
    policy keeps its non-batched dot outputs). ``telemetry`` traces each
    layer and the head (the recomputed layers too) and counts the MoE
    layers' routing once."""
    parts = []
    if embeds is not None:
        parts.append(embeds.to(torch.bfloat16))
    if tokens is not None:
        parts.append(embed(params["embed"], tokens))
    h = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]
    rope = _rope(cfg, positions)
    causal = not cfg.encoder_only
    remat = remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    marks = {"context_fn": functools.partial(_remat_contexts, telemetry)} \
        if telemetry.enabled else {}
    for i, (layer, (mixer, mlp)) in enumerate(zip(params["layers"],
                                                  layer_kinds(cfg))):
        if cfg.seq_parallel:
            h = seq_parallel(h)
        args = (layer, h, cfg, mixer, mlp, positions, causal,
                attention_impl, impl, rope, telemetry, i)
        h, a, load = checkpoint(_apply_block_seq, *args,
                                use_reentrant=False, **marks) \
            if remat else _apply_block_seq(*args)
        if a is not None:
            aux = aux + a
        if load is not None and loads is not None:
            loads.append(load)
    with telemetry.tracer.span("model.head"):
        return _logits(params, cfg, h), aux


# ----------------------------------------------------------------- decode --

def _rope(cfg: ModelConfig, positions: torch.Tensor):
    """The RoPE tables a model's attention layers share, or None: the
    whole head, or latent attention's rope slice."""
    if not cfg.uses_attention:
        return None
    if cfg.mla is not None:
        return mla_mod.rope_for(cfg, positions)
    return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)


def refuse_latent_decode(cfg: ModelConfig) -> None:
    """Raise for a config with latent attention: the port has no decode
    cache of the latent yet, so nothing decodes or serves it."""
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: latent attention (MLA) has no decode cache in the "
            f"port yet; it trains and runs full-sequence forwards only")


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
    recurrent states (and Mamba's bf16 conv window) otherwise. Latent
    attention raises (:func:`refuse_latent_decode`)."""
    refuse_latent_decode(cfg)
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
    refuse_latent_decode(cfg)
    h = embed(params["embed"], tokens)
    rope = _rope(cfg, pos[:, None])
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
