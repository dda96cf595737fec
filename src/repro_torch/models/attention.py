"""GQA attention: prefill (naive or blockwise) and single-token decode
against a KV cache.

The port of ``repro/models/attention.py``. ``attention_forward`` picks
the implementation as the reference does: ``"auto"`` is naive for
S <= 2048 and blockwise beyond. The blockwise path of the reference is
the online-softmax formulation that its Pallas kernel implements; here
it IS the flash kernel (``kernels.flash_attention``), fed the
unexpanded KV heads, and its gradient (the reference's custom VJP) is
the flash backward kernel. ``decode_attention``'s attention core is the paged
kernel (``kernels.paged_attention``) run on a page view of the dense
per-slot cache. ``kernel_impl`` / ``impl`` = ``"plain"`` runs the two
kernels' plain versions instead (on the card, for checking).

The decode cache is updated in place under ``kv_update="scatter"`` (the
reference's donated-buffer scatter); ``"onehot"`` keeps the reference's
full-cache blend and returns new tensors.

On a device mesh (``DTensor`` activations) the two kernels run on each
rank's local shards through ``local_map``: heads over the ``model``
axis when the query and KV head counts both divide by it (else
replicated there), batch rows as the activations hold them. A decode
cache that is sequence-sharded (the reference's ``decode_state_specs``)
is redistributed to that layout for the call, and the updated cache
comes back in it (a new ``DTensor``, not written in place).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.models.layers import (Params, matmul, normal, rope_tables,
                                       rotate)
from repro_torch.sharding.local import (as_dtensor, batch_only,
                                        head_placements, is_dtensor,
                                        on_local_shards, split_heads)

NEG_INF = -1e30

#: Largest page of the decode cache's page view (see decode_attention).
MAX_PAGE = 64

# Page tables of the page view by (batch, pages per row, device): built
# once and never written, so the paged wrapper range-checks each once.
_PAGE_TABLES: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

#: The flash wrapper's block sizes on the blockwise path. The CUDA kernel
#: tiles by its own 64 x 64, so these set only the padding contract.
BLOCK_Q = 128
BLOCK_K = 128


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype) -> Params:
    """wq, wk, wv, wo in (in, out) layout at the reference's scales, plus
    zero QKV biases when ``cfg.qkv_bias``."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    q_dim, kv_dim = cfg.n_heads * hd, cfg.n_kv_heads * hd
    std = 1.0 / math.sqrt(d)
    p: Params = {
        "wq": normal(gen, (d, q_dim), std, dtype),
        "wk": normal(gen, (d, kv_dim), std, dtype),
        "wv": normal(gen, (d, kv_dim), std, dtype),
        "wo": normal(gen, (q_dim, d), 1.0 / math.sqrt(q_dim), dtype),
    }
    if cfg.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros(q_dim, dtype=dtype, device=dev)
        p["bk"] = torch.zeros(kv_dim, dtype=dtype, device=dev)
        p["bv"] = torch.zeros(kv_dim, dtype=dtype, device=dev)
    return p


def _project_qkv(params: Params, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> q (B, S, H, Dh), k and v (B, S, Hk, Dh)."""
    hd = cfg.resolved_head_dim
    q = matmul(x, params["wq"])
    k = matmul(x, params["wk"])
    v = matmul(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = split_heads(q, cfg.n_heads, hd)
    k = split_heads(k, cfg.n_kv_heads, hd)
    v = split_heads(v, cfg.n_kv_heads, hd)
    return q, k, v


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Broadcast KV heads to query heads for GQA: (B, S, Hk, D) ->
    (B, S, H, D), kv head j serving query heads j*rep .. j*rep+rep-1."""
    B, S, Hk, D = k.shape
    rep = n_heads // Hk
    return k[:, :, :, None, :].expand(B, S, Hk, rep, D).reshape(
        B, S, Hk * rep, D)


def _naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Softmax attention over expanded heads, (B, Sq, H, D) out: the
    logits product in the inputs' dtype cast to fp32, fp32 softmax, the
    probabilities cast back before the value product (the reference's
    arithmetic)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(Sk, device=q.device)[None, :]
        logits = torch.where(ki <= qi, logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, impl: str) -> torch.Tensor:
    """The reference's blockwise (online-softmax) attention with its
    custom backward (``attention.py:127-186``): the flash kernels on
    (B, S, H, D) q and unexpanded (B, S, Hk, D) k, v, forward and, when a
    gradient is asked for, backward (``ops.FlashAttention``). Non-causal
    keys are not padded (the kernel's contract), so bk is then the
    largest divisor of Sk up to ``BLOCK_K``."""
    bk = BLOCK_K if causal else math.gcd(k.shape[1], BLOCK_K)
    return flash_attention(q, k, v, causal=causal, bq=BLOCK_Q, bk=bk,
                           impl=impl)


def _on_heads(core, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """``core(q, k, v)`` of (B, S, H, D) q and (B, S, Hk, D) k, v, its
    heads merged: (B, S, H * D). On ``DTensor``s it runs on each rank's
    whole heads and batch rows (``local_map``, all three placed by q's
    batch sharding), the heads merged there too: a head dim that does
    not divide by the model axis cannot be split or merged at the
    DTensor level."""
    def merged(q, k, v):
        out = core(q, k, v)
        return out.reshape(*out.shape[:2], -1)

    if not is_dtensor(q):
        return merged(q, k, v)
    pq = head_placements(q, 2, (q.shape[2], k.shape[2]))
    return on_local_shards(merged, q, (pq, pq, pq), pq)(q, k, v)


def attention_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, causal: bool,
                      impl: str = "auto",
                      kernel_impl: str = "kernel",
                      rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> torch.Tensor:
    """Full-sequence attention (training / prefill). ``impl``: "auto",
    "naive" or "blockwise"; ``kernel_impl``: "kernel" or "plain" for the
    blockwise path's flash kernel; ``rope``: ``rope_tables`` of
    ``positions`` when the caller has them."""
    q, k, v = _project_qkv(params, x, cfg)
    if rope is None:
        rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    q, k = rotate(q, rope), rotate(k, rope)
    S = x.shape[1]
    if impl == "auto":
        impl = "naive" if S <= 2048 else "blockwise"
    if impl == "naive":
        def core(q, k, v):
            return _naive_attention(q, _expand_kv(k, q.shape[2]),
                                    _expand_kv(v, q.shape[2]), causal)
    elif impl == "blockwise":
        def core(q, k, v):
            return _blockwise_attention(q, k, v, causal, kernel_impl)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    return matmul(_on_heads(core, q, k, v), params["wo"])


def page_size_for(max_len: int) -> int:
    """The page size of the decode cache's page view: the largest power
    of two up to ``MAX_PAGE`` that divides ``max_len``."""
    ps = MAX_PAGE
    while max_len % ps:
        ps //= 2
    return ps


def decode_attention(params: Params, x: torch.Tensor, cfg: ModelConfig,
                     kv_cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                     impl: str = "kernel", page_size: Optional[int] = None,
                     rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (B, 1, d); kv_cache: {"k", "v"}: (B, S_max,
    Hk, Dh); pos: (B,) write positions. Returns the output and the cache
    (the same tensors, written in place, under ``kv_update="scatter"``).

    The attention core is paged decode attention on a page view of the
    cache: pages of ``page_size`` positions, (B * S_max / PS, PS, Hk, Dh),
    row b of the page table holding pages b * S_max / PS + [0, S_max /
    PS), and ``seq_lens = pos + 1`` (positions <= pos are live, as in the
    reference). The result does not depend on the page size: the view
    only renames positions, and the kernel walks them in chunks of its
    own. ``page_size`` defaults to :func:`page_size_for` (S_max).
    ``rope``: ``rope_tables`` of ``pos[:, None]`` when the caller has
    them."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k_new, v_new = _project_qkv(params, x, cfg)
    if rope is None:
        rope = rope_tables(pos[:, None], hd, cfg.rope_theta)
    q, k_new = rotate(q, rope), rotate(k_new, rope)
    if is_dtensor(q):
        return _decode_on_mesh(params, q, k_new, v_new, kv_cache, pos, cfg,
                               impl, page_size, x.dtype)
    out, k_cache, v_cache = _decode_core(q, k_new, v_new, kv_cache["k"],
                                         kv_cache["v"], pos, cfg, impl,
                                         page_size)
    return matmul(out.to(x.dtype).reshape(B, 1, cfg.n_heads * hd),
                  params["wo"]), {"k": k_cache, "v": v_cache}


def _decode_core(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor,
                 pos: torch.Tensor, cfg: ModelConfig, impl: str,
                 page_size: Optional[int]):
    """The cache update and the paged kernel on plain (or local)
    tensors: (out (B, H, Dh) in the kernel's dtype, k cache, v cache)."""
    B, hd = q.shape[0], q.shape[-1]
    kv_update = getattr(cfg, "kv_update", "scatter")
    if kv_update == "onehot":
        # The reference's pre-hillclimb baseline: the one-hot blend reads
        # and rewrites the entire cache every token.
        k_cache = _scatter_kv(k_cache, k_new, pos)
        v_cache = _scatter_kv(v_cache, v_new, pos)
    else:
        b_idx = torch.arange(B, device=q.device)
        k_cache[b_idx, pos.long()] = k_new[:, 0].to(k_cache.dtype)
        v_cache[b_idx, pos.long()] = v_new[:, 0].to(v_cache.dtype)
    S_max, Hk = k_cache.shape[1], k_cache.shape[2]
    ps = page_size_for(S_max) if page_size is None else page_size
    if S_max % ps:
        raise ValueError(f"page size {ps} does not divide S_max={S_max}")
    n_pg = S_max // ps
    table = _page_table(B, n_pg, q.device)
    k_pages = k_cache.reshape(B * n_pg, ps, Hk, hd)
    v_pages = v_cache.reshape(B * n_pg, ps, Hk, hd)
    # The paged kernel works in one dtype: q joins the cache's (the
    # reference's logits product promotes the same pair).
    dt = torch.promote_types(q.dtype, k_cache.dtype)
    out = paged_decode_attention(q[:, 0].to(dt), k_pages.to(dt),
                                 v_pages.to(dt), table,
                                 (pos + 1).to(torch.int32), impl=impl)
    return out, k_cache, v_cache


def _decode_on_mesh(params: Params, q, k_new, v_new, kv_cache, pos, cfg,
                    impl, page_size, dtype):
    """:func:`decode_attention` on ``DTensor``s: the cache update and the
    paged kernel on each rank's whole heads and batch rows
    (:func:`_decode_core` under ``local_map``); the caches come back in
    that layout. Every input takes the cache's batch sharding."""
    ph = head_placements(kv_cache["k"], 2, (q.shape[2], k_new.shape[2]))
    pb = batch_only(kv_cache["k"])

    def core(q, k_new, v_new, k_cache, v_cache, pos):
        out, k_cache, v_cache = _decode_core(q, k_new, v_new, k_cache,
                                             v_cache, pos, cfg, impl,
                                             page_size)
        return out.to(dtype).reshape(out.shape[0], 1, -1), k_cache, v_cache

    out, k_cache, v_cache = on_local_shards(
        core, q, (ph,) * 5 + (pb,), (ph, ph, ph))(
            q, k_new, v_new, kv_cache["k"], kv_cache["v"],
            as_dtensor(pos, q))
    return matmul(out, params["wo"]), {"k": k_cache, "v": v_cache}


def _page_table(batch: int, n_pg: int, device: torch.device
                ) -> torch.Tensor:
    """The page view's (batch, n_pg) int32 table: row b holds pages
    b * n_pg + [0, n_pg)."""
    key = (batch, n_pg, device)
    if key not in _PAGE_TABLES:
        _PAGE_TABLES[key] = torch.arange(batch * n_pg, dtype=torch.int32,
                                         device=device).view(batch, n_pg)
    return _PAGE_TABLES[key]


def _scatter_kv(cache: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """cache: (B, S, Hk, D); new: (B, 1, Hk, D); pos: (B,). The one-hot
    blend, in the promoted dtype of cache and new."""
    oh = torch.nn.functional.one_hot(pos.long(), cache.shape[1]).to(
        cache.dtype)
    return cache * (1 - oh)[..., None, None] + oh[..., None, None] * new


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Zeroed (batch, max_len, Hk, Dh) K and V caches."""
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
