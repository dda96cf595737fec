"""Batched serving engine: admission, prefix-cached prefill accounting,
decode loop.

The port of ``repro/serve/engine.py``, with the same admission, prompt
replay and decode loop, so ``EngineStats`` and the generated tokens match
the reference's. The ``PagedKVCacheManager`` tracks logical pages with
the paper's cost-based eviction and decides how much prefill counts as
executed. The model's decode path keeps a dense per-slot KV cache; its
attention core is the paged kernel on a page view of that cache
(``models.attention.decode_attention``).

As in the reference, every admitted prompt is replayed token by token
through the decode path: the dense slot cache cannot splice cached
pages. Without MoE layers the lanes of a step do not affect each other,
so each replay step runs on the admitted slot's lane alone (a view of
the batch state, its caches written in place). An MoE layer couples the
lanes of a step: its capacity comes from all of the step's tokens, and
each (token, k) queues behind the earlier lanes'. So with MoE layers a
replay step runs every lane, as the reference's does: the admitted lane
gets the prompt token, every other lane token 0 at position 0 on its
real state, and only the admitted lane's new state is kept; the other
lanes' states end as they were.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (DecodeState, decode_step,
                                      init_decode_state,
                                      refuse_latent_decode, resolve_device)
from repro_torch.serve.kvcache import PagedKVCacheManager


@dataclasses.dataclass
class Request:
    """One request: its prompt tokens, how many tokens to generate, and
    what the engine did for it."""
    request_id: int
    prompt: List[int]
    max_new_tokens: int = 16
    generated: List[int] = dataclasses.field(default_factory=list)
    prefill_tokens_executed: int = 0


@dataclasses.dataclass
class EngineStats:
    """Counters over every ``run``: requests, prompt tokens, prefill
    tokens executed and saved by the prefix cache, batched decode
    steps."""
    requests: int = 0
    prompt_tokens: int = 0
    prefill_executed: int = 0
    prefill_saved: int = 0
    decode_steps: int = 0


class ServingEngine:
    """Slot-batched greedy-decode engine. Runs on the card unless
    ``device="cpu"``; the parameters must live on that device.
    ``impl="plain"`` runs the attention kernels' plain versions."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 128, page_size: int = 16,
                 cache_budget_pages: int = 64, policy: str = "cost",
                 device="cuda", impl: str = "kernel"):
        refuse_latent_decode(cfg)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self.impl = impl
        kv_layers = sum(1 for m, _ in cfg.layer_pattern if m == "attn") * \
            cfg.n_periods
        page_bytes = max(1, 2 * page_size * cfg.n_kv_heads *
                         cfg.resolved_head_dim * 2 * kv_layers)
        self.manager = PagedKVCacheManager(
            page_size=page_size, budget_bytes=cache_budget_pages * page_bytes,
            page_bytes=page_bytes, policy=policy)
        self.stats = EngineStats()
        self.all_lane_replay = any(mlp == "moe" for _, mlp in
                                   cfg.layer_pattern)

    @torch.no_grad()
    def _decode(self, params, tokens: torch.Tensor, state: DecodeState,
                pos: torch.Tensor):
        """One decode step of the model (logits, state')."""
        return decode_step(params, self.cfg, tokens, state, pos,
                           impl=self.impl)

    def _prefill_into_slot(self, state, slot: int, tokens: Sequence[int],
                           start: int) -> None:
        """Run tokens [start:] through the decode path to build the slot's
        state (see the module docstring for which lanes a step runs)."""
        if self.all_lane_replay:
            self._replay_all_lanes(state, slot, tokens, start)
        else:
            lane = [{k: t[slot:slot + 1] for k, t in st.items()}
                    for st in state["kv"]]
            for t in range(start, len(tokens)):
                tok = torch.full((1, 1), tokens[t], dtype=torch.int32,
                                 device=self.device)
                pos = torch.full((1,), t, dtype=torch.int32,
                                 device=self.device)
                _, lane = self._decode(self.params, tok, lane, pos)
            _merge_slot(state["kv"], lane, slot)
        state["next_logits"][slot] = None

    def _replay_all_lanes(self, state, slot: int, tokens: Sequence[int],
                          start: int) -> None:
        """The reference's replay: every step runs all ``slots`` lanes, the
        admitted one on its prompt and the others on token 0 at position 0
        with their current state, and keeps the admitted lane's new state.
        The recurrent states are new tensors each step, so only the lane
        is copied back. Under ``kv_update="scatter"`` the step writes every
        lane's K/V in place, the others' at position 0; a lane at position
        0 attends to nothing but what the step just wrote there, so the
        others' position-0 rows are saved once before the replay and put
        back once after it (2 rows a layer and lane: cheaper than a
        scratch cache or a restore after every step)."""
        others = torch.tensor([s for s in range(self.slots) if s != slot],
                              dtype=torch.long, device=self.device)
        saved = [{k: st[k][others, 0].clone() for k in ("k", "v")}
                 if "k" in st else None for st in state["kv"]]
        toks = np.zeros((self.slots, 1), np.int32)
        poss = np.zeros((self.slots,), np.int32)
        for t in range(start, len(tokens)):
            toks[slot, 0], poss[slot] = tokens[t], t
            _, new = self._decode(self.params,
                                  torch.from_numpy(toks).to(self.device),
                                  state["kv"],
                                  torch.from_numpy(poss).to(self.device))
            _merge_slot(state["kv"], [{k: x[slot:slot + 1]
                                       for k, x in st.items()}
                                      for st in new], slot)
        for st, rows in zip(state["kv"], saved):
            if rows is not None:
                for k, row in rows.items():
                    st[k][others, 0] = row.to(st[k].dtype)

    def run(self, requests: Sequence[Request]) -> List[Request]:
        """Serve requests through ``slots`` concurrent decode lanes."""
        queue = list(requests)
        done: List[Request] = []
        state = {"kv": init_decode_state(self.cfg, self.slots, self.max_len,
                                         device=self.device),
                 "next_logits": [None] * self.slots}
        active: List[Optional[Request]] = [None] * self.slots
        lengths = np.zeros(self.slots, np.int32)

        while queue or any(a is not None for a in active):
            # Admission.
            for s in range(self.slots):
                if active[s] is None and queue:
                    req = queue.pop(0)
                    _check_prompt(req, self.max_len)
                    alloc = self.manager.allocate(req.request_id, req.prompt)
                    cached_tokens = len(req.prompt) - alloc.recompute_tokens
                    self.stats.requests += 1
                    self.stats.prompt_tokens += len(req.prompt)
                    self.stats.prefill_saved += cached_tokens
                    self.stats.prefill_executed += alloc.recompute_tokens
                    req.prefill_tokens_executed = alloc.recompute_tokens
                    # The slot replays the whole prompt; the accounting of
                    # skipped prefill comes from the manager.
                    self._prefill_into_slot(state, s, req.prompt, start=0)
                    lengths[s] = len(req.prompt)
                    active[s] = req
            # One batched decode step for all slots. As in the reference,
            # a request's first step re-feeds its last prompt token at
            # position len - 1.
            toks = np.zeros((self.slots, 1), np.int32)
            poss = np.maximum(lengths - 1, 0).astype(np.int32)
            for s, req in enumerate(active):
                if req is not None:
                    toks[s, 0] = (req.generated[-1] if req.generated
                                  else req.prompt[-1])
            logits, state["kv"] = self._decode(
                self.params, torch.from_numpy(toks).to(self.device),
                state["kv"], torch.from_numpy(poss).to(self.device))
            self.stats.decode_steps += 1
            nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
            for s, req in enumerate(active):
                if req is None:
                    continue
                req.generated.append(int(nxt[s]))
                lengths[s] += 1
                if (len(req.generated) >= req.max_new_tokens or
                        lengths[s] >= self.max_len):
                    done.append(req)
                    active[s] = None
        return done


def _check_prompt(req: Request, max_len: int) -> None:
    """Reject, on the host, a prompt longer than ``max_len``, which the
    decode path cannot hold. Token ids outside the vocabulary are not
    refused: the embedding maps them as the reference's gather does."""
    if len(req.prompt) > max_len:
        raise ValueError(f"request {req.request_id}: prompt of "
                         f"{len(req.prompt)} tokens exceeds max_len="
                         f"{max_len}")


def _merge_slot(old: DecodeState, new: DecodeState, slot: int) -> None:
    """Write ``slot``'s lane of ``new`` (per-layer state dicts of (1, ...)
    tensors) into the batch state ``old``, in place; the other lanes stay
    as they are. Lanes the step already wrote in place are skipped; a
    lane whose dtype was promoted (``kv_update="onehot"`` with fp32
    weights) promotes the whole batch tensor, as the reference's merge
    does."""
    for o, n in zip(old, new):
        for key, lane in n.items():
            full = o[key]
            if lane.data_ptr() == full[slot:slot + 1].data_ptr() and \
                    lane.dtype == full.dtype:
                continue
            if lane.dtype != full.dtype:
                full = full.to(torch.promote_types(full.dtype, lane.dtype))
                o[key] = full
            full[slot:slot + 1] = lane
