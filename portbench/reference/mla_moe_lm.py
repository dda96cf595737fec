"""Moonlight's (DeepSeek-V3's) decoder layer with one chip's share of the
experts, trained with AdamW, in plain PyTorch: the reference of the
training cells whose configuration names ``"reference": "mla_moe_lm"``.

It follows the configuration's keys (Hugging Face names) as the
benchmark runs them:

- RMSNorm (``rms_norm_eps``) before each half of a layer and at the end.
- Latent attention without a query LoRA: q = x W_q, heads of
  ``qk_nope_head_dim`` + ``qk_rope_head_dim``; [c | k_pe] = x W_kv_a, c
  RMS-normed (``kv_lora_rank`` wide); [k_nope | v] = c W_kv_b per head
  (``qk_nope_head_dim`` + ``v_head_dim``); RoPE (``rope_theta``) on q's
  rope slice and on k_pe, one head shared by all heads, rotating the two
  halves of the slice (the port's layout; Hugging Face's ``deepseek_v3``
  rotates interleaved pairs, a fixed permutation of the slice); causal
  softmax over the q/k width, its scale 1 / sqrt(nope + rope); o W_o over
  the heads' values. Computed in blocks of :data:`QUERY_BLOCK` queries,
  each checkpointed, so the scores of one block are alive at a time.
- ``first_k_dense_replace`` leading layers with a SwiGLU MLP of
  ``intermediate_size``.
- Then mixture-of-experts layers: ``n_shared_experts`` SwiGLU experts of
  ``moe_intermediate_size`` always on, and routed experts: sigmoid scores
  over all ``router_experts`` (the published expert count), each token's
  ``num_experts_per_tok`` chosen by score plus the layer's balancing bias
  (a stable descending sort; one group), gates the chosen unbiased scores
  over their sum (``norm_topk_prob``) times ``routed_scaling_factor``, and
  GShard's capacity: a (token, k) pair's place in its expert's queue is
  the number of pairs before it in (token, k) order, pairs past
  ``capacity_factor * k * T / router_experts`` dropped. The layer holds
  ``n_routed_experts`` of the experts, ids ``held_offset`` on, and adds
  their part of the result only (what one chip of an expert-parallel
  group computes); pairs chosen for the others add nothing.
- The loss: mean next-token cross entropy over the labelled positions
  plus ``aux_loss_alpha`` times the sequence-wise balance loss of every
  MoE layer (DeepSeek-V3 eq. 17-20: over each sequence, sum_e f_e P_e,
  f_e = E / (k S) times the positions whose unbiased top k holds e, P_e
  the mean of s_e / sum_j s_j; then the mean over sequences).
- AdamW as ``moe_lm`` has it (global-norm clipping, warmup, bias-corrected
  float32 moments, weight decay on every block leaf and top-level
  matrices) over every leaf but the balancing biases, which take no
  gradient: after each step b_e += ``bias_update_speed`` * sign(mean load
  - load_e), the load counted over all experts from that step's choices.

Parameters are stored as the configuration states (``torch_dtype`` for
the matrices, float32 for the router, the norm scales and the biases);
everything is computed in float32, TF32 off. ``precision="fp8"`` is the
control (``moe_lm``'s: every matrix product's operands rounded to float8
e4m3). Leaves are named as the port's parameter tree names them."""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.moe_lm import (DTYPES, Leaves, _Math, _rms,
                                        _swiglu, as_tree, decays,
                                        learning_rate, sample_index)

__all__ = ["leaf_specs", "make_params", "as_tree", "active_params",
           "loss_terms", "train", "sample_index", "QUERY_BLOCK"]

#: Queries of one checkpointed attention block.
QUERY_BLOCK = 1024
#: Leaf name of a router's balancing bias (state, not a parameter).
BIAS = "score_bias"


def _dims(conf: Mapping) -> Dict[str, int]:
    return {"d": conf["hidden_size"], "h": conf["num_attention_heads"],
            "r": conf["kv_lora_rank"], "dn": conf["qk_nope_head_dim"],
            "dr": conf["qk_rope_head_dim"], "dv": conf["v_head_dim"]}


def leaf_specs(conf: Mapping) -> List[Tuple[str, Tuple[int, ...], str,
                                            str, float]]:
    """(name, shape, dtype name, init, std) of every leaf, in name order;
    init is ``normal`` (at ``std``), ``ones`` or ``zeros``."""
    g = _dims(conf)
    d, h, r, dn, dr, dv = (g[k] for k in ("d", "h", "r", "dn", "dr", "dv"))
    v = conf["vocab_size"]
    held, e = conf["n_routed_experts"], conf["router_experts"]
    de, di = conf["moe_intermediate_size"], conf["intermediate_size"]
    sh = conf["n_shared_experts"] * de
    w = conf["torch_dtype"]

    def nrm(name, shape, fan_in, dtype=w):
        return (name, shape, dtype, "normal", 1 / math.sqrt(fan_in))

    def fixed(name, shape, init):
        return (name, shape, "float32", init, 0.0)
    out = [nrm("embed/table", (v, d), d), nrm("unembed/table", (v, d), d),
           fixed("final_norm/scale", (d,), "ones")]
    for i in range(conf["num_hidden_layers"]):
        pre = f"layers/{i}/"
        out += [nrm(pre + "mixer/wq", (d, h * (dn + dr)), d),
                nrm(pre + "mixer/wkv_a", (d, r + dr), d),
                fixed(pre + "mixer/kv_norm", (r,), "ones"),
                nrm(pre + "mixer/wkv_b", (r, h * (dn + dv)), r),
                nrm(pre + "mixer/wo", (h * dv, d), h * dv),
                fixed(pre + "norm1/scale", (d,), "ones"),
                fixed(pre + "norm2/scale", (d,), "ones")]
        if i < conf["first_k_dense_replace"]:
            out += [nrm(pre + "mlp/w_in", (d, di), d),
                    nrm(pre + "mlp/w_gate", (d, di), d),
                    nrm(pre + "mlp/w_out", (di, d), di)]
            continue
        out += [nrm(pre + "mlp/router", (d, e), d, "float32"),
                fixed(pre + "mlp/" + BIAS, (e,), "zeros"),
                nrm(pre + "mlp/w_in", (held, d, de), d),
                nrm(pre + "mlp/w_gate", (held, d, de), d),
                nrm(pre + "mlp/w_out", (held, de, d), de),
                nrm(pre + "mlp/sh_in", (d, sh), d),
                nrm(pre + "mlp/sh_gate", (d, sh), d),
                nrm(pre + "mlp/sh_out", (sh, d), sh)]
    return sorted(out)


def make_params(conf: Mapping, seed: int, device) -> Leaves:
    """The weights from ``seed``: one normal draw a dtype on ``device``
    (a ``torch.Generator`` there), sliced and scaled leaf by leaf; norm
    scales ones, balancing biases zeros. The same seed gives the same
    bits on a device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    specs = leaf_specs(conf)
    out: Leaves = {}
    for dname in sorted({s[2] for s in specs}):
        group = [s for s in specs if s[2] == dname and s[3] == "normal"]
        total = sum(math.prod(s[1]) for s in group)
        flat = torch.randn(total, generator=gen, device=device,
                           dtype=DTYPES[dname])
        off = 0
        for name, shape, _, _, std in group:
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape) * std
            off += n
        del flat
    for name, shape, dname, init, _ in specs:
        if init != "normal":
            fill = torch.ones if init == "ones" else torch.zeros
            out[name] = fill(shape, dtype=DTYPES[dname], device=device)
    return out


def active_params(conf: Mapping) -> int:
    """Parameters a token multiplies with: all but the input embedding
    (a gather) and the balancing biases (only added to choose), each
    held expert at k / router_experts of its parameters (the chance that
    a token's k experts hold it)."""
    total = 0
    e, k = conf["router_experts"], conf["num_experts_per_tok"]
    for name, shape, _, _, _ in leaf_specs(conf):
        n = math.prod(shape)
        leaf = name.split("/")[-1]
        if name == "embed/table" or leaf == BIAS:
            continue
        if leaf in ("w_in", "w_gate", "w_out") and len(shape) == 3:
            n = n * k // e
        total += n
    return total


# ------------------------------------------------------------- forward --

def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) at positions 0 .. S-1, the halves of D rotated."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :,
                                                                 None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend(q, k, v, q0: int, m: _Math):
    """Causal softmax attention of the query block starting at ``q0``
    (q (B, H, n, Dqk)) against keys 0 .. q0 + n - 1 of k, v (B, H, S,
    .)."""
    n = q.shape[2]
    k, v = k[:, :, :q0 + n], v[:, :, :q0 + n]
    scores = m.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    keep = torch.arange(q0 + n, device=q.device)[None, :] <= \
        torch.arange(q0, q0 + n, device=q.device)[:, None]
    probs = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
    return m.mm(probs, v)


def _mla(x, p, conf, m: _Math):
    g = _dims(conf)
    b, s, _ = x.shape
    h, r, dn, dv = g["h"], g["r"], g["dn"], g["dv"]
    theta = conf["rope_theta"]
    q = m.mm(x, p["wq"]).view(b, s, h, -1)
    kva = m.mm(x, p["wkv_a"])
    c = _rms(kva[..., :r], p["kv_norm"], conf["rms_norm_eps"])
    k_pe = _rope(kva[..., None, r:], theta)                   # (B, S, 1, dr)
    kvb = m.mm(c, p["wkv_b"]).view(b, s, h, dn + dv)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], theta)], dim=-1)
    k = torch.cat([kvb[..., :dn], k_pe.expand(b, s, h, g["dr"])], dim=-1)
    q, k, v = (t.transpose(1, 2) for t in (q, k, kvb[..., dn:]))
    out = torch.cat([checkpoint(_attend, q[:, :, q0:q0 + QUERY_BLOCK], k, v,
                                q0, m, use_reentrant=False)
                     for q0 in range(0, s, QUERY_BLOCK)], dim=2)
    return m.mm(out.transpose(1, 2).reshape(b, s, h * dv), p["wo"])


def _top(scores: torch.Tensor, k: int) -> torch.Tensor:
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][:, :k]


def _moe(x, p, conf, m: _Math):
    """(held + shared experts' output, the layer's balance loss, the
    load of every expert)."""
    b, s, d = x.shape
    t = b * s
    e, k = conf["router_experts"], conf["num_experts_per_tok"]
    held, off = conf["n_routed_experts"], conf.get("held_offset", 0)
    xt = x.reshape(t, d)
    scores = torch.sigmoid(m.mm(xt, p["router"]))
    top = _top(scores + p[BIAS], k)
    gates = torch.gather(scores, 1, top)
    if conf["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    gates = gates * conf["routed_scaling_factor"]

    share = (scores / scores.sum(-1, keepdim=True)).view(b, s, e).mean(1)
    chosen = _top(scores, k).reshape(b, s * k)
    f = torch.zeros(b, e, device=x.device).scatter_add(
        1, chosen, torch.ones_like(chosen, dtype=torch.float32)) * \
        (e / (k * s))
    aux = (f * share).sum(-1).mean()

    flat = top.reshape(-1)
    load = torch.bincount(flat, minlength=e)
    cap = max(1, int(conf["capacity_factor"] * k * t / e))
    onehot = F.one_hot(flat, e)
    pos = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
    keep = pos < cap
    gflat = gates.reshape(-1)
    y = torch.zeros_like(xt)
    for ex in range(held):
        idx = torch.nonzero((flat == off + ex) & keep)[:, 0]
        if idx.numel() == 0:
            continue
        tok = idx // k
        ye = _swiglu(xt[tok], p["w_in"][ex], p["w_gate"][ex],
                     p["w_out"][ex], m)
        y = y.index_add(0, tok, ye * gflat[idx, None])
    y = y.view(b, s, d) + _swiglu(x, p["sh_in"], p["sh_gate"], p["sh_out"],
                                  m)
    return y, aux, load


def _block(h, p, conf, m: _Math, dense: bool):
    eps = conf["rms_norm_eps"]
    h = h + _mla(_rms(h, p["norm1/scale"], eps), p, conf, m)
    x = _rms(h, p["norm2/scale"], eps)
    if dense:
        return h + _swiglu(x, p["w_in"], p["w_gate"], p["w_out"], m), \
            None, None
    y, aux, load = _moe(x, p, conf, m)
    return h + y, aux, load


def _layer_leaves(p: Leaves, i: int) -> Dict[str, torch.Tensor]:
    pre = f"layers/{i}/"
    out = {}
    for name, t in p.items():
        if name.startswith(pre):
            key = name[len(pre):]
            out[key.split("/")[-1] if key.startswith(("mixer", "mlp"))
                else key] = t
    return out


def loss_terms(p: Leaves, batch: Mapping[str, torch.Tensor], conf: Mapping,
               precision: str = "fp32"):
    """(total loss, cross entropy, summed balance loss, the MoE layers'
    loads (layers, E)) of float32 leaves ``p`` on one batch; each layer
    is recomputed in the backward pass."""
    m = _Math(precision)
    h = p["embed/table"][batch["tokens"].long()]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    loads = []
    for i in range(conf["num_hidden_layers"]):
        lp = _layer_leaves(p, i)
        dense = i < conf["first_k_dense_replace"]
        h, a, load = checkpoint(
            lambda h, lp=lp, dense=dense: _block(h, lp, conf, m, dense), h,
            use_reentrant=False)
        if a is not None:
            aux = aux + a
            loads.append(load)
    h = _rms(h, p["final_norm/scale"], conf["rms_norm_eps"])
    logits = m.mm(h, p["unembed/table"].t())
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         batch["labels"].reshape(-1).long(),
                         ignore_index=-1)
    return ce + conf["aux_loss_alpha"] * aux, ce, aux, torch.stack(loads)


# ---------------------------------------------------------------- AdamW --

def train(conf: Mapping, opt: Mapping, seed: int,
          batches: Sequence[Mapping[str, torch.Tensor]], device,
          precision: str = "fp32") -> dict:
    """``len(batches)`` AdamW steps from the weights of ``seed``, each
    followed by the balancing biases' move.

    Returns ``losses`` (each step's cross entropy), ``grad_norm`` (the
    first step's global norm before clipping), ``first_grad`` (each
    trained leaf's norm of the first step's clipped gradient),
    ``first_grad_sample`` (that gradient at each leaf's
    :func:`sample_index`, on the host), ``change`` (each leaf's norm of
    its stored value's change over all the steps) and ``biases`` (the
    balancing biases after the steps, by leaf name, on the host)."""
    stored = make_params(conf, seed, device)
    names = sorted(n for n in stored if not n.endswith("/" + BIAS))
    biases = sorted(n for n in stored if n.endswith("/" + BIAS))
    mom = {n: torch.zeros_like(stored[n], dtype=torch.float32)
           for n in names}
    vel = {n: torch.zeros_like(stored[n], dtype=torch.float32)
           for n in names}
    gamma = conf["bias_update_speed"]
    out: dict = {"losses": []}
    for step, batch in enumerate(batches, start=1):
        leaves = {n: stored[n].float().requires_grad_(True) for n in names}
        leaves.update({n: stored[n] for n in biases})
        total, ce, _, loads = loss_terms(leaves, batch, conf, precision)
        grads = torch.autograd.grad(total, [leaves[n] for n in names])
        del leaves, total
        out["losses"].append(float(ce.detach()))
        gnorm = torch.sqrt(sum(g.pow(2).sum() for g in grads))
        scale = torch.clamp(opt["clip_norm"] / gnorm.clamp(min=1e-12),
                            max=1.0)
        if step == 1:
            out["grad_norm"] = float(gnorm)
            out["first_grad"] = {n: float(g.norm() * scale)
                                 for n, g in zip(names, grads)}
            out["first_grad_sample"] = {
                n: (g.reshape(-1)[sample_index(g.numel()).to(g.device)]
                    * scale).cpu() for n, g in zip(names, grads)}
        lr = learning_rate(opt, step)
        bc1 = 1 - opt["b1"] ** step
        bc2 = 1 - opt["b2"] ** step
        with torch.no_grad():
            for n, g in zip(names, grads):
                g = g * scale
                mom[n].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                vel[n].mul_(opt["b2"]).add_(g * g, alpha=1 - opt["b2"])
                upd = (mom[n] / bc1) / (torch.sqrt(vel[n] / bc2) +
                                        opt["eps"])
                p32 = stored[n].float()
                if decays(n, p32.ndim):
                    upd = upd + opt["weight_decay"] * p32
                stored[n] = (p32 - lr * upd).to(stored[n].dtype)
            load = loads.float()
            move = gamma * torch.sign(load.mean(-1, keepdim=True) - load)
            for i, n in enumerate(biases_in_layer_order(biases)):
                stored[n] = stored[n] + move[i]
        del grads
    del mom, vel
    start = make_params(conf, seed, device)
    out["change"] = {n: float((stored[n].float() - start[n].float()).norm())
                     for n in names}
    out["biases"] = {n: stored[n].float().cpu() for n in biases}
    return out


def biases_in_layer_order(names: Sequence[str]) -> List[str]:
    """Bias leaf names ordered by their layer number."""
    return sorted(names, key=lambda n: int(n.split("/")[1]))
