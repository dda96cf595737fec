"""A decoder-only LM with DeepSeekMoE blocks, trained with AdamW, in plain
PyTorch: the reference of the training cells whose configuration names
``"reference": "moe_lm"``.

It follows the configuration's keys (Hugging Face names) as the
benchmark runs them: RMSNorm, rotary attention (the two halves of each
head rotated), causal softmax attention, and a mixture-of-experts MLP with
``n_shared_experts`` always-on SwiGLU experts beside ``n_routed_experts``
routed ones: a softmax router, each token's ``num_experts_per_tok``
experts by a stable descending sort, their gates renormalised over those
(``norm_topk_prob``), and GShard's capacity: a (token, k) pair's place
in its expert's queue is the number of pairs before it in (token, k)
order; pairs past ``capacity_factor * k * T / E`` are dropped. The loss
is the mean next-token cross entropy over the labelled positions plus
``aux_loss_alpha`` times the Switch load-balance loss of every layer
(over each token's first expert). AdamW: global-norm clipping, linear
warmup, bias-corrected moments in float32, weight decay on every block
leaf and on top-level matrices.

Parameters are stored as the configuration states (``torch_dtype`` for
the matrices, float32 for the router and the norm scales); everything is
computed in float32, TF32 off. ``precision="fp8"`` is the control: every
matrix product's operands rounded to float8 e4m3 with a per-tensor
scale (gradients pass straight through the rounding).

Leaves are named as the port's parameter tree names them
(``layers/<i>/mixer/wq``, ...), so the two sides can be compared leaf by
leaf; the benchmark makes the weights here, from the seed, and hands the
same to the port."""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Leaves = Dict[str, torch.Tensor]
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def leaf_specs(conf: Mapping) -> List[Tuple[str, Tuple[int, ...], str,
                                            float]]:
    """(name, shape, dtype name, init std; 0 for a norm scale of ones) of
    every parameter leaf, in name order."""
    d, v = conf["hidden_size"], conf["vocab_size"]
    hd = d // conf["num_attention_heads"]
    q_dim = conf["num_attention_heads"] * hd
    kv_dim = conf["num_key_value_heads"] * hd
    e, de = conf["n_routed_experts"], conf["moe_intermediate_size"]
    sh = conf["n_shared_experts"] * de
    w = conf["torch_dtype"]
    sd, se, sq = 1 / math.sqrt(d), 1 / math.sqrt(de), 1 / math.sqrt(q_dim)
    out = [("embed/table", (v, d), w, sd), ("final_norm/scale", (d,),
                                              "float32", 0.0),
           ("unembed/table", (v, d), w, sd)]
    for i in range(conf["num_hidden_layers"]):
        pre = f"layers/{i}/"
        out += [(pre + "mixer/wq", (d, q_dim), w, sd),
                (pre + "mixer/wk", (d, kv_dim), w, sd),
                (pre + "mixer/wv", (d, kv_dim), w, sd),
                (pre + "mixer/wo", (q_dim, d), w, sq),
                (pre + "mlp/router", (d, e), "float32", sd),
                (pre + "mlp/w_in", (e, d, de), w, sd),
                (pre + "mlp/w_gate", (e, d, de), w, sd),
                (pre + "mlp/w_out", (e, de, d), w, se),
                (pre + "mlp/sh_in", (d, sh), w, sd),
                (pre + "mlp/sh_gate", (d, sh), w, sd),
                (pre + "mlp/sh_out", (sh, d), w, 1 / math.sqrt(sh)),
                (pre + "norm1/scale", (d,), "float32", 0.0),
                (pre + "norm2/scale", (d,), "float32", 0.0)]
    return sorted(out)


def make_params(conf: Mapping, seed: int, device) -> Leaves:
    """The weights from ``seed``: one normal draw a dtype on ``device``
    (a ``torch.Generator`` there), sliced and scaled leaf by leaf; norm
    scales are ones. The same seed gives the same bits on a device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    specs = leaf_specs(conf)
    out: Leaves = {}
    for dname in sorted({s[2] for s in specs}):
        group = [s for s in specs if s[2] == dname and s[3] > 0]
        total = sum(math.prod(s[1]) for s in group)
        flat = torch.randn(total, generator=gen, device=device,
                           dtype=DTYPES[dname])
        off = 0
        for name, shape, _, std in group:
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape) * std
            off += n
        del flat
    for name, shape, dname, std in specs:
        if std == 0:
            out[name] = torch.ones(shape, dtype=DTYPES[dname],
                                   device=device)
    return out


def as_tree(leaves: Leaves) -> dict:
    """The leaves as the port's parameter tree: nested dicts, with
    ``layers`` a list of one dict a layer."""
    tree: dict = {}
    for name, t in leaves.items():
        node = tree
        *path, last = name.split("/")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = t
    if "layers" in tree:
        tree["layers"] = [tree["layers"][str(i)]
                          for i in range(len(tree["layers"]))]
    return tree


def active_params(conf: Mapping) -> int:
    """Parameters a token multiplies with: all but the input embedding
    (a gather) and the routed experts it is not sent to."""
    total = 0
    e, k = conf["n_routed_experts"], conf["num_experts_per_tok"]
    for name, shape, _, _ in leaf_specs(conf):
        n = math.prod(shape)
        if name == "embed/table":
            continue
        if name.split("/")[-1] in ("w_in", "w_gate", "w_out"):
            n = n * k // e
        total += n
    return total


# ------------------------------------------------------------- forward --

def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, straight
    through in the backward pass."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())


class _Math:
    """Matrix products of the reference in its precision."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = _fp8(a), _fp8(b)
        return torch.matmul(a, b)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) at positions 0 .. S-1."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :,
                                                                 None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(x, p, conf, m: _Math):
    b, s, d = x.shape
    h, hk = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = d // h
    q = _rope(m.mm(x, p["wq"]).view(b, s, h, hd), conf["rope_theta"])
    k = _rope(m.mm(x, p["wk"]).view(b, s, hk, hd), conf["rope_theta"])
    v = m.mm(x, p["wv"]).view(b, s, hk, hd)
    k = k.repeat_interleave(h // hk, dim=2)
    v = v.repeat_interleave(h // hk, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))       # (B, H, S, D)
    scores = m.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    out = m.mm(probs, v).transpose(1, 2).reshape(b, s, h * hd)
    return m.mm(out, p["wo"])


def _swiglu(x, w_in, w_gate, w_out, m: _Math):
    return m.mm(F.silu(m.mm(x, w_gate)) * m.mm(x, w_in), w_out)


def _moe(x, p, conf, m: _Math):
    """(routed + shared experts' output, the layer's aux loss)."""
    b, s, d = x.shape
    t = b * s
    e, k = conf["n_routed_experts"], conf["num_experts_per_tok"]
    xt = x.reshape(t, d)
    probs = torch.softmax(m.mm(xt, p["router"]), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]
    gates = torch.gather(probs, 1, top)
    if conf["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    first = torch.bincount(top[:, 0], minlength=e).float() / t
    aux = e * torch.sum(probs.mean(0) * first)
    cap = max(1, int(conf["capacity_factor"] * k * t / e))
    flat = top.reshape(-1)
    onehot = F.one_hot(flat, e)
    pos = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
    keep = pos < cap
    gflat = gates.reshape(-1)
    y = torch.zeros_like(xt)
    for ex in range(e):
        idx = torch.nonzero((flat == ex) & keep)[:, 0]
        if idx.numel() == 0:
            continue
        tok = idx // k
        ye = _swiglu(xt[tok], p["w_in"][ex], p["w_gate"][ex],
                     p["w_out"][ex], m)
        y = y.index_add(0, tok, ye * gflat[idx, None])
    y = y.view(b, s, d) + _swiglu(x, p["sh_in"], p["sh_gate"], p["sh_out"],
                                  m)
    return y, aux


def _block(h, p, conf, m: _Math):
    eps = conf["rms_norm_eps"]
    h = h + _attention(_rms(h, p["norm1/scale"], eps), p, conf, m)
    y, aux = _moe(_rms(h, p["norm2/scale"], eps), p, conf, m)
    return h + y, aux


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
               precision: str = "fp32"
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total loss, cross entropy, summed aux loss) of float32 leaves
    ``p`` on one batch; each layer is recomputed in the backward pass."""
    m = _Math(precision)
    h = p["embed/table"][batch["tokens"].long()]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(conf["num_hidden_layers"]):
        lp = _layer_leaves(p, i)
        h, a = checkpoint(lambda h, lp=lp: _block(h, lp, conf, m), h,
                          use_reentrant=False)
        aux = aux + a
    h = _rms(h, p["final_norm/scale"], conf["rms_norm_eps"])
    logits = m.mm(h, p["unembed/table"].t())
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         batch["labels"].reshape(-1).long(),
                         ignore_index=-1)
    return ce + conf["aux_loss_alpha"] * aux, ce, aux


def sample_index(numel: int, size: int = 1 << 20) -> torch.Tensor:
    """The elements of a flattened leaf that a vector comparison reads:
    all of a small leaf, every k-th of a large one (at most about
    ``size``)."""
    return torch.arange(0, numel, max(1, numel // size))


# ---------------------------------------------------------------- AdamW --

def learning_rate(opt: Mapping, step: int) -> float:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then cosine
    decay to ``min_lr`` at ``total_steps`` (``step`` counts from 1)."""
    if step < opt["warmup_steps"]:
        return opt["peak_lr"] * step / opt["warmup_steps"]
    t = min(max((step - opt["warmup_steps"]) /
                max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    return opt["min_lr"] + 0.5 * (opt["peak_lr"] - opt["min_lr"]) * (
        1 + math.cos(math.pi * t))


def decays(name: str, ndim: int) -> bool:
    """Weight decay applies to every block leaf and to top-level
    matrices."""
    return name.startswith("layers/") or ndim >= 2


def train(conf: Mapping, opt: Mapping, seed: int,
          batches: Sequence[Mapping[str, torch.Tensor]], device,
          precision: str = "fp32") -> dict:
    """``len(batches)`` AdamW steps from the weights of ``seed``.

    Returns ``losses`` (each step's cross entropy), ``grad_norm`` (the
    first step's global norm before clipping), ``first_grad`` (each
    leaf's norm of the first step's clipped gradient, as the optimizer
    gets it), ``first_grad_sample`` (that gradient at each leaf's
    :func:`sample_index`, on the host) and ``change`` (each leaf's norm
    of its stored value's change over all the steps)."""
    stored = make_params(conf, seed, device)
    names = sorted(stored)
    mom = {n: torch.zeros_like(stored[n], dtype=torch.float32)
           for n in names}
    vel = {n: torch.zeros_like(stored[n], dtype=torch.float32)
           for n in names}
    out: dict = {"losses": []}
    for step, batch in enumerate(batches, start=1):
        leaves = {n: stored[n].float().requires_grad_(True) for n in names}
        total, ce, _ = loss_terms(leaves, batch, conf, precision)
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
        del grads
    del mom, vel
    start = make_params(conf, seed, device)
    out["change"] = {n: float((stored[n].float() - start[n].float()).norm())
                     for n in names}

    return out
