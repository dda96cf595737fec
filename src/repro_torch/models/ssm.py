"""Sequence-mixing SSM blocks: Mamba (Jamba's 7-of-8 layers) and xLSTM's
mLSTM / sLSTM.

The port of ``repro/models/ssm.py``. Mamba runs chunkwise: a loop over
128-position chunks carrying the (B, di, ds) state, with an inclusive
scan inside each chunk. The reference's ``jax.lax.associative_scan``
has no PyTorch counterpart; here the scan is :func:`_doubling_scan`,
log2(chunk) = 7 rounds of the reference's own ``combine`` (Hillis and
Steele), which sums in another tree order: fp32 results agree to
rounding (1e-4 in the tests), not bit for bit. A cumprod / cumsum form
is not used: it divides by decay products that underflow when dt * |A|
is large. mLSTM has the stabilized sequential recurrence and the
chunkwise-parallel form (64-position chunks), ``impl="auto"`` taking the
latter at S >= 128; sLSTM is a time loop after one hoisted input
projection.

Every block has ``init_*(gen, cfg, dtype)``, ``*_forward(params, x,
cfg) -> (y, final state)``, ``init_*_state(cfg, batch, device)`` and
``*_step(params, x_t, state, cfg) -> (y_t, state)``; a step returns new
state tensors and leaves its input state as it was.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, matmul, normal
from repro_torch.sharding.local import batch_rows, on_batch_rows

#: The stabilizer's start and the log input gate of padded positions.
NEG_BIG = -1e30

State = Tuple[torch.Tensor, ...]


# ------------------------------------------------------------------ Mamba --

def _mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, d_state, d_conv, dt_rank)."""
    mc = cfg.mamba
    assert mc is not None
    di = mc.expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return di, mc.d_state, mc.d_conv, dt_rank


def init_mamba(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> Params:
    """Mamba parameters at the reference's scales; ``dt_bias``, ``A_log``
    (the S4D-lin init log(1..ds) per channel) and ``D`` are fp32."""
    d = cfg.d_model
    di, ds, dc, dtr = _mamba_dims(cfg)
    dev = gen.device
    f32 = torch.float32
    return {
        "w_in": normal(gen, (d, 2 * di), 1.0 / math.sqrt(d), dtype),
        "conv_w": normal(gen, (dc, di), 0.1, dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "w_dt_down": normal(gen, (di, dtr), 1.0 / math.sqrt(di), dtype),
        "w_dt_up": normal(gen, (dtr, di), 1.0 / math.sqrt(dtr), dtype),
        "dt_bias": torch.full((di,), -4.6, dtype=f32, device=dev),
        "w_bc": normal(gen, (di, 2 * ds), 1.0 / math.sqrt(di), dtype),
        "A_log": torch.log(torch.arange(1, ds + 1, dtype=f32, device=dev)
                           ).repeat(di, 1),
        "D": torch.ones((di,), dtype=f32, device=dev),
        "w_out": normal(gen, (di, d), 1.0 / math.sqrt(di), dtype),
    }


def _mamba_gates(params: Params, xc: torch.Tensor):
    """xc (..., di) post-conv activations -> fp32 (dt, B, C)."""
    dt = F.softplus(matmul(matmul(xc, params["w_dt_down"]),
                           params["w_dt_up"]).float() + params["dt_bias"])
    bc = matmul(xc, params["w_bc"]).float()
    ds = bc.shape[-1] // 2
    return dt, bc[..., :ds], bc[..., ds:]


def _causal_conv(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence of x (B, S, di), fp32
    accumulation in the reference's order, then silu, in x's dtype."""
    dc = params["conv_w"].shape[0]
    w = params["conv_w"].float()
    pad = F.pad(x.float(), (0, 0, dc - 1, 0))
    S = x.shape[1]
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(dc))
    return F.silu(out + params["conv_b"].float()).to(x.dtype)


def _doubling_scan(a: torch.Tensor, b: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of h -> a * h + b: after it, position t
    holds (prod a[..t], the state at t from a zero start). Each round
    folds in the prefix ``step`` positions back with the reference's
    ``combine(left, right) = (a1 a2, a2 b1 + b2)``."""
    step = 1
    while step < a.shape[1]:
        a_l, b_l = a[:, :-step], b[:, :-step]
        a_r, b_r = a[:, step:], b[:, step:]
        a = torch.cat([a[:, :step], a_l * a_r], dim=1)
        b = torch.cat([b[:, :step], a_r * b_l + b_r], dim=1)
        step *= 2
    return a, b


#: The Mamba parameters its recurrence reads (not the two projections).
_MAMBA_CORE = ("conv_w", "conv_b", "w_dt_down", "w_dt_up", "w_bc",
               "dt_bias", "A_log", "D")


def _core(params: Params) -> Params:
    """The parameters of the recurrence."""
    return {k: params[k] for k in _MAMBA_CORE if k in params}


def _mamba_scan(params: Params, xi: torch.Tensor, cfg: ModelConfig,
                chunk: int) -> Tuple[torch.Tensor, State]:
    """The conv, the selective gates and the chunked scan over xi (B, S,
    di): (fp32 y (B, S, di) before the ``silu(z)`` gate, (h, the conv
    window))."""
    B, S, _ = xi.shape
    di, ds, dc, _ = _mamba_dims(cfg)
    xc = _causal_conv(params, xi)                           # (B, S, di)
    dt, Bsel, Csel = _mamba_gates(params, xc)
    A = -torch.exp(params["A_log"])                         # (di, ds)
    pad = (-S) % chunk
    if pad:
        xc_p, dt_p, B_p, C_p = (F.pad(t, (0, 0, 0, pad))
                                for t in (xc, dt, Bsel, Csel))
    else:
        xc_p, dt_p, B_p, C_p = xc, dt, Bsel, Csel
    h = torch.zeros((B, di, ds), dtype=torch.float32, device=xi.device)
    ys = []
    for c0 in range(0, S + pad, chunk):
        xcc = xc_p[:, c0:c0 + chunk].float()
        dtc, Bc, Cc = (t[:, c0:c0 + chunk] for t in (dt_p, B_p, C_p))
        a = torch.exp(dtc[..., None] * A)                   # (B, Ck, di, ds)
        b = (dtc * xcc)[..., None] * Bc[:, :, None, :]
        a_cum, b_cum = _doubling_scan(a, b)
        h_t = a_cum * h[:, None] + b_cum
        ys.append(torch.einsum("bkis,bks->bki", h_t, Cc)
                  + params["D"] * xcc)
        h = h_t[:, -1]
    y = torch.cat(ys, dim=1)[:, :S]
    conv_state = F.pad(xi, (0, 0, dc - 1, 0))[:, S:S + dc - 1]
    return y, (h, conv_state)


def mamba_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                  chunk: int = 128
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (y, {"h": (B, di, ds) fp32, "conv": (B, dc - 1, di)
    the last inputs of the conv}). On ``DTensor``s the two projections
    stay tensor-parallel and the recurrence runs on each rank's batch
    rows (``on_batch_rows``)."""
    xi, z = torch.chunk(matmul(x, params["w_in"]), 2, dim=-1)
    y, (h, conv_state) = on_batch_rows(
        lambda p, xi: _mamba_scan(p, xi, cfg, chunk), xi, _core(params),
        (), 3)
    y = y.to(x.dtype) * F.silu(z)
    return matmul(y, params["w_out"]), {"h": h, "conv": conv_state}


def init_mamba_state(cfg: ModelConfig, batch: int, device
                     ) -> Dict[str, torch.Tensor]:
    """Zero fp32 state h (batch, di, ds) and bf16 conv window (batch,
    dc - 1, di)."""
    di, ds, dc, _ = _mamba_dims(cfg)
    return {"h": torch.zeros((batch, di, ds), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, dc - 1, di), dtype=torch.bfloat16,
                                device=device)}


def _mamba_cell(params: Params, xi: torch.Tensor, h: torch.Tensor,
                conv: torch.Tensor, dtype: torch.dtype
                ) -> Tuple[torch.Tensor, State]:
    """One position of the recurrence: xi (B, di) and the state -> (fp32
    y (B, di) before the ``silu(z)`` gate, (h, conv window))."""
    window = torch.cat([conv, xi[:, None].to(conv.dtype)], dim=1)
    xc = torch.einsum("bci,ci->bi", window.float(),
                      params["conv_w"].float())
    xc = F.silu(xc + params["conv_b"].float()).to(dtype)
    dt, Bsel, Csel = _mamba_gates(params, xc)               # (B, di), (B, ds)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt[..., None] * A)                        # (B, di, ds)
    b = (dt * xc.float())[..., None] * Bsel[:, None, :]
    h = a * h + b
    y = torch.einsum("bis,bs->bi", h, Csel) + params["D"] * xc.float()
    return y, (h, window[:, 1:])


def mamba_step(params: Params, x_t: torch.Tensor,
               state: Dict[str, torch.Tensor], cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x_t (B, 1, d) single-token decode (on ``DTensor``s the recurrence
    runs on batch rows, as in :func:`mamba_forward`)."""
    xi, z = torch.chunk(matmul(x_t[:, 0], params["w_in"]), 2, dim=-1)
    y, (h, conv) = on_batch_rows(
        lambda p, xi, h, c: _mamba_cell(p, xi, h, c, x_t.dtype), xi,
        _core(params), (state["h"], state["conv"]), 3)
    y = y.to(x_t.dtype) * F.silu(z)
    return matmul(y, params["w_out"])[:, None], {"h": h, "conv": conv}


# ------------------------------------------------------------------ mLSTM --

def _xlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(projection width dp, heads H, head width dp // H)."""
    dp = int(cfg.xlstm_proj_factor * cfg.d_model)
    H = cfg.n_heads
    dp -= dp % H
    return dp, H, dp // H


def init_mlstm(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> Params:
    """mLSTM parameters; ``if_bias`` (input gates -3, forget gates +3) is
    fp32."""
    d = cfg.d_model
    dp, H, _ = _xlstm_dims(cfg)
    std, stdp = 1.0 / math.sqrt(d), 1.0 / math.sqrt(dp)
    return {
        "w_up": normal(gen, (d, 2 * dp), std, dtype),
        "wq": normal(gen, (dp, dp), stdp, dtype),
        "wk": normal(gen, (dp, dp), stdp, dtype),
        "wv": normal(gen, (dp, dp), stdp, dtype),
        "w_if": normal(gen, (dp, 2 * H), stdp, dtype),
        "if_bias": torch.cat([torch.full((H,), -3.0), torch.full((H,), 3.0)]
                             ).to(gen.device),
        "w_down": normal(gen, (dp, d), stdp, dtype),
    }


def _mlstm_qkvg(params: Params, xin: torch.Tensor, H: int, dh: int):
    """q, k (scaled by 1/sqrt(dh)), v (..., H, dh) and the fp32 log
    input and log forget gates (..., H)."""
    lead = xin.shape[:-1]
    q = matmul(xin, params["wq"]).reshape(*lead, H, dh)
    k = matmul(xin, params["wk"]).reshape(*lead, H, dh) / math.sqrt(dh)
    v = matmul(xin, params["wv"]).reshape(*lead, H, dh)
    gates = matmul(xin, params["w_if"]).float() + params["if_bias"]
    return q, k, v, gates[..., :H], -F.softplus(-gates[..., H:])


def _mlstm_recurrence(q, k, v, log_i, log_f, state: State
                      ) -> Tuple[torch.Tensor, State]:
    """The stabilized mLSTM, step by step. q/k/v (B, S, H, dh); gates (B,
    S, H); state (C (B, H, dh, dh), n (B, H, dh), m (B, H)). Returns fp32
    h (B, S, H, dh) and the final state. The loop walks ``unbind``
    views: the backward of a per-position slice would write a zero
    gradient the size of the whole input at every position."""
    C, n, m = state
    hs = []
    for qt, kt, vt, li, lf in zip(*(x.unbind(1) for x in
                                    (q, k, v, log_i, log_f))):
        m_new = torch.maximum(lf + m, li)
        i_ = torch.exp(li - m_new)
        f_ = torch.exp(lf + m - m_new)
        C = f_[..., None, None] * C + i_[..., None, None] * \
            (kt[..., :, None] * vt[..., None, :]).float()
        n = f_[..., None] * n + i_[..., None] * kt.float()
        qf = qt.float()
        num = torch.einsum("bhd,bhde->bhe", qf, C)
        den = torch.abs(torch.einsum("bhd,bhd->bh", qf, n))
        hs.append(num / torch.maximum(den, torch.exp(-m_new))[..., None])
        m = m_new
    return torch.stack(hs, dim=1), (C, n, m)


def _mlstm_chunkwise(q, k, v, log_i, log_f, state: State, chunk: int = 64
                     ) -> Tuple[torch.Tensor, State]:
    """The chunkwise-parallel stabilized mLSTM: within a chunk the
    recurrence unrolls to an attention-like form with the decay matrix
    D[t, tau] = exp(a_t + b_tau - m_t) (a the cumsum of log_f, b = log_i -
    a, m the running stabilizer); (C, n, m) cross chunk boundaries only.
    The same function as :func:`_mlstm_recurrence` up to fp32
    rounding."""
    B, S, H, dh = q.shape
    pad = (-S) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=NEG_BIG)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    C0, n0, m0 = state
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))
    hs = []
    for c0 in range(0, S + pad, chunk):
        qf, kf, vf = (t[:, c0:c0 + chunk].float() for t in (q, k, v))
        a = torch.cumsum(log_f[:, c0:c0 + chunk].float(), dim=1)  # (B,L,H)
        b = log_i[:, c0:c0 + chunk].float() - a
        m = a + torch.maximum(m0[:, None], torch.cummax(b, dim=1).values)
        s = torch.einsum("bthd,bshd->bhts", qf, kf)               # (B,H,L,L)
        at, bt, mt = (x.transpose(1, 2) for x in (a, b, m))       # (B,H,L)
        logD = at[..., :, None] + bt[..., None, :] - mt[..., :, None]
        # The masked entries' exponent is replaced before exp, so their
        # gradient is 0 and never 0 * inf.
        D = torch.where(tri, torch.exp(torch.where(tri, logD, 0.0)), 0.0)
        carry_w = torch.exp(a + m0[:, None] - m)                  # (B,L,H)
        num = (torch.einsum("bthd,bhde->bthe", qf, C0) * carry_w[..., None]
               + torch.einsum("bhts,bshd->bthd", D * s, vf))
        qn = (torch.einsum("bthd,bhd->bth", qf, n0) * carry_w
              + torch.einsum("bhts,bhts->bht", D, s).transpose(1, 2))
        hs.append(num / torch.maximum(torch.abs(qn),
                                      torch.exp(-m))[..., None])
        aL, mL = a[:, -1], m[:, -1]                               # (B,H)
        w_tau = torch.exp(aL[:, None] + b - mL[:, None])          # (B,L,H)
        decay = torch.exp(aL + m0 - mL)
        C0 = decay[..., None, None] * C0 + torch.einsum(
            "bshd,bsh,bshe->bhde", kf, w_tau, vf)
        n0 = decay[..., None] * n0 + torch.einsum("bshd,bsh->bhd", kf,
                                                  w_tau)
        m0 = mL
    return torch.cat(hs, dim=1)[:, :S], (C0, n0, m0)


@batch_rows(4)
def mlstm_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                  impl: str = "auto") -> Tuple[torch.Tensor, State]:
    """x (B, S, d) -> (y, (C, n, m)). ``impl``: "auto" (chunkwise at S >=
    128), "chunkwise" or "sequential". On ``DTensor``s each rank runs
    its batch rows (``batch_rows``)."""
    B, S, _ = x.shape
    dp, H, dh = _xlstm_dims(cfg)
    xin, z = torch.chunk(matmul(x, params["w_up"]), 2, dim=-1)
    q, k, v, li, lf = _mlstm_qkvg(params, xin, H, dh)
    state = init_mlstm_state(cfg, B, x.device)
    if impl == "auto":
        impl = "chunkwise" if S >= 128 else "sequential"
    if impl == "chunkwise":
        hs, state = _mlstm_chunkwise(q, k, v, li, lf, state)
    elif impl == "sequential":
        hs, state = _mlstm_recurrence(q, k, v, li, lf, state)
    else:
        raise ValueError(f"unknown mlstm impl {impl!r}")
    y = hs.reshape(B, S, dp).to(x.dtype) * F.silu(z)
    return matmul(y, params["w_down"]), state


def init_mlstm_state(cfg: ModelConfig, batch: int, device) -> State:
    """(C, n, m): zeros, and m at -1e30."""
    _, H, dh = _xlstm_dims(cfg)
    f32 = torch.float32
    return (torch.zeros((batch, H, dh, dh), dtype=f32, device=device),
            torch.zeros((batch, H, dh), dtype=f32, device=device),
            torch.full((batch, H), NEG_BIG, dtype=f32, device=device))


@batch_rows(4, stateful=True)
def mlstm_step(params: Params, x_t: torch.Tensor, state: State,
               cfg: ModelConfig) -> Tuple[torch.Tensor, State]:
    """x_t (B, 1, d) single-token decode."""
    B = x_t.shape[0]
    dp, H, dh = _xlstm_dims(cfg)
    xin, z = torch.chunk(matmul(x_t[:, 0], params["w_up"]), 2, dim=-1)
    q, k, v, li, lf = _mlstm_qkvg(params, xin, H, dh)
    hs, state = _mlstm_recurrence(q[:, None], k[:, None], v[:, None],
                                  li[:, None], lf[:, None], state)
    y = hs[:, 0].reshape(B, dp).to(x_t.dtype) * F.silu(z)
    return matmul(y, params["w_down"])[:, None], state


# ------------------------------------------------------------------ sLSTM --

def init_slstm(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> Params:
    """sLSTM parameters; ``g_bias`` (4 dp) is fp32."""
    d = cfg.d_model
    dp, _, _ = _xlstm_dims(cfg)
    std, stdp = 1.0 / math.sqrt(d), 1.0 / math.sqrt(dp)
    return {
        "w_up": normal(gen, (d, 2 * dp), std, dtype),
        "w_gates": normal(gen, (dp, 4 * dp), stdp, dtype),
        "r_gates": normal(gen, (dp, 4 * dp), stdp * 0.5, dtype),
        "g_bias": torch.zeros((4 * dp,), dtype=torch.float32,
                              device=gen.device),
        "w_down": normal(gen, (dp, d), stdp, dtype),
    }


def _slstm_recurrence(params: Params, xin: torch.Tensor, state: State
                      ) -> Tuple[torch.Tensor, State]:
    """The stabilized sLSTM over xin (B, S, dp): the input projection for
    every position in one product, then a time loop holding only the
    recurrent ``h @ r_gates`` (over ``unbind`` views, as in
    :func:`_mlstm_recurrence`). Returns fp32 h (B, S, dp) and (c, n, m,
    h)."""
    x_pre = matmul(xin, params["w_gates"]).float() + params["g_bias"]
    c, n, m, h = state
    r_gates = params["r_gates"]
    hs = []
    for x_t in x_pre.unbind(1):
        pre = x_t + matmul(h.to(xin.dtype), r_gates).float()
        li, lf, zg, og = torch.chunk(pre, 4, dim=-1)
        lf = -F.softplus(-lf)
        m_new = torch.maximum(lf + m, li)
        i_ = torch.exp(li - m_new)
        f_ = torch.exp(lf + m - m_new)
        c = f_ * c + i_ * torch.tanh(zg)
        n = f_ * n + i_
        h = torch.sigmoid(og) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, m, h)


@batch_rows(5)
def slstm_forward(params: Params, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, State]:
    """x (B, S, d) -> (y, (c, n, m, h)); on ``DTensor``s each rank runs
    its batch rows."""
    xin, z = torch.chunk(matmul(x, params["w_up"]), 2, dim=-1)
    hs, state = _slstm_recurrence(params, xin,
                                  init_slstm_state(cfg, x.shape[0],
                                                   x.device))
    y = hs.to(x.dtype) * F.silu(z)
    return matmul(y, params["w_down"]), state


def init_slstm_state(cfg: ModelConfig, batch: int, device) -> State:
    """(c, n, m, h) of (batch, dp) fp32: zeros, m at -1e30."""
    dp, _, _ = _xlstm_dims(cfg)
    z = torch.zeros((batch, dp), dtype=torch.float32, device=device)
    return z, z.clone(), torch.full_like(z, NEG_BIG), z.clone()


@batch_rows(5, stateful=True)
def slstm_step(params: Params, x_t: torch.Tensor, state: State,
               cfg: ModelConfig) -> Tuple[torch.Tensor, State]:
    """x_t (B, 1, d) single-token decode."""
    xin, z = torch.chunk(matmul(x_t[:, 0], params["w_up"]), 2, dim=-1)
    hs, state = _slstm_recurrence(params, xin[:, None], state)
    y = hs[:, 0].to(x_t.dtype) * F.silu(z)
    return matmul(y, params["w_down"])[:, None], state
