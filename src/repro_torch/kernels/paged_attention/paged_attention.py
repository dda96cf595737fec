"""Paged single-token decode attention: hand-written CUDA for Hopper plus
its plain PyTorch version.

The port of ``repro/kernels/paged_attention/paged_attention.py``. The
CUDA kernel in ``paged_attention.cu`` replaces the Pallas TPU kernel
``paged_attention``: q ``(B, H, D)`` attends over KV pages ``(NP, PS, Hk,
D)`` named by a ``(B, MAXP)`` int32 page table, masked at ``seq_lens``,
with fp32 running max, denominator and accumulator; GQA groups the H
query heads as ``(Hk, H // Hk)``. The kernel splits each request's
positions across the CTAs of one thread-block cluster and combines the
splits' partial softmax states in the same launch;
:func:`paged_attention_split_plain` is the plain version of that split
and combine, and :func:`split_count` the rule that picks the number of
splits.

:func:`paged_attention` launches the kernel for CUDA tensors and counts
the launch in :data:`LAUNCHES`; for CPU tensors, or under
``impl="plain"``, it runs the plain version
:func:`ref.paged_attention_ref`. There is no fallback between the two.
Before a launch the host checks every page-table entry against the page
pool (one device-to-host read), so the kernel never gathers outside it.
A table tensor that passed the check and has not been written since (its
version counter is unchanged) is not read again: a decode step passes the
same table to every layer.
"""
from __future__ import annotations

import math
import weakref
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels._build import HEAD_DIMS, CudaLibrary
from repro_torch.kernels._tensors import aligned16, run_op
from repro_torch.kernels.paged_attention.ref import (NEG_INF,
                                                     paged_attention_ref)

#: ``impl`` values, as for the flash kernel.
IMPLS = ("kernel", "plain")


#: Kernel name -> launches so far (bumped only where the kernel launches).
LAUNCHES: Dict[str, int] = {"paged_attention": 0}

#: Most CTAs one request's positions are split across (the portable
#: thread-block cluster size).
MAX_SPLITS = 8

#: Fewest positions the automatic split gives one CTA. 16 keeps all the
#: splits busy at llama3.2-3b's B = 1 prompt-replay call (160 positions),
#: where 64 would use three of eight; ``chip_smoke.py`` times both.
MIN_SPLIT_LEN = 16

#: Most query heads of a GQA group one CTA holds (the kernel's largest
#: instantiation); larger groups take several CTAs.
MAX_HEADS_PER_CTA = 8

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The last table that passed the range check: (the tensor, its version
# counter then, the pool size it was checked against).
_checked: Optional[Tuple[weakref.ref, int, int]] = None

#: The compiled ``paged_attention.cu`` and its launcher.
LIBRARY = CudaLibrary("paged", Path(__file__).with_name("paged_attention.cu"), {
    "paged_launch": (("ptr", "ptr", "ptr", "ptr", "ptr", "ptr", "i32", "i32",
                      "i32", "i32", "i32", "i32", "i32", "f32", "i32", "i32",
                      "ptr"), "i32"),
})

# Streaming multiprocessors by CUDA device index, read once.
_sm_count: Dict[int, int] = {}


def _check_inputs(q: torch.Tensor, k_pages: torch.Tensor,
                  v_pages: torch.Tensor, page_table: torch.Tensor,
                  seq_lens: torch.Tensor) -> None:
    """Shapes, types and devices both versions take."""
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"expected q (B, H, D) and pages (NP, PS, Hk, D), "
                         f"got {tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    b, h, d = q.shape
    n_pages, ps, hk, dk = k_pages.shape
    if dk != d or h % hk != 0:
        raise ValueError(f"need matching head dims and H % Hk == 0: q "
                         f"{tuple(q.shape)}, pages {tuple(k_pages.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or page_table.shape[1] == 0 or page_table.dtype != torch.int32:
        raise ValueError(f"expected a (B={b}, MAXP >= 1) int32 page table, "
                         f"got {tuple(page_table.shape)} {page_table.dtype}")
    if seq_lens.shape != (b,) or seq_lens.is_floating_point():
        raise ValueError(f"expected integer seq_lens of shape ({b},), got "
                         f"{tuple(seq_lens.shape)} {seq_lens.dtype}")
    if n_pages == 0 or ps == 0:
        raise ValueError("empty page pool")
    devs = {t.device for t in (q, k_pages, v_pages, page_table, seq_lens)}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")


def _check_impl(impl: str) -> None:
    """Raise for an unknown ``impl``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known: {IMPLS}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor, *,
                    impl: str = "kernel") -> torch.Tensor:
    """q: (B, H, D); k_pages/v_pages: (NP, PS, Hk, D); page_table:
    (B, MAXP) int32 page ids (entries past the live length may name any
    page of the pool: they are masked by seq_lens); seq_lens: (B,)
    integers. Returns (B, H, D) in q's dtype.

    ``impl="kernel"`` runs the op ``repro_torch::paged_attention``
    (``_tensors.run_op``): the CUDA kernel for CUDA tensors, the plain version for CPU tensors, an
    empty output for fake tensors (a dry-run sees one op). A ``DTensor``
    raises there (the op has no sharding rule): callers pass local
    shards. :func:`split_count` picks how many CTAs split each request's
    positions, each taking at least :data:`MIN_SPLIT_LEN` of them; the
    result does not depend on the count."""
    _check_inputs(q, k_pages, v_pages, page_table, seq_lens)
    _check_impl(impl)
    if impl == "plain":
        return paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens)
    return run_op(torch.ops.repro_torch.paged_attention, _paged_cuda,
                  _paged_cpu, q, k_pages, v_pages, page_table, seq_lens)


def _paged_cpu(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
              page_table: torch.Tensor, seq_lens: torch.Tensor
              ) -> torch.Tensor:
    """The op's default kernel, for CPU tensors: the plain version."""
    if q.device.type != "cpu":
        raise ValueError(f"paged attention runs on cuda or cpu tensors, not "
                         f"{q.device}")
    return paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens)


_paged_op = torch.library.custom_op("repro_torch::paged_attention",
                                    _paged_cpu, mutates_args=())


@_paged_op.register_fake
def _paged_fake(q, k_pages, v_pages, page_table, seq_lens):
    """An output of q's shape and dtype, nothing computed."""
    return torch.empty_like(q)


@_paged_op.register_kernel("cuda")
def _paged_cuda(q, k_pages, v_pages, page_table, seq_lens):
    """Check what the kernel takes, then launch it on CUDA tensors."""
    b, h, d = q.shape
    n_pages, ps, hk, _ = k_pages.shape
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"the CUDA paged kernel takes float32 or bfloat16 "
                        f"q and pages of one dtype, got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA paged kernel takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    maxp = page_table.shape[1]
    chunks = -(-(h // hk) // MAX_HEADS_PER_CTA)
    if b > 65535 or hk * chunks > 65535 or maxp * ps >= 2 ** 31:
        raise ValueError(f"too large: B={b}, Hk={hk}, MAXP*PS={maxp * ps}")
    n_split = split_count(b, hk * chunks, maxp * ps, q.device)
    lib = LIBRARY.load()
    _check_table(page_table, n_pages)
    q, k_pages, v_pages = (aligned16(x.contiguous())
                           for x in (q, k_pages, v_pages))
    page_table = page_table.contiguous()
    seq_lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    return _launch(lib, q, k_pages, v_pages, page_table, seq_lens, out,
                   n_split, MIN_SPLIT_LEN)


def split_count(b: int, groups: int, capacity: int,
                device: torch.device) -> int:
    """How many CTAs the kernel splits each request's positions across:
    enough that ``b * groups`` clusters of them fill the card's SMs, at
    most :data:`MAX_SPLITS`, and no more than the ``capacity`` (MAXP *
    PS positions) gives :data:`MIN_SPLIT_LEN` each. The kernel lowers it
    per request from that request's own length, so no length is read
    back to the host."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    want = -(-_sm_count[idx] // max(1, b * groups))
    return max(1, min(MAX_SPLITS, want, -(-capacity // MIN_SPLIT_LEN)))


def split_bounds(n_pos: torch.Tensor, n_split: int,
                 min_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split rule: a request that visits ``n_pos`` positions
    uses ``n_eff = min(n_split, ceil(n_pos / min_len))`` splits of
    ``ceil(n_pos / n_eff)`` positions each (split s takes positions [s *
    len, (s + 1) * len) below n_pos). Returns (n_eff, len)."""
    n_eff = torch.clamp((n_pos + min_len - 1) // min_len, max=n_split)
    return n_eff, (n_pos + n_eff - 1) // n_eff


def paged_attention_split_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor,
                                page_table: torch.Tensor,
                                seq_lens: torch.Tensor, n_split: int,
                                min_len: int = 1) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: each request's visited
    positions (all MAXP * PS of them, at score -1e30, when seq_len <= 0)
    cut by :func:`split_bounds`, a softmax state (max m, sum l, weighted
    sum acc) per split, and the splits folded in rank order, m = max(m1,
    m2), l = l1 e^(m1 - m) + l2 e^(m2 - m), acc likewise. Same shapes
    and result as :func:`ref.paged_attention_ref`."""
    _check_inputs(q, k_pages, v_pages, page_table, seq_lens)
    b, h, d = q.shape
    _, ps, hk, _ = k_pages.shape
    total = page_table.shape[1] * ps
    idx = page_table.long()
    k = k_pages[idx].reshape(b, total, hk, d)
    v = v_pages[idx].reshape(b, total, hk, d)
    k = torch.repeat_interleave(k, h // hk, dim=2).float()
    v = torch.repeat_interleave(v, h // hk, dim=2).float()
    sl = seq_lens.to(q.device).long()
    n_pos = torch.where(sl > 0, torch.clamp(sl, max=total),
                        torch.full_like(sl, total))
    s = torch.einsum("bhd,bshd->bhs", q.float(), k) / math.sqrt(d)
    s = torch.where((sl > 0)[:, None, None], s,
                    torch.full_like(s, NEG_INF))
    _, length = split_bounds(n_pos, n_split, min_len)
    pos = torch.arange(total, device=q.device)[None, :]
    part = torch.where(pos < n_pos[:, None], pos // length[:, None], -1)
    m = torch.full((b, h), NEG_INF, device=q.device)
    l = torch.zeros((b, h), device=q.device)
    acc = torch.zeros((b, h, d), device=q.device)
    for split in range(n_split):
        sel = (part == split)[:, None, :]
        m2 = torch.where(sel, s, torch.full_like(s, NEG_INF)).amax(-1)
        p = torch.where(sel, torch.exp(s - m2[..., None]),
                        torch.zeros_like(s))
        mn = torch.maximum(m, m2)
        c1, c2 = torch.exp(m - mn), torch.exp(m2 - mn)
        l = l * c1 + p.sum(-1) * c2
        acc = acc * c1[..., None] + \
            torch.einsum("bhs,bshd->bhd", p, v) * c2[..., None]
        m = mn
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def _check_table(page_table: torch.Tensor, n_pages: int) -> None:
    """Raise unless every entry of ``page_table`` lies in [0, n_pages).
    Reads the table back only when it is not the last table checked, or
    was written since, or was checked against a smaller pool."""
    global _checked
    if _checked is not None:
        ref, version, pool = _checked
        if ref() is page_table and page_table._version == version \
                and n_pages >= pool:
            return
    if bool(((page_table < 0) | (page_table >= n_pages)).any()):
        raise ValueError(f"page table names a page outside [0, {n_pages})")
    _checked = (weakref.ref(page_table), page_table._version, n_pages)


def _launch(lib, q, k_pages, v_pages, page_table, seq_lens, out, n_split,
            min_len):
    """Launch the kernel on checked, contiguous inputs into ``out``, with
    ``n_split`` CTAs per cluster and at least ``min_len`` positions per
    split."""
    b, h, d = q.shape
    _, ps, hk, _ = k_pages.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_launch(q.data_ptr(), k_pages.data_ptr(),
                               v_pages.data_ptr(), page_table.data_ptr(),
                               seq_lens.data_ptr(), out.data_ptr(),
                               _DTYPES[q.dtype], b, h, hk, ps,
                               page_table.shape[1], d, 1.0 / math.sqrt(d),
                               n_split, min_len, stream)
    LIBRARY.check(err, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out
