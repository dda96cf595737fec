"""Paged single-token decode attention: hand-written CUDA for Hopper plus
its plain PyTorch version.

The port of ``repro/kernels/paged_attention/paged_attention.py``. The
CUDA kernel in ``paged_attention.cu`` replaces the Pallas TPU kernel
``paged_attention``: q ``(B, H, D)`` attends over KV pages ``(NP, PS, Hk,
D)`` named by a ``(B, MAXP)`` int32 page table, masked at ``seq_lens``,
with fp32 running max, denominator and accumulator; GQA groups the H
query heads as ``(Hk, H // Hk)``.

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

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

#: ``impl`` values, as for the flash kernel.
IMPLS = ("kernel", "plain")

#: Head dims the CUDA kernel is instantiated for.
HEAD_DIMS = (32, 64, 128)

#: Kernel name -> launches so far (bumped only where the kernel launches).
LAUNCHES: Dict[str, int] = {"paged_attention": 0}

#: Dynamic shared memory a CTA may use on Hopper (232,448 bytes).
MAX_SMEM_BYTES = 227 * 1024

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The last table that passed the range check: (the tensor, its version
# counter then, the pool size it was checked against).
_checked: Optional[Tuple[weakref.ref, int, int]] = None

#: The compiled ``paged_attention.cu`` and its launcher.
LIBRARY = CudaLibrary("paged", Path(__file__).with_name("paged_attention.cu"), {
    "paged_launch": (("ptr", "ptr", "ptr", "ptr", "ptr", "ptr", "i32", "i32",
                      "i32", "i32", "i32", "i32", "i32", "f32", "ptr"),
                     "i32"),
    "paged_smem_bytes": (("i32", "i32"), "i64"),
})


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


def _use_kernel(t: torch.Tensor, impl: str) -> bool:
    """True when the wrapper must launch the CUDA kernel: a CUDA tensor
    under ``impl="kernel"``. CPU tensors take the plain version; any
    other device raises."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known: {IMPLS}")
    if t.device.type == "cuda":
        return impl == "kernel"
    if t.device.type == "cpu":
        return False
    raise ValueError(f"paged attention runs on cuda or cpu tensors, not "
                     f"{t.device}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    seq_lens: torch.Tensor, *,
                    impl: str = "kernel") -> torch.Tensor:
    """q: (B, H, D); k_pages/v_pages: (NP, PS, Hk, D); page_table:
    (B, MAXP) int32 page ids (entries past the live length may name any
    page of the pool: they are masked by seq_lens); seq_lens: (B,)
    integers. Returns (B, H, D) in q's dtype."""
    _check_inputs(q, k_pages, v_pages, page_table, seq_lens)
    if not _use_kernel(q, impl):
        return paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens)
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
    if b > 65535 or hk > 65535 or page_table.shape[1] * ps >= 2 ** 31:
        raise ValueError(f"too large: B={b}, Hk={hk}, "
                         f"MAXP*PS={page_table.shape[1] * ps}")
    lib = LIBRARY.load()
    smem = lib.paged_smem_bytes(h // hk, d)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"GQA group of {h // hk} heads at D={d} needs "
                         f"{smem} bytes of shared memory")
    _check_table(page_table, n_pages)
    q, k_pages, v_pages = q.contiguous(), k_pages.contiguous(), \
        v_pages.contiguous()
    page_table = page_table.contiguous()
    seq_lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    return _launch(lib, q, k_pages, v_pages, page_table, seq_lens, out)


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


def _launch(lib, q, k_pages, v_pages, page_table, seq_lens, out):
    """Launch the kernel on checked, contiguous inputs into ``out``."""
    b, h, d = q.shape
    _, ps, hk, _ = k_pages.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_launch(q.data_ptr(), k_pages.data_ptr(),
                               v_pages.data_ptr(), page_table.data_ptr(),
                               seq_lens.data_ptr(), out.data_ptr(),
                               _DTYPES[q.dtype], b, h, hk, ps,
                               page_table.shape[1], d, 1.0 / math.sqrt(d),
                               stream)
    LIBRARY.check(err, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out
