"""Flash-attention forward: hand-written CUDA for Hopper plus its plain
PyTorch version.

The port of ``repro/kernels/flash_attention/flash_attention.py``. The
CUDA kernel in ``flash_attention.cu`` replaces the Pallas TPU kernel
``flash_attention_fwd``: q ``(B, H, Sq, D)`` against k, v
``(B, Hk, Sk, D)`` with GQA (query head h reads kv head ``h // (H //
Hk)``), online softmax in fp32, causal masking on global indices with
``q_offset``, output in q's dtype.

:func:`flash_attention_fwd` launches the kernel for CUDA tensors and
counts the launch in :data:`LAUNCHES`; for CPU tensors, or under
``impl="plain"``, it runs the plain version :func:`ref.attention_ref`.
There is no fallback between the two: a kernel that fails to build or
launch raises. The kernel takes float32 and bfloat16 and head dims in
:data:`HEAD_DIMS`; anything else raises on a CUDA tensor.

``bq`` and ``bk`` keep the reference's contract (``Sq % bq == 0`` and
``Sk % bk == 0``, which ``ops`` meets by padding) but do not reach the
kernel, which tiles by its own 64 x 64: the result does not depend on
them.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.flash_attention.ref import attention_ref

#: ``impl`` values: ``"kernel"`` launches the CUDA kernel for CUDA
#: tensors (the plain version serves CPU tensors); ``"plain"`` always runs
#: the plain version, on whatever device the tensors are on.
IMPLS = ("kernel", "plain")

#: Head dims the CUDA kernel is instantiated for.
HEAD_DIMS = (32, 64, 128)

#: Kernel name -> launches so far (bumped only where the kernel launches).
LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: The compiled ``flash_attention.cu`` and its launcher.
LIBRARY = CudaLibrary("flash", Path(__file__).with_name("flash_attention.cu"), {
    "flash_fwd_launch": (("ptr", "ptr", "ptr", "ptr", "i32", "i32", "i32",
                          "i32", "i32", "i32", "i32", "i32", "i32", "f32",
                          "ptr"), "i32"),
})


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bq: int, bk: int, q_offset: int) -> None:
    """The reference's contract (``flash_attention.py:69``): H % Hk == 0,
    Sq % bq == 0, Sk % bk == 0; plus matching shapes, one device, at
    least one key and a non-negative ``q_offset``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, H, Sq, D) and k, v (B, Hk, Sk, D),"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    _, hk, sk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    if not (h % hk == 0 and sq % bq == 0 and sk % bk == 0):
        raise ValueError(f"need H % Hk == 0, Sq % bq == 0, Sk % bk == 0: "
                         f"H={h} Hk={hk} Sq={sq} bq={bq} Sk={sk} bk={bk}")
    if sk == 0:
        raise ValueError("no keys: Sk must be positive")
    if q_offset < 0:
        raise ValueError(f"q_offset={q_offset} must be >= 0")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")


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
    raise ValueError(f"flash attention runs on cuda or cpu tensors, not "
                     f"{t.device}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, bq: int = 128, bk: int = 128,
                        q_offset: int = 0,
                        impl: str = "kernel") -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hk, Sk, D) with H % Hk == 0, Sq % bq
    == 0 and Sk % bk == 0 (``ops`` pads). Returns (B, H, Sq, D) in q's
    dtype. With ``causal``, query i sees keys j <= i + q_offset."""
    _check_shapes(q, k, v, bq, bk, q_offset)
    if not _use_kernel(q, impl):
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    b, h, sq, d = q.shape
    _, hk, sk, _ = k.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the CUDA flash kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernel takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    if b > 65535 or h > 65535:
        raise ValueError(f"grid too large: B={b}, H={h}")
    if max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError("q or k has 2^31 or more elements")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), _DTYPES[q.dtype], b, h,
                                   hk, sq, sk, d, int(bool(causal)),
                                   int(q_offset), 1.0 / math.sqrt(d), stream)
    LIBRARY.check(err, "flash_attention_fwd")
    LAUNCHES["flash_attention_fwd"] += 1
    return out
