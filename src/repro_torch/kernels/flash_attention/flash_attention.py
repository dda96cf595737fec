"""Flash attention, forward and backward: hand-written CUDA for Hopper
plus the plain PyTorch versions.

The port of ``repro/kernels/flash_attention/flash_attention.py``. The
CUDA kernels in ``flash_attention.cu`` replace the Pallas TPU kernel
``flash_attention_fwd``: q ``(B, H, Sq, D)`` against k, v
``(B, Hk, Sk, D)`` with GQA (query head h reads kv head ``h // (H //
Hk)``), online softmax in fp32, causal masking on global indices with
``q_offset``, output in q's dtype. bfloat16 inputs go to
``flash_fwd_bf16_kernel`` (wgmma on the tensor cores, K/V streamed by
TMA); float32 inputs to ``flash_fwd_f32_kernel`` (the CUDA cores, which
keep the reference's fp32 tolerance that TF32 would not).

:func:`flash_attention_fwd` launches a kernel for CUDA tensors and
counts the launch in :data:`LAUNCHES` (both kernels under one name); for
CPU tensors, or under ``impl="plain"``, it runs the plain version
:func:`ref.attention_ref`. With ``return_lse`` it also returns each
row's logsumexp, which the backward reads. Both directions are custom
ops (``torch.ops.repro_torch.flash_attention_fwd`` / ``_bwd``), so a
dispatch mode or a fake tensor sees each call as one op; plain tensors
take the ops' kernels directly (``_tensors.run_op``).

:func:`flash_attention_bwd` is the backward: the kernels of
``flash_attention_bwd.cu`` (no Pallas counterpart: they replace the
reference's plain-JAX custom VJP ``_blockwise_bwd``,
``repro/models/attention.py:142``) give dq, dk and dv from ``(q, k, v,
out, lse, dout)``; its plain version is :func:`ref.attention_bwd_ref`.
One call counts one launch under ``"flash_attention_bwd"``.

There is no fallback between a kernel and its plain version: a kernel
that fails to build or launch raises. The kernels take float32 and
bfloat16 and head dims in :data:`HEAD_DIMS`; anything else raises on a
CUDA tensor.

``bq`` and ``bk`` keep the reference's contract (``Sq % bq == 0`` and
``Sk % bk == 0``, which ``ops`` meets by padding) but do not reach the
kernels, which tile by their own sizes: the result does not depend on
them.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels._tensors import aligned16, run_op
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)

#: ``impl`` values: ``"kernel"`` launches the CUDA kernel for CUDA
#: tensors (the plain version serves CPU tensors); ``"plain"`` always runs
#: the plain version, on whatever device the tensors are on.
IMPLS = ("kernel", "plain")

#: Head dims both CUDA kernels are instantiated for.
HEAD_DIMS = (32, 64, 80, 128, 192)

#: Kernel name -> launches so far (bumped only where the kernel launches).
LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0,
                            "flash_attention_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: The compiled ``flash_attention.cu``: its launcher and the dynamic
#: shared memory a CTA of each kernel takes (by dtype code and head dim).
LIBRARY = CudaLibrary("flash", Path(__file__).with_name("flash_attention.cu"), {
    "flash_fwd_launch": (("ptr", "ptr", "ptr", "ptr", "ptr", "i32", "i32",
                          "i32", "i32", "i32", "i32", "i32", "i32", "i32",
                          "f32", "ptr"), "i32"),
    "flash_smem_bytes": (("i32", "i32"), "i64"),
})

#: The compiled ``flash_attention_bwd.cu``: its launcher and the dynamic
#: shared memory of its dK/dV (0) and dQ (1) kernels by dtype code and
#: head dim.
LIBRARY_BWD = CudaLibrary(
    "flash_bwd", Path(__file__).with_name("flash_attention_bwd.cu"), {
        "flash_bwd_launch": (("ptr",) * 10 + ("i32",) * 9 + ("f32", "ptr"),
                             "i32"),
        "flash_bwd_smem_bytes": (("i32", "i32", "i32"), "i64"),
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


def _check_impl(impl: str) -> None:
    """Raise for an unknown ``impl``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known: {IMPLS}")


def _on_cpu(t: torch.Tensor) -> None:
    """The ops' default kernel serves CPU tensors (the plain version);
    any device but the CPU and CUDA raises."""
    if t.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, not "
                         f"{t.device}")


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> None:
    """What the CUDA kernels take beyond the reference's contract: one
    dtype of float32 or bfloat16, a head dim of :data:`HEAD_DIMS`, a grid
    and element counts that fit their index types."""
    b, h, _, d = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the CUDA flash kernels take float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernels take head dims "
                         f"{HEAD_DIMS}, got {d}")
    if b > 65535 or h > 65535:
        raise ValueError(f"grid too large: B={b}, H={h}")
    if max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError("q or k has 2^31 or more elements")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, bq: int = 128, bk: int = 128,
                        q_offset: int = 0, impl: str = "kernel",
                        return_lse: bool = False):
    """q: (B, H, Sq, D); k, v: (B, Hk, Sk, D) with H % Hk == 0, Sq % bq
    == 0 and Sk % bk == 0 (``ops`` pads). Returns (B, H, Sq, D) in q's
    dtype. With ``causal``, query i sees keys j <= i + q_offset. With
    ``return_lse``, returns ``(out, lse)``: lse (B, H, Sq) fp32 is each
    row's natural-log logsumexp of the scaled, masked scores.

    ``impl="kernel"`` runs the op ``repro_torch::flash_attention_fwd``
    (``_tensors.run_op``): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors, empty outputs of the right shapes for fake
    tensors (so a dry-run sees one op; ``launch.op_analysis`` charges it
    the kernel's work). A ``DTensor`` raises there (the op has no
    sharding rule): callers pass local shards, through ``local_map``."""
    _check_shapes(q, k, v, bq, bk, q_offset)
    _check_impl(impl)
    if impl == "plain":
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                             return_lse=return_lse)
    out, lse = run_op(torch.ops.repro_torch.flash_attention_fwd, _fwd_cuda,
                      _fwd_cpu, q, k, v, bool(causal), int(q_offset),
                      bool(return_lse))
    return (out, lse) if return_lse else out


def _fwd_cpu(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            q_offset: int, return_lse: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op's default kernel, for CPU tensors: the plain version
    (``lse`` empty unless asked for)."""
    _on_cpu(q)
    if return_lse:
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                             return_lse=True)
    out = attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    return out, q.new_empty((0,), dtype=torch.float32)


_fwd_op = torch.library.custom_op("repro_torch::flash_attention_fwd",
                                  _fwd_cpu, mutates_args=())


@_fwd_op.register_fake
def _fwd_fake(q, k, v, causal, q_offset, return_lse):
    """Outputs of the right shapes and dtypes, nothing computed."""
    b, h, sq, _ = q.shape
    return torch.empty_like(q), q.new_empty(
        (b, h, sq) if return_lse else (0,), dtype=torch.float32)


@_fwd_op.register_kernel("cuda")
def _fwd_cuda(q, k, v, causal, q_offset, return_lse):
    """Launch the forward kernel on CUDA tensors."""
    _check_kernel_inputs(q, k, v)
    b, h, sq, d = q.shape
    _, hk, sk, _ = k.shape
    q, k, v = (aligned16(x.contiguous()) for x in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq) if return_lse else (0,),
                      dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   out.data_ptr(),
                                   lse.data_ptr() if return_lse else None,
                                   _DTYPES[q.dtype], b, h, hk, sq, sk, d,
                                   int(bool(causal)), int(q_offset),
                                   1.0 / math.sqrt(d), stream)
    LIBRARY.check(err, "flash_attention_fwd")
    LAUNCHES["flash_attention_fwd"] += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        q_offset: int = 0, impl: str = "kernel"):
    """Gradients (dq, dk, dv) of :func:`flash_attention_fwd` from its
    ``out`` and ``lse``: q, out, dout (B, H, Sq, D); k, v (B, Hk, Sk, D);
    lse (B, H, Sq) fp32. dq has q's shape and dtype, dk and dv k's (summed
    over each kv head's group of query heads). ``impl="kernel"`` runs
    the op ``repro_torch::flash_attention_bwd`` (the CUDA kernels for
    CUDA tensors, :func:`ref.attention_bwd_ref` for CPU tensors, shapes
    alone for fake ones); ``"plain"`` runs the plain version. Both
    compute in fp32, and the kernels give the same bits from run to run
    (no atomics)."""
    _check_shapes(q, k, v, 1, 1, q_offset)
    b, h, sq, d = q.shape
    if out.shape != q.shape or dout.shape != q.shape or \
            tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be q's shape "
                         f"{tuple(q.shape)}, lse {tuple(lse.shape)} must be "
                         f"{(b, h, sq)}")
    _check_impl(impl)
    if impl == "plain":
        return attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                 q_offset=q_offset)
    return run_op(torch.ops.repro_torch.flash_attention_bwd, _bwd_cuda,
                  _bwd_cpu, q, k, v, out, lse, dout, bool(causal),
                  int(q_offset))


def _bwd_cpu(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
            causal: bool, q_offset: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's default kernel, for CPU tensors: the plain version."""
    _on_cpu(q)
    return attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                             q_offset=q_offset)


_bwd_op = torch.library.custom_op("repro_torch::flash_attention_bwd",
                                  _bwd_cpu, mutates_args=())


@_bwd_op.register_fake
def _bwd_fake(q, k, v, out, lse, dout, causal, q_offset):
    """Gradients of the right shapes and dtypes, nothing computed."""
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@_bwd_op.register_kernel("cuda")
def _bwd_cuda(q, k, v, out, lse, dout, causal, q_offset):
    """Launch the backward kernels on CUDA tensors."""
    _check_kernel_inputs(q, k, v)
    b, h, sq, d = q.shape
    _, hk, sk, _ = k.shape
    if out.dtype != q.dtype or dout.dtype != q.dtype or \
            lse.dtype != torch.float32:
        raise TypeError(f"out and dout must be q's dtype {q.dtype} and lse "
                        f"float32, got {out.dtype}, {dout.dtype}, "
                        f"{lse.dtype}")
    if not all(t.device == q.device for t in (out, lse, dout)):
        raise ValueError("q, out, lse and dout on different devices")
    q, k, v, out, dout = (aligned16(x.contiguous())
                          for x in (q, k, v, out, dout))
    lse = lse.contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = LIBRARY_BWD.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_bwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), dout.data_ptr(),
                                   lse.data_ptr(), delta.data_ptr(),
                                   dq.data_ptr(), dk.data_ptr(),
                                   dv.data_ptr(), _DTYPES[q.dtype], b, h, hk,
                                   sq, sk, d, int(bool(causal)),
                                   int(q_offset), 1.0 / math.sqrt(d), stream)
    LIBRARY_BWD.check(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
