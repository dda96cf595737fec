"""Conversion of the reference's parameter pytree into the port's
parameters.

``params_from_numpy`` takes what ``repro.models.model.init_params``
returns, with every leaf turned into a numpy array (any float dtype,
``ml_dtypes.bfloat16`` included), and gives the dict
``repro_torch.models.model`` reads: the leading ``n_periods`` axis of
each block leaf is split into layers (layer ``p * period + i`` is block
``b{i}`` of period ``p``; an MoE expert stack keeps its expert axis
under the period axis). The ``(in, out)`` layout of the weight matrices
and the ``(vocab, d)`` layout of the tables are kept on purpose: both
sides compute ``x @ w``. bf16 and fp16 pass through fp32 numpy, which
holds them exactly. ``decode_state_from_numpy`` carries the reference's
decode state (``init_decode_state`` or a ``decode_step`` result) across
the same way.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import check_supported, resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32, "float64": torch.float64}
_NORMS = ("norm1", "norm2", "final_norm")
# Leaves the reference makes fp32 whatever the parameter dtype: the MoE
# router, Mamba's dt bias, A_log and D, the xLSTM gate biases.
_FP32_LEAVES = ("router", "dt_bias", "A_log", "D", "if_bias", "g_bias")


def _tensor(a: Any, device: torch.device,
            dtype: Optional[torch.dtype]) -> torch.Tensor:
    """One numpy leaf as a tensor in its own dtype, or in ``dtype``."""
    arr = np.asarray(a)
    name = str(arr.dtype)
    if name not in _DTYPES:
        raise TypeError(f"unsupported parameter dtype {arr.dtype}")
    wide = arr if name == "float64" else arr.astype(np.float32)
    t = torch.from_numpy(np.ascontiguousarray(wide))
    return t.to(device=device, dtype=dtype or _DTYPES[name])


def _convert(tree: Dict[str, Any], device: torch.device,
             dtype: Optional[torch.dtype], index: Optional[int] = None,
             in_norm: bool = False) -> Dict[str, Any]:
    """Convert a nested dict, taking row ``index`` of every leaf when
    given (one period of a stacked block). Norm parameters and the fp32
    leaves keep their dtype."""
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        norm = in_norm or key in _NORMS
        if isinstance(val, dict):
            out[key] = _convert(val, device, dtype, index, norm)
        else:
            leaf = val if index is None else np.asarray(val)[index]
            keep = norm or key in _FP32_LEAVES
            out[key] = _tensor(leaf, device, None if keep else dtype)
    return out


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device="cuda",
                      dtype: Optional[torch.dtype] = None
                      ) -> Dict[str, Any]:
    """The reference's ``init_params`` pytree (numpy leaves) as the
    port's parameters on ``device``. ``dtype`` None keeps each leaf's
    dtype; a dtype casts every weight, bias and table to it while the
    norm parameters and the fp32 leaves (``_FP32_LEAVES``) stay as they
    are."""
    check_supported(cfg)
    dev = resolve_device(device)
    layers = []
    for p in range(cfg.n_periods):
        for i in range(cfg.period):
            layers.append(_convert(tree["blocks"][f"b{i}"], dev, dtype,
                                   index=p))
    params: Dict[str, Any] = {"layers": layers}
    rest = {k: v for k, v in tree.items() if k != "blocks"}
    params.update(_convert(rest, dev, dtype))
    return params


def decode_state_from_numpy(cfg: ModelConfig, state: Dict[str, Any],
                            device="cuda") -> List[Dict[str, torch.Tensor]]:
    """The reference's decode state (numpy leaves, ``b{i}`` entries
    stacked over the periods) as the port's: one dict per layer, every
    tensor in its own dtype, the lane on axis 0."""
    check_supported(cfg)
    dev = resolve_device(device)
    return [_convert(state[f"b{i}"], dev, None, index=p)
            for p in range(cfg.n_periods) for i in range(cfg.period)]
