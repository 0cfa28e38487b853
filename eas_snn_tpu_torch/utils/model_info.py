"""Parameter and FLOP report of a model (counterpart of
``eas_snn_tpu/utils/model_info.py``; reference
yolox/utils/model_utils.py:22-32 through thop): parameters by count, MACs
from the SOP accounting's conv MACs (``evaluators/energy.py:count_ops``),
no external profiler.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

__all__ = ["count_params", "model_info", "get_model_info"]


def count_params(model: nn.Module) -> int:
    """Parameters (BN running statistics are buffers, not counted)."""
    return int(sum(p.numel() for p in model.parameters()))


def model_info(model: nn.Module, sample_shape: Sequence[int]
               ) -> Tuple[int, float]:
    """(parameters, GFLOPs a frame) for events of ``sample_shape`` (B, Tl,
    Tm, H, W, C): conv MACs a frame x 2, taken on a zero-weight CPU copy
    (``evaluators/energy.py:conv_macs_per_frame``), so that the model's
    own device runs nothing."""
    from ..evaluators.energy import conv_macs_per_frame

    return (count_params(model),
            2.0 * conv_macs_per_frame(model, tuple(sample_shape)) / 1e9)


def get_model_info(model: nn.Module, sample_events: torch.Tensor) -> str:
    """'Params: N.NNM, Gflops: X.XX' (conv MACs only, x2 FLOPs a MAC, a
    frame of ``sample_events``' shape)."""
    n_params, gflops = model_info(model, sample_events.shape)
    return f"Params: {n_params / 1e6:.2f}M, Gflops: {gflops:.2f}"
