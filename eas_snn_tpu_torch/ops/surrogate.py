"""Forward Heaviside spikes of the surrogate-gradient spike functions.

Counterpart of ``eas_snn_tpu/ops/surrogate.py`` for eval: each function
forwards a hard step; the surrogate gradients wait for the training slice.
atan and sigmoid threshold with ``>=``, rect and tanh with ``>``
(``patan`` at eval is atan's forward).
"""

from __future__ import annotations

import torch

__all__ = ["spike_ge", "heaviside", "get_spike_fn"]

_KINDS = ("rect", "atan", "sigmoid", "tanh", "patan")


def spike_ge(kind: str) -> bool:
    """True where the spike fires at ``x >= 0``, False where at ``x > 0``."""
    if kind not in _KINDS:
        raise KeyError(f"unknown spike_fn '{kind}'")
    return kind in ("atan", "sigmoid", "patan")


def heaviside(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Hard spike of ``x`` (membrane minus threshold) in ``x.dtype``."""
    s = x >= 0 if spike_ge(kind) else x > 0
    return s.to(x.dtype)


def get_spike_fn(kind: str):
    """``x -> heaviside(x, kind)`` for the named surrogate."""
    spike_ge(kind)
    return lambda x: heaviside(x, kind)
