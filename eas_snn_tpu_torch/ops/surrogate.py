"""Surrogate-gradient spike functions (counterpart of
``eas_snn_tpu/ops/surrogate.py``).

Each function forwards a hard Heaviside spike of ``x`` (membrane minus
threshold) in ``x.dtype`` and backpropagates ``g * f'(x)``, where f' is
:func:`surrogate_deriv`, the JAX PLIF kernels' ``_surrogate_deriv``
(``eas_snn_tpu/ops/plif_pallas.py:82-97``) with the same operation order.
atan and sigmoid fire at ``x >= 0``, rect and tanh at ``x > 0``; rect is
pinned to alpha = 1 as the JAX registry pins it. patan (ASGL) forwards
atan's hard spike; its training closure is not ported yet, so its
backward raises.
"""

from __future__ import annotations

import math

import torch

__all__ = ["spike_ge", "heaviside", "surrogate_deriv", "get_spike_fn",
           "train_alpha"]

_KINDS = ("rect", "atan", "sigmoid", "tanh", "patan")
_PATAN_TODO = ("patan (ASGL) training is not ported yet (ROADMAP.md, "
               "modules to port: 'Remaining model surface')")


def spike_ge(kind: str) -> bool:
    """True where the spike fires at ``x >= 0``, False where at ``x > 0``."""
    if kind not in _KINDS:
        raise KeyError(f"unknown spike_fn '{kind}'")
    return kind in ("atan", "sigmoid", "patan")


def train_alpha(kind: str, alpha: float) -> float:
    """The surrogate's alpha in training: rect is pinned to 1."""
    return 1.0 if kind == "rect" else float(alpha)


def heaviside(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Hard spike of ``x`` (membrane minus threshold) in ``x.dtype``."""
    s = x >= 0 if spike_ge(kind) else x > 0
    return s.to(x.dtype)


def surrogate_deriv(kind: str, alpha: float, x: torch.Tensor) -> torch.Tensor:
    """f'(x) of the named surrogate, in x's dtype."""
    if kind == "atan":
        t = ((math.pi / 2.0) * alpha) * x
        return x.new_full((), alpha / 2.0) / (1.0 + t * t)
    if kind == "rect":
        return (x.abs() < 0.5 / alpha).to(x.dtype) * alpha
    if kind == "sigmoid":
        s = torch.sigmoid(alpha * x)
        return alpha * s * (1.0 - s)
    if kind == "tanh":
        t = torch.tanh(alpha * x)
        return (0.5 * alpha) * (1.0 - t * t)
    if kind == "patan":
        raise NotImplementedError(_PATAN_TODO)
    raise KeyError(f"unknown spike_fn '{kind}'")


class _Spike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kind, alpha):
        ctx.save_for_backward(x)
        ctx.kind, ctx.alpha = kind, alpha
        return heaviside(x, kind)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * surrogate_deriv(ctx.kind, ctx.alpha, x), None, None


def get_spike_fn(kind: str, alpha: float = 2.0):
    """``x -> spike(x)`` for the named surrogate, differentiable through
    its surrogate gradient (patan: the hard forward, whose backward
    raises)."""
    spike_ge(kind)
    alpha = train_alpha(kind, alpha)
    return lambda x: _Spike.apply(x, kind, alpha)
