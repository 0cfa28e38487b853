"""Surrogate-gradient spike functions (counterpart of
``eas_snn_tpu/ops/surrogate.py``).

Each function forwards a hard Heaviside spike of ``x`` (membrane minus
threshold) in ``x.dtype`` and backpropagates ``g * f'(x)``, where f' is
:func:`surrogate_deriv`, the JAX PLIF kernels' ``_surrogate_deriv``
(``eas_snn_tpu/ops/plif_pallas.py:82-97``) with the same operation order.
atan and sigmoid fire at ``x >= 0``, rect and tanh at ``x > 0``; rect is
pinned to alpha = 1 as the JAX registry pins it. patan (ASGL,
:func:`asgl_spike`) forwards the hard spike at ``x >= 0`` through a
straight-through mix with the smooth :func:`inv_arctanh`, whose
derivative at p = 0 is atan's at ``|alpha|``; its ``alpha`` may be a
learnable tensor.
"""

from __future__ import annotations

import math

import torch

from typing import Optional, Union

__all__ = ["spike_ge", "heaviside", "surrogate_deriv", "get_spike_fn",
           "train_alpha", "inv_arctanh", "asgl_spike"]

_KINDS = ("rect", "atan", "sigmoid", "tanh", "patan")


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
    if kind in ("atan", "patan"):
        # patan: d/dx of inv_arctanh, atan's derivative at |alpha|
        alpha = abs(alpha) if kind == "patan" else alpha
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


def inv_arctanh(x: torch.Tensor, alpha) -> torch.Tensor:
    """The smooth CDF-like squashing 1/pi * atan(pi/2 * |alpha| * x) + 0.5
    (reference activation.py:121-131 InvArcTanh)."""
    return (1.0 / math.pi) * torch.atan((math.pi / 2.0) * abs(alpha) * x) \
        + 0.5


def asgl_spike(x: torch.Tensor, alpha: Union[float, torch.Tensor],
               p: float = 0.0, generator: Optional[torch.Generator] = None,
               training: bool = True,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ASGL straight-through spike, ``sig + ((hard - sig) * mask).detach()``
    with ``sig = inv_arctanh(x, alpha)`` and ``hard = (x >= 0)``: each
    element takes the hard spike where ``mask`` is 1 and the smooth value
    where it is 0; the gradient always follows the smooth function, into
    x and a tensor ``alpha`` (reference activation.py:181-205
    EfficientNoisySpikeII). ``mask`` defaults to 1 at ``p <= 0`` (no
    random numbers are drawn) and to a Bernoulli(1 - p) draw from
    ``generator`` otherwise (the device's default generator when None);
    an injected ``mask`` overrides both. At eval the hard spike."""
    hard = (x >= 0).to(x.dtype)
    if not training:
        return hard
    sig = inv_arctanh(x, alpha)
    if mask is None:
        if p <= 0.0:
            return sig + (hard - sig).detach()
        mask = torch.bernoulli(torch.full_like(x, 1.0 - p),
                               generator=generator)
    return sig + ((hard - sig) * mask).detach()


def get_spike_fn(kind: str, alpha: float = 2.0):
    """``x -> spike(x)`` for the named surrogate, differentiable through
    its surrogate gradient (patan: ``asgl_spike`` at p = 0 with a fixed
    alpha, as the JAX registry gives it)."""
    spike_ge(kind)
    if kind == "patan":
        return lambda x: asgl_spike(x, float(alpha))
    alpha = train_alpha(kind, alpha)
    return lambda x: _Spike.apply(x, kind, alpha)
