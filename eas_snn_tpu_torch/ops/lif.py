"""Parametric LIF dynamics as plain functions (counterpart of
``eas_snn_tpu/ops/lif.py``).

spikingjelly ``ParametricLIFNode(init_tau=2.0, decay_input=False,
v_reset=None)``: v <- v * (1 - sigmoid(w)) + x ; s = H(v - thresh) ;
v <- v - thresh * s. Time is the leading axis of a sequence: (T, ...).
With a spike function from ``surrogate.get_spike_fn`` the scan is
differentiable in x and w through the surrogate (the reset keeps its
gradient, as spikingjelly's ``detach_reset=False``): the autograd oracle
of the train PLIF op (``plif.plif_train``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

__all__ = ["PLIF_W_INIT", "plif_step", "plif_scan"]

# w = -log(init_tau - 1); init_tau = 2.0 gives w = 0.0 (decay 0.5).
PLIF_W_INIT = 0.0


def plif_step(
    vmem: torch.Tensor,
    x: torch.Tensor,
    w: torch.Tensor,
    spike_fn: Callable[[torch.Tensor], torch.Tensor],
    thresh: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One PLIF update (soft reset). Returns (v, spike)."""
    v = vmem * (1.0 - torch.sigmoid(w)) + x
    spike = spike_fn(v - thresh)
    return v - thresh * spike, spike


def plif_scan(
    x_seq: torch.Tensor,
    w: torch.Tensor,
    spike_fn: Callable[[torch.Tensor], torch.Tensor],
    thresh: float = 1.0,
    v0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PLIF over a (T, ...) sequence. Returns (spikes (T, ...), final v)."""
    v = torch.zeros_like(x_seq[0]) if v0 is None else v0
    spikes = []
    for x in x_seq:
        v, s = plif_step(v, x, w, spike_fn, thresh)
        spikes.append(s)
    return torch.stack(spikes), v
