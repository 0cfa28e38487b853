"""Leaky integrate-and-fire dynamics as plain functions (counterpart of
``eas_snn_tpu/ops/lif.py`` and of ``eas_snn_tpu/ops/arsnn.py:
gated_lif_update``).

Time is the leading axis of a sequence: (T, ...). A LIF stores its decay
as a logit: the effective decay is ``sigmoid(decay)`` (reference
utils/util.py:278-280). The reset is soft when ``vreset`` is None
(v -= thresh * s), hard to ``vreset`` otherwise (v = v * (1 - s) +
vreset * s). With a spike function from ``surrogate.get_spike_fn`` every
function here is differentiable through the surrogate.

spikingjelly ``ParametricLIFNode(init_tau=2.0, decay_input=False,
v_reset=None)`` (PLIF): v <- v * (1 - sigmoid(w)) + x ; s = H(v - thresh) ;
v <- v - thresh * s. The reset keeps its gradient, as spikingjelly's
``detach_reset=False``: :func:`plif_scan` is the autograd oracle of the
train PLIF op (``plif.plif_train``) and the path that trains patan.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

__all__ = ["PLIF_W_INIT", "plif_step", "plif_scan", "lif_step", "lif_scan",
           "gated_lif_update"]

SpikeFn = Callable[[torch.Tensor], torch.Tensor]

# w = -log(init_tau - 1); init_tau = 2.0 gives w = 0.0 (decay 0.5).
PLIF_W_INIT = 0.0


def _reset(v: torch.Tensor, spike: torch.Tensor, thresh: float,
           vreset: Optional[float]) -> torch.Tensor:
    if vreset is None:
        return v - thresh * spike
    return v * (1.0 - spike) + vreset * spike


def gated_lif_update(vmem: torch.Tensor, gate: torch.Tensor,
                     current: torch.Tensor, thresh: float,
                     vreset: Optional[float], spike_fn: SpikeFn
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """v <- gate * v + current; spike; reset. Returns (v, v_no_reset,
    spike) (reference embedding.py:132-139)."""
    v = gate * vmem + current
    spike = spike_fn(v - thresh)
    return _reset(v, spike, thresh, vreset), v, spike


def lif_step(vmem: torch.Tensor, psp: torch.Tensor, decay: torch.Tensor,
             thresh: float, vreset: Optional[float], spike_fn: SpikeFn
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """v <- sigmoid(decay) * v + psp; spike; reset. Returns (v, v_no_reset,
    spike) (reference cell.py:37-65)."""
    return gated_lif_update(vmem, torch.sigmoid(decay), psp, thresh, vreset,
                            spike_fn)


def lif_scan(psp_seq: torch.Tensor, decay: torch.Tensor, thresh: float,
             vreset: Optional[float], spike_fn: SpikeFn
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LIF over a (T, ...) current sequence. Returns (spikes (T, ...), the
    final membrane, the sum of the no-reset membranes): the last two are
    the 'last' and 'sum' readouts of the snn embedding."""
    v = vsum = torch.zeros_like(psp_seq[0])
    spikes = []
    for psp in psp_seq:
        v, v_noreset, s = lif_step(v, psp, decay, thresh, vreset, spike_fn)
        vsum = vsum + v_noreset
        spikes.append(s)
    return torch.stack(spikes), v, vsum


def plif_step(
    vmem: torch.Tensor,
    x: torch.Tensor,
    w: torch.Tensor,
    spike_fn: SpikeFn,
    thresh: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One PLIF update (soft reset). Returns (v, spike)."""
    v = vmem * (1.0 - torch.sigmoid(w)) + x
    spike = spike_fn(v - thresh)
    return v - thresh * spike, spike


def plif_scan(
    x_seq: torch.Tensor,
    w: torch.Tensor,
    spike_fn: SpikeFn,
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
