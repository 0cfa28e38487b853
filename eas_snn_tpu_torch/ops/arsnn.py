"""Adaptive recurrent SNN (ARSNN) sampling scan (counterpart of
``eas_snn_tpu/ops/arsnn.py:arsnn_scan``), plain PyTorch, differentiable.

A gated recurrent LIF runs over Tm micro-steps; each spike closes the
current temporal slice of its (pixel, channel) and writes a readout of the
accumulated membrane into the next of Ts slots. The data-dependent scatter
of the reference is a dense masked one-hot write, as in the JAX package,
whose deploy and train paths also run this scan as plain XLA. Layout NCHW:
events (Tm, N, Cin, H, W) -> aggregation (Ts, N, C, H, W).

Gradients flow as in the JAX scan: through the spike function's surrogate
(the caller's ``spike_fn``), the gates, currents and readouts; the control
masks come from the detached spike, and the int8 slot counters and
last-spike times carry none. With ``remat`` each micro-step keeps only its
inputs for the backward, which recomputes the step's internals (the JAX
scan's ``jax.checkpoint(step)``, ``eas_snn_tpu/ops/arsnn.py:182-188``),
under the spatial sharding its forward ran in (the gate stack's halo).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import active_spatial, spatial_context
from .arsnn_fused import sigmoid as _sigmoid_rounded
from .lif import gated_lif_update

__all__ = ["arsnn_scan"]


def _gate(x: torch.Tensor) -> torch.Tensor:
    """The gate sigmoid as the JAX scan computes it: in bf16 XLA expands
    ``jax.nn.sigmoid`` as 1/(1+exp(-x)) with a rounding after every op,
    where ``torch.sigmoid`` rounds once. In f32 ``torch.sigmoid``, whose
    gradient stays finite where exp(-x) overflows."""
    if x.dtype == torch.bfloat16:
        return _sigmoid_rounded(x)
    return torch.sigmoid(x)


def _onehot(seg: torch.Tensor, Ts: int) -> torch.Tensor:
    iota = torch.arange(Ts, dtype=seg.dtype, device=seg.device)
    return seg[None] == iota.reshape((Ts,) + (1,) * seg.dim())


def arsnn_scan(
    events: torch.Tensor,
    input_conv_fn: Callable[[torch.Tensor], torch.Tensor],
    gate_conv_fn: Callable[[torch.Tensor], torch.Tensor],
    *,
    Ts: int,
    thresh: float,
    vreset: Optional[float],
    spike_fn: Callable[[torch.Tensor], torch.Tensor],
    readout: str = "sum",
    spike_attach: bool = False,
    write_zero: bool = False,
    use_abs: bool = False,
    remat: bool = False,
) -> torch.Tensor:
    """Run the sampler over a time-major (Tm, N, Cin, H, W) stack, already
    time-reversed by the caller. The state lives in ``events.dtype``.
    Returns the (Ts, N, C, H, W) aggregation; ``remat`` recomputes each
    micro-step in the backward."""
    if readout not in ("sum", "last", "avg"):
        raise NotImplementedError(f"readout '{readout}'")
    Tm, N = events.shape[:2]
    dt = events.dtype
    inp = input_conv_fn(events.reshape((Tm * N,) + tuple(events.shape[2:])))
    inp = inp.reshape((Tm, N) + tuple(inp.shape[1:]))
    C = inp.shape[2] // 2
    g_in_all, c_in_all = inp[:, :, :C], inp[:, :, C:]

    shape = g_in_all.shape[1:]
    dev = events.device
    zero = torch.zeros(shape, dtype=dt, device=dev)
    vmem, spike, vavg = zero, zero, zero
    # slot counters and last-spike times are tiny ints (< Tm, Ts)
    seg = torch.zeros(shape, dtype=torch.int8, device=dev)
    t_last = torch.full(shape, -1, dtype=torch.int8, device=dev)
    agg = torch.zeros((Ts,) + tuple(shape), dtype=dt, device=dev)

    def step(t, vmem, spike, vavg, seg, t_last, agg, g_in, c_in):
        state = gate_conv_fn(spike)
        g_rec, c_rec = state[:, :C], state[:, C:]
        gate = _gate(g_in + g_rec)
        vmem, v_noreset, spike = gated_lif_update(
            vmem, gate, c_in + c_rec, thresh, vreset, spike_fn)
        vavg = vavg + v_noreset
        spiked = spike.detach() > 0.5
        valid = spiked & (seg < Ts)
        if readout == "sum":
            v = vavg
        elif readout == "last":
            v = vmem
        else:
            v = vavg / torch.clamp(t - t_last, min=1).to(dt)
        if spike_attach:
            v = v * spike
        write = torch.where(valid, v, torch.zeros((), dtype=dt, device=dev))
        agg = agg + _onehot(seg, Ts).to(dt) * write[None]
        seg = seg + valid.to(torch.int8)
        t_last = torch.where(valid, torch.full((), t, dtype=torch.int8,
                                               device=dev), t_last)
        vavg = torch.where(spiked, torch.zeros((), dtype=dt, device=dev), vavg)
        return vmem, spike, vavg, seg, t_last, agg

    carry = (vmem, spike, vavg, seg, t_last, agg)
    sp = active_spatial()
    for t in range(Tm):
        xs = (g_in_all[t], c_in_all[t])
        if remat and torch.is_grad_enabled():
            # the step draws no random numbers: no RNG state to stash
            carry = checkpoint(step, t, *carry, *xs, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=lambda: (contextlib.nullcontext(),
                                                   spatial_context(sp)))
        else:
            carry = step(t, *carry, *xs)
    vmem, spike, vavg, seg, t_last, agg = carry

    # residual write for elements that never closed their last slot
    valid = (spike.detach() <= 0.5) & (seg < Ts)
    if readout == "sum":
        v = vavg
    elif readout == "last":
        v = vmem
    else:
        v = vavg / torch.clamp(Tm - 1 - t_last, min=1).to(dt)
    if write_zero:
        v = v * 0.0
    write = torch.where(valid, v, torch.zeros((), dtype=dt, device=dev))
    agg = agg + _onehot(seg, Ts).to(dt) * write[None]
    if use_abs:
        agg = torch.relu(agg)
    return agg
