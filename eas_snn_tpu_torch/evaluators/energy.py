"""Synaptic-operation counting and energy estimation (the port's
counterpart of ``eas_snn_tpu/evaluators/energy.py``; reference
yolox/evaluators/event_evaluator.py:466-565, yolox/utils/hooks.py:31-116).

The JAX package sows a ones-kernel coverage count in every ``BaseConv``;
here forward pre-hooks on the port's ``models/blocks.py:BaseConv`` take
the same count, installed for one forward and removed after it, so the
normal forward pays nothing. A hook sees a site's input before the site
consumes it (a fused site reads int8 spikes; a tuple input is a virtual
channel concat, counted piece by piece). For a k x k conv of stride s
from C_in to C_out channels (groups 1: the port has no grouped conv):

    sops = sum over output positions of the window sum of |x| over all
           input channels (a ones-kernel conv) * C_out
    macs = N * H_out * W_out * k^2 * C_in * C_out

in f64 from f32 partial sums (the JAX package sums in the conv's compute
dtype), and a flag for whether the site spikes.

Energy model constants from the reference (:561-563): 0.9 pJ a synaptic
op (spike-driven) against 4.6 pJ a MAC (dense).
"""

from __future__ import annotations

import copy
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.blocks import BaseConv

__all__ = ["count_ops", "estimate_energy", "conv_macs_per_frame",
           "E_SOP_PJ", "E_MAC_PJ"]

E_SOP_PJ = 0.9
E_MAC_PJ = 4.6


def _site_ops(mod: BaseConv, x) -> np.ndarray:
    """[sops, macs, spiking] of one call of ``mod`` on input ``x``."""
    pieces = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    k, s = mod.ksize, mod.stride
    # channel sums of |x| first: the ones kernel sums every input channel
    # alike, so one single-channel window sum gives the same coverage
    acc = sum(p.float().abs().sum(1, keepdim=True) for p in pieces)
    ones = torch.ones((1, 1, k, k), dtype=torch.float32, device=acc.device)
    coverage = F.conv2d(acc, ones, stride=s, padding=(k - 1) // 2)
    c_in = sum(p.shape[1] for p in pieces)
    c_out = mod.weight.shape[0]
    out_hw = coverage.shape[0] * coverage.shape[2] * coverage.shape[3]
    sops = float(coverage.double().sum()) * c_out
    macs = float(out_hw) * k * k * c_in * c_out
    return np.array([sops, macs, float(mod.neuron.spiking)], np.float64)


def count_ops(model: nn.Module, events: torch.Tensor
              ) -> Dict[str, np.ndarray]:
    """One eval forward of ``model`` on ``events`` collecting
    {module name: array([sops, macs, is_spiking])} over every
    ``BaseConv``, summed over its calls; the model's train/eval mode is
    restored."""
    out: Dict[str, np.ndarray] = {}
    handles = []

    def hook(name):
        def pre(mod, args):
            ops = _site_ops(mod, args[0])
            out[name] = out[name] + ops if name in out else ops
        return pre

    for name, mod in model.named_modules():
        if isinstance(mod, BaseConv):
            handles.append(mod.register_forward_pre_hook(hook(name)))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(events)
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    return out


def estimate_energy(model: nn.Module, events: torch.Tensor
                    ) -> Dict[str, float]:
    """Whole-model energy a frame, split into the spiking (SOP) and the
    dense (MAC) part (reference event_evaluator.py:544-565)."""
    ops = count_ops(model, events)
    sops = sum(float(v[0]) for v in ops.values() if v[2] > 0)
    macs_snn_modules = sum(float(v[1]) for v in ops.values() if v[2] > 0)
    macs = sum(float(v[1]) for v in ops.values() if v[2] == 0)
    batch = events.shape[0]
    return {
        "sops": sops / batch,
        "dense_macs": macs / batch,
        "snn_equivalent_macs": macs_snn_modules / batch,
        "snn_energy_mJ": sops / batch * E_SOP_PJ * 1e-9,
        "ann_energy_mJ": macs / batch * E_MAC_PJ * 1e-9,
        "total_energy_mJ": (sops * E_SOP_PJ + macs * E_MAC_PJ) / batch * 1e-9,
    }


def conv_macs_per_frame(model: nn.Module, sample_shape: Sequence[int]
                        ) -> float:
    """Conv MACs a frame for events of ``sample_shape`` (B, Tl, Tm, H, W,
    C): MACs depend on shapes only, so one eval forward of a zero-weight
    f32 copy of the model on the CPU gives them, whatever device the model
    is on."""
    cpu = copy.deepcopy(model).to("cpu", torch.float32)
    with torch.no_grad():
        for t in list(cpu.parameters()) + list(cpu.buffers()):
            if t.is_floating_point():
                t.zero_()
    for m in cpu.modules():
        if hasattr(m, "dtype") and isinstance(m.dtype, torch.dtype):
            m.dtype = torch.float32
    ops = count_ops(cpu, torch.zeros(tuple(sample_shape)))
    return sum(float(v[1]) for v in ops.values()) / sample_shape[0]
