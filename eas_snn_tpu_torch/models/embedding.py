"""The ARSNN adaptive sampler as an event-to-frame front end (counterpart
of ``eas_snn_tpu/models/embedding.py:ARSNNEmbedding``; reference
embedding.py:79-226).

Events arrive as (B, Tl, Tm, H, W, C); macro slices Tl fold into the
batch and the Tm micro-steps are scanned in reversed order
(embedding.py:155-156). The output is a (Ts, B*Tl, C, H, W) stack of
learned temporal slices. The conv stacks are ``conv[ReLU conv]*`` as
``nn.Sequential`` (so their convs sit at indices 0, 2, ...), computed in
``dtype`` (None: the state dtype) with the bias added after the conv, as
the JAX closure does. The same forward trains: the sampler's rect spike
carries its surrogate gradient (``ops/arsnn.py``), and with no state dtype
set (the flagship trains without ``deploy()``) the state keeps the
input's dtype, f32.

``fused_sampler`` (the JAX ``use_pallas``) routes the eval forward through
the fused sampler kernels (``ops/arsnn_fused.py``), as
``eas_snn_tpu/models/embedding.py:345-369`` does: the whole-scan kernel
(v2) where ``v2_supported`` passes, the module is not training, and the
mode is 'always', or 'auto' with the events on a CUDA device; else, under
'always', the per-step kernel (v1) with the convs outside it, which has no
gradient; else the plain differentiable scan. The kernels compute their
own precision: v2 in f32 whatever the state and conv dtypes (on the events
rounded to the state dtype), v1 in the state dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.arsnn import arsnn_scan
from ..ops.arsnn_fused import arsnn_fused_v2, arsnn_scan_fused, v2_supported
from ..ops.surrogate import get_spike_fn

__all__ = ["ARSNNEmbedding", "fold_time", "FUSED_SAMPLER_MODES"]

FUSED_SAMPLER_MODES = ("never", "auto", "always")


def fold_time(events: torch.Tensor) -> torch.Tensor:
    """(B, Tl, Tm, H, W, C) or (B, Tm, H, W, C) -> time-reversed
    (Tm, B*Tl, H, W, C)."""
    if events.dim() == 6:
        B, Tl, Tm = events.shape[:3]
        events = events.reshape((B * Tl,) + tuple(events.shape[2:]))
    elif events.dim() != 5:
        raise ValueError(f"expected 5/6-dim events, got {tuple(events.shape)}")
    return events.movedim(1, 0).flip(0)


def _conv_stack(in_ch: int, out_ch: int, ksize: int, depth: int) -> nn.Sequential:
    layers = []
    for i in range(depth):
        if i:
            layers.append(nn.ReLU())
        layers.append(nn.Conv2d(in_ch if i == 0 else out_ch, out_ch, ksize,
                                padding=ksize // 2))
    return nn.Sequential(*layers)


class ARSNNEmbedding(nn.Module):
    def __init__(self, ksize: int = 7, in_channels: int = 2,
                 out_channels: int = 2, Ts: int = 1, depth: int = 1,
                 readout: str = "sum", spike_attach: bool = False,
                 write_zero: bool = False, use_abs: bool = False,
                 thresh: float = 1.0, vreset: Optional[float] = 0.0,
                 dtype: Optional[torch.dtype] = None,
                 state_dtype: Optional[torch.dtype] = None,
                 fused_sampler: str = "never"):
        super().__init__()
        if fused_sampler not in FUSED_SAMPLER_MODES:
            raise ValueError(f"fused_sampler '{fused_sampler}' not in "
                             f"{FUSED_SAMPLER_MODES}")
        C = out_channels
        self.ksize, self.depth = ksize, depth
        self.fused_sampler = fused_sampler
        self.Ts, self.readout, self.thresh, self.vreset = Ts, readout, thresh, vreset
        self.spike_attach, self.write_zero, self.use_abs = (
            spike_attach, write_zero, use_abs)
        self.dtype, self.state_dtype = dtype, state_dtype
        self.input_conv = _conv_stack(in_channels, 2 * C, ksize, depth)
        self.gate_conv = _conv_stack(C, 2 * C, ksize, depth)
        # the sampler's spike is rect whatever the detector uses
        # (reference get_kwargs_spikes, event_yolox_base.py:153-158)
        self.spike_fn = get_spike_fn("rect")

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Input convs: orthogonal x sqrt(2); gate convs: fan-in uniform;
        biases zero (reference embedding.py:121-130)."""
        for m in self.input_conv:
            if isinstance(m, nn.Conv2d):
                nn.init.orthogonal_(m.weight, math.sqrt(2.0), generator=generator)
                nn.init.zeros_(m.bias)
        for m in self.gate_conv:
            if isinstance(m, nn.Conv2d):
                lim = math.sqrt(3.0 / (m.weight[0].numel()))
                nn.init.uniform_(m.weight, -lim, lim, generator=generator)
                nn.init.zeros_(m.bias)

    def _apply_stack(self, stack: nn.Sequential):
        def apply(x: torch.Tensor) -> torch.Tensor:
            out_dtype = x.dtype
            cdt = self.dtype or out_dtype
            x = x.to(cdt)
            for m in stack:
                if isinstance(m, nn.ReLU):
                    x = torch.relu(x)
                else:
                    x = F.conv2d(x, m.weight.to(cdt), padding=m.padding) + \
                        m.bias.to(cdt)[None, :, None, None]
            return x.to(out_dtype)

        return apply

    def stack_weights(self):
        """[(weight, bias), ...] of the input and of the gate conv stack,
        one pair a layer: what the whole-scan kernel takes."""
        return [[(m.weight, m.bias) for m in stack if isinstance(m, nn.Conv2d)]
                for stack in (self.input_conv, self.gate_conv)]

    def scan_kwargs(self) -> dict:
        """The scan's keyword options, as every sampler route takes them."""
        return dict(Ts=self.Ts, thresh=self.thresh, vreset=self.vreset,
                    readout=self.readout, spike_attach=self.spike_attach,
                    write_zero=self.write_zero, use_abs=self.use_abs)

    def route(self, ev: torch.Tensor) -> str:
        """'v2', 'v1' or 'plain': the sampler path for the time-major
        (Tm, N, Cin, H, W) events ``ev``."""
        if self.fused_sampler == "never":
            return "plain"
        Tm, N, Cin = ev.shape[:3]
        C = self.gate_conv[0].in_channels
        if v2_supported(Tm, Cin, C, self.depth, self.ksize, Ts=self.Ts,
                        training=self.training, N=N) and (
                self.fused_sampler == "always" or ev.is_cuda):
            return "v2"
        return "v1" if self.fused_sampler == "always" else "plain"

    def forward(self, events: torch.Tensor) -> torch.Tensor:
        ev = fold_time(events).permute(0, 1, 4, 2, 3)  # (Tm, N, C, H, W)
        in_dtype = ev.dtype
        if self.state_dtype is not None:
            ev = ev.to(self.state_dtype)
        kw = self.scan_kwargs()
        route = self.route(ev)
        convs = (self._apply_stack(self.input_conv),
                 self._apply_stack(self.gate_conv))
        if route == "v2":
            agg = arsnn_fused_v2(ev.contiguous(), *self.stack_weights(), **kw)
        elif route == "v1":
            agg = arsnn_scan_fused(ev, *convs, **kw)
        else:
            agg = arsnn_scan(ev, *convs, spike_fn=self.spike_fn, **kw)
        return agg.to(in_dtype)
