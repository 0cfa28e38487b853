"""CSPDarknet backbone (counterpart of ``eas_snn_tpu/models/darknet.py``;
reference yolox/models/darknet.py:97-180), NCHW.

The Focus stem is always analog: the reference's convert_to_spiking wraps
it whole in a SeqToANNContainer (hence ``stem.0``) without converting its
activation. dark2..dark5 are spiking when the neuron config says so. ``in_channels``
is the stem's input (2 event polarities, 3 for RGB); ``depthwise`` makes
every stage conv and CSP bottleneck depthwise-separable (YOLOX-Nano).

With ``remat`` (JAX ``CSPDarknet.remat``, ``models/darknet.py:29-46``)
every block of every stage, the Focus stem, each stage conv, CSP layer
and SPP, recomputes its inner activations in the backward
(``blocks.remat``): the backward holds one block's activations at a time
beside the blocks' inputs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from .blocks import (BaseConv, CSPLayer, DWConv, Focus, Neuron,
                     SPPBottleneck, remat)

__all__ = ["CSPDarknet"]


class CSPDarknet(nn.Module):
    def __init__(self, dep_mul: float, wid_mul: float, in_channels: int = 2,
                 out_features: Tuple[str, ...] = ("dark3", "dark4", "dark5"),
                 act: str = "silu", neuron: Neuron = Neuron(),
                 dtype=torch.float32, remat: bool = False,
                 depthwise: bool = False):
        super().__init__()
        self.out_features = out_features
        self.remat = remat
        base = int(wid_mul * 64)
        depth = max(round(dep_mul * 3), 1)
        kw = dict(act=act, neuron=neuron, dtype=dtype)
        csp = dict(depthwise=depthwise, **kw)
        conv = DWConv if depthwise else BaseConv
        self.stem = nn.Sequential(
            Focus(in_channels, base, 3, act=act, dtype=dtype))
        self.dark2 = nn.Sequential(
            conv(base, base * 2, 3, 2, **kw),
            CSPLayer(base * 2, base * 2, n=depth, **csp))
        self.dark3 = nn.Sequential(
            conv(base * 2, base * 4, 3, 2, **kw),
            CSPLayer(base * 4, base * 4, n=depth * 3, **csp))
        self.dark4 = nn.Sequential(
            conv(base * 4, base * 8, 3, 2, **kw),
            CSPLayer(base * 8, base * 8, n=depth * 3, **csp))
        self.dark5 = nn.Sequential(
            conv(base * 8, base * 16, 3, 2, **kw),
            SPPBottleneck(base * 16, base * 16, **kw),
            CSPLayer(base * 16, base * 16, n=depth, shortcut=False, **csp))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs = {}
        for name in ("stem", "dark2", "dark3", "dark4", "dark5"):
            stage = getattr(self, name)
            if self.remat:
                for block in stage:
                    x = remat(block, x)
            else:
                x = stage(x)
            outputs[name] = x
        return {k: v for k, v in outputs.items() if k in self.out_features}
