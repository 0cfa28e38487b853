"""YOLO-PAFPN neck (counterpart of ``eas_snn_tpu/models/pafpn.py``;
reference yolo_pafpn.py / spiking_yolo_pafpn.py), NCHW.

``backbone_neuron`` makes the CSPDarknet spiking, ``neck_neuron`` the
neck's convs (the 'full_spike' modes). With a spiking backbone and an
analog neck the dark3..dark5 spike trains are rate-decoded (mean over T,
in f32) before the neck (spiking_yolo_pafpn.py:98); a spiking neck takes
the (T*B, ...) spike trains themselves (int8 at eval). The merges hand
their CSP layer a tuple (a channel concat that only the unfused path
materializes), so a fused 1x1 site reads the pieces directly.

``image_channels`` is the backbone stem's input (2 event polarities, 3
for RGB); ``depthwise`` makes the bottom-up convs and every CSP
bottleneck depthwise-separable, as in the backbone (YOLOX-Nano; JAX
``models/pafpn.py:66, 73``).

``remat`` goes to the backbone and makes every conv and CSP layer of the
neck recompute its inner activations in the backward (JAX
``models/pafpn.py:39-41, 68-71``; ``blocks.remat``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from .blocks import BaseConv, CSPLayer, DWConv, Neuron, remat, upsample2x
from .darknet import CSPDarknet

__all__ = ["YOLOPAFPN", "rate_decode"]


def rate_decode(x: torch.Tensor, T: int) -> torch.Tensor:
    """(T*B, C, H, W) -> (B, C, H, W) firing rate, f32."""
    return x.reshape((T, -1) + tuple(x.shape[1:])).float().mean(0)


class YOLOPAFPN(nn.Module):
    def __init__(self, depth: float = 1.0, width: float = 1.0,
                 in_features: Tuple[str, ...] = ("dark3", "dark4", "dark5"),
                 in_channels: Tuple[int, int, int] = (256, 512, 1024),
                 act: str = "silu", backbone_neuron: Neuron = Neuron(),
                 neck_neuron: Neuron = Neuron(), dtype=torch.float32,
                 remat: bool = False, depthwise: bool = False,
                 image_channels: int = 2):
        super().__init__()
        self.in_features = in_features
        self.backbone_neuron, self.neck_neuron = backbone_neuron, neck_neuron
        self.backbone = CSPDarknet(depth, width, in_channels=image_channels,
                                   out_features=in_features, act=act,
                                   neuron=backbone_neuron, dtype=dtype,
                                   remat=remat, depthwise=depthwise)
        c0, c1, c2 = (int(c * width) for c in in_channels)
        n = round(3 * depth)
        kw = dict(act=act, neuron=neck_neuron, dtype=dtype)
        csp = dict(n=n, shortcut=False, depthwise=depthwise, **kw)
        conv = DWConv if depthwise else BaseConv
        self.lateral_conv0 = BaseConv(c2, c1, 1, 1, **kw)
        self.C3_p4 = CSPLayer(2 * c1, c1, **csp)
        self.reduce_conv1 = BaseConv(c1, c0, 1, 1, **kw)
        self.C3_p3 = CSPLayer(2 * c0, c0, **csp)
        self.bu_conv2 = conv(c0, c0, 3, 2, **kw)
        self.C3_n3 = CSPLayer(2 * c0, c1, **csp)
        self.bu_conv1 = conv(c1, c1, 3, 2, **kw)
        self.C3_n4 = CSPLayer(2 * c1, c2, **csp)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        feats: Dict[str, torch.Tensor] = self.backbone(x)
        features = [feats[f] for f in self.in_features]
        if self.backbone_neuron.spiking and not self.neck_neuron.spiking:
            features = [rate_decode(f, self.backbone_neuron.T)
                        for f in features]
        x2, x1, x0 = features
        run = self._block
        fpn_out0 = run(self.lateral_conv0, x0)
        f_out0 = run(self.C3_p4, upsample2x(fpn_out0), x1)
        fpn_out1 = run(self.reduce_conv1, f_out0)
        pan_out2 = run(self.C3_p3, upsample2x(fpn_out1), x2)
        pan_out1 = run(self.C3_n3, run(self.bu_conv2, pan_out2), fpn_out1)
        pan_out0 = run(self.C3_n4, run(self.bu_conv1, pan_out1), fpn_out0)
        outs = (pan_out2, pan_out1, pan_out0)
        return (outs, feats) if return_features else outs

    def _block(self, module: nn.Module, *xs: torch.Tensor) -> torch.Tensor:
        if self.backbone.remat:
            return remat(module, *xs)
        return module(xs if len(xs) > 1 else xs[0])
