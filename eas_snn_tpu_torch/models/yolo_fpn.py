"""The YOLOv3 family of the RGB presets (counterpart of
``eas_snn_tpu/models/yolo_fpn.py`` and of the detector that
``exps/default/yolov3.py`` builds inline; reference yolox/models/
darknet.py:10-95 Darknet and yolo_fpn.py:12-84 YOLOFPN), NCHW.

``Darknet`` (depth 21 or 53, LeakyReLU 0.1, an SPP tail after dark5),
``YOLOFPN`` (the top-down merges of dark5 into dark4 and dark3, each
through a 1-3-1-3-1 embedding) and ``YOLOv3`` (YOLOFPN and the YOLOX head
on its 128 / 256 / 512 channels). Parameter names are the reference's:
``backbone.backbone.stem.{0,1,2}``, ``dark2..dark5.{i}`` (the SPP tail
continues dark5's indices), ``ResLayer.layer1`` / ``layer2``,
``backbone.out1_cbl``, ``backbone.out1.{0-4}``, ``backbone.out2_cbl``,
``backbone.out2.{0-4}`` and ``head.*``, so a reference ``.pth`` loads by
key.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from .blocks import BaseConv, SPPBottleneck, upsample2x
from .head import YOLOXHead
from .simota import yolox_losses
from .yolox import init_convs

__all__ = ["Darknet", "ResLayer", "YOLOFPN", "YOLOv3"]

_ACT = "lrelu"


def _cbl(c_in: int, c_out: int, k: int, stride: int = 1,
         dtype=torch.float32) -> BaseConv:
    return BaseConv(c_in, c_out, k, stride, act=_ACT, dtype=dtype)


class ResLayer(nn.Module):
    """1x1 halving, 3x3 back, an additive shortcut (reference
    network_blocks.py:107-122)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.layer1 = _cbl(channels, channels // 2, 1, dtype=dtype)
        self.layer2 = _cbl(channels // 2, channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layer2(self.layer1(x))


class Darknet(nn.Module):
    """Darknet-21 or -53: a 3x3 stem, then five groups of a stride-2 3x3
    conv and ResLayers, the last followed by the SPP tail (1x1, 3x3, SPP,
    3x3, 1x1)."""

    DEPTH2BLOCKS = {21: (1, 2, 2, 1), 53: (2, 8, 8, 4)}

    def __init__(self, depth: int = 53, in_channels: int = 3,
                 stem_out_channels: int = 32,
                 out_features: Sequence[str] = ("dark3", "dark4", "dark5"),
                 dtype=torch.float32):
        super().__init__()
        if depth not in self.DEPTH2BLOCKS:
            raise ValueError(f"Darknet depth {depth}: 21 or 53")
        self.out_features = tuple(out_features)
        c = stem_out_channels

        def group(ch: int, n: int):
            return [_cbl(ch, ch * 2, 3, 2, dtype),
                    *(ResLayer(ch * 2, dtype) for _ in range(n))]

        self.stem = nn.Sequential(_cbl(in_channels, c, 3, dtype=dtype),
                                  *group(c, 1))
        n2, n3, n4, n5 = self.DEPTH2BLOCKS[depth]
        self.dark2 = nn.Sequential(*group(c * 2, n2))
        self.dark3 = nn.Sequential(*group(c * 4, n3))
        self.dark4 = nn.Sequential(*group(c * 8, n4))
        self.dark5 = nn.Sequential(
            *group(c * 16, n5),
            _cbl(c * 32, c * 16, 1, dtype=dtype),
            _cbl(c * 16, c * 32, 3, dtype=dtype),
            SPPBottleneck(c * 32, c * 16, act=_ACT, dtype=dtype),
            _cbl(c * 16, c * 32, 3, dtype=dtype),
            _cbl(c * 32, c * 16, 1, dtype=dtype))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs = {}
        for name in ("stem", "dark2", "dark3", "dark4", "dark5"):
            x = getattr(self, name)(x)
            outputs[name] = x
        return {k: v for k, v in outputs.items() if k in self.out_features}


class YOLOFPN(nn.Module):
    """The YOLOv3 neck over Darknet: dark5 through a 1x1, upsampled and
    concatenated with dark4, a 5-conv embedding; the same again into
    dark3. Outputs (dark3 level 128, dark4 level 256, dark5 512)
    channels."""

    def __init__(self, depth: int = 53,
                 in_features: Sequence[str] = ("dark3", "dark4", "dark5"),
                 in_channels: int = 3, dtype=torch.float32):
        super().__init__()
        self.in_features = tuple(in_features)
        self.backbone = Darknet(depth, in_channels, out_features=in_features,
                                dtype=dtype)
        self.out1_cbl = _cbl(512, 256, 1, dtype=dtype)
        self.out1 = self._embedding(256, 512 + 256, dtype)
        self.out2_cbl = _cbl(256, 128, 1, dtype=dtype)
        self.out2 = self._embedding(128, 256 + 128, dtype)

    @staticmethod
    def _embedding(ch: int, c_in: int, dtype) -> nn.Sequential:
        return nn.Sequential(_cbl(c_in, ch, 1, dtype=dtype),
                             _cbl(ch, ch * 2, 3, dtype=dtype),
                             _cbl(ch * 2, ch, 1, dtype=dtype),
                             _cbl(ch, ch * 2, 3, dtype=dtype),
                             _cbl(ch * 2, ch, 1, dtype=dtype))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        feats = self.backbone(x)
        x2, x1, x0 = (feats[f] for f in self.in_features)
        out_dark4 = self.out1(torch.cat([upsample2x(self.out1_cbl(x0)), x1],
                                        1))
        out_dark3 = self.out2(torch.cat(
            [upsample2x(self.out2_cbl(out_dark4)), x2], 1))
        return out_dark3, out_dark4, x0


class YOLOv3(nn.Module):
    """The YOLOv3 detector of the reference's yolov3 exp: YOLOFPN and the
    YOLOX head (width 1.0, LeakyReLU) on its (128, 256, 512) channels.
    Takes the event pipeline's (B, 1, 1, H, W, 3) images (or (B, H, W,
    3)) and answers as ``EASYOLOX``: decoded (B, A, 5 + C) at eval, the
    loss dict in training with targets (B, M, 5), the head's train outputs
    without."""

    def __init__(self, num_classes: int = 80, depth: int = 53,
                 in_channels: int = 3, compute_dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype
        self.backbone = YOLOFPN(depth, in_channels=in_channels,
                                dtype=compute_dtype)
        self.head = YOLOXHead(num_classes, width=1.0,
                              in_channels=(128, 256, 512), act=_ACT,
                              dtype=compute_dtype)

    draws_random_numbers = False

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Lecun-normal convs, identity BNs, the head's prior biases (the
        JAX package's initializers)."""
        init_convs(self, generator)
        self.head.reset_prior_bias()

    def forward(self, events: torch.Tensor,
                targets: Optional[torch.Tensor] = None, use_l1: bool = False
                ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        x = events[:, 0, 0] if events.dim() == 6 else events
        out = self.head(self.backbone(x.permute(0, 3, 1, 2).to(self.dtype)))
        if not self.training:
            return out
        if targets is None:
            return out.outputs
        losses = yolox_losses(out.outputs, out.origin_preds, targets,
                              out.grid_x, out.grid_y, out.strides,
                              self.head.num_classes, use_l1=use_l1)
        return {"total_loss": losses.total_loss,
                "iou_loss": losses.iou_loss,
                "conf_loss": losses.conf_loss,
                "cls_loss": losses.cls_loss,
                "l1_loss": losses.l1_loss,
                "num_fg": losses.num_fg}
