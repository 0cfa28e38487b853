"""Decoupled anchor-free YOLOX head (counterpart of
``eas_snn_tpu/models/head.py``; reference yolo_head.py,
spiking_yolo_head.py), NCHW.

Analog by default. With ``decode_input`` (the 'full_spike' mode) each
level arrives as a (T*B, ...) spike train and is rate-decoded before the
analog stem (spiking_yolo_head.py:159-160). With a spiking ``neuron``
('full_spike_v2') the stems and towers are spiking sites at T*B, the
``*_pred`` 1x1 convs run on their spike trains (cast to the compute
dtype: int8 at eval) and the predictions are rate-decoded
(spiking_yolo_head.py:175-178).

Per level the output channels are [reg(4), obj(1), cls(C)], decoded as
xy = (reg_xy + grid) * stride and wh = exp(reg_wh) * stride with an ``ij``
grid (gx the column, gy the row). At eval obj and cls are sigmoided and
the decoded (B, A, 5 + C) tensor comes out; in training obj and cls stay
logits and a :class:`HeadOutput` also carries the raw reg outputs (for
the L1 loss), the grid and the stride of every anchor.

With ``depthwise`` the towers' 3x3 convs are depthwise-separable
(YOLOX-Nano; JAX ``models/head.py:65``).

On a 2-D mesh (``parallel/mesh.py``) a channel-sharded ``*_pred`` conv
computes its slice of the channels and gathers them; on row shards each
level's outputs are gathered along H before they are flattened, so the
anchors keep the unsharded order and the decode runs on the whole grid
(no row offset left to apply).
"""

from __future__ import annotations

from math import log
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import gather_c, gather_rows, tp_mesh
from .blocks import BaseConv, DWConv, Neuron
from .pafpn import rate_decode

__all__ = ["YOLOXHead", "HeadOutput"]


class HeadOutput(NamedTuple):
    """Train outputs: decoded xy/wh in image units with obj/cls logits
    (B, A, 5 + C), raw reg (B, A, 4), and per anchor (A,) grid x, grid y
    and stride."""

    outputs: torch.Tensor
    origin_preds: torch.Tensor
    grid_x: torch.Tensor
    grid_y: torch.Tensor
    strides: torch.Tensor


class YOLOXHead(nn.Module):
    def __init__(self, num_classes: int, width: float = 1.0,
                 strides: Tuple[int, ...] = (8, 16, 32),
                 in_channels: Tuple[int, ...] = (256, 512, 1024),
                 act: str = "silu", dtype=torch.float32,
                 prior_prob: float = 1e-2, neuron: Neuron = Neuron(),
                 decode_input: bool = False, T: int = 1,
                 depthwise: bool = False):
        super().__init__()
        self.num_classes, self.strides, self.dtype = num_classes, strides, dtype
        self.neuron, self.decode_input, self.T = neuron, decode_input, T
        self.prior_bias = -log((1 - prior_prob) / prior_prob)
        hidden = int(256 * width)
        kw = dict(act=act, neuron=neuron, dtype=dtype)
        conv = DWConv if depthwise else BaseConv

        def tower():
            return nn.Sequential(conv(hidden, hidden, 3, 1, **kw),
                                 conv(hidden, hidden, 3, 1, **kw))

        self.stems = nn.ModuleList(
            BaseConv(int(c * width), hidden, 1, 1, **kw) for c in in_channels)
        self.cls_convs = nn.ModuleList(tower() for _ in in_channels)
        self.reg_convs = nn.ModuleList(tower() for _ in in_channels)
        self.cls_preds = nn.ModuleList(
            nn.Conv2d(hidden, num_classes, 1) for _ in in_channels)
        self.reg_preds = nn.ModuleList(
            nn.Conv2d(hidden, 4, 1) for _ in in_channels)
        self.obj_preds = nn.ModuleList(
            nn.Conv2d(hidden, 1, 1) for _ in in_channels)

    @torch.no_grad()
    def reset_prior_bias(self) -> None:
        """cls/obj biases at -log((1 - p) / p) (reference :135-146)."""
        for conv in (*self.cls_preds, *self.obj_preds):
            conv.bias.fill_(self.prior_bias)

    def _pred(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        # conv in the compute dtype, bias added in it, then f32 (flax Conv);
        # a spiking head's predictions are rate-decoded
        y = F.conv2d(x.to(self.dtype), conv.weight.to(self.dtype))
        y = y + conv.bias.to(self.dtype)[None, :, None, None]
        mesh = tp_mesh(conv)
        y = (gather_c(y, mesh) if mesh is not None else y).float()
        return rate_decode(y, self.T) if self.neuron.spiking else y

    def forward(self, xin: Sequence[torch.Tensor]):
        outputs, origins, gxs, gys, svs = [], [], [], [], []
        for k, (stride, x) in enumerate(zip(self.strides, xin)):
            if self.decode_input and not self.neuron.spiking:
                x = rate_decode(x, self.T)
            x = self.stems[k](x)
            cls_out = self._pred(self.cls_preds[k], self.cls_convs[k](x))
            reg_feat = self.reg_convs[k](x)
            reg_out = self._pred(self.reg_preds[k], reg_feat)
            obj_out = self._pred(self.obj_preds[k], reg_feat)
            out = gather_rows(torch.cat([reg_out, obj_out, cls_out], 1))
            B, _, H, W = out.shape
            out = out.reshape(B, out.shape[1], H * W).permute(0, 2, 1)
            yv, xv = torch.meshgrid(
                torch.arange(H, dtype=torch.float32, device=x.device),
                torch.arange(W, dtype=torch.float32, device=x.device),
                indexing="ij")
            gx, gy = xv.reshape(-1), yv.reshape(-1)
            if self.training:
                # decode into image units, obj/cls as logits (JAX :116-121)
                xy = (out[..., :2] + torch.stack([gx, gy], -1)[None]) * stride
                wh = torch.exp(out[..., 2:4]) * stride
                outputs.append(torch.cat([xy, wh, out[..., 4:]], -1))
                origins.append(out[..., :4])
            else:
                outputs.append(torch.cat(
                    [out[..., :4], torch.sigmoid(out[..., 4:])], -1))
            gxs.append(gx)
            gys.append(gy)
            svs.append(torch.full((H * W,), float(stride), device=x.device))
        out = torch.cat(outputs, 1)
        gx, gy, sv = torch.cat(gxs), torch.cat(gys), torch.cat(svs)
        if self.training:
            return HeadOutput(out, torch.cat(origins, 1), gx, gy, sv)
        grid = torch.stack([gx, gy], -1)[None]
        xy = (out[..., :2] + grid) * sv[None, :, None]
        wh = torch.exp(out[..., 2:4]) * sv[None, :, None]
        return torch.cat([xy, wh, out[..., 4:]], -1)
