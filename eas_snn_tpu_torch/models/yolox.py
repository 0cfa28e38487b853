"""The assembled event detector: ARSNN sampler -> PAFPN (spiking CSPDarknet
backbone, analog neck) -> YOLOX head (counterpart of
``eas_snn_tpu/models/yolox.py:EASYOLOX``).

``use_spike`` is 'backbone' (spiking CSPDarknet, features rate-decoded
before the analog neck) or 'none' (all analog; a multi-slice embedding
output keeps slice 0). Events go in as (B, Tl, Tm, H, W, C). At eval
decoded (B, A, 5 + num_classes) comes out, as in the JAX package; in
training with targets (B, M, 5) the loss dict of the JAX package
(total, iou (already x5), conf, cls, l1, num_fg), and without targets the
head's decoded train outputs (obj/cls as logits).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.nn as nn

from ..ops.lif import PLIF_W_INIT
from .blocks import BaseConv, Neuron
from .embedding import ARSNNEmbedding
from .head import YOLOXHead
from .pafpn import YOLOPAFPN
from .simota import yolox_losses

__all__ = ["EASYOLOX", "USE_SPIKE_MODES"]

# std of a unit normal truncated to [-2, 2] (flax's lecun_normal divides by
# it so that the truncated draw keeps variance 1/fan_in)
_TRUNC_STD = 0.87962566103423978

USE_SPIKE_MODES = ("none", "backbone")
# modes of the JAX package that this port does not run yet
_LATER_MODES = ("full", "full_v2")


class EASYOLOX(nn.Module):
    def __init__(self, num_classes: int = 2, depth: float = 0.33,
                 width: float = 0.50, act: str = "silu",
                 use_spike: str = "backbone", T: int = 3,
                 spike_fn: str = "atan", alpha: float = 2.0,
                 embedding_ksize: int = 5,
                 embedding_depth: int = 1, Ts: int = 1, readout: str = "sum",
                 spike_attach: bool = False, write_zero: bool = False,
                 use_abs: bool = False, thresh: float = 1.0,
                 vreset: Optional[float] = 0.0,
                 compute_dtype: torch.dtype = torch.float32,
                 embedding_state_dtype: Optional[torch.dtype] = None,
                 fuse: str = "auto", fused_sampler: str = "never"):
        super().__init__()
        if use_spike in _LATER_MODES:
            raise NotImplementedError(
                f"use_spike='{use_spike}' is not ported yet (ROADMAP.md, "
                "modules to port: 'Remaining model surface')")
        if use_spike not in USE_SPIKE_MODES:
            raise ValueError(f"use_spike '{use_spike}' not in "
                             f"{USE_SPIKE_MODES + _LATER_MODES}")
        self.use_spike, self.T = use_spike, T
        # the embedding's convs run in bf16 when the model does (the JAX
        # package's emb_dt); its state dtype is a knob of its own
        self.embedding = ARSNNEmbedding(
            ksize=embedding_ksize, depth=embedding_depth, Ts=Ts,
            readout=readout, spike_attach=spike_attach,
            write_zero=write_zero, use_abs=use_abs, thresh=thresh,
            vreset=vreset,
            dtype=compute_dtype if compute_dtype == torch.bfloat16 else None,
            state_dtype=embedding_state_dtype, fused_sampler=fused_sampler,
        )
        neuron = (Neuron(True, T, spike_fn, fuse=fuse, alpha=alpha)
                  if use_spike == "backbone" else Neuron())
        self.backbone = YOLOPAFPN(depth, width, act=act,
                                  backbone_neuron=neuron,
                                  dtype=compute_dtype)
        self.head = YOLOXHead(num_classes, width, act=act,
                              dtype=compute_dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers: every conv
        lecun-normal (normal truncated at 2 std, variance 1/fan_in) with a
        zero bias, BN the identity, each PLIF w at PLIF_W_INIT, the head's
        cls/obj biases at the prior and the sampler's convs as the sampler
        sets them. At this init dark3-dark5 of the flagship barely fire on
        Poisson(0.2) events."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                std = m.weight[0].numel() ** -0.5 / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        for m in self.modules():
            if isinstance(m, BaseConv) and m.neuron.spiking:
                m.act.w.fill_(PLIF_W_INIT)
        self.embedding.reset_parameters(generator)
        self.head.reset_prior_bias()

    def _temporalize(self, x: torch.Tensor) -> torch.Tensor:
        """Embedding output -> (T*B, C, H, W) for the spiking backbone
        (reference spiking_yolox.py:52-57)."""
        if x.dim() == 4:  # one frame, repeated over the T steps
            x = x[None].expand((self.T,) + tuple(x.shape))
        elif x.shape[0] == 1:
            x = x.expand((self.T,) + tuple(x.shape[1:]))
        elif x.shape[0] != self.T:
            raise ValueError(f"embedding emitted {x.shape[0]} slices but "
                             f"T={self.T}")
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def forward(self, events: torch.Tensor,
                targets: Optional[torch.Tensor] = None, use_l1: bool = False
                ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        x = self.embedding(events)  # (Ts, B*Tl, C, H, W)
        if self.use_spike == "none":
            x = x[0]
        else:
            x = self._temporalize(x)
        out = self.head(self.backbone(x))
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
