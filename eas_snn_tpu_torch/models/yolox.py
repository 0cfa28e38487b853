"""The assembled event detector: embedding -> PAFPN (CSPDarknet backbone
and neck) -> YOLOX head (counterpart of ``eas_snn_tpu/models/yolox.py:
EASYOLOX``; reference event_yolox_base.py:197-214).

``use_spike`` picks one of the reference's four variants:

* 'none': all analog; a multi-slice embedding output keeps slice 0;
* 'backbone': spiking CSPDarknet, its features rate-decoded before the
  analog neck;
* 'full' ('full_spike'): spiking backbone and neck, each head level
  rate-decoded before the analog head;
* 'full_v2' ('full_spike_v2'): spiking head too, its predictions
  rate-decoded.

``embedding`` is 'count', 'snn', 'rsnn' or 'arsnn'
(``models/embedding.py:build_embedding``); ``norm`` (any value but None)
puts a BatchNorm over the embedding's output, after keeping its first
slice where it emits several (the reference's ModuleList wrap,
spiking_yolox.py:41-47). Events go in as (B, Tl, Tm, H, W, C). At eval
decoded (B, A, 5 + num_classes) comes out, as in the JAX package; in
training with targets (B, M, 5) the loss dict of the JAX package
(total, iou (already x5), conf, cls, l1, num_fg), and without targets the
head's decoded train outputs (obj/cls as logits).

``remat`` (JAX ``EASYOLOX.remat``) recomputes the inner activations of
every backbone and neck block in the backward, and of every step of the
arsnn sampler's plain scan. ``train_store`` 'int8' (the default, as the
JAX package's PLIF ``train_store``) holds the spike trains that a train
step saves for its backward as int8 (``blocks.int8_saved_spikes``);
'float' keeps them in the compute dtype. Neither changes a bit of the
step. ``packed_embedding`` ('never' | 'auto', JAX
``EASYOLOX.packed_embedding``) runs the arsnn sampler's scan in the
space-to-depth layout of ``ops/pack.py`` where the frame packs
(``models/embedding.py``).

``in_channels`` is the C of the events (2 polarities; 3 for the RGB
family, whose images go in as (B, 1, 1, H, W, 3) through the count
embedding into an analog YOLOX); ``depthwise`` makes the backbone's,
the neck's and the head's 3x3 convs depthwise-separable (YOLOX-Nano).
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn as nn

from ..ops.lif import PLIF_W_INIT
from ..parallel.mesh import check_placement
from .blocks import PLIF, BaseConv, BatchNorm, Neuron, int8_saved_spikes
from .embedding import build_embedding
from .head import YOLOXHead
from .pafpn import YOLOPAFPN
from .simota import yolox_losses

__all__ = ["EASYOLOX", "USE_SPIKE_MODES", "init_convs"]

# std of a unit normal truncated to [-2, 2] (flax's lecun_normal divides by
# it so that the truncated draw keeps variance 1/fan_in)
_TRUNC_STD = 0.87962566103423978

USE_SPIKE_MODES = ("none", "backbone", "full", "full_v2")


@torch.no_grad()
def init_convs(model: nn.Module, generator: torch.Generator) -> None:
    """Every conv of ``model`` lecun-normal (normal truncated at 2 std,
    variance 1 / fan_in, the fan-in ``weight[0].numel()``: k * k for a
    depthwise conv, as flax's) with a zero bias, every BN the identity."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            std = m.weight[0].numel() ** -0.5 / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


class EASYOLOX(nn.Module):
    def __init__(self, num_classes: int = 2, depth: float = 0.33,
                 width: float = 0.50, act: str = "silu",
                 use_spike: str = "backbone", T: int = 3,
                 spike_fn: str = "atan", alpha: float = 2.0,
                 asgl_p: float = 0.0, alpha_granularity: str = "layer",
                 norm: Optional[str] = None, embedding: str = "arsnn",
                 embedding_ksize: int = 5,
                 embedding_depth: int = 1, Ts: int = 1, readout: str = "sum",
                 spike_attach: bool = False, write_zero: bool = False,
                 use_abs: bool = False, split: bool = False,
                 thresh: float = 1.0, vreset: Optional[float] = 0.0,
                 decay: float = 0.5,
                 compute_dtype: torch.dtype = torch.float32,
                 embedding_state_dtype: Optional[torch.dtype] = None,
                 fuse: str = "auto", fused_sampler: str = "never",
                 remat: bool = False, train_store: str = "int8",
                 in_channels: int = 2, depthwise: bool = False,
                 packed_embedding: str = "never"):
        super().__init__()
        if use_spike not in USE_SPIKE_MODES:
            raise ValueError(f"use_spike '{use_spike}' not in "
                             f"{USE_SPIKE_MODES}")
        if train_store not in ("int8", "float"):
            raise ValueError(f"train_store '{train_store}' is not 'int8' or "
                             "'float'")
        self.train_store = train_store
        self.use_spike, self.T, self.dtype = use_spike, T, compute_dtype
        # the sampler's convs run in bf16 when the model does (the JAX
        # package's emb_dt); its state dtype is a knob of its own
        self.embedding = build_embedding(
            embedding, ksize=embedding_ksize, depth=embedding_depth, Ts=Ts,
            readout=readout, spike_attach=spike_attach,
            write_zero=write_zero, use_abs=use_abs, split=split,
            thresh=thresh, vreset=vreset, decay=decay,
            dtype=compute_dtype if compute_dtype == torch.bfloat16 else None,
            state_dtype=embedding_state_dtype, fused_sampler=fused_sampler,
            remat=remat, packed=packed_embedding,
        )
        # BatchNorm2d(2) after the embedding (reference
        # event_yolox_base.py:188-192), eps 1e-3, momentum 0.03
        self.emb_bn = BatchNorm(2) if norm is not None else None
        snn = Neuron(True, T, spike_fn, fuse=fuse, alpha=alpha,
                     asgl_p=asgl_p, alpha_granularity=alpha_granularity)
        ann = Neuron()
        self.backbone = YOLOPAFPN(
            depth, width, act=act,
            backbone_neuron=ann if use_spike == "none" else snn,
            neck_neuron=snn if use_spike in ("full", "full_v2") else ann,
            dtype=compute_dtype, remat=remat, depthwise=depthwise,
            image_channels=in_channels)
        # the head takes (T*B) spike trains when the neck spikes
        self.head = YOLOXHead(
            num_classes, width, act=act, dtype=compute_dtype,
            neuron=snn if use_spike == "full_v2" else ann,
            decode_input=use_spike == "full", T=T, depthwise=depthwise)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers: every conv
        lecun-normal (normal truncated at 2 std, variance 1/fan_in) with a
        zero bias, BN the identity, each PLIF w at PLIF_W_INIT, the head's
        cls/obj biases at the prior and the sampler's convs as the sampler
        sets them. At this init dark3-dark5 of the flagship barely fire on
        Poisson(0.2) events."""
        init_convs(self, generator)
        for m in self.modules():
            if isinstance(m, BaseConv) and m.neuron.spiking:
                m.act.w.fill_(PLIF_W_INIT)
            if isinstance(m, PLIF) and hasattr(m, "asgl_alpha"):
                m.asgl_alpha.fill_(m.alpha)
        self.embedding.reset_parameters(generator)
        self.head.reset_prior_bias()

    def materialize_alpha(self, sample_shape: Sequence[int]) -> None:
        """Create every 'neuron'-granularity patan alpha at its site's
        (C, H, W) for events of ``sample_shape`` (B, Tl, Tm, H, W, C): one
        train forward of a copy of the model on the meta device gives the
        shapes (the JAX package's init on an example input)."""
        sites = [(n, m) for n, m in self.named_modules()
                 if isinstance(m, PLIF) and m.spike_fn == "patan"
                 and not hasattr(m, "asgl_alpha")]
        if not sites:
            return
        meta = copy.deepcopy(self).to("meta").train()
        meta(torch.zeros(tuple(sample_shape), device="meta"))
        shapes = {n: m.asgl_alpha.shape for n, m in meta.named_modules()
                  if isinstance(m, PLIF) and hasattr(m, "asgl_alpha")}
        with torch.no_grad():
            for n, m in sites:
                m.materialize_alpha(shapes[n])

    @property
    def draws_random_numbers(self) -> bool:
        """Whether a train step draws random numbers: patan at
        ``asgl_p > 0`` draws a fresh Bernoulli mask a step."""
        return any(isinstance(m, PLIF) and m.spike_fn == "patan"
                   and m.asgl_p > 0 for m in self.modules())

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

    def set_remat(self, on: bool) -> None:
        """Turn ``remat`` on or off after the build (the values and
        gradients of a step do not change)."""
        self.backbone.backbone.remat = on
        if hasattr(self.embedding, "remat"):
            self.embedding.remat = on

    def forward(self, events: torch.Tensor,
                targets: Optional[torch.Tensor] = None, use_l1: bool = False
                ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        check_placement(self)  # TP and SP at once, before the sampler
        store = (int8_saved_spikes() if self.training
                 and self.train_store == "int8" and self.use_spike != "none"
                 and torch.is_grad_enabled() else contextlib.nullcontext())
        with store:
            return self._forward(events, targets, use_l1)

    def _forward(self, events, targets, use_l1):
        # (Ts, B*Tl, C, H, W) from arsnn, (B*Tl, C, H, W) from the others
        x = self.embedding(events)
        if self.emb_bn is not None:
            if x.dim() > 4:
                x = x[0]
            x = self.emb_bn(x.to(self.dtype), self.dtype)
        if self.use_spike == "none":
            if x.dim() > 4:
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
