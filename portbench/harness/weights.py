"""The weights, made by the benchmark on the card from the seed, and the
spiking BN calibrated on the cell's own traffic; the same state dict goes
to the program and to the reference.

The draw, in a few large calls of one ``torch.Generator`` on the card:
every conv of the detector lecun-normal (a normal truncated at 2 std,
variance 1 / fan-in: one draw for all of them, scaled a tensor) with a
zero bias, the head's cls and obj biases at the prior -log((1 - p) / p),
p = 0.01; the sampler's input convs orthogonal x sqrt(2) and its gate
convs uniform in +-sqrt(3 / fan-in), zero biases; every BN the identity;
every PLIF decay logit 0 (decay 0.5). These are the port's and the JAX
package's initializers (``models/yolox.py:init_convs``,
``models/embedding.py``).

:func:`calibrate` is ``chip_smoke.py:calibrate_spiking_bn``: each spiking
site's running mean and variance become the per-channel moments of its
conv output (f32) on the calibration windows, in forward order, with
scale 1 and bias 0, so that every stage fires; at the identity BN the
flagship's dark3-dark5 barely fire. The analog sites keep the identity
BN: calibrated too, they pass every difference on undamped, and the
random detector's outputs turn chaotic (``PERF.md``). It runs on the
reference model.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

_TRUNC_STD = 0.87962566103423978
PRIOR = -math.log((1 - 0.01) / 0.01)


@torch.no_grad()
def make_state(ref: nn.Module, gen: torch.Generator, device
               ) -> Dict[str, torch.Tensor]:
    """The state dict of ``ref``'s structure (the port's names), drawn on
    ``device`` from ``gen``."""
    sd = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
          for k, v in ref.state_dict().items()}
    convs = [(n, m) for n, m in ref.named_modules()
             if isinstance(m, nn.Conv2d) and not n.startswith("embedding")]
    total = sum(m.weight.numel() for _, m in convs)
    flat = torch.empty(total, device=device)
    nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    off = 0
    for n, m in convs:
        k = m.weight.numel()
        std = m.weight[0].numel() ** -0.5 / _TRUNC_STD
        sd[n + ".weight"].copy_(flat[off:off + k].view(m.weight.shape) * std)
        off += k
        if m.bias is not None:
            prior = n.startswith(("head.cls_preds", "head.obj_preds"))
            sd[n + ".bias"].fill_(PRIOR if prior else 0.0)
    for n, m in ref.named_modules():
        if not (isinstance(m, nn.Conv2d) and n.startswith("embedding")):
            continue
        w = sd[n + ".weight"]
        if n.startswith("embedding.input_conv"):
            nn.init.orthogonal_(w, math.sqrt(2.0), generator=gen)
        else:
            lim = math.sqrt(3.0 / w[0].numel())
            nn.init.uniform_(w, -lim, lim, generator=gen)
        sd[n + ".bias"].zero_()
    for k, v in sd.items():
        if k.endswith(("bn.weight", "bn.running_var")):
            v.fill_(1.0)
        elif k.endswith(("bn.bias", "bn.running_mean", "act.w")):
            v.zero_()
        elif k.endswith("num_batches_tracked"):
            v.zero_()
    return sd


@torch.no_grad()
def calibrate(ref: nn.Module, sites, events: torch.Tensor) -> None:
    """The BN statistics of ``sites`` (BaseConvs of ``ref``) from one eval
    forward of ``ref`` over ``events``; f32 convs."""
    def hook(mod, args) -> None:
        x = args[0]
        x = torch.cat([p.float() for p in x], 1) \
            if isinstance(x, (tuple, list)) else x.float()
        y = F.conv2d(x, mod.weight.float(), stride=mod.stride,
                     padding=(mod.k - 1) // 2)
        mod.bn.running_mean.copy_(y.mean((0, 2, 3)))
        mod.bn.running_var.copy_(y.var((0, 2, 3), unbiased=False))
        mod.bn.weight.fill_(1.0)
        mod.bn.bias.fill_(0.0)

    handles = [m.register_forward_pre_hook(hook) for m in sites]
    was = ref.training
    ref.eval()
    try:
        ref(events)
    finally:
        for h in handles:
            h.remove()
        ref.train(was)
