"""The plain reference's train steps: the loss forward, the backward, Adam
(per leaf, betas 0.9 / 0.999, eps 1e-8, no weight decay: the
configurations' groups all share one learning rate) at the schedule's
rate, then the parameter EMA d = 0.9998 * (1 - exp(-t / 2000)) of the
reference's utils/ema.py. The schedules are frozen copies of the port's
``core/optim.py:build_lr_schedule`` for the two the configurations use.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from .simota import yolox_losses


def lr_at(sched: dict, step: int) -> float:
    """The rate of update ``step`` (counted from 0): 'fixed', or
    'yoloxwarmcos' (quadratic warm-up, cosine to ``min_lr_ratio``)."""
    lr = sched["lr"]
    if sched["name"] == "fixed":
        return lr
    if sched["name"] != "yoloxwarmcos":
        raise ValueError(f"schedule {sched['name']}")
    ipe = sched["iters_per_epoch"]
    total = ipe * sched["max_epoch"]
    warm = ipe * sched["warmup_epochs"]
    no_aug = ipe * sched["no_aug_epochs"]
    min_lr = lr * sched["min_lr_ratio"]
    it = float(step)
    if no_aug > 0 and it >= total - no_aug:
        return min_lr
    if it <= warm:
        return lr * (it / max(warm, 1)) ** 2
    denom = max(total - warm - no_aug, 1)
    return min_lr + 0.5 * (lr - min_lr) * (1.0 + math.cos(
        math.pi * (it - warm) / denom))


def ema_decay(step: int) -> float:
    f32 = np.float32
    return float(f32(0.9998) * (f32(1.0) - np.exp(-f32(step) / f32(2000.0))))


def steps(model: nn.Module, batches, sched: dict, n: int = 3,
          start: int = 0, adam: Optional[dict] = None) -> dict:
    """``n`` train steps of ``model`` (train mode) on ``batches`` [(events,
    labels), ...], as updates ``start`` .. ``start + n - 1``, from Adam's
    moments and the EMA in ``adam`` ({'m', 'v', 'ema'}: {leaf: tensor}),
    or from zero moments and the parameters where ``adam`` is None.
    Returns the loss terms of each step, the first step's gradient of
    every leaf, the parameters and EMA after the last, the moments
    ('adam') and the whole state dict ('state')."""
    model.train()
    params = dict(model.named_parameters())
    if adam is None:
        adam = dict(m={k: torch.zeros_like(p) for k, p in params.items()},
                    v={k: torch.zeros_like(p) for k, p in params.items()},
                    ema={k: p.detach().clone() for k, p in params.items()})
    m, v, ema = adam["m"], adam["v"], adam["ema"]
    losses: List[Dict[str, float]] = []
    first_grad = {}
    b1, b2, eps = 0.9, 0.999, 1e-8
    for i in range(n):
        t = start + i
        for p in params.values():
            p.grad = None
        events, labels = batches[i]
        out, origin, gx, gy, sv = model(events)
        lo = yolox_losses(out, origin, labels, gx, gy, sv,
                          model.num_classes, use_l1=False)
        lo.total_loss.backward()
        losses.append({k: float(getattr(lo, k).detach()) for k in (
            "total_loss", "iou_loss", "conf_loss", "cls_loss", "num_fg")})
        lr = lr_at(sched, t)
        with torch.no_grad():
            for k, p in params.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if i == 0:
                    first_grad[k] = g.detach().clone()
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = m[k] / (1 - b1 ** (t + 1))
                vh = v[k] / (1 - b2 ** (t + 1))
                p.sub_(lr * mh / (vh.sqrt() + eps))
            d = ema_decay(t + 1)
            for k, p in params.items():
                ema[k].mul_(d).add_(p.detach() * (1.0 - d))
    return dict(losses=losses, grad=first_grad,
                params={k: p.detach().clone() for k, p in params.items()},
                ema=ema, adam=dict(m=m, v=v, ema=ema),
                state={k: t.detach().clone()
                       for k, t in model.state_dict().items()})
