"""One training step, the parameter EMA and the EMA eval forward
(counterpart of ``eas_snn_tpu/core/train_state.py``; reference
yolox/core/trainer.py:95-135, yolox/utils/ema.py).

A step is: zero the gradients, the loss forward, backward, the optimizer
update at the schedule's lr for the update count before it, then the EMA
of the parameters (not the BN buffers, which stay the model's). No neuron
state survives a step, so nothing is reset between steps.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from .optim import set_learning_rate, updates

__all__ = ["init_ema", "ema_update", "optimizer_update", "train_step",
           "eval_step"]

EMA_DECAY = 0.9998


def init_ema(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of every parameter, by name."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module,
               step: int) -> None:
    """ema <- ema * d + param * (1 - d) in place, with the warm-up ramp
    d = 0.9998 * (1 - exp(-step / 2000)) computed in f32 as the JAX package
    does (reference utils/ema.py:38-60)."""
    f32 = np.float32
    d = f32(EMA_DECAY) * (f32(1.0) - np.exp(-f32(step) / f32(2000.0)))
    names = [n for n, _ in model.named_parameters()]
    e = [ema[n] for n in names]
    p = [q.detach() for _, q in model.named_parameters()]
    torch._foreach_mul_(e, float(d))
    torch._foreach_add_(e, p, alpha=float(f32(1.0) - d))


def optimizer_update(model: nn.Module, optimizer: torch.optim.Optimizer,
                     ema: Optional[Dict[str, torch.Tensor]]) -> None:
    """The update half of a step, after the backward: the lr of update t
    (t = updates so far), the optimizer step, the count, then the EMA at
    t + 1."""
    t = updates(optimizer)
    set_learning_rate(optimizer, t)
    optimizer.step()
    for g in optimizer.param_groups:
        g["updates"] = t + 1
    if ema is not None:
        ema_update(ema, model, t + 1)


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               ema: Optional[Dict[str, torch.Tensor]], events: torch.Tensor,
               targets: torch.Tensor, use_l1: bool = False,
               to_host: bool = False) -> dict:
    """One step of a model in train mode. Returns the loss dict: detached
    device tensors, so that the step does not wait for the card, or Python
    floats with ``to_host``."""
    optimizer.zero_grad(set_to_none=True)
    losses = model(events, targets, use_l1=use_l1)
    losses["total_loss"].backward()
    optimizer_update(model, optimizer, ema)
    losses = {k: v.detach() for k, v in losses.items()}
    return {k: float(v) for k, v in losses.items()} if to_host else losses


@torch.no_grad()
def eval_step(model: nn.Module, ema: Optional[Dict[str, torch.Tensor]],
              events: torch.Tensor) -> torch.Tensor:
    """The eval forward with the EMA parameters (the model's own where
    ``ema`` is None) and the model's BN buffers; the model's train/eval
    mode is restored."""
    was_training = model.training
    model.eval()
    try:
        return functional_call(model, ema or {}, (events,))
    finally:
        model.train(was_training)
