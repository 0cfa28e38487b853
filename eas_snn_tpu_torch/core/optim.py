"""Learning-rate schedules and the optimizer with the reference's group
policy (counterpart of ``eas_snn_tpu/core/optim.py``; reference
yolox/exp/event_yolox_base.py:353-416, yolox/utils/lr_scheduler.py).

Schedules are plain Python functions of the update count. The optimizer
is ``torch.optim.Adam`` (or :class:`SGD`, Nesterov momentum) over three
groups:
conv kernels outside BN and outside the embedding, which take the weight
decay (coupled into the gradient, torch's and the JAX package's rule);
every other parameter outside the embedding; and the embedding, whose
learning rate is scaled by ``emb_lr / base_lr`` for good (the JAX
package's reading of ``emb_lr``, which the reference's trainer overwrites
after its first step). Update t (counted from 0) uses schedule(t); the
count is each group's ``"updates"`` entry, a host integer, so it travels
with ``state_dict()``.

On a CUDA device the optimizer is built capturable (Adam: foreach, its
step counts and bias corrections on the device; :class:`SGD` always) and
each group's ``lr`` is a 0-d f32 tensor on the device that
``set_learning_rate`` fills in place before the step: the step can then
be captured in a CUDA graph (``train_state.CapturedStep``), the
counterpart of the JAX package evaluating its schedule inside the jitted
update. On the CPU Adam's lr stays a Python float.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn

__all__ = ["build_lr_schedule", "build_optimizer", "set_learning_rate",
           "updates", "learning_rate", "load_optimizer_state", "SGD"]


def build_lr_schedule(
    name: str,
    lr: float,
    iters_per_epoch: int,
    total_epochs: int,
    warmup_epochs: float = 0,
    warmup_lr_start: float = 0.0,
    no_aug_epochs: int = 0,
    min_lr_ratio: float = 0.05,
    milestones: tuple = (),
    gamma: float = 0.1,
    semi_epoch: int = 0,
    iters_per_epoch_semi: Optional[int] = None,
) -> Callable[[int], float]:
    """Per-update LR schedule: 'fixed', 'cos', 'warmcos', 'yoloxwarmcos'
    (quadratic warmup, cosine to min_lr_ratio, flat minimum over the
    no-aug tail), 'yoloxsemiwarmcos' (a slower clock after semi_epoch) and
    'multistep' (milestones in epochs)."""
    total_iters = iters_per_epoch * total_epochs
    warmup_iters = iters_per_epoch * warmup_epochs
    no_aug_iters = iters_per_epoch * no_aug_epochs
    min_lr = lr * min_lr_ratio
    denom = max(total_iters - warmup_iters - no_aug_iters, 1)
    ms_iters = [int(total_iters * m / total_epochs) for m in milestones or ()]
    if name not in ("fixed", "cos", "warmcos", "yoloxwarmcos",
                    "yoloxsemiwarmcos", "multistep"):
        raise ValueError(f"unknown scheduler '{name}'")

    def quad_warm(it: float) -> float:
        return ((lr - warmup_lr_start) * (it / max(warmup_iters, 1)) ** 2
                + warmup_lr_start)

    def cosine(pos: float) -> float:
        return min_lr + 0.5 * (lr - min_lr) * (1.0 + math.cos(
            math.pi * pos / denom))

    def sched(step: int) -> float:
        it = float(step)
        if name == "fixed":
            return lr
        if name == "cos":
            return lr * 0.5 * (1.0 + math.cos(math.pi * it / total_iters))
        if name == "warmcos":
            if it <= warmup_iters:
                return ((lr - warmup_lr_start) * it / max(warmup_iters, 1)
                        + warmup_lr_start)
            return lr * 0.5 * (1.0 + math.cos(
                math.pi * (it - warmup_iters) / (total_iters - warmup_iters)))
        if name == "yoloxwarmcos":
            if no_aug_iters > 0 and it >= total_iters - no_aug_iters:
                return min_lr
            if it <= warmup_iters:
                return quad_warm(it)
            return cosine(it - warmup_iters)
        if name == "yoloxsemiwarmcos":
            ipe_semi = iters_per_epoch_semi or iters_per_epoch
            normal_iters = iters_per_epoch * semi_epoch
            semi_iters = ipe_semi * (total_epochs - semi_epoch - no_aug_epochs)
            if it <= warmup_iters:
                return quad_warm(it)
            if it >= normal_iters + semi_iters:
                return min_lr
            if it <= normal_iters:
                return cosine(it - warmup_iters)
            return cosine(normal_iters - warmup_iters
                          + (it - normal_iters) * iters_per_epoch / ipe_semi)
        return lr * gamma ** sum(it >= m for m in ms_iters)  # multistep

    return sched


class SGD(torch.optim.Optimizer):
    """SGD with Nesterov momentum and coupled weight decay whose lr is a
    0-d tensor a group, on the parameters' device: capturable in a CUDA
    graph, where ``torch.optim.SGD`` reads a tensor lr on the host. Its
    arithmetic is ``torch.optim.SGD``'s (``nesterov=True``, no dampening)
    op for op, the last as torch's SGD takes a tensor lr (``addcmul`` with
    value -1), which gives the bits of its float-lr update; the momentum
    buffer of the first step is the gradient itself, as in torch's. The
    JAX package's ``optax.trace(nesterov=True)`` and
    ``scale_by_learning_rate`` compute the same update."""

    def __init__(self, params, lr: float, momentum: float = 0.9,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay,
                                      capturable=True))
        for g in self.param_groups:
            if not isinstance(g["lr"], torch.Tensor):
                dev = g["params"][0].device
                g["lr"] = torch.full((), float(g["lr"]), dtype=torch.float32,
                                     device=dev)

    @torch.no_grad()
    def step(self, closure=None):
        for g in self.param_groups:
            params = [p for p in g["params"] if p.grad is not None]
            if not params:
                continue
            d = [p.grad for p in params]
            if g["weight_decay"] != 0:
                d = torch._foreach_add(d, params, alpha=g["weight_decay"])
            states = [self.state[p] for p in params]
            if "momentum_buffer" not in states[0]:
                bufs = [x.detach().clone() for x in d]
                for st, b in zip(states, bufs):
                    st["momentum_buffer"] = b
            else:
                bufs = [st["momentum_buffer"] for st in states]
                torch._foreach_mul_(bufs, g["momentum"])
                torch._foreach_add_(bufs, d, alpha=1.0)
            d = torch._foreach_add(d, bufs, alpha=g["momentum"])
            lr = g["lr"]
            torch._foreach_addcmul_(params, d, [lr] * len(params), value=-1)


def _groups(model: nn.Module):
    """(decay, no_decay, embedding) parameter lists: decay holds the conv
    kernels outside BN and outside ``model.embedding``."""
    emb = {id(p) for n, p in model.named_parameters()
           if n.split(".")[0] == "embedding"}
    kernels = {id(m.weight) for m in model.modules()
               if isinstance(m, nn.Conv2d)}
    decay, no_decay, emb_params = [], [], []
    for _, p in model.named_parameters():
        if id(p) in emb:
            emb_params.append(p)
        elif id(p) in kernels:
            decay.append(p)
        else:
            no_decay.append(p)
    return decay, no_decay, emb_params


def build_optimizer(model: nn.Module, lr_schedule: Callable[[int], float],
                    optimizer: str = "ADAM", weight_decay: float = 0.0,
                    momentum: float = 0.9, emb_lr: float = -1.0,
                    base_lr: float = 1e-3) -> torch.optim.Optimizer:
    """Adam (default) or :class:`SGD` (Nesterov) with the reference's
    groups. The schedule rides on the optimizer as ``lr_schedule``; each
    group's ``lr_scale`` multiplies it. On a CUDA device both are
    capturable, with a 0-d device tensor lr a group (SGD's lr is one on
    the CPU too)."""
    emb_scale = emb_lr / base_lr if emb_lr > 0 else 1.0
    decay, no_decay, emb = _groups(model)
    groups = [
        dict(params=decay, weight_decay=weight_decay, lr_scale=1.0),
        dict(params=no_decay, weight_decay=0.0, lr_scale=1.0),
        dict(params=emb, weight_decay=0.0, lr_scale=emb_scale),
    ]
    groups = [dict(g, updates=0) for g in groups if g["params"]]
    lr0 = lr_schedule(0)
    dev = next(model.parameters()).device
    if optimizer.upper() == "ADAM" and dev.type == "cuda":
        # one tensor a group: a shared default would tie their lrs
        for g in groups:
            g["lr"] = torch.full((), lr0 * g["lr_scale"],
                                 dtype=torch.float32, device=dev)
        opt = torch.optim.Adam(groups, lr=lr0, betas=(0.9, 0.999), eps=1e-8,
                               foreach=True, capturable=True)
    elif optimizer.upper() == "ADAM":
        opt = torch.optim.Adam(groups, lr=lr0, betas=(0.9, 0.999), eps=1e-8)
    else:
        for g in groups:
            g["lr"] = lr0 * g["lr_scale"]
        opt = SGD(groups, lr=lr0, momentum=momentum)
    opt.lr_schedule = lr_schedule
    return opt


def updates(optimizer: torch.optim.Optimizer) -> int:
    """The number of updates the optimizer has applied."""
    return optimizer.param_groups[0]["updates"]


def set_learning_rate(optimizer: torch.optim.Optimizer, step: int) -> None:
    """Every group's lr for update ``step``: schedule(step) * lr_scale,
    filled in place where the lr is a device tensor."""
    lr = optimizer.lr_schedule(step)
    for g in optimizer.param_groups:
        if isinstance(g["lr"], torch.Tensor):
            g["lr"].fill_(lr * g["lr_scale"])
        else:
            g["lr"] = lr * g["lr_scale"]


def learning_rate(optimizer: torch.optim.Optimizer) -> float:
    """The first group's lr of the last update, from the schedule on the
    host (reading a device lr would wait for the card)."""
    g = optimizer.param_groups[0]
    return optimizer.lr_schedule(max(updates(optimizer) - 1, 0)) \
        * g["lr_scale"]


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         state_dict: dict) -> None:
    """``optimizer.load_state_dict`` that keeps what this optimizer was
    built with: each group's ``capturable`` and ``foreach`` flags and the
    kind of its lr (its own device tensor, filled with the saved value, or
    a float), and Adam's step counts where capturable wants them (on the
    parameter's device) or not (on the CPU). So a checkpoint written on
    the card restores on the CPU and the other way round. It replaces the
    optimizer's state tensors: a CUDA graph captured before it would update
    the old ones."""
    kept = [(g.get("capturable"), g.get("foreach"), g["lr"])
            for g in optimizer.param_groups]
    optimizer.load_state_dict(state_dict)
    for g, (capturable, foreach, lr) in zip(optimizer.param_groups, kept):
        value = float(g["lr"])
        if capturable is not None:
            g["capturable"] = capturable
        g["foreach"] = foreach
        if isinstance(lr, torch.Tensor):
            lr.fill_(value)
            g["lr"] = lr
        else:
            g["lr"] = value
        for p in g["params"]:
            st = optimizer.state.get(p, {})
            if isinstance(st.get("step"), torch.Tensor):
                dev = p.device if capturable else torch.device("cpu")
                st["step"] = st["step"].to(device=dev, dtype=torch.float32)
