"""Conv+BN folding and parameter freezing (counterpart of
``eas_snn_tpu/utils/model_surgery.py``; reference
yolox/utils/model_utils.py:35-96 fuse_conv_and_bn / fuse_model, :131-156
freeze_module). Neither is on the eval or the train path: the fused
conv+BN+PLIF sites fold their BN at each call (``ops/conv_plif.py``).
"""

from __future__ import annotations

import copy
from typing import Dict, Sequence

import torch
import torch.nn as nn

from ..models.blocks import BaseConv

__all__ = ["fuse_conv_bn", "freeze_labels", "freeze"]


@torch.no_grad()
def fuse_conv_bn(model: nn.Module, eps: float = 1e-3,
                 inplace: bool = True) -> nn.Module:
    """Fold each ``BaseConv``'s eval BatchNorm into its conv weight, as the
    JAX package folds every conv / bn pair: with g = scale / sqrt(var +
    eps), the kernel becomes kernel * g and the BN scale 1, bias bias -
    mean * g, mean 0, var 1 - eps, so that the eval function is the same
    and the BN is a bias add. On ``model`` itself, or on a copy with
    ``inplace=False``; returns the model folded."""
    if not inplace:
        model = copy.deepcopy(model)
    for m in model.modules():
        if not isinstance(m, BaseConv):
            continue
        bn = m.bn
        g = bn.weight / torch.sqrt(bn.running_var + eps)
        m.weight.mul_(g.reshape(-1, 1, 1, 1))
        bn.bias.sub_(bn.running_mean * g)
        bn.weight.fill_(1.0)
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0 - eps)
    return model


def freeze_labels(model: nn.Module, prefixes: Sequence[str]
                  ) -> Dict[str, str]:
    """'frozen' or 'trainable' for each parameter name: frozen where a
    module name on its path equals or starts with one of ``prefixes`` (the
    JAX package's labels for ``optax.multi_transform``)."""
    def frozen(name: str) -> bool:
        return any(t == p or t.startswith(p)
                   for t in name.split(".")[:-1] for p in prefixes)

    return {n: "frozen" if frozen(n) else "trainable"
            for n, _ in model.named_parameters()}


def freeze(model: nn.Module, prefixes: Sequence[str]) -> int:
    """``requires_grad`` off for the parameters ``freeze_labels`` calls
    frozen (an optimizer built after it skips nothing: Adam leaves a
    parameter without a gradient as it is). Returns how many."""
    labels = freeze_labels(model, prefixes)
    for n, p in model.named_parameters():
        p.requires_grad_(labels[n] == "trainable")
    return sum(v == "frozen" for v in labels.values())
