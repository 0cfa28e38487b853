"""The model zoo: detectors by name and weights from local checkpoints
(counterpart of ``eas_snn_tpu/models/build.py``; reference
yolox/models/build.py:36-111, which downloads its checkpoints: here a zoo
name resolves to a file in the repository).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from .yolox import EASYOLOX

__all__ = ["MODEL_SPECS", "ZOO_CKPTS", "create_model", "load_weights"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# zoo name -> checkpoint, relative to the repository root: a
# reference-initialized state dict checked into the repo
ZOO_CKPTS: Dict[str, str] = {
    "syolox-s-gen1": "checkpoints/syolox_s_gen1_init.pth",
}

_GEN1_SPIKING = dict(use_spike="backbone", embedding="arsnn",
                     embedding_depth=2, embedding_ksize=5, Ts=3, T=3,
                     readout="sum", write_zero=True, vreset=None,
                     spike_fn="atan")

# name -> (depth, width, EASYOLOX keyword arguments)
MODEL_SPECS: Dict[str, Tuple[float, float, Dict[str, Any]]] = {
    "yolox-s": (0.33, 0.50, dict(use_spike="none", embedding="count",
                                 num_classes=80)),
    "yolox-m": (0.67, 0.75, dict(use_spike="none", embedding="count",
                                 num_classes=80)),
    "yolox-l": (1.00, 1.00, dict(use_spike="none", embedding="count",
                                 num_classes=80)),
    "syolox-s-gen1": (0.33, 0.50, dict(_GEN1_SPIKING, num_classes=2)),
    "syolox-m-gen1": (0.67, 0.75, dict(_GEN1_SPIKING, num_classes=2)),
    "syolox-m-ncaltech": (0.67, 0.75, dict(_GEN1_SPIKING, alpha=1.5,
                                           num_classes=100)),
    "syolox-m-gen4": (0.67, 0.75, dict(_GEN1_SPIKING, num_classes=3)),
}


def _key(name: str) -> str:
    return name.lower().replace("_", "-")


def create_model(name: str, num_classes: Optional[int] = None,
                 device="cuda", seed: int = 0, **overrides) -> EASYOLOX:
    """The ``EASYOLOX`` of zoo entry ``name`` ('_' and '-' alike) with
    ``overrides`` of its keyword arguments, its weights drawn from a
    ``torch.Generator`` seeded with ``seed``, in eval mode on ``device``."""
    from ..exp.event_exp import resolve_device

    dev = resolve_device(device)
    key = _key(name)
    if key not in MODEL_SPECS:
        raise KeyError(f"unknown model '{name}'; available: "
                       f"{sorted(MODEL_SPECS)}")
    depth, width, kw = MODEL_SPECS[key]
    kw = dict(kw, depth=depth, width=width)
    if num_classes is not None:
        kw["num_classes"] = num_classes
    kw.update(overrides)
    model = EASYOLOX(**kw)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def load_weights(model: nn.Module, ckpt: str, device="cuda"
                 ) -> Dict[str, int]:
    """Weights from ``ckpt`` into ``model``, then the model onto ``device``.
    ``ckpt`` is a zoo name (``ZOO_CKPTS``), a reference ``.pth`` state dict
    (loaded by key) or a checkpoint of the port (its EMA where it has
    one), as ``core/checkpoint.py:eval_state_dict`` reads them. Every
    tensor whose name and shape match the model's is copied in; the rest
    of the model keeps its values. Returns {mapped, kept_current, total,
    unmapped}: tensors loaded, model tensors left as they were, the
    model's tensors, and checkpoint tensors with no place in the model
    (BN's ``num_batches_tracked`` counters are not counted)."""
    from ..core.checkpoint import eval_state_dict
    from ..exp.event_exp import resolve_device

    dev = resolve_device(device)
    if _key(ckpt) in ZOO_CKPTS:
        ckpt = os.path.join(_REPO, ZOO_CKPTS[_key(ckpt)])
    src = {k: v for k, v in eval_state_dict(ckpt).items()
           if not k.endswith("num_batches_tracked")}
    own = {k: v for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    take = {k: v for k, v in src.items()
            if k in own and tuple(v.shape) == tuple(own[k].shape)}
    model.load_state_dict(take, strict=False)
    model.to(dev)
    return {"mapped": len(take), "kept_current": len(own) - len(take),
            "total": len(own), "unmapped": len(src) - len(take)}
