"""Training checkpoints through ``torch.save`` (counterpart of
``eas_snn_tpu/core/checkpoint.py``; reference yolox/core/trainer.py:388-419,
yolox/utils/checkpoint.py:11-43).

A checkpoint holds {model, ema, optimizer, step, best_ap}: the model's
state dict (parameters and BN buffers), the EMA parameters, the
optimizer's state dict (its update count included), the step and the best
AP so far. ``CheckpointManager`` writes ``ckpt_<step>.pth`` files and keeps
the newest three.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from .optim import load_optimizer_state

__all__ = ["CheckpointManager", "load_partial_params"]

_NAME = re.compile(r"ckpt_(\d+)\.pth$")


class CheckpointManager:
    MAX_TO_KEEP = 3

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        """Steps with a checkpoint on disk, ascending."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m[1]) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pth")

    def save(self, step: int, model: nn.Module,
             optimizer: torch.optim.Optimizer,
             ema: Optional[Dict[str, torch.Tensor]] = None,
             best_ap: float = 0.0) -> str:
        payload = {"model": model.state_dict(),
                   "optimizer": optimizer.state_dict(),
                   "ema": ema, "step": int(step), "best_ap": float(best_ap)}
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.MAX_TO_KEEP]:
            os.remove(self.path(old))
        return path

    def restore(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                ema: Optional[Dict[str, torch.Tensor]] = None,
                step: Optional[int] = None) -> Tuple[int, float]:
        """Load the checkpoint of ``step`` (the latest by default) into the
        model, optimizer and EMA in place. Returns (step, best_ap), or
        (0, 0.0) when there is none. The optimizer's state tensors are
        replaced (``optim.load_optimizer_state``): restore before any CUDA
        graph of the step is captured."""
        step = self.latest_step() if step is None else step
        if step is None:
            return 0, 0.0
        dev = next(model.parameters()).device
        payload = torch.load(self.path(step), map_location=dev,
                             weights_only=True)
        model.load_state_dict(payload["model"], strict=True)
        load_optimizer_state(optimizer, payload["optimizer"])
        if ema is not None and payload["ema"] is not None:
            with torch.no_grad():
                for name, value in payload["ema"].items():
                    ema[name].copy_(value)
        return payload["step"], payload["best_ap"]


def load_partial_params(model: nn.Module,
                        state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Shape-checked partial load for fine-tuning (reference
    utils/checkpoint.py:11-33): every entry whose name and shape match the
    model's is copied in; the rest keep their current values. Returns a
    report {"loaded": n, "shape_mismatch": [names], "missing": [names],
    "unexpected": [names]}."""
    own = model.state_dict()
    take, mismatch = {}, []
    for name, value in state_dict.items():
        if name in own:
            if tuple(value.shape) == tuple(own[name].shape):
                take[name] = value
            else:
                mismatch.append(name)
    model.load_state_dict(take, strict=False)
    return {"loaded": len(take), "shape_mismatch": mismatch,
            "missing": sorted(set(own) - set(state_dict)),
            "unexpected": sorted(set(state_dict) - set(own))}
