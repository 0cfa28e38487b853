"""Training checkpoints through ``torch.save`` (counterpart of
``eas_snn_tpu/core/checkpoint.py``; reference yolox/core/trainer.py:388-419,
yolox/utils/checkpoint.py:11-43).

A checkpoint holds {model, ema, optimizer, step, best_ap}: the model's
state dict (parameters and BN buffers), the EMA parameters, the
optimizer's state dict (its update count included), the step and the best
AP so far. ``CheckpointManager`` writes ``ckpt_<step>.pth`` files and keeps
the newest three, and ``best.pth`` beside them when asked (JAX
``core/checkpoint.py:35-56``). In a data-parallel run only rank 0 writes
(every process holds the same state); every process can restore. On a
channel-sharded 2-D mesh (``parallel/mesh.py``) every process first
gathers the sharded tensors whole over its model group, so the file is an
unsharded model's, and a restore cuts the whole tensors to the process's
slices: an unsharded checkpoint shards into a 2-D run and back.
``eval_state_dict`` reads the weights to evaluate from a checkpoint (its
EMA where it has one) or from a reference ``.pth``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from .. import parallel
from ..parallel import mesh as pmesh
from ..utils.weights import load_reference_state_dict
from .optim import load_optimizer_state

__all__ = ["CheckpointManager", "load_partial_params", "eval_state_dict",
           "load_eval_weights"]

_NAME = re.compile(r"ckpt_(\d+)\.pth$")


class CheckpointManager:
    MAX_TO_KEEP = 3

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        if parallel.rank() == 0:
            os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        """Steps with a checkpoint on disk, ascending."""
        if not os.path.isdir(self.directory):
            return []
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m[1]) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pth")

    @property
    def best_path(self) -> str:
        return os.path.join(self.directory, "best.pth")

    def save(self, step: int, model: nn.Module,
             optimizer: torch.optim.Optimizer,
             ema: Optional[Dict[str, torch.Tensor]] = None,
             best_ap: float = 0.0, is_best: bool = False) -> str:
        """Write ``ckpt_<step>.pth`` (and the same payload as ``best.pth``
        with ``is_best``) on rank 0; returns the step's path."""
        path = self.path(step)
        model_sd, opt_sd = model.state_dict(), None
        if pmesh.sharded_keys(model):  # every process gathers
            model_sd = pmesh.gather_state(model, model_sd)
            opt_sd = pmesh.gather_optimizer_state(optimizer, model)
            ema = pmesh.gather_state(model, ema) if ema is not None else None
        if parallel.rank() != 0:
            return path
        payload = {"model": model_sd,
                   "optimizer": opt_sd or optimizer.state_dict(),
                   "ema": ema, "step": int(step), "best_ap": float(best_ap)}
        for dst in (path, self.best_path) if is_best else (path,):
            tmp = dst + ".tmp"
            torch.save(payload, tmp)
            os.replace(tmp, dst)
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
        if pmesh.sharded_keys(model):
            payload["model"] = pmesh.shard_state(model, payload["model"])
            payload["optimizer"] = pmesh.shard_optimizer_state(
                payload["optimizer"], optimizer, model)
            if payload["ema"] is not None:
                payload["ema"] = pmesh.shard_state(model, payload["ema"])
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


def eval_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The weights to evaluate from ``path``: a checkpoint of the port
    (``ckpt_<step>.pth``, ``best.pth``) gives its model state with the EMA
    parameters in place of the trained ones where it has an EMA; any other
    ``.pth`` is read as a reference state dict
    (``utils/weights.py:load_reference_state_dict``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and {"model", "ema", "step"} <= set(obj):
        sd = dict(obj["model"])
        sd.update(obj["ema"] or {})
        return sd
    return load_reference_state_dict(path)


def load_eval_weights(model: nn.Module, path: str) -> None:
    """``eval_state_dict(path)`` into ``model``, strictly, in place."""
    model.load_state_dict(eval_state_dict(path), strict=True)
