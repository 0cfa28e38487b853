"""Experiment tracking: a JSONL metrics log, plus TensorBoard and wandb
where they can be imported (the port's copy of
``eas_snn_tpu/utils/tracking.py:22-183``; reference yolox/utils/logger.py
WandbLogger and the TensorBoard scalars of core/trainer.py:292-304).

One ``{"ts", "step", "split", <metrics>}`` object a line in
``<run dir>/metrics.jsonl``, always. The prediction-image panel
(``log_pred_images``) waits for the evaluators (ROADMAP.md §1 item 9).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

__all__ = ["MetricsTracker"]


class MetricsTracker:
    """backend: 'auto' adds every importable backend; 'jsonl' only the
    file; 'tensorboard' / 'wandb' require that backend and raise when it
    cannot be imported (the reference fails the same way on ``--logger
    wandb`` without wandb). ``enabled=False`` (every process but rank 0
    of a data-parallel run) writes nothing."""

    def __init__(self, output_dir: str, backend: str = "auto",
                 run_config: Optional[Dict] = None, enabled: bool = True):
        if backend not in ("auto", "jsonl", "tensorboard", "wandb"):
            raise ValueError(f"unknown metrics backend '{backend}'")
        self._tb = None
        self._wandb = None
        self._f = None
        if not enabled:
            return
        os.makedirs(output_dir, exist_ok=True)
        self._f = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        if backend in ("auto", "tensorboard"):
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                if backend == "tensorboard":
                    raise
            else:
                self._tb = SummaryWriter(os.path.join(output_dir, "tb"))
        if backend in ("auto", "wandb"):
            try:
                import wandb
            except ImportError:
                if backend == "wandb":
                    raise
            else:
                self._wandb = wandb.init(
                    project=os.environ.get("WANDB_PROJECT", "eas-snn-tpu"),
                    name=os.path.basename(output_dir.rstrip(os.sep)) or None,
                    dir=output_dir, config=dict(run_config or {}),
                    resume="allow")

    def log(self, step: int, metrics: Dict[str, float],
            split: str = "train") -> None:
        if self._f is None:
            return
        row = {"ts": time.time(), "step": int(step), "split": split}
        row.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"{split}/{k}", float(v), int(step))
        if self._wandb is not None:
            self._wandb.log({f"{split}/{k}": float(v)
                             for k, v in metrics.items()}, step=int(step))

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
