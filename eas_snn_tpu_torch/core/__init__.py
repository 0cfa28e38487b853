"""Training runtime of the port: schedules and optimizer groups, the train
step with EMA (eager, or captured as CUDA graphs), checkpoints and the
trainer."""

from .checkpoint import CheckpointManager, load_partial_params
from .optim import build_lr_schedule, build_optimizer
from .train_state import (CapturedStep, ema_update, eval_step, init_ema,
                          train_step)
from .trainer import Trainer

__all__ = ["CheckpointManager", "load_partial_params", "build_lr_schedule",
           "build_optimizer", "CapturedStep", "ema_update", "eval_step",
           "init_ema", "train_step", "Trainer"]
