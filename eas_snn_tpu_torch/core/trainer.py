"""The training loop (counterpart of ``eas_snn_tpu/core/trainer.py``;
reference yolox/core/trainer.py:36-419).

``Trainer(exp, device="cuda").train(batches)`` builds the seeded model in
train mode, the optimizer and schedule from the batch size of the first
batch, and the EMA, then runs ``exp.max_epoch`` epochs of
``iters_per_epoch`` steps over ``batches``, an iterable of (events,
labels): events (B, Tl, Tm, H, W, 2), labels (B, M, 5) [cls, cx, cy, w,
h] padded with zero rows. A re-iterable (a list) is walked again when it
runs out; a one-shot iterable ends the training. The no-aug tail of the
schedule turns the L1 loss on. Every ``exp.print_interval`` steps the
losses come to the host into a meter and the log; after every epoch a
checkpoint is written under ``<exp.output_dir>/<exp.exp_name>/ckpt``.

Not here yet: the data loader (ROADMAP item 8), multiscale resizing, the
evaluator and best-AP tracking (AP stays 0.0), metrics trackers and
profiling.
"""

from __future__ import annotations

import datetime
import logging
import os
import time
from typing import Iterable, Iterator, Optional, Tuple

import torch

from ..utils.metric import MeterBuffer
from .checkpoint import CheckpointManager
from .optim import updates
from .train_state import init_ema, train_step

__all__ = ["Trainer"]

Batch = Tuple[torch.Tensor, torch.Tensor]


class Trainer:
    def __init__(self, exp, device="cuda",
                 iters_per_epoch: Optional[int] = None):
        from ..exp.event_exp import resolve_device

        self.exp = exp
        self.device = resolve_device(device)
        self.iters_per_epoch = iters_per_epoch
        self.max_epoch = exp.max_epoch
        self.meter = MeterBuffer(window_size=exp.print_interval)
        self.file_name = os.path.join(exp.output_dir, exp.exp_name)
        self.logger = logging.getLogger("eas_snn_tpu_torch.trainer")
        self.use_l1 = False
        self.best_ap = 0.0
        self.epoch = 0
        self.model = self.optimizer = self.ema = self.ckpt = None
        self.last_losses: dict = {}

    def train(self, batches: Iterable[Batch]) -> None:
        self._batches = batches
        self._it: Iterator[Batch] = iter(batches)
        first = next(self._it)
        self.before_train(first)
        self._pending: Optional[Batch] = first
        for self.epoch in range(self.max_epoch):
            self.before_epoch()
            if not self.train_in_iter():
                break
            self.after_epoch()
        self.logger.info("training done at step %d", updates(self.optimizer))

    def before_train(self, first: Batch) -> None:
        exp = self.exp
        batch_size = int(first[0].shape[0])
        if self.iters_per_epoch is None:
            if not hasattr(self._batches, "__len__"):
                raise ValueError("iters_per_epoch is needed for batches "
                                 "without a length")
            self.iters_per_epoch = len(self._batches)
        self.model = exp.get_model(device=self.device, seed=exp.seed or 0,
                                   train=True)
        self.optimizer = exp.get_optimizer(self.model, batch_size,
                                           self.iters_per_epoch)
        self.ema = init_ema(self.model) if exp.ema else None
        self.ckpt = CheckpointManager(os.path.join(self.file_name, "ckpt"))
        self.logger.info("training %s on %s: batch %d, %d iters/epoch, %d "
                         "epochs", exp.exp_name, self.device, batch_size,
                         self.iters_per_epoch, self.max_epoch)

    def before_epoch(self) -> None:
        exp = self.exp
        if (exp.no_aug_epochs > 0 and not self.use_l1
                and self.epoch >= self.max_epoch - exp.no_aug_epochs):
            # reference trainer.py:228-241: the tail adds the L1 loss
            self.logger.info("--->no-aug phase: adding L1")
            self.use_l1 = True

    def _next(self) -> Optional[Batch]:
        if self._pending is not None:
            batch, self._pending = self._pending, None
            return batch
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self._batches)
            return next(self._it, None)

    def train_in_iter(self) -> bool:
        """One epoch; False when the batches ran out."""
        for it in range(self.iters_per_epoch):
            t0 = time.perf_counter()
            batch = self._next()
            if batch is None:
                self.logger.info("batches exhausted at epoch %d, iter %d",
                                 self.epoch + 1, it + 1)
                return False
            events, labels = (t.to(self.device, non_blocking=True)
                              for t in batch)
            t_data = time.perf_counter()
            losses = train_step(self.model, self.optimizer, self.ema, events,
                                labels, use_l1=self.use_l1)
            if (it + 1) % self.exp.print_interval == 0:
                losses = {k: float(v) for k, v in losses.items()}
                self.meter.update(iter_time=time.perf_counter() - t0,
                                  data_time=t_data - t0,
                                  lr=self.optimizer.param_groups[0]["lr"],
                                  **losses)
                self._log_iter(it)
            self.last_losses = losses
        return True

    def _log_iter(self, it: int) -> None:
        done = self.epoch * self.iters_per_epoch + it + 1
        left = self.iters_per_epoch * self.max_epoch - done
        eta = datetime.timedelta(
            seconds=int(left * self.meter["iter_time"].avg))
        loss_str = ", ".join(f"{k}: {v.latest:.3f}"
                             for k, v in self.meter.items()
                             if "loss" in k or k == "num_fg")
        mem = (f"mem: {torch.cuda.max_memory_allocated() / 2**30:.1f}GiB, "
               if self.device.type == "cuda" else "")
        self.logger.info(
            "epoch: %d/%d, iter: %d/%d, %siter_time: %.3fs, data_time: "
            "%.3fs, %s, lr: %.3e, ETA: %s", self.epoch + 1, self.max_epoch,
            it + 1, self.iters_per_epoch, mem, self.meter["iter_time"].avg,
            self.meter["data_time"].avg, loss_str,
            self.meter["lr"].latest, eta)

    def after_epoch(self) -> None:
        path = self.ckpt.save(updates(self.optimizer), self.model,
                              self.optimizer, self.ema, self.best_ap)
        self.logger.info("epoch %d done: checkpoint %s", self.epoch + 1, path)
