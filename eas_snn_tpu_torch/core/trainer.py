"""The training loop (counterpart of ``eas_snn_tpu/core/trainer.py:57-469``;
reference yolox/core/trainer.py:36-419).

``Trainer(exp, args, device="cuda").train()`` trains on ``exp``'s data
loader: ``before_train`` builds the seeded model in train mode, the
optimizer and schedule for ``args.batch_size``, the EMA and the checkpoint
manager, then resumes (``args.resume``: the latest checkpoint, from the
epoch its step falls in) or loads fine-tune weights (``args.ckpt``: a
shape-checked partial load), before any step is captured. Each epoch runs
``iters_per_epoch`` steps: the next batch (copied to the card on a side
stream while the step before runs), device binning where the loader ships
raw events, the seeded multiscale resize, then the step: one CUDA graph a
batch geometry on the card (``CapturedStep``), ``train_step`` on the CPU.
The no-aug tail turns the L1 loss on. Every ``exp.print_interval`` steps
the losses come to the host into the meters, the log and
``metrics.jsonl`` (on the card with the MFU, a conv-only lower bound);
``args.profile`` N traces N steps of the first epoch with torch.profiler
into ``<run dir>/profile``. Every ``exp.eval_interval`` epochs the EMA
weights (the trained ones without EMA) are evaluated in a separate
eval-mode model, built once and refreshed from the train state at each
evaluation, so the captured step's parameters are only read; AP and AP50
go to the log and to ``metrics.jsonl`` under the ``val`` split, and the
best AP so far to the checkpoints (JAX ``core/trainer.py:371-398``).
Every epoch ends with a checkpoint in ``<run dir>/ckpt``, and a new best
AP also writes ``best.pth``.

``train(batches)`` trains on an in-memory iterable of (events, labels)
instead: a re-iterable (a list) is walked again when it runs out, a
one-shot iterable ends the training.

Data parallel (a process group started by ``parallel``, one process a
card): ``args.batch_size`` is the global batch, and each process loads its
rank-strided ``batch_size / world_size`` samples a step, as the JAX
trainer feeds its jitted step one global batch of ``-b`` rows sharded
over the mesh; the schedule's lr is that of the global batch. Every
process builds the seeded model, then takes rank 0's state
(``broadcast_state``), steps on the global-batch step
(``core/train_state.py``) and takes the same seeded multiscale sizes; the
evaluation runs each process's share of the val split and gathers the
rows (``evaluators/event_evaluator.py:_allgather_rows``). Only rank 0
makes the run directory, logs at INFO, writes the metrics and saves
checkpoints (JAX ``core/trainer.py:65-77``).

After each evaluation rank 0 draws the eval model's detections on the
first batch of the evaluator's loader into ``<run dir>/pred_images/``
(``MetricsTracker.log_pred_images``; ``EAS_LOG_PRED_IMAGES=0`` turns it
off), and with wandb and ``EAS_WANDB_ARTIFACTS=1`` a new best checkpoint
becomes a wandb artifact (JAX ``core/trainer.py:405-456``).
"""

from __future__ import annotations

import argparse
import csv
import datetime
import functools
import itertools
import os
import sys
import time
from typing import Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import parallel
from ..data.loader import DevicePrefetcher
from ..data.reps import bin_event_batch
from ..evaluators.energy import conv_macs_per_frame
from ..ops.boxes import postprocess
from ..utils.logger import setup_logger
from ..utils.metric import MeterBuffer
from ..utils.tracking import MetricsTracker
from ..utils.weights import load_reference_state_dict
from .checkpoint import CheckpointManager, load_partial_params
from .optim import learning_rate, updates
from .train_state import (CapturedStep, broadcast_state, init_ema,
                          train_step)

__all__ = ["Trainer", "multiscale_resize"]

Batch = Tuple[torch.Tensor, torch.Tensor]

# the H100 SXM's dense bf16 tensor-core peak, the MFU's denominator
PEAK_FLOPS = 989e12


def multiscale_resize(events: torch.Tensor, targets: torch.Tensor,
                      size: Tuple[int, int]):
    """A (B, Tl, Tm, H, W, C) batch resized to ``size`` = (H', W') by
    nearest neighbour with half-pixel centres (``'nearest-exact'``, the
    rule of the JAX package's ``jax.image.resize(..., "nearest")``), and
    the cxcywh labels rescaled to match in f32 (JAX
    ``core/trainer.py:32-53``; reference exp/event_yolox_base.py:
    337-351)."""
    b, tl, tm, h, w, c = events.shape
    h2, w2 = size
    if (h, w) == (h2, w2):
        return events, targets
    x = events.reshape(b * tl * tm, h, w, c).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(h2, w2), mode="nearest-exact")
    events = x.permute(0, 2, 3, 1).reshape(b, tl, tm, h2, w2, c)
    targets = targets.clone()
    targets[..., 1::2] *= w2 / w
    targets[..., 2::2] *= h2 / h
    return events, targets


def _cycle(batches: Iterable):
    """``batches`` again and again while it is a re-iterable that yields."""
    while True:
        n = 0
        for b in batches:
            n += 1
            yield b
        if n == 0 or iter(batches) is batches:
            return


class Trainer:
    def __init__(self, exp, args: Optional[argparse.Namespace] = None,
                 device="cuda", iters_per_epoch: Optional[int] = None):
        from ..exp.event_exp import resolve_device

        self.exp = exp
        self.args = args if args is not None else argparse.Namespace()
        self.device = resolve_device(device)
        self.rank = parallel.rank()
        self.world_size = parallel.world_size()
        self.iters_per_epoch = iters_per_epoch
        self.max_epoch = exp.max_epoch
        self.meter = MeterBuffer(window_size=exp.print_interval)
        self.file_name = os.path.join(
            exp.output_dir,
            getattr(self.args, "experiment_name", None) or exp.exp_name)
        if self.rank == 0:
            os.makedirs(self.file_name, exist_ok=True)
        self.logger = setup_logger(self.file_name, self.rank)
        # without command-line args only the JSONL file: 'auto' would
        # start every importable backend, wandb included
        self.tracker = MetricsTracker(
            self.file_name,
            backend=getattr(self.args, "logger", None) or "jsonl",
            run_config={k: v for k, v in vars(exp).items()
                        if isinstance(v, (int, float, str, bool,
                                          type(None)))},
            enabled=self.rank == 0)
        self.use_l1 = False
        self.best_ap = 0.0
        self.epoch = self.start_epoch = 0
        self.model = self.optimizer = self.ema = self.ckpt = None
        self.train_loader = None
        self.evaluator = self.eval_model = None
        self._flops_per_frame: Optional[float] = None
        self.step_fn = None
        self.finetune_report: Optional[dict] = None
        self.last_losses: dict = {}

    # ------------------------------------------------------------------
    def train(self, batches: Optional[Iterable[Batch]] = None) -> None:
        self.before_train(batches)
        try:
            for self.epoch in range(self.start_epoch, self.max_epoch):
                self.before_epoch()
                if not self.train_in_iter():
                    break
                self.after_epoch()
        finally:
            self.after_train()

    def before_train(self, batches: Optional[Iterable[Batch]] = None) -> None:
        exp, args = self.exp, self.args
        self.logger.info("args: %s", vars(args))
        self.logger.info("exp value:\n%s", {
            k: v for k, v in vars(exp).items() if not k.startswith("_")})
        if batches is None:
            batch_size = getattr(args, "batch_size", None)
            if not batch_size:
                raise ValueError("Trainer.train() reads the exp's data "
                                 "loader: args.batch_size is needed")
            if batch_size % self.world_size:
                raise ValueError(f"the global batch {batch_size} does not "
                                 f"split over {self.world_size} processes")
            self.train_loader = exp.get_data_loader(
                batch_size=batch_size // self.world_size, training=True,
                pin_memory=self.device.type == "cuda")
            n_batches = max(len(self.train_loader.dataset) // batch_size, 1)
            source = ((b[0], b[1]) for b in self.train_loader)
        else:
            it = iter(_cycle(batches))
            first = next(it)
            batch_size = int(first[0].shape[0]) * self.world_size
            n_batches = len(batches) if hasattr(batches, "__len__") else None
            source = itertools.chain([first], it)
        # JAX trainer.py:116-118: the exp's count, else a pass over the data
        self.iters_per_epoch = (self.iters_per_epoch
                                or getattr(exp, "iters_per_epoch", None)
                                or n_batches)
        if not self.iters_per_epoch:
            raise ValueError("iters_per_epoch is needed for batches without "
                             "a length")
        self.batch_size = batch_size
        self._batches = DevicePrefetcher(source, self.device)

        self.model = exp.get_model(device=self.device, seed=exp.seed or 0,
                                   train=True)
        self.optimizer = exp.get_optimizer(self.model, batch_size,
                                           self.iters_per_epoch)
        self.ema = init_ema(self.model) if exp.ema else None
        self.ckpt = CheckpointManager(os.path.join(self.file_name, "ckpt"))
        # restore and fine-tune loads before any capture: a graph keeps
        # the optimizer state tensors it captured
        if getattr(args, "resume", False):
            step, self.best_ap = self.ckpt.restore(self.model,
                                                   self.optimizer, self.ema)
            self.start_epoch = step // self.iters_per_epoch
            self.logger.info("resumed at step %d (epoch %d), best_ap %.4f",
                             step, self.start_epoch, self.best_ap)
        elif getattr(args, "ckpt", None):
            report = load_partial_params(
                self.model, load_reference_state_dict(args.ckpt))
            if self.ema is not None:
                with torch.no_grad():
                    for n, p in self.model.named_parameters():
                        self.ema[n].copy_(p)
            self.logger.info("fine-tune init from %s: %s", args.ckpt, report)
            self.finetune_report = report
        broadcast_state(self.model, self.ema)
        if self.device.type == "cuda":
            self.step_fn = CapturedStep(self.model, self.optimizer, self.ema)
        else:
            self.step_fn = functools.partial(train_step, self.model,
                                             self.optimizer, self.ema)

        h, w = exp.input_size
        self._bin = (functools.partial(bin_event_batch, n_bins=exp.Tm,
                                       height=h, width=w)
                     if exp.device_binning else None)
        # multiscale: a bounded size set and one seeded choice every
        # multiscale_interval steps (JAX trainer.py:198-207)
        self._ms_interval = exp.multiscale_interval
        if self._ms_interval:
            r = exp.multiscale_range
            self._ms_sizes = [(h + 32 * k, w + 32 * k) for k in range(-r, r + 1)
                              if h + 32 * k > 0 and w + 32 * k > 0]
            self._ms_rng = np.random.default_rng(exp.seed or 0)
            self._ms_size = (h, w)
        # conv FLOPs a frame for the MFU (JAX trainer.py:208-220)
        self._flops_per_frame = 2.0 * conv_macs_per_frame(
            self.model, (1, exp.Tl, exp.Tm, h, w, exp.in_dim))
        self.logger.info("model: %.2f conv GFLOPs/frame",
                         self._flops_per_frame / 1e9)
        self.logger.info(
            "training %s on %s: batch %d (%d a process, %d processes), %d "
            "iters/epoch, epochs %d-%d, step %s", exp.exp_name, self.device,
            batch_size, batch_size // self.world_size, self.world_size,
            self.iters_per_epoch, self.start_epoch + 1, self.max_epoch,
            "captured as CUDA graphs" if isinstance(
                self.step_fn, CapturedStep) else "eager")

    def before_epoch(self) -> None:
        exp = self.exp
        if (exp.no_aug_epochs > 0 and not self.use_l1
                and self.epoch >= self.max_epoch - exp.no_aug_epochs):
            # reference trainer.py:228-241: the tail closes mosaic and adds
            # the L1 loss; the event datasets keep their per-sample
            # augmentation (JAX core/trainer.py:261-262). The loader's
            # workers are persistent forks: a dataset that changes here
            # must be read by a loader built after it.
            self.logger.info("--->no-aug phase: closing mosaic, adding L1")
            self.use_l1 = True
            ds = getattr(self.train_loader, "dataset", None)
            if hasattr(ds, "close_mosaic"):
                ds.close_mosaic()

    def _prepare(self, batch) -> Batch:
        """Device binning and the multiscale resize of a batch on the
        device."""
        frames, labels = batch
        if isinstance(frames, (tuple, list)):
            if self._bin is None:
                raise ValueError("the loader ships raw events but "
                                 "device_binning is off")
            frames = self._bin(*frames)
        if self._ms_interval:
            frames, labels = multiscale_resize(frames, labels, self._ms_size)
        return frames, labels

    def train_in_iter(self) -> bool:
        """One epoch; False when the batches ran out."""
        from torch.profiler import ProfilerActivity, profile

        profile_n = int(getattr(self.args, "profile", 0) or 0)
        # skip the steps that warm up (JAX: the compiling first step; here
        # the eager warm-up and the capture) where the epoch has more
        first = (CapturedStep.WARMUP + 1 if isinstance(
            self.step_fn, CapturedStep) else 1)
        profile_start = min(first, self.iters_per_epoch - 1)
        prof = None
        for it in range(self.iters_per_epoch):
            if profile_n and self.epoch == self.start_epoch:
                if it == profile_start and prof is None:
                    acts = [ProfilerActivity.CPU] + (
                        [ProfilerActivity.CUDA]
                        if self.device.type == "cuda" else [])
                    prof = profile(activities=acts)
                    prof.start()
                elif prof is not None and it == profile_start + profile_n:
                    self._stop_profile(prof, profile_n)
                    prof = None
            if self._ms_interval and it % self._ms_interval == 0:
                self._ms_size = self._ms_sizes[
                    int(self._ms_rng.integers(len(self._ms_sizes)))]
            t0 = time.perf_counter()
            batch = next(self._batches, None)
            t_data = time.perf_counter()
            if batch is None:
                self.logger.info("batches exhausted at epoch %d, iter %d",
                                 self.epoch + 1, it + 1)
                if prof is not None:
                    self._stop_profile(prof, profile_n)
                return False
            events, targets = self._prepare(batch)
            losses = self.step_fn(events, targets, use_l1=self.use_l1)
            self.progress_in_iter = self.epoch * self.iters_per_epoch + it
            if (it + 1) % self.exp.print_interval == 0:
                losses = {k: float(v) for k, v in losses.items()}
                self.meter.update(iter_time=time.perf_counter() - t0,
                                  data_time=t_data - t0,
                                  lr=learning_rate(self.optimizer), **losses)
                self._log_iter(it)
                self.tracker.log(updates(self.optimizer), losses)
            self.last_losses = losses
        if prof is not None:
            self._stop_profile(prof, profile_n)
        return True

    def _stop_profile(self, prof, n: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        path = os.path.join(self.file_name, "profile")
        os.makedirs(path, exist_ok=True)
        trace = os.path.join(path, f"trace_step{updates(self.optimizer)}.json")
        prof.export_chrome_trace(trace)
        self.logger.info("profiler trace (%d iters) -> %s", n, trace)

    def _log_iter(self, it: int) -> None:
        left = self.iters_per_epoch * self.max_epoch \
            - (self.progress_in_iter + 1)
        eta = datetime.timedelta(
            seconds=int(left * self.meter["iter_time"].avg))
        loss_str = ", ".join(f"{k}: {v.latest:.3f}"
                             for k, v in self.meter.items()
                             if "loss" in k or k == "num_fg")
        mem = (f"mem: {torch.cuda.max_memory_allocated() / 2**30:.1f}GiB, "
               if self.device.type == "cuda" else "")
        self.logger.info(
            "epoch: %d/%d, iter: %d/%d, %siter_time: %.3fs, data_time: "
            "%.3fs, %s%s, lr: %.3e, ETA: %s", self.epoch + 1, self.max_epoch,
            it + 1, self.iters_per_epoch, mem, self.meter["iter_time"].avg,
            self.meter["data_time"].avg, self._mfu_str(), loss_str,
            self.meter["lr"].latest, eta)

    def _mfu_str(self) -> str:
        """The MFU on the card against the H100's dense bf16 peak: a lower
        bound, conv FLOPs only and 3x the forward for forward + backward
        (JAX trainer.py:326-345)."""
        it_s = self.meter["iter_time"].avg
        if self.device.type != "cuda" or not self._flops_per_frame \
                or it_s <= 0:
            return ""
        mfu = 3.0 * self._flops_per_frame * self.batch_size / it_s \
            / PEAK_FLOPS / self.world_size
        return f"mfu (conv-only lower bound): {100 * mfu:.1f}%, "

    def after_epoch(self) -> None:
        is_best = ((self.epoch + 1) % self.exp.eval_interval == 0
                   and self.evaluate_and_save_model())
        path = self.ckpt.save(updates(self.optimizer), self.model,
                              self.optimizer, self.ema, self.best_ap,
                              is_best=is_best)
        if (is_best and self.rank == 0
                and os.environ.get("EAS_WANDB_ARTIFACTS", "0") == "1"):
            # the reference's opt-in (WandbLogger's log_checkpoints)
            self.tracker.log_artifact(self.ckpt.best_path, name="best_ckpt",
                                      kind="model")
        self.logger.info("epoch %d done: checkpoint %s%s", self.epoch + 1,
                         path, " (best)" if is_best else "")

    def _refresh_eval_model(self) -> torch.nn.Module:
        """The eval-mode model with the train state's buffers and the EMA
        parameters (the trained ones without EMA), built on first use. The
        train model is only read: its captured graphs replay fixed
        addresses."""
        if self.eval_model is None:
            self.eval_model = self.exp.get_model(
                device=self.device, seed=self.exp.seed or 0, train=False)
        with torch.no_grad():
            self.eval_model.load_state_dict(self.model.state_dict())
            if self.ema is not None:
                for n, p in self.eval_model.named_parameters():
                    p.copy_(self.ema[n])
        return self.eval_model

    def evaluate_and_save_model(self) -> bool:
        """Evaluate on the exp's map_val split; logs AP and AP50 and keeps
        the best AP. Returns whether this AP is a new best (the caller's
        checkpoint then also writes ``best.pth``)."""
        if self.evaluator is None:
            self.evaluator = self.exp.get_evaluator(
                batch_size=self.batch_size // self.world_size)
        ap, ap50, summary = self.exp.eval(self._refresh_eval_model(),
                                          self.evaluator)
        update_best = ap > self.best_ap
        self.best_ap = max(self.best_ap, ap)
        self.logger.info("epoch %d eval: AP=%.4f AP50=%.4f (best %.4f)\n%s",
                         self.epoch + 1, ap, ap50, self.best_ap, summary)
        self.tracker.log(updates(self.optimizer),
                         {"AP50_95": ap, "AP50": ap50}, split="val")
        self._log_pred_images()
        return update_best

    def _log_pred_images(self) -> None:
        """The eval model's detections (``exp.test_conf``, ``nmsthre``) on
        the first batch of the evaluator's loader, drawn by the tracker
        with the dataset's class names (ids where it has none; the JAX
        trainer asks its evaluator, which has none). Rank 0 only;
        ``EAS_LOG_PRED_IMAGES=0`` turns it off. A failure is logged and
        the run goes on: logging must never end a run (JAX
        ``core/trainer.py:405-432``)."""
        if self.rank != 0 or os.environ.get("EAS_LOG_PRED_IMAGES",
                                            "1") == "0":
            return
        try:
            loader = self.evaluator.dataloader
            frames = next(iter(loader))[0]
            with torch.inference_mode():
                out = self.eval_model(frames.to(self.device))
                out = out.float().cpu().numpy()
            dets = postprocess(out, self.exp.num_classes,
                               self.exp.test_conf, self.exp.nmsthre)
            names = (getattr(loader.dataset, "class_names", None)
                     or tuple(str(i) for i in range(self.exp.num_classes)))
            self.tracker.log_pred_images(updates(self.optimizer),
                                         frames.numpy(), dets,
                                         class_names=names)
        except Exception as e:  # logging must never end the run
            self.logger.info("pred-image logging skipped: %r", e,
                             exc_info=True)

    def after_train(self) -> None:
        if self.optimizer is not None:
            self.logger.info("training done at step %d, best AP: %.4f",
                             updates(self.optimizer), self.best_ap)
        self.tracker.close()
        if getattr(self.args, "grid_search", False):
            # grid-search CSV row (reference trainer.py:205-226)
            path = os.path.join(self.exp.output_dir, "grid_search.csv")
            with open(path, "a", newline="") as f:
                csv.writer(f).writerow(
                    [self.best_ap, self.file_name, " ".join(sys.argv)])
