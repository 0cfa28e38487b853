#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``eas_snn_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--batch 128] [--forwards 5] [--train-batch 64]
                          [--train-steps 8] [--workers 7]

Phases, each of which fails the run (exit code 1, no result line):

1. device: the card's name and power limit; the build, with each
   kernel's registers, spills and static shared memory from nvcc's
   ``-Xptxas=-v`` report;
2. kernels: builds the CUDA kernels from ``eas_snn_tpu_torch/csrc``, finds
   every geometry at which the flagship forward (SYOLOX-M, Gen1 256x320,
   T=3, deploy precision) calls each kernel, and there holds each kernel
   against its plain PyTorch version on seeded inputs, with the site's own
   weights. Tolerance: PLIF spikes bit-equal (both round after every f32
   operation); conv+PLIF spikes equal except where the plain version's
   membrane lies within 1e-4 of the threshold (the kernel and cuDNN sum
   the f32 preactivation in different orders). The firing rate must lie in
   1-99%. The PLIF kernel is called as its unfused site calls it (the
   neuron with its BN's kept eval terms) and must launch nothing else.
   Prints the wrapper's call time (CUDA events, back to back), the
   kernel's own device time (torch.profiler, by kernel name) with the
   other kernels a call launches, the plain version's time, the unfused
   chain's (cuDNN conv + BN + PLIF kernel), the bound and, for the wgmma
   kernels, the launch plan (wgmma width x output-channel chunks, grid,
   dynamic shared memory), then each kernel's sum a forward; then the
   PLIF kernel off the flagship's layouts (a ragged H*W in bf16 and f32,
   planes of three vectors, an unaligned x, T = 9), bit-equal;
2b. the wgmma kernels at every other spiking 1x1 and 3x3 site of the
   flagship forward, both strides (the sites the policy leaves on the
   unfused chain, the dark3-dark5 downsamples among them), called
   directly with no change to routing: held to the plain version with the
   tolerance of phase 2 and timed (call and kernel) against the chain; a
   site whose layout or weights the wrapper refuses is listed as refused,
   with the reason;
3. main path: ``get_exp("gen1_syolox_m").deploy().get_model("cuda")`` and
   ``detect`` on Poisson(0.2) events; frames/s, peak memory, detections,
   and the launch counts, which must be 35 / 8 / 6 / 1 per forward plus
   Tm of the whole-scan sampler kernel (``deploy()`` engages the fused
   sampler route on the card); the kernels line reports these counts;
   per-layer device ms and a profile of one forward; then the calls of
   rsqrt, sigmoid and rsub (the sites' eval constants) in one backbone
   forward, which only the 15 fused sites may make (the unfused sites keep
   theirs);
3b. sampler kernels: the whole-scan sampler kernel (kernel 5) against its
   plain version on the flagship's deploy events (bf16-rounded, B=128)
   with the model's own f32 sampler weights, and the per-step kernel
   (kernel 9) at the flagship step geometry in f32 and bf16 state, then
   both at small shapes (every readout, soft and hard reset, depth 1 and
   2, ksize 3, 5 and 7, H x W off the 32x32 tile, W a multiple of 4 or
   not). Tolerance: slots and every state output bit-equal (kernel 5's
   stencils are FMAs, which its plain version emulates exactly, in one
   order; every other operation is rounded on its own on both sides).
   Prints each kernel's call time (CUDA
   events) and own device time (torch.profiler), the plain version's, the
   bound (kernel 5's: its multiply-adds
   as FMAs, beside the floor of unfused ones) and the default sampler
   route's (the plain embedding: cuDNN convs and the eager chain);
3c. sampler routes: the plain and the fused route of the same deploy
   model through ``detect`` in turns (plain, fused, fused, plain): frames/s,
   peak memory, launches (35 / 8 / 6 / 1 a forward, plus Tm of kernel 5 on
   the fused route, never kernel 9), per-layer device ms and the idle share
   of one profiled forward of each; then the per-step route (v1, kernel 9)
   over the same events with the flagship sampler's conv stacks in f32
   (cuDNN), held to kernel 5's slots (V1_TOL), Tm launches a scan; then
   the Gen4 preset (gen4_rvt_syolox_m, 384x640, Tl=Tm=3): kernel 5
   against its plain version at its sampler geometry (B=16, N=48) and 3
   timed ``detect`` forwards with the fused route;
4. card against CPU: the same model in f32 at B=2 on the card (kernels)
   and on the CPU (plain versions): the sampler on the same events (the
   plain route, and the fused route: kernel 5 on the card, its plain
   version on the CPU), the analog stem, every spiking site, and the
   analog neck and head each on the input the card gave it, then the
   free-running forward's per-stage agreement and firing rates beside two
   chaos witnesses (the CPU against itself with the sampler's output, or
   every conv weight, moved up by one ulp);
5. train kernels: at every spiking site geometry of the flagship train
   step (B=64, bf16, found by hooks on the sites' neurons) the train PLIF
   forward (BN normalize fused, spikes in bf16) and backward (dx and the
   deterministic sums da, ds, db, dm) against their plain versions on
   random preactivations, BN terms (firing rate 5-95%) and cotangents.
   Tolerance: spikes and dx bit-equal (both round after every f32
   operation and divide exactly); each sum within SUM_TOL of the plain
   one relative to the largest magnitude of its vector (f32 sums taken in
   another order); a second backward on the same inputs must give the
   same bits (deterministic sums), and the backward must make one launch
   a call and no other. Also one identity-BN case (the backward of kernel
   1) and, at small shapes, the rect, sigmoid and tanh surrogates, f32
   storage and a ragged H*W (7x9) in bf16 and f32. Prints each kernel's
   call time (CUDA events) and own device time (torch.profiler), the
   plain version's, the bound and the backward's plan (items a thread,
   blocks, waves);
6. train step: ``get_exp("gen1_syolox_m").get_model("cuda", train=True)``
   (bf16 conv/BN, f32 sampler state) at B=64 on Poisson(0.2) events and
   labels of 1-8 random boxes, Adam (``fixed`` 1e-3) with EMA: 2 warm-up
   steps, then ``--train-steps`` timed ``train_step`` calls on the same
   batch: ms/step and images/s (host clock), the forward / backward /
   optimizer+EMA split of one more step (CUDA events), peak memory, the
   device idle share of one profiled step and the losses. Fails unless
   every loss and gradient is finite, the total loss falls from the first
   step to the last, and the train PLIF kernels launch exactly 50 + 50
   times a step (counted by the wrappers, and in the profiled step by
   kernel name);
6b. the step captured as CUDA graphs (``core/train_state.py:
   CapturedStep``: 3 eager warm-up steps a geometry, then one graph a
   geometry, all in one memory pool) against the eager step, at B=64 and
   B=8, in turns (eager, captured, captured, eager): ms/step and images/s
   over ``--train-steps`` steps, peak memory, the idle share of 3 profiled
   steps, and 50 + 50 train PLIF launches a step in those 3 steps, by
   kernel name (the profiler records the kernels of a replayed graph; the
   wrappers' counters do not see a replay). Then from one snapshot of the
   train state a captured step against an eager step, at 256x320 and at
   256x320 and 288x352 in turns through the shared pool (the PLIF
   backward's scratch buffer grows between them). Tolerance: the eager
   step's own difference from the same snapshot (0 on the H100: the
   captured step gives the eager step's bits);
7. the entry point: a synthetic Gen1 tree (4 streams, 128 label groups,
   500k events/s at 240x304) written with the port's writers;
   ``gen1_syolox_m`` at B=64 through the port's CLI parser
   (``tools/train_event.py:build``), ``exp.get_data_loader`` (``--workers``
   forked workers) and ``Trainer``: images/s with the loader in the loop
   over the last ``--train-steps`` captured steps (after the batches the
   workers had ready), the data-time share, a checkpoint, a second
   trainer with ``--resume`` that starts at the saved step and epoch and
   whose first 4 losses (3 eager, then its first replay) equal the first
   trainer's next 4 (replays; bit-equal, as 6b),
   a profiled window of 3 trainer steps (idle share), the loader alone
   (samples/s), the host ms a sample (``dataset.profile``); then 2 steps
   with device binning and ``--profile 1``, and that loader's samples/s
   and host ms a raw sample. The first trainer has a val split (1 stream,
   16 label groups) and ``eval_interval`` 1: its epoch end evaluates the
   EMA weights in its separate eval model between replays of the captured
   step; every parameter, buffer, Adam state and EMA tensor must keep its
   bits, ``best.pth`` and the val row of ``metrics.jsonl`` must be
   written, and the next replays' losses must be finite;
8. the eval entry point: a synthetic Gen1 val tree (the ap_drift writer,
   3 streams of 40 label groups at 240x304); the COCO and the Prophesee
   evaluator fed the ground truth as letterboxed predictions must give AP
   and AP50 1.0; ``gen1_syolox_m`` with calibrated random weights (saved,
   then loaded through ``-c``) through ``tools/eval_event.py:main`` with
   ``--fp16 -b 64`` from zeroed launch counts, which must be 35 / 8 / 6 /
   1 + Tm of kernel 5 a batch; the evaluator's split (frames/s with the
   loader in the loop, forward and NMS ms an image, the data-time share,
   the gather and matching seconds) on a first pass (workers starting)
   and a second one (warm workers, the same AP); the native matcher
   against the numpy one on the model's rows (equal stats); one profiled
   batch (the eval kernels by name); the ``--energy`` report (SOPs, dense
   MACs, mJ a frame);
9. N-Caltech101 (``ncaltech_syolox_m``: 640x640, 100 classes, atan at
   alpha 1.5): a synthetic tree written with the port's ``encode_atis``
   and annotation writer (100 classes and ``BACKGROUND_Google``, 5
   recordings each: 400 train and 100 val by the seeded split; 240x180,
   three saccades of 100 ms, 100k events a recording, one box each);
   (9a, 9b) phases 2 and 2b at the deploy forward's site geometries at
   B=32 (no site is in the TPU's fusion table at 640x640: all 50 take the
   PLIF kernel; the wgmma kernels are called directly at every 1x1 / 3x3
   site, refusals listed), then kernel 5 at (Tm 4, N 32, 640x640); (9c)
   phase 5's check at every train-step site geometry at B=32 with the
   preset's alpha 1.5 on both sides (9a-9c run in a process of their
   own: in the process that ran phases 2-8 the profiler recorded no
   launch of the PLIF kernels in most of their windows); (9d) ``tools/train_event.py``'s
   parser, loader and ``Trainer`` at B=32 (the reference's batch):
   images/s with the loader in the loop over ``--train-steps`` captured
   steps, the data-time share, peak and reserved memory, finite losses,
   50 + 50 train PLIF launches a step (the wrappers' counts over the
   warm-up and the capture, and by kernel name in 2 profiled replays);
   (9e) the COCO evaluator fed the ground truth over 100 classes (AP and
   AP50 1.0) and ``tools/eval_event.py --fp16 -b 32`` with calibrated
   random weights through ``-c``: 50 launches of the PLIF kernel + 4 of
   kernel 5 a batch, frames/s with the loader, forward and NMS ms;
10. 1Mpx: ``gen4_rvt_syolox_m`` with ``data_name gen4 Tl 1`` (the raw
   reader stacks Tl windows of Tm micro-frames for a label, while the
   model takes one window: Tm 3 stays) on a raw tree (720x1280 ``.dat``
   streams at 1M events/s, labels over all 7 classes that the reader
   filters to 3; 2 train streams of 16 label groups, 2 val streams of 12,
   250 ms apart); 4 captured steps at B=16 through the train CLI as 9d,
   then the Prophesee protocol (camera gen4) with the ground truth as
   predictions (AP 1.0) and ``tools/eval_event.py --fp16 --eval_proh -b
   16 --save_boxes`` (50 + 3 launches a batch); the port's
   ``tools/psee_evaluate_folders.py`` over both runs' box files must give
   the evaluator's AP and AP50;
11. the fully spiking Gen1 detector (``gen1_syolox_m`` with ``use_spike
   full_spike_v2``: spiking backbone, neck and head; 11a-11c and 11e in a
   process of their own, ``full_spike_phases``): (11a) phase 2 / 2b's
   checks at every neck and head site of the deploy forward at B=128
   (39 on row 1, 6 on row 2, 2 on row 3 by the policy; the wgmma kernels
   called directly at the others) and phase 5's at the 47 neck and head
   train sites at B=64; (11b) 10 ``detect`` forwards at B=128: frames/s,
   launches 74 / 14 / 8 / 1 + Tm a forward by the wrappers and by kernel
   name in a profiled forward, layer ms, and card against CPU stage by
   stage at B=2 (``stages_card_vs_cpu``: the embedding, the stem, every
   spiking site on the card's input, the head's predictions on the
   card's tower outputs); (11c) the step as CUDA graphs at B=64: 97 + 97
   train PLIF launches a step (the wrappers over the warm-up and the
   capture, by name in 3 profiled replays), eager and captured ms/step
   in turns, idle share, peak, and a captured step bit-equal to an eager
   one from one snapshot; (11d) the train CLI on a synthetic Gen1 tree,
   the eval CLI ``--fp16`` (the ground truth as predictions: AP 1.0;
   calibrated weights: 74 / 14 / 8 / 1 + Tm a batch) and ``--energy``
   against the backbone-only detector on the same weights (the spiking
   share of the conv work must grow); (11e) ``full_spike``: one deploy
   forward (60 / 13 / 8 / 1 + Tm) and one captured step (82 + 82);
12. the other variants: (12a) ``e_yolox_m`` (count embedding, analog
   YOLOX, 640x640, 100 classes, f32) through the train CLI at B=32 (which
   must turn TF32 off for the f32 preset) and the eval CLI on phase 9's
   N-Caltech101 tree: no
   hand-written kernel launched (the wrappers' counts, and by name in
   the profiled replays), AP 1.0 with the ground truth; (12b) the snn
   and rsnn embeddings, ``norm bn`` and ``spike_fn patan`` on
   ``gen1_syolox_m``'s widths at B=16: a captured step bit-equal to the
   eager step (patan: no launch of rows 7 and 8: it trains through the
   plain scan), a deploy forward's launches, and card against CPU stage
   by stage at B=2;
13. streaming detection (13a and 13b in a process of their own,
   ``streaming_phases``): (13a) phases 2 / 2b's checks at every site
   geometry of ``gen1_syolox_m``'s deploy forward at B=1 (35 / 8 / 6 / 1,
   refusals listed) and kernel 5 against its plain version at N=1;
   (13b) ``inference.StreamingDetector`` with calibrated weights on a
   synthetic Gen1 stream (the ap_drift writer, 240x304, 500k events/s):
   a detection every 100 ms over a 200 ms window, 100 ticks, captured, at
   ``max_events`` 65,536 and 262,144 (host ms, end-to-end ms p50 / p99,
   detections a second, peak memory, 100 replays of one graph); one
   eager detection's launches (35 / 8 / 6 / 1 + Tm) and a replay's by
   kernel name; eager and captured detection in turns, their outputs
   bit-equal and their ms; the re-read baseline
   (``tools/bench_streaming.py``, its forward captured as the stream's)
   and the ratios; the binned and letterboxed frames of the card
   bit-equal to the CPU's, and the
   streaming outputs bit-equal to the batch path's (host ``micro_sum``)
   on one window; (13c) ``create_model('syolox-s-gen1')`` and
   ``load_weights('syolox-s-gen1')`` on the card (430 mapped), captured
   detections with those weights, and ``tools/eval_event.py -f`` on a
   user exp file over phase 8's val tree (35 / 8 / 6 / 1 + Tm launches a
   batch); (13d, in 13b's process) the demo CLI
   (``tools/demo.py:main --fp16 -c``, weights with their BN calibrated on
   8 of the demo's own windows, saved as a ``.pth``) over 13b's stream at
   10 detections a second of stream time, 50 frames, with ``--conf`` the
   least over the frames of each frame's top score, so that every frame
   draws a box (the phase fails under 40 of 50):
   each frame's detections bit-equal to an eager ``StreamingDetector``'s
   of the same weights over the same ticks (the demo's own launches 3 x
   35 / 8 / 6 / 1 + Tm: two warm-up runs and the capture; the reference's
   one eager detection the same 1 x), every PNG read back by ``utils/png.py:read_png``
   equal to the frame drawn again in memory, ms a frame of detection,
   drawing and PNG writing, the demo's frames/s and the host ms of the
   stream's index search, a window's decode and its binning; then
   ``utils/assign_viz.py:visualize_assignments`` at ``gen1_syolox_m``'s
   full width, 256x320, B=2 with planted boxes: 50 launches of row 7 in
   its train-mode forward, a foreground anchor for every planted box,
   the images' shape and their PNGs;
14. training at scale, in two processes of their own: (14a,
   ``scale_phases``) ``ncaltech_syolox_m`` (bf16, 640x640) at B=32 as the
   captured step with remat off and on and the saved spike trains in
   bf16 or int8: peak allocated GiB and ms a step of each, every
   configuration's losses and end state (parameters, BN statistics, Adam,
   EMA) bit-equal to the plain one's under ``CapturedStep.cudnn_mode()``,
   the train PLIF launches 50 + 50 a plain step and 100 + 50 a remat step
   (the wrappers; by kernel name in a replay); ``e_yolox_m`` (f32) at
   B=32 with remat off and on, bit-equal; then the largest batch of 32,
   48, 64, 96, 128 that fits with remat and int8 (the first that does
   not ends the sweep); (14c, ``scale_dp_phases``) the capturable SGD's
   captured step bit-equal to its eager one at ``gen1_syolox_m`` B=64;
   (14b) an NCCL group of one process: the captured step with the group
   bit-equal to the one without from one snapshot, NCCL's kernels by
   name in a replay (one a collective: each BN site forward and
   backward, SimOTA's counts, the gradient bucket), ms a step with and
   without the group in turns, then the train CLI's ``main`` with the
   group on a Gen1 tree as phase 7 writes it, through captured steps and
   the evaluation's gather, whose first batch's prediction images
   (``<run dir>/pred_images/step*.png``) must decode with ``read_png``;
15. when every check passed, one ``{"kernels": [...]}`` line, the
   nvidia-smi line, and last ``{"ok": true, "device": {...}}``.

``determinism_cost`` (not run by ``main``) times the captured step with
cuDNN's deterministic algorithms on and off; ``nan_trace`` (not run by
``main``) traces ``e_yolox_m``'s first non-finite tensor on one repeated
batch.

Bounds use the H100 SXM's published peaks: 3.35 TB/s of HBM, 989 TFLOP/s
bf16 on the tensor cores, 67 TFLOP/s f32 outside them. TF32 is off for
every plain version and comparison (cuDNN would run f32 convs in TF32).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import os
import re
import subprocess
import sys
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

from eas_snn_tpu_torch.core.train_state import (init_ema, optimizer_update,
                                                train_step)
from eas_snn_tpu_torch.exp import detect, get_exp
from eas_snn_tpu_torch.models.blocks import PLIF, BaseConv
from eas_snn_tpu_torch.models.embedding import apply_stack, fold_time
from eas_snn_tpu_torch.ops import KERNEL_WRAPPERS, launch_counts, reset_launches
from eas_snn_tpu_torch.ops import _build
from eas_snn_tpu_torch.ops import arsnn_fused as af
from eas_snn_tpu_torch.ops import plif as plif_mod
from eas_snn_tpu_torch.ops import conv_plif as cp
from eas_snn_tpu_torch.ops.plif import (
    decay_multiplier, plif_bwd_plan, plif_forward, plif_forward_plain,
    plif_train_backward, plif_train_backward_plain, plif_train_forward,
    plif_train_forward_plain)
from eas_snn_tpu_torch.ops.surrogate import train_alpha

HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12
PLIF_OPS = 6          # f32 operations per element per step
BN_OPS = 3            # the eval BN folded into the PLIF kernel
SPIKE_TOL = 1e-4      # conv sites: flips allowed only this near threshold
SITE_TOL = 1e-4       # card vs CPU: share of a site's spikes that may flip
ANALOG_TOL = 1e-5     # card vs CPU: |card - cpu| / (1 + |cpu|), f32 analog
SUM_TOL = 1e-4        # train backward sums: |kernel - plain| / max|plain|
# v1 (cuDNN f32 convs) vs v2 (in-kernel stencils) on the same events: the
# share of slot values beyond 1e-5 relative (threshold ties of the
# recurrence flipped by the convs' summation order)
V1_TOL = 1e-4
SAMPLER_OPS = 20      # f32 operations per element and step of the chain
MIN_WRITTEN = 100     # non-zero slot values a sampler comparison must see
PER_FORWARD = {"plif_fwd": 35, "conv1x1_plif": 8, "conv3x3_plif": 6,
               "conv3x3s2_plif": 1}
# 384x640 (1Mpx) and 640x640 (N-Caltech101): no site geometry is in the
# TPU's fusion table (its keys are Gen1's), so all 50 spiking sites take
# the PLIF kernel
UNFUSED_PER_FORWARD = {"plif_fwd": 50}
GEN4_BATCH = 16
PER_STEP = {"plif_train_fwd": 50, "plif_train_bwd": 50}

KERNEL_INFO = {
    "plif_fwd": ("eas_snn_tpu_torch/csrc/plif.cu",
                 "eas_snn_tpu/ops/plif_pallas.py:302"),
    "conv1x1_plif": ("eas_snn_tpu_torch/csrc/conv_wgmma.cu",
                     "eas_snn_tpu/ops/conv_plif_pallas.py:155"),
    "conv3x3_plif": ("eas_snn_tpu_torch/csrc/conv_wgmma.cu",
                     "eas_snn_tpu/ops/conv_plif_pallas.py:359"),
    "conv3x3s2_plif": ("eas_snn_tpu_torch/csrc/conv_wgmma.cu",
                       "eas_snn_tpu/ops/conv_plif_pallas.py:581"),
    "plif_train_fwd": ("eas_snn_tpu_torch/csrc/plif.cu",
                       "eas_snn_tpu/ops/plif_pallas.py:389"),
    # with the identity BN terms it is also kernel 1's backward (:338)
    "plif_train_bwd": ("eas_snn_tpu_torch/csrc/plif_bwd.cu",
                       "eas_snn_tpu/ops/plif_pallas.py:419, "
                       "eas_snn_tpu/ops/plif_pallas.py:338"),
    "arsnn_v2": ("eas_snn_tpu_torch/csrc/arsnn_v2.cu",
                 "eas_snn_tpu/ops/arsnn_pallas.py:579"),
    "arsnn_step": ("eas_snn_tpu_torch/csrc/arsnn_step.cu",
                   "eas_snn_tpu/ops/arsnn_pallas.py:147"),
}
FAILURES = []
PTXAS_FLAGS = ("-Xptxas=-v",)  # added to the build's flags (phase 1)
DEV = "cuda"
SEED = 0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    FAILURES.append(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(e) -> float:
    """A profiler row's own device time in us (the attribute's name
    differs across torch versions)."""
    us = getattr(e, "self_device_time_total", None)
    return getattr(e, "self_cuda_time_total", 0) if us is None else us


def kernel_ms(fn, symbol: str, iters: int = 10, launches: int = 1):
    """The kernel's own device time a call of fn(), which launches it
    ``launches`` times: the mean device time of the launches of kernels
    whose name holds ``symbol`` that torch.profiler records over ``iters``
    calls (after two warm-up calls), times ``launches``. The profiler does
    not always record every launch of a short window (seen on the H100:
    6 of 10, once none), so the time is taken a launch, not a call, and a
    window that recorded no launch of the kernel is profiled again, at
    most three windows. Returns (ms, recorded launches a call, recorded
    launches of other kernels a call: the wrapper's side kernels)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us, n, side = 0.0, 0, 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            if symbol in e.key:
                us, n = us + _device_us(e), n + e.count
            else:
                side += e.count
        if n:
            return us / 1e3 / n * launches, n / iters, side / iters
        print(f"  (the profiler recorded no {symbol} launch in {iters} "
              "calls: profiled again)")
    fail(f"no {symbol} launch in three profiles: its time is not measured")
    return float("nan"), 0.0, side / iters


def host_ms(fn, iters: int = 20) -> float:
    """Host-clock ms a call of fn() takes to enqueue its work (no
    synchronize between calls): where it exceeds the kernel's time, the
    back-to-back call time is the host's."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / iters


def bound_ms(nbytes: float, tc_flops: float, f32_ops: float):
    """(bound in ms, 'bytes' or 'operations') for one call."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = tc_flops / BF16_TC_FLOPS + f32_ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def min_margin(pre: torch.Tensor, T: int, a: torch.Tensor, thresh: float
               ) -> torch.Tensor:
    """Smallest |v_t - thresh| over t of the PLIF recurrence on a (T*B, ...)
    f32 preactivation (atan: spike at >= 0), repeated over T."""
    xs = pre.reshape((T, -1) + tuple(pre.shape[1:]))
    v = torch.zeros_like(xs[0])
    m = torch.full_like(xs[0], float("inf"))
    for t in range(T):
        v = v * a + xs[t]
        d = v - thresh
        m = torch.minimum(m, d.abs())
        v = v - thresh * (d >= 0).float()
    return m.repeat((T,) + (1,) * (m.dim() - 1))


@torch.no_grad()
def calibrate_spiking_bn(model, events: torch.Tensor,
                         ann: bool = False) -> None:
    """Give a randomly initialised detector the BN statistics training
    would track: each spiking site's running mean and variance become the
    per-channel moments of its conv output on ``events`` (in forward
    order), with scale 1 and bias 0. Each site's preactivation is then
    about N(0, 1) per channel, so every stage fires (about 20%) whichever
    draw the weights came from; at the JAX init (identity BN) dark3-dark5
    of the flagship barely fire on Poisson(0.2) events. With ``ann`` the
    sites of SiLU neurons too: at the init their activations shrink
    stage by stage, so that the head's scores stay at its prior."""

    def hook(mod, args) -> None:
        x = args[0]
        x = torch.cat([p.float() for p in x], 1) \
            if isinstance(x, (tuple, list)) else x.float()
        y = F.conv2d(x, mod.weight.float(), stride=mod.stride,
                     padding=(mod.ksize - 1) // 2)
        mod.bn.running_mean.copy_(y.mean((0, 2, 3)))
        mod.bn.running_var.copy_(y.var((0, 2, 3), unbiased=False))
        mod.bn.weight.fill_(1.0)
        mod.bn.bias.fill_(0.0)

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BaseConv) and (ann or m.neuron.spiking)]
    model(events)
    for h in handles:
        h.remove()


def _kernel_name(mangled: str) -> str:
    """A mangled kernel name cut to its own name and template arguments:
    the first length-prefixed identifier ending in "kernel", and what
    follows it up to the parameter list."""
    for j in range(1, len(mangled)):
        if not (mangled[j - 1].isdigit() and not mangled[j].isdigit()):
            continue
        for k in (1, 2):
            if j - k >= 0 and mangled[j - k:j].isdigit():
                name = mangled[j:j + int(mangled[j - k:j])]
                if name.endswith("kernel") and "_cu_" not in name:
                    return name + mangled[j + len(name):].split("Ev")[0]
    return mangled


def print_ptxas(log: str) -> None:
    """One line a kernel from nvcc's -Xptxas=-v report: registers, spill
    stores / loads and static shared memory (the wgmma kernels' dynamic
    shared memory is the plan's, printed in phase 2), and every ptxas
    performance warning as it stands."""
    name = None
    for line in log.splitlines():
        if "Performance Loss" in line:  # e.g. wgmma serialized by ptxas
            print(f"  {line.strip()}")
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = _kernel_name(m.group(1)), "spills not reported"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = f"spill stores {m.group(1)}, loads {m.group(2)}"
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            print(f"  ptxas {name}: {m.group(1)} registers, {spills}, "
                  f"static smem {smem.group(1) if smem else 0}")
            name = None


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 2

def site_geometries(model, events, where=None):
    """Run one forward with pre-hooks on every spiking BaseConv (whose name
    ``where`` accepts, where given) and return
    ({key: [count, module, pieces' shapes, input dtype, kernel]}, where the
    kernel is the one the site launches (the PLIF kernel for an unfused
    site, whose input is then the conv+BN output), and the same for the
    unfused 1x1 and 3x3 sites with the wgmma kernel that would serve them
    and their conv inputs)."""
    sites = OrderedDict()
    others = OrderedDict()

    def hook(mod, args):
        x = args[0]
        pieces = tuple(x) if isinstance(x, (tuple, list)) else (x,)
        shapes = tuple(tuple(p.shape) for p in pieces)
        if not mod.fused(pieces) and mod.ksize in (1, 3):
            name = ("conv1x1_plif" if mod.ksize == 1 else
                    "conv3x3_plif" if mod.stride == 1 else "conv3x3s2_plif")
            key = (name, shapes, str(pieces[0].dtype), mod.weight.shape[0])
            if key not in others:
                others[key] = [0, mod, shapes, pieces[0].dtype, name]
            others[key][0] += 1
        if mod.fused(pieces):
            name = ("conv1x1_plif" if mod.ksize == 1 else
                    "conv3x3_plif" if mod.stride == 1 else "conv3x3s2_plif")
            dtype = pieces[0].dtype
        else:
            name = "plif_fwd"
            TB, _, H, W = shapes[0]
            ho, wo = (H - 1) // mod.stride + 1, (W - 1) // mod.stride + 1
            shapes = ((TB, mod.weight.shape[0], ho, wo),)
            dtype = mod.dtype
        key = (name, shapes, str(dtype), mod.weight.shape[0])
        if key not in sites:
            sites[key] = [0, mod, shapes, dtype, name]
        sites[key][0] += 1

    handles = [m.register_forward_pre_hook(hook)
               for n, m in model.named_modules()
               if isinstance(m, BaseConv) and m.neuron.spiking
               and (where is None or where(n))]
    feats = {}
    handles.append(model.backbone.backbone.register_forward_hook(
        lambda m, i, o: feats.update(o)))
    detect(model, events)
    for h in handles:
        h.remove()
    rates = {k: float(v.float().mean()) for k, v in feats.items()}
    print("  main path firing rates: " + ", ".join(
        f"{k} {v:.4f}" for k, v in rates.items()))
    for k, v in rates.items():
        if not 0.01 <= v <= 0.99:
            fail(f"main path {k} fires at {v:.4f}, outside 1-99%")
    return sites, others


def _site_inputs(shapes, dtype, gen):
    """Seeded inputs: Bernoulli(0.25) spikes for int8, N(0, 1) otherwise."""
    xs = []
    for shp in shapes:
        if dtype == torch.int8:
            x = (torch.rand(shp, device=DEV, generator=gen) < 0.25)
            xs.append(x.to(torch.int8))
        else:
            xs.append(torch.randn(shp, device=DEV, generator=gen).to(dtype))
    return xs


def check_plif_site(mod, shapes, dtype, gen):
    """The PLIF kernel with the site's BN folded in, on conv outputs drawn
    so that the BN output is about N(0.6, 1), called as the unfused site
    calls it (its neuron with its BN's eval terms: both kept on the site,
    so a call launches the kernel and nothing else)."""
    T, th, kind = mod.neuron.T, mod.neuron.thresh, mod.act.kind
    bn = mod.bn.eval_terms()
    mean, mul, bias = (p.reshape(1, -1, 1, 1) for p in bn)
    z = torch.randn(shapes[0], device=DEV, generator=gen) + 0.6
    x = ((z - bias) / mul + mean).to(dtype)
    w = mod.act.w
    run = lambda: mod.act(x, bn=mod.bn.eval_terms())  # noqa: E731
    got = run()
    want = plif_forward_plain(x, T, w, th, kind, bn=bn)
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    res = dict(mismatch=mism, allowed=0, rate=float(want.float().mean()),
               max_abs_err=float((got.float() - want.float()).abs().max()))
    if mism:
        fail(f"plif_fwd at {shapes[0]}: {mism} spikes differ (bit-equal "
             "expected)")
    res["ms"] = cuda_ms(run, 20)
    res["kernel_ms"], _, res["side"] = kernel_ms(run, "plif_fwd_kernel")
    if res["side"]:
        fail(f"plif_fwd at {shapes[0]}: the site launches {res['side']} "
             "other kernels a call (its eval constants are kept: none "
             "expected)")
    res["plain_ms"] = cuda_ms(
        lambda: plif_forward_plain(x, T, w, th, kind, bn=bn), 3, warmup=1)
    # yardstick: a PyTorch pass that moves the same bytes (x read, one
    # byte an element written): what the card gives this byte pattern
    out1 = torch.empty(x.shape, dtype=torch.bool, device=DEV)
    res["same_bytes_ms"] = cuda_ms(lambda: torch.ge(x, 0.0, out=out1), 20)
    n = x.numel()
    res["bound_ms"], res["bound_by"] = bound_ms(
        n * (x.element_size() + 1) + 12 * x.shape[1] + 4, 0.0,
        (PLIF_OPS + BN_OPS) * n)
    res["chain_ms"] = None
    return res


def check_conv_site(name, mod, shapes, dtype, gen):
    T, th, kind = mod.neuron.T, mod.neuron.thresh, mod.act.kind
    xs = _site_inputs(shapes, dtype, gen)
    mul, bias_f = mod.bn.fold()
    w_plif = mod.act.w
    a = decay_multiplier(w_plif)
    if name == "conv1x1_plif":
        wf = cp.fold_conv1x1(mod.weight, mul)
        run = lambda: cp.conv1x1_plif(xs, wf, bias_f, T, w_plif, th, kind)
        pre = cp.conv1x1_preact_plain(xs, wf, bias_f)
        plain = lambda: cp.conv1x1_plif_plain(xs, wf, bias_f, T, w_plif, th,
                                              kind)
    else:
        wf = cp.fold_conv3x3(mod.weight, mul)
        op = cp.conv3x3_plif if name == "conv3x3_plif" else cp.conv3x3s2_plif
        run = lambda: op(xs[0], wf, bias_f, T, w_plif, th, kind)
        pre = cp.conv3x3_preact_plain(xs[0], wf, bias_f, mod.stride)
        plain = lambda: cp.conv3x3_plif_plain(xs[0], wf, bias_f, T, w_plif,
                                              mod.stride, th, kind)
    got = run()
    want = plif_forward_plain(pre, T, w_plif, th, kind)
    margin = min_margin(pre, T, a, th)
    torch.cuda.synchronize()
    diff = got != want
    mism = int(diff.sum())
    bad = int((diff & (margin >= SPIKE_TOL)).sum())
    res = dict(mismatch=mism, allowed=mism - bad,
               rate=float(want.float().mean()),
               max_abs_err=float((got.float() - want.float()).abs().max()))
    if bad:
        fail(f"{name} at {shapes}: {bad} spikes differ away from the "
             "threshold")
    del pre, margin, want, got
    res["ms"] = cuda_ms(run, 10)
    res["kernel_ms"], _, res["side"] = kernel_ms(run, "conv_wgmma_kernel")
    res["plain_ms"] = cuda_ms(plain, 3, warmup=1)
    # the unfused chain this site would otherwise run: cuDNN conv in the
    # compute dtype, BN, then the PLIF kernel
    neuron = mod.neuron
    mod.neuron = neuron._replace(fuse="never")
    arg = tuple(xs) if len(xs) > 1 else xs[0]
    res["chain_ms"] = cuda_ms(lambda: mod(arg), 10)
    mod.neuron = neuron
    TB, _, H, W = shapes[0]
    cin = sum(s[1] for s in shapes)
    cout = mod.weight.shape[0]
    ho, wo = (H - 1) // mod.stride + 1, (W - 1) // mod.stride + 1
    n_out = TB * cout * ho * wo
    k = mod.ksize
    nbytes = (sum(x.numel() * x.element_size() for x in xs)
              + wf.numel() * 2 + cout * 4 + 4 + n_out)
    res["bound_ms"], res["bound_by"] = bound_ms(
        nbytes, 2.0 * n_out * cin * k * k, PLIF_OPS * n_out)
    plan = cp.conv_plan(k, tuple(s[1] for s in shapes), cout, TB // T, H, W,
                        xs[0].element_size(), _build.sm_count(xs[0].device),
                        mod.stride)
    res["plan"] = (f"N{plan.width}x{plan.n_chunks} grid "
                   f"{plan.grid_x}x{plan.n_chunks} smem {plan.smem}")
    return res


def _print_site(name, count, shapes, dtype, r):
    chain = "-" if r["chain_ms"] is None else f"{r['chain_ms']:8.4f}"
    shp = "+".join("x".join(map(str, s)) for s in shapes)
    print(f"  {name:15s} {count:3d} {shp:34s} {str(dtype)[6:]:9s} "
          f"{r['rate']:6.3f} {r['mismatch']:5d} {r['ms']:8.4f} "
          f"{r['kernel_ms']:8.4f} {r['side']:4.0f} "
          f"{r['plain_ms']:8.4f} {chain:>8s} {r['bound_ms']:8.4f} "
          f"{r['bound_by']}" + (f"  {r['plan']}" if "plan" in r else ""),
          flush=True)
    if r["allowed"]:
        print(f"    {r['allowed']} spikes differ within {SPIKE_TOL} of "
              "the threshold (allowed)")


def phase_other_sites(others, gen, phase: str = "2b") -> list:
    """The wgmma kernels called directly at every other spiking 1x1 and
    3x3 site of the forward, both strides (the sites the TPU's policy
    leaves on the unfused chain), with no change to routing: held to the
    plain version like the fused sites, timed against the chain. A site
    whose layout or weights the wrapper refuses is listed as refused, with
    the reason. Returns the refusals (kernel, count, shapes, reason)."""
    print(f"phase {phase}: the wgmma kernels at the unfused 1x1 / 3x3 / 3x3 "
          "stride-2 sites (called directly; the forward keeps the chain "
          "there)")
    refused = []
    for (name, *_), (count, mod, shapes, dtype, _) in others.items():
        try:
            r = check_conv_site(name, mod, shapes, dtype, gen)
        except ValueError as e:
            shp = "+".join("x".join(map(str, s)) for s in shapes)
            print(f"  {name:15s} {count:3d} {shp:34s} refused: {e}")
            refused.append((name, count, shapes, str(e)))
            continue
        _print_site(name, count, shapes, dtype, r)
    return refused


def phase_kernels(model, events, seed, expect=PER_FORWARD, phase="2",
                  what="flagship", extras=True, sites_phase="2b",
                  where=None):
    """Each eval kernel against its plain version at every site geometry
    of ``model``'s forward on ``events`` (the sites whose name ``where``
    accepts, where given), which must send ``expect`` sites to each
    kernel; then the PLIF kernel off those layouts (with ``extras``) and
    the wgmma kernels at the unfused sites. Returns the per-kernel sums a
    forward and the wgmma refusals."""
    sites, others = site_geometries(model, events, where)
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    per_kernel = {n: dict(ms=0.0, kernel_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                          chain_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                          max_abs_err=0.0, sites=0, same_bytes_ms=0.0)
                  for n in PER_FORWARD}
    print(f"phase {phase}: kernel vs plain at every {what} site geometry "
          "(times in ms per call: ms = the wrapper's call, CUDA events "
          "back to back; kernel = the kernel's own device time, "
          "torch.profiler; side = other kernels a call)")
    print(f"  {'kernel':15s} {'x':>3s} {'input':34s} {'dtype':9s} "
          f"{'rate':>6s} {'mism':>5s} {'ms':>8s} {'kernel':>8s} "
          f"{'side':>4s} {'plain':>8s} {'chain':>8s} {'bound':>8s} by")
    for (name, *_), (count, mod, shapes, dtype, _) in sites.items():
        if name == "plif_fwd":
            r = check_plif_site(mod, shapes, dtype, gen)
        else:
            r = check_conv_site(name, mod, shapes, dtype, gen)
        if not 0.01 <= r["rate"] <= 0.99:
            fail(f"{name} at {shapes}: firing rate {r['rate']:.4f} outside "
                 "1-99%")
        _print_site(name, count, shapes, dtype, r)
        agg = per_kernel[name]
        agg["sites"] += count
        agg["max_abs_err"] = max(agg["max_abs_err"], r["max_abs_err"])
        for key in ("ms", "kernel_ms", "plain_ms", "bound_ms", "chain_ms",
                    "same_bytes_ms"):
            agg[key] += count * (r.get(key) or 0.0)
        agg["bytes_ms" if r["bound_by"] == "bytes" else "ops_ms"] += (
            count * r["bound_ms"])
    for name, agg in per_kernel.items():
        if agg["sites"] != expect.get(name, 0):
            fail(f"{name}: {agg['sites']} sites found in the {what} "
                 f"forward, expected {expect.get(name, 0)}")
    for name, agg in per_kernel.items():
        if not agg["sites"]:
            continue
        chain = (f", unfused chain {agg['chain_ms']:.4f}"
                 if name != "plif_fwd" else
                 f", torch.ge of x into a bool tensor (the same bytes) "
                 f"{agg['same_bytes_ms']:.4f}")
        print(f"  {name}: {agg['ms']:.4f} ms a forward over its "
              f"{agg['sites']} sites (kernel {agg['kernel_ms']:.4f}){chain}, "
              f"bound {agg['bound_ms']:.4f}")
    if extras:
        plif_ragged_cases(gen)
    return per_kernel, phase_other_sites(others, gen, sites_phase)


def plif_ragged_cases(gen) -> None:
    """The PLIF kernel off the flagship's layouts, bit-equal to its plain
    version: a ragged H*W (7x9: the scalar tail) in bf16 and f32, planes
    of three 16-byte vectors (4x6 bf16), an x off 16-byte alignment (the
    scalar tail again), and T = 9 (the looped steps)."""
    worst = 0
    cases = (((3, 4, 16, 7, 9), torch.bfloat16, False),
             ((3, 4, 16, 7, 9), torch.float32, False),
             ((3, 4, 16, 4, 6), torch.bfloat16, False),
             ((3, 4, 16, 8, 8), torch.bfloat16, True),
             ((9, 2, 16, 8, 8), torch.bfloat16, False))
    for (T, B, C, H, W), dt, shifted in cases:
        n = T * B * C * H * W
        buf = (torch.randn(n + 1, device=DEV, generator=gen) + 0.6).to(dt)
        x = (buf[1:] if shifted else buf[:n]).view(T * B, C, H, W)
        bn = (0.2 * torch.randn(C, device=DEV, generator=gen),
              0.5 + torch.rand(C, device=DEV, generator=gen),
              0.1 * torch.randn(C, device=DEV, generator=gen))
        w = torch.tensor(-0.3, device=DEV)
        got = plif_forward(x, T, w, bn=bn)
        want = plif_forward_plain(x, T, w, bn=bn)
        torch.cuda.synchronize()
        worst = max(worst, int((got != want).sum()))
        rate = float(want.float().mean())
        if not 0.05 <= rate <= 0.95:
            fail(f"plif_fwd ragged case {(T, B, C, H, W)}: firing rate "
                 f"{rate:.4f} outside 5-95%")
    print(f"  plif_fwd off the flagship layouts (7x9 bf16 and f32, 4x6 bf16, "
          f"unaligned x, T=9): worst {worst} spikes differ")
    if worst:
        fail("plif_fwd off the flagship layouts: spikes differ (bit-equal "
             "expected)")


# ---------------------------------------------------------------- phase 3

def per_forward(v2_launches: int, base=PER_FORWARD) -> dict:
    """Launches a forward must make: ``base``, plus ``v2_launches`` of
    kernel 5 (Tm where the sampler must take the whole-scan route, else
    0), fixed by the caller and not read off the routing under test."""
    want = {k: base.get(k, 0) for k in KERNEL_WRAPPERS}
    want["arsnn_v2"] = v2_launches
    return want


def run_detect(exp, model, batches):
    """detect() over the batches from zeroed counts: (frames/s, counts,
    peak GiB, detections)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    dets = []
    for ev in batches:
        dets += exp.detect(model, ev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    frames = sum(int(b.shape[0] * b.shape[1]) for b in batches)
    return (frames / dt, counts, torch.cuda.max_memory_allocated() / 2**30,
            dets, dt)


def check_counts(what, counts, forwards: int, v2_launches: int,
                 base=PER_FORWARD) -> None:
    want = {k: v * forwards
            for k, v in per_forward(v2_launches, base).items()}
    if counts != want:
        fail(f"{what}: launch counts {counts}, expected {want}")


def phase_main_path(exp, model, batches):
    print(f"phase 3: main path, {len(batches)} forwards at B="
          f"{batches[0].shape[0]} (detect: forward, filter, NMS; sampler "
          f"route '{model.embedding.route(sampler_events(model, batches[0]))}'"
          f", fused_sampler='{exp.fused_sampler}')")
    fps, counts, peak, dets, dt = run_detect(exp, model, batches)
    n_det = [0 if d is None else len(d) for d in dets]
    print(f"  frames/s {fps:.2f} (host clock, {len(dets)} frames in "
          f"{dt:.4f} s), peak memory {peak:.3f} GiB")
    print(f"  detections per image: mean {np.mean(n_det):.2f}, max "
          f"{max(n_det)}; launches {counts}")
    for d in dets:
        if d is not None and not np.isfinite(d).all():
            fail("non-finite detections")
            break
    # deploy() sets fused_sampler='auto' (the route measured faster on the
    # card, PERF.md), so on CUDA events every forward runs kernel 5 once a
    # micro-step
    check_counts("main path", counts, len(batches), exp.Tm)
    layer_times(model, batches[0])
    ms, n = profiled_total(profile_call(lambda: model(batches[0]),
                                        "one forward"), "plif_fwd_kernel")
    print(f"  plif_fwd_kernel in the profiled forward: {ms:.4f} ms over {n} "
          "launches (phase 2's kernel ms: the sites' kernels timed apart)")
    constant_ops(model, batches[0])
    return counts


CONSTANT_OPS = ("aten::rsqrt", "aten::sigmoid", "aten::rsub")


def constant_ops(model, events) -> None:
    """Calls of the ops that make a spiking site's eval constants (the BN's
    rsqrt, the decay's sigmoid and 1 - s) in one backbone forward, from
    torch.profiler's operator rows. The unfused sites keep theirs
    (models/blocks.py: BatchNorm.eval_terms, PLIF.decay), so only the
    fused sites' own weight folding may call them: at most once each a
    fused site."""
    from torch.profiler import ProfilerActivity, profile
    seen = {}
    bb = model.backbone.backbone
    h = bb.register_forward_pre_hook(lambda m, i: seen.update(x=i[0]))
    model(events)
    h.remove()
    bb(seen["x"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bb(seen["x"])
        torch.cuda.synchronize()
    calls = {k: 0 for k in CONSTANT_OPS}
    for e in prof.key_averages():
        if e.key in calls:
            calls[e.key] += e.count
    fused = sum(v for k, v in PER_FORWARD.items() if k != "plif_fwd")
    print(f"  eval constants in one backbone forward: " + ", ".join(
        f"{k} {v}" for k, v in calls.items()) + f" (at most {fused}: the "
        f"fused sites fold theirs a call; the {PER_FORWARD['plif_fwd']} "
        "unfused sites keep theirs)")
    if any(v > fused for v in calls.values()):
        fail(f"backbone forward: constant ops {calls}, at most {fused} each "
             "expected")


def layer_times(model, events) -> None:
    """Device ms of each layer of one forward, from CUDA events recorded
    by hooks around the sampler, the backbone, the whole PAFPN and the
    head (the neck is the PAFPN minus its backbone)."""
    mods = {"sampler": model.embedding, "backbone": model.backbone.backbone,
            "pafpn": model.backbone, "head": model.head}
    ev, handles = {}, []
    for name, mod in mods.items():
        ev[name] = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        handles.append(mod.register_forward_pre_hook(
            lambda m, i, e=ev[name]: e[0].record()))
        handles.append(mod.register_forward_hook(
            lambda m, i, o, e=ev[name]: e[1].record()))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    model(events)
    end.record()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    ms = {k: e[0].elapsed_time(e[1]) for k, e in ev.items()}
    ms["neck"] = ms.pop("pafpn") - ms["backbone"]
    print(f"  layers of one forward (device ms, CUDA events): total "
          f"{start.elapsed_time(end):.3f}; " + ", ".join(
              f"{k} {ms[k]:.3f}" for k in ("sampler", "backbone", "neck",
                                           "head")))


def profile_call(fn, what: str, top: int = 14) -> list:
    """One call of fn() under torch.profiler: device time by kernel, and
    the device's busy share of the call's host-clock window. Returns the
    rows (ms, launches, kernel name), longest first."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # operator rows would count their kernels again
        us = _device_us(e)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        print(f"  profile of {what}: no device time recorded (not measured)")
        return rows
    print(f"  profile of {what}: device busy {busy:.3f} ms of "
          f"{wall_ms:.3f} ms host-clock window (idle share "
          f"{1 - busy / wall_ms:.3f}, profiler on); top kernels:")
    for ms, n, key in rows[:top]:
        print(f"    {ms:9.3f} ms {n:5d}x  {key[:90]}")
    return rows


def profiled_total(rows, symbol: str):
    """(ms, launches) of the kernels in ``profile_call``'s rows whose name
    holds ``symbol``."""
    hits = [(ms, n) for ms, n, key in rows if symbol in key]
    return sum(ms for ms, _ in hits), sum(n for _, n in hits)


# ------------------------------------------------------ sampler kernels

def sampler_events(model, events: torch.Tensor) -> torch.Tensor:
    """The (Tm, N, 2, H, W) events the embedding hands a sampler kernel:
    time-reversed, in its state dtype, contiguous."""
    emb = model.embedding
    ev = fold_time(events).permute(0, 1, 4, 2, 3)
    if emb.state_dtype is not None:
        ev = ev.to(emb.state_dtype)
    return ev.contiguous()


def _mismatch(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose bits differ (or values, for integer tensors)."""
    if a.dtype.is_floating_point:
        return int((_bits(a) != _bits(b)).sum())
    return int((a != b).sum())


def v2_bound(ev, Ts: int, depth: int, k: int, nw: int, fused: bool = True):
    """Bound of one whole-scan call: the events read and the slots written
    once; the stencil multiply-adds the scan needs (the input stack at
    every step, the gate stack at all but t = 0, where it sees no spikes
    and its output is its biases' alone) as FMAs (2 flops each at the f32
    rate: one instruction), or with ``fused`` False as the unfused floor (a
    multiply and an add, two instructions each at that rate); SAMPLER_OPS
    a state element and step, in f32."""
    Tm, N, Cin, H, W = ev.shape
    px = N * H * W
    inner = (depth - 1) * 16  # a 4 -> 4 layer
    macs = px * k * k * (Tm * (Cin * 4 + inner) + (Tm - 1) * (2 * 4 + inner))
    nbytes = ev.numel() * ev.element_size() + Ts * N * 2 * H * W * 4 + 4 * nw
    return bound_ms(nbytes, 0.0, (2 if fused else 4) * macs
                    + SAMPLER_OPS * 2 * px * Tm)


def check_v2(what, ev, iw, gw, kw, timed=False):
    """Kernel 5 against its plain version: slots bit-equal. At least
    MIN_WRITTEN slot values must be non-zero (the comparison must see
    written slots), unless a hard reset zeroes the 'last' readout of every
    spiking element (then only residuals are)."""
    got = af.arsnn_fused_v2(ev, iw, gw, **kw)
    want = af.arsnn_fused_v2_plain(ev, iw, gw, **kw)
    torch.cuda.synchronize()
    res = dict(mismatch=_mismatch(got, want), n=got.numel(),
               max_abs_err=float((got - want).abs().max()),
               written=float((want != 0).float().mean()),
               n_written=int((want != 0).sum()))
    if res["mismatch"] or not torch.isfinite(got).all():
        fail(f"arsnn_v2 {what}: {res['mismatch']} of {res['n']} slot values "
             "differ from the plain version (bit-equal expected)")
    if res["n_written"] < MIN_WRITTEN and (kw["readout"], kw["vreset"]) != (
            "last", 0.0):
        fail(f"arsnn_v2 {what}: only {res['n_written']} slot values are "
             "non-zero")
    if timed:
        del got, want
        res["ms"] = cuda_ms(lambda: af.arsnn_fused_v2(ev, iw, gw, **kw), 5)
        res["kernel_ms"], _, _ = kernel_ms(
            lambda: af.arsnn_fused_v2(ev, iw, gw, **kw), "arsnn_v2_kernel", 3,
            launches=ev.shape[0])
        res["plain_ms"] = cuda_ms(
            lambda: af.arsnn_fused_v2_plain(ev, iw, gw, **kw), 1, warmup=1)
        nw = sum(w.numel() + b.numel() for w, b in iw + gw)
        geo = (ev, kw["Ts"], len(iw), iw[0][0].shape[-1], nw)
        res["bound_ms"], res["bound_by"] = v2_bound(*geo)
        res["unfused_ms"] = v2_bound(*geo, fused=False)[0]
    return res


def default_route_ms(model, events) -> float:
    """Device ms of the plain sampler route (cuDNN convs, the eager chain)
    on the model's own events, the yardstick of both sampler kernels."""
    emb = model.embedding
    old, emb.fused_sampler = emb.fused_sampler, "never"
    ms = cuda_ms(lambda: emb(events), 3)
    emb.fused_sampler = old
    return ms


def cuda_ms_each(prepare, fn, iters: int = 10) -> float:
    """Mean device time of fn() over calls that each start from state that
    prepare() restores (CUDA events around each call alone)."""
    times = []
    for i in range(iters + 1):
        prepare()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in times[1:]]))


def step_case(shape, dtype, gen, Ts=3, t=2, readout="sum", vreset=None,
              attach=False, timed=False):
    """Kernel 9 against its plain version on seeded state: every output
    bit-equal. The four gate/current planes are channel slices of one
    (N, 2C, H, W) conv output and one recurrent output, as the v1 scan
    passes them."""
    N, C, H, W = shape
    dev = dict(device=DEV)
    rn = lambda *s: torch.randn(s, generator=gen, **dev)  # noqa: E731
    inp = (rn(N, 2 * C, H, W) * 1.5 + torch.tensor(
        [0.0] * C + [0.8] * C, **dev).reshape(1, -1, 1, 1)).to(dtype)
    rec = (rn(N, 2 * C, H, W) * 1.0).to(dtype)
    planes = (inp[:, :C], rec[:, :C], inp[:, C:], rec[:, C:])
    state0 = ((rn(*shape) + 0.5).to(dtype), (rn(*shape) * 2).to(dtype),
              torch.randint(0, Ts + 1, shape, generator=gen, **dev).to(
                  torch.int8),
              torch.randint(-1, t, shape, generator=gen, **dev).to(torch.int8),
              (rn(Ts, *shape) * 0.5).to(dtype))
    kw = dict(Ts=Ts, thresh=1.0, vreset=vreset, readout=readout,
              spike_attach=attach)
    state = [x.clone() for x in state0]
    got = af.fused_step(t, *planes, *state, **kw)
    want = af.fused_step_plain(t, *planes, *state0, **kw)
    torch.cuda.synchronize()
    names = ("vmem", "vavg", "spike", "seg", "tlast", "agg")
    mism = {n: _mismatch(g, w) for n, g, w in zip(names, got, want)}
    res = dict(mismatch=sum(mism.values()), rate=float(want[2].float().mean()),
               max_abs_err=max(float((g.float() - w.float()).abs().max())
                               for g, w in zip(got, want)),
               valid=int((want[3] != state0[2]).sum()))
    what = f"arsnn_step at {tuple(shape)} {str(dtype)[6:]} {readout}"
    if res["mismatch"]:
        fail(f"{what}: outputs differ from the plain version {mism} "
             "(bit-equal expected)")
    if not 0.05 <= res["rate"] <= 0.95:
        fail(f"{what}: firing rate {res['rate']:.4f} outside 5-95%")
    if timed:
        del got, want

        def restore():
            for x, x0 in zip(state, state0):
                x.copy_(x0)

        res["ms"] = cuda_ms_each(
            restore, lambda: af.fused_step(t, *planes, *state, **kw))
        res["kernel_ms"], _, _ = kernel_ms(
            lambda: (restore(), af.fused_step(t, *planes, *state, **kw)),
            "arsnn_step_kernel")
        res["plain_ms"] = cuda_ms(lambda: af.fused_step_plain(
            t, *planes, *state0, **kw), 3, warmup=1)
        M, es = N * C * H * W, inp.element_size()
        # read 4 planes, vmem, vavg, seg, tlast; write vmem, vavg, spike,
        # seg, tlast; one slot element read and written where valid
        nbytes = M * (9 * es + 4) + res["valid"] * 2 * es
        res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 0.0,
                                                    SAMPLER_OPS * M)
    return res


@torch.no_grad()
def phase_sampler_kernels(model, events, seed):
    """Kernels 5 and 9 against their plain versions (phase 3b)."""
    emb = model.embedding
    print("phase 3b: sampler kernels vs plain (ms a call)")
    gen = torch.Generator(device=DEV).manual_seed(seed + 4)
    ev = sampler_events(model, events)
    iw, gw = emb.stack_weights()
    kw = emb.scan_kwargs()
    out = {}
    r = check_v2("at the flagship", ev, iw, gw, kw, timed=True)
    r["default_ms"] = default_route_ms(model, events)
    print(f"  arsnn_v2 flagship events {tuple(ev.shape)} {str(ev.dtype)[6:]}, "
          f"depth {len(iw)} k {iw[0][0].shape[-1]}: {r['mismatch']} of "
          f"{r['n']} slots differ, {r['written']:.3f} non-zero; call "
          f"{r['ms']:.4f} ms (kernel {r['kernel_ms']:.4f}), plain "
          f"{r['plain_ms']:.4f}, bound "
          f"{r['bound_ms']:.4f} ({r['bound_by']}: the multiply-adds as "
          f"FMAs; unfused floor {r['unfused_ms']:.4f}); default route "
          f"(plain embedding: cuDNN convs + eager chain) "
          f"{r['default_ms']:.4f} ms", flush=True)
    out["arsnn_v2"] = r
    # small shapes: every readout, both resets, depth 1-2, k 3-7, H x W
    # off the 32x32 tile, f32 and bf16 events
    cases = (("sum", None, True, False, 2, 3, torch.float32),
             ("last", 0.0, False, True, 2, 5, torch.bfloat16),
             ("avg", None, True, True, 1, 7, torch.float32),
             ("avg", 0.0, False, False, 2, 7, torch.float32),
             ("sum", 0.0, False, True, 1, 5, torch.bfloat16),
             ("last", None, True, False, 1, 3, torch.float32))
    # at 40x45 the state moves pixel by pixel, at 40x44 as vectors (and
    # through shared memory at depth 2)
    worst = 0
    for W in (45, 44):
        for readout, vreset, wz, use_abs, depth, k, dt in cases:
            dims = [(2, 4)] + [(4, 4)] * (depth - 1)
            ws = [[(torch.randn(co, ci, k, k, generator=gen, device=DEV)
                    * 0.4, torch.randn(co, generator=gen, device=DEV) * 0.1)
                   for ci, co in dims] for _ in range(2)]
            evs = (torch.randn((4, 3, 2, 40, W), generator=gen, device=DEV)
                   * 2).to(dt)
            rr = check_v2(f"{readout} depth {depth} k {k} at 40x{W}", evs,
                          *ws, dict(Ts=3, thresh=1.0, vreset=vreset,
                                    readout=readout, spike_attach=True,
                                    write_zero=wz, use_abs=use_abs))
            worst = max(worst, rr["mismatch"])
            r["max_abs_err"] = max(r["max_abs_err"], rr["max_abs_err"])
    print(f"  arsnn_v2 at 40x45 and 40x44, 6 cases each (sum/last/avg, "
          f"soft/hard, depth 1/2, k 3/5/7, f32/bf16 events): worst {worst} "
          "slots differ")

    H, W = ev.shape[-2:]
    shape = (ev.shape[1], 2, H, W)
    out["arsnn_step"] = None
    for dt in (torch.float32, torch.bfloat16):
        rs = step_case(shape, dt, gen, timed=True)
        rs["default_ms"] = r["default_ms"] / ev.shape[0]
        print(f"  arsnn_step flagship step {shape} {str(dt)[6:]}: rate "
              f"{rs['rate']:.3f}, {rs['mismatch']} outputs differ; call "
              f"{rs['ms']:.4f} ms (kernel {rs['kernel_ms']:.4f}), plain "
              f"{rs['plain_ms']:.4f}, bound "
              f"{rs['bound_ms']:.4f} ({rs['bound_by']}); default route "
              f"{rs['default_ms']:.4f} ms a micro-step (the plain "
              "embedding's forward / Tm)", flush=True)
        if dt == torch.float32:
            out["arsnn_step"] = rs
    worst = 0
    for readout, vreset, attach in (("last", 0.0, True), ("avg", None, True),
                                    ("avg", 0.0, False)):
        for dt in (torch.float32, torch.bfloat16):
            rs = step_case((2, 2, 20, 24), dt, gen, readout=readout,
                           vreset=vreset, attach=attach)
            worst = max(worst, rs["mismatch"])
            out["arsnn_step"]["max_abs_err"] = max(
                out["arsnn_step"]["max_abs_err"], rs["max_abs_err"])
    print(f"  arsnn_step at 2x2x20x24, 6 cases (last/avg, soft/hard, "
          f"spike_attach, f32/bf16): worst {worst} outputs differ")
    return out


@torch.no_grad()
def phase_sampler_routes(exp, model, batches, seed):
    """The plain and the fused route in turns, the v1 route, and the Gen4
    preset (phase 3c). Returns {"arsnn_step": launches of the v1 scan}
    (kernel 9 lies on no path that deploy() runs)."""
    emb = model.embedding
    B = batches[0].shape[0]
    print(f"phase 3c: sampler routes through detect at B={B}, "
          f"{len(batches)} forwards a run, in turns")
    fps = {"never": [], "always": []}
    for i, mode in enumerate(("never", "always", "always", "never")):
        old, emb.fused_sampler = emb.fused_sampler, mode
        f, counts, peak, _, _ = run_detect(exp, model, batches)
        check_counts(f"route '{mode}'", counts, len(batches),
                     exp.Tm if mode == "always" else 0)
        fps[mode].append(f)
        print(f"  run {i + 1} fused_sampler='{mode}': frames/s {f:.2f}, peak "
              f"{peak:.3f} GiB; launches {counts}", flush=True)
        if i < 2:
            layer_times(model, batches[0])
            profile_call(lambda: model(batches[0]), f"one forward ('{mode}')",
                         top=8)
        emb.fused_sampler = old
    mean = {k: float(np.mean(v)) for k, v in fps.items()}
    print(f"  frames/s mean: plain {mean['never']:.2f}, fused "
          f"{mean['always']:.2f} (fused / plain "
          f"{mean['always'] / mean['never']:.3f}; deploy() sets "
          f"fused_sampler='{exp.fused_sampler}')")

    # v1: the per-step kernel with the flagship's own conv stacks in f32
    # (cuDNN, TF32 off) over the same events, held to kernel 5's slots
    ev = sampler_events(model, batches[0]).float()
    emb32 = copy.deepcopy(emb).float()
    kw = emb.scan_kwargs()
    v2 = af.arsnn_fused_v2(ev, *emb.stack_weights(), **kw)
    torch.cuda.synchronize()
    reset_launches()
    v1 = af.arsnn_scan_fused(ev, apply_stack(emb32.input_conv),
                             apply_stack(emb32.gate_conv), **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = {"arsnn_step": counts["arsnn_step"]}
    rel = _rel_err(v1, v2)
    share = float((rel > ANALOG_TOL).float().mean())
    v1_ms = cuda_ms(lambda: af.arsnn_scan_fused(
        ev, apply_stack(emb32.input_conv),
        apply_stack(emb32.gate_conv), **kw), 3)
    print(f"  v1 route (kernel 9, cuDNN f32 convs) over the same events: "
          f"{v1_ms:.4f} ms a scan; slots vs kernel 5: share beyond "
          f"{ANALOG_TOL:.0e} relative {share:.2e} (tolerance {V1_TOL:.0e}), "
          f"max {float(rel.max()):.3e}; launches {counts}")
    want = {k: 0 for k in counts}
    want["arsnn_step"] = ev.shape[0]
    if counts != want:
        fail(f"v1 route: launch counts {counts}, expected {want}")
    if share > V1_TOL or not torch.isfinite(v1).all():
        fail("v1 route: slots disagree with kernel 5's")
    del v1, v2, ev, emb32
    torch.cuda.empty_cache()

    # the Gen4 preset: kernel 5 at its geometry, 3 detect forwards
    g4 = get_exp("gen4_rvt_syolox_m").deploy()
    g4.fused_sampler = "always"
    m4 = g4.get_model(device=DEV, seed=seed)
    H, W = g4.test_size
    gen = torch.Generator(device=DEV).manual_seed(seed + 5)
    shape = (GEN4_BATCH, g4.Tl, g4.Tm, H, W, g4.in_dim)
    b4 = [torch.poisson(torch.full(shape, 0.2, device=DEV), generator=gen)
          for _ in range(3)]
    calibrate_spiking_bn(m4, b4[0][:2])
    ev4 = sampler_events(m4, b4[0])
    r4 = check_v2("at Gen4", ev4, *m4.embedding.stack_weights(),
                  m4.embedding.scan_kwargs(), timed=True)
    r4["default_ms"] = default_route_ms(m4, b4[0])
    print(f"  Gen4 ({g4.exp_name}, {H}x{W}) arsnn_v2 at {tuple(ev4.shape)}: "
          f"{r4['mismatch']} of {r4['n']} slots differ, {r4['written']:.4f} "
          f"non-zero; call {r4['ms']:.4f} ms (kernel "
          f"{r4['kernel_ms']:.4f}), plain {r4['plain_ms']:.4f}, bound "
          f"{r4['bound_ms']:.4f} ({r4['bound_by']}); default route "
          f"{r4['default_ms']:.4f} ms")
    f, counts, peak, dets, dt = run_detect(g4, m4, b4)
    check_counts("Gen4 fused route", counts, len(b4), g4.Tm,
                 UNFUSED_PER_FORWARD)
    print(f"  Gen4 fused route: 3 forwards at B={GEN4_BATCH} (N="
          f"{GEN4_BATCH * g4.Tl}): {f:.2f} frames/s ({len(dets)} frames in "
          f"{dt:.4f} s, host clock), peak {peak:.3f} GiB; launches {counts}")
    del m4, b4, ev4
    torch.cuda.empty_cache()
    return launches


def _ulp_up(x: torch.Tensor) -> torch.Tensor:
    """Every nonzero value of x moved up by one ulp."""
    return torch.where(x != 0, torch.nextafter(
        x, torch.full_like(x, float("inf"))), x)


def _rel_err(card: torch.Tensor, cpu: torch.Tensor) -> torch.Tensor:
    return (card.float() - cpu.float()).abs() / (1 + cpu.float().abs())


def _check_analog(what: str, card: torch.Tensor, cpu: torch.Tensor,
                  phase: str = "4") -> None:
    rel = _rel_err(card, cpu)
    n_bad = int((rel > ANALOG_TOL).sum())
    print(f"  {what}: max |card - cpu| / (1 + |cpu|) {float(rel.max()):.3e}, "
          f"{n_bad} of {rel.numel()} beyond {ANALOG_TOL:.0e}")
    if n_bad or card.shape != cpu.shape or not torch.isfinite(card).all():
        fail(f"phase {phase}: {what} disagrees between card and CPU")


@torch.no_grad()
def phase_card_vs_cpu(seed, events):
    """The flagship in f32 at B=2, card (kernels, cuDNN) vs CPU (plain
    versions, oneDNN), with identical weights.

    A deep spiking network is chaotic: one spike that flips because two
    f32 sums were taken in different orders changes its neighbours'
    membranes by a weight, and the flips cascade. So the elementwise check
    is made stage by stage, each stage on the CPU from the very input the
    card gave it:

    * the sampler (plain PyTorch on both sides) on the same events, and the
      analog stem on the card's sampler output: every value within
      ANALOG_TOL relative (f32 sums in another order); the fused route's
      sampler, kernel 5 on the card against its plain version on the CPU
      (both round each stencil term once, as an FMA), the same way;
    * every spiking site: it may differ from the card's spikes in at most
      SITE_TOL of its outputs (threshold ties; a wrong kernel differs at
      the firing rate, ~20%);
    * the analog neck and head on the card's backbone features: the
      decoded output within 1e-3 relative (the box decode's exp amplifies
      the sums' rounding).

    The free-running forward is reported with its elementwise agreement
    beside two chaos witnesses, the CPU against itself with every nonzero
    value of the sampler's output, or of every conv weight, moved up by
    one ulp; its per-stage firing rates must agree to 0.01."""
    print("phase 4: card vs CPU, gen1_syolox_m in f32 at B=2")
    exp = get_exp("gen1_syolox_m")
    exp.compute_dtype = "float32"
    cpu_model = exp.get_model(device="cpu", seed=seed)
    calibrate_spiking_bn(cpu_model, events)
    gpu_model = exp.get_model(device=DEV, seed=seed)
    gpu_model.load_state_dict(cpu_model.state_dict())

    sites, feats, seen = OrderedDict(), {}, {}

    def keep(name):
        def hook(mod, args, out):
            x = args[0]
            xs = tuple(x) if isinstance(x, (tuple, list)) else (x,)
            sites[name] = (tuple(p.cpu() for p in xs), out.cpu())
        return hook

    bb = gpu_model.backbone.backbone
    handles = [m.register_forward_hook(keep(n))
               for n, m in gpu_model.named_modules()
               if isinstance(m, BaseConv) and m.neuron.spiking]
    handles.append(bb.register_forward_hook(
        lambda m, i, o: feats.update({k: v.cpu() for k, v in o.items()})))
    handles.append(gpu_model.embedding.register_forward_hook(
        lambda m, i, o: seen.update(embedding=o.cpu())))
    handles.append(bb.stem.register_forward_hook(
        lambda m, i, o: seen.update(stem_in=i[0].cpu(), stem=o.cpu())))
    gpu = gpu_model(events.to(DEV)).float().cpu()
    for h in handles:
        h.remove()

    # the sampler on the same events, the stem on the card's sampler output
    _check_analog("sampler output", seen["embedding"],
                  cpu_model.embedding(events))
    # the fused route's sampler: kernel 5 on the card, its plain version on
    # the CPU
    for m in (gpu_model, cpu_model):
        m.embedding.fused_sampler = "always"
    _check_analog("fused sampler output (kernel 5 vs its plain version)",
                  gpu_model.embedding(events.to(DEV)).cpu(),
                  cpu_model.embedding(events))
    for m in (gpu_model, cpu_model):
        m.embedding.fused_sampler = "never"
    _check_analog("stem output", seen["stem"],
                  cpu_model.backbone.backbone.stem(seen["stem_in"]))

    # site by site, on the card's inputs
    cpu_mods = dict(cpu_model.named_modules())
    worst, n_diff, n_all = 0.0, 0, 0
    for name, (xs, y_card) in sites.items():
        y = cpu_mods[name](xs if len(xs) > 1 else xs[0])
        d = int((y != y_card).sum())
        worst = max(worst, d / y.numel())
        n_diff, n_all = n_diff + d, n_all + y.numel()
    print(f"  {len(sites)} spiking sites on the card's inputs: {n_diff} of "
          f"{n_all} spikes differ, worst site {worst:.2e} (tolerance "
          f"{SITE_TOL:.0e})")
    if len(sites) != sum(PER_FORWARD.values()) or worst > SITE_TOL:
        fail("phase 4: spiking sites disagree between card and CPU")

    # free-running on the CPU, then twice more as chaos witnesses: with
    # the sampler's output one ulp up, and with every conv weight one ulp
    # up (a perturbation at every layer, as the card's summation order is)
    def run_free(model, nudge_sampler=False):
        got = {}
        hooks = [model.backbone.backbone.register_forward_hook(
            lambda m, i, o: got.update(o))]
        if nudge_sampler:
            hooks.append(model.embedding.register_forward_hook(
                lambda m, i, o: _ulp_up(o)))
        out = model(events).float()
        for h in hooks:
            h.remove()
        return got, out

    free, cpu = run_free(cpu_model)
    nudged_in, _ = run_free(cpu_model, nudge_sampler=True)
    nudged_model = copy.deepcopy(cpu_model)
    for m in nudged_model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.weight.copy_(_ulp_up(m.weight))
    nudged_w, _ = run_free(nudged_model)
    del nudged_model

    # the analog tail on the card's features
    cpu_model.backbone.backbone.forward = lambda x: feats
    tail = cpu_model(events).float()
    rel = float(_rel_err(gpu, tail).max())
    print(f"  neck + head on the card's features: max |card - cpu| / "
          f"(1 + |cpu|) {rel:.3e} (tolerance 1e-3)")
    if not torch.isfinite(gpu).all() or rel > 1e-3:
        fail("phase 4: decoded outputs disagree on the same features")

    def agree(x, y):
        return float((x == y).float().mean())

    for stage in ("dark3", "dark4", "dark5"):
        a, b = feats[stage], free[stage]
        ra, rb = float(a.float().mean()), float(b.float().mean())
        print(f"  free-running {stage}: spike agreement card vs cpu "
              f"{agree(a, b):.4f}; cpu vs cpu with the sampler output one "
              f"ulp up {agree(nudged_in[stage], b):.4f}, with every conv "
              f"weight one ulp up {agree(nudged_w[stage], b):.4f}; rate "
              f"card {ra:.4f} cpu {rb:.4f} (tolerance 0.01)")
        if abs(ra - rb) > 0.01 or not 0.01 <= rb <= 0.99:
            fail(f"phase 4: free-running {stage} firing rates disagree")
    print(f"  free-running decoded: max |card - cpu| "
          f"{float((gpu - cpu).abs().max()):.3e}")


# ---------------------------------------------------------------- phase 5

BWD_OPS = 24  # f32 operations per element and step of the train backward


def train_site_geometries(model, events, labels, where=None):
    """{(shape, dtype, T, thresh, spike_fn, alpha): count} of the spiking
    sites' preactivations in one train forward (pre-hooks on the neurons
    whose name ``where`` accepts, where given; run without gradients)."""
    sites = OrderedDict()

    def hook(mod, args):
        x = args[0]
        key = (tuple(x.shape), x.dtype, mod.T, mod.thresh, mod.spike_fn,
               mod.alpha)
        sites[key] = sites.get(key, 0) + 1

    handles = [m.register_forward_pre_hook(hook)
               for n, m in model.named_modules()
               if isinstance(m, PLIF) and (where is None or where(n))]
    with torch.no_grad():
        model(events, labels)
    for h in handles:
        h.remove()
    return sites


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_train_site(shape, dtype, T, th, kind, gen, identity=False,
                     timed=True, alpha=2.0):
    """Both train kernels against their plain versions on random bf16
    preactivations and cotangents; BN terms that put the normalized
    preactivation near N(0.6, 1) (the identity terms for ``identity``);
    the surrogate's constants from ``alpha`` on both sides. The backward
    runs twice: its sums must be bitwise identical."""
    C = shape[1]
    dev = dict(device=DEV)
    z = torch.randn(shape, generator=gen, **dev)
    if identity:
        mean, mul, bias = (torch.full((C,), v, **dev) for v in (0.0, 1.0,
                                                                0.0))
        x = (z + 0.6).to(dtype)
    else:
        mean = 0.2 * torch.randn(C, generator=gen, **dev)
        mul = 0.5 + torch.rand(C, generator=gen, **dev)
        bias = 0.6 + 0.1 * torch.randn(C, generator=gen, **dev)
        x = (z + mean.reshape(1, -1, 1, 1)).to(dtype)
    w = 2 * torch.rand((), generator=gen, **dev) - 1
    a = (1 - torch.sigmoid(w)).reshape(1)
    g = torch.randn(shape, generator=gen, **dev).to(dtype)
    fwd_args = (x, a, mean, mul, bias, T, th, kind)
    bwd_args = (x, g, a, mean, mul, bias, T, th, kind,
                train_alpha(kind, alpha))
    got = plif_train_forward(*fwd_args)
    want = plif_train_forward_plain(*fwd_args)
    kb = plif_train_backward(*bwd_args)
    kb2 = plif_train_backward(*bwd_args)
    pb = plif_train_backward_plain(*bwd_args)
    torch.cuda.synchronize()
    res = dict(rate=float(want.float().mean()),
               fwd_mism=int((_bits(got) != _bits(want)).sum()),
               dx_mism=int((_bits(kb[0]) != _bits(pb[0])).sum()),
               rerun_mism=sum(int((_bits(u) != _bits(v)).sum())
                              for u, v in zip(kb, kb2)))
    res["fwd_err"] = float((got.float() - want.float()).abs().max())
    res["bwd_err"] = float((kb[0].float() - pb[0].float()).abs().max())
    res["sum_rel"] = {}
    for name, u, v in zip(("da", "dm", "ds", "db"), kb[1:], pb[1:]):
        res["bwd_err"] = max(res["bwd_err"], float((u - v).abs().max()))
        res["sum_rel"][name] = float((u - v).abs().max()
                                     / v.abs().max().clamp_min(1e-30))
    what = f"train PLIF at {shape}{' (identity BN)' if identity else ''}"
    if res["fwd_mism"]:
        fail(f"{what}: {res['fwd_mism']} spikes differ (bit-equal expected)")
    if res["dx_mism"]:
        fail(f"{what}: {res['dx_mism']} dx values differ (bit-equal "
             "expected)")
    if res["rerun_mism"]:
        fail(f"{what}: a second backward on the same inputs differs in "
             f"{res['rerun_mism']} values (deterministic sums expected)")
    bad = {k: v for k, v in res["sum_rel"].items() if not v <= SUM_TOL}
    if bad:
        fail(f"{what}: sums beyond {SUM_TOL:.0e} relative: {bad}")
    if not 0.05 <= res["rate"] <= 0.95:
        fail(f"{what}: firing rate {res['rate']:.4f} outside 5-95%")
    del got, want, kb, kb2, pb
    if not timed:
        return res
    res["fwd_ms"] = cuda_ms(lambda: plif_train_forward(*fwd_args), 20)
    res["fwd_kernel_ms"], _, _ = kernel_ms(
        lambda: plif_train_forward(*fwd_args), "plif_fwd_kernel")
    res["fwd_plain_ms"] = cuda_ms(lambda: plif_train_forward_plain(
        *fwd_args), 3, warmup=1)
    res["bwd_ms"] = cuda_ms(lambda: plif_train_backward(*bwd_args), 20)
    res["bwd_kernel_ms"], res["bwd_recorded"], res["bwd_side"] = kernel_ms(
        lambda: plif_train_backward(*bwd_args), "plif_bwd")
    res["bwd_host_ms"] = host_ms(lambda: plif_train_backward(*bwd_args))
    # yardstick: a PyTorch pass that moves the backward's bytes (two
    # reads, one write in x's dtype)
    buf = torch.empty_like(x)
    res["add_ms"] = cuda_ms(lambda: torch.add(x, g, out=buf), 20)
    if res["bwd_side"]:
        fail(f"{what}: the backward launches {res['bwd_side']} other "
             "kernels a call (none expected)")
    res["bwd_plain_ms"] = cuda_ms(lambda: plif_train_backward_plain(
        *bwd_args), 3, warmup=1)
    n, es = x.numel(), x.element_size()
    res["fwd_bound"] = bound_ms(2 * n * es + 12 * C + 4, 0.0,
                                (PLIF_OPS + BN_OPS) * n)
    res["bwd_bound"] = bound_ms(3 * n * es + 12 * C + 4 + 16 * C, 0.0,
                                (PLIF_OPS + BN_OPS + BWD_OPS) * n)
    return res


def phase_train_kernels(model, events, labels, seed, phase="5",
                        extras=True, alpha=2.0, where=None,
                        expect_sites=PER_STEP["plif_train_fwd"]):
    """Both train kernels against their plain versions at every spiking
    site geometry of ``model``'s train step on ``events`` (the sites whose
    name ``where`` accepts, where given: ``expect_sites`` of them), each
    at the site's own alpha, which must be ``alpha``; then (with
    ``extras``) the identity BN, the other surrogates, f32 storage and a
    ragged H*W. Returns the per-kernel sums a step."""
    sites = train_site_geometries(model, events, labels, where)
    gen = torch.Generator(device=DEV).manual_seed(seed + 3)
    agg = {n: dict(ms=0.0, kernel_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                   bytes_ms=0.0, ops_ms=0.0, max_abs_err=0.0)
           for n in PER_STEP}
    add_ms = 0.0
    print(f"phase {phase}: train kernels vs plain at every train-step site "
          f"geometry, alpha {alpha} "
          "(ms per call: the wrapper's call by CUDA events, k = the "
          "kernel's own device time by torch.profiler; host = the host's "
          "enqueue time a backward call; the backward's plan: items a "
          "thread, blocks, waves; rec: launches the profiler recorded a "
          "call)")
    print(f"  {'x':>3s} {'preactivation':22s} {'rate':>6s} {'fwd':>8s} "
          f"{'fwd k':>8s} {'plain':>8s} {'bound':>8s} {'bwd':>8s} "
          f"{'bwd k':>8s} {'host':>8s} {'plain':>8s} {'bound':>8s}  plan  "
          "rec  sums |kernel - plain| / max|plain|")
    n_sites = 0
    for (shape, dtype, T, th, kind, a_site), count in sites.items():
        if a_site != alpha:
            fail(f"train PLIF at {shape}: the site's alpha is {a_site}, the "
                 f"preset's {alpha}")
        r = check_train_site(shape, dtype, T, th, kind, gen, alpha=a_site)
        n_sites += count
        plan = plif_bwd_plan(shape[0] // T, shape[1], shape[2] * shape[3],
                             dtype, T, sms=_build.sm_count(torch.device(DEV)))
        print(f"  {count:3d} {'x'.join(map(str, shape)):22s} "
              f"{r['rate']:6.3f} {r['fwd_ms']:8.4f} {r['fwd_kernel_ms']:8.4f} "
              f"{r['fwd_plain_ms']:8.4f} "
              f"{r['fwd_bound'][0]:8.4f} {r['bwd_ms']:8.4f} "
              f"{r['bwd_kernel_ms']:8.4f} {r['bwd_host_ms']:8.4f} "
              f"{r['bwd_plain_ms']:8.4f} {r['bwd_bound'][0]:8.4f}  "
              f"{plan.ipt}/{plan.grid}/{plan.waves:.1f}  "
              f"{r['bwd_recorded']:.1f}  " +
              " ".join(f"{k} {v:.1e}" for k, v in r["sum_rel"].items()),
              flush=True)
        add_ms += count * r["add_ms"]
        for name, pre in (("plif_train_fwd", "fwd"), ("plif_train_bwd",
                                                       "bwd")):
            a = agg[name]
            a["ms"] += count * r[f"{pre}_ms"]
            a["kernel_ms"] += count * r[f"{pre}_kernel_ms"]
            a["plain_ms"] += count * r[f"{pre}_plain_ms"]
            bms, by = r[f"{pre}_bound"]
            a["bound_ms"] += count * bms
            a["bytes_ms" if by == "bytes" else "ops_ms"] += count * bms
            a["max_abs_err"] = max(a["max_abs_err"], r[f"{pre}_err"])
    print("  a step: " + ", ".join(
        f"{name} call {a['ms']:.4f} ms, kernel {a['kernel_ms']:.4f}, bound "
        f"{a['bound_ms']:.4f}" for name, a in agg.items()) +
        f"; torch.add of x and g into a third tensor (the backward's bytes) "
        f"{add_ms:.4f}")
    if n_sites != expect_sites or str(dtype) != "torch.bfloat16":
        fail(f"phase {phase}: {n_sites} spiking sites in {dtype}, expected "
             f"{expect_sites} in bf16")
    if not extras:
        return agg
    # the backward of kernel 1 (pallas_call at plif_pallas.py:338): the
    # same kernel with the identity BN terms
    r = check_train_site(shape, dtype, T, th, kind, gen, identity=True)
    print(f"  identity BN at {'x'.join(map(str, shape))}: rate "
          f"{r['rate']:.3f}, spikes differ {r['fwd_mism']}, dx differ "
          f"{r['dx_mism']}, sums " + " ".join(
              f"{k} {v:.1e}" for k, v in r["sum_rel"].items()) +
          f"; bwd {r['bwd_ms']:.4f} ms (kernel {r['bwd_kernel_ms']:.4f}, "
          f"host {r['bwd_host_ms']:.4f}), plain {r['bwd_plain_ms']:.4f}, "
          f"bound {r['bwd_bound'][0]:.4f}")
    # the kernels' other branches, which the flagship does not take: the
    # other surrogates, f32 storage and a ragged H*W (7x9: the scalar
    # tail) in both dtypes
    for kind, dt, shp in (("rect", dtype, (3 * 4, 16, 8, 8)),
                          ("sigmoid", dtype, (3 * 4, 16, 8, 8)),
                          ("tanh", dtype, (3 * 4, 16, 8, 8)),
                          ("atan", torch.float32, (3 * 4, 8, 4, 4)),
                          ("atan", dtype, (3 * 4, 16, 7, 9)),
                          ("atan", torch.float32, (3 * 4, 16, 7, 9))):
        r = check_train_site(shp, dt, T, th, kind, gen, timed=False)
        print(f"  {kind} {str(dt)[6:]} at {'x'.join(map(str, shp))}: spikes "
              f"differ {r['fwd_mism']}, dx differ {r['dx_mism']}, rerun "
              f"differs {r['rerun_mism']}, sums " +
              " ".join(f"{k} {v:.1e}" for k, v in r["sum_rel"].items()))
    return agg


# ---------------------------------------------------------------- phase 6

def random_labels(B: int, H: int, W: int, rng, max_labels: int = 50):
    """(B, max_labels, 5) [cls, cx, cy, w, h]: 1-8 boxes an image, w and h
    at least 8 px, inside the frame, classes {0, 1}, zero rows after."""
    lab = np.zeros((B, max_labels, 5), np.float32)
    for b in range(B):
        n = int(rng.integers(1, 9))
        w = rng.uniform(8, W / 3, n)
        h = rng.uniform(8, H / 3, n)
        lab[b, :n] = np.stack([rng.integers(0, 2, n), rng.uniform(w / 2,
                               W - w / 2), rng.uniform(h / 2, H - h / 2), w,
                               h], 1)
    return torch.from_numpy(lab)


def phase_train_step(exp, model, events, labels, steps: int):
    B = events.shape[0]
    print(f"phase 6: train step, gen1_syolox_m at B={B}, {steps} timed "
          "steps on one batch (Adam, fixed lr, EMA)")
    opt = exp.get_optimizer(model, B, iters_per_epoch=1000)
    ema = init_ema(model) if exp.ema else None
    losses = [train_step(model, opt, ema, events, labels) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(train_step(model, opt, ema, events, labels))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {dt / steps * 1e3:.3f} ms/step, {B * steps / dt:.2f} images/s "
          f"(host clock, {steps} steps in {dt:.4f} s), peak memory "
          f"{peak:.3f} GiB; launches {counts}")
    want = {k: PER_STEP.get(k, 0) * steps for k in KERNEL_WRAPPERS}
    if counts != want:
        fail(f"train step launch counts {counts}, expected {want}")
    host = [{k: float(v) for k, v in x.items()} for x in losses]
    for i in (0, len(host) - 1):
        print(f"  step {i + 1}: " + ", ".join(
            f"{k} {v:.5f}" for k, v in host[i].items()))
    print("  total loss by step: " + " ".join(
        f"{x['total_loss']:.4f}" for x in host))
    if not all(np.isfinite(v) for x in host for v in x.values()):
        fail("train step: a loss is not finite")
    n_none = sum(p.grad is None for p in model.parameters())
    bad = sum(int(not torch.isfinite(p.grad).all())
              for p in model.parameters() if p.grad is not None)
    if n_none or bad:
        fail(f"train step: {n_none} parameters without a gradient, {bad} "
             "with non-finite gradients")
    if not host[-1]["total_loss"] < host[0]["total_loss"]:
        fail("train step: the total loss did not fall on a fixed batch")

    # one more step, split by CUDA events (not counted above)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    opt.zero_grad(set_to_none=True)
    ev[0].record()
    out = model(events, labels)
    ev[1].record()
    out["total_loss"].backward()
    ev[2].record()
    optimizer_update(model, opt, ema)
    ev[3].record()
    torch.cuda.synchronize()
    fwd, bwd, upd = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
    print(f"  one step by CUDA events: forward {fwd:.3f} ms, backward "
          f"{bwd:.3f} ms, optimizer + EMA {upd:.3f} ms")
    rows = profile_call(lambda: train_step(model, opt, ema, events, labels),
                        "one train step", top=16)
    totals = {k: profiled_total(rows, k)
              for k in ("plif_fwd_kernel", "plif_bwd")}
    plif = {k: n for k, (_, n) in totals.items()}
    print(f"  PLIF kernels in the profiled step: {plif} (one of each a "
          "spiking site; the backward has no second pass); device ms "
          + ", ".join(f"{k} {ms:.4f}" for k, (ms, _) in totals.items()))
    if plif != {"plif_fwd_kernel": PER_STEP["plif_train_fwd"],
                "plif_bwd": PER_STEP["plif_train_bwd"]}:
        fail(f"train step profile: PLIF kernel launches {plif}")
    return counts


# ---------------------------------------------------------------- phase 6b

def _state_tensors(model, opt, ema):
    """Every tensor a step carries to the next, in a fixed order: the
    model's parameters and buffers, Adam's state, the EMA."""
    out = list(model.state_dict().values())
    for g in opt.param_groups:
        for p in g["params"]:
            out += [v for v in opt.state[p].values()
                    if isinstance(v, torch.Tensor)]
    return out + (list(ema.values()) if ema is not None else [])


def snapshot(model, opt, ema):
    """A copy of the train state; ``restore`` writes it back in place, so
    that the captured graphs keep their addresses."""
    return ([t.detach().clone() for t in _state_tensors(model, opt, ema)],
            [g["updates"] for g in opt.param_groups])


@torch.no_grad()
def restore(snap, model, opt, ema) -> None:
    tensors, counts = snap
    for t, s in zip(_state_tensors(model, opt, ema), tensors):
        t.copy_(s)
    for g, n in zip(opt.param_groups, counts):
        g["updates"] = n


def state_diff(a, b):
    """(largest |a - b| over the state tensors, elements that differ)."""
    worst, n = 0.0, 0
    for x, y in zip(a, b):
        if x.is_floating_point():
            d = (x.float() - y.float()).abs()
            worst = max(worst, float(d.max()))
            n += int((d > 0).sum())
        else:
            n += int((x != y).sum())
    return worst, n


def step_pair(step, model, opt, ema, snap, events, labels):
    """From ``snap``: one captured step, then one eager step, then two
    eager steps; returns the losses and end states of the captured and the
    first eager step and the eager pair's state difference (the noise of
    the eager step against itself). The eager steps run under the cuDNN
    setting the captured step was captured under (``cudnn_mode``)."""
    runs = []
    for fn in (step, lambda e, t: train_step(model, opt, ema, e, t),
               lambda e, t: train_step(model, opt, ema, e, t)):
        restore(snap, model, opt, ema)
        with step.cudnn_mode():
            losses = {k: float(v) for k, v in fn(events, labels).items()}
        torch.cuda.synchronize()
        runs.append((losses, [t.detach().clone() for t in
                              _state_tensors(model, opt, ema)]))
    return runs


def check_step_pair(what, runs, lr: float):
    """Tolerance: the eager step's own difference from the same snapshot
    (the second eager step against the first), in the losses and in every
    state element; measured 0 on the H100 (bit-equal), so the captured
    step must give the eager step's bits."""
    (lc, sc), (le, se), (le2, se2) = runs
    dl = max(abs(lc[k] - le[k]) for k in le)
    dl_noise = max(abs(le2[k] - le[k]) for k in le)
    ds, ns = state_diff(sc, se)
    dn, nn_ = state_diff(se2, se)
    print(f"  {what}: captured vs eager from one snapshot: total loss "
          f"{lc['total_loss']:.6f} / {le['total_loss']:.6f}, largest loss "
          f"difference {dl:.3e}; state largest |diff| {ds:.3e} "
          f"({ds / lr:.3f} lr), {ns} elements differ; eager vs eager: "
          f"losses {dl_noise:.3e}, state {dn:.3e}, {nn_} elements")
    if not (dl <= dl_noise and ds <= dn):
        fail(f"{what}: the captured step differs from the eager one "
             f"(losses {dl:.3e}, state {ds:.3e}) by more than the eager "
             f"step from itself (losses {dl_noise:.3e}, state {dn:.3e})")


def timed_steps(fn, events, labels, steps: int):
    """(ms a step, images/s, peak GiB, losses) of ``steps`` calls on one
    batch, host clock around work that ends in a synchronize."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = [fn(events, labels) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return (dt / steps * 1e3, events.shape[0] * steps / dt,
            torch.cuda.max_memory_allocated() / 2**30,
            [float(x["total_loss"]) for x in out])


def phase_captured_step(exp, events, labels, steps: int):
    """Phase 6b: the step as CUDA graphs (``CapturedStep``) against the
    eager step, at B=64 and B=8, in turns."""
    from eas_snn_tpu_torch.core.train_state import CapturedStep
    t_phase = time.perf_counter()
    model = exp.get_model(device=DEV, seed=SEED + 1, train=True)
    opt = exp.get_optimizer(model, events.shape[0], iters_per_epoch=1000)
    ema = init_ema(model) if exp.ema else None
    step = CapturedStep(model, opt, ema)
    lr = opt.lr_schedule(0)
    eager = lambda e, t: train_step(model, opt, ema, e, t)
    print(f"phase 6b: the step captured as CUDA graphs (CapturedStep: "
          f"{step.WARMUP} eager warm-up steps a geometry, then capture and "
          f"replay) against the eager step; Adam capturable, lr {lr:g}")
    for B in (events.shape[0], 8):
        ev, lab = events[:B].contiguous(), labels[:B].contiguous()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_reserved() / 2**30
        t0 = time.perf_counter()
        for _ in range(step.WARMUP + 1):
            step(ev, lab)
        torch.cuda.synchronize()
        print(f"  B={B}: {step.WARMUP} warm-up steps, capture and first "
              f"replay in {time.perf_counter() - t0:.2f} s; peak allocated "
              f"over them {torch.cuda.max_memory_allocated() / 2**30:.3f} "
              f"GiB (the capture's own peak included); reserved "
              f"{before:.3f} -> {torch.cuda.memory_reserved() / 2**30:.3f} "
              "GiB (the graphs' pool is reserved, not allocated, between "
              "replays)")
        eager(ev, lab)
        for name in ("eager", "captured", "captured", "eager"):
            fn = step if name == "captured" else eager
            ms, ips, peak, losses = timed_steps(fn, ev, lab, steps)
            print(f"  B={B} {name:8s}: {ms:.3f} ms/step, {ips:.2f} images/s "
                  f"({steps} steps, host clock), peak allocated {peak:.3f} "
                  f"GiB; total loss {losses[0]:.4f} -> {losses[-1]:.4f}")
            if not all(np.isfinite(losses)):
                fail(f"B={B} {name}: a loss is not finite")
        for name, fn in (("eager", eager), ("captured", step)):
            prof = profile_call(lambda: [fn(ev, lab) for _ in range(3)],
                                f"3 {name} steps at B={B}", top=6)
            plif = {k: profiled_total(prof, k)[1]
                    for k in ("plif_fwd_kernel", "plif_bwd")}
            print(f"  B={B} {name}: PLIF kernel launches in the 3 profiled "
                  f"steps, by kernel name: {plif}")
            want = {"plif_fwd_kernel": 3 * PER_STEP["plif_train_fwd"],
                    "plif_bwd": 3 * PER_STEP["plif_train_bwd"]}
            if plif != want:
                fail(f"B={B} {name}: PLIF launches {plif} in 3 steps, "
                     f"expected {want}")

    # one snapshot: a captured step against an eager step, then two
    # sizes in turns through the shared pool
    H, W = events.shape[3:5]
    big = F.interpolate(events.flatten(0, 2).permute(0, 3, 1, 2),
                        size=(H + 32, W + 32), mode="nearest-exact")
    big = big.permute(0, 2, 3, 1).reshape(events.shape[:3] + (H + 32, W + 32,
                                                              events.shape[5]))
    big_lab = labels.clone()
    big_lab[..., 1::2] *= (W + 32) / W
    big_lab[..., 2::2] *= (H + 32) / H
    for _ in range(step.WARMUP):
        step(big, big_lab)
    snap = snapshot(model, opt, ema)
    check_step_pair(f"{H}x{W} B={events.shape[0]}",
                    step_pair(step, model, opt, ema, snap, events, labels),
                    lr)
    for size, ev, lab in (((H + 32, W + 32), big, big_lab),
                          ((H, W), events, labels),
                          ((H + 32, W + 32), big, big_lab)):
        check_step_pair(f"alternating, {size[0]}x{size[1]}",
                        step_pair(step, model, opt, ema, snap, ev, lab), lr)
    print(f"  graphs held: {len(step.keys)} (one pool); PLIF backward "
          f"scratch buffers kept for graphs: "
          f"{len(plif_mod._BWD_RETIRED)} retired, "
          f"{len(plif_mod._BWD_SCRATCH)} live")
    print(f"  phase 6b took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------- phase 7

GEN1_HW = (240, 304)        # the Gen1 sensor
EVENTS_PER_S = 500_000      # ~100k events in a 200 ms window
LABEL_DT_US = 50_000        # a label group every 50 ms


def write_gen1_tree(root: str, streams: int, groups: int, seed: int) -> dict:
    """A synthetic Gen1 directory written with the port's writers: each
    stream a ``<seq>_td.dat`` of uniform events at EVENTS_PER_S over the
    sensor and a ``<seq>_bbox.npy`` of ``groups`` label groups, one every
    LABEL_DT_US from 250 ms on, 1-4 boxes of 20-120 x 20-90 px each."""
    from eas_snn_tpu_torch.data.psee_io import (write_bboxes_npy,
                                                write_dat_events)
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    H, W = GEN1_HW
    n_events = 0
    for s in range(streams):
        dur = 250_000 + groups * LABEL_DT_US
        n = EVENTS_PER_S * dur // 1_000_000
        t = np.sort(rng.integers(0, dur, n))
        write_dat_events(os.path.join(root, f"seq{s}_td.dat"), t,
                         rng.integers(0, W, n), rng.integers(0, H, n),
                         rng.integers(0, 2, n), height=H, width=W)
        rows = []
        for k in range(groups):
            for j in range(int(rng.integers(1, 5))):
                w, h = rng.uniform(20, 120), rng.uniform(20, 90)
                rows.append((250_000 + k * LABEL_DT_US,
                             rng.uniform(0, W - w), rng.uniform(0, H - h),
                             w, h, int(rng.integers(0, 2)), j, 1.0))
        write_bboxes_npy(os.path.join(root, f"seq{s}_bbox.npy"), rows)
        n_events += n
    return dict(streams=streams, groups=streams * groups, events=n_events)


class TimedBatches:
    """Wraps the trainer's batch iterator: host seconds a ``next``."""

    def __init__(self, it):
        self.it, self.seconds = it, []

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        try:
            return next(self.it)
        finally:
            self.seconds.append(time.perf_counter() - t0)


def loader_alone(tr, B: int, what: str) -> None:
    """Samples/s of the trainer's batches (workers, pinned memory, the
    prefetcher's copy to the card) with no step between them, after the
    batches the workers had ready (two a worker) are drained."""
    for _ in range(2 * tr.train_loader.num_workers + 2):
        next(tr._batches)
    k = 8
    t0 = time.perf_counter()
    for _ in range(k):
        next(tr._batches)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"  the loader alone ({what}): {B * k / dt:.2f} samples/s ({k} "
          f"batches of {B} with their copy to the card, "
          f"{tr.train_loader.num_workers} worker processes, "
          f"os.cpu_count() {os.cpu_count()})")


def host_cost(exp, what: str, n: int = 16) -> None:
    """Host ms a train sample, in this process on one thread as in a
    loader worker; the dataset's profile splits the frame path."""
    ds = exp.get_dataset(training=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    for i in range(n):
        ds[i]
    wall = (time.perf_counter() - t0) / n * 1e3
    torch.set_num_threads(threads)
    prof = ds.profile
    split = (f", of which slicing + micro_sum "
             f"{prof['slicing_s'] / prof['count'] * 1e3:.3f} and "
             f"augmentation {prof['augment_s'] / prof['count'] * 1e3:.3f} "
             "(dataset.profile)" if prof["count"] else "")
    print(f"  host cost a train sample ({what}, one thread): {wall:.3f} "
          f"ms{split}")


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if not a.is_floating_point():
        return torch.equal(a, b)
    return torch.equal(_bits(a.reshape(-1)), _bits(b.reshape(-1)))


def eval_between_replays(tr) -> None:
    """The trainer's epoch end with its evaluation (``eval_interval`` 1)
    between replays of the captured step: every parameter, buffer, Adam
    state and EMA tensor must keep its bits; ``best.pth`` and the val row
    of ``metrics.jsonl`` must be written. The smoke run's weights have
    seen a few dozen steps of noise, whose AP may be 0.0, which is no new
    best against the trainer's initial 0.0: the best AP is set to -1 first,
    so that this evaluation is a best whatever its AP."""
    before = [t.detach().clone() for t in _state_tensors(
        tr.model, tr.optimizer, tr.ema)]
    tr.best_ap = -1.0
    t0 = time.perf_counter()
    tr.after_epoch()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    after = _state_tensors(tr.model, tr.optimizer, tr.ema)
    changed = sum(not _same_bits(a, b) for a, b in zip(before, after))
    rows = [json.loads(r) for r in open(os.path.join(tr.file_name,
                                                     "metrics.jsonl"))]
    val = [r for r in rows if r["split"] == "val"]
    best = tr.ckpt.best_path
    tm = tr.evaluator.timing
    print(f"  evaluation between replays (epoch end, eval_interval 1) in "
          f"{dt:.1f} s: val rows {val}; {tm['samples']} val samples, "
          f"forward {1e3 * tm['forward_s'] / max(tm['samples'], 1):.3f} ms "
          f"an image; {changed} of {len(before)} train-state tensors "
          f"changed; best.pth {'written' if os.path.exists(best) else 'missing'}")
    if changed:
        fail(f"phase 7: the evaluation changed {changed} train-state tensors")
    if not os.path.exists(best):
        fail(f"phase 7: {best} not written")
    if not val or not all(np.isfinite(r["AP50_95"]) for r in val):
        fail(f"phase 7: metrics.jsonl holds no val AP: {val}")


def phase_entry_point(B: int, steps: int, workers: int) -> None:
    """Phase 7: ``gen1_syolox_m`` trained through the port's CLI parser,
    ``exp.get_data_loader`` and ``Trainer`` from a synthetic Gen1 tree:
    captured steps with the loader in the loop, the loader alone, the
    host cost a sample, a profiled window; then save, resume and device
    binning."""
    import shutil

    from eas_snn_tpu_torch.core.optim import updates
    from eas_snn_tpu_torch.core.train_state import CapturedStep
    from eas_snn_tpu_torch.tools.train_event import build
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "outputs", "chip_smoke_phase7")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "gen1")
    t0 = time.perf_counter()
    tree = write_gen1_tree(os.path.join(data, "train"), streams=4, groups=32,
                           seed=SEED)
    val = write_gen1_tree(os.path.join(data, "val"), streams=1, groups=16,
                          seed=SEED + 1)
    print(f"phase 7: the train entry point; synthetic Gen1 tree "
          f"({tree['streams']} streams, {tree['groups']} label groups, "
          f"{tree['events']} events at {EVENTS_PER_S} events/s, "
          f"{GEN1_HW[0]}x{GEN1_HW[1]}; val {val['groups']} label groups) "
          f"written in {time.perf_counter() - t0:.1f} s")
    # the timed steps follow the warm-up, the capture and as many steps as
    # the workers had batches ready (two a worker), so that they see the
    # loader's steady rate
    drain = 2 * workers + 2
    n_iters = CapturedStep.WARMUP + 1 + drain + steps
    argv = ["-n", "gen1_syolox_m", "-b", str(B), "-l", "jsonl",
            "data_dir", data, "output_dir", os.path.join(root, "out"),
            "data_num_workers", str(workers), "max_epoch", "1",
            "print_interval", str(n_iters), "seed", str(SEED),
            "eval_interval", "1"]
    exp, args = build(argv)
    exp.iters_per_epoch = n_iters
    tr = exp.get_trainer(args, device=DEV)
    t0 = time.perf_counter()
    tr.before_train()
    nw = tr.train_loader.num_workers
    print(f"  Trainer.before_train (model, optimizer, {nw} forked loader "
          f"workers, first batch) in "
          f"{time.perf_counter() - t0:.1f} s; dataset "
          f"{len(tr.train_loader.dataset)} samples; os.cpu_count() "
          f"{os.cpu_count()}")
    stamps = []
    step = tr.step_fn

    def timed_step(*a, **k):
        out = step(*a, **k)
        stamps.append(time.perf_counter())
        return out

    tr.step_fn = timed_step
    tr._batches = TimedBatches(tr._batches)
    tr.before_epoch()
    tr.train_in_iter()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    tr.step_fn = step
    w = CapturedStep.WARMUP
    wall = t_end - stamps[-steps - 1]
    data_s = sum(tr._batches.seconds[-steps:])
    head = stamps[-steps - 1] - stamps[w]
    print(f"  {len(stamps)} steps at B={B} ({w} eager warm-up, then "
          f"captured; {step.replays} replays): {B * steps / wall:.2f} "
          f"images/s with the loader in the loop over the last {steps} "
          f"({wall / steps * 1e3:.3f} ms a step, host clock to a "
          f"synchronize; the {drain} replays before them, on the batches "
          f"the workers had ready: {B * drain / head:.2f} images/s); "
          f"data_time {data_s / wall:.3f} of iter_time; losses "
          f"{tr.last_losses}")
    losses = {k: float(v) for k, v in tr.last_losses.items()}
    if not all(np.isfinite(v) for v in losses.values()):
        fail(f"phase 7: a loss is not finite: {losses}")
    if step.replays != n_iters - w:
        fail(f"phase 7: {step.replays} replays, expected {n_iters - w}")
    eval_between_replays(tr)
    saved = updates(tr.optimizer)

    # resume: the next steps of the first trainer (replays) against the
    # first steps of a second one restored from its checkpoint (its
    # eager warm-up, then its capture and first replay), on one batch
    ev, lab = next(tr._batches)
    n = CapturedStep.WARMUP + 1
    after = [{k: float(v) for k, v in step(ev, lab).items()}
             for _ in range(n)]
    if not all(np.isfinite(v) for a in after for v in a.values()):
        fail(f"phase 7: a loss of the replays after the evaluation is not "
             f"finite: {after}")
    args.resume = True
    tr2 = exp.get_trainer(args, device=DEV)
    tr2.before_train([(ev.cpu(), lab.cpu())])
    start = updates(tr2.optimizer)
    first = [{k: float(v) for k, v in tr2.step_fn(ev, lab).items()}
             for _ in range(n)]
    print(f"  resume: checkpoint at step {saved}; the second trainer "
          f"starts at step {start}, epoch {tr2.start_epoch} (iters/epoch "
          f"{tr2.iters_per_epoch}); total loss of the next {n} steps, the "
          f"first trainer (replays) / the resumed one ({n - 1} eager, then "
          f"its first replay): " + ", ".join(
              f"{a['total_loss']:.6f} / {b['total_loss']:.6f}"
              for a, b in zip(after, first)))
    if tr2.start_epoch != saved // tr2.iters_per_epoch:
        fail(f"resume: start epoch {tr2.start_epoch}, expected "
             f"{saved // tr2.iters_per_epoch}")
    if start != saved:
        fail(f"resume: the second trainer starts at step {start}, the "
             f"checkpoint is at {saved}")
    if after != first:
        fail(f"resume: losses {first} differ from the first trainer's "
             f"{after} (phase 6b's tolerance: bit-equal)")
    if tr2.step_fn.replays != 1:
        fail(f"resume: the second trainer replayed {tr2.step_fn.replays} "
             "times, expected 1")
    tr2.after_train()
    del tr2

    # a profiled window of 3 steps with the loader in the loop
    tr.iters_per_epoch = 3
    profile_call(tr.train_in_iter, f"3 trainer steps at B={B} (loader in "
                 "the loop)", top=6)
    tr.after_train()

    loader_alone(tr, B, "frames")
    del tr
    host_cost(exp, "frames")

    # device binning: raw indexed events from the loader, binned on card
    exp, args = build(["-expn", "binning", "--profile", "1"] + argv
                      + ["device_binning", "True", "eval_interval", "10"])
    exp.iters_per_epoch = 2
    tr = exp.get_trainer(args, device=DEV)
    tr.train()
    losses = {k: float(v) for k, v in tr.last_losses.items()}
    traces = os.listdir(os.path.join(tr.file_name, "profile"))
    print(f"  device binning: 2 steps at B={B}, losses {losses}; --profile "
          f"1 wrote {traces}")
    if not all(np.isfinite(v) for v in losses.values()):
        fail(f"device binning: a loss is not finite: {losses}")
    if len(traces) != 1:
        fail(f"--profile 1 wrote {traces}")
    loader_alone(tr, B, "raw events")
    del tr
    host_cost(exp, "raw events")
    shutil.rmtree(root, ignore_errors=True)
    print(f"  phase 7 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------- phase 8

EVAL_GEN1 = "gen1_syolox_m"
EVAL_BATCH = 64  # the eval CLI's -b in phase 8
EVAL_OPTS: list = []  # extra 'key value' overrides (a CPU rehearsal's)


def truth_forward(ds, num_classes: int, batch: int, scale: float):
    """A forward_fn that returns each batch's ground truth as decoded,
    letterboxed predictions (obj and class score 0.99, the other anchors
    empty), for the map_val loader's sequential order."""
    order = iter(range(len(ds)))

    def forward(frames):
        B = frames.shape[0]
        sids = [next(order) for _ in range(B)]
        boxes = [ds.raw_boxes(*ds.resolve_index(i)) for i in sids]
        A = max(8, max(len(b) for b in boxes))
        out = np.zeros((B, A, 5 + num_classes), np.float32)
        out[:, :, 2:4] = 1e-3
        out[:, :, 4] = 1e-9
        for b, rows in enumerate(boxes):
            for j, (x1, y1, x2, y2, cls) in enumerate(rows):
                out[b, j, :4] = ((x1 + x2) / 2 * scale, (y1 + y2) / 2 * scale,
                                 (x2 - x1) * scale, (y2 - y1) * scale)
                out[b, j, 4] = 0.99
                out[b, j, 5 + int(cls)] = 0.99
        return out

    return forward


class _OneBatch(list):
    """A one-batch stand-in for an evaluator's loader."""

    def __init__(self, batch, dataset):
        super().__init__([batch])
        self.dataset = dataset


def _timing_line(tm: dict) -> str:
    n = tm["samples"]
    loop = tm["data_s"] + tm["forward_s"] + tm["nms_s"] + tm["rows_s"]
    return (f"{n / loop:.2f} frames/s with the loader in the loop ({n} "
            f"frames in {loop:.3f} s; whole pass with the matching "
            f"{tm['wall_s']:.3f} s); forward {1e3 * tm['forward_s'] / n:.3f} "
            f"ms an image (to the host, f32), NMS {1e3 * tm['nms_s'] / n:.3f} "
            f"ms an image, row assembly {1e3 * tm['rows_s'] / n:.3f}; data "
            f"time {tm['data_s'] / loop:.3f} of the loop; gather + matching "
            f"{tm['match_s']:.3f} s")


def profiled_eval_batch(argv_json: str, ckpt: str, batch_path: str) -> int:
    """Phase 8's profiled batch, run as a process of its own: the eval
    CLI's model (``argv_json``, weights from ``ckpt``) on one saved loader
    batch under torch.profiler. Prints the launches by the wrappers'
    counts and by kernel name, with the names expected, as JSON on its
    last line.

    In the process that has run phases 2-7 the profiler recorded none of
    kernel 5's launches in this window, three windows running, while its
    wrapper, which checks every launch, counted them all; a fresh process
    records every launch (the cause is not known)."""
    from eas_snn_tpu_torch.core.checkpoint import load_eval_weights
    from eas_snn_tpu_torch.tools import eval_event
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + PTXAS_FLAGS  # phase 1's builds
    exp, _ = eval_event.build(json.loads(argv_json))
    model = exp.get_model(device=DEV, seed=SEED)
    load_eval_weights(model, ckpt)
    frames = torch.load(batch_path).to(DEV)
    want = {"plif_fwd_kernel": PER_FORWARD["plif_fwd"],
            "conv_wgmma_kernel": sum(PER_FORWARD[k] for k in (
                "conv1x1_plif", "conv3x3_plif", "conv3x3s2_plif")),
            "arsnn_v2_kernel": exp.Tm}

    # the profiler can miss launches of a short window (phase 5): the
    # window opens with a short spin kernel, and a window short of a
    # kernel is profiled again, at most three
    def batch_in_window():
        torch.cuda._sleep(1_000_000)
        exp.detect(model, frames)

    exp.detect(model, frames)  # warm-up
    for attempt in range(3):
        reset_launches()
        rows = profile_call(batch_in_window,
                            f"one eval batch (B={frames.shape[0]})", top=6)
        one = launch_counts()
        by_name = {sym: profiled_total(rows, sym)[1] for sym in want}
        print(f"  launches in the profiled batch (window {attempt + 1}): "
              f"wrappers {one}; by kernel name {by_name}")
        if by_name == want:
            break
    print(json.dumps({"wrappers": one, "by_name": by_name, "want": want}))
    return 0


def phase_eval_entry_point(B: int, workers: int) -> None:
    """Phase 8: the eval entry point (``tools/eval_event.py:main``) on the
    card at full width: ``gen1_syolox_m`` under ``--fp16`` (``deploy()``)
    with calibrated random weights loaded through ``-c``, over a synthetic
    Gen1 val tree (the ap_drift writer); the evaluators' protocol checks
    with the ground truth as predictions, the native matcher against the
    numpy one on the model's rows, the launches of one profiled batch,
    the evaluator's timing split and the ``--energy`` report."""
    import shutil

    from eas_snn_tpu_torch.evaluators import DetEval, EventEvaluator
    from eas_snn_tpu_torch.tools import ap_drift, eval_event
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "outputs", "chip_smoke_phase8")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    data = ap_drift.make_data(os.path.join(root, "gen1"), n_train=0,
                              n_val=3)
    print(f"phase 8: the eval entry point; synthetic Gen1 val tree (the "
          f"ap_drift writer: 3 streams of 40 label groups, "
          f"{ap_drift.H_SENSOR}x{ap_drift.W_SENSOR}) written in "
          f"{time.perf_counter() - t0:.1f} s")
    opts = ["data_dir", data, "data_num_workers", str(workers)] + EVAL_OPTS

    # calibrated random weights, saved as a state dict for -c
    exp, _ = eval_event.build(["-n", EVAL_GEN1, "--fp16"] + opts)
    model = exp.get_model(device=DEV, seed=SEED)
    H, W = exp.test_size
    gen = torch.Generator(device=DEV).manual_seed(SEED + 8)
    with torch.no_grad():
        calibrate_spiking_bn(model, torch.poisson(torch.full(
            (8, exp.Tl, exp.Tm, H, W, exp.in_dim), 0.2, device=DEV),
            generator=gen))
    ckpt = os.path.join(root, "calibrated.pth")
    torch.save(model.state_dict(), ckpt)
    del model

    # protocol checks: the ground truth as predictions gives AP 1
    for proph in (False, True):
        pexp, _ = eval_event.build(["-n", EVAL_GEN1, "--fp16"] + (
            ["--eval_proh"] if proph else []) + opts)
        ev = pexp.get_evaluator(batch_size=B)
        ds = ev.dataloader.dataset
        scale = min(H / ds.img_size[0], W / ds.img_size[1])
        t0 = time.perf_counter()
        ap, ap50, _ = ev.evaluate(truth_forward(ds, pexp.num_classes, B,
                                                scale))
        what = "Prophesee" if proph else "COCO"
        print(f"  {what} protocol, ground truth as predictions over "
              f"{len(ds)} samples: AP {ap:.6f}, AP50 {ap50:.6f} "
              f"({time.perf_counter() - t0:.2f} s)")
        if ap != 1.0 or ap50 != 1.0:
            fail(f"phase 8: {what} AP {ap} / AP50 {ap50} with the ground "
                 "truth as predictions, expected 1.0")

    # the model through the CLI, from zeroed launch counts
    flags = ["-n", EVAL_GEN1, "--fp16", "-b", str(B), "-c", ckpt,
             "--device", DEV]
    argv = flags + opts
    reset_launches()
    t0 = time.perf_counter()
    res = eval_event.main(argv)
    counts = launch_counts()
    ev, tm = res["evaluator"], res["timing"]
    n_batches = -(-tm["samples"] // B)
    print(f"  eval_event.main {' '.join(argv[:6])} ...: AP {res['ap']:.4f}, "
          f"AP50 {res['ap50']:.4f} in {time.perf_counter() - t0:.1f} s "
          f"(model, weights, {res['conv_gflops_per_frame']:.2f} conv "
          f"GFLOPs a frame, {ev.dataloader.num_workers} loader workers "
          f"started); launches {counts}")
    print(f"  first pass (workers starting): {_timing_line(tm)}")
    check_counts("phase 8 (eval entry point)", counts, n_batches, exp.Tm)
    model = exp.get_model(device=DEV, seed=SEED)
    from eas_snn_tpu_torch.core.checkpoint import load_eval_weights
    load_eval_weights(model, ckpt)
    ap2, ap50_2, text = exp.eval(model, ev)
    print(f"  second pass (warm workers): {_timing_line(ev.timing)}; AP "
          f"{ap2:.4f}, AP50 {ap50_2:.4f}")
    print("  " + text.splitlines()[-1].strip())
    if (ap2, ap50_2) != (res["ap"], res["ap50"]):
        fail(f"phase 8: a second pass gave AP {ap2} / {ap50_2}, the first "
             f"{res['ap']} / {res['ap50']}")
    if not np.isfinite(ev.last_rows[0]).all():
        fail("phase 8: non-finite detection rows")

    # one batch of the loader: its copy to the card and the forward alone
    batch = next(iter(ev.dataloader))
    host = batch[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = host.to(DEV)
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: model(frames), 3)
    print(f"  one loader batch (B={frames.shape[0]}, "
          f"{host.numel() * host.element_size() / 1e6:.1f} MB of f32 "
          f"frames): its copy to the card {copy_ms:.3f} ms (pageable host "
          f"memory), the forward alone {fwd_ms:.3f} ms (CUDA events)")
    # the same batch profiled, with the eval kernels by name, in a process
    # of its own (profiled_eval_batch)
    batch_path = os.path.join(root, "batch.pt")
    torch.save(host, batch_path)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke."
         "profiled_eval_batch(*sys.argv[1:]))",
         json.dumps(["-n", EVAL_GEN1, "--fp16"] + opts), ckpt, batch_path],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300)
    lines = r.stdout.splitlines()
    for line in lines[:-1]:
        print(line)
    try:
        got = json.loads(lines[-1])
    except (IndexError, ValueError):
        got = None
    if r.returncode != 0 or got is None:
        fail(f"phase 8: the profiled batch's process exited {r.returncode}: "
             f"{r.stderr[-2000:]}")
    else:
        print(f"  (its process took {time.perf_counter() - t0:.1f} s)")
        check_counts("phase 8 (one profiled batch)", got["wrappers"], 1,
                     exp.Tm)
        if got["by_name"] != got["want"]:
            fail(f"phase 8: kernels by name {got['by_name']} in the "
                 f"profiled batch, expected {got['want']}")

    # the host NMS under load and the matchers on its rows: the head's
    # prediction biases at 0, so that nearly every anchor passes the
    # confidence filter (random weights at the YOLOX bias init keep no
    # box), over the batch's first 8 images through the evaluator
    with torch.no_grad():
        for conv in list(model.head.obj_preds) + list(model.head.cls_preds):
            conv.bias.zero_()
        out = model(frames[:8]).float().cpu().numpy()
    del model
    one = _OneBatch([tuple(x[:8]) if i == 1 else x[:8]
                     for i, x in enumerate(batch)], ev.dataloader.dataset)
    for conf in (exp.test_conf, 0.001):
        load = EventEvaluator(one, (H, W), conf, exp.nmsthre,
                              exp.num_classes)
        load.evaluate(lambda f: out)
        n_in = float((out[..., 4] * out[..., 5:].max(-1) >= conf).sum(1)
                     .mean())
        det_rows, gt_rows = load.last_rows
        print(f"  host NMS under load (head biases 0, 8 images of "
              f"{out.shape[1]} anchors, conf {conf}): {n_in:.1f} boxes an "
              f"image in, {len(det_rows) / 8:.1f} kept, "
              f"{1e3 * load.timing['nms_s'] / 8:.3f} ms an image")
    # the native matcher against the numpy one on those rows
    t0 = time.perf_counter()
    native = DetEval(exp.num_classes).evaluate(det_rows, gt_rows)
    t1 = time.perf_counter()
    plain = DetEval(exp.num_classes, use_native=False).evaluate(
        det_rows, gt_rows)
    t2 = time.perf_counter()
    print(f"  matchers on {len(det_rows)} detection and {len(gt_rows)} "
          f"ground-truth rows: native {t1 - t0:.3f} s, numpy {t2 - t1:.3f} "
          f"s; AP {native.ap:.6f} / {plain.ap:.6f}")
    if not len(det_rows) or not np.array_equal(native.stats, plain.stats):
        fail(f"phase 8: native matcher {native.stats} != numpy "
             f"{plain.stats} on {len(det_rows)} rows")

    # the map_val loader alone at B=8 (more batches than workers): a
    # pass that starts the workers, then a timed one
    lexp, _ = eval_event.build(["-n", EVAL_GEN1, "--fp16"] + opts)
    loader = lexp.get_evaluator(batch_size=8).dataloader
    for what in ("workers starting", "warm workers"):
        t0 = time.perf_counter()
        n = sum(int(b[0].shape[0]) for b in loader)
        dt = time.perf_counter() - t0
        print(f"  the map_val loader alone at B=8, {what}: {n / dt:.2f} "
              f"samples/s ({n} samples, {loader.num_workers} workers; at "
              f"B={B} two batches keep two workers busy)")
    del loader

    # the energy report
    t0 = time.perf_counter()
    e = eval_event.main(flags + ["--energy"] + opts)["energy"]
    print(f"  --energy ({EVAL_GEN1}, Poisson(0.2), one window): "
          f"{e['sops']:.6g} SOPs, {e['dense_macs']:.6g} dense MACs, "
          f"{e['snn_equivalent_macs']:.6g} MACs of the spiking sites if "
          f"dense; {e['snn_energy_mJ']:.6g} + {e['ann_energy_mJ']:.6g} = "
          f"{e['total_energy_mJ']:.6g} mJ a frame "
          f"({time.perf_counter() - t0:.1f} s)")
    if not (e["sops"] > 0 and e["total_energy_mJ"] > 0):
        fail(f"phase 8: energy report {e}")
    del ev, res
    shutil.rmtree(root, ignore_errors=True)
    print(f"  phase 8 took {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------- phases 9 and 10

NCALTECH = "ncaltech_syolox_m"
NC_BATCH = 32            # the reference's N-Caltech batch (readme.md:147)
NC_EVENTS = 100_000      # events a recording
NC_SACCADE_US = 100_000  # three saccades a recording
GEN4_RAW = ["data_name", "gen4", "Tl", "1"]  # the 1Mpx preset on raw data
GEN4_SENSOR = (720, 1280)
GEN4_EVENTS_PER_S = 1_000_000
GEN4_LABEL_DT_US = 250_000  # beyond the protocol's +-50 ms window


def write_ncaltech_tree(root: str, n_classes: int, per_class: int,
                        seed: int) -> dict:
    """N-Caltech101's layout written with the port's writers: ``n_classes``
    class folders and ``BACKGROUND_Google`` under ``Caltech101/`` and
    ``Caltech101_annotations/``, ``per_class`` recordings each at the
    240x180 sensor: NC_EVENTS events over three saccades of NC_SACCADE_US
    (each a burst around its middle), 70% of them on the object's box and
    the rest anywhere, and one box of 40-120 x 40-100 px."""
    from eas_snn_tpu_torch.data.ncaltech import (encode_atis,
                                                 write_ncaltech_annotation)
    rng = np.random.default_rng(seed)
    H, W = 180, 240
    names = [f"class_{c:03d}" for c in range(n_classes)]
    for cls in names + ["BACKGROUND_Google"]:
        ddir = os.path.join(root, "Caltech101", cls)
        adir = os.path.join(root, "Caltech101_annotations", cls)
        os.makedirs(ddir)
        os.makedirs(adir)
        for i in range(per_class):
            x1, y1 = int(rng.integers(0, 120)), int(rng.integers(0, 80))
            x2 = min(x1 + int(rng.integers(40, 121)), W - 1)
            y2 = min(y1 + int(rng.integers(40, 101)), H - 1)
            n = NC_EVENTS
            sacc = rng.integers(0, 3, n)
            t = np.sort(sacc * NC_SACCADE_US + np.clip(rng.normal(
                NC_SACCADE_US / 2, NC_SACCADE_US / 5, n), 0,
                NC_SACCADE_US - 1).astype(np.int64))
            on = rng.random(n) < 0.7
            x = np.where(on, rng.integers(x1, x2 + 1, n),
                         rng.integers(0, W, n))
            y = np.where(on, rng.integers(y1, y2 + 1, n),
                         rng.integers(0, H, n))
            with open(os.path.join(ddir, f"image_{i:04d}.bin"), "wb") as f:
                f.write(encode_atis(t, x, y, rng.integers(0, 2, n)))
            write_ncaltech_annotation(
                os.path.join(adir, f"annotation_{i:04d}.bin"),
                [x1, y1, x2, y2])
    n_rec = (n_classes + 1) * per_class
    return dict(classes=n_classes, recordings=n_rec, events=n_rec * NC_EVENTS)


def write_gen4_tree(root: str, streams: int, groups: int, seed: int) -> dict:
    """A raw 1Mpx directory written with the port's writers: each stream a
    720x1280 ``<seq>_td.dat`` of uniform events at GEN4_EVENTS_PER_S and a
    ``<seq>_bbox.npy`` of ``groups`` label groups GEN4_LABEL_DT_US apart
    from 0.6 s on (the protocol skips the first 0.5 s), 2-4 boxes of 60-300
    x 40-200 px each over all 7 classes, the first a pedestrian, two
    wheeler or car (the raw reader keeps those three)."""
    from eas_snn_tpu_torch.data.psee_io import (write_bboxes_npy,
                                                write_dat_events)
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    H, W = GEN4_SENSOR
    n_events = 0
    for s in range(streams):
        dur = 600_000 + groups * GEN4_LABEL_DT_US
        n = GEN4_EVENTS_PER_S * dur // 1_000_000
        write_dat_events(os.path.join(root, f"moorea_{s}_td.dat"),
                         np.sort(rng.integers(0, dur, n)),
                         rng.integers(0, W, n), rng.integers(0, H, n),
                         rng.integers(0, 2, n), height=H, width=W)
        rows = []
        for k in range(groups):
            for j in range(int(rng.integers(2, 5))):
                w, h = rng.uniform(60, 300), rng.uniform(40, 200)
                cls = int(rng.integers(0, 3 if j == 0 else 7))
                rows.append((600_000 + k * GEN4_LABEL_DT_US,
                             rng.uniform(0, W - w), rng.uniform(0, H - h),
                             w, h, cls, j, 1.0))
        write_bboxes_npy(os.path.join(root, f"moorea_{s}_bbox.npy"), rows)
        n_events += n
    return dict(streams=streams, groups=streams * groups, events=n_events)


def calibrated_checkpoint(exp, path: str, seed: int) -> None:
    """The exp's model with calibrated random weights, saved as a state
    dict for the eval CLI's ``-c``."""
    model = exp.get_model(device=DEV, seed=SEED)
    H, W = exp.test_size
    gen = torch.Generator(device=DEV).manual_seed(seed)
    with torch.no_grad():
        calibrate_spiking_bn(model, torch.poisson(torch.full(
            (4, exp.Tl, exp.Tm, H, W, exp.in_dim), 0.2, device=DEV),
            generator=gen))
    torch.save(model.state_dict(), path)


def train_through_cli(argv: list, B: int, steps: int, workers: int,
                      phase: str, per_step=PER_STEP) -> tuple:
    """``argv`` through the train CLI's parser, ``exp.get_data_loader``
    (``workers`` forked workers) and ``Trainer`` on the card: images/s
    with the loader in the loop over the last ``steps`` captured steps
    (after the batches the workers had ready), the data-time share, peak
    allocated and reserved memory, finite losses, the train PLIF launches
    of the eager warm-up and the capture (the wrappers' counts:
    ``per_step``, 50 + 50 a step at the flagship, no eval kernel) and of 2
    profiled replays (by kernel name). Returns the profiled rows and the
    wrappers' launches a step."""
    from eas_snn_tpu_torch.core.train_state import CapturedStep
    from eas_snn_tpu_torch.tools.train_event import build
    drain = 2 * workers + 2
    n_iters = CapturedStep.WARMUP + 1 + drain + steps
    exp, args = build(argv + ["data_num_workers", str(workers),
                              "max_epoch", "1", "print_interval",
                              str(n_iters), "seed", str(SEED),
                              "eval_interval", "10"])
    exp.iters_per_epoch = n_iters
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = exp.get_trainer(args, device=DEV)
    reset_launches()
    t0 = time.perf_counter()
    tr.before_train()
    print(f"  Trainer.before_train ({tr.train_loader.num_workers} forked "
          f"loader workers, first batch) in {time.perf_counter() - t0:.1f} "
          f"s; dataset {len(tr.train_loader.dataset)} samples", flush=True)
    stamps, step = [], tr.step_fn

    def timed_step(*a, **k):
        out = step(*a, **k)
        stamps.append(time.perf_counter())
        return out

    tr.step_fn = timed_step
    tr._batches = TimedBatches(tr._batches)
    tr.before_epoch()
    tr.train_in_iter()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    tr.step_fn = step
    counts = launch_counts()
    wall = t_end - stamps[-steps - 1]
    data_s = sum(tr._batches.seconds[-steps:])
    losses = {k: float(v) for k, v in tr.last_losses.items()}
    print(f"  {len(stamps)} steps at B={B} ({step.WARMUP} eager warm-up, "
          f"then captured; {step.replays} replays): {B * steps / wall:.2f} "
          f"images/s with the loader in the loop over the last {steps} "
          f"({wall / steps * 1e3:.3f} ms a step, host clock to a "
          f"synchronize); data_time {data_s / wall:.3f} of iter_time; peak "
          f"allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
          f"reserved {torch.cuda.memory_reserved() / 2**30:.3f} GiB; "
          f"losses {losses}", flush=True)
    if not all(np.isfinite(v) for v in losses.values()):
        fail(f"phase {phase}: a loss is not finite: {losses}")
    if step.replays != n_iters - step.WARMUP:
        fail(f"phase {phase}: {step.replays} replays, expected "
             f"{n_iters - step.WARMUP}")
    want = {k: (step.WARMUP + 1) * per_step.get(k, 0) for k in counts}
    print(f"  launches of the warm-up and the capture (the wrappers' "
          f"counts): {counts}")
    if counts != want:
        fail(f"phase {phase}: launches {counts} over the warm-up and the "
             f"capture, expected {want}")
    tr.iters_per_epoch = 2
    rows = profile_call(tr.train_in_iter, f"2 trainer steps at B={B} "
                        "(captured, the loader in the loop)", top=6)
    plif = {k: profiled_total(rows, k)[1]
            for k in ("plif_fwd_kernel", "plif_bwd")}
    print(f"  PLIF launches in the 2 profiled replays, by kernel name: "
          f"{plif}")
    if plif != {"plif_fwd_kernel": 2 * per_step.get("plif_train_fwd", 0),
                "plif_bwd": 2 * per_step.get("plif_train_bwd", 0)}:
        fail(f"phase {phase}: PLIF launches {plif} in 2 replays, expected "
             f"{per_step} a step")
    tr.after_train()
    return rows, {k: v // (step.WARMUP + 1) for k, v in counts.items()}


def eval_through_cli(flags: list, opts: list, B: int, phase: str,
                     base=UNFUSED_PER_FORWARD, v2: bool = True) -> tuple:
    """``tools/eval_event.py:main`` from zeroed launch counts, which must
    be ``base`` (50 of the PLIF kernel at 640x640 and 384x640) + Tm of
    kernel 5 (with ``v2``) a batch and nothing else; prints the
    evaluator's split. Returns what ``main`` reported and the wrappers'
    launches a batch."""
    from eas_snn_tpu_torch.tools import eval_event
    reset_launches()
    t0 = time.perf_counter()
    res = eval_event.main(flags + opts)
    counts = launch_counts()
    tm = res["evaluator"].timing
    n_batches = -(-tm["samples"] // B)
    print(f"  eval_event.main {' '.join(flags[:6])} ...: AP "
          f"{res['ap']:.4f}, AP50 {res['ap50']:.4f} in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({res['conv_gflops_per_frame']:.2f} conv GFLOPs a frame); "
          f"launches {counts}")
    print(f"  {_timing_line(tm)}", flush=True)
    exp, _ = eval_event.build(flags + opts)
    check_counts(f"phase {phase} (eval entry point)", counts, n_batches,
                 exp.Tm if v2 else 0, base)
    if not np.isfinite(res["ap"]):
        fail(f"phase {phase}: AP {res['ap']}")
    return res, {k: v // n_batches for k, v in counts.items()}


def truth_ap(pexp, B: int, what: str, phase: str, box_dir=None):
    """The exp's evaluator fed the ground truth as letterboxed predictions
    (box files under ``box_dir``): AP and AP50 must be 1.0."""
    ev = pexp.get_evaluator(batch_size=B)
    if box_dir:
        ev.box_dir = box_dir
    ds = ev.dataloader.dataset
    H, W = pexp.test_size
    scale = min(H / ds.img_size[0], W / ds.img_size[1])
    t0 = time.perf_counter()
    ap, ap50, _ = ev.evaluate(truth_forward(ds, pexp.num_classes, B, scale))
    print(f"  {what} protocol, ground truth as predictions over {len(ds)} "
          f"samples, {pexp.num_classes} classes: AP {ap:.6f}, AP50 "
          f"{ap50:.6f} ({time.perf_counter() - t0:.2f} s)", flush=True)
    if ap != 1.0 or ap50 != 1.0:
        fail(f"phase {phase}: {what} AP {ap} / AP50 {ap50} with the ground "
             "truth as predictions, expected 1.0")
    return ap, ap50


def folders_ap(box_dir: str, want, phase: str, what: str) -> None:
    """The port's ``psee_evaluate_folders`` over the saved box files must
    give the evaluator's (AP, AP50)."""
    from eas_snn_tpu_torch.tools import psee_evaluate_folders
    with contextlib.redirect_stdout(io.StringIO()):
        got = psee_evaluate_folders.main(
            ["--gt", os.path.join(box_dir, "gt"), "--dt",
             os.path.join(box_dir, "dt"), "--camera", "gen4"])
    print(f"  psee_evaluate_folders over the box files of {what}: AP "
          f"{got['AP']:.6f}, AP50 {got['AP_50']:.6f} (the evaluator: "
          f"{want[0]:.6f}, {want[1]:.6f})")
    if (got["AP"], got["AP_50"]) != tuple(want):
        fail(f"phase {phase}: the folder evaluation of {what} gave "
             f"{got['AP']} / {got['AP_50']}, the evaluator {want}")


def ncaltech_kernels() -> int:
    """Phases 9a-9c, run as a process of its own: the eval kernels at
    every site geometry of ``ncaltech_syolox_m``'s deploy forward at B=32
    (phases 2 and 2b's checks), kernel 5 at its sampler geometry, and the
    train kernels at every train-step site geometry at the preset's alpha
    (phase 5's). Returns the exit code: 1 if a check failed.

    In the process that has run phases 2-8, torch.profiler recorded no
    launch of the PLIF kernels in most of these windows, three windows a
    site running, as it misses kernel 5 in phase 8's batch there; a fresh
    process records them."""
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + PTXAS_FLAGS  # phase 1's builds
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    exp = get_exp(NCALTECH).deploy()
    model = exp.get_model(device=DEV, seed=SEED)
    H, W = exp.test_size
    gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    ev = torch.poisson(torch.full((NC_BATCH, exp.Tl, exp.Tm, H, W,
                                   exp.in_dim), 0.2, device=DEV),
                       generator=gen)
    with torch.no_grad():
        calibrate_spiking_bn(model, ev[:4])
        _, refused = phase_kernels(
            model, ev, SEED, UNFUSED_PER_FORWARD, phase="9a",
            what=f"{NCALTECH} deploy ({H}x{W}, B={NC_BATCH})", extras=False,
            sites_phase="9b")
        print(f"  wgmma refusals at {H}x{W}: {len(refused)} site geometries "
              f"({sum(r[1] for r in refused)} sites)")
        sev = sampler_events(model, ev)
        r = check_v2(f"at {NCALTECH}", sev, *model.embedding.stack_weights(),
                     model.embedding.scan_kwargs(), timed=True)
        print(f"  arsnn_v2 at {tuple(sev.shape)} {str(sev.dtype)[6:]}: "
              f"{r['mismatch']} of {r['n']} slots differ, {r['written']:.4f} "
              f"non-zero; call {r['ms']:.4f} ms (kernel "
              f"{r['kernel_ms']:.4f}), plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    del model, ev, sev
    torch.cuda.empty_cache()

    texp = get_exp(NCALTECH)
    tmodel = texp.get_model(device=DEV, seed=SEED, train=True)
    events = torch.poisson(torch.full((NC_BATCH, texp.Tl, texp.Tm, H, W,
                                       texp.in_dim), 0.2, device=DEV),
                           generator=gen)
    labels = random_labels(NC_BATCH, H, W, np.random.default_rng(SEED + 9))
    phase_train_kernels(tmodel, events, labels.to(DEV), SEED, phase="9c",
                        extras=False, alpha=texp.alpha)
    return 1 if FAILURES else 0


def phase_ncaltech(steps: int, workers: int) -> str:
    """Phase 9: ``ncaltech_syolox_m`` (640x640, 100 classes, alpha 1.5).
    Returns its synthetic tree's directory, which phase 12a reads and
    removes."""
    import shutil

    from eas_snn_tpu_torch.tools import eval_event
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "outputs", "chip_smoke_phase9")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "ncaltech")
    t0 = time.perf_counter()
    tree = write_ncaltech_tree(data, n_classes=100, per_class=5, seed=SEED)
    print(f"phase 9: N-Caltech101 ({NCALTECH}); synthetic tree "
          f"({tree['classes']} classes and BACKGROUND_Google, "
          f"{tree['recordings']} recordings, {tree['events']} events at "
          f"240x180) written in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # the kernel checks (9a-9c) in a process of their own
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.ncaltech_kernels())"], cwd=here,
        capture_output=True, text=True, timeout=900)
    print(r.stdout.rstrip())
    print(f"  (the kernel checks' process took "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    if r.returncode != 0:
        fail(f"phase 9a-9c: the kernel checks' process exited "
             f"{r.returncode}: {r.stderr[-2000:]}")
    torch.cuda.empty_cache()

    print(f"phase 9d: training through the CLI at B={NC_BATCH}", flush=True)
    train_through_cli(["-n", NCALTECH, "-b", str(NC_BATCH), "-l", "jsonl",
                       "data_dir", data, "output_dir",
                       os.path.join(root, "out")], NC_BATCH, steps, workers,
                      "9d")
    torch.cuda.empty_cache()

    print("phase 9e: evaluation", flush=True)
    opts = ["data_dir", data, "data_num_workers", str(workers)]
    pexp, _ = eval_event.build(["-n", NCALTECH, "--fp16"] + opts)
    truth_ap(pexp, NC_BATCH, "COCO", "9e")
    ckpt = os.path.join(root, "calibrated.pth")
    calibrated_checkpoint(pexp, ckpt, SEED + 9)
    eval_through_cli(["-n", NCALTECH, "--fp16", "-b", str(NC_BATCH), "-c",
                      ckpt, "--device", DEV], opts, NC_BATCH, "9e")
    shutil.rmtree(os.path.join(root, "out"), ignore_errors=True)
    print(f"  phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return data


def phase_gen4(steps: int, workers: int) -> None:
    """Phase 10: the 1Mpx model (``gen4_rvt_syolox_m``, 384x640, 3
    classes) on raw Gen4 streams (GEN4_RAW)."""
    import shutil

    from eas_snn_tpu_torch.tools import eval_event
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "outputs", "chip_smoke_phase10")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "gen4")
    t0 = time.perf_counter()
    tree = write_gen4_tree(os.path.join(data, "train"), streams=2, groups=16,
                           seed=SEED)
    val = write_gen4_tree(os.path.join(data, "val"), streams=2, groups=12,
                          seed=SEED + 1)
    print(f"phase 10: 1Mpx (gen4_rvt_syolox_m with {' '.join(GEN4_RAW)}: "
          f"the raw reader stacks Tl windows of Tm micro-frames a label, the "
          f"model takes one); raw tree ({tree['streams']} streams, "
          f"{tree['groups']} label groups, {tree['events']} events at "
          f"{GEN4_EVENTS_PER_S} events/s, {GEN4_SENSOR[0]}x{GEN4_SENSOR[1]};"
          f" val {val['groups']} groups, {val['events']} events) written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    B = GEN4_BATCH
    train_through_cli(["-n", "gen4_rvt_syolox_m", "-b", str(B), "-l",
                       "jsonl", "data_dir", data, "output_dir",
                       os.path.join(root, "out")] + GEN4_RAW, B, steps,
                      workers, "10")
    torch.cuda.empty_cache()

    opts = ["data_dir", data, "data_num_workers", str(workers)] + GEN4_RAW
    pexp, _ = eval_event.build(["-n", "gen4_rvt_syolox_m", "--fp16",
                                "--eval_proh"] + opts)
    truth = os.path.join(root, "truth_boxes")
    want = truth_ap(pexp, B, "Prophesee (camera gen4)", "10", truth)
    folders_ap(truth, want, "10", "the ground truth as predictions")
    ckpt = os.path.join(root, "calibrated.pth")
    calibrated_checkpoint(pexp, ckpt, SEED + 10)
    boxes = os.path.join(root, "boxes")
    res, _ = eval_through_cli(["-n", "gen4_rvt_syolox_m", "--fp16", "-b",
                            str(B), "-c", ckpt, "--device", DEV,
                            "--eval_proh", "--save_boxes", boxes], opts, B,
                           "10")
    if res["evaluator"].camera != "gen4" or res["evaluator"].downsampled_by_2:
        fail("phase 10: the evaluator is not the gen4 camera's at full "
             "resolution")
    folders_ap(boxes, (res["ap"], res["ap50"]), "10", "the model")
    shutil.rmtree(root, ignore_errors=True)
    print(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------- phases 11 and 12

FULL_V2 = ["use_spike", "full_spike_v2"]
FULL_V1 = ["use_spike", "full_spike"]
# launches of a deploy forward of gen1_syolox_m (256x320) on rows 1-4: the
# JAX package's policy applied to the fully spiking detector's sites,
# pinned on the CPU (tests/test_torch_variants.py::
# test_fully_spiking_flagship_site_routing)
FULL_V2_PER_FORWARD = {"plif_fwd": 74, "conv1x1_plif": 14, "conv3x3_plif": 8,
                       "conv3x3s2_plif": 1}
FULL_V1_PER_FORWARD = {"plif_fwd": 60, "conv1x1_plif": 13, "conv3x3_plif": 8,
                       "conv3x3s2_plif": 1}
# the neck's and the head's sites (the backbone's are phase 2's)
FULL_V2_NEW_SITES = {k: FULL_V2_PER_FORWARD[k] - PER_FORWARD[k]
                     for k in PER_FORWARD}
FULL_V2_STEP = {"plif_train_fwd": 97, "plif_train_bwd": 97}
FULL_V1_STEP = {"plif_train_fwd": 82, "plif_train_bwd": 82}
FULL_B = 128          # the deploy forward's batch (phase 3's)
FULL_FORWARDS = 10    # forwards timed in phase 11b
FULL_TRAIN_B = 64     # the train step's batch (phase 6's)
VARIANT_B = 16        # phase 12b's train batch
E_YOLOX = "e_yolox_m"
E_YOLOX_B = 32        # the reference's N-Caltech batch
# every hand-written kernel, by the symbol torch.profiler shows
HAND_KERNELS = ("plif_fwd_kernel", "plif_bwd", "conv_wgmma_kernel",
                "arsnn_v2_kernel", "arsnn_step_kernel")
VARIANTS_12B = (("snn", ["embedding", "snn", "Ts", "1"]),
                ("rsnn", ["embedding", "rsnn", "Ts", "1"]),
                ("norm bn", ["norm", "bn"]),
                ("spike_fn patan", ["spike_fn", "patan"]))


def neck_or_head(name: str) -> bool:
    """A site of the neck or of the head (not of the CSPDarknet)."""
    return not name.startswith("backbone.backbone.")


def site_rates(model, events, where=neck_or_head) -> str:
    """The firing rates of the spiking sites ``where`` accepts in one eval
    forward: min / mean / max over the sites."""
    rates = []
    hs = [m.register_forward_hook(
        lambda m, i, o: rates.append(float(o.float().mean())))
        for n, m in model.named_modules()
        if isinstance(m, BaseConv) and m.neuron.spiking and where(n)]
    with torch.no_grad():
        model(events)
    for h in hs:
        h.remove()
    return (f"{len(rates)} sites, rate min {min(rates):.4f} mean "
            f"{np.mean(rates):.4f} max {max(rates):.4f}") if rates else \
        "no site"


@torch.no_grad()
def stages_card_vs_cpu(phase: str, overrides: list, events) -> None:
    """``gen1_syolox_m`` with ``overrides`` in f32 at B=2, card (kernels,
    cuDNN) against CPU (plain versions), stage by stage as phase 4 does:
    the embedding on the same events and the analog stem on the card's
    embedding output (ANALOG_TOL), every spiking site on the card's input
    (at most SITE_TOL of its spikes flip), and the head's prediction convs
    and box decode on the card's tower outputs (1e-3 relative)."""
    exp = get_exp("gen1_syolox_m").merge(overrides)
    exp.compute_dtype = "float32"
    cpu_model = exp.get_model(device="cpu", seed=SEED)
    calibrate_spiking_bn(cpu_model, events)
    gpu_model = exp.get_model(device=DEV, seed=SEED)
    gpu_model.load_state_dict(cpu_model.state_dict())
    sites, seen, towers = OrderedDict(), {}, {}

    def keep(name):
        def hook(mod, args, out):
            xs = args[0] if isinstance(args[0], (tuple, list)) else args[:1]
            sites[name] = (tuple(p.cpu() for p in xs), out.cpu())
        return hook

    def tower_mods(model):
        return {(kind, k): getattr(model.head, f"{kind}_convs")[k]
                for kind in ("cls", "reg") for k in range(3)}

    hs = [m.register_forward_hook(keep(n))
          for n, m in gpu_model.named_modules()
          if isinstance(m, BaseConv) and m.neuron.spiking]
    hs += [m.register_forward_hook(
        lambda m, i, o, n=n: towers.update({n: o.cpu()}))
        for n, m in tower_mods(gpu_model).items()]
    hs.append(gpu_model.embedding.register_forward_hook(
        lambda m, i, o: seen.update(embedding=o.cpu())))
    bb = gpu_model.backbone.backbone
    hs.append(bb.stem.register_forward_hook(
        lambda m, i, o: seen.update(stem_in=i[0].cpu(), stem=o.cpu())))
    gpu = gpu_model(events.to(DEV)).float().cpu()
    for h in hs:
        h.remove()
    _check_analog(f"{overrides}: embedding output", seen["embedding"],
                  cpu_model.embedding(events), phase)
    _check_analog(f"{overrides}: stem output", seen["stem"],
                  cpu_model.backbone.backbone.stem(seen["stem_in"]), phase)
    cpu_mods = dict(cpu_model.named_modules())
    worst, n_diff, n_all = 0.0, 0, 0
    for name, (xs, y_card) in sites.items():
        y = cpu_mods[name](xs if len(xs) > 1 else xs[0])
        d = int((y != y_card).sum())
        worst = max(worst, d / y.numel())
        n_diff, n_all = n_diff + d, n_all + y.numel()
    print(f"  {len(sites)} spiking sites on the card's inputs: {n_diff} of "
          f"{n_all} spikes differ, worst site {worst:.2e} (tolerance "
          f"{SITE_TOL:.0e})")
    if not sites or worst > SITE_TOL:
        fail(f"phase {phase}: {overrides}: spiking sites disagree between "
             "card and CPU")
    # the prediction convs and the decode on the card's tower outputs
    hs = [m.register_forward_hook(lambda m, i, o, n=n: towers[n])
          for n, m in tower_mods(cpu_model).items()]
    tail = cpu_model(events).float()
    for h in hs:
        h.remove()
    rel = float(_rel_err(gpu, tail).max())
    print(f"  {overrides}: head predictions and decode on the card's tower "
          f"outputs: max |card - cpu| / (1 + |cpu|) {rel:.3e} (tolerance "
          "1e-3)")
    if not torch.isfinite(gpu).all() or rel > 1e-3:
        fail(f"phase {phase}: {overrides}: decoded outputs disagree on the "
             "same tower outputs")


def captured_step_check(phase: str, exp, events, labels, per_step: dict,
                        steps: int = 0) -> dict:
    """``exp``'s train step at the events' batch as CUDA graphs
    (``CapturedStep``): the wrappers' launches over the eager warm-up and
    the capture (``per_step`` a step, no eval kernel), with ``steps``
    eager and captured steps timed in turns (ms/step, images/s, peak
    memory), then from one snapshot a captured step against an eager one
    (the eager step's own difference as tolerance: its bits). Returns the
    launches a step."""
    from eas_snn_tpu_torch.core.train_state import CapturedStep
    B = events.shape[0]
    model = exp.get_model(device=DEV, seed=SEED + 1, train=True)
    opt = exp.get_optimizer(model, B, iters_per_epoch=1000)
    ema = init_ema(model) if exp.ema else None
    step = CapturedStep(model, opt, ema)
    eager = lambda e, t: train_step(model, opt, ema, e, t)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(step.WARMUP + 1):
        step(events, labels)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"  {step.WARMUP} warm-up steps, capture and first replay at B={B} "
          f"in {time.perf_counter() - t0:.2f} s, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
          f"(the wrappers' counts over the warm-up and the capture) {counts}")
    want = {k: (step.WARMUP + 1) * per_step.get(k, 0) for k in counts}
    if counts != want:
        fail(f"phase {phase}: launches {counts}, expected {want}")
    for name in (("eager", "captured", "captured", "eager") if steps
                 else ()):
        fn = step if name == "captured" else eager
        ms, ips, peak, losses = timed_steps(fn, events, labels, steps)
        print(f"  B={B} {name:8s}: {ms:.3f} ms/step, {ips:.2f} images/s "
              f"({steps} steps, host clock), peak allocated {peak:.3f} GiB; "
              f"total loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        if not all(np.isfinite(losses)):
            fail(f"phase {phase}: {name}: a loss is not finite")
    if steps:
        rows = profile_call(lambda: [step(events, labels) for _ in range(3)],
                            f"3 captured steps at B={B}", top=6)
        by_name = {k: profiled_total(rows, k)[1]
                   for k in ("plif_fwd_kernel", "plif_bwd")}
        print(f"  train PLIF launches in the 3 profiled replays, by kernel "
              f"name: {by_name}")
        if by_name != {"plif_fwd_kernel": 3 * per_step["plif_train_fwd"],
                       "plif_bwd": 3 * per_step["plif_train_bwd"]}:
            fail(f"phase {phase}: launches by name {by_name} in 3 replays, "
                 f"expected 3 x {per_step}")
    snap = snapshot(model, opt, ema)
    check_step_pair(f"phase {phase} B={B}", step_pair(
        step, model, opt, ema, snap, events, labels), opt.lr_schedule(0))
    return {k: v // (step.WARMUP + 1) for k, v in counts.items()}


def full_spike_phases() -> int:
    """Phases 11a-11c and 11e, run as a process of its own (the profiler
    records every launch of a fresh process, PERF.md §7): the fully
    spiking detector (``gen1_syolox_m`` with ``use_spike full_spike_v2``,
    then ``full_spike``). Prints, as JSON on its last line, the launches
    a forward and a step of each path and the neck/head sites' kernel
    sums. Returns the exit code: 1 if a check failed."""
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + PTXAS_FLAGS  # phase 1's builds
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    exp = get_exp("gen1_syolox_m").deploy().merge(FULL_V2)
    H, W = exp.test_size
    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    shape = (FULL_B, exp.Tl, exp.Tm, H, W, exp.in_dim)
    batches = [torch.poisson(torch.full(shape, 0.2, device=DEV),
                             generator=gen) for _ in range(FULL_FORWARDS)]
    with torch.no_grad():
        model = exp.get_model(device=DEV, seed=SEED)
        calibrate_spiking_bn(model, batches[0][:8])
        print(f"  neck and head firing (calibrated BN, B={FULL_B}): "
              f"{site_rates(model, batches[0])}")
        per_kernel, refused = phase_kernels(
            model, batches[0], SEED + 11, FULL_V2_NEW_SITES, phase="11a",
            what=f"full_spike_v2 neck/head (deploy, B={FULL_B})",
            extras=False, sites_phase="11a (wgmma, direct)",
            where=neck_or_head)
        out["eval_sites"] = {k: {f: v[f] for f in (
            "ms", "kernel_ms", "plain_ms", "bound_ms", "max_abs_err",
            "sites")} for k, v in per_kernel.items() if v["sites"]}
        print(f"  wgmma refusals at the neck/head sites: {len(refused)} "
              f"geometries ({sum(r[1] for r in refused)} sites)")

        print(f"phase 11b: the full_spike_v2 deploy forward, "
              f"{FULL_FORWARDS} forwards at B={FULL_B} (detect)", flush=True)
        fps, counts, peak, dets, dt = run_detect(exp, model, batches)
        print(f"  frames/s {fps:.2f} (host clock, {len(dets)} frames in "
              f"{dt:.4f} s), peak memory {peak:.3f} GiB; launches {counts}")
        check_counts("phase 11b (full_spike_v2 forward)", counts,
                     FULL_FORWARDS, exp.Tm, FULL_V2_PER_FORWARD)
        out["full_v2_forward"] = {k: v // FULL_FORWARDS
                                  for k, v in counts.items()}
        layer_times(model, batches[0])
        rows = profile_call(lambda: model(batches[0]),
                            "one full_spike_v2 forward")
        by_name = {k: profiled_total(rows, k)[1] for k in (
            "plif_fwd_kernel", "conv_wgmma_kernel", "arsnn_v2_kernel")}
        want = {"plif_fwd_kernel": FULL_V2_PER_FORWARD["plif_fwd"],
                "conv_wgmma_kernel": sum(
                    v for k, v in FULL_V2_PER_FORWARD.items()
                    if k != "plif_fwd"), "arsnn_v2_kernel": exp.Tm}
        print(f"  launches in the profiled forward, by kernel name: "
              f"{by_name}")
        if by_name != want:
            fail(f"phase 11b: kernels by name {by_name}, expected {want}")
        del model, batches
        torch.cuda.empty_cache()
        small = torch.poisson(torch.full((2,) + shape[1:], 0.2),
                              generator=torch.Generator().manual_seed(SEED))
        print("  card vs CPU, full_spike_v2 in f32 at B=2, stage by stage:")
        stages_card_vs_cpu("11b", FULL_V2, small)
    torch.cuda.empty_cache()

    texp = get_exp("gen1_syolox_m").merge(FULL_V2)
    B = FULL_TRAIN_B
    gen = torch.Generator(device=DEV).manual_seed(SEED + 12)
    events = torch.poisson(torch.full((B, texp.Tl, texp.Tm, H, W,
                                       texp.in_dim), 0.2, device=DEV),
                           generator=gen)
    labels = random_labels(B, H, W, np.random.default_rng(SEED + 11)).to(DEV)
    tmodel = texp.get_model(device=DEV, seed=SEED, train=True)
    out["train_sites"] = phase_train_kernels(
        tmodel, events, labels, SEED + 11, phase="11a (train)", extras=False,
        alpha=texp.alpha, where=neck_or_head,
        expect_sites=FULL_V2_STEP["plif_train_fwd"] - PER_STEP[
            "plif_train_fwd"])
    del tmodel
    torch.cuda.empty_cache()
    print(f"phase 11c: the full_spike_v2 train step as CUDA graphs at B={B} "
          "(Adam, EMA)", flush=True)
    out["full_v2_step"] = captured_step_check("11c", texp, events, labels,
                                              FULL_V2_STEP, steps=8)
    torch.cuda.empty_cache()

    print("phase 11e: full_spike: one deploy forward and one captured step",
          flush=True)
    dexp = get_exp("gen1_syolox_m").deploy().merge(FULL_V1)
    with torch.no_grad():
        model = dexp.get_model(device=DEV, seed=SEED)
        calibrate_spiking_bn(model, events[:8])
        _, counts, peak, _, dt = run_detect(dexp, model, [events])
    print(f"  one forward at B={B}: {dt * 1e3:.3f} ms (host clock), peak "
          f"{peak:.3f} GiB; launches {counts}")
    check_counts("phase 11e (full_spike forward)", counts, 1, dexp.Tm,
                 FULL_V1_PER_FORWARD)
    out["full_forward"] = counts
    del model
    torch.cuda.empty_cache()
    out["full_step"] = captured_step_check(
        "11e", get_exp("gen1_syolox_m").merge(FULL_V1), events, labels,
        FULL_V1_STEP)
    print(json.dumps(out))
    return 1 if FAILURES else 0


def _backbone_only_state(sd: dict) -> dict:
    """A full_spike_v2 state dict as the backbone-only detector's: the
    neck's and head's convs out of their SeqToANN containers, their PLIF
    decays dropped."""
    out = {}
    for k, v in sd.items():
        if k.startswith("backbone.backbone.") or k.startswith("embedding."):
            out[k] = v
        elif k.endswith(".act.w"):
            continue
        else:
            out[k.replace(".conv.0.weight", ".conv.weight")] = v
    return out


def phase_full_spike(steps: int, workers: int) -> dict:
    """Phase 11: the fully spiking Gen1 detector. 11a-11c and 11e in a
    process of their own (``full_spike_phases``); 11d, the CLIs, here.
    Returns the child's JSON result."""
    import shutil

    from eas_snn_tpu_torch.tools import ap_drift, eval_event
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    print("phase 11: the fully spiking Gen1 detector (gen1_syolox_m with "
          "use_spike full_spike_v2: spiking backbone, neck and head)",
          flush=True)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.full_spike_phases())"], cwd=here,
        capture_output=True, text=True, timeout=900)
    lines = r.stdout.rstrip().splitlines()
    print("\n".join(lines[:-1]))
    print(f"  (the process of phases 11a-11c and 11e took "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    try:
        res = json.loads(lines[-1])
    except (IndexError, ValueError):
        res = {}
    if r.returncode != 0 or not res:
        fail(f"phase 11a-11e: the process exited {r.returncode}: "
             f"{r.stderr[-2000:]}")
    torch.cuda.empty_cache()

    root = os.path.join(here, "outputs", "chip_smoke_phase11")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "gen1")
    t0 = time.perf_counter()
    tree = write_gen1_tree(os.path.join(data, "train"), streams=2, groups=16,
                           seed=SEED + 11)
    val = ap_drift.make_data(os.path.join(root, "val"), n_train=0, n_val=1)
    print(f"phase 11d: the CLIs on full_spike_v2; synthetic Gen1 train tree "
          f"({tree['streams']} streams, {tree['groups']} label groups) and "
          f"an ap_drift val tree (1 stream of 40 label groups) written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    B = FULL_TRAIN_B
    train_through_cli(["-n", "gen1_syolox_m", "-b", str(B), "-l", "jsonl",
                       "data_dir", data, "output_dir",
                       os.path.join(root, "out")] + FULL_V2, B, steps,
                      workers, "11d", per_step=FULL_V2_STEP)
    torch.cuda.empty_cache()
    opts = ["data_dir", val, "data_num_workers", str(workers)] + FULL_V2
    pexp, _ = eval_event.build(["-n", "gen1_syolox_m", "--fp16"] + opts)
    truth_ap(pexp, B, "COCO", "11d")
    ckpt = os.path.join(root, "calibrated.pth")
    calibrated_checkpoint(pexp, ckpt, SEED + 11)
    flags = ["-n", "gen1_syolox_m", "--fp16", "-b", str(B), "-c", ckpt,
             "--device", DEV]
    eval_through_cli(flags, opts, B, "11d", base=FULL_V2_PER_FORWARD)
    # the energy report, against the backbone-only detector on the same
    # weights
    e2 = eval_event.main(flags + ["--energy"] + opts)["energy"]
    ckpt1 = os.path.join(root, "backbone_only.pth")
    torch.save(_backbone_only_state(torch.load(ckpt)), ckpt1)
    e1 = eval_event.main(flags[:-4] + ["-c", ckpt1, "--device", DEV,
                                       "--energy"] + opts[:-2])["energy"]
    share = {}
    for what, e in (("full_spike_v2", e2), ("backbone only", e1)):
        share[what] = e["snn_equivalent_macs"] / (
            e["snn_equivalent_macs"] + e["dense_macs"])
        print(f"  --energy {what}: {e['sops']:.6g} SOPs, "
              f"{e['dense_macs']:.6g} dense MACs, "
              f"{e['snn_equivalent_macs']:.6g} MACs at the spiking sites if "
              f"dense (spiking share of the conv work "
              f"{share[what]:.4f}); {e['snn_energy_mJ']:.6g} + "
              f"{e['ann_energy_mJ']:.6g} = {e['total_energy_mJ']:.6g} mJ a "
              "frame")
    if not share["full_spike_v2"] > share["backbone only"] or not e2[
            "sops"] > e1["sops"]:
        fail(f"phase 11d: the spiking share {share} does not grow with the "
             "spiking neck and head")
    shutil.rmtree(root, ignore_errors=True)
    print(f"  phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return res


def phase_variants(nc_data: str, steps: int, workers: int) -> dict:
    """Phase 12: ``e_yolox_m`` (count embedding, analog YOLOX, 640x640,
    100 classes, f32) through both CLIs on phase 9's synthetic
    N-Caltech101 tree (``nc_data``, removed after), launching no
    hand-written kernel; then the snn and rsnn embeddings, the
    post-embedding BN and patan on ``gen1_syolox_m``'s widths. Returns
    the wrappers' launches a step and an eval batch of ``e_yolox_m``."""
    import shutil

    from eas_snn_tpu_torch.tools import eval_event
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "outputs", "chip_smoke_phase12")
    shutil.rmtree(root, ignore_errors=True)
    data = nc_data
    print(f"phase 12a: {E_YOLOX} (count embedding, analog YOLOX, f32) on "
          f"phase 9's N-Caltech101 tree", flush=True)
    # torch's defaults, with cuBLAS's TF32 on too: the CLI must turn both
    # off for an f32 preset
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    B = E_YOLOX_B
    rows, out = train_through_cli(
        ["-n", E_YOLOX, "-b", str(B), "-l", "jsonl", "data_dir", data,
         "output_dir", os.path.join(root, "out")], B, steps, workers, "12a",
        per_step={})
    out = {"e_yolox_m_step": out}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    print(f"  TF32 (cuDNN, cuBLAS) after the train CLI's build: {tf32}: the "
          "preset's f32 convs and matmuls run in IEEE f32 "
          "(EventExp.apply_precision), as the JAX package's f32 runs on "
          "the CPU its tests hold the port to")
    if any(tf32):
        fail(f"phase 12a: the train CLI left TF32 {tf32} for an f32 preset")
    by_name = {k: profiled_total(rows, k)[1] for k in HAND_KERNELS}
    print(f"  hand-written kernels in the 2 profiled replays, by name: "
          f"{by_name} (of {sum(r[1] for r in rows)} kernel launches "
          "recorded)")
    if any(by_name.values()) or not rows:
        fail(f"phase 12a: {E_YOLOX} launched hand-written kernels "
             f"{by_name}, or the profiler recorded nothing")
    torch.cuda.empty_cache()
    opts = ["data_dir", data, "data_num_workers", str(workers)]
    pexp, _ = eval_event.build(["-n", E_YOLOX] + opts)
    truth_ap(pexp, B, "COCO", "12a")
    ckpt = os.path.join(root, "random.pth")
    calibrated_checkpoint(pexp, ckpt, SEED + 12)
    _, out["e_yolox_m_batch"] = eval_through_cli(
        ["-n", E_YOLOX, "-b", str(B), "-c", ckpt, "--device", DEV], opts, B,
        "12a", base={}, v2=False)
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(os.path.dirname(data), ignore_errors=True)
    torch.cuda.empty_cache()

    H, W = get_exp("gen1_syolox_m").test_size
    gen = torch.Generator(device=DEV).manual_seed(SEED + 13)
    rng = np.random.default_rng(SEED + 13)
    small = torch.poisson(torch.full((2, 1, 4, H, W, 2), 0.2),
                          generator=torch.Generator().manual_seed(SEED))
    for tag, over in VARIANTS_12B:
        texp = get_exp("gen1_syolox_m").merge(over)
        events = torch.poisson(torch.full((VARIANT_B, texp.Tl, texp.Tm, H, W,
                                           texp.in_dim), 0.2, device=DEV),
                               generator=gen)
        labels = random_labels(VARIANT_B, H, W, rng).to(DEV)
        patan = texp.spike_fn == "patan"
        print(f"phase 12b: gen1_syolox_m with {' '.join(over)} at "
              f"B={VARIANT_B}" + (": patan trains through the plain scan "
                                  "(no kernel, as in the JAX package), 0 "
                                  "launches of rows 7 and 8 expected"
                                  if patan else ""), flush=True)
        captured_step_check(f"12b {tag}", texp, events, labels,
                            {} if patan else PER_STEP)
        dexp = get_exp("gen1_syolox_m").deploy().merge(over)
        with torch.no_grad():
            model = dexp.get_model(device=DEV, seed=SEED)
            calibrate_spiking_bn(model, events[:4])
            _, counts, _, _, dt = run_detect(dexp, model, [events])
        print(f"  one deploy forward at B={VARIANT_B}: {dt * 1e3:.3f} ms "
              f"(host clock); launches {counts}")
        check_counts(f"phase 12b {tag} (deploy forward)", counts, 1,
                     dexp.Tm if dexp.embedding == "arsnn" else 0)
        del model
        torch.cuda.empty_cache()
        stages_card_vs_cpu(f"12b {tag}", over, small)
    print(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return out


def determinism_cost(steps: int = 6) -> int:
    """The cost of cuDNN's deterministic algorithms in the captured step
    (``CapturedStep.deterministic``), as a process of its own: for
    ``e_yolox_m`` (f32, IEEE) and ``ncaltech_syolox_m`` (bf16) at B=32,
    640x640, one model and optimizer, captured with the flag on, off, off,
    on, each from one snapshot of the train state (the same work each
    time) and timed over ``steps`` replays (host clock to a synchronize).
    Run with ``python3 -c "import sys, chip_smoke;
    sys.exit(chip_smoke.determinism_cost())"``. Returns the exit code."""
    import gc

    from eas_snn_tpu_torch.core.train_state import CapturedStep
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + PTXAS_FLAGS
    _build.build_all()
    print(f"device {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{nvidia_smi_line()}", flush=True)
    for name in (E_YOLOX, NCALTECH):
        exp = get_exp(name)
        exp.apply_precision()
        B, (H, W) = E_YOLOX_B, exp.input_size
        model = exp.get_model(device=DEV, seed=SEED, train=True)
        opt = exp.get_optimizer(model, B, iters_per_epoch=1000)
        ema = init_ema(model) if exp.ema else None
        gen = torch.Generator(device=DEV).manual_seed(SEED + 14)
        events = torch.poisson(torch.full((B, exp.Tl, exp.Tm, H, W,
                                           exp.in_dim), 0.2, device=DEV),
                               generator=gen)
        labels = random_labels(B, H, W, np.random.default_rng(SEED)).to(DEV)
        ms = {True: [], False: []}
        train_step(model, opt, ema, events, labels)  # Adam's state exists
        snap = snapshot(model, opt, ema)
        for det in (True, False, False, True):
            restore(snap, model, opt, ema)
            step = CapturedStep(model, opt, ema)
            step.deterministic = det
            for _ in range(step.WARMUP + 1):
                step(events, labels)
            t, _, peak, losses = timed_steps(step, events, labels, steps)
            ms[det].append(t)
            print(f"  {name} B={B} {H}x{W} {exp.compute_dtype} (cuDNN TF32 "
                  f"{torch.backends.cudnn.allow_tf32}), deterministic {det}: {t:.3f} ms a captured step "
                  f"({steps} replays), peak {peak:.3f} GiB, total loss "
                  f"{losses[-1]:.4f}; flag after "
                  f"{torch.backends.cudnn.deterministic}", flush=True)
            if not np.isfinite(losses).all():
                fail(f"determinism cost: {name}: a loss is not finite")
            del step
            gc.collect()
            torch.cuda.empty_cache()
        on, off = np.mean(ms[True]), np.mean(ms[False])
        print(f"  {name}: deterministic {on:.3f} ms against {off:.3f} ms a "
              f"step: x{on / off:.4f}", flush=True)
        del model, opt, ema, events, snap
        torch.cuda.empty_cache()
    return 1 if FAILURES else 0


# ---------------------------------------------------------------- phase 13

GEN1_SENSOR = (240, 304)
STREAM_TICKS = 100           # detections, one every STREAM_TICK_US
STREAM_TICK_US = 100_000
STREAM_WINDOW_US = 200_000
# the JAX tool's event budget (tools/bench_streaming.py) and the default
STREAM_BUDGETS = (65_536, 262_144)
STREAM_CONF = 0.3            # the JAX tool's confidence threshold


def _stream_ticks() -> list:
    return [STREAM_WINDOW_US + 100_000 + i * STREAM_TICK_US
            for i in range(STREAM_TICKS)]


def _detector(model, exp, max_events: int, eager: bool = False,
              device=None):
    from eas_snn_tpu_torch.inference import StreamingDetector
    return StreamingDetector(
        model, img_size=GEN1_SENSOR, input_size=exp.test_size, Tm=exp.Tm,
        window_us=STREAM_WINDOW_US, max_events=max_events,
        num_classes=exp.num_classes, confthre=STREAM_CONF,
        nmsthre=exp.nmsthre, device=device or DEV, eager=eager)


def _stream_line(what: str, res: dict) -> dict:
    """Host ms (push and fill), end-to-end ms p50 / p99 and detections a
    second of one ``bench_streaming.stream`` run; prints them."""
    a = {k: np.asarray(res[k]) * 1e3 for k in ("push_s", "fill_s",
                                               "total_s")}
    out = dict(host_ms=float((a["push_s"] + a["fill_s"]).mean()),
               push_ms=float(a["push_s"].mean()),
               fill_ms=float(a["fill_s"].mean()),
               p50_ms=float(np.percentile(a["total_s"], 50)),
               p99_ms=float(np.percentile(a["total_s"], 99)),
               per_s=float(1e3 / a["total_s"].mean()),
               boxes=res["detections"])
    print(f"  {what}: host {out['host_ms']:.4f} ms a detection (push "
          f"{out['push_ms']:.4f}, fill {out['fill_ms']:.4f}), end to end "
          f"p50 {out['p50_ms']:.4f} / p99 {out['p99_ms']:.4f} ms, "
          f"{out['per_s']:.2f} detections/s, {out['boxes']} boxes over "
          f"{len(res['total_s'])} ticks", flush=True)
    return out


def _same_outputs(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(
        a.view(np.uint32), b.view(np.uint32))


DEMO_FPS = 10         # detections a second of stream time (13b's tick)
DEMO_FRAMES = 50
DEMO_MIN_DRAWN = 40   # frames of the DEMO_FRAMES that must draw a box
DEMO_CALIB = 8        # the demo's windows its weights' BN is calibrated on
ASSIGN_BOXES = (      # planted [cls, cx, cy, w, h] a sample, 256x320
    ((0, 80, 100, 60, 40), (1, 200, 150, 30, 70), (0, 280, 40, 24, 24)),
    ((1, 160, 128, 100, 80), (0, 40, 220, 48, 36)),
)


def demo_phase(exp, model, dat: str, root: str) -> dict:
    """Phase 13d: the demo CLI over the stream ``dat`` with ``model``'s
    weights (``exp`` under ``deploy()``), their BN calibrated again on the
    demo's own windows so that the scores spread over anchors and frames,
    held to an eager ``StreamingDetector``; then ``visualize_assignments``
    at ``gen1_syolox_m``. Returns the demo's launches a detection (its
    own counts over its warm-up and capture), those of the assignment
    forward, and the demo's ms."""
    from eas_snn_tpu_torch.data import EventStream, micro_sum
    from eas_snn_tpu_torch.inference import CapturedProgram, StreamingDetector
    from eas_snn_tpu_torch.tools import demo
    from eas_snn_tpu_torch.utils import event_frame_to_image, vis_detections
    from eas_snn_tpu_torch.utils.assign_viz import (assign,
                                                    visualize_assignments)
    from eas_snn_tpu_torch.utils.png import read_png
    res = {}
    os.makedirs(root, exist_ok=True)
    window_us = abs(exp.window) * 1000
    step_us = int(1e6 / DEMO_FPS)
    stream = EventStream(dat)
    t_first = stream.first_time() + window_us
    ticks = [t_first + i * step_us for i in range(DEMO_FRAMES)]
    dmodel = exp.get_model(device=DEV, seed=SEED)
    dmodel.load_state_dict(model.state_dict())

    def reference(conf):
        return StreamingDetector(
            dmodel, img_size=GEN1_SENSOR, input_size=exp.test_size,
            Tm=exp.Tm, window_us=window_us, num_classes=exp.num_classes,
            confthre=conf, nmsthre=exp.nmsthre, device=DEV, eager=True)

    # 13b's weights have the spiking sites calibrated; the SiLU neck and
    # head keep the init's identity BN, whose activations shrink stage by
    # stage, so that the head's scores sit at its prior in a few bf16
    # values. Every site calibrated on the demo's own letterboxed windows
    # spreads them.
    probe, calib = reference(1.0), []
    for i, t in enumerate(ticks):
        probe.push(stream.events_between(t - step_us, t))
        if i % (DEMO_FRAMES // DEMO_CALIB) == 0 and len(calib) < DEMO_CALIB:
            calib.append(probe.frames(t).clone())
    with torch.no_grad():
        calibrate_spiking_bn(dmodel, torch.stack(calib)[:, None], ann=True)
    del probe, calib
    ckpt = os.path.join(root, "calibrated.pth")
    torch.save(dmodel.state_dict(), ckpt)

    # the scores of every frame's anchors (obj x best class), from an
    # eager pass over the demo's ticks; --conf is the least of the frames'
    # top scores, so every frame keeps at least one anchor
    probe, scores = reference(1.0), []
    for t in ticks:
        probe.push(stream.events_between(t - step_us, t))
        out = probe.outputs(t)
        scores.append(np.zeros(0, np.float32) if out is None
                      else out[0, :, 4] * out[0, :, 5:].max(1))
    del probe
    conf = float(min((sc.max() for sc in scores if len(sc)), default=1.0))
    passed = [int((sc >= conf).sum()) for sc in scores]
    print(f"phase 13d: the demo CLI (tools/demo.py --fp16 -c, gen1_syolox_m "
          f"with its BN calibrated on {DEMO_CALIB} of the demo's windows, "
          f"as a .pth) over 13b's stream, {DEMO_FPS} detections a second "
          f"of stream time, {DEMO_FRAMES} frames, --conf {conf!r} (the "
          f"least of the frames' top scores; "
          f"{len(np.unique(np.concatenate(scores)))} distinct scores over "
          f"the frames; anchors passing a frame: min {min(passed)}, max "
          f"{max(passed)})", flush=True)
    out_dir = os.path.join(root, "frames")
    reset_launches()
    t0 = time.perf_counter()
    run = demo.main(["-n", "gen1_syolox_m", "--fp16", "-c", ckpt, "--input",
                     dat, "--out", out_dir, "--fps", str(DEMO_FPS),
                     "--conf", repr(conf), "--max-frames", str(DEMO_FRAMES),
                     "--device", DEV])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    warm = CapturedProgram.WARMUP + 1
    print(f"  {run['frames']} frames in {wall:.2f} s "
          f"({run['frames_per_s']:.2f} frames/s in its loop), "
          f"{sum(run['boxes_per_frame'])} boxes "
          f"({max(run['boxes_per_frame'])} at most a frame); launches over "
          f"the demo (the wrappers): {counts}")
    for k in ("detect", "draw", "write"):
        m = run["ms"][k]
        print(f"    ms a frame, {k}: mean {m['mean']:.4f}, p50 "
              f"{m['p50']:.4f}")
    res["demo"] = {k: run[k] for k in ("frames", "boxes_per_frame", "ms",
                                       "frames_per_s")}
    res["demo"]["conf"] = conf
    # where a frame's host time goes: each of the demo's two
    # events_between calls a frame searches the memory-mapped stream's
    # timestamps twice, then decodes; the drawn window is binned
    t_mid = t_first + DEMO_FRAMES // 2 * step_us
    i0 = stream.time_to_index(t_mid - window_us)
    i1 = stream.time_to_index(t_mid)
    window = stream.events_slice(i0, i1)
    parts = {
        "time_to_index": host_ms(lambda: stream.time_to_index(t_mid)),
        "decode_window": host_ms(lambda: stream.events_slice(i0, i1)),
        "micro_sum": host_ms(lambda: micro_sum(window, 1, *GEN1_SENSOR))}
    res["demo"]["host_parts_ms"] = parts
    print(f"    host ms of the parts, on this stream ({stream.event_count()} "
          f"events; a window {i1 - i0}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()), flush=True)
    check_counts(f"phase 13d (the demo: {warm} eager forwards, warm-up and "
                 f"capture, then replays)", counts, warm, exp.Tm)
    res["demo_detect"] = {k: v // warm for k, v in counts.items()}
    drawn = sum(n > 0 for n in run["boxes_per_frame"])
    print(f"  frames that draw a box: {drawn} of {run['frames']}")
    if run["frames"] != DEMO_FRAMES or drawn < DEMO_MIN_DRAWN:
        fail(f"phase 13d: {run['frames']} frames, {drawn} draw a box "
             f"(expected {DEMO_FRAMES} frames, at least {DEMO_MIN_DRAWN} "
             f"drawing)")

    ref = reference(conf)
    same, drawn_same = 0, 0
    for i, (t, want, path) in enumerate(zip(ticks, run["detections"],
                                            run["paths"])):
        ref.push(stream.events_between(t - step_us, t))
        if i == 0:
            reset_launches()
        got = ref.detect(t)
        if i == 0:
            one = launch_counts()
            print(f"  one eager detection of the reference: launches {one}")
            check_counts("phase 13d (a detection of the reference)", one, 1,
                         exp.Tm)
        same += (got is None and want is None) or (
            got is not None and want is not None and _same_outputs(got, want))
        window = stream.events_between(t - window_us, t)
        img = event_frame_to_image(micro_sum(window, 1, *GEN1_SENSOR)[0])
        if want is not None:
            img = vis_detections(img, want[:, :4], want[:, 4] * want[:, 5],
                                 want[:, 6], conf=conf)
        drawn_same += np.array_equal(read_png(path), img)
    print(f"  detections bit-equal to the eager StreamingDetector's in "
          f"{same} of {run['frames']} frames; PNGs read back equal to the "
          f"frame drawn in memory: {drawn_same} of {run['frames']}",
          flush=True)
    if same != run["frames"] or drawn_same != run["frames"]:
        fail("phase 13d: the demo's detections or PNGs differ")
    del ref, dmodel

    texp = get_exp("gen1_syolox_m")
    tmodel = texp.get_model(device=DEV, seed=SEED + 17, train=False)
    H, W = texp.test_size
    B = len(ASSIGN_BOXES)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 17)
    events = torch.poisson(torch.full((B, texp.Tl, texp.Tm, H, W,
                                       texp.in_dim), 0.2, device=DEV),
                           generator=gen)
    labels = np.zeros((B, 50, 5), np.float32)
    for b, boxes in enumerate(ASSIGN_BOXES):
        labels[b, :len(boxes)] = boxes
    prefix = os.path.join(root, "assign_")
    reset_launches()
    images = visualize_assignments(tmodel, events, labels,
                                   save_prefix=prefix)
    torch.cuda.synchronize()
    res["assign_forward"] = launch_counts()
    found, _ = assign(tmodel, events, labels)
    fg, matched = found.fg_mask.cpu().numpy(), found.matched_gt.cpu().numpy()
    per_box = [[int((matched[b][fg[b]] == g).sum()) for g in range(len(bx))]
               for b, bx in enumerate(ASSIGN_BOXES)]
    pngs = sum(np.array_equal(read_png(f"{prefix}{b}.png"), images[b])
               for b in range(B))
    print(f"  visualize_assignments at gen1_syolox_m ({H}x{W}, B={B}, "
          f"train mode): launches {res['assign_forward']}; foreground "
          f"anchors a planted box {per_box}; images "
          f"{[im.shape for im in images]}, {pngs} PNGs read back equal",
          flush=True)
    want = {k: 0 for k in res["assign_forward"]}
    want["plif_train_fwd"] = PER_STEP["plif_train_fwd"]
    if res["assign_forward"] != want:
        fail(f"phase 13d: visualize_assignments launched "
             f"{res['assign_forward']}, expected {want}")
    if (not all(n > 0 for row in per_box for n in row) or pngs != B
            or any(im.shape != (H, W, 3) for im in images)):
        fail("phase 13d: an assignment, an image or a PNG is missing")
    return res


def streaming_phases() -> int:
    """Phases 13a and 13b, run as a process of its own (the profiler
    records every launch of a fresh process, PERF.md §7): the eval kernels
    at every site geometry of ``gen1_syolox_m``'s deploy forward at B=1
    and kernel 5 at N=1, then ``StreamingDetector`` on a synthetic Gen1
    stream. Prints, as JSON on its last line, the B=1 kernel sums, the
    launches of one detection and the streaming numbers. Returns the exit
    code: 1 if a check failed."""
    import shutil

    from eas_snn_tpu_torch.data import EventStream, micro_sum
    from eas_snn_tpu_torch.models import EASYOLOX
    from eas_snn_tpu_torch.tools import bench_streaming as bs
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + PTXAS_FLAGS  # phase 1's builds
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    exp = get_exp("gen1_syolox_m").deploy()
    H, W = exp.test_size
    model = exp.get_model(device=DEV, seed=SEED)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 13)
    with torch.no_grad():
        calibrate_spiking_bn(model, torch.poisson(torch.full(
            (8, exp.Tl, exp.Tm, H, W, exp.in_dim), 0.2, device=DEV),
            generator=gen))
        ev1 = torch.poisson(torch.full((1, exp.Tl, exp.Tm, H, W,
                                        exp.in_dim), 0.2, device=DEV),
                            generator=gen)
        per_kernel, refused = phase_kernels(
            model, ev1, SEED, PER_FORWARD, phase="13a",
            what=f"deploy forward at B=1 ({H}x{W}, the streaming geometry)",
            extras=False, sites_phase="13a")
        print(f"  wgmma refusals at B=1: {len(refused)} site geometries "
              f"({sum(r[1] for r in refused)} sites)")
        sev = sampler_events(model, ev1)
        r = check_v2("at N=1", sev, *model.embedding.stack_weights(),
                     model.embedding.scan_kwargs(), timed=True)
        print(f"  arsnn_v2 at {tuple(sev.shape)} {str(sev.dtype)[6:]}: "
              f"{r['mismatch']} of {r['n']} slots differ, {r['written']:.4f} "
              f"non-zero; call {r['ms']:.4f} ms (kernel "
              f"{r['kernel_ms']:.4f}), plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    keys = ("ms", "kernel_ms", "plain_ms", "bound_ms", "max_abs_err")
    out["b1_kernels"] = {k: {q: v[q] for q in keys + ("sites",)}
                         for k, v in per_kernel.items() if v["sites"]}
    out["b1_kernels"]["arsnn_v2"] = {q: r[q] for q in keys}

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "outputs", "chip_smoke_phase13")
    shutil.rmtree(root, ignore_errors=True)
    ticks = _stream_ticks()
    t0 = time.perf_counter()
    duration = ticks[-1] + 2 * STREAM_TICK_US
    dat = bs.make_stream(root, duration, EVENTS_PER_S)
    n_ev = EventStream(dat).event_count()
    print(f"phase 13b: StreamingDetector, gen1_syolox_m under deploy() with "
          f"calibrated weights; a synthetic Gen1 stream (the ap_drift "
          f"writer, {GEN1_SENSOR[0]}x{GEN1_SENSOR[1]}, {EVENTS_PER_S} "
          f"events/s, {n_ev} events over {duration / 1e6:.1f} s) "
          f"written in {time.perf_counter() - t0:.1f} s; window "
          f"{STREAM_WINDOW_US} us, a detection every {STREAM_TICK_US} us, "
          f"{STREAM_TICKS} ticks", flush=True)
    out["stream"] = {}
    for me in STREAM_BUDGETS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        det = _detector(model, exp, me)
        res = bs.stream(det, dat, ticks)
        s = _stream_line(f"captured, max_events {me}", res)
        s["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        s["replays"] = det.replays
        print(f"    peak memory {s['peak_gib']:.3f} GiB; {det.replays} "
              f"replays of one graph")
        if det.program.graph is None or det.replays != len(ticks):
            fail(f"phase 13b: {det.replays} replays at max_events {me}, "
                 f"expected {len(ticks)} (the capture's and one a tick)")
        out["stream"][str(me)] = s
        del det
    torch.cuda.empty_cache()

    # one window for the checks: the events up to the eleventh tick
    t_chk = ticks[len(ticks) // 10]
    pkt = EventStream(dat).load_delta_t(t_chk + 1)
    me = STREAM_BUDGETS[0]
    det_e, det_c = _detector(model, exp, me, True), _detector(model, exp, me)
    for d in (det_e, det_c):
        d.push(pkt)
    reset_launches()
    first = det_e.outputs(t_chk)
    counts = launch_counts()
    print(f"  one eager detection: launches {counts}")
    check_counts("phase 13b (a detection)", counts, 1, exp.Tm)
    out["stream_detect"] = counts
    for _ in range(det_c.WARMUP + 1):
        det_c.outputs(t_chk)
    want = {"plif_fwd_kernel": PER_FORWARD["plif_fwd"],
            "conv_wgmma_kernel": sum(v for k, v in PER_FORWARD.items()
                                     if k != "plif_fwd"),
            "arsnn_v2_kernel": exp.Tm}
    for attempt in range(3):
        rows = profile_call(lambda: det_c.outputs(t_chk),
                            "one captured detection (a replay)", top=8)
        by_name = {k: profiled_total(rows, k)[1] for k in want}
        print(f"  launches in the profiled replay (window {attempt + 1}), "
              f"by kernel name: {by_name}")
        if by_name == want:
            break
    if by_name != want:
        fail(f"phase 13b: kernels by name {by_name} in a replay, expected "
             f"{want}")
    turns = [("eager", det_e.outputs(t_chk)),
             ("captured", det_c.outputs(t_chk)),
             ("captured", det_c.outputs(t_chk)),
             ("eager", det_e.outputs(t_chk))]
    same = all(_same_outputs(first, o) for _, o in turns)
    print(f"  decoded outputs (1, {first.shape[1]}, {first.shape[2]}) of "
          f"one window in turns (eager, captured, captured, eager): "
          f"bit-equal {same}; finite {bool(np.isfinite(first).all())}")
    if not same or not np.isfinite(first).all():
        fail("phase 13b: the captured detection is not the eager one's bits")
    del det_e, det_c

    out["turns"] = []
    for eager in (True, False, False, True):
        det = _detector(model, exp, me, eager)
        s = _stream_line(f"{'eager' if eager else 'captured'} (turns), "
                         f"max_events {me}", bs.stream(det, dat, ticks))
        out["turns"].append(dict(s, eager=eager))
        del det
    t0 = time.perf_counter()
    base = bs.baseline(exp, model, dat, ticks, STREAM_CONF,
                       torch.device(DEV))
    b = dict(host_ms=float(np.mean(base["host_s"]) * 1e3),
             p50_ms=float(np.percentile(base["total_s"], 50) * 1e3),
             p99_ms=float(np.percentile(base["total_s"], 99) * 1e3))
    b["per_s"] = float(1.0 / np.mean(base["total_s"]))
    out["baseline"] = b
    cap = out["stream"][str(me)]
    out["ratio_host"] = b["host_ms"] / cap["host_ms"]
    out["ratio_p50"] = b["p50_ms"] / cap["p50_ms"]
    print(f"  baseline (re-read the window, host micro_sum, bilinear "
          f"letterbox, pageable copy, the forward at B=1 as one CUDA "
          f"graph): host {b['host_ms']:.4f} ms a detection, end to end p50 "
          f"{b['p50_ms']:.4f} / p99 {b['p99_ms']:.4f} ms, {b['per_s']:.2f} "
          f"detections/s ({time.perf_counter() - t0:.1f} s); baseline over "
          f"captured stream at max_events {me}: host x{out['ratio_host']:.2f}"
          f", p50 x{out['ratio_p50']:.2f}", flush=True)

    # binned and letterboxed frames: the card against the CPU, and the
    # streaming forward against the batch path, on full windows
    full = STREAM_BUDGETS[1]
    det_g = _detector(model, exp, full, eager=True)
    det_h = _detector(EASYOLOX(num_classes=2, width=0.125, depth=0.33),
                      exp, full, eager=True, device="cpu")
    for d in (det_g, det_h):
        d.push(pkt)
    worst = 0
    # the buffer holds the newest window_us: a window ending half a tick
    # before t_chk still lies mostly inside it
    for t in (t_chk - STREAM_TICK_US // 2, t_chk):
        fg, fh = det_g.frames(t).cpu(), det_h.frames(t)
        worst = max(worst, int((fg != fh).sum()))
        if not torch.equal(fg, fh) or not fg.sum() > 0:
            fail(f"phase 13b: frames of the window ending at {t} differ "
                 f"between card and CPU ({int((fg != fh).sum())} values)")
    win = det_g._buf[(det_g._buf["t"] >= t_chk + 1 - STREAM_WINDOW_US)
                     & (det_g._buf["t"] <= t_chk)]
    frames = torch.from_numpy(micro_sum(win, exp.Tm, *GEN1_SENSOR)).to(DEV)
    ih, iw = det_g._scaled_hw
    fh = F.interpolate(frames.permute(0, 3, 1, 2), size=(ih, iw),
                       mode="nearest-exact")
    canvas = F.pad(fh, (0, W - iw, 0, H - ih)).permute(0, 2, 3, 1)
    with torch.no_grad():
        batch = model(canvas[None, None]).float().cpu().numpy()
    stream_out = det_g.outputs(t_chk)
    same_batch = _same_outputs(stream_out, batch)
    print(f"  frames card vs CPU ({len(win)} events a window, max_events "
          f"{full}): {worst} values differ; the streaming outputs against "
          f"the batch path (host micro_sum, the same letterbox, the "
          f"forward) on that window: bit-equal {same_batch}", flush=True)
    if not same_batch:
        fail("phase 13b: streaming and batch outputs differ on one window")
    del det_g, det_h
    torch.cuda.empty_cache()
    out.update(demo_phase(exp, model, dat, os.path.join(root, "demo")))
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(out))
    return 1 if FAILURES else 0


_USER_EXP = '''"""A user's exp file: gen1_syolox_m's fields, its own name."""
from eas_snn_tpu_torch.exp import EventExp, get_exp


class Exp(EventExp):
    def __init__(self):
        super().__init__()
        vars(self).update(vars(get_exp("gen1_syolox_m")))
        self.exp_name = "user_gen1_syolox_m"
'''


def phase_streaming(workers: int) -> dict:
    """Phase 13: streaming detection. 13a and 13b in a process of their
    own (``streaming_phases``); 13c here: the model zoo's front door and
    the eval CLI on a user's exp file. Returns the child's JSON result with
    13c's launches a batch."""
    import shutil

    from eas_snn_tpu_torch.models import create_model, load_weights
    from eas_snn_tpu_torch.tools import ap_drift
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    print("phase 13: streaming detection (StreamingDetector: binning on the "
          "card, the detect program as one CUDA graph)", flush=True)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.streaming_phases())"], cwd=here,
        capture_output=True, text=True, timeout=900)
    lines = r.stdout.rstrip().splitlines()
    try:
        res = json.loads(lines[-1])
    except (IndexError, ValueError):
        res, lines = {}, lines + [""]
    print("\n".join(lines[:-1]))
    print(f"  (the process of phases 13a-13b took "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    if r.returncode != 0 or not res:
        fail(f"phase 13a-13b: the process exited {r.returncode}: "
             f"{r.stderr[-2000:]}")
    torch.cuda.empty_cache()

    print("phase 13c: the zoo (create_model, load_weights) and the eval CLI "
          "with -f", flush=True)
    model = create_model("syolox-s-gen1", device=DEV)
    rep = load_weights(model, "syolox-s-gen1", device=DEV)
    det = _detector(model, get_exp("gen1_syolox_s"), STREAM_BUDGETS[1])
    rng = np.random.default_rng(SEED + 13)
    from eas_snn_tpu_torch.data import EVENT_DTYPE
    pkt = np.zeros(100_000, EVENT_DTYPE)
    pkt["t"] = np.sort(rng.integers(0, STREAM_WINDOW_US, len(pkt)))
    pkt["x"] = rng.integers(0, GEN1_SENSOR[1], len(pkt))
    pkt["y"] = rng.integers(0, GEN1_SENSOR[0], len(pkt))
    pkt["p"] = rng.integers(0, 2, len(pkt))
    det.push(pkt)
    outs = [det.outputs() for _ in range(det.WARMUP + 2)]
    dets = det.detect()
    print(f"  create_model('syolox-s-gen1') on {DEV}, load_weights("
          f"'syolox-s-gen1'): {rep}; {det.replays} captured detections on "
          f"Poisson events: outputs {outs[-1].shape}, finite "
          f"{bool(np.isfinite(outs[-1]).all())}, bit-equal to the eager "
          f"warm-up's {_same_outputs(outs[0], outs[-1])}; "
          f"{0 if dets is None else len(dets)} boxes", flush=True)
    if rep != {"mapped": 430, "kept_current": 0, "total": 430,
               "unmapped": 0}:
        fail(f"phase 13c: load_weights report {rep}, expected 430 mapped")
    if not all(np.isfinite(o).all() for o in outs) or not _same_outputs(
            outs[0], outs[-1]):
        fail("phase 13c: the zoo model's detections are not finite or the "
             "captured ones differ from the eager warm-up's")
    del model, det
    torch.cuda.empty_cache()

    root = os.path.join(here, "outputs", "chip_smoke_phase13c")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    data = ap_drift.make_data(os.path.join(root, "gen1"), n_train=0,
                              n_val=3)
    user = os.path.join(root, "user_exp.py")
    with open(user, "w") as f:
        f.write(_USER_EXP)
    exp = get_exp(user).deploy()
    ckpt = os.path.join(root, "calibrated.pth")
    calibrated_checkpoint(exp, ckpt, SEED + 13)
    print(f"  phase 8's val tree (the ap_drift writer, 3 streams) and a "
          f"user exp file written in {time.perf_counter() - t0:.1f} s")
    flags = ["-f", user, "--fp16", "-b", str(EVAL_BATCH), "-c", ckpt,
             "--device", DEV]
    opts = ["data_dir", data, "data_num_workers", str(workers)] + EVAL_OPTS
    cli, per_batch = eval_through_cli(flags, opts, EVAL_BATCH, "13c",
                                      base=PER_FORWARD)
    if cli["exp"] != "user_gen1_syolox_m":
        fail(f"phase 13c: the eval CLI ran exp {cli['exp']}")
    res["cli_batch"] = per_batch
    shutil.rmtree(root, ignore_errors=True)
    print(f"  (phase 13 took {time.perf_counter() - t_phase:.1f} s)",
          flush=True)
    return res


NAN_STEPS = 40
# e_yolox_s at the reduced size the CPU trajectories of both packages use
# (tests/test_torch_divergence.py)
NAN_REDUCED = dict(name="e_yolox_s", B=8, size=(256, 256))
# smaller runs than the NaN's own at its lr (5e-4 whatever the batch), in
# search of one that the CPU can run with both packages, then the NaN's
# own run from three other seeds (``nan_sweep``)
NAN_SWEEP = tuple(dict(name=n, B=b, size=(s, s), lr=5e-4) for n, b, s in (
    ("e_yolox_m", 8, 640), ("e_yolox_m", 4, 640), ("e_yolox_m", 2, 640),
    ("e_yolox_m", 8, 320), ("e_yolox_m", 8, 256), ("e_yolox_s", 8, 640),
    ("e_yolox_s", 2, 640))) + tuple(
    dict(name=E_YOLOX, B=E_YOLOX_B, size=None, seed=s) for s in (1, 2, 3))
NAN_SWEEP_STEPS = 60


def _first_nonfinite(model, events, labels):
    """One eager train step of ``model`` (train mode) with forward hooks on
    every module and gradient hooks on every module output: the first
    module whose output is not finite in the forward, then the first
    whose output gradient is not finite in the backward (backward order),
    then the parameters whose gradient is not finite. Returns the three
    findings as strings."""
    found = {"forward": None, "backward": None}

    def bad(t):
        return (isinstance(t, torch.Tensor) and t.is_floating_point()
                and not bool(torch.isfinite(t).all()))

    def describe(name, t):
        t = t.detach()
        n = int((~torch.isfinite(t)).sum())
        fin = t[torch.isfinite(t)]
        big = float(fin.abs().max()) if fin.numel() else float("nan")
        return (f"{name} {tuple(t.shape)} {t.dtype}: {n} non-finite of "
                f"{t.numel()}, largest finite |x| {big:.4g}")

    def hook(name):
        def fwd(mod, args, out):
            outs = out if isinstance(out, (tuple, list)) else (
                list(out.values()) if isinstance(out, dict) else (out,))
            for o in outs:
                if found["forward"] is None and bad(o):
                    ins = [describe("input", a) for a in args if bad(a)]
                    found["forward"] = describe(name, o) + (
                        f"; its inputs: {ins}" if ins else
                        "; its inputs are finite")
                if isinstance(o, torch.Tensor) and o.requires_grad:
                    def grad_hook(g, name=name):
                        if found["backward"] is None and bad(g):
                            found["backward"] = describe(name + " grad", g)
                    o.register_hook(grad_hook)
        return fwd

    handles = [m.register_forward_hook(hook(n or "model"))
               for n, m in model.named_modules()]
    try:
        for p in model.parameters():
            p.grad = None
        losses = model(events, labels)
        losses["total_loss"].backward()
    finally:
        for h in handles:
            h.remove()
    grads = [describe(n, p.grad) for n, p in model.named_parameters()
             if p.grad is not None and bad(p.grad)]
    return found["forward"], found["backward"], grads


def nan_run(name: str, B: int, size, steps: int = NAN_STEPS,
            lr: Optional[float] = None, seed: int = SEED) -> dict:
    """``steps`` eager Adam steps (at ``lr``, by default the preset's lr at
    batch ``B``; no warm-up; EMA) of ``name`` in train mode from the
    weights of ``seed`` on one Poisson(0.2) batch and its random labels
    drawn from ``seed``, under deterministic cuDNN with TF32 off
    (what a captured step replays); each step's loss terms, the largest
    gradient norm and the largest parameter. At the first step whose
    losses, gradients or parameters are not finite, the step is run again
    from the state before it with hooks (``_first_nonfinite``)."""
    exp = get_exp(name)
    if size is not None:
        exp.input_size = exp.test_size = tuple(size)
    if lr is not None:
        exp.basic_lr_per_img = lr / B
    exp.apply_precision()
    H, W = exp.input_size
    model = exp.get_model(device=DEV, seed=seed, train=True)
    opt = exp.get_optimizer(model, B, iters_per_epoch=1000)
    ema = init_ema(model) if exp.ema else None
    gen = torch.Generator(device=DEV).manual_seed(seed + 14)
    events = torch.poisson(torch.full((B, exp.Tl, exp.Tm, H, W, exp.in_dim),
                                      0.2, device=DEV), generator=gen)
    labels = random_labels(B, H, W, np.random.default_rng(seed)).to(DEV)
    lr = exp.basic_lr_per_img * B
    print(f"  {name} B={B} {H}x{W} {exp.compute_dtype}, seed {seed}, Adam "
          f"lr {lr:g} (scheduler {exp.scheduler}, warm-up epochs "
          f"{exp.warmup_epochs}), {steps} eager steps on one batch",
          flush=True)
    rows, first_bad = [], None
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for step in range(steps):
            snap = snapshot(model, opt, ema)
            losses = {k: float(v) for k, v in train_step(
                model, opt, ema, events, labels).items()}
            norms = {n: float(p.grad.float().norm())
                     for n, p in model.named_parameters()
                     if p.grad is not None}
            gname = max(norms, key=lambda n: norms[n]
                        if np.isfinite(norms[n]) else np.inf)
            pmax = max(float(p.detach().abs().max())
                       for p in model.parameters())
            row = dict(step=step + 1, **losses, max_grad_norm=norms[gname],
                       max_grad_param=gname, max_abs_param=pmax)
            rows.append(row)
            print("    step {step}: total {total_loss:.6g} iou {iou_loss:.6g}"
                  " conf {conf_loss:.6g} cls {cls_loss:.6g} l1 {l1_loss:.6g}"
                  " num_fg {num_fg:.6g}; largest grad norm {max_grad_norm:.6g}"
                  " ({max_grad_param}); largest |param| {max_abs_param:.6g}"
                  .format(**row), flush=True)
            finite = (all(np.isfinite(v) for k, v in losses.items())
                      and all(np.isfinite(v) for v in norms.values())
                      and np.isfinite(pmax))
            if not finite:
                first_bad = step + 1
                restore(snap, model, opt, ema)
                fwd, bwd, grads = _first_nonfinite(model, events, labels)
                print(f"    first non-finite at step {first_bad}: forward "
                      f"{fwd}; backward {bwd}; {len(grads)} parameters with "
                      f"non-finite gradients, first: {grads[:3]}",
                      flush=True)
                rows.append(dict(first_bad=first_bad, forward=fwd,
                                 backward=bwd, grads=grads[:10]))
                break
    finally:
        torch.backends.cudnn.deterministic = old
    del model, opt, ema, events
    torch.cuda.empty_cache()
    return {"name": name, "B": B, "size": [H, W], "lr": lr, "seed": seed,
            "first_nonfinite_step": first_bad, "rows": rows}


def nan_trace() -> int:
    """The ``e_yolox_m`` NaN (f32, B=32, 640x640, Adam at the preset's lr
    5e-4, no warm-up, one repeated batch), as a process of its own: each
    step's loss terms and the first non-finite tensor; then e_yolox_s at
    the reduced size of the CPU comparison of both packages (256x256,
    B=8), at the preset's lr. Prints each run's first non-finite step as
    JSON on its last line. Run with ``python3 -c "import sys, chip_smoke;
    sys.exit(chip_smoke.nan_trace())"``."""
    print(f"device {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{nvidia_smi_line()}", flush=True)
    runs = [nan_run(E_YOLOX, E_YOLOX_B, None), nan_run(**NAN_REDUCED)]
    print(json.dumps({r["name"]: r["first_nonfinite_step"] for r in runs}))
    return 0


def nan_sweep() -> int:
    """``nan_run`` for ``NAN_SWEEP_STEPS`` steps at each of ``NAN_SWEEP``,
    as a process of its own; prints each run's first non-finite step
    (null: none) as JSON on its last line. Run with ``python3 -c "import
    sys, chip_smoke; sys.exit(chip_smoke.nan_sweep())"``."""
    print(f"device {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{nvidia_smi_line()}", flush=True)
    runs = [nan_run(**cfg, steps=NAN_SWEEP_STEPS) for cfg in NAN_SWEEP]
    print(json.dumps([{k: r[k] for k in ("name", "B", "size", "seed",
                                          "first_nonfinite_step")}
                      for r in runs]))
    return 0


# ---------------------------------------------------------------- phase 14

SCALE_B = 32                         # the reference's N-Caltech batch
SCALE_SWEEP = (32, 48, 64, 96, 128)  # batches tried with remat + int8
SCALE_REPLAYS = 3                    # timed replays a configuration
# remat recomputes each site's train PLIF forward once: 2 x 50 + 50
PER_STEP_REMAT = {"plif_train_fwd": 100, "plif_train_bwd": 50}
DP_B = FULL_TRAIN_B                  # phase 6's gen1_syolox_m batch
DP_CLI_B = 16                        # the train CLI's -b in phase 14b


def _poisson_batch(exp, B: int, seed: int):
    """One Poisson(0.2) batch of ``exp``'s input size and its random
    labels, on the card."""
    H, W = exp.input_size
    gen = torch.Generator(device=DEV).manual_seed(seed)
    events = torch.poisson(torch.full((B, exp.Tl, exp.Tm, H, W, exp.in_dim),
                                      0.2, device=DEV), generator=gen)
    return events, random_labels(B, H, W, np.random.default_rng(seed)).to(DEV)


def _fits(err: Optional[BaseException]) -> bool:
    """False for a failure that is the card's memory running out, also
    where it ended a graph capture and the capture's end raised."""
    while err is not None:
        if isinstance(err, torch.cuda.OutOfMemoryError) or \
                "out of memory" in str(err):
            return False
        err = err.__cause__ or err.__context__
    return True


def scale_step(exp, events, labels, remat: bool, store: str, replays: int,
               profile: bool = False) -> dict:
    """``exp``'s step as CUDA graphs (``CapturedStep``) with ``remat`` and
    the spike store ``store``, from the model of seed SEED + 1 on one
    batch: the eager warm-up and the capture, then ``replays`` timed
    replays. Returns the peak allocated GiB over all of them, ms a replay
    (host clock to a synchronize), the wrappers' launches a step over the
    warm-up and the capture, the last losses, the end state (on the host)
    and, with ``profile``, the train PLIF kernels' launches in one
    profiled replay by name."""
    from eas_snn_tpu_torch.core.train_state import CapturedStep
    model = exp.get_model(device=DEV, seed=SEED + 1, train=True)
    model.set_remat(remat)
    model.train_store = store
    opt = exp.get_optimizer(model, events.shape[0], iters_per_epoch=1000)
    ema = init_ema(model) if exp.ema else None
    step = CapturedStep(model, opt, ema)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for _ in range(step.WARMUP + 1):
        step(events, labels)
    torch.cuda.synchronize()
    counts = {k: v // (step.WARMUP + 1) for k, v in launch_counts().items()}
    t0 = time.perf_counter()
    for _ in range(replays):
        losses = step(events, labels)
    torch.cuda.synchronize()
    out = dict(ms=(time.perf_counter() - t0) / replays * 1e3,
               peak=torch.cuda.max_memory_allocated() / 2**30, counts=counts,
               losses={k: float(v) for k, v in losses.items()},
               state=[t.detach().to("cpu", copy=True) for t in
                      _state_tensors(model, opt, ema)])
    if profile:
        rows = profile_call(lambda: step(events, labels),
                            "one replay of the remat step", top=6)
        out["by_name"] = {k: profiled_total(rows, k)[1]
                          for k in ("plif_fwd_kernel", "plif_bwd")}
    del step, model, opt, ema
    torch.cuda.empty_cache()
    return out


def _same_step(what: str, a: dict, b: dict) -> None:
    """b's losses and end state must be a's, bit for bit."""
    ds, ns = state_diff(a["state"], b["state"])
    same = a["losses"] == b["losses"] and ns == 0
    print(f"  {what}: losses and end state (parameters, BN statistics, "
          f"Adam, EMA) {'bit-equal' if same else 'DIFFER'} (largest |diff| "
          f"{ds:.3e}, {ns} elements)")
    if not same:
        fail(f"{what}: the step is not bit-equal")


def scale_phases() -> int:
    """Phase 14a, run as a process of its own: train memory at 640x640.
    ``ncaltech_syolox_m`` (bf16) at B=32 as the captured step with remat
    off and on and the int8 spike store off and on (peak GiB and ms a
    step each; every configuration's state bit-equal to the plain one's;
    the train PLIF launches pinned: 50 + 50 a plain step, 100 + 50 with
    remat, by the wrappers and by name in a replay), ``e_yolox_m`` (f32)
    at B=32 with remat off and on, then the largest batch of SCALE_SWEEP
    that fits with remat and int8 (stopping at the first that does not).
    Prints, as JSON on its last line, the launches a remat step and the
    measurements. Returns the exit code: 1 if a check failed."""
    from eas_snn_tpu_torch.core.train_state import CapturedStep
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + PTXAS_FLAGS  # phase 1's builds
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    res = {}
    exp = get_exp(NCALTECH)
    events, labels = _poisson_batch(exp, SCALE_B, SEED + 14)
    print(f"phase 14a: train memory at 640x640: {NCALTECH} "
          f"({exp.compute_dtype}) at B={SCALE_B} as CUDA graphs, remat off "
          f"and on, saved spikes in {exp.compute_dtype} or int8; "
          f"{CapturedStep.WARMUP} eager warm-up steps, the capture, "
          f"{SCALE_REPLAYS} timed replays each", flush=True)
    runs = {}
    for remat in (False, True):
        for store in ("float", "int8"):
            r = runs[remat, store] = scale_step(
                exp, events, labels, remat, store, SCALE_REPLAYS,
                profile=remat and store == "int8")
            per = PER_STEP_REMAT if remat else PER_STEP
            want = {k: per.get(k, 0) for k in r["counts"]}
            print(f"  remat {'on ' if remat else 'off'}, saved spikes "
                  f"{store:5s}: peak allocated {r['peak']:.3f} GiB, "
                  f"{r['ms']:.3f} ms a step, total loss "
                  f"{r['losses']['total_loss']:.6f}; train PLIF launches a "
                  f"step (the wrappers) {r['counts']}", flush=True)
            if r["counts"] != want:
                fail(f"phase 14a: launches {r['counts']} a step, expected "
                     f"{want}")
    base = runs[False, "float"]
    for (remat, store), r in runs.items():
        if (remat, store) != (False, "float"):
            _same_step(f"remat {remat}, spikes {store} against remat off, "
                       "spikes float", base, r)
    by_name = runs[True, "int8"]["by_name"]
    print(f"  remat step: train PLIF launches in one profiled replay, by "
          f"kernel name: {by_name}")
    if by_name != {"plif_fwd_kernel": PER_STEP_REMAT["plif_train_fwd"],
                   "plif_bwd": PER_STEP_REMAT["plif_train_bwd"]}:
        fail(f"phase 14a: launches by name {by_name}, expected "
             f"{PER_STEP_REMAT}")
    res["remat_step"] = runs[True, "int8"]["counts"]
    res["peaks_gib"] = {f"remat_{int(r)}_{s}": v["peak"]
                        for (r, s), v in runs.items()}
    res["ms"] = {f"remat_{int(r)}_{s}": v["ms"] for (r, s), v in runs.items()}
    del runs, base, events, labels
    torch.cuda.empty_cache()

    eexp = get_exp(E_YOLOX)
    eexp.apply_precision()
    events, labels = _poisson_batch(eexp, E_YOLOX_B, SEED + 15)
    eruns = {}
    for remat in (False, True):
        r = eruns[remat] = scale_step(eexp, events, labels, remat, "int8",
                                      SCALE_REPLAYS)
        print(f"  {E_YOLOX} ({eexp.compute_dtype}) B={E_YOLOX_B} remat "
              f"{'on ' if remat else 'off'}: peak allocated "
              f"{r['peak']:.3f} GiB, {r['ms']:.3f} ms a step, total loss "
              f"{r['losses']['total_loss']:.6f}", flush=True)
    _same_step(f"{E_YOLOX} remat on against off", eruns[False], eruns[True])
    res["e_yolox_m"] = {f"remat_{int(r)}": dict(peak_gib=v["peak"],
                                                ms=v["ms"])
                        for r, v in eruns.items()}
    del eruns, events, labels
    torch.cuda.empty_cache()

    largest = None
    for B in SCALE_SWEEP:
        events, labels = _poisson_batch(exp, B, SEED + 14)
        try:
            r = scale_step(exp, events, labels, True, "int8", 2)
        except (RuntimeError, torch.cuda.OutOfMemoryError) as err:
            if _fits(err):
                raise
            print(f"  B={B} with remat and int8: does not fit "
                  f"({str(err).splitlines()[0][:120]})", flush=True)
            break
        largest = dict(B=B, peak_gib=r["peak"], ms=r["ms"])
        print(f"  B={B} with remat and int8: fits, peak allocated "
              f"{r['peak']:.3f} GiB, {r['ms']:.3f} ms a step", flush=True)
        del events, labels, r
        torch.cuda.empty_cache()
    print(f"  largest batch of {list(SCALE_SWEEP)} that fits with remat and "
          f"int8: {largest}")
    res["largest"] = largest
    print(f"  phase 14a took {time.perf_counter() - t_phase:.1f} s")
    print(json.dumps(res))
    return 1 if FAILURES else 0



def _nccl_launches(rows) -> tuple:
    """(launches, names) of NCCL's kernels in ``profile_call``'s rows."""
    hits = [(n, key) for _, n, key in rows
            if "nccl" in key.lower() or "onerank" in key.lower()]
    return sum(n for n, _ in hits), sorted({k[:60] for _, k in hits})


def scale_dp_phases(workers: int) -> int:
    """Phases 14c and 14b, run as a process of its own. 14c: the
    capturable SGD's captured step against its eager step from one
    snapshot at ``gen1_syolox_m`` B=64 (bit-equal). 14b: an NCCL group of
    one process; the captured step with the group (its collectives in the
    graph: the BN sites', SimOTA's, the gradient bucket) against the
    captured step without it from one snapshot (bit-equal), NCCL's kernels
    by name in a replay, ms a step with and without the group in turns;
    then the train CLI's ``main`` with the group started, on a Gen1 tree
    as phase 7 writes it, through the evaluation and its gather. Prints,
    as JSON on its last line, the launches a step of both paths. Returns
    the exit code: 1 if a check failed."""
    import shutil
    import socket

    from eas_snn_tpu_torch import parallel
    from eas_snn_tpu_torch.core.train_state import CapturedStep
    from eas_snn_tpu_torch.evaluators import event_evaluator
    from eas_snn_tpu_torch.models.blocks import BatchNorm
    from eas_snn_tpu_torch.tools import train_event
    from eas_snn_tpu_torch.utils.png import read_png
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + PTXAS_FLAGS  # phase 1's builds
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    res = {}
    exp = get_exp("gen1_syolox_m")
    events, labels = _poisson_batch(exp, DP_B, SEED + 16)

    exp.optimizer = "SGD"
    print(f"phase 14c: the capturable SGD (Nesterov, a device lr a group): "
          f"gen1_syolox_m at B={DP_B}, captured against eager", flush=True)
    opt_kind = type(exp.get_optimizer(torch.nn.Conv2d(1, 1, 1).to(DEV),
                                       DP_B)).__name__
    print(f"  optimizer: {opt_kind}")
    res["sgd_step"] = captured_step_check("14c", exp, events, labels,
                                          PER_STEP)
    exp.optimizer = "ADAM"

    print(f"phase 14b: data parallel on the card: an NCCL group of one "
          f"process, gen1_syolox_m at B={DP_B}", flush=True)
    model = exp.get_model(device=DEV, seed=SEED + 1, train=True)
    opt = exp.get_optimizer(model, DP_B, iters_per_epoch=1000)
    ema = init_ema(model)
    plain = CapturedStep(model, opt, ema)
    for _ in range(plain.WARMUP + 1):
        plain(events, labels)
    snap = snapshot(model, opt, ema)

    def one_step(step):
        restore(snap, model, opt, ema)
        losses = {k: float(v) for k, v in step(events, labels).items()}
        torch.cuda.synchronize()
        return dict(losses=losses, state=[t.detach().clone() for t in
                                          _state_tensors(model, opt, ema)])

    without = one_step(plain)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    parallel.start_group(f"127.0.0.1:{port}", 1, 0, device=DEV)
    print(f"  NCCL group of one started in {time.perf_counter() - t0:.2f} s "
          f"(backend {torch.distributed.get_backend()}, world size "
          f"{parallel.world_size()})", flush=True)
    dp = CapturedStep(model, opt, ema)
    reset_launches()
    for _ in range(dp.WARMUP + 1):
        dp(events, labels)
    torch.cuda.synchronize()
    res["dp_step"] = {k: v // (dp.WARMUP + 1)
                      for k, v in launch_counts().items()}
    print(f"  warm-up and capture with the group: launches a step (the "
          f"wrappers) {res['dp_step']}")
    if res["dp_step"] != {k: PER_STEP.get(k, 0) for k in res["dp_step"]}:
        fail(f"phase 14b: launches {res['dp_step']}, expected {PER_STEP}")
    _same_step("captured step with the group against without it, from one "
               "snapshot", without, one_step(dp))
    sites = sum(isinstance(m, BatchNorm) for m in model.modules())
    rows = profile_call(lambda: dp(events, labels),
                        "one replay with the group", top=6)
    n, names = _nccl_launches(rows)
    want = 2 * sites + 2  # each BN site forward and backward, SimOTA, bucket
    print(f"  NCCL kernels in the replay, by name: {n} launches of {names} "
          f"({want} collectives: {sites} BN sites forward and backward, "
          f"SimOTA's counts, the gradient bucket)")
    if n < want:
        fail(f"phase 14b: {n} NCCL launches in a replay, expected at least "
             f"{want}")
    ms = {}
    for name in ("without", "with", "with", "without"):
        fn = dp if name == "with" else plain
        t, ips, peak, losses = timed_steps(fn, events, labels, 5)
        ms.setdefault(name, []).append(t)
        print(f"  captured step {name} the group: {t:.3f} ms a step, "
              f"{ips:.2f} images/s, peak {peak:.3f} GiB")
    res["dp_ms"] = ms
    del plain, dp, model, opt, ema, snap, events, labels
    torch.cuda.empty_cache()

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "outputs", "chip_smoke_phase14")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "gen1")
    tree = write_gen1_tree(os.path.join(data, "train"), streams=2,
                           groups=48, seed=SEED + 14)
    write_gen1_tree(os.path.join(data, "val"), streams=1, groups=8,
                    seed=SEED + 15)
    gathered = []
    gather = event_evaluator._allgather_rows

    def counted(rows):
        out = gather(rows)
        gathered.append((len(rows), len(out)))
        return out

    event_evaluator._allgather_rows = counted
    t0 = time.perf_counter()
    train_event.main(["-n", "gen1_syolox_m", "-b", str(DP_CLI_B), "-l",
                      "jsonl", "data_dir", data, "output_dir",
                      os.path.join(root, "out"), "data_num_workers",
                      str(workers), "max_epoch", "1", "print_interval", "1",
                      "seed", str(SEED), "eval_interval", "1"])
    event_evaluator._allgather_rows = gather
    run = os.path.join(root, "out", "gen1_syolox_m")
    rows = [json.loads(r) for r in open(os.path.join(run, "metrics.jsonl"))]
    train = [r for r in rows if r["split"] == "train"]
    val = [r for r in rows if r["split"] == "val"]
    print(f"  train CLI with the group ({tree['streams']} streams, "
          f"{tree['groups']} label groups, -b {DP_CLI_B}): {len(train)} "
          f"steps, last total loss {train[-1]['total_loss']:.4f}, val "
          f"{val}, gathers (rows in, rows out) {gathered}, in "
          f"{time.perf_counter() - t0:.1f} s")
    if not (len(train) > CapturedStep.WARMUP + 1 and val and gathered
            and all(a == b for a, b in gathered)
            and all(np.isfinite(r["total_loss"]) for r in train)):
        fail("phase 14b: the train CLI with the group did not train "
             "through a captured step and an evaluation with the gather")
    img_dir = os.path.join(run, "pred_images")
    names = sorted(os.listdir(img_dir)) if os.path.isdir(img_dir) else []
    shapes = {read_png(os.path.join(img_dir, n)).shape for n in names}
    print(f"  the evaluation's prediction images: {len(names)} PNGs "
          f"({names[:1]}...), decoded shapes {shapes}")
    if not names or not all(re.fullmatch(r"step\d{8}_\d+\.png", n)
                            for n in names) \
            or shapes != {tuple(exp.test_size) + (3,)}:
        fail("phase 14b: the train CLI's evaluation wrote no prediction "
             "image, or one that does not decode to the eval frame")
    parallel.shutdown()
    shutil.rmtree(root, ignore_errors=True)
    print(f"  phases 14b-14c took {time.perf_counter() - t_phase:.1f} s")
    print(json.dumps(res))
    return 1 if FAILURES else 0


def _child(fn: str, what: str, timeout: int) -> dict:
    """``chip_smoke.<fn>`` in a process of its own: its output, then its
    JSON result (empty, and a failure, if it gave none or exited non-zero).
    """
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; "
                        f"sys.exit(chip_smoke.{fn})"], cwd=here,
                       capture_output=True, text=True, timeout=timeout)
    lines = r.stdout.rstrip().splitlines()
    print("\n".join(lines[:-1]))
    print(f"  (the process of {what} took {time.perf_counter() - t0:.1f} s)",
          flush=True)
    try:
        res = json.loads(lines[-1])
    except (IndexError, ValueError):
        res = {}
    if r.returncode != 0 or not res:
        fail(f"{what}: the process exited {r.returncode}: "
             f"{r.stderr[-2000:]}")
    return res


def phase_scale(workers: int) -> dict:
    """Phase 14: training at scale, in two processes of their own: 14a
    (``scale_phases``), then 14c and 14b (``scale_dp_phases``: the NCCL
    group stays in that process). Returns both results."""
    res = _child("scale_phases()", "phase 14a", 600)
    torch.cuda.empty_cache()
    res.update(_child(f"scale_dp_phases({workers})", "phases 14b-14c", 600))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--forwards", type=int, default=5)
    ap.add_argument("--train-batch", type=int, default=64)
    ap.add_argument("--train-steps", type=int, default=8)
    ap.add_argument("--workers", type=int, default=7,
                    help="the loader worker processes of phases 7-13")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"phase 1: device {name}; nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + PTXAS_FLAGS
    log = io.StringIO()
    with contextlib.redirect_stderr(log):
        _build.build_all()
    print(f"built {len(_build.SOURCES)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s; nvcc's -Xptxas=-v report:",
          flush=True)
    print_ptxas(log.getvalue())

    with torch.no_grad():
        exp = get_exp("gen1_syolox_m").deploy()
        model = exp.get_model(device=DEV, seed=SEED)
        H, W = exp.test_size
        gen = torch.Generator(device=DEV).manual_seed(SEED)
        shape = (args.batch, exp.Tl, exp.Tm, H, W, exp.in_dim)
        batches = [torch.poisson(torch.full(shape, 0.2, device=DEV),
                                 generator=gen) for _ in range(args.forwards)]
        # random weights: BN statistics as training would track them, so
        # that every stage fires
        calibrate_spiking_bn(model, batches[0][:8])

        per_kernel, _ = phase_kernels(model, batches[0], SEED)
        counts = phase_main_path(exp, model, batches)
        sk = phase_sampler_kernels(model, batches[0], SEED)
        for kname in ("arsnn_v2", "arsnn_step"):
            per_kernel[kname] = {k: sk[kname][k] for k in (
                "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err")}
        counts.update(phase_sampler_routes(exp, model, batches, SEED))
        del batches, model
        torch.cuda.empty_cache()
        small = torch.poisson(torch.full((2, exp.Tl, exp.Tm, H, W,
                                          exp.in_dim), 0.2),
                              generator=torch.Generator().manual_seed(SEED))
        phase_card_vs_cpu(SEED, small)
    torch.cuda.empty_cache()

    texp = get_exp("gen1_syolox_m")
    tmodel = texp.get_model(device=DEV, seed=SEED, train=True)
    H, W = texp.test_size
    B = args.train_batch
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    events = torch.poisson(torch.full((B, texp.Tl, texp.Tm, H, W,
                                       texp.in_dim), 0.2, device=DEV),
                           generator=gen)
    labels = random_labels(B, H, W, np.random.default_rng(SEED)).to(DEV)
    per_kernel.update(phase_train_kernels(tmodel, events, labels, SEED))
    counts.update({k: v for k, v in phase_train_step(
        texp, tmodel, events, labels, args.train_steps).items()
        if k in PER_STEP})
    del tmodel
    torch.cuda.empty_cache()
    phase_captured_step(texp, events, labels, args.train_steps)
    del events, labels
    torch.cuda.empty_cache()
    phase_entry_point(B, args.train_steps, args.workers)
    phase_eval_entry_point(EVAL_BATCH, args.workers)
    torch.cuda.empty_cache()
    nc_data = phase_ncaltech(args.train_steps, args.workers)
    torch.cuda.empty_cache()
    phase_gen4(4, args.workers)
    torch.cuda.empty_cache()
    res11 = phase_full_spike(4, args.workers)
    torch.cuda.empty_cache()
    res12 = phase_variants(nc_data, 4, args.workers)
    torch.cuda.empty_cache()
    res13 = phase_streaming(args.workers)
    torch.cuda.empty_cache()
    res14 = phase_scale(args.workers)
    if FAILURES:
        print(smi)
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1

    # each path of this run, its launches read from zeroed counts just
    # after it: the full_spike_v2 and full_spike forwards and steps
    # (phase 11's process; None where it gave no result), e_yolox_m's
    # step and eval batch (phase 12a)
    paths = {p: res11.get(p) for p in ("full_v2_forward", "full_v2_step",
                                       "full_forward", "full_step")}
    paths.update(res12)
    # phase 13: one detection of the streaming program (eager, the wrappers'
    # counts; its replays launch the same kernels by name) and a batch of
    # the eval CLI on a user's exp file
    paths["stream_detect"] = res13.get("stream_detect")
    paths["stream_cli_batch"] = res13.get("cli_batch")
    # phase 13d: a detection of the demo CLI (its counts over its warm-up
    # and capture, a third each), and the train-mode forward of
    # visualize_assignments
    paths["demo_detect"] = res13.get("demo_detect")
    paths["assign_forward"] = res13.get("assign_forward")
    # phase 14: a step of ncaltech_syolox_m with remat (each site's forward
    # again in the recompute), of gen1_syolox_m with an NCCL group and with
    # the capturable SGD (the wrappers, from zeroed counts)
    for p in ("remat_step", "dp_step", "sgd_step"):
        paths[p] = res14.get(p)
    neck_head = dict(res11.get("eval_sites", {}),
                     **res11.get("train_sites", {}))
    b1 = res13.get("b1_kernels", {})
    kernels = []
    for kname, agg in per_kernel.items():
        source, replaces = KERNEL_INFO[kname]
        kernels.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=counts[kname], max_abs_err=agg["max_abs_err"],
            ms=agg["ms"], kernel_ms=agg["kernel_ms"],
            plain_ms=agg["plain_ms"], bound_ms=agg["bound_ms"],
            bound_by=agg.get("bound_by") or (
                "bytes" if agg["bytes_ms"] >= agg["ops_ms"] else "operations"),
            library_ms=None,
            path_launches={p: None if c is None else c.get(kname, 0)
                           for p, c in paths.items()},
            neck_head=({k: neck_head[kname][k] for k in (
                "ms", "kernel_ms", "plain_ms", "bound_ms", "max_abs_err")}
                if kname in neck_head else None),
            b1=b1.get(kname)))
    print("kernel times: eval kernels per forward, train kernels per train "
          "step, each the sum over the kernel's sites of the per-call times "
          "above (ms: the wrapper's call, CUDA events; kernel_ms: the "
          "kernel's own device time, torch.profiler); arsnn_v2 per forward "
          "at the flagship (one call, Tm "
          "launches), arsnn_step per call at the flagship step geometry in "
          "f32; launches from phase 3 (eval, arsnn_v2 included: deploy()'s "
          "own route), phase 3c (arsnn_step: the v1 scan) and phase 6 "
          "(train); path_launches: a forward or a step of phase 11's "
          "full_spike_v2 and full_spike paths, a step of phase 12a's "
          "e_yolox_m through the train CLI and a batch through the eval CLI "
          "(by the wrappers, from zeroed counts), one streaming detection "
          "and a batch of the eval CLI on a user exp file (phase 13), a "
          "detection of the demo CLI (a third of its warm-up and capture) "
          "and the train-mode forward of visualize_assignments (13d), a "
          "remat step of ncaltech_syolox_m (phase 14a: 100 + 50), a step "
          "with an NCCL group and one with the capturable SGD (14b, 14c); "
          "neck_head: the sums over "
          "the neck and head sites of the full_spike_v2 forward (rows 1-3) "
          "and step (rows 7, 8), phase 11a; b1: the sums over the sites of "
          "the deploy forward at B=1 (rows 1-4) and kernel 5 at N=1, phase "
          "13a; no "
          "single PyTorch call computes a fused site, the PLIF recurrence, "
          "its backward, the sampler scan or its step, so library_ms is "
          "null")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
