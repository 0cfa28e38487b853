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
9. one ``{"kernels": [...]}`` line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

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

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

from eas_snn_tpu_torch.core.train_state import (init_ema, optimizer_update,
                                                train_step)
from eas_snn_tpu_torch.exp import detect, get_exp
from eas_snn_tpu_torch.models.blocks import PLIF, BaseConv
from eas_snn_tpu_torch.models.embedding import fold_time
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
# Gen4 (384x640): no site geometry is in the TPU's fusion table (its keys
# are Gen1's), so all 50 spiking sites take the PLIF kernel
GEN4_PER_FORWARD = {"plif_fwd": 50}
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
def calibrate_spiking_bn(model, events: torch.Tensor) -> None:
    """Give a randomly initialised detector the BN statistics training
    would track: each spiking site's running mean and variance become the
    per-channel moments of its conv output on ``events`` (in forward
    order), with scale 1 and bias 0. Each site's preactivation is then
    about N(0, 1) per channel, so every stage fires (about 20%) whichever
    draw the weights came from; at the JAX init (identity BN) dark3-dark5
    of the flagship barely fire on Poisson(0.2) events."""

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
               if isinstance(m, BaseConv) and m.neuron.spiking]
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

def site_geometries(model, events):
    """Run one forward with pre-hooks on every spiking BaseConv and return
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

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BaseConv) and m.neuron.spiking]
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


def phase_other_sites(others, gen):
    """The wgmma kernels called directly at every other spiking 1x1 and
    3x3 site of the flagship forward, both strides (the sites the TPU's
    policy leaves on the unfused chain), with no change to routing: held
    to the plain version like the fused sites, timed against the chain. A
    site whose layout or weights the wrapper refuses is listed as refused,
    with the reason."""
    print("phase 2b: the wgmma kernels at the unfused 1x1 / 3x3 / 3x3 "
          "stride-2 sites (called directly; the forward keeps the chain "
          "there)")
    for (name, *_), (count, mod, shapes, dtype, _) in others.items():
        try:
            r = check_conv_site(name, mod, shapes, dtype, gen)
        except ValueError as e:
            shp = "+".join("x".join(map(str, s)) for s in shapes)
            print(f"  {name:15s} {count:3d} {shp:34s} refused: {e}")
            continue
        _print_site(name, count, shapes, dtype, r)


def phase_kernels(model, events, seed):
    sites, others = site_geometries(model, events)
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    per_kernel = {n: dict(ms=0.0, kernel_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                          chain_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                          max_abs_err=0.0, sites=0, same_bytes_ms=0.0)
                  for n in PER_FORWARD}
    print("phase 2: kernel vs plain at every flagship site geometry "
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
        if agg["sites"] != PER_FORWARD[name]:
            fail(f"{name}: {agg['sites']} sites found in the flagship "
                 f"forward, expected {PER_FORWARD[name]}")
    for name, agg in per_kernel.items():
        chain = (f", unfused chain {agg['chain_ms']:.4f}"
                 if name != "plif_fwd" else
                 f", torch.ge of x into a bool tensor (the same bytes) "
                 f"{agg['same_bytes_ms']:.4f}")
        print(f"  {name}: {agg['ms']:.4f} ms a forward over its "
              f"{agg['sites']} sites (kernel {agg['kernel_ms']:.4f}){chain}, "
              f"bound {agg['bound_ms']:.4f}")
    plif_ragged_cases(gen)
    phase_other_sites(others, gen)
    return per_kernel


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
    emb32.dtype = None
    kw = emb.scan_kwargs()
    v2 = af.arsnn_fused_v2(ev, *emb.stack_weights(), **kw)
    torch.cuda.synchronize()
    reset_launches()
    v1 = af.arsnn_scan_fused(ev, emb32._apply_stack(emb32.input_conv),
                             emb32._apply_stack(emb32.gate_conv), **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = {"arsnn_step": counts["arsnn_step"]}
    rel = _rel_err(v1, v2)
    share = float((rel > ANALOG_TOL).float().mean())
    v1_ms = cuda_ms(lambda: af.arsnn_scan_fused(
        ev, emb32._apply_stack(emb32.input_conv),
        emb32._apply_stack(emb32.gate_conv), **kw), 3)
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
                 GEN4_PER_FORWARD)
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


def _check_analog(what: str, card: torch.Tensor, cpu: torch.Tensor) -> None:
    rel = _rel_err(card, cpu)
    n_bad = int((rel > ANALOG_TOL).sum())
    print(f"  {what}: max |card - cpu| / (1 + |cpu|) {float(rel.max()):.3e}, "
          f"{n_bad} of {rel.numel()} beyond {ANALOG_TOL:.0e}")
    if n_bad or card.shape != cpu.shape or not torch.isfinite(card).all():
        fail(f"phase 4: {what} disagrees between card and CPU")


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


def train_site_geometries(model, events, labels):
    """{(shape, dtype, T, thresh, spike_fn): count} of the spiking
    sites' preactivations in one train forward (pre-hooks on the neurons;
    run without gradients)."""
    sites = OrderedDict()

    def hook(mod, args):
        x = args[0]
        key = (tuple(x.shape), x.dtype, mod.T, mod.thresh, mod.spike_fn)
        sites[key] = sites.get(key, 0) + 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, PLIF)]
    with torch.no_grad():
        model(events, labels)
    for h in handles:
        h.remove()
    return sites


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_train_site(shape, dtype, T, th, kind, gen, identity=False,
                     timed=True):
    """Both train kernels against their plain versions on random bf16
    preactivations and cotangents; BN terms that put the normalized
    preactivation near N(0.6, 1) (the identity terms for ``identity``).
    The backward runs twice: its sums must be bitwise identical."""
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
                train_alpha(kind, 2.0))
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


def phase_train_kernels(model, events, labels, seed):
    sites = train_site_geometries(model, events, labels)
    gen = torch.Generator(device=DEV).manual_seed(seed + 3)
    agg = {n: dict(ms=0.0, kernel_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                   bytes_ms=0.0, ops_ms=0.0, max_abs_err=0.0)
           for n in PER_STEP}
    add_ms = 0.0
    print("phase 5: train kernels vs plain at every train-step site geometry "
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
    for (shape, dtype, T, th, kind), count in sites.items():
        r = check_train_site(shape, dtype, T, th, kind, gen)
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
    if n_sites != PER_STEP["plif_train_fwd"] or str(dtype) != "torch.bfloat16":
        fail(f"train step: {n_sites} spiking sites in {dtype}, expected "
             f"{PER_STEP['plif_train_fwd']} in bf16")
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
    the eager step against itself)."""
    runs = []
    for fn in (step, lambda e, t: train_step(model, opt, ema, e, t),
               lambda e, t: train_step(model, opt, ema, e, t)):
        restore(snap, model, opt, ema)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--forwards", type=int, default=5)
    ap.add_argument("--train-batch", type=int, default=64)
    ap.add_argument("--train-steps", type=int, default=8)
    ap.add_argument("--workers", type=int, default=7,
                    help="phases 7 and 8's loader worker processes")
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

        per_kernel = phase_kernels(model, batches[0], SEED)
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
            library_ms=None))
    print("kernel times: eval kernels per forward, train kernels per train "
          "step, each the sum over the kernel's sites of the per-call times "
          "above (ms: the wrapper's call, CUDA events; kernel_ms: the "
          "kernel's own device time, torch.profiler); arsnn_v2 per forward "
          "at the flagship (one call, Tm "
          "launches), arsnn_step per call at the flagship step geometry in "
          "f32; launches from phase 3 (eval, arsnn_v2 included: deploy()'s "
          "own route), phase 3c (arsnn_step: the v1 scan) and phase 6 "
          "(train); no "
          "single PyTorch call computes a fused site, the PLIF recurrence, "
          "its backward, the sampler scan or its step, so library_ms is "
          "null")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
