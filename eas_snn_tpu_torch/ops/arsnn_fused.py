"""The fused ARSNN sampler (counterpart of
``eas_snn_tpu/ops/arsnn_pallas.py``): forward only, for eval.

Two kernels, each with a plain PyTorch version beside it that repeats its
arithmetic operation for operation. Each is a registered op of the
``eas_snn`` namespace (``ops/library.py``) that the wrappers here call on
either device: the plain version on CPU tensors; on a CUDA tensor the
kernel, or a raise.

* **v1**, ``fused_step`` (``csrc/arsnn_step.cu``): one micro-step's
  elementwise chain (gated LIF, reset, no-reset integral, slot write) with
  the convs outside it, in the state dtype, rounding after every operation
  as eager PyTorch and XLA do. ``arsnn_scan_fused`` runs the scan with it,
  its convs being the caller's (cuDNN on the card, as XLA ran them
  outside the Pallas kernel).
* **v2**, ``arsnn_fused_v2`` (``csrc/arsnn_v2.cu``): the whole scan with
  both depth-stacked conv stacks computed inside the kernel as f32
  stencils, whatever dtype the events and the state come in. The stencil
  sums in the JAX kernel's order: the bias first, then for dy, ci, dx (and
  each output channel) ``out = fma(w, x, out)``, one fused multiply-add
  rounded once (:func:`fma_f32` emulates it exactly in the plain
  version); ReLU after every layer but the last; the intermediate layer's
  input is zero outside the image.

Both kernels spike with an exact Heaviside ``v - thresh > 0`` (no
surrogate: there is no backward). v2 skips the ``spike_attach`` multiply
(the spike is exactly 1 wherever a slot is written), as the JAX kernel
does. Layouts are NCHW, as in ``ops/arsnn.py``: events (Tm, N, Cin, H, W),
state (N, C, H, W), slots (Ts, N, C, H, W). Slot counters and last-spike
times are int8.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from . import _build

__all__ = ["fused_step", "fused_step_plain", "arsnn_scan_fused",
           "arsnn_fused_v2", "arsnn_fused_v2_plain", "arsnn_fused_v2_rows",
           "v2_supported",
           "arsnn_step_cpu", "arsnn_step_cuda", "arsnn_v2_cpu",
           "arsnn_v2_cuda",
           "sigmoid", "fma_f32", "READOUTS"]

READOUTS = ("sum", "last", "avg")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# int8 slot counters and last-spike times: t - t_last must fit
MAX_STEPS = 127
V2_KSIZES = (1, 3, 5, 7)   # the v2 kernel's compiled stencil sizes
# elements of one f64 temporary of the v2 plain version's stencils: its
# scan runs over chunks of the batch that keep each below this
PLAIN_CHUNK_ELEMS = 1 << 24
Weights = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def _onehot(seg: torch.Tensor, Ts: int) -> torch.Tensor:
    iota = torch.arange(Ts, dtype=seg.dtype, device=seg.device)
    return seg[None] == iota.reshape((Ts,) + (1,) * seg.dim())


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a * b + c`` on f32 tensors (broadcast) rounded once to f32, as a
    fused multiply-add (CUDA's ``__fmaf_rn``) computes it, emulated
    exactly in f64: the product of two f32 values is exact in f64; TwoSum
    gives the f64 sum ``s`` and its rounding error ``e`` exactly; rounding
    to odd (where ``e != 0`` and the last bit of ``s`` is even, ``s`` steps
    to its neighbour toward ``e``) makes the one conversion to f32 round
    as the exact ``a * b + c`` would (53 bits >= 24 + 2)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    z = s - p
    e = (p - (s - z)).add_(c - z)
    step = ((s.view(torch.int64) & 1) == 0) & (e != 0)
    toward = torch.copysign(torch.full_like(s, math.inf), e)
    return torch.where(step, torch.nextafter(s, toward), s).float()


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)) in x's dtype, each operation rounded to it: the
    kernels' sigmoid, XLA's expansion of ``jax.nn.sigmoid`` (in bf16 it
    rounds after the exp and the add too), and in f32 PyTorch's own CUDA
    sigmoid."""
    return 1.0 / (1.0 + torch.exp(-x))


def _check_readout(readout: str) -> None:
    if readout not in READOUTS:
        raise NotImplementedError(f"readout '{readout}'")


# ------------------------------------------------------------------ v1

def fused_step_plain(t: int, g_in, g_rec, c_in, c_rec, vmem, vavg, seg,
                     tlast, agg, *, Ts: int, thresh: float,
                     vreset: Optional[float], readout: str = "sum",
                     spike_attach: bool = False):
    """One micro-step in the state dtype (``vmem.dtype``), each operation
    rounded to it. Pure: returns new (vmem, vavg, spike, seg, tlast, agg)."""
    _check_readout(readout)
    dt = vmem.dtype
    gate = sigmoid(g_in + g_rec)
    current = c_in + c_rec
    v = gate * vmem + current
    spike = (v - thresh > 0).to(dt)
    if vreset is None:
        v_after = v - thresh * spike
    else:
        v_after = v * (1.0 - spike) + vreset * spike
    vavg_new = vavg + v
    spiked = spike > 0.5
    valid = spiked & (seg < Ts)
    if readout == "sum":
        w = vavg_new
    elif readout == "last":
        w = v_after
    else:
        w = vavg_new / (t - tlast.to(torch.int32)).clamp(min=1).to(dt)
    if spike_attach:
        w = w * spike
    zero = torch.zeros((), dtype=dt, device=vmem.device)
    write = torch.where(valid, w, zero)
    agg_new = agg + torch.where(_onehot(seg, Ts), write[None], zero)
    return (v_after, torch.where(spiked, zero, vavg_new), spike,
            seg + valid.to(seg.dtype),
            torch.where(valid, torch.tensor(t, dtype=tlast.dtype,
                                            device=tlast.device), tlast),
            agg_new)


def _check_step(t, ins, vmem, vavg, seg, tlast, agg, Ts, readout) -> None:
    _check_readout(readout)
    dt, shape = vmem.dtype, tuple(vmem.shape)
    if dt not in _DTYPE_CODE or len(shape) != 4:
        raise ValueError(f"fused_step: state must be (N, C, H, W) f32 or "
                         f"bf16, got {shape} {dt}")
    for x in ins:
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError("fused_step: the gate and current planes must "
                             "have the state's shape and dtype")
    if vavg.dtype != dt or tuple(vavg.shape) != shape:
        raise ValueError("fused_step: vavg must match vmem")
    for x in (seg, tlast):
        if x.dtype != torch.int8 or tuple(x.shape) != shape:
            raise ValueError("fused_step: seg and tlast must be int8 of the "
                             "state's shape")
    if agg.dtype != dt or tuple(agg.shape) != (Ts,) + shape:
        raise ValueError(f"fused_step: agg must be (Ts={Ts},) + {shape} in "
                         f"{dt}")
    if not 0 <= t < MAX_STEPS or not 0 < Ts <= MAX_STEPS:
        raise ValueError(f"fused_step: t and Ts must lie below {MAX_STEPS} "
                         "(int8 counters)")


def fused_step(t: int, g_in, g_rec, c_in, c_rec, vmem, vavg, seg, tlast,
               agg, *, Ts: int, thresh: float, vreset: Optional[float],
               readout: str = "sum", spike_attach: bool = False):
    """One micro-step that updates vmem, vavg, seg, tlast and agg in place
    (the JAX kernel's input_output_aliases) and returns (vmem, vavg,
    spike, seg, tlast, agg), spike a new tensor. Calls the registered op
    ``eas_snn::arsnn_step``, which launches ``csrc/arsnn_step.cu`` on CUDA
    tensors and on CPU tensors runs ``fused_step_plain`` and copies its
    results into the state.

    The kernel reads the four gate/current planes with 16-byte vectors:
    each must have the NCHW strides (sN, H*W, W, 1), the four the same sN
    (so they may be channel slices of one conv output), C*H*W a multiple of
    8 in bf16 or 4 in f32, every tensor 16-byte aligned; the state tensors
    are contiguous."""
    ins = (g_in, g_rec, c_in, c_rec)
    _check_step(t, ins, vmem, vavg, seg, tlast, agg, Ts, readout)
    spike = torch.ops.eas_snn.arsnn_step(
        int(t), *ins, vmem, vavg, seg, tlast, agg, int(Ts), float(thresh),
        None if vreset is None else float(vreset), readout,
        bool(spike_attach))
    return vmem, vavg, spike, seg, tlast, agg


def arsnn_step_cpu(t: int, g_in, g_rec, c_in, c_rec, vmem, vavg, seg, tlast,
                   agg, Ts: int, thresh: float, vreset: Optional[float],
                   readout: str, spike_attach: bool) -> torch.Tensor:
    """The CPU implementation of ``eas_snn::arsnn_step``: the plain step,
    its state copied into the five state tensors; returns the spike."""
    state = (vmem, vavg, seg, tlast, agg)
    out = fused_step_plain(t, g_in, g_rec, c_in, c_rec, *state, Ts=Ts,
                           thresh=thresh, vreset=vreset, readout=readout,
                           spike_attach=spike_attach)
    for dst, src in zip(state, out[:2] + out[3:]):
        dst.copy_(src)
    return out[2]


def arsnn_step_cuda(t: int, g_in, g_rec, c_in, c_rec, vmem, vavg, seg,
                    tlast, agg, Ts: int, thresh: float,
                    vreset: Optional[float], readout: str,
                    spike_attach: bool) -> torch.Tensor:
    """The device implementation of ``eas_snn::arsnn_step``: the layout
    checks and one launch of ``csrc/arsnn_step.cu``, counted in
    ``fused_step.launches``."""
    ins = (g_in, g_rec, c_in, c_rec)
    state = (vmem, vavg, seg, tlast, agg)
    for x in state:
        _build.require_cuda(x, "fused_step")
    N, C, H, W = vmem.shape
    HW, es = H * W, vmem.element_size()
    vec = 16 // es
    sN = g_in.stride(0)
    for x in ins + state:
        if x.device != vmem.device:
            raise ValueError("fused_step: tensors on different devices")
    for x in ins:
        if x.stride()[1:] != (HW, W, 1) or x.stride(0) != sN:
            raise ValueError("fused_step: the kernel needs the gate and "
                             "current planes in NCHW strides with one batch "
                             "stride")
    if (C * HW) % vec or sN % vec or any(x.data_ptr() % 16
                                         for x in ins + state):
        raise ValueError(f"fused_step: the kernel's 16-byte vectors need "
                         f"C*H*W and the batch stride multiples of {vec} and "
                         "16-byte aligned tensors")
    spike = torch.empty_like(vmem)
    err = _build.get_lib("arsnn_step").arsnn_step(
        *(x.data_ptr() for x in ins), sN, vmem.data_ptr(), vavg.data_ptr(),
        spike.data_ptr(), seg.data_ptr(), tlast.data_ptr(), agg.data_ptr(),
        N * C * HW, C * HW, int(t), int(Ts), float(thresh),
        0.0 if vreset is None else float(vreset), int(vreset is not None),
        READOUTS.index(readout), int(spike_attach), _DTYPE_CODE[vmem.dtype],
        _build.stream_ptr(vmem.device))
    _build.check(err, "arsnn_step")
    fused_step.launches += 1
    return spike


fused_step.launches = 0


def _residual(agg, vmem, vavg, spike, seg, tlast, Tm: int, Ts: int,
              readout: str, write_zero: bool, use_abs: bool):
    """The write for elements whose last slot never closed, then use_abs
    (embedding.py:203-217), in the state dtype."""
    dt = vmem.dtype
    valid = (spike <= 0.5) & (seg < Ts)
    if readout == "sum":
        w = vavg
    elif readout == "last":
        w = vmem
    else:
        w = vavg / (Tm - 1 - tlast.to(torch.int32)).clamp(min=1).to(dt)
    if write_zero:
        w = w * 0.0
    zero = torch.zeros((), dtype=dt, device=vmem.device)
    write = torch.where(valid, w, zero)
    agg = agg + torch.where(_onehot(seg, Ts), write[None], zero)
    return torch.relu(agg) if use_abs else agg


def arsnn_scan_fused(events: torch.Tensor,
                     input_conv_fn: Callable[[torch.Tensor], torch.Tensor],
                     gate_conv_fn: Callable[[torch.Tensor], torch.Tensor], *,
                     Ts: int, thresh: float, vreset: Optional[float],
                     readout: str = "sum", spike_attach: bool = False,
                     write_zero: bool = False, use_abs: bool = False
                     ) -> torch.Tensor:
    """The sampler over a time-reversed (Tm, N, Cin, H, W) stack with
    ``fused_step`` (v1) for each micro-step; the convs are the callers',
    outside the kernel. State in ``events.dtype``. Returns the (Ts, N, C,
    H, W) slots. Forward only: it raises if autograd would need a
    gradient through it (the plain ``arsnn_scan`` trains)."""
    _check_readout(readout)
    Tm, N = events.shape[:2]
    if Tm > MAX_STEPS:
        raise ValueError(f"arsnn_scan_fused: Tm={Tm} > {MAX_STEPS}")
    inp = input_conv_fn(events.reshape((Tm * N,) + tuple(events.shape[2:])))
    if inp.requires_grad:
        raise RuntimeError(
            "arsnn_scan_fused (the fused v1 sampler) has no gradient: train "
            "with fused_sampler='never', or run it under torch.no_grad()")
    inp = inp.reshape((Tm, N) + tuple(inp.shape[1:]))
    C = inp.shape[2] // 2
    shape = (N, C) + tuple(inp.shape[3:])
    dt, dev = events.dtype, events.device
    vmem = torch.zeros(shape, dtype=dt, device=dev)
    vavg = torch.zeros_like(vmem)
    spike = torch.zeros_like(vmem)
    seg = torch.zeros(shape, dtype=torch.int8, device=dev)
    tlast = torch.full(shape, -1, dtype=torch.int8, device=dev)
    agg = torch.zeros((Ts,) + shape, dtype=dt, device=dev)
    for t in range(Tm):
        rec = gate_conv_fn(spike)
        vmem, vavg, spike, seg, tlast, agg = fused_step(
            t, inp[t, :, :C], rec[:, :C], inp[t, :, C:], rec[:, C:], vmem,
            vavg, seg, tlast, agg, Ts=Ts, thresh=thresh, vreset=vreset,
            readout=readout, spike_attach=spike_attach)
    return _residual(agg, vmem, vavg, spike, seg, tlast, Tm, Ts, readout,
                     write_zero, use_abs)


# ------------------------------------------------------------------ v2

def v2_supported(Tm: int, C_in: int, C_out: int, depth: int, ksize: int,
                 Ts: int = 4, training: bool = False, N: int = 1) -> bool:
    """Can the whole-scan kernel run this sampler? JAX's structural
    conditions (C_in = C_out = 2, depth <= 2, ksize <= 7; JAX's "no
    ``record``" always holds, the port having no record option), eval only
    (the kernel has no backward), and the CUDA kernel's own limits in place of the JAX gate's VMEM budget, which was the v5e's:
    the stencil sizes it is compiled for (odd, <= 7), int8 counters
    (Tm, Ts < 128) and N in one grid dimension. The kernel streams its
    state through device memory tile by tile, so no size of H, W or N
    exhausts its shared memory (at most ~92 KB a block, at ksize 7), and
    unlike the JAX gate this one takes no H or W."""
    return (not training and depth in (1, 2)
            and C_in == 2 and C_out == 2 and ksize in V2_KSIZES
            and 0 < Tm <= MAX_STEPS and 0 < Ts <= MAX_STEPS
            and 0 < N <= 65535)


def _flat_weights(weights: Weights) -> Tuple[torch.Tensor, torch.Tensor]:
    """[(weight OIHW, bias), ...] -> flat f32 (w[co, ci, dy, dx] of every
    layer, biases), detached and contiguous."""
    ws = [w.detach().float().reshape(-1) for w, _ in weights]
    bs = [b.detach().float().reshape(-1) for _, b in weights]
    return torch.cat(ws).contiguous(), torch.cat(bs).contiguous()


def _stencil_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """One stencil layer in the JAX kernel's order: (N, ci, H, W) f32 ->
    (N, co, H, W), bias first, then for dy, ci, dx: out = fma(w, shifted
    x, out), each multiply-add rounded once (:func:`fma_f32`; the co axis
    is batched, which does not change any channel's order)."""
    N, ci_n, H, W = x.shape
    co_n, _, k, _ = w.shape
    p = k // 2
    xp = torch.nn.functional.pad(x, (p, p, p, p))
    out = b.reshape(1, co_n, 1, 1).expand(N, co_n, H, W).clone()
    for dy in range(k):
        for ci in range(ci_n):
            band = xp[:, ci:ci + 1, dy:dy + H]
            for dx in range(k):
                out = fma_f32(w[:, ci, dy, dx].reshape(1, co_n, 1, 1),
                              band[..., dx:dx + W], out)
    return out


def _stack_plain(x: torch.Tensor, weights: Weights) -> torch.Tensor:
    for i, (w, b) in enumerate(weights):
        if i:
            x = torch.relu(x)  # zero padding of the next layer: relu'd 0s
        x = _stencil_plain(x, w.detach().float(), b.detach().float())
    return x


def arsnn_fused_v2_plain(events: torch.Tensor, input_weights: Weights,
                         gate_weights: Weights, *, Ts: int, thresh: float,
                         vreset: Optional[float], readout: str = "sum",
                         spike_attach: bool = False, write_zero: bool = False,
                         use_abs: bool = False, exchange=None,
                         chunk_rows: Optional[int] = None) -> torch.Tensor:
    """Plain version of the whole-scan kernel, all in f32: (Tm, N, Cin, H,
    W) events (any float dtype, widened) -> (Ts, N, C, H, W) f32. The
    batch elements are independent, so it scans chunks of them one after
    the other (the f64 temporaries of :func:`fma_f32` stay below
    PLAIN_CHUNK_ELEMS elements each, for ``chunk_rows`` rows: H by
    default). ``exchange`` (a row shard's, ``arsnn_fused_v2_rows``) is
    called on the spikes after every micro-step."""
    _check_readout(readout)
    del spike_attach  # the spike is exactly 1 wherever a slot is written
    ev = events.float()
    N, H, W = ev.shape[1], ev.shape[3], ev.shape[4]
    co = max(w.shape[0] for w, _ in list(input_weights) + list(gate_weights))
    step = max(1, PLAIN_CHUNK_ELEMS // (co * (chunk_rows or H) * W))
    kw = dict(Ts=Ts, thresh=thresh, vreset=vreset, readout=readout,
              write_zero=write_zero, use_abs=use_abs, exchange=exchange)
    return torch.cat([_scan_plain(ev[:, n:n + step], input_weights,
                                  gate_weights, **kw)
                      for n in range(0, N, step)], dim=1)


def _scan_plain(ev: torch.Tensor, input_weights: Weights,
                gate_weights: Weights, *, Ts: int, thresh: float,
                vreset: Optional[float], readout: str, write_zero: bool,
                use_abs: bool, exchange=None) -> torch.Tensor:
    Tm, N, _, H, W = ev.shape
    C = input_weights[-1][0].shape[0] // 2
    f32 = dict(dtype=torch.float32, device=ev.device)
    vmem = torch.zeros((N, C, H, W), **f32)
    vavg = torch.zeros_like(vmem)
    spike = torch.zeros_like(vmem)
    seg = torch.zeros((N, C, H, W), dtype=torch.int8, device=ev.device)
    tlast = torch.full((N, C, H, W), -1, dtype=torch.int8, device=ev.device)
    agg = torch.zeros((Ts, N, C, H, W), **f32)
    for t in range(Tm):
        inp = _stack_plain(ev[t], input_weights)
        rec = _stack_plain(spike, gate_weights)
        vmem, vavg, spike, seg, tlast, agg = fused_step_plain(
            t, inp[:, :C], rec[:, :C], inp[:, C:], rec[:, C:], vmem, vavg,
            seg, tlast, agg, Ts=Ts, thresh=thresh, vreset=vreset,
            readout=readout)
        if exchange is not None:
            exchange(spike)
    return _residual(agg, vmem, vavg, spike, seg, tlast, Tm, Ts, readout,
                     write_zero, use_abs)


def _check_v2(events, input_weights, gate_weights, Ts, readout) -> int:
    """Check the geometry; return ksize."""
    _check_readout(readout)
    if events.dim() != 5:
        raise ValueError("arsnn_fused_v2: events must be (Tm, N, Cin, H, W)")
    Tm, N, Cin = events.shape[:3]
    ksize = input_weights[0][0].shape[-1]
    depth = len(input_weights)
    C = input_weights[-1][0].shape[0] // 2
    shapes_ok = len(gate_weights) == depth and all(
        w.shape[-2:] == (ksize, ksize) for w, _ in list(input_weights)
        + list(gate_weights))
    if not shapes_ok or not v2_supported(Tm, Cin, C, depth, ksize, Ts=Ts,
                                         N=N):
        raise ValueError(
            f"arsnn_fused_v2: the kernel does not take Tm={Tm}, N={N}, "
            f"Cin={Cin}, C={C}, depth={depth}, ksize={ksize}, Ts={Ts} "
            "(v2_supported)")
    return ksize


def arsnn_fused_v2(events: torch.Tensor, input_weights: Weights,
                   gate_weights: Weights, *, Ts: int, thresh: float,
                   vreset: Optional[float], readout: str = "sum",
                   spike_attach: bool = False, write_zero: bool = False,
                   use_abs: bool = False) -> torch.Tensor:
    """The whole sampler scan, forward only. ``events``: (Tm, N, 2, H, W)
    f32 or bf16 (read as is and widened to f32), already time-reversed;
    ``input_weights`` / ``gate_weights``: [(weight OIHW, bias), ...] per
    layer of each depth-stacked conv stack (used in f32). Returns (Ts, N,
    2, H, W) f32. Calls the registered op ``eas_snn::arsnn_v2`` on the
    layers' weights as one list (the input stack's, then the gate
    stack's, weight and bias a layer): on CUDA events it launches
    ``csrc/arsnn_v2.cu`` Tm times (one launch a micro-step); on CPU events
    it runs ``arsnn_fused_v2_plain``. ``spike_attach`` changes nothing
    (the spike is exactly 1 wherever a slot is written)."""
    _check_v2(events, input_weights, gate_weights, Ts, readout)
    if events.device.type != "cpu" and events.dtype not in _DTYPE_CODE:
        raise ValueError(f"arsnn_fused_v2: events must be f32 or bf16, got "
                         f"{events.dtype}")
    flat = [p for w, b in list(input_weights) + list(gate_weights)
            for p in (w, b)]
    return torch.ops.eas_snn.arsnn_v2(
        events, flat, len(input_weights), int(Ts), float(thresh),
        None if vreset is None else float(vreset), readout, bool(write_zero),
        bool(use_abs))


def arsnn_fused_v2_rows(events: torch.Tensor, input_weights: Weights,
                        gate_weights: Weights, *, exchange, chunk_rows: int,
                        Ts: int, thresh: float, vreset: Optional[float],
                        readout: str = "sum", spike_attach: bool = False,
                        write_zero: bool = False, use_abs: bool = False
                        ) -> torch.Tensor:
    """:func:`arsnn_fused_v2` on a row shard grown by its halo: after each
    micro-step ``exchange`` refreshes the halo rows of the step's spikes
    (the state the next step's gate stencil reads) from the neighbouring
    shards. The kernel on CUDA events (Tm launches, counted in
    ``arsnn_fused_v2.launches``), the plain version on CPU ones
    (``chunk_rows``: the rows every shard chunks its batch for, so that
    all shards call ``exchange`` alike). Not a registered op: the
    exchange is a collective."""
    _check_v2(events, input_weights, gate_weights, Ts, readout)
    del spike_attach
    flat = [p for w, b in list(input_weights) + list(gate_weights)
            for p in (w, b)]
    args = (events, flat, len(input_weights), int(Ts), float(thresh),
            None if vreset is None else float(vreset), readout,
            bool(write_zero), bool(use_abs))
    if events.device.type == "cpu":
        return arsnn_v2_cpu(*args, exchange=exchange, chunk_rows=chunk_rows)
    if events.dtype not in _DTYPE_CODE:
        raise ValueError(f"arsnn_fused_v2: events must be f32 or bf16, got "
                         f"{events.dtype}")
    return arsnn_v2_cuda(*args, exchange=exchange)


def _pairs(weights: Sequence[torch.Tensor], depth: int):
    """The op's flat weight list -> (input stack, gate stack) of
    (weight, bias) pairs."""
    pairs = [(weights[i], weights[i + 1]) for i in range(0, len(weights), 2)]
    return pairs[:depth], pairs[depth:]


def arsnn_v2_cpu(events, weights, depth: int, Ts: int, thresh: float,
                 vreset: Optional[float], readout: str, write_zero: bool,
                 use_abs: bool, exchange=None,
                 chunk_rows: Optional[int] = None) -> torch.Tensor:
    """The CPU implementation of ``eas_snn::arsnn_v2``: the plain scan."""
    return arsnn_fused_v2_plain(
        events, *_pairs(weights, depth), Ts=Ts, thresh=thresh, vreset=vreset,
        readout=readout, write_zero=write_zero, use_abs=use_abs,
        exchange=exchange, chunk_rows=chunk_rows)


def arsnn_v2_cuda(events, weights, depth: int, Ts: int, thresh: float,
                  vreset: Optional[float], readout: str, write_zero: bool,
                  use_abs: bool, exchange=None) -> torch.Tensor:
    """The device implementation of ``eas_snn::arsnn_v2``: Tm launches of
    ``csrc/arsnn_v2.cu``, counted in ``arsnn_fused_v2.launches``;
    ``exchange`` (``arsnn_fused_v2_rows``) gets each step's spikes after
    its launch."""
    _build.require_cuda(events, "arsnn_fused_v2")
    input_weights, gate_weights = _pairs(weights, depth)
    ksize = input_weights[0][0].shape[-1]
    Tm, N, _, H, W = events.shape
    dev = events.device
    iw, ib = (p.to(dev) for p in _flat_weights(input_weights))
    gw, gb = (p.to(dev) for p in _flat_weights(gate_weights))
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((Ts, N, 2, H, W), **f32)  # every value written
    # device-memory state between the Tm launches, each tensor 16-byte
    # aligned: membrane and no-reset integral (f32), slot counter and
    # last-spike time (int8), and the spikes double-buffered (u8) so that
    # step t's gate stencil reads step t-1's spikes of its neighbours
    vmem = torch.empty((N, 2, H, W), **f32)
    vavg = torch.empty_like(vmem)
    seg = torch.empty((N, 2, H, W), dtype=torch.int8, device=dev)
    tlast = torch.empty_like(seg)
    spikes = [torch.empty((N, 2, H, W), dtype=torch.uint8, device=dev)
              for _ in range(2)]
    lib = _build.get_lib("arsnn_v2")
    stream = _build.stream_ptr(dev)
    for t in range(Tm):
        err = lib.arsnn_v2_step(
            events.data_ptr(), iw.data_ptr(), ib.data_ptr(), gw.data_ptr(),
            gb.data_ptr(), out.data_ptr(), vmem.data_ptr(), vavg.data_ptr(),
            seg.data_ptr(), tlast.data_ptr(), spikes[t % 2].data_ptr(),
            spikes[(t + 1) % 2].data_ptr(), N, H, W, Tm, Ts, t,
            depth, ksize, float(thresh),
            0.0 if vreset is None else float(vreset),
            int(vreset is not None), READOUTS.index(readout),
            int(write_zero), int(use_abs), _DTYPE_CODE[events.dtype], stream)
        _build.check(err, "arsnn_v2_step")
        arsnn_fused_v2.launches += 1
        if exchange is not None:
            exchange(spikes[(t + 1) % 2])
    return out


arsnn_fused_v2.launches = 0
