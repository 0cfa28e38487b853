"""PLIF over T time steps folded in the batch axis (counterpart of
``eas_snn_tpu/ops/plif_pallas.py``): the eval forward with int8 spikes
out, and the train op, a differentiable PLIF with the train-mode BN folded
in (:func:`plif_train`).

    a = 1 - sigmoid(w)            f32, computed outside the kernel
    v_t = v_{t-1} * a + x_t       f32 membrane whatever the storage dtype
    s_t = [v_t - thresh >= 0]     (>= for atan/sigmoid, > for rect/tanh)
    v_t <- v_t - thresh * s_t     soft reset

Optionally the site's eval BatchNorm comes first, ``bn = (mean, mul,
bias)`` per channel of an NCHW x: x <- ((x - mean) * mul + bias) in f32,
rounded to x's dtype (:func:`bn_eval`, what the unfused BN computes). The
JAX package leaves that BN to XLA, which fuses it; the port fuses it into
the kernel, which always applies one: without ``bn`` the wrapper passes
the identity terms (0, 1, 0), exact in both dtypes.

The spikes are always stored as int8: they are exactly 0/1, so the storage
is lossless. On a CUDA tensor ``plif_forward`` launches ``csrc/plif.cu``
on an NCHW tensor of any H*W, cut into items as :func:`plif_fwd_plan`
says (one 16-byte vector a thread where H*W splits into them, else
single elements: the scalar tail); on a CPU tensor it runs
``plif_forward_plain``, the same arithmetic in PyTorch ops (bit-equal to
the kernel, which rounds after every operation). A caller that keeps the
decay multiplier ``a`` (``models/blocks.py:PLIF`` does at eval) passes it
and saves the two small kernels that compute it.

The train op (:func:`plif_train`) takes the BN's per-channel (mean, mul,
bias) of the batch statistics and ``a = 1 - sigmoid(w)`` as tensors, so
that autograd chains their gradients into the statistics, the BN scale and
bias, and w. Its forward (``plif_train_forward``, ``csrc/plif.cu``) is the
eval kernel storing spikes in x's dtype; its backward
(``plif_train_backward``, ``csrc/plif_bwd.cu``) recomputes the forward in
f32 and walks back in time:

    g_pre = g_after + (g - thresh * g_after) * f'(v_pre - thresh)
    dx = g_pre * mul                   in x's dtype
    da = sum g_pre * v_after_{t-1}     ds = sum g_pre * (x - mean)
    db = sum g_pre                     dm = -mul * db

with f' the surrogate derivative (``surrogate.surrogate_deriv``). The
backward is one launch a call (:func:`plif_bwd_plan` cuts the grid; the
last block to finish sums the blocks' partials in a fixed order, in a
scratch buffer kept per device and stream). Both have plain versions
here, which the wrappers run on CPU tensors; dx is bit-equal between
kernel and plain version, the sums agree to f32 summation order.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from . import _build
from .surrogate import spike_ge, surrogate_deriv, train_alpha

__all__ = ["plif_forward", "plif_forward_plain", "plif_spikes_plain",
           "plif_fwd_cuda", "decay_multiplier",
           "bn_eval", "plif_train", "plif_train_forward",
           "plif_train_forward_plain", "plif_train_backward",
           "plif_train_backward_plain", "plif_fwd_plan", "plif_bwd_plan"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BN = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # mean, mul, bias

# threads a block (kThreads of csrc/plif.cu and csrc/plif_bwd.cu)
THREADS = 256
# the kernels' offsets within a step are 32-bit
MAX_STEP_ELEMS = 2**31 - 1


class FwdPlan(NamedTuple):
    """Grid of the forward kernel: item q (one a thread) is the E elements
    from element (q % ipp) * E of (b, c) plane q // ipp, at every step."""
    E: int          # elements an item
    ipp: int        # items a plane
    items: int      # items a step
    grid: int       # blocks of THREADS


@functools.lru_cache(maxsize=1024)
def plif_fwd_plan(B: int, C: int, HW: int, dtype: torch.dtype,
                  aligned: bool = True) -> FwdPlan:
    """Items of the PLIF forward kernel (eval and train) over a (T*B, C,
    H, W) x of H*W = HW: one 16-byte vector where H*W splits into them,
    else one element (a ragged H*W, or an x not 16-byte aligned: the
    scalar tail). One item a thread; the grid covers every item once
    (5,760 blocks of 256 threads at the smallest flagship eval site,
    384x384x8x10 in bf16)."""
    vec = 16 // dtype.itemsize
    E = vec if aligned and HW % vec == 0 else 1
    items = B * C * HW // E
    return FwdPlan(E, HW // E, items, max(1, -(-items // THREADS)))


class BwdPlan(NamedTuple):
    """Grid of the backward kernel: block c * nb + j walks items j * chunk
    ... min((j + 1) * chunk, per_c) - 1 of channel c (item q of a channel
    is the E elements from element (q % ipp) * E of plane (q // ipp, c)),
    its threads in steps of THREADS: at most ipt items a thread."""
    E: int          # elements an item
    ipp: int        # items a plane
    per_c: int      # items a channel
    ipt: int        # items a thread, at most
    nb: int         # blocks a channel
    chunk: int      # items a block
    grid: int       # C * nb blocks
    scratch: int    # f32 words of scratch: the ticket (padded to 4), then
                    # 3 partials a block
    waves: float    # grid over the blocks the card holds at once


def _bwd_blocks_per_sm(T: int) -> int:
    """csrc/plif_bwd.cu:bwd_min_blocks."""
    return 3 if T <= 4 else 2 if T <= 6 else 1


@functools.lru_cache(maxsize=1024)
def plif_bwd_plan(B: int, C: int, HW: int, dtype: torch.dtype, T: int,
                  aligned: bool = True, sms: int = 132) -> BwdPlan:
    """Grid of the PLIF backward kernel over a (T*B, C, H, W) x: items of
    one 16-byte vector (one element where H*W does not split into them, or
    x, g are not 16-byte aligned), blocks inside one channel (its sums stay
    the block's), and as many items a thread (1, 2, 4 or 8) as keep at
    least two waves of resident blocks on the card and the threads as
    evenly loaded: fewer blocks mean fewer partials for the last block to
    sum, but a block's last round over its items must not leave more of
    its threads idle (at 8x10, 640 items a channel are 3 blocks of one
    round, not 2 of two rounds with 3/8 of the threads idle in the
    second)."""
    vec = 16 // dtype.itemsize
    E = vec if aligned and HW % vec == 0 else 1
    per_c = B * HW // E
    resident = sms * _bwd_blocks_per_sm(T)

    def cut(ipt: int) -> Tuple[int, int, float]:
        """(blocks a channel, items a block, busy share of the threads)"""
        nb = -(-per_c // (THREADS * ipt))
        chunk = -(-per_c // nb)
        return nb, chunk, chunk / (THREADS * -(-chunk // THREADS))

    ipt = 1
    while ipt < 8 and C * cut(2 * ipt)[0] >= 2 * resident and \
            cut(2 * ipt)[2] >= cut(ipt)[2]:
        ipt *= 2
    nb, chunk, _ = cut(ipt)
    grid = C * nb
    return BwdPlan(E, HW // E, per_c, ipt, nb, chunk, grid, 4 + 3 * grid,
                   grid / resident)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The arithmetic of the plain versions on x of ``dtype``: f32 for
    bf16 and f32 (the kernels'), f64 for an f64 x (a float64 reference on
    the CPU, where the f32 sums that cancel would hide a gradient)."""
    return torch.promote_types(dtype, torch.float32)


def bn_eval(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
            bias: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Eval BatchNorm of an NCHW x: (x - mean) * mul + bias in f32 (f64
    for an f64 x), cast to ``out_dtype`` (the JAX package's BN
    arithmetic)."""
    shp = (1, -1, 1, 1)
    y = (x.to(acc_dtype(x.dtype)) - mean.reshape(shp)) * mul.reshape(shp) \
        + bias.reshape(shp)
    return y.to(out_dtype)


def decay_multiplier(w: torch.Tensor) -> torch.Tensor:
    """a = 1 - sigmoid(w) in f32, as a 1-element tensor on w's device."""
    return (1.0 - torch.sigmoid(w.detach().float())).reshape(1)


def plif_forward_plain(x_tb: torch.Tensor, T: int, w: torch.Tensor,
                       thresh: float = 1.0, kind: str = "atan",
                       bn: Optional[BN] = None,
                       a: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch PLIF forward: (T*B, ...) bf16/f32 -> int8 spikes;
    ``a`` is ``decay_multiplier(w)`` where the caller keeps it."""
    a = decay_multiplier(w) if a is None else a
    return plif_spikes_plain(x_tb, T, a, bn, thresh, spike_ge(kind))


def plif_spikes_plain(x_tb: torch.Tensor, T: int, a: torch.Tensor,
                      bn: Optional[BN], thresh: float, ge: bool
                      ) -> torch.Tensor:
    """:func:`plif_forward_plain` on the decay multiplier ``a`` and the
    comparison (``ge``: >=, else >): the CPU implementation of the
    registered op ``eas_snn::plif_fwd`` (``ops/library.py``)."""
    if bn is not None:
        x_tb = bn_eval(x_tb, *bn, x_tb.dtype)
    a = a.to(x_tb.device)
    xs = x_tb.reshape((T, -1) + tuple(x_tb.shape[1:])).float()
    v = torch.zeros_like(xs[0])
    outs = []
    for t in range(T):
        v = v * a + xs[t]
        d = v - thresh
        s = d >= 0 if ge else d > 0
        outs.append(s.to(torch.int8))
        v = v - thresh * s.float()
    return torch.stack(outs).reshape(x_tb.shape)


def _fwd_launch(entry: str, x: torch.Tensor, out: torch.Tensor,
                a: torch.Tensor, bn: BN, T: int, thresh: float,
                ge: bool) -> None:
    """Launch ``entry`` of csrc/plif.cu on x (checked: CUDA, contiguous,
    (T*B, C, H, W), bf16/f32) with the f32 ``a`` and BN terms on its
    device."""
    C, HW = x.shape[1], x.shape[2] * x.shape[3]
    n = x.numel() // T
    if n > MAX_STEP_ELEMS:
        raise ValueError(f"{entry}: {n} elements a step; the kernel's "
                         f"offsets are 32-bit (at most {MAX_STEP_ELEMS})")
    plan = plif_fwd_plan(n // (C * HW), C, HW, x.dtype,
                         aligned=x.data_ptr() % 16 == 0)
    err = getattr(_build.get_lib("plif"), entry)(
        x.data_ptr(), out.data_ptr(), a.data_ptr(), n, T, float(thresh),
        int(ge), _DTYPE_CODE[x.dtype],
        *(p.data_ptr() for p in bn), C, HW, plan.E, plan.grid,
        _build.stream_ptr(x.device),
    )
    _build.check(err, entry)


def plif_forward(x_tb: torch.Tensor, T: int, w: torch.Tensor,
                 thresh: float = 1.0, kind: str = "atan",
                 out_dtype: torch.dtype = torch.int8,
                 bn: Optional[BN] = None,
                 a: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PLIF over a (T*B, C, H, W) preactivation, spikes in int8; with
    ``bn`` the preactivation is ``bn_eval(x_tb, *bn, x_tb.dtype)``. ``a``
    is ``decay_multiplier(w)`` where the caller keeps it (f32, on x's
    device); the BN terms cost nothing more a call when they are f32 and
    contiguous on x's device. Calls the registered op
    ``eas_snn::plif_fwd``: the kernel on a CUDA tensor, the plain version
    on a CPU one."""
    if out_dtype != torch.int8:
        raise ValueError("plif_forward stores spikes as int8 only")
    if x_tb.shape[0] % T:
        raise ValueError(f"leading dim {x_tb.shape[0]} is not a multiple "
                         f"of T={T}")
    if bn is not None and (x_tb.dim() != 4 or any(
            p.shape != (x_tb.shape[1],) for p in bn)):
        raise ValueError("bn needs an NCHW x and (C,) mean, mul and bias")
    if x_tb.device.type != "cpu":
        if x_tb.dtype not in _DTYPE_CODE:
            raise ValueError(f"plif_forward: unsupported dtype {x_tb.dtype}")
        if x_tb.dim() != 4:
            raise ValueError("plif_forward: the kernel takes (T*B, C, H, W)")
    a = decay_multiplier(w) if a is None else a
    a, *bn = (None if p is None else p.to(device=x_tb.device,
                                          dtype=torch.float32).contiguous()
              for p in (a, *(bn or (None,) * 3)))
    return torch.ops.eas_snn.plif_fwd(x_tb, T, a, *bn, float(thresh),
                                      spike_ge(kind))


def plif_fwd_cuda(x_tb: torch.Tensor, T: int, a: torch.Tensor,
                  mean: Optional[torch.Tensor], mul: Optional[torch.Tensor],
                  bias: Optional[torch.Tensor], thresh: float, ge: bool
                  ) -> torch.Tensor:
    """The device implementation of ``eas_snn::plif_fwd``: one launch of
    ``csrc/plif.cu``, counted in ``plif_forward.launches``. Without BN
    terms it passes the identity (0, 1, 0)."""
    _build.require_cuda(x_tb, "plif_forward")
    C = x_tb.shape[1]
    bn = (mean, mul, bias)
    if mean is None:
        bn = tuple(p.to(x_tb.device) for p in (
            torch.zeros(C), torch.ones(C), torch.zeros(C)))
    out = torch.empty(x_tb.shape, dtype=torch.int8, device=x_tb.device)
    _fwd_launch("plif_fwd", x_tb, out, a, bn, T, thresh, ge)
    plif_forward.launches += 1
    return out


plif_forward.launches = 0


# ------------------------------------------------------------------ train

# surrogate kind -> the backward kernel's code
_KIND_CODE = {"atan": 0, "rect": 1, "sigmoid": 2, "tanh": 3}


def _steps(x: torch.Tensor, T: int) -> torch.Tensor:
    """(T*B, ...) -> (T, B, ...)."""
    return x.reshape((T, -1) + tuple(x.shape[1:]))


def plif_train_forward_plain(x, a, mean, mul, bias, T: int,
                             thresh: float = 1.0, kind: str = "atan"
                             ) -> torch.Tensor:
    """Plain train forward: spikes of ``bn_eval(x, mean, mul, bias,
    x.dtype)`` with an f32 membrane (f64 for an f64 x), in x's dtype."""
    ge = spike_ge(kind)
    acc = acc_dtype(x.dtype)
    xs = _steps(bn_eval(x, mean, mul, bias, x.dtype), T).to(acc)
    a = a.to(acc)
    v = torch.zeros_like(xs[0])
    outs = []
    for t in range(T):
        v = v * a + xs[t]
        d = v - thresh
        s = (d >= 0 if ge else d > 0).to(acc)
        outs.append(s.to(x.dtype))
        v = v - thresh * s
    return torch.stack(outs).reshape(x.shape)


def plif_train_backward_plain(x, g, a, mean, mul, bias, T: int,
                              thresh: float = 1.0, kind: str = "atan",
                              alpha: float = 2.0):
    """Plain train backward: (dx, da (1,), dm, ds, db), the sums in f32
    (f64 for an f64 x)."""
    ge = spike_ge(kind)
    acc = acc_dtype(x.dtype)
    shp = (1, -1, 1, 1)
    m, s, b = (p.to(acc).reshape(shp) for p in (mean, mul, bias))
    a = a.to(acc)
    xs, gs = _steps(x, T), _steps(g, T)
    v = torch.zeros(xs.shape[1:], dtype=acc, device=x.device)
    xms, d_pre, v_prev = [], [], []
    for t in range(T):
        v_prev.append(v)
        xm = xs[t].to(acc) - m
        xms.append(xm)
        v = v * a + (xm * s + b).to(x.dtype).to(acc)
        d = v - thresh
        d_pre.append(d)
        v = v - thresh * (d >= 0 if ge else d > 0).to(acc)
    dx = torch.empty_like(xs)
    da = torch.zeros(1, dtype=acc, device=x.device)
    ds = torch.zeros(x.shape[1], dtype=acc, device=x.device)
    db = torch.zeros_like(ds)
    g_after = torch.zeros_like(v)
    for t in range(T - 1, -1, -1):
        fp = surrogate_deriv(kind, alpha, d_pre[t])
        g_pre = g_after + (gs[t].to(acc) - thresh * g_after) * fp
        dx[t] = (g_pre * s).to(x.dtype)
        ds += (g_pre * xms[t]).sum((0, 2, 3))
        db += g_pre.sum((0, 2, 3))
        da += (g_pre * v_prev[t]).sum()
        g_after = g_pre * a
    return dx.reshape(x.shape), da, -(mul.to(acc) * db), ds, db


def _train_operands(x, a, bn, T: int, what: str):
    """Check the kernel's layout; the f32 (1,) a and (C,) terms on x's
    device, contiguous."""
    _build.require_cuda(x, what)
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: unsupported dtype {x.dtype}")
    if x.numel() // T > MAX_STEP_ELEMS:
        raise ValueError(f"{what}: {x.numel() // T} elements a step; the "
                         f"kernel's offsets are 32-bit (at most "
                         f"{MAX_STEP_ELEMS})")
    for p in (a, *bn):
        if p.device != x.device:
            raise ValueError(f"{what}: BN terms or a on {p.device}, x on "
                             f"{x.device}")
    a = a.detach().float().reshape(1).contiguous()
    return a, tuple(p.detach().float().contiguous() for p in bn)


def plif_train_forward(x, a, mean, mul, bias, T: int, thresh: float = 1.0,
                       kind: str = "atan") -> torch.Tensor:
    """Train forward on (T*B, C, H, W): spikes in x's dtype. Launches
    ``plif_train_fwd`` on a CUDA tensor, runs the plain version on a CPU
    one."""
    if x.device.type == "cpu":
        return plif_train_forward_plain(x, a, mean, mul, bias, T, thresh,
                                        kind)
    a, bn = _train_operands(x, a, (mean, mul, bias), T,
                            "plif_train_forward")
    out = torch.empty_like(x)
    _fwd_launch("plif_train_fwd", x, out, a, bn, T, thresh, spike_ge(kind))
    plif_train_forward.launches += 1
    return out


def _surrogate_constants(kind: str, alpha: float) -> Tuple[float, float]:
    """(p0, p1) of csrc/plif_bwd.cu:surrogate_deriv."""
    if kind == "atan":
        return (math.pi / 2.0) * alpha, alpha / 2.0
    if kind == "rect":
        return 0.5 / alpha, alpha
    if kind == "sigmoid":
        return alpha, alpha
    return alpha, 0.5 * alpha


# (device, stream) -> f32 scratch of the backward kernel: its ticket
# (zero between launches: the kernel's last block resets it) and the
# blocks' partials. Grown, never shrunk; launches on one stream are
# ordered, so one buffer serves them all. A CUDA graph keeps the address
# it captured, so a buffer that growth replaces stays alive in
# _BWD_RETIRED (a graph of a smaller geometry still writes it at replay),
# and no buffer is made or grown during a capture: a step warms up on the
# capturing stream first (core/train_state.py:CapturedStep).
_BWD_SCRATCH: Dict[Tuple[str, int], torch.Tensor] = {}
_BWD_RETIRED: List[torch.Tensor] = []


def _capturing(dev: torch.device) -> bool:
    return dev.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _bwd_scratch(dev: torch.device, stream: int, words: int) -> torch.Tensor:
    key = (str(dev), stream)
    buf = _BWD_SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        if _capturing(dev):
            raise RuntimeError(
                "plif_train_backward: its scratch buffer would be made or "
                f"grown to {words} words during a CUDA graph capture; run "
                "the step eagerly on the capturing stream first")
        if buf is not None:
            _BWD_RETIRED.append(buf)
        buf = torch.zeros(1 << max(12, (words - 1).bit_length()),
                          dtype=torch.float32, device=dev)
        _BWD_SCRATCH[key] = buf
    return buf


def plif_train_backward(x, g, a, mean, mul, bias, T: int,
                        thresh: float = 1.0, kind: str = "atan",
                        alpha: float = 2.0):
    """Train backward: (dx in x's dtype, da (1,), dm, ds, db f32 (C,)).
    Launches ``plif_train_bwd`` (one launch, deterministic sums) on a
    CUDA tensor, runs the plain version on a CPU one. Two allocations a
    call: dx, and the f32 buffer whose views are da, dm, ds and db."""
    if x.device.type == "cpu":
        return plif_train_backward_plain(x, g, a, mean, mul, bias, T, thresh,
                                         kind, alpha)
    a, bn = _train_operands(x, a, (mean, mul, bias), T,
                            "plif_train_backward")
    g = g.to(x.dtype).contiguous()
    if g.shape != x.shape:
        raise ValueError("plif_train_backward: the cotangent must have x's "
                         "shape")
    if not 1 <= T <= 8:
        raise ValueError(f"plif_train_backward: the kernel takes T in 1..8, "
                         f"got {T}")
    B, C = x.shape[0] // T, x.shape[1]
    HW = x.shape[2] * x.shape[3]
    dev = x.device
    plan = plif_bwd_plan(B, C, HW, x.dtype, T,
                         (x.data_ptr() | g.data_ptr()) % 16 == 0,
                         _build.sm_count(dev))
    stream = _build.stream_ptr(dev)
    dx = torch.empty_like(x)
    sums = torch.empty(1 + 3 * C, dtype=torch.float32, device=dev)
    p0, p1 = _surrogate_constants(kind, alpha)
    err = _build.get_lib("plif_bwd").plif_train_bwd(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), a.data_ptr(),
        *(p.data_ptr() for p in bn),
        _bwd_scratch(dev, stream, plan.scratch).data_ptr(), sums.data_ptr(),
        T, B, C, HW, plan.E, plan.nb, plan.chunk, float(thresh),
        int(spike_ge(kind)), _KIND_CODE[kind], float(p0), float(p1),
        _DTYPE_CODE[x.dtype], stream,
    )
    _build.check(err, "plif_train_bwd")
    plif_train_backward.launches += 1
    da, dm, ds, db = sums.split((1, C, C, C))
    return dx, da, dm, ds, db


plif_train_forward.launches = 0
plif_train_backward.launches = 0


class _PLIFTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, mean, mul, bias, T, thresh, kind, alpha):
        ctx.save_for_backward(x, a, mean, mul, bias)
        ctx.cfg = (T, thresh, kind, alpha)
        return plif_train_forward(x, a, mean, mul, bias, T, thresh, kind)

    @staticmethod
    def backward(ctx, g):
        x, a, mean, mul, bias = ctx.saved_tensors
        dx, da, dm, ds, db = plif_train_backward(x, g, a, mean, mul, bias,
                                                 *ctx.cfg)
        return (dx, da.reshape(a.shape).to(a.dtype), dm, ds, db,
                None, None, None, None)


def plif_train(x: torch.Tensor, T: int, a: torch.Tensor, mean: torch.Tensor,
               mul: torch.Tensor, bias: torch.Tensor, thresh: float = 1.0,
               kind: str = "atan", alpha: float = 2.0) -> torch.Tensor:
    """Differentiable PLIF of ``bn_eval(x, mean, mul, bias, x.dtype)`` over a
    (T*B, C, H, W) x; ``a`` = 1 - sigmoid(w) (any shape of one element),
    (C,) f32 BN terms. Spikes in x's dtype; the backward gives x, a and
    the three BN terms their gradients."""
    if kind not in _KIND_CODE:
        raise NotImplementedError(
            f"spike_fn '{kind}' has no train PLIF op: patan (ASGL) trains "
            "through the plain scan with its learnable alpha "
            "(models/blocks.py:PLIF), as in the JAX package")
    if x.dim() != 4 or x.shape[0] % T:
        raise ValueError(f"plif_train: expected (T*B, C, H, W) with T={T}, "
                         f"got {tuple(x.shape)}")
    if a.numel() != 1 or any(p.shape != (x.shape[1],)
                             for p in (mean, mul, bias)):
        raise ValueError("plif_train: a must hold one value and mean, mul, "
                         "bias be (C,)")
    return _PLIFTrain.apply(x, a, mean, mul, bias, T, float(thresh), kind,
                            train_alpha(kind, alpha))
