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
is lossless. On a CUDA tensor ``plif_forward`` launches ``csrc/plif.cu``,
which takes an NCHW tensor whose H*W splits into 16-byte vectors (a
multiple of 8 in bf16, of 4 in f32) at a 16-byte aligned address, and
raises otherwise; on a CPU tensor it runs ``plif_forward_plain``, the same
arithmetic in PyTorch ops (bit-equal to the kernel, which rounds after
every operation).

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

with f' the surrogate derivative (``surrogate.surrogate_deriv``). Both
have plain versions here, which the wrappers run on CPU tensors; dx is
bit-equal between kernel and plain version, the sums agree to f32
summation order.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build
from .surrogate import spike_ge, surrogate_deriv, train_alpha

__all__ = ["plif_forward", "plif_forward_plain", "decay_multiplier",
           "bn_eval", "plif_train", "plif_train_forward",
           "plif_train_forward_plain", "plif_train_backward",
           "plif_train_backward_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BN = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # mean, mul, bias


def bn_eval(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
            bias: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Eval BatchNorm of an NCHW x: (x - mean) * mul + bias in f32, cast to
    ``out_dtype`` (the JAX package's BN arithmetic)."""
    shp = (1, -1, 1, 1)
    y = (x.float() - mean.reshape(shp)) * mul.reshape(shp) + bias.reshape(shp)
    return y.to(out_dtype)


def decay_multiplier(w: torch.Tensor) -> torch.Tensor:
    """a = 1 - sigmoid(w) in f32, as a 1-element tensor on w's device."""
    return (1.0 - torch.sigmoid(w.detach().float())).reshape(1)


def plif_forward_plain(x_tb: torch.Tensor, T: int, w: torch.Tensor,
                       thresh: float = 1.0, kind: str = "atan",
                       bn: Optional[BN] = None) -> torch.Tensor:
    """Plain PyTorch PLIF forward: (T*B, ...) bf16/f32 -> int8 spikes."""
    if bn is not None:
        x_tb = bn_eval(x_tb, *bn, x_tb.dtype)
    ge = spike_ge(kind)
    a = decay_multiplier(w).to(x_tb.device)
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


def plif_forward(x_tb: torch.Tensor, T: int, w: torch.Tensor,
                 thresh: float = 1.0, kind: str = "atan",
                 out_dtype: torch.dtype = torch.int8,
                 bn: Optional[BN] = None) -> torch.Tensor:
    """PLIF over a (T*B, C, H, W) preactivation, spikes in int8; with
    ``bn`` the preactivation is ``bn_eval(x_tb, *bn, x_tb.dtype)``."""
    if out_dtype != torch.int8:
        raise ValueError("plif_forward stores spikes as int8 only")
    if x_tb.shape[0] % T:
        raise ValueError(f"leading dim {x_tb.shape[0]} is not a multiple "
                         f"of T={T}")
    if bn is not None and (x_tb.dim() != 4 or any(
            p.shape != (x_tb.shape[1],) for p in bn)):
        raise ValueError("bn needs an NCHW x and (C,) mean, mul and bias")
    if x_tb.device.type == "cpu":
        return plif_forward_plain(x_tb, T, w, thresh, kind, bn)
    _build.require_cuda(x_tb, "plif_forward")
    if x_tb.dtype not in _DTYPE_CODE:
        raise ValueError(f"plif_forward: unsupported dtype {x_tb.dtype}")
    if x_tb.dim() != 4:
        raise ValueError("plif_forward: the kernel takes (T*B, C, H, W)")
    C, HW = x_tb.shape[1], x_tb.shape[2] * x_tb.shape[3]
    vec = 16 // x_tb.element_size()
    if HW % vec or x_tb.data_ptr() % 16:
        raise ValueError(f"plif_forward: H*W={HW} must be a multiple of {vec} "
                         "and x 16-byte aligned for the kernel's vector loads")
    a = decay_multiplier(w).to(x_tb.device)
    if bn is None:
        bn = (torch.zeros(C), torch.ones(C), torch.zeros(C))
    bn = tuple(p.to(device=x_tb.device, dtype=torch.float32).contiguous()
               for p in bn)
    out = torch.empty(x_tb.shape, dtype=torch.int8, device=x_tb.device)
    err = _build.get_lib("plif").plif_fwd(
        x_tb.data_ptr(), out.data_ptr(), a.data_ptr(), x_tb.numel() // T, T,
        float(thresh), int(spike_ge(kind)), _DTYPE_CODE[x_tb.dtype],
        *(p.data_ptr() for p in bn), C, HW, _build.stream_ptr(x_tb.device),
    )
    _build.check(err, "plif_fwd")
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
    x.dtype)`` with an f32 membrane, in x's dtype."""
    ge = spike_ge(kind)
    xs = _steps(bn_eval(x, mean, mul, bias, x.dtype), T).float()
    a = a.float()
    v = torch.zeros_like(xs[0])
    outs = []
    for t in range(T):
        v = v * a + xs[t]
        d = v - thresh
        s = (d >= 0 if ge else d > 0).float()
        outs.append(s.to(x.dtype))
        v = v - thresh * s
    return torch.stack(outs).reshape(x.shape)


def plif_train_backward_plain(x, g, a, mean, mul, bias, T: int,
                              thresh: float = 1.0, kind: str = "atan",
                              alpha: float = 2.0):
    """Plain train backward: (dx, da (1,), dm, ds, db), the sums in f32."""
    ge = spike_ge(kind)
    shp = (1, -1, 1, 1)
    m, s, b = (p.float().reshape(shp) for p in (mean, mul, bias))
    a = a.float()
    xs, gs = _steps(x, T), _steps(g, T)
    v = torch.zeros(xs.shape[1:], dtype=torch.float32, device=x.device)
    xms, d_pre, v_prev = [], [], []
    for t in range(T):
        v_prev.append(v)
        xm = xs[t].float() - m
        xms.append(xm)
        v = v * a + (xm * s + b).to(x.dtype).float()
        d = v - thresh
        d_pre.append(d)
        v = v - thresh * (d >= 0 if ge else d > 0).float()
    dx = torch.empty_like(xs)
    da = torch.zeros(1, dtype=torch.float32, device=x.device)
    ds = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    db = torch.zeros_like(ds)
    g_after = torch.zeros_like(v)
    for t in range(T - 1, -1, -1):
        fp = surrogate_deriv(kind, alpha, d_pre[t])
        g_pre = g_after + (gs[t].float() - thresh * g_after) * fp
        dx[t] = (g_pre * s).to(x.dtype)
        ds += (g_pre * xms[t]).sum((0, 2, 3))
        db += g_pre.sum((0, 2, 3))
        da += (g_pre * v_prev[t]).sum()
        g_after = g_pre * a
    return dx.reshape(x.shape), da, -(mul.float() * db), ds, db


def _train_operands(x, a, bn, what: str):
    """Check the kernel's layout; the f32 (1,) a and (C,) terms on x's
    device, contiguous."""
    _build.require_cuda(x, what)
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: unsupported dtype {x.dtype}")
    vec = 16 // x.element_size()
    HW = x.shape[2] * x.shape[3]
    if HW % vec or x.data_ptr() % 16:
        raise ValueError(f"{what}: H*W={HW} must be a multiple of {vec} and "
                         "x 16-byte aligned for the kernel's vector loads")
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
    a, bn = _train_operands(x, a, (mean, mul, bias), "plif_train_forward")
    out = torch.empty_like(x)
    C, HW = x.shape[1], x.shape[2] * x.shape[3]
    err = _build.get_lib("plif").plif_train_fwd(
        x.data_ptr(), out.data_ptr(), a.data_ptr(), x.numel() // T, T,
        float(thresh), int(spike_ge(kind)), _DTYPE_CODE[x.dtype],
        *(p.data_ptr() for p in bn), C, HW, _build.stream_ptr(x.device),
    )
    _build.check(err, "plif_train_fwd")
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


def plif_train_backward(x, g, a, mean, mul, bias, T: int,
                        thresh: float = 1.0, kind: str = "atan",
                        alpha: float = 2.0):
    """Train backward: (dx in x's dtype, da (1,), dm, ds, db f32 (C,)).
    Launches ``plif_train_bwd`` (three passes, deterministic sums) on a
    CUDA tensor, runs the plain version on a CPU one."""
    if x.device.type == "cpu":
        return plif_train_backward_plain(x, g, a, mean, mul, bias, T, thresh,
                                         kind, alpha)
    a, bn = _train_operands(x, a, (mean, mul, bias), "plif_train_backward")
    g = g.to(x.dtype).contiguous()
    if g.shape != x.shape or g.data_ptr() % 16:
        raise ValueError("plif_train_backward: the cotangent must be a "
                         "16-byte aligned tensor of x's shape")
    if not 1 <= T <= 8:
        raise ValueError(f"plif_train_backward: the kernel takes T in 1..8, "
                         f"got {T}")
    B, C = x.shape[0] // T, x.shape[1]
    HW = x.shape[2] * x.shape[3]
    vec = 16 // x.element_size()
    # ~4 vectors a thread, 256 threads a block: nb blocks a channel
    nb = max(1, -(-B * HW // vec // 1024))
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    partials = torch.empty(3 * C * nb, **f32)
    da_c = torch.empty(C, **f32)
    da = torch.empty(1, **f32)
    ds, db, dm = (torch.empty(C, **f32) for _ in range(3))
    p0, p1 = _surrogate_constants(kind, alpha)
    err = _build.get_lib("plif_bwd").plif_train_bwd(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), a.data_ptr(),
        *(p.data_ptr() for p in bn), partials.data_ptr(), da_c.data_ptr(),
        da.data_ptr(), ds.data_ptr(), db.data_ptr(), dm.data_ptr(), T, B, C,
        HW, nb, float(thresh), int(spike_ge(kind)), _KIND_CODE[kind],
        float(p0), float(p1), _DTYPE_CODE[x.dtype], _build.stream_ptr(dev),
    )
    _build.check(err, "plif_train_bwd")
    plif_train_backward.launches += 1
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
            f"spike_fn '{kind}' has no train PLIF op (patan/ASGL training "
            "is not ported yet: ROADMAP.md, modules to port: 'Remaining "
            "model surface')")
    if x.dim() != 4 or x.shape[0] % T:
        raise ValueError(f"plif_train: expected (T*B, C, H, W) with T={T}, "
                         f"got {tuple(x.shape)}")
    if a.numel() != 1 or any(p.shape != (x.shape[1],)
                             for p in (mean, mul, bias)):
        raise ValueError("plif_train: a must hold one value and mean, mul, "
                         "bias be (C,)")
    return _PLIFTrain.apply(x, a, mean, mul, bias, T, float(thresh), kind,
                            train_alpha(kind, alpha))
