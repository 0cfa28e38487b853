"""PLIF forward over T time steps folded in the batch axis, int8 spikes out
(counterpart of ``eas_snn_tpu/ops/plif_pallas.py``, eval forward).

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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .surrogate import spike_ge

__all__ = ["plif_forward", "plif_forward_plain", "decay_multiplier",
           "bn_eval"]

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
