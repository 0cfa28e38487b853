"""YOLOX building blocks with spiking sites (counterpart of
``eas_snn_tpu/models/blocks.py``), NCHW, eval and train.

Spiking or analog is a constructor flag. A spiking block sees (T*B, C, H,
W) tensors, t-major, and its activation is a PLIF neuron over T steps:
int8 spikes out at eval, spikes in the compute dtype in training (they
carry the surrogate gradient). Parameter names follow the reference
PyTorch model after spikingjelly's conversion: a spiking ``BaseConv``
holds its conv as ``conv.0`` (the SeqToANNContainer) and its neuron's
decay logit as ``act.w``; an analog one holds ``conv`` directly. Each
module branches on ``self.training``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv_plif import (
    conv1x1_plif, conv3x3_plif, conv3x3s2_plif, fold_bn, fold_conv1x1,
    fold_conv3x3,
)
from ..ops.conv_plif_policy import should_fuse
from ..ops.lif import PLIF_W_INIT
from ..ops.plif import bn_eval, decay_multiplier, plif_forward, plif_train

__all__ = [
    "Neuron", "BatchNorm", "PLIF", "BaseConv", "Bottleneck", "SPPBottleneck",
    "CSPLayer", "Focus", "spp_pools", "upsample2x",
]

Pieces = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


class Neuron(NamedTuple):
    """How a block's activations behave. ``fuse`` is the conv+BN+PLIF
    policy mode (ops/conv_plif_policy.py) for its spiking sites."""

    spiking: bool = False
    T: int = 1
    spike_fn: str = "atan"
    thresh: float = 1.0
    fuse: str = "auto"


# flax's momentum: running <- 0.97 * running + 0.03 * batch statistic
_FLAX_MOMENTUM = 0.97


class _KeptConstant:
    """Mixin for a module that keeps one value derived from its tensors
    between eval calls (:meth:`_kept`). The value is keyed on each
    source's storage address and version counter: every in-place write
    bumps the counter (optimizer steps, an EMA's ``copy_``,
    ``load_state_dict``). ``train()`` and a module's move (``_apply``: a
    moved tensor may land on storage the move freed) drop it."""

    _kept_value = None  # (key, value)

    def _kept(self, srcs: Tuple[torch.Tensor, ...], make):
        key = tuple((t.data_ptr(), t._version) for t in srcs)
        if self._kept_value is None or self._kept_value[0] != key:
            with torch.no_grad():
                self._kept_value = (key, make())
        return self._kept_value[1]

    def train(self, mode: bool = True):
        self._kept_value = None
        return super().train(mode)

    def _apply(self, *args, **kwargs):
        self._kept_value = None
        return super()._apply(*args, **kwargs)


class _BatchStats(torch.autograd.Function):
    """Per-channel mean and biased variance of an NCHW x in f32, flax's fast
    variance: var = max(0, E[x^2] - E[x]^2). The backward recomputes from
    x, which is saved in its own dtype (an f32 copy of every conv output
    would cost ~5 GB at the flagship's B=64)."""

    @staticmethod
    def forward(ctx, x):
        xf = x.float()
        mean = xf.mean((0, 2, 3))
        z = (xf * xf).mean((0, 2, 3)) - mean * mean
        ctx.save_for_backward(x, mean, z)
        return mean, torch.clamp_min(z, 0.0)

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x, mean, z = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        # d max(0, z) / dz: 1 above 0, 1/2 at 0 (JAX's tie rule), 0 below
        g_z = g_var * ((z > 0).float() + 0.5 * (z == 0).float())
        g_m = g_mean - 2.0 * mean * g_z
        shp = (1, -1, 1, 1)
        dx = (g_m / n).reshape(shp) + (2.0 * g_z / n).reshape(shp) * x.float()
        return dx.to(x.dtype)


class BatchNorm(_KeptConstant, nn.BatchNorm2d):
    """BatchNorm with the JAX package's arithmetic (``BatchNormFusable``):
    mul = rsqrt(var + eps) * scale, y = (x - mean) * mul + bias in f32,
    cast to the compute dtype. At eval mean and var are the running
    statistics; in training they are the batch's (f32, biased fast
    variance) and the running ones move as 0.97 * running + 0.03 * batch
    (the biased variance, where ``nn.BatchNorm2d`` would store the
    unbiased one). eps 1e-3, momentum 0.03 (the reference's init_yolo);
    the buffers keep torch's names, so checkpoints load by key."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-3, momentum=0.03)

    def eval_terms(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(mean, mul, bias) of y = (x - mean) * mul + bias, f32 and
        contiguous. Kept between calls, and computed again when the running
        statistics, the weight or the bias change, or on ``train()``;
        computed afresh (differentiable) where autograd wants the
        gradient of the weight or bias."""
        if torch.is_grad_enabled() and (self.weight.requires_grad
                                        or self.bias.requires_grad):
            return self._eval_terms()
        return self._kept((self.running_mean, self.running_var, self.weight,
                           self.bias), self._eval_terms)

    def _eval_terms(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return tuple(p.to(torch.float32).contiguous()
                     for p in (self.running_mean, mul, self.bias))

    def terms(self, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(mean, mul, bias) for the NCHW ``x``: the running statistics' at
        eval; in training the batch statistics' (differentiable), and the
        running statistics are updated."""
        if not self.training:
            return self.eval_terms()
        mean, var = _BatchStats.apply(x)
        with torch.no_grad():
            m = _FLAX_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
            self.num_batches_tracked += 1
        return mean, torch.rsqrt(var + self.eps) * self.weight, self.bias

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        return bn_eval(x, *self.terms(x), out_dtype)

    def fold(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mul, bias_f) such that this BN (at eval) is x * mul + bias_f."""
        return fold_bn(self.weight, self.bias, self.running_mean,
                       self.running_var, self.eps)


class PLIF(_KeptConstant, nn.Module):
    """Parametric LIF over T steps folded in the batch axis; one learnable
    scalar decay logit ``w`` (spikingjelly ParametricLIFNode). At eval the
    spikes are int8 (patan runs atan's hard forward); in training they are
    in x's dtype, with the surrogate gradient of ``spike_fn`` (alpha 2,
    the JAX package's default; rect 1)."""

    def __init__(self, T: int, spike_fn: str = "atan", thresh: float = 1.0):
        super().__init__()
        self.T, self.thresh = T, thresh
        self.spike_fn = spike_fn
        self.kind = "atan" if spike_fn == "patan" else spike_fn
        self.w = nn.Parameter(torch.tensor(PLIF_W_INIT))

    def decay(self) -> torch.Tensor:
        """The eval decay multiplier ``decay_multiplier(w)``, (1,) f32:
        kept between calls, and computed again when w changes or on
        ``train()``."""
        return self._kept((self.w,), lambda: decay_multiplier(self.w))

    def forward(self, x: torch.Tensor, bn=None) -> torch.Tensor:
        """Spikes of x, or of ``bn_eval(x, *bn, x.dtype)`` with ``bn``
        (mean, mul, bias)."""
        if not self.training:
            return plif_forward(x, self.T, self.w, self.thresh, self.kind,
                                bn=bn, a=self.decay())
        if bn is None:
            C = x.shape[1]
            bn = tuple(torch.full((C,), v, device=x.device)
                       for v in (0.0, 1.0, 0.0))
        a = 1.0 - torch.sigmoid(self.w.float())
        return plif_train(x, self.T, a, *bn, self.thresh, self.spike_fn)


_ACTS = {"silu": nn.SiLU, "relu": nn.ReLU,
         "lrelu": lambda: nn.LeakyReLU(0.1), "idnt": nn.Identity}


def _analog_act(name: str) -> nn.Module:
    if name not in _ACTS:
        raise AttributeError(f"Unsupported act type: {name}")
    return _ACTS[name]()


class BaseConv(nn.Module):
    """Conv -> BN -> activation (reference network_blocks.py:31-56).

    At eval a spiking 1x1 or 3x3 site that the policy picks runs as one
    whole-site conv+BN+PLIF kernel on BN-folded weights; every other site,
    and every site in training, runs conv (in the compute dtype) -> BN ->
    activation, where a spiking site's BN runs inside the PLIF kernel (its
    batch statistics' terms in training). The input may be a tuple of
    tensors: a channel concat, materialized only on the unfused path.
    """

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, act: str = "silu",
                 neuron: Neuron = Neuron(), dtype=torch.float32):
        super().__init__()
        self.ksize, self.stride, self.neuron, self.dtype = (
            ksize, stride, neuron, dtype)
        conv = nn.Conv2d(in_channels, out_channels, ksize, stride,
                         padding=(ksize - 1) // 2, bias=False)
        self.conv = nn.Sequential(conv) if neuron.spiking else conv
        self.bn = BatchNorm(out_channels)
        self.act = (PLIF(neuron.T, neuron.spike_fn, neuron.thresh)
                    if neuron.spiking else _analog_act(act))

    @property
    def weight(self) -> torch.Tensor:
        return self.conv[0].weight if self.neuron.spiking else self.conv.weight

    def fused(self, pieces: Sequence[torch.Tensor]) -> bool:
        """Does this site run as a whole-site conv+BN+PLIF kernel? Never in
        training."""
        n = self.neuron
        if not n.spiking or self.training:
            return False
        if (self.ksize, self.stride) not in ((1, 1), (3, 1), (3, 2)):
            return False
        if len(pieces) > 1 and self.ksize != 1:
            return False
        H, W = pieces[0].shape[-2:]
        return should_fuse(self.ksize, self.stride, H, W,
                           [p.shape[1] for p in pieces],
                           self.weight.shape[0], n.fuse)

    def forward(self, x: Pieces) -> torch.Tensor:
        pieces = tuple(x) if isinstance(x, (tuple, list)) else (x,)
        if self.fused(pieces):
            mul, bias_f = self.bn.fold()
            n, w = self.neuron, self.act.w
            kind = self.act.kind
            if self.ksize == 1:
                return conv1x1_plif(pieces, fold_conv1x1(self.weight, mul),
                                    bias_f, n.T, w, n.thresh, kind)
            op = conv3x3_plif if self.stride == 1 else conv3x3s2_plif
            return op(pieces[0], fold_conv3x3(self.weight, mul), bias_f, n.T,
                      w, n.thresh, kind)
        x = torch.cat([p.to(self.dtype) for p in pieces], 1) \
            if len(pieces) > 1 else pieces[0].to(self.dtype)
        y = F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                     padding=(self.ksize - 1) // 2)
        if self.neuron.spiking:
            return self.act(y, bn=self.bn.terms(y))
        return self.act(self.bn(y, self.dtype))


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 conv, additive shortcut (reference
    network_blocks.py:81-104). Spiking: spikes + spikes."""

    def __init__(self, in_channels: int, out_channels: int,
                 shortcut: bool = True, expansion: float = 0.5,
                 act: str = "silu", neuron: Neuron = Neuron(),
                 dtype=torch.float32):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act, neuron, dtype)
        self.conv2 = BaseConv(hidden, out_channels, 3, 1, act, neuron, dtype)
        self.use_add = shortcut and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


def _max_pool_sep(x: torch.Tensor, k: int) -> torch.Tensor:
    """Stride-1 same-padded k x k max pool as two 1-D pools, rows then
    columns: the values of the 2-D pool, and the JAX package's routing of
    the gradient among tied maxima (each 1-D window sends it to its first
    maximum)."""
    x = F.max_pool2d(x, (k, 1), stride=1, padding=(k // 2, 0))
    return F.max_pool2d(x, (1, k), stride=1, padding=(0, k // 2))


def spp_pools(x: torch.Tensor, kernel_sizes: Sequence[int]) -> list:
    """The SPP pyramid's stride-1 same-padded max pools, as the JAX
    package's chain of separable pools: pool_{k+d-1}(x) == pool_d(pool_k(x)),
    so 9 rides on 5 and 13 on 9. Values equal the direct pools; on spike
    tensors ties are everywhere, and the gradient follows the JAX chain's
    tie routing. Spikes pool in f32 (exact) and come back in their own
    dtype."""
    y = x if x.is_floating_point() else x.float()
    pools, prev_k, src = [], 0, y
    for k in kernel_sizes:
        d = k - prev_k + 1 if prev_k else k
        if d < 1 or d % 2 == 0:  # not composable: pool directly
            src, d = y, k
        src = _max_pool_sep(src, d)
        pools.append(src.to(x.dtype))
        prev_k = k
    return pools


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling (reference network_blocks.py:125-147)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Tuple[int, ...] = (5, 9, 13),
                 act: str = "silu", neuron: Neuron = Neuron(),
                 dtype=torch.float32):
        super().__init__()
        hidden = in_channels // 2
        self.kernel_sizes = kernel_sizes
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act, neuron, dtype)
        self.conv2 = BaseConv(hidden * (len(kernel_sizes) + 1), out_channels,
                              1, 1, act, neuron, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        return self.conv2((x, *spp_pools(x, self.kernel_sizes)))


class CSPLayer(nn.Module):
    """C3 cross-stage partial block (reference network_blocks.py:150-188).
    Takes a tensor or a tuple of tensors (a channel concat)."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 act: str = "silu", neuron: Neuron = Neuron(),
                 dtype=torch.float32):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act, neuron, dtype)
        self.conv2 = BaseConv(in_channels, hidden, 1, 1, act, neuron, dtype)
        self.conv3 = BaseConv(2 * hidden, out_channels, 1, 1, act, neuron,
                              dtype)
        self.m = nn.Sequential(*[
            Bottleneck(hidden, hidden, shortcut, 1.0, act, neuron, dtype)
            for _ in range(n)
        ])

    def forward(self, x: Pieces) -> torch.Tensor:
        x1 = self.m(self.conv1(x))
        return self.conv3((x1, self.conv2(x)))


class Focus(nn.Module):
    """Space-to-depth stem, channel order TL, BL, TR, BR (reference
    network_blocks.py:191-213)."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int = 1,
                 stride: int = 1, act: str = "silu",
                 neuron: Neuron = Neuron(), dtype=torch.float32):
        super().__init__()
        self.conv = BaseConv(4 * in_channels, out_channels, ksize, stride,
                             act, neuron, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tl = x[..., ::2, ::2]
        tr = x[..., ::2, 1::2]
        bl = x[..., 1::2, ::2]
        br = x[..., 1::2, 1::2]
        return self.conv(torch.cat([tl, bl, tr, br], 1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample of (N, C, H, W)."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
