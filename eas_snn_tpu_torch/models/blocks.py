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

import contextlib
import warnings
from typing import NamedTuple, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint
from torch.utils.weak import WeakTensorKeyDictionary

from .. import parallel
from ..parallel.mesh import (active_spatial, batch_group, channel_slice,
                             gather_c, gather_rows, over_rows,
                             spatial_context, tp_mesh)
from ..ops.conv_plif import (
    conv1x1_plif, conv3x3_plif, conv3x3s2_plif, fold_bn, fold_conv1x1,
    fold_conv3x3, layout_refusal,
)
from ..ops.conv_plif_policy import should_fuse
from ..ops.lif import PLIF_W_INIT, plif_scan
from ..ops.plif import (acc_dtype, bn_eval, decay_multiplier, plif_forward,
                        plif_train)
from ..ops.surrogate import asgl_spike

__all__ = [
    "Neuron", "BatchNorm", "PLIF", "BaseConv", "DWConv", "Bottleneck",
    "SPPBottleneck",
    "CSPLayer", "Focus", "spp_pools", "upsample2x", "remat",
    "frozen_bn_stats", "int8_saved_spikes", "is_spike_train",
]

Pieces = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


class Neuron(NamedTuple):
    """How a block's activations behave. ``fuse`` is the conv+BN+PLIF
    policy mode (ops/conv_plif_policy.py) for its spiking sites; ``alpha``
    the surrogate gradient's width in training (JAX ``NeuronCfg.alpha``);
    ``asgl_p`` and ``alpha_granularity`` concern patan only: the ASGL
    mixing probability and the shape of its learnable alpha ('layer',
    'channel' or 'neuron')."""

    spiking: bool = False
    T: int = 1
    spike_fn: str = "atan"
    thresh: float = 1.0
    fuse: str = "auto"
    alpha: float = 2.0
    asgl_p: float = 0.0
    alpha_granularity: str = "layer"


# flax's momentum: running <- 0.97 * running + 0.03 * batch statistic
_FLAX_MOMENTUM = 0.97


class _KeptConstant:
    """Mixin for a module that keeps one value derived from its tensors
    between eval calls (:meth:`_kept`). The value is keyed on each
    source's storage address and version counter: every in-place write
    bumps the counter (optimizer steps, an EMA's ``copy_``,
    ``load_state_dict``). ``train()`` and a module's move (``_apply``: a
    moved tensor may land on storage the move freed) drop it. Under
    ``torch.export`` (whose fake tensors have neither address nor
    version) the value is computed in the traced graph, by the same
    operations, so the exported program computes it from its weights."""

    _kept_value = None  # (key, value)

    def _kept(self, srcs: Tuple[torch.Tensor, ...], make):
        if torch.compiler.is_exporting():
            return make()
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
    """Per-channel mean and biased variance of an NCHW x in f32 (f64 for an
    f64 x), flax's fast variance: var = max(0, E[x^2] - E[x]^2). The
    backward recomputes from x, which is saved in its own dtype (an f32
    copy of every conv output would cost ~5 GB at the flagship's B=64).

    With a process group (``parallel``) the statistics are the global
    batch's, as under the JAX package's data-parallel jit: each process
    weights its E[x] and E[x^2] by its share of the global batch and one
    all-reduce a site sums them; the backward sums the statistics'
    gradients over the group the same way before it forms dx with the
    global count. The share of a group of one is 1.0, so such a group
    gives the bits of no group. Under a 2-D mesh the sums go over the
    data group only: the model group's processes hold the same samples,
    and a channel-sharded site's statistics are those of its own
    channels. On row shards (a spatial sharding active when the forward
    runs) they go over the whole mesh: each process holds H / tp rows of
    B / dp samples, so its share is 1 / (dp x tp) (``mesh.batch_group``).
    The forward's group is kept for the backward, which may run outside
    the sharding's context."""

    @staticmethod
    def forward(ctx, x):
        xf = x.to(acc_dtype(x.dtype))
        mean = xf.mean((0, 2, 3))
        msq = (xf * xf).mean((0, 2, 3))
        ctx.group, ctx.procs = None, 1
        if parallel.is_initialized():
            # every process steps on as many samples (the JAX mesh shards
            # the batch evenly, and H over the model axis): its share is
            # 1 / the group's size
            ctx.group, ctx.procs = batch_group()
            both = torch.cat([mean, msq]) * (1.0 / ctx.procs)
            mean, msq = parallel.all_reduce_sum_(both, ctx.group).chunk(2)
        z = msq - mean * mean
        ctx.save_for_backward(x, mean, z)
        return mean, torch.clamp_min(z, 0.0)

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x, mean, z = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        if parallel.is_initialized():
            both = parallel.all_reduce_sum_(torch.cat([g_mean, g_var]),
                                            ctx.group)
            g_mean, g_var = both.chunk(2)
            n = n * ctx.procs
        # d max(0, z) / dz: 1 above 0, 1/2 at 0 (JAX's tie rule), 0 below
        g_z = g_var * ((z > 0).float() + 0.5 * (z == 0).float())
        g_m = g_mean - 2.0 * mean * g_z
        shp = (1, -1, 1, 1)
        dx = (g_m / n).reshape(shp) + (2.0 * g_z / n).reshape(shp) * \
            x.to(mean.dtype)
        return dx.to(x.dtype)


# True while no BN running statistic may move: a block's recompute under
# ``remat``, or a forward under ``frozen_bn_stats``
_RECOMPUTING = [False]


@contextlib.contextmanager
def frozen_bn_stats():
    """A train-mode forward under this context moves no BN running
    statistic (``BatchNorm.terms``): ``remat``'s recompute, and a forward
    whose ``batch_stats`` the JAX package would discard."""
    prev, _RECOMPUTING[0] = _RECOMPUTING[0], True
    try:
        yield
    finally:
        _RECOMPUTING[0] = prev


@contextlib.contextmanager
def _recompute(sp):
    with frozen_bn_stats(), spatial_context(sp):
        yield


def _contexts():
    # the recompute sees the spatial sharding of the forward, wherever the
    # backward runs (the halos, the gathered SPP map and head levels)
    return contextlib.nullcontext(), _recompute(active_spatial())


def remat(module: nn.Module, *xs: torch.Tensor) -> torch.Tensor:
    """``module(x)`` (``module(xs)`` for a channel concat's pieces) with
    its inner activations recomputed in the backward instead of kept: the
    JAX package's block-granular ``nn.remat`` (``models/darknet.py:
    29-46``). Only the inputs are saved. The recompute runs the block's
    forward again (its PLIF kernels too) but moves no BN running
    statistic (``BatchNorm.terms``), as ``nn.remat`` drops the
    recomputed mutation. No RNG state is stashed: a block of a train step
    draws no random numbers (patan at ``asgl_p > 0`` is the one that
    would, and its model is refused by ``CapturedStep``), and stashing
    would read the card's RNG state, which a CUDA graph capture refuses.
    On row shards the recompute runs under the forward's spatial
    sharding. Outside training, or without autograd, the module runs as
    it is."""
    if not (module.training and torch.is_grad_enabled()):
        return module(xs if len(xs) > 1 else xs[0])
    return checkpoint(_call, module, *xs, use_reentrant=False,
                      preserve_rng_state=False, context_fn=_contexts)


def _call(module: nn.Module, *xs: torch.Tensor) -> torch.Tensor:
    return module(xs if len(xs) > 1 else xs[0])


# The spike trains of the train forward: PLIF outputs and channel concats
# of them, by identity. Their values are exactly 0 and 1.
_SPIKE_TRAINS = WeakTensorKeyDictionary()


def _mark_spikes(t: torch.Tensor) -> torch.Tensor:
    _SPIKE_TRAINS[t] = True
    return t


def is_spike_train(t: torch.Tensor) -> bool:
    """Whether ``t`` is a spike train of a train forward: the output of a
    spiking site, or a channel concat of such outputs."""
    return t in _SPIKE_TRAINS


class int8_saved_spikes(torch.autograd.graph.saved_tensors_hooks):
    """Within it, every spike train that autograd saves for the backward
    (a conv's input, for its weight gradient; a block's input under
    ``remat``) is held as int8 and turned back into its dtype when the
    backward reads it: the JAX package's ``'view'`` train store
    (``ops/plif_pallas.py:314-329``). Bit-lossless, since spikes are 0/1.
    Only tensors known to be spike trains (``is_spike_train``) are packed,
    and each once however many ops save it: ``saves`` counts the saves
    held as int8, ``trains`` the distinct spike trains."""

    def __init__(self):
        self.packed = WeakTensorKeyDictionary()
        self.saves = self.trains = 0
        super().__init__(self._pack, self._unpack)

    def _pack(self, t: torch.Tensor):
        if t.dtype == torch.int8 or not is_spike_train(t):
            return t
        self.saves += 1
        if t not in self.packed:
            self.trains += 1
            self.packed[t] = (t.to(torch.int8), t.dtype)
        return self.packed[t]

    @staticmethod
    def _unpack(p):
        return p[0].to(p[1]) if isinstance(p, tuple) else p


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
        running statistics are updated (not by a ``remat`` recompute).
        With a process group the batch statistics are the global
        batch's (``_BatchStats``)."""
        if not self.training:
            return self.eval_terms()
        mean, var = _BatchStats.apply(x)
        if not _RECOMPUTING[0]:  # a remat recompute moves nothing
            with torch.no_grad():
                m = _FLAX_MOMENTUM
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
                self.num_batches_tracked += 1
        return mean, torch.rsqrt(var + self.eps) * self.weight, self.bias

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        mesh = tp_mesh(self)
        if mesh is not None:  # channel-sharded: this process's channels
            # of the whole x (a BN of its own; BaseConv uses ``terms``)
            x = channel_slice(x, mesh, self.weight.shape[0])
            return gather_c(bn_eval(x, *self.terms(x), out_dtype), mesh)
        return bn_eval(x, *self.terms(x), out_dtype)

    def fold(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mul, bias_f) such that this BN (at eval) is x * mul + bias_f."""
        return fold_bn(self.weight, self.bias, self.running_mean,
                       self.running_var, self.eps)


class PLIF(_KeptConstant, nn.Module):
    """Parametric LIF over T steps folded in the batch axis; one learnable
    scalar decay logit ``w`` (spikingjelly ParametricLIFNode). At eval the
    spikes are int8 (patan runs atan's hard forward); in training they are
    in x's dtype, with the surrogate gradient of ``spike_fn`` at ``alpha``
    (rect pinned to 1, as in the JAX package).

    patan (ASGL) trains as the JAX package trains it, through the plain
    scan (``ops/lif.py:plif_scan``) with ``asgl_spike`` and a learnable
    ``asgl_alpha`` of shape (1,), (C,) or (C, H, W) for the granularity
    'layer', 'channel' or 'neuron' (JAX ``PLIF.alpha``; reference
    activation.py:73-83, 181-205): no kernel of either package serves it.
    A 'neuron' alpha takes its (C, H, W) from the input size when the
    model is built (``EASYOLOX.materialize_alpha``, a train forward on the
    meta device, as the JAX package's init on an example input). At
    ``asgl_p > 0`` the mask is drawn from the device's default
    generator."""

    GRANULARITIES = ("layer", "channel", "neuron")

    def __init__(self, T: int, spike_fn: str = "atan", thresh: float = 1.0,
                 alpha: float = 2.0, asgl_p: float = 0.0,
                 alpha_granularity: str = "layer", channels: int = 1):
        super().__init__()
        self.T, self.thresh, self.alpha = T, thresh, alpha
        self.spike_fn = spike_fn
        self.kind = "atan" if spike_fn == "patan" else spike_fn
        self.w = nn.Parameter(torch.tensor(PLIF_W_INIT))
        self.asgl_p, self.alpha_granularity = asgl_p, alpha_granularity
        if spike_fn == "patan":
            if alpha_granularity not in self.GRANULARITIES:
                raise NotImplementedError(
                    f"granularity '{alpha_granularity}'")
            if alpha_granularity != "neuron":
                shape = (1,) if alpha_granularity == "layer" else (channels,)
                self.asgl_alpha = nn.Parameter(torch.full(shape, alpha))

    def materialize_alpha(self, shape) -> None:
        """Create the 'neuron' granularity's alpha at ``shape`` (C, H, W),
        filled with ``alpha``, on w's device."""
        self.asgl_alpha = nn.Parameter(torch.full(
            tuple(shape), float(self.alpha), device=self.w.device))

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
        if self.spike_fn == "patan":
            if not hasattr(self, "asgl_alpha"):
                if not x.is_meta:
                    raise RuntimeError(
                        "PLIF: the 'neuron' patan alpha is created when the "
                        "model is built (EASYOLOX.materialize_alpha); "
                        "this site has none")
                self.materialize_alpha(x.shape[1:])
            return _mark_spikes(self._asgl_scan(x, bn))
        if bn is None:
            C = x.shape[1]
            bn = tuple(torch.full((C,), v, device=x.device)
                       for v in (0.0, 1.0, 0.0))
        a = 1.0 - torch.sigmoid(self.w.to(acc_dtype(x.dtype)))
        return _mark_spikes(plif_train(x, self.T, a, *bn, self.thresh,
                                       self.spike_fn, self.alpha))

    def _asgl_scan(self, x: torch.Tensor, bn) -> torch.Tensor:
        """Training with patan: the BN normalize as the unfused path does
        it, then the differentiable scan with ``asgl_spike`` (JAX
        ``eas_snn_tpu/models/blocks.py:193-222``)."""
        if bn is not None:
            x = bn_eval(x, *bn, x.dtype)
        alpha = self.asgl_alpha.to(x.dtype)
        if self.alpha_granularity == "channel":
            alpha = alpha.reshape(-1, 1, 1)

        def spike(v: torch.Tensor) -> torch.Tensor:
            return asgl_spike(v, alpha, p=self.asgl_p)

        xs = x.reshape((self.T, -1) + tuple(x.shape[1:]))
        spikes, _ = plif_scan(xs, self.w.to(x.dtype), spike, self.thresh)
        return spikes.reshape(x.shape)


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
    ``groups`` splits the conv's channels as ``nn.Conv2d``'s (the depthwise
    half of :class:`DWConv`); a grouped site is never fused.
    """

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, act: str = "silu",
                 neuron: Neuron = Neuron(), dtype=torch.float32,
                 groups: int = 1):
        super().__init__()
        self.ksize, self.stride, self.neuron, self.dtype = (
            ksize, stride, neuron, dtype)
        self.groups = groups
        conv = nn.Conv2d(in_channels, out_channels, ksize, stride,
                         padding=(ksize - 1) // 2, groups=groups, bias=False)
        self.conv = nn.Sequential(conv) if neuron.spiking else conv
        self.bn = BatchNorm(out_channels)
        self.act = (PLIF(neuron.T, neuron.spike_fn, neuron.thresh,
                         neuron.alpha, neuron.asgl_p,
                         neuron.alpha_granularity, out_channels)
                    if neuron.spiking else _analog_act(act))

    @property
    def weight(self) -> torch.Tensor:
        return self.conv[0].weight if self.neuron.spiking else self.conv.weight

    @property
    def mesh(self):
        """The mesh this site's output channels are sharded over, or
        None."""
        return tp_mesh(self.conv[0] if self.neuron.spiking else self.conv)

    def fused(self, pieces: Sequence[torch.Tensor]) -> bool:
        """Does this site run as a whole-site conv+BN+PLIF kernel? Never in
        training. Asked of the global site: the whole Cout of a
        channel-sharded site, the whole H of a row shard."""
        n = self.neuron
        if not n.spiking or self.training or self.groups != 1:
            return False
        if (self.ksize, self.stride) not in ((1, 1), (3, 1), (3, 2)):
            return False
        if len(pieces) > 1 and self.ksize != 1:
            return False
        H, W = pieces[0].shape[-2:]
        sp, tp = active_spatial(), self.mesh
        return should_fuse(self.ksize, self.stride,
                           H * (sp.tp if sp is not None else 1), W,
                           [p.shape[1] for p in pieces],
                           self.weight.shape[0] * (tp.tp if tp else 1), n.fuse)

    def forward(self, x: Pieces) -> torch.Tensor:
        pieces = tuple(x) if isinstance(x, (tuple, list)) else (x,)
        mesh = self.mesh
        groups = self.groups
        if mesh is not None and groups != 1:
            # depthwise: this process's output channels read its input
            # channels
            if groups != pieces[0].shape[1] or len(pieces) > 1:
                raise NotImplementedError("a channel-sharded grouped conv "
                                          "other than a depthwise one")
            n = self.weight.shape[0]
            pieces, groups = (channel_slice(pieces[0], mesh, n),), n
        y = self._site(pieces, groups)
        if mesh is None:
            return y
        out = gather_c(y, mesh)
        return _mark_spikes(out) if is_spike_train(y) else out

    def _site(self, pieces: Tuple[torch.Tensor, ...],
              groups: int) -> torch.Tensor:
        k, stride = self.ksize, self.stride
        if self.fused(pieces):
            mul, bias_f = self.bn.fold()
            n, w = self.neuron, self.act.w
            kind = self.act.kind
            if k == 1:
                w1 = fold_conv1x1(self.weight, mul)
                sp = active_spatial()
                why = layout_refusal(pieces, 1) if sp is not None else None
                if why is not None:
                    # the kernel refuses the row shard: the site runs on
                    # the gathered map and keeps its rows
                    warnings.warn(f"{why}; this row shard's site gathers "
                                  "its rows and runs the kernel on the "
                                  "whole map")
                    rows = pieces[0].shape[-2]
                    whole = tuple(gather_rows(p, sp) for p in pieces)
                    return conv1x1_plif(whole, w1, bias_f, n.T, w, n.thresh,
                                        kind).narrow(
                        -2, sp.model_index * rows, rows).contiguous()
                return conv1x1_plif(pieces, w1, bias_f, n.T, w, n.thresh,
                                    kind)
            op = conv3x3_plif if stride == 1 else conv3x3s2_plif
            w3 = fold_conv3x3(self.weight, mul)
            return over_rows(pieces[0], lambda t: op(
                t, w3, bias_f, n.T, w, n.thresh, kind), k, stride)
        x = torch.cat([p.to(self.dtype) for p in pieces], 1) \
            if len(pieces) > 1 else pieces[0].to(self.dtype)
        if len(pieces) > 1 and all(map(is_spike_train, pieces)):
            _mark_spikes(x)
        wt = self.weight.to(self.dtype)
        spikes = is_spike_train(x)
        # a row shard's halo-grown spikes are spikes too (the int8 store)
        y = over_rows(x, lambda t: F.conv2d(
            _mark_spikes(t) if spikes else t, wt, stride=stride,
            padding=(k - 1) // 2, groups=groups), k, stride)
        if self.neuron.spiking:
            return self.act(y, bn=self.bn.terms(y))
        # the BN of y's channels (a slice of a channel-sharded site's)
        return self.act(bn_eval(y, *self.bn.terms(y), self.dtype))


class DWConv(nn.Module):
    """A depthwise k x k conv, then a pointwise 1x1 (reference
    network_blocks.py:59-78; JAX ``models/blocks.py:DWConv``), each a
    :class:`BaseConv` with its BN and activation: ``dconv`` and ``pconv``,
    the reference's names. Takes BaseConv's arguments."""

    def __init__(self, in_channels: int, out_channels: int, ksize: int,
                 stride: int = 1, act: str = "silu",
                 neuron: Neuron = Neuron(), dtype=torch.float32):
        super().__init__()
        self.dconv = BaseConv(in_channels, in_channels, ksize, stride, act,
                              neuron, dtype, groups=in_channels)
        self.pconv = BaseConv(in_channels, out_channels, 1, 1, act, neuron,
                              dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pconv(self.dconv(x))


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 conv (depthwise-separable with ``depthwise``),
    additive shortcut (reference network_blocks.py:81-104). Spiking:
    spikes + spikes."""

    def __init__(self, in_channels: int, out_channels: int,
                 shortcut: bool = True, expansion: float = 0.5,
                 act: str = "silu", neuron: Neuron = Neuron(),
                 dtype=torch.float32, depthwise: bool = False):
        super().__init__()
        hidden = int(out_channels * expansion)
        conv = DWConv if depthwise else BaseConv
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act, neuron, dtype)
        self.conv2 = conv(hidden, out_channels, 3, 1, act, neuron, dtype)
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
        sp = active_spatial()
        if sp is None:
            return self.conv2((x, *spp_pools(x, self.kernel_sizes)))
        # row shards: the pools reach 6 rows (5, then 5 twice more) past
        # shards of 2-4 rows at stride 32, so they run on the gathered
        # map (the smallest of the model) and keep this shard's rows
        n = x.shape[-2]
        pools = spp_pools(gather_rows(x, sp), self.kernel_sizes)
        return self.conv2((x, *(p.narrow(-2, sp.model_index * n, n)
                                for p in pools)))


class CSPLayer(nn.Module):
    """C3 cross-stage partial block (reference network_blocks.py:150-188).
    Takes a tensor or a tuple of tensors (a channel concat)."""

    def __init__(self, in_channels: int, out_channels: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 act: str = "silu", neuron: Neuron = Neuron(),
                 dtype=torch.float32, depthwise: bool = False):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = BaseConv(in_channels, hidden, 1, 1, act, neuron, dtype)
        self.conv2 = BaseConv(in_channels, hidden, 1, 1, act, neuron, dtype)
        self.conv3 = BaseConv(2 * hidden, out_channels, 1, 1, act, neuron,
                              dtype)
        self.m = nn.Sequential(*[
            Bottleneck(hidden, hidden, shortcut, 1.0, act, neuron, dtype,
                       depthwise)
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
    """Nearest-neighbour 2x spatial upsample of (N, C, H, W), in x's dtype
    (int8 spike trains of a spiking neck stay int8)."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
