"""Event-to-frame front ends (counterpart of
``eas_snn_tpu/models/embedding.py``; reference embedding.py): ``count``
(the micro-frames summed), ``snn`` (a feedforward LIF), ``rsnn`` (a gated
recurrent LIF) and ``arsnn``, the adaptive sampler (reference
embedding.py:79-226), built by :func:`build_embedding`. count, snn and
rsnn emit one (B*Tl, C, H, W) frame; their forward is plain PyTorch, as
the JAX package's is plain XLA (no kernel of either package serves them).
Their spike is rect at alpha 1 whatever the detector's (reference
get_kwargs_spikes, event_yolox_base.py:153-158). Parameter names are the
reference's where the JAX package's importer knows them: the snn stack
``embedding_conv.layer.{0,2,..}`` (the reference's time-distributed
``tdLayer``), the rsnn and arsnn stacks ``input_conv.{0,2,..}`` and
``gate_conv.{0,2,..}``, the snn decay logit ``decay``.

Events arrive as (B, Tl, Tm, H, W, C); macro slices Tl fold into the
batch and the Tm micro-steps are scanned in reversed order
(embedding.py:155-156). The output is a (Ts, B*Tl, C, H, W) stack of
learned temporal slices. The conv stacks are ``conv[ReLU conv]*`` as
``nn.Sequential`` (so their convs sit at indices 0, 2, ...), computed in
``dtype`` (None: the state dtype) with the bias added after the conv, as
the JAX closure does. The same forward trains: the sampler's rect spike
carries its surrogate gradient (``ops/arsnn.py``), and with no state dtype
set (the flagship trains without ``deploy()``) the state keeps the
input's dtype, f32.

``packed`` ('never' | 'auto', the JAX ``packed``) runs the whole scan in
the space-to-depth layout of ``ops/pack.py`` where 'auto' and the frame
packs into ``packed_block`` x ``packed_block`` blocks: each k x k stencil
conv becomes a cuDNN 3 x 3 conv of the packed weights (a differentiable
gather of the module's own), so the route trains; the scan's arithmetic
is the plain route's, its convs summed in another order. It comes first,
as in ``eas_snn_tpu/models/embedding.py:329-344``.

On a 2-D mesh (``parallel/mesh.py``) a channel-sharded stack gathers its
weights where it uses them, and every route computes the whole stack on
every process, as the sampler's kernel takes whole weights. Inside a
spatial sharding each conv stack runs on its row shard grown by the
stack's reach (depth x k // 2 rows; depth rows of blocks packed), and the
whole-scan kernel refreshes the halo rows of its spikes between its
micro-steps (``ops/arsnn_fused.py:arsnn_fused_v2_rows``): the gate stack
reads the neighbours' spikes of the step before.

``fused_sampler`` (the JAX ``use_pallas``) routes the eval forward through
the fused sampler kernels (``ops/arsnn_fused.py``), as
``eas_snn_tpu/models/embedding.py:345-369`` does: the whole-scan kernel
(v2) where ``v2_supported`` passes, the module is not training, and the
mode is 'always', or 'auto' with the events on a CUDA device; else, under
'always', the per-step kernel (v1) with the convs outside it, which has no
gradient; else the plain differentiable scan. The kernels compute their
own precision: v2 in f32 whatever the state and conv dtypes (on the events
rounded to the state dtype), v1 in the state dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.arsnn import arsnn_scan
from ..ops.arsnn_fused import (arsnn_fused_v2, arsnn_fused_v2_rows,
                               arsnn_scan_fused, v2_supported)
from ..ops.lif import gated_lif_update, lif_scan
from ..ops.pack import (depth_to_space, pack_bias, pack_conv_kernel,
                        packable, space_to_depth)
from ..ops.surrogate import get_spike_fn
from ..parallel.mesh import active_spatial, exchange_rows_, full, halo, \
    over_rows

__all__ = ["ARSNNEmbedding", "LIFEmbedding", "RSNNEmbedding",
           "SpikeCountEmbedding", "build_embedding", "fold_time",
           "logit_decay", "apply_packed_stack", "FUSED_SAMPLER_MODES",
           "PACKED_MODES", "EMBEDDINGS"]

EMBEDDINGS = ("count", "snn", "rsnn", "arsnn")

FUSED_SAMPLER_MODES = ("never", "auto", "always")
PACKED_MODES = ("never", "auto")


def fold_time(events: torch.Tensor) -> torch.Tensor:
    """(B, Tl, Tm, H, W, C) or (B, Tm, H, W, C) -> time-reversed
    (Tm, B*Tl, H, W, C)."""
    if events.dim() == 6:
        B, Tl, Tm = events.shape[:3]
        events = events.reshape((B * Tl,) + tuple(events.shape[2:]))
    elif events.dim() != 5:
        raise ValueError(f"expected 5/6-dim events, got {tuple(events.shape)}")
    return events.movedim(1, 0).flip(0)


def logit_decay(decay: float) -> float:
    """The logit of ``decay``, so that sigmoid(param) is the decay
    (reference utils/util.py:278-280 warp_decay)."""
    return math.log(decay / (1.0 - decay))


def _conv_stack(in_ch: int, out_ch: int, ksize: int, depth: int) -> nn.Sequential:
    layers = []
    for i in range(depth):
        if i:
            layers.append(nn.ReLU())
        layers.append(nn.Conv2d(in_ch if i == 0 else out_ch, out_ch, ksize,
                                padding=ksize // 2))
    return nn.Sequential(*layers)


def _init_orthogonal(stack: nn.Module, generator: torch.Generator) -> None:
    """Every conv of ``stack`` orthogonal x sqrt(2), its bias zero (the JAX
    package's ``_ORTHO``; reference embedding.py:121-127)."""
    for m in stack.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.orthogonal_(m.weight, math.sqrt(2.0), generator=generator)
            nn.init.zeros_(m.bias)


def _init_fan_in_uniform(stack: nn.Module,
                         generator: torch.Generator) -> None:
    """Every conv of ``stack`` uniform in +-sqrt(3 / fan_in), its bias zero
    (the JAX package's ``_KAIMING_SIGMOID``; reference
    embedding.py:128-130)."""
    for m in stack.modules():
        if isinstance(m, nn.Conv2d):
            lim = math.sqrt(3.0 / (m.weight[0].numel()))
            nn.init.uniform_(m.weight, -lim, lim, generator=generator)
            nn.init.zeros_(m.bias)


def _reach(stack: nn.Sequential, rows_per_layer: int) -> int:
    """The stencil size of a whole stack for :func:`over_rows`."""
    depth = sum(isinstance(m, nn.Conv2d) for m in stack)
    return 2 * depth * rows_per_layer + 1


def apply_stack(stack: nn.Sequential, dtype: Optional[torch.dtype] = None):
    """``x -> stack(x)`` computed in ``dtype`` (None: x's), the bias added
    after each conv and the result cast back to x's dtype, as the JAX
    package's conv-stack closure computes. Channel-sharded weights are
    gathered (``parallel.mesh.full``); on a row shard the stack runs over
    its halo (``parallel.mesh.over_rows``)."""
    def layers(x: torch.Tensor) -> torch.Tensor:
        out_dtype = x.dtype
        cdt = dtype or out_dtype
        x = x.to(cdt)
        for m in stack:
            if isinstance(m, nn.ReLU):
                x = torch.relu(x)
            else:
                x = F.conv2d(x, full(m, "weight").to(cdt),
                             padding=m.padding) + \
                    full(m, "bias").to(cdt)[None, :, None, None]
        return x.to(out_dtype)

    k = next(m for m in stack if isinstance(m, nn.Conv2d)).kernel_size[0]
    return lambda x: over_rows(x, layers, _reach(stack, k // 2))


def apply_packed_stack(stack: nn.Sequential, block: int,
                       dtype: Optional[torch.dtype] = None):
    """:func:`apply_stack` of ``stack`` in the space-to-depth layout: each
    conv a 3 x 3 conv (pad 1) of its packed weights over ``block`` x
    ``block`` packed inputs (JAX ``_packed_conv_apply``). The weights are
    packed once, when the closure is made."""
    packed = [(pack_conv_kernel(full(m, "weight"), block),
               pack_bias(full(m, "bias"), block))
              if isinstance(m, nn.Conv2d) else None for m in stack]

    def layers(x: torch.Tensor) -> torch.Tensor:
        out_dtype = x.dtype
        cdt = dtype or out_dtype
        x = x.to(cdt)
        for wb in packed:
            if wb is None:
                x = torch.relu(x)
            else:
                x = F.conv2d(x, wb[0].to(cdt), padding=1) + \
                    wb[1].to(cdt)[None, :, None, None]
        return x.to(out_dtype)

    return lambda x: over_rows(x, layers, _reach(stack, 1))


class _TimeDistributed(nn.Module):
    """A stack applied with time folded into the batch (the reference's
    ``tdLayer``, layer.py:122-132): here only a holder that gives its
    parameters the reference's ``.layer`` names."""

    def __init__(self, layer: nn.Sequential):
        super().__init__()
        self.layer = layer


def _events_nchw(events: torch.Tensor) -> torch.Tensor:
    """(B, Tl, Tm, H, W, C) -> time-reversed (Tm, B*Tl, C, H, W)."""
    return fold_time(events).permute(0, 1, 4, 2, 3)


def _over_steps(fn, ev: torch.Tensor) -> torch.Tensor:
    """``fn`` over the (Tm * N, C, H, W) steps of a (Tm, N, C, H, W) ``ev``,
    as one batch; the result back as (Tm, N, ...)."""
    y = fn(ev.reshape((-1,) + tuple(ev.shape[2:])))
    return y.reshape(tuple(ev.shape[:2]) + tuple(y.shape[1:]))


class SpikeCountEmbedding(nn.Module):
    """The event micro-frames summed over time (reference
    embedding.py:9-24): (B*Tl, C, H, W)."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        pass

    def forward(self, events: torch.Tensor) -> torch.Tensor:
        return _events_nchw(events).sum(0)


class LIFEmbedding(nn.Module):
    """One conv stack over all Tm steps, then a LIF over them with a
    learnable decay logit; readout 'sum' (the no-reset membranes summed)
    or 'last' (the final membrane) (reference embedding.py:28-76)."""

    def __init__(self, ksize: int = 7, in_channels: int = 2,
                 out_channels: int = 2, depth: int = 1, readout: str = "sum",
                 thresh: float = 1.0, vreset: Optional[float] = 0.0,
                 decay: float = 0.5):
        super().__init__()
        if readout not in ("sum", "last"):
            raise NotImplementedError(f"readout '{readout}'")
        self.readout, self.thresh, self.vreset = readout, thresh, vreset
        self.decay_init = decay
        self.embedding_conv = _TimeDistributed(
            _conv_stack(in_channels, out_channels, ksize, depth))
        self.decay = nn.Parameter(torch.tensor(logit_decay(decay)))
        self.spike_fn = get_spike_fn("rect")

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        _init_orthogonal(self.embedding_conv, generator)
        self.decay.fill_(logit_decay(self.decay_init))

    def forward(self, events: torch.Tensor) -> torch.Tensor:
        ev = _events_nchw(events)
        psp = _over_steps(apply_stack(self.embedding_conv.layer), ev)
        _, v, vsum = lif_scan(psp, self.decay.to(psp.dtype), self.thresh,
                              self.vreset, self.spike_fn)
        return vsum if self.readout == "sum" else v


class RSNNEmbedding(nn.Module):
    """A gated recurrent LIF without segmentation (reference
    embedding.py:229-316 SpikingEmbedding): the input conv runs once over
    all steps, the gate conv on each step's last spike;
    gate = sigmoid(g_in + g_rec), v <- gate * v + c_in + c_rec. Readout
    'sum' or 'last', ReLU'd with ``use_relu`` (the exp's ``abs``)."""

    def __init__(self, ksize: int = 7, in_channels: int = 2,
                 out_channels: int = 2, depth: int = 1, readout: str = "sum",
                 use_relu: bool = False, thresh: float = 1.0,
                 vreset: Optional[float] = 0.0):
        super().__init__()
        C = out_channels
        self.readout, self.use_relu = readout, use_relu
        self.thresh, self.vreset = thresh, vreset
        self.input_conv = _conv_stack(in_channels, 2 * C, ksize, depth)
        self.gate_conv = _conv_stack(C, 2 * C, ksize, depth)
        self.spike_fn = get_spike_fn("rect")

    def reset_parameters(self, generator: torch.Generator) -> None:
        _init_orthogonal(self.input_conv, generator)
        _init_fan_in_uniform(self.gate_conv, generator)

    def forward(self, events: torch.Tensor) -> torch.Tensor:
        ev = _events_nchw(events)
        inp = _over_steps(apply_stack(self.input_conv), ev)
        C = inp.shape[2] // 2
        gate_conv = apply_stack(self.gate_conv)
        v = spike = vsum = torch.zeros_like(inp[0, :, :C])
        for t in range(inp.shape[0]):
            rec = gate_conv(spike)
            gate = torch.sigmoid(inp[t, :, :C] + rec[:, :C])
            v, v_noreset, spike = gated_lif_update(
                v, gate, inp[t, :, C:] + rec[:, C:], self.thresh,
                self.vreset, self.spike_fn)
            vsum = vsum + v_noreset
        out = vsum if self.readout == "sum" else v
        return torch.relu(out) if self.use_relu else out


class ARSNNEmbedding(nn.Module):
    def __init__(self, ksize: int = 7, in_channels: int = 2,
                 out_channels: int = 2, Ts: int = 1, depth: int = 1,
                 readout: str = "sum", spike_attach: bool = False,
                 write_zero: bool = False, use_abs: bool = False,
                 split: bool = False,
                 thresh: float = 1.0, vreset: Optional[float] = 0.0,
                 dtype: Optional[torch.dtype] = None,
                 state_dtype: Optional[torch.dtype] = None,
                 fused_sampler: str = "never", remat: bool = False,
                 packed: str = "never", packed_block: int = 4):
        super().__init__()
        self.remat = remat
        if fused_sampler not in FUSED_SAMPLER_MODES:
            raise ValueError(f"fused_sampler '{fused_sampler}' not in "
                             f"{FUSED_SAMPLER_MODES}")
        if packed not in PACKED_MODES:
            raise ValueError(f"packed '{packed}' not in {PACKED_MODES}")
        self.packed, self.packed_block = packed, packed_block
        C = out_channels
        self.ksize, self.depth = ksize, depth
        self.fused_sampler = fused_sampler
        self.Ts, self.readout, self.thresh, self.vreset = Ts, readout, thresh, vreset
        self.spike_attach, self.write_zero, self.use_abs = (
            spike_attach, write_zero, use_abs)
        self.dtype, self.state_dtype = dtype, state_dtype
        self.input_conv = _conv_stack(in_channels, 2 * C, ksize, depth)
        self.gate_conv = _conv_stack(C, 2 * C, ksize, depth)
        if split:
            # declared only, as the reference declares them
            # (embedding.py:100-102, 129-130): no forward uses them
            self.input_conv_agg = nn.Conv2d(in_channels, 2 * C, ksize,
                                            padding=ksize // 2)
            self.gate_conv_agg = nn.Conv2d(C, 2 * C, ksize,
                                           padding=ksize // 2)
        # the sampler's spike is rect whatever the detector uses
        # (reference get_kwargs_spikes, event_yolox_base.py:153-158)
        self.spike_fn = get_spike_fn("rect")

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Input convs: orthogonal x sqrt(2); gate convs: fan-in uniform;
        biases zero (reference embedding.py:121-130); the split convs with
        the two inits swapped."""
        _init_orthogonal(self.input_conv, generator)
        _init_fan_in_uniform(self.gate_conv, generator)
        if hasattr(self, "input_conv_agg"):
            _init_fan_in_uniform(self.input_conv_agg, generator)
            _init_orthogonal(self.gate_conv_agg, generator)

    def stack_weights(self):
        """[(weight, bias), ...] of the input and of the gate conv stack,
        one pair a layer: what the whole-scan kernel takes."""
        return [[(full(m, "weight"), full(m, "bias")) for m in stack
                 if isinstance(m, nn.Conv2d)]
                for stack in (self.input_conv, self.gate_conv)]

    def scan_kwargs(self) -> dict:
        """The scan's keyword options, as every sampler route takes them."""
        return dict(Ts=self.Ts, thresh=self.thresh, vreset=self.vreset,
                    readout=self.readout, spike_attach=self.spike_attach,
                    write_zero=self.write_zero, use_abs=self.use_abs)

    def route(self, ev: torch.Tensor) -> str:
        """'packed', 'v2', 'v1' or 'plain': the sampler path for the
        time-major (Tm, N, Cin, H, W) events ``ev``."""
        if self.packed == "auto" and packable(ev.shape[3], ev.shape[4],
                                              self.ksize, self.packed_block):
            return "packed"
        if self.fused_sampler == "never":
            return "plain"
        Tm, N, Cin = ev.shape[:3]
        C = self.gate_conv[0].in_channels
        if v2_supported(Tm, Cin, C, self.depth, self.ksize, Ts=self.Ts,
                        training=self.training, N=N) and (
                self.fused_sampler == "always" or ev.is_cuda):
            return "v2"
        return "v1" if self.fused_sampler == "always" else "plain"

    def forward(self, events: torch.Tensor) -> torch.Tensor:
        ev = _events_nchw(events)
        in_dtype = ev.dtype
        if self.state_dtype is not None:
            ev = ev.to(self.state_dtype)
        kw = self.scan_kwargs()
        route = self.route(ev)
        if route == "packed":
            blk = self.packed_block
            agg = arsnn_scan(
                space_to_depth(ev, blk),
                apply_packed_stack(self.input_conv, blk, self.dtype),
                apply_packed_stack(self.gate_conv, blk, self.dtype),
                spike_fn=self.spike_fn, remat=self.remat, **kw)
            return depth_to_space(agg, blk,
                                  self.gate_conv[0].in_channels).to(in_dtype)
        convs = (apply_stack(self.input_conv, self.dtype),
                 apply_stack(self.gate_conv, self.dtype))
        sp = active_spatial()
        if route == "v2" and sp is not None:
            r = self.depth * (self.ksize // 2)
            ext, t, b = halo(ev, r, r, sp)
            agg = arsnn_fused_v2_rows(
                ext.contiguous(), *self.stack_weights(),
                exchange=lambda spikes: exchange_rows_(spikes, r, sp),
                chunk_rows=ev.shape[-2] + 2 * r, **kw)
            agg = agg[..., t:agg.shape[-2] - b, :]
        elif route == "v2":
            agg = arsnn_fused_v2(ev.contiguous(), *self.stack_weights(), **kw)
        elif route == "v1":
            agg = arsnn_scan_fused(ev, *convs, **kw)
        else:
            agg = arsnn_scan(ev, *convs, spike_fn=self.spike_fn,
                             remat=self.remat, **kw)
        return agg.to(in_dtype)


def build_embedding(name: str, *, dtype: Optional[torch.dtype] = None,
                    ksize: int = 7, depth: int = 1, Ts: int = 1,
                    readout: str = "sum", spike_attach: bool = False,
                    write_zero: bool = False, use_abs: bool = False,
                    split: bool = False, thresh: float = 1.0,
                    vreset: Optional[float] = 0.0, decay: float = 0.5,
                    state_dtype: Optional[torch.dtype] = None,
                    fused_sampler: str = "never",
                    remat: bool = False, packed: str = "never",
                    packed_block: int = 4) -> nn.Module:
    """The embedding ``name`` (JAX ``build_embedding``; reference
    embedding_dict, event_yolox_base.py:166-177). ``dtype``, the state
    dtype and the fused sampler concern the arsnn sampler only, as in the
    JAX package; so does ``remat``, the per-step rematerialization of the
    sampler's plain scan (JAX ``models/embedding.py:278, 319``), and
    ``packed``, its space-to-depth route (``packed_block``)."""
    if name == "count":
        return SpikeCountEmbedding()
    if name == "snn":
        return LIFEmbedding(ksize=ksize, depth=depth, readout=readout,
                            thresh=thresh, vreset=vreset, decay=decay)
    if name == "rsnn":
        return RSNNEmbedding(ksize=ksize, depth=depth, readout=readout,
                             use_relu=use_abs, thresh=thresh, vreset=vreset)
    if name == "arsnn":
        return ARSNNEmbedding(
            ksize=ksize, depth=depth, Ts=Ts, readout=readout,
            spike_attach=spike_attach, write_zero=write_zero,
            use_abs=use_abs, split=split, thresh=thresh, vreset=vreset,
            dtype=dtype, state_dtype=state_dtype,
            fused_sampler=fused_sampler, remat=remat, packed=packed,
            packed_block=packed_block)
    raise KeyError(f"unknown embedding '{name}'; one of {EMBEDDINGS}")
