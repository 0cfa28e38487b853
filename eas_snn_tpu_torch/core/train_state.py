"""One training step, the parameter EMA and the EMA eval forward
(counterpart of ``eas_snn_tpu/core/train_state.py``; reference
yolox/core/trainer.py:95-135, yolox/utils/ema.py).

A step is: zero the gradients, the loss forward, backward, the optimizer
update at the schedule's lr for the update count before it, then the EMA
of the parameters (not the BN buffers, which stay the model's). No neuron
state survives a step, so nothing is reset between steps.

``train_step`` runs the step eagerly, op by op from Python: the CPU path
and the path every parity test uses. ``CapturedStep`` runs the same step
as one CUDA graph a batch geometry, the counterpart of the JAX package's
jitted, donated ``train_step``: the host only fills the lr and EMA decay
scalars, copies the batch in and replays.

With a process group (``parallel``: data parallelism, one process a card)
both run the JAX package's global-batch step: the BN statistics and
SimOTA's counts are the global batch's (``models/blocks.py``,
``models/simota.py``), and between the backward and the update every
gradient and loss term is summed over the group in one flat buffer
(:func:`reduce_gradients`), so every process applies the same update.
:func:`broadcast_state` gives every process rank 0's state before the
first step. Captured, the collectives are part of the graph; the eager
warm-up steps create the group's communicator before the capture.

On a 2-D mesh (``parallel/mesh.py``) the batch's sums go over the data
group; each process of a model group back-propagates a ``tp``-th of the
loss they share (``mesh.loss_scale``), so a replicated parameter's
gradient is summed over the whole world and a channel-sharded one's over
the data group only. Inside a spatial sharding (``mesh.spatial_sharding``
as a context around ``train_step``) the step runs on this process's
rows: no parameter is sharded, each process's gradient is the share of
its rows and is summed over the whole mesh, and the loss terms, which
the model group holds whole, over the data group. Gloo cannot be
captured in a CUDA graph: ``CapturedStep`` refuses a gloo group on the
card and a spatial sharding, whose step runs eagerly (``train_step``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from .. import parallel
from ..parallel import mesh as pmesh
from .optim import set_learning_rate, updates

__all__ = ["init_ema", "ema_terms", "ema_apply", "ema_update",
           "optimizer_update", "reduce_gradients", "broadcast_state",
           "loss_backward",
           "train_step", "eval_step", "CapturedStep"]

EMA_DECAY = 0.9998


def init_ema(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of every parameter, by name."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def ema_terms(step: int) -> Tuple[np.float32, np.float32]:
    """(d, 1 - d) of the warm-up ramp d = 0.9998 * (1 - exp(-step / 2000)),
    computed in f32 as the JAX package does (reference utils/ema.py:38-60)."""
    f32 = np.float32
    d = f32(EMA_DECAY) * (f32(1.0) - np.exp(-f32(step) / f32(2000.0)))
    return d, f32(1.0) - d


@torch.no_grad()
def ema_apply(ema: Dict[str, torch.Tensor], model: nn.Module,
              d: torch.Tensor, one_minus_d: torch.Tensor) -> None:
    """ema <- ema * d + param * (1 - d) in place, in the JAX package's
    order (a product each, then the sum: a lerp rounds differently), with
    d and 1 - d 0-d tensors on the parameters' device, so that a captured
    step reads them at replay."""
    names = [n for n, _ in model.named_parameters()]
    e = [ema[n] for n in names]
    p = [q.detach() for _, q in model.named_parameters()]
    torch._foreach_mul_(e, d)
    torch._foreach_add_(e, torch._foreach_mul(p, one_minus_d))


def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module,
               step: int) -> None:
    """The EMA after update ``step`` (counted from 1)."""
    dev = next(iter(ema.values())).device
    d, omd = (torch.full((), float(v), dtype=torch.float32, device=dev)
              for v in ema_terms(step))
    ema_apply(ema, model, d, omd)


def optimizer_update(model: nn.Module, optimizer: torch.optim.Optimizer,
                     ema: Optional[Dict[str, torch.Tensor]]) -> None:
    """The update half of a step, after the backward: the lr of update t
    (t = updates so far), the optimizer step, the count, then the EMA at
    t + 1."""
    t = updates(optimizer)
    set_learning_rate(optimizer, t)
    optimizer.step()
    for g in optimizer.param_groups:
        g["updates"] = t + 1
    if ema is not None:
        ema_update(ema, model, t + 1)


# the loss terms that are sums over the batch (num_fg is a ratio of the
# global counts already)
_SUMMED_LOSSES = ("total_loss", "iou_loss", "conf_loss", "cls_loss",
                  "l1_loss")


def _sum_flat(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The tensors summed over ``group`` in one all-reduce of one flat f32
    buffer (f64 where one of them is: a float64 model's gradients); the
    sums, in order."""
    acc = torch.float64 if any(t.dtype == torch.float64 for t in tensors) \
        else torch.float32
    flat = torch.cat([t.reshape(-1).to(acc) for t in tensors])
    return list(parallel.all_reduce_sum_(flat, group).split(
        [t.numel() for t in tensors]))


def reduce_gradients(model: nn.Module, losses: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """With a process group: every parameter's gradient and the detached
    loss terms summed over the group, in one all-reduce of one flat f32
    buffer (each process's loss is its share of the global batch's, so
    the sums are the global batch's gradient and losses). Returns the
    loss dict with the summed terms. Without a group: ``losses`` as it
    is. On a channel-sharded 2-D mesh the loss terms and the sharded
    parameters' gradients are summed over the data group, and the
    replicated parameters' (each process's a share, ``mesh.loss_scale``)
    over the world: two all-reduces. On row shards (a spatial sharding
    active) every gradient is a share, summed over the whole mesh, and
    the loss terms over the data group: two all-reduces."""
    if not parallel.is_initialized():
        return losses
    names = [k for k in losses if k in _SUMMED_LOSSES]
    terms = torch.stack([losses[k].float() for k in names])
    params = [p for p in model.parameters() if p.grad is not None]
    sharded = pmesh.sharded_params(model)
    shard = [p.grad for p in params if id(p) in sharded]
    repl = [p.grad for p in params if id(p) not in sharded]
    if sharded:
        mesh = next(iter(sharded.values()))
        *sums, summed = _sum_flat(shard + [terms], mesh.data_group)
        sums += _sum_flat(repl, None) if repl else []
    else:
        group, _ = pmesh.batch_group()
        data = pmesh.data_group()
        if group is data:
            *sums, summed = _sum_flat(repl + [terms], data)
        else:  # row shards: the loss terms are the model group's, whole
            sums = _sum_flat(repl, group) if repl else []
            (summed,) = _sum_flat([terms], data)
    with torch.no_grad():
        for g, v in zip(shard + repl, sums):
            g.copy_(v.view_as(g))
    return dict(losses, **dict(zip(names, summed.unbind())))


@torch.no_grad()
def broadcast_state(model: nn.Module,
                    ema: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Rank 0's parameters, buffers and EMA on every process of the group
    (nothing without one): the start of data-parallel training. On a
    channel-sharded 2-D mesh each sharded tensor comes from the process
    of data index 0 with the same model index (its peers hold the same
    slice), the rest from rank 0."""
    names = pmesh.sharded_keys(model)
    state = dict(model.named_parameters())
    state.update(model.named_buffers())
    ema = ema or {}
    sharded = [t for k, t in list(state.items()) + list(ema.items())
               if k in names]
    rest = [t for k, t in list(state.items()) + list(ema.items())
            if k not in names]
    if sharded:
        mesh = next(iter(names.values()))
        parallel.broadcast_(sharded, mesh.data_group, mesh.data_src())
    parallel.broadcast_(rest)


def loss_backward(model: nn.Module, losses: Dict[str, torch.Tensor]
                  ) -> None:
    """The backward of a train forward's total loss: of this process's
    share of it where ``model`` is channel-sharded or runs on row shards
    (``mesh.loss_scale``)."""
    scale = pmesh.loss_scale(model)
    loss = losses["total_loss"]
    (loss * scale if scale != 1.0 else loss).backward()


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               ema: Optional[Dict[str, torch.Tensor]], events: torch.Tensor,
               targets: torch.Tensor, use_l1: bool = False,
               to_host: bool = False) -> dict:
    """One step of a model in train mode. Returns the loss dict: detached
    device tensors, so that the step does not wait for the card, or Python
    floats with ``to_host``."""
    optimizer.zero_grad(set_to_none=True)
    losses = model(events, targets, use_l1=use_l1)
    loss_backward(model, losses)
    losses = reduce_gradients(model, {k: v.detach()
                                      for k, v in losses.items()})
    optimizer_update(model, optimizer, ema)
    return {k: float(v) for k, v in losses.items()} if to_host else losses


def _refuse_spatial() -> None:
    if pmesh.active_spatial() is not None:
        raise NotImplementedError(
            "CapturedStep: a spatially sharded step is not captured (its "
            "halo exchanges and sums run over gloo on one card, which a "
            "CUDA graph cannot capture); run train_step eagerly inside the "
            "spatial sharding")


class _Graph:
    """One captured step: its static inputs, its loss output (one f32
    vector, allocated outside the graphs' pool) and the graph."""

    def __init__(self, events: torch.Tensor, targets: torch.Tensor,
                 names: List[str]):
        self.events = torch.empty_like(events)
        self.targets = torch.empty_like(targets)
        self.names = names
        self.out = torch.empty(len(names), dtype=torch.float32,
                               device=events.device)
        self.graph = torch.cuda.CUDAGraph()


class CapturedStep:
    """The train step as CUDA graphs, one a key (events shape, labels
    shape, dtypes, ``use_l1``), as the JAX package compiles once a static
    shape and ``use_l1`` value.

    The first ``WARMUP`` steps of a key run ``train_step`` eagerly on a
    side stream: real steps on real batches, which count toward training
    (as the JAX package's first, compiling step does) and which set up,
    on the stream the capture uses, what the step keeps between calls
    (Adam's state, the cuBLAS workspace, the PLIF backward's scratch).
    The next step of the key captures zero_grad, the loss forward,
    backward, the optimizer step and the EMA, then replays; every later
    step copies the batch into the static inputs, fills the lr and decay
    scalars on the host and replays. A capture that fails raises: nothing
    runs the eager step in its place. With a process group the graph holds
    the step's collectives (``reduce_gradients``, the BN sites', SimOTA's):
    the group's communicator exists before the capture, since the eager
    warm-up steps ran the same collectives on the capturing stream.

    All graphs of one ``CapturedStep`` share one memory pool, so that
    multiscale sizes do not each hold a step's activations. That is safe
    only because no graph reads a tensor that another graph wrote inside
    the pool: what a step carries to the next (parameters, optimizer
    state, BN buffers, EMA, the lr and decay scalars, the static inputs and
    loss outputs) lives outside it, and each graph's gradients are written
    and read within its own replay. After a replay ``p.grad`` is the last
    captured graph's buffer, not necessarily the replayed one's: read
    gradients after an eager step.

    Restore checkpoints (``load_optimizer_state`` replaces Adam's state
    tensors) before the first capture; after a reload, build a new
    ``CapturedStep``.

    The warm-up steps and the capture run with
    ``torch.backends.cudnn.deterministic`` set to ``deterministic``, and
    the flag is restored after each: the graph keeps the algorithms it
    captured, so every replay gives the same bits, those of an eager step
    run under the flag. cuDNN otherwise picks weight-gradient algorithms
    that sum with atomics for f32 convs (the snn and rsnn embeddings' 5x5
    stacks, ``e_yolox_*``'s convs). A model whose step draws random
    numbers (``model.draws_random_numbers``: patan at ``asgl_p > 0``) is
    refused, since a replay would repeat the captured draw.
    """

    WARMUP = 3
    deterministic = True

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 ema: Optional[Dict[str, torch.Tensor]]):
        _refuse_spatial()
        if getattr(model, "draws_random_numbers", False):
            raise NotImplementedError(
                "CapturedStep: patan at asgl_p > 0 draws a fresh Bernoulli "
                "mask a step, which a replayed graph would repeat; run "
                "train_step eagerly (asgl_p = 0, the reference's value, "
                "draws no random numbers and captures)")
        dev = next(model.parameters()).device
        if dev.type == "cuda" and parallel.backend() == "gloo":
            raise NotImplementedError(
                "CapturedStep: a gloo group's collectives (several "
                "processes on one card) cannot be captured in a CUDA graph; "
                "run train_step eagerly")
        if dev.type != "cuda":
            raise ValueError("CapturedStep: the model is on "
                             f"{dev}; CUDA graphs need a CUDA device "
                             "(train_step runs the step on the CPU)")
        if not all(g.get("capturable") and isinstance(g["lr"], torch.Tensor)
                   for g in optimizer.param_groups):
            raise NotImplementedError(
                "CapturedStep: the optimizer must be capturable, with a "
                "device-tensor lr a group (build_optimizer's Adam or SGD on "
                "a CUDA device): a CUDA graph cannot capture an lr read on "
                "the host")
        self.model, self.optimizer, self.ema = model, optimizer, ema
        self.device = dev
        self.stream = torch.cuda.Stream(dev)
        self.pool = torch.cuda.graph_pool_handle()
        self._d = torch.zeros((), dtype=torch.float32, device=dev)
        self._one_minus_d = torch.zeros_like(self._d)
        self._graphs: Dict[tuple, _Graph] = {}
        self._warm: Dict[tuple, int] = {}
        self._names: Dict[tuple, List[str]] = {}
        self.replays = 0

    @property
    def keys(self) -> List[tuple]:
        """The keys with a captured graph."""
        return list(self._graphs)

    def __call__(self, events: torch.Tensor, targets: torch.Tensor,
                 use_l1: bool = False) -> Dict[str, torch.Tensor]:
        """One step; the loss dict as device tensors of this step."""
        _refuse_spatial()
        key = (tuple(events.shape), tuple(targets.shape), events.dtype,
               targets.dtype, bool(use_l1))
        g = self._graphs.get(key)
        if g is None:
            if self._warm.get(key, 0) < self.WARMUP:
                self._warm[key] = self._warm.get(key, 0) + 1
                return self._warm_up(key, events, targets, use_l1)
            g = self._capture(key, events, targets, use_l1)
        return self._replay(g, events, targets)

    def _warm_up(self, key, events, targets, use_l1):
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream), self.cudnn_mode():
            losses = train_step(self.model, self.optimizer, self.ema,
                                events, targets, use_l1=use_l1)
        cur.wait_stream(self.stream)
        for v in losses.values():
            v.record_stream(cur)
        self._names[key] = list(losses)
        return losses

    def _capture(self, key, events, targets, use_l1) -> _Graph:
        g = _Graph(events, targets, self._names[key])
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.graph(g.graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"), \
                self.cudnn_mode():
            self.optimizer.zero_grad(set_to_none=True)
            losses = self.model(g.events, g.targets, use_l1=use_l1)
            loss_backward(self.model, losses)
            losses = reduce_gradients(self.model, {
                k: v.detach() for k, v in losses.items()})
            self.optimizer.step()
            if self.ema is not None:
                ema_apply(self.ema, self.model, self._d, self._one_minus_d)
            g.out.copy_(torch.stack([losses[k].float() for k in g.names]))
        cur.wait_stream(self.stream)
        self._graphs[key] = g
        return g

    @contextlib.contextmanager
    def cudnn_mode(self):
        """The cuDNN setting of the warm-up steps and the capture; an
        eager step held to a replay bit for bit runs under it too."""
        old = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = self.deterministic
        try:
            yield
        finally:
            torch.backends.cudnn.deterministic = old

    def _replay(self, g: _Graph, events, targets) -> Dict[str, torch.Tensor]:
        t = updates(self.optimizer)
        set_learning_rate(self.optimizer, t)
        if self.ema is not None:
            d, omd = ema_terms(t + 1)
            self._d.fill_(float(d))
            self._one_minus_d.fill_(float(omd))
        g.events.copy_(events)
        g.targets.copy_(targets)
        g.graph.replay()
        for grp in self.optimizer.param_groups:
            grp["updates"] = t + 1
        self.replays += 1
        return dict(zip(g.names, g.out.clone().unbind()))


@torch.no_grad()
def eval_step(model: nn.Module, ema: Optional[Dict[str, torch.Tensor]],
              events: torch.Tensor) -> torch.Tensor:
    """The eval forward with the EMA parameters (the model's own where
    ``ema`` is None) and the model's BN buffers; the model's train/eval
    mode is restored."""
    was_training = model.training
    model.eval()
    try:
        return functional_call(model, ema or {}, (events,))
    finally:
        model.train(was_training)
