"""Meshes of processes: the 1-D data mesh and the 2-D ``data`` x ``model``
mesh (counterpart of ``eas_snn_tpu/parallel/mesh.py``, all of its names).

In the JAX package a mesh is a grid of devices and a placement is a
sharding: XLA's partitioner turns one program into the collectives the
placements need. The port runs one process a mesh coordinate and does
those collectives by hand, over process groups:

* :func:`make_mesh_2d` splits the world's ``dp * tp`` processes into a
  grid (world rank ``d * tp + m`` at data index ``d``, model index ``m``,
  JAX's ``reshape(dp, tp)``) and makes two families of subgroups: a data
  group holds the processes of one model index, a model group those of
  one data index. The batch's reductions (BN statistics, SimOTA's counts,
  the gradient) go over the data group (:func:`data_group`,
  :func:`batch_group`).
* Tensor parallelism (TP): :func:`channel_shard_params` keeps on each
  process only its slice of what JAX's rule shards over output channels.
  A sharded conv site computes its slice of the output channels and
  all-gathers them over the model group (:func:`gather_c`), so every
  consumer sees the whole tensor; the sampler's stacks gather their
  weights where they are used (:func:`full`).
* Spatial parallelism (SP): :func:`spatial_sharding` gives each process of
  the model group its rows of the events; inside its context every k x k
  site exchanges k // 2 rows with the shard's neighbours
  (:func:`over_rows`), and the SPP pools and the head's outputs gather H.
  TP and SP both use the model axis, and one model takes one of them
  (:func:`check_placement`), as JAX has no placement of both.

The train step under TP follows JAX's SPMD transpose: every process of a
model group holds the same loss, each counts a ``tp``-th of it
(:func:`loss_scale`), the all-gather's backward sums over the group and
takes the slice, and a replicated parameter's gradient is then a share
that the step sums over the model group as well as the data group
(``core/train_state.py:reduce_gradients``). The train step under SP
follows the same rule: the loss of the gathered head outputs is the
model group's, each process back-propagates a ``tp``-th of it, every
parameter is replicated and its gradient is the share of this process's
rows, summed over the whole mesh (:func:`batch_group`); a BN site's
statistics are those of whole images, summed over the whole mesh too
(``models/blocks.py:_BatchStats``), and the loss terms over the data
group (:func:`data_group`). A recompute in the backward
(``remat``) runs under the sharding of its forward
(:func:`spatial_context`).

On cards the groups speak NCCL where there are as many cards as
processes; several processes on one card speak gloo over the card's
tensors (``parallel.start_group`` chooses and says so; :func:`make_mesh_2d`
checks once that gloo takes them, and raises if it does not). On the CPU
the groups speak gloo.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from .. import parallel
from . import (_MESH, all_gather, all_reduce_sum_, backend,
               initialize_distributed, is_initialized, rank, world_size)

__all__ = [
    "make_mesh", "shard_batch", "replicate", "data_parallel_shardings",
    "initialize_distributed",
    "make_mesh_2d", "channel_shard_params", "dp_tp_shardings",
    "spatial_sharding", "Mesh2D", "SpatialSharding", "gather_c", "halo",
    "over_rows", "gather_rows", "full", "tp_mesh", "active_spatial",
    "loss_scale", "sharded_keys", "sharded_params", "spatial_context",
    "check_placement", "data_group", "batch_group",
    "gather_state", "shard_state",
    "gather_optimizer_state", "shard_optimizer_state",
]


class Mesh2D:
    """This process's place in a (dp, tp) grid of processes: its
    ``data_index`` and ``model_index``, and the groups of its data axis
    (the processes of its model index) and of its model axis (those of
    its data index). With no process group started the mesh is 1 x 1 and
    both groups are None: every collective is then the identity."""

    def __init__(self, dp: int, tp: int, data_index: int = 0,
                 model_index: int = 0, data_group=None, model_group=None):
        self.dp, self.tp = dp, tp
        self.data_index, self.model_index = data_index, model_index
        self.data_group, self.model_group = data_group, model_group

    def data_src(self) -> int:
        """The world rank of data index 0 at this model index: the source
        of a broadcast of this process's shards."""
        return self.model_index

    def __repr__(self) -> str:
        return (f"Mesh2D(dp={self.dp}, tp={self.tp}, data={self.data_index},"
                f" model={self.model_index})")


def _check_cuda_collectives() -> None:
    """Raise unless the world group's gloo takes CUDA tensors for an
    all-reduce and an all-gather (one tiny call of each)."""
    t = torch.ones(2, device="cuda")
    try:
        dist.all_reduce(t)
        dist.all_gather([torch.empty_like(t) for _ in range(world_size())], t)
        torch.cuda.synchronize()
    except (RuntimeError, ValueError) as e:
        raise RuntimeError("parallel.mesh: the gloo group takes no CUDA "
                           f"tensor for its collectives ({e})") from e


def make_mesh_2d(dp: int, tp: int, devices: Optional[Sequence] = None
                 ) -> Mesh2D:
    """The ("data", "model") mesh of shape (dp, tp) over the started
    process group, whose size must be dp * tp (``devices`` is JAX's
    argument, unused: a process is a device). Every process calls it, in
    the same order as its other group calls. With no group started only
    1 x 1 exists. The mesh becomes the process's current one: the batch's
    reductions go over its data group from now on."""
    del devices
    if not is_initialized():
        if dp * tp != 1:
            raise ValueError(f"make_mesh_2d({dp}, {tp}): no process group is "
                             "started (parallel.start_group)")
        _MESH[0] = Mesh2D(1, 1)
        return _MESH[0]
    if world_size() != dp * tp:
        raise ValueError(f"make_mesh_2d({dp}, {tp}): the group has "
                         f"{world_size()} processes, not {dp * tp}")
    d, m = divmod(rank(), tp)
    data_groups = [dist.new_group([i * tp + j for i in range(dp)])
                   for j in range(tp)]
    model_groups = [dist.new_group([i * tp + j for j in range(tp)])
                    for i in range(dp)]
    if backend() == "gloo" and torch.cuda.is_available():
        _check_cuda_collectives()
        if rank() == 0:
            print("parallel.mesh: gloo takes the card's tensors for "
                  "all-reduce and all-gather", flush=True)
    _MESH[0] = Mesh2D(dp, tp, d, m, data_groups[m], model_groups[d])
    return _MESH[0]


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = "data") -> Mesh2D:
    """The 1-D data-parallel mesh over every process: a (world, 1) mesh,
    whose data group is the world's processes."""
    del devices, axis_name
    return make_mesh_2d(world_size(), 1)


def _batch_share(mesh: Mesh2D, x: torch.Tensor, axis: int = 0
                 ) -> torch.Tensor:
    B = x.shape[axis]
    if B % mesh.dp:
        raise ValueError(f"a batch of {B} does not split over "
                         f"{mesh.dp} data processes")
    per = B // mesh.dp
    return x.narrow(axis, mesh.data_index * per, per)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def shard_batch(mesh: Mesh2D, tree, axis_name: str = "data"):
    """This process's share of a batch: axis 0 of every tensor of
    ``tree`` split evenly over the data axis."""
    del axis_name
    return _tree_map(lambda x: _batch_share(mesh, x), tree)


def replicate(mesh: Mesh2D, tree):
    """Every process holds the whole ``tree`` (itself)."""
    del mesh
    return tree


def data_parallel_shardings(mesh: Mesh2D, axis_name: str = "data"):
    """(batch placement, replicated placement): functions of a tensor."""
    del axis_name
    return (lambda x: _batch_share(mesh, x)), (lambda x: x)


def dp_tp_shardings(mesh: Mesh2D):
    """(batch placement, replicated placement) of a 2-D mesh: the batch
    split over "data" only (the model axis holds whole batches); use
    :func:`channel_shard_params` for the parameters."""
    return data_parallel_shardings(mesh)


# ------------------------------------------------------------ the rule

def _shardable(shape, tp: int) -> bool:
    """JAX's rule (``mesh.py:103-118``) in torch layout: a 4-D conv
    kernel whose output channels (dim 0 here, the last axis in JAX's
    HWIO) divide by ``tp``, and a 1-D vector whose length does."""
    return len(shape) in (1, 4) and shape[0] % tp == 0


def _slice(t: torch.Tensor, mesh: Mesh2D) -> torch.Tensor:
    n = t.shape[0] // mesh.tp
    return t.detach().narrow(0, mesh.model_index * n, n).clone()


def channel_shard_params(mesh: Mesh2D, tree, axis_name: str = "model"):
    """Keep this process's slice of what JAX's rule shards over the model
    axis: every conv weight whose output channels divide by tp and every
    1-D vector of a length that does (BN scale, bias and running
    statistics, conv biases, a per-channel patan alpha); everything else
    stays replicated. A module is sharded in place: its parameters keep
    their identity (``p.data`` is replaced), so build the optimizer
    before or after, but step it only after. A dict of tensors (an EMA,
    a state dict of whole tensors) comes back sharded. At tp = 1 nothing
    changes."""
    del axis_name
    if mesh.tp == 1:
        return tree
    if isinstance(tree, dict):
        return {k: _slice(v, mesh) if isinstance(v, torch.Tensor)
                and _shardable(v.shape, mesh.tp) else v
                for k, v in tree.items()}
    for mod in tree.modules():
        if tp_mesh(mod) is not None:
            raise ValueError(f"{type(mod).__name__} is sharded already")
        names = set()
        for name, p in list(mod._parameters.items()):
            if p is not None and _shardable(p.shape, mesh.tp):
                p.data = _slice(p, mesh)
                names.add(name)
        for name, b in list(mod._buffers.items()):
            if b is not None and _shardable(b.shape, mesh.tp):
                mod._buffers[name] = _slice(b, mesh)
                names.add(name)
        if names:
            mod._tp_mesh, mod._tp_names = mesh, frozenset(names)
    return tree


def tp_mesh(module: nn.Module) -> Optional[Mesh2D]:
    """The mesh over which ``module``'s own tensors are channel-sharded,
    or None."""
    return module.__dict__.get("_tp_mesh")


def is_sharded(module: nn.Module, name: str) -> bool:
    return tp_mesh(module) is not None and name in module._tp_names


def loss_scale(model: nn.Module) -> float:
    """The share of the replicated loss each process of a model group
    back-propagates: 1 / tp where ``model`` is channel-sharded or a
    spatial sharding is active, else 1."""
    sp = active_spatial()
    if sp is not None:
        return 1.0 / sp.tp
    for mod in model.modules():
        m = tp_mesh(mod)
        if m is not None:
            return 1.0 / m.tp
    return 1.0


# ------------------------------------------------------- collectives

class _GatherC(torch.autograd.Function):
    """All-gather along ``dim`` over the model group; the backward sums
    the cotangent over the group and takes this process's slice (the
    SPMD transpose: a replicated tensor's cotangent is a share)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return torch.cat(all_gather(x, mesh.model_group), dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_sum_(g.contiguous().clone(), ctx.mesh.model_group)
        return (g.narrow(ctx.dim, ctx.mesh.model_index * ctx.n, ctx.n),
                None, None)


def gather_c(x: torch.Tensor, mesh: Mesh2D, dim: int = 1) -> torch.Tensor:
    """The model group's slices of ``x`` along ``dim``, concatenated in
    model order (differentiable)."""
    return _GatherC.apply(x, mesh, dim)


def full(module: nn.Module, name: str) -> torch.Tensor:
    """``module.<name>`` whole: gathered over the model group where it is
    sharded (differentiable), else itself."""
    t = getattr(module, name)
    return gather_c(t, module._tp_mesh, 0) if is_sharded(module, name) else t


def channel_slice(x: torch.Tensor, mesh: Mesh2D, n: int,
                  dim: int = 1) -> torch.Tensor:
    """This process's ``n`` channels of the whole ``x``."""
    return x.narrow(dim, mesh.model_index * n, n)


def _edges(x: torch.Tensor, mesh: Mesh2D, top: int, bot: int):
    """(the ``top`` last rows of the shard above, the ``bot`` first rows
    of the shard below), None at the image's edges: one all-gather of
    every shard's edge rows over the model group."""
    n = x.shape[-2]
    if n < max(top, bot):
        raise ValueError(f"a shard of {n} rows cannot lend a halo of "
                         f"{max(top, bot)} rows")
    pkt = torch.cat([x[..., :bot, :], x[..., n - top:, :]], -2)
    parts = all_gather(pkt, mesh.model_group)
    m = mesh.model_index
    above = parts[m - 1][..., bot:, :] if m > 0 and top else None
    below = parts[m + 1][..., :bot, :] if m < mesh.tp - 1 and bot else None
    return above, below


class _Halo(torch.autograd.Function):
    """x with ``top`` rows of the shard above and ``bot`` rows of the
    shard below (none at the image's edges). The backward sends the halo
    rows' cotangents back to their owners, which add them."""

    @staticmethod
    def forward(ctx, x, mesh, top, bot):
        above, below = _edges(x, mesh, top, bot)
        ctx.mesh, ctx.top, ctx.bot, ctx.n = mesh, top, bot, x.shape[-2]
        ctx.t = 0 if above is None else top
        ctx.b = 0 if below is None else bot
        return torch.cat([p for p in (above, x, below) if p is not None], -2)

    @staticmethod
    def backward(ctx, g):
        mesh, top, bot, n, t = ctx.mesh, ctx.top, ctx.bot, ctx.n, ctx.t
        gx = g[..., t:t + n, :].clone()
        zeros = g.new_zeros(g.shape[:-2] + (top + bot, g.shape[-1]))
        pkt = zeros.clone()
        if t:
            pkt[..., :top, :] = g[..., :t, :]
        if ctx.b:
            pkt[..., top:, :] = g[..., t + n:, :]
        parts = all_gather(pkt, mesh.model_group)
        m = mesh.model_index
        if m < mesh.tp - 1 and top:  # the shard below's top halo is ours
            gx[..., n - top:, :] += parts[m + 1][..., :top, :]
        if m > 0 and bot:  # the shard above's bottom halo is ours
            gx[..., :bot, :] += parts[m - 1][..., top:, :]
        return gx, None, None, None


def halo(x: torch.Tensor, top: int, bot: int, mesh: Mesh2D):
    """(x with its halo rows, rows added above, rows added below) over the
    model group's row shards (differentiable)."""
    ext = _Halo.apply(x, mesh, top, bot)
    m = mesh.model_index
    t = top if m > 0 else 0
    return ext, t, ext.shape[-2] - x.shape[-2] - t


def over_rows(x: torch.Tensor, fn: Callable[[torch.Tensor], torch.Tensor],
              ksize: int, stride: int = 1,
              mesh: Optional[Mesh2D] = None) -> torch.Tensor:
    """``fn`` (a same-padded k x k stencil of ``stride`` 1, or a 3 x 3 of
    stride 2, over the rows of ``x``'s last-but-one axis) on this
    process's row shard, with the value the whole image would give: the
    shard grows by its halo (k // 2 rows each side; for stride 2 two rows
    above, so that the shard keeps starting at an even row), ``fn`` runs
    on it (its own zero padding stands only at the image's edges), and
    the halo's output rows are cropped. With no spatial sharding active,
    ``fn(x)``."""
    mesh = mesh or active_spatial()
    if mesh is None or (ksize == 1 and stride == 1):
        return fn(x)
    if stride == 1:
        r = ksize // 2
        ext, t, b = halo(x, r, r, mesh)
        y = fn(ext)
        return y[..., t:y.shape[-2] - b, :].contiguous()
    if stride == 2 and ksize == 3:
        ext, t, _ = halo(x, 2, 0, mesh)
        y = fn(ext)
        return y[..., t // 2:, :].contiguous()
    raise NotImplementedError(f"a {ksize}x{ksize} stencil of stride {stride} "
                              "over row shards")


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh2D] = None
                ) -> torch.Tensor:
    """The whole image of a row-sharded ``x`` (its last-but-one axis),
    gathered over the model group in model order; ``x`` itself with no
    spatial sharding active."""
    mesh = mesh or active_spatial()
    return x if mesh is None else gather_c(x, mesh, x.dim() - 2)


def exchange_rows_(x: torch.Tensor, r: int, mesh: Mesh2D) -> None:
    """Refresh, in place, the halo rows of a shard ``x`` that
    :func:`halo` grew by ``r`` rows a side (none at the image's edges)
    from the neighbours' own rows: the sampler's state between
    micro-steps."""
    m = mesh.model_index
    top = r if m > 0 else 0
    bot = r if m < mesh.tp - 1 else 0
    n = x.shape[-2] - top - bot
    above, below = _edges(x[..., top:top + n, :], mesh, r, r)
    if above is not None:
        x[..., :top, :] = above
    if below is not None:
        x[..., top + n:, :] = below


# --------------------------------------------------- spatial sharding

_ACTIVE_SP: List[Optional[Mesh2D]] = [None]


def active_spatial() -> Optional[Mesh2D]:
    """The mesh whose model group shards H in the running forward (inside
    a :class:`SpatialSharding` context), or None."""
    return _ACTIVE_SP[0]


@contextlib.contextmanager
def spatial_context(mesh: Optional[Mesh2D]):
    """``mesh`` as the active spatial sharding within (None: none), the
    one before restored after: a recompute in the backward (``remat``'s
    ``context_fn``) sees the sharding its forward saw, wherever the
    backward runs."""
    prev, _ACTIVE_SP[0] = _ACTIVE_SP[0], mesh
    try:
        yield
    finally:
        _ACTIVE_SP[0] = prev


def data_group():
    """The group a batch's samples split over in the running step: the
    active spatial sharding's data group, else the mesh made last's
    (``parallel.data_group``). The loss terms and SimOTA's counts are
    summed over it: a model group holds the same loss."""
    sp = active_spatial()
    return sp.data_group if sp is not None else parallel.data_group()


def batch_group() -> Tuple[Optional[object], int]:
    """The group of a batch's per-process sums in the running step (BN
    statistics, the gradients' shares) and its number of processes: on
    row shards the whole mesh (the world, dp x tp: each process holds H /
    tp rows of B / dp samples), else :func:`data_group`."""
    sp = active_spatial()
    if sp is not None:
        return None, sp.dp * sp.tp
    g = data_group()
    return g, world_size(g)


def check_placement(module: nn.Module) -> None:
    """Raise where a spatial sharding is active and a tensor of ``module``
    (or of a module inside it) is channel-sharded: TP and SP both split
    over the model axis, and the JAX package has no placement of both."""
    if active_spatial() is not None and any(
            tp_mesh(m) is not None for m in module.modules()):
        raise NotImplementedError(
            "channel sharding (TP) and a spatial sharding (SP) at once: "
            "both use the mesh's model axis; use one of them")


class SpatialSharding:
    """(B, ..., H, ...) event tensors with the batch over "data" and the
    image H axis (``h_axis``) over "model". Called on a whole tensor it
    returns this process's share; as a context manager it makes the
    forward inside it run on row shards (``over_rows`` at every k x k
    site, the SPP pools and the head's levels gathered along H), and a
    train step inside it the step of the whole images (its backward
    through the halos, its sums over the whole mesh). Each
    shard must hold whole rows at the model's coarsest stride
    (``multiple``, 32 for YOLOX), so H must divide by tp * 32."""

    def __init__(self, mesh: Mesh2D, h_axis: int = 3, ndim: int = 6,
                 multiple: int = 32):
        self.mesh, self.h_axis, self.ndim = mesh, h_axis, ndim
        self.multiple = multiple

    def rows(self, H: int) -> slice:
        tp = self.mesh.tp
        if H % (tp * self.multiple):
            raise ValueError(
                f"spatial sharding: H = {H} does not divide by tp x "
                f"{self.multiple} = {tp * self.multiple}; every shard must "
                f"hold whole rows at stride {self.multiple}")
        n = H // tp
        return slice(self.mesh.model_index * n, (self.mesh.model_index + 1)
                     * n)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != self.ndim:
            raise ValueError(f"expected {self.ndim}-dim events, got "
                             f"{tuple(x.shape)}")
        r = self.rows(x.shape[self.h_axis])
        x = _batch_share(self.mesh, x)
        return x.narrow(self.h_axis, r.start, r.stop - r.start).contiguous()

    def __enter__(self):
        if _ACTIVE_SP[0] is not None:
            raise RuntimeError("a spatial sharding is active already")
        _ACTIVE_SP[0] = self.mesh
        return self

    def __exit__(self, *exc):
        _ACTIVE_SP[0] = None


def spatial_sharding(mesh: Mesh2D, h_axis: int = 3, ndim: int = 6,
                     axis_name: str = "model") -> SpatialSharding:
    """The placement of (B, Tl, Tm, H, W, C) events with the batch over
    "data" and H over "model" (JAX ``spatial_sharding``)."""
    del axis_name
    return SpatialSharding(mesh, h_axis, ndim)


# ------------------------------------------------------- checkpoints

def sharded_keys(model: nn.Module) -> Dict[str, Mesh2D]:
    """The state-dict keys of ``model``'s channel-sharded tensors, each
    with its mesh."""
    out = {}
    for prefix, mod in model.named_modules():
        m = tp_mesh(mod)
        if m is not None:
            for name in mod._tp_names:
                out[f"{prefix}.{name}" if prefix else name] = m
    return out


def gather_state(model: nn.Module, state: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """``state`` (keyed as ``model``'s state dict: the state dict itself
    or an EMA) with every sharded tensor gathered whole over its model
    group. Every process of the group calls it, in the same order."""
    keys = sharded_keys(model)
    return {k: torch.cat(all_gather(v.detach(), keys[k].model_group), 0)
            if k in keys else v for k, v in state.items()}


def shard_state(model: nn.Module, state: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """A whole ``state`` (keyed as ``model``'s state dict) cut to this
    process's slices where ``model`` is sharded."""
    keys = sharded_keys(model)
    return {k: _slice(v, keys[k]) if k in keys else v
            for k, v in state.items()}


def sharded_params(model: nn.Module) -> Dict[int, Mesh2D]:
    """{id(parameter): mesh} of ``model``'s channel-sharded parameters."""
    out = {}
    for mod in model.modules():
        m = tp_mesh(mod)
        if m is not None:
            for name in mod._tp_names:
                if name in mod._parameters:
                    out[id(mod._parameters[name])] = m
    return out


def gather_optimizer_state(optimizer, model: nn.Module) -> dict:
    """``optimizer.state_dict()`` with the state of every sharded
    parameter gathered whole (every process of the group calls it)."""
    sd = optimizer.state_dict()
    by_id = sharded_params(model)
    flat = [p for g in optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(flat):
        m = by_id.get(id(p))
        if m is None or i not in sd["state"]:
            continue
        sd["state"][i] = {
            k: torch.cat(all_gather(v, m.model_group), 0)
            if isinstance(v, torch.Tensor) and v.shape == p.shape else v
            for k, v in sd["state"][i].items()}
    return sd


def shard_optimizer_state(sd: dict, optimizer, model: nn.Module) -> dict:
    """A whole optimizer state dict cut to this process's slices."""
    by_id = sharded_params(model)
    flat = [p for g in optimizer.param_groups for p in g["params"]]
    state = dict(sd["state"])
    for i, p in enumerate(flat):
        m = by_id.get(id(p))
        if m is None or i not in state:
            continue
        state[i] = {k: _slice(v, m) if isinstance(v, torch.Tensor)
                    and v.dim() and v.shape[0] == p.shape[0] * m.tp
                    and v.shape[1:] == p.shape[1:] else v
                    for k, v in state[i].items()}
    return dict(sd, state=state)
