"""Data parallelism over processes (counterpart of
``eas_snn_tpu/parallel/mesh.py``; reference yolox/core/launch.py:39-147,
utils/dist.py).

The JAX package trains data-parallel on a 1-D ``data`` mesh: the step is
one jitted program over a batch sharded across the devices, so every
reduction over the batch is global: the BN batch statistics, SimOTA's
``num_fg`` normaliser and the gradient. The port runs one process a card
and makes the same reductions global by hand, through the collectives
here: ``models/blocks.py`` all-reduces each BN site's statistics (and
their gradients in the backward), ``models/simota.py`` the foreground and
ground-truth counts, and ``core/train_state.py`` the gradients and the
loss terms, in one flat buffer a step. A process group is started by
:func:`initialize_distributed`: NCCL when the processes train on cards,
gloo on the CPU, a TCP rendezvous at the coordinator. With no group every
function here is the identity, and the step is the single-process one.

The 2-D mesh (``mesh.py``: :func:`make_mesh_2d`) splits the processes
into a ``data`` and a ``model`` axis. The batch's reductions then go over
the data group only (:func:`data_group`), and the model group carries the
tensor-parallel and spatial collectives. Every function here takes a
``group`` (None: the world).

A plain ``DistributedDataParallel`` wrapper would give each replica its
own BN statistics (the reference's arithmetic); the port follows the JAX
package's global batch instead.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "start_group", "shutdown",
           "is_initialized", "rank", "world_size", "all_reduce_sum_",
           "broadcast_", "all_gather", "data_group", "backend",
           "make_mesh", "make_mesh_2d", "shard_batch", "replicate",
           "data_parallel_shardings", "channel_shard_params",
           "dp_tp_shardings", "spatial_sharding", "Mesh2D",
           "SpatialSharding"]

# the 2-D mesh made by ``mesh.make_mesh_2d``, if any: its data group is
# the group of the batch's reductions
_MESH: list = [None]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> None:
    """Join ``num_processes`` processes in one group (the JAX package's
    ``jax.distributed.initialize``; reference core/launch.py:118-124): a
    no-op for one process or none, else :func:`start_group`."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize_distributed: several processes need "
                         "the coordinator's host:port and a process id")
    start_group(coordinator_address, num_processes, process_id, device)


def start_group(coordinator_address: str, num_processes: int,
                process_id: int, device="cuda") -> None:
    """Start the group of ``num_processes`` processes, even of one.
    ``coordinator_address`` is ``host:port`` of the rendezvous, which
    process 0 serves, or a ``torch.distributed`` init URL (``file://``: a
    file that every process can reach); ``process_id`` is this process's
    rank. On a CUDA
    ``device`` the group speaks NCCL, its communicator is made now, and
    the process takes card ``process_id`` modulo the host's cards; on the
    CPU it speaks gloo. With more processes than cards NCCL would refuse
    two ranks on one card, so the group speaks gloo over the cards'
    tensors, and says so."""
    backend, kw = "gloo", {}
    cuda = torch.device(device).type == "cuda"
    if cuda and num_processes > torch.cuda.device_count():
        card = process_id % torch.cuda.device_count()
        torch.cuda.set_device(card)
        if process_id == 0:
            print(f"parallel: {num_processes} processes on "
                  f"{torch.cuda.device_count()} card(s): NCCL takes one rank "
                  "a card, so the group speaks gloo over the cards' tensors",
                  flush=True)
    elif cuda:
        backend = "nccl"
        # the group's watchdog must not query a collective's events while
        # a CUDA graph captures it (PyTorch's CUDA graphs notes)
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        card = process_id % torch.cuda.device_count()
        torch.cuda.set_device(card)
        kw["device_id"] = torch.device("cuda", card)
    url = coordinator_address if "://" in coordinator_address else \
        f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id, **kw)


def shutdown() -> None:
    """Leave the process group, if one is started (and the 2-D mesh)."""
    _MESH[0] = None
    if is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    """Whether a process group is started (whatever its size)."""
    return dist.is_available() and dist.is_initialized()


def rank(group=None) -> int:
    """This process's rank in ``group`` (the world): 0 with no group."""
    return dist.get_rank(group) if is_initialized() else 0


def world_size(group=None) -> int:
    """The number of processes of ``group`` (the world): 1 with no
    group."""
    return dist.get_world_size(group) if is_initialized() else 1


def data_group():
    """The group the batch is split over: the 2-D mesh's data group where
    one is made (``mesh.make_mesh_2d``), else None, the world."""
    return _MESH[0].data_group if _MESH[0] is not None else None


def backend(group=None) -> str:
    """The backend of ``group`` (the world), or '' with no group."""
    return dist.get_backend(group) if is_initialized() else ""


def _sum_op(group=None):
    """The sum of the group's backend. NCCL gets a sum pre-multiplied by
    1.0, which is the sum in every bit at any size (x * 1.0 == x), because
    NCCL skips an in-place plain sum over one rank without a launch: so
    the collective runs, and is captured in a CUDA graph, in a group of
    one as in a larger one."""
    if dist.get_backend(group) == "nccl":
        return dist._make_nccl_premul_sum(1.0)
    return dist.ReduceOp.SUM


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over ``group`` (the world), in place (the identity
    with no group). One collective; it blocks until the sum is in ``t``
    (on the card: the current stream waits for it, so a CUDA graph
    captures it)."""
    if is_initialized():
        dist.all_reduce(t, op=_sum_op(group), group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every process's ``t`` of ``group`` (the world), in rank order (one
    collective; ``[t]`` with no group). Every process's ``t`` has the same
    shape and dtype."""
    if not is_initialized():
        return [t]
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def broadcast_(tensors: Iterable[torch.Tensor], group=None,
               src: int = 0) -> None:
    """The values of ``tensors`` on the process of global rank ``src`` on
    every process of ``group`` (the world), in place: one broadcast a
    dtype, through a flat buffer. Nothing with no group."""
    if not is_initialized():
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_ in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group_])
        dist.broadcast(flat, src=src, group=group)
        views: List[torch.Tensor] = list(flat.split([t.numel()
                                                     for t in group_]))
        with torch.no_grad():
            for t, v in zip(group_, views):
                t.copy_(v.view_as(t))


from .mesh import (Mesh2D, SpatialSharding, channel_shard_params,  # noqa: E402
                   data_parallel_shardings, dp_tp_shardings, make_mesh,
                   make_mesh_2d, replicate, shard_batch, spatial_sharding)
