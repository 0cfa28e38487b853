"""Samplers, the batched event loader and the device prefetcher (the port's
counterpart of ``eas_snn_tpu/data/loader.py:37-397``, in PyTorch's idiom;
reference yolox/data/samplers.py:30-85, dataloading.py:32-113,
data_prefetcher.py:8-52).

  * ``InfiniteSampler`` / ``SequentialSampler``: ``torch.utils.data``
    samplers with the JAX package's index order for the same seed, rank
    and world size;
  * ``collate_event_batch``: frames (B, Tl, Tm, H, W, C) float32 and
    labels (B, max_labels, 5) as tensors (raw-events samples stack
    component-wise to (B, Tl, N); map-val labels stay a list);
  * ``EventDataLoader``: ``torch.utils.data.DataLoader`` with worker
    processes (forked, persistent), pinned batches on a CUDA host, and
    each worker's dataset generator reseeded ``seed + 1000 * (wid + 1)``
    as the JAX package's process workers do (otherwise every worker would
    draw the same augmentation);
  * ``DevicePrefetcher``: copies batch k+1 to the card on a side stream
    while step k runs; the consuming stream waits on the copy's event (the
    counterpart of the JAX trainer's ``device_put`` overlap).

The JAX package's thread workers and shared-memory frame ring are not
carried over: the DataLoader's worker processes and pinned-memory thread
take their place.
"""

from __future__ import annotations

import functools
import itertools
import multiprocessing
import os
from typing import Iterator, Optional

import numpy as np
import torch
import torch.utils.data

__all__ = ["InfiniteSampler", "SequentialSampler", "collate_event_batch",
           "EventDataLoader", "DevicePrefetcher", "worker_seed"]


class InfiniteSampler(torch.utils.data.Sampler):
    """Infinite shuffled (or sequential) index stream, rank-strided."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        if size <= 0:
            raise ValueError("InfiniteSampler: the dataset is empty")
        self.size = size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size

    def __iter__(self) -> Iterator[int]:
        return itertools.islice(self._infinite(), self.rank, None,
                                self.world_size)

    def _infinite(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed)
        while True:
            if self.shuffle:
                yield from (int(i) for i in rng.permutation(self.size))
            else:
                yield from range(self.size)


class SequentialSampler(torch.utils.data.Sampler):
    """One pass over [0, size), rank-strided without padding: ranks take
    disjoint strided slices, so no sample is counted twice at the
    evaluator's gather (the JAX package's reason, loader.py:68-86)."""

    def __init__(self, size: int, rank: int = 0, world_size: int = 1):
        self.size = size
        self.rank = rank
        self.world_size = world_size

    def __iter__(self) -> Iterator[int]:
        return iter(range(self.rank, self.size, self.world_size))

    def __len__(self) -> int:
        return len(range(self.rank, self.size, self.world_size))


def collate_event_batch(samples, stack_labels: bool = True):
    """samples: (frames, labels, img_size, sample_id) tuples; ``frames``
    may be a tuple of per-slice event arrays (raw-events mode). Returns
    (frames, labels, img_sizes, ids) as tensors."""
    if isinstance(samples[0][0], tuple):
        frames = tuple(torch.from_numpy(np.stack([s[0][i] for s in samples]))
                       for i in range(len(samples[0][0])))
    else:
        frames = torch.from_numpy(
            np.stack([s[0] for s in samples]).astype(np.float32, copy=False))
    img_sizes = torch.from_numpy(np.array([s[2] for s in samples]))
    ids = torch.from_numpy(np.array([s[3] for s in samples]))
    if stack_labels:
        labels = torch.from_numpy(np.stack([s[1] for s in samples]).astype(
            np.float32, copy=False))
    else:
        labels = [torch.from_numpy(np.asarray(s[1], np.float32))
                  for s in samples]
    return frames, labels, img_sizes, ids


def worker_seed(seed: int, worker_id: int) -> int:
    """The JAX package's per-worker reseed (loader.py:140-141)."""
    return seed + 1000 * (worker_id + 1)


def _reseed_worker(seed: int, worker_id: int) -> None:
    ds = torch.utils.data.get_worker_info().dataset
    if hasattr(ds, "rng"):
        ds.rng = np.random.default_rng(worker_seed(seed, worker_id))


class EventDataLoader:
    """Batches of an ``EventDetDataset`` from worker processes."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 infinite: bool = True, num_workers: int = 4, seed: int = 0,
                 rank: int = 0, world_size: int = 1, prefetch_batches: int = 2,
                 pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.infinite = infinite
        self.seed = seed
        # more workers than spare cores only adds context switches
        cpu_cap = max(0, (os.cpu_count() or 1) - 1)
        self.num_workers = max(0, min(num_workers, cpu_cap))
        if infinite:
            self.sampler = InfiniteSampler(len(dataset), shuffle=shuffle,
                                           seed=seed, rank=rank,
                                           world_size=world_size)
        else:
            self.sampler = SequentialSampler(len(dataset), rank=rank,
                                             world_size=world_size)
        workers = self.num_workers > 0
        self._loader = torch.utils.data.DataLoader(
            dataset, batch_size=batch_size, sampler=self.sampler,
            num_workers=self.num_workers,
            collate_fn=functools.partial(
                collate_event_batch,
                stack_labels=not getattr(dataset, "map_val", False)),
            pin_memory=pin_memory, drop_last=False,
            worker_init_fn=(functools.partial(_reseed_worker, seed)
                            if workers else None),
            # fork, as the JAX package's workers: they run numpy and
            # one-thread CPU torch only, never CUDA. Spawned workers took
            # ~13 s to start 7 on the card's host (each imports the port)
            # and each aborted at exit (std::terminate in a C++ static
            # destructor), on the H100's host and on a CPU-only host alike.
            multiprocessing_context=(multiprocessing.get_context("fork")
                                     if workers else None),
            persistent_workers=workers,
            prefetch_factor=prefetch_batches if workers else None)

    def __len__(self) -> int:
        if self.infinite:
            raise TypeError("infinite loader has no length")
        return -(-len(self.sampler) // self.batch_size)

    def __iter__(self):
        return iter(self._loader)


def _tensors(batch):
    if isinstance(batch, torch.Tensor):
        yield batch
    elif isinstance(batch, (tuple, list)):
        for b in batch:
            yield from _tensors(b)


def _to(batch, device: torch.device):
    if isinstance(batch, torch.Tensor):
        return batch.to(device, non_blocking=True)
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to(b, device) for b in batch)
    return batch


class DevicePrefetcher:
    """Iterates ``batches`` (tensors, or tuples and lists of them) on
    ``device``: on a CUDA device the copy of batch k+1 is issued on a side
    stream when batch k is handed out, so it overlaps step k; the stream
    that takes a batch waits on its copy's event. On the CPU it passes the
    batches through."""

    def __init__(self, batches, device):
        self.device = torch.device(device)
        self._it = iter(batches)
        self._stream: Optional[torch.cuda.Stream] = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda"
            else None)
        self._next = None
        self._preload()

    def _preload(self) -> None:
        batch = next(self._it, None)
        if batch is None or self._stream is None:
            self._next = (batch, None)
            return
        with torch.cuda.stream(self._stream):
            batch = _to(batch, self.device)
            done = torch.cuda.Event()
            done.record(self._stream)
        self._next = (batch, done)

    def __iter__(self):
        return self

    def __next__(self):
        batch, done = self._next
        if batch is None:
            raise StopIteration
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in _tensors(batch):
                t.record_stream(cur)
        self._preload()
        return batch
