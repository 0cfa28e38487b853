"""Dataset unions (the port's copy of ``eas_snn_tpu/data/concat.py``;
reference yolox/data/datasets/datasets_wrapper.py:22-69).
``ConcatDataset`` splices its children's index spaces and moves each
sample id into the union's; ``MixConcatDataset`` also takes the
``(flag, index, ...)`` tuples of a mosaic batch sampler and rewrites the
index into the child's range.
"""

from __future__ import annotations

import bisect
from typing import Sequence

import numpy as np
import torch.utils.data

__all__ = ["ConcatDataset", "MixConcatDataset"]


class ConcatDataset(torch.utils.data.Dataset):
    def __init__(self, datasets: Sequence):
        if not datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self.datasets = list(datasets)
        self.cumulative_sizes = list(np.cumsum([len(d)
                                                for d in self.datasets]))
        first = self.datasets[0]
        if hasattr(first, "input_size"):
            self.input_size = first.input_size
        if hasattr(first, "class_names"):
            self.class_names = first.class_names
        self.map_val = bool(getattr(first, "map_val", False))
        # the children's sample names in the union's index space (a child
        # without names contributes empty ones)
        self.sample_names = []
        for d in self.datasets:
            names = getattr(d, "sample_names", None)
            self.sample_names += (list(names) if names is not None
                                  else [""] * len(d))

    def __len__(self) -> int:
        return int(self.cumulative_sizes[-1])

    def _resolve(self, idx: int):
        if idx < 0:
            if -idx > len(self):
                raise ValueError("index out of range")
            idx = len(self) + idx
        d = bisect.bisect_right(self.cumulative_sizes, idx)
        s = idx if d == 0 else idx - self.cumulative_sizes[d - 1]
        return d, s

    def __getitem__(self, idx: int):
        d, s = self._resolve(idx)
        return self._reindex(self.datasets[d][s], d)

    def _reindex(self, sample, d: int):
        """A child's sample with its id moved into the union's space."""
        off = 0 if d == 0 else int(self.cumulative_sizes[d - 1])
        if (off and isinstance(sample, tuple) and len(sample) == 4
                and np.isscalar(sample[3])):
            return sample[:3] + (sample[3] + off,)
        return sample

    def close_mosaic(self):
        for d in self.datasets:
            if hasattr(d, "close_mosaic"):
                d.close_mosaic()

    @property
    def training(self):
        return getattr(self.datasets[0], "training", True)

    @training.setter
    def training(self, value):
        for d in self.datasets:
            if hasattr(d, "training"):
                d.training = value


class MixConcatDataset(ConcatDataset):
    """Takes a plain index or a ``(flag, index, ...)`` tuple (reference
    :44-69); the tuple reaches the child with its index in the child's
    range."""

    def __getitem__(self, index):
        if isinstance(index, (int, np.integer)):
            return super().__getitem__(int(index))
        d, s = self._resolve(int(index[1]))
        return self._reindex(self.datasets[d][(index[0], s)
                                              + tuple(index[2:])], d)
