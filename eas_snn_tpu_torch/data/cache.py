"""A small LRU cache of samples in RAM, spilled to npz files when given a
directory (the port's copy of ``eas_snn_tpu/data/cache.py``; reference
yolox/utils/cache.py:6-60): the datasets' frame prestore
(``EventDetDataset(cache_path=...)``, reference gen4.py:99-120), keyed by
sample name.

Each loader worker holds its own copy of the RAM side (workers are forked
processes); the disk side is shared: a file is written under a name of
its writer's and renamed into place, so a reader never sees half of one.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Optional

import numpy as np

__all__ = ["SampleCache"]


class SampleCache:
    def __init__(self, directory: Optional[str] = None,
                 max_items: int = 200000):
        self.directory = directory
        self.max_items = max_items
        self._ram: "OrderedDict[str, np.ndarray]" = OrderedDict()
        if directory:
            os.makedirs(directory, exist_ok=True)

    def _disk_path(self, key: str) -> Optional[str]:
        if not self.directory:
            return None
        return os.path.join(self.directory,
                            key.replace(os.sep, "_") + ".npz")

    def read(self, key: str) -> Optional[np.ndarray]:
        """The array under ``key`` (RAM first, then disk), or None."""
        if key in self._ram:
            self._ram.move_to_end(key)
            return self._ram[key]
        path = self._disk_path(key)
        if path and os.path.exists(path):
            with np.load(path) as z:
                arr = z["arr"]
            self._put_ram(key, arr)
            return arr
        return None

    def write(self, key: str, value: np.ndarray) -> None:
        self._put_ram(key, value)
        path = self._disk_path(key)
        if path and not os.path.exists(path):
            tmp = f"{path[:-4]}.{os.getpid()}.tmp.npz"
            np.savez_compressed(tmp, arr=value)
            os.replace(tmp, path)

    def _put_ram(self, key: str, value: np.ndarray) -> None:
        self._ram[key] = value
        self._ram.move_to_end(key)
        while len(self._ram) > self.max_items:
            self._ram.popitem(last=False)

    def __len__(self) -> int:
        return len(self._ram)
