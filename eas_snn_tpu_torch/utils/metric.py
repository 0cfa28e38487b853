"""Windowed meters for training telemetry and the card's memory in use
(the port's copy of ``eas_snn_tpu/utils/metric.py``; reference
yolox/utils/metric.py:65-137)."""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["AverageMeter", "MeterBuffer", "hbm_usage_gb"]


class AverageMeter:
    """The median and average over a window, the latest value, and the
    average and count of all values seen."""

    def __init__(self, window_size: int = 50):
        self._deque = deque(maxlen=window_size)
        self._total = 0.0
        self.count = 0

    def update(self, value) -> None:
        self._deque.append(float(value))
        self._total += float(value)
        self.count += 1

    @property
    def median(self) -> float:
        return float(np.median(self._deque)) if self._deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self._deque)) if self._deque else 0.0

    @property
    def global_avg(self) -> float:
        return self._total / max(self.count, 1)

    @property
    def latest(self) -> float:
        return self._deque[-1] if self._deque else 0.0

    def reset(self) -> None:
        self._deque.clear()
        self._total = 0.0
        self.count = 0

    def clear(self) -> None:
        """Empty the window; the global average and count stay."""
        self._deque.clear()


class MeterBuffer(defaultdict):
    """Name -> AverageMeter map with bulk update and filter."""

    def __init__(self, window_size: int = 20):
        super().__init__(lambda: AverageMeter(window_size))

    def update(self, values: Optional[Dict] = None, **kwargs) -> None:
        values = dict(values or {})
        values.update(kwargs)
        for k, v in values.items():
            self[k].update(v)

    def get_filtered_meter(self, filter_key: str) -> Dict[str, AverageMeter]:
        return {k: v for k, v in self.items() if filter_key in k}

    def reset(self) -> None:
        for v in self.values():
            v.reset()

    def clear_meters(self) -> None:
        for v in self.values():
            v.clear()


def hbm_usage_gb(device="cuda") -> float:
    """Memory the caching allocator holds in tensors on ``device``, in
    GiB; 0.0 on a device without memory statistics (the CPU, or no
    card)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return 0.0
    return torch.cuda.memory_allocated(dev) / 2 ** 30
