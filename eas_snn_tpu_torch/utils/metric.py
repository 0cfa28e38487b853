"""Windowed meters for training telemetry (the port's own copy of
``eas_snn_tpu/utils/metric.py:AverageMeter`` and ``MeterBuffer``, the
parts the trainer reads; reference yolox/utils/metric.py:65-137)."""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict, Optional

import numpy as np

__all__ = ["AverageMeter", "MeterBuffer"]


class AverageMeter:
    """The average and latest value over a window, and the count of all
    values seen."""

    def __init__(self, window_size: int = 50):
        self._deque = deque(maxlen=window_size)
        self.count = 0

    def update(self, value) -> None:
        self._deque.append(float(value))
        self.count += 1

    @property
    def avg(self) -> float:
        return float(np.mean(self._deque)) if self._deque else 0.0

    @property
    def latest(self) -> float:
        return self._deque[-1] if self._deque else 0.0


class MeterBuffer(defaultdict):
    """Name -> AverageMeter map with bulk update."""

    def __init__(self, window_size: int = 20):
        super().__init__(lambda: AverageMeter(window_size))

    def update(self, values: Optional[Dict] = None, **kwargs) -> None:
        values = dict(values or {})
        values.update(kwargs)
        for k, v in values.items():
            self[k].update(v)
