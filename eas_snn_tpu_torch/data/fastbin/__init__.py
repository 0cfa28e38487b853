"""ctypes loader for the native event-binning core (``fastbin.cpp``, the
port's copy of ``eas_snn_tpu/data/fastbin/``).

The core is compiled at first use into the port's build directory
(``ops/_build.py:host_library``, beside the CUDA libraries). A failed
build raises: the numpy versions in ``reps.py`` are the core's plain
versions and test oracle, not a silent fallback.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ...ops._build import host_library

__all__ = ["load_native"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "fastbin.cpp")


def load_native() -> ctypes.CDLL:
    """The loaded core, built on first use."""
    u16 = np.ctypeslib.ndpointer(np.uint16, flags="C")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C")
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C")
    i = ctypes.c_int64
    return host_library(_SRC, "fastbin", {
        "polarity_histogram": (None, [i, u16, u16, u8, i, i, f32]),
        "micro_sum": (None, [i, i64, u16, u16, u8, i, i, i, i, i, f32])})
