"""ctypes loader for the native event-binning core (``fastbin.cpp``, the
port's copy of ``eas_snn_tpu/data/fastbin/``).

The core is compiled at first use by one ``g++ -O3`` into the port's build
directory (``eas_snn_tpu_torch/_build/``, where ``ops/_build.py`` puts the
CUDA libraries), named by the hash of its source and flags, with an atomic
rename so that processes building at once do not clash. A failed build
raises: the numpy versions in ``reps.py`` are the core's plain versions and
test oracle, not a silent fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

__all__ = ["load_native", "library_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastbin.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")
# no -march=native: the library may be loaded on another host's CPU
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"libfastbin_{tag[:12]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    r = subprocess.run(["g++", *FLAGS, _SRC, "-o", tmp],
                       capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed to build {_SRC}:\n{r.stderr}")
    os.replace(tmp, path)


def load_native() -> ctypes.CDLL:
    """The loaded core, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        u16 = np.ctypeslib.ndpointer(np.uint16, flags="C")
        u8 = np.ctypeslib.ndpointer(np.uint8, flags="C")
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C")
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C")
        i = ctypes.c_int64
        lib.polarity_histogram.restype = None
        lib.polarity_histogram.argtypes = [i, u16, u16, u8, i, i, f32]
        lib.micro_sum.restype = None
        lib.micro_sum.argtypes = [i, i64, u16, u16, u8, i, i, i, i, i, f32]
        _LIB = lib
        return lib
