"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) into a shared library with a plain C interface, and
loaded with ``ctypes``. Libraries are named by the hash of their source and
flags, so an edited source is rebuilt and an unchanged one is reused. The
build directory (``eas_snn_tpu_torch/_build/``) is listed in ``.gitignore``.

Nothing is built at import: the first kernel launch builds all libraries.
The port's host C++ cores (``data/fastbin``, ``evaluators/cocoeval``) are
built the same way, one ``g++`` each at first use (``host_library``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from typing import Dict, Sequence, Tuple

import torch

__all__ = ["SOURCES", "build_all", "get_lib", "host_library", "check",
           "stream_ptr", "sm_count", "require_cuda"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("plif", "plif_bwd", "conv_wgmma", "arsnn_step", "arsnn_v2")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entry points (csrc/*.cu); every pointer and the
# stream are c_void_p so ctypes never truncates them to 32 bits.
_SIGNATURES = {
    # x, out, a, n, steps, th, ge, dtype, mean, mul, bias, C, HW, E, grid,
    # stream
    "plif": {name: (_P, _P, _P, _L, _I, _F, _I, _I, _P, _P, _P, _I, _I, _I,
                    _I, _P)
             for name in ("plif_fwd", "plif_train_fwd")},
    # x, g, dx, a, mean, mul, bias, scratch, sums, steps, B, C, HW, E, nb,
    # chunk, th, ge, kind, p0, p1, dtype, stream
    "plif_bwd": {"plif_train_bwd": (_P,) * 9 + (_I,) * 7 + (_F, _I, _I, _F,
                                                            _F, _I, _P)},
    "conv_wgmma": {
        # ptrs, cins, n_pieces, w, bias, a, out, B, steps, Cout, H, W, nw,
        # chunk, n_chunks, grid_x, th, ge, dtype, stream
        "conv1x1_plif": (
            ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _P, _P, _P, _P,
            _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P,
        ),
        # x, w3, bias, a, out, B, steps, Cin, Cout, H, W, nw, chunk,
        # n_chunks, grid_x, th, ge, dtype, stream (stride 1 and 2)
        **{name: (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                  _I, _F, _I, _I, _P)
           for name in ("conv3x3_plif", "conv3x3s2_plif")},
    },
    # gin, grec, cin, crec, in_sn, vmem, vavg, spike, seg, tlast, agg, M,
    # CHW, t, Ts, th, vreset, hard, readout, attach, dtype, stream
    "arsnn_step": {"arsnn_step": (_P,) * 4 + (_L,) + (_P,) * 6 + (
        _L, _I, _I, _I, _F, _F, _I, _I, _I, _I, _P)},
    # ev, iw, ib, gw, gb, out, vmem, vavg, seg, tlast, sp_prev, sp_next, N,
    # H, W, Tm, Ts, t, depth, ksize, th, vreset, hard, readout, write_zero,
    # use_abs, dtype, stream
    "arsnn_v2": {"arsnn_v2_step": (_P,) * 12 + (_I,) * 8 + (_F, _F) + (
        _I,) * 5 + (_P,)},
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        src = f.read()
    common = os.path.join(CSRC, "common.cuh")
    with open(common, "rb") as f:
        src += f.read()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")


def build_all() -> Dict[str, str]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    per source, all in parallel. Raises with the compiler's output on any
    failure and prints it (warnings; with ``-Xptxas=-v`` added to
    NVCC_FLAGS, registers and spills) to stderr on success. Returns
    {source name: library path}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in SOURCES}
    procs = {}
    nvcc = None
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        nvcc = nvcc or _nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if out and proc.returncode == 0:
            print(f"[nvcc {name}]\n{out}", file=sys.stderr)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def get_lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all on first use."""
    if name not in _LIBS:
        paths = build_all()
        for n, path in paths.items():
            lib = ctypes.CDLL(path)
            for fn, argtypes in _SIGNATURES[n].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[n] = lib
    return _LIBS[name]


# host libraries: no -march=native, as one may be loaded on another CPU
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_HOST_LOCK = threading.Lock()
_HOST_LIBS: Dict[str, ctypes.CDLL] = {}


def host_library(src: str, stem: str,
                 signatures: Dict[str, Tuple[object, Sequence[object]]]
                 ) -> ctypes.CDLL:
    """The ctypes library of the host C++ source ``src``, with each
    function of ``signatures`` ({name: (restype, argtypes)}) bound.

    Compiled at first use by one ``g++`` into BUILD_DIR as
    ``lib<stem>_<hash of source and flags>.so``, through a temporary name
    and an atomic rename, so that processes building at once (forked
    loader workers, evaluation subprocesses) never load a half-written
    library. A failed build raises with the compiler's output."""
    with _HOST_LOCK:
        if src in _HOST_LIBS:
            return _HOST_LIBS[src]
        with open(src, "rb") as f:
            tag = hashlib.sha1(f.read() + " ".join(HOST_FLAGS).encode()
                               ).hexdigest()[:12]
        path = os.path.join(BUILD_DIR, f"lib{stem}_{tag}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            r = subprocess.run(["g++", *HOST_FLAGS, src, "-o", tmp],
                               capture_output=True, text=True)
            if r.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"g++ failed to build {src}:\n{r.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = list(argtypes)
        _HOST_LIBS[src] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device, which sizes the
    persistent grids; for any other device (the meta tensors of the
    layout checks) the H100 SXM's 132."""
    if device.type != "cuda":
        return 132
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got "
                         f"{t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
