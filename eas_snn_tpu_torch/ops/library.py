"""The port's eval kernels as ``torch.library`` ops, namespace ``eas_snn``.

Each op (``torch.ops.eas_snn.<name>``) has three implementations:

* **CUDA**: the hand kernel's ctypes launch (``csrc/*.cu``), with the
  checks that read data pointers (alignment, the kernels' plans); it adds
  one to its wrapper's ``launches`` a launch, so the counts
  (``ops.launch_counts``) are counted when a kernel runs, also inside a
  reloaded exported program, and never at trace time;
* **CPU**: the kernel's plain PyTorch version;
* **fake**: the output's shape and dtype, which ``torch.export`` traces
  with (and meta tensors get), so that an exported eval forward holds the
  ops as nodes of its graph and runs them again when it is loaded.

| op | kernel (TPU row) | wrapper |
| --- | --- | --- |
| ``plif_fwd`` | ``csrc/plif.cu`` (1) | ``ops/plif.py:plif_forward`` |
| ``conv1x1_plif`` | ``csrc/conv_wgmma.cu`` (2) | ``ops/conv_plif.py:conv1x1_plif`` |
| ``conv3x3_plif`` | ``csrc/conv_wgmma.cu`` (3) | ``ops/conv_plif.py:conv3x3_plif`` |
| ``conv3x3s2_plif`` | ``csrc/conv_wgmma.cu`` (4) | ``ops/conv_plif.py:conv3x3s2_plif`` |
| ``arsnn_v2`` | ``csrc/arsnn_v2.cu`` (5, Tm launches a call) | ``ops/arsnn_fused.py:arsnn_fused_v2`` |
| ``arsnn_step`` | ``csrc/arsnn_step.cu`` (9, in place) | ``ops/arsnn_fused.py:fused_step`` |

The wrappers check their arguments and call the op on either device: one
route. The ops take the folded conv weights in f32 and the PLIF's decay
logit (the conv ops; the CUDA implementation rounds the weights to bf16
and forms the decay multiplier) or the decay multiplier and the BN terms
in f32 (``plif_fwd``). The train PLIF (rows 7 and 8, ``ops/plif.py:
plif_train``) stays an autograd Function: export is of the eval forward.
Importing ``eas_snn_tpu_torch`` registers the ops, which a saved program
(``tools/export.py``) needs before ``torch.export.load``.
"""

from __future__ import annotations

import torch

from . import arsnn_fused, conv_plif, plif

__all__ = ["NAMESPACE", "OPS"]

NAMESPACE = "eas_snn"


# Defined through ``torch.library.Library`` (a schema and one kernel a
# device), not ``torch.library.custom_op``, whose Python layers cost each
# eager call several microseconds more on the host.
_LIB = torch.library.Library(NAMESPACE, "DEF")


def _register(schema: str, cpu, cuda, fake):
    """``eas_snn::<schema>`` with ``cpu`` as its CPU kernel, ``cuda`` as
    its CUDA kernel and ``fake`` for tracing. Returns the op's default
    overload."""
    name = schema.split("(")[0]
    _LIB.define(schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", lib=_LIB)(fake)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


# ---------------------------------------------------------------- row 1

def _plif_fwd_cpu(x, T, a, mean, mul, bias, thresh, ge):
    bn = None if mean is None else (mean, mul, bias)
    return plif.plif_spikes_plain(x, T, a, bn, thresh, ge)


def _plif_fwd_fake(x, T, a, mean, mul, bias, thresh, ge):
    return x.new_empty(x.shape, dtype=torch.int8)


# ---------------------------------------------------------------- rows 2-4

def _conv1x1_plif_fake(xs, w, bias, w_plif, T, thresh, ge):
    TB, _, H, W = xs[0].shape
    return xs[0].new_empty((TB, w.shape[0], H, W), dtype=torch.int8)


def _conv3x3(stride: int):
    def cpu(x, w, bias, w_plif, T, thresh, ge):
        return conv_plif.conv3x3_plif_cpu(x, w, bias, w_plif, T, thresh, ge,
                                          stride)

    def cuda(x, w, bias, w_plif, T, thresh, ge):
        return conv_plif.conv3x3_plif_cuda(x, w, bias, w_plif, T, thresh,
                                           ge, stride)

    def fake(x, w, bias, w_plif, T, thresh, ge):
        TB, _, H, W = x.shape
        return x.new_empty((TB, w.shape[1], (H - 1) // stride + 1,
                            (W - 1) // stride + 1), dtype=torch.int8)

    return cpu, cuda, fake


# ---------------------------------------------------------------- row 5

def _arsnn_v2_fake(events, weights, depth, Ts, thresh, vreset, readout,
                   write_zero, use_abs):
    _, N, _, H, W = events.shape
    return events.new_empty((Ts, N, 2, H, W), dtype=torch.float32)


# ---------------------------------------------------------------- row 9

def _arsnn_step_fake(t, g_in, g_rec, c_in, c_rec, vmem, vavg, seg, tlast,
                     agg, Ts, thresh, vreset, readout, spike_attach):
    return torch.empty_like(vmem)


OPS = {
    "plif_fwd": _register(
        "plif_fwd(Tensor x, int T, Tensor a, Tensor? mean, Tensor? mul, "
        "Tensor? bias, float thresh, bool ge) -> Tensor",
        _plif_fwd_cpu, plif.plif_fwd_cuda, _plif_fwd_fake),
    "conv1x1_plif": _register(
        "conv1x1_plif(Tensor[] xs, Tensor w, Tensor bias, Tensor w_plif, "
        "int T, float thresh, bool ge) -> Tensor",
        conv_plif.conv1x1_plif_cpu, conv_plif.conv1x1_plif_cuda,
        _conv1x1_plif_fake),
    **{name: _register(
        f"{name}(Tensor x, Tensor w, Tensor bias, Tensor w_plif, int T, "
        "float thresh, bool ge) -> Tensor", *_conv3x3(stride))
       for name, stride in (("conv3x3_plif", 1), ("conv3x3s2_plif", 2))},
    "arsnn_v2": _register(
        "arsnn_v2(Tensor events, Tensor[] weights, int depth, int Ts, "
        "float thresh, float? vreset, str readout, bool write_zero, "
        "bool use_abs) -> Tensor",
        arsnn_fused.arsnn_v2_cpu, arsnn_fused.arsnn_v2_cuda, _arsnn_v2_fake),
    "arsnn_step": _register(
        "arsnn_step(int t, Tensor g_in, Tensor g_rec, Tensor c_in, "
        "Tensor c_rec, Tensor(a!) vmem, Tensor(b!) vavg, Tensor(c!) seg, "
        "Tensor(d!) tlast, Tensor(e!) agg, int Ts, float thresh, "
        "float? vreset, str readout, bool spike_attach) -> Tensor",
        arsnn_fused.arsnn_step_cpu, arsnn_fused.arsnn_step_cuda,
        _arsnn_step_fake),
}
