"""Meta tensors standing in for CUDA ones in the port's layout tests.

An ``eas_snn`` op on meta tensors runs its fake implementation: the
output's shape and dtype, nothing checked. Inside :class:`MetaAsCuda` it
runs the op's device implementation instead (the module-level
``*_cuda`` functions the op registers for CUDA), so that a test that
replaces the kernel libraries with stubs drives the wrappers' whole device
path, its layout checks, plans and launch counts, as on the card.
"""

from __future__ import annotations

from functools import partial

from torch.utils._python_dispatch import TorchDispatchMode

from eas_snn_tpu_torch.ops import arsnn_fused, conv_plif, plif
from eas_snn_tpu_torch.ops.library import NAMESPACE

DEVICE_IMPLS = {
    "plif_fwd": plif.plif_fwd_cuda,
    "conv1x1_plif": conv_plif.conv1x1_plif_cuda,
    "conv3x3_plif": partial(conv_plif.conv3x3_plif_cuda, stride=1),
    "conv3x3s2_plif": partial(conv_plif.conv3x3_plif_cuda, stride=2),
    "arsnn_v2": arsnn_fused.arsnn_v2_cuda,
    "arsnn_step": arsnn_fused.arsnn_step_cuda,
}


class MetaAsCuda(TorchDispatchMode):
    """Within it, each ``eas_snn`` op runs its device implementation;
    every other op runs as it would."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == NAMESPACE:
            return DEVICE_IMPLS[func._schema.name.split("::")[1]](
                *args, **(kwargs or {}))
        return func(*args, **(kwargs or {}))
