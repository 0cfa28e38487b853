"""Ops of the port: surrogate spike functions, PLIF dynamics, the PLIF
(eval and train), conv+BN+PLIF and fused ARSNN sampler kernel wrappers
with their plain versions (the eval kernels registered as ``torch.library``
ops, ``library.py``), the ARSNN scan and its space-to-depth packing
(``pack.py``), the fusion policy, box geometry and the NMS
postprocess."""

from .arsnn_fused import arsnn_fused_v2, fused_step
from .conv_plif import conv1x1_plif, conv3x3_plif, conv3x3s2_plif
from .plif import plif_forward, plif_train_backward, plif_train_forward
from . import library  # registers the eas_snn ops the wrappers call

__all__ = ["plif_forward", "plif_train_forward", "plif_train_backward",
           "conv1x1_plif", "conv3x3_plif", "conv3x3s2_plif",
           "arsnn_fused_v2", "fused_step",
           "KERNEL_WRAPPERS", "reset_launches", "launch_counts"]

# Every wrapper that launches a CUDA kernel, by kernel name.
KERNEL_WRAPPERS = {
    "plif_fwd": plif_forward,
    "conv1x1_plif": conv1x1_plif,
    "conv3x3_plif": conv3x3_plif,
    "conv3x3s2_plif": conv3x3s2_plif,
    "plif_train_fwd": plif_train_forward,
    "plif_train_bwd": plif_train_backward,
    "arsnn_v2": arsnn_fused_v2,
    "arsnn_step": fused_step,
}


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
