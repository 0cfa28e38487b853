"""PyTorch/CUDA port of ``eas_snn_tpu`` for one NVIDIA H100.

The eval forward of the spiking YOLOX detectors (ARSNN sampler, spiking
CSPDarknet, analog PAFPN and YOLOX head, decode and NMS) and their train
step (surrogate gradients, train-mode BN, SimOTA and the YOLOX losses,
Adam with EMA, checkpoints, a trainer: ``core/``) in plain PyTorch, with
the PLIF and conv+BN+PLIF sites of the backbone running hand-written CUDA
kernels (``csrc/``): at eval the PLIF forward and the fused conv sites, in
training the BN-fused PLIF forward and its backward. Tensors inside are NCHW with the T time steps
folded into the batch axis, t-major: (T*B, C, H, W). Events go in as
(B, Tl, Tm, H, W, C) and decoded (B, A, 5 + classes) comes out, as in the
JAX package.

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``"cpu"``; on CPU tensors every kernel wrapper runs its plain PyTorch
version instead.
"""

from .exp import EventExp, detect, get_exp

__all__ = ["EventExp", "detect", "get_exp"]
