"""Which spiking conv sites run the whole-site conv+BN+PLIF kernels.

The port's own copy of ``eas_snn_tpu/ops/conv_plif_policy.py``
(``_MEASURED_WINS`` and ``should_fuse``). The table was measured on a TPU
v5e (SYOLOX-M, Gen1 256x320, T=3, B=128: fused vs the unfused
conv -> BN -> PLIF chain per site); it says nothing about the H100 and is
to be measured again there. Until then it fixes which sites of the
flagship forward take which kernel: 8 sites the 1x1 kernel, 6 the 3x3
stride-1 kernel, 1 the 3x3 stride-2 kernel, and the other 35 spiking sites
a cuDNN conv + BN followed by the PLIF kernel.

Unlike the JAX ``*_supported`` gates, no ``B % 128`` lane rule applies:
the CUDA kernels take any batch. The JAX environment switch
``EAS_CONV_PLIF_FUSE`` is the ``mode`` argument here.
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["should_fuse", "FUSE_MODES"]

FUSE_MODES = ("auto", "always", "never")

# (ksize, stride, H_in, W_in, n_pieces, cin_total, cout): fused sites.
# Batch-independent; the spatial keys hold at the Gen1 256x320 input.
_MEASURED_WINS = {
    (1, 1, 64, 80, 1, 96, 48),     # dark2 CSP conv1/conv2 (reduce)
    (1, 1, 64, 80, 2, 96, 96),     # dark2 CSP conv3 (virtual concat)
    (3, 1, 32, 40, 1, 96, 96),     # dark3 bottleneck conv2 (x6)
    (1, 1, 32, 40, 2, 192, 192),   # dark3 CSP conv3
    (1, 1, 16, 20, 1, 384, 192),   # dark4 CSP conv1/conv2
    (1, 1, 16, 20, 2, 384, 384),   # dark4 CSP conv3
    (1, 1, 8, 10, 2, 768, 768),    # dark5 CSP conv3
    (3, 2, 128, 160, 1, 48, 96),   # dark2 downsample
}


def should_fuse(ksize: int, stride: int, H: int, W: int,
                cins: Sequence[int], cout: int, mode: str = "auto") -> bool:
    """Fuse this site? ``cins``: the channel count of each concat piece.

    ``mode``: 'auto' (the table), 'always' or 'never'. Callers check that
    the site is a spiking 1x1 or 3x3 conv the kernels serve.
    """
    if mode not in FUSE_MODES:
        raise ValueError(f"fuse mode '{mode}' not in {FUSE_MODES}")
    if mode != "auto":
        return mode == "always"
    key = (ksize, stride, H, W, len(cins), sum(cins), cout)
    return key in _MEASURED_WINS
