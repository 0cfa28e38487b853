"""Space-to-depth packing of the sampler's small-channel stencil convs
(counterpart of ``eas_snn_tpu/ops/pack.py``), NCHW.

The ARSNN sampler's convs take 2 channels in and give 4 out. Packing
b x b pixel blocks into channels turns each k x k stencil into a 3 x 3
conv over (H/b, W/b) blocks with b*b*ci -> b*b*co channels, whose weights
route each original tap between block positions, so that the packed conv
computes exactly the original stencil (zero padding included, a zero
block being b zero rows or columns, while k // 2 <= b):

    out[co, y, x] = sum_{ci, dy, dx} w[co, ci, dy, dx] in[ci, y+dy-p, x+dx-p]

The channel order within a packed pixel is channel-major, packed index
= c * b*b + (by * b + bx), as in the JAX package: the scan splits its conv
outputs into gate and current halves along channels, and channel-major
packing keeps the original halves as the packed halves. The weight
transform is a gather of the original weights (with zeros where no tap
routes), so it is differentiable and the packed scan trains.

The layouts are the port's: (..., C, H, W) activations and (co, ci, kh,
kw) weights, where the JAX package's are (..., H, W, C) and (kh, kw, ci,
co); the values are the same.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["packable", "space_to_depth", "depth_to_space",
           "pack_conv_kernel", "pack_bias"]


def packable(H: int, W: int, ksize: int, block: int) -> bool:
    """Whether b x b blocks tile (H, W) and a k x k stencil reaches no
    further than the neighbouring block."""
    return H % block == 0 and W % block == 0 and ksize // 2 <= block


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """(..., C, H, W) -> (..., C*b*b, H/b, W/b), channel-major."""
    *lead, C, H, W = x.shape
    b, n = block, len(lead)
    x = x.reshape(*lead, C, H // b, b, W // b, b)
    # lead, C, Hb, by, Wb, bx -> lead, C, by, bx, Hb, Wb
    x = x.permute(*range(n), n, n + 2, n + 4, n + 1, n + 3)
    return x.reshape(*lead, C * b * b, H // b, W // b)


def depth_to_space(x: torch.Tensor, block: int, channels: int
                   ) -> torch.Tensor:
    """The inverse of :func:`space_to_depth`: (..., C*b*b, Hb, Wb) ->
    (..., C, Hb*b, Wb*b)."""
    *lead, _, Hb, Wb = x.shape
    b, n = block, len(lead)
    x = x.reshape(*lead, channels, b, b, Hb, Wb)
    # lead, C, by, bx, Hb, Wb -> lead, C, Hb, by, Wb, bx
    x = x.permute(*range(n), n, n + 3, n + 1, n + 4, n + 2)
    return x.reshape(*lead, channels, Hb * b, Wb * b)


def _pack_index(ksize: int, ci: int, co: int, block: int) -> np.ndarray:
    """For every element of the packed (b*b*co, b*b*ci, 3, 3) kernel the
    flat index of the original (co, ci, k, k) tap routed there, or
    co*ci*k*k (a zero) where none is (JAX ``_pack_index_map``)."""
    p, b = ksize // 2, block
    idx = np.full((b * b * co, b * b * ci, 3, 3), co * ci * ksize * ksize,
                  np.int64)
    for by in range(b):
        for bx in range(b):
            for dy in range(ksize):
                for dx in range(ksize):
                    oy, ox = by + dy - p, bx + dx - p
                    sy, sx = oy // b, ox // b    # block shift in {-1, 0, 1}
                    iy, ix = oy - sy * b, ox - sx * b
                    for c_in in range(ci):
                        for c_out in range(co):
                            idx[c_out * b * b + by * b + bx,
                                c_in * b * b + iy * b + ix,
                                sy + 1, sx + 1] = (
                                ((c_out * ci + c_in) * ksize + dy) * ksize
                                + dx)
    return idx


_INDEX: Dict[Tuple[int, int, int, int, str],
             Tuple[torch.Tensor, torch.Tensor]] = {}


def _index(ksize: int, ci: int, co: int, block: int, device: torch.device
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_pack_index` on ``device``, and its inverse: for each
    original tap the b*b flat positions of the packed kernel it routes to
    (every tap routes to one position a block position). Kept (made once
    a geometry and device, so that a CUDA graph captured after a first
    eager call copies nothing to the card)."""
    key = (ksize, ci, co, block, str(device))
    if key not in _INDEX:
        idx = _pack_index(ksize, ci, co, block).reshape(-1)
        taps = co * ci * ksize * ksize
        order = np.argsort(idx, kind="stable")[: taps * block * block]
        routes = order.reshape(taps, block * block)
        assert (idx[routes] == np.arange(taps)[:, None]).all()
        _INDEX[key] = (torch.from_numpy(idx).to(device),
                       torch.from_numpy(routes).to(device))
    return _INDEX[key]


class _Route(torch.autograd.Function):
    """The packed kernel as a gather of the flat weights (a zero past
    them); its backward sums each tap's b*b routes by a gather and a sum
    in a fixed order, not a scatter-add, so that a step's weight gradients
    are the same bits at every run."""

    @staticmethod
    def forward(ctx, flat, idx, routes):
        ctx.save_for_backward(routes)
        return torch.cat([flat, flat.new_zeros(1)])[idx]

    @staticmethod
    def backward(ctx, g):
        (routes,) = ctx.saved_tensors
        return g.reshape(-1)[routes].sum(1), None, None


def pack_conv_kernel(k: torch.Tensor, block: int) -> torch.Tensor:
    """(co, ci, k, k) -> (b*b*co, b*b*ci, 3, 3) packed weights: a gather
    of ``k`` (differentiable; its gradient sums each tap's routes)."""
    co, ci, kh, _ = k.shape
    idx, routes = _index(kh, ci, co, block, k.device)
    b2 = block * block
    return _Route.apply(k.reshape(-1), idx, routes).reshape(
        b2 * co, b2 * ci, 3, 3)


def pack_bias(bias: torch.Tensor, block: int) -> torch.Tensor:
    """(co,) -> (co*b*b,), channel-major: every block position of a
    channel gets its bias (an expand, whose gradient is a sum in a fixed
    order)."""
    return bias[:, None].expand(-1, block * block).reshape(-1)
