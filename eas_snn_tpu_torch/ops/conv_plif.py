"""Whole-site conv + folded BatchNorm + PLIF for eval, int8 spikes out
(counterpart of ``eas_snn_tpu/ops/conv_plif_pallas.py``).

At eval the BN folds into the conv: w_f = w * mul in f32, rounded to bf16
for the multiply, and bias_f = beta - mean * mul in f32, with
mul = rsqrt(var + eps) * scale. The site then computes, per time step,
acc = bias_f + sum(bf16 w_f * bf16 x) in f32 and runs the PLIF recurrence
on acc, so the preactivation never reaches device memory.

Three ops, each a CUDA kernel on CUDA tensors and its plain PyTorch
version on CPU tensors (each registered as a ``torch.library`` op of the
``eas_snn`` namespace, ``ops/library.py``; the wrappers here check their
arguments and call the op on either device):

* ``conv1x1_plif``: 1x1 conv over a virtual channel concat of up to 4
  pieces (``csrc/conv_wgmma.cu``, wgmma);
* ``conv3x3_plif``: 3x3, stride 1, pad 1 (``csrc/conv_wgmma.cu``, wgmma);
* ``conv3x3s2_plif``: 3x3, stride 2, pad 1; output (h, w) taps input
  (2h+dy-1, 2w+dx-1) (``csrc/conv_wgmma.cu``, wgmma).

All take int8, bf16 or f32 inputs in (T*B, C, H, W) layout. On the card
every input's channel count must be a multiple of 8 and its address
16-byte aligned. The 1x1 kernel copies each channel's pixels in 16-byte
pieces that never span two images, so H*W must fill whole 16-byte
copies; the 3x3 kernels (both strides) copy whole 4-byte row segments,
so W must be a whole number of them. The kernels keep one chunk of the
output channels' weights resident in shared memory (:func:`conv_plan`
picks the chunks, and raises where even the narrowest does not fit). The
wrappers raise otherwise. Every flagship site fits.

The plain versions multiply bf16 values held in f32, so their products
are exact; they run the convolution with TF32 off all the same, so that a
plain version on the card sums in full f32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from . import _build
from .plif import decay_multiplier, plif_forward_plain, plif_spikes_plain
from .surrogate import spike_ge

__all__ = [
    "fold_bn",
    "fold_conv1x1",
    "fold_conv3x3",
    "conv1x1_preact_plain",
    "conv3x3_preact_plain",
    "conv1x1_plif_plain",
    "conv3x3_plif_plain",
    "conv1x1_plif",
    "conv3x3_plif",
    "conv3x3s2_plif",
    "ConvPlan",
    "conv_plan",
    "layout_refusal",
    "wgmma_smem_bytes",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
Pieces = Union[torch.Tensor, Sequence[torch.Tensor]]


def fold_bn(scale, bias, mean, var, eps: float = 1e-3
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BN as (mul, bias_f): y = (x - mean) * mul + bias = x * mul +
    bias_f, all in f32."""
    mul = torch.rsqrt(var.float() + eps) * scale.float()
    return mul, bias.float() - mean.float() * mul


def fold_conv1x1(kernel: torch.Tensor, mul: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 1, 1) kernel * per-Cout mul -> (Cout, Cin) f32."""
    return kernel[:, :, 0, 0].float() * mul.float()[:, None]


def fold_conv3x3(kernel: torch.Tensor, mul: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) kernel * per-Cout mul -> (3, Cout, 3*Cin) f32,
    the last axis ordered (dx, ci): the JAX ``fold_conv3x3`` layout."""
    k = kernel.float() * mul.float()[:, None, None, None]
    k = k.permute(2, 0, 3, 1)  # (co, ci, dy, dx) -> (dy, co, dx, ci)
    return k.reshape(3, k.shape[1], -1).contiguous()


def _pieces(x: Pieces) -> Tuple[torch.Tensor, ...]:
    xs = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    if not 1 <= len(xs) <= 4:
        raise ValueError(f"1 to 4 concat pieces supported, got {len(xs)}")
    TB, _, H, W = xs[0].shape
    for p in xs:
        if p.dim() != 4 or p.shape[0] != TB or p.shape[2:] != (H, W):
            raise ValueError("concat pieces must share (T*B, H, W)")
        if p.dtype != xs[0].dtype or p.device != xs[0].device:
            raise ValueError("concat pieces must share dtype and device")
        if p.dtype not in _DTYPE_CODE:
            raise ValueError(f"unsupported input dtype {p.dtype}")
    return xs


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """The bf16 multiply operand, held in f32."""
    return x.to(torch.bfloat16).float()


def conv1x1_preact_plain(x: Pieces, w_oc: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """acc = bias + sum_j (bf16 w_j @ bf16 x_j), f32, (T*B, Cout, H, W)."""
    xs = _pieces(x)
    w16 = _bf16(w_oc)
    acc = bias.float()[None, :, None, None]
    off = 0
    for p in xs:
        c = p.shape[1]
        acc = acc + torch.einsum("oc,nchw->nohw", w16[:, off:off + c],
                                 _bf16(p))
        off += c
    return acc


def conv3x3_preact_plain(x: torch.Tensor, w3: torch.Tensor,
                         bias: torch.Tensor, stride: int) -> torch.Tensor:
    """acc = bias + conv3x3(bf16 x, bf16 w), f32, pad 1."""
    cout = w3.shape[1]
    k = w3.reshape(3, cout, 3, -1).permute(1, 3, 0, 2)  # -> (co, ci, dy, dx)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(_bf16(x), _bf16(k), stride=stride, padding=1)
    return y + bias.float()[None, :, None, None]


def conv1x1_plif_plain(x: Pieces, w_oc, bias, T: int, w_plif,
                       thresh: float = 1.0, kind: str = "atan"):
    return plif_forward_plain(conv1x1_preact_plain(x, w_oc, bias), T, w_plif,
                              thresh, kind)


def conv3x3_plif_plain(x, w3, bias, T: int, w_plif, stride: int = 1,
                       thresh: float = 1.0, kind: str = "atan"):
    return plif_forward_plain(conv3x3_preact_plain(x, w3, bias, stride), T,
                              w_plif, thresh, kind)


# ------------------------------------------------ the wgmma kernels' plan
# Constants of csrc/conv_wgmma.cu: the wgmma widths instantiated (N), the
# shared memory a block may use and the pixels of a tile (M).
WGMMA_WIDTHS = (32, 48, 64, 96)
SMEM_LIMIT = 232_448
M_TILE = 64
H100_SMS = 132


def s2_copy_bytes(W: int, itemsize: int) -> int:
    """Bytes a copy of the stride-2 kernel's producers: 16 where an input
    row is a whole number of 16-byte copies (C3X3S2V), else 4."""
    return 16 if (W * itemsize) % 16 == 0 else 4


def _geo(ksize: int, itemsize: int, stride: int = 1,
         copy: int = 4) -> Tuple[int, ...]:
    """(taps, channels a K chunk, bf16 stages, bytes a bf16 stage, raw
    stages, bytes a raw stage, bytes a spike-stage row) of the source's
    Geo for ``itemsize``-byte inputs: C1X1, C3X3, or with ``stride`` 2
    C3X3S2 (``copy`` 4) and C3X3S2V (16)."""
    if ksize == 1:
        return (1, 64, 2, 8 * (M_TILE * 16 + 16), 4 if itemsize == 1 else 2,
                4096 * itemsize, M_TILE + 16)
    if stride == 2:
        # 16-channel chunks; four 9x9 parity planes a group of 8; 17 halo
        # rows of 16 + copy / itemsize elements
        raw_stages = 2 if itemsize == 4 else 3 if copy == 16 else 4
        return (9, 16, 2, 2 * 4 * 9 * 9 * 16, raw_stages,
                16 * 17 * (16 * itemsize + copy), 72)
    epc = 4 // itemsize  # elements a 4-byte copy
    kc = 16 if itemsize == 4 else 32
    row = (8 + 2 * epc) * itemsize
    return 9, kc, 2, kc // 8 * 10 * 10 * 16, 2, 10 * kc * row, 72


def _ceil(n: int, m: int) -> int:
    return -(-n // m)


def _r128(n: int) -> int:
    return _ceil(n, 128) * 128


class ConvPlan(NamedTuple):
    """How a wgmma conv kernel covers a site: blocks of ``grid_x`` x
    ``n_chunks``; block (x, y) owns output channels [y*chunk, (y+1)*chunk)
    (the last chunk clipped at Cout), multiplies them as one wgmma of
    width ``width`` >= chunk, and walks the 64-pixel tiles 2x + c +
    2*grid_x*i with its two consumer warpgroups c = 0, 1."""
    width: int
    chunk: int
    n_chunks: int
    k_pad: int
    smem: int
    n_tiles: int
    grid_x: int


def wgmma_smem_bytes(ksize: int, width: int, k_pad: int, itemsize: int,
                     stride: int = 1, copy: int = 4) -> int:
    """Dynamic shared memory of one block (``Smem`` in the source), each
    part 128-byte aligned: resident weights, bias, two bf16 rings, two raw
    rings, two spike stages, barriers."""
    taps, _, stages, stage, raw_stages, raw, out_ld = _geo(ksize, itemsize,
                                                           stride, copy)
    return (_r128(taps * k_pad * width * 2) + _r128(width * 4)
            + 2 * stages * stage + 2 * raw_stages * raw
            + _r128(2 * width * out_ld) + 2 * 2 * stages * 8)


@functools.lru_cache(maxsize=256)
def conv_plan(ksize: int, cins: Tuple[int, ...], cout: int, B: int, H: int,
              W: int, itemsize: int, num_sms: int = H100_SMS,
              stride: int = 1) -> ConvPlan:
    """The launch plan of the 1x1 (``ksize`` 1) or 3x3 (``stride`` 1 or 2)
    wgmma kernel at a site with (H, W) inputs; B is the batch without T,
    ``itemsize`` the input's bytes an element, K padded to whole K chunks
    in every piece. Takes the fewest output-channel chunks whose resident
    weights fit in shared memory, each chunk a multiple of 8 channels run
    at the narrowest wgmma width that holds it. Raises ValueError where
    even the narrowest does not fit."""
    if stride not in (1, 2) or (ksize == 1 and stride != 1):
        raise ValueError(f"no {ksize}x{ksize} kernel of stride {stride}")
    copy = s2_copy_bytes(W, itemsize) if stride == 2 else 4
    kc = _geo(ksize, itemsize, stride, copy)[1]
    k_pad = sum(_ceil(c, kc) * kc for c in cins)
    for n in range(1, _ceil(cout, 8) + 1):
        chunk = _ceil(_ceil(cout, n), 8) * 8
        width = next((w for w in WGMMA_WIDTHS if w >= chunk), None)
        if width is None:
            continue
        smem = wgmma_smem_bytes(ksize, width, k_pad, itemsize, stride, copy)
        if smem <= SMEM_LIMIT:
            break
    else:
        name = f"conv{ksize}x{ksize}{'s2' if stride == 2 else ''}_plif"
        raise ValueError(
            f"{name}: the kernel keeps a chunk of the "
            f"weights resident in shared memory, and {ksize * ksize} taps x "
            f"{k_pad} channels do not fit in {SMEM_LIMIT} bytes even for "
            f"{WGMMA_WIDTHS[0]} output channels")
    if ksize == 1:
        n_tiles = _ceil(B * H * W, M_TILE)
    else:
        ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
        n_tiles = B * _ceil(ho, 8) * _ceil(wo, 8)
    n_chunks = _ceil(cout, chunk)
    grid_x = max(1, min(_ceil(n_tiles, 2), num_sms // n_chunks))
    return ConvPlan(width, chunk, n_chunks, k_pad, smem, n_tiles, grid_x)


def _layout_refusal(xs: Sequence[torch.Tensor], row: int, copy: int,
                    what: str) -> Optional[str]:
    """Why the kernel's whole aligned copies do not cover every piece (C_j
    % 8 == 0, ``row`` elements a whole number of ``copy`` bytes, each
    piece 16-byte aligned), or None."""
    for p in xs:
        if p.shape[1] % 8 or (row * p.element_size()) % copy or \
                p.data_ptr() % 16:
            return (f"{what}: the kernel needs channels in 8s, rows of whole "
                    f"{copy}-byte copies and 16-byte aligned inputs; got "
                    f"{tuple(p.shape)} {p.dtype} at offset "
                    f"{p.data_ptr() % 16}")
    return None


def _check_layout(xs: Sequence[torch.Tensor], row: int, copy: int,
                  what: str) -> None:
    """Raise where :func:`_layout_refusal` gives a reason."""
    why = _layout_refusal(xs, row, copy, what)
    if why is not None:
        raise ValueError(why)


def layout_refusal(xs: Sequence[torch.Tensor], ksize: int,
                   stride: int = 1) -> Optional[str]:
    """Why the kernel of a ``ksize`` site would refuse the layout of the
    CUDA pieces ``xs`` (None where it takes them, and on the CPU, where
    the plain version takes any layout)."""
    if not xs[0].is_cuda:
        return None
    H, W = xs[0].shape[-2:]
    if ksize == 1:
        return _layout_refusal(xs, H * W, 16, "conv1x1_plif")
    name = "conv3x3_plif" if stride == 1 else "conv3x3s2_plif"
    return _layout_refusal(xs, W, 4, name)


def _operands(w: torch.Tensor, bias: torch.Tensor, w_plif: torch.Tensor,
              dev: torch.device, what: str):
    """The kernel's weight operands on ``dev``: bf16 weights, f32 bias and
    the f32 decay multiplier, each contiguous."""
    for t in (w, bias, w_plif):
        if t.device != dev:
            raise ValueError(f"{what}: weights on {t.device}, input on {dev}")
    return (w.to(torch.bfloat16).contiguous(),
            bias.to(torch.float32).contiguous(), decay_multiplier(w_plif))


def conv1x1_plif(x: Pieces, w_oc: torch.Tensor, bias: torch.Tensor, T: int,
                 w_plif: torch.Tensor, thresh: float = 1.0,
                 kind: str = "atan") -> torch.Tensor:
    """Fused 1x1 conv + folded BN + PLIF over a virtual concat of pieces
    (T*B, C_j, H, W); ``w_oc`` (Cout, sum C_j) from :func:`fold_conv1x1`.
    Returns (T*B, Cout, H, W) int8 spikes. Calls the registered op
    ``eas_snn::conv1x1_plif``: the kernel on CUDA tensors, the plain
    version on CPU ones."""
    xs = _pieces(x)
    TB, _, H, W = xs[0].shape
    cin = sum(p.shape[1] for p in xs)
    cout = w_oc.shape[0]
    if w_oc.shape != (cout, cin) or bias.shape != (cout,):
        raise ValueError(f"weights {tuple(w_oc.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit Cin={cin}")
    if TB % T:
        raise ValueError(f"leading dim {TB} is not a multiple of T={T}")
    return torch.ops.eas_snn.conv1x1_plif(list(xs), w_oc, bias, w_plif, T,
                                          float(thresh), spike_ge(kind))


def conv1x1_plif_cpu(xs, w_oc, bias, w_plif, T: int, thresh: float,
                     ge: bool):
    """The CPU implementation of ``eas_snn::conv1x1_plif``: the plain
    version."""
    return plif_spikes_plain(conv1x1_preact_plain(xs, w_oc, bias), T,
                             decay_multiplier(w_plif), None, thresh, ge)


def conv1x1_plif_cuda(xs, w_oc, bias, w_plif, T: int, thresh: float,
                      ge: bool):
    """The device implementation of ``eas_snn::conv1x1_plif``: the
    layout checks, the plan, the kernel's operands (:func:`_operands`)
    and one launch of ``csrc/conv_wgmma.cu``, counted in
    ``conv1x1_plif.launches``."""
    TB, _, H, W = xs[0].shape
    cout = w_oc.shape[0]
    for p in xs:
        _build.require_cuda(p, "conv1x1_plif")
    _check_layout(xs, H * W, 16, "conv1x1_plif")
    dev = xs[0].device
    plan = conv_plan(1, tuple(p.shape[1] for p in xs), cout, TB // T, H, W,
                     xs[0].element_size(), _build.sm_count(dev))
    w16, b32, a = _operands(w_oc, bias, w_plif, dev, "conv1x1_plif")
    out = torch.empty((TB, cout, H, W), dtype=torch.int8, device=dev)
    n = len(xs)
    ptrs = (ctypes.c_void_p * n)(*[p.data_ptr() for p in xs])
    cins = (ctypes.c_int * n)(*[p.shape[1] for p in xs])
    err = _build.get_lib("conv_wgmma").conv1x1_plif(
        ptrs, cins, n, w16.data_ptr(), b32.data_ptr(), a.data_ptr(),
        out.data_ptr(), TB // T, T, cout, H, W, plan.width, plan.chunk,
        plan.n_chunks, plan.grid_x, float(thresh), int(ge),
        _DTYPE_CODE[xs[0].dtype], _build.stream_ptr(dev),
    )
    _build.check(err, "conv1x1_plif")
    conv1x1_plif.launches += 1
    return out


def _conv3x3(x, w3, bias, T, w_plif, thresh, kind, stride, wrapper):
    what = wrapper.__name__
    if x.dim() != 4 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: expected (T*B, C, H, W) int8/bf16/f32")
    TB, cin, H, W = x.shape
    cout = w3.shape[1]
    if w3.shape != (3, cout, 3 * cin) or bias.shape != (cout,):
        raise ValueError(f"{what}: weights {tuple(w3.shape)} do not fit "
                         f"Cin={cin}")
    if TB % T:
        raise ValueError(f"leading dim {TB} is not a multiple of T={T}")
    return getattr(torch.ops.eas_snn, what)(x, w3, bias, w_plif, T,
                                            float(thresh), spike_ge(kind))


def conv3x3_plif_cpu(x, w3, bias, w_plif, T: int, thresh: float, ge: bool,
                     stride: int = 1):
    """The CPU implementation of ``eas_snn::conv3x3_plif`` (``stride`` 1)
    and ``eas_snn::conv3x3s2_plif`` (2): the plain version."""
    return plif_spikes_plain(conv3x3_preact_plain(x, w3, bias, stride), T,
                             decay_multiplier(w_plif), None, thresh, ge)


def conv3x3_plif_cuda(x, w3, bias, w_plif, T: int, thresh: float, ge: bool,
                      stride: int = 1):
    """The device implementation of ``eas_snn::conv3x3_plif`` and
    ``eas_snn::conv3x3s2_plif``: the layout checks, the plan, the
    kernel's operands and one launch of ``csrc/conv_wgmma.cu``, counted in
    the wrapper's ``launches``."""
    wrapper = conv3x3_plif if stride == 1 else conv3x3s2_plif
    what = wrapper.__name__
    TB, cin, H, W = x.shape
    cout = w3.shape[1]
    _build.require_cuda(x, what)
    dev = x.device
    _check_layout((x,), W, 4, what)
    plan = conv_plan(3, (cin,), cout, TB // T, H, W, x.element_size(),
                     _build.sm_count(dev), stride)
    w16, b32, a = _operands(w3, bias, w_plif, dev, what)
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    out = torch.empty((TB, cout, ho, wo), dtype=torch.int8, device=dev)
    err = getattr(_build.get_lib("conv_wgmma"), what)(
        x.data_ptr(), w16.data_ptr(), b32.data_ptr(), a.data_ptr(),
        out.data_ptr(), TB // T, T, cin, cout, H, W, plan.width, plan.chunk,
        plan.n_chunks, plan.grid_x, float(thresh), int(ge),
        _DTYPE_CODE[x.dtype], _build.stream_ptr(dev))
    _build.check(err, what)
    wrapper.launches += 1
    return out


def conv3x3_plif(x: torch.Tensor, w3: torch.Tensor, bias: torch.Tensor,
                 T: int, w_plif: torch.Tensor, thresh: float = 1.0,
                 kind: str = "atan") -> torch.Tensor:
    """Fused 3x3/stride-1 conv + folded BN + PLIF; ``w3`` (3, Cout, 3*Cin)
    from :func:`fold_conv3x3`. Returns (T*B, Cout, H, W) int8 spikes
    (the registered op ``eas_snn::conv3x3_plif``)."""
    return _conv3x3(x, w3, bias, T, w_plif, thresh, kind, 1, conv3x3_plif)


def conv3x3s2_plif(x: torch.Tensor, w3: torch.Tensor, bias: torch.Tensor,
                   T: int, w_plif: torch.Tensor, thresh: float = 1.0,
                   kind: str = "atan") -> torch.Tensor:
    """Fused 3x3/stride-2 conv + folded BN + PLIF. Returns
    (T*B, Cout, ceil(H/2), ceil(W/2)) int8 spikes (the registered op
    ``eas_snn::conv3x3s2_plif``)."""
    return _conv3x3(x, w3, bias, T, w_plif, thresh, kind, 2, conv3x3s2_plif)


conv1x1_plif.launches = 0
conv3x3_plif.launches = 0
conv3x3s2_plif.launches = 0
