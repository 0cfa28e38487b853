"""Image IO and geometry of the RGB pipeline without cv2 or PIL (the
port's counterparts of ``cv2.imread``, ``cv2.resize``,
``cv2.warpAffine`` and ``cv2.getRotationMatrix2D``, which the JAX
package's ``data/coco.py`` and ``data/mosaic.py`` call).

``imread(path)`` reads a JPEG or a PNG by its signature, not its name
(cv2 does the same: a VOC tree's ``.jpg`` may hold PNG bytes), and
returns cv2's (H, W, 3) uint8 BGR. JPEGs go through the host C++ core
``imgcore/imgcore.cpp``: baseline, extended-sequential and progressive
Huffman (spectral selection and successive approximation, the scans'
coefficients gathered over the whole image before one IDCT), 8-bit,
one, three or four components (CMYK and YCCK, turned into BGR as cv2
turns them), sampling factors 1 and 2 (4:4:4, 4:2:2, 4:4:0, 4:2:0;
other integral ratios as boxes), restart intervals, EXIF orientation;
the pixels are libjpeg-turbo's (islow IDCT, fancy upsampling, its YCbCr
tables), as ``cv2.imread`` gives them. An arithmetic-coded, lossless,
hierarchical or 12-bit JPEG, a truncated or corrupt one and any other
format raise ``ValueError`` naming the file and the mode. PNGs go
through ``utils/png.py:read_png``; a grey image comes back as three
equal channels.

``resize_linear_u8`` and ``warp_affine_u8`` run in the same core and
equal OpenCV's uint8 INTER_LINEAR results bit for bit; their numpy
versions (``*_plain``) spell out the same arithmetic and serve the tests.

The core is compiled by ``g++`` at first use into the port's build
directory (``ops/_build.py:host_library``); a failed build raises.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Sequence, Tuple

import numpy as np

from ..ops._build import host_library
from ..utils.png import read_png

__all__ = ["imread", "resize_linear_u8", "warp_affine_u8",
           "rotation_matrix_2d", "resize_linear_u8_plain",
           "warp_affine_u8_plain", "load_native"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "imgcore",
                    "imgcore.cpp")
_PNG = b"\x89PNG\r\n\x1a\n"
_JPEG = b"\xff\xd8\xff"
_ERRLEN = 256


def load_native() -> ctypes.CDLL:
    """The loaded core, built on first use."""
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
    i, ll, s = ctypes.c_int, ctypes.c_longlong, ctypes.c_char_p
    return host_library(_SRC, "imgcore", {
        "jpeg_header": (i, [u8, ll, i32, s, i]),
        "jpeg_decode": (i, [u8, ll, u8, i32, s, i]),
        "resize_linear_u8": (None, [u8, i, i, i, u8, i, i]),
        "warp_affine_u8": (None, [u8, i, i, i, u8, i, i, f64, i]),
        "png_unfilter": (i, [u8, i, ll, i, u8]),
    })


_MODES = {1: "unsupported JPEG", 2: "truncated JPEG", 3: "corrupt JPEG"}


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's EXIF orientation (imgcodecs ApplyExifOrientation): 2 flips
    left-right, 3 rotates 180, 4 flips up-down, 5 transposes, 6-8
    transpose and then flip as 2-4."""
    if orientation >= 5:
        img = img.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    axes = flip.get(orientation, ())
    if axes:
        img = np.flip(img, axes)
    return np.ascontiguousarray(img)


def _read_jpeg(data: bytes, path: str) -> np.ndarray:
    lib = load_native()
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(4, np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = lib.jpeg_header(buf, len(buf), info, err, _ERRLEN)
    if rc == 0:
        h, w = int(info[0]), int(info[1])
        out = np.empty((h, w, 3), np.uint8)
        rc = lib.jpeg_decode(buf, len(buf), out, info, err, _ERRLEN)
    if rc != 0:
        raise ValueError(f"{path}: {_MODES.get(rc, 'JPEG')}: "
                         f"{err.value.decode(errors='replace')}")
    return _orient(out, int(info[3]))


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path)``: (H, W, 3) uint8 BGR. Raises ``ValueError``
    (naming the file) where cv2 would return None or where the port does
    not read the file's mode."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_JPEG):
        return _read_jpeg(data, path)
    if data.startswith(_PNG):
        img = read_png(path)
        return np.repeat(img[..., None], 3, 2) if img.ndim == 2 else img
    raise ValueError(f"{path}: not a JPEG or a PNG file (the port reads "
                     "these two formats)")


def _u8(img: np.ndarray) -> Tuple[np.ndarray, int]:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected a uint8 (H, W[, C]) image, got "
                         f"{img.dtype} {img.shape}")
    return img, 1 if img.ndim == 2 else img.shape[2]


def resize_linear_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` on a
    uint8 image, ``size`` = (w, h)."""
    img, cn = _u8(img)
    ow, oh = int(size[0]), int(size[1])
    if ow <= 0 or oh <= 0:
        raise ValueError(f"resize_linear_u8: bad size {size}")
    out = np.empty((oh, ow) + img.shape[2:], np.uint8)
    load_native().resize_linear_u8(img, img.shape[0], img.shape[1], cn, out,
                                   oh, ow)
    return out


def warp_affine_u8(img: np.ndarray, M: np.ndarray, size: Tuple[int, int],
                   border: int = 114) -> np.ndarray:
    """``cv2.warpAffine(img, M, dsize=size, borderValue=(border,) * 3)``
    (INTER_LINEAR, BORDER_CONSTANT) on a uint8 image, ``size`` = (w, h)."""
    img, cn = _u8(img)
    ow, oh = int(size[0]), int(size[1])
    m = np.ascontiguousarray(np.asarray(M, np.float64).reshape(6))
    out = np.empty((oh, ow) + img.shape[2:], np.uint8)
    load_native().warp_affine_u8(img, img.shape[0], img.shape[1], cn, out, oh,
                                 ow, m, int(border))
    return out


def rotation_matrix_2d(center: Sequence[float], angle: float,
                       scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: (2, 3) float64;
    the centre is single precision, as OpenCV's Point2f."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]],
                    np.float64)


# ---- the plain versions (numpy; the tests' second oracle) -------------------

def resize_linear_u8_plain(img: np.ndarray,
                           size: Tuple[int, int]) -> np.ndarray:
    """``resize_linear_u8`` in numpy."""
    img, cn = _u8(img)
    squeeze = img.ndim == 2
    src = img.reshape(img.shape[0], img.shape[1], cn).astype(np.int64)
    ih, iw = src.shape[:2]
    ow, oh = int(size[0]), int(size[1])
    sx, sy = 1.0 / (ow / iw), 1.0 / (oh / ih)
    eps = np.finfo(np.float64).eps
    if (abs(sx - round(sx)) < eps and abs(sy - round(sy)) < eps
            and round(sx) == 2 and round(sy) == 2):
        o = (src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2]
             + src[1::2, 1::2] + 2) >> 2
        out = o[:oh, :ow].astype(np.uint8)
        return out[..., 0] if squeeze else out

    def coefs(n: int, scale: float):
        f = ((np.arange(n) + 0.5) * scale - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        return s, (f - s.astype(np.float32)).astype(np.float32)

    def fixed(f):
        one = np.float32(2048)
        return (np.rint((np.float32(1) - f) * one).astype(np.int64),
                np.rint(f * one).astype(np.int64))

    xs, fx = coefs(ow, sx)
    fx[xs < 0] = 0
    xs[xs < 0] = 0
    big = xs >= iw - 1
    fx[big], xs[big] = 0, iw - 1
    a0, a1 = fixed(fx)
    hor = (src[:, xs] * a0[None, :, None]
           + src[:, np.minimum(xs + 1, iw - 1)] * a1[None, :, None])
    ys, fy = coefs(oh, sy)
    b0, b1 = fixed(fy)
    h0 = hor[np.clip(ys, 0, ih - 1)].reshape(oh, -1)
    h1 = hor[np.clip(ys + 1, 0, ih - 1)].reshape(oh, -1)

    def mulhi(h, b):
        return (np.clip(h >> 4, -32768, 32767) * b[:, None]) >> 16

    out = np.clip((mulhi(h0, b0) + mulhi(h1, b1) + 2) >> 2, 0, 255)
    out = out.astype(np.uint8).reshape(oh, ow, cn)
    return out[..., 0] if squeeze else out


def _fma32(a, b, c) -> np.ndarray:
    """Correctly rounded float32 a * b + c: the exact product in float64,
    the sum rounded to odd in float64 (an error-free sum), then to
    float32."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64)
               for v in (a, b, c))
    p = a * b
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    bits = s.view(np.int64)
    odd_fix = (err != 0) & (bits & 1 == 0) & np.isfinite(s)
    s = np.where(odd_fix, np.nextafter(s, s + err), s)
    return s.astype(np.float32)


def _affine_inverse(M: np.ndarray) -> np.ndarray:
    m = np.asarray(M, np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0] = a11
    m[1] *= -d
    m[3] *= -d
    m[4] = a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def warp_affine_u8_plain(img: np.ndarray, M: np.ndarray,
                         size: Tuple[int, int],
                         border: int = 114) -> np.ndarray:
    """``warp_affine_u8`` in numpy."""
    img, cn = _u8(img)
    squeeze = img.ndim == 2
    src = img.reshape(img.shape[0], img.shape[1], cn)
    ih, iw = src.shape[:2]
    ow, oh = int(size[0]), int(size[1])
    f = _affine_inverse(M).astype(np.float32)
    xs = np.broadcast_to(np.arange(ow, dtype=np.float32)[None], (oh, ow))
    ys = np.arange(oh, dtype=np.float32)[:, None]
    yx = np.broadcast_to((ys * f[1]).astype(np.float32), (oh, ow))
    yy = np.broadcast_to((ys * f[4]).astype(np.float32), (oh, ow))
    # OpenCV's vector loop (16 columns a group) and its scalar tail
    vec = np.arange(ow)[None] < ow // 16 * 16
    sx = np.where(vec, _fma32(f[0], xs, yx + f[2]),
                  _fma32(xs, f[0], yx) + f[2])
    sy = np.where(vec, _fma32(f[3], xs, yy + f[5]),
                  _fma32(xs, f[3], yy) + f[5])
    fx, fy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    ix = np.clip(fx, -4, iw + 4).astype(np.int64)
    iy = np.clip(fy, -4, ih + 4).astype(np.int64)

    def tap(dy, dx):
        yy, xx = iy + dy, ix + dx
        ok = (yy >= 0) & (yy < ih) & (xx >= 0) & (xx < iw)
        px = src[np.clip(yy, 0, ih - 1), np.clip(xx, 0, iw - 1)]
        return np.where(ok[..., None], px, border).astype(np.float32)

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    v0 = _fma32(ax, p01 - p00, p00)
    v1 = _fma32(ax, p11 - p10, p10)
    v = _fma32(ay, v1 - v0, v0)
    out = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return out[..., 0] if squeeze else out
