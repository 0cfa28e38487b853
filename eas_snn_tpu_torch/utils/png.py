"""PNG files from and to uint8 numpy images, on the standard library's
``zlib`` and ``struct`` (the port's stand-in for the JAX package's
``cv2.imwrite`` / ``cv2.imread`` of PNGs).

``write_png`` writes an (H, W, 3) BGR image (the channel order the
drawing functions carry, as OpenCV's) as 8-bit RGB, and an (H, W) image
as 8-bit grey: non-interlaced, every row under filter 0 (none), one IDAT
chunk compressed at zlib's level 1 (OpenCV's default for PNGs, zlib's
fastest).

``read_png`` reads non-interlaced 8-bit grey, RGB, grey + alpha and RGBA
and 1-, 2-, 4- or 8-bit palette PNGs, under any of PNG's row filters
(None, Sub, Up, Average, Paeth; cv2 and most tools write filtered rows)
and over any number of IDAT chunks, and returns what ``cv2.imread`` with
``IMREAD_COLOR`` gives before its grey-to-BGR step: (H, W, 3) BGR, or
(H, W) for grey, the alpha dropped as cv2 drops it. Rows under filters
1-4 are undone by the port's host core (``data/imgcore``, built by g++
at first use); a file of unfiltered rows needs no build. Anything else
raises ``ValueError`` naming the file and the mode: a chunk whose CRC
is wrong, a truncated file, another bit depth or colour type (16-bit,
grey below 8 bits), interlacing, a filter type past 4, a palette index
past the palette.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["write_png", "read_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GREY, _RGB, _PALETTE, _GREY_ALPHA, _RGBA = 0, 2, 3, 4, 6  # colour types
# samples a pixel of each colour type
_CHANNELS = {_GREY: 1, _RGB: 3, _PALETTE: 1, _GREY_ALPHA: 2, _RGBA: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path: str, img: np.ndarray) -> None:
    """Write ``img``, uint8 (H, W, 3) BGR or (H, W) grey, to ``path``."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 3:
        kind, rows = _RGB, img[..., ::-1]
    elif img.ndim == 2:
        kind, rows = _GREY, img
    else:
        raise ValueError(f"write_png takes (H, W, 3) or (H, W) images, not "
                         f"{img.shape}")
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        raise ValueError(f"write_png: an empty image {img.shape}")
    raw = np.empty((h, 1 + rows[0].size), np.uint8)
    raw[:, 0] = 0  # filter type 0 (None) on every row
    raw[:, 1:] = rows.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, kind, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """The uint8 image in ``path``: (H, W, 3) BGR for RGB(A) and palette
    images, (H, W) for grey (with or without alpha). Raises
    ``ValueError`` on a file this module does not read."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat, ended, plte = len(_SIGNATURE), None, [], False, None
    while pos < len(buf):
        if pos + 8 > len(buf):
            raise ValueError(f"{path}: truncated chunk header")
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        end = pos + 8 + n
        if end + 4 > len(buf):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        data = buf[pos + 8:end]
        (crc,) = struct.unpack(">I", buf[end:end + 4])
        if crc != zlib.crc32(kind + data):
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        pos = end + 4
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"PLTE":
            plte = data
        elif kind == b"IEND":
            ended = True
            break
        elif not kind[:1].islower():
            raise ValueError(f"{path}: unsupported critical chunk {kind!r}")
    if header is None or not idat or not ended:
        raise ValueError(f"{path}: IHDR, IDAT or IEND missing")
    w, h, depth, kind, compression, filt, interlace = header
    if (kind not in _CHANNELS or (kind == _PALETTE and depth not in (1, 2, 4, 8))
            or (kind != _PALETTE and depth != 8)):
        raise ValueError(f"{path}: bit depth {depth}, colour type {kind}: "
                         "only 8-bit grey, RGB, grey + alpha and RGBA and "
                         "1- to 8-bit palette images are read")
    if compression or filt or interlace:
        raise ValueError(f"{path}: compression {compression}, filter "
                         f"method {filt}, interlace {interlace}: only 0, 0, "
                         "0 (non-interlaced) are read")
    channels = _CHANNELS[kind]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    stride = -(-w * channels * depth // 8)
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data, "
                         f"expected {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    filters = np.unique(rows[:, 0])
    if filters.max() > 4:
        raise ValueError(f"{path}: row filters {filters.tolist()}: PNG's "
                         "filter types are 0-4")
    if filters.any():
        from ..data.image import load_native

        img = np.empty((h, stride), np.uint8)
        load_native().png_unfilter(np.ascontiguousarray(rows), h, stride,
                                   max(1, channels * depth // 8), img)
    else:
        img = rows[:, 1:]
    if kind == _PALETTE:
        return _palette_bgr(img, w, depth, plte, path)
    img = img.reshape(h, w, channels)
    if kind in (_GREY, _GREY_ALPHA):
        return img[..., 0].copy()
    return img[..., 2::-1].copy()


def _palette_bgr(idx: np.ndarray, w: int, depth: int, plte, path: str
                 ) -> np.ndarray:
    """(H, stride) packed palette indices -> (H, W, 3) BGR."""
    if plte is None or len(plte) % 3 or not plte:
        raise ValueError(f"{path}: a palette image without a valid PLTE "
                         "chunk")
    if depth < 8:
        bits = np.unpackbits(idx, axis=1).reshape(idx.shape[0], -1, depth)
        idx = bits @ (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    idx = idx[:, :w]
    pal = np.frombuffer(plte, np.uint8).reshape(-1, 3)
    if idx.max() >= len(pal):
        raise ValueError(f"{path}: palette index {int(idx.max())} past the "
                         f"{len(pal)} entries of PLTE")
    return pal[idx][..., ::-1].copy()
