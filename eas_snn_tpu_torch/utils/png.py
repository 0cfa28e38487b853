"""PNG files from and to uint8 numpy images, on the standard library's
``zlib`` and ``struct`` alone (the port's stand-in for the JAX package's
``cv2.imwrite`` / ``cv2.imread`` of PNGs).

``write_png`` writes an (H, W, 3) BGR image (the channel order the
drawing functions carry, as OpenCV's) as 8-bit RGB, and an (H, W) image
as 8-bit grey: non-interlaced, every row under filter 0 (none), one IDAT
chunk compressed at zlib's level 1 (OpenCV's default for PNGs, zlib's
fastest). ``read_png`` reads what ``write_png`` writes and returns
(H, W, 3) BGR or (H, W) grey; anything else raises ``ValueError``: a
chunk whose CRC is wrong, a truncated file, another bit depth or colour
type, interlacing, a row filter other than 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["write_png", "read_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GREY, _RGB = 0, 2  # PNG colour types


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
    """The uint8 image in ``path``: (H, W, 3) BGR for RGB, (H, W) for grey.
    Raises ``ValueError`` on a file this module does not read."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat, ended = len(_SIGNATURE), None, [], False
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
        elif kind == b"IEND":
            ended = True
            break
        elif not kind[:1].islower():
            raise ValueError(f"{path}: unsupported critical chunk {kind!r}")
    if header is None or not idat or not ended:
        raise ValueError(f"{path}: IHDR, IDAT or IEND missing")
    w, h, depth, kind, compression, filt, interlace = header
    if depth != 8 or kind not in (_GREY, _RGB):
        raise ValueError(f"{path}: bit depth {depth}, colour type {kind}: "
                         "only 8-bit grey and RGB are read")
    if compression or filt or interlace:
        raise ValueError(f"{path}: compression {compression}, filter "
                         f"method {filt}, interlace {interlace}: only 0, 0, "
                         "0 (non-interlaced) are read")
    channels = 3 if kind == _RGB else 1
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    stride = w * channels
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data, "
                         f"expected {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    filters = np.unique(rows[:, 0])
    if filters.any():
        raise ValueError(f"{path}: row filters {filters.tolist()}: only "
                         "filter 0 (none) is read")
    img = rows[:, 1:]
    if channels == 1:
        return img.copy()
    return img.reshape(h, w, 3)[..., ::-1].copy()
