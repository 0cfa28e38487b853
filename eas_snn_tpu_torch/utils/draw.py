"""Raster primitives on uint8 numpy images, with OpenCV's pixels, without
OpenCV (the port's stand-ins for the ``cv2.rectangle``, ``cv2.circle``,
``cv2.getTextSize`` and ``cv2.putText`` calls of the JAX package's
``utils/visualize.py``, ``utils/assign_viz.py`` and
``tools/play_events.py``).

Points are (x, y) integers; a colour is a tuple of one value a channel
(BGR on a 3-channel image) or a scalar on an (H, W) one; everything is
clipped to the image, so corners may lie off it.

- ``rectangle``: OpenCV's 8-connected outline at thickness 1; at
  thickness 2 OpenCV draws each side as a band three pixels wide, ended
  by a filled circle of radius 1 at the corner it runs to (its thick-line
  rule), so the band's four outer corner pixels stay blank; thickness
  -1 fills. Corners may come in any order.
- ``circle``: OpenCV's filled integer circle (its Bresenham variant:
  radius 1 a plus, radius 2 a diamond).
- ``text_size``: ``cv2.getTextSize(label, FONT_HERSHEY_SIMPLEX, scale,
  1)`` at the two scales the drawing uses, 0.4 and 0.35, from OpenCV's
  per-character advances and descents there (OpenCV 5's text engine: a
  label's width is the sum of its characters' advances plus one, its
  height one value a scale, its baseline the largest descent).
- ``put_text``: the label in a 5x7 bitmap font of the port's own, one
  glyph at each of OpenCV's character positions, inside the label's
  footprint (``text_size``). OpenCV's glyphs are antialiased outlines
  compiled into its library; the port's differ from them by design and
  only the footprint is OpenCV's.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

__all__ = ["rectangle", "circle", "text_size", "put_text"]

Color = Union[int, Sequence[int]]

# cv2.getTextSize(c, FONT_HERSHEY_SIMPLEX, scale, 1) of each printable
# ASCII character (' ' .. '~'), written as chr(48 + n): its advance (the
# width of a label grows by it) and its descent below the baseline
_ADVANCE = {
    0.4: "32487882775725257777777777335656977787688377698777776879777353583"
         "676764772262:76774647696654246",
    0.35: "2236576255452424555555555522454586666556626557666665566766534347"
          "3555553552242855553435575543235",
}
_DESCENT = {
    0.4: "00002110220010011001011010010000200100010010000101010100000212010"
         "111110300300001330101000302320",
    0.35: "0000111022001001100101101001000020010001001000010101010000021201"
          "0111110300200001220101000202220",
}
_HEIGHT = {0.4: 11, 0.35: 9}  # round(27 * scale)

# 5x7 glyphs of ' ' .. '~': five column bytes each, bit 0 the top row,
# bit 6 the baseline row
_FONT = bytes.fromhex(
    "000000000000005f00000007000700147f147f14242a7f2a1223130864623649552250"
    "0005030000001c2241000041221c00142a1c2a1408083e080800503000000808080808"
    "006060000020100804023e5149453e00427f4000426151494621414b4d311814127f10"
    "27454545393c4a49493001710905033649494936064949291e00363600000056360000"
    "0814224100141414141400412214080201510906324979413e7e1111117e7f49494936"
    "3e414141227f4141221c7f494949417f090901013e414951327f0808087f00417f4100"
    "2040413f017f081422417f404040407f020c027f7f0408107f3e4141413e7f09090906"
    "3e4151215e7f09192946464949493101017f01013f4040403f1f2040201f3f4038403f"
    "631408146307087008076151494543007f41410002040810200041417f000402010204"
    "4040404040000102040020545454787f484444383844444420384444487f3854545418"
    "087e0901020c5252523e7f0804047800447d40002040443d007f1028440000417f4000"
    "7c041804787c0804047838444444387c14141408081414187c7c080404084854545420"
    "043f4440203c4040207c1c2040201c3c4030403c44281028440c5050503c4464544c44"
    "000836410000007f000000413608000201020402")
_GLYPHS = (np.unpackbits(np.frombuffer(_FONT, np.uint8).reshape(95, 5, 1),
                         axis=2, bitorder="little")[..., :7]
           .transpose(0, 2, 1).astype(bool))  # (95, 7 rows, 5 columns)


def _fill(img: np.ndarray, x0: int, y0: int, x1: int, y1: int,
          color: Color) -> None:
    """The inclusive box [x0, x1] x [y0, y1], clipped to ``img``."""
    h, w = img.shape[:2]
    x0, y0 = max(int(x0), 0), max(int(y0), 0)
    x1, y1 = min(int(x1), w - 1), min(int(y1), h - 1)
    if x0 <= x1 and y0 <= y1:
        img[y0:y1 + 1, x0:x1 + 1] = color


def rectangle(img: np.ndarray, pt1: Tuple[int, int], pt2: Tuple[int, int],
              color: Color, thickness: int = 1) -> np.ndarray:
    """``cv2.rectangle(img, pt1, pt2, color, thickness)`` in place for
    thickness 1, 2 or a negative one (filled); returns ``img``."""
    x1, y1 = (int(v) for v in pt1)
    x2, y2 = (int(v) for v in pt2)
    xa, xb, ya, yb = min(x1, x2), max(x1, x2), min(y1, y2), max(y1, y2)
    if thickness < 0:
        _fill(img, xa, ya, xb, yb, color)
    elif thickness == 1:
        for y in (ya, yb):
            _fill(img, xa, y, xb, y, color)
        for x in (xa, xb):
            _fill(img, x, ya, x, yb, color)
    elif thickness == 2:
        for y in (ya, yb):                   # the horizontal sides' bands
            _fill(img, xa, y - 1, xb, y + 1, color)
        for x in (xa, xb):                   # the vertical sides' bands
            _fill(img, x - 1, ya, x + 1, yb, color)
        for x in (xa, xb):                   # each corner's radius-1 cap
            for y in (ya, yb):
                _fill(img, x - 1, y, x + 1, y, color)
                _fill(img, x, y - 1, x, y + 1, color)
    else:
        raise ValueError(f"rectangle: thickness {thickness}; 1, 2 and "
                         "negative (filled) are drawn")
    return img


def circle(img: np.ndarray, center: Tuple[int, int], radius: int,
           color: Color) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, -1)`` (filled) in place;
    returns ``img``. OpenCV's integer circle: rows of horizontal spans
    from its midpoint walk."""
    cx, cy = (int(v) for v in center)
    if radius < 0:
        raise ValueError(f"circle: radius {radius}")
    err, dx, dy, plus, minus = 0, int(radius), 0, 1, 2 * int(radius) - 1
    while dx >= dy:
        for y in (cy - dy, cy + dy):
            _fill(img, cx - dx, y, cx + dx, y, color)
        for y in (cy - dx, cy + dx):
            _fill(img, cx - dy, y, cx + dy, y, color)
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    return img


def _codes(label: str) -> np.ndarray:
    """Index of each character in the tables; '?' for one outside
    printable ASCII."""
    codes = np.frombuffer(label.encode("ascii", "replace"), np.uint8)
    codes = codes.astype(np.int64) - 32
    return np.where((codes >= 0) & (codes < 95), codes, ord("?") - 32)


def _metrics(scale: float):
    key = round(float(scale), 6)
    if key not in _ADVANCE:
        raise ValueError(f"text at scale {scale}: the tables hold "
                         f"{sorted(_ADVANCE)}")
    return (np.frombuffer(_ADVANCE[key].encode(), np.uint8) - 48,
            np.frombuffer(_DESCENT[key].encode(), np.uint8) - 48,
            _HEIGHT[key])


def text_size(label: str, scale: float) -> Tuple[Tuple[int, int], int]:
    """``cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, scale, 1)``:
    ((width, height), baseline), at scale 0.4 or 0.35."""
    advance, descent, height = _metrics(scale)
    if not label:
        return (0, 0), 0
    codes = _codes(label)
    return ((int(advance[codes].sum()) + 1, height),
            int(descent[codes].max()))


def put_text(img: np.ndarray, label: str, org: Tuple[int, int],
             scale: float, color: Color) -> np.ndarray:
    """Draw ``label`` with its baseline's left end at ``org`` = (x, y) in
    place, as ``cv2.putText(img, label, org, FONT_HERSHEY_SIMPLEX,
    scale, color, 1)`` places it: each glyph of the port's 5x7 font sits
    centred in its character's advance, its bottom row on the baseline,
    and nothing is drawn outside the label's footprint
    ([x, x + width) x [y - height, y + baseline], ``text_size``). Returns
    ``img``."""
    if not label:
        return img
    (tw, _), _ = text_size(label, scale)
    advance = _metrics(scale)[0]
    x, y = (int(v) for v in org)
    mask = np.zeros((7, tw), bool)
    pen = 0
    for c in _codes(label):
        glyph = _GLYPHS[c]
        cols = np.flatnonzero(glyph.any(0))
        if len(cols):
            glyph = glyph[:, cols[0]:cols[-1] + 1]
            at = pen + max((int(advance[c]) - glyph.shape[1]) // 2, 0)
            span = min(glyph.shape[1], tw - at)
            if span > 0:
                mask[:, at:at + span] |= glyph[:, :span]
        pen += int(advance[c])
    h, w = img.shape[:2]
    rows, cols = np.nonzero(mask)
    rows, cols = rows + y - 6, cols + x
    keep = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    img[rows[keep], cols[keep]] = color
    return img
