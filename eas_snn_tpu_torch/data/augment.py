"""Joint event-frame + box augmentation and target transforms (the port's
copy of ``eas_snn_tpu/data/augment.py``; reference yolox/data/datasets/
gen1.py:433-521 and yolox/data/event_data_augment.py:10-103).

  * train: aspect-jitter + scale, random placement on a zero canvas,
    horizontal flip; boxes adjusted, clipped, degenerate (<1 px) dropped;
  * val: letterbox (corner-anchored by default, like the reference) or plain
    resize;
  * ``TrainTransform`` drops boxes with min side <= 1 and pads labels to
    ``max_labels`` rows of ``[cls, cx, cy, w, h]`` float32;
  * ``ValTransform`` passes boxes through.

The random draws are the JAX package's, in its order, so boxes match it
bit for bit for the same generator. ``resize_frames`` is
``torch.nn.functional.interpolate`` (bilinear, half-pixel centres, no
antialias) on CPU tensors where the JAX package calls ``cv2.resize``
(INTER_LINEAR, the same rule): the two agree to f32 rounding of the
sampling weights (tests/test_torch_data.py states the tolerance).

Frames are channel-last (T, H, W, C); boxes are (N, 5) ``[x1,y1,x2,y2,cls]``
in pixel units until the final cxcywh conversion.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "sample_affine",
    "apply_affine_to_boxes",
    "resize_frames",
    "letterbox",
    "random_resize_place_flip",
    "xyxy2cxcywh_np",
    "TrainTransform",
    "ValTransform",
]


def sample_affine(
    img_size: Tuple[int, int],
    input_size: Tuple[int, int],
    rng: np.random.Generator,
    training: bool = True,
    jitter: float = 0.3,
    scale_range: Tuple[float, float] = (0.4, 1.0),
    flip_prob: float = 0.5,
):
    """Draw the same geometric transform as random_resize_place_flip /
    letterbox, but as an explicit affine (sx, sy, dx, dy, flip) so it can be
    applied to raw event coordinates (event-space augmentation for the
    on-device binning path) as well as to boxes."""
    ih, iw = img_size
    h, w = input_size
    if not training:
        scale = min(w / iw, h / ih)
        return dict(sx=scale, sy=scale, dx=0.0, dy=0.0, flip=False)
    new_ar = (
        iw / ih
        * rng.uniform(1 - jitter, 1 + jitter)
        / rng.uniform(1 - jitter, 1 + jitter)
    )
    scale = rng.uniform(*scale_range)
    if new_ar < 1:
        nh = int(scale * h)
        nw = int(nh * new_ar)
    else:
        nw = int(scale * w)
        nh = int(nw / new_ar)
    nw, nh = max(nw, 1), max(nh, 1)
    dx = int(rng.uniform(0, max(w - nw, 1)))
    dy = int(rng.uniform(0, max(h - nh, 1)))
    flip = bool(rng.uniform() < flip_prob)
    return dict(sx=nw / iw, sy=nh / ih, dx=float(dx), dy=float(dy), flip=flip)


def apply_affine_to_boxes(
    boxes: np.ndarray, affine: dict, input_size: Tuple[int, int]
) -> np.ndarray:
    """xyxy+cls boxes through the affine, clipped, degenerate dropped."""
    h, w = input_size
    box = np.asarray(boxes, np.float32).reshape(-1, boxes.shape[-1]).copy()
    if len(box) == 0:
        return box
    box[:, [0, 2]] = box[:, [0, 2]] * affine["sx"] + affine["dx"]
    box[:, [1, 3]] = box[:, [1, 3]] * affine["sy"] + affine["dy"]
    if affine["flip"]:
        box[:, [0, 2]] = w - box[:, [2, 0]]
    return _clip_filter_boxes(box, w, h)


def xyxy2cxcywh_np(b: np.ndarray) -> np.ndarray:
    out = b.copy().astype(np.float32)
    out[:, 2] = b[:, 2] - b[:, 0]
    out[:, 3] = b[:, 3] - b[:, 1]
    out[:, 0] = b[:, 0] + out[:, 2] / 2
    out[:, 1] = b[:, 1] + out[:, 3] / 2
    return out


def resize_frames(frames: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """Bilinear-resize a (T, H, W, C) float32 stack to (T, h', w', C),
    ``dsize`` = (w', h'): all T frames in one call, T*C planes of one NCHW
    image (the reference loops over frames, gen1.py:424-432)."""
    t, h, w, c = frames.shape
    nw, nh = dsize
    x = torch.from_numpy(np.ascontiguousarray(frames, np.float32))
    x = x.permute(0, 3, 1, 2).reshape(1, t * c, h, w).contiguous()
    out = F.interpolate(x, size=(nh, nw), mode="bilinear",
                        align_corners=False, antialias=False)
    return out.reshape(t, c, nh, nw).permute(0, 2, 3, 1).contiguous().numpy()


def _clip_filter_boxes(box: np.ndarray, w: int, h: int) -> np.ndarray:
    box[:, 0:2] = np.maximum(box[:, 0:2], 0)
    box[:, 2] = np.minimum(box[:, 2], w)
    box[:, 3] = np.minimum(box[:, 3], h)
    keep = (box[:, 2] - box[:, 0] > 1) & (box[:, 3] - box[:, 1] > 1)
    return box[keep]


def letterbox(
    frames: np.ndarray,
    boxes: np.ndarray,
    input_size: Tuple[int, int],
    center: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Aspect-preserving resize onto a zero canvas (reference val path,
    gen1.py:439-470; dx=dy=0 corner anchoring unless ``center``)."""
    t, ih, iw, c = frames.shape
    h, w = input_size
    scale = min(w / iw, h / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    dx, dy = ((w - nw) // 2, (h - nh) // 2) if center else (0, 0)
    canvas = np.zeros((t, h, w, c), np.float32)
    canvas[:, dy:dy + nh, dx:dx + nw] = resize_frames(frames, (nw, nh))
    box = np.asarray(boxes, np.float32).reshape(-1, boxes.shape[-1]).copy()
    if len(box):
        box[:, [0, 2]] = box[:, [0, 2]] * (nw / iw) + dx
        box[:, [1, 3]] = box[:, [1, 3]] * (nh / ih) + dy
        box = _clip_filter_boxes(box, w, h)
    return canvas, box


def random_resize_place_flip(
    frames: np.ndarray,
    boxes: np.ndarray,
    input_size: Tuple[int, int],
    rng: np.random.Generator,
    jitter: float = 0.3,
    scale_range: Tuple[float, float] = (0.4, 1.0),
    flip_prob: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Train-time joint augmentation (reference gen1.py:487-521)."""
    t, ih, iw, c = frames.shape
    h, w = input_size
    new_ar = (
        iw / ih
        * rng.uniform(1 - jitter, 1 + jitter)
        / rng.uniform(1 - jitter, 1 + jitter)
    )
    scale = rng.uniform(*scale_range)
    if new_ar < 1:
        nh = int(scale * h)
        nw = int(nh * new_ar)
    else:
        nw = int(scale * w)
        nh = int(nw / new_ar)
    nw, nh = max(nw, 1), max(nh, 1)
    resized = resize_frames(frames, (nw, nh))
    dx = int(rng.uniform(0, max(w - nw, 1)))
    dy = int(rng.uniform(0, max(h - nh, 1)))
    canvas = np.zeros((t, h, w, c), np.float32)
    ch, cw = min(nh, h - dy), min(nw, w - dx)
    canvas[:, dy:dy + ch, dx:dx + cw] = resized[:, :ch, :cw]
    flip = rng.uniform() < flip_prob
    if flip:
        canvas = np.ascontiguousarray(canvas[:, :, ::-1, :])
    box = np.asarray(boxes, np.float32).reshape(-1, boxes.shape[-1]).copy()
    if len(box):
        box[:, [0, 2]] = box[:, [0, 2]] * (nw / iw) + dx
        box[:, [1, 3]] = box[:, [1, 3]] * (nh / ih) + dy
        if flip:
            box[:, [0, 2]] = w - box[:, [2, 0]]
        box = _clip_filter_boxes(box, w, h)
    return canvas, box


class TrainTransform:
    """Filter degenerate boxes; emit (frames, (max_labels, 5) [cls,cx,cy,w,h])
    (reference event_data_augment.py:10-65). Boxes arrive as cxcywh rows
    ``[cx, cy, w, h, cls]``."""

    def __init__(self, max_labels: int = 50):
        self.max_labels = max_labels

    def __call__(self, frames, targets, input_dim):
        padded = np.zeros((self.max_labels, 5), np.float32)
        if len(targets):
            boxes = targets[:, :4]
            labels = targets[:, 4]
            keep = np.minimum(boxes[:, 2], boxes[:, 3]) > 1
            boxes, labels = boxes[keep], labels[keep]
            n = min(len(boxes), self.max_labels)
            padded[:n, 0] = labels[:n]
            padded[:n, 1:5] = boxes[:n]
        return frames, padded


class ValTransform:
    """Pass boxes through unchanged (reference event_data_augment.py:68-103)."""

    def __call__(self, frames, targets, input_dim):
        return frames, np.asarray(targets, np.float32)
