"""Mosaic and MixUp for the RGB pipeline (counterpart of
``eas_snn_tpu/data/mosaic.py``; reference yolox/data/datasets/
mosaicdetection.py:37-230 MosaicDetection and data_augment.py
random_affine): four images on a 2x canvas, a random affine (rotation,
scale, shear, translation), an optional mixup with a second sample, and
degenerate boxes dropped.

The pixels are uint8 throughout and equal the JAX package's bit for bit:
``data/image.py`` holds ``resize_linear_u8``, ``warp_affine_u8`` and
``rotation_matrix_2d`` to cv2's rules. The random draws are the JAX
package's, from ``self.rng`` in its order; the loader's workers reseed it
(``data/loader.py:_reseed_worker``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from .augment import TrainTransform, xyxy2cxcywh_np
from .image import resize_linear_u8, rotation_matrix_2d, warp_affine_u8

__all__ = ["MosaicDataset", "random_affine"]


def _affine_matrix(rng, degrees, translate, scales, shear, twidth, theight
                   ) -> Tuple[np.ndarray, float]:
    angle = rng.uniform(-degrees, degrees)
    scale = rng.uniform(*scales)
    M = np.eye(3)
    M[:2] = rotation_matrix_2d((0, 0), angle, scale)
    shear_x = math.tan(math.radians(rng.uniform(-shear, shear)))
    shear_y = math.tan(math.radians(rng.uniform(-shear, shear)))
    S = np.eye(3)
    S[0, 1] = shear_x
    S[1, 0] = shear_y
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * twidth
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * theight
    return (T @ S @ M)[:2], scale


def random_affine(img: np.ndarray, targets: np.ndarray,
                  rng: np.random.Generator,
                  target_size: Tuple[int, int] = (640, 640),
                  degrees: float = 10.0, translate: float = 0.1,
                  scales: Tuple[float, float] = (0.1, 2.0),
                  shear: float = 2.0):
    """Warp a uint8 image and its xyxy boxes by a random rotation, scale,
    shear and translation; ``target_size`` = (w, h)."""
    tw, th = target_size
    M, _ = _affine_matrix(rng, degrees, translate, scales, shear, tw, th)
    img = warp_affine_u8(img, M, (tw, th), border=114)
    n = len(targets)
    if n:
        corners = np.ones((4 * n, 3))
        corners[:, :2] = targets[:, [0, 1, 2, 1, 0, 3, 2, 3]].reshape(-1, 2)
        corners = (corners @ M.T).reshape(n, 8)
        xs = corners[:, 0::2]
        ys = corners[:, 1::2]
        new = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], axis=1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, tw)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, th)
        targets = targets.copy()
        targets[:, :4] = new
        keep = (new[:, 2] - new[:, 0] > 1) & (new[:, 3] - new[:, 1] > 1)
        targets = targets[keep]
    return img, targets


class MosaicDataset:
    """The train view of an RGB dataset with ``_read(index)`` and
    ``annotations`` (COCODataset, VOCDataset): a 4-image mosaic with
    probability ``mosaic_prob`` (then a mixup with ``mixup_prob``), else
    the image letterboxed to the corner; a flip with probability 0.5."""

    def __init__(self, base, input_size: Tuple[int, int] = (640, 640),
                 mosaic_prob: float = 1.0, mixup_prob: float = 1.0,
                 degrees: float = 10.0, translate: float = 0.1,
                 mosaic_scale: Tuple[float, float] = (0.1, 2.0),
                 mixup_scale: Tuple[float, float] = (0.5, 1.5),
                 shear: float = 2.0, max_labels: int = 120, seed: int = 0):
        self.base = base
        self.input_size = tuple(input_size)
        self.mosaic_prob = mosaic_prob
        self.mixup_prob = mixup_prob
        self.degrees = degrees
        self.translate = translate
        self.mosaic_scale = mosaic_scale
        self.mixup_scale = mixup_scale
        self.shear = shear
        self.enable_mosaic = True
        self.rng = np.random.default_rng(seed)
        self.transform = TrainTransform(max_labels)
        self.sample_names = getattr(base, "sample_names", None)
        self.class_names = getattr(base, "class_names", ())
        self.map_val = False

    def __len__(self) -> int:
        return len(self.base)

    def _raw(self, idx: int):
        return self.base._read(idx), self.base.annotations[idx].copy()

    def close_mosaic(self) -> None:
        """The no-aug tail (reference trainer.py:228-241): no more mosaic
        or mixup."""
        self.enable_mosaic = False

    def __getitem__(self, index: int):
        h, w = self.input_size
        if self.enable_mosaic and self.rng.uniform() < self.mosaic_prob:
            # the mosaic's centre on the 2x canvas
            yc = int(self.rng.uniform(0.5 * h, 1.5 * h))
            xc = int(self.rng.uniform(0.5 * w, 1.5 * w))
            ids = [index] + list(self.rng.integers(0, len(self), 3))
            canvas = np.full((2 * h, 2 * w, 3), 114, np.uint8)
            all_boxes = []
            for i, idx in enumerate(ids):
                img, boxes = self._raw(int(idx))
                ih, iw = img.shape[:2]
                scale = min(h / ih, w / iw)
                img = resize_linear_u8(img, (int(iw * scale), int(ih * scale)))
                sh, sw = img.shape[:2]
                # the quadrant's placement (reference get_mosaic_coordinate)
                if i == 0:
                    x1, y1 = max(xc - sw, 0), max(yc - sh, 0)
                    x2, y2 = xc, yc
                elif i == 1:
                    x1, y1 = xc, max(yc - sh, 0)
                    x2, y2 = min(xc + sw, 2 * w), yc
                elif i == 2:
                    x1, y1 = max(xc - sw, 0), yc
                    x2, y2 = xc, min(yc + sh, 2 * h)
                else:
                    x1, y1 = xc, yc
                    x2, y2 = min(xc + sw, 2 * w), min(yc + sh, 2 * h)
                cw, ch = x2 - x1, y2 - y1
                sx1 = sw - cw if i in (0, 2) else 0
                sy1 = sh - ch if i in (0, 1) else 0
                canvas[y1:y2, x1:x2] = img[sy1:sy1 + ch, sx1:sx1 + cw]
                if len(boxes):
                    b = boxes.copy()
                    b[:, [0, 2]] = b[:, [0, 2]] * scale - sx1 + x1
                    b[:, [1, 3]] = b[:, [1, 3]] * scale - sy1 + y1
                    all_boxes.append(b)
            boxes = (np.concatenate(all_boxes) if all_boxes
                     else np.zeros((0, 5), np.float32))
            boxes[:, 0:4:2] = boxes[:, 0:4:2].clip(0, 2 * w)
            boxes[:, 1:4:2] = boxes[:, 1:4:2].clip(0, 2 * h)
            img, boxes = random_affine(
                canvas, boxes, self.rng, target_size=(w, h),
                degrees=self.degrees, translate=self.translate,
                scales=self.mosaic_scale, shear=self.shear)
            if self.rng.uniform() < self.mixup_prob:
                img, boxes = self._mixup(img, boxes)
        else:
            img, boxes = self._raw(index)
            ih, iw = img.shape[:2]
            scale = min(h / ih, w / iw)
            img2 = resize_linear_u8(img, (int(iw * scale), int(ih * scale)))
            canvas = np.full((h, w, 3), 114, np.uint8)
            canvas[: img2.shape[0], : img2.shape[1]] = img2
            img = canvas
            boxes = boxes.copy()
            boxes[:, :4] *= scale

        if self.rng.uniform() < 0.5 and len(boxes):  # hflip
            img = np.ascontiguousarray(img[:, ::-1])
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]

        frames = img.astype(np.float32)[None, None]  # (1, 1, H, W, 3)
        cxcywh = xyxy2cxcywh_np(boxes) if len(boxes) else boxes
        _, padded = self.transform(None, cxcywh, self.input_size)
        ih, iw = self.input_size
        return frames, padded, (ih, iw), index

    def _mixup(self, img: np.ndarray, boxes: np.ndarray):
        """Blend with a second, jittered sample (reference mixup)."""
        h, w = self.input_size
        idx = int(self.rng.integers(0, len(self)))
        img2, boxes2 = self._raw(idx)
        jit = self.rng.uniform(*self.mixup_scale)
        ih, iw = img2.shape[:2]
        scale = min(h / ih, w / iw) * jit
        img2 = resize_linear_u8(img2, (max(int(iw * scale), 1),
                                       max(int(ih * scale), 1)))
        canvas = np.full((h, w, 3), 114, np.uint8)
        ch = min(img2.shape[0], h)
        cw = min(img2.shape[1], w)
        canvas[:ch, :cw] = img2[:ch, :cw]
        if len(boxes2):
            b = boxes2.copy()
            b[:, :4] *= scale
            b[:, [0, 2]] = b[:, [0, 2]].clip(0, cw)
            b[:, [1, 3]] = b[:, [1, 3]].clip(0, ch)
            keep = (b[:, 2] - b[:, 0] > 1) & (b[:, 3] - b[:, 1] > 1)
            boxes = np.concatenate([boxes, b[keep]]) if keep.any() else boxes
        out = img.astype(np.float32) * 0.5 + canvas.astype(np.float32) * 0.5
        return out.astype(np.uint8), boxes
