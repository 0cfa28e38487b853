"""Box geometry for the losses, in torch (the port's counterparts of
``eas_snn_tpu/ops/boxes.py:cxcywh2xyxy``, ``pairwise_iou`` and
``iou_loss``; reference yolox/utils/boxes.py:80-103, models/losses.py),
and the host-side postprocess: confidence filter and class-aware hard
NMS, in numpy (its own copy of ``nms_numpy`` and ``postprocess_numpy``,
after the reference's yolox/utils/boxes.py:33-77). Boxes are 'cxcywh'
(centre x/y, width, height) unless a name says 'xyxy' (corners). The
losses use the 'iou' loss only; the JAX package's xyxy IoU and 'giou'
loss have no caller and are not ported.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

__all__ = ["cxcywh2xyxy", "pairwise_iou", "iou_loss", "nms_numpy",
           "postprocess"]


def cxcywh2xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between (..., M, 4) and (..., A, 4) cxcywh boxes: (..., M, A)."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    tl = torch.maximum(a[..., :2] - a[..., 2:] / 2, b[..., :2] - b[..., 2:] / 2)
    br = torch.minimum(a[..., :2] + a[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2)
    area_a, area_b = a[..., 2] * a[..., 3], b[..., 2] * b[..., 3]
    valid = (tl < br).all(-1)
    wh = br - tl
    inter = wh[..., 0] * wh[..., 1] * valid
    return inter / (area_a + area_b - inter + 1e-12)


def iou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise 1 - IoU^2 of aligned (..., 4) cxcywh boxes."""
    tl = torch.maximum(pred[..., :2] - pred[..., 2:] / 2,
                       target[..., :2] - target[..., 2:] / 2)
    br = torch.minimum(pred[..., :2] + pred[..., 2:] / 2,
                       target[..., :2] + target[..., 2:] / 2)
    area_p = pred[..., 2] * pred[..., 3]
    area_g = target[..., 2] * target[..., 3]
    en = (tl < br).all(-1).to(pred.dtype)
    wh = br - tl
    area_i = wh[..., 0] * wh[..., 1] * en
    iou = area_i / (area_p + area_g - area_i + 1e-16)
    return 1.0 - iou ** 2


def nms_numpy(boxes: np.ndarray, scores: np.ndarray, iou_thr: float) -> np.ndarray:
    """Hard NMS over (n, 4) xyxy boxes; returns the kept indices."""
    x1, y1, x2, y2 = boxes.T
    areas = (x2 - x1) * (y2 - y1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1)
        h = np.maximum(0.0, yy2 - yy1)
        inter = w * h
        iou = inter / (areas[i] + areas[order[1:]] - inter + 1e-12)
        order = order[1:][iou <= iou_thr]
    return np.asarray(keep, dtype=np.int64)


def postprocess(prediction: np.ndarray, num_classes: int,
                conf_thre: float = 0.7, nms_thre: float = 0.45,
                class_agnostic: bool = False) -> List[Optional[np.ndarray]]:
    """Per image: keep anchors with obj * best-class score >= conf_thre,
    then NMS (per class unless ``class_agnostic``).

    prediction: (B, A, 5 + num_classes) decoded [cx, cy, w, h, obj, cls...]
    with obj/cls already sigmoided. Returns per-image (n, 7) arrays
    [x1, y1, x2, y2, obj, cls_conf, cls], or None where nothing is kept.
    """
    outputs = []
    for pred in prediction:
        box = np.stack([
            pred[:, 0] - pred[:, 2] / 2, pred[:, 1] - pred[:, 3] / 2,
            pred[:, 0] + pred[:, 2] / 2, pred[:, 1] + pred[:, 3] / 2,
        ], axis=1)
        cls_conf = pred[:, 5:5 + num_classes]
        cls_ind = cls_conf.argmax(1)
        cls_score = cls_conf[np.arange(len(pred)), cls_ind]
        mask = pred[:, 4] * cls_score >= conf_thre
        if not mask.any():
            outputs.append(None)
            continue
        dets = np.concatenate([
            box[mask], pred[mask, 4:5], cls_score[mask, None],
            cls_ind[mask, None].astype(pred.dtype),
        ], axis=1)
        boxes = dets[:, :4]
        if not class_agnostic:
            # offset boxes by class so one NMS pass is per class
            boxes = boxes + dets[:, 6:7] * (dets[:, :4].max() + 1.0)
        keep = nms_numpy(boxes, dets[:, 4] * dets[:, 5], nms_thre)
        outputs.append(dets[keep])
    return outputs
