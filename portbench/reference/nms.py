"""The host postprocess: confidence filter and class-aware hard NMS in
numpy, a frozen copy of the port's ``ops/boxes.py:nms_numpy`` and
``postprocess`` (after the reference's yolox/utils/boxes.py:33-77)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np


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
