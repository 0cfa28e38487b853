"""PASCAL-VOC AP, the 2007 11-point and the 2010+ continuous metric (the
port's copy of ``eas_snn_tpu/evaluators/voc_eval.py``; reference
yolox/evaluators/voc_eval.py:36-185, voc_evaluator.py:19-200).

Callers hand over per-image ground truth and flat detections in memory;
the greedy confidence-ordered matching, the difficult boxes, the +1.0 box
extents and both AP metrics are the reference's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["voc_ap", "voc_eval_class", "VOCDetEval"]


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = False) -> float:
    """AP from a PR curve (reference voc_eval.py:36-67)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def voc_eval_class(
    gt_by_img: Dict[int, Tuple[np.ndarray, np.ndarray]],
    det_img_ids: np.ndarray,
    det_boxes: np.ndarray,
    det_scores: np.ndarray,
    ovthresh: float = 0.5,
    use_07_metric: bool = False,
):
    """One-class VOC evaluation (reference voc_eval.py:70-185).

    gt_by_img: img_id -> (boxes (G, 4) xyxy, difficult (G,) bool).
    Returns (rec, prec, ap); (0, 0, 0) when there are no detections, as the
    reference does.
    """
    npos = sum(int((~diff).sum()) for _, diff in gt_by_img.values())
    if len(det_img_ids) == 0:
        return 0.0, 0.0, 0.0

    order = np.argsort(-det_scores)
    det_img_ids = np.asarray(det_img_ids)[order]
    det_boxes = np.asarray(det_boxes, np.float64)[order]

    taken = {k: np.zeros(len(v[0]), bool) for k, v in gt_by_img.items()}
    nd = len(det_img_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        img = int(det_img_ids[d])
        bb = det_boxes[d]
        boxes, difficult = gt_by_img.get(img, (np.zeros((0, 4)), np.zeros(0, bool)))
        ovmax, jmax = -np.inf, -1
        if len(boxes):
            g = boxes.astype(np.float64)
            iw = np.maximum(
                np.minimum(g[:, 2], bb[2]) - np.maximum(g[:, 0], bb[0]) + 1.0,
                0.0,
            )
            ih = np.maximum(
                np.minimum(g[:, 3], bb[3]) - np.maximum(g[:, 1], bb[1]) + 1.0,
                0.0,
            )
            inters = iw * ih
            uni = (
                (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                + (g[:, 2] - g[:, 0] + 1.0) * (g[:, 3] - g[:, 1] + 1.0)
                - inters
            )
            overlaps = inters / uni
            ovmax = float(np.max(overlaps))
            jmax = int(np.argmax(overlaps))
        if ovmax > ovthresh:
            if not difficult[jmax]:
                if not taken[img][jmax]:
                    tp[d] = 1.0
                    taken[img][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


class VOCDetEval:
    """Multi-class mAP50 over flat rows, VOC protocol.

    detections: (N, 7) [img, cls, x1, y1, x2, y2, score];
    ground truth: (M, 6|7) [img, cls, x1, y1, x2, y2(, difficult)].
    """

    def __init__(self, num_classes: int, use_07_metric: bool = False,
                 ovthresh: float = 0.5):
        self.num_classes = num_classes
        self.use_07_metric = use_07_metric
        self.ovthresh = ovthresh

    def evaluate(self, detections: np.ndarray, ground_truth: np.ndarray):
        det = np.asarray(detections, np.float64).reshape(-1, 7)
        gt = np.asarray(ground_truth, np.float64)
        if gt.size == 0:
            gt = gt.reshape(0, 7)
        elif gt.shape[1] == 6:
            gt = np.concatenate([gt, np.zeros((len(gt), 1))], axis=1)

        aps: List[float] = []
        per_class = {}
        for c in range(self.num_classes):
            gtc = gt[gt[:, 1] == c]
            gt_by_img: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
            for img in np.unique(gtc[:, 0]).astype(int):
                rows = gtc[gtc[:, 0] == img]
                gt_by_img[img] = (rows[:, 2:6], rows[:, 6].astype(bool))
            dc = det[det[:, 1] == c]
            _, _, ap = voc_eval_class(
                gt_by_img, dc[:, 0].astype(int), dc[:, 2:6], dc[:, 6],
                ovthresh=self.ovthresh, use_07_metric=self.use_07_metric,
            )
            aps.append(float(ap))
            per_class[c] = float(ap)
        return float(np.mean(aps)) if aps else 0.0, per_class
