"""Prophesee-protocol evaluation: box filters and time-tolerant matching
(the port's copy of ``eas_snn_tpu/evaluators/prophesee.py``; reference
yolox/utils/psee_loader/evaluation.py:6-43, io/box_filtering.py:23-41,
metrics/coco_eval.py:25-179, evaluator.py:11-79).

Protocol: ground truth and predictions alike are filtered: the first
0.5 s of each stream is skipped, the minimum diagonal is 30 px (Gen1) /
60 px (1Mpx) and the minimum side 10 / 20 px, both halved for frames
downsampled by 2. Every unique ground-truth timestamp becomes one
pseudo-image, detections within +/-50 ms of it are assigned to it, and
the COCO mAP of ``coco_map.DetEval`` is taken over them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..data.psee_io import BBOX_DTYPE
from .coco_map import DetEval

__all__ = [
    "filter_boxes",
    "match_times",
    "evaluate_lists",
    "PropheseeEvaluator",
    "boxes_to_prophesee",
]


def filter_boxes(
    boxes: np.ndarray,
    skip_ts: int = int(5e5),
    min_box_diag: int = 60,
    min_box_side: int = 20,
) -> np.ndarray:
    """(box_filtering.py:23-41 semantics: strictly-after skip_ts, diag^2 and
    per-side minima.)"""
    ts = boxes["t"]
    w = boxes["w"]
    h = boxes["h"]
    mask = (
        (ts > skip_ts)
        & (w ** 2 + h ** 2 >= min_box_diag ** 2)
        & (w >= min_box_side)
        & (h >= min_box_side)
    )
    return boxes[mask]


def match_times(
    all_ts: np.ndarray, gt_boxes: np.ndarray, dt_boxes: np.ndarray, time_tol: int
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Per unique GT timestamp: exact-time GT group and +/-tol detection
    window (coco_eval.py:56-91 — the reference's cursor walk becomes four
    searchsorted calls; both inputs must be time-sorted)."""
    gt_t = gt_boxes["t"]
    dt_t = dt_boxes["t"]
    g_lo = np.searchsorted(gt_t, all_ts, side="left")
    g_hi = np.searchsorted(gt_t, all_ts, side="right")
    d_lo = np.searchsorted(dt_t, all_ts - time_tol, side="left")
    d_hi = np.searchsorted(dt_t, all_ts + time_tol, side="right")
    # the reference's high cursor never moves backwards across timestamps
    g_hi = np.maximum.accumulate(g_hi)
    d_hi = np.maximum.accumulate(d_hi)
    g_lo = np.minimum(g_lo, g_hi)
    d_lo = np.minimum(d_lo, d_hi)
    gt_win = [gt_boxes[a:b] for a, b in zip(g_lo, g_hi)]
    dt_win = [dt_boxes[a:b] for a, b in zip(d_lo, d_hi)]
    return gt_win, dt_win


def evaluate_lists(
    dt_boxes_list: Sequence[np.ndarray],
    gt_boxes_list: Sequence[np.ndarray],
    *,
    camera: str = "gen1",
    apply_bbox_filters: bool = True,
    downsampled_by_2: bool = False,
    time_tol: int = 50000,
    num_classes: int | None = None,
    use_native: bool = True,
) -> Dict[str, float]:
    """Full Prophesee protocol over per-stream box arrays
    (evaluation.py:13-43 + evaluate_detection)."""
    assert camera in ("gen1", "gen4")
    classes = ("car", "pedestrian") if camera == "gen1" else (
        "pedestrian", "two-wheeler", "car"
    )
    if num_classes is None:
        num_classes = len(classes)
    if apply_bbox_filters:
        diag = 30 if camera == "gen1" else 60
        side = 10 if camera == "gen1" else 20
        if downsampled_by_2:
            diag //= 2
            side //= 2
        gt_boxes_list = [
            filter_boxes(b, int(5e5), diag, side) for b in gt_boxes_list
        ]
        dt_boxes_list = [
            filter_boxes(b, int(5e5), diag, side) for b in dt_boxes_list
        ]

    det_rows, gt_rows = [], []
    img_id = 0
    for gt_b, dt_b in zip(gt_boxes_list, dt_boxes_list):
        assert np.all(np.diff(gt_b["t"]) >= 0), "GT must be time-sorted"
        assert np.all(np.diff(dt_b["t"]) >= 0), "detections must be time-sorted"
        all_ts = np.unique(gt_b["t"])
        gt_win, dt_win = match_times(all_ts, gt_b, dt_b, time_tol)
        for g, d in zip(gt_win, dt_win):
            for r in g:
                gt_rows.append(
                    [img_id, r["class_id"], r["x"], r["y"], r["w"], r["h"], 0]
                )
            for r in d:
                det_rows.append(
                    [img_id, r["class_id"], r["x"], r["y"], r["w"], r["h"],
                     r["class_confidence"]]
                )
            img_id += 1
    det = np.asarray(det_rows, np.float64).reshape(-1, 7)
    gt = np.asarray(gt_rows, np.float64).reshape(-1, 7)
    res = DetEval(num_classes=num_classes, use_native=use_native).evaluate(det, gt)
    s = res.stats
    return {
        "AP": float(s[0]), "AP_50": float(s[1]), "AP_75": float(s[2]),
        "AP_S": float(s[3]), "AP_M": float(s[4]), "AP_L": float(s[5]),
        "per_class_AP": res.per_class_ap,
    }


def boxes_to_prophesee(
    t: np.ndarray, x: np.ndarray, y: np.ndarray, w: np.ndarray, h: np.ndarray,
    class_id: np.ndarray, confidence: np.ndarray,
) -> np.ndarray:
    """Pack plain arrays into the Prophesee BBOX_DTYPE record layout, sorted
    by time (psee_evaluator.py:288-307 semantics)."""
    arr = np.zeros(len(t), BBOX_DTYPE)
    arr["t"] = t
    arr["x"] = x
    arr["y"] = y
    arr["w"] = w
    arr["h"] = h
    arr["class_id"] = class_id.astype(np.uint32)
    arr["class_confidence"] = confidence
    return arr[np.argsort(arr["t"], kind="stable")]


class PropheseeEvaluator:
    """Buffering evaluator: add labels/predictions per stream, evaluate at
    the end (reference utils/psee_loader/evaluator.py:11-79)."""

    def __init__(self, camera: str = "gen1", downsampled_by_2: bool = False):
        self.camera = camera
        self.downsampled_by_2 = downsampled_by_2
        self._gt: List[np.ndarray] = []
        self._dt: List[np.ndarray] = []

    def add_labels(self, boxes: np.ndarray):
        self._gt.append(np.asarray(boxes, BBOX_DTYPE))

    def add_predictions(self, boxes: np.ndarray):
        self._dt.append(np.asarray(boxes, BBOX_DTYPE))

    def has_data(self) -> bool:
        return bool(self._gt)

    def reset_buffer(self):
        self._gt.clear()
        self._dt.clear()

    def evaluate_buffer(self) -> Dict[str, float]:
        # one logical stream per add() call pair
        n = max(len(self._gt), len(self._dt))
        gt = self._gt + [np.zeros(0, BBOX_DTYPE)] * (n - len(self._gt))
        dt = self._dt + [np.zeros(0, BBOX_DTYPE)] * (n - len(self._dt))
        gt = [g[np.argsort(g["t"], kind="stable")] for g in gt]
        dt = [d[np.argsort(d["t"], kind="stable")] for d in dt]
        return evaluate_lists(
            dt, gt, camera=self.camera, downsampled_by_2=self.downsampled_by_2
        )
