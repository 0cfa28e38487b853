"""COCO-protocol mAP engine without pycocotools (the port's copy of
``eas_snn_tpu/evaluators/coco_map.py``; reference
yolox/layers/fast_coco_eval_api.py:17-151,
yolox/evaluators/event_evaluator.py:395-463).

The greedy IoU matching runs in the native matcher (``cocoeval/``, g++ at
first use, ctypes); ``DetEval(use_native=False)`` picks its numpy mirror,
the test oracle. Precision and recall accumulate in vectorized float64
numpy, in the JAX package's order of operations, so the same rows give
the same AP bit for bit.

Protocol constants are pycocotools' defaults: IoU thresholds
0.5:0.05:0.95, 101 recall points, areas all / small / medium / large
(0, 32^2, 96^2, 1e10), maxDets (1, 10, 100). Inputs are plain arrays:
detections ``(image_id, category, x, y, w, h, score)`` and ground truths
``(image_id, category, x, y, w, h[, ignore])``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence, Tuple

import numpy as np

from .cocoeval import load_native

__all__ = ["DetEval", "EvalResults", "IOU_THRS", "RECALL_THRS", "AREA_RNGS", "MAX_DETS"]

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _match_category_numpy(
    gt_off, gt_boxes, gt_ignore, det_off, det_boxes, det_scores,
    iou_thrs, area_min, area_max, max_det,
):
    """The numpy mirror of cocoeval.cpp:coco_match_category."""
    n_img = len(gt_off) - 1
    D = int(det_off[-1])
    T = len(iou_thrs)
    det_matched = np.zeros((T, D), np.uint8)
    det_ignored = np.zeros((T, D), np.uint8)
    det_rank = np.zeros(D, np.int32)
    n_pos = 0
    for img in range(n_img):
        g0, g1 = int(gt_off[img]), int(gt_off[img + 1])
        d0, d1 = int(det_off[img]), int(det_off[img + 1])
        gi_idx = np.arange(g0, g1)
        gi_idx = gi_idx[np.argsort(gt_ignore[g0:g1], kind="stable")]
        dord = np.arange(d0, d1)[
            np.argsort(-det_scores[d0:d1], kind="stable")
        ]
        det_rank[dord] = np.arange(len(dord))
        n_pos += int((gt_ignore[g0:g1] == 0).sum())
        dn = min(len(dord), max_det)
        G = len(gi_idx)
        if dn == 0:
            continue
        # pairwise IoU, crowd semantics for ignored gts
        db = det_boxes[dord[:dn]]
        gb = gt_boxes[gi_idx] if G else np.zeros((0, 4))
        if G:
            ix1 = np.maximum(db[:, None, 0], gb[None, :, 0])
            iy1 = np.maximum(db[:, None, 1], gb[None, :, 1])
            ix2 = np.minimum(db[:, None, 0] + db[:, None, 2], gb[None, :, 0] + gb[None, :, 2])
            iy2 = np.minimum(db[:, None, 1] + db[:, None, 3], gb[None, :, 1] + gb[None, :, 3])
            inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
            da = (db[:, 2] * db[:, 3])[:, None]
            ga = (gb[:, 2] * gb[:, 3])[None, :]
            crowd = (gt_ignore[gi_idx] != 0)[None, :]
            uni = np.where(crowd, da, da + ga - inter)
            ious = np.where(uni > 0, inter / np.maximum(uni, 1e-12), 0.0)
        for t, thr in enumerate(iou_thrs):
            gmatched = np.zeros(G, bool)
            for di in range(dn):
                best = max(thr, 1e-10)
                m = -1
                for gi in range(G):
                    if G == 0:
                        break
                    if gmatched[gi] and not gt_ignore[gi_idx[gi]]:
                        continue
                    if m >= 0 and not gt_ignore[gi_idx[m]] and gt_ignore[gi_idx[gi]]:
                        break
                    iou = ious[di, gi]
                    if iou < best:
                        continue
                    best = iou
                    m = gi
                det = dord[di]
                if m >= 0:
                    gmatched[m] = True
                    if gt_ignore[gi_idx[m]]:
                        det_ignored[t, det] = 1
                    else:
                        det_matched[t, det] = 1
                else:
                    area = det_boxes[det, 2] * det_boxes[det, 3]
                    if area < area_min or area >= area_max:
                        det_ignored[t, det] = 1
    return det_matched, det_ignored, det_rank, n_pos


@dataclass
class EvalResults:
    stats: np.ndarray                      # the 12 COCO summary numbers
    per_class_ap: Dict[int, float] = field(default_factory=dict)
    per_class_ar: Dict[int, float] = field(default_factory=dict)

    @property
    def ap(self) -> float:
        return float(self.stats[0])

    @property
    def ap50(self) -> float:
        return float(self.stats[1])


class DetEval:
    """COCO-protocol evaluator over flat detection/GT arrays."""

    def __init__(
        self,
        num_classes: int,
        use_native: bool = True,
        iou_thrs: np.ndarray = IOU_THRS,
        max_dets: Sequence[int] = MAX_DETS,
        area_rngs: Dict[str, Tuple[float, float]] = AREA_RNGS,
    ):
        self.num_classes = num_classes
        self.iou_thrs = np.asarray(iou_thrs, np.float64)
        self.max_dets = tuple(max_dets)
        self.area_rngs = dict(area_rngs)
        self.native = load_native() if use_native else None

    # ------------------------------------------------------------------
    def _match(self, gt_off, gt_boxes, gt_ignore, det_off, det_boxes,
               det_scores, area_rng):
        max_det = max(self.max_dets)
        if self.native is not None:
            D = int(det_off[-1])
            T = len(self.iou_thrs)
            det_matched = np.zeros(T * D, np.uint8)
            det_ignored = np.zeros(T * D, np.uint8)
            det_rank = np.zeros(max(D, 1), np.int32)
            n_pos = self.native.coco_match_category(
                len(gt_off) - 1,
                np.ascontiguousarray(gt_off, np.int64),
                np.ascontiguousarray(gt_boxes.reshape(-1), np.float64),
                np.ascontiguousarray(gt_ignore, np.uint8),
                np.ascontiguousarray(det_off, np.int64),
                np.ascontiguousarray(det_boxes.reshape(-1), np.float64),
                np.ascontiguousarray(det_scores, np.float64),
                self.iou_thrs, T,
                float(area_rng[0]), float(area_rng[1]), max_det,
                det_matched, det_ignored, det_rank,
            )
            return (
                det_matched.reshape(T, D), det_ignored.reshape(T, D),
                det_rank[:D], int(n_pos),
            )
        return _match_category_numpy(
            gt_off, gt_boxes, gt_ignore, det_off, det_boxes, det_scores,
            self.iou_thrs, area_rng[0], area_rng[1], max_det,
        )

    # ------------------------------------------------------------------
    def evaluate(
        self,
        detections: np.ndarray,   # (N, 7) [img, cat, x, y, w, h, score]
        ground_truth: np.ndarray,  # (M, 6|7) [img, cat, x, y, w, h(, ignore)]
    ) -> EvalResults:
        det = np.asarray(detections, np.float64).reshape(-1, 7)
        gt = np.asarray(ground_truth, np.float64)
        if gt.size == 0:
            gt = gt.reshape(0, 7)
        elif gt.shape[1] == 6:
            gt = np.concatenate([gt, np.zeros((len(gt), 1))], axis=1)

        img_ids = np.unique(
            np.concatenate([det[:, 0], gt[:, 0]])
        )
        img_index = {int(v): i for i, v in enumerate(img_ids)}
        n_img = len(img_ids)
        T = len(self.iou_thrs)
        R = len(RECALL_THRS)
        A = len(self.area_rngs)
        M = len(self.max_dets)
        K = self.num_classes

        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        for k in range(K):
            dk = det[det[:, 1] == k]
            gk = gt[gt[:, 1] == k]
            d_img = np.array([img_index[int(i)] for i in dk[:, 0]], np.int64)
            g_img = np.array([img_index[int(i)] for i in gk[:, 0]], np.int64)
            ds = np.argsort(d_img, kind="stable")
            gs = np.argsort(g_img, kind="stable")
            dk, d_img = dk[ds], d_img[ds]
            gk, g_img = gk[gs], g_img[gs]
            det_off = np.searchsorted(d_img, np.arange(n_img + 1))
            gt_off = np.searchsorted(g_img, np.arange(n_img + 1))
            det_boxes = np.ascontiguousarray(dk[:, 2:6])
            det_scores = np.ascontiguousarray(dk[:, 6])
            gt_boxes = np.ascontiguousarray(gk[:, 2:6])
            gareas = gt_boxes[:, 2] * gt_boxes[:, 3]

            for a, (aname, arng) in enumerate(self.area_rngs.items()):
                gt_ignore = (
                    (gk[:, 6] != 0) | (gareas < arng[0]) | (gareas >= arng[1])
                ).astype(np.uint8)
                matched, ignored, rank, n_pos = self._match(
                    gt_off, gt_boxes, gt_ignore, det_off, det_boxes,
                    det_scores, arng,
                )
                if n_pos == 0:
                    continue
                order = np.argsort(-det_scores, kind="mergesort")
                for m, md in enumerate(self.max_dets):
                    sel = order[rank[order] < md]
                    tps = (matched[:, sel] == 1) & (ignored[:, sel] == 0)
                    fps = (matched[:, sel] == 0) & (ignored[:, sel] == 0)
                    tp = np.cumsum(tps, axis=1, dtype=np.float64)
                    fp = np.cumsum(fps, axis=1, dtype=np.float64)
                    for t in range(T):
                        tpt, fpt = tp[t], fp[t]
                        nd = len(tpt)
                        rc = tpt / n_pos
                        pr = tpt / np.maximum(tpt + fpt, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd else 0.0
                        q = np.zeros(R)
                        if nd:
                            # monotone precision envelope
                            pr = np.maximum.accumulate(pr[::-1])[::-1]
                            inds = np.searchsorted(rc, RECALL_THRS, side="left")
                            valid = inds < nd
                            q[valid] = pr[inds[valid]]
                        precision[t, :, k, a, m] = q

        def _s(ap=True, iou=None, area="all", md=100):
            aidx = list(self.area_rngs).index(area)
            midx = self.max_dets.index(md)
            if ap:
                s = precision[:, :, :, aidx, midx]
                if iou is not None:
                    s = s[np.isclose(self.iou_thrs, iou)]
            else:
                s = recall[:, :, aidx, midx]
                if iou is not None:
                    s = s[np.isclose(self.iou_thrs, iou)]
            s = s[s > -1]
            return float(np.mean(s)) if s.size else -1.0

        stats = np.array([
            _s(True), _s(True, 0.5), _s(True, 0.75),
            _s(True, area="small"), _s(True, area="medium"), _s(True, area="large"),
            _s(False, md=self.max_dets[0]), _s(False, md=self.max_dets[1]),
            _s(False, md=self.max_dets[-1]),
            _s(False, area="small"), _s(False, area="medium"), _s(False, area="large"),
        ])

        aidx = list(self.area_rngs).index("all")
        midx = self.max_dets.index(max(self.max_dets))
        per_ap, per_ar = {}, {}
        for k in range(K):
            pk = precision[:, :, k, aidx, midx]
            rk = recall[:, k, aidx, midx]
            per_ap[k] = float(np.mean(pk[pk > -1])) if (pk > -1).any() else float("nan")
            per_ar[k] = float(np.mean(rk[rk > -1])) if (rk > -1).any() else float("nan")
        return EvalResults(stats, per_ap, per_ar)


def summarize(res: EvalResults, class_names: Sequence[str] = ()) -> str:
    """pycocotools-style summary block + per-class AP/AR table
    (reference per-class tables: event_evaluator.py:35-80)."""
    tmpl = (
        " Average Precision  (AP) @[ IoU={:<9} | area={:>6} | maxDets={:>3} ] = {:0.3f}"
    )
    tmplr = (
        " Average Recall     (AR) @[ IoU={:<9} | area={:>6} | maxDets={:>3} ] = {:0.3f}"
    )
    s = res.stats
    lines = [
        tmpl.format("0.50:0.95", "all", 100, s[0]),
        tmpl.format("0.50", "all", 100, s[1]),
        tmpl.format("0.75", "all", 100, s[2]),
        tmpl.format("0.50:0.95", "small", 100, s[3]),
        tmpl.format("0.50:0.95", "medium", 100, s[4]),
        tmpl.format("0.50:0.95", "large", 100, s[5]),
        tmplr.format("0.50:0.95", "all", 1, s[6]),
        tmplr.format("0.50:0.95", "all", 10, s[7]),
        tmplr.format("0.50:0.95", "all", 100, s[8]),
        tmplr.format("0.50:0.95", "small", 100, s[9]),
        tmplr.format("0.50:0.95", "medium", 100, s[10]),
        tmplr.format("0.50:0.95", "large", 100, s[11]),
    ]
    if class_names:
        lines.append(" per-class AP/AR:")
        for k, name in enumerate(class_names):
            ap = res.per_class_ap.get(k, float("nan"))
            ar = res.per_class_ar.get(k, float("nan"))
            lines.append(f"   {name:>16}: AP={ap:0.3f} AR={ar:0.3f}")
    return "\n".join(lines)
