"""COCO-protocol and Prophesee-protocol evaluators over event datasets (the
port's counterpart of ``eas_snn_tpu/evaluators/event_evaluator.py``;
reference yolox/evaluators/event_evaluator.py:84-565,
psee_evaluator.py:86-508).

Both evaluators walk the map_val loader and call ``forward_fn(frames)``
on each batch's frames as the loader gives them (a CPU tensor); it returns
the decoded ``(B, A, 5 + C)`` outputs (boxes in input-size units, obj and
cls already sigmoided) as a float32 numpy array (``EventExp.eval`` makes
one). The confidence filter and class-aware NMS run on the host
(``ops/boxes.py:postprocess``); labels, image sizes and ids stay on the
host. Rows from several processes are gathered with ``torch.distributed``
(the JAX package's ``multihost_utils.process_allgather``).

Each ``evaluate`` leaves its host seconds in ``self.timing``: the wait for
the loader (``data_s``), the forward with its copy to the host
(``forward_s``), the NMS (``nms_s``), the row assembly (``rows_s``), the
gather and the matching (``match_s``), the whole pass (``wall_s``) and the
sample count.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..data.psee_io import BBOX_DTYPE
from ..ops.boxes import postprocess
from .coco_map import DetEval, summarize
from .prophesee import PropheseeEvaluator, boxes_to_prophesee

__all__ = ["EventEvaluator", "PSEEEvaluator"]

ForwardFn = Callable[[torch.Tensor], np.ndarray]


def _allgather_rows(rows: np.ndarray) -> np.ndarray:
    """Rows of every process of the default group, in rank order; the
    identity when no process group is initialized. All-gather needs one
    shape on every process, so the counts are gathered first, each
    process's rows padded to the largest count, gathered, and the padding
    stripped."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return rows
    world = dist.get_world_size()
    if world == 1:
        return rows
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    n = torch.tensor([len(rows)], dtype=torch.int64, device=dev)
    counts = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(counts, n)
    counts = [int(c) for c in counts]
    width = rows.shape[1] if rows.ndim == 2 else 7
    padded = torch.zeros((max(counts), width), dtype=torch.float64,
                         device=dev)
    padded[:len(rows)] = torch.from_numpy(
        np.asarray(rows, np.float64).reshape(-1, width))
    gathered = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(gathered, padded)
    return np.concatenate([g[:c].cpu().numpy()
                           for g, c in zip(gathered, counts)], axis=0)


def _batches(loader, timing: Dict[str, float]):
    """The loader's batches, with the wait for each added to
    ``timing['data_s']``."""
    it = iter(loader)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        timing["data_s"] += time.perf_counter() - t0
        if batch is None:
            return
        yield batch


def _new_timing() -> Dict[str, float]:
    return dict(data_s=0.0, forward_s=0.0, nms_s=0.0, rows_s=0.0,
                match_s=0.0, wall_s=0.0, samples=0)


class EventEvaluator:
    """COCO-protocol mAP over an event dataset (map_val loader)."""

    def __init__(self, dataloader, img_size: Tuple[int, int],
                 confthre: float, nmsthre: float, num_classes: int,
                 per_class_report: bool = True):
        self.dataloader = dataloader
        self.img_size = img_size
        self.confthre = confthre
        self.nmsthre = nmsthre
        self.num_classes = num_classes
        self.per_class_report = per_class_report
        self.timing = _new_timing()
        # the gathered (detections, ground truth) rows of the last COCO pass
        self.last_rows = None

    def _letterbox_scale(self, img_h: float, img_w: float) -> float:
        return min(self.img_size[0] / img_h, self.img_size[1] / img_w)

    def _forward(self, forward_fn: ForwardFn, frames):
        """Decoded outputs of one batch, then its NMS, timed."""
        t0 = time.perf_counter()
        outputs = np.asarray(forward_fn(frames))
        t1 = time.perf_counter()
        dets = postprocess(outputs, self.num_classes, self.confthre,
                           self.nmsthre)
        self.timing["forward_s"] += t1 - t0
        self.timing["nms_s"] += time.perf_counter() - t1
        return dets

    def evaluate(self, forward_fn: ForwardFn) -> Tuple[float, float, str]:
        """(AP@[.5:.95], AP@.5, summary text) (reference evaluate:
        event_evaluator.py:122-263); rows assembled batch by batch with
        vectorized numpy, as the JAX package does."""
        self.timing = tm = _new_timing()
        t_start = time.perf_counter()
        det_blocks: List[np.ndarray] = []
        gt_blocks: List[np.ndarray] = []
        for frames, labels, img_sizes, ids in _batches(self.dataloader, tm):
            dets = self._forward(forward_fn, frames)
            t0 = time.perf_counter()
            for det, (img_h, img_w), sid, lab in zip(dets, img_sizes, ids,
                                                     labels):
                tm["samples"] += 1
                scale = self._letterbox_scale(float(img_h), float(img_w))
                # GT rows: raw-size [cx, cy, w, h, cls] -> corner xywh
                lab = np.asarray(lab, np.float64).reshape(-1, 5)
                if len(lab):
                    g = np.zeros((len(lab), 7), np.float64)
                    g[:, 0] = int(sid)
                    g[:, 1] = lab[:, 4]
                    g[:, 2] = lab[:, 0] - lab[:, 2] / 2
                    g[:, 3] = lab[:, 1] - lab[:, 3] / 2
                    g[:, 4] = lab[:, 2]
                    g[:, 5] = lab[:, 3]
                    gt_blocks.append(g)
                if det is None:
                    continue
                # det: (n, 7) [x1, y1, x2, y2, obj, cls_conf, cls]
                b = det[:, :4].astype(np.float64) / scale
                d = np.empty((len(det), 7), np.float64)
                d[:, 0] = int(sid)
                d[:, 1] = det[:, 6]
                d[:, 2] = b[:, 0]
                d[:, 3] = b[:, 1]
                d[:, 4] = b[:, 2] - b[:, 0]
                d[:, 5] = b[:, 3] - b[:, 1]
                d[:, 6] = det[:, 4] * det[:, 5]
                det_blocks.append(d)
            tm["rows_s"] += time.perf_counter() - t0

        def _cat(blocks):
            if not blocks:
                return np.zeros((0, 7), np.float64)
            return np.concatenate(blocks, axis=0)

        t0 = time.perf_counter()
        det_arr = _allgather_rows(_cat(det_blocks))
        gt_arr = _allgather_rows(_cat(gt_blocks))
        res = DetEval(self.num_classes).evaluate(det_arr, gt_arr)
        tm["match_s"] = time.perf_counter() - t0
        tm["wall_s"] = time.perf_counter() - t_start
        self.last_rows = (det_arr, gt_arr)
        class_names = getattr(self.dataloader.dataset, "class_names", ())
        text = summarize(res, class_names if self.per_class_report else ())
        n = tm["samples"]
        if n:
            text += (f"\n forward: {1000 * tm['forward_s'] / n:.2f} ms/img,"
                     f" NMS: {1000 * tm['nms_s'] / n:.2f} ms/img")
        return res.ap, res.ap50, text


class PSEEEvaluator(EventEvaluator):
    """Prophesee-protocol evaluation (reference psee_evaluator.py:86-307):
    predictions are rescaled to the sensor's resolution, stamped with the
    label time parsed from the sample names, buffered, and evaluated with
    the +/-50 ms protocol at the end."""

    def __init__(self, dataloader, img_size: Tuple[int, int],
                 confthre: float, nmsthre: float, num_classes: int,
                 camera: str = "gen1", downsampled_by_2: bool = False):
        super().__init__(dataloader, img_size, confthre, nmsthre,
                         num_classes)
        self.camera = camera
        self.downsampled_by_2 = downsampled_by_2

    @staticmethod
    def _parse_name(name: str) -> Tuple[str, int]:
        """'<stream>_r<idx>_a<time>' -> (stream, time_us) (reference
        get_time_from_name: psee_evaluator.py:285)."""
        stream, _, tail = name.rpartition("_r")
        t = int(tail.rpartition("_a")[2])
        return stream, t

    def evaluate(self, forward_fn: ForwardFn) -> Tuple[float, float, str]:
        self.timing = tm = _new_timing()
        t_start = time.perf_counter()
        ds = self.dataloader.dataset
        per_stream_gt: Dict[str, List] = defaultdict(list)
        per_stream_dt: Dict[str, List] = defaultdict(list)
        for frames, labels, img_sizes, ids in _batches(self.dataloader, tm):
            dets = self._forward(forward_fn, frames)
            t0 = time.perf_counter()
            for det, (img_h, img_w), sid, lab in zip(dets, img_sizes, ids,
                                                     labels):
                tm["samples"] += 1
                stream, t_us = self._parse_name(ds.sample_names[int(sid)])
                lab = np.asarray(lab)
                if lab.size:
                    # raw-size rows [cx, cy, w, h, cls] -> corner x/y
                    per_stream_gt[stream].append(
                        (t_us, lab[:, 0] - lab[:, 2] / 2,
                         lab[:, 1] - lab[:, 3] / 2, lab[:, 2], lab[:, 3],
                         lab[:, 4]))
                if det is None:
                    continue
                scale = self._letterbox_scale(float(img_h), float(img_w))
                b = det[:, :4] / scale
                per_stream_dt[stream].append(
                    (t_us, b[:, 0], b[:, 1], b[:, 2] - b[:, 0],
                     b[:, 3] - b[:, 1], det[:, 6], det[:, 4] * det[:, 5]))
            tm["rows_s"] += time.perf_counter() - t0

        # flatten to gatherable rows [stream_idx, t, x, y, w, h, cls, conf];
        # the stream names come from the dataset's table, so the indices
        # agree across processes
        t0 = time.perf_counter()
        stream_names = sorted({self._parse_name(n)[0]
                               for n in ds.sample_names})
        stream_idx = {n: i for i, n in enumerate(stream_names)}

        def flatten(per_stream, with_conf):
            blocks = []
            for stream, parts in per_stream.items():
                si = stream_idx[stream]
                for part in parts:
                    if with_conf:
                        t_us, x, y, w, h, cls, conf = part
                    else:
                        t_us, x, y, w, h, cls = part
                        conf = np.ones(len(x), np.float32)
                    blocks.append(np.column_stack([
                        np.full(len(x), si, np.float64),
                        np.full(len(x), t_us, np.float64),
                        x, y, w, h, cls, conf,
                    ]))
            if not blocks:
                return np.zeros((0, 8), np.float64)
            return np.concatenate(blocks, axis=0).astype(np.float64)

        gt_rows = _allgather_rows(flatten(per_stream_gt, False))
        dt_rows = _allgather_rows(flatten(per_stream_dt, True))

        evaluator = PropheseeEvaluator(self.camera, self.downsampled_by_2)
        for si in range(len(stream_names)):
            g = gt_rows[gt_rows[:, 0] == si]
            d = dt_rows[dt_rows[:, 0] == si]
            if not len(g) and not len(d):
                continue
            evaluator.add_labels(boxes_to_prophesee(
                g[:, 1].astype(np.int64), g[:, 2], g[:, 3], g[:, 4], g[:, 5],
                g[:, 6].astype(np.int64), g[:, 7].astype(np.float32),
            ) if len(g) else np.zeros(0, BBOX_DTYPE))
            evaluator.add_predictions(boxes_to_prophesee(
                d[:, 1].astype(np.int64), d[:, 2], d[:, 3], d[:, 4], d[:, 5],
                d[:, 6].astype(np.int64), d[:, 7].astype(np.float32),
            ) if len(d) else np.zeros(0, BBOX_DTYPE))
        metrics = evaluator.evaluate_buffer()
        tm["match_s"] = time.perf_counter() - t0
        tm["wall_s"] = time.perf_counter() - t_start
        text = "\n".join(f" {k}: {v:.4f}" for k, v in metrics.items()
                         if not isinstance(v, dict))
        n = tm["samples"]
        if n:
            text += f"\n forward: {1000 * tm['forward_s'] / n:.2f} ms/img"
        return metrics["AP"], metrics["AP_50"], text
