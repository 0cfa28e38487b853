"""Shared event-detection dataset machinery (the port's copy of
``eas_snn_tpu/data/event_dataset.py``, as a ``torch.utils.data.Dataset``;
reference yolox/data/datasets/gen1.py:43-521).

  * label index: per-file lists of (timestamp, (N, 5) xyxy+cls boxes)
    groups; global sample index -> (file, group) via cumsum + searchsorted
    (gen1.py:263-267);
  * slice generation: ``Tl`` aggregated frames ending at the label
    timestamp, each window loaded with a fixed ``window`` span and the
    reference's zero-event backoff (gen1.py:115-137, 217-236);
  * aggregation dispatch to the representations of reps.py (``sum``,
    ``micro_sum``, ``voxel_grid``, ``voxel_cube``, ``timesurface``;
    gen1.py:330-373), and the frame prestore cache (``cache_path``: 'ram'
    or a directory, cache.py; reference gen4.py:99-120);
  * joint augmentation + target transform (augment.py), or, for device
    binning, host-indexed raw events (``getitem_raw``);
  * mAP-val mode returning raw-sensor-size boxes + sample ids
    (gen1.py:191-197).

Samples are numpy arrays, as the JAX package's; ``loader.py`` collates
them into tensors. ``rng`` draws the augmentation; the loader reseeds each
worker's copy.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.utils.data

from .augment import (
    TrainTransform,
    ValTransform,
    letterbox,
    random_resize_place_flip,
    resize_frames,
    xyxy2cxcywh_np,
)
from .cache import SampleCache
from .reps import (micro_sum, polarity_histogram, slice_time_windows,
                   timesurface, voxel_cube, voxel_grid)

__all__ = ["EventDetDataset", "LabelGroup"]

LabelGroup = Tuple[int, np.ndarray]  # (timestamp_us, (N, 5) [x1,y1,x2,y2,cls])

AGGREGATIONS = ("sum", "micro_sum", "voxel_grid", "voxel_cube", "timesurface")


class EventDetDataset(torch.utils.data.Dataset):
    """Base class; subclasses implement ``_load_index`` (fill ``self.files``
    and ``self.labels``) and ``events_in_window(file_idx, t0, t1)``."""

    def __init__(
        self,
        data_dir: str,
        input_size: Tuple[int, int],
        img_size: Tuple[int, int],
        *,
        training: bool = True,
        map_val: bool = False,
        aggregation: str = "micro_sum",
        num_slice: int = 1,       # Tl
        micro_slice: int = 1,     # Tm
        window: Tuple[int, int] = (-200000, 0),  # us, relative to label time
        overlap: float = 0.0,
        measure: str = "count",
        max_labels: int = 50,
        flip_prob: float = 0.5,
        jitter: float = 0.3,
        letterbox_val: bool = True,
        raw_events: bool = False,
        max_events_per_slice: int = 131072,
        cache_path: Optional[str] = None,  # frame prestore (gen4.py:99-120)
        seed: int = 0,
        class_names: Sequence[str] = (),
    ):
        self.data_dir = data_dir
        self.input_size = tuple(input_size)
        self.img_size = tuple(img_size)
        self.training = training
        self.map_val = map_val
        self.aggregation = aggregation
        self.num_slice = num_slice
        self.micro_slice = micro_slice
        self.window = tuple(window)
        self.overlap = overlap
        self.measure = measure
        self.flip_prob = flip_prob
        self.jitter = jitter
        self.letterbox_val = letterbox_val
        self.raw_events = raw_events
        self.max_events_per_slice = max_events_per_slice
        self._frame_cache = None
        if cache_path is not None:
            self._frame_cache = SampleCache(
                cache_path if cache_path != "ram" else None)
        self.class_names = tuple(class_names)
        self.target_transform = (
            TrainTransform(max_labels) if not map_val else ValTransform()
        )
        self.rng = np.random.default_rng(seed)

        # cumulative per-stage latency profile (reference gen1.py:84)
        self.profile = {"slicing_s": 0.0, "augment_s": 0.0, "count": 0}
        self.files: List[str] = []
        self.labels: List[List[LabelGroup]] = []
        self._load_index()
        self.end_idx = np.cumsum([len(groups) for groups in self.labels])
        self.sample_names = [
            self.sample_name(f, g)
            for f in range(len(self.labels))
            for g in range(len(self.labels[f]))
        ]
        self.name_to_id: Dict[str, int] = {
            n: i for i, n in enumerate(self.sample_names)
        }

    # ------------------------------------------------------------------
    # subclass interface
    # ------------------------------------------------------------------
    def _load_index(self):
        raise NotImplementedError

    def events_in_window(self, file_idx: int, t0: int, t1: int) -> np.ndarray:
        """Decoded events of stream ``file_idx`` with t0 <= t < t1."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return int(self.end_idx[-1]) if len(self.end_idx) else 0

    def resolve_index(self, index: int) -> Tuple[int, int]:
        file = int(np.searchsorted(self.end_idx, index, side="right"))
        if not 0 <= index < len(self):
            raise IndexError(f"index {index} outside a dataset of "
                             f"{len(self)} samples")
        group = index - (int(self.end_idx[file - 1]) if file > 0 else 0)
        return file, group

    def sample_name(self, file_idx: int, group_idx: int) -> str:
        base = os.path.basename(self.files[file_idx]).split("_bbox.npy")[0]
        t = self.labels[file_idx][group_idx][0]
        return f"{base}_r{group_idx}_a{t}"

    # ------------------------------------------------------------------
    # slicing + aggregation
    # ------------------------------------------------------------------
    def search_events(self, file_idx: int, timestamp: int) -> np.ndarray:
        """Load the fixed window ending at ``timestamp``; if empty, back off
        window-by-window up to num_slice times (gen1.py:217-236)."""
        w0, w1 = self.window
        span = w1 - w0
        cur = timestamp + w0
        # the reference's zero_trigger loop makes num_slice + 2 attempts
        # (gen1.py:222-231: break only once zero_trigger > num_slice)
        for trigger in range(self.num_slice + 2):
            if cur <= 0:
                # reference seek_time(<=0) resets to t=0 and load_delta_t
                # then spans a FULL window from 0 (psee_loader.py:208-210 +
                # :128-170) — the window end extends to `span`, it is not
                # clamped to cur + span.
                events = self.events_in_window(file_idx, 0, span)
            else:
                events = self.events_in_window(file_idx, cur, cur + span)
            if len(events) > 0:
                return events
            cur -= span
        return events

    def generate_slices(self, file_idx: int, group_idx: int) -> np.ndarray:
        """``Tl`` aggregated frames ending at the label timestamp
        (continuous mode, gen1.py:115-127); served from the frame prestore
        cache where there is one (reference gen4.py:99-120)."""
        key = None
        if self._frame_cache is not None:
            key = self.sample_name(file_idx, group_idx)
            hit = self._frame_cache.read(key)
            if hit is not None:
                return hit
        timestamp = int(self.labels[file_idx][group_idx][0])
        w0, w1 = self.window
        span = w1 - w0
        frames = np.stack([
            self.aggregate(self.search_events(file_idx, timestamp + k * span))
            for k in range(-self.num_slice + 1, 1)
        ], 0)
        if key is not None:
            self._frame_cache.write(key, frames)
        return frames

    def aggregate(self, events: Optional[np.ndarray]) -> np.ndarray:
        """One window's frames: (H, W, 2) for ``sum``, else (Tm, H, W, C)
        with C 2 (``micro_sum``, ``timesurface``), 1 (``voxel_grid``) or 4
        (``voxel_cube``); zeros of that shape for an empty window."""
        h, w = self.img_size
        Tm = self.micro_slice
        empty = events is None or len(events) == 0
        if self.aggregation == "sum":
            if empty:
                return np.zeros((h, w, 2), np.float32)
            return polarity_histogram(events, h, w)
        if self.aggregation == "micro_sum":
            if empty:
                return np.zeros((Tm, h, w, 2), np.float32)
            return micro_sum(events, Tm, h, w)
        if self.aggregation == "voxel_grid":
            if empty:
                return np.zeros((Tm, h, w, 1), np.float32)
            return voxel_grid(events, h, w, n_time_bins=Tm)
        if self.aggregation == "voxel_cube":
            if empty:
                return np.zeros((Tm, h, w, 4), np.float32)
            return voxel_cube(events, h, w, num_slices=Tm)
        if self.aggregation == "timesurface":
            if empty:
                return np.zeros((Tm, h, w, 2), np.float32)
            slices, dt = slice_time_windows(events, Tm, self.overlap)
            return timesurface(slices, h, w, dt=dt, tau=50e3)
        raise ValueError(f"unknown aggregation '{self.aggregation}' (the "
                         f"datasets have {AGGREGATIONS})")

    # ------------------------------------------------------------------
    def raw_boxes(self, file_idx: int, group_idx: int) -> np.ndarray:
        """(N, 5) [x1, y1, x2, y2, cls] at raw sensor resolution."""
        return self.labels[file_idx][group_idx][1].astype(np.float32).copy()

    def getitem_raw(self, index: int):
        """On-device-binning sample: instead of dense frame stacks, emit
        per-slice padded event arrays with precomputed micro-bin indices —
        the host ships ~5 small int arrays and the trainer scatter-adds
        them into (Tl, Tm, H, W, 2) on device (SURVEY.md §7 hard part 5).

        Augmentation happens in *event coordinate space* via the same
        affine the frame path uses (nearest-pixel assignment instead of a
        bilinear frame resize — exact when scale == 1, crisper otherwise).
        Returns ((b, x, y, p, valid) each (Tl, N), labels, img_size, sid).
        """
        from .augment import apply_affine_to_boxes, sample_affine

        file_idx, group_idx = self.resolve_index(index)
        raw = self.raw_boxes(file_idx, group_idx)
        affine = sample_affine(
            self.img_size, self.input_size, self.rng,
            training=self.training, jitter=self.jitter,
            flip_prob=self.flip_prob,
        )
        h, w = self.input_size
        Tl, Tm, N = self.num_slice, self.micro_slice, self.max_events_per_slice
        timestamp = int(self.labels[file_idx][group_idx][0])
        w0, w1 = self.window
        span = w1 - w0

        bb = np.zeros((Tl, N), np.int32)
        xx = np.zeros((Tl, N), np.int32)
        yy = np.zeros((Tl, N), np.int32)
        pp = np.zeros((Tl, N), np.int32)
        vv = np.zeros((Tl, N), bool)
        for s, k in enumerate(range(-Tl + 1, 1)):
            ev = self.search_events(file_idx, timestamp + k * span)
            if len(ev) == 0:
                continue
            if len(ev) > N:
                ev = ev[len(ev) - N:]
            n = len(ev)
            t_rel = ev["t"].astype(np.int64) - int(ev["t"][0])
            tw = max(int(t_rel[-1]) // Tm, 1)
            b = (t_rel // tw).astype(np.int32)
            inside_t = b < Tm
            ex = ev["x"].astype(np.float64) * affine["sx"] + affine["dx"]
            ey = ev["y"].astype(np.float64) * affine["sy"] + affine["dy"]
            if affine["flip"]:
                ex = w - 1 - ex
            ix = np.floor(ex).astype(np.int32)
            iy = np.floor(ey).astype(np.int32)
            ok = inside_t & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            bb[s, :n] = np.clip(b, 0, Tm - 1)
            xx[s, :n] = np.clip(ix, 0, w - 1)
            yy[s, :n] = np.clip(iy, 0, h - 1)
            pp[s, :n] = ev["p"]
            vv[s, :n] = ok

        boxes = apply_affine_to_boxes(raw, affine, self.input_size)
        cxcywh = xyxy2cxcywh_np(boxes) if len(boxes) else boxes
        _, padded = self.target_transform(None, cxcywh, self.input_size)
        sid = self.name_to_id[self.sample_name(file_idx, group_idx)]
        return (bb, xx, yy, pp, vv), padded, self.img_size, sid

    def __getitem__(self, index: int):
        if self.raw_events:
            return self.getitem_raw(index)
        file_idx, group_idx = self.resolve_index(index)
        raw = self.raw_boxes(file_idx, group_idx)
        t0 = time.perf_counter()
        frames = self.generate_slices(file_idx, group_idx)  # (Tl, ..., H, W, C)
        t1 = time.perf_counter()
        multi_micro = frames.ndim > 4
        if multi_micro:
            Tl, Tm = frames.shape[:2]
            frames = frames.reshape((-1,) + frames.shape[2:])

        if self.training:
            frames, boxes = random_resize_place_flip(
                frames, raw, self.input_size, self.rng,
                jitter=self.jitter, flip_prob=self.flip_prob,
            )
        elif self.letterbox_val:
            frames, boxes = letterbox(frames, raw, self.input_size)
        else:
            frames = resize_frames(
                frames, (self.input_size[1], self.input_size[0])
            )
            h, w = self.input_size
            ih, iw = self.img_size
            boxes = raw.copy()
            boxes[:, [0, 2]] *= w / iw
            boxes[:, [1, 3]] *= h / ih

        if multi_micro:
            frames = frames.reshape((Tl, Tm) + frames.shape[1:])
        self.profile["slicing_s"] += t1 - t0
        self.profile["augment_s"] += time.perf_counter() - t1
        self.profile["count"] += 1

        sid = self.name_to_id[self.sample_name(file_idx, group_idx)]
        if self.map_val:
            # raw-resolution cxcywh boxes for protocol eval (gen1.py:191-197)
            raw_c = xyxy2cxcywh_np(raw) if len(raw) else raw
            frames, raw_c = self.target_transform(frames, raw_c, self.input_size)
            return frames, raw_c, self.img_size, sid
        cxcywh = xyxy2cxcywh_np(boxes) if len(boxes) else boxes
        frames, padded = self.target_transform(frames, cxcywh, self.input_size)
        return frames, padded, self.img_size, sid
