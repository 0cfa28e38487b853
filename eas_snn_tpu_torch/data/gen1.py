"""Prophesee GEN1 automotive detection dataset, raw `.dat` + `_bbox.npy`
(the port's copy of ``eas_snn_tpu/data/gen1.py``; reference
yolox/data/datasets/gen1.py:43-528): label grouping by timestamp, the 4
corrupted sequences skipped, continuous windowed slicing over shared
memory-mapped ``EventStream`` readers.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

import numpy as np

from .event_dataset import EventDetDataset
from .psee_io import EventStream, load_bboxes

__all__ = ["Gen1Dataset", "GEN1_CLASSES", "GEN1_DIRS_TO_IGNORE", "group_boxes_by_time"]

GEN1_CLASSES = ("car", "pedestrian")

# sequences whose labels are all removed by the eval filter chain
# (reference gen1.py:24-30)
GEN1_DIRS_TO_IGNORE = (
    "17-04-06_09-57-37_6344500000_6404500000",
    "17-04-13_19-17-27_976500000_1036500000",
    "17-04-06_15-14-36_1159500000_1219500000",
    "17-04-11_15-13-23_122500000_182500000",
)


def group_boxes_by_time(boxes: np.ndarray) -> List[Tuple[int, np.ndarray]]:
    """Group a bbox record array into per-timestamp (t, (N, 5) xyxy+cls)
    label groups (reference extract_labels: gen1.py:269-311 — here one
    vectorized unique() instead of an event-at-a-time reader loop)."""
    if len(boxes) == 0:
        return []
    ts = boxes["t"].astype(np.int64)
    if not np.all(np.diff(ts) >= 0):
        raise ValueError("label times must be ascending")
    xyxy = np.stack(
        [
            boxes["x"],
            boxes["y"],
            boxes["x"] + boxes["w"],
            boxes["y"] + boxes["h"],
            boxes["class_id"].astype(np.float32),
        ],
        axis=-1,
    ).astype(np.float32)
    _, starts = np.unique(ts, return_index=True)
    groups = []
    for i, s in enumerate(starts):
        e = starts[i + 1] if i + 1 < len(starts) else len(ts)
        groups.append((int(ts[s]), xyxy[s:e]))
    return groups


class Gen1Dataset(EventDetDataset):
    """304x240 GEN1; 2 classes; streams resolved as
    ``<seq>_td.dat`` / ``<seq>_bbox.npy`` pairs in ``data_dir``."""

    def __init__(self, data_dir: str, input_size=(256, 320),
                 img_size=(240, 304), **kw):
        kw.setdefault("class_names", GEN1_CLASSES)
        self._streams: Dict[int, EventStream] = {}
        super().__init__(data_dir, input_size, img_size=img_size, **kw)

    def _load_index(self):
        paths = self.data_dir if isinstance(self.data_dir, list) else [self.data_dir]
        for root in paths:
            for fname in sorted(os.listdir(root)):
                if not fname.endswith("_bbox.npy"):
                    continue
                seq = re.split("_bbox|_td", fname)[0]
                if seq in GEN1_DIRS_TO_IGNORE:
                    continue
                path = os.path.join(root, fname)
                groups = group_boxes_by_time(load_bboxes(path))
                if groups:
                    self.files.append(path)
                    self.labels.append(groups)

    def _stream(self, file_idx: int) -> EventStream:
        if file_idx not in self._streams:
            dat = self.files[file_idx].replace("_bbox.npy", "_td.dat")
            if not os.path.exists(dat):
                dat = self.files[file_idx].replace("_bbox.npy", "_td.npy")
            self._streams[file_idx] = EventStream(dat)
        return self._streams[file_idx]

    def events_in_window(self, file_idx: int, t0: int, t1: int) -> np.ndarray:
        return self._stream(file_idx).events_between(max(t0, 0), max(t1, 0))
