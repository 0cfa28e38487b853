"""N-Caltech101 detection dataset: ATIS binary streams and contour
annotations (the port's copy of ``eas_snn_tpu/data/ncaltech.py``;
reference yolox/data/datasets/ncaltech.py:22-400): ATIS decode with the
13-bit timestamp overflow rows, the binary annotation reader, the seeded
per-class 0.8/0.2 split files, equal-duration slicing and measure-weighted
aggregation. ``speed_aug`` rescales a training stream's time axis (the
reference's ``SpeedVariator`` is undefined and crashes, SURVEY.md §2.11;
the JAX package replaces it the same way).
"""

from __future__ import annotations

import math
import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from .event_dataset import EventDetDataset
from .reps import (slice_time_windows, timesurface, timesurface_measure,
                   voxel_cube, voxel_grid)

__all__ = ["NCaltechDataset", "read_atis_events", "read_ncaltech_annotation",
           "write_ncaltech_annotation", "encode_atis", "write_split_files"]

ATIS_DTYPE = np.dtype([("x", "<i8"), ("y", "<i8"), ("t", "<i8"),
                       ("p", "<i8")])
NCALTECH_HW = (180, 240)  # the ATIS sensor's height and width


def read_atis_events(path_or_bytes, window: Optional[Tuple[int, int]] = None
                     ) -> np.ndarray:
    """A structured (x, y, t, p) array from an ATIS ``.bin`` stream (a path
    or its bytes). 5 bytes an event: x, y, then a 23-bit big-endian time
    whose first byte's top bit is the polarity; a row with y == 240 marks
    a timestamp overflow and adds 2^13 us to every later event (reference
    read_ATIS: ncaltech.py:63-96). ``window`` (w0, w1) with w0 < 0 keeps
    the events in (t_last + w0, t_last + w1]."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = np.frombuffer(path_or_bytes, np.uint8).astype(np.uint32)
    else:
        raw = np.fromfile(path_or_bytes, np.uint8).astype(np.uint32)
    x = raw[0::5]
    y = raw[1::5]
    p = (raw[2::5] & 128) >> 7
    t = ((raw[2::5] & 127) << 16) | (raw[3::5] << 8) | raw[4::5]
    t = t.astype(np.int64) + (1 << 13) * np.cumsum(y == 240)
    keep = y != 240
    out = np.empty(int(keep.sum()), ATIS_DTYPE)
    out["x"], out["y"], out["t"], out["p"] = x[keep], y[keep], t[keep], \
        p[keep]
    if window is not None and window[0] < 0 and len(out):
        lo, hi = out["t"][-1] + window[0], out["t"][-1] + window[1]
        out = out[(out["t"] > lo) & (out["t"] <= hi)]
    return out


def encode_atis(t, x, y, p) -> bytes:
    """The ``.bin`` bytes of events (t < 2^23 us, no overflow rows of its
    own: a row with y == 240 is written as given): the inverse of
    ``read_atis_events`` for synthetic streams."""
    t = np.asarray(t, np.int64)
    if not (t < (1 << 23)).all():
        raise ValueError("encode_atis: times must lie below 2^23 us")
    out = np.empty((len(t), 5), np.uint8)
    out[:, 0] = x
    out[:, 1] = y
    out[:, 2] = (np.asarray(p, np.int64) << 7) | (t >> 16)
    out[:, 3] = (t >> 8) & 255
    out[:, 4] = t & 255
    return out.tobytes()


def read_ncaltech_annotation(path: str) -> Tuple[List[int], np.ndarray]:
    """(box [x1, y1, x2, y2], object contour) of a binary annotation file:
    int16 rows, int16 cols, rows * cols int16 (Fortran order) of the box
    contour, then the same for the object contour (reference
    read_annotation: ncaltech.py:107-127)."""
    with open(path, "rb") as f:
        rows, = struct.unpack("h", f.read(2))
        cols, = struct.unpack("h", f.read(2))
        box_contour = np.fromfile(f, np.int16, rows * cols).reshape(
            (rows, cols), order="F")
        rows, = struct.unpack("h", f.read(2))
        cols, = struct.unpack("h", f.read(2))
        obj_contour = np.fromfile(f, np.int16, rows * cols).reshape(
            (rows, cols), order="F")
    box = [int(box_contour[0].min()), int(box_contour[1].min()),
           int(box_contour[0].max()), int(box_contour[1].max())]
    return box, obj_contour


def write_ncaltech_annotation(path: str, box, contour=None) -> None:
    """An annotation file that ``read_ncaltech_annotation`` reads back as
    ``box`` [x1, y1, x2, y2]: the box contour as its four corners (x row,
    y row), then ``contour`` (2, n) int16, by default the same corners."""
    x1, y1, x2, y2 = (int(v) for v in box)
    corners = np.array([[x1, x2, x2, x1], [y1, y1, y2, y2]], np.int16)
    obj = corners if contour is None else np.asarray(contour, np.int16)
    with open(path, "wb") as f:
        for arr in (corners, obj):
            f.write(struct.pack("hh", *arr.shape))
            f.write(arr.tobytes(order="F"))


def write_split_files(root: str, train_ratio=0.8, val_ratio=0.2, seed=0):
    """``<root>/{train,val,test}.txt``: each class's recordings shuffled by
    one seeded generator, the first ceil(0.8 n) to train, the next
    floor(0.2 n) to val, the rest to test; nothing is written where
    ``train.txt`` exists (reference split_dataset: ncaltech.py:136-170)."""
    data_path = os.path.join(root, "Caltech101")
    if os.path.exists(os.path.join(root, "train.txt")):
        return
    rng = np.random.default_rng(seed)
    splits = {"train": [], "val": [], "test": []}
    for cls_name in sorted(os.listdir(data_path)):
        names = sorted(os.listdir(os.path.join(data_path, cls_name)))
        rng.shuffle(names)
        pairs = [(os.path.join("Caltech101", cls_name, n),
                  os.path.join("Caltech101_annotations", cls_name,
                               n.replace("image", "annotation")))
                 for n in names]
        n_train = math.ceil(len(pairs) * train_ratio)
        n_val = int(len(pairs) * val_ratio)
        splits["train"] += pairs[:n_train]
        splits["val"] += pairs[n_train:n_train + n_val]
        splits["test"] += pairs[n_train + n_val:]
    for split, pairs in splits.items():
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.writelines(" ".join(p) + "\n" for p in pairs)


class NCaltechDataset(EventDetDataset):
    """One object box a sample; 100 classes (``BACKGROUND_Google``
    dropped); the 240x180 ATIS sensor; ``jitter`` 0.1 (reference
    ncaltech.py:371)."""

    def __init__(self, data_dir: str, input_size=(640, 640),
                 split: str = "train",
                 window: Optional[Tuple[int, int]] = None,
                 speed_aug: bool = False,
                 speed_scale: Tuple[float, float] = (0.5, 1.5),
                 tau: float = 500e3, **kw):
        self.split = split
        self.stream_window = window
        self.speed_aug = speed_aug
        self.speed_scale = speed_scale
        self.tau = tau
        kw.setdefault("window", (0, 0))
        kw.setdefault("jitter", 0.1)
        super().__init__(data_dir, input_size, img_size=NCALTECH_HW, **kw)

    def _load_index(self):
        root = self.data_dir
        names = tuple(n for n in sorted(os.listdir(os.path.join(
            root, "Caltech101"))) if n != "BACKGROUND_Google")
        if not self.class_names:
            self.class_names = names
        self.name_to_idx = {n: i for i, n in enumerate(self.class_names)}
        write_split_files(root)
        with open(os.path.join(root, f"{self.split}.txt")) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        for line in lines:
            if "BACKGROUND_Google" in line:
                continue
            data_rel, label_rel = line.split(" ")
            cls_name = data_rel.split("/")[-2]
            box, _ = read_ncaltech_annotation(os.path.join(root, label_rel))
            boxes = np.array([box + [self.name_to_idx[cls_name]]],
                             np.float32)
            self.files.append(os.path.join(root, data_rel))
            self.labels.append([(0, boxes)])

    def sample_name(self, file_idx: int, group_idx: int) -> str:
        path = self.files[file_idx]
        cls_name = path.split(os.sep)[-2]
        stem = os.path.basename(path).split(".")[0]
        return f"{cls_name}-{stem}"

    # ------------------------------------------------------------------
    def _measure(self, events: np.ndarray, t_target) -> np.ndarray:
        if self.measure == "count":
            return np.ones(len(events), np.float64)
        if self.measure == "timesurface":
            return timesurface_measure(events["t"].astype(np.float64),
                                       float(t_target), self.tau, "tanh")
        raise ValueError(f"unknown measure '{self.measure}' (N-Caltech has "
                         "'count' and 'timesurface')")

    def _sum_frame(self, events, t_target) -> np.ndarray:
        h, w = self.img_size
        frame = np.zeros((2, h, w), np.float64)
        if events is not None and len(events):
            np.add.at(frame, (events["p"].astype(np.int64) & 1,
                              events["y"].astype(np.int64),
                              events["x"].astype(np.int64)),
                      self._measure(events, t_target))
        return np.moveaxis(frame, 0, -1).astype(np.float32)  # (H, W, 2)

    def aggregate(self, events, t_target=None):
        """Measure-weighted aggregation of one window (reference
        ncaltech.py:227-270): ``sum``, ``voxel_grid``, ``voxel_cube``,
        ``timesurface`` and ``micro_sum``."""
        h, w = self.img_size
        Tm = self.micro_slice
        agg = self.aggregation
        if t_target is None and events is not None and len(events):
            t_target = events["t"][-1]
        if agg == "sum":
            return self._sum_frame(events, t_target)
        if agg == "voxel_grid":
            return voxel_grid(events, h, w, n_time_bins=Tm)
        if agg == "voxel_cube":
            return voxel_cube(events, h, w, num_slices=Tm, tbins=2)
        if agg == "timesurface":
            slices, dt = slice_time_windows(events, Tm, self.overlap)
            return timesurface(slices, h, w, dt=dt, tau=10e3)
        if agg == "micro_sum":
            slices, _ = slice_time_windows(events, Tm, 0.0)
            return np.stack([self._sum_frame(ms, t_target) for ms in slices],
                            0)
        raise ValueError(f"unknown aggregation '{agg}' (N-Caltech has sum, "
                         "micro_sum, voxel_grid, voxel_cube, timesurface)")

    def generate_slices(self, file_idx: int, group_idx: int) -> np.ndarray:
        events = read_atis_events(self.files[file_idx], self.stream_window)
        if self.speed_aug and self.training and len(events):
            s = self.rng.uniform(*self.speed_scale)
            events = events.copy()
            events["t"] = (events["t"] * s).astype(np.int64)
        slices, _ = slice_time_windows(events, self.num_slice, self.overlap)
        return np.stack([
            self.aggregate(ev, t_target=(ev["t"][-1] if ev is not None
                                         and len(ev) else None))
            for ev in slices], 0)
