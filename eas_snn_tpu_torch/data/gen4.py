"""Prophesee 1Mpx (Gen4) datasets, raw streams and RVT-preprocessed HDF5
(the port's copy of ``eas_snn_tpu/data/gen4.py``).

* ``Gen4Dataset``: raw 720x1280 ``.dat`` / ``.npy`` streams with their
  ``_bbox.npy`` labels, the Gen1 skeleton (reference yolox/data/datasets/
  gen4.py:46-975), with RVT's label filters applied at index time
  (reference gen4.py:399 apply_filters).
* ``RVTGen4Dataset``: RVT's stacked histograms (reference yolox/data/
  datasets/rvt_gen4.py:56-639): per sequence ``event_representations_v2/
  <rep>/event_representations_ds2_nearest.h5`` and
  ``objframe_idx_2_repr_idx.npy``; labels from ``labels_v2/labels.npz``
  rescaled by 1 / down_sample_factor into the ds2 360x640 frame
  (rvt_gen4.py:365-409). The label filters (``filter_labels``) are off by
  default: RVT's preprocessing ships them filtered. Reading a
  representation needs ``h5py``, imported at the first read.
"""

from __future__ import annotations

import os
import numpy as np

from .event_dataset import EventDetDataset
from .gen1 import Gen1Dataset, group_boxes_by_time
from .psee_io import load_bboxes

__all__ = ["Gen4Dataset", "RVTGen4Dataset", "GEN4_CLASSES",
           "apply_label_filters"]

GEN4_CLASSES = ("pedestrian", "two wheeler", "car", "truck", "bus",
                "traffic sign", "traffic light")


def apply_label_filters(x: np.ndarray, y: np.ndarray, w: np.ndarray,
                        h: np.ndarray, cls: np.ndarray, frame_h: int,
                        frame_w: int) -> np.ndarray:
    """RVT's Gen4 label filter chain (rvt_gen4.py:302-360): crops x, y, w,
    h to the field of view in place and returns the keep mask of classes
    pedestrian / two wheeler / car with both sides of at least 5 px and a
    width of at most 0.9 of the frame's."""
    keep = cls <= 2
    x1 = np.clip(x, 0, frame_w - 1)
    y1 = np.clip(y, 0, frame_h - 1)
    x2 = np.clip(x + w, 0, frame_w - 1)
    y2 = np.clip(y + h, 0, frame_h - 1)
    x[:], y[:], w[:], h[:] = x1, y1, x2 - x1, y2 - y1
    keep &= (w > 0) & (h > 0)
    keep &= (w >= 5) & (h >= 5)
    keep &= w <= (9 * frame_w) // 10
    return keep


class Gen4Dataset(Gen1Dataset):
    """Raw 1Mpx streams at 720x1280 (reference gen4.py:46-47). No sequence
    is skipped, and the reference's 5-file cap (gen4.py:375 max_files, a
    debugging leftover) is not kept."""

    def __init__(self, data_dir: str, input_size=(384, 640), **kw):
        kw.setdefault("class_names", GEN4_CLASSES)
        # the label filters crop to the frame: img_size must be set before
        # the base class reads the index
        kw.setdefault("img_size", (720, 1280))
        super().__init__(data_dir, input_size, **kw)

    def _load_index(self):
        paths = (self.data_dir if isinstance(self.data_dir, list)
                 else [self.data_dir])
        for root in paths:
            for fname in sorted(os.listdir(root)):
                if not fname.endswith("_bbox.npy"):
                    continue
                boxes = load_bboxes(os.path.join(root, fname))
                if len(boxes):
                    x = boxes["x"].astype(np.float32).copy()
                    y = boxes["y"].astype(np.float32).copy()
                    w = boxes["w"].astype(np.float32).copy()
                    h = boxes["h"].astype(np.float32).copy()
                    cls = boxes["class_id"].astype(np.float32)
                    keep = apply_label_filters(x, y, w, h, cls,
                                               self.img_size[0],
                                               self.img_size[1])
                    boxes = boxes.copy()
                    boxes["x"], boxes["y"] = x, y
                    boxes["w"], boxes["h"] = w, h
                    boxes = boxes[keep]
                groups = group_boxes_by_time(boxes)
                if groups:
                    self.files.append(os.path.join(root, fname))
                    self.labels.append(groups)


class RVTGen4Dataset(EventDetDataset):
    """RVT stacked-histogram 1Mpx at ds2 (360x640). A sample's frames are
    (1, Tl, H, W, C): the ``Tl`` representations that end at the label
    frame, zero-padded where the stream has fewer, act as micro-steps;
    ``event_sum`` collapses the 10 time bins of each polarity to one
    channel (C 2)."""

    def __init__(self, data_dir: str, input_size=(384, 640),
                 rep_name: str = "stacked_histogram_dt=50_nbins=10",
                 down_sample_factor: int = 2,
                 aggregation: str = "event_sum",
                 filter_labels: bool = False, **kw):
        self.rep_name = rep_name
        self.down_sample_factor = down_sample_factor
        self.filter_labels = filter_labels
        kw.setdefault("class_names", GEN4_CLASSES[:3])
        kw["aggregation"] = aggregation
        super().__init__(data_dir, input_size, img_size=(360, 640), **kw)

    def sample_name(self, file_idx: int, group_idx: int) -> str:
        base = os.path.basename(self.files[file_idx].rstrip("/"))
        t = self.labels[file_idx][group_idx][0]
        return f"{base}_r{group_idx}_a{t}"

    def _load_index(self):
        paths = (self.data_dir if isinstance(self.data_dir, list)
                 else [self.data_dir])
        h, w = self.img_size
        s = 1.0 / self.down_sample_factor
        for root in paths:
            for seq in sorted(os.listdir(root)):
                label_dir = os.path.join(root, seq, "labels_v2")
                if not os.path.isdir(label_dir):
                    continue
                z = np.load(os.path.join(label_dir, "labels.npz"))
                times = np.load(os.path.join(label_dir, "timestamps_us.npy"))
                rows, frame_idx = z["labels"], z["objframe_idx_2_label_idx"]
                groups = []
                for i, lo in enumerate(frame_idx):
                    hi = (frame_idx[i + 1] if i + 1 < len(frame_idx)
                          else len(rows))
                    g = rows[lo:hi]
                    x = g["x"].astype(np.float32).copy()
                    y = g["y"].astype(np.float32).copy()
                    bw = g["w"].astype(np.float32).copy()
                    bh = g["h"].astype(np.float32).copy()
                    cls = g["class_id"].astype(np.float32)
                    if self.filter_labels:
                        keep = apply_label_filters(
                            x, y, bw, bh, cls, h * self.down_sample_factor,
                            w * self.down_sample_factor)
                        x, y, bw, bh, cls = (a[keep]
                                             for a in (x, y, bw, bh, cls))
                    # the ds2 rescale with the crop to the field of view
                    # (rvt_gen4.py:365-390)
                    x2 = np.clip((x + bw) * s, 0, w - 1)
                    y2 = np.clip((y + bh) * s, 0, h - 1)
                    x1 = np.clip(x * s, 0, w - 1)
                    y1 = np.clip(y * s, 0, h - 1)
                    keep = (x2 - x1 > 0) & (y2 - y1 > 0)
                    boxes = np.stack([x1, y1, x2, y2, cls],
                                     -1)[keep].astype(np.float32)
                    groups.append((int(times[i]), boxes))
                self.files.append(os.path.join(root, seq))
                self.labels.append(groups)

    def _rep_dir(self, file_idx: int) -> str:
        return os.path.join(self.files[file_idx], "event_representations_v2",
                            self.rep_name)

    def generate_slices(self, file_idx: int, group_idx: int) -> np.ndarray:
        """The ``Tl`` representations ending at the label frame, zero-padded
        before the stream's first (rvt_gen4.py:109-125)."""
        import h5py

        rep_dir = self._rep_dir(file_idx)
        idx_map = np.load(os.path.join(rep_dir, "objframe_idx_2_repr_idx.npy"))
        end = int(idx_map[group_idx]) + 1
        start = max(end - self.num_slice, 0)
        with h5py.File(os.path.join(
                rep_dir, "event_representations_ds2_nearest.h5"), "r") as f:
            rep = f["data"][start:end]  # (n, bins, H, W)
        if self.aggregation == "event_sum":
            rep = rep.reshape(rep.shape[0], 2, -1,
                              *rep.shape[-2:]).sum(axis=2)
        pad = np.zeros((self.num_slice - rep.shape[0],) + rep.shape[1:],
                       rep.dtype)
        rep = np.concatenate([pad, rep], axis=0)
        # (n, C, H, W) -> (1, n, H, W, C) (reference expand_dims at
        # rvt_gen4.py:124)
        return np.moveaxis(rep, 1, -1).astype(np.float32)[None]

    def events_in_window(self, file_idx: int, t0: int, t1: int) -> np.ndarray:
        raise ValueError("RVT representations are precomputed: the dataset "
                         "has no raw events (device binning and raw_events "
                         "need a raw reader)")
