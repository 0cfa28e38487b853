"""Data layer of the port: event IO, representations, the Gen1 dataset,
the loader (the port's counterpart of ``eas_snn_tpu/data/``; reference
yolox/data/* and yolox/utils/psee_loader/io/*).

Ported: Gen1 (``gen1.py``) with ``sum`` / ``micro_sum`` frames, the
train/val augmentation, device binning and the loader. Not yet
(ROADMAP.md §1 item 8): the Gen4, RVT-Gen4 and N-Caltech datasets, mosaic,
concat, the frame prestore cache and the other aggregations.
"""

import os

from .augment import (TrainTransform, ValTransform, letterbox,
                      random_resize_place_flip, resize_frames)
from .event_dataset import EventDetDataset
from .gen1 import GEN1_CLASSES, Gen1Dataset, group_boxes_by_time
from .loader import (DevicePrefetcher, EventDataLoader, InfiniteSampler,
                     SequentialSampler, collate_event_batch)
from .psee_io import (BBOX_DTYPE, EVENT_DTYPE, EventStream, load_bboxes,
                      write_bboxes_npy, write_dat_events)
from .reps import (bin_event_batch, micro_sum, pad_events,
                   polarity_histogram, slice_time_windows)

__all__ = [
    "build_dataset", "TrainTransform", "ValTransform", "letterbox",
    "random_resize_place_flip", "resize_frames", "EventDetDataset",
    "Gen1Dataset", "GEN1_CLASSES", "group_boxes_by_time",
    "DevicePrefetcher", "EventDataLoader", "InfiniteSampler",
    "SequentialSampler", "collate_event_batch", "EventStream", "EVENT_DTYPE",
    "BBOX_DTYPE", "load_bboxes", "write_dat_events", "write_bboxes_npy",
    "polarity_histogram", "micro_sum", "slice_time_windows", "pad_events",
    "bin_event_batch",
]

_NOT_PORTED = ("gen4", "rvt-gen4", "rvt_gen4", "rvtgen4", "n-caltech",
               "ncaltech", "n-caltech101")


def build_dataset(data_name: str, data_dir: str, training: bool = True,
                  map_val: bool = False, input_size=(640, 640), **kw):
    """Dataset by name (reference exp dispatch: yolox/exp/
    event_yolox_base.py:220-247, 445-482): ``gen1`` reads
    ``<data_dir>/{train,val}`` where that split directory exists, else
    ``data_dir``."""
    name = data_name.lower()
    if name == "gen1":
        sub = os.path.join(data_dir, "train" if training else "val")
        root = sub if os.path.isdir(sub) else data_dir
        return Gen1Dataset(root, input_size=input_size, training=training,
                           map_val=map_val, **kw)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset '{data_name}' is not ported yet (the port reads "
            "gen1): ROADMAP.md §1 item 8")
    raise KeyError(f"unknown dataset '{data_name}'")
