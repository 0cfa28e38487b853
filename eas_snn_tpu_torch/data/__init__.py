"""Data layer of the port: event IO, representations, the datasets, the
loader (the port's counterpart of ``eas_snn_tpu/data/``; reference
yolox/data/* and yolox/utils/psee_loader/io/*).

Datasets: Gen1 (``gen1.py``), raw 1Mpx and RVT-preprocessed 1Mpx
(``gen4.py``; the RVT reader needs ``h5py``), N-Caltech101
(``ncaltech.py``) and their unions (``concat.py``), every aggregation of
``reps.py`` and the frame prestore cache (``cache.py``). The RGB family:
COCO and VOC (``coco.py``), mosaic and mixup (``mosaic.py``) and the
image IO they read through (``image.py``: JPEG and PNG, cv2's resize and
warp, without cv2).
"""

import os

from .augment import (TrainTransform, ValTransform, letterbox,
                      random_resize_place_flip, resize_frames)
from .cache import SampleCache
from .coco import VOC_CLASSES, COCODataset, VOCDataset
from .concat import ConcatDataset, MixConcatDataset
from .event_dataset import EventDetDataset
from .gen1 import GEN1_CLASSES, Gen1Dataset, group_boxes_by_time
from .gen4 import GEN4_CLASSES, Gen4Dataset, RVTGen4Dataset
from .image import imread
from .loader import (DevicePrefetcher, EventDataLoader, InfiniteSampler,
                     SequentialSampler, collate_event_batch)
from .mosaic import MosaicDataset
from .ncaltech import (NCaltechDataset, encode_atis, read_atis_events,
                       read_ncaltech_annotation)
from .psee_io import (BBOX_DTYPE, EVENT_DTYPE, EventStream, load_bboxes,
                      write_bboxes_npy, write_dat_events)
from .reps import (bin_event_batch, bin_events_device, micro_sum, pad_events,
                   polarity_histogram, slice_time_windows, timesurface,
                   timesurface_measure, voxel_cube, voxel_grid)

__all__ = [
    "build_dataset", "TrainTransform", "ValTransform", "letterbox",
    "random_resize_place_flip", "resize_frames", "EventDetDataset",
    "Gen1Dataset", "Gen4Dataset", "RVTGen4Dataset", "NCaltechDataset",
    "GEN1_CLASSES", "GEN4_CLASSES", "group_boxes_by_time",
    "DevicePrefetcher", "EventDataLoader", "InfiniteSampler",
    "SequentialSampler", "collate_event_batch", "SampleCache",
    "ConcatDataset", "MixConcatDataset", "EventStream", "EVENT_DTYPE",
    "BBOX_DTYPE", "load_bboxes", "write_dat_events", "write_bboxes_npy",
    "read_atis_events", "read_ncaltech_annotation", "encode_atis",
    "polarity_histogram", "micro_sum", "voxel_grid", "voxel_cube",
    "timesurface", "timesurface_measure", "slice_time_windows",
    "pad_events", "bin_event_batch", "bin_events_device", "COCODataset",
    "VOCDataset", "VOC_CLASSES", "MosaicDataset", "imread",
]


def _split_root(data_dir: str, training: bool) -> str:
    """``<data_dir>/{train,val}`` where that split directory exists, else
    ``data_dir``."""
    sub = os.path.join(data_dir, "train" if training else "val")
    return sub if os.path.isdir(sub) else data_dir


def build_dataset(data_name: str, data_dir: str, training: bool = True,
                  map_val: bool = False, input_size=(640, 640), **kw):
    """Dataset by name (reference exp dispatch: yolox/exp/
    event_yolox_base.py:220-247, 445-482; JAX ``data/__init__.py:73-127``):

    * ``n-caltech`` / ``ncaltech`` / ``n-caltech101``: the seeded split
      files' train or val list; a ``window`` (w0, w1) with w0 < 0 crops
      each stream to its last -w0 us, any other window (the presets'
      (0, 0)) keeps the whole stream; ``speed_aug`` reaches it alone;
    * ``gen1``, ``gen4`` (raw 1Mpx): ``<data_dir>/{train,val}``;
    * ``rvt-gen4`` / ``rvt_gen4`` / ``rvtgen4``: the same split rule; the
      slicing knobs ``aggregation``, ``window`` and ``measure`` do not
      apply to precomputed representations and are dropped.
    """
    name = data_name.lower()
    speed_aug = kw.pop("speed_aug", False)
    if name in ("n-caltech", "ncaltech", "n-caltech101"):
        win = kw.pop("window", None)
        return NCaltechDataset(
            data_dir, input_size=input_size,
            split="train" if training else "val",
            window=win if (win and win[0] < 0) else None,
            speed_aug=speed_aug, training=training, map_val=map_val, **kw)
    if name in ("gen1", "gen4"):
        cls = Gen1Dataset if name == "gen1" else Gen4Dataset
        return cls(_split_root(data_dir, training), input_size=input_size,
                   training=training, map_val=map_val, **kw)
    if name in ("rvt-gen4", "rvt_gen4", "rvtgen4"):
        for k in ("aggregation", "window", "measure"):
            kw.pop(k, None)
        return RVTGen4Dataset(_split_root(data_dir, training),
                              input_size=input_size, training=training,
                              map_val=map_val, **kw)
    raise KeyError(f"unknown dataset '{data_name}'")
