"""RGB detection datasets, COCO json and VOC xml (counterpart of
``eas_snn_tpu/data/coco.py``; reference yolox/data/datasets/coco.py:33-200
COCODataset and voc.py VOCDetection).

The COCO json is parsed directly (no pycocotools) and the VOC xml by the
standard library's ElementTree. Images are read by the port's own
``data/image.py:imread`` (cv2's pixels, without cv2). Both datasets emit
the event pipeline's sample ``(frames (1, 1, H, W, 3), labels
(max_labels, 5), img_size, id)``, so that the loader, the trainer and the
evaluators drive the RGB models (an analog YOLOX on one frame of three
channels) as they drive the event models. The random draws are the JAX
package's, from ``np.random.default_rng(seed)`` in its order.
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .augment import (TrainTransform, ValTransform, letterbox,
                      random_resize_place_flip, xyxy2cxcywh_np)
from .image import imread

__all__ = ["COCODataset", "VOCDataset", "VOC_CLASSES"]

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class _RGBDetBase:
    """Maps an RGB image dataset onto the event sample contract."""

    def __init__(self, input_size, training, map_val, max_labels, flip_prob,
                 jitter=0.3, seed=0):
        self.input_size = tuple(input_size)
        self.training = training
        self.map_val = map_val
        self.flip_prob = flip_prob
        self.jitter = jitter
        self.rng = np.random.default_rng(seed)
        self.target_transform = (TrainTransform(max_labels) if not map_val
                                 else ValTransform())

    def _emit(self, img: np.ndarray, boxes: np.ndarray, sid: int):
        ih, iw = img.shape[:2]
        raw = boxes.copy()  # raw-resolution xyxy, before the letterbox
        frames = img.astype(np.float32)[None]  # (1, H, W, 3)
        if self.training:
            frames, boxes = random_resize_place_flip(
                frames, boxes, self.input_size, self.rng,
                jitter=self.jitter, flip_prob=self.flip_prob)
        else:
            frames, boxes = letterbox(frames, boxes, self.input_size)
        frames = frames[None]  # (Tl=1, Tm=1, H, W, 3)
        if self.map_val:
            # the evaluator rescales detections to the raw frame, so the
            # ground truth stays in it (as the event datasets' map_val)
            raw_c = xyxy2cxcywh_np(raw) if len(raw) else raw
            frames, raw_c = self.target_transform(frames, raw_c,
                                                  self.input_size)
            return frames, raw_c, (ih, iw), sid
        cxcywh = xyxy2cxcywh_np(boxes) if len(boxes) else boxes
        frames, padded = self.target_transform(frames, cxcywh,
                                               self.input_size)
        return frames, padded, (ih, iw), sid


class COCODataset(_RGBDetBase):
    """COCO-format detection: ``<data_dir>/annotations/<json_file>`` and
    the images under ``<data_dir>/<name>/``. Crowd annotations are
    dropped; boxes are clipped to the image, and empty ones dropped."""

    def __init__(self, data_dir: str,
                 json_file: str = "instances_train2017.json",
                 name: str = "train2017", input_size=(640, 640),
                 training: bool = True, map_val: bool = False,
                 max_labels: int = 50, flip_prob: float = 0.5, **kw):
        super().__init__(input_size, training, map_val, max_labels, flip_prob)
        self.data_dir = data_dir
        self.name = name
        with open(os.path.join(data_dir, "annotations", json_file)) as f:
            coco = json.load(f)
        cats = sorted(coco["categories"], key=lambda c: c["id"])
        self.class_names = tuple(c["name"] for c in cats)
        self.cat_to_idx = {c["id"]: i for i, c in enumerate(cats)}
        self.images: List[Dict] = coco["images"]
        anns_by_img: Dict[int, List] = {}
        for a in coco["annotations"]:
            if a.get("iscrowd", 0):
                continue
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self.annotations = []
        for im in self.images:
            rows = []
            for a in anns_by_img.get(im["id"], []):
                x, y, w, h = a["bbox"]
                x2 = min(x + w, im["width"])
                y2 = min(y + h, im["height"])
                x, y = max(x, 0), max(y, 0)
                if x2 > x and y2 > y:
                    rows.append([x, y, x2, y2,
                                 self.cat_to_idx[a["category_id"]]])
            self.annotations.append(
                np.asarray(rows, np.float32).reshape(-1, 5))
        self.sample_names = [im["file_name"] for im in self.images]

    def __len__(self) -> int:
        return len(self.images)

    def _read(self, index: int) -> np.ndarray:
        return imread(os.path.join(self.data_dir, self.name,
                                   self.images[index]["file_name"]))

    def __getitem__(self, index: int):
        return self._emit(self._read(index), self.annotations[index].copy(),
                          index)


class VOCDataset(_RGBDetBase):
    """PASCAL VOC xml detection (reference voc.py): the ids of
    ``VOC<year>/ImageSets/Main/<split>.txt`` for each (year, split), boxes
    1-based in the xml (hence the -1), 'difficult' objects dropped outside
    training."""

    def __init__(self, data_dir: str,
                 image_sets: Sequence[Tuple[str, str]] = (("2007",
                                                           "trainval"),),
                 input_size=(640, 640), training: bool = True,
                 map_val: bool = False, max_labels: int = 50,
                 flip_prob: float = 0.5,
                 class_names: Sequence[str] = VOC_CLASSES, **kw):
        super().__init__(input_size, training, map_val, max_labels, flip_prob)
        self.data_dir = data_dir
        self.class_names = tuple(class_names)
        self.name_to_idx = {n: i for i, n in enumerate(self.class_names)}
        self.ids: List[Tuple[str, str]] = []
        for year, split in image_sets:
            root = os.path.join(data_dir, f"VOC{year}")
            with open(os.path.join(root, "ImageSets", "Main",
                                   f"{split}.txt")) as f:
                for line in f:
                    if line.strip():
                        self.ids.append((root, line.strip()))
        self.sample_names = [i[1] for i in self.ids]
        # the annotations of every image, parsed once (MosaicDataset reads
        # them by index, as COCODataset's)
        self.annotations = [self._load_annotation(root, img_id)
                            for root, img_id in self.ids]

    def __len__(self) -> int:
        return len(self.ids)

    def _load_annotation(self, root: str, img_id: str) -> np.ndarray:
        tree = ET.parse(os.path.join(root, "Annotations", f"{img_id}.xml"))
        rows = []
        for obj in tree.findall("object"):
            if int(obj.findtext("difficult", "0")) == 1 and not self.training:
                continue
            name = obj.findtext("name").strip()
            if name not in self.name_to_idx:
                continue
            b = obj.find("bndbox")
            rows.append([float(b.findtext("xmin")) - 1,
                         float(b.findtext("ymin")) - 1,
                         float(b.findtext("xmax")) - 1,
                         float(b.findtext("ymax")) - 1,
                         self.name_to_idx[name]])
        return np.asarray(rows, np.float32).reshape(-1, 5)

    def _read(self, index: int) -> np.ndarray:
        root, img_id = self.ids[index]
        return imread(os.path.join(root, "JPEGImages", f"{img_id}.jpg"))

    def __getitem__(self, index: int):
        return self._emit(self._read(index), self.annotations[index].copy(),
                          index)
