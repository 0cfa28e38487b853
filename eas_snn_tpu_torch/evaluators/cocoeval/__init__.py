"""ctypes loader for the native COCO matcher (``cocoeval.cpp``, the port's
copy of ``eas_snn_tpu/evaluators/cocoeval/``).

The matcher is compiled at first use into the port's build directory
(``ops/_build.py:host_library``). A failed build raises: the numpy matcher
(``coco_map._match_category_numpy``) is chosen only explicitly
(``DetEval(use_native=False)``), as the test oracle.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ...ops._build import host_library

__all__ = ["load_native"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "cocoeval.cpp")


def load_native() -> ctypes.CDLL:
    """The loaded matcher (``coco_match_category``), built on first use."""
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    # n_img, gt_off, gt_boxes, gt_ignore, det_off, det_boxes, det_scores,
    # iou_thrs, n_thr, area_min, area_max, max_det, det_matched,
    # det_ignored, det_rank
    return host_library(_SRC, "cocoeval", {"coco_match_category": (
        ctypes.c_int64,
        [ctypes.c_int64, i64, f64, u8, i64, f64, f64, f64, ctypes.c_int64,
         ctypes.c_double, ctypes.c_double, ctypes.c_int64, u8, u8, i32])})
