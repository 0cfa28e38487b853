"""Detection drawing over event frames (the port's copy of
``eas_snn_tpu/utils/visualize.py``; reference yolox/utils/visualize.py:
11-60 and the event-frame rendering of
yolox/utils/psee_loader/visualize/vis_utils.py:22 make_binary_histo),
drawn by ``utils/draw.py`` in place of cv2.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .draw import put_text, rectangle, text_size

__all__ = ["event_frame_to_image", "vis_detections"]

LABEL_SCALE = 0.4  # the label's text scale (the JAX package's)


def event_frame_to_image(frame: np.ndarray) -> np.ndarray:
    """(H, W, 2) polarity-count frame -> grey BGR uint8 image: 127 where
    the polarities tie, 255 where positive events dominate, 0 where
    negative ones do (make_binary_histo's look)."""
    pos = frame[..., 1].astype(np.float64)
    neg = frame[..., 0].astype(np.float64)
    img = np.full(frame.shape[:2], 127, np.uint8)
    img[pos > neg] = 255
    img[neg > pos] = 0
    return np.stack([img] * 3, axis=-1)


_PALETTE = np.array(
    [
        (56, 56, 255), (151, 157, 255), (31, 112, 255), (29, 178, 255),
        (49, 210, 207), (10, 249, 72), (23, 204, 146), (134, 219, 61),
        (52, 147, 26), (187, 212, 0), (168, 153, 44), (255, 194, 0),
        (147, 69, 52), (255, 115, 100), (236, 24, 0), (255, 56, 132),
        (133, 0, 82), (255, 56, 203), (200, 149, 255), (199, 55, 255),
    ],
    np.uint8,
)


def label_text(score: float, cls_id: int, class_names: Sequence[str]) -> str:
    """A detection's label, ``name:score%`` (the id where no name is
    given)."""
    name = class_names[cls_id] if cls_id < len(class_names) else str(cls_id)
    return f"{name}:{score * 100:.1f}%"


def vis_detections(
    img: np.ndarray,
    boxes: np.ndarray,
    scores: Optional[np.ndarray] = None,
    cls_ids: Optional[np.ndarray] = None,
    conf: float = 0.5,
    class_names: Sequence[str] = (),
) -> np.ndarray:
    """A copy of the BGR ``img`` with the xyxy ``boxes`` scoring at least
    ``conf`` drawn at thickness 2 in their class's palette colour, each
    with its label in white on a filled box of that colour above its
    top-left corner."""
    img = img.copy()
    for i in range(len(boxes)):
        score = float(scores[i]) if scores is not None else 1.0
        if score < conf:
            continue
        cls_id = int(cls_ids[i]) if cls_ids is not None else 0
        color = tuple(int(c) for c in _PALETTE[cls_id % len(_PALETTE)])
        x1, y1, x2, y2 = (int(v) for v in boxes[i][:4])
        rectangle(img, (x1, y1), (x2, y2), color, 2)
        label = label_text(score, cls_id, class_names)
        (tw, th), _ = text_size(label, LABEL_SCALE)
        rectangle(img, (x1, y1 - th - 4), (x1 + tw, y1), color, -1)
        put_text(img, label, (x1, y1 - 2), LABEL_SCALE, (255, 255, 255))
    return img
