"""Experiment tracking: a JSONL metrics log, plus TensorBoard and wandb
where they can be imported (the port's copy of
``eas_snn_tpu/utils/tracking.py:22-183``; reference yolox/utils/logger.py
WandbLogger and the TensorBoard scalars of core/trainer.py:292-304).

One ``{"ts", "step", "split", <metrics>}`` object a line in
``<run dir>/metrics.jsonl``, always. ``log_pred_images`` draws detections
over event frames into ``<run dir>/pred_images/step%08d_%d.png`` (and
TensorBoard images, and a wandb media panel with its boxes);
``log_artifact`` registers a file or directory as a wandb artifact (JAX
:82-175).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["MetricsTracker"]


class MetricsTracker:
    """backend: 'auto' adds every importable backend; 'jsonl' only the
    file; 'tensorboard' / 'wandb' require that backend and raise when it
    cannot be imported (the reference fails the same way on ``--logger
    wandb`` without wandb). ``enabled=False`` (every process but rank 0
    of a data-parallel run) writes nothing."""

    def __init__(self, output_dir: str, backend: str = "auto",
                 run_config: Optional[Dict] = None, enabled: bool = True):
        if backend not in ("auto", "jsonl", "tensorboard", "wandb"):
            raise ValueError(f"unknown metrics backend '{backend}'")
        self._tb = None
        self._wandb = None
        self._f = None
        if not enabled:
            return
        os.makedirs(output_dir, exist_ok=True)
        self._f = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        if backend in ("auto", "tensorboard"):
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                if backend == "tensorboard":
                    raise
            else:
                self._tb = SummaryWriter(os.path.join(output_dir, "tb"))
        if backend in ("auto", "wandb"):
            try:
                import wandb
            except ImportError:
                if backend == "wandb":
                    raise
            else:
                self._wandb = wandb.init(
                    project=os.environ.get("WANDB_PROJECT", "eas-snn-tpu"),
                    name=os.path.basename(output_dir.rstrip(os.sep)) or None,
                    dir=output_dir, config=dict(run_config or {}),
                    resume="allow")

    def log(self, step: int, metrics: Dict[str, float],
            split: str = "train") -> None:
        if self._f is None:
            return
        row = {"ts": time.time(), "step": int(step), "split": split}
        row.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"{split}/{k}", float(v), int(step))
        if self._wandb is not None:
            self._wandb.log({f"{split}/{k}": float(v)
                             for k, v in metrics.items()}, step=int(step))

    def log_pred_images(self, step: int, frames, detections,
                        class_names: Sequence[str] = (), split: str = "val",
                        conf: float = 0.3, max_images: int = 8) -> List[str]:
        """Draw evaluation detections (reference: WandbLogger's val
        prediction panel, yolox/utils/logger.py:320-385) and return the
        PNG paths written.

        frames: (H, W, 2) polarity-count frames, (..., H, W, 2) slices
        (summed into one count frame) or BGR uint8 images; detections:
        per frame an (n, 7) [x1, y1, x2, y2, obj, cls_conf, cls] array
        (``ops/boxes.py:postprocess``) or None. The first ``max_images``
        are drawn with ``vis_detections`` at ``conf`` and written to
        ``<run dir>/pred_images/step%08d_%d.png``; TensorBoard gets each
        image in RGB, wandb one list of ``wandb.Image`` with the boxes'
        positions, classes and scores."""
        if self._f is None:
            return []
        from .png import write_png
        from .visualize import event_frame_to_image, vis_detections

        img_dir = os.path.join(os.path.dirname(self._f.name), "pred_images")
        os.makedirs(img_dir, exist_ok=True)
        written, wandb_imgs = [], []
        for i, (frame, det) in enumerate(zip(frames, detections)):
            if i >= max_images:
                break
            frame = np.asarray(frame)
            if frame.ndim > 3:  # (Tl, Tm, H, W, 2) slices -> one frame
                frame = frame.reshape((-1,) + frame.shape[-3:]).sum(0)
            img = (frame if frame.ndim == 3 and frame.shape[-1] == 3
                   and frame.dtype == np.uint8
                   else event_frame_to_image(frame))
            if det is not None and len(det):
                det = np.asarray(det)
                img = vis_detections(img, det[:, :4], det[:, 4] * det[:, 5],
                                     det[:, 6].astype(int), conf=conf,
                                     class_names=class_names)
            path = os.path.join(img_dir, f"step{int(step):08d}_{i}.png")
            write_png(path, img)
            written.append(path)
            if self._tb is not None:
                self._tb.add_image(f"{split}/pred_{i}", img[..., ::-1],
                                   int(step), dataformats="HWC")
            if self._wandb is not None:
                wandb_imgs.append(self._wandb_image(img, det, class_names,
                                                    conf))
        if self._wandb is not None and wandb_imgs:
            self._wandb.log({f"{split}/predictions": wandb_imgs},
                            step=int(step))
        return written

    @staticmethod
    def _wandb_image(img: np.ndarray, det, class_names: Sequence[str],
                     conf: float):
        """``wandb.Image`` of the BGR ``img`` in RGB with the detections
        scoring at least ``conf`` as its box data."""
        import wandb

        box_data = []
        for b in (det if det is not None else ()):
            score = float(b[4] * b[5])
            if score < conf:
                continue
            box_data.append({
                "position": {"minX": float(b[0]), "minY": float(b[1]),
                             "maxX": float(b[2]), "maxY": float(b[3])},
                "domain": "pixel", "class_id": int(b[6]),
                "scores": {"conf": score}})
        return wandb.Image(img[..., ::-1], boxes={"predictions": {
            "box_data": box_data,
            "class_labels": dict(enumerate(class_names))}})

    def log_artifact(self, path: str, name: str, kind: str = "model"
                     ) -> None:
        """Register ``path`` (a file or a directory) as a wandb artifact
        (reference: WandbLogger.save_checkpoint, yolox/utils/logger.py);
        nothing without wandb."""
        if self._wandb is None:
            return
        import wandb

        art = wandb.Artifact(name=name, type=kind)
        if os.path.isdir(path):
            art.add_dir(path)
        else:
            art.add_file(path)
        self._wandb.log_artifact(art)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
