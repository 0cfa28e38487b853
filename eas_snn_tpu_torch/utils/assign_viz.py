"""SimOTA assignment drawing (the port's counterpart of
``eas_snn_tpu/utils/assign_viz.py``; reference
yolox/models/spiking_yolo_head.py:595 visualize_assign_result and
yolox/utils/demo_utils.py:19): the ground-truth boxes and the anchor
centres SimOTA assigned to each, for debugging label assignment.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .draw import circle, rectangle
from .png import write_png
from .visualize import _PALETTE, event_frame_to_image

__all__ = ["assign", "visualize_assignments"]


def _anchor_tables(h_in: int, w_in: int):
    """Grid x, grid y and stride of every anchor of the 8 / 16 / 32
    pyramid, in the head's order (f32)."""
    gx, gy, sv = [], [], []
    for s in (8, 16, 32):
        hh, ww = h_in // s, w_in // s
        yv, xv = np.meshgrid(np.arange(hh), np.arange(ww), indexing="ij")
        gx.append(xv.reshape(-1))
        gy.append(yv.reshape(-1))
        sv.append(np.full(hh * ww, s, np.float32))
    return (np.concatenate(gx).astype(np.float32),
            np.concatenate(gy).astype(np.float32), np.concatenate(sv))


def assign(model: torch.nn.Module, events: torch.Tensor,
           labels: np.ndarray):
    """SimOTA over the batch ``events`` (on the model's device) with
    ``labels``: ``model``'s train-mode forward without targets (the
    decoded head outputs (B, A, 5 + C): boxes in image units, objectness
    and classes as logits, what SimOTA takes), then the batched
    ``models/simota.py:simota_assign``. The forward moves no BN running
    statistic (``frozen_bn_stats``), as the JAX function discards its
    forward's ``batch_stats``, and the model's mode is as it was. Returns
    the ``AssignResult`` and the anchors' grid x, grid y and stride."""
    from ..models.blocks import frozen_bn_stats
    from ..models.simota import simota_assign

    dev = events.device
    was_training = model.training
    model.train()
    try:
        with torch.no_grad(), frozen_bn_stats():
            outputs = model(events).float()
    finally:
        model.train(was_training)
    A = outputs.shape[1]
    h_in, w_in = events.shape[3], events.shape[4]
    gx, gy, sv = _anchor_tables(h_in, w_in)
    if len(gx) != A:
        raise ValueError(f"{A} anchors in the head's outputs, {len(gx)} in "
                         f"the 8 / 16 / 32 pyramid of {h_in}x{w_in}")
    lab = torch.as_tensor(np.asarray(labels), dtype=torch.float32,
                          device=dev)
    res = simota_assign(
        lab[..., 1:5], lab[..., 0], lab.sum(-1) > 0,
        outputs[..., :4], outputs[..., 5:], outputs[..., 4],
        torch.as_tensor((gx + 0.5) * sv, device=dev),
        torch.as_tensor((gy + 0.5) * sv, device=dev),
        torch.as_tensor(sv, device=dev), outputs.shape[2] - 5)
    return res, (gx, gy, sv)


def visualize_assignments(model: torch.nn.Module, events, labels,
                          save_prefix: Optional[str] = None
                          ) -> List[np.ndarray]:
    """SimOTA's assignment of the batch (``assign``) drawn as one BGR
    image a sample: the sample's first slice summed into one event frame,
    each valid ground-truth box at thickness 2 and each foreground
    anchor's centre as a dot of radius 2, coloured by the matched box's
    row.

    Args:
      events: (B, Tl, Tm, H, W, C) batch (numpy or tensor).
      labels: (B, M, 5) [cls, cx, cy, w, h], rows of zeros padding.
    Returns the (H, W, 3) uint8 images, also written to
    ``{save_prefix}{i}.png`` when ``save_prefix`` is given.
    """
    dev = next(model.parameters()).device
    ev = torch.as_tensor(events).to(dev, torch.float32)
    labels = np.asarray(labels)
    res, (gx, gy, sv) = assign(model, ev, labels)
    fg_all = res.fg_mask.cpu().numpy()
    matched_all = res.matched_gt.cpu().numpy()
    gt_valid = labels.sum(-1) > 0
    frames = ev[:, 0].sum(1).cpu().numpy()  # (B, H, W, C)

    images = []
    for b in range(len(frames)):
        img = event_frame_to_image(frames[b][..., :2])
        for gi in np.where(gt_valid[b])[0]:
            _, cx, cy, w, hh_ = labels[b, gi]
            color = tuple(int(c) for c in _PALETTE[int(gi) % len(_PALETTE)])
            rectangle(img, (int(cx - w / 2), int(cy - hh_ / 2)),
                      (int(cx + w / 2), int(cy + hh_ / 2)), color, 2)
        for a in np.where(fg_all[b])[0]:
            color = tuple(int(c) for c in
                          _PALETTE[int(matched_all[b, a]) % len(_PALETTE)])
            circle(img, (int((gx[a] + 0.5) * sv[a]),
                         int((gy[a] + 0.5) * sv[a])), 2, color)
        if save_prefix:
            write_png(f"{save_prefix}{b}.png", img)
        images.append(img)
    return images
