"""SimOTA label assignment and the YOLOX losses, dense and batched, f32:
a frozen copy of the port's ``models/simota.py`` and of the box geometry
of its ``ops/boxes.py`` (``pairwise_iou``, ``iou_loss``), without the
process-group sums, which no benchmark cell uses. The assignment runs
without gradients on detached predictions; its dynamic top-k is the
tie-exact threshold of the JAX package."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

def cxcywh2xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between (..., M, 4) and (..., A, 4) cxcywh boxes: (..., M, A)."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    tl = torch.maximum(a[..., :2] - a[..., 2:] / 2, b[..., :2] - b[..., 2:] / 2)
    br = torch.minimum(a[..., :2] + a[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2)
    area_a, area_b = a[..., 2] * a[..., 3], b[..., 2] * b[..., 3]
    valid = (tl < br).all(-1)
    wh = br - tl
    inter = wh[..., 0] * wh[..., 1] * valid
    return inter / (area_a + area_b - inter + 1e-12)


def iou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise 1 - IoU^2 of aligned (..., 4) cxcywh boxes."""
    tl = torch.maximum(pred[..., :2] - pred[..., 2:] / 2,
                       target[..., :2] - target[..., 2:] / 2)
    br = torch.minimum(pred[..., :2] + pred[..., 2:] / 2,
                       target[..., :2] + target[..., 2:] / 2)
    area_p = pred[..., 2] * pred[..., 3]
    area_g = target[..., 2] * target[..., 3]
    en = (tl < br).all(-1).to(pred.dtype)
    wh = br - tl
    area_i = wh[..., 0] * wh[..., 1] * en
    iou = area_i / (area_p + area_g - area_i + 1e-16)
    return 1.0 - iou ** 2


_BIG = 1e6  # geometry-violation penalty (reference :505)
_INF = 1e9  # invalid-gt penalty (replaces the dynamic gt count)


def _topk_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sum of the k largest values along the last axis, duplicates counted
    once per copy (``jax.lax.top_k(x, k)[0].sum(-1)``)."""
    neg = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    rem = torch.full(x.shape[:-1], k, dtype=torch.int32, device=x.device)
    cur = x
    for _ in range(k):
        m = cur.amax(-1)
        tie = cur >= m[..., None]
        take = torch.minimum(tie.sum(-1, dtype=torch.int32), rem)
        acc = acc + torch.where(take > 0, m * take.to(x.dtype), 0.0)
        cur = torch.where(tie, neg, cur)
        rem = rem - take
    return acc


def _kth_smallest(x: torch.Tensor, ks: torch.Tensor, k: int) -> torch.Tensor:
    """The ks-th smallest value along the last axis (1 <= ks <= k), a
    duplicated value taking one rank per copy."""
    pos = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
    kth = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    cum = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    cur = x
    for _ in range(k):
        m = cur.amin(-1)
        tie = cur <= m[..., None]
        cnt = tie.sum(-1, dtype=torch.int32)
        kth = torch.where((cum < ks) & (cum + cnt >= ks), m, kth)
        cur = torch.where(tie, pos, cur)
        cum = cum + cnt
    return kth


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of integer-valued ``idx`` (all zeros out of range, as
    ``jax.nn.one_hot``)."""
    iota = torch.arange(n, device=idx.device)
    return (idx.to(torch.int64)[..., None] == iota).float()


def _bce_probs(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """binary_cross_entropy on probabilities, logs clamped at -100."""
    logp = torch.clamp_min(torch.log(p + 1e-12), -100.0)
    log1mp = torch.clamp_min(torch.log(1.0 - p + 1e-12), -100.0)
    return -(y * logp + (1.0 - y) * log1mp)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative, 1 at 0 (torch's is 0 there)."""
    return torch.where(x >= 0, x, -x)


def _bce_logits(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """BCE with logits, stable form (torch BCEWithLogitsLoss)."""
    return (torch.maximum(x, torch.zeros_like(x)) - x * y
            + torch.log1p(torch.exp(-_abs(x))))


class AssignResult(NamedTuple):
    fg_mask: torch.Tensor     # (B, A) bool: the anchor is foreground
    matched_gt: torch.Tensor  # (B, A) int: the matched gt row
    pred_iou: torch.Tensor    # (B, A) IoU with the matched gt
    num_fg: torch.Tensor      # (B,) f32
    num_gt: torch.Tensor      # (B,) f32


@torch.no_grad()
def simota_assign(gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                  gt_valid: torch.Tensor, pred_boxes: torch.Tensor,
                  cls_logits: torch.Tensor, obj_logits: torch.Tensor,
                  centers_x: torch.Tensor, centers_y: torch.Tensor,
                  strides: torch.Tensor, num_classes: int,
                  center_radius: float = 1.5) -> AssignResult:
    """Dense SimOTA over a batch: gt (B, M, 4) cxcywh, (B, M) classes and
    validity; predictions (B, A, 4) decoded cxcywh, (B, A, C) and (B, A, 1)
    logits; anchor centres (A,) in image units and strides (A,)."""
    f32 = torch.float32
    gt_boxes, pred_boxes = gt_boxes.to(f32), pred_boxes.to(f32)
    cls_logits = cls_logits.to(f32)
    obj_logits = obj_logits.to(f32).reshape(obj_logits.shape[:2])
    M, A = gt_boxes.shape[1], pred_boxes.shape[1]
    valid = gt_valid[..., None]                                 # (B, M, 1)

    # geometry constraint (reference :530-559)
    cd = strides.to(f32) * center_radius                        # (A,)
    gx, gy = gt_boxes[..., 0:1], gt_boxes[..., 1:2]             # (B, M, 1)
    is_in_center = ((centers_x - (gx - cd) > 0)
                    & ((gx + cd) - centers_x > 0)
                    & (centers_y - (gy - cd) > 0)
                    & ((gy + cd) - centers_y > 0) & valid)      # (B, M, A)
    anchor_filter = is_in_center.any(1)                         # (B, A)

    # pairwise costs
    ious = pairwise_iou(gt_boxes, pred_boxes) * valid           # (B, M, A)
    iou_cost = -torch.log(ious + 1e-8)
    joint = torch.sqrt(torch.sigmoid(cls_logits)
                       * torch.sigmoid(obj_logits)[..., None])  # (B, A, C)
    gt_onehot = _one_hot(gt_classes, num_classes)               # (B, M, C)
    cls_cost = _bce_probs(joint[:, None], gt_onehot[:, :, None]).sum(-1)
    # soft 1e6 penalties: a gt whose dynamic k exceeds its in-centre
    # anchors spills into penalty anchors, preferring in-filter ones
    cost = (cls_cost + 3.0 * iou_cost + _BIG * (~is_in_center)
            + _BIG * (~anchor_filter)[:, None, :] + _INF * (~valid))

    # dynamic k (reference :561-570): per gt clamp(sum of top-10 IoU, 1)
    cand_ious = torch.where(anchor_filter[:, None, :], ious, 0.0)
    k10 = min(10, A)
    dynamic_ks = torch.clamp_min(_topk_sum(cand_ious, k10).to(torch.int32),
                                 1)
    kth = _kth_smallest(cost, torch.clamp_max(dynamic_ks, k10), k10)
    matching = (cost <= kth[..., None]) & valid                 # (B, M, A)

    # conflicts (reference :575-581): an anchor matched to several gts
    # keeps the gt of least cost over the whole cost column
    n_match = matching.sum(1)                                   # (B, A)
    keep = torch.arange(M, device=cost.device)[:, None] == \
        cost.argmin(1)[:, None, :]
    matching = torch.where(n_match[:, None, :] > 1, matching & keep,
                           matching)

    fg_mask = matching.any(1)
    matched_gt = matching.to(torch.uint8).argmax(1)
    pred_iou = (matching * ious).sum(1)
    return AssignResult(fg_mask, matched_gt, pred_iou,
                        fg_mask.sum(-1).to(f32), gt_valid.sum(-1).to(f32))


class LossOutput(NamedTuple):
    total_loss: torch.Tensor
    iou_loss: torch.Tensor
    conf_loss: torch.Tensor
    cls_loss: torch.Tensor
    l1_loss: torch.Tensor
    num_fg: torch.Tensor  # foreground anchors per gt (reference :429)


def yolox_losses(outputs: torch.Tensor, origin_preds: Optional[torch.Tensor],
                 labels: torch.Tensor, centers_x: torch.Tensor,
                 centers_y: torch.Tensor, strides: torch.Tensor,
                 num_classes: int, use_l1: bool = False) -> LossOutput:
    """YOLOX training losses with SimOTA assignment. ``outputs`` (B, A,
    5 + C): decoded boxes in image units, obj/cls logits; ``origin_preds``
    (B, A, 4) raw reg outputs (for L1); ``labels`` (B, M, 5) [cls, cx, cy,
    w, h] padded with zero rows; grid ``centers_*`` in cells, ``strides``
    (A,). ``iou_loss`` is reported already weighted by 5. With a process
    group the losses are divided by the global batch's foreground count
    (``num_fg`` is the global batch's too), so that the group's losses sum
    to the global batch's."""
    f32 = torch.float32
    outputs, labels = outputs.to(f32), labels.to(f32)
    bbox_preds, obj_preds = outputs[..., :4], outputs[..., 4:5]
    cls_preds = outputs[..., 5:]
    gt_valid = labels.sum(2) > 0                                # (B, M)
    gt_classes, gt_boxes = labels[..., 0], labels[..., 1:5]
    acx = (centers_x + 0.5) * strides
    acy = (centers_y + 0.5) * strides
    assign = simota_assign(gt_boxes, gt_classes, gt_valid,
                           bbox_preds.detach(), cls_preds.detach(),
                           obj_preds.detach(), acx, acy, strides,
                           num_classes)

    fg = assign.fg_mask.to(f32)                                 # (B, A)
    num_fg, num_gt = assign.num_fg.sum(), assign.num_gt.sum()
    total_num_fg = torch.clamp_min(num_fg, 1.0)
    total_num_gt = torch.clamp_min(num_gt, 1.0)
    idx = assign.matched_gt.to(torch.int64)
    reg_t = torch.gather(gt_boxes, 1, idx[..., None].expand(-1, -1, 4))
    cls_t = (_one_hot(torch.gather(gt_classes, 1, idx), num_classes)
             * assign.pred_iou[..., None])                      # (B, A, C)
    obj_t = fg[..., None]

    loss_iou = (iou_loss(bbox_preds, reg_t) * fg).sum() / total_num_fg
    loss_obj = _bce_logits(obj_preds, obj_t).sum() / total_num_fg
    loss_cls = (_bce_logits(cls_preds, cls_t).sum(-1) * fg).sum() \
        / total_num_fg
    if use_l1 and origin_preds is not None:
        # L1 targets in grid units (reference get_l1_target :432-437)
        st = strides[None, :, None]
        l1_t = torch.cat([
            reg_t[..., 0:1] / st - centers_x[None, :, None],
            reg_t[..., 1:2] / st - centers_y[None, :, None],
            torch.log(reg_t[..., 2:3] / st + 1e-8),
            torch.log(reg_t[..., 3:4] / st + 1e-8),
        ], -1)
        loss_l1 = (_abs(origin_preds.to(f32) - l1_t).sum(-1) * fg).sum() \
            / total_num_fg
    else:
        loss_l1 = torch.zeros((), dtype=f32, device=outputs.device)
    reg_weight = 5.0
    total = reg_weight * loss_iou + loss_obj + loss_cls + loss_l1
    return LossOutput(total, reg_weight * loss_iou, loss_obj, loss_cls,
                      loss_l1, num_fg / total_num_gt)
