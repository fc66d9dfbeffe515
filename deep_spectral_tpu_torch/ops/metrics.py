"""Metrics of the port, from `deep_spectral_tpu.ops.metrics`: the box IoU
family and the CorLoc hit of object localization
(reference: object-localization/datasets.py:269-321, main.py:394-397), and
the confusion matrix and per-class Jaccard / mIoU of semantic segmentation
(reference: semantic-segmentation/eval.py:141-153), as one bincount pass
over the pixels."""
from __future__ import annotations

import math
from typing import Optional

import torch


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """IoU of boxes (xmin, ymin, xmax, ymax): box1 (4,), box2 (..., 4)."""
    b1, b2 = box1.float(), box2.float()
    ix1 = torch.maximum(b1[0], b2[..., 0])
    iy1 = torch.maximum(b1[1], b2[..., 1])
    ix2 = torch.minimum(b1[2], b2[..., 2])
    iy2 = torch.minimum(b1[3], b2[..., 3])
    inter = torch.clamp_min(ix2 - ix1, 0) * torch.clamp_min(iy2 - iy1, 0)
    a1 = (b1[2] - b1[0]) * (b1[3] - b1[1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    return inter / torch.clamp_min(a1 + a2 - inter, 1e-16)


def bbox_iou_variants(box1: torch.Tensor, box2: torch.Tensor, *, x1y1x2y2: bool = True,
                      giou: bool = False, diou: bool = False, ciou: bool = False,
                      eps: float = 1e-16) -> torch.Tensor:
    """IoU / GIoU / DIoU / CIoU between box1 (4,) and box2 (..., 4), the
    yolov5-style family the reference exposes."""
    b1, b2 = box1.float(), box2.float()
    if not x1y1x2y2:  # xywh -> xyxy
        b1 = torch.stack([b1[0] - b1[2] / 2, b1[1] - b1[3] / 2,
                          b1[0] + b1[2] / 2, b1[1] + b1[3] / 2])
        b2 = torch.stack([b2[..., 0] - b2[..., 2] / 2, b2[..., 1] - b2[..., 3] / 2,
                          b2[..., 0] + b2[..., 2] / 2, b2[..., 1] + b2[..., 3] / 2],
                         dim=-1)
    ix1 = torch.maximum(b1[0], b2[..., 0])
    iy1 = torch.maximum(b1[1], b2[..., 1])
    ix2 = torch.minimum(b1[2], b2[..., 2])
    iy2 = torch.minimum(b1[3], b2[..., 3])
    inter = torch.clamp_min(ix2 - ix1, 0) * torch.clamp_min(iy2 - iy1, 0)
    w1, h1 = b1[2] - b1[0], b1[3] - b1[1]
    w2, h2 = b2[..., 2] - b2[..., 0], b2[..., 3] - b2[..., 1]
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (giou or diou or ciou):
        return iou
    cw = torch.maximum(b1[2], b2[..., 2]) - torch.minimum(b1[0], b2[..., 0])
    ch = torch.maximum(b1[3], b2[..., 3]) - torch.minimum(b1[1], b2[..., 1])
    if giou:
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = (((b2[..., 0] + b2[..., 2]) - (b1[0] + b1[2])) ** 2 +
            ((b2[..., 1] + b2[..., 3]) - (b1[1] + b1[3])) ** 2) / 4.0
    if diou:
        return iou - rho2 / c2
    v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps)) -
                              torch.atan(w1 / (h1 + eps))) ** 2
    alpha = v / (1 - iou + v + eps)
    return iou - (rho2 / c2 + v * alpha)


def corloc_hit(pred_box: torch.Tensor, gt_boxes: torch.Tensor,
               gt_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1.0 iff the predicted box has IoU >= 0.5 with a valid GT box."""
    ious = bbox_iou(pred_box, gt_boxes)
    if gt_valid is not None:
        ious = torch.where(gt_valid, ious, 0.0)
    best = ious.max() if ious.numel() else ious.new_zeros(())
    return (torch.clamp_min(best, 0.0) >= 0.5).float()


def confusion_matrix(flat_preds: torch.Tensor, flat_targets: torch.Tensor,
                     num_pred: int, num_gt: int) -> torch.Tensor:
    """(num_pred, num_gt) co-occurrence counts (int64)."""
    idx = flat_preds.to(torch.int64) * num_gt + flat_targets.to(torch.int64)
    return torch.bincount(idx, minlength=num_pred * num_gt).reshape(num_pred, num_gt)


def per_class_jaccard(flat_preds: torch.Tensor, flat_targets: torch.Tensor,
                      num_classes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-class TP / (TP + FP + FN) in f32, and their mean over all classes."""
    conf = confusion_matrix(flat_preds, flat_targets, num_classes,
                            num_classes).to(torch.float32)
    tp = torch.diagonal(conf)
    fp = conf.sum(dim=1) - tp  # predicted c, target != c
    fn = conf.sum(dim=0) - tp  # target c, predicted != c
    jac = tp / torch.clamp(tp + fp + fn, min=1e-8)
    return jac, jac.mean()
