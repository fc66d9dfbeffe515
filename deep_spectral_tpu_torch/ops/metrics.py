"""Metrics of the port, from `deep_spectral_tpu.ops.metrics`:
  * binary masks: accuracy, IoU, precision/recall with the empty-mask -> 1.0
    convention, the soft precision-recall curve and F-max (reference:
    object-segmentation/metrics.py:65-114);
  * the box IoU family and the CorLoc hit of object localization
    (reference: object-localization/datasets.py:269-321, main.py:394-397);
  * semantic segmentation: the confusion matrix (one bincount pass over the
    pixels), the IoU matrix, Hungarian (scipy's assignment on the host) and
    majority-vote cluster matching, and per-class Jaccard / mIoU (reference:
    semantic-segmentation/eval_utils.py:7-46, eval.py:141-153).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------- binary masks

def binary_accuracy(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pixel accuracy (reference: object-segmentation/metrics.py:65-67)."""
    return (pred.bool() == target.bool()).float().mean()


def binary_iou(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """IoU, 0 when both masks are empty (the reference's NaN -> 0,
    metrics.py:70-76)."""
    p, t = pred.bool(), target.bool()
    inter = (p & t).float().sum()
    union = (p | t).float().sum()
    return torch.where(union > 0, inter / union.clamp_min(1.0), 0.0)


def precision_recall(target: torch.Tensor, pred: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precision and recall over the last two dims; an empty prediction has
    precision 1.0, an empty target recall 1.0 (reference:
    object-segmentation/metrics.py:91-100)."""
    t, p = target.bool(), pred.bool()
    tp = (t & p).float().sum((-2, -1))
    p_area = p.float().sum((-2, -1))
    t_area = t.float().sum((-2, -1))
    precision = torch.where(p_area == 0, 1.0, tp / p_area.clamp_min(1.0))
    recall = torch.where(t_area == 0, 1.0, tp / t_area.clamp_min(1.0))
    return precision, recall


def soft_precision_recall_curve(soft_pred: torch.Tensor, target: torch.Tensor,
                                prob_bins: int = 255) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precision and recall at the thresholds arange(0, 1, 1/bins)[1:], all
    thresholds at once (reference: object-segmentation/metrics.py:79-88).
    Returns two (prob_bins - 1,) f32 tensors."""
    # numpy's f32 arange, which the JAX package's equals bit for bit (torch's
    # f32 arange rounds half of these thresholds differently)
    thresholds = torch.from_numpy(
        np.arange(0.0, 1.0, 1.0 / prob_bins, dtype=np.float32)[1:]).to(soft_pred.device)
    return precision_recall(target[None], soft_pred[None] > thresholds[:, None, None])


def f_max(precisions: torch.Tensor, recalls: torch.Tensor,
          beta_sq: float = 0.3) -> torch.Tensor:
    """Largest F-beta over thresholds of the mean precision and recall
    across images, (num_images, num_thresholds) each (reference:
    object-segmentation/metrics.py:103-114); NaN F taken as 0."""
    p, r = precisions.mean(0), recalls.mean(0)
    f = ((1 + beta_sq) * p * r) / (beta_sq * p + r)
    return torch.nan_to_num(f, nan=0.0).max()


# ------------------------------------------------------------------ detection


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


def iou_matrix_from_confusion(conf: torch.Tensor) -> torch.Tensor:
    """IoU[c1, c2] = tp / (tp + fp + fn) of pred cluster c1 against GT class
    c2 (the reference's get_iou, eval_utils.py:36-46), f32."""
    conf = conf.to(torch.float32)
    fp = conf.sum(dim=0, keepdim=True) - conf  # target c2, pred != c1
    fn = conf.sum(dim=1, keepdim=True) - conf  # pred c1, target != c2
    return conf / torch.clamp(conf + fp + fn, min=1e-8)


def hungarian_match(flat_preds: torch.Tensor, flat_targets: torch.Tensor,
                    preds_k: int, targets_k: int) -> list:
    """Optimal 1:1 cluster -> class assignment maximizing IoU (reference:
    semantic-segmentation/eval_utils.py:7-23): the confusion matrix on the
    pixels' device, the (k x k) assignment by scipy on the host.
    Returns [(pred_c, gt_c), ...]."""
    from scipy.optimize import linear_sum_assignment
    if preds_k != targets_k:
        raise ValueError(f"Hungarian matching needs preds_k == targets_k; "
                         f"got {preds_k} and {targets_k}")
    conf = confusion_matrix(flat_preds, flat_targets, preds_k, targets_k)
    iou = iou_matrix_from_confusion(conf).cpu().numpy()
    rows, cols = linear_sum_assignment(-iou)
    return list(zip(rows.tolist(), cols.tolist()))


def majority_vote(flat_preds: torch.Tensor, flat_targets: torch.Tensor,
                  preds_k: int, targets_k: int) -> list:
    """Each pred cluster -> its best-IoU GT class, the first on ties
    (reference: semantic-segmentation/eval_utils.py:26-33)."""
    conf = confusion_matrix(flat_preds, flat_targets, preds_k, targets_k)
    best = iou_matrix_from_confusion(conf).cpu().numpy().argmax(axis=1)
    return list(zip(range(preds_k), best.tolist()))


def apply_label_map(preds: np.ndarray, match: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Pred cluster ids -> matched class ids (host side; unmatched ids -> 0)."""
    lut = np.zeros(max(m[0] for m in match) + 1, dtype=np.int64)
    for pred_c, gt_c in match:
        lut[pred_c] = gt_c
    return lut[preds]
