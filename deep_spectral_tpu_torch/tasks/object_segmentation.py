"""Binary object-segmentation evaluation, the port of
`deep_spectral_tpu.tasks.object_segmentation` (the reference's
`object-segmentation/` subproject: main.py, metrics.py, dataset.py).

Evaluates predicted single-region masks (patch-level or full-resolution
PNGs) against the GT masks of saliency datasets (CUB, DUT-OMRON, DUTS,
ECSSD layouts): per-image accuracy and IoU, and F-max for soft predictions,
with the reference's resize and crop (nearest upsample by the downsample
factor, a center crop for CUB; main.py:75-112) and its empty-mask
conventions (metrics.py). The masks are prepared on the host and scored on
`device` (CUDA unless the caller asks for the CPU).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..ops import metrics as M
from ..ops.resize import resize_nearest
from ..utils.device import resolve_device
from ..utils.serialization import load_segmap_png


def _paths(d: Path) -> list[Path]:
    """Folder-of-files or folder-of-folders listing, sorted
    (reference: dataset.py:10-16, :42-54)."""
    entries = sorted(d.iterdir())
    if entries and entries[0].is_dir():
        return sorted(p for sub in entries for p in sub.iterdir())
    return entries


def central_crop(arr: np.ndarray) -> np.ndarray:
    """Center crop to a square of side min(H, W) (reference: dataset.py:19-22)."""
    H, W = arr.shape[:2]
    s = min(H, W)
    y0, x0 = (H - s) // 2, (W - s) // 2
    return arr[y0:y0 + s, x0:x0 + s]


def load_gt_mask(path: Path, crop: bool) -> np.ndarray:
    """GT mask binarized at the middle of the 0-255 range (reference:
    dataset.py:86)."""
    from PIL import Image
    m = np.array(Image.open(path).convert("RGB"))[:, :, 0]
    if crop:
        m = central_crop(m)
    return m > 127


def _nearest(pred: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    return resize_nearest(torch.from_numpy(pred.astype(np.int32)), hw).numpy()


def prepare_prediction(pred: np.ndarray, target_hw: tuple[int, int],
                       downsample: Optional[int], crop: bool) -> np.ndarray:
    """The reference's resize of patch-level predictions (main.py:85-100):
    {0, 255} -> {0, 1}, nearest resize to max(patches * downsample, H) per
    dim, the exact x downsample upscale pasted over its top-left part, then
    the optional center crop."""
    pred = np.array(pred)
    uniq = set(np.unique(pred).tolist())
    if not uniq <= {0, 1, 255}:
        raise ValueError(f"unexpected prediction values {uniq}")
    pred[pred == 255] = 1
    if downsample is not None:
        H, W = target_hw
        Hp, Wp = pred.shape
        H_pad, W_pad = Hp * downsample, Wp * downsample
        up = _nearest(pred, (max(H_pad, H), max(W_pad, W)))
        up[:H_pad, :W_pad] = _nearest(pred, (H_pad, W_pad))
        pred = up
    if crop:
        pred = central_crop(pred)
    return pred.astype(bool)


def evaluate_predictions(
    images_dir: str | Path,
    labels_dir: str | Path,
    predictions_dir: str | Path,
    downsample: Optional[int] = 16,
    crop: bool = False,
    device=None,
) -> dict:
    """Mean accuracy and IoU over a dataset's images (reference:
    object-segmentation/main.py:60-112); `crop=True` for CUB. Prediction
    files are `<image stem>.png` in `predictions_dir`."""
    dev = resolve_device(device, "evaluate_predictions")
    image_paths = _paths(Path(images_dir))
    label_paths = _paths(Path(labels_dir))
    if len(image_paths) != len(label_paths):
        raise ValueError(f"{len(image_paths)} images vs {len(label_paths)} labels")
    accs, ious = [], []
    pairs = list(zip(image_paths, label_paths))
    try:
        from tqdm import tqdm
        pairs = tqdm(pairs, desc="eval")
    except ImportError:
        pass
    for img_path, lab_path in pairs:
        target = load_gt_mask(lab_path, crop=False)
        pred = load_segmap_png(Path(predictions_dir) / f"{img_path.stem}.png")
        pred = prepare_prediction(pred, target.shape, downsample, crop)
        if crop:
            target = central_crop(target)
        # a size mismatch can remain at the right and bottom edges: score the
        # common extent, as the reference's paste-over does
        H = min(pred.shape[0], target.shape[0])
        W = min(pred.shape[1], target.shape[1])
        p = torch.from_numpy(np.ascontiguousarray(pred[:H, :W])).to(dev)
        t = torch.from_numpy(np.ascontiguousarray(target[:H, :W])).to(dev)
        accs.append(float(M.binary_accuracy(p, t)))
        ious.append(float(M.binary_iou(p, t)))
    results = {"acc": float(np.mean(accs)), "iou": float(np.mean(ious)),
               "n_images": len(accs)}
    print(f"acc: {results['acc']:.4f}  iou: {results['iou']:.4f} "
          f"({results['n_images']} images)")
    return results


def evaluate_soft_predictions(soft_preds: np.ndarray, targets: np.ndarray,
                              device=None) -> dict:
    """Accuracy, IoU and F-max of soft (probability) predictions (N, H, W)
    against binary targets (reference: metrics.py:7-62 with
    preds_are_soft=True); the hard masks are soft > 0.5."""
    dev = resolve_device(device, "evaluate_soft_predictions")
    soft = torch.from_numpy(np.asarray(soft_preds, np.float32)).to(dev)
    tgt = torch.from_numpy(np.asarray(targets)).to(dev)
    hard = soft > 0.5
    accs = [float(M.binary_accuracy(h, t)) for h, t in zip(hard, tgt)]
    ious = [float(M.binary_iou(h, t)) for h, t in zip(hard, tgt)]
    curves = [M.soft_precision_recall_curve(sp, t) for sp, t in zip(soft, tgt)]
    fmax = float(M.f_max(torch.stack([c[0] for c in curves]),
                         torch.stack([c[1] for c in curves])))
    return {"acc": float(np.mean(accs)), "iou": float(np.mean(ious)), "f_max": fmax}
