"""Localization visualizations (matplotlib, headless): predicted boxes, LOST
degree/correlation feature maps, and seed-expansion overlays, the port's copy
of `deep_spectral_tpu.tasks.localization_vis` (the reference's
`object-localization/visualizations.py`, cv2-based, rebuilt for file output).

matplotlib is imported inside each function: nothing on the localization
path needs it, and a host without it runs everything but these plots.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def _save(fig, path):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, bbox_inches="tight", dpi=100)
    import matplotlib.pyplot as plt
    plt.close(fig)


def visualize_predictions(image: np.ndarray, pred_box, gt_boxes,
                          output_path: str | Path):
    """Image with predicted (red) and GT (green) boxes
    (reference: visualizations.py — pred-box overlay)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(image)
    x0, y0, x1, y1 = pred_box
    ax.add_patch(plt.Rectangle((x0, y0), x1 - x0, y1 - y0, fill=False,
                               edgecolor="red", linewidth=3))
    for (x0, y0, x1, y1) in np.atleast_2d(gt_boxes):
        ax.add_patch(plt.Rectangle((x0, y0), x1 - x0, y1 - y0, fill=False,
                                   edgecolor="lime", linewidth=2))
    ax.axis("off")
    _save(fig, output_path)


def visualize_fms(A: np.ndarray, seed: int, scores: np.ndarray,
                  dims: tuple[int, int], output_dir: str | Path):
    """LOST degree map, seed-correlation map, and binary seed-similarity map
    (reference: visualizations.py visualize_fms)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    w_featmap, h_featmap = dims
    out = Path(output_dir)
    for name, fm in [
        ("degree_map", (-scores).reshape(w_featmap, h_featmap)),
        ("seed_correlation", np.asarray(A)[seed].reshape(w_featmap, h_featmap)),
        ("seed_similar", (np.asarray(A)[seed] > 0).reshape(w_featmap, h_featmap)),
    ]:
        fig, ax = plt.subplots()
        im = ax.imshow(fm, cmap="viridis")
        fig.colorbar(im)
        ax.axis("off")
        _save(fig, out / f"{name}.png")


def visualize_seed_expansion(image: np.ndarray, pred_box, seed: int,
                             seed_expanded_mask: np.ndarray,
                             dims: tuple[int, int], scales: tuple[int, int],
                             output_path: str | Path):
    """Seed patch + expanded-seed mask + final box overlay
    (reference: visualizations.py visualize_seed_expansion)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    w_featmap, h_featmap = dims
    sy, sx = np.unravel_index(int(seed), (w_featmap, h_featmap))
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(image)
    mask_img = np.kron(seed_expanded_mask.reshape(w_featmap, h_featmap),
                       np.ones((scales[0], scales[1])))
    mask_img = mask_img[: image.shape[0], : image.shape[1]]
    ax.imshow(np.ma.masked_where(mask_img == 0, mask_img), alpha=0.4,
              cmap="autumn")
    ax.add_patch(plt.Rectangle((sx * scales[1], sy * scales[0]),
                               scales[1], scales[0], fill=False,
                               edgecolor="cyan", linewidth=2))
    x0, y0, x1, y1 = pred_box
    ax.add_patch(plt.Rectangle((x0, y0), x1 - x0, y1 - y0, fill=False,
                               edgecolor="red", linewidth=3))
    ax.axis("off")
    _save(fig, output_path)
