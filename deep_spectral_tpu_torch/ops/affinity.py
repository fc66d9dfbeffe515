"""Stage 2's affinity graphs: the dense semantic affinity from ViT patch
features and the pixel color affinities fused into it.

The port of `deep_spectral_tpu.ops.affinity`, batched over a leading image
dimension: `l2_normalize`, `feature_affinity` and `degree_vector`, and the
color graphs `knn_affinity` (color + position KNN, extract_utils.py:151-188)
and `rw_affinity` (pymatting's random-walk weights, extract_utils.py:191-204),
which take a validity mask per image as the JAX package's vmapped
`knn_affinity_batched` does.

The JAX package builds the graph in true f32 (its Gram matmul is pinned to
precision HIGHEST): a TF32-rounded W moves the eigenvectors by
~||dW|| / gap, below the parity bar. Here the Gram product runs inside
`exact_f32()`, which sets `torch.backends.cuda.matmul.allow_tf32 = False`
(and cuDNN's flag) for its duration.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.precision import exact_f32


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Torch-style F.normalize(p=2): x / max(||x||, eps) (reference: extract/extract.py:148)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(n, eps)


def feature_affinity(feats: torch.Tensor, *, normalize: bool = True,
                     threshold_at_zero: bool = True, max_normalize: bool = True,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W = relu(f f^T) / max(W) per image, in true f32.

    feats: (..., N, D); mask: optional (..., N) bool validity. The features
    are masked (not W), which zeroes padded rows and columns of W exactly.
    max_normalize divides by each image's own max. Matches reference:
    extract/extract.py:191-194 (laplacian) and :167-169 (affinity)."""
    f = feats.float()
    if normalize:
        f = l2_normalize(f, dim=-1)
    if mask is not None:
        f = f * mask.to(f.dtype)[..., None]
    with exact_f32():
        W = f @ f.transpose(-1, -2)
    if threshold_at_zero:
        W = torch.clamp_min(W, 0.0)
    if max_normalize:
        W = W / torch.clamp_min(W.amax(dim=(-2, -1), keepdim=True), 1e-12)
    return W


def degree_vector(W: torch.Tensor, threshold: float = 1e-12) -> torch.Tensor:
    """Row sums with the reference's divide-by-zero clamp: d[d < 1e-12] = 1
    (reference: extract/extract_utils.py:207-220)."""
    d = W.sum(dim=-1)
    return torch.where(d < threshold, 1.0, d)


def _pixel_coord_features(h: int, w: int, distance_weight: float, device):
    """x = tile(linspace(0, 1, w), h) and y = repeat(linspace(0, 1, h), w),
    scaled (reference: extract/extract_utils.py:165-166). linspace(0, 1, n)
    is rounded as XLA rounds `jnp.linspace`: f32(i) * f32(1 / (n - 1)), the
    last entry exactly 1."""
    def linspace(n):
        x = torch.arange(n, dtype=torch.float32, device=device)
        if n > 1:
            x = x * float(np.float32(1.0) / np.float32(n - 1))
            x[-1] = 1.0
        return x
    return distance_weight * linspace(w).repeat(h), \
        distance_weight * linspace(h).repeat_interleave(w)


def _knn_indices(f: torch.Tensor, k: int, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, n, k) exact k-nearest-neighbour indices under squared L2, self
    included, ties to the lowest index (the order of JAX's `top_k`): a
    stable sort, since `torch.topk` fixes no order among ties. The squared
    norms are summed channel after channel, XLA's order for a 5-wide sum."""
    sq = f[..., 0] * f[..., 0]
    for c in range(1, f.shape[-1]):
        sq = sq + f[..., c] * f[..., c]
    with exact_f32():
        d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * (f @ f.transpose(1, 2))
    if valid is not None:
        d2 = torch.where(valid[:, None, :], d2, torch.finfo(d2.dtype).max)
    return torch.sort(d2, dim=-1, stable=True)[1][..., :k]


def knn_affinity(images_lr: torch.Tensor, n_neighbors: Sequence[int] = (20, 10),
                 distance_weights: Sequence[float] = (2.0, 0.1), *,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense KNN color affinity over low-res pixels, per image.

    images_lr: (B, h, w, 3) float images in [0, 1] (the reference's bilinear
    downsample to the patch grid, extract/extract.py:202-204); mask: optional
    (B, h*w) validity. Returns W (B, h*w, h*w) f32, symmetric, with
    W[a, b] = (#knn lists of a holding b) + (#knn lists of b holding a): the
    reference's duplicate-summing CSR matrix (extract_utils.py:182-187).
    Pixel coordinates span the whole (h, w) grid, padding included, as in the
    JAX package."""
    B, h, w, _ = images_lr.shape
    n = h * w
    rgb = images_lr.reshape(B, n, 3).float()
    valid = None if mask is None else mask.to(torch.bool)
    W = torch.zeros((B, n, n), dtype=torch.float32, device=rgb.device)
    for k, distance_weight in zip(n_neighbors, distance_weights):
        xw, yw = _pixel_coord_features(h, w, float(distance_weight), rgb.device)
        f = torch.cat([rgb, xw.expand(B, n)[..., None], yw.expand(B, n)[..., None]], dim=-1)
        if valid is not None:
            f = torch.where(valid[..., None], f, 1e6)  # never anyone's neighbour
        idx = _knn_indices(f, int(k), valid)
        A = torch.zeros((B, n, n), dtype=torch.float32, device=rgb.device)
        A.scatter_(2, idx, 1.0)  # the k neighbours of a row are distinct
        if valid is not None:
            vf = valid.to(torch.float32)
            A = A * vf[:, :, None] * vf[:, None, :]
        W = W + A + A.transpose(1, 2)
    return W


def rw_affinity(images_lr: torch.Tensor, sigma: float = 0.033, radius: int = 1, *,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense random-walk color affinity, pymatting's `_rw_laplacian` weights
    (reference: extract/extract_utils.py:191-204), per image.

    For every pixel i and offset (dy, dx) of the (2r+1)^2 window the
    neighbour is clamped into the image (into the valid top-left rectangle of
    a padded image), and W[i, j] gains exp(-||c_i - c_j||^2 / (2 sigma^2))
    for each offset that lands on j. The offsets are added one at a time in
    JAX's (dy, dx) order; within one offset every row i appears once, so each
    entry's sum runs in the same order in both packages and on any device.
    images_lr: (B, h, w, 3); mask: optional (B, h*w). Returns (B, h*w, h*w)."""
    B, h, w, _ = images_lr.shape
    n = h * w
    img = images_lr.float()
    dev = img.device
    rows = torch.arange(h, device=dev)[None, :, None].expand(B, h, w)
    cols = torch.arange(w, device=dev)[None, None, :].expand(B, h, w)
    flat_idx = (rows * w + cols).reshape(B, n)
    if mask is None:
        vh = torch.full((B, 1, 1), h, device=dev)
        vw = torch.full((B, 1, 1), w, device=dev)
        valid2d = None
    else:
        m2 = mask.reshape(B, h, w)
        # padding is bottom/right: the valid region is [0, vh) x [0, vw)
        vh = m2[:, :, 0].sum(dim=1).reshape(B, 1, 1)
        vw = m2[:, 0, :].sum(dim=1).reshape(B, 1, 1)
        valid2d = m2.to(torch.float32)
    batch = torch.arange(B, device=dev)[:, None, None].expand(B, h, w)
    W = torch.zeros((B, n, n), dtype=torch.float32, device=dev)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            ny = torch.minimum(torch.clamp_min(rows + dy, 0), vh - 1)
            nx = torch.minimum(torch.clamp_min(cols + dx, 0), vw - 1)
            neighbor = img[batch, ny, nx]
            d2 = ((img - neighbor) ** 2).sum(dim=-1)
            wgt = torch.exp(-d2 / (2.0 * sigma * sigma))
            if valid2d is not None:
                wgt = wgt * valid2d  # rows outside the valid region add nothing
            nbr_idx = (ny * w + nx).reshape(B, n)
            W.index_put_((batch.reshape(B, n), flat_idx, nbr_idx), wgt.reshape(B, n),
                         accumulate=True)
    return W
