"""Dense semantic affinity from ViT patch features (stage 2's graph).

The port of `l2_normalize`, `feature_affinity` and `degree_vector` from
`deep_spectral_tpu.ops.affinity`, batched over a leading image dimension.

The JAX package builds the graph in true f32 (its Gram matmul is pinned to
precision HIGHEST): a TF32-rounded W moves the eigenvectors by
~||dW|| / gap, below the parity bar. Here the Gram product runs inside
`exact_f32()`, which sets `torch.backends.cuda.matmul.allow_tf32 = False`
(and cuDNN's flag) for its duration.
"""
from __future__ import annotations

from typing import Optional

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
