"""K-means and PCA of the port (`deep_spectral_tpu.ops.kmeans` in PyTorch).

The JAX package replaces the reference's sklearn calls (per-image KMeans
over eigenvector rows, extract/extract.py:320-329; the dataset-wide
MiniBatchKMeans over bbox features, :581; PCA before it, :574-577) with
k-means++ seeding and exact full-batch Lloyd, best of `n_init` restarts.
The port keeps that algorithm and its arithmetic:
  * distances as xn + cn - 2 X C^T and center sums as a one-hot matmul, both
    in true f32 (`utils.precision.exact_f32`; no TF32, and no `index_add_`,
    whose CUDA atomics would make the summation order run-dependent);
  * `argmin` ties go to the first index, for the labels and for the best of
    the restarts;
  * a lane (one image's one restart) stops when its center shift is at most
    `tol` or after `max_iter` steps, and keeps its carry while the others go
    on, as JAX's vmapped `while_loop` does. A stopped lane's later steps are
    exact no-ops, so the host asks "every lane stopped?" only every
    POLL_EVERY steps.

Draws: JAX draws the k-means++ seeding from `jax.random`, which torch cannot
reproduce. The port draws from a `torch.Generator`: each image's generator
gives (n_init, k) uniforms on the host, and the seeding turns them into
D^2-weighted row choices on the device by inverse CDF, so an image's draw
depends on its generator only, not on its batch. `kmeanspp_init` and
`lloyd` are separate, so a test can hand both packages the same initial
centers (JAX `_lloyd(X, c0, ...)`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch

from ..utils.device import POLL_EVERY
from ..utils.precision import exact_f32


class KMeansResult(NamedTuple):
    labels: torch.Tensor   # (..., n) int64, -1 on masked rows
    centers: torch.Tensor  # (..., k, d) float32
    inertia: torch.Tensor  # (...,) float32
    n_iter: torch.Tensor   # (...,) int32, Lloyd steps the lane ran


def lane_sq_dists(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Squared distances xn + cn - 2 X C^T in true f32 for every lane:
    X (B, n, d), C (B, R, k, d) -> (B, R, n, k). One matmul per image, the
    R restarts' centers side by side."""
    B, R, k, d = C.shape
    xn = (X * X).sum(-1)[:, None, :, None]
    cn = (C * C).sum(-1)[:, :, None, :]
    with exact_f32():
        xc = torch.bmm(X, C.reshape(B, R * k, d).transpose(1, 2))
    return xn + cn - 2.0 * xc.reshape(B, -1, R, k).permute(0, 2, 1, 3)


def sq_dists(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """(n, k) squared distances of X (n, d) to C (k, d) (JAX `_sq_dists`)."""
    return lane_sq_dists(X[None], C[None, None])[0, 0]


def _valid(X: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.ones(X.shape[:2], dtype=torch.bool, device=X.device)
    return mask.to(device=X.device, dtype=torch.bool)


def _draw(w: torch.Tensor, u: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """One row per lane with P(i) proportional to w[..., i] (w >= 0, zero on
    masked rows), by inverse CDF at the uniforms u (...). A lane whose
    weights are all 0 (fewer distinct rows than centers) draws uniformly
    from its valid rows."""
    w = w.double()
    w = torch.where(w.sum(-1, keepdim=True) > 0, w, valid.double())
    cdf = torch.cumsum(w, -1)
    idx = torch.searchsorted(cdf, (u.double() * cdf[..., -1])[..., None], right=True)[..., 0]
    last = w.shape[-1] - 1 - torch.flip(w > 0, [-1]).to(torch.int8).argmax(-1)
    return torch.minimum(idx, last)


def kmeanspp_init(X: torch.Tensor, k: int, u: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k-means++ seeding (D^2-weighted draws) of every lane: X (B, n, d),
    u (B, R, k) uniforms in [0, 1) -> centers (B, R, k, d). Center 0 is a
    uniform draw over the valid rows, center i a draw with weights the
    squared distance to the nearest of centers 0..i-1, as JAX's
    `_kmeanspp_init`; every center is a valid row of X."""
    X = X.float()
    B, n, d = X.shape
    R = u.shape[1]
    valid = _valid(X, mask)[:, None, :].expand(B, R, n)
    rows = torch.arange(B, device=X.device)[:, None]
    u = u.to(X.device)
    centers = X.new_zeros((B, R, k, d))
    mind = valid.float()
    for i in range(k):
        c = X[rows, _draw(mind, u[..., i], valid)]            # (B, R, d)
        centers[:, :, i] = c
        dist = torch.where(valid, ((X[:, None] - c[:, :, None]) ** 2).sum(-1), 0.0)
        mind = dist if i == 0 else torch.minimum(mind, dist)
    return centers


def lloyd(X: torch.Tensor, centers: torch.Tensor, max_iter: int = 300,
          mask: Optional[torch.Tensor] = None, tol: float = 1e-8) -> KMeansResult:
    """Exact Lloyd iterations of every lane from `centers`: X (B, n, d),
    centers (B, R, k, d) -> a KMeansResult of (B, R) lanes (JAX `_lloyd`,
    vmapped). Masked rows take no part and get label -1."""
    X = X.float()
    C = centers.to(device=X.device, dtype=torch.float32).clone()
    B, R, k, d = C.shape
    n = X.shape[1]
    valid = _valid(X, mask)
    vf = valid.float()[:, None, :, None]
    it = torch.zeros((B, R), dtype=torch.int32, device=X.device)
    shift = torch.full((B, R), float("inf"), device=X.device)
    iota = torch.arange(k, device=X.device)
    for step in range(max_iter):  # a lane's steps <= step < max_iter
        active = shift > tol
        if step % POLL_EVERY == 0 and not bool(active.any()):
            break
        labels = lane_sq_dists(X, C).argmin(-1)               # (B, R, n)
        onehot = (labels[..., None] == iota).float() * vf      # (B, R, n, k)
        counts = onehot.sum(2)[..., None]                      # (B, R, k, 1)
        with exact_f32():
            sums = torch.bmm(onehot.permute(0, 1, 3, 2).reshape(B, R * k, n), X)
        new = torch.where(counts > 0, sums.reshape(B, R, k, d) / counts.clamp_min(1.0), C)
        moved = ((new - C) ** 2).sum((-1, -2))
        C = torch.where(active[..., None, None], new, C)
        shift = torch.where(active, moved, shift)
        it = it + active.to(torch.int32)
    # one final assignment against the converged centers
    d2 = lane_sq_dists(X, C)
    labels = torch.where(valid[:, None], d2.argmin(-1), -1)
    inertia = (d2.amin(-1) * valid[:, None]).sum(-1)
    return KMeansResult(labels, C, inertia, it)


def draw_uniforms(generator: torch.Generator, n_init: int, k: int) -> torch.Tensor:
    """The (n_init, k) uniforms of one image's k-means++ seedings, on the host."""
    return torch.rand((n_init, k), generator=generator, dtype=torch.float64)


def kmeans(X: torch.Tensor, k: int,
           generator: Union[torch.Generator, Sequence[torch.Generator]], *,
           n_init: int = 10, max_iter: int = 300, mask: Optional[torch.Tensor] = None,
           tol: float = 1e-8) -> KMeansResult:
    """Exact Lloyd k-means with k-means++ seeding, best of `n_init` restarts
    (sklearn's defaults n_init=10, max_iter=300; JAX `kmeans`).

    X (n, d) with one generator, or a batch (B, n, d) with one generator
    per image (B of them); mask ((B,) n) marks the rows that take part. The
    restarts of every image run as lanes of one batched Lloyd on X's
    device; the best restart is the first of least inertia."""
    batched = X.dim() == 3
    if not batched:
        X, generator = X[None], [generator]
        mask = None if mask is None else mask[None]
    if len(generator) != X.shape[0]:
        raise ValueError(f"{len(generator)} generators for {X.shape[0]} images")
    X = X.float()
    u = torch.stack([draw_uniforms(g, n_init, k) for g in generator])
    res = lloyd(X, kmeanspp_init(X, k, u, mask), max_iter, mask, tol)
    best = res.inertia.argmin(1)
    rows = torch.arange(X.shape[0], device=X.device)
    out = KMeansResult(*(f[rows, best] for f in res))
    return out if batched else KMeansResult(*(f[0] for f in out))


def pca(X: torch.Tensor, dim: int) -> torch.Tensor:
    """PCA projection to `dim` components by a centered SVD in true f32,
    with the svd_flip-style signs of the JAX package (the largest-|.| entry
    of each right singular vector made positive), as sklearn's
    `PCA(dim).fit_transform` up to those signs (reference:
    extract/extract.py:574-577)."""
    X = X.float()
    Xc = X - X.mean(0, keepdim=True)
    with exact_f32():
        U, S, Vt = torch.linalg.svd(Xc, full_matrices=False)
    signs = torch.sign(Vt.gather(1, Vt.abs().argmax(1, keepdim=True)))[:, 0]
    return (U * S[None, :] * signs[None, :])[:, :dim]
