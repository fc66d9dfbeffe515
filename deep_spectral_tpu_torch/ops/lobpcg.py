"""Block LOBPCG for the largest eigenpairs of a batch of symmetric operators.

The port of `jax.experimental.sparse.linalg.lobpcg_standard`, which the JAX
package's stage-2 solver calls (`deep_spectral_tpu.ops.eigen._lobpcg_laplacian`),
step for step: SVQB orthonormalization ("twice is enough"), the projection of
the residuals out of [X, P], the Rayleigh-Ritz solve on [X, P, R], the
block-Householder extension of the start basis, and the exit test of
`lobpcg_standard` (a pair is converged when |A v - theta v| < tol * 10 * n *
(theta + |A v|); tol defaults to f32's machine epsilon).

`torch.lobpcg` is another algorithm (its own orthonormalization and
convergence test), so it could not be held to the JAX iterates.

Batching: every function takes a leading image dimension. JAX runs one
`while_loop` per image under `vmap`, where a lane that has stopped keeps its
state while the batch loops on; here the loop runs on the host and a stopped
lane's state is frozen with `torch.where`, so an image's result does not
depend on its batch-mates. The host waits for the device at each
iteration's exit test, at every `eigh_finite` and (twice) at the start
basis's SVD; each such point is an `eigs.sync` span, and each sync an
`eigs.syncs` count (`utils/profiling.py`).

Precision: every product runs in true f32 (`exact_f32`, no TF32), as JAX's
`_mm` pins precision HIGHEST; the small eigh, QR and SVD steps are torch's.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils.precision import exact_f32
from ..utils.profiling import count, span

_EPS = float(torch.finfo(torch.float32).eps)


def eigh_finite(M: torch.Tensor):
    """Batched eigh (ascending) that tolerates non-finite lanes: they are
    solved as the identity and flagged, instead of making LAPACK/cuSOLVER
    raise. Returns (w, V, bad). A host sync on a CUDA device: eigh reads its
    error flags back."""
    bad = ~torch.isfinite(M).all(dim=-1).all(dim=-1)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    M = torch.where(bad[:, None, None], eye, M)
    with span("eigs.sync"):
        count("eigs.syncs")
        w, V = torch.linalg.eigh(M)
    return w, V, bad


def _eigh_descending(M: torch.Tensor):
    """JAX's `_eigh_ascending` (which returns the pairs in descending order);
    a non-finite lane comes back NaN, as from JAX's eigh."""
    w, V, bad = eigh_finite(M)
    w = torch.where(bad[:, None], torch.nan, w)
    V = torch.where(bad[:, None, None], torch.nan, V)
    return w.flip(-1), V.flip(-1)


def _col_norms(X: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(X, dim=1, keepdim=True)


def _svqb(X: torch.Tensor) -> torch.Tensor:
    """A truncated orthonormal basis of X's columns (B, n, k); columns of a
    rank-deficient X come back zero."""
    norms = _col_norms(X)
    X = X / torch.where(norms == 0, 1.0, norms)
    inner = X.transpose(1, 2) @ X
    w, V = _eigh_descending(inner)
    tau = _EPS * w[:, :1]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, 1.0) ** -0.5
    orthoX = X @ (V * sqrted[:, None, :])
    # JAX pairs the eigenvalue order with the diagonal's column order here
    keep = ((w > tau) & (torch.diagonal(inner, dim1=1, dim2=2) > 0.0))[:, None, :]
    orthoX = orthoX * keep.to(orthoX.dtype)
    norms = _col_norms(orthoX)
    keep = keep & (norms > 0.0)
    return orthoX / torch.where(keep, norms, 1.0)


def _orthonormalize(X: torch.Tensor) -> torch.Tensor:
    return _svqb(_svqb(X))


def _project_out(basis: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """U's component outside span(basis), nonzero columns orthonormal;
    columns that may have picked basis components back up are zeroed."""
    for _ in range(2):
        U = U - basis @ (basis.transpose(1, 2) @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.transpose(1, 2) @ U)
    return U * (_col_norms(U) >= 0.99).to(U.dtype)


def _extend_basis(X: torch.Tensor, m: int) -> torch.Tensor:
    """m orthonormal columns orthogonal to the orthonormal X (B, n, k), from
    block Householder reflectors (deterministic, no random draw)."""
    B, n, k = X.shape
    upper = X[:, :k]
    # PyTorch's batched svd waits for a CUDA device twice (its sync debug
    # mode counts two, torch 2.11 on an H100)
    with span("eigs.sync"):
        count("eigs.syncs", 2)
        u, s, vt = torch.linalg.svd(upper)
    y = torch.cat([upper + u @ vt, X[:, k:]], dim=1)
    w = y @ (vt.transpose(1, 2) * ((2 * (1 + s)) ** -0.5)[:, None, :])
    # JAX's multi_dot([w, w[k:].T, other]) with other = [I_m; 0]: w[k:].T @
    # other is w[k:k+m].T exactly
    h = -2 * (w @ w[:, k:k + m].transpose(1, 2))
    eye = torch.eye(m, dtype=X.dtype, device=X.device)
    return torch.cat([h[:, :k], h[:, k:k + m] + eye, h[:, k + m:]], dim=1)


def lobpcg_standard(A: Callable[[torch.Tensor], torch.Tensor], X: torch.Tensor,
                    m: int = 100, tol: Optional[float] = None):
    """The largest-k eigenpairs of the symmetric operators `A` acts as.

    A: maps (B, n, c) to (B, n, c); X: (B, n, k) start directions, numerically
    independent, with 5 k < n. m caps the iterations; each lane stops once
    all k of its pairs pass the tolerance test (see the module docstring).
    Returns theta (B, k) descending, U (B, n, k) and the iterations each lane
    ran (B,)."""
    B, n, k = X.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    tol = _EPS if tol is None else float(tol)
    dev = X.device
    with exact_f32():
        X = _orthonormalize(X.float())
        P = _extend_basis(X, k)
        AX = A(X)
        theta = (X * AX).sum(dim=1)
        R = AX - theta[:, None, :] * X
        i = torch.zeros(B, dtype=torch.int32, device=dev)
        converged = torch.zeros(B, dtype=torch.int64, device=dev)
        for _ in range(m):
            active = converged < k
            with span("eigs.sync"):  # the exit test
                count("eigs.syncs")
                if not bool(active.any()):
                    break
            Rn = _project_out(torch.cat([X, P], dim=2), R)
            XPR = torch.cat([X, P, Rn], dim=2)
            th, Q = _eigh_descending(XPR.transpose(1, 2) @ A(XPR))
            Bq = Q[:, :, :k]
            Bq = Bq / _col_norms(Bq)
            Xn = XPR @ Bq
            Xn = Xn / _col_norms(Xn)
            q, _ = torch.linalg.qr(Q[:, :k, k:].transpose(1, 2))
            Pn = XPR @ (Q[:, :, k:] @ q)
            normP = _col_norms(Pn)
            Pn = Pn / torch.where(normP == 0, 1.0, normP)
            AXn = A(Xn)
            Rn = AXn - th[:, None, :k] * Xn
            reltol = (_col_norms(AXn)[:, 0] + th[:, :k]) * n * 10
            conv_n = (_col_norms(Rn)[:, 0] < tol * reltol).sum(dim=1)
            a3 = active[:, None, None]
            X, P, R = (torch.where(a3, Xn, X), torch.where(a3, Pn, P),
                       torch.where(a3, Rn, R))
            theta = torch.where(active[:, None], th[:, :k], theta)
            converged = torch.where(active, conv_n, converged)
            i = i + active.to(torch.int32)
    return theta, X, i
