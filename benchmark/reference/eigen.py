"""Plain stage-2 reference: the generalized eigenproblem (D - W) x = lam D x
of one image's patch graph (the reference repo's extract/extract.py:191-234),
solved densely.

W = relu(f_hat f_hat^T) / max over the valid patches (f_hat the L2-normed
features), d its row sums (1 where below 1e-12), and the whitened operator
A = I - D^-1/2 W D^-1/2, whose eigenvectors v give x = D^-1/2 v.
`judge` holds a solver's answer against it: the residual of each returned
pair in A, and the gap of each eigenvalue to A's own K smallest.
"""
from __future__ import annotations

import torch

from .lowp import fp8, tf32


def operator(feats: torch.Tensor, dtype=torch.float64, lowp: bool = False) -> dict:
    """The whitened operator of (n, D) valid-patch features. lowp: the
    control, the features and the operator rounded to fp8, the rest in f32
    rounded to TF32."""
    f = feats.to(dtype)
    if lowp:
        f = fp8(f.float())
    f = f / torch.clamp_min(torch.linalg.vector_norm(f, dim=-1, keepdim=True), 1e-12)
    W = torch.clamp_min(f @ f.T, 0.0)
    W = W / torch.clamp_min(W.max(), 1e-12)
    d = W.sum(dim=-1)
    d = torch.where(d < 1e-12, torch.ones_like(d), d)
    s = torch.rsqrt(d)
    S = s[:, None] * W * s[None, :]
    if lowp:
        S = fp8(S)
    A = torch.eye(len(d), dtype=S.dtype, device=S.device) - S
    return {"A": A, "d": d}


def smallest(op: dict, K: int, vectors: bool = False):
    """A's K smallest eigenvalues (and, with `vectors`, the unwhitened
    eigenvectors x (K, n), x^T D x = 1)."""
    if not vectors:
        return torch.linalg.eigvalsh(op["A"])[:K]
    w, V = torch.linalg.eigh(op["A"])
    return w[:K], (torch.rsqrt(op["d"])[:, None] * V[:, :K]).T


def control_answer(feats: torch.Tensor, K: int) -> tuple:
    """The control's eigenpairs: the reference in the program's place one
    precision step down (fp8 features and operator, TF32-rounded outputs)."""
    op = operator(feats, torch.float32, lowp=True)
    w, x = smallest(op, K, vectors=True)
    return tf32(w), tf32(x)


def judge(op: dict, ref_evals: torch.Tensor, evals, evecs) -> dict:
    """Numbers of one image's answer (evals (K,), evecs (K, n)) against the
    reference operator `op` and its K smallest eigenvalues `ref_evals`:
    `residual`, the largest ||A v - theta v|| over the K pairs with
    v = D^1/2 x / ||D^1/2 x||; `eigval_gap`, the largest |theta - lam|;
    `norm_gap`, the largest |x^T D x - 1| (the reference's M-normalization)."""
    A, d = op["A"], op["d"]
    theta = evals.to(A.device, A.dtype)
    v = torch.sqrt(d)[None, :] * evecs.to(A.device, A.dtype)
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    norm_gap = (norm[:, 0] ** 2 - 1).abs()
    v = v / torch.clamp_min(norm, 1e-300)
    r = torch.linalg.vector_norm(v @ A - theta[:, None] * v, dim=-1)
    r = torch.where(torch.isfinite(r), r, torch.full_like(r, float("inf")))
    gap = (theta - ref_evals.to(A.device, A.dtype)).abs()
    gap = torch.where(torch.isfinite(gap), gap, torch.full_like(gap, float("inf")))
    norm_gap = torch.where(torch.isfinite(norm_gap), norm_gap,
                           torch.full_like(norm_gap, float("inf")))
    return {"residual": float(r.max()), "eigval_gap": float(gap.max()),
            "norm_gap": float(norm_gap.max())}
