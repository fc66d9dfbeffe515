"""The numbers that decide `correct`, and the verdict against the limits.

Every number is a widest gap over the answers compared (larger is worse);
`limits/<workload>.json` holds each number's limit and the readings it was
set from. A number that is not finite, or a limit with no number, fails.
"""
from __future__ import annotations

import math

import torch

from .reference import eigen as ref_eigen


def keys_gap(port: list, ref: list) -> float:
    """Largest ||k_port - k_ref|| / ||k_ref|| over images (valid patches)."""
    worst = 0.0
    for kp, kr in zip(port, ref, strict=True):
        kr = kr.double()
        gap = float(torch.linalg.vector_norm(kp.double() - kr) / torch.linalg.vector_norm(kr))
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def eig_gaps(feats16: list, answers: list, K: int) -> dict:
    """Largest gaps over images of the answers (evals (K,), evecs (K, n))
    against the reference operator of each image's fp16 features (n, D):
    `eig_residual`, `eigval_gap` and `eigvec_norm_gap` (|x^T D x - 1|)."""
    worst = {"eig_residual": 0.0, "eigval_gap": 0.0, "eigvec_norm_gap": 0.0}
    for f, (evals, evecs) in zip(feats16, answers, strict=True):
        op = ref_eigen.operator(f)
        got = ref_eigen.judge(op, ref_eigen.smallest(op, K), evals, evecs)
        for name, key in (("eig_residual", "residual"), ("eigval_gap", "eigval_gap"),
                          ("eigvec_norm_gap", "norm_gap")):
            v = got[key]
            worst[name] = max(worst[name], v if math.isfinite(v) else math.inf)
    return worst


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for each limited number."""
    checks, ok = {}, True
    for name, lim in limits["limits"].items():
        value = numbers.get(name, math.inf)
        value = value if math.isfinite(value) else math.inf
        checks[name] = {"value": value, "limit": lim}
        ok = ok and value <= lim
    return ok, checks
