"""Smallest-K Laplacian eigenpairs of one graph by LOBPCG: the port of
`deep_spectral_tpu.parallel.lobpcg`. The solver is `ops.eigen`'s
(`solver='lobpcg'`: block LOBPCG on the Gershgorin-shifted whitened
operator, `ops/lobpcg.py`); its row-sharded form is
`parallel.sharded.row_sharded_laplacian_eigs`."""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.eigen import laplacian_eigs


def lobpcg_laplacian_eigs(W: torch.Tensor, K: int, *, iters: int = 120,
                          mask: Optional[torch.Tensor] = None,
                          apply_sign_fix: bool = True, x0=None):
    """Smallest-K generalized eigenpairs of (D - W, D) via LOBPCG.

    Same contract as ops.eigen.laplacian_eigs(lapnorm=True): returns
    (eigenvalues (K,), eigenvectors (K, N)) ascending, x^T D x = 1. x0: the
    (N, K + 3) start block (default `ops.eigen.default_start_block`)."""
    return laplacian_eigs(W, K, lapnorm=True, mask=mask, apply_sign_fix=apply_sign_fix,
                          solver="lobpcg", lobpcg_iters=iters, x0=x0)
