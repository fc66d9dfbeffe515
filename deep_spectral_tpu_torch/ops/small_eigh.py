"""Eigenpairs of a batch of small symmetric matrices without a host sync.

`small_eigh` is the Chebyshev solver's eigh (`ops/eigen.py`, its
Rayleigh-Ritz step): the hand-written cyclic Jacobi kernel
(`csrc/small_eigh.cu`) for CUDA tensors of order m <= SMALL_EIGH_MAX_M, which
never waits for the host, and `eigh_finite` (`torch.linalg.eigh`, a counted
host sync on a CUDA device) for CPU tensors, its plain twin, and for larger
orders. Both return (w, V, bad): eigenvalues ascending, eigenvectors as
columns, and a flag for each matrix with a non-finite entry, which is solved
as the identity. Both read the lower triangle, in f32.
"""
from __future__ import annotations

import torch

from .lobpcg import eigh_finite

# Largest order the kernel takes (one CTA a matrix, its m x m matrix and
# eigenvectors in shared memory). The stage-2 default K=20 block is 23.
SMALL_EIGH_MAX_M = 32


def sync_free(device: torch.device, m: int) -> bool:
    """Whether `small_eigh` of (., m, m) matrices on `device` runs without a
    host sync: on a CUDA device up to SMALL_EIGH_MAX_M."""
    return device.type == "cuda" and m <= SMALL_EIGH_MAX_M


def small_eigh(M: torch.Tensor):
    """Batched eigh of symmetric (B, m, m) f32 matrices: (w (B, m) ascending,
    V (B, m, m), bad (B,) bool). The kernel where `sync_free`, else
    `eigh_finite`. One launch a call: `small_eigh.launches` counts the
    launches made, and a call inside a CUDA graph capture, which launches
    nothing, counts in `small_eigh.captured` instead; whoever replays the
    graph adds its captured calls to `launches` at each replay."""
    if M.dim() != 3 or M.shape[-1] != M.shape[-2]:
        raise ValueError(f"small_eigh takes (B, m, m) matrices; got {tuple(M.shape)}")
    B, m, _ = M.shape
    if not sync_free(M.device, m):
        return eigh_finite(M)
    if M.dtype != torch.float32:
        raise TypeError(f"small_eigh's kernel takes f32; got {M.dtype}")
    M = M.contiguous()
    w = torch.empty((B, m), dtype=torch.float32, device=M.device)
    V = torch.empty((B, m, m), dtype=torch.float32, device=M.device)
    bad = torch.empty((B,), dtype=torch.bool, device=M.device)
    if B == 0:
        return w, V, bad
    from .. import _build
    lib = _build.load()
    with torch.cuda.device(M.device):
        err = lib.dss_small_eigh(M.data_ptr(), w.data_ptr(), V.data_ptr(), bad.data_ptr(),
                                 B, m, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "small_eigh")
    if torch.cuda.is_current_stream_capturing():
        small_eigh.captured += 1
    else:
        small_eigh.launches += 1
    return w, V, bad


small_eigh.launches = 0
small_eigh.captured = 0
