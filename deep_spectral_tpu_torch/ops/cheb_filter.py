"""Chebyshev filter chain T_degree(((I - S) - c) / e) X, batched over images.

`chebyshev_filter` launches the hand-written Hopper kernel
(`csrc/cheb_filter.cu`, the port of the JAX package's Pallas `_cheb_kernel`)
for CUDA tensors, and computes the same function with its plain PyTorch twin,
`chebyshev_filter_plain`, for CPU tensors. A CUDA tensor the kernel does not
take raises; there is no other fallback.

Arithmetic (the Pallas form, shared by kernel and twin):
    a_shift(t) = ((1 - c) t - S bf16(t)) * (1 / e)      f32 accumulation
    T_0 = X, T_1 = a_shift(X), T_{j+1} = 2 a_shift(T_j) - T_{j-1}
and every step after the first scales (T_j, T_{j+1}) of each column by
1 / max(max |T_{j+1}|, 1), which keeps |T_j| near 1 (the caller's
Rayleigh-Ritz normalizes the per-column scale away).
"""
from __future__ import annotations

from typing import Union

import torch

Scalar = Union[float, torch.Tensor]


def _per_image(x: Scalar, B: int, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(-1).expand(B)


def chebyshev_filter_plain(S: torch.Tensor, X: torch.Tensor, c: Scalar,
                           e: Scalar, degree: int) -> torch.Tensor:
    """Plain PyTorch twin: the operator product is `S.float() @
    bf16(t).float()` (operands rounded to S's dtype, f32 accumulation, as the
    TPU kernel does), not torch's reduced-precision-output matmul.
    S (B, N, N), X (B, N, m) f32, c/e scalars or (B,). Returns (B, N, m) f32."""
    if degree < 1:
        raise ValueError("degree must be >= 1")
    B = X.shape[0]
    c = _per_image(c, B, X.device)[:, None, None]
    inv_e = 1.0 / _per_image(e, B, X.device)[:, None, None]
    Sf = S.float()

    def a_shift(t):
        st = Sf @ t.to(S.dtype).float()
        return ((1.0 - c) * t - st) * inv_e

    one = torch.ones((), dtype=torch.float32, device=X.device)
    t0 = X.float()
    t1 = a_shift(t0)
    for _ in range(degree - 1):
        t2 = 2.0 * a_shift(t1) - t0
        sc = 1.0 / torch.maximum(t2.abs().amax(dim=1, keepdim=True), one)
        t0, t1 = t1 * sc, t2 * sc
    return t1


def chebyshev_filter(S: torch.Tensor, X: torch.Tensor, c: Scalar, e: Scalar,
                     degree: int) -> torch.Tensor:
    """T_degree(((I - S) - c) / e) X per image.

    S: (B, N, N) whitened operator; X: (B, N, m) f32; c, e: window
    parameters, scalars or per image (B,). CPU tensors run the plain twin.
    CUDA tensors run the kernel, which takes a bf16 S and f32 X, any m (in
    groups of 8 columns) and any N. Returns a new (B, N, m) f32 tensor.

    The kernel runs one launch per step of the chain plus a last rescale
    pass, all from one call; `chebyshev_filter.launches` counts calls, that
    is whole chains, not those launches."""
    if degree < 1:
        raise ValueError("degree must be >= 1")
    if not X.is_cuda:
        return chebyshev_filter_plain(S, X, c, e, degree)
    B, N, m = X.shape
    if S.dtype != torch.bfloat16 or X.dtype != torch.float32:
        raise TypeError(f"cheb kernel takes bf16 S and f32 X; got {S.dtype}, {X.dtype}")
    if tuple(S.shape) != (B, N, N):
        raise ValueError(f"S shape {tuple(S.shape)} != {(B, N, N)}")
    if S.device != X.device:
        raise ValueError(f"S is on {S.device}, X on {X.device}")
    # the kernel's vector loads need 16-byte aligned bases
    S, X = (x if x.data_ptr() % 16 == 0 else x.clone()
            for x in (S.contiguous(), X.contiguous()))
    ce = torch.stack([_per_image(c, B, X.device), _per_image(e, B, X.device)],
                     dim=1).contiguous()
    out = torch.empty((B, N, m), dtype=torch.float32, device=X.device)
    # T_{j-1} and the two alternating unscaled T_j, and each step's column maxima
    work = torch.empty((3, B, N, m), dtype=torch.float32, device=X.device)
    colmax = torch.empty((degree + 1, B, m), dtype=torch.int32, device=X.device)
    from .. import _build
    lib = _build.load()
    with torch.cuda.device(X.device):
        err = lib.dss_cheb_filter(
            S.data_ptr(), X.data_ptr(), ce.data_ptr(), out.data_ptr(), work.data_ptr(),
            colmax.data_ptr(), B, N, m, degree, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "chebyshev_filter")
    chebyshev_filter.launches += 1
    return out


chebyshev_filter.launches = 0
