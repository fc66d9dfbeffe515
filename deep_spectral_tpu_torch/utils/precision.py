"""True-f32 matmuls and convolutions on CUDA.

PyTorch runs float32 matmuls in full f32 by default
(`torch.backends.cuda.matmul.allow_tf32` is False) but float32 convolutions
through cuDNN in TF32 (`torch.backends.cudnn.allow_tf32` is True), which keeps
about three decimal digits. The JAX package pins its graph construction, its
solver's Rayleigh-Ritz and residual steps and its fp32 ViT path to true f32
(`precision=HIGHEST`); the port does the same inside `exact_f32()`, which sets
both flags to False and restores them on exit.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def exact_f32():
    """Run the enclosed float32 matmuls and convolutions without TF32."""
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
