"""Rounding to the precisions one step below those a cell states, for the
control that has to come out as not correct: fp8 (e4m3, one scale per
tensor) below bf16 and fp16, TF32 (10 mantissa bits) below true f32."""
from __future__ import annotations

from contextlib import contextmanager

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale (amax -> 448),
    returned in x's dtype."""
    scale = torch.clamp_min(x.detach().abs().amax().float(), 1e-30) / FP8_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to nearest on 10 mantissa bits (TF32's), in f32."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


@contextmanager
def tf32_enabled(enabled: bool):
    """TF32 for the enclosed f32 matmuls and convolutions (True) or true
    f32 (False); the flags are restored on exit."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
