"""Resize ops of the port.

`resize_bicubic` is PyTorch's own `F.interpolate(mode="bicubic",
align_corners=False)`: the convention (cubic kernel a = -0.75, half-pixel
centres) that the JAX package's `ops.resize.resize_bicubic` reimplements to
resample DINO's positional embeddings. It resamples to an exact output size,
as the JAX `interpolate_pos_embed` does, not by DINO's `scale_factor` with its
+0.1 offset.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bicubic(x: torch.Tensor, out_hw: tuple[int, int], *,
                   channels_last: bool = True) -> torch.Tensor:
    """Bicubic resize of the two spatial dims to `out_hw`, in f32.

    x: (..., H, W, C) if channels_last else (..., H, W)."""
    x = x.float()
    if channels_last:
        lead, (H, W, C) = x.shape[:-3], x.shape[-3:]
        y = x.reshape(-1, H, W, C).permute(0, 3, 1, 2)
        y = F.interpolate(y, size=tuple(out_hw), mode="bicubic", align_corners=False)
        return y.permute(0, 2, 3, 1).reshape(*lead, *out_hw, C)
    lead, (H, W) = x.shape[:-2], x.shape[-2:]
    y = F.interpolate(x.reshape(-1, 1, H, W), size=tuple(out_hw), mode="bicubic",
                      align_corners=False)
    return y.reshape(*lead, *out_hw)
