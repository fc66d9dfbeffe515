"""Resize ops of the port.

`resize_bilinear` (gather form) and `resize_bilinear_mm` (two interpolation
matmuls) are the JAX package's `ops.resize` functions of the same names, with
the same index arithmetic (torch `align_corners=False` half-pixel sources,
clamped edges), in true f32: the DeepLab logits upsample (the matmul form in
training, the gather form in evaluation).

`resize_nearest` is the JAX package's function of that name: cv2
INTER_NEAREST source indices floor(dst * in / out), the product in f32 as
the JAX package computes it; the object-segmentation evaluation upsamples
patch-level masks with it.

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

from ..utils.precision import exact_f32


def _linear_weights(out_size: int, in_size: int, device):
    """(i0, i1, frac) of the JAX package's `_linear_weights`, in f32."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    src = (i + 0.5) * (in_size / out_size) - 0.5
    i0 = torch.clamp(torch.floor(src), 0, in_size - 1).to(torch.int64)
    i1 = torch.clamp(i0 + 1, 0, in_size - 1)
    frac = torch.clamp(src - torch.floor(src), 0.0, 1.0)
    frac = torch.where(src < 0, 0.0, frac)
    frac = torch.where(src > in_size - 1, 1.0, frac)
    return i0, i1, frac


def _resize_axis_linear(x: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    i0, i1, frac = _linear_weights(out_size, in_size, x.device)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w = frac.reshape(shape)
    return x.index_select(axis, i0) * (1.0 - w) + x.index_select(axis, i1) * w


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int], *,
                    channels_last: bool = True) -> torch.Tensor:
    """Separable bilinear resize matching F.interpolate(align_corners=False),
    in f32. x: (..., H, W, C) if channels_last else (..., H, W)."""
    h_axis = x.ndim - 3 if channels_last else x.ndim - 2
    x = _resize_axis_linear(x.float(), out_hw[0], h_axis)
    return _resize_axis_linear(x, out_hw[1], h_axis + 1)


def _linear_resize_matrix(out_size: int, in_size: int, device) -> torch.Tensor:
    """(out_size, in_size) f32 matrix R with R @ x == the gather form: (1-frac)
    at i0 and frac at i1, summed where they coincide at clamped edges."""
    i0, i1, frac = _linear_weights(out_size, in_size, device)
    rows = torch.arange(out_size, device=device)
    R = torch.zeros((out_size, in_size), dtype=torch.float32, device=device)
    R.index_put_((rows, i0), 1.0 - frac, accumulate=True)
    R.index_put_((rows, i1), frac, accumulate=True)
    return R


def resize_bilinear_mm(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize as two true-f32 matmuls (the JAX package pins them to
    precision HIGHEST): x (B, H, W, C) -> (B, out_h, out_w, C). Equal to
    `resize_bilinear` up to f32 summation order."""
    B, H, W, C = x.shape
    out_h, out_w = out_hw
    x = x.float()
    with exact_f32():
        if W != out_w:
            x = torch.einsum("Ww,bhwc->bhWc", _linear_resize_matrix(out_w, W, x.device), x)
        if H != out_h:
            x = torch.einsum("Hh,bhWc->bHWc", _linear_resize_matrix(out_h, H, x.device), x)
    return x


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


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of the last two dims with cv2 INTER_NEAREST
    semantics, src = floor(dst * in / out) in f32
    (reference: extract/extract.py:679-680). x: (..., H, W), any dtype."""
    for axis, size in ((x.ndim - 2, out_hw[0]), (x.ndim - 1, out_hw[1])):
        n_in = x.shape[axis]
        src = torch.floor(torch.arange(size, dtype=torch.float32, device=x.device)
                          * torch.tensor(n_in / size, dtype=torch.float32))
        x = x.index_select(axis, src.long().clamp(0, n_in - 1))
    return x
