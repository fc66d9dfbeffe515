"""Image/patch-grid size arithmetic.

Matches the size conventions of the reference pipeline
(reference: extract/extract_utils.py:73-79): an image of shape (H, W) processed by a
ViT with patch size P yields a patch grid of (H_patch, W_patch) = (H//P, W//P) and a
"padded" (actually floor-cropped) pixel extent (H_pad, W_pad) = (H_patch*P, W_patch*P).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ImageSizes:
    B: int
    C: int
    H: int
    W: int
    P: int
    H_patch: int
    W_patch: int
    H_pad: int
    W_pad: int

    def __iter__(self):
        # Allow tuple-unpacking in the reference's 9-tuple order.
        yield from (self.B, self.C, self.H, self.W, self.P,
                    self.H_patch, self.W_patch, self.H_pad, self.W_pad)


def get_image_sizes(data_dict: dict, downsample_factor: Optional[int] = None) -> ImageSizes:
    """Derive patch-grid sizes from a stored feature dict.

    `data_dict['shape']` is the original (B, C, H, W) of the image tensor and
    `data_dict['patch_size']` the ViT patch size (reference: extract/extract_utils.py:73-79).
    """
    P = int(data_dict["patch_size"] if downsample_factor is None else downsample_factor)
    B, C, H, W = (int(x) for x in data_dict["shape"])
    if B != 1:
        raise ValueError(f"feature dicts are per-image; got batch dim {B}")
    H_patch, W_patch = H // P, W // P
    H_pad, W_pad = H_patch * P, W_patch * P
    return ImageSizes(B, C, H, W, P, H_patch, W_patch, H_pad, W_pad)


def patch_grid(H: int, W: int, P: int) -> tuple[int, int, int, int]:
    """(H_patch, W_patch, H_pad, W_pad) for an image of extent (H, W) and patch P."""
    H_patch, W_patch = H // P, W // P
    return H_patch, W_patch, H_patch * P, W_patch * P


def infer_patch_grid(num_tokens: int, H: int, W: int) -> tuple[int, int, int]:
    """Infer (P_effective, H_lr, W_lr) from a flat patch-mask length and image size.

    Handles native P=8/P=16 grids as well as 2x/4x upsampled eigenvector grids
    (reference: object-localization/object_discovery.py:88-99).
    """
    if (H // 8) * (W // 8) == num_tokens:
        return 8, H // 8, W // 8
    if (H // 16) * (W // 16) == num_tokens:
        return 16, H // 16, W // 16
    if 4 * (H // 16) * (W // 16) == num_tokens:
        return 8, 2 * (H // 16), 2 * (W // 16)
    if 16 * (H // 32) * (W // 32) == num_tokens:
        return 8, 4 * (H // 32), 4 * (W // 32)
    raise ValueError(f"cannot infer patch grid: {num_tokens=} for image {(H, W)}")
