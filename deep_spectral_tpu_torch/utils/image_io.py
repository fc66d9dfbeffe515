"""Host-side image IO and the ImageNet-normalization transform.

The reference normalizes with ImageNet statistics and applies NO resize — images keep
their native resolution and are floor-cropped to a patch multiple on device
(reference: extract/extract_utils.py:53-59, extract/extract.py:88). We keep those
semantics: decode + normalize on host (PIL/numpy), crop/resize on device.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def load_image_rgb(path: str | Path) -> np.ndarray:
    """Decode an image to an (H, W, 3) uint8 RGB array."""
    from PIL import Image
    with Image.open(str(path)) as im:
        return np.array(im.convert("RGB"))


def load_image_resized(path: str | Path, size_wh: tuple[int, int]) -> np.ndarray:
    """Decode and bilinearly resize to (W, H); returns float in [0, 1].

    Matches the reference's PIL BILINEAR downsample of the color image used for the
    KNN color affinity (reference: extract/extract.py:202-204).
    """
    from PIL import Image
    with Image.open(str(path)) as im:
        im = im.convert("RGB").resize(size_wh, Image.BILINEAR)
        return np.array(im).astype(np.float32) / 255.0


def normalize_imagenet(image_u8: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 CHW, scaled to [0,1] then ImageNet-normalized
    (reference: extract/extract_utils.py:53-59)."""
    x = image_u8.astype(np.float32) / 255.0
    x = (x - IMAGENET_MEAN) / IMAGENET_STD
    return np.transpose(x, (2, 0, 1))


# (x/255 - mean)/std folded into one multiply-add; hot-path host normalize
# is ~1.8x the composed form on this host (scripts/profile_host_path.py:
# 4.36 -> 2.46 ms per VOC image single-threaded — it skips the two
# transposes and three temporaries).
IMAGENET_SCALE = (1.0 / (255.0 * IMAGENET_STD)).astype(np.float32)
IMAGENET_SHIFT = (IMAGENET_MEAN / IMAGENET_STD).astype(np.float32)


def normalize_imagenet_hwc(image_u8: np.ndarray) -> np.ndarray:
    """uint8 HWC -> ImageNet-normalized float32 HWC (the layout every kernel
    here consumes), in one fused pass. Equals
    `normalize_imagenet(x).transpose(1, 2, 0)` to 1e-5."""
    return image_u8.astype(np.float32) * IMAGENET_SCALE - IMAGENET_SHIFT


def denormalize_imagenet(image_chw: np.ndarray) -> np.ndarray:
    """Inverse of `normalize_imagenet`; float32 CHW -> float HWC in [0,1]
    (reference: extract/extract_utils.py:62-70)."""
    x = np.transpose(image_chw, (1, 2, 0))
    return x * IMAGENET_STD + IMAGENET_MEAN


def read_image_list(images_list: str | Path, images_root: Optional[str | Path]) -> list[Path]:
    """Read an images.txt list; paths resolved under `images_root` when given.

    The reference sorts and dedups the list (reference: extract/extract_utils.py:23).
    """
    names = Path(images_list).read_text().splitlines()
    names = sorted(set(n for n in names if n.strip()))
    root = Path(images_root) if images_root is not None else None
    return [root / n if root is not None else Path(n) for n in names]
