"""On-disk serialization, byte-compatible with the reference pipeline's layout.

The reference exchanges data between stages exclusively through per-image files:
`<id>.pth` torch-pickle dicts for features/eigs/bboxes and `.png` images for segmaps
(reference: extract/extract.py:113, :243-244, :496; README.md data layout). A copy
of `deep_spectral_tpu.utils.serialization` without its jax branches, so files written
by either package load in the other.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np


def _to_numpy(obj: Any) -> Any:
    """Recursively convert torch tensors to numpy for a neutral in-memory form."""
    import torch
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_to_numpy(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return obj


def _to_torch(obj: Any) -> Any:
    import torch
    if isinstance(obj, dict):
        return {k: _to_torch(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = type(obj)
        return t(_to_torch(v) for v in obj)
    if isinstance(obj, np.ndarray) and obj.dtype != object and obj.dtype.kind not in "US":
        arr = np.ascontiguousarray(obj)
        if not arr.flags.writeable:
            arr = arr.copy()
        return torch.from_numpy(arr)
    return obj


def save_pth(obj: Any, path: str | Path) -> None:
    """Save a dict of arrays as a torch-pickle `.pth`, as the reference stages do."""
    import torch
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_to_torch(obj), str(path))


def load_pth(path: str | Path) -> Any:
    """Load a `.pth` file into numpy-backed python objects."""
    import torch
    obj = torch.load(str(path), map_location="cpu", weights_only=False)
    return _to_numpy(obj)


def load_pth_meta(path: str | Path) -> Any:
    """Load a `.pth` dict's structure WITHOUT reading tensor data: tensors
    come back as their shape tuples, everything else as-is.

    torch's zip container mmaps storages lazily under `mmap=True`, so a
    shape-only scan never faults the tensor pages in — measured 0.38 vs
    0.60 ms per feature dict on this host (scripts/profile_host_path.py).
    Used by the stage-2 size scan, which reads every feature dict once just
    for its grid shape (pipeline/extract.py)."""
    import torch

    def shapes(obj):
        if isinstance(obj, dict):
            return {k: shapes(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(shapes(v) for v in obj)
        if isinstance(obj, torch.Tensor):
            return tuple(obj.shape)
        return obj

    return shapes(torch.load(str(path), map_location="cpu",
                             weights_only=False, mmap=True))


def save_segmap_png(segmap: np.ndarray, path: str | Path) -> None:
    """Save an integer segmentation map as an 8-bit grayscale PNG
    (reference: extract/extract.py:351, :406, :645, :693)."""
    from PIL import Image
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(segmap)
    if arr.dtype == bool:
        arr = arr.astype(np.uint8)
    Image.fromarray(arr.astype(np.uint8)).convert("L").save(str(path))


def load_segmap_png(path: str | Path) -> np.ndarray:
    from PIL import Image
    return np.array(Image.open(str(path)))
