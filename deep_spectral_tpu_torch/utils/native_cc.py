"""ctypes bindings for the native connected-component labeler
(`native/cc_label.cpp`), the port's own copy of `deep_spectral_tpu.utils.native_cc`.

The source is compiled with g++ at first use into
`deep_spectral_tpu_torch/_build/cclabel_<hash>.so` (gitignored; written to a
temporary name and renamed into place, so processes that build at once all
end with a whole library). Without a compiler every function falls back to
scipy.ndimage, as the JAX package's copy does; `backend()` says which one
runs. Host code: the localization task labels patch grids of a few
thousand cells.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "cc_label.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _build_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        src = _SRC.read_text()
        tag = hashlib.sha256(src.encode()).hexdigest()[:16]
        cache = _BUILD_DIR / f"cclabel_{tag}.so"
        if not cache.is_file():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", tmp],
                               check=True, capture_output=True)
                os.replace(tmp, cache)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(cache))
        lib.cc_label.restype = ctypes.c_int32
        lib.cc_label.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
        lib.largest_component.restype = ctypes.c_int64
        lib.largest_component.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8)]
        lib.label_bboxes.restype = None
        lib.label_bboxes.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _lib_failed = True
    return _lib


def backend() -> str:
    """'native' when the g++ build loads, else 'scipy'."""
    return "native" if _build_lib() is not None else "scipy"


def _as_u8(mask: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(mask.astype(np.uint8))


def cc_label(mask: np.ndarray, connectivity: int = 2) -> tuple[np.ndarray, int]:
    """(labels int32 (h, w) with 0 background, num_components)."""
    lib = _build_lib()
    h, w = mask.shape
    if lib is None:
        import scipy.ndimage as ndi
        structure = np.ones((3, 3)) if connectivity == 2 else None
        labels, num = ndi.label(mask, structure=structure)
        return labels.astype(np.int32), int(num)
    m = _as_u8(mask)
    labels = np.empty((h, w), np.int32)
    num = lib.cc_label(m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       h, w, connectivity,
                       labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels, int(num)


def largest_component(mask: np.ndarray, connectivity: int = 2) -> np.ndarray:
    """The largest connected component of `mask`, as a bool mask."""
    lib = _build_lib()
    h, w = mask.shape
    if lib is None:
        labels, num = cc_label(mask, connectivity)
        if num == 0:
            return np.zeros_like(mask, bool)
        sizes = np.bincount(labels.ravel())[1:]
        return labels == (int(np.argmax(sizes)) + 1)
    m = _as_u8(mask)
    out = np.empty((h, w), np.uint8)
    lib.largest_component(m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          h, w, connectivity,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)


def label_bboxes(labels: np.ndarray, num_labels: int) -> np.ndarray:
    """(num_labels, 4) int32 [xmin, ymin, xmax, ymax] (exclusive max) per label."""
    lib = _build_lib()
    h, w = labels.shape
    if lib is None:
        boxes = np.zeros((num_labels, 4), np.int32)
        for c in range(1, num_labels + 1):
            ys, xs = np.where(labels == c)
            if len(ys):
                boxes[c - 1] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
        return boxes
    lab = np.ascontiguousarray(labels.astype(np.int32))
    boxes = np.empty((num_labels, 4), np.int32)
    lib.label_bboxes(lab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                     h, w, num_labels,
                     boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return boxes
