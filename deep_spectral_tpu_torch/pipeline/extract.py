"""Stages 1 and 2 of the deep-spectral pipeline on PyTorch.

The port of `deep_spectral_tpu.pipeline.extract.extract_features` and
`extract_eigs`: same flags (plus `device`), same on-disk layout (per-image
`<id>.pth` dicts with the reference's schema), same shape-bucketed batching.
Stages are resumable: an image whose output file exists is skipped.

Flags whose paths are not ported yet raise NotImplementedError:
`image_color_lambda > 0` (color-fused affinities), `which_matrix` other than
'laplacian', `image_downsample_factor` other than the patch size, and
`cheb_filter_impl` other than 'auto' (the filter is the CUDA kernel on the
GPU and its plain twin on the CPU).
"""
from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..models.convert import load_model
from ..models.vit import extract_patch_keys, get_model_config
from ..ops.eigen import (resolve_eig_chunk, spectral_decompose_batched,
                         validate_cheb_window_init)
from ..utils import bucketing
from ..utils.device import resolve_device
from ..utils.image_io import (IMAGENET_SCALE, IMAGENET_SHIFT, load_image_rgb,
                              read_image_list)
from ..utils.serialization import load_pth, load_pth_meta, save_pth
from ..utils.sizes import get_image_sizes


def make_output_dir(output_dir, check_if_empty: bool = True) -> None:
    """mkdir -p; if non-empty, confirm interactively when attached to a TTY
    (reference: extract/extract_utils.py:98-104)."""
    out = Path(output_dir)
    out.mkdir(exist_ok=True, parents=True)
    if check_if_empty and any(out.iterdir()) and sys.stdin.isatty():
        if input("Output dir already contains files. Continue? (y/n) >> ") != "y":
            sys.exit()


class _AsyncWriter:
    """Overlap host-side serialization with device compute."""

    def __init__(self, workers: int = 8):
        self._pool = ThreadPoolExecutor(workers)
        self._futures = []

    def submit(self, fn, *args):
        self._futures.append(self._pool.submit(fn, *args))

    def close(self):
        for f in self._futures:
            f.result()
        self._pool.shutdown()


# ----------------------------------------------------------- stage 1: features

def extract_features(
    images_list: str,
    images_root: Optional[str],
    model_name: str,
    batch_size: int,
    output_dir: str,
    which_block: int = -1,
    ckpt_dir: Optional[str] = None,
    bucket_granularity: int = 8,
    precision: str = "bf16",
    device: str = "cuda",
):
    """Dense ViT patch-key features for every image in the list
    (reference: extract/extract.py:21-116), batched per shape bucket; the
    saved per-image dict is schema-identical to the reference's."""
    make_output_dir(output_dir)
    dev = resolve_device(device, "extract_features")
    model_name = model_name.lower()
    cfg = get_model_config(model_name)
    model = load_model(model_name, ckpt_dir, precision=precision, device=dev)
    P = cfg.patch_size

    paths = read_image_list(images_list, images_root)
    rels = [p.name if images_root is not None else str(p) for p in paths]
    # Images go to the device as uint8 and are normalized there.
    scale = torch.from_numpy(IMAGENET_SCALE).to(dev)
    shift = torch.from_numpy(IMAGENET_SHIFT).to(dev)

    from PIL import Image

    def size_of(item):
        _, path = item
        with Image.open(str(path)) as im:
            w, h = im.size
        return (h // P, w // P)

    writer = _AsyncWriter()
    items = [x for x in enumerate(paths)
             if not (Path(output_dir) / f"{Path(rels[x[0]]).stem}.pth").is_file()]
    done = [0]

    def prepare(bucket: bucketing.Bucket, batch_items):
        """Host side: decode, floor-crop to patch multiples, pad (uint8)."""
        imgs, metas = [], []
        for idx, path in batch_items:
            rgb = load_image_rgb(path)
            H, W = rgb.shape[:2]
            imgs.append(rgb[:(H // P) * P, :(W // P) * P])
            metas.append((idx, rels[idx], (1, 3, H, W)))
        padded, extents = bucketing.pad_batch_images(
            imgs, (bucket.h * P, bucket.w * P), batch_size)
        masks = bucketing.token_masks(extents, bucket, P)
        return padded, masks, extents, metas

    def consume(bucket: bucketing.Bucket, batch_items, prepared):
        padded, masks, extents, metas = prepared
        images = torch.from_numpy(padded).to(dev).float() * scale - shift
        k = extract_patch_keys(model, images, which_block=which_block,
                               token_mask=torch.from_numpy(masks).to(dev))
        k = k.to(torch.float16).cpu().numpy()
        for i, (idx, rel, shape) in enumerate(metas):
            hp, wp = extents[i, 0] // P, extents[i, 1] // P
            ki = k[i].reshape(bucket.h, bucket.w, -1)[:hp, :wp].reshape(1, hp * wp, -1)
            out = {
                "k": ki,
                "indices": np.asarray([idx]),
                "file": rel,
                "id": Path(rel).stem,
                "model_name": model_name,
                "patch_size": P,
                "shape": shape,
            }
            writer.submit(save_pth, out, Path(output_dir) / f"{out['id']}.pth")
        done[0] += len(metas)

    bucketing.run_bucketed_prefetched(
        items, size_of, prepare, consume, batch_size=batch_size,
        granularity=bucket_granularity)
    writer.close()
    print(f"Saved {done[0]} features to {output_dir}")


# --------------------------------------------------------------- stage 2: eigs

def extract_eigs(
    images_root: str,
    features_dir: str,
    output_dir: str,
    which_matrix: str = "laplacian",
    which_color_matrix: str = "knn",
    which_features: str = "k",
    normalize: bool = True,
    threshold_at_zero: bool = True,
    lapnorm: bool = True,
    K: int = 20,
    image_downsample_factor: Optional[int] = None,
    image_color_lambda: float = 0.0,
    multiprocessing: int = 0,  # accepted for CLI parity; batching replaces it
    batch_size: int = 8,
    bucket_granularity: int = 4,
    solver: str = "auto",  # 'eigh' (exact) | 'chebyshev' | 'auto'
    cheb_filter_impl: str = "auto",
    cheb_window_init: str = "auto",  # auto|wide|wide@<lam_cut>|estimate
    eig_chunk: str = "auto",  # sub-batch the solve: auto|none|<int>
    device: str = "cuda",
):
    """Laplacian eigendecomposition per image (reference:
    extract/extract.py:119-280), batched on the device. Images whose
    chebyshev residual exceeds CHEB_RESIDUAL_TOL (or whose result is not
    finite) are re-solved with dense eigh by the solver's guard."""
    del multiprocessing, which_color_matrix, images_root
    if which_matrix != "laplacian":
        raise NotImplementedError(
            f"which_matrix={which_matrix!r} is not ported yet (laplacian only)")
    if image_color_lambda > 0:
        raise NotImplementedError("image_color_lambda > 0 (color-fused "
                                  "affinities) is not ported yet")
    if cheb_filter_impl != "auto":
        raise NotImplementedError(
            f"cheb_filter_impl={cheb_filter_impl!r}: the port has one filter "
            f"(the CUDA kernel on the GPU, its plain twin on the CPU)")
    validate_cheb_window_init(cheb_window_init)
    if isinstance(eig_chunk, str):
        if eig_chunk.lower() in ("none", "", "0"):
            eig_chunk = None
        elif eig_chunk != "auto":
            eig_chunk = int(eig_chunk)
    chunk = resolve_eig_chunk(eig_chunk, batch_size)
    if chunk and batch_size % chunk != 0:
        raise ValueError(
            f"--eig_chunk {chunk} must divide --batch_size {batch_size}")
    dev = resolve_device(device, "extract_eigs")
    make_output_dir(output_dir)

    pending = []
    for f in sorted(Path(features_dir).iterdir()):
        d = load_pth_meta(f)
        image_id = Path(d["file"]).stem
        out_file = Path(output_dir) / f"{image_id}.pth"
        if out_file.is_file():
            continue
        s = get_image_sizes(d)
        if image_downsample_factor not in (None, s.P):
            raise NotImplementedError(
                f"image_downsample_factor={image_downsample_factor} (feature "
                f"upsampling) is not ported yet")
        pending.append((f, image_id, out_file, (s.H_patch, s.W_patch)))

    writer = _AsyncWriter()

    def prepare(bucket: bucketing.Bucket, batch_items):
        """Host side: reload feature dicts and pad them to the bucket grid."""
        feats = None
        extents = np.zeros((batch_size, 2), np.int32)
        metas = []
        for i, (fpath, image_id, out_file, (h, w)) in enumerate(batch_items):
            d = load_pth(fpath)
            D = d[which_features].shape[-1]
            if feats is None:
                feats = np.zeros((batch_size, bucket.tokens, D), np.float16)
            grid = np.zeros((bucket.h, bucket.w, D), np.float16)
            grid[:h, :w] = np.asarray(d[which_features]).reshape(h, w, D)
            feats[i] = grid.reshape(-1, D)
            extents[i] = (h, w)
            metas.append((image_id, out_file, h, w))
        masks = bucketing.grid_masks(extents, (bucket.h, bucket.w))
        return feats, masks, metas

    def consume(bucket: bucketing.Bucket, batch_items, prepared):
        feats_np, masks_np, metas = prepared
        evals, evecs = spectral_decompose_batched(
            torch.from_numpy(feats_np).to(dev).float(),
            torch.from_numpy(masks_np).to(dev), K=K, which_matrix=which_matrix,
            normalize=normalize, threshold_at_zero=threshold_at_zero,
            lapnorm=lapnorm, solver=solver, cheb_window_init=cheb_window_init,
            eig_chunk=chunk)
        evals, evecs = evals.cpu().numpy(), evecs.cpu().numpy()
        for i, (image_id, out_file, h, w) in enumerate(metas):
            vec = evecs[i].reshape(K, bucket.h, bucket.w)[:, :h, :w]
            out = {
                "eigenvalues": evals[i].astype(np.float32),
                "eigenvectors": vec.reshape(K, h * w).astype(np.float32),
            }
            writer.submit(save_pth, out, out_file)

    def coarse_grid(it):
        # Coarser buckets for big graphs: padding costs O(N^2 m) solve work,
        # while each distinct bucket shape is its own batch.
        h, w = it[3]
        g = bucket_granularity if h * w <= 2048 else max(bucket_granularity, 16)
        b = bucketing.bucket_for(h, w, g)
        return (b.h, b.w)

    bucketing.run_bucketed_prefetched(
        pending, coarse_grid, prepare, consume,
        batch_size=batch_size, granularity=1)
    writer.close()
    print(f"Saved eigs to {output_dir}")
