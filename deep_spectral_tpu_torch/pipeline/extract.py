"""Stages 1 and 2 of the deep-spectral pipeline on PyTorch.

The port of `deep_spectral_tpu.pipeline.extract.extract_features` and
`extract_eigs`: same flags (plus `device`), same on-disk layout (per-image
`<id>.pth` dicts with the reference's schema), same shape-bucketed batching.
Stages are resumable: an image whose output file exists is skipped.

Both stages keep one batch in flight, as the JAX stages do: a batch's
results are copied to pinned host memory without blocking, and fetched (and
written) only after the next batch has been sent to the device.
`DSS_TPU_INFLIGHT` sets the depth (0 fetches every batch at once), read as
the JAX package reads it.

Every stage-2 flag of the JAX stage runs: the color-fused graph
(`image_color_lambda > 0`, `which_color_matrix` 'knn' or 'rw'), every
`which_matrix`, feature upsampling (`image_downsample_factor`) and every
solver. `cheb_filter_impl` other than 'auto' raises NotImplementedError: the
port has one filter (the CUDA kernel on the GPU, its plain twin on the CPU).
"""
from __future__ import annotations

import os
import sys
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..models.convert import load_model
from ..models.vit import extract_patch_keys, get_model_config
from ..ops.affinity import knn_affinity, rw_affinity
from ..ops.eigen import (resolve_eig_chunk, spectral_decompose_batched,
                         validate_cheb_window_init)
from ..ops.resize import resize_bilinear
from ..utils import bucketing
from ..utils.device import resolve_device
from ..utils.image_io import (IMAGENET_SCALE, IMAGENET_SHIFT, load_image_resized,
                              load_image_rgb, read_image_list)
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


def _inflight_depth(default: int = 1) -> int:
    """How many dispatched but unfetched batches stages 1-2 keep: the JAX
    package's `DSS_TPU_INFLIGHT` (0 fetches each batch at once)."""
    return max(0, int(os.environ.get("DSS_TPU_INFLIGHT", default)))


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array to `dev`; to CUDA from pinned memory, without blocking."""
    t = torch.from_numpy(a)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


class _Fetch:
    """Copies of device tensors to the host, started now and waited for in
    `result()`: into pinned buffers with non-blocking copies behind an event
    on CUDA, plain copies on the CPU."""

    def __init__(self, *tensors: torch.Tensor):
        self._event = None
        if tensors[0].is_cuda:
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                          for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = [t.clone() for t in tensors]

    def result(self) -> list:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


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

    # One batch in flight: its features are fetched after the next batch
    # has been sent, so the download overlaps the next upload and forward.
    inflight: deque = deque()
    depth = _inflight_depth()

    def flush_one():
        fetch, bucket, extents, metas = inflight.popleft()
        k = fetch.result()[0]  # fp16
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

    def consume(bucket: bucketing.Bucket, batch_items, prepared):
        padded, masks, extents, metas = prepared
        images = _to_device(padded, dev).float() * scale - shift
        k = extract_patch_keys(model, images, which_block=which_block,
                               token_mask=_to_device(masks, dev))
        inflight.append((_Fetch(k.to(torch.float16)), bucket, extents, metas))
        while len(inflight) > depth:
            flush_one()

    bucketing.run_bucketed_prefetched(
        items, size_of, prepare, consume, batch_size=batch_size,
        granularity=bucket_granularity)
    while inflight:
        flush_one()
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
    solver: str = "auto",  # 'eigh' (exact) | 'chebyshev' | 'lobpcg' | 'auto'
    cheb_filter_impl: str = "auto",
    cheb_window_init: str = "auto",  # auto|wide|wide@<lam_cut>|estimate
    eig_chunk: str = "auto",  # sub-batch the solve: auto|none|<int>
    device: str = "cuda",
):
    """Laplacian/affinity eigendecomposition per image (reference:
    extract/extract.py:119-280), batched on the device. The images of a
    batch whose iterative solve did not converge (a chebyshev residual above
    CHEB_RESIDUAL_TOL, or a non-finite result) are re-solved together with
    dense eigh by the solver's guard, before the batch is fetched."""
    del multiprocessing
    if cheb_filter_impl != "auto":
        raise NotImplementedError(
            f"cheb_filter_impl={cheb_filter_impl!r}: the port has one filter "
            f"(the CUDA kernel on the GPU, its plain twin on the CPU)")
    if which_color_matrix not in ("knn", "rw"):
        raise ValueError(f"which_color_matrix must be 'knn' or 'rw'; "
                         f"got {which_color_matrix!r}")
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
    color_affinity = knn_affinity if which_color_matrix == "knn" else rw_affinity
    solve_kw = dict(K=K, which_matrix=which_matrix, normalize=normalize,
                    threshold_at_zero=threshold_at_zero, lapnorm=lapnorm,
                    image_color_lambda=image_color_lambda)

    def lr_grid_of(s):
        f = s.P if image_downsample_factor is None else image_downsample_factor
        return s.H_pad // f, s.W_pad // f

    pending = []
    for f in sorted(Path(features_dir).iterdir()):
        d = load_pth_meta(f)
        image_id = Path(d["file"]).stem
        out_file = Path(output_dir) / f"{image_id}.pth"
        if out_file.is_file():
            continue
        pending.append((f, image_id, out_file, lr_grid_of(get_image_sizes(d))))

    writer = _AsyncWriter()

    def prepare(bucket: bucketing.Bucket, batch_items):
        """Host side: reload feature dicts (padded to the bucket grid when
        they are on the low-res grid already; else kept whole, to be
        upsampled on the device) and the color images at the low-res grid."""
        feats, native = None, {}
        imgs = (np.zeros((batch_size, bucket.h, bucket.w, 3), np.float32)
                if image_color_lambda > 0 else None)
        extents = np.zeros((batch_size, 2), np.int32)
        metas = []
        for i, (fpath, image_id, out_file, (h_lr, w_lr)) in enumerate(batch_items):
            d = load_pth(fpath)
            s = get_image_sizes(d)
            D = d[which_features].shape[-1]
            if feats is None:
                feats = np.zeros((batch_size, bucket.h, bucket.w, D), np.float16)
            fi = np.asarray(d[which_features]).reshape(s.H_patch, s.W_patch, D)
            if (s.H_patch, s.W_patch) == (h_lr, w_lr):
                feats[i, :h_lr, :w_lr] = fi
            else:
                native[i] = fi
            extents[i] = (h_lr, w_lr)
            if imgs is not None:
                imgs[i, :h_lr, :w_lr] = load_image_resized(
                    Path(images_root) / d["file"], (w_lr, h_lr))
            metas.append((image_id, out_file, h_lr, w_lr))
        masks = bucketing.grid_masks(extents, (bucket.h, bucket.w))
        return feats, native, imgs, masks, extents, metas

    # One solve in flight: a batch's results are fetched after the next
    # batch has been sent.
    inflight: deque = deque()
    depth = _inflight_depth()

    def consume(bucket: bucketing.Bucket, batch_items, prepared):
        feats_np, native, imgs, masks_np, extents, metas = prepared
        feats = _to_device(feats_np, dev)
        for i, fi in native.items():
            # bilinear upsample to the low-res grid (reference:
            # extract/extract.py:184-188), stored fp16 as the JAX stage does
            h_lr, w_lr = extents[i]
            up = resize_bilinear(_to_device(fi, dev), (int(h_lr), int(w_lr)))
            feats[i, :h_lr, :w_lr] = up.to(torch.float16)
        feats = feats.reshape(batch_size, bucket.tokens, -1).float()
        masks = _to_device(masks_np, dev)
        color_W = (None if imgs is None
                   else color_affinity(_to_device(imgs, dev), mask=masks))
        # the solver's guard re-solves, on the device, each image whose
        # iterative solve did not converge (the reference's ARPACK retry,
        # extract/extract.py:227-234)
        evals, evecs = spectral_decompose_batched(
            feats, masks, color_W, solver=solver, cheb_window_init=cheb_window_init,
            eig_chunk=chunk, **solve_kw)
        inflight.append((_Fetch(evals, evecs), metas, bucket))
        while len(inflight) > depth:
            flush_one()

    def flush_one():
        fetch, metas, bucket = inflight.popleft()
        evals, evecs = fetch.result()
        for i, (image_id, out_file, h_lr, w_lr) in enumerate(metas):
            vec = evecs[i].reshape(K, bucket.h, bucket.w)[:, :h_lr, :w_lr]
            out = {
                "eigenvalues": evals[i].astype(np.float32),
                "eigenvectors": vec.reshape(K, h_lr * w_lr).astype(np.float32),
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
    while inflight:
        flush_one()
    writer.close()
    print(f"Saved eigs to {output_dir}")
