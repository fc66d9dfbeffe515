"""The ten stages of the deep-spectral pipeline on PyTorch.

The port of `deep_spectral_tpu.pipeline.extract`: same
function names and flags (plus `device` for the stages that use the card),
same on-disk layout (per-image `<id>.pth` dicts and `.png` segmaps with the
reference's schema, and the bbox stages' `.pth` lists), same shape-bucketed
batching. Per-image stages are resumable: an image whose output file exists
is skipped.

  1. `extract_features`: ViT patch keys (kernel 1 in every attending block);
  2. `extract_eigs`: Laplacian eigenvectors (kernel 2 in the Chebyshev solve);
  3. `extract_multi_region_segmentations`: k-means over eigenvectors, one
     batched k-means per batch on the device, then the background swap;
  4. `extract_single_region_segmentations`: the 0/255 Fiedler mask (host);
  5. `extract_bboxes`: per-segment boxes after erode/dilate (host numpy);
  6. `extract_bbox_features`: the ViT's CLS of every box crop, crops in
     square power-of-two buckets (kernel 1 in every block);
  7. `extract_bbox_clusters`: dataset-wide k-means (optionally after PCA)
     of the L2-normalized box features, on the device;
  8. `extract_semantic_segmentations`: segments mapped to their box's
     cluster (host);
  9. `extract_crf_segmentations`: dense-CRF mean field (`ops/crf.py`) of
     the upsampled segmaps at full image resolution, images of one 64-pixel
     bucket batched on the device;
 10. `vis_segmentations`: a static PNG/HTML gallery (matplotlib), and
     `vis_server`, the interactive viewer (`pipeline/vis_server.py`).

Stages 1, 2 and 9 shard their images across the processes of a
`torch.distributed` group (`shard_across_processes`), as the JAX stages
shard them across JAX processes.

Stages 1-3, 6 and 9 keep one batch in flight, as the JAX stages 1-2 do: a
batch's results are copied to pinned host memory without blocking, and
fetched (and written) only after the next batch has been sent to the
device. `DSS_TPU_INFLIGHT` sets the depth (0 fetches every batch at once),
read as the JAX package reads it. Images go to the device as uint8 and are
ImageNet-normalized there (stages 1 and 6) or cast to f32 there (stage 9).

Every stage-2 flag of the JAX stage runs: the color-fused graph
(`image_color_lambda > 0`, `which_color_matrix` 'knn' or 'rw'), every
`which_matrix`, feature upsampling (`image_downsample_factor`), every
solver and every `cheb_filter_impl`: 'auto' and 'pallas' are the filter
kernel (the CUDA kernel on the GPU, its plain twin on the CPU), 'xla' the
JAX package's chain of batched products (`ops.eigen.resolved_cheb_impl`).
A kernel that fails raises: the JAX stage's pallas -> xla downgrade on a
build failure is not ported.

k-means draws its seeding from a `torch.Generator`, not `jax.random`: stage
3 seeds each image's generator with `seed + index` (its position among the
paired input files), as JAX keys each image with `PRNGKey(seed + index)`,
so an image's segmap does not depend on its batch; stage 7 seeds one
generator with `seed`. Partitions match the JAX stages' where k-means has
one clear optimum; the draws themselves differ.
"""
from __future__ import annotations

import os
import sys
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..models.convert import load_model
from ..models.relpos import sam_preprocess, sam_resized_size
from ..models.vit import extract_patch_keys, get_model_config
from ..ops.affinity import knn_affinity, rw_affinity
from ..ops.crf import dense_crf
from ..ops.eigen import (resolve_eig_chunk, resolved_cheb_impl,
                         spectral_decompose_batched, validate_cheb_window_init)
from ..ops.kmeans import kmeans, pca
from ..ops.morphology import erode_or_dilate_mask, infer_background_swap, mask_bbox
from ..ops.resize import resize_bilinear, resize_nearest
from ..parallel import distributed
from ..utils import bucketing
from ..utils.device import resolve_device
from ..utils.image_io import (IMAGENET_SCALE, IMAGENET_SHIFT, load_image_resized,
                              load_image_rgb, read_image_list)
from ..utils.profiling import span
from ..utils.serialization import (load_pth, load_pth_meta, load_segmap_png, save_pth,
                                   save_segmap_png)
from ..utils.sizes import get_image_sizes
from .vis_server import vis_server  # noqa: F401  (a stage of the CLI)


def make_output_dir(output_dir, check_if_empty: bool = True) -> None:
    """mkdir -p; if non-empty, confirm interactively when attached to a TTY
    (reference: extract/extract_utils.py:98-104)."""
    out = Path(output_dir)
    out.mkdir(exist_ok=True, parents=True)
    if check_if_empty and any(out.iterdir()) and sys.stdin.isatty():
        if input("Output dir already contains files. Continue? (y/n) >> ") != "y":
            sys.exit()


def _resolve_image_file(images_root, image_id: str) -> Path:
    """The image file of an id without extension (the bbox dicts carry only
    the id, extract/extract.py:529-532): any extension, as the JAX stage
    accepts."""
    root = Path(images_root)
    for ext in (".jpg", ".jpeg", ".png", ".JPEG", ".JPG", ".PNG", ".bmp", ".webp"):
        p = root / f"{image_id}{ext}"
        if p.is_file():
            return p
    matches = sorted(root.glob(f"{image_id}.*"))
    if matches:
        return matches[0]
    raise FileNotFoundError(f"no image named '{image_id}.*' under {root}")


def get_paired_input_files(path1, path2) -> list:
    """[(index, (file1, file2)), ...] of two sorted directories (or file
    lists) of equal length."""
    def files(p):
        p = Path(p)
        if p.is_dir():
            return sorted(p.iterdir())
        if p.is_file():
            return p.read_text().splitlines()
        raise ValueError(str(p))
    f1, f2 = files(path1), files(path2)
    if len(f1) != len(f2):
        raise ValueError(f"{len(f1)} vs {len(f2)} paired files")
    return list(enumerate(zip(f1, f2)))


def shard_across_processes(items):
    """Round-robin shard a per-image work list across the processes of the
    `torch.distributed` group: rank r of n takes items[r::n], so each
    process computes and writes a disjoint subset (the outputs are
    independent per-image files, so no synchronization is needed; the
    reference's accelerate multi-process extraction, extract/extract.py:
    113-114). One process, or no group: every item."""
    n = distributed.process_count()
    if n == 1:
        return items
    return items[distributed.process_index()::n]


def _progress(it, desc):
    try:
        from tqdm import tqdm
        return tqdm(it, desc=desc)
    except ImportError:
        return it


def _inflight_depth(default: int = 1) -> int:
    """How many dispatched but unfetched batches stages 1-3 and 6 keep: the JAX
    package's `DSS_TPU_INFLIGHT` (0 fetches each batch at once)."""
    return max(0, int(os.environ.get("DSS_TPU_INFLIGHT", default)))


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array to `dev`; to CUDA from pinned memory, without blocking (a
    `stage.upload` span)."""
    t = torch.from_numpy(a)
    if dev.type != "cuda":
        return t
    with span("stage.upload"):
        return t.pin_memory().to(dev, non_blocking=True)


class _Fetch:
    """Copies of device tensors to the host, started now and waited for in
    `result()`: into pinned buffers with non-blocking copies behind an event
    on CUDA (a `stage.fetch` span; the wait, `stage.wait`), plain copies on
    the CPU."""

    def __init__(self, *tensors: torch.Tensor):
        self._event = None
        if tensors[0].is_cuda:
            with span("stage.fetch"):
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
            with span("stage.wait"):
                self._event.synchronize()
        return [h.numpy() for h in self._host]


class _InFlight:
    """Dispatched but unfetched batches, oldest first: `push` queues a
    batch's `_Fetch` with the host work to do on its arrays, and runs the
    oldest batch's work (a `stage.callback` span) while more than
    `_inflight_depth()` batches wait; `drain` runs the rest. A batch's
    download so overlaps the next batch's upload and compute."""

    def __init__(self):
        self._queue: deque = deque()
        self._depth = _inflight_depth()

    def push(self, fetch: _Fetch, on_result) -> None:
        self._queue.append((fetch, on_result))
        while len(self._queue) > self._depth:
            self._pop()

    def _pop(self) -> None:
        fetch, on_result = self._queue.popleft()
        arrays = fetch.result()
        with span("stage.callback"):
            on_result(*arrays)

    def drain(self) -> None:
        while self._queue:
            self._pop()


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

class _PatchInput:
    """Stage 1's input for the DINO families: each image floor-cropped to
    whole patches and padded into its shape bucket as uint8, normalized on
    the card and run under the bucket's token mask with each image's grid;
    an image's features are its own grid of the bucket's, its shape the
    decoded image's."""

    def __init__(self, cfg, dev: torch.device, batch_size: int):
        self.P, self.dev, self.batch_size = cfg.patch_size, dev, batch_size
        self.scale = torch.from_numpy(IMAGENET_SCALE).to(dev)
        self.shift = torch.from_numpy(IMAGENET_SHIFT).to(dev)

    def bucket_of(self, path) -> tuple[int, int]:
        from PIL import Image
        with Image.open(str(path)) as im:
            w, h = im.size
        return h // self.P, w // self.P

    def grid(self, bucket: bucketing.Bucket) -> tuple[int, int]:
        return bucket.h, bucket.w

    def prepare(self, bucket: bucketing.Bucket, rgbs: list):
        """Host side: (padded uint8, token masks, each image's pixel extent
        in the bucket, shapes)."""
        P = self.P
        crops = [rgb[:(rgb.shape[0] // P) * P, :(rgb.shape[1] // P) * P] for rgb in rgbs]
        padded, extents = bucketing.pad_batch_images(
            crops, (bucket.h * P, bucket.w * P), self.batch_size)
        masks = bucketing.token_masks(extents, bucket, P)
        return padded, masks, extents, [(1, 3, *rgb.shape[:2]) for rgb in rgbs]

    def keys(self, model, padded: np.ndarray, masks: np.ndarray, extents: np.ndarray,
             which_block: int) -> torch.Tensor:
        images = _to_device(padded, self.dev).float() * self.scale - self.shift
        return extract_patch_keys(model, images, which_block=which_block,
                                  token_mask=_to_device(masks, self.dev), grids=extents // self.P)


class _SamInput:
    """Stage 1's input for SAM (`models/relpos.py`): each image uploaded as
    it is (uint8, padded to the batch's largest), resized on the card so
    that its longer side is img_size, normalized, zero-padded to img_size x
    img_size and run with no mask, every image one (g, g) bucket; an
    image's features are its resized size's patch grid, floor(h' / P) x
    floor(w' / P) from the top left, and its shape (1, 3, h', w'), the
    resized size, so stage 2 and the later stages read that grid."""

    def __init__(self, cfg, dev: torch.device, batch_size: int):
        self.cfg, self.dev, self.batch_size = cfg, dev, batch_size

    def bucket_of(self, path) -> tuple[int, int]:
        return self.cfg.pos_grid, self.cfg.pos_grid

    def grid(self, bucket: bucketing.Bucket) -> tuple[int, int]:
        return self.cfg.pos_grid, self.cfg.pos_grid

    def prepare(self, bucket: bucketing.Bucket, rgbs: list):
        """Host side: (padded uint8, the uploaded images' sizes, their
        resized sizes, shapes)."""
        hw = np.array([rgb.shape[:2] for rgb in rgbs])
        padded, sizes = bucketing.pad_batch_images(rgbs, tuple(hw.max(axis=0)), self.batch_size)
        resized = [sam_resized_size(h, w, self.cfg.img_size) for h, w in hw]
        extents = np.zeros_like(sizes)
        extents[:len(rgbs)] = resized
        return padded, sizes, extents, [(1, 3, *r) for r in resized]

    def keys(self, model, padded: np.ndarray, sizes: np.ndarray, extents: np.ndarray,
             which_block: int) -> torch.Tensor:
        images = sam_preprocess(_to_device(padded, self.dev), sizes, self.cfg.img_size)
        return extract_patch_keys(model, images, which_block=which_block)


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
    saved per-image dict is schema-identical to the reference's. A SAM
    model takes SAM's own input instead (`_SamInput`)."""
    make_output_dir(output_dir)
    dev = resolve_device(device, "extract_features")
    model_name = model_name.lower()
    cfg = get_model_config(model_name)
    model = load_model(model_name, ckpt_dir, precision=precision, device=dev)
    P = cfg.patch_size
    # Images go to the device as uint8 and are normalized there.
    inputs = (_SamInput if cfg.family == "sam" else _PatchInput)(cfg, dev, batch_size)

    paths = read_image_list(images_list, images_root)
    rels = [p.name if images_root is not None else str(p) for p in paths]

    def size_of(item):
        return inputs.bucket_of(item[1])

    writer = _AsyncWriter()
    items = [x for x in enumerate(paths)
             if not (Path(output_dir) / f"{Path(rels[x[0]]).stem}.pth").is_file()]
    items = shard_across_processes(items)
    done = [0]

    def prepare(bucket: bucketing.Bucket, batch_items):
        """Host side: decode, then the family's `prepare`."""
        padded, extra, extents, shapes = inputs.prepare(
            bucket, [load_image_rgb(path) for _, path in batch_items])
        metas = [(idx, rels[idx], shape) for (idx, _), shape in zip(batch_items, shapes)]
        return padded, extra, extents, metas

    # One batch in flight: its features are fetched after the next batch
    # has been sent, so the download overlaps the next upload and forward.
    inflight = _InFlight()

    def save(grid, extents, metas, k):  # k: fp16
        for i, (idx, rel, shape) in enumerate(metas):
            hp, wp = extents[i, 0] // P, extents[i, 1] // P
            ki = k[i].reshape(*grid, -1)[:hp, :wp].reshape(1, hp * wp, -1)
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
        padded, extra, extents, metas = prepared
        k = inputs.keys(model, padded, extra, extents, which_block)
        inflight.push(_Fetch(k.to(torch.float16)),
                      partial(save, inputs.grid(bucket), extents, metas))

    bucketing.run_bucketed_prefetched(
        items, size_of, prepare, consume, batch_size=batch_size,
        granularity=bucket_granularity)
    inflight.drain()
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
    cheb_filter_impl: str = "auto",  # 'xla' | 'pallas' | 'auto' (the kernel)
    cheb_window_init: str = "auto",  # auto|wide|wide@<lam_cut>|estimate
    eig_chunk: str = "auto",  # sub-batch the solve: auto|none|<int>
    device: str = "cuda",
):
    """Laplacian/affinity eigendecomposition per image (reference:
    extract/extract.py:119-280), batched on the device. The images of a
    batch whose iterative solve did not converge (a chebyshev residual above
    CHEB_RESIDUAL_TOL, or a non-finite result) are re-solved together with
    dense eigh by the solver's guard, before the batch is fetched. The
    chebyshev filter that the request resolves to is printed once a run."""
    del multiprocessing
    # fails fast on a bad request; the port's resolution reads no shape
    print(f"eigs: chebyshev filter {resolved_cheb_impl(0, cheb_filter_impl)!r} "
          f"(cheb_filter_impl={cheb_filter_impl!r})")
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
    pending = shard_across_processes(pending)

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
    inflight = _InFlight()
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
            feats, masks, color_W, solver=solver, cheb_filter_impl=cheb_filter_impl,
            cheb_window_init=cheb_window_init, eig_chunk=chunk, **solve_kw)
        inflight.push(_Fetch(evals, evecs), partial(save, metas, bucket))

    def save(metas, bucket, evals, evecs):
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
    inflight.drain()
    writer.close()
    print(f"Saved eigs to {output_dir}")


# ------------------------------------------- stages 3/4: region segmentations

def _load_feature_eig_pair(feature_path, eigs_path) -> dict:
    d = load_pth(feature_path)
    d.update(load_pth(eigs_path))
    return d


def extract_multi_region_segmentations(
    features_dir: str,
    eigs_dir: str,
    output_dir: str,
    adaptive: bool = False,
    non_adaptive_num_segments: int = 4,
    infer_bg_index: bool = True,
    kmeans_baseline: bool = False,
    num_eigenvectors: int = 1_000_000,
    multiprocessing: int = 0,  # accepted for CLI parity; batching replaces it
    seed: int = 0,
    batch_size: int = 16,
    bucket_granularity: int = 4,
    device: str = "cuda",
):
    """k-means over eigenvectors -> multi-region segmaps
    (reference: extract/extract.py:283-377), batched: images grouped by
    n_clusters and grid bucket, each batch clustered by one batched k-means
    (10 restarts per image) on the device, then the background swap there."""
    del multiprocessing
    dev = resolve_device(device, "extract_multi_region_segmentations")
    make_output_dir(output_dir)
    inputs = get_paired_input_files(features_dir, eigs_dir)

    # Host pass: per-image n_clusters (the adaptive eigengap,
    # extract/extract.py:311-315) and segmap grid, grouped by n_clusters.
    groups = defaultdict(list)
    for index, (feature_path, eigs_path) in inputs:
        d = _load_feature_eig_pair(feature_path, eigs_path)
        out_file = Path(output_dir) / f"{d['id']}.png"
        if out_file.is_file():
            continue
        s = get_image_sizes(d)
        if adaptive:
            gaps = np.diff(np.asarray(d["eigenvalues"]))
            order = np.argsort(gaps)[::-1]
            n_clusters = int(order[order != 0][0]) + 1
        else:
            n_clusters = non_adaptive_num_segments
        if kmeans_baseline:
            X = np.asarray(d["k"], np.float32).reshape(-1, d["k"].shape[-1])
        else:
            X = np.asarray(d["eigenvectors"], np.float32)[1: 1 + num_eigenvectors].T
        n_pts = X.shape[0]
        if n_pts == s.H_patch * s.W_patch:
            grid = (s.H_patch, s.W_patch)
        elif n_pts == s.H_patch * s.W_patch * 4:
            grid = (s.H_patch * 2, s.W_patch * 2)
        else:
            raise ValueError(f"{n_pts=} vs {s}")
        groups[n_clusters].append((index, out_file, X, grid))

    writer = _AsyncWriter()
    inflight = _InFlight()

    def save(bucket, batch_items, labels):
        for i, (_, out_file, _, (h, w)) in enumerate(batch_items):
            segmap = labels[i].reshape(bucket.h, bucket.w)[:h, :w]
            writer.submit(save_segmap_png, segmap.astype(np.uint8), out_file)

    for n_clusters, items in groups.items():
        def prepare(bucket: bucketing.Bucket, batch_items):
            M = batch_items[0][2].shape[1]
            X = np.zeros((len(batch_items), bucket.h, bucket.w, M), np.float32)
            extents = np.zeros((len(batch_items), 2), np.int64)
            for i, (_, _, Xi, (h, w)) in enumerate(batch_items):
                X[i, :h, :w] = Xi.reshape(h, w, M)
                extents[i] = (h, w)
            masks = bucketing.grid_masks(extents, (bucket.h, bucket.w))
            generators = [torch.Generator().manual_seed(seed + it[0]) for it in batch_items]
            return X.reshape(len(batch_items), bucket.tokens, M), masks, extents, generators

        def consume(bucket: bucketing.Bucket, batch_items, prepared, n_clusters=n_clusters):
            X, masks, extents, generators = prepared
            res = kmeans(_to_device(X, dev), n_clusters, generators, n_init=10,
                         max_iter=300, mask=_to_device(masks, dev))
            labels = res.labels.reshape(len(batch_items), bucket.h, bucket.w)
            if infer_bg_index:
                labels = infer_background_swap(labels, n_clusters,
                                               extents=_to_device(extents, dev))
            inflight.push(_Fetch(labels.to(torch.int32)), partial(save, bucket, batch_items))

        bucketing.run_bucketed_prefetched(
            items, lambda it: it[3], prepare, consume,
            batch_size=batch_size, granularity=bucket_granularity)
    inflight.drain()
    writer.close()
    print(f"Saved multi-region segmentations to {output_dir}")


def extract_single_region_segmentations(
    features_dir: str,
    eigs_dir: str,
    output_dir: str,
    threshold: float = 0.0,
    multiprocessing: int = 0,
):
    """Binary mask = Fiedler vector > threshold
    (reference: extract/extract.py:380-426), saved as 0/255 like the
    reference's bool -> PIL path, so that binarizing at 0.5 downstream works."""
    del multiprocessing
    make_output_dir(output_dir)
    inputs = get_paired_input_files(features_dir, eigs_dir)
    for _, (feature_path, eigs_path) in _progress(inputs, "single_region"):
        d = _load_feature_eig_pair(feature_path, eigs_path)
        out_file = Path(output_dir) / f"{d['id']}.png"
        if out_file.is_file():
            continue
        s = get_image_sizes(d)
        vec = np.asarray(d["eigenvectors"])[1]
        segmap = (vec > threshold).reshape(s.H_patch, s.W_patch)
        save_segmap_png(segmap.astype(np.uint8) * 255, out_file)
    print(f"Saved single-region segmentations to {output_dir}")


# ------------------------------------------------------------ stage 5: bboxes

def extract_bboxes(
    features_dir: str,
    segmentations_dir: str,
    output_file: str,
    num_erode: int = 2,
    num_dilate: int = 3,
    skip_bg_index: bool = True,
    downsample_factor: Optional[int] = None,
):
    """Eroded/dilated per-segment bounding boxes
    (reference: extract/extract.py:429-497), on the host: patch grids are
    tiny, so a device round trip per segmap would cost more than the work.
    Each image's segments are eroded, dilated (a step skipped for a segment
    it would empty, extract/extract_utils.py:115-121) and boxed together, as
    one batch of CPU tensors through `ops.morphology`. One `.pth` list of
    per-image dicts."""
    make_output_dir(str(Path(output_file).parent), check_if_empty=False)
    inputs = get_paired_input_files(features_dir, segmentations_dir)
    all_outputs = []
    for _, (feature_path, seg_path) in _progress(inputs, "bboxes"):
        d = load_pth(feature_path)
        segmap = load_segmap_png(seg_path)
        s = get_image_sizes(d, downsample_factor)
        outputs = {"bboxes": [], "bboxes_original_resolution": [],
                   "segment_indices": [], "id": d["id"],
                   "format": "(xmin, ymin, xmax, ymax)"}
        seg_ids = [i for i in sorted(np.unique(segmap).tolist())
                   if not (skip_bg_index and i <= 0)]
        masks = torch.from_numpy(segmap[None] == np.asarray(seg_ids).reshape(-1, 1, 1))
        masks = erode_or_dilate_mask(masks, num_erode, erode=True)
        masks = erode_or_dilate_mask(masks, num_dilate, erode=False)
        for seg_idx, box in zip(seg_ids, mask_bbox(masks).tolist()):
            xmin, ymin, xmax, ymax = box
            outputs["segment_indices"].append(seg_idx)
            outputs["bboxes"].append([xmin, ymin, xmax, ymax])
            outputs["bboxes_original_resolution"].append(
                [xmin * s.P, ymin * s.P, xmax * s.P, ymax * s.P])
        all_outputs.append(outputs)
    save_pth(all_outputs, output_file)
    print(f"Saved bboxes to {output_file}")


# ----------------------------------------------------- stage 6: bbox features

def extract_bbox_features(
    images_root: str,
    bbox_file: str,
    model_name: str,
    output_file: str,
    ckpt_dir: Optional[str] = None,
    batch_size: int = 16,
    precision: str = "bf16",
    device: str = "cuda",
):
    """CLS embedding of each bbox crop (reference: extract/extract.py:500-544),
    batched across all crops: each crop is cut to whole patches (at least
    one), crops go into square power-of-two buckets (largest first) in
    batches of `batch_size` (a short batch padded with empty images, as the
    JAX stage pads), as uint8 to the device, normalized there, and the ViT
    runs with the crops' token masks. Saved as the bbox list with
    `features` (n_boxes, embed_dim) f32 added to each image's dict. A SAM
    model, which has no CLS token, raises."""
    dev = resolve_device(device, "extract_bbox_features")
    model_name = model_name.lower()
    cfg = get_model_config(model_name)
    if cfg.family == "sam":
        raise ValueError(f"extract_bbox_features takes a model's CLS token; {model_name} has none")
    bbox_list = load_pth(bbox_file)
    model = load_model(model_name, ckpt_dir, precision=precision, device=dev)
    P = cfg.patch_size
    scale = torch.from_numpy(IMAGENET_SCALE).to(dev)
    shift = torch.from_numpy(IMAGENET_SHIFT).to(dev)

    crops = []  # (image index, box index, uint8 crop)
    for i, bd in enumerate(_progress(bbox_list, "bbox crops")):
        rgb = load_image_rgb(_resolve_image_file(images_root, bd["id"]))
        for j, (xmin, ymin, xmax, ymax) in enumerate(bd["bboxes_original_resolution"]):
            crop = rgb[ymin:ymax, xmin:xmax]
            hp, wp = max(crop.shape[0] // P, 1), max(crop.shape[1] // P, 1)
            crops.append((i, j, crop[: hp * P, : wp * P]))

    # Square pow2 buckets: crop shapes vary wildly; a few padded shapes
    # instead of one per crop.
    crop_groups = defaultdict(list)
    for c in crops:
        hp, wp = max(c[2].shape[0] // P, 1), max(c[2].shape[1] // P, 1)
        crop_groups[bucketing.square_pow2_bucket(hp, wp)].append(c)

    feats: dict = {}
    inflight = _InFlight()

    def keep(batch_items, cls):
        for b, (i, j, _) in enumerate(batch_items):
            feats[(i, j)] = cls[b]

    for bucket in sorted(crop_groups, key=lambda b: -b.tokens):
        group = crop_groups[bucket]
        for chunk in bucketing.batches(range(len(group)), batch_size):
            batch_items = [group[i] for i in chunk]
            padded, extents = bucketing.pad_batch_images(
                [c[2] for c in batch_items], (bucket.h * P, bucket.w * P), batch_size)
            masks = bucketing.token_masks(extents, bucket, P)
            images = _to_device(padded, dev).float() * scale - shift
            with torch.no_grad():
                cls = model(images, n_intermediates=1, token_mask=_to_device(masks, dev),
                            grids=extents // P)["cls"]
            inflight.push(_Fetch(cls.float()), partial(keep, batch_items))
    inflight.drain()

    for i, bd in enumerate(bbox_list):
        n = len(bd["bboxes"])
        bd["features"] = (np.stack([feats[(i, j)] for j in range(n)]) if n
                          else np.zeros((0, cfg.embed_dim), np.float32))
    save_pth(bbox_list, output_file)
    print(f"Saved features to {output_file}")


# ----------------------------------------------------- stage 7: bbox clusters

def extract_bbox_clusters(
    bbox_features_file: str,
    output_file: str,
    num_clusters: int = 20,
    seed: int = 0,
    pca_dim: Optional[int] = 0,
    device: str = "cuda",
):
    """Dataset-wide clustering of the L2-normalized bbox features
    (reference: extract/extract.py:547-599): optional PCA, then exact
    full-batch k-means (10 restarts, 300 steps; the JAX package's
    replacement for MiniBatchKMeans) on the device."""
    dev = resolve_device(device, "extract_bbox_clusters")
    bbox_list = load_pth(bbox_features_file)
    all_features = np.concatenate([bd["features"] for bd in bbox_list], axis=0)
    all_features = all_features / np.linalg.norm(all_features, axis=-1, keepdims=True)

    X = torch.from_numpy(np.asarray(all_features, np.float32)).to(dev)
    if pca_dim:
        X = pca(X, pca_dim)
    res = kmeans(X, num_clusters, torch.Generator().manual_seed(seed),
                 n_init=10, max_iter=300)
    clusters = res.labels.cpu().numpy().astype(np.int32)

    idx_vals, counts = np.unique(clusters, return_counts=True)
    print(f"Cluster indices: {idx_vals.tolist()}")
    print(f"Cluster counts: {counts.tolist()}")

    idx = 0
    for bd in bbox_list:
        n = len(bd["bboxes"])
        del bd["features"]
        bd["clusters"] = clusters[idx: idx + n]
        idx += n
    save_pth(bbox_list, output_file)
    print(f"Saved clusters to {output_file}")


# ------------------------------------------- stage 8: semantic segmentations

def extract_semantic_segmentations(
    segmentations_dir: str,
    bbox_clusters_file: str,
    output_dir: str,
):
    """Each segment mapped to its bbox's dataset-wide cluster id, background
    kept 0; 0/255 segmaps read as 0/1 (reference: extract/extract.py:602-647)."""
    bbox_list = load_pth(bbox_clusters_file)
    make_output_dir(output_dir)
    for bd in _progress(bbox_list, "semantic segmaps"):
        segmap = load_segmap_png(Path(segmentations_dir) / f"{bd['id']}.png")
        if set(np.unique(segmap).tolist()).issubset({0, 255}):
            segmap = segmap.copy()
            segmap[segmap == 255] = 1
        semantic_map = dict(zip(bd["segment_indices"], np.asarray(bd["clusters"]).tolist()))
        if 0 in semantic_map:
            raise ValueError(f"{bd['id']}: segment 0 has a box: {semantic_map}")
        semantic_map[0] = 0  # background stays zero
        lut = np.zeros(max(semantic_map) + 1, np.uint8)
        for k, v in semantic_map.items():
            lut[k] = v
        save_segmap_png(lut[segmap], Path(output_dir) / f"{bd['id']}.png")
    print(f"Saved semantic segmentations to {output_dir}")


# --------------------------------------------------- stage 9: CRF refinement

CRF_GRAN = 64  # stage 9's pixel bucket granularity


def _upsample_segmap(segmap: np.ndarray, H: int, W: int, P: int) -> np.ndarray:
    """A patch segmap nearest-upsampled (cv2's convention) onto the image's
    patch-multiple region (H//P)*P x (W//P)*P, the border beyond it from the
    (H, W) resize (reference: extract/extract.py:679-681); {0, 255} maps
    read as {0, 1}."""
    seg = torch.from_numpy(segmap.astype(np.int32))
    H_pad, W_pad = (H // P) * P, (W // P) * P
    full = resize_nearest(seg, (H, W)).numpy()
    full[:H_pad, :W_pad] = resize_nearest(seg, (H_pad, W_pad)).numpy()
    if set(np.unique(full).tolist()) == {0, 255}:
        full[full == 255] = 1
    return full


def extract_crf_segmentations(
    images_list: str,
    images_root: str,
    segmentations_dir: str,
    output_dir: str,
    num_classes: int = 21,
    downsample_factor: int = 16,
    multiprocessing: int = 0,  # accepted for CLI parity; batching replaces it
    w1: float = 10.0,
    alpha: float = 80.0,
    beta: float = 13.0,
    w2: float = 3.0,
    gamma: float = 3.0,
    it: float = 5.0,
    batch_size: int = 4,
    gt_prob: float = 0.7,
    device: str = "cuda",
):
    """Dense-CRF sharpening of patch-level segmaps at full image resolution
    (reference: extract/extract.py:650-735), on the device: images are
    grouped by 64-pixel size bucket, edge-replicated into it, sent as uint8
    in batches of `batch_size`, refined by one batched mean field, and
    cropped back. `gt_prob` softens the hard-label unaries
    (unary_from_labels, see ops/crf.py). Images pair with segmaps by
    position (the list's order against the sorted segmentations dir)."""
    del multiprocessing
    dev = resolve_device(device, "extract_crf_segmentations")
    make_output_dir(output_dir)
    params = (w1, alpha, beta, w2, gamma, it)
    writer = _AsyncWriter()

    from PIL import Image
    pending = []
    for _, (image_file, segmap_path) in get_paired_input_files(images_list,
                                                                segmentations_dir):
        out_file = Path(output_dir) / f"{Path(image_file).stem}.png"
        if out_file.is_file():
            continue
        # the listed file name, any extension (the reference re-derives
        # `{id}.jpg`, extract/extract.py:668)
        with Image.open(str(Path(images_root) / image_file)) as im:
            Wd, Hd = im.size
        pending.append((image_file, segmap_path, out_file, (Hd, Wd)))
    pending = shard_across_processes(pending)

    def prepare(bucket: bucketing.Bucket, batch_items):
        """Host side: decode, upsample the segmap, pad both into the bucket
        by edge replication (border neighbourhoods stay natural), uint8."""
        BH, BW = bucket.h * CRF_GRAN, bucket.w * CRF_GRAN
        imgs = np.zeros((len(batch_items), BH, BW, 3), np.uint8)
        segs = np.zeros((len(batch_items), BH, BW), np.uint8)
        metas = []
        for i, (image_file, segmap_path, out_file, (H, W)) in enumerate(batch_items):
            image = load_image_rgb(Path(images_root) / image_file)
            seg = _upsample_segmap(load_segmap_png(segmap_path), H, W, downsample_factor)
            if seg.min() < 0 or seg.max() > 255:
                raise ValueError(f"{segmap_path}: labels outside 0..255")
            imgs[i] = np.pad(image, ((0, BH - H), (0, BW - W), (0, 0)), mode="edge")
            segs[i] = np.pad(seg, ((0, BH - H), (0, BW - W)), mode="edge")
            metas.append((out_file, H, W))
        return imgs, segs, metas

    def save(metas, labels):
        for (out_file, H, W), lab in zip(metas, labels):
            writer.submit(save_segmap_png, lab[:H, :W], out_file)

    # One batch in flight: a batch's labels are fetched after the next batch
    # has been sent.
    inflight = _InFlight()

    def consume(bucket: bucketing.Bucket, batch_items, prepared):
        imgs, segs, metas = prepared
        labels = dense_crf(_to_device(imgs, dev), _to_device(segs, dev),
                           num_classes=num_classes, params=params, gt_prob=gt_prob)
        inflight.push(_Fetch(labels.to(torch.uint8)), partial(save, metas))

    bucketing.run_bucketed_prefetched(
        pending, lambda it: (-(-it[3][0] // CRF_GRAN), -(-it[3][1] // CRF_GRAN)),
        prepare, consume, batch_size=batch_size, granularity=1)
    inflight.drain()
    writer.close()
    print(f"Saved CRF segmentations to {output_dir}")


# ------------------------------------------------- stage 10: visualization


def vis_segmentations(
    images_list: str,
    images_root: str,
    segmentations_dir: str,
    bbox_file: Optional[str] = None,
    output_dir: str = "./vis",
    max_images: int = 40,
):
    """Static HTML/PNG gallery of image / segmap overlays (the reference's
    streamlit app, extract/extract.py:738-834, rendered to files), drawn
    with matplotlib's Agg backend as the JAX stage draws it. Host only."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    # boxes keyed by image id, never by position (bboxes.pth follows the
    # sorted segmentations dir, the list any order)
    bboxes_by_id = {bd["id"]: bd for bd in load_pth(bbox_file)} if bbox_file else None
    colors = matplotlib.colormaps["tab20"].resampled(21)

    rows = []
    names = Path(images_list).read_text().splitlines()
    for name in names[:max_images]:
        image_id = Path(name).stem
        image = load_image_rgb(Path(images_root) / name)
        segmap = load_segmap_png(Path(segmentations_dir) / f"{image_id}.png")
        if set(np.unique(segmap).tolist()) == {0, 255}:
            segmap = (segmap == 255).astype(np.uint8)
        seg_full = resize_nearest(torch.from_numpy(segmap.astype(np.int32)),
                                  image.shape[:2]).numpy()
        ncols = 3 if bboxes_by_id is not None else 2
        fig, axes = plt.subplots(1, ncols, figsize=(5 * ncols, 5))
        axes[0].imshow(image)
        axes[0].set_title(image_id)
        overlay = colors(seg_full % 21)[..., :3]
        blend = 0.55 * image / 255.0 + 0.45 * overlay
        blend[seg_full == 0] = (image / 255.0)[seg_full == 0]
        axes[1].imshow(blend)
        axes[1].set_title("segments")
        if bboxes_by_id is not None:
            axes[2].imshow(image)
            bd = bboxes_by_id.get(image_id, {"bboxes_original_resolution": []})
            for (xmin, ymin, xmax, ymax) in bd["bboxes_original_resolution"]:
                axes[2].add_patch(plt.Rectangle((xmin, ymin), xmax - xmin, ymax - ymin,
                                                fill=False, edgecolor="red", linewidth=2))
            axes[2].set_title("boxes")
        for ax in axes:
            ax.axis("off")
        fig.savefig(out / f"{image_id}.png", bbox_inches="tight", dpi=80)
        plt.close(fig)
        rows.append(f'<div><h3>{image_id}</h3><img src="{image_id}.png"/></div>')
    (out / "index.html").write_text("<html><body>" + "\n".join(rows) + "</body></html>")
    print(f"Wrote visualization gallery to {out / 'index.html'}")
