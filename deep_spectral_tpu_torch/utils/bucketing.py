"""Shape-bucketed batching: ragged real-world images grouped into a few padded
shapes (a copy of `deep_spectral_tpu.utils.bucketing`, which is numpy-only).

The reference processes one image at a time precisely because every image has a
different resolution (batch_size=1 in all recipes, README.md:65). Here we
instead round each image's patch grid up to a bucket shape (multiples of
`granularity` patches), zero-pad, and carry a validity mask; the ViT, the
affinity and the eigensolvers accept these masks and are exact under padding
(attention masking, affinity zeroing, pad-diagonal eigensolve). Images in the
same bucket run as one batch.
"""
from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

import numpy as np


@dataclass(frozen=True)
class Bucket:
    """A padded patch-grid shape: images with H_patch <= h, W_patch <= w fit."""
    h: int
    w: int

    @property
    def tokens(self) -> int:
        return self.h * self.w


def bucket_for(h_patch: int, w_patch: int, granularity: int = 8) -> Bucket:
    g = granularity
    return Bucket(math.ceil(h_patch / g) * g, math.ceil(w_patch / g) * g)


def square_pow2_bucket(h_patch: int, w_patch: int, min_side: int = 8) -> Bucket:
    """Square power-of-two bucket: side = next pow2 >= max(h, w, min_side).

    For wildly-varying shapes (bbox crops) where every distinct bucket costs a
    compile: caps the number of compiled shapes at ~log2(max_size) in exchange
    for masked-padding compute waste."""
    side = min_side
    target = max(h_patch, w_patch, min_side)
    while side < target:
        side *= 2
    return Bucket(side, side)


def group_into_buckets(
    sizes: Sequence[tuple[int, int]],
    granularity: int = 8,
) -> dict[Bucket, list[int]]:
    """Map (h_patch, w_patch) per item -> {bucket: [item indices]}."""
    groups: dict[Bucket, list[int]] = defaultdict(list)
    for i, (hp, wp) in enumerate(sizes):
        groups[bucket_for(hp, wp, granularity)].append(i)
    return dict(groups)


def batches(indices: Sequence[int], batch_size: int) -> Iterable[list[int]]:
    for i in range(0, len(indices), batch_size):
        yield list(indices[i: i + batch_size])


def pad_batch_images(
    images: Sequence[np.ndarray],  # each (Hi, Wi, C) or (Hi, Wi)
    out_hw: tuple[int, int],
    batch_size: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad images to (batch_size, H, W, [C]) plus per-image (h, w) extents.

    Short batches are padded with all-zero rows so every batch of a bucket has
    identical shape (one compile per bucket, not per remainder)."""
    H, W = out_hw
    sample = np.asarray(images[0])
    trailing = sample.shape[2:]
    out = np.zeros((batch_size, H, W, *trailing), dtype=sample.dtype)
    extents = np.zeros((batch_size, 2), np.int32)
    for i, im in enumerate(images):
        im = np.asarray(im)
        h, w = im.shape[:2]
        out[i, :h, :w] = im
        extents[i] = (h, w)
    return out, extents


def token_masks(extents: np.ndarray, bucket: Bucket, patch_size: int) -> np.ndarray:
    """(B, bucket.h * bucket.w) bool: True where a patch is inside its image."""
    B = extents.shape[0]
    masks = np.zeros((B, bucket.h, bucket.w), bool)
    for i, (h, w) in enumerate(extents):
        masks[i, : h // patch_size, : w // patch_size] = True
    return masks.reshape(B, -1)


def grid_masks(extents_lr: np.ndarray, bucket_hw: tuple[int, int]) -> np.ndarray:
    """(B, H*W) bool for low-res pixel grids given (h_lr, w_lr) extents."""
    H, W = bucket_hw
    B = extents_lr.shape[0]
    masks = np.zeros((B, H, W), bool)
    for i, (h, w) in enumerate(extents_lr):
        masks[i, :h, :w] = True
    return masks.reshape(B, -1)


def make_batch_plan(
    items: Sequence,
    size_fn: Callable[[object], tuple[int, int]],
    *,
    batch_size: int,
    granularity: int = 8,
) -> list[tuple[Bucket, list]]:
    """Largest-bucket-first batch plan: [(bucket, item_sublist), ...]."""
    sizes = [size_fn(it) for it in items]
    groups = group_into_buckets(sizes, granularity)
    plan = []
    for bucket in sorted(groups, key=lambda b: -b.tokens):
        for idx_batch in batches(groups[bucket], batch_size):
            plan.append((bucket, [items[i] for i in idx_batch]))
    return plan


def run_bucketed_prefetched(
    items: Sequence,
    size_fn: Callable[[object], tuple[int, int]],
    prepare_batch: Callable[[Bucket, list], object],
    consume_batch: Callable[[Bucket, list, object], None],
    *,
    batch_size: int,
    granularity: int = 8,
    depth: int = 2,
    workers: int = 4,
) -> None:
    """Pipelined variant: `prepare_batch` (host IO: decode/normalize/pad) runs in
    a thread pool up to `depth` batches ahead of `consume_batch` (device step).

    This is the input pipeline that replaces the reference's
    DataLoader(num_workers=8) + per-image loop: host decode overlaps device
    compute instead of serializing with it."""
    from concurrent.futures import ThreadPoolExecutor

    plan = make_batch_plan(items, size_fn, batch_size=batch_size,
                           granularity=granularity)
    with ThreadPoolExecutor(workers) as pool:
        futures = {}
        for i in range(min(depth, len(plan))):
            futures[i] = pool.submit(prepare_batch, *plan[i])
        for i, (bucket, batch_items) in enumerate(plan):
            prepared = futures.pop(i).result()
            nxt = i + depth
            if nxt < len(plan):
                futures[nxt] = pool.submit(prepare_batch, *plan[nxt])
            consume_batch(bucket, batch_items, prepared)
