"""Replays of the per-batch device path of the port's stages 1 and 2
(`deep_spectral_tpu_torch/pipeline/extract.py`), with the disk files left
out: the uploads (`_to_device`), the calls, the fetches (`_Fetch`) and the
one batch in flight (`_InFlight`) are the stages' own.

Stage 1 hands each batch's features to stage 2 through the host, in fp16,
as the feature files do. What the features are is the benchmark's: each
image's structured field plus 0.02 x its keys, mixed on the device before
the fetch. Stage 2 solves every batch as `extract_eigs` does, the guard's
dense re-solves included.

With `trace` set, each call into the port is bracketed by CUDA events (the
spans the per-layer metrics read) and the work of each call is counted from
its shapes (`work.py`); the filter chains are counted at their shapes as the
solver runs them, by a counting wrapper around the solver's filter.
"""
from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager
from functools import partial

import numpy as np
import torch

from . import work


class Trace:
    """Spans (name -> CUDA event pairs) and work (name -> [flops, bytes])."""

    def __init__(self):
        self.events = defaultdict(list)
        self.work = defaultdict(lambda: [0.0, 0.0])
        self.chains: list = []

    @contextmanager
    def span(self, name: str):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.events[name].append((start, end))

    def add(self, name: str, flops: float, nbytes: float = 0.0) -> None:
        self.work[name][0] += flops
        self.work[name][1] += nbytes

    def spans_ms(self) -> dict:
        torch.cuda.synchronize()
        return {n: [s.elapsed_time(e) for s, e in pairs] for n, pairs in self.events.items()}


@contextmanager
def counting_filter(trace: Trace):
    """Record (B, N, m, degree) of every filter chain the solver launches."""
    from deep_spectral_tpu_torch.ops import eigen
    inner = eigen.chebyshev_filter

    def counted(S, X, c, e, degree):
        trace.chains.append((*X.shape, degree))
        return inner(S, X, c, e, degree)

    eigen.chebyshev_filter = counted
    try:
        yield
    finally:
        eigen.chebyshev_filter = inner


class Stage2:
    """`extract_eigs`'s consume: upload fp16 features and masks, solve,
    fetch (evals, evecs) one batch later. `on_result(tag, evals, evecs)`
    runs when a batch's results are on the host."""

    def __init__(self, dev, K: int, batch_size: int, on_result, trace: Trace | None = None):
        from deep_spectral_tpu_torch.ops.eigen import resolve_eig_chunk
        from deep_spectral_tpu_torch.pipeline.extract import _InFlight
        self.dev, self.on_result, self.trace = dev, on_result, trace
        self.chunk = resolve_eig_chunk("auto", batch_size)
        self.kw = dict(K=K, which_matrix="laplacian", normalize=True, threshold_at_zero=True,
                       lapnorm=True, image_color_lambda=0.0, solver="auto",
                       cheb_filter_impl="auto", cheb_window_init="auto", eig_chunk=self.chunk)
        self.inflight = _InFlight()

    def submit(self, feats_np: np.ndarray, masks_np: np.ndarray, tag) -> None:
        """feats_np (B, bh, bw, D) fp16 zero-padded, masks_np (B, bh * bw)."""
        from deep_spectral_tpu_torch.ops.eigen import spectral_decompose_batched
        from deep_spectral_tpu_torch.pipeline.extract import _Fetch, _to_device
        B, bh, bw, _ = feats_np.shape
        feats = _to_device(feats_np, self.dev).reshape(B, bh * bw, -1).float()
        masks = _to_device(masks_np, self.dev)
        if self.trace is None:
            evals, evecs = spectral_decompose_batched(feats, masks, None, **self.kw)
        else:
            evals, evecs = self._traced(feats, masks, masks_np)
        self.inflight.push(_Fetch(evals, evecs), partial(self.on_result, tag))

    def _traced(self, feats, masks, masks_np):
        from deep_spectral_tpu_torch.ops.eigen import spectral_decompose_batched
        tr = self.trace
        n_valid = masks_np.sum(axis=1)
        before = len(tr.chains)
        with tr.span("eigs"), counting_filter(tr):
            out = spectral_decompose_batched(feats, masks, None, **self.kw)
        for _, _, m, degree in tr.chains[before:]:
            for n in n_valid:
                tr.add("cheb_filter", *work.cheb_chain(int(n), m, degree))
        D = feats.shape[-1]
        tr.add("model", sum(work.affinity(int(n), D) for n in n_valid))
        return out

    def drain(self) -> None:
        self.inflight.drain()


class Stage1:
    """`extract_features`'s consume: upload uint8 images and token masks,
    normalize on the device, `extract_patch_keys`, mix the benchmark's
    field in, fetch fp16 features one batch later. `on_result(tag, feats)`
    runs when a batch's features are on the host."""

    def __init__(self, model, cfg: dict, dev, on_result, trace: Trace | None = None):
        from deep_spectral_tpu_torch.pipeline.extract import _InFlight
        from deep_spectral_tpu_torch.utils.image_io import IMAGENET_SCALE, IMAGENET_SHIFT
        self.model, self.cfg, self.dev = model, cfg, dev
        self.on_result, self.trace = on_result, trace
        self.scale = torch.from_numpy(IMAGENET_SCALE).to(dev)
        self.shift = torch.from_numpy(IMAGENET_SHIFT).to(dev)
        self.inflight = _InFlight()
        self.keep_keys: dict = {}   # tag -> keys of a batch the check compares

    def submit(self, padded: np.ndarray, masks_np: np.ndarray, field: torch.Tensor,
               grid: tuple, buckets: tuple, tag, keep: bool = False) -> None:
        """padded (B, H, W, 3) uint8, masks_np (B, bh * bw) token masks,
        field (B, h * w, D) f32 on the device, grid (h, w) the images' valid
        patch grid; buckets: stage 1's (bh, bw) and stage 2's."""
        from deep_spectral_tpu_torch.models.vit import extract_patch_keys
        from deep_spectral_tpu_torch.pipeline.extract import _Fetch, _to_device
        images = _to_device(padded, self.dev).float() * self.scale - self.shift
        masks = _to_device(masks_np, self.dev)
        if self.trace is None:
            k = extract_patch_keys(self.model, images, which_block=-1, token_mask=masks)
        else:
            with self.trace.span("vit"):
                k = extract_patch_keys(self.model, images, which_block=-1, token_mask=masks)
            self._count(masks_np, images.shape)
        if keep:
            self.keep_keys[tag] = k.clone()
        self.inflight.push(_Fetch(mix(field, k, grid, *buckets)), partial(self.on_result, tag))

    def _count(self, masks_np, shape):
        c, P = self.cfg, self.cfg["patch_size"]
        B, H, W, _ = shape
        T = 1 + (H // P) * (W // P)
        keys = [1 + int(n) for n in masks_np.sum(axis=1)]
        hd = c["embed_dim"] // c["num_heads"]
        f, b = work.attention_fwd(keys, T, c["num_heads"], hd, 2, masked=True)
        self.trace.add("attention", (c["depth"] - 1) * f, (c["depth"] - 1) * b)
        self.trace.add("model", sum(work.vit_keys(n - 1, c) for n in keys))

    def drain(self) -> None:
        self.inflight.drain()


def mix(field: torch.Tensor, keys: torch.Tensor, grid: tuple, bucket1: tuple,
        bucket2: tuple) -> torch.Tensor:
    """Stage 2's fp16 features in its (b2h, b2w) bucket: field + 0.02 keys
    on the valid (h, w) patches, zeros elsewhere. field (B, h * w, D) f32,
    keys (B, bh * bw, D) in stage 1's (bh, bw) bucket."""
    (h, w), (bh, bw) = grid, bucket1
    B, _, D = keys.shape
    out = torch.zeros((B, *bucket2, D), dtype=torch.float16, device=keys.device)
    k = keys.reshape(B, bh, bw, D)[:, :h, :w].float()
    out[:, :h, :w] = (field.reshape(B, h, w, D) + 0.02 * k).to(torch.float16)
    return out
