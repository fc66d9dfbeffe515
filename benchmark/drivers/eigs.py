"""Driver `eigs`: stage 2 alone, closed loop, over ragged image shapes.

The mix's images (`aspects`: width:height ratios with a count each, the
longer side `longer_side` pixels) have patch grids of their own; each is
bucketed as `extract_eigs` buckets it, so a batch holds one bucket, and its
fp16 features (a structured field, the ViT bypassed) are padded into it on
the host as that stage pads them. Batches of `eig_batch_size` form as the
images, shuffled, stream into their buckets; the counts make every
bucket's batches whole. The images, their fields and the batches are drawn
from the traffic's `content_seed`, the same for every run, and so is the
cycle of batches; the run's seed draws where in the cycle the run starts,
and so which batches the check compares. Every seed does the same work in
the same sequence: the solver's convergence, and with it the time, depends
on the graphs, on which share a batch and on which batch follows which.

End-to-end: `images_per_s` (eigenpairs on the host inside the window over
the window) and `batch_p95_ms` (a batch's hand-over to its eigenpairs on
the host). Correctness: the window's first batch of each bucket, held to
the dense solve of the same features.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import checks, features, stages
from benchmark.drivers.extract import eig_bucket, sync
from benchmark.reference.lowp import tf32_enabled


def image_grids(tr: dict, patch: int) -> list[tuple[int, int]]:
    """The (h, w) patch grid of every image of the mix, in pool order."""
    L, out = tr["longer_side"], []
    for (aw, ah), count in tr["aspects"]:
        W, H = (L, round(L * ah / aw)) if aw >= ah else (round(L * aw / ah), L)
        out += [(H // patch, W // patch)] * count
    return out


def batch_plan(grids, order, B: int, granularity: int) -> list[tuple[tuple, list]]:
    """[(bucket (bh, bw), [image index, ...]), ...] as the images of `order`
    stream into their buckets, a batch emitted when B are waiting."""
    waiting, plan = {}, []
    for i in order:
        b = eig_bucket(*grids[i], granularity)
        key = (b.h, b.w)
        waiting.setdefault(key, []).append(int(i))
        if len(waiting[key]) == B:
            plan.append((key, waiting.pop(key)))
    if waiting:
        raise ValueError(f"the mix leaves part batches in {sorted(waiting)}")
    return plan


class Runner:
    def __init__(self, cell, seed: int, dev):
        from deep_spectral_tpu_torch.utils import bucketing
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr, self.dev, self.limits = cfg, tr, dev, cell.limits
        D, B, K = cfg["embed_dim"], tr["eig_batch_size"], tr["K"]
        rng = np.random.default_rng(tr["content_seed"])
        grids = image_grids(tr, cfg["patch_size"])
        plan = batch_plan(grids, rng.permutation(len(grids)), B, tr["eig_granularity"])
        batches = []
        for (bh, bw), idx in plan:
            feats = np.zeros((B, bh, bw, D), np.float16)
            extents = np.zeros((B, 2), np.int32)
            for r, i in enumerate(idx):
                h, w = grids[i]
                f = features.structured_field([features.field_draws(rng, h, w, D)], h, w, dev)
                feats[r, :h, :w] = f.reshape(h, w, D).to(torch.float16).cpu().numpy()
                extents[r] = (h, w)
            batches.append((feats, bucketing.grid_masks(extents, (bh, bw)), extents))
        order = np.roll(np.arange(len(plan)), seed % len(plan))
        self.plan = [plan[i] for i in order]
        self.batches = [batches[i] for i in order]
        self.s2 = stages.Stage2(dev, K, B, self._on_eigs)
        self.j, self.starts, self.done, self.failed = 0, {}, [], 0
        self.keep, self.answers = set(), {}
        self._warm()

    def _iterate(self) -> None:
        j, p = self.j, self.j % len(self.batches)
        feats, masks, _ = self.batches[p]
        self.starts[j] = time.perf_counter()
        self.s2.submit(feats, masks, tag=j)
        self.j += 1

    def _on_eigs(self, j, evals, evecs) -> None:
        now = time.perf_counter()
        bad = ~(np.isfinite(evals).all(axis=1) & np.isfinite(evecs).reshape(len(evecs), -1).all(1))
        p = j % len(self.batches)
        n = int((self.batches[p][2][:, 0] > 0).sum())
        self.done.append((now, now - self.starts.pop(j), n, int(bad[:n].sum())))
        if j in self.keep:
            self.answers[j] = (evals, evecs)

    def _warm(self) -> None:
        """The guard's dense eigh at every bucket shape, then one pass."""
        from deep_spectral_tpu_torch.ops.eigen import spectral_decompose_batched
        for feats, masks, _ in {b[0].shape: b for b in self.batches}.values():
            f = torch.from_numpy(feats[:1]).to(self.dev).reshape(1, -1, feats.shape[-1]).float()
            spectral_decompose_batched(f, torch.from_numpy(masks[:1]).to(self.dev),
                                       K=self.tr["K"], solver="eigh")
        for _ in range(len(self.batches) * self.tr["warm_passes"]):
            self._iterate()
        sync(self.dev)

    def _keep_first_of_each_bucket(self, start: int) -> None:
        seen = set()
        for j in range(start, start + len(self.batches)):
            key = self.plan[j % len(self.batches)][0]
            if key not in seen:
                seen.add(key)
                self.keep.add(j)

    def window(self, seconds: float) -> dict:
        self._keep_first_of_each_bucket(self.j)
        self.done.clear()
        t0 = time.perf_counter()
        self.window_start = time.time()
        end = t0 + seconds
        while time.perf_counter() < end:
            self._iterate()
        inside = [d for d in self.done if t0 <= d[0] <= end]
        self.s2.drain()
        images = sum(d[2] for d in inside)
        lat = [d[1] for d in inside]
        return {"metrics": {"images_per_s": images / seconds,
                            "batch_p95_ms": float(np.percentile(lat, 95)) * 1e3 if lat else math.inf},
                "attempted": images, "failed": sum(d[3] for d in inside)}

    def traced(self, seconds: float):
        from benchmark.trace import Timeline
        self.s2.drain()
        sync(self.dev)
        tr = stages.Trace()
        self.s2.trace = tr
        n = min(self.tr["trace_batches"], len(self.batches))
        self._keep_first_of_each_bucket(self.j)
        self.done.clear()

        def body():
            end = time.perf_counter() + seconds
            for _ in range(n):
                if time.perf_counter() >= end:
                    break
                self._iterate()
            self.s2.drain()
            sync(self.dev)

        self.window_start = time.time()
        timeline = Timeline.record(body)
        self.s2.trace = None
        images = sum(d[2] for d in self.done)
        return timeline, tr, {"images": images, "attempted": images,
                              "failed": sum(d[3] for d in self.done)}

    def release(self) -> None:
        del self.s2
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def compared(self) -> tuple[list, list]:
        """(fp16 features (n, D), port answers (evals, evecs (K, n))) of the
        kept batches' real images, on their valid nodes."""
        feats, answers, K = [], [], self.tr["K"]
        for j, (evals, evecs) in sorted(self.answers.items()):
            f16, _, extents = self.batches[j % len(self.batches)]
            _, bh, bw, D = f16.shape
            for r, (h, w) in enumerate(extents):
                if h == 0:
                    continue
                feats.append(torch.from_numpy(f16[r, :h, :w].reshape(h * w, D)).to(self.dev))
                v = evecs[r].reshape(K, bh, bw)[:, :h, :w].reshape(K, h * w)
                answers.append((torch.from_numpy(evals[r]), torch.from_numpy(v)))
        return feats, answers

    def numbers(self) -> dict:
        feats, answers = self.compared()
        with tf32_enabled(False):
            return checks.eig_gaps(feats, answers, self.tr["K"])

    def check(self) -> tuple[bool, dict]:
        if not self.answers:
            return False, {"sample_missing": {"value": math.inf, "limit": 0.0}}
        return checks.verdict(self.numbers(), self.limits)
