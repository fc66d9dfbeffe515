"""Driver `extract`: stages 1 and 2 of the pipeline, closed loop.

Each iteration hands one stage-1 batch of uint8 images (padded to its
bucket as `extract_features` pads them) to stage 1; its fp16 features come
back to the host one batch later and are handed to stage 2 in batches of
`eig_batch_size`, bucketed as `extract_eigs` buckets them. Inputs come from
pools made in set-up and cycled (`pool_batches` batches, more than the
card's 50 MB L2 between two uses of one batch). The pools' images and
fields are drawn from the traffic's `content_seed`, the same for every run;
the run's seed draws the weights, the batch the check samples and where in
the pool's fixed cycle the run starts. Every seed so does nearly the same
work in the same sequence (the weights move the features by 0.02 x the
keys only): the solver's convergence, and with it the time, depends on the
graphs and on which batch follows which.

End-to-end: `images_per_s`, the images whose eigenpairs reached the host
inside the window over the window; `batch_p95_ms`, the 95th percentile of
a stage-1 batch's time from its images' hand-over to the last of its
eigenpairs on the host, over the batches finished in the window.
Correctness: one stage-1 batch of the window, drawn from the seed: its keys
against the reference ViT's on the same images and weights, and all its
images' eigenpairs (every lane of its stage-2 solves), on the fp16 features
stage 2 was handed, against the dense solve of those features.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import checks, features, stages, weights
from benchmark.reference import vit as ref_vit
from benchmark.reference.lowp import tf32_enabled


def eig_bucket(h: int, w: int, granularity: int):
    """`extract_eigs`'s `coarse_grid`: granularity 16 at least above 2048
    patches (a copy of the rule inside that stage)."""
    from deep_spectral_tpu_torch.utils import bucketing
    g = granularity if h * w <= 2048 else max(granularity, 16)
    return bucketing.bucket_for(h, w, g)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_vit(cfg: dict, sd: dict, dev, dtype=torch.bfloat16):
    """The port's ViT of `cfg` holding the benchmark's weights `sd`."""
    from deep_spectral_tpu_torch.models.vit import VisionTransformer, get_model_config
    vcfg = get_model_config(cfg["name"])
    for key in ("patch_size", "embed_dim", "depth", "num_heads", "mlp_ratio", "img_size"):
        if getattr(vcfg, key) != cfg[key]:
            raise ValueError(f"{cfg['name']}: the port's {key} {getattr(vcfg, key)} "
                             f"is not the configuration's {cfg[key]}")
    with torch.device(dev):
        model = VisionTransformer(vcfg, dtype)
    model.load_state_dict(sd)
    return model.eval()


class Runner:
    def __init__(self, cell, seed: int, dev):
        from deep_spectral_tpu_torch.utils import bucketing
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr, self.seed, self.dev = cfg, tr, seed, dev
        self.limits = cell.limits
        P, D = cfg["patch_size"], cfg["embed_dim"]
        H, W = tr["image_hw"]
        B, self.B2 = tr["batch_size"], tr["eig_batch_size"]
        self.grid = (H // P, W // P)
        b1 = bucketing.bucket_for(*self.grid, tr["stage1_granularity"])
        b2 = eig_bucket(*self.grid, tr["eig_granularity"])
        self.buckets = ((b1.h, b1.w), (b2.h, b2.w))
        rng = np.random.default_rng(tr["content_seed"])

        self.sd = weights.seeded_weights(weights.vit_shapes(cfg), seed, dev)
        self.model = build_vit(cfg, self.sd, dev)
        gen = torch.Generator(device=dev).manual_seed(tr["content_seed"])
        n_pool = tr["pool_batches"]
        imgs = torch.randint(0, 256, (n_pool * B, H, W, 3), generator=gen, dtype=torch.uint8,
                             device=dev).cpu().numpy()
        self.images, self.masks1 = [], None
        for i in range(n_pool):
            padded, extents = bucketing.pad_batch_images(
                list(imgs[i * B:(i + 1) * B]), (b1.h * P, b1.w * P), B)
            self.images.append(padded)
            self.masks1 = bucketing.token_masks(extents, b1, P)
        self.masks2 = bucketing.grid_masks(np.tile(np.asarray(self.grid), (self.B2, 1)),
                                           self.buckets[1])
        h, w = self.grid
        self.fields = [features.structured_field(
            [features.field_draws(rng, h, w, D) for _ in range(B)], h, w, dev)
            for _ in range(n_pool)]
        self.order = np.roll(np.arange(n_pool), seed % n_pool)
        self.check_rng = np.random.default_rng([seed, 1])

        self.j = 0
        self.starts, self.left, self.done, self.arrivals = {}, {}, [], []
        self.failed, self.sample, self.answers, self.stage2_inputs = 0, None, {}, None
        self.s2 = stages.Stage2(dev, tr["K"], self.B2, self._on_eigs)
        self.s1 = stages.Stage1(self.model, cfg, dev, self._on_feats)
        self._warm()

    # -- the loop ---------------------------------------------------------
    def _iterate(self) -> None:
        j, p = self.j, int(self.order[self.j % len(self.images)])
        self.starts[j] = time.perf_counter()
        self.left[j] = self.tr["batch_size"] // self.B2
        self.s1.submit(self.images[p], self.masks1, self.fields[p], self.grid, self.buckets,
                       tag=j, keep=j == self.sample)
        self.j += 1

    def _on_feats(self, j, feats) -> None:
        if j == self.sample:
            self.stage2_inputs = feats.copy()
        for c in range(self.left[j]):
            self.s2.submit(feats[c * self.B2:(c + 1) * self.B2], self.masks2, tag=(j, c))

    def _on_eigs(self, tag, evals, evecs) -> None:
        now = time.perf_counter()
        j, c = tag
        bad = ~(np.isfinite(evals).all(axis=1) & np.isfinite(evecs).reshape(len(evecs), -1).all(1))
        self.failed += int(bad.sum())
        self.arrivals.append((now, len(evals), int(bad.sum())))
        if j == self.sample:
            self.answers[c] = (evals, evecs)
        self.left[j] -= 1
        if self.left[j] == 0:
            del self.left[j]
            self.done.append((now, now - self.starts.pop(j)))

    def _drain(self) -> None:
        self.s1.drain()
        self.s2.drain()

    def _warm(self) -> None:
        """Every shape of the cell once (the guard's dense eigh included),
        then `warm_batches` iterations; the loop stays primed."""
        from deep_spectral_tpu_torch.ops.eigen import CHEB_MAX_N, spectral_decompose_batched
        n2 = self.buckets[1][0] * self.buckets[1][1]
        if n2 <= CHEB_MAX_N:
            f = torch.randn((1, n2, self.cfg["embed_dim"]), device=self.dev)
            spectral_decompose_batched(f, torch.from_numpy(self.masks2[:1]).to(self.dev),
                                       K=self.tr["K"], solver="eigh")
        t = []
        for _ in range(self.tr["warm_batches"]):
            t.append(time.perf_counter())
            self._iterate()
        sync(self.dev)
        t.append(time.perf_counter())
        half = len(t) // 2
        self.rate = (len(t) - 1 - half) / max(t[-1] - t[half], 1e-9)   # batches/s

    # -- runs -------------------------------------------------------------
    def window(self, seconds: float) -> dict:
        n_min = max(1, int(0.5 * seconds * self.rate))
        self.sample = self.j + int(self.check_rng.integers(0, n_min))
        self.arrivals.clear()
        self.done.clear()
        self.failed = 0
        t0 = time.perf_counter()
        self.window_start = time.time()
        end = t0 + seconds
        while time.perf_counter() < end:
            self._iterate()
        images = sum(n for t, n, _ in self.arrivals if t0 <= t <= end)
        failed = sum(f for t, _, f in self.arrivals if t0 <= t <= end)
        lat = [dt for t, dt in self.done if t0 <= t <= end]
        self._drain()
        return {"metrics": {"images_per_s": images / seconds,
                            "batch_p95_ms": float(np.percentile(lat, 95)) * 1e3 if lat else math.inf},
                "attempted": images, "failed": failed}

    def traced(self, seconds: float):
        from benchmark.trace import Timeline
        self._drain()
        sync(self.dev)
        tr = stages.Trace()
        self.s1.trace = self.s2.trace = tr
        n = self.tr["trace_batches"]
        self.sample = self.j + int(self.check_rng.integers(0, n))
        self.arrivals.clear()
        self.failed = 0

        def body():
            end = time.perf_counter() + seconds
            for _ in range(n):
                if time.perf_counter() >= end:
                    break
                self._iterate()
            self._drain()
            sync(self.dev)

        self.window_start = time.time()
        timeline = Timeline.record(body)
        self.s1.trace = self.s2.trace = None
        images = sum(a[1] for a in self.arrivals)
        return timeline, tr, {"images": images, "attempted": images, "failed": self.failed}

    def release(self) -> None:
        """Free the port's state before the reference runs."""
        self.keys = self.s1.keep_keys.pop(self.sample, None)
        del self.model, self.s1, self.s2
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- correctness ------------------------------------------------------
    def sample_inputs(self):
        """The sampled batch's padded images and fields."""
        p = int(self.order[self.sample % len(self.images)])
        return self.images[p], self.fields[p]

    def port_answers(self) -> list:
        """The sampled batch's eigenpairs, per image on its valid nodes."""
        (h, w), (b2h, b2w), K = self.grid, self.buckets[1], self.tr["K"]
        out = []
        for c in sorted(self.answers):
            evals, evecs = self.answers[c]
            for i in range(len(evals)):
                v = evecs[i].reshape(K, b2h, b2w)[:, :h, :w].reshape(K, h * w)
                out.append((torch.from_numpy(evals[i]), torch.from_numpy(v)))
        return out

    def reference_keys(self, fp8: bool = False) -> list:
        """The reference's keys of the sampled batch, per image on its
        valid patches (fp8: the control's)."""
        padded, _ = self.sample_inputs()
        (h, w), (bh, bw) = self.grid, self.buckets[0]
        x = ref_vit.normalize_uint8(torch.from_numpy(padded).to(self.dev))
        mask = torch.from_numpy(self.masks1).to(self.dev)
        with tf32_enabled(False):
            k = ref_vit.patch_keys(self.sd, self.cfg, x, mask,
                                   ref_vit.Numerics(torch.float32, fp8=fp8))
        return [ki.reshape(bh, bw, -1)[:h, :w].reshape(h * w, -1) for ki in k]

    def port_keys(self) -> list:
        (h, w), (bh, bw) = self.grid, self.buckets[0]
        return [ki.float().reshape(bh, bw, -1)[:h, :w].reshape(h * w, -1) for ki in self.keys]

    def stage2_features(self) -> list:
        """The fp16 features stage 2 was handed for the sampled batch (stage
        1's output as the files would hold it), per image on its valid
        patches, in the order of `port_answers`: stage 2's answers are
        judged on the input they got, and stage 1's keys against the
        reference's own. Every image of the batch, so every lane of each of
        its stage-2 solves, is compared."""
        (h, w), D = self.grid, self.cfg["embed_dim"]
        x = self.stage2_inputs[:, :h, :w].reshape(-1, h * w, D)
        return [torch.from_numpy(f).to(self.dev) for f in x]

    def numbers(self) -> dict:
        out = {"keys_rel_err": checks.keys_gap(self.port_keys(), self.reference_keys())}
        with tf32_enabled(False):
            out.update(checks.eig_gaps(self.stage2_features(), self.port_answers(), self.tr["K"]))
        return out

    def check(self) -> tuple[bool, dict]:
        if self.keys is None or not self.answers or self.stage2_inputs is None:
            return False, {"sample_missing": {"value": math.inf, "limit": 0.0}}
        return checks.verdict(self.numbers(), self.limits)
