"""Driver `extract_dinov3`: the `extract` driver's closed loop, metrics and
check (`drivers/extract.py`) on a DINOv3 ViT over COCO-shaped ragged images.

What differs from `extract` and `extract_dinov2`:
  * the images are the `eigs` driver's mix (`aspects` at `longer_side`,
    `image_grids`), each floor-cropped to whole patches; `stage1_plan`
    groups them into stage-1 batches of one bucket at `stage1_granularity`
    whose images fall into whole stage-2 batches (`eig_batch_size` of one
    bucket at `eig_granularity`, bucketed as `extract_eigs` buckets each
    image), with the groups of a bucket dealt in turn so that images of
    other grids share a stage-1 batch. Each iteration hands one stage-1
    batch to stage 1 with each image's grid; its features come back one
    batch later as that batch's stage-2 batches;
  * the weights are DINOv3's (`dinov3_shapes`: storage and mask tokens,
    `rope_embed.periods`, a qkv projection without a bias, LayerScale
    gammas drawn as the `scale` kind, 1 + N(0, 0.02^2), the unfused SwiGLU
    FFN's `mlp.w1`, `w2` and `w3`), drawn one tensor at a time from the run's
    seed (`seeded_weights`), and the port's model takes them as its own
    tensors (`load_state_dict(assign=True)`): a second 27 GB copy of 6.7B
    f32 parameters, or one flat draw of them all, would not leave the card
    room to run;
  * stage 1's work counts 1 + R prefix tokens an image, the three FFN
    matrices (`block_flops`), the blocks' attention at 32 heads of 128, and
    RoPE's bytes (`rope_bytes`: each block's q and k patch rows read and
    written once in bf16), all on valid tokens;
  * the sampled batch has an image smaller than its bucket (`Runner.sample`):
    the check judges keys that ran compacted under each image's own RoPE
    grid;
  * `keys_rel_err` judges the sampled batch's keys against
    `reference/dinov3.py`, each image alone at its cropped size, unpadded;
    `keys_f32_rel_err` judges the same modules rebuilt in f32 after the
    window on the batch's first `F32_IMAGES` images, with the window's
    masks and grids, attention on the port's plain 'einsum' route (kernel 1
    has no f32 build at head dim 128); the eigenpairs of every stage-2
    batch the sampled batch made, as `extract`.

A port without the configuration's model raises in set-up, before any
weight is drawn. `calibration_rows` gives the control's and the faults'
readings for `limits/<workload>.json`.
"""
from __future__ import annotations

import math
import time
from functools import partial

import numpy as np
import torch

from benchmark import checks, features, stages, work
from benchmark.drivers import extract as base
from benchmark.drivers.eigs import image_grids
from benchmark.reference import dinov3 as ref_dinov3
from benchmark.reference import vit as ref_vit
from benchmark.reference.lowp import tf32_enabled

F32_IMAGES = 2
_PORT_FIELDS = (("patch_size", "patch_size"), ("embed_dim", "embed_dim"), ("depth", "depth"),
                ("num_heads", "num_heads"), ("mlp_ratio", "ffn_ratio"),
                ("num_registers", "n_storage_tokens"), ("ffn", "ffn_layer"),
                ("norm_eps", "layer_norm_eps"))


def dinov3_shapes(cfg: dict) -> dict:
    """name -> (shape, kind) of a DINOv3 ViT's parameters under DINOv3's
    names (kinds as `weights.vit_shapes`)."""
    D, P, depth = cfg["embed_dim"], cfg["patch_size"], cfg["depth"]
    hidden = ref_dinov3.swiglu_hidden(D, cfg["ffn_ratio"])
    shapes = {"cls_token": ((1, 1, D), "small"),
              "storage_tokens": ((1, cfg["n_storage_tokens"], D), "small"),
              "mask_token": ((1, D), "small"),
              "patch_embed.proj.weight": ((D, 3, P, P), "weight"),
              "patch_embed.proj.bias": ((D,), "small")}
    for i in range(depth):
        b = f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            shapes[b + norm + ".weight"] = ((D,), "scale")
            shapes[b + norm + ".bias"] = ((D,), "small")
        shapes[b + "attn.qkv.weight"] = ((3 * D, D), "weight")
        for name, (out, inp) in (("attn.proj", (D, D)), ("mlp.w1", (hidden, D)),
                                 ("mlp.w2", (hidden, D)), ("mlp.w3", (D, hidden))):
            shapes[b + name + ".weight"] = ((out, inp), "weight")
            shapes[b + name + ".bias"] = ((out,), "small")
        shapes[b + "ls1.gamma"] = ((D,), "scale")
        shapes[b + "ls2.gamma"] = ((D,), "scale")
    shapes["norm.weight"] = ((D,), "scale")
    shapes["norm.bias"] = ((D,), "small")
    return shapes


@torch.no_grad()
def seeded_weights(cfg: dict, seed: int, device) -> dict:
    """name -> f32 tensor on `device`: each entry of `dinov3_shapes` drawn in
    turn from one generator on `device` seeded with `seed`, scaled in place
    by kind as `weights.seeded_weights` scales it; `rope_embed.periods` from
    the configuration's base."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, (shape, kind) in dinov3_shapes(cfg).items():
        x = torch.randn(shape, generator=gen, device=device)
        if kind == "weight":
            x.mul_(1.0 / math.sqrt(math.prod(shape) // shape[0]))
        elif kind == "small":
            x.mul_(0.02)
        else:                                     # "scale"
            x.mul_(0.02).add_(1.0)
        out[name] = x
    out["rope_embed.periods"] = ref_dinov3.rope_periods(
        cfg["embed_dim"] // cfg["num_heads"], cfg["pos_embed_rope_base"]).to(device)
    return out


def block_flops(t: int, cfg: dict) -> float:
    """One block over t tokens: qkv and proj (8 t D^2), the FFN's w1, w2 and
    w3 (6 t D H) and the two attention products (4 t^2 D)."""
    D, H = cfg["embed_dim"], ref_dinov3.swiglu_hidden(cfg["embed_dim"], cfg["ffn_ratio"])
    return 2.0 * t * (4 * D * D + 3 * D * H) + 4.0 * t * t * D


def vit_keys(n_patches: int, cfg: dict) -> float:
    """Stage 1 of one image with n valid patches and 1 + R prefix tokens:
    the patch embedding, depth - 1 whole blocks and the last block's qkv
    projection."""
    D = cfg["embed_dim"]
    t = n_patches + 1 + cfg["n_storage_tokens"]
    return (work.patch_embed(n_patches, cfg["patch_size"], D)
            + (cfg["depth"] - 1) * block_flops(t, cfg) + 2.0 * t * D * 3 * D)


def rope_bytes(n_patches: int, cfg: dict) -> float:
    """RoPE of one block on one image: its q and k patch rows (n x D each)
    read and written once in bf16."""
    return 2 * 2 * 2.0 * n_patches * cfg["embed_dim"]


def port_config(cfg: dict):
    """The port's ViTConfig of `cfg["name"]`, checked field by field (raises
    where the port has no such model)."""
    from deep_spectral_tpu_torch.models.vit import get_model_config
    vcfg = get_model_config(cfg["name"])
    for port_key, key in _PORT_FIELDS:
        if getattr(vcfg, port_key) != cfg[key]:
            raise ValueError(f"{cfg['name']}: the port's {port_key} {getattr(vcfg, port_key)} "
                             f"is not the configuration's {key} {cfg[key]}")
    if vcfg.family != "dinov3":
        raise ValueError(f"{cfg['name']}: the port's family is {vcfg.family!r}, not 'dinov3'")
    return vcfg


def build_vit(vcfg, sd: dict, dev, dtype=torch.bfloat16, attention_impl: str = "auto"):
    """The port's model holding the tensors of `sd` as its own."""
    from deep_spectral_tpu_torch.models.vit import VisionTransformer
    with torch.device("meta"):
        model = VisionTransformer(vcfg, dtype, attention_impl)
    model.load_state_dict(sd, assign=True)
    return model.eval()


def stage1_plan(grids: list, order, B: int, B2: int, g1: int) -> list:
    """[(stage-1 bucket (bh, bw), [[image index, ...] one stage-2 batch of
    B2, ...]), ...]: each stage-1 bucket's images, taken in `order`, cut
    into runs of B2 of one grid (so of one stage-2 bucket); a bucket's runs
    dealt in turn by their place in their grid's list (so other grids share
    a batch) and taken B // B2 at a time."""
    from deep_spectral_tpu_torch.utils import bucketing
    by1: dict = {}
    for i in order:
        b1 = bucketing.bucket_for(*grids[i], g1)
        by1.setdefault((b1.h, b1.w), {}).setdefault(tuple(grids[i]), []).append(int(i))
    plan = []
    for key1, by2 in by1.items():
        runs = []
        for idx in by2.values():
            if len(idx) % B2:
                raise ValueError(f"the mix leaves a part stage-2 batch in {key1}")
            n = len(idx) // B2
            runs += [((r + 0.5) / n, idx[r * B2:(r + 1) * B2]) for r in range(n)]
        runs = [r for _, r in sorted(runs, key=lambda x: x[0])]
        per = B // B2
        if len(runs) % per:
            raise ValueError(f"the mix leaves a part stage-1 batch in {key1}")
        plan += [(key1, runs[k:k + per]) for k in range(0, len(runs), per)]
    return plan


class Batch:
    """One stage-1 batch of the pool: padded uint8 images, token masks, each
    image's grid, and its stage-2 batches (bucket, rows, grid, fields,
    masks)."""

    def __init__(self, bucket1, runs, grids, imgs, cfg, tr, rng, dev):
        from deep_spectral_tpu_torch.utils import bucketing
        P, D = cfg["patch_size"], cfg["embed_dim"]
        order = [i for run in runs for i in run]
        b1 = bucketing.Bucket(*bucket1)
        self.bucket1 = bucket1
        self.images, extents = bucketing.pad_batch_images(
            [imgs[i] for i in order], (b1.h * P, b1.w * P), len(order))
        self.masks1 = bucketing.token_masks(extents, b1, P)
        self.grids1 = extents // P
        self.groups = []
        for r, run in enumerate(runs):
            h, w = grids[run[0]]
            b2 = base.eig_bucket(h, w, tr["eig_granularity"])
            field = features.structured_field(
                [features.field_draws(rng, h, w, D) for _ in run], h, w, dev)
            masks2 = bucketing.grid_masks(np.tile([h, w], (len(run), 1)), (b2.h, b2.w))
            rows = list(range(r * len(run), (r + 1) * len(run)))
            self.groups.append(((b2.h, b2.w), rows, (h, w), field, masks2))


class Stage1(stages.Stage1):
    """`stages.Stage1` handing the port each image's grid and mixing each of
    the batch's stage-2 batches in its own bucket."""

    def submit(self, batch: Batch, tag, keep: bool = False) -> None:
        from deep_spectral_tpu_torch.models.vit import extract_patch_keys
        from deep_spectral_tpu_torch.pipeline.extract import _Fetch, _to_device
        images = _to_device(batch.images, self.dev).float() * self.scale - self.shift
        masks = _to_device(batch.masks1, self.dev)
        call = partial(extract_patch_keys, self.model, images, which_block=-1,
                       token_mask=masks, grids=batch.grids1)
        if self.trace is None:
            k = call()
        else:
            with self.trace.span("vit"):
                k = call()
            self._count(batch)
        if keep:
            self.keep_keys[tag] = k.clone()
        outs = [stages.mix(field, k[rows], grid, batch.bucket1, b2)
                for b2, rows, grid, field, _ in batch.groups]
        self.inflight.push(_Fetch(*outs), partial(self.on_result, tag))

    def _count(self, batch: Batch):
        c = self.cfg
        prefix = 1 + c["n_storage_tokens"]
        n = [int(gh) * int(gw) for gh, gw in batch.grids1]
        keys = [prefix + m for m in n]
        T = max(keys)
        hd = c["embed_dim"] // c["num_heads"]
        f, b = work.attention_fwd(keys, T, c["num_heads"], hd, 2, masked=True)
        self.trace.add("attention", (c["depth"] - 1) * f, (c["depth"] - 1) * b)
        self.trace.add("model", sum(vit_keys(m, c) for m in n))
        self.trace.add("rope", 0.0, (c["depth"] - 1) * sum(rope_bytes(m, c) for m in n))


class Runner(base.Runner):
    def __init__(self, cell, seed: int, dev):
        cfg, tr = cell.config, cell.traffic
        vcfg = port_config(cfg)
        self.cfg, self.vcfg, self.tr, self.seed, self.dev = cfg, vcfg, tr, seed, dev
        self.limits = cell.limits
        P = cfg["patch_size"]
        self.B2 = tr["eig_batch_size"]
        rng = np.random.default_rng(tr["content_seed"])
        grids = [(h, w) for h, w in image_grids(tr, P)]
        plan = stage1_plan(grids, rng.permutation(len(grids)), tr["batch_size"], self.B2,
                           tr["stage1_granularity"])
        plan = [plan[i] for i in rng.permutation(len(plan))]

        self.sd = seeded_weights(cfg, seed, dev)
        self.model = build_vit(vcfg, self.sd, dev)
        gen = torch.Generator(device=dev).manual_seed(tr["content_seed"])
        imgs = [torch.randint(0, 256, (h * P, w * P, 3), generator=gen, dtype=torch.uint8,
                              device=dev).cpu().numpy() for h, w in grids]
        self.pool = [Batch(b1, runs, grids, imgs, cfg, tr, rng, dev) for b1, runs in plan]
        self.order = np.roll(np.arange(len(self.pool)), seed % len(self.pool))
        self.check_rng = np.random.default_rng([seed, 1])

        self.j = 0
        self.starts, self.left, self.done, self.arrivals = {}, {}, [], []
        self.failed, self.sample, self.answers, self.stage2_inputs = 0, None, {}, None
        self.s2 = stages.Stage2(dev, tr["K"], self.B2, self._on_eigs)
        self.s1 = Stage1(self.model, cfg, dev, self._on_feats)
        self._warm()

    # -- the loop ---------------------------------------------------------
    def _batch(self, j: int) -> Batch:
        return self.pool[int(self.order[j % len(self.pool)])]

    @property
    def sample(self):
        """The window's sampled batch, which the check judges. Where the
        window draws one whose images all fill their bucket (the cycle's
        1:1 batch), it is the next batch of the cycle that has an image
        smaller than its bucket, so that the keys judged ran compacted and
        rotated by each image's own grid."""
        return self._sample

    @sample.setter
    def sample(self, j) -> None:
        if j is not None:
            j += next((d for d in range(len(self.pool)) if not self._fills(j + d)), 0)
        self._sample = j

    def _fills(self, j: int) -> bool:
        batch = self._batch(j)
        return bool((batch.grids1 == np.asarray(batch.bucket1)).all())

    def _iterate(self) -> None:
        j = self.j
        batch = self._batch(j)
        self.starts[j] = time.perf_counter()
        self.left[j] = len(batch.groups)
        self.s1.submit(batch, tag=j, keep=j == self.sample)
        self.j += 1

    def _on_feats(self, j, *feats) -> None:
        batch = self._batch(j)
        if j == self.sample:
            self.stage2_inputs = [f.copy() for f in feats]
        for c, (f, group) in enumerate(zip(feats, batch.groups)):
            self.s2.submit(f, group[4], tag=(j, c))

    def _warm(self) -> None:
        """The guard's dense eigh at every stage-2 bucket, then
        `warm_batches` iterations (a whole cycle of the pool: every
        stage-1 shape); the loop stays primed."""
        from deep_spectral_tpu_torch.ops.eigen import spectral_decompose_batched
        shapes = {g[0]: g for b in self.pool for g in b.groups}
        for (b2h, b2w), _, _, _, masks2 in shapes.values():
            f = torch.randn((1, b2h * b2w, self.cfg["embed_dim"]), device=self.dev)
            spectral_decompose_batched(f, torch.from_numpy(masks2[:1]).to(self.dev),
                                       K=self.tr["K"], solver="eigh")
        t = []
        for _ in range(self.tr["warm_batches"]):
            t.append(time.perf_counter())
            self._iterate()
        base.sync(self.dev)
        t.append(time.perf_counter())
        half = len(t) // 2
        self.rate = (len(t) - 1 - half) / max(t[-1] - t[half], 1e-9)

    # -- correctness ------------------------------------------------------
    def sampled(self) -> Batch:
        return self._batch(self.sample)

    def _crops(self, batch: Batch, n=None) -> list:
        P = self.cfg["patch_size"]
        return [ref_vit.normalize_uint8(torch.from_numpy(
            batch.images[i, :gh * P, :gw * P].copy()).to(self.dev))
            for i, (gh, gw) in enumerate(batch.grids1[:n])]

    def reference_keys(self, fp8: bool = False, tf32: bool = False, rope: str = "own",
                       storage: bool = True, bucket_rope: bool = False, n=None) -> list:
        """The reference's keys of the sampled batch (its first `n` images),
        each image run alone at its cropped size (fp8: the control's; tf32:
        products in TF32; rope="none", storage=False, bucket_rope: the
        faults)."""
        batch = self.sampled()
        grids = [tuple(batch.bucket1)] * len(batch.grids1) if bucket_rope else None
        with tf32_enabled(tf32):
            return ref_dinov3.patch_keys(self.sd, self.cfg, self._crops(batch, n),
                                         ref_vit.Numerics(torch.float32, fp8=fp8), rope,
                                         storage, grids)

    def _per_image(self, k, batch: Batch) -> list:
        bh, bw = batch.bucket1
        return [ki.float().reshape(bh, bw, -1)[:gh, :gw].reshape(gh * gw, -1)
                for ki, (gh, gw) in zip(k, batch.grids1)]

    def port_keys(self) -> list:
        return self._per_image(self.keys, self.sampled())

    def port_keys_f32(self) -> list:
        """The port's keys of the sampled batch's first `F32_IMAGES` images
        from its modules rebuilt in f32 (after `release`), padded as the
        window ran them, attention on the 'einsum' route."""
        from deep_spectral_tpu_torch.models.vit import extract_patch_keys
        from deep_spectral_tpu_torch.utils.image_io import IMAGENET_SCALE, IMAGENET_SHIFT
        batch, n = self.sampled(), F32_IMAGES
        x = torch.from_numpy(batch.images[:n]).to(self.dev).float() \
            * torch.from_numpy(IMAGENET_SCALE).to(self.dev) \
            - torch.from_numpy(IMAGENET_SHIFT).to(self.dev)
        model = build_vit(self.vcfg, self.sd, self.dev, torch.float32, "einsum")
        k = extract_patch_keys(model, x, token_mask=torch.from_numpy(batch.masks1[:n]).to(self.dev),
                               grids=batch.grids1[:n])
        del model
        return self._per_image(k, batch)

    def stage2_features(self) -> list:
        """The fp16 features stage 2 was handed for the sampled batch, per
        image on its valid patches, in the order of `port_answers`."""
        out = []
        for f, (_, _, (h, w), _, _) in zip(self.stage2_inputs, self.sampled().groups):
            out += [torch.from_numpy(fi[:h, :w].reshape(h * w, -1)).to(self.dev) for fi in f]
        return out

    def port_answers(self) -> list:
        K, out = self.tr["K"], []
        for c in sorted(self.answers):
            (b2h, b2w), _, (h, w), _, _ = self.sampled().groups[c]
            evals, evecs = self.answers[c]
            for i in range(len(evals)):
                v = evecs[i].reshape(K, b2h, b2w)[:, :h, :w].reshape(K, h * w)
                out.append((torch.from_numpy(evals[i]), torch.from_numpy(v)))
        return out

    def numbers(self) -> dict:
        ref = self.reference_keys()
        out = {"keys_rel_err": checks.keys_gap(self.port_keys(), ref),
               "keys_f32_rel_err": checks.keys_gap(self.port_keys_f32(), ref[:F32_IMAGES])}
        with tf32_enabled(False):
            out.update(checks.eig_gaps(self.stage2_features(), self.port_answers(), self.tr["K"]))
        return out


def calibration_rows(runner: Runner) -> list[dict]:
    """The control's and the faults' numbers after a window and `release`:
    the reference with fp8 products (TF32 for the f32 check, which it
    judges on `F32_IMAGES` images) and the eigen control; the reference
    without RoPE, with RoPE over the bucket's grid (the sampled batch has
    an image smaller than its bucket: `Runner.sample`), without its storage
    tokens, each against the
    whole reference (`keys_rel_err` on the batch, `keys_f32_rel_err` on its
    first images); the port's keys x 1.1; the eigen faults."""
    from benchmark.calibrate import _eig_control, _eig_faults
    n, K = F32_IMAGES, runner.tr["K"]
    ref = runner.reference_keys()
    feats, answers = runner.stage2_features(), runner.port_answers()
    rows = [{"kind": "control", "numbers": {
        "keys_rel_err": checks.keys_gap(runner.reference_keys(fp8=True), ref),
        "keys_f32_rel_err": checks.keys_gap(runner.reference_keys(tf32=True, n=n), ref[:n]),
        **_eig_control(feats, K)}}]

    def fault(keys, whole):
        return {"keys_rel_err": checks.keys_gap(keys, whole),
                "keys_f32_rel_err": checks.keys_gap(keys[:n], whole[:n])}

    rows.append({"kind": "fault.no_rope", "numbers": fault(runner.reference_keys(rope="none"),
                                                           ref)})
    rows.append({"kind": "fault.bucket_grid_rope",
                 "numbers": fault(runner.reference_keys(bucket_rope=True), ref)})
    rows.append({"kind": "fault.no_storage",
                 "numbers": fault(runner.reference_keys(storage=False), ref)})
    port_k = runner.port_keys()
    port_k[0] = port_k[0] * 1.1
    rows.append({"kind": "fault.keys_altered",
                 "numbers": {"keys_rel_err": checks.keys_gap(port_k, ref)}})
    rows += [{"kind": f"fault.{k}", "numbers": v}
             for k, v in _eig_faults(feats, answers, K, runner.B2).items()]
    return rows
