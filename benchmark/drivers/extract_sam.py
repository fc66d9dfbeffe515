"""Driver `extract_sam`: the `extract_dinov3` driver's closed loop, metrics
and check on SAM's image encoder over COCO-shaped images at SAM's input.

What differs from `extract_dinov3`:
  * each image of the mix (`aspects` at `longer_side`: `eigs.image_grids`
    at patch 1) is handed to stage 1 as it is, uint8; on the card the port
    resizes it so that its longer side is `img_size`, normalizes it and pads
    it with zeros to img_size x img_size (`relpos.sam_preprocess`), so every
    stage-1 batch is one (g, g) input. An image's features are its resized
    size's patch grid (`sam_resized_size` // P), and stage 2 solves that
    grid in batches of `eig_batch_size` of one bucket, as `extract_eigs`
    buckets it, with the traffic's `solver`;
  * `stage1_plan` groups the images into stage-1 batches of whole stage-2
    batches of one grid each, grids mixed within a batch, the stage-1 bucket
    one (g, g) for all;
  * the weights are SAM's (`sam_shapes`: the positional embedding, each
    block's rel-pos tables, `mlp.lin1`/`lin2`, the neck), drawn one tensor
    at a time from the run's seed (`seeded_weights`); the rel-pos tables
    are drawn N(0, `rel_pos_sigma`^2) (the configuration's `assumed`);
  * stage 1's work counts SAM's forward as it runs it (`block_flops`,
    `vit_keys`): qkv, proj and attention over the padded windows, the MLP
    over the grid, the rel-pos products; kernel 1's work at 16 heads of 80
    over the windows (T = s^2 a window) and the global blocks (T = g^2),
    with the rel tables' bytes read (`attention_work`);
  * `keys_rel_err` judges the sampled batch's keys against
    `reference/sam.py`, each image alone from its uint8 image;
    `keys_f32_rel_err` the port's modules rebuilt in f32 after the window on
    the batch's first `F32_IMAGES` images, attention on the plain 'einsum'
    route (kernel 1 has no f32 build at head dim 80); the eigenpairs of
    every stage-2 batch the sampled batch made, as `extract`.

A port without the configuration's model raises in set-up, before any
weight is drawn. `calibration_rows` gives the control's and the faults'
readings for `limits/<workload>.json`.
"""
from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch

from benchmark import checks, features, stages, work
from benchmark.drivers import eigs
from benchmark.drivers import extract as base
from benchmark.drivers import extract_dinov3 as v3
from benchmark.reference import sam as ref_sam
from benchmark.reference.lowp import tf32_enabled
from benchmark.reference.vit import Numerics

F32_IMAGES = 2
NECK_CHANNELS = 256


def resized_grid(size: tuple, cfg: dict) -> tuple[int, int]:
    """An (H, W) image's features' patch grid at SAM's input."""
    h, w = ref_sam.resized_size(*size, cfg["img_size"])
    return h // cfg["patch_size"], w // cfg["patch_size"]


def sam_shapes(cfg: dict) -> dict:
    """name -> (shape, kind) of SAM's image encoder's parameters under SAM's
    names (kinds as `weights.vit_shapes`, and 'relpos' for the rel-pos
    tables)."""
    D, P, depth = cfg["embed_dim"], cfg["patch_size"], cfg["depth"]
    g, hd, C = cfg["img_size"] // P, D // cfg["num_heads"], NECK_CHANNELS
    shapes = {"patch_embed.proj.weight": ((D, 3, P, P), "weight"),
              "patch_embed.proj.bias": ((D,), "small"),
              "pos_embed": ((1, g, g, D), "small")}
    for i in range(depth):
        b = f"blocks.{i}."
        s = g if i in cfg["global_attn_indexes"] else cfg["window_size"]
        for norm in ("norm1", "norm2"):
            shapes[b + norm + ".weight"] = ((D,), "scale")
            shapes[b + norm + ".bias"] = ((D,), "small")
        for name, (out, inp) in (("attn.qkv", (3 * D, D)), ("attn.proj", (D, D)),
                                 ("mlp.lin1", (cfg["mlp_dim"], D)),
                                 ("mlp.lin2", (D, cfg["mlp_dim"]))):
            shapes[b + name + ".weight"] = ((out, inp), "weight")
            shapes[b + name + ".bias"] = ((out,), "small")
        shapes[b + "attn.rel_pos_h"] = ((2 * s - 1, hd), "relpos")
        shapes[b + "attn.rel_pos_w"] = ((2 * s - 1, hd), "relpos")
    shapes["neck.0.weight"] = ((C, D, 1, 1), "weight")
    shapes["neck.1.weight"] = ((C,), "scale")
    shapes["neck.1.bias"] = ((C,), "small")
    shapes["neck.2.weight"] = ((C, C, 3, 3), "weight")
    shapes["neck.3.weight"] = ((C,), "scale")
    shapes["neck.3.bias"] = ((C,), "small")
    return shapes


@torch.no_grad()
def seeded_weights(cfg: dict, seed: int, device) -> dict:
    """name -> f32 tensor on `device`: each entry of `sam_shapes` drawn in
    turn from one generator on `device` seeded with `seed`, scaled in place
    by kind as `weights.seeded_weights` scales it, the rel-pos tables by
    `rel_pos_sigma`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, (shape, kind) in sam_shapes(cfg).items():
        x = torch.randn(shape, generator=gen, device=device)
        if kind == "weight":
            x.mul_(1.0 / math.sqrt(math.prod(shape) // shape[0]))
        elif kind == "small":
            x.mul_(0.02)
        elif kind == "relpos":
            x.mul_(cfg["rel_pos_sigma"])
        else:                                     # "scale"
            x.mul_(0.02).add_(1.0)
        out[name] = x
    return out


def port_config(cfg: dict):
    """The port's ViTConfig of `cfg["name"]`, checked field by field (raises
    where the port has no such model)."""
    from deep_spectral_tpu_torch.models.vit import get_model_config
    vcfg = get_model_config(cfg["name"])
    want = {"family": "sam", "patch_size": cfg["patch_size"], "embed_dim": cfg["embed_dim"],
            "depth": cfg["depth"], "num_heads": cfg["num_heads"],
            "mlp_ratio": cfg["mlp_dim"] / cfg["embed_dim"], "img_size": cfg["img_size"],
            "window_size": cfg["window_size"],
            "global_blocks": tuple(cfg["global_attn_indexes"]),
            "norm_eps": cfg["layer_norm_eps"]}
    for key, value in want.items():
        if getattr(vcfg, key) != value:
            raise ValueError(f"{cfg['name']}: the port's {key} {getattr(vcfg, key)} is not "
                             f"the configuration's {value}")
    return vcfg


def block_flops(cfg: dict, window: bool) -> float:
    """One block over one image as SAM runs it: qkv and proj over the
    tokens attended (a window block's padded windows: n^2 s^2 tokens, n =
    ceil(g / s)), the MLP over the g^2 grid tokens, the two attention
    products (4 T^2 D a window or the grid) and the rel-pos products (2 T D
    2s over the tokens attended)."""
    D, g = cfg["embed_dim"], cfg["img_size"] // cfg["patch_size"]
    s = cfg["window_size"] if window else g
    n = -(-g // s) if window else 1
    t = n * n * s * s
    return (2.0 * t * D * 4 * D + 2.0 * g * g * D * 2 * cfg["mlp_dim"]
            + n * n * 4.0 * (s * s) ** 2 * D + 2.0 * t * D * 2 * s)


def vit_keys(cfg: dict) -> float:
    """Stage 1 of one image: the patch embedding, the blocks before the
    keys' block, and that block's qkv projection over the grid."""
    D, g = cfg["embed_dim"], cfg["img_size"] // cfg["patch_size"]
    last = cfg["depth"] - 1
    blocks = sum(block_flops(cfg, i not in cfg["global_attn_indexes"]) for i in range(last))
    return work.patch_embed(g * g, cfg["patch_size"], D) + blocks + 2.0 * g * g * D * 3 * D


def attention_work(cfg: dict, images: int) -> tuple[float, float]:
    """(flops, bytes) of kernel 1 over `images` images' blocks before the
    keys' block: each window block's n^2 windows of s^2 tokens and each
    global block's g^2, 16 heads of 80 in bf16, q/k/v/out (`work.
    attention_fwd`) and the rel_h and rel_w tables (T x 2s a head, bf16)."""
    D, H, g = cfg["embed_dim"], cfg["num_heads"], cfg["img_size"] // cfg["patch_size"]
    hd = D // H
    flops = nbytes = 0.0
    for i in range(cfg["depth"] - 1):
        window = i not in cfg["global_attn_indexes"]
        s = cfg["window_size"] if window else g
        n = -(-g // s) if window else 1
        f, b = work.attention_fwd([s * s] * (images * n * n), s * s, H, hd, 2)
        flops += f
        nbytes += b + images * n * n * s * s * H * 2 * s * 2
    return flops, nbytes


def stage1_plan(grids: list, order, B: int, B2: int) -> list:
    """`extract_dinov3.stage1_plan` with every image in one stage-1 bucket:
    [(bucket, [[image index, ...] one stage-2 batch of B2 of one grid,
    ...]), ...]."""
    return v3.stage1_plan(grids, order, B, B2, max(max(g) for g in grids))


class Batch:
    """One stage-1 batch of the pool: its uint8 images padded to the batch's
    largest (`images`, sizes in `sizes`), each image's resized grid, and its
    stage-2 batches (bucket, rows, grid, fields, masks)."""

    def __init__(self, runs, sizes, grids, imgs, cfg, tr, rng, dev):
        from deep_spectral_tpu_torch.utils import bucketing
        g = cfg["img_size"] // cfg["patch_size"]
        order = [i for run in runs for i in run]
        hw = np.array([sizes[i] for i in order])
        self.bucket1 = (g, g)
        self.images, self.sizes = bucketing.pad_batch_images(
            [imgs[i] for i in order], tuple(hw.max(axis=0)), len(order))
        self.grids1 = np.array([grids[i] for i in order])
        self.groups = []
        for r, run in enumerate(runs):
            h, w = grids[run[0]]
            b2 = base.eig_bucket(h, w, tr["eig_granularity"])
            field = features.structured_field(
                [features.field_draws(rng, h, w, cfg["embed_dim"]) for _ in run], h, w, dev)
            masks2 = bucketing.grid_masks(np.tile([h, w], (len(run), 1)), (b2.h, b2.w))
            rows = list(range(r * len(run), (r + 1) * len(run)))
            self.groups.append(((b2.h, b2.w), rows, (h, w), field, masks2))


class Stage1(stages.Stage1):
    """`stages.Stage1` handing the port each batch's uint8 images, which it
    preprocesses on the card, and mixing each stage-2 batch in its bucket."""

    def submit(self, batch: Batch, tag, keep: bool = False) -> None:
        from deep_spectral_tpu_torch.models.relpos import sam_preprocess
        from deep_spectral_tpu_torch.models.vit import extract_patch_keys
        from deep_spectral_tpu_torch.pipeline.extract import _Fetch, _to_device

        def call():
            images = sam_preprocess(_to_device(batch.images, self.dev), batch.sizes,
                                    self.cfg["img_size"])
            return extract_patch_keys(self.model, images, which_block=-1)

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
        n = len(batch.grids1)
        self.trace.add("attention", *attention_work(self.cfg, n))
        self.trace.add("model", n * vit_keys(self.cfg))


class Stage2(stages.Stage2):
    """`stages.Stage2` with the traffic's solver."""

    def __init__(self, dev, K: int, batch_size: int, on_result, solver: str):
        super().__init__(dev, K, batch_size, on_result)
        self.kw["solver"] = solver


class Runner(v3.Runner):
    def __init__(self, cell, seed: int, dev):
        cfg, tr = cell.config, cell.traffic
        vcfg = port_config(cfg)
        self.cfg, self.vcfg, self.tr, self.seed, self.dev = cfg, vcfg, tr, seed, dev
        self.limits = cell.limits
        self.B2 = tr["eig_batch_size"]
        rng = np.random.default_rng(tr["content_seed"])
        sizes = eigs.image_grids(tr, 1)
        grids = [resized_grid(s, cfg) for s in sizes]
        plan = stage1_plan(grids, rng.permutation(len(grids)), tr["batch_size"], self.B2)
        plan = [plan[i] for i in rng.permutation(len(plan))]

        self.sd = seeded_weights(cfg, seed, dev)
        self.model = v3.build_vit(vcfg, self.sd, dev)
        gen = torch.Generator(device=dev).manual_seed(tr["content_seed"])
        imgs = [torch.randint(0, 256, (h, w, 3), generator=gen, dtype=torch.uint8,
                              device=dev).cpu().numpy() for h, w in sizes]
        self.pool = [Batch(runs, sizes, grids, imgs, cfg, tr, rng, dev) for _, runs in plan]
        self.order = np.roll(np.arange(len(self.pool)), seed % len(self.pool))
        self.check_rng = np.random.default_rng([seed, 1])

        self.j = 0
        self.starts, self.left, self.done, self.arrivals = {}, {}, [], []
        self.failed, self.sample, self.answers, self.stage2_inputs = 0, None, {}, None
        self.s2 = Stage2(dev, tr["K"], self.B2, self._on_eigs, tr["solver"])
        self.s1 = Stage1(self.model, cfg, dev, self._on_feats)
        self._warm()

    def _fills(self, j: int) -> bool:
        """Every batch is judged as the window samples it: each is SAM's
        padded input whatever its images' sizes."""
        return False

    # -- correctness ------------------------------------------------------
    def _uint8(self, batch: Batch, n=None) -> list:
        return [torch.from_numpy(batch.images[i, :h, :w].copy()).to(self.dev)
                for i, (h, w) in enumerate(batch.sizes[:n])]

    def reference_keys(self, fp8: bool = False, tf32: bool = False, n=None, **faults) -> list:
        """The reference's keys of the sampled batch (its first `n` images),
        each image run alone from its uint8 image (fp8: the control's; tf32:
        products in TF32; `faults`: `reference/sam.py`'s)."""
        with tf32_enabled(tf32):
            return ref_sam.patch_keys(self.sd, self.cfg, self._uint8(self.sampled(), n),
                                      Numerics(torch.float32, fp8=fp8), **faults)

    def _per_image(self, k, batch: Batch) -> list:
        g = batch.bucket1[0]
        return [ki.float().reshape(g, g, -1)[:gh, :gw].reshape(gh * gw, -1)
                for ki, (gh, gw) in zip(k, batch.grids1)]

    def port_keys_f32(self) -> list:
        """The port's keys of the sampled batch's first `F32_IMAGES` images
        from its modules rebuilt in f32 (after `release`), attention on the
        'einsum' route."""
        from deep_spectral_tpu_torch.models.relpos import sam_preprocess
        from deep_spectral_tpu_torch.models.vit import extract_patch_keys
        batch, n = self.sampled(), F32_IMAGES
        x = sam_preprocess(torch.from_numpy(batch.images[:n]).to(self.dev), batch.sizes[:n],
                           self.cfg["img_size"])
        model = v3.build_vit(self.vcfg, self.sd, self.dev, torch.float32, "einsum")
        k = extract_patch_keys(model, x)
        del model
        return self._per_image(k, batch)


FAULTS = {"no_relpos": {"rel": False}, "padded_keys_masked": {"mask_pad": True},
          "relpos_from_scaled_q": {"scaled_rel": True}}


def calibration_rows(runner: Runner) -> list[dict]:
    """The control's and the faults' numbers after a window and `release`:
    the reference with fp8 products (TF32 for the f32 check, which it
    judges on `F32_IMAGES` images) and the eigen control; the reference
    without the rel-pos bias, with the padded window tokens masked as keys,
    with the rel terms built from the scaled q (`FAULTS`), each against the
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
    for name, fault in FAULTS.items():
        keys = runner.reference_keys(**fault)
        rows.append({"kind": f"fault.{name}", "numbers": {
            "keys_rel_err": checks.keys_gap(keys, ref),
            "keys_f32_rel_err": checks.keys_gap(keys[:n], ref[:n])}})
    port_k = runner.port_keys()
    port_k[0] = port_k[0] * 1.1
    rows.append({"kind": "fault.keys_altered",
                 "numbers": {"keys_rel_err": checks.keys_gap(port_k, ref)}})
    rows += [{"kind": f"fault.{k}", "numbers": v}
             for k, v in _eig_faults(feats, answers, K, runner.B2).items()]
    return rows
