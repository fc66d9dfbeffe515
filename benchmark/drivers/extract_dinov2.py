"""Driver `extract_dinov2`: the `extract` driver's closed loop, metrics and
check (`drivers/extract.py`) on a DINOv2 ViT with registers.

What differs from `extract`:
  * images are floor-cropped to whole patches before they are padded to
    stage 1's bucket, as `extract_features` crops them (480 -> 476 at P=14);
  * the weights are DINOv2's (`dinov2_shapes`: register tokens, the mask
    token, LayerScale gammas drawn as the `scale` kind, 1 + N(0, 0.02^2),
    the fused SwiGLU FFN's `mlp.w12` and `mlp.w3`), loaded into the port's
    model of the configuration's name with `load_state_dict`;
  * stage 1 hands the port each image's patch grid (the host's extents), so
    each image takes the positional embeddings of its own grid;
  * stage 1's work counts 1 + R prefix tokens an image, SwiGLU's three
    matrices (`vit_keys`, `block_flops`) and, of the last block, the qkv
    projection alone, on valid tokens;
  * `keys_rel_err` judges the port's keys against `reference/dinov2.py`,
    which runs each image alone at its cropped size, unpadded;
  * `keys_f32_rel_err` judges the same modules rebuilt in f32 after the
    window (kernel 1's f32 build on the card), on the sampled batch's first
    `F32_IMAGES` images with the window's masks and grids, against the same
    reference. Under random weights attention spreads nearly evenly over
    the 1 + R + h w tokens, so a model that left its registers out moves the
    keys by about what bf16 rounding does over 40 blocks; true f32 tells
    the two apart, so `correct` sees the model's structure as well as the
    timed stage's rounding.

A port without the configuration's model raises in set-up, before any
weight is drawn.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from benchmark import checks, features, stages, weights, work
from benchmark.drivers import extract as base
from benchmark.reference import dinov2 as ref_dinov2
from benchmark.reference import vit as ref_vit
from benchmark.reference.lowp import tf32_enabled

F32_IMAGES = 2
_PORT_FIELDS = (("patch_size", "patch_size"), ("embed_dim", "embed_dim"), ("depth", "depth"),
                ("num_heads", "num_heads"), ("mlp_ratio", "mlp_ratio"), ("img_size", "img_size"),
                ("num_registers", "num_register_tokens"), ("ffn", "ffn_layer"))


def dinov2_shapes(cfg: dict) -> dict:
    """name -> (shape, kind) of a DINOv2 ViT's parameters under DINOv2's
    names (kinds as `weights.vit_shapes`)."""
    D, P, depth = cfg["embed_dim"], cfg["patch_size"], cfg["depth"]
    R, hidden = cfg["num_register_tokens"], ref_dinov2.swiglu_hidden(D, cfg["mlp_ratio"])
    grid = cfg["img_size"] // P
    shapes = {"cls_token": ((1, 1, D), "small"),
              "register_tokens": ((1, R, D), "small"),
              "mask_token": ((1, D), "small"),
              "pos_embed": ((1, 1 + grid * grid, D), "small"),
              "patch_embed.proj.weight": ((D, 3, P, P), "weight"),
              "patch_embed.proj.bias": ((D,), "small")}
    for i in range(depth):
        b = f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            shapes[b + norm + ".weight"] = ((D,), "scale")
            shapes[b + norm + ".bias"] = ((D,), "small")
        for name, (out, inp) in (("attn.qkv", (3 * D, D)), ("attn.proj", (D, D)),
                                 ("mlp.w12", (2 * hidden, D)), ("mlp.w3", (D, hidden))):
            shapes[b + name + ".weight"] = ((out, inp), "weight")
            shapes[b + name + ".bias"] = ((out,), "small")
        shapes[b + "ls1.gamma"] = ((D,), "scale")
        shapes[b + "ls2.gamma"] = ((D,), "scale")
    shapes["norm.weight"] = ((D,), "scale")
    shapes["norm.bias"] = ((D,), "small")
    return shapes


def block_flops(t: int, cfg: dict) -> float:
    """One block over t tokens: qkv and proj (8 t D^2), the SwiGLU FFN's
    w12 and w3 (6 t D H) and the two attention products (4 t^2 D)."""
    D = cfg["embed_dim"]
    H = ref_dinov2.swiglu_hidden(D, cfg["mlp_ratio"])
    return 2.0 * t * (4 * D * D + 3 * D * H) + 4.0 * t * t * D


def vit_keys(n_patches: int, cfg: dict) -> float:
    """Stage 1 of one image with n valid patches and 1 + R prefix tokens:
    the patch embedding, depth - 1 whole blocks and the last block's qkv
    projection."""
    D = cfg["embed_dim"]
    t = n_patches + 1 + cfg["num_register_tokens"]
    return (work.patch_embed(n_patches, cfg["patch_size"], D)
            + (cfg["depth"] - 1) * block_flops(t, cfg) + 2.0 * t * D * 3 * D)


def port_config(cfg: dict):
    """The port's ViTConfig of `cfg["name"]`, checked field by field (raises
    where the port has no such model)."""
    from deep_spectral_tpu_torch.models.vit import get_model_config
    vcfg = get_model_config(cfg["name"])
    for port_key, key in _PORT_FIELDS:
        if getattr(vcfg, port_key) != cfg[key]:
            raise ValueError(f"{cfg['name']}: the port's {port_key} {getattr(vcfg, port_key)} "
                             f"is not the configuration's {key} {cfg[key]}")
    if vcfg.family != "dinov2":
        raise ValueError(f"{cfg['name']}: the port's family is {vcfg.family!r}, not 'dinov2'")
    return vcfg


def build_vit(vcfg, sd: dict, dev, dtype=torch.bfloat16):
    from deep_spectral_tpu_torch.models.vit import VisionTransformer
    with torch.device(dev):
        model = VisionTransformer(vcfg, dtype)
    model.load_state_dict(sd)
    return model.eval()


class Stage1(stages.Stage1):
    """`stages.Stage1` handing the port each image's patch grid."""

    def __init__(self, model, cfg: dict, dev, on_result, grids: np.ndarray):
        super().__init__(model, cfg, dev, on_result)
        self.grids = grids

    def submit(self, padded, masks_np, field, grid, buckets, tag, keep=False) -> None:
        from deep_spectral_tpu_torch.models.vit import extract_patch_keys
        from deep_spectral_tpu_torch.pipeline.extract import _Fetch, _to_device
        images = _to_device(padded, self.dev).float() * self.scale - self.shift
        masks = _to_device(masks_np, self.dev)
        call = partial(extract_patch_keys, self.model, images, which_block=-1,
                       token_mask=masks, grids=self.grids)
        if self.trace is None:
            k = call()
        else:
            with self.trace.span("vit"):
                k = call()
            self._count(masks_np, images.shape)
        if keep:
            self.keep_keys[tag] = k.clone()
        self.inflight.push(_Fetch(stages.mix(field, k, grid, *buckets)),
                           partial(self.on_result, tag))

    def _count(self, masks_np, shape):
        c = self.cfg
        B, H, W, _ = shape
        prefix = 1 + c["num_register_tokens"]
        T = prefix + (H // c["patch_size"]) * (W // c["patch_size"])
        keys = [prefix + int(n) for n in masks_np.sum(axis=1)]
        f, b = work.attention_fwd(keys, T, c["num_heads"], c["embed_dim"] // c["num_heads"], 2,
                                  masked=True)
        self.trace.add("attention", (c["depth"] - 1) * f, (c["depth"] - 1) * b)
        self.trace.add("model", sum(vit_keys(n - prefix, c) for n in keys))


class Runner(base.Runner):
    def __init__(self, cell, seed: int, dev):
        from deep_spectral_tpu_torch.utils import bucketing
        cfg, tr = cell.config, cell.traffic
        vcfg = port_config(cfg)
        self.cfg, self.vcfg, self.tr, self.seed, self.dev = cfg, vcfg, tr, seed, dev
        self.limits = cell.limits
        P, D = cfg["patch_size"], cfg["embed_dim"]
        H, W = tr["image_hw"]
        B, self.B2 = tr["batch_size"], tr["eig_batch_size"]
        self.grid = (H // P, W // P)
        b1 = bucketing.bucket_for(*self.grid, tr["stage1_granularity"])
        b2 = base.eig_bucket(*self.grid, tr["eig_granularity"])
        self.buckets = ((b1.h, b1.w), (b2.h, b2.w))
        rng = np.random.default_rng(tr["content_seed"])

        self.sd = weights.seeded_weights(dinov2_shapes(cfg), seed, dev)
        self.model = build_vit(vcfg, self.sd, dev)
        gen = torch.Generator(device=dev).manual_seed(tr["content_seed"])
        n_pool = tr["pool_batches"]
        imgs = torch.randint(0, 256, (n_pool * B, H, W, 3), generator=gen, dtype=torch.uint8,
                             device=dev).cpu().numpy()
        ch, cw = self.grid[0] * P, self.grid[1] * P
        self.images, self.masks1 = [], None
        for i in range(n_pool):
            padded, extents = bucketing.pad_batch_images(
                list(imgs[i * B:(i + 1) * B, :ch, :cw]), (b1.h * P, b1.w * P), B)
            self.images.append(padded)
            self.masks1 = bucketing.token_masks(extents, b1, P)
            self.grids1 = extents // P
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
        self.s1 = Stage1(self.model, cfg, dev, self._on_feats, self.grids1)
        self._warm()

    def reference_keys(self, fp8: bool = False, registers: bool = True,
                       tf32: bool = False) -> list:
        """The reference's keys of the sampled batch, each image run alone
        at its cropped size (fp8: the control's; registers=False: the
        reference without its register tokens; tf32: products in TF32)."""
        padded, _ = self.sample_inputs()
        P = self.cfg["patch_size"]
        h, w = self.grid
        x = ref_vit.normalize_uint8(torch.from_numpy(padded[:, :h * P, :w * P]).to(self.dev))
        with tf32_enabled(tf32):
            return ref_dinov2.patch_keys(self.sd, self.cfg, list(x),
                                         ref_vit.Numerics(torch.float32, fp8=fp8), registers)

    def port_keys_f32(self) -> list:
        """The port's keys of the sampled batch's first `F32_IMAGES` images
        from its modules rebuilt in f32 (after `release`), padded as the
        window ran them, per image on its valid patches."""
        from deep_spectral_tpu_torch.models.vit import extract_patch_keys
        from deep_spectral_tpu_torch.utils.image_io import IMAGENET_SCALE, IMAGENET_SHIFT
        padded, _ = self.sample_inputs()
        n = F32_IMAGES
        x = torch.from_numpy(padded[:n]).to(self.dev).float() \
            * torch.from_numpy(IMAGENET_SCALE).to(self.dev) \
            - torch.from_numpy(IMAGENET_SHIFT).to(self.dev)
        model = build_vit(self.vcfg, self.sd, self.dev, torch.float32)
        k = extract_patch_keys(model, x, token_mask=torch.from_numpy(self.masks1[:n]).to(self.dev),
                               grids=self.grids1[:n])
        del model
        (h, w), (bh, bw) = self.grid, self.buckets[0]
        return [ki.reshape(bh, bw, -1)[:h, :w].reshape(h * w, -1) for ki in k]

    def numbers(self) -> dict:
        ref = self.reference_keys()
        out = {"keys_rel_err": checks.keys_gap(self.port_keys(), ref),
               "keys_f32_rel_err": checks.keys_gap(self.port_keys_f32(), ref[:F32_IMAGES])}
        with tf32_enabled(False):
            out.update(checks.eig_gaps(self.stage2_features(), self.port_answers(), self.tr["K"]))
        return out
