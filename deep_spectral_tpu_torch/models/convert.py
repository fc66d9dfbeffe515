"""Weights for the port's ViT: DINO checkpoints, the JAX package's params, or
a seeded random init.

The reference loads its backbone with `torch.hub.load('facebookresearch/dino:main',
name)` (extract/extract_utils.py:40-50). There is no network here, so a local
DINO state dict is used when one is found (`ckpt_dir`, or
`$DSS_TPU_DINO_CKPT_DIR/<model_name>.pth`, the JAX package's lookup, or the
published file name of a DINOv2 or DINOv3 model, `CHECKPOINT_FILES`); since
the port keeps DINO's, DINOv2's and DINOv3's parameter names it loads that
file as it is (`load_dino_state_dict`). Without a
checkpoint the weights are a seeded random init from a `torch.Generator`
(different numbers from the JAX package's flax init of the same seed).
`flax_to_torch_state_dict` carries the JAX package's ViT params over, and
`flax_deeplab_to_torch_state_dict` a whole `DeepLabViT` (params and
batch_stats), `flax_resnet_to_torch_state_dict` and
`flax_vgg16_to_torch_state_dict` the JAX package's ResNet-50 and VGG-16
trunks, so both packages can run identical weights.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .vit import LayerScale, ViTConfig, VisionTransformer, get_model_config

# Published checkpoint files whose names are not `<model_name>.pth`
# (facebookresearch/dinov2's and dinov3's downloads; a glob where the name
# carries a hash).
CHECKPOINT_FILES = {"dinov2_vitg14_reg": "dinov2_vitg14_reg4_pretrain.pth",
                    "dinov3_vit7b16": "dinov3_vit7b16_pretrain_lvd1689m*.pth",
                    "sam_vit_h": "sam_vit_h_4b8939.pth"}
# Training-only entries of a DINOv3 checkpoint: the local crops' CLS norm.
DINOV3_TRAINING_ONLY = ("local_cls_norm.",)
# The prefix of a SAM checkpoint's image encoder (its prompt encoder and mask
# decoder are not the backbone).
SAM_ENCODER = "image_encoder."


def flax_to_torch_state_dict(params: dict, cfg: ViTConfig) -> dict:
    """Map the JAX package's `VisionTransformer` params (a flax tree of numpy
    or jax arrays, with or without the outer 'params' key) to a DINO-named
    torch state dict. Inverts
    `deep_spectral_tpu.models.convert.convert_dino_torch_checkpoint`."""
    p = params.get("params", params)

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd = {
        "cls_token": t(p["cls_token"]),
        "pos_embed": t(p["pos_embed"]),
        # flax Conv (P, P, 3, D) -> torch Conv2d (D, 3, P, P)
        "patch_embed.proj.weight": t(p["patch_embed"]["kernel"]).permute(3, 2, 0, 1).contiguous(),
        "patch_embed.proj.bias": t(p["patch_embed"]["bias"]),
        "norm.weight": t(p["norm"]["scale"]),
        "norm.bias": t(p["norm"]["bias"]),
    }
    for i in range(cfg.depth):
        blk, b = p[f"blocks_{i}"], f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            sd[b + norm + ".weight"] = t(blk[norm]["scale"])
            sd[b + norm + ".bias"] = t(blk[norm]["bias"])
        for parent, name in (("attn", "qkv"), ("attn", "proj"),
                             ("mlp", "fc1"), ("mlp", "fc2")):
            # flax Dense kernel (in, out) -> torch Linear (out, in)
            sd[f"{b}{parent}.{name}.weight"] = t(blk[parent][name]["kernel"]).T.contiguous()
            sd[f"{b}{parent}.{name}.bias"] = t(blk[parent][name]["bias"])
    return sd


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _hwio_to_oihw(x) -> torch.Tensor:
    return _t(x).permute(3, 2, 0, 1).contiguous()


def _conv_bn(p: dict, stats: dict, prefix: str) -> dict:
    """A flax ConvBNReLU's Conv_0 / BatchNorm_0 under torch names."""
    return {prefix + "conv.weight": _hwio_to_oihw(p["Conv_0"]["kernel"]),
            prefix + "bn.scale": _t(p["BatchNorm_0"]["scale"]),
            prefix + "bn.bias": _t(p["BatchNorm_0"]["bias"]),
            prefix + "bn.mean": _t(stats["BatchNorm_0"]["mean"]),
            prefix + "bn.var": _t(stats["BatchNorm_0"]["var"])}


def flax_deeplab_to_torch_state_dict(params: dict, batch_stats: dict,
                                     vit_cfg: ViTConfig,
                                     head: str = "deeplabv3plus") -> dict:
    """Map the JAX package's `DeepLabViT` variables (params and batch_stats,
    with or without their outer collection keys) to the port's
    `DeepLabViT` state dict. flax's auto-names map as
      head/ConvBNReLU_0 (v3+ low-level)     -> head.low
      head/ASPP_0/ConvBNReLU_{0..3}         -> head.aspp.convs.{0..3}
      head/ASPP_0/ConvBNReLU_4 (pooling)    -> head.aspp.pool
      head/ASPP_0/ConvBNReLU_5 (projection) -> head.aspp.project
      head/ConvBNReLU_{1 (v3+), 0 (v3)}     -> head.fuse
      head/Conv_0                           -> head.classifier
    with conv kernels HWIO -> OIHW."""
    p = params.get("params", params)
    st = batch_stats.get("batch_stats", batch_stats)
    sd = {f"backbone.{k}": v for k, v in flax_to_torch_state_dict(p["backbone"], vit_cfg).items()}
    sd.update(_flax_head(p["head"], st["head"], head))
    return sd


def flax_deeplab_resnet_to_torch_state_dict(params: dict, batch_stats: dict,
                                            head: str = "deeplabv3plus") -> dict:
    """Map the JAX package's `DeepLabResNet` variables to the port's
    `DeepLabResNet` state dict: the backbone as
    `flax_resnet_to_torch_state_dict`, the head as in
    `flax_deeplab_to_torch_state_dict`."""
    p = params.get("params", params)
    st = batch_stats.get("batch_stats", batch_stats)
    sd = {f"backbone.{k}": v
          for k, v in flax_resnet_to_torch_state_dict(p["backbone"], st["backbone"]).items()}
    sd.update(_flax_head(p["head"], st["head"], head))
    return sd


def _flax_head(ph: dict, sh: dict, head: str) -> dict:
    """A flax DeepLab head's params and batch_stats under the port's names."""
    sd = {}
    aspp, aspp_st = ph["ASPP_0"], sh["ASPP_0"]
    for i in range(4):
        sd.update(_conv_bn(aspp[f"ConvBNReLU_{i}"], aspp_st[f"ConvBNReLU_{i}"],
                           f"head.aspp.convs.{i}."))
    sd.update(_conv_bn(aspp["ConvBNReLU_4"], aspp_st["ConvBNReLU_4"], "head.aspp.pool."))
    sd.update(_conv_bn(aspp["ConvBNReLU_5"], aspp_st["ConvBNReLU_5"], "head.aspp.project."))
    fuse = "ConvBNReLU_1" if head == "deeplabv3plus" else "ConvBNReLU_0"
    if head == "deeplabv3plus":
        sd.update(_conv_bn(ph["ConvBNReLU_0"], sh["ConvBNReLU_0"], "head.low."))
    sd.update(_conv_bn(ph[fuse], sh[fuse], "head.fuse."))
    sd["head.classifier.weight"] = _hwio_to_oihw(ph["Conv_0"]["kernel"])
    sd["head.classifier.bias"] = _t(ph["Conv_0"]["bias"])
    return sd


def _flax_bn(p: dict, stats: dict, prefix: str) -> dict:
    """A flax BatchNorm's scale/bias and mean/var under torchvision's names."""
    return {prefix + "weight": _t(p["scale"]), prefix + "bias": _t(p["bias"]),
            prefix + "running_mean": _t(stats["mean"]),
            prefix + "running_var": _t(stats["var"])}


def flax_resnet_to_torch_state_dict(params: dict, batch_stats: dict) -> dict:
    """Map the JAX package's `ResNet50` variables (params and batch_stats,
    with or without their outer collection keys) to the port's `ResNet50`
    state dict, whose names are torchvision's:
      conv1 / bn1                        -> conv1 / bn1
      layer{L}_{B}/conv{i}, bn{i}        -> layer{L}.{B}.conv{i}, bn{i}
      layer{L}_{B}/down_conv, down_bn    -> layer{L}.{B}.downsample.0, .1
    with conv kernels HWIO -> OIHW. Inverts
    `deep_spectral_tpu.models.resnet.convert_torchvision_resnet50`."""
    p = params.get("params", params)
    st = batch_stats.get("batch_stats", batch_stats)
    sd = {"conv1.weight": _hwio_to_oihw(p["conv1"]["kernel"]),
          **_flax_bn(p["bn1"], st["bn1"], "bn1.")}
    for li, n_blocks in enumerate((3, 4, 6, 3), start=1):
        for bi in range(n_blocks):
            src, dst = f"layer{li}_{bi}", f"layer{li}.{bi}."
            bp, bs = p[src], st[src]
            for ci in (1, 2, 3):
                sd[f"{dst}conv{ci}.weight"] = _hwio_to_oihw(bp[f"conv{ci}"]["kernel"])
                sd.update(_flax_bn(bp[f"bn{ci}"], bs[f"bn{ci}"], f"{dst}bn{ci}."))
            if "down_conv" in bp:
                sd[f"{dst}downsample.0.weight"] = _hwio_to_oihw(bp["down_conv"]["kernel"])
                sd.update(_flax_bn(bp["down_bn"], bs["down_bn"], f"{dst}downsample.1."))
    return sd


def flax_vgg16_to_torch_state_dict(params: dict) -> dict:
    """Map the JAX package's `VGG16Features` params (conv{stage}_{i}) to the
    port's, laid out as torchvision's vgg16 `features.<index>`."""
    from .resnet import _VGG16_STAGES
    p = params.get("params", params)
    sd, index = {}, 0
    for si, (_, n_convs) in enumerate(_VGG16_STAGES, start=1):
        for ci in range(1, n_convs + 1):
            conv = p[f"conv{si}_{ci}"]
            sd[f"features.{index}.weight"] = _hwio_to_oihw(conv["kernel"])
            sd[f"features.{index}.bias"] = _t(conv["bias"])
            index += 2                     # the conv and its ReLU
        index += 1                         # the stage's max-pool
    return sd


def find_local_checkpoint(model_name: str,
                          ckpt_dir: Optional[str] = None) -> Optional[Path]:
    """Look for `<model_name>.pth` (or the published file name,
    `CHECKPOINT_FILES`) under `ckpt_dir` or $DSS_TPU_DINO_CKPT_DIR."""
    roots = []
    if ckpt_dir:
        roots.append(Path(ckpt_dir))
    env = os.environ.get("DSS_TPU_DINO_CKPT_DIR")
    if env:
        roots.append(Path(env))
    names = [f"{model_name}.pth", f"{model_name}.pt"]
    if model_name in CHECKPOINT_FILES:
        names.append(CHECKPOINT_FILES[model_name])
    for root in roots:
        for name in names:
            for cand in sorted(root.glob(name)):
                if cand.is_file():
                    return cand
    return None


def load_dino_state_dict(path: str | Path) -> dict:
    """A DINO, DINOv2, DINOv3 or SAM checkpoint's backbone state dict:
    unwraps 'state_dict', strips DDP's 'module.' prefix and drops the
    projection head and DINOv3's training-only entries (a DINOv2 or DINOv3
    file is the backbone's own state dict under the port's names:
    `mask_token`, `register_tokens` or `storage_tokens`,
    `rope_embed.periods`, `ls1.gamma`, `mlp.w12` or `mlp.w1`/`w2`/`w3`); a
    SAM checkpoint gives its image encoder (`sam_encoder_state_dict`)."""
    sd = torch.load(str(path), map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    if any(k.startswith(SAM_ENCODER) for k in sd):
        return sam_encoder_state_dict(sd)
    return {k: v for k, v in sd.items()
            if not k.startswith(("head.", *DINOV3_TRAINING_ONLY))}


def sam_encoder_state_dict(sd: dict) -> dict:
    """The port's SAM state dict of a SAM checkpoint's (`sam_vit_h_4b8939.pth`,
    `Sam.state_dict()`): the `image_encoder.` entries with the prefix
    stripped. The port keeps the encoder's own names (`patch_embed.proj`,
    `pos_embed`, `blocks.{i}.norm1`, `attn.qkv`, `attn.proj`,
    `attn.rel_pos_h`, `attn.rel_pos_w`, `norm2`, `mlp.lin1`, `mlp.lin2`,
    `neck.0`-`neck.3`); the prompt encoder and the mask decoder are left out."""
    return {k.removeprefix(SAM_ENCODER): v for k, v in sd.items() if k.startswith(SAM_ENCODER)}


@torch.no_grad()
def random_init_(model: VisionTransformer, seed: int = 0) -> VisionTransformer:
    """Seeded random weights: linear and conv weights ~ N(0, 1/fan_in)
    (flax's lecun-normal scale), zero biases and CLS token, pos_embed ~
    N(0, 0.02^2), LayerNorms at identity; DINOv2's LayerScales at 1 (the
    hub's init_values), register tokens ~ N(0, 0.02^2), its mask token 0;
    DINOv3's LayerScales at 1e-5 (the hub's layerscale_init), storage tokens
    ~ N(0, 0.02^2), its mask token 0 (RoPE's periods are the model's); SAM's
    relative-position tables at 0 (its rel_pos_zero_init), its LayerNorm2d
    at identity, no CLS."""
    g = torch.Generator().manual_seed(seed)
    family = model.cfg.family
    for module in model.modules():
        if isinstance(module, (torch.nn.Linear, torch.nn.Conv2d)):
            fan_in = module.weight[0].numel()
            module.weight.copy_(torch.randn(module.weight.shape, generator=g)
                                / fan_in ** 0.5)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, torch.nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, LayerScale):
            module.gamma.fill_(1e-5 if family == "dinov3" else 1.0)
    if family == "sam":
        model.pos_embed.copy_(torch.randn(model.pos_embed.shape, generator=g) * 0.02)
        for blk in model.blocks:
            blk.attn.rel_pos_h.zero_()
            blk.attn.rel_pos_w.zero_()
        return model
    model.cls_token.zero_()
    if family == "dinov3":
        model.storage_tokens.copy_(torch.randn(model.storage_tokens.shape, generator=g) * 0.02)
    else:
        model.pos_embed.copy_(torch.randn(model.pos_embed.shape, generator=g) * 0.02)
        if model.cfg.num_registers:
            model.register_tokens.copy_(torch.randn(model.register_tokens.shape,
                                                    generator=g) * 0.02)
    if family != "dino":
        model.mask_token.zero_()
    return model


def load_model(model_name: str, ckpt_dir: Optional[str] = None, seed: int = 0,
               precision: str = "fp32",
               device: str | torch.device | None = None) -> VisionTransformer:
    """The ViT for `model_name` on `device` (CUDA unless the caller asks for
    the CPU; a CUDA device with no card raises RuntimeError), in eval mode:
    the local DINO checkpoint when one is found, a seeded random init
    otherwise. precision='bf16' sets the compute dtype to bfloat16 (params
    stay f32; LayerNorm and softmax statistics stay f32); 'fp32' runs true
    f32."""
    device = resolve_device(device, "load_model")
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"precision must be 'fp32' or 'bf16'; got {precision!r}")
    cfg = get_model_config(model_name)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    model = VisionTransformer(cfg, dtype)
    path = find_local_checkpoint(model_name, ckpt_dir)
    if path is None:
        random_init_(model, seed)
    else:
        model.load_state_dict(load_dino_state_dict(path))
    return model.to(device).eval()
