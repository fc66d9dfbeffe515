"""Plain DINO ViT forward (Caron et al. 2021; facebookresearch/dino's
`vision_transformer.py`): patch embedding, CLS token, positional embeddings
resampled bicubically to the patch grid, pre-norm blocks (LayerNorm eps
1e-6, multi-head softmax attention, GELU MLP), a final LayerNorm.

Departures, each what the benchmarked stage computes: images are NHWC;
keys of padded patches are masked out of every attention (a bucket-padded
batch); positional embeddings are resampled to an exact output size.

`dtype` is the arithmetic (f32 with TF32 off, or f64); `fp8=True` is the
control: every product's inputs rounded to fp8 (`lowp.fp8`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .lowp import fp8 as _fp8


class Numerics:
    def __init__(self, dtype: torch.dtype = torch.float32, fp8: bool = False):
        self.dtype, self.fp8 = dtype, fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, in this arithmetic."""
        x = x.to(self.dtype)
        return _fp8(x) if self.fp8 else x

    def linear(self, x, w, b):
        return F.linear(self.q(x), self.q(w), b.to(self.dtype))


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_uint8(images: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> ImageNet-normalized `dtype`."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=dtype, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=dtype, device=images.device)
    return (images.to(dtype) / 255.0 - mean) / std


def layer_norm(x, sd, prefix, eps=1e-6):
    return F.layer_norm(x, x.shape[-1:], sd[prefix + ".weight"].to(x.dtype),
                        sd[prefix + ".bias"].to(x.dtype), eps)


def embed(sd: dict, cfg: dict, images: torch.Tensor, num: Numerics) -> torch.Tensor:
    """(B, 1 + h * w, D) tokens of normalized (B, H, W, 3) images."""
    P = cfg["patch_size"]
    B, H, W, _ = images.shape
    h, w = H // P, W // P
    x = F.conv2d(num.q(images.permute(0, 3, 1, 2)), num.q(sd["patch_embed.proj.weight"]),
                 sd["patch_embed.proj.bias"].to(num.dtype), stride=P)
    x = x.flatten(2).transpose(1, 2)
    pos = sd["pos_embed"].to(num.dtype)
    grid = cfg["img_size"] // P
    if (h, w) != (grid, grid):
        patch = pos[:, 1:].reshape(1, grid, grid, -1).permute(0, 3, 1, 2)
        patch = F.interpolate(patch, size=(h, w), mode="bicubic", align_corners=False)
        pos = torch.cat([pos[:, :1], patch.permute(0, 2, 3, 1).reshape(1, h * w, -1)], 1)
    cls = sd["cls_token"].to(num.dtype).expand(B, -1, -1)
    return torch.cat([cls, x], dim=1) + pos


def qkv(sd, prefix, x, cfg, num):
    """(B, T, 3, heads, hd) projection of the block's normed input."""
    B, T, D = x.shape
    y = num.linear(layer_norm(x, sd, prefix + ".norm1"), sd[prefix + ".attn.qkv.weight"],
                   sd[prefix + ".attn.qkv.bias"])
    return y.reshape(B, T, 3, cfg["num_heads"], D // cfg["num_heads"])


def block(sd, i, x, cfg, num, key_mask: Optional[torch.Tensor] = None):
    """Block i over tokens x (B, T, D); key_mask (B, T) bool or None."""
    p = f"blocks.{i}"
    B, T, D = x.shape
    q, k, v = qkv(sd, p, x, cfg, num).unbind(2)
    s = torch.einsum("bthd,bshd->bhts", num.q(q), num.q(k)) / math.sqrt(D // cfg["num_heads"])
    if key_mask is not None:
        s = s.masked_fill(~key_mask[:, None, None, :], -math.inf)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", num.q(a), num.q(v)).reshape(B, T, D)
    x = x + num.linear(o, sd[p + ".attn.proj.weight"], sd[p + ".attn.proj.bias"])
    h = num.linear(layer_norm(x, sd, p + ".norm2"), sd[p + ".mlp.fc1.weight"],
                   sd[p + ".mlp.fc1.bias"])
    return x + num.linear(F.gelu(h), sd[p + ".mlp.fc2.weight"], sd[p + ".mlp.fc2.bias"])


@torch.no_grad()
def patch_keys(sd: dict, cfg: dict, images: torch.Tensor, key_mask: Optional[torch.Tensor],
               num: Numerics, chunk: int = 4) -> torch.Tensor:
    """Stage 1's features: the last block's keys, heads merged, CLS dropped,
    of normalized images (B, H, W, 3); key_mask (B, h * w) marks valid
    patches. Runs `chunk` images at a time. Returns (B, h * w, D) f32."""
    out = []
    for i in range(0, images.shape[0], chunk):
        x = embed(sd, cfg, images[i:i + chunk], num)
        m = None
        if key_mask is not None:
            mk = key_mask[i:i + chunk]
            m = torch.cat([torch.ones_like(mk[:, :1]), mk], dim=1)
        for b in range(cfg["depth"] - 1):
            x = block(sd, b, x, cfg, num, m)
        k = qkv(sd, f"blocks.{cfg['depth'] - 1}", x, cfg, num)[:, 1:, 1]
        out.append(k.reshape(k.shape[0], k.shape[1], -1).float())
    return torch.cat(out)
