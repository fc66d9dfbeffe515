"""Plain DINOv2 ViT forward with registers (Oquab et al. 2023; Darcet et al.
2023; facebookresearch/dinov2's `vision_transformer.py`, `layers/block.py`,
`layers/layer_scale.py`, `layers/swiglu_ffn.py`), as the hub builds
`dinov2_vitg14_reg`: patch embedding, CLS token, positional embeddings
resampled by torch's antialiased bicubic to an exact output size
(`interpolate_antialias=True`, `interpolate_offset=0`) and added to CLS and
the patches, then the register tokens inserted after CLS with no positional
embedding; pre-norm blocks (LayerNorm eps 1e-6, multi-head softmax
attention at scale hd^-0.5, the fused SwiGLU FFN w3(silu(a) * b) with [a, b]
= chunk(w12(x), 2), each branch scaled by its LayerScale gamma before the
residual add).

Each image runs alone at its own size (floor-cropped to whole patches by the
caller), unmasked and unbatched. Departures, each what the benchmarked stage
computes: images are NHWC; the output is stage 1's features, the last
block's keys with heads merged and CLS and the registers dropped, and not
the final norm's tokens.

`num` is `vit.Numerics`: the arithmetic (f32 with TF32 off, or f64) and the
fp8 control. `registers=False` leaves the register tokens out (a model
fault the check has to catch).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .vit import Numerics, layer_norm


def swiglu_hidden(D: int, mlp_ratio: float) -> int:
    """`SwiGLUFFNFused`'s hidden width: (int(2/3 of D * mlp_ratio) + 7) // 8 * 8."""
    return (int(int(D * mlp_ratio) * 2 / 3) + 7) // 8 * 8


def embed(sd: dict, cfg: dict, image: torch.Tensor, num: Numerics,
          registers: bool = True) -> torch.Tensor:
    """(1, 1 + R + h * w, D) tokens of one normalized (H, W, 3) image."""
    P = cfg["patch_size"]
    H, W, _ = image.shape
    h, w = H // P, W // P
    x = F.conv2d(num.q(image.permute(2, 0, 1)[None]), num.q(sd["patch_embed.proj.weight"]),
                 sd["patch_embed.proj.bias"].to(num.dtype), stride=P)
    x = torch.cat([sd["cls_token"].to(num.dtype), x.flatten(2).transpose(1, 2)], dim=1)
    pos = sd["pos_embed"].float()
    M = cfg["img_size"] // P
    if (h, w) != (M, M):
        patch = pos[:, 1:].reshape(1, M, M, -1).permute(0, 3, 1, 2)
        patch = F.interpolate(patch, size=(h, w), mode="bicubic", antialias=True)
        pos = torch.cat([pos[:, :1], patch.permute(0, 2, 3, 1).reshape(1, h * w, -1)], dim=1)
    x = x + pos.to(num.dtype)
    if registers and cfg["num_register_tokens"]:
        x = torch.cat([x[:, :1], sd["register_tokens"].to(num.dtype), x[:, 1:]], dim=1)
    return x


def qkv(sd, prefix, x, cfg, num):
    """(1, T, 3, heads, hd) projection of the block's normed input."""
    _, T, D = x.shape
    y = num.linear(layer_norm(x, sd, prefix + ".norm1"), sd[prefix + ".attn.qkv.weight"],
                   sd[prefix + ".attn.qkv.bias"])
    return y.reshape(1, T, 3, cfg["num_heads"], D // cfg["num_heads"])


def block(sd, i, x, cfg, num):
    """Block i over one image's tokens x (1, T, D)."""
    p = f"blocks.{i}"
    _, T, D = x.shape
    q, k, v = qkv(sd, p, x, cfg, num).unbind(2)
    s = torch.einsum("bthd,bshd->bhts", num.q(q), num.q(k)) / math.sqrt(D // cfg["num_heads"])
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", num.q(a), num.q(v)).reshape(1, T, D)
    o = num.linear(o, sd[p + ".attn.proj.weight"], sd[p + ".attn.proj.bias"])
    x = x + sd[p + ".ls1.gamma"].to(num.dtype) * o
    y = num.linear(layer_norm(x, sd, p + ".norm2"), sd[p + ".mlp.w12.weight"],
                   sd[p + ".mlp.w12.bias"])
    a, b = y.chunk(2, dim=-1)
    y = num.linear(F.silu(a) * b, sd[p + ".mlp.w3.weight"], sd[p + ".mlp.w3.bias"])
    return x + sd[p + ".ls2.gamma"].to(num.dtype) * y


@torch.no_grad()
def patch_keys(sd: dict, cfg: dict, images: list, num: Numerics,
               registers: bool = True) -> list:
    """Stage 1's features of each normalized (h_i * P, w_i * P, 3) image,
    run alone: the last block's keys, heads merged, CLS and registers
    dropped, (h_i * w_i, D) f32."""
    out = []
    for image in images:
        x = embed(sd, cfg, image, num, registers)
        for b in range(cfg["depth"] - 1):
            x = block(sd, b, x, cfg, num)
        prefix = x.shape[1] - (image.shape[0] // cfg["patch_size"]) * (
            image.shape[1] // cfg["patch_size"])
        k = qkv(sd, f"blocks.{cfg['depth'] - 1}", x, cfg, num)[0, prefix:, 1]
        out.append(k.reshape(k.shape[0], -1).float())
    return out
