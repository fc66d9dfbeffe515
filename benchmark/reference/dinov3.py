"""Plain DINOv3 ViT forward (Simeoni et al. 2025, arXiv:2508.10104;
facebookresearch/dinov3's `models/vision_transformer.py`, `layers/block.py`,
`layers/attention.py`, `layers/rope_position_encoding.py`,
`layers/ffn_layers.py`), as the hub builds `dinov3_vit7b16`, with plain
torch operations in the arithmetic `num` gives (f32 with TF32 off for the
check, set by the caller):

  * tokens x0 = [CLS; s_1..s_R; PatchEmbed(image)] (a conv of P, stride P,
    with a bias); nothing positional is added;
  * RoPE tables of an h x w grid (base 100, "separate" coordinates, f32):
    c_y = 2 (i + 0.5) / h - 1, c_x = 2 (j + 0.5) / w - 1, periods p (the
    checkpoint's `rope_embed.periods`, base^(f / 32)), angles
    [2 pi c_y / p, 2 pi c_x / p] tiled twice to hd, their cos and sin;
  * each block: u = LN1(x) (eps `layer_norm_eps`); q, k, v = u W_qkv (no
    bias), heads of hd; on the patch rows only, in f32, then cast back,
    q <- q cos + rot(q) sin and the same for k, rot(z) = [-z[hd/2:],
    z[:hd/2]]; x <- x + g1 (softmax(q k^T / sqrt(hd)) v W_o + b_o); x <- x
    + g2 (W3 (silu(W1 y + b1) * (W2 y + b2)) + b3), y = LN2(x).

Departures from the published source, each what the benchmarked stage
computes: one image at a time, at its own (floor-cropped) size, unmasked and
unbatched; images are NHWC; the output is stage 1's features, the k part of
the last block's qkv projection before its RoPE (the reference pipeline's
forward hook on that linear layer), with CLS and the storage tokens
dropped; the final norm and the last block's attention are not run;
training's coordinate shift, jitter and rescale are off, as at inference;
the mask token (`cls_token + 0 * mask_token`) is left out, which changes no
value. `rope="none"` leaves RoPE out, `rope_grids` takes each image's
coordinates over another grid (the bucket's), `storage=False` leaves the
storage tokens out: model faults the check has to catch.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .vit import Numerics, layer_norm


def rope_periods(head_dim: int, base: float) -> torch.Tensor:
    """(head_dim // 4,) f32: base^(2 f / (head_dim / 2))."""
    return base ** (2 * torch.arange(head_dim // 4, dtype=torch.float32) / (head_dim // 2))


def rope_tables(periods: torch.Tensor, h: int, w: int, norm_hw: Optional[tuple] = None):
    """(cos, sin), each (h * w, hd) f32, of an h x w grid's patches in
    row-major order, coordinates over the grid itself or over `norm_hw`."""
    nh, nw = norm_hw or (h, w)
    dev = periods.device
    ch = torch.arange(0.5, h, dtype=torch.float32, device=dev) / nh
    cw = torch.arange(0.5, w, dtype=torch.float32, device=dev) / nw
    coords = torch.stack(torch.meshgrid(ch, cw, indexing="ij"), dim=-1).flatten(0, 1)
    coords = 2.0 * coords - 1.0
    angles = 2 * math.pi * coords[:, :, None] / periods.float()[None, None, :]
    angles = angles.flatten(1, 2).tile(2)
    return torch.cos(angles), torch.sin(angles)


def swiglu_hidden(D: int, ffn_ratio: float, align: int = 64) -> int:
    """"swiglu64"'s hidden width: int(2/3 of int(D * ffn_ratio)), rounded
    up to a multiple of 64."""
    d = int(int(D * ffn_ratio) * 2 / 3)
    return d + (-d % align)


def embed(sd: dict, cfg: dict, image: torch.Tensor, num: Numerics,
          storage: bool = True) -> torch.Tensor:
    """(1, 1 + R + h * w, D) tokens of one normalized (H, W, 3) image."""
    P = cfg["patch_size"]
    x = F.conv2d(num.q(image.permute(2, 0, 1)[None]), num.q(sd["patch_embed.proj.weight"]),
                 sd["patch_embed.proj.bias"].to(num.dtype), stride=P)
    parts = [sd["cls_token"].to(num.dtype)]
    if storage:
        parts.append(sd["storage_tokens"].to(num.dtype))
    return torch.cat(parts + [x.flatten(2).transpose(1, 2)], dim=1)


def qkv(sd, prefix, x, cfg, num):
    """(1, T, 3, heads, hd) projection (no bias) of the block's normed input."""
    _, T, D = x.shape
    u = layer_norm(x, sd, prefix + ".norm1", cfg["layer_norm_eps"])
    y = F.linear(num.q(u), num.q(sd[prefix + ".attn.qkv.weight"]))
    return y.reshape(1, T, 3, cfg["num_heads"], D // cfg["num_heads"])


def rope_apply(z: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """z (1, n, heads, hd) rotated in f32 by (n, hd) tables, cast back."""
    hd = z.shape[-1]
    zf = z.float()
    rot = torch.cat([-zf[..., hd // 2:], zf[..., :hd // 2]], dim=-1)
    return (zf * cos[None, :, None] + rot * sin[None, :, None]).to(z.dtype)


def block(sd, i, x, cfg, num, tables):
    """Block i over one image's tokens x (1, T, D); tables (cos, sin) of its
    patch rows, the last rows of x, or None."""
    p = f"blocks.{i}"
    _, T, D = x.shape
    q, k, v = qkv(sd, p, x, cfg, num).unbind(2)
    if tables is not None:
        pre = T - tables[0].shape[0]
        q = torch.cat([q[:, :pre], rope_apply(q[:, pre:], *tables)], dim=1)
        k = torch.cat([k[:, :pre], rope_apply(k[:, pre:], *tables)], dim=1)
    s = torch.einsum("bthd,bshd->bhts", num.q(q), num.q(k)) / math.sqrt(D // cfg["num_heads"])
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", num.q(a), num.q(v)).reshape(1, T, D)
    o = num.linear(o, sd[p + ".attn.proj.weight"], sd[p + ".attn.proj.bias"])
    x = x + sd[p + ".ls1.gamma"].to(num.dtype) * o
    y = layer_norm(x, sd, p + ".norm2", cfg["layer_norm_eps"])
    h = F.silu(num.linear(y, sd[p + ".mlp.w1.weight"], sd[p + ".mlp.w1.bias"])) \
        * num.linear(y, sd[p + ".mlp.w2.weight"], sd[p + ".mlp.w2.bias"])
    y = num.linear(h, sd[p + ".mlp.w3.weight"], sd[p + ".mlp.w3.bias"])
    return x + sd[p + ".ls2.gamma"].to(num.dtype) * y


@torch.no_grad()
def patch_keys(sd: dict, cfg: dict, images: list, num: Numerics, rope: str = "own",
               storage: bool = True, rope_grids: Optional[list] = None) -> list:
    """Stage 1's features of each normalized (h_i * P, w_i * P, 3) image,
    run alone: the last block's keys before RoPE, heads merged, CLS and
    storage tokens dropped, (h_i * w_i, D) f32. `rope`: "own" (the model)
    or "none"; `rope_grids`: the (h, w) each image's coordinates are
    normalized over, in place of its own grid."""
    P = cfg["patch_size"]
    out = []
    for n, image in enumerate(images):
        h, w = image.shape[0] // P, image.shape[1] // P
        tables = None
        if rope == "own":
            tables = rope_tables(sd["rope_embed.periods"], h, w,
                                 None if rope_grids is None else rope_grids[n])
        x = embed(sd, cfg, image, num, storage)
        for b in range(cfg["depth"] - 1):
            x = block(sd, b, x, cfg, num, tables)
        k = qkv(sd, f"blocks.{cfg['depth'] - 1}", x, cfg, num)[0, x.shape[1] - h * w:, 1]
        out.append(k.reshape(k.shape[0], -1).float())
    return out
