"""Plain SAM ViT image encoder (Kirillov et al. 2023, arXiv:2304.02643;
facebookresearch/segment-anything's `modeling/image_encoder.py`:
`ImageEncoderViT`, `Block`, `Attention`, `window_partition`,
`window_unpartition`, `get_rel_pos`, `add_decomposed_rel_pos`;
`modeling/common.py`: `MLPBlock`, `LayerNorm2d`; `utils/transforms.py`:
`ResizeLongestSide`; `modeling/sam.py`: `Sam.preprocess`), as
`build_sam_vit_h` builds it, with plain torch operations in the arithmetic
`num` gives (f32 with TF32 off for the check, set by the caller), one image
at a time:

  * preprocess: a uint8 image of h x w is resized to h' x w', s = L /
    max(h, w), h' = int(h s + 0.5), w' likewise (L = img_size, 1024),
    normalized x = (x - [123.675, 116.28, 103.53]) / [58.395, 57.12,
    57.375], and padded with zeros at the bottom and right to L x L;
  * embed: x0 = Conv16x16/16(x) + b laid out (1, g, g, D), g = L / 16, plus
    pos_embed (1, g, g, D); no CLS or other prefix token;
  * each block i: u = LN1(x) (eps 1e-6); in a window block (i not in
    `global_attn_indexes`) u is padded with zeros to whole windows of s =
    `window_size` and cut into (s x s) windows, the padded tokens staying in
    as queries and keys, unmasked; q, k, v = u W_qkv + b_qkv, heads of hd;
    logits = (q / sqrt(hd)) k^T + rel_h[q, y_k] + rel_w[q, x_k], rel_h[q,
    y'] = sum_c q_c R_h[y_q, y', c], R_h[y, y'] = rel_pos_h[y - y' + s - 1]
    (s the window's or the whole grid's side), rel_w likewise over columns,
    both of the unscaled q; softmax; times v; W_o + b_o; in a window block,
    unpartition and crop; x <- x + attn; x <- x + W2 GELU_erf(W1 LN2(x) +
    b1) + b2;
  * neck: Conv1x1 (no bias), LayerNorm2d (eps 1e-6), Conv3x3 pad 1 (no
    bias), LayerNorm2d, to (1, 256, g, g).

Departures from the published source, each what the benchmarked stage
computes: the resize is torch's bilinear interpolation of the uint8
values in f32 (align_corners False, no antialias), not PIL's resize to
uint8 (`ResizeLongestSide.apply_image`), and its result is not rounded;
images are (h, w, 3) uint8 tensors; stage 1's features (`patch_keys`) are
the k part of block `which_block`'s qkv projection on the whole (g, g) grid
(the hook on that linear layer, taken before any window partition, which
changes no token's projection), heads merged, cropped to the image's own
floor(h' / 16) x floor(w' / 16) patch grid; the rest of that block and the
neck are not run for them. `rel=False` leaves the relative-position bias
out, `mask_pad=True` masks the padded tokens of a window as keys, and
`scaled_rel=True` builds the rel terms from the scaled q: model faults the
check has to catch.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .vit import Numerics

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def resized_size(h: int, w: int, long_side: int) -> tuple[int, int]:
    scale = long_side * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def preprocess(image: torch.Tensor, long_side: int) -> torch.Tensor:
    """(1, 3, L, L) f32 input of one (h, w, 3) uint8 image."""
    h, w = image.shape[:2]
    hr, wr = resized_size(h, w, long_side)
    x = F.interpolate(image.permute(2, 0, 1)[None].float(), size=(hr, wr), mode="bilinear",
                      align_corners=False)
    mean = torch.tensor(PIXEL_MEAN, device=image.device)[None, :, None, None]
    std = torch.tensor(PIXEL_STD, device=image.device)[None, :, None, None]
    x = (x - mean) / std
    return F.pad(x, (0, long_side - wr, 0, long_side - hr))


def window_partition(x: torch.Tensor, window: int):
    B, H, W, C = x.shape
    pad_h = (window - H % window) % window
    pad_w = (window - W % window) % window
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // window, window, Wp // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C), (Hp, Wp)


def window_unpartition(windows: torch.Tensor, window: int, pad_hw, hw) -> torch.Tensor:
    (Hp, Wp), (H, W) = pad_hw, hw
    B = windows.shape[0] // (Hp * Wp // window // window)
    x = windows.view(B, Hp // window, Wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def get_rel_pos(size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(size, size, C): rel_pos[q - k + size - 1] (queries and keys of one
    size, so no resample)."""
    coords = torch.arange(size, device=rel_pos.device)
    return rel_pos[(coords[:, None] - coords[None, :]) + (size - 1)]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, size: int, num: Numerics):
    """attn (B, T, T) plus rel_h[q, y_k] + rel_w[q, x_k] of q (B, T, C)."""
    Rh, Rw = get_rel_pos(size, rel_pos_h), get_rel_pos(size, rel_pos_w)
    B, _, dim = q.shape
    r_q = num.q(q).reshape(B, size, size, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, num.q(Rh))
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, num.q(Rw))
    attn = attn.view(B, size, size, size, size) + rel_h[:, :, :, :, None] \
        + rel_w[:, :, :, None, :]
    return attn.view(B, size * size, size * size)


def attention(sd, p, x, cfg, num, key_valid=None, rel=True, scaled_rel=False):
    """SAM's `Attention` over x (B, s, s, D); key_valid (B, s * s) masks keys
    (the `mask_pad` fault) where given."""
    B, H, W, D = x.shape
    heads = cfg["num_heads"]
    hd = D // heads
    qkv = num.linear(x, sd[p + ".qkv.weight"], sd[p + ".qkv.bias"])
    qkv = qkv.reshape(B, H * W, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, B * heads, H * W, hd).unbind(0)
    scale = hd ** -0.5
    attn = num.q(q * scale) @ num.q(k).transpose(-2, -1)
    if rel:
        attn = add_decomposed_rel_pos(attn, q * scale if scaled_rel else q,
                                      sd[p + ".rel_pos_h"], sd[p + ".rel_pos_w"], H, num)
    if key_valid is not None:
        valid = key_valid.repeat_interleave(heads, dim=0)[:, None, :]
        attn = attn.masked_fill(~valid, -math.inf)
    attn = attn.softmax(dim=-1)
    x = (num.q(attn) @ num.q(v)).view(B, heads, H, W, hd).permute(0, 2, 3, 1, 4)
    return num.linear(x.reshape(B, H, W, D), sd[p + ".proj.weight"], sd[p + ".proj.bias"])


def layer_norm(x, sd, prefix, eps):
    return F.layer_norm(x, x.shape[-1:], sd[prefix + ".weight"].to(x.dtype),
                        sd[prefix + ".bias"].to(x.dtype), eps)


def block(sd, i, x, cfg, num, rel=True, mask_pad=False, scaled_rel=False):
    """Block i over x (1, g, g, D)."""
    p = f"blocks.{i}"
    eps = cfg["layer_norm_eps"]
    shortcut = x
    x = layer_norm(x, sd, p + ".norm1", eps)
    H, W = x.shape[1], x.shape[2]
    windowed = i not in cfg["global_attn_indexes"]
    key_valid = None
    if windowed:
        s = cfg["window_size"]
        if mask_pad:
            ones = torch.ones((1, H, W, 1), dtype=x.dtype, device=x.device)
            key_valid = window_partition(ones, s)[0].reshape(-1, s * s) > 0
        x, pad_hw = window_partition(x, s)
    x = attention(sd, p + ".attn", x, cfg, num, key_valid, rel, scaled_rel)
    if windowed:
        x = window_unpartition(x, cfg["window_size"], pad_hw, (H, W))
    x = shortcut + x
    h = num.linear(layer_norm(x, sd, p + ".norm2", eps), sd[p + ".mlp.lin1.weight"],
                   sd[p + ".mlp.lin1.bias"])
    return x + num.linear(F.gelu(h), sd[p + ".mlp.lin2.weight"], sd[p + ".mlp.lin2.bias"])


def embed(sd, cfg, image: torch.Tensor, num: Numerics) -> torch.Tensor:
    """(1, g, g, D) tokens of one uint8 image."""
    P = cfg["patch_size"]
    x = preprocess(image, cfg["img_size"])
    x = F.conv2d(num.q(x), num.q(sd["patch_embed.proj.weight"]),
                 sd["patch_embed.proj.bias"].to(num.dtype), stride=P)
    return x.permute(0, 2, 3, 1) + sd["pos_embed"].to(num.dtype)


def layer_norm_2d(x, weight, bias, eps=1e-6):
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return weight[:, None, None] * x + bias[:, None, None]


@torch.no_grad()
def neck(sd: dict, cfg: dict, image: torch.Tensor, num: Numerics, **faults) -> torch.Tensor:
    """The image encoder's output (1, 256, g, g) of one uint8 image."""
    x = embed(sd, cfg, image, num)
    for i in range(cfg["depth"]):
        x = block(sd, i, x, cfg, num, **faults)
    x = F.conv2d(num.q(x.permute(0, 3, 1, 2)), num.q(sd["neck.0.weight"]))
    x = layer_norm_2d(x, sd["neck.1.weight"].to(num.dtype), sd["neck.1.bias"].to(num.dtype))
    x = F.conv2d(num.q(x), num.q(sd["neck.2.weight"]), padding=1)
    return layer_norm_2d(x, sd["neck.3.weight"].to(num.dtype), sd["neck.3.bias"].to(num.dtype))


@torch.no_grad()
def patch_keys(sd: dict, cfg: dict, images: list, num: Numerics, which_block: int = -1,
               **faults) -> list:
    """Stage 1's features of each (h, w, 3) uint8 image, run alone: block
    `which_block`'s keys on the (g, g) grid, heads merged, cropped to the
    image's resized patch grid, (h_p * w_p, D) f32. `faults`: `rel`,
    `mask_pad`, `scaled_rel` (see the module docstring)."""
    P, L = cfg["patch_size"], cfg["img_size"]
    last = which_block % cfg["depth"]
    out = []
    for image in images:
        hr, wr = resized_size(image.shape[0], image.shape[1], L)
        x = embed(sd, cfg, image, num)
        for i in range(last):
            x = block(sd, i, x, cfg, num, **faults)
        p = f"blocks.{last}"
        u = layer_norm(x, sd, p + ".norm1", cfg["layer_norm_eps"])
        D = u.shape[-1]
        k = num.linear(u, sd[p + ".attn.qkv.weight"], sd[p + ".attn.qkv.bias"])[..., D:2 * D]
        out.append(k[0, :hr // P, :wr // P].reshape(-1, D).float())
    return out
