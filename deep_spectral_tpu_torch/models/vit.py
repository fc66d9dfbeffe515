"""DINO, DINOv2, DINOv3 and SAM Vision Transformers as a PyTorch `nn.Module`.

The port of `deep_spectral_tpu.models.vit`. Parameter names are DINO's own
(`patch_embed.proj`, `blocks.{i}.norm1`, `attn.qkv`, `attn.proj`, `mlp.fc1`,
`mlp.fc2`, `norm`, `cls_token`, `pos_embed`), so a DINO checkpoint loads with
`load_state_dict`. The public input is NHWC (B, H, W, 3), the JAX layout.

The DINOv2 family (`ViTConfig.family == "dinov2"`; Oquab et al. 2023, and
Darcet et al. 2023 for the registers; facebookresearch/dinov2's
`vision_transformer.py`) adds, under DINOv2's own names so its checkpoints
load as they are: `num_registers` register tokens (`register_tokens`,
inserted after CLS with no positional embedding), LayerScale after both
branches of every block (`blocks.{i}.ls1.gamma`, `ls2.gamma`), the fused
SwiGLU FFN when `ffn == "swiglufused"` (`mlp.w12`, `mlp.w3`), the unused
`mask_token`, and positional embeddings resampled by torch's antialiased
bicubic to each image's own patch grid (`grids`), placed at its valid
positions of a padded bucket. DINO v1 keeps the JAX package's resample to
the input's whole (bucket) grid and reads no grids.

The DINOv3 family (`family == "dinov3"`; Simeoni et al. 2025,
facebookresearch/dinov3's `vision_transformer.py`), under DINOv3's names:
CLS, then `num_registers` storage tokens (`storage_tokens`), then the
patches, with no positional embedding added anywhere; positions come from
2D axial RoPE (`models/rope.py`, periods in `rope_embed.periods`) applied
to q and k of the patch rows after each block's qkv projection, with
angles from each image's own grid (`grids`); a qkv projection without a
bias; LayerScale on both branches; the unfused SwiGLU FFN when `ffn ==
"swiglu64"` (`mlp.w1`, `mlp.w2`, `mlp.w3`, hidden width aligned to 64);
LayerNorm eps `norm_eps` (1e-5).

The SAM family (`family == "sam"`; Kirillov et al. 2023,
facebookresearch/segment-anything's `ImageEncoderViT`), under SAM's image
encoder's names (`patch_embed.proj`, `pos_embed`, `blocks.{i}.norm1`,
`attn.qkv`, `attn.proj`, `attn.rel_pos_h`, `attn.rel_pos_w`, `norm2`,
`mlp.lin1`, `mlp.lin2`, `neck.0`-`neck.3`): no CLS or other prefix token; an
absolute positional embedding (1, g, g, D), added once, with no resample
(the input is always img_size x img_size, `models/relpos.sam_preprocess`);
windowed attention (`window_size`) in every block but `global_blocks`, the
normed tokens zero-padded to whole windows whose padded tokens are attended
as keys, unmasked, then unpartitioned and cropped after the projection;
SAM's decomposed relative-position bias in every block, its tables
(`models/relpos.py`) added inside kernel 1's softmax; exact GELU in every
precision; no final norm; the conv neck (1x1, LayerNorm2d, 3x3, LayerNorm2d)
is the forward's output and is not run by `extract_patch_keys`.

Numerics follow the JAX model:
  * LayerNorm in f32 with the configuration's eps (1e-6; DINOv3's 1e-5);
    linear layers and the patch conv in the compute dtype (params stay f32
    and are cast per call, as flax does);
  * under bf16 the residual stream is bf16;
  * GELU is exact erf in f32 and the tanh form in bf16 (SAM's: exact erf
    in both);
  * an optional token mask removes padded keys from every attention.

Attention (`attention_impl`, the JAX model's knob): 'einsum' is the plain
masked softmax below, the JAX model's einsum path, and also runs whenever an
attention map is requested; 'flash' runs the hand-written kernels of
`models/flash_attention.py` (their plain twins on the CPU): the autograd
function when q/k/v need a gradient, else the packed forward for bf16 and
the residual-saving forward's f32 build for f32; 'auto' is 'flash' on CUDA
and 'einsum' on the CPU. The kernels mask the ragged sequence edge
themselves, so nothing is padded.

`remat=True` runs each block under `torch.utils.checkpoint` (non-reentrant)
whenever autograd records, as the JAX model wraps its blocks in `nn.remat`:
a block keeps only its input for the backward, which runs the block's
forward again (kernel 3 included, on the 'flash' route) to rebuild what it
needs. No block draws random numbers, so the recomputation is exact.
"""
from __future__ import annotations

import math
import weakref
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.resize import resize_bicubic
from ..utils.precision import exact_f32
from ..utils.profiling import count, span
from .flash_attention import (FlashAttentionFn, flash_attention_lse,
                              flash_attention_packed, relpos_bias)
from .relpos import gathered_rel_pos, rel_tables, window_partition, window_unpartition
from .rope import RopeEmbed, RopePlan, apply_rope_

ATTENTION_IMPLS = ("auto", "einsum", "flash")
FAMILIES = ("dino", "dinov2", "dinov3", "sam")
FFNS = ("mlp", "swiglufused", "swiglu64")
DINOV3_ROPE_BASE = 100.0  # the hub's pos_embed_rope_base

# `extract_patch_keys` replays stage 1's forward from a CUDA graph where B x T
# x D, the activations one elementwise op of it touches (batch, tokens run,
# width), is below this. There a bf16 elementwise pass at HBM's rate (2^25
# elements read and written, 134 MB at 3.35 TB/s: ~40 us) takes no longer
# than the host takes to issue its launch (~40 us a launch on the
# benchmark's H100 host), so the issue of the forward's launches (~290 at
# ViT-S/16) sets its pace, and one replay in their place is the saving.
# Above it the device sets the pace, and a graph would only add its
# capture's device-wide synchronize and a second pool of activations. At
# b24: ViT-S/16 (9.4M) and ViT-S/8 (28.3M) replay; DINOv2 ViT-g/14 (42.8M
# compacted) and DINOv3 ViT-7B/16 (~118M) stay eager, and SAM is never graphed
# (`forward_key`).
VIT_GRAPH_MAX_ELEMENTS = 1 << 25


@dataclass(frozen=True)
class ViTConfig:
    patch_size: int
    embed_dim: int
    depth: int
    num_heads: int
    mlp_ratio: float = 4.0
    img_size: int = 224  # pretraining resolution (defines stored pos_embed grid)
    family: str = "dino"     # "dinov2": LayerScale, mask token, per-image antialiased positions;
    #                          "dinov3": LayerScale, mask token, RoPE, no positional embedding;
    #                          "sam": no prefix token, windows, relative positions, a neck
    num_registers: int = 0   # register (DINOv3: storage) tokens after CLS
    ffn: str = "mlp"         # "mlp" (GELU), "swiglufused" (DINOv2), "swiglu64" (DINOv3, unfused)
    norm_eps: float = 1e-6   # every LayerNorm's
    window_size: int = 0     # SAM: the window side of every block but `global_blocks`
    global_blocks: tuple = ()  # SAM: the blocks that attend over the whole grid

    @property
    def pos_grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_prefix(self) -> int:
        """Tokens before the patches: CLS and the registers (SAM: none)."""
        return 0 if self.family == "sam" else 1 + self.num_registers


VIT_CONFIGS: dict[str, ViTConfig] = {
    # reference model names (extract/extract_utils.py:40-50, torch.hub dino)
    "dino_vits16": ViTConfig(16, 384, 12, 6),
    "dino_vits8": ViTConfig(8, 384, 12, 6),
    "dino_vitb16": ViTConfig(16, 768, 12, 12),
    "dino_vitb8": ViTConfig(8, 768, 12, 12),
    # tiny config for tests/CI smoke only — not a reference model
    "test_vit_tiny": ViTConfig(8, 32, 2, 2, img_size=32),
    # DINOv2 ViT-g/14 with 4 registers (torch.hub facebookresearch/dinov2
    # `dinov2_vitg14_reg`: vit_giant2, img_size 518, init_values 1.0,
    # ffn_layer "swiglufused", interpolate_antialias, interpolate_offset 0)
    "dinov2_vitg14_reg": ViTConfig(14, 1536, 40, 24, img_size=518, family="dinov2",
                                   num_registers=4, ffn="swiglufused"),
    # its tiny sibling for tests/CI smoke only — not a reference model
    "test_dinov2_tiny": ViTConfig(14, 128, 2, 2, img_size=70, family="dinov2",
                                  num_registers=4, ffn="swiglufused"),
    # DINOv3 ViT-7B/16 (torch.hub facebookresearch/dinov3 `dinov3_vit7b16`:
    # vit_7b, 4 storage tokens, ffn_ratio 3, "swiglu64", qkv_bias False,
    # "layernormbf16" (eps 1e-5), RoPE base 100 "separate"; img_size does not
    # apply: no positional embedding)
    "dinov3_vit7b16": ViTConfig(16, 4096, 40, 32, mlp_ratio=3.0, family="dinov3",
                                num_registers=4, ffn="swiglu64", norm_eps=1e-5),
    # its tiny sibling (heads of 128, as the RoPE kernel's) for tests only
    "test_dinov3_tiny": ViTConfig(16, 256, 2, 2, mlp_ratio=3.0, family="dinov3",
                                  num_registers=4, ffn="swiglu64", norm_eps=1e-5),
    # SAM ViT-H's image encoder (facebookresearch/segment-anything
    # `build_sam_vit_h`: ImageEncoderViT, img_size 1024, 16 heads of 80,
    # window 14, global attention in blocks 7, 15, 23 and 31, rel-pos)
    "sam_vit_h": ViTConfig(16, 1280, 32, 16, img_size=1024, family="sam", window_size=14,
                           global_blocks=(7, 15, 23, 31)),
    # its tiny sibling (heads of 80; a 20x20 grid in windows of 3, so padded)
    # for tests only
    "test_sam_tiny": ViTConfig(16, 160, 3, 2, img_size=320, family="sam", window_size=3,
                               global_blocks=(1,)),
}


def get_model_config(name: str) -> ViTConfig:
    name = name.lower()
    if name not in VIT_CONFIGS:
        raise ValueError(f"unknown model {name!r}; have {sorted(VIT_CONFIGS)}")
    return VIT_CONFIGS[name]


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _layer_norm(x: torch.Tensor, layer: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight,
                        layer.bias, layer.eps)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, attention_impl: str = "auto",
                 qkv_bias: bool = True):
        super().__init__()
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}; "
                             f"got {attention_impl!r}")
        self.num_heads = num_heads
        self.attention_impl = attention_impl
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def qkv_heads(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The fused projection as (B, T, 3, H, hd)."""
        B, T, D = x.shape
        return _linear(x, self.qkv, dtype).reshape(B, T, 3, self.num_heads,
                                                   D // self.num_heads)

    def forward(self, x, token_mask=None, want_attn=False, dtype=torch.float32,
                rope: Optional[RopePlan] = None):
        """Returns the output, the projection (B, T, 3, H, hd), its q and k
        rotated in place by `rope` where given, and the einsum route's
        probabilities."""
        B, T, D = x.shape
        qkv = self.qkv_heads(x, dtype)
        if rope is not None:
            with span("vit.rope"):
                apply_rope_(qkv, rope)
                count("vit.rope_rows", 2 * rope.rows)
        out, attn = attend(qkv, token_mask, self.attention_impl, dtype, want_attn)
        out = _linear(out.reshape(B, T, D), self.proj, dtype)
        return out, qkv, attn


def attend(qkv: torch.Tensor, token_mask: Optional[torch.Tensor], impl: str,
           dtype: torch.dtype, want_attn: bool = False, rel_pos: Optional[tuple] = None):
    """Masked attention of the fused projection qkv (B, T, 3, H, hd) by the
    route `impl` names (see the module docstring), with SAM's relative-
    position tables `rel_pos` added to the logits where given (their flash
    route is kernel 1's bf16 inference build, which raises on other CUDA
    tensors). Returns the output (B, T, H, hd) in `dtype` and, on the
    einsum route, the probabilities (B, H, T, T) (else None)."""
    q, k, v = qkv.unbind(2)                      # (B, T, H, hd) views
    if impl == "auto":
        impl = "flash" if qkv.is_cuda else "einsum"
    if impl == "flash" and not want_attn:
        if rel_pos is not None:
            if qkv.is_cuda and torch.is_grad_enabled() and qkv.requires_grad:
                raise ValueError("kernel 1's relative-position build is inference only; "
                                 "attention_impl='einsum' takes a gradient")
            return flash_attention_packed(q, k, v, token_mask, rel_pos), None
        if torch.is_grad_enabled() and qkv.requires_grad:
            return FlashAttentionFn.apply(qkv, token_mask), None
        if qkv.dtype == torch.bfloat16:
            return flash_attention_packed(q, k, v, token_mask), None
        return flash_attention_lse(q, k, v, token_mask)[0], None
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    logits = logits * (1.0 / math.sqrt(q.shape[-1]))
    if rel_pos is not None:
        logits = logits + relpos_bias(rel_pos, logits.shape[-1])
    if token_mask is not None:
        logits = torch.where(token_mask[:, None, None, :], logits, -1e30)
    attn = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhts,bshd->bthd", attn.float(), v.float()).to(dtype), attn


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, dtype=torch.float32):
        h = _linear(x, self.fc1, dtype)
        h = F.gelu(h, approximate="tanh" if dtype == torch.bfloat16 else "none")
        return _linear(h, self.fc2, dtype)


def swiglu_hidden(dim: int, mlp_ratio: float, align: int = 8) -> int:
    """A SwiGLU FFN's hidden width: 2/3 of the MLP's, rounded up to a
    multiple of `align`: DINOv2's `SwiGLUFFNFused` (8; 4096 at width 1536),
    DINOv3's "swiglu64" (64; 8192 at width 4096, ratio 3)."""
    d = int(int(dim * mlp_ratio) * 2 / 3)
    return d + (-d % align)


class SwiGLUFFN(nn.Module):
    """w3(silu(a) * b) with [a, b] = chunk(w12(x), 2), one `vit.swiglu` span."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x, dtype=torch.float32):
        with span("vit.swiglu"):
            a, b = _linear(x, self.w12, dtype).chunk(2, dim=-1)
            return _linear(F.silu(a) * b, self.w3, dtype)


class UnfusedSwiGLUFFN(nn.Module):
    """DINOv3's `SwiGLUFFN`: w3(silu(w1 x) * w2 x), one `vit.swiglu` span."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w1 = nn.Linear(dim, hidden)
        self.w2 = nn.Linear(dim, hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x, dtype=torch.float32):
        with span("vit.swiglu"):
            return _linear(F.silu(_linear(x, self.w1, dtype)) * _linear(x, self.w2, dtype),
                           self.w3, dtype)


def _ffn(kind: str, dim: int, mlp_ratio: float) -> nn.Module:
    if kind == "mlp":
        return Mlp(dim, int(dim * mlp_ratio))
    if kind == "swiglufused":
        return SwiGLUFFN(dim, swiglu_hidden(dim, mlp_ratio))
    return UnfusedSwiGLUFFN(dim, swiglu_hidden(dim, mlp_ratio, align=64))


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def add(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """x + gamma * h in h's dtype."""
        return torch.addcmul(x, h, self.gamma.to(h.dtype))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 attention_impl: str = "auto", ffn: str = "mlp", norm_eps: float = 1e-6,
                 qkv_bias: bool = True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.attn = Attention(dim, num_heads, attention_impl, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)
        self.mlp = _ffn(ffn, dim, mlp_ratio)

    def forward(self, x, token_mask=None, want_attn=False, dtype=torch.float32, rope=None):
        h, qkv, attn = self.attn(_layer_norm(x, self.norm1), token_mask,
                                 want_attn, dtype, rope)
        x = x + h
        x = x + self.mlp(_layer_norm(x, self.norm2), dtype)
        return x, qkv, attn


class LayerScaleBlock(Block):
    """DINOv2's and DINOv3's block: each branch scaled by its LayerScale
    before the add."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 attention_impl: str = "auto", ffn: str = "mlp", norm_eps: float = 1e-6,
                 qkv_bias: bool = True):
        super().__init__(dim, num_heads, mlp_ratio, attention_impl, ffn, norm_eps, qkv_bias)
        self.ls1 = LayerScale(dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x, token_mask=None, want_attn=False, dtype=torch.float32, rope=None):
        h, qkv, attn = self.attn(_layer_norm(x, self.norm1), token_mask,
                                 want_attn, dtype, rope)
        x = self.ls1.add(x, h)
        x = self.ls2.add(x, self.mlp(_layer_norm(x, self.norm2), dtype))
        return x, qkv, attn


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, patch_size)


class SamAttention(Attention):
    """SAM's attention over an s x s grid of tokens (a window, or the whole
    grid of a global block), with its decomposed relative-position bias
    (`rel_pos_h`, `rel_pos_w`, (2s - 1, hd)): the tables of the unscaled q
    (`models/relpos.py`, one `vit.relpos` span) added to the logits. On the
    card and with no gradient to take, the gathered (T, hd, 2s) operand is
    held while the two parameters are unchanged (their device, data
    pointers and versions) and the dtype is the same."""

    def __init__(self, dim: int, num_heads: int, attention_impl: str, size: int):
        super().__init__(dim, num_heads, attention_impl)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, dim // num_heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, dim // num_heads))

    def gathered(self, dtype: torch.dtype) -> torch.Tensor:
        h, w = self.rel_pos_h, self.rel_pos_w
        if not h.is_cuda or (torch.is_grad_enabled() and h.requires_grad):
            return gathered_rel_pos(h, w, dtype)
        key = (dtype, h.device, h.data_ptr(), h._version, w.data_ptr(), w._version)
        held = self.__dict__.get("_gathered_held")
        if held is None or held[0] != key:
            held = self.__dict__["_gathered_held"] = (key, gathered_rel_pos(h, w, dtype))
        return held[1]

    def forward(self, u, token_mask=None, want_attn=False, dtype=torch.float32, rope=None):
        """u (B, s * s, D) normed tokens. Returns the projected output, the
        projection (B, s * s, 3, H, hd) and the einsum route's
        probabilities."""
        B, T, D = u.shape
        qkv = self.qkv_heads(u, dtype)
        with span("vit.relpos"):
            rel = rel_tables(qkv[:, :, 0], self.gathered(qkv.dtype))
        out, attn = attend(qkv, None, self.attention_impl, dtype, want_attn, rel)
        return _linear(out.reshape(B, T, D), self.proj, dtype), qkv, attn


class SamMlp(nn.Module):
    """SAM's `MLPBlock`: lin2(GELU(lin1 x)), GELU exact in every precision."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x, dtype=torch.float32):
        return _linear(F.gelu(_linear(x, self.lin1, dtype)), self.lin2, dtype)


class SamBlock(nn.Module):
    """SAM's block over (B, g * g, D) row-major tokens: a window block
    (`window` > 0) pads the normed tokens to whole windows and cuts them
    (`relpos.window_partition`), attends in each window, projects, and puts
    the windows back, cropped (each a `vit.window` span; counters
    `vit.window_rows`, the rows its qkv projection runs, and
    `vit.window_rows_valid`, the grid's); a global block (`window` 0)
    attends over the whole grid. The returned projection is in the block's
    attention layout (windows for a window block)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, attention_impl: str,
                 window: int, grid: int, norm_eps: float = 1e-6):
        super().__init__()
        self.window, self.grid = window, grid
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.attn = SamAttention(dim, num_heads, attention_impl, window or grid)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)
        self.mlp = SamMlp(dim, int(dim * mlp_ratio))

    def forward(self, x, token_mask=None, want_attn=False, dtype=torch.float32, rope=None):
        u = _layer_norm(x, self.norm1).to(dtype)
        if self.window:
            with span("vit.window"):
                u = window_partition(u, self.grid, self.window)
            count("vit.window_rows", u.shape[0] * u.shape[1])
            count("vit.window_rows_valid", x.shape[0] * x.shape[1])
        h, qkv, attn = self.attn(u, None, want_attn, dtype)
        if self.window:
            with span("vit.window"):
                h = window_unpartition(h, x.shape[0], self.grid, self.window)
        x = x + h
        x = x + self.mlp(_layer_norm(x, self.norm2), dtype)
        return x, qkv, attn


class LayerNorm2d(nn.Module):
    """SAM's `LayerNorm2d`: over the channels of (B, C, H, W), in f32."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        x = x.float()
        u = x.mean(1, keepdim=True)
        x = (x - u) / torch.sqrt((x - u).pow(2).mean(1, keepdim=True) + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


SAM_NECK_CHANNELS = 256


class VisionTransformer(nn.Module):
    """DINO, DINOv2, DINOv3 or SAM ViT. Input: (B, H, W, 3) normalized
    images, H and W multiples of the patch size (SAM: img_size x img_size).
    `compute_dtype` is torch.float32 or torch.bfloat16.

    forward returns a dict with 'x_norm' (B, 1+R+N, D; R registers after
    CLS), 'cls' (B, D), 'qkv' ({'q','k','v'}: head-merged (B, 1+R+N, D) of
    block `qkv_block`; DINOv3's q and k after its RoPE, the operands of the
    block's attention: `extract_patch_keys` gives the keys before it),
    'intermediates' (the last `n_intermediates` blocks' outputs, normed) and,
    with want_attn, 'attn' (B, heads, 1+N, 1+N) of the last block. SAM's
    forward returns 'tokens' (B, g * g, D), the last block's output, and
    'neck' (B, 256, g, g) f32, the image encoder's output.
    `attention_impl`: 'auto', 'einsum' or 'flash'; `remat`: recompute each
    block in the backward (see the module docstring)."""

    def __init__(self, cfg: ViTConfig, compute_dtype: torch.dtype = torch.float32,
                 attention_impl: str = "auto", remat: bool = False):
        super().__init__()
        if cfg.family not in FAMILIES or cfg.ffn not in FFNS:
            raise ValueError(f"family must be one of {FAMILIES} and ffn one of {FFNS}; "
                             f"got {cfg.family!r}, {cfg.ffn!r}")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.attention_impl = attention_impl
        self.remat = remat
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, D)
        if cfg.family == "sam":
            g = cfg.pos_grid
            self.pos_embed = nn.Parameter(torch.zeros(1, g, g, D))
            self.blocks = nn.ModuleList(
                [SamBlock(D, cfg.num_heads, cfg.mlp_ratio, attention_impl,
                          0 if i in cfg.global_blocks else cfg.window_size, g, cfg.norm_eps)
                 for i in range(cfg.depth)])
            C = SAM_NECK_CHANNELS
            self.neck = nn.Sequential(nn.Conv2d(D, C, 1, bias=False), LayerNorm2d(C),
                                      nn.Conv2d(C, C, 3, padding=1, bias=False), LayerNorm2d(C))
            return
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        if cfg.family == "dinov3":
            self.storage_tokens = nn.Parameter(torch.zeros(1, cfg.num_registers, D))
            self.rope_embed = RopeEmbed(D // cfg.num_heads, DINOV3_ROPE_BASE)
        else:
            self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.pos_grid ** 2, D))
            if cfg.num_registers:
                self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_registers, D))
        if cfg.family != "dino":
            self.mask_token = nn.Parameter(torch.zeros(1, D))   # the iBOT mask; unused
        block = Block if cfg.family == "dino" else LayerScaleBlock
        self.blocks = nn.ModuleList(
            [block(D, cfg.num_heads, cfg.mlp_ratio, attention_impl, cfg.ffn, cfg.norm_eps,
                   qkv_bias=cfg.family != "dinov3")
             for _ in range(cfg.depth)])
        self.norm = nn.LayerNorm(D, eps=cfg.norm_eps)

    def precision(self):
        """True f32 for the fp32 model; bf16 runs as bf16."""
        return exact_f32() if self.compute_dtype == torch.float32 else nullcontext()

    def rope_plan(self, grids: Optional[np.ndarray], h: int, w: int, batch: int,
                  compacted: bool = False) -> Optional[RopePlan]:
        """The DINOv3 family's RoPE for a batch of an (h, w)-patch input
        (`RopePlan.make`); None for the other families."""
        if self.cfg.family != "dinov3":
            return None
        return RopePlan.make(self.rope_embed.periods, grids, h, w, batch, self.cfg.num_prefix,
                             compacted)

    def pos_table(self, h: int, w: int, grids: Optional[np.ndarray] = None) -> torch.Tensor:
        """The positional embeddings `embed` adds to an (h, w)-patch input:
        the DINOv2 family's per image (`dinov2_pos_embed`), DINO v1's the
        bucket's (`interpolate_pos_embed`). On the card and with no gradient
        to take, the model keeps the last table it made and hands it to the
        next call of the same input while `pos_embed` is unchanged (its
        device, dtype, data pointer and version): the resample is a dozen
        launches for the host to issue on every forward. The CPU resamples
        on every call."""
        cfg, pos = self.cfg, self.pos_embed
        if not pos.is_cuda or (torch.is_grad_enabled() and pos.requires_grad):
            return self._resample_pos(h, w, grids)
        reads = grids is not None and cfg.family == "dinov2"
        key = (h, w, tuple(np.asarray(grids).ravel().tolist()) if reads else None,
               pos.device, pos.dtype, pos.data_ptr(), pos._version)
        held = self.__dict__.get("_pos_held")
        if held is None or held[0] != key:
            held = self.__dict__["_pos_held"] = (key, self._resample_pos(h, w, grids))
        return held[1]

    def _resample_pos(self, h: int, w: int, grids: Optional[np.ndarray]) -> torch.Tensor:
        cfg = self.cfg
        if cfg.family == "dinov2":
            return dinov2_pos_embed(self.pos_embed, cfg.pos_grid, h, w, grids)
        return interpolate_pos_embed(self.pos_embed, cfg.pos_grid, h, w)

    def embed(self, x: torch.Tensor, token_mask: Optional[torch.Tensor] = None,
              pos_embed_override: Optional[torch.Tensor] = None,
              grids: Optional[np.ndarray] = None):
        """Patch tokens + CLS + positional embeddings, then the register
        tokens after CLS, in the compute dtype, and the token mask extended
        by the (always valid) CLS and register tokens.
        `pos_embed_override` ((B or 1, 1+N, D)) replaces the interpolated
        positional embeddings: bucket-padded evaluation passes each image's
        own-grid embeddings placed at its valid token positions. `grids`
        ((B, 2) host ints, each image's patch grid inside the input's) gives
        the DINOv2 family those per image (`dinov2_pos_embed`); DINO v1
        does not read it. The DINOv3 family adds no positional embedding
        (its positions are RoPE's, in the blocks): CLS, the storage tokens
        and the patches. SAM's are its patches plus its positional
        embedding, with no prefix token and no mask (None): its input is
        always the img_size x img_size square."""
        cfg, dtype = self.cfg, self.compute_dtype
        B, H, W, _ = x.shape
        P = cfg.patch_size
        if H % P or W % P:
            raise ValueError(f"input {H}x{W} not a multiple of patch size {P}")
        h, w = H // P, W // P
        conv = self.patch_embed.proj
        patches = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), conv.weight.to(dtype),
                           conv.bias.to(dtype), stride=P)
        tokens = patches.flatten(2).transpose(1, 2)
        R = cfg.num_registers
        if cfg.family == "sam":
            if (H, W) != (cfg.img_size, cfg.img_size) or pos_embed_override is not None:
                raise ValueError(f"SAM's input is {cfg.img_size}x{cfg.img_size} with its own "
                                 f"positional embedding; got {H}x{W}")
            pos = self.pos_embed.reshape(1, h * w, -1).float()
            return (tokens.float() + pos).to(dtype), None
        if cfg.family == "dinov3":
            if pos_embed_override is not None:
                raise ValueError("the DINOv3 family has no positional embeddings to override")
            tokens = torch.cat([self.cls_token.to(dtype).expand(B, -1, -1),
                                self.storage_tokens.to(dtype).expand(B, -1, -1), tokens], dim=1)
        else:
            pos = (pos_embed_override if pos_embed_override is not None
                   else self.pos_table(h, w, grids))
            tokens = torch.cat([self.cls_token.expand(B, -1, -1).float(),
                                tokens.float()], dim=1)
            tokens = (tokens + pos).to(dtype)
            if R:
                tokens = torch.cat([tokens[:, :1],
                                    self.register_tokens.to(dtype).expand(B, -1, -1),
                                    tokens[:, 1:]], dim=1)
        if token_mask is not None:
            token_mask = torch.cat(
                [torch.ones((B, 1 + R), dtype=torch.bool, device=token_mask.device),
                 token_mask.to(torch.bool)], dim=1)
        return tokens, token_mask

    def forward(self, x: torch.Tensor, *, qkv_block: int = -1,
                n_intermediates: int = 1, want_attn: bool = False,
                token_mask: Optional[torch.Tensor] = None,
                pos_embed_override: Optional[torch.Tensor] = None,
                grids: Optional[np.ndarray] = None):
        cfg, dtype = self.cfg, self.compute_dtype
        if cfg.family == "sam":
            return self._sam_forward(x)
        with self.precision():
            tokens, token_mask = self.embed(x, token_mask, pos_embed_override, grids)
            P = cfg.patch_size
            rope = self.rope_plan(grids, x.shape[1] // P, x.shape[2] // P, x.shape[0])
            qkv_block = qkv_block % cfg.depth
            qkv_out, attn_out, intermediates = None, None, []
            remat = self.remat and torch.is_grad_enabled()
            for i, blk in enumerate(self.blocks):
                want_this = want_attn and i == cfg.depth - 1
                if remat:
                    tokens, qkv, attn = checkpoint(blk, tokens, token_mask, want_this, dtype,
                                                   rope, use_reentrant=False)
                else:
                    tokens, qkv, attn = blk(tokens, token_mask, want_this, dtype, rope)
                if i == qkv_block:
                    B, T = qkv.shape[:2]
                    qkv_out = {name: qkv[:, :, j].reshape(B, T, -1)
                               for j, name in enumerate("qkv")}
                if want_this:
                    attn_out = attn
                if cfg.depth - i <= n_intermediates:
                    intermediates.append(_layer_norm(tokens, self.norm))
            x_norm = intermediates[-1] if intermediates else _layer_norm(tokens, self.norm)
        out = {"x_norm": x_norm, "cls": x_norm[:, 0], "qkv": qkv_out,
               "intermediates": tuple(intermediates)}
        if want_attn:
            out["attn"] = attn_out
        return out

    def _sam_forward(self, x: torch.Tensor) -> dict:
        cfg, dtype = self.cfg, self.compute_dtype
        g = cfg.pos_grid
        with self.precision():
            tokens = self.embed(x)[0]
            for blk in self.blocks:
                tokens = blk(tokens, None, False, dtype)[0]
            y = tokens.reshape(x.shape[0], g, g, -1).permute(0, 3, 1, 2)
            conv1, norm1, conv3, norm3 = self.neck
            y = norm1(F.conv2d(y.to(dtype), conv1.weight.to(dtype)))
            y = norm3(F.conv2d(y.to(dtype), conv3.weight.to(dtype), padding=1))
        return {"tokens": tokens, "neck": y}


def interpolate_pos_embed(pos_embed: torch.Tensor, grid: int, h: int,
                          w: int) -> torch.Tensor:
    """Bicubic-resample stored (1, 1+grid^2, D) positional embeddings to an
    (h, w) patch grid (torch bicubic, a=-0.75, align_corners=False)."""
    if h == grid and w == grid:
        return pos_embed
    cls_pos = pos_embed[:, :1]
    patch_pos = pos_embed[:, 1:].reshape(1, grid, grid, -1)
    patch_pos = resize_bicubic(patch_pos, (h, w), channels_last=True)
    return torch.cat([cls_pos, patch_pos.reshape(1, h * w, -1)], dim=1)


def antialias_pos_embed(pos_embed: torch.Tensor, grid: int, h: int, w: int) -> torch.Tensor:
    """DINOv2's resample of stored (1, 1+grid^2, D) positional embeddings to
    an (h, w) patch grid: torch's antialiased bicubic to an exact size, in
    f32 (`interpolate_antialias=True`, `interpolate_offset=0`)."""
    pos_embed = pos_embed.float()
    if h == grid and w == grid:
        return pos_embed
    patch_pos = pos_embed[:, 1:].reshape(1, grid, grid, -1).permute(0, 3, 1, 2)
    patch_pos = F.interpolate(patch_pos, size=(h, w), mode="bicubic", antialias=True)
    return torch.cat([pos_embed[:, :1], patch_pos.flatten(2).transpose(1, 2)], dim=1)


def dinov2_pos_embed(pos_embed: torch.Tensor, grid: int, h: int, w: int,
                     grids: Optional[np.ndarray] = None) -> torch.Tensor:
    """Positional embeddings of an (h, w)-patch input: with `grids` ((B, 2)
    host ints), each image's own (h_i, w_i) resample at its valid positions
    and zeros elsewhere, (B, 1+h*w, D), or (1, 1+h*w, D) when every image
    has one grid; without, the whole (h, w) grid's, as an unpadded input
    takes it. A grid of zero patches (a batch's padding row) gets zeros."""
    if grids is None:
        return antialias_pos_embed(pos_embed, grid, h, w)
    keys = [(int(gh), int(gw)) for gh, gw in np.asarray(grids).reshape(-1, 2)]
    if any(gh > h or gw > w for gh, gw in keys):
        raise ValueError(f"image grids {sorted(set(keys))} do not fit the {h}x{w} input")
    tables = {}
    for gh, gw in dict.fromkeys(keys):
        if gh * gw == 0:
            tables[gh, gw] = pos_embed.new_zeros((1, 1 + h * w, pos_embed.shape[-1]),
                                                 dtype=torch.float32)
            continue
        own = antialias_pos_embed(pos_embed, grid, gh, gw)
        patch = own[:, 1:].transpose(1, 2).reshape(1, -1, gh, gw)
        patch = F.pad(patch, (0, w - gw, 0, h - gh)).flatten(2).transpose(1, 2)
        tables[gh, gw] = torch.cat([own[:, :1], patch], dim=1)
    if len(tables) == 1:
        return next(iter(tables.values()))
    return torch.cat([tables[k] for k in keys])


class _Compaction:
    """Each image's own tokens of a bucket-padded batch, as one batch of
    Tc tokens an image, Tc the largest of the images' 1 + R + h_i w_i.
    Planned on the host from the grids ((B, 2) ints) of an (h, w)-patch
    bucket and uploaded as one int64 array: a flat gather of each image's
    prefix and grid tokens (a shorter image's tail repeats its CLS and is
    masked as keys), and a flat scatter of its grid rows back to the
    bucket's layout. A grid of zero patches keeps its prefix tokens."""

    def __init__(self, grids: np.ndarray, h: int, w: int, prefix: int,
                 device: torch.device):
        g = np.asarray(grids, np.int64).reshape(-1, 2)
        B, T = len(g), prefix + h * w
        counts = prefix + g[:, 0] * g[:, 1]
        self.B, self.T, self.Tc, self.N = B, T, int(counts.max()), h * w
        gather = np.zeros((B, self.Tc), np.int64)
        src, dst = [], []
        for b, (gh, gw) in enumerate(g):
            pos = (np.arange(gh)[:, None] * w + np.arange(gw)).ravel()
            gather[b, :prefix] = np.arange(prefix)
            gather[b, prefix:prefix + pos.size] = prefix + pos
            gather[b] += b * T
            src.append(b * self.Tc + prefix + np.arange(pos.size))
            dst.append(b * self.N + pos)
        host = torch.from_numpy(np.concatenate([counts, gather.ravel(), *src, *dst]))
        idx = (host.pin_memory() if device.type == "cuda" else host).to(device,
                                                                         non_blocking=True)
        S = int(counts.sum()) - B * prefix
        _, self.gather, self.src, self.dst = idx.split([B, B * self.Tc, S, S])
        self.mask = (None if (counts == self.Tc).all() else
                     torch.arange(self.Tc, device=device) < idx[:B, None])

    @classmethod
    def plan(cls, grids: np.ndarray, h: int, w: int, prefix: int,
             device: torch.device) -> Optional["_Compaction"]:
        """The compaction of a batch of `grids` in an (h, w)-patch bucket, or
        None where every image fills the bucket."""
        if not cls.needed(grids, h, w):
            return None
        return cls(grids, h, w, prefix, device)

    @staticmethod
    def needed(grids: np.ndarray, h: int, w: int) -> bool:
        """Whether an image of `grids` leaves part of the (h, w)-patch bucket."""
        g = np.asarray(grids).reshape(-1, 2)
        return int((g[:, 0] * g[:, 1]).max()) != h * w

    def tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, T, D) bucket tokens -> (B, Tc, D) compacted."""
        if tokens.shape[:2] != (self.B, self.T):
            raise ValueError(f"{self.B} grids of {self.T} tokens for tokens "
                             f"{tuple(tokens.shape[:2])}")
        return tokens.reshape(self.B * self.T, -1).index_select(0, self.gather).reshape(
            self.B, self.Tc, -1)

    def patches(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Tc, ...) compacted rows -> the bucket's (B, h * w, D) patch
        rows, zeros at padded positions."""
        x = x.reshape(self.B * self.Tc, -1)
        out = x.new_zeros((self.B * self.N, x.shape[1]))
        out.index_copy_(0, self.dst, x.index_select(0, self.src))
        return out.reshape(self.B, self.N, -1)


def graphs_forward(batch: int, tokens: int, width: int) -> bool:
    """Whether stage 1's forward of `batch` images of `tokens` tokens of
    `width` features is paced by the host's issue, and so replayed from a
    CUDA graph on the card (VIT_GRAPH_MAX_ELEMENTS)."""
    return batch * tokens * width < VIT_GRAPH_MAX_ELEMENTS


def _forward(model: VisionTransformer, images: torch.Tensor, last: int,
             token_mask: Optional[torch.Tensor], grids: Optional[np.ndarray]):
    """`extract_patch_keys`'s forward as far as block `last`'s qkv
    projection: (qkv (B, T, 3, H, hd), the batch's `_Compaction` or None)."""
    cfg, dtype = model.cfg, model.compute_dtype
    with model.precision():
        tokens, token_mask = model.embed(images, token_mask, grids=grids)
        compact = None
        P = cfg.patch_size
        h, w = images.shape[1] // P, images.shape[2] // P
        if grids is not None and cfg.family in ("dinov2", "dinov3"):
            compact = _Compaction.plan(grids, h, w, cfg.num_prefix, tokens.device)
        rope = model.rope_plan(grids, h, w, images.shape[0], compacted=compact is not None)
        if compact is not None:
            tokens, token_mask = compact.tokens(tokens), compact.mask
        for blk in model.blocks[:last]:
            tokens = blk(tokens, token_mask, False, dtype, rope)[0]
        blk = model.blocks[last]
        return blk.attn.qkv_heads(_layer_norm(tokens, blk.norm1), dtype), compact


def _keys(qkv: torch.Tensor, compact: Optional[_Compaction], j: int,
          prefix: int) -> torch.Tensor:
    """Feature j (0 q, 1 k, 2 v) of qkv, head-merged, the `prefix` tokens
    dropped, in the bucket's layout: (B, N, D)."""
    if compact is not None:
        return compact.patches(qkv[:, :, j])
    B, T = qkv.shape[:2]
    return qkv[:, prefix:, j].reshape(B, T - prefix, -1)


def forward_key(model: VisionTransformer, images: torch.Tensor, last: int, j: int,
                token_mask: Optional[torch.Tensor],
                grids: Optional[np.ndarray]) -> Optional[tuple]:
    """What fixes the kernels and the addresses of `extract_patch_keys`'s
    forward, the key of its CUDA graph: the input's shape, dtype and
    device, the mask's, the block and feature, the grids where the
    embedding reads them (DINO v1 reads none), the compute dtype, the
    version of `pos_embed` (whose table the graph holds: a write to it, as
    `load_state_dict` makes, changes the key) and the data pointers of the
    model's parameters and buffers (a replay reads their values; `.to()`
    or a replaced tensor changes the key). None where the forward is not
    graphed: the host's issue does not set its pace (`graphs_forward`), or
    it uploads a plan the host makes per call (a `_Compaction`, DINOv3's
    `RopePlan`), whose host buffer a capture would keep, or the model is
    SAM's, whose blocks hold operands gathered from their relative-position
    tables (`SamAttention.gathered`) that a capture would read as they were
    then."""
    cfg = model.cfg
    B, H, W = images.shape[:3]
    h, w = H // cfg.patch_size, W // cfg.patch_size
    if cfg.family == "sam" or not graphs_forward(B, cfg.num_prefix + h * w, cfg.embed_dim):
        return None
    reads_grids = grids is not None and cfg.family != "dino"
    if cfg.family == "dinov3" or (reads_grids and _Compaction.needed(grids, h, w)):
        return None
    return (tuple(images.shape), images.dtype, images.device,
            None if token_mask is None else (tuple(token_mask.shape), token_mask.dtype,
                                             token_mask.device),
            last, j, tuple(np.asarray(grids).ravel().tolist()) if reads_grids else None,
            model.compute_dtype, model.pos_embed._version, _data_pointers(model))


def _data_pointers(module: nn.Module) -> tuple:
    """The data pointers of the module's parameters and buffers, its
    submodules' included (a walk of the tree: `parameters()` takes ~4x as
    long, 0.6 ms at ViT-S/16)."""
    out, stack = [], [module]
    while stack:
        mod = stack.pop()
        out += [t.data_ptr() for t in (*mod._parameters.values(), *mod._buffers.values())
                if t is not None]
        stack += mod._modules.values()
    return tuple(out)


class GraphPolicy:
    """A model's stage-1 CUDA graph (`forward`, a `_GraphedForward` or
    None) and its capture policy: `step(key)` says what a call of `key`
    does. A key is captured at its second consecutive use and replayed
    while the model holds its graph; the model holds one graph, which the
    next capture replaces. So memory stays at one forward's pool, and a
    stream of changing keys stays eager."""

    def __init__(self):
        self.captured: Optional[tuple] = None   # the key of `forward`
        self.last: Optional[tuple] = None       # the key of the model's last graphable call
        self.forward = None

    def step(self, key: tuple) -> str:
        """'replay', 'capture' (run eagerly, then capture) or 'eager'."""
        if key == self.captured:
            action = "replay"
        elif key == self.last:
            self.captured, action = key, "capture"
        else:
            action = "eager"
        self.last = key
        return action


# The kernel wrappers a stage-1 forward calls. Each counts its launches in
# `launches` and a call captured into a CUDA graph, which launches nothing,
# in `captured` (kernel 3 its f32 build's apart, in `f32_launches` and
# `f32_captured`); a replay adds what its capture counted to `launches`.
_KERNELS = (flash_attention_packed, flash_attention_lse, apply_rope_)


def _captured() -> list:
    return [(f.captured, getattr(f, "f32_captured", 0)) for f in _KERNELS]


class _GraphedForward:
    """Stage 1's forward and keys (`_forward`, `_keys`) of one
    `forward_key`, replayed from a CUDA graph: each call copies the
    caller's images and mask into the static inputs, replays, and hands
    back a copy of the keys (the graph's buffer is the next replay's
    output). Captured on the images' device, on a stream of its own there,
    on static inputs holding the capturing call's values, after that call
    ran eagerly; `tokens` is its count of the tokens run. The graph reads
    the positional table that call made (`pos_table`, held here; the key
    holds `pos_embed`'s version) and runs no resample."""

    def __init__(self, model: VisionTransformer, last: int, j: int,
                 grids: Optional[np.ndarray], images: torch.Tensor,
                 token_mask: Optional[torch.Tensor], tokens: int):
        self.tokens = tokens
        self.images = images.clone()
        self.token_mask = None if token_mask is None else token_mask.clone()
        P = model.cfg.patch_size
        self.pos = model.pos_table(images.shape[1] // P, images.shape[2] // P, grids)
        launched, captured = [f.launches for f in _KERNELS], _captured()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(images.device), \
                torch.cuda.graph(self.graph, stream=torch.cuda.Stream(images.device),
                                 capture_error_mode="thread_local"):
            qkv = _forward(model, self.images, last, self.token_mask, grids)[0]
            self.keys = _keys(qkv, None, j, model.cfg.num_prefix)
        if [f.launches for f in _KERNELS] != launched:
            raise RuntimeError(f"stage 1's capture on {images.device} launched kernels "
                               f"outside its graph")
        self.captured = [(a - b, a32 - b32) for (a, a32), (b, b32) in zip(_captured(), captured)]

    def __call__(self, images: torch.Tensor, token_mask: Optional[torch.Tensor]) -> torch.Tensor:
        with torch.cuda.device(images.device):
            self.images.copy_(images)
            if token_mask is not None:
                self.token_mask.copy_(token_mask)
            self.graph.replay()
            keys = self.keys.clone()
        for f, (n, n32) in zip(_KERNELS, self.captured):
            f.launches += n
            if n32:
                f.f32_launches += n32
        return keys


_model_graphs: "weakref.WeakKeyDictionary[VisionTransformer, GraphPolicy]" = \
    weakref.WeakKeyDictionary()


@torch.no_grad()
def extract_patch_keys(model: VisionTransformer, images: torch.Tensor,
                       which_block: int = -1, which_features: str = "k",
                       token_mask: Optional[torch.Tensor] = None,
                       grids: Optional[np.ndarray] = None) -> torch.Tensor:
    """Stage-1 features: head-merged `which_features` ('q', 'k' or 'v') of
    block `which_block`, CLS and registers dropped (reference:
    extract/extract.py:96-98, which has no registers). Runs only as far as
    that block's qkv projection.

    Given `grids` ((B, 2) host ints, each image's patch grid; see
    `VisionTransformer.embed`), a DINOv2- or DINOv3-family model runs its
    blocks on each image's own tokens: after the embedding, the prefix and
    grid tokens of every image are gathered into a batch of the largest
    count, the shorter images' tails masked as keys, and the features are
    scattered back with zeros at the padded positions. Such a token's result
    does not depend on the padding (its positions, DINOv2's embeddings or
    DINOv3's RoPE angles, are its own grid's), so the padding's work is
    dropped, not changed. Without grids, for DINO v1, or where every image
    fills the bucket, the blocks run on the whole bucket under
    `token_mask`. DINOv3's keys are the last block's before its RoPE (the
    hub's forward hook on that qkv projection). SAM's blocks run on the
    whole img_size x img_size input, which it takes no mask or grids for
    (its padding is SAM's input); its keys are block `which_block`'s on the
    whole (g, g) grid, projected from the block's normed input before any
    window partition (windows change no token's projection).

    On the card, a forward that `forward_key` keys (one whose host issue
    sets its pace) is replayed from a CUDA graph under the model's
    `GraphPolicy` (`_GraphedForward`): the eager forward's kernels in its
    order on the same data, so the keys are bit-equal to the eager
    forward's.

    One `vit.extract` span, which counts `vit.tokens` (the B x T tokens
    run: compacted, B x Tc), `vit.compacted` (1 for a batch whose blocks ran
    compacted), `vit.graph_replays` (1 for a call that a replay served),
    `vit.graph_captures` (1 for a call that captured a graph) and, given
    grids, `vit.tokens_valid` (the prefix and grid tokens of the images with
    any); DINOv3's blocks each open a `vit.rope` span, SAM's a `vit.relpos`
    span and, in a window block, two `vit.window` spans (`SamBlock`).
    Returns (B, N, D) in
    the compute dtype."""
    cfg = model.cfg
    j = "qkv".index(which_features)
    last = which_block % cfg.depth
    with span("vit.extract"):
        key = forward_key(model, images, last, j, token_mask, grids) if images.is_cuda else None
        graphs = None if key is None else _model_graphs.setdefault(model, GraphPolicy())
        action = "eager" if graphs is None else graphs.step(key)
        compact = None
        if action == "replay":
            keys, tokens = graphs.forward(images, token_mask), graphs.forward.tokens
        else:
            qkv, compact = _forward(model, images, last, token_mask, grids)
            tokens = qkv.shape[0] * qkv.shape[1]
        if action == "capture":
            graphs.forward = None     # the old graph's pool goes before the new capture
            try:
                graphs.forward = _GraphedForward(model, last, j, grids, images, token_mask,
                                                 tokens)
            except BaseException:
                graphs.captured = None
                raise
            count("vit.graph_captures")
        if compact is not None:
            count("vit.compacted")
        count("vit.tokens", tokens)
        if action == "replay":
            count("vit.graph_replays")
        if grids is not None:
            count("vit.tokens_valid", sum(cfg.num_prefix + int(gh) * int(gw)
                                          for gh, gw in np.asarray(grids).reshape(-1, 2)
                                          if gh * gw))
    return keys if action == "replay" else _keys(qkv, compact, j, cfg.num_prefix)
