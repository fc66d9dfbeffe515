"""2D axial rotary position embedding (RoPE) of the DINOv3 family, on the
port's packed (B, T, 3, H, hd) qkv projection.

DINOv3 (Simeoni et al. 2025; facebookresearch/dinov3's
`layers/rope_position_encoding.py` and `layers/attention.py`, as the hub
builds its ViTs: base 100, coordinates normalized "separate", f32) gives
positions to the patches through q and k alone. A patch (i, j) of an h x w
grid has coordinates c_y = 2 (i + 0.5) / h - 1 and c_x = 2 (j + 0.5) / w - 1,
and the hd / 2 angles [2 pi c_y / p_f, 2 pi c_x / p_f] (f < hd / 4, periods
p_f = base^(f / (hd / 4)), the module's `periods` buffer), tiled twice to
hd; each patch row of q and k becomes z cos + rot(z) sin in f32, rot(z) =
[-z[hd/2:], z[:hd/2]], cast back. The prefix rows (CLS and the storage
tokens) keep their values. Training's shift, jitter and rescale of the
coordinates are off at inference and are not implemented.

A `RopePlan` says where each image's patches lie in the rows after the
prefix: image b's grid (h_b, w_b) and the stride of its grid rows, w_b in a
batch compacted to each image's own tokens, the bucket's w in a padded
one. Angles always come from the image's own grid, so a token's result does
not depend on the bucket's padding.

`apply_rope_` rotates in place: on CUDA tensors `csrc/rope.cu` (hd = 128,
bf16 or f32; angles computed in the kernel from each row's patch index and
its image's grid, no table in memory), on CPU tensors its plain twin
`apply_rope_plain_`; anything else raises. `apply_rope_.launches` counts
kernel launches, `apply_rope_.captured` calls captured into a CUDA graph
(which launch nothing; whoever replays the graph adds them to `launches`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

KERNEL_HEAD_DIM = 128


def rope_periods(head_dim: int, base: float) -> torch.Tensor:
    """(head_dim // 4,) f32 periods base^(2 f / (head_dim / 2)), as DINOv3
    computes them."""
    return base ** (2 * torch.arange(head_dim // 4, dtype=torch.float32) / (head_dim // 2))


class RopeEmbed(nn.Module):
    """DINOv3's `rope_embed`: the periods, kept as a checkpoint buffer."""

    def __init__(self, head_dim: int, base: float):
        super().__init__()
        self.register_buffer("periods", rope_periods(head_dim, base))


def rope_tables(periods: torch.Tensor, h: int, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (h * w, hd) f32, of an h x w grid's patches in
    row-major order (DINOv3's `RopePositionEmbedding`)."""
    dev = periods.device
    ch = torch.arange(0.5, h, dtype=torch.float32, device=dev) / h
    cw = torch.arange(0.5, w, dtype=torch.float32, device=dev) / w
    coords = torch.stack(torch.meshgrid(ch, cw, indexing="ij"), dim=-1).flatten(0, 1)
    coords = 2.0 * coords - 1.0
    angles = 2 * math.pi * coords[:, :, None] / periods.float()[None, None, :]
    angles = angles.flatten(1, 2).tile(2)
    return torch.cos(angles), torch.sin(angles)


@dataclass
class RopePlan:
    """A batch's RoPE: the model's `periods`, where each image's patches lie
    after the `prefix` rows (`grids`, (B, 3) int32 (h_b, w_b, row stride)
    on the device, and its host copy `host`), and `rows` = sum h_b w_b, the
    patch rows of q (and of k)."""
    periods: torch.Tensor
    grids: torch.Tensor
    host: np.ndarray
    prefix: int
    rows: int

    @classmethod
    def make(cls, periods: torch.Tensor, grids: Optional[np.ndarray], h: int, w: int,
             batch: int, prefix: int, compacted: bool) -> "RopePlan":
        """The plan of a batch whose input is an (h, w)-patch grid, on the
        periods' device: with `grids` ((B, 2) host ints), each image's own
        grid, its rows w_b apart when the batch runs `compacted`, else the
        bucket's w; without, every image the whole (h, w) grid."""
        g = (np.tile([h, w], (batch, 1)) if grids is None
             else np.asarray(grids, np.int64).reshape(-1, 2))
        if (g[:, 0] > h).any() or (g[:, 1] > w).any():
            raise ValueError(f"image grids {sorted(set(map(tuple, g.tolist())))} do not fit "
                             f"the {h}x{w} input")
        stride = np.maximum(g[:, 1], 1) if compacted else np.full(len(g), w)
        host = np.concatenate([g, stride[:, None]], axis=1).astype(np.int32)
        t = torch.from_numpy(host)
        if periods.is_cuda:
            t = t.pin_memory()
        return cls(periods, t.to(periods.device, non_blocking=True), host, prefix,
                   int((g[:, 0] * g[:, 1]).sum()))


def apply_rope_plain_(qkv: torch.Tensor, plan: RopePlan) -> torch.Tensor:
    """Plain twin of the kernel: each image's patch rows of q and k (qkv
    (B, T, 3, H, hd)) rotated in place by its own grid's tables."""
    hd = qkv.shape[-1]
    for b, (gh, gw, stride) in enumerate(plan.host.tolist()):
        if gh * gw == 0:
            continue
        cos, sin = rope_tables(plan.periods.to(qkv.device), gh, gw)
        rows = plan.prefix + (np.arange(gh)[:, None] * stride + np.arange(gw)).ravel()
        rows = torch.from_numpy(rows).to(qkv.device)
        x = qkv[b, rows, :2].float()                           # (n, 2, H, hd)
        rot = torch.cat([-x[..., hd // 2:], x[..., :hd // 2]], dim=-1)
        qkv[b, rows, :2] = (x * cos[:, None, None] + rot * sin[:, None, None]).to(qkv.dtype)
    return qkv


def apply_rope_(qkv: torch.Tensor, plan: RopePlan) -> torch.Tensor:
    """Rotate the patch rows of q and k of qkv (B, T, 3, H, hd) in place
    (see the module docstring). CPU tensors: the twin. CUDA tensors: the
    kernel, which takes a contiguous bf16 or f32 qkv with hd == 128 and has
    no backward (raises where qkv needs a gradient)."""
    if not qkv.is_cuda:
        return apply_rope_plain_(qkv, plan)
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise RuntimeError("the RoPE kernel has no backward; run it under torch.no_grad()")
    periods = plan.periods
    B, T, three, H, hd = qkv.shape
    if three != 3 or hd != KERNEL_HEAD_DIM:
        raise ValueError(f"RoPE kernel is built for (B, T, 3, H, {KERNEL_HEAD_DIM}); "
                         f"got {tuple(qkv.shape)}")
    if qkv.dtype not in (torch.bfloat16, torch.float32) or not qkv.is_contiguous():
        raise ValueError(f"RoPE kernel takes a contiguous bf16 or f32 qkv; got {qkv.dtype}, "
                         f"strides {qkv.stride()}")
    if (periods.dtype != torch.float32 or periods.shape != (hd // 4,)
            or not periods.is_contiguous() or periods.device != qkv.device
            or plan.grids.device != qkv.device or plan.grids.dtype != torch.int32
            or tuple(plan.grids.shape) != (B, 3)):
        raise ValueError(f"periods must be ({hd // 4},) f32 and the plan's grids ({B}, 3) "
                         f"int32, both on {qkv.device}")
    from .. import _build
    lib = _build.load()
    with torch.cuda.device(qkv.device):
        captured = torch.cuda.is_current_stream_capturing()
        err = lib.dss_rope_rotate(qkv.data_ptr(), int(qkv.dtype == torch.float32),
                                  plan.grids.data_ptr(), periods.data_ptr(),
                                  B, T, plan.prefix, H, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "apply_rope_")
    if captured:
        apply_rope_.captured += 1
    else:
        apply_rope_.launches += 1
    return qkv


apply_rope_.launches = apply_rope_.captured = 0
