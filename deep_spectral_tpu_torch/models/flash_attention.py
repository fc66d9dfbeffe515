"""Masked flash-attention forward over the packed (B, T, H, hd) layout.

`flash_attention_packed` launches the hand-written Hopper kernel
(`csrc/flash_fwd.cu`, the port of the JAX package's Pallas
`_flash_kernel_packed`) for CUDA tensors, and computes the same function with
its plain PyTorch twin, `flash_attention_packed_plain`, for CPU tensors. There
is no other fallback: a CUDA tensor the kernel does not take raises.

Semantics (shared by kernel and twin, as in the Pallas kernel): non-causal
softmax(q k^T / sqrt(hd)) v for every (batch, head); keys whose `kv_mask` is
false score MASK_VALUE and get probability exactly 0; statistics in f32; the
probabilities are cast to the value dtype before the P.V product; a query row
with no valid key outputs 0.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
KERNEL_HEAD_DIM = 64


def flash_attention_packed_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 kv_mask: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: a masked softmax in f32 that masks
    with `where` (p = 0 on masked keys) and casts p to v's dtype before the
    P.V product. q/k/v (B, T, H, hd); kv_mask (B, T) bool. Returns
    (B, T, H, hd) in q's dtype."""
    B, T, H, hd = q.shape
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(hd)
    if kv_mask is None:
        valid = torch.ones((B, 1, 1, T), dtype=torch.bool, device=q.device)
    else:
        valid = kv_mask[:, None, None, :].to(torch.bool)
    s = torch.where(valid, s, MASK_VALUE)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1)                                   # (B, H, T)
    o = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(), v.float())
    l = l.permute(0, 2, 1)[..., None]                   # (B, T, H, 1)
    o = o / torch.where(l == 0.0, 1.0, l)
    return o.to(q.dtype)


def _check_qkv(x: torch.Tensor, name: str, shape) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flash kernel takes bf16 {name}; got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(x.shape)} != {tuple(shape)}")
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]):
        raise ValueError(f"{name} strides {x.stride()}: the kernel needs unit "
                         f"stride on hd and 16-byte aligned rows")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} data pointer is not 16-byte aligned")


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd), kv-masked) v over (B, T, H, hd) tensors.

    CPU tensors: the plain twin. CUDA tensors: the Hopper kernel, which takes
    bf16 q/k/v with hd == 64, read through their strides (views into the
    fused qkv projection need no copy); anything else raises. The output is a
    new contiguous (B, T, H, hd) tensor. `flash_attention_packed.launches`
    counts kernel launches."""
    if not q.is_cuda:
        return flash_attention_packed_plain(q, k, v, kv_mask)
    B, T, H, hd = q.shape
    if hd != KERNEL_HEAD_DIM:
        raise ValueError(f"flash kernel is built for hd={KERNEL_HEAD_DIM}; got {hd}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        _check_qkv(x, name, (B, T, H, hd))
    if kv_mask is not None:
        if kv_mask.device != q.device or tuple(kv_mask.shape) != (B, T):
            raise ValueError(f"kv_mask must be ({B}, {T}) on {q.device}; got "
                             f"{tuple(kv_mask.shape)} on {kv_mask.device}")
        kv_mask = kv_mask.to(torch.bool).contiguous()
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    from .. import _build
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.dss_flash_fwd_packed(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(), out.data_ptr(),
            B, T, H, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention_packed")
    flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = 0
