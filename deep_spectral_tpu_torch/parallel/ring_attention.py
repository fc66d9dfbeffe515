"""Ring attention: sequence-parallel masked attention over a process group.

The port of `deep_spectral_tpu.parallel.ring_attention`. The token
dimension is sharded over a mesh dim: each rank holds one token shard of q,
k and v ((B, Tl, H, hd), the port's packed layout) and of the key validity
mask. Each of the n hops, a rank attends its q shard to the K/V shard it
holds, then (between hops, n - 1 times) sends that K/V shard and its mask
to the next rank of the ring and receives the previous rank's
(`dist.batch_isend_irecv`, started before the hop's compute so the transfer
overlaps it). Rank r thus sees the shards r, r-1, ..., r-n+1 (mod n). At
world 1 the ring is one local attention with no transfer, as the JAX
version "degrades to a single local attention".

impl='einsum' keeps an f32 online-softmax accumulator over materialized
(Tl, Tl) score tiles, the JAX einsum hops. impl='flash' runs each hop's
tile through `flash_attention_lse`, kernel 3 on CUDA (the bf16 wgmma build
or the f32 build; its plain twin on the CPU), and merges the normalized
hop outputs by their row log-sum-exp (`merge_hops`). A hop whose keys are
all masked has an lse of about MASK_VALUE, so its weight underflows to 0 as
soon as a hop with a valid key is merged: padding shards stay inert.
impl='auto' (the default) is 'flash' on CUDA tensors and 'einsum' on the
CPU, so the card runs kernel 3 unless the caller asks otherwise.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ..models.flash_attention import MASK_VALUE, flash_attention_lse
from ..utils.precision import exact_f32
from .mesh import MODEL_AXIS, axis_group, local_rows

IMPLS = ("einsum", "flash")


def resolve_impl(impl: str, device: torch.device) -> str:
    """'auto' -> 'flash' on CUDA, 'einsum' on the CPU; else `impl`, checked."""
    if impl == "auto":
        return "flash" if device.type == "cuda" else "einsum"
    if impl not in IMPLS:
        raise ValueError(f"impl must be 'auto' or one of {IMPLS}; got {impl!r}")
    return impl


def merge_hops(o_run: torch.Tensor, lse_run: torch.Tensor, o_i: torch.Tensor,
               lse_i: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two normalized attention outputs over disjoint key sets, merged by
    the two-softmax rule (JAX's ring_attention.py:96-100), in f32:
        m = max(lse_a, lse_b); w_i = exp(lse_i - m)
        o = (w_a o_a + w_b o_b) / (w_a + w_b); lse = m + log(w_a + w_b).
    o_* (B, Tl, H, hd) (o_run f32), lse_* (B, H, Tl) f32. Returns (o f32,
    lse)."""
    with exact_f32():
        m = torch.maximum(lse_run, lse_i)
        w_a, w_b = torch.exp(lse_run - m), torch.exp(lse_i - m)
        denom = w_a + w_b
        per_row = lambda w: w.transpose(1, 2)[..., None]  # noqa: E731  (B, Tl, H, 1)
        o = (per_row(w_a) * o_run + per_row(w_b) * o_i.float()) / per_row(denom)
        return o, m + torch.log(denom)


def _start_rotation(group, tensors: list) -> tuple[list, list]:
    """Send `tensors` to the next rank of the ring and receive the previous
    rank's into new buffers; returns (requests, buffers)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt, prv = ((r + 1) % n, (r - 1) % n) if group is None else \
        (dist.get_global_rank(group, (r + 1) % n), dist.get_global_rank(group, (r - 1) % n))
    bufs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors] + \
          [dist.P2POp(dist.irecv, b, prv, group) for b in bufs]
    return dist.batch_isend_irecv(ops), bufs


def _einsum_hop(q, k, v, mask, state):
    """One hop of the f32 online-softmax recurrence over a materialized score
    tile; state (m, l, acc) with acc (B, H, Tl, hd)."""
    m_run, l_run, acc = state
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
    valid = mask[:, None, None, :]
    s = torch.where(valid, s, MASK_VALUE)
    m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m_run - m_new)
    p = torch.where(valid, torch.exp(s - m_new), 0.0)
    l_new = alpha * l_run + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bhts,bshd->bhtd", p.to(v.dtype).float(), v.float())
    return m_new, l_new, acc


def ring_attention_local(q_l: torch.Tensor, k_l: torch.Tensor, v_l: torch.Tensor,
                         m_l: torch.Tensor, *, group=None, impl: str = "auto"
                         ) -> torch.Tensor:
    """The per-rank body of ring attention over `group` (None: the default
    group): q_l/k_l/v_l (B, Tl, H, hd) local token shards, m_l (B, Tl) the
    local key validity shard. Returns the local output (B, Tl, H, hd) in
    q_l's dtype. Also the attention of the sequence-parallel ViT
    (parallel/sp_vit.py)."""
    impl = resolve_impl(impl, q_l.device)
    n = dist.get_world_size(group)
    B, Tl, H, hd = q_l.shape
    k_c, v_c = k_l.contiguous(), v_l.contiguous()
    m_c = m_l.to(torch.bool).contiguous()
    with exact_f32():
        if impl == "einsum":
            state = (torch.full((B, H, Tl, 1), -math.inf, device=q_l.device),
                     torch.zeros((B, H, Tl, 1), device=q_l.device),
                     torch.zeros((B, H, Tl, hd), device=q_l.device))
        for hop in range(n):
            reqs = None
            if hop < n - 1:  # rotate between hops: n - 1 transfers
                reqs, bufs = _start_rotation(group, [k_c, v_c, m_c.view(torch.uint8)])
            if impl == "einsum":
                state = _einsum_hop(q_l, k_c, v_c, m_c, state)
            else:
                o_i, lse_i = flash_attention_lse(q_l, k_c, v_c, m_c)
                if hop == 0:
                    o_run, lse_run = o_i.float(), lse_i
                else:
                    o_run, lse_run = merge_hops(o_run, lse_run, o_i, lse_i)
            if reqs is not None:
                for req in reqs:
                    req.wait()
                k_c, v_c, m_c = bufs[0], bufs[1], bufs[2].view(torch.bool)
        if impl == "flash":
            return o_run.to(q_l.dtype)
        _, l_run, acc = state
        out = acc * torch.where(l_run == 0.0, 1.0, 1.0 / l_run)
    return out.permute(0, 2, 1, 3).to(q_l.dtype)


def ring_attention(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: Optional[torch.Tensor] = None, *, axis: str = MODEL_AXIS,
                   impl: str = "auto") -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + mask) v with the tokens sharded over the
    mesh dim `axis` (or over `mesh`, a process group): q/k/v are this
    rank's (B, Tl, H, hd) shards of a T = n Tl sequence (pad tokens and
    mask them to make T divide), kv_mask its (B, Tl) shard (None: all
    valid). Returns this rank's (B, Tl, H, hd) shard of the output, as the
    JAX function's output is sharded like q."""
    group = axis_group(mesh, axis)
    B, Tl = q.shape[:2]
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != q's {tuple(q.shape)}")
    if kv_mask is None:
        kv_mask = torch.ones((B, Tl), dtype=torch.bool, device=q.device)
    elif tuple(kv_mask.shape) != (B, Tl):
        raise ValueError(f"kv_mask shape {tuple(kv_mask.shape)} != {(B, Tl)}")
    return ring_attention_local(q, k, v, kv_mask, group=group, impl=impl)


def ring_attention_sharded(mesh, q, k, v, kv_mask=None, *, axis: str = MODEL_AXIS,
                           impl: str = "auto") -> torch.Tensor:
    """`ring_attention` from whole (B, T, H, hd) tensors (the same on every
    rank): takes this rank's token shard of each first. T must divide by
    the dim's size. Returns this rank's output shard."""
    group = axis_group(mesh, axis)
    n = dist.get_world_size(group)
    if q.shape[1] % n:
        raise ValueError(f"T={q.shape[1]} not divisible by {axis} axis ({n}); "
                         "pad tokens and extend kv_mask")
    q, k, v = (local_rows(group, x, dim=1) for x in (q, k, v))
    if kv_mask is not None:
        kv_mask = local_rows(group, kv_mask, dim=1)
    return ring_attention(group, q, k, v, kv_mask, axis=axis, impl=impl)
