"""Pipeline-parallel ViT forward: a GPipe schedule over a mesh dim.

The port of `deep_spectral_tpu.parallel.pp_vit`. The transformer's `depth`
blocks are split into S stages, one per rank of the mesh dim (`axis`), and
each rank builds and holds only its stage's L = depth / S blocks
(`build_stage`: a `VisionTransformer` of depth L, with the front end and
the final norm, which every rank holds as the JAX version replicates
them). Microbatches flow stage to stage by point-to-point sends: at tick t
of the M + S - 1, stage s runs microbatch t - s; the bubble ticks, inert in
the JAX version, are skipped. The last stage's final-normed output reaches
every rank of the dim by a broadcast, as the JAX version's `psum` makes it
replicated.

Blocks run through the port's `Block.forward`, so the stage's
`attention_impl` takes the single-card model's routes: on CUDA with 'flash'
(or 'auto'), kernel 1 (`flash_attention_packed`) in bf16 and kernel 3's f32
build in fp32. On a 2-D mesh (PP x DP) each data row runs its own pipeline
over its rank's local batch; nothing crosses the data dim.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch
import torch.distributed as dist

from ..models.vit import VisionTransformer, ViTConfig, _layer_norm
from ..utils.device import resolve_device
from .mesh import MODEL_AXIS, axis_group, replicate, require_dino_v1


def build_stage(cfg: ViTConfig, state_dict: dict, mesh, *, axis: str = MODEL_AXIS,
                compute_dtype: torch.dtype = torch.float32, attention_impl: str = "auto",
                device: str | torch.device | None = None) -> VisionTransformer:
    """This rank's pipeline stage of the ViT `cfg`: a `VisionTransformer` of
    depth L holding blocks s L .. s L + L - 1 of the full model's DINO-named
    `state_dict` (renumbered from 0), its front end and its final norm, in
    eval mode on `device` (CUDA unless the caller asks for the CPU; a CUDA
    device with no card raises RuntimeError). DINO v1 only."""
    require_dino_v1(cfg, "build_stage")
    device = resolve_device(device, "build_stage")
    group = axis_group(mesh, axis)
    S, s = dist.get_world_size(group), dist.get_rank(group)
    if cfg.depth % S:
        raise ValueError(f"depth {cfg.depth} not divisible by {S} stages")
    L = cfg.depth // S
    stage = VisionTransformer(dataclasses.replace(cfg, depth=L), compute_dtype,
                              attention_impl)
    own = {}
    for name, value in state_dict.items():
        m = re.match(r"blocks\.(\d+)\.(.*)", name)
        if m is None:
            own[name] = value
        elif s * L <= int(m.group(1)) < (s + 1) * L:
            own[f"blocks.{int(m.group(1)) - s * L}.{m.group(2)}"] = value
    stage.load_state_dict(own, strict=True)
    return stage.to(device).eval()


@torch.no_grad()
def pp_vit_forward(mesh, stage: VisionTransformer, images: torch.Tensor,
                   token_mask: Optional[torch.Tensor] = None, *,
                   n_microbatches: Optional[int] = None,
                   axis: str = MODEL_AXIS) -> dict:
    """Pipeline-parallel ViT forward over the mesh dim `axis` (or over
    `mesh`, a process group), with this rank's `stage` (`build_stage`).
    images (B, H, W, 3) and token_mask (B, N) are this rank's local batch,
    the same on every rank of the dim. B must divide by n_microbatches
    (default: min(S, B), a full pipeline). Returns {'x_norm': (B, 1+N, D)
    f32, 'cls': (B, D)}, the single-card forward's, on every rank of the
    dim. DINO v1 only."""
    require_dino_v1(stage.cfg, "pp_vit_forward")
    group = axis_group(mesh, axis)
    S, s = dist.get_world_size(group), dist.get_rank(group)
    B, Hi, Wi, _ = images.shape
    M = n_microbatches or min(S, B)
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    mb = B // M
    cfg, dtype = stage.cfg, stage.compute_dtype
    P = cfg.patch_size
    T, D = 1 + (Hi // P) * (Wi // P), cfg.embed_dim
    dev = images.device
    mask = None
    if token_mask is not None:
        mask = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                          token_mask.to(torch.bool)], dim=1)
    prev = dist.get_global_rank(group, s - 1) if s > 0 and group is not None else s - 1
    nxt = dist.get_global_rank(group, s + 1) if s < S - 1 and group is not None else s + 1
    sends, outs = [], []
    with stage.precision():
        tokens = stage.embed(images, token_mask)[0] if s == 0 else None
        for t in range(M + S - 1):
            m = t - s
            if not 0 <= m < M:
                continue  # a bubble tick
            rows = slice(m * mb, (m + 1) * mb)
            if s == 0:
                x = tokens[rows]
            else:
                x = torch.empty((mb, T, D), dtype=dtype, device=dev)
                dist.recv(x, src=prev, group=group)
            for blk in stage.blocks:
                x = blk(x, None if mask is None else mask[rows], False, dtype)[0]
            if s < S - 1:
                x = x.contiguous()
                sends.append((dist.isend(x, dst=nxt, group=group), x))
            else:
                outs.append(_layer_norm(x, stage.norm))
        for req, _ in sends:
            req.wait()
        x_norm = torch.cat(outs) if s == S - 1 else \
            torch.empty((B, T, D), dtype=torch.float32, device=dev)
        x_norm = replicate(group, x_norm, src=S - 1)
    return {"x_norm": x_norm, "cls": x_norm[:, 0]}
