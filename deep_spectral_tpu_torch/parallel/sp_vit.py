"""Sequence-parallel ViT forward: the token dimension sharded over a mesh dim.

The port of `deep_spectral_tpu.parallel.sp_vit`. For token counts that
outgrow one card (P=8 backbones beyond ~540 px), every row-wise op of the
transformer (LayerNorm, the qkv/proj/MLP matmuls with replicated weights)
runs on each rank's token shard as it is, and attention runs as ring
attention over the dim (`ring_attention_local`): no activation is ever
gathered, and a rank's memory is O(T / n).

The blocks are the port's `VisionTransformer` modules, applied piece by
piece (`embed`, `Attention.qkv_heads`, `Mlp` and the `_layer_norm` /
`_linear` helpers), so the precision recipe is the single-card model's:
matmuls in the model's compute dtype, f32 LayerNorm, tanh GELU in bf16,
true f32 in fp32 (`model.precision()`). The model's compute dtype takes the
place of the JAX functions' `precision` argument.

attn_impl: 'einsum' or 'flash' ring hops (see `ring_attention_local`);
'auto' is 'flash' on CUDA and 'einsum' on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.vit import VisionTransformer, _layer_norm, _linear
from .mesh import MODEL_AXIS, axis_group, local_rows, replicate, require_dino_v1
from .ring_attention import resolve_impl, ring_attention_local


def _embed_tokens(model: VisionTransformer, images: torch.Tensor,
                  token_mask: Optional[torch.Tensor], n_shards: int):
    """Replicated front end (patch embed + CLS + interpolated pos embeds, in
    the compute dtype), padded with masked tokens to a multiple of
    `n_shards`; returns (tokens (B, Tp, D), mask (B, Tp) bool, T valid)."""
    tokens, mask = model.embed(images, token_mask)
    B, T = tokens.shape[:2]
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.bool, device=tokens.device)
    pad = -T % n_shards
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
        mask = F.pad(mask, (0, pad))
    return tokens, mask, T


def _attention_sublayers(blk, tok, qkv, mask_l, group, impl, dtype):
    """The rest of a block after its qkv projection: ring attention, proj,
    and the MLP sublayer, on the local token shard."""
    B, Tl, D = tok.shape
    q, k, v = qkv.unbind(2)
    o = ring_attention_local(q, k, v, mask_l, group=group, impl=impl)
    tok = tok + _linear(o.reshape(B, Tl, D), blk.attn.proj, dtype)
    return tok + blk.mlp(_layer_norm(tok, blk.norm2), dtype)


def _shard_setup(mesh, axis, model, images, token_mask):
    group = axis_group(mesh, axis)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    tokens, mask, T = _embed_tokens(model, images, token_mask, n)
    tok_l, mask_l = local_rows(group, tokens, 1), local_rows(group, mask, 1)
    # this rank's rows that are real tokens: [r Tl, min((r + 1) Tl, T))
    valid = max(min(T - r * tok_l.shape[1], tok_l.shape[1]), 0)
    return group, r, tok_l, mask_l, valid


@torch.no_grad()
def sp_vit_forward(mesh, model: VisionTransformer, images: torch.Tensor,
                   token_mask: Optional[torch.Tensor] = None, *, qkv_block: int = -1,
                   n_intermediates: int = 1, axis: str = MODEL_AXIS,
                   attn_impl: str = "auto") -> dict:
    """Token-sharded full ViT forward over the mesh dim `axis` (or over
    `mesh`, a process group). images (B, H, W, 3) and token_mask (B, N) are
    the same on every rank. Returns the single-card output dict over this
    rank's token rows [r Tl, min((r + 1) Tl, T)) of the 1 + N (padding
    dropped; concatenating the ranks' rows gives the whole sequence):
    'x_norm' (B, rows, D) f32, 'qkv' {'q', 'k', 'v'} head-merged (B, rows,
    D) f32 of block `qkv_block`, 'intermediates' the final-normed outputs of
    the last `n_intermediates` blocks, and 'cls' (B, D), replicated on every
    rank of the dim. DINO v1 only."""
    cfg, dtype = model.cfg, model.compute_dtype
    require_dino_v1(cfg, "sp_vit_forward")
    qkv_block = qkv_block % cfg.depth
    with model.precision():
        group, r, tok_l, mask_l, valid = _shard_setup(mesh, axis, model, images, token_mask)
        impl = resolve_impl(attn_impl, tok_l.device)
        B, Tl, D = tok_l.shape
        qkv_l, inters = None, []
        for i, blk in enumerate(model.blocks):
            qkv = blk.attn.qkv_heads(_layer_norm(tok_l, blk.norm1), dtype)
            if i == qkv_block:
                qkv_l = {name: qkv[:, :valid, j].reshape(B, valid, D).float()
                         for j, name in enumerate("qkv")}
            tok_l = _attention_sublayers(blk, tok_l, qkv, mask_l, group, impl, dtype)
            if cfg.depth - i <= n_intermediates:
                inters.append(_layer_norm(tok_l, model.norm))
        x_norm_l = inters[-1] if inters else _layer_norm(tok_l, model.norm)
        cls = replicate(group, x_norm_l[:, 0].clone())  # a view would take rank 0's row
    return {"x_norm": x_norm_l[:, :valid], "cls": cls, "qkv": qkv_l,
            "intermediates": tuple(x[:, :valid] for x in inters)}


@torch.no_grad()
def sp_patch_features(mesh, model: VisionTransformer, images: torch.Tensor,
                      token_mask: Optional[torch.Tensor] = None, *, which_block: int = -1,
                      axis: str = MODEL_AXIS, attn_impl: str = "auto") -> torch.Tensor:
    """Token-sharded `extract_patch_keys`: the head-merged keys of
    `which_block` over this rank's patch rows (CLS and padding dropped;
    concatenating the ranks' rows gives (B, N, D)), f32. Exits the block
    stack at `which_block`: its keys come from its qkv projection, which
    neither its attention nor a later block can change. DINO v1 only."""
    cfg, dtype = model.cfg, model.compute_dtype
    require_dino_v1(cfg, "sp_patch_features")
    which_block = which_block % cfg.depth
    with model.precision():
        group, r, tok_l, mask_l, valid = _shard_setup(mesh, axis, model, images, token_mask)
        impl = resolve_impl(attn_impl, tok_l.device)
        B, Tl, D = tok_l.shape
        for i, blk in enumerate(model.blocks):
            qkv = blk.attn.qkv_heads(_layer_norm(tok_l, blk.norm1), dtype)
            if i == which_block:
                start = 1 if r == 0 else 0
                return qkv[:, start:valid, 1].reshape(B, max(valid - start, 0), D).float()
            tok_l = _attention_sublayers(blk, tok_l, qkv, mask_l, group, impl, dtype)
    raise AssertionError("unreachable: which_block in range(depth)")
