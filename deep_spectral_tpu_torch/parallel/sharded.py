"""Sharded entry points for the pipeline's heavy paths.

The port of `deep_spectral_tpu.parallel.sharded`. Two dims of scale:

  * data — many images: the batched ViT forward and the batched spectral
    decomposition run on each rank's block of the batch (kernel 1, kernel
    2), replacing the reference's DDP and its CPU process pool over images;
  * model — one big model or one huge graph: Megatron tensor parallelism of
    the ViT (each rank runs kernel 1 on its heads, one all-reduce per
    sublayer), and the Laplacian eigensolve of one (N, N) affinity whose
    rows are sharded (each LOBPCG matvec multiplies the local rows, then
    all-gathers them).

JAX annotates shardings and XLA inserts the collectives; here every rank
runs its block and the collectives are explicit.
"""
from __future__ import annotations

import re
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.vit import VisionTransformer, _layer_norm, attend, extract_patch_keys
from ..ops.affinity import degree_vector
from ..ops.eigen import _as_vectors, _start_block, spectral_decompose_batched
from ..ops.lobpcg import lobpcg_standard
from ..utils.precision import exact_f32
from .mesh import (DATA_AXIS, MODEL_AXIS, axis_group, gather_rows, local_rows,
                   require_dino_v1)


def _group_or_first(mesh, axis: str):
    """`axis`'s group, or the mesh's only dim when `axis` is not one of its
    names (the JAX functions' fallback on a 1-D mesh)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None and axis not in names:
        axis = names[-1]
    return axis_group(mesh, axis)


def sharded_spectral_decompose(mesh, feats: torch.Tensor,
                               masks: Optional[torch.Tensor] = None,
                               color_W: Optional[torch.Tensor] = None, *, K: int = 5,
                               axis: str = DATA_AXIS, **kwargs):
    """Data-parallel `spectral_decompose_batched`: feats (b, N, D), masks
    (b, N) and color_W (b, N, N) are this rank's block of the batch (every
    rank's block the same size: pad with masked dummy images); each rank
    solves its block, and the results of every rank are gathered in rank
    order: eigenvalues (B, K), eigenvectors (B, K, N) on every rank."""
    group = axis_group(mesh, axis)
    out = spectral_decompose_batched(feats, masks, color_W, K=K, **kwargs)
    return tuple(gather_rows(group, o) for o in out)


def sharded_patch_features(mesh, model: VisionTransformer, images: torch.Tensor,
                           token_mask: Optional[torch.Tensor] = None,
                           which_block: int = -1, axis: str = DATA_AXIS) -> torch.Tensor:
    """Data-parallel `extract_patch_keys`: the weights replicated, images
    (b, H, W, 3) and token_mask (b, N) this rank's block of the batch.
    Returns this rank's (b, N, D) keys, as the JAX function's output is
    sharded like its batch."""
    axis_group(mesh, axis)  # the dim must exist
    return extract_patch_keys(model, images, which_block=which_block, token_mask=token_mask)


def tensor_parallel_param_shardings(params) -> dict:
    """Megatron's plan for the ViT's parameters (a `VisionTransformer` or its
    state dict), by name: 'column' for the
    qkv and mlp.fc1 weights and biases (their output features split over
    the ranks; a torch Linear weight is (out, in), so its rows), 'row' for
    the attn.proj and mlp.fc2 weights (their input features split: the
    weight's columns), 'replicated' for everything else (norms, embeddings,
    and the proj / fc2 biases, added once after the all-reduce)."""
    names = params.keys() if isinstance(params, dict) else \
        [name for name, _ in params.named_parameters()]
    plan = {}
    for name in names:
        if re.search(r"\.(attn\.qkv|mlp\.fc1)\.(weight|bias)$", name):
            plan[name] = "column"
        elif re.search(r"\.(attn\.proj|mlp\.fc2)\.weight$", name):
            plan[name] = "row"
        else:
            plan[name] = "replicated"
    return plan


def _tp_block_weights(blk, r: int, n: int, num_heads: int) -> dict:
    """Rank r's shard of a block: its heads' rows of q, of k and of v in the
    fused qkv, the matching input columns of proj, and its chunk of fc1's
    outputs and fc2's inputs."""
    D = blk.attn.qkv.in_features
    hd, Hl = D // num_heads, num_heads // n
    heads = slice(r * Hl * hd, (r + 1) * Hl * hd)
    hidden_l = blk.mlp.fc1.out_features // n
    hid = slice(r * hidden_l, (r + 1) * hidden_l)
    qkv_w = blk.attn.qkv.weight.reshape(3, D, D)[:, heads].reshape(3 * Hl * hd, D)
    qkv_b = blk.attn.qkv.bias.reshape(3, D)[:, heads].reshape(-1)
    return {"qkv_w": qkv_w, "qkv_b": qkv_b, "proj_w": blk.attn.proj.weight[:, heads],
            "fc1_w": blk.mlp.fc1.weight[hid], "fc1_b": blk.mlp.fc1.bias[hid],
            "fc2_w": blk.mlp.fc2.weight[:, hid]}


def _row_parallel(x, weight, bias, group, dtype):
    """x (.., in/n) times this rank's columns of a row-parallel weight, the
    partial products summed over the group in f32, the bias added once."""
    part = F.linear(x.to(dtype), weight.to(dtype)).float()
    if dist.get_world_size(group) > 1:
        dist.all_reduce(part, group=group)
    return (part + bias.float()).to(dtype)


@torch.no_grad()
def tp_sharded_patch_features(mesh, model: VisionTransformer, images: torch.Tensor,
                              token_mask: Optional[torch.Tensor] = None,
                              which_block: int = -1, axis: str = MODEL_AXIS) -> torch.Tensor:
    """`extract_patch_keys` with Megatron tensor parallelism over the mesh dim
    `axis` (TP over the only dim of a 1-D mesh): each rank takes its heads
    of q, of k and of v, with the matching fc1 outputs and proj / fc2
    inputs (`tensor_parallel_param_shardings`), runs its heads' attention
    by the model's route (kernel 1 on CUDA in bf16), and sums each
    sublayer's row-parallel product with one all-reduce. images (b, H, W, 3)
    and token_mask (b, N) are this rank's block of the batch over the data
    dim of a 2-D mesh (the same on every rank of `axis`). The keys are
    gathered back along heads: (b, N, D) on every rank of `axis`. DINO v1
    only."""
    require_dino_v1(model.cfg, "tp_sharded_patch_features")
    group = _group_or_first(mesh, axis)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    cfg, dtype = model.cfg, model.compute_dtype
    H = cfg.num_heads
    hidden = model.blocks[0].mlp.fc1.out_features
    if H % n or hidden % n:
        raise ValueError(f"{H} heads and {hidden} MLP features must divide by {n} ranks")
    last = which_block % cfg.depth
    gelu = "tanh" if dtype == torch.bfloat16 else "none"
    with model.precision():
        x, mask = model.embed(images, token_mask)
        B, T, D = x.shape
        for i, blk in enumerate(model.blocks[:last + 1]):
            w = _tp_block_weights(blk, r, n, H)
            qkv = F.linear(_layer_norm(x, blk.norm1).to(dtype), w["qkv_w"].to(dtype),
                           w["qkv_b"].to(dtype)).reshape(B, T, 3, H // n, D // H)
            if i == last:
                keys = gather_rows(group, qkv[:, 1:, 1].contiguous(), dim=2)
                return keys.reshape(B, T - 1, D)
            o, _ = attend(qkv, mask, blk.attn.attention_impl, dtype)
            x = x + _row_parallel(o.reshape(B, T, -1), w["proj_w"], blk.attn.proj.bias,
                                  group, dtype)
            h = F.linear(_layer_norm(x, blk.norm2).to(dtype), w["fc1_w"].to(dtype),
                         w["fc1_b"].to(dtype))
            x = x + _row_parallel(F.gelu(h, approximate=gelu), w["fc2_w"],
                                  blk.mlp.fc2.bias, group, dtype)
    raise AssertionError("unreachable: which_block in range(depth)")


@torch.no_grad()
def row_sharded_laplacian_eigs(mesh, W: torch.Tensor, K: int, *, iters: int = 120,
                               mask: Optional[torch.Tensor] = None,
                               apply_sign_fix: bool = True, x0=None,
                               axis: str = MODEL_AXIS):
    """The smallest-K eigenpairs of one graph's normalized Laplacian, the
    (N, N) affinity row-sharded over the mesh dim `axis` (the only dim of a
    1-D mesh): W (N/n, N) and mask (N/n,) are this rank's row block (N must
    divide by n: pad with masked rows). The same solve as
    `lobpcg_laplacian_eigs` (block LOBPCG on the Gershgorin-shifted
    whitened operator), with the degree vector all-gathered, the shift's
    row maximum all-reduced (MAX), and each matvec a product of the local
    rows all-gathered; the Rayleigh-Ritz steps run replicated on the
    gathered block, which is the same on every rank, so every rank computes
    the same bits. x0: the (N, K + 3) start block. Returns eigenvalues (K,)
    and eigenvectors (K, N) on every rank. Unlike the single-graph solver,
    a non-finite result is not re-solved by dense eigh (no rank holds W)."""
    group = _group_or_first(mesh, axis)
    n = dist.get_world_size(group)
    Nl, N = W.shape
    if Nl * n != N:
        raise ValueError(f"W's row block ({Nl}, {N}) is not 1/{n} of an (N, N) graph: "
                         "N must divide by the group's size (pad with masked rows)")
    W = W.float()
    mask_full = None
    with exact_f32():
        if mask is not None:
            mask_full = gather_rows(group, mask.to(torch.bool).contiguous())
            W = W * mask.to(W.dtype)[:, None] * mask_full.to(W.dtype)[None, :]
        d = gather_rows(group, degree_vector(W))
        s = torch.rsqrt(d)
        s_loc = local_rows(group, s)
        c = 1.0 + (s_loc[:, None] * W * s[None, :]).abs().sum(dim=1).amax()
        if n > 1:
            dist.all_reduce(c, op=dist.ReduceOp.MAX, group=group)

        def mv(X):  # (1, N, m) -> (1, N, m): (c - 1) I + D^-1/2 W D^-1/2
            Xl = local_rows(group, X[0])
            local = (c - 1.0) * Xl + s_loc[:, None] * (W @ (s[:, None] * X[0]))
            return gather_rows(group, local)[None]

        masks = None if mask_full is None else mask_full[None]
        X0 = _start_block(x0, 1, N, K + 3, masks, W.device)
        theta, V, _ = lobpcg_standard(mv, X0, m=iters)
    V = torch.rsqrt(d)[None, :, None] * V[:, :, :K]
    return (c - theta)[0, :K], _as_vectors(V, masks, apply_sign_fix)[0]
