"""Seeded weights of the benchmark, made on the device in one draw.

No checkpoint is in the repository, so every cell runs seeded random weights
at the published widths. They are the benchmark's, not the port's: one
`torch.randn` of every parameter at once, from a generator on the device
seeded with the run's seed, scaled per tensor (weights N(0, 1/fan_in), the
LeCun scale DINO's random init uses; biases, norms' offsets and positional
embeddings N(0, 0.02^2); norms' scales 1 + N(0, 0.02^2)). The same state
dict is loaded into the port (`load_state_dict`, the path a DINO checkpoint
takes) and handed to the reference. Names are DINO's for the ViT and the
port's `DeepLabHeadV3Plus` names for the head.
"""
from __future__ import annotations

import math

import torch

HEAD_CHANNELS, LOW_CHANNELS, ASPP_RATES = 256, 48, (12, 24, 36)


def vit_shapes(cfg: dict) -> dict:
    """name -> (shape, kind) of a DINO ViT's parameters; kind is 'weight'
    (fan-in scaled), 'small' (N(0, 0.02^2)), 'scale' (1 + small) or 'zero'."""
    D, P, depth = cfg["embed_dim"], cfg["patch_size"], cfg["depth"]
    hidden = int(D * cfg["mlp_ratio"])
    grid = cfg["img_size"] // P
    shapes = {"cls_token": ((1, 1, D), "small"),
              "pos_embed": ((1, 1 + grid * grid, D), "small"),
              "patch_embed.proj.weight": ((D, 3, P, P), "weight"),
              "patch_embed.proj.bias": ((D,), "small")}
    for i in range(depth):
        b = f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            shapes[b + norm + ".weight"] = ((D,), "scale")
            shapes[b + norm + ".bias"] = ((D,), "small")
        for name, (out, inp) in (("attn.qkv", (3 * D, D)), ("attn.proj", (D, D)),
                                 ("mlp.fc1", (hidden, D)), ("mlp.fc2", (D, hidden))):
            shapes[b + name + ".weight"] = ((out, inp), "weight")
            shapes[b + name + ".bias"] = ((out,), "small")
    shapes["norm.weight"] = ((D,), "scale")
    shapes["norm.bias"] = ((D,), "small")
    return shapes


def head_shapes(cfg: dict, num_classes: int) -> dict:
    """name -> (shape, kind) of the DeepLabV3+ head over the ViT (its BN
    statistics are 'zero' means and 'one' variances)."""
    D, C = cfg["embed_dim"], HEAD_CHANNELS
    shapes = {}

    def conv_bn(prefix, out, inp, k):
        shapes[prefix + "conv.weight"] = ((out, inp, k, k), "weight")
        shapes[prefix + "bn.scale"] = ((out,), "scale")
        shapes[prefix + "bn.bias"] = ((out,), "small")
        shapes[prefix + "bn.mean"] = ((out,), "zero")
        shapes[prefix + "bn.var"] = ((out,), "one")

    conv_bn("head.low.", LOW_CHANNELS, D, 1)
    conv_bn("head.aspp.convs.0.", C, D, 1)
    for i in range(len(ASPP_RATES)):
        conv_bn(f"head.aspp.convs.{i + 1}.", C, D, 3)
    conv_bn("head.aspp.pool.", C, D, 1)
    conv_bn("head.aspp.project.", C, C * (len(ASPP_RATES) + 2), 1)
    conv_bn("head.fuse.", C, LOW_CHANNELS + C, 3)
    shapes["head.classifier.weight"] = ((num_classes, C, 1, 1), "weight")
    shapes["head.classifier.bias"] = ((num_classes,), "small")
    return shapes


@torch.no_grad()
def seeded_weights(shapes: dict, seed: int, device) -> dict:
    """name -> f32 tensor on `device`: one draw of every entry of `shapes`
    from a generator on `device` seeded with `seed`, scaled by kind."""
    total = sum(math.prod(s) for s, _ in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, (shape, kind) in shapes.items():
        n = math.prod(shape)
        x = flat[off:off + n].view(shape)
        off += n
        if kind == "weight":
            x = x * (1.0 / math.sqrt(n // shape[0]))
        elif kind == "small":
            x = x * 0.02
        elif kind == "scale":
            x = 1.0 + 0.02 * x
        elif kind == "zero":
            x = torch.zeros_like(x)
        elif kind == "one":
            x = torch.ones_like(x)
        else:
            raise ValueError(f"unknown kind {kind!r}")
        out[name] = x
    return out
