"""Plain reference of the self-training step: a DINO ViT with a DeepLabV3+
head (Chen et al. 2018; the reference repo's semantic-segmentation/model),
per-pixel cross-entropy over all pixels, and AdamW (optax's `adamw` with
a linear decay of the rate to 0 over `max_steps`).

The head: a 1x1 ConvBNReLU of the low-level map (the 5th block from the
end, normed), an ASPP over the last block's normed map (a 1x1, three 3x3s
dilated 12/24/36, the global pool through a 1x1, a 1x1 projection, dropout
0.5), the ASPP output resized to the low-level grid, a 3x3 ConvBNReLU over
both and a 1x1 classifier; the logits are resized bilinearly to the image.
BatchNorm normalizes with the batch's E[x^2] - E[x]^2 (eps 1e-5), as flax
does; the dropout mask is drawn as `torch.rand(shape, generator) < 0.5`
from the generator the step is given. Only the last `trained` blocks and
the head train; the frozen blocks run without a graph.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .vit import Numerics, block, embed, layer_norm

RATES = (12, 24, 36)


def _conv_bn_relu(p, prefix, x, num, dilation=1):
    w = p[prefix + "conv.weight"]
    k = w.shape[-1]
    y = F.conv2d(num.q(x), num.q(w), None, padding=dilation * (k - 1) // 2, dilation=dilation)
    mean = y.mean(dim=(0, 2, 3))
    var = torch.clamp_min((y * y).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    mul = torch.rsqrt(var + 1e-5) * p[prefix + "bn.scale"].to(y.dtype)
    y = (y - mean[:, None, None]) * mul[:, None, None] + p[prefix + "bn.bias"].to(y.dtype)[:, None, None]
    return F.relu(y)


def logits(p: dict, cfg: dict, images: torch.Tensor, gen: torch.Generator, num: Numerics,
           trained: int = 1) -> torch.Tensor:
    """(B, C, H, W) training-mode logits of normalized (B, H, W, 3) images."""
    B, H, W, _ = images.shape
    g = H // cfg["patch_size"]
    depth, D = cfg["depth"], cfg["embed_dim"]
    x = embed(p, cfg, images, num)
    inters = []
    for i in range(depth):
        with torch.set_grad_enabled(i >= depth - trained):
            x = block(p, i, x, cfg, num)
        if depth - i <= 5:
            inters.append(layer_norm(x, p, "norm"))
    low, out = (t[:, 1:].reshape(B, g, g, D).permute(0, 3, 1, 2) for t in (inters[0], inters[-1]))
    ll = _conv_bn_relu(p, "head.low.", low, num)
    branches = [_conv_bn_relu(p, "head.aspp.convs.0.", out, num)]
    branches += [_conv_bn_relu(p, f"head.aspp.convs.{i + 1}.", out, num, r)
                 for i, r in enumerate(RATES)]
    pooled = _conv_bn_relu(p, "head.aspp.pool.", out.mean(dim=(2, 3), keepdim=True), num)
    branches.append(pooled.expand(-1, -1, g, g))
    y = _conv_bn_relu(p, "head.aspp.project.", torch.cat(branches, dim=1), num)
    keep = torch.rand(y.shape, generator=gen, device=y.device) < 0.5
    y = torch.where(keep, y / 0.5, torch.zeros_like(y))
    if y.shape[2:] != ll.shape[2:]:
        y = F.interpolate(y, size=ll.shape[2:], mode="bilinear", align_corners=False)
    y = _conv_bn_relu(p, "head.fuse.", torch.cat([ll, y], dim=1), num)
    z = F.conv2d(num.q(y), num.q(p["head.classifier.weight"]),
                 p["head.classifier.bias"].to(y.dtype))
    return F.interpolate(z, size=(H, W), mode="bilinear", align_corners=False)


def loss(z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over all pixels; z (B, C, H, W), labels (B, H, W)."""
    return -torch.log_softmax(z, dim=1).gather(1, labels[:, None].long()).mean()


def trained_names(p: dict, cfg: dict, trained: int = 1) -> list[str]:
    """The leaves that train: the last `trained` blocks and the head
    (not its BatchNorm statistics)."""
    blocks = tuple(f"blocks.{cfg['depth'] - 1 - i}." for i in range(trained))
    return [n for n in p if n.startswith(blocks)
            or (n.startswith("head.") and not n.endswith((".bn.mean", ".bn.var")))]


class AdamW:
    """optax adamw(linear_schedule(lr, 0, max_steps), weight_decay)."""

    def __init__(self, leaves: dict, lr: float, weight_decay: float, max_steps: int,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.leaves, self.lr, self.wd, self.max_steps = leaves, lr, weight_decay, max_steps
        self.b1, self.b2, self.eps, self.count = b1, b2, eps, 0
        self.mu = {n: torch.zeros_like(v) for n, v in leaves.items()}
        self.nu = {n: torch.zeros_like(v) for n, v in leaves.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        rate = self.lr * (1 - min(self.count, self.max_steps) / self.max_steps)
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for n, g in grads.items():
            self.mu[n] = self.b1 * self.mu[n] + (1 - self.b1) * g
            self.nu[n] = self.b2 * self.nu[n] + (1 - self.b2) * g * g
            u = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + self.eps)
            self.leaves[n] -= rate * (u + self.wd * self.leaves[n])


def first_steps(weights: dict, cfg: dict, batches: list, seed_gen: torch.Generator,
                num: Numerics, opt: dict, trained: int = 1, keep: slice = slice(None)) -> dict:
    """Run the steps of `batches` ((images, labels) each) from `weights`:
    per-step losses, each trained leaf's first gradient norm and its change
    norm after the last step. `keep` takes rows of every batch (a fault
    that leaves part of the batch out)."""
    p = {n: v.detach().to(num.dtype).clone() for n, v in weights.items()}
    names = trained_names(p, cfg, trained)
    start = {n: p[n].clone() for n in names}
    adam = AdamW({n: p[n] for n in names}, **opt)
    losses, grad1 = [], None
    for images, labels in batches:
        for n in names:
            p[n].requires_grad_(True)
        L = loss(logits(p, cfg, images[keep].to(num.dtype), seed_gen, num, trained), labels[keep])
        grads = torch.autograd.grad(L, [p[n] for n in names])
        for n in names:
            p[n] = p[n].detach()
        adam.leaves = {n: p[n] for n in names}
        adam.step(dict(zip(names, grads)))
        losses.append(float(L.detach()))
        if grad1 is None:
            grad1 = {n: float(torch.linalg.vector_norm(g.double())) for n, g in zip(names, grads)}
    change = {n: float(torch.linalg.vector_norm((p[n] - start[n]).double())) for n in names}
    return {"losses": losses, "grad1": grad1, "change": change}
