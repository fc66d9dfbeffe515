"""DeepLabV3/V3+ heads over the DINO ViT backbone (`DeepLabViT`) or a dilated
ResNet-50 (`DeepLabResNet`): the port of `deep_spectral_tpu.models.deeplab`
(the reference's self-training model, semantic-segmentation/model/model.py).

The public layout is the JAX package's: images (B, H, W, 3) in, logits
(B, H, W, num_classes) out; inside, the head runs NCHW convolutions.
`model.train()` / `model.eval()` take the place of flax's `train` argument.

Numerics follow flax:
  * BatchNorm normalizes with the batch's biased variance E[x^2] - E[x]^2
    (clipped at 0) and keeps running statistics with momentum 0.9 on that
    same biased variance (torch's BatchNorm2d keeps the unbiased one);
  * the head runs in true f32 (no TF32): its inputs come out of the f32
    final LayerNorm even under a bf16 backbone;
  * the ASPP dropout (rate 0.5) keeps with probability 0.5 and scales by 2,
    drawing from the `generator` passed to `forward` (the port of the train
    step's dropout rng);
  * a `spatial_mask` (bucket-padded evaluation) re-zeroes padded cells after
    every conv so padding stays exactly inert.

Data-parallel training (`data_parallel_`, one process per device): each
rank holds a block of the global batch; BatchNorm normalizes with the
statistics of the GLOBAL batch (sums of x and x^2 all-reduced, with their
gradient all-reduced in the backward), as the JAX model's batch-global BN
under a sharded batch (and unlike torch's SyncBatchNorm, which is CUDA-only
and keeps another variance), and the dropout draws the global batch's mask
and takes the rank's block of it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear, resize_bilinear_mm
from ..parallel.distributed import all_sum_differentiable
from ..utils.precision import exact_f32
from .vit import ViTConfig, VisionTransformer

HEADS = ("deeplabv3plus", "deeplabv3")


def _dp_size(group) -> int:
    """The data-parallel group's size (1 without one)."""
    return 1 if group is None else dist.get_world_size(group)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            group=None) -> torch.Tensor:
    """flax `nn.Dropout(rate)` in training: keep with probability 1 - rate,
    scale kept values by 1 / (1 - rate). With a data-parallel `group`, x is
    this rank's block of the global batch: the mask is drawn for the whole
    batch and this rank takes its block of it."""
    keep_prob = 1.0 - rate
    n = _dp_size(group)
    shape = (x.shape[0] * n, *x.shape[1:])
    keep = torch.rand(shape, generator=generator, device=x.device) < keep_prob
    if n > 1:
        keep = keep[dist.get_rank(group) * x.shape[0]:][:x.shape[0]]
    return torch.where(keep, x / keep_prob, 0.0)


def flax_batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    mean_buf: torch.Tensor, var_buf: torch.Tensor, training: bool,
                    momentum: float = 0.9, eps: float = 1e-5, group=None) -> torch.Tensor:
    """flax `nn.BatchNorm` over NCHW channels: in training, the batch's mean
    and biased variance, and the running buffers updated in place with
    `momentum`; in evaluation, the buffers. With a data-parallel `group` of
    more than one rank, x is this rank's block of the global batch (blocks of
    one size) and the statistics are the global batch's."""
    if training:
        n = _dp_size(group)
        if n == 1:
            mean = x.mean(dim=(0, 2, 3))
            mean2 = (x * x).mean(dim=(0, 2, 3))
        else:
            sums = all_sum_differentiable(
                torch.stack([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3))]), group)
            count = n * (x.numel() // x.shape[1])
            mean, mean2 = sums[0] / count, sums[1] / count
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            mean_buf.copy_(momentum * mean_buf + (1 - momentum) * mean)
            var_buf.copy_(momentum * var_buf + (1 - momentum) * var)
    else:
        mean, var = mean_buf, var_buf
    mul = torch.rsqrt(var + eps) * scale
    return (x - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` over NCHW channels.
    Parameters `scale`, `bias`; buffers `mean`, `var` (flax's batch_stats)."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.dp_group = None  # set by `data_parallel_`

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_batch_norm(x, self.scale, self.bias, self.mean, self.var,
                               self.training, self.momentum, self.eps, self.dp_group)


class ConvBNReLU(nn.Module):
    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 dilation: int = 1, use_relu: bool = True):
        super().__init__()
        pad = dilation * (kernel - 1) // 2
        self.conv = nn.Conv2d(in_features, features, kernel, padding=pad,
                              dilation=dilation, bias=False)
        self.bn = BatchNorm(features)
        self.use_relu = use_relu

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """`mask` ((B, 1, H, W)): zeroing padded positions makes the next
        conv's zero padding at the valid-region border the same as an
        unpadded forward's."""
        x = self.bn(self.conv(x))
        x = F.relu(x) if self.use_relu else x
        return x if mask is None else x * mask


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (torchvision semantics): 1x1 conv, three
    dilated 3x3 convs, a global-pooling branch, concat -> 1x1 project +
    dropout."""

    def __init__(self, in_features: int, out_features: int = 256,
                 atrous_rates: Sequence[int] = (12, 24, 36)):
        super().__init__()
        self.convs = nn.ModuleList(
            [ConvBNReLU(in_features, out_features, kernel=1)]
            + [ConvBNReLU(in_features, out_features, kernel=3, dilation=r)
               for r in atrous_rates])
        self.pool = ConvBNReLU(in_features, out_features, kernel=1)
        self.project = ConvBNReLU(out_features * (len(atrous_rates) + 2),
                                  out_features, kernel=1)
        self.dp_group = None  # set by `data_parallel_`

    def forward(self, x, mask=None, generator=None):
        branches = [conv(x, mask) for conv in self.convs]
        if mask is None:  # global pooling over the valid region only
            g = x.mean(dim=(2, 3), keepdim=True)
        else:
            g = (x * mask).sum(dim=(2, 3), keepdim=True) / \
                torch.clamp(mask.sum(dim=(2, 3), keepdim=True), min=1.0)
        g = self.pool(g).expand(-1, -1, *x.shape[2:])
        branches.append(g if mask is None else g * mask)
        y = self.project(torch.cat(branches, dim=1), mask)
        return dropout(y, 0.5, generator, self.dp_group) if self.training else y


class DeepLabHeadV3Plus(nn.Module):
    """(reference: semantic-segmentation/model/model.py:80-113).
    `low_features`: the low-level map's channels, when they differ from the
    final map's `in_features` (ResNet: 256 and 2048)."""

    def __init__(self, in_features: int, num_classes: int,
                 aspp_rates: Sequence[int] = (12, 24, 36),
                 low_features: Optional[int] = None):
        super().__init__()
        self.low = ConvBNReLU(low_features or in_features, 48, kernel=1)
        self.aspp = ASPP(in_features, 256, aspp_rates)
        self.fuse = ConvBNReLU(48 + 256, 256, kernel=3)
        self.classifier = nn.Conv2d(256, num_classes, 1)

    def forward(self, low_level, out, mask=None, generator=None):
        ll = self.low(low_level, mask)
        y = self.aspp(out, mask, generator)
        y = resize_bilinear(y, ll.shape[2:], channels_last=False)
        y = self.fuse(torch.cat([ll, y], dim=1), mask)
        return self.classifier(y)


class DeepLabHead(nn.Module):
    """Plain DeepLabV3 head (ASPP -> 3x3 -> classifier)."""

    def __init__(self, in_features: int, num_classes: int,
                 aspp_rates: Sequence[int] = (12, 24, 36),
                 low_features: Optional[int] = None):
        super().__init__()
        del low_features  # no low-level branch
        self.aspp = ASPP(in_features, 256, aspp_rates)
        self.fuse = ConvBNReLU(256, 256, kernel=3)
        self.classifier = nn.Conv2d(256, num_classes, 1)

    def forward(self, low_level, out, mask=None, generator=None):
        return self.classifier(self.fuse(self.aspp(out, mask, generator), mask))


class DeepLabViT(nn.Module):
    """DINO ViT backbone + DeepLab head; logits at input resolution.
    `num_classes` includes background (the reference adds it,
    model/__init__.py:11-13)."""

    def __init__(self, vit_cfg: ViTConfig, num_classes: int,
                 head: str = "deeplabv3plus",
                 compute_dtype: torch.dtype = torch.float32,
                 attention_impl: str = "einsum", remat: bool = False):
        super().__init__()
        if head not in HEADS:
            raise ValueError(f"head must be one of {HEADS}; got {head!r}")
        self.vit_cfg, self.num_classes, self.head_name = vit_cfg, num_classes, head
        self.backbone = VisionTransformer(vit_cfg, compute_dtype, attention_impl, remat)
        head_cls = DeepLabHeadV3Plus if head == "deeplabv3plus" else DeepLabHead
        self.head = head_cls(vit_cfg.embed_dim, num_classes)

    def forward(self, x: torch.Tensor, token_mask: Optional[torch.Tensor] = None,
                spatial_mask: Optional[torch.Tensor] = None,
                pos_embed_override: Optional[torch.Tensor] = None,
                return_grid: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, H, W, 3). spatial_mask ((B, hp, wp) bool): valid-patch mask
        of bucket-padded evaluation; it derives the attention token mask,
        zeroes padded feature cells and threads through the head's convs.
        return_grid: the patch-grid logits (B, hp, wp, C) without the final
        upsample. In training the upsample is the matmul form, in evaluation
        the gather form, as in the JAX model."""
        B, H, W, _ = x.shape
        P = self.vit_cfg.patch_size
        hp, wp = H // P, W // P
        if spatial_mask is not None and token_mask is None:
            token_mask = spatial_mask.reshape(B, hp * wp)
        inters = self.backbone(x, n_intermediates=5, token_mask=token_mask,
                               pos_embed_override=pos_embed_override)["intermediates"]
        # layer -5 -> low level, the final layer -> out (model.py:75-77), CLS dropped
        low = inters[0][:, 1:].reshape(B, hp, wp, -1).permute(0, 3, 1, 2)
        out = inters[-1][:, 1:].reshape(B, hp, wp, -1).permute(0, 3, 1, 2)
        m = None
        if spatial_mask is not None:
            m = spatial_mask.to(low.dtype)[:, None]          # (B, 1, hp, wp)
            low, out = low * m, out * m
        with exact_f32():
            logits = self.head(low, out, m, generator).permute(0, 2, 3, 1)
        if return_grid:
            return logits
        if self.training:
            return resize_bilinear_mm(logits, (H, W))
        return resize_bilinear(logits, (H, W))


class DeepLabResNet(nn.Module):
    """ResNet-50 backbone (dilated, output stride 8 or 16) + DeepLab head: the
    reference's `get_deeplab_resnet` (semantic-segmentation/model/model.py:
    8-39), layer1 -> low level, layer4 -> out. Images (B, H, W, 3) in,
    logits (B, H, W, num_classes) out, like `DeepLabViT`; the whole forward
    runs in true f32, as the JAX model's f32 convolutions do."""

    def __init__(self, num_classes: int, head: str = "deeplabv3plus",
                 output_stride: int = 8):
        super().__init__()
        from .resnet import ResNet50
        if head not in HEADS:
            raise ValueError(f"head must be one of {HEADS}; got {head!r}")
        if output_stride == 8:
            rswd, rates = (False, True, True), (12, 24, 36)
        elif output_stride == 16:
            rswd, rates = (False, False, True), (6, 12, 18)
        else:
            raise ValueError(f"output_stride must be 8 or 16; got {output_stride}")
        self.num_classes, self.head_name = num_classes, head
        self.backbone = ResNet50(replace_stride_with_dilation=rswd)
        head_cls = DeepLabHeadV3Plus if head == "deeplabv3plus" else DeepLabHead
        self.head = head_cls(2048, num_classes, rates, low_features=256)

    def forward(self, x: torch.Tensor, token_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        del token_mask  # a conv backbone needs no token mask
        H, W = x.shape[1:3]
        with exact_f32():
            feats = self.backbone(x.permute(0, 3, 1, 2))
            logits = self.head(feats["layer1"], feats["layer4"], None,
                               generator).permute(0, 2, 3, 1)
        if self.training:
            return resize_bilinear_mm(logits, (H, W))
        return resize_bilinear(logits, (H, W))


def data_parallel_(model: nn.Module, group) -> nn.Module:
    """Make `model` train one rank's block of a global batch over the
    process group `group` (None: back to one device): global-batch BatchNorm
    statistics and the global dropout mask (see the module docstring)."""
    for module in model.modules():
        if hasattr(module, "dp_group"):
            module.dp_group = group
    return model


def backbone_param_labels(model: nn.Module, unfrozen_backbone_layers: int
                          ) -> dict[str, str]:
    """Label each parameter 'train' or 'freeze' and set `requires_grad` to
    match: the head always trains; backbone blocks (ViT) or stages (ResNet's
    layer1-4) train only in the last `unfrozen_backbone_layers` (-1 trains
    the whole backbone, 0 freezes it); the other backbone parameters (the
    ViT's patch embed, CLS token, pos_embed and final norm; the ResNet stem)
    train only at -1 (reference: semantic-segmentation/train.py:48-52).
    Returns name -> label; the optimizer takes the 'train' parameters."""
    depth = model.vit_cfg.depth if hasattr(model, "vit_cfg") else 4
    labels = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] != "backbone" or unfrozen_backbone_layers < 0:
            label = "train"
        elif parts[1] == "blocks":
            label = "train" if depth - int(parts[2]) <= unfrozen_backbone_layers else "freeze"
        elif parts[1].startswith("layer"):
            label = "train" if 4 - int(parts[1][5:]) < unfrozen_backbone_layers else "freeze"
        else:
            label = "freeze"
        labels[name] = label
        p.requires_grad_(label == "train")
    return labels
