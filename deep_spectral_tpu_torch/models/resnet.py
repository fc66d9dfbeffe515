"""ResNet-50 and VGG-16 feature backbones in plain PyTorch: the port of
`deep_spectral_tpu.models.resnet` (torchvision is not a dependency).

The reference's localization model zoo has truncated resnet50 / vgg16
feature extractors with optional dilation (reference:
object-localization/networks.py:13-83, `ResNet50Bottom`, `vgg16Bottom`), and
the self-training model a ResNet-50 DeepLab backbone with
replace_stride_with_dilation (semantic-segmentation/model/model.py:8-39).
Both modules take NCHW images and return every stage's feature map (NCHW),
so callers truncate at any layer.

Parameter and buffer names are torchvision's (`conv1`, `bn1`,
`layer1.0.conv1`, `layer1.0.downsample.0`, ...; VGG's `features.<index>`),
so a local torchvision state dict loads with `load_state_dict` as it is
(its BatchNorm `num_batches_tracked` counters are dropped).
`models.convert.flax_resnet_to_torch_state_dict` and
`flax_vgg16_to_torch_state_dict` carry the JAX package's params across.
BatchNorm has flax's semantics (momentum 0.9, eps 1e-5, the batch's biased
variance in training), as in `models.deeplab`.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .deeplab import flax_batch_norm


class BatchNorm2d(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` under torchvision's
    names: parameters `weight`, `bias`; buffers `running_mean`,
    `running_var`."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.dp_group = None  # set by `deeplab.data_parallel_`

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_batch_norm(x, self.weight, self.bias, self.running_mean,
                               self.running_var, self.training, self.momentum, self.eps,
                               self.dp_group)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)  # torchvision's counter
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided, dilated) -> 1x1 x4, with a projected shortcut in
    each stage's first block."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 1, bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = BatchNorm2d(features)
        self.conv3 = nn.Conv2d(features, features * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(features * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_features, features * 4, 1, stride=stride, bias=False),
                BatchNorm2d(features * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet50(nn.Module):
    """Returns {'stem', 'layer1'..'layer4'} feature maps (NCHW).

    replace_stride_with_dilation mirrors torchvision: a True entry turns that
    layer's stride 2 into dilation (output stride 8 = (False, True, True),
    reference: model/model.py:10-17)."""

    def __init__(self, replace_stride_with_dilation: Sequence[bool] = (False, False, False)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        in_features, dilation = 64, 1
        for li, (n_blocks, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            stride = 1 if li == 0 else 2
            if li > 0 and replace_stride_with_dilation[li - 1]:
                dilation *= stride
                stride = 1
            blocks = [Bottleneck(in_features if bi == 0 else width * 4, width,
                                 stride=stride if bi == 0 else 1, dilation=dilation,
                                 downsample=bi == 0) for bi in range(n_blocks)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            in_features = width * 4

    def forward(self, x: torch.Tensor) -> dict:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        feats = {"stem": y}
        for li in range(1, 5):
            y = getattr(self, f"layer{li}")(y)
            feats[f"layer{li}"] = y
        return feats


# torchvision's vgg16 `features`: (out channels, convs) per stage; each conv
# is followed by a ReLU and each stage by a 2x2 max-pool
_VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16Features(nn.Module):
    """VGG-16's convolutional trunk, laid out as torchvision's `features`;
    returns the feature map after each of the five conv stages. The
    reference truncates at features[:-1] (conv5_3 + ReLU, before the last
    max-pool): that is `stage5` (reference: object-localization/
    networks.py:71-83). The last max-pool is kept in `features` for the
    checkpoint layout and never run."""

    def __init__(self):
        super().__init__()
        layers, in_features = [], 3
        for width, n_convs in _VGG16_STAGES:
            for _ in range(n_convs):
                layers += [nn.Conv2d(in_features, width, 3, padding=1), nn.ReLU()]
                in_features = width
            layers.append(nn.MaxPool2d(2, stride=2))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> dict:
        feats = {}
        layers = list(self.features)[:-1]
        for i, layer in enumerate(layers):
            x = layer(x)
            if i + 1 == len(layers) or isinstance(layers[i + 1], nn.MaxPool2d):
                feats[f"stage{len(feats) + 1}"] = x
        return feats


def resnet50_feature_extractor(layer: str = "layer4", dilate_last: bool = False):
    """(model, extract) where extract(x) is `model`'s truncated feature map
    `layer`: the `ResNet50Bottom` analogue (reference: networks.py:13-37).
    `dilate_last` keeps layer4 at stride 16 with dilation 2, the zoo's
    'dilated' variants."""
    rswd = (False, False, True) if dilate_last else (False, False, False)
    model = ResNet50(replace_stride_with_dilation=rswd)

    def extract(x: torch.Tensor) -> torch.Tensor:
        return model(x)[layer]
    return model, extract
