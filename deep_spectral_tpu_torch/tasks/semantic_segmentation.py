"""DeepLab self-training on pseudolabels, its prediction dump and the
clustering evaluation: the port of `deep_spectral_tpu.tasks.semantic_segmentation`
(reference: semantic-segmentation/train.py, eval.py).

Host side, copied from the JAX package (numpy / PIL only): the VOC-layout
dataset with pseudolabels, the augmentation stack and the image normalization.
Evaluation of pseudolabels: `evaluate_segments` (Hungarian or majority-vote
cluster matching, then mIoU; confusion matrices on the device) and
`visualize_overlays` (matplotlib, imported inside it).
Model side, in PyTorch: `TrainConfig`, `build_model` (DeepLabViT over a DINO
ViT, with `remat` as activation checkpointing of its blocks, or
DeepLabResNet over a dilated ResNet-50), `create_train_state`, `train_step`
(one-hot cross-entropy over all pixels, AdamW with a linear decay, optional
global-norm clipping, gradient accumulation, EMA and a NaN guard that
reverts the whole state on the device), `eval_step`, the bucket-padded
evaluation that `train` runs for ViT backbones (ResNets take the per-image
path), `generate_predictions` (the reference's `generate` job), checkpoints
(`torch.save` of the same tree as the JAX package's orbax checkpoint) and
`train` with its producer threads. `train(mesh=...)` trains data-parallel,
one process per device (`parallel/`): the state replicated, each global
batch split by rank over the mesh's first dim, gradients averaged across
ranks, BatchNorm over the global batch (`models.deeplab.data_parallel_`).

The optimizer is written out rather than taken from `torch.optim`, because
it has to be optax's `adamw` to the last rounding step: optax adds the
decoupled weight decay to the Adam direction before scaling by the learning
rate, evaluates the schedule at the count before the update, and clips by
the global norm with no epsilon; and the NaN guard has to revert the moments
with a device-side select.
"""
from __future__ import annotations

import collections
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.deeplab import (DeepLabResNet, DeepLabViT, backbone_param_labels,
                              data_parallel_)
from ..models.vit import ViTConfig, VisionTransformer, get_model_config, interpolate_pos_embed
from ..ops import metrics as M
from ..ops.resize import resize_bilinear
from ..utils.device import resolve_device
from ..utils.image_io import IMAGENET_MEAN, IMAGENET_STD, load_image_rgb
from ..utils.precision import exact_f32
from ..utils.profiling import span
from ..utils.serialization import load_segmap_png, save_segmap_png

VOC_NUM_CLASSES = 21  # 20 + background (reference: model/__init__.py:11-13)


# ------------------------------------------------------------------- datasets

def upsample_pseudolabel(segmap: np.ndarray, image_hw: tuple[int, int]) -> np.ndarray:
    """Nearest-upsample a patch-level pseudolabel to image resolution, handling
    the x8/x16/x32 grids (reference: dataset/voc.py:12-19), with cv2
    INTER_NEAREST index semantics (src = floor(dst * in / out)).

    The index product is computed in float32, NOT float64: the JAX package's
    device resize multiplies in f32, and f64-vs-f32 rounding disagrees on 1-2
    rows for some real grid/image pairs (e.g. 8 -> 282)."""
    H_in, W_in = segmap.shape
    H_out, W_out = image_hw
    iy = np.floor(np.arange(H_out, dtype=np.float32)
                  * np.float32(H_in / H_out)).astype(np.int64)
    ix = np.floor(np.arange(W_out, dtype=np.float32)
                  * np.float32(W_in / W_out)).astype(np.int64)
    iy = np.minimum(iy, H_in - 1)
    ix = np.minimum(ix, W_in - 1)
    return segmap.astype(np.int32)[iy[:, None], ix[None, :]]


class VOCSegmentationWithPseudolabels:
    """VOC2012-layout dataset with pseudolabel segmaps.

    root/
      JPEGImages/<id>.jpg
      SegmentationClass/<id>.png      (GT, for val)
      ImageSets/Segmentation/val.txt
    segments_dir/<id or positional>.png  (pseudolabels)

    Semantics preserved from the reference: custom 'train' split = all
    JPEGImages minus val stems (voc.py:78-87); segment files paired to image
    files by SORTED POSITION, not by id (voc.py:112-131); optional label_map
    remapping (the Hungarian matching) applied to the pseudolabel.
    """

    def __init__(self, root: str, image_set: str, segments_dir: str,
                 label_map: Optional[dict] = None):
        root = Path(root)
        self.root = root
        images_dir = root / "JPEGImages"
        val_stems = set()
        val_file = root / "ImageSets" / "Segmentation" / "val.txt"
        if val_file.is_file():
            val_stems = set(val_file.read_text().split())
        all_images = sorted(images_dir.glob("*.jpg"))
        if image_set == "val":
            self.images = [p for p in all_images if p.stem in val_stems]
        elif image_set == "train":
            self.images = [p for p in all_images if p.stem not in val_stems]
        else:
            self.images = all_images
        self.targets = [root / "SegmentationClass" / f"{p.stem}.png"
                        for p in self.images]
        # Segment files cover the WHOLE image folder and pair to sorted images
        # by position, then the split subset is selected
        # (reference: dataset/voc.py:112-131 `_prepare_segments_dir`).
        seg_files = sorted(Path(segments_dir).iterdir())
        assert len(seg_files) == len(all_images), \
            f"{len(seg_files)} segmaps vs {len(all_images)} images in folder"
        split_stems = {p.stem for p in self.images}
        self.segments = [s for img, s in zip(all_images, seg_files)
                         if img.stem in split_stems]
        assert len(self.segments) == len(self.images)
        self.label_map = label_map

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i: int):
        image = load_image_rgb(self.images[i])
        seg = load_segmap_png(self.segments[i]).astype(np.int64)
        if seg.shape != image.shape[:2]:
            seg = upsample_pseudolabel(seg, image.shape[:2])
        if self.label_map is not None:
            lut = np.arange(max(int(seg.max()) + 1,
                                max(self.label_map) + 1), dtype=np.int64)
            for k, v in self.label_map.items():
                lut[k] = v
            seg = lut[seg]
        target = None
        if self.targets[i].is_file():
            target = np.asarray(load_segmap_png(self.targets[i]), np.int64)
        return image, seg, target, self.images[i].stem


# ------------------------------------------------------------- transforms

def normalize_image(img_u8: np.ndarray) -> np.ndarray:
    return ((img_u8.astype(np.float32) / 255.0) - IMAGENET_MEAN) / IMAGENET_STD


def train_augment(rng: np.random.Generator, image: np.ndarray, seg: np.ndarray,
                  resize_size: int = 256, crop_size: int = 224) -> tuple:
    """Smallest-max-size resize + random crop + hflip + ColorJitter(brightness
    0.4, contrast 0.4, saturation 0.2, hue 0.1, p=0.8) + ToGray(p=0.2) +
    GaussianBlur(p=0.1) — the reference's consumed albumentations stack
    (dataset/__init__.py:10-26; the train loop only uses one view)."""
    from PIL import Image as PILImage
    H, W = image.shape[:2]
    scale = resize_size / min(H, W)
    newH, newW = max(int(round(H * scale)), crop_size), max(int(round(W * scale)), crop_size)
    image = np.array(PILImage.fromarray(image).resize((newW, newH), PILImage.BICUBIC))
    seg = np.array(PILImage.fromarray(seg.astype(np.uint8)).resize(
        (newW, newH), PILImage.NEAREST)).astype(np.int64)
    y0 = int(rng.integers(0, newH - crop_size + 1))
    x0 = int(rng.integers(0, newW - crop_size + 1))
    image = image[y0:y0 + crop_size, x0:x0 + crop_size]
    seg = seg[y0:y0 + crop_size, x0:x0 + crop_size]
    if rng.random() < 0.5:
        image, seg = image[:, ::-1], seg[:, ::-1]
    if rng.random() < 0.8:  # ColorJitter(0.4, 0.4, 0.2, 0.1, p=0.8)
        img = image.astype(np.float32)
        img = img * (1 + rng.uniform(-0.4, 0.4))                     # brightness
        mean = img.mean()
        img = (img - mean) * (1 + rng.uniform(-0.4, 0.4)) + mean     # contrast
        gray = img.mean(-1, keepdims=True)
        img = (img - gray) * (1 + rng.uniform(-0.2, 0.2)) + gray     # saturation
        img = _hue_shift(np.clip(img, 0, 255), rng.uniform(-0.1, 0.1))  # hue
        image = np.clip(img, 0, 255).astype(np.uint8)
    if rng.random() < 0.2:  # ToGray(p=0.2)
        gray = image.astype(np.float32) @ np.array([0.299, 0.587, 0.114],
                                                   np.float32)
        image = np.repeat(np.clip(gray, 0, 255).astype(np.uint8)[..., None],
                          3, axis=-1)
    if rng.random() < 0.1:  # GaussianBlur(p=0.1), cv2-default kernel 3..7
        ksize = int(rng.choice([3, 5, 7]))
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8  # cv2 default sigma
        image = _gaussian_blur(image, ksize, sigma)
    return normalize_image(np.ascontiguousarray(image)), np.ascontiguousarray(seg)


def _hue_shift(img: np.ndarray, factor: float) -> np.ndarray:
    """Rotate hue by `factor` turns (ColorJitter hue semantics): RGB->HSV,
    H += factor, ->RGB. `img` float32 in [0, 255]."""
    if abs(factor) < 1e-8:
        return img
    x = img / 255.0
    mx, mn = x.max(-1), x.min(-1)
    v = mx
    s = np.where(mx > 0, (mx - mn) / np.maximum(mx, 1e-12), 0.0)
    c = mx - mn
    safe_c = np.maximum(c, 1e-12)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    h = np.where(mx == r, ((g - b) / safe_c) % 6,
                 np.where(mx == g, (b - r) / safe_c + 2, (r - g) / safe_c + 4)) / 6.0
    h = np.where(c > 0, h, 0.0)
    h = (h + factor) % 1.0
    # HSV -> RGB, vectorized
    i = np.floor(h * 6).astype(np.int32) % 6
    f = h * 6 - np.floor(h * 6)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    lut = np.stack([np.stack([v, t, p], -1), np.stack([q, v, p], -1),
                    np.stack([p, v, t], -1), np.stack([p, q, v], -1),
                    np.stack([t, p, v], -1), np.stack([v, p, q], -1)], 0)
    out = np.take_along_axis(lut, i[None, ..., None], axis=0)[0]
    return out * 255.0


def _gaussian_blur(img_u8: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """Separable Gaussian blur with reflect padding (cv2.GaussianBlur-style)."""
    r = ksize // 2
    xs = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    img = img_u8.astype(np.float32)
    img = np.pad(img, ((r, r), (r, r), (0, 0)), mode="reflect")
    img = np.apply_along_axis(lambda m: np.convolve(m, k, mode="valid"), 0, img)
    img = np.apply_along_axis(lambda m: np.convolve(m, k, mode="valid"), 1, img)
    return np.clip(img, 0, 255).astype(np.uint8)


# ------------------------------------------------------- cluster-matching eval

def evaluate_segments(dataset, n_clusters: int = 21,
                      num_classes: int = VOC_NUM_CLASSES,
                      ignore_index: int = 255, device=None):
    """Dataset-wide evaluation of pseudolabel segmaps against GT with
    Hungarian (when n_clusters == num_classes) or majority-vote matching
    (reference: eval.py:87-159), over the pixels whose GT is not
    `ignore_index`. The confusion matrices run on `device` (CUDA unless the
    caller asks for the CPU), the assignment on the host. Returns (miou,
    per-class Jaccard as numpy, match)."""
    dev = resolve_device(device, "evaluate_segments")
    preds_all, gts_all = [], []
    for i in range(len(dataset)):
        _, seg, target, _ = dataset[i]
        if target is None:
            continue
        valid = target != ignore_index
        preds_all.append(seg[valid])
        gts_all.append(target[valid])
    flat_preds = np.concatenate(preds_all)
    flat_targets = torch.from_numpy(np.concatenate(gts_all)).to(dev)
    preds = torch.from_numpy(flat_preds).to(dev)
    if n_clusters == num_classes:
        match = M.hungarian_match(preds, flat_targets, n_clusters, num_classes)
    else:
        match = M.majority_vote(preds, flat_targets, n_clusters, num_classes)
    remapped = torch.from_numpy(M.apply_label_map(flat_preds, match)).to(dev)
    jac, miou = M.per_class_jaccard(remapped, flat_targets, num_classes)
    return float(miou), jac.cpu().numpy(), match


def visualize_overlays(dataset, match, output_dir, max_images: int = 40):
    """Pseudolabel / GT overlay PNGs of the first `max_images` images (the
    reference's label2rgb visualization, eval.py:57-84)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    cmap = matplotlib.colormaps["tab20"].resampled(21)
    lut = None
    if match is not None:
        lut = np.arange(max(m[0] for m in match) + 1)
        for pred_c, gt_c in match:
            lut[pred_c] = gt_c
    n = min(len(dataset), max_images)
    for i in range(n):
        image, seg, target, stem = dataset[i]
        if lut is not None:
            seg = lut[np.clip(seg, 0, len(lut) - 1)]
        ncols = 3 if target is not None else 2
        fig, axes = plt.subplots(1, ncols, figsize=(5 * ncols, 5))
        axes[0].imshow(image)
        axes[0].set_title(stem)
        overlay = cmap(seg % 21)[..., :3]
        blend = 0.55 * image / 255.0 + 0.45 * overlay
        blend[seg == 0] = (image / 255.0)[seg == 0]
        axes[1].imshow(blend)
        axes[1].set_title("pred")
        if target is not None:
            gt_overlay = cmap(np.clip(target, 0, 20) % 21)[..., :3]
            gt_blend = 0.55 * image / 255.0 + 0.45 * gt_overlay
            gt_blend[target == 0] = (image / 255.0)[target == 0]
            axes[2].imshow(gt_blend)
            axes[2].set_title("gt")
        for ax in axes:
            ax.axis("off")
        fig.savefig(out / f"{stem}.png", bbox_inches="tight", dpi=80)
        plt.close(fig)
    print(f"Wrote {n} overlays to {out}")


# ------------------------------------------------------------- train state

@dataclasses.dataclass
class TrainConfig:
    """Mirrors config/train.yaml's knobs (the JAX package's TrainConfig)."""
    backbone: str | ViTConfig = "dino_vits16"
    num_classes: int = VOC_NUM_CLASSES
    lr: float = 5e-3
    weight_decay: float = 1e-8
    max_train_steps: int = 5000
    warmup_steps: int = 0
    unfrozen_backbone_layers: int = 1
    gradient_accumulation_steps: int = 1
    clip_grad_norm: Optional[float] = None
    use_ema: bool = False
    ema_decay: float = 0.999
    crop_size: int = 224
    resize_size: int = 256
    batch_size: int = 16
    # Host-side augmentation threads (the reference's DataLoader workers).
    num_workers: int = 4
    seed: int = 1
    remat: bool = False  # recompute the ViT blocks in the backward (big batches)
    # 'fp32' or 'bf16': bf16 backbone compute with fp32 params, norms, head
    # and loss (the reference's fp16 Accelerator, train.py:29).
    precision: str = "fp32"


def _is_resnet(cfg: TrainConfig) -> bool:
    return isinstance(cfg.backbone, str) and "resnet" in cfg.backbone


def _backbone_patch_size(cfg: TrainConfig) -> int:
    """Patch size of the configured ViT backbone; 16 for a ResNet, whose
    per-image eval crops to multiples of 16 (the reference's default
    downsample), as the JAX package does."""
    if _is_resnet(cfg):
        return 16
    return cfg.backbone.patch_size if isinstance(cfg.backbone, ViTConfig) \
        else get_model_config(cfg.backbone).patch_size


def build_model(cfg: TrainConfig):
    """The DeepLabV3+ model of `cfg`: DeepLabResNet (output stride 8, f32)
    for a 'resnet' backbone name, else DeepLabViT with `precision`'s compute
    dtype, `remat`, and 'auto' attention: the hand-written kernels on CUDA
    (kernels 3-5 where a block trains, the packed forward or kernel 3's f32
    build where it does not), the JAX model's einsum on the CPU."""
    if cfg.precision not in ("fp32", "bf16"):
        raise ValueError(f"precision must be 'fp32' or 'bf16', got {cfg.precision!r}")
    if _is_resnet(cfg):
        return DeepLabResNet(cfg.num_classes)
    vit_cfg = cfg.backbone if isinstance(cfg.backbone, ViTConfig) \
        else get_model_config(cfg.backbone)
    dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
    return DeepLabViT(vit_cfg, cfg.num_classes, compute_dtype=dtype, attention_impl="auto",
                      remat=cfg.remat)


@torch.no_grad()
def init_deeplab_(model, seed: int):
    """Seeded random weights: a ViT backbone as `convert.random_init_`; a
    ResNet backbone's and the head's convs ~ N(0, 1/fan_in) (flax's
    lecun-normal scale) with zero biases; BatchNorm at identity with zero
    mean and unit variance."""
    from ..models.convert import random_init_
    g = torch.Generator().manual_seed(seed + 1)
    if isinstance(model.backbone, VisionTransformer):
        random_init_(model.backbone, seed)
        modules = model.head.modules()
    else:
        modules = model.modules()
    for module in modules:
        if isinstance(module, torch.nn.Conv2d):
            fan_in = module.weight[0].numel()
            module.weight.copy_(torch.randn(module.weight.shape, generator=g) / fan_in ** 0.5)
            if module.bias is not None:
                module.bias.zero_()
    return model


class AdamW:
    """optax's `chain(clip_by_global_norm?, adamw(linear_schedule(lr, 0,
    max_steps), weight_decay))` over the trainable parameters, inside
    `MultiSteps` when accumulating gradients. Every piece of state is a
    tensor on the parameters' device, so a step needs no host sync and the NaN
    guard reverts it with selects."""

    def __init__(self, params: dict[str, torch.Tensor], cfg: TrainConfig,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        if cfg.warmup_steps:
            raise NotImplementedError(
                "warmup_steps > 0: the JAX package builds this schedule with "
                "optax.warmup_linear_schedule, which optax does not have")
        self.params = params
        self.lr, self.max_steps = cfg.lr, cfg.max_train_steps
        self.weight_decay, self.clip = cfg.weight_decay, cfg.clip_grad_norm
        self.accum = cfg.gradient_accumulation_steps
        self.b1, self.b2, self.eps = b1, b2, eps
        dev = next(iter(params.values())).device
        self.state = {"count": torch.zeros((), dtype=torch.int32, device=dev)}
        for n, p in params.items():
            self.state[f"mu.{n}"] = torch.zeros_like(p)
            self.state[f"nu.{n}"] = torch.zeros_like(p)
            if self.accum > 1:
                self.state[f"acc.{n}"] = torch.zeros_like(p)
        if self.accum > 1:
            self.state["mini_step"] = torch.zeros((), dtype=torch.int32, device=dev)

    def schedule(self, count: torch.Tensor) -> torch.Tensor:
        """optax.linear_schedule(lr, 0, max_steps) at `count`, in f32."""
        frac = 1 - torch.clamp(count, 0, self.max_steps).to(torch.float32) / self.max_steps
        return self.lr * frac

    def _adamw(self, grads: dict) -> tuple[dict, dict]:
        """(updates, new state) of clip + adamw for `grads`."""
        new = {}
        if self.clip:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            trigger = g_norm < self.clip
            grads = {n: torch.where(trigger, g, (g / g_norm) * self.clip)
                     for n, g in grads.items()}
        count = self.state["count"]
        count_inc = count + 1
        bc1 = 1 - self.b1 ** count_inc.to(torch.float32)
        bc2 = 1 - self.b2 ** count_inc.to(torch.float32)
        step_size = -self.schedule(count)
        updates = {}
        for n, g in grads.items():
            mu = (1 - self.b1) * g + self.b1 * self.state[f"mu.{n}"]
            nu = (1 - self.b2) * (g * g) + self.b2 * self.state[f"nu.{n}"]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * self.params[n]
            updates[n] = step_size * u
            new[f"mu.{n}"], new[f"nu.{n}"] = mu, nu
        new["count"] = count_inc
        return updates, new

    @torch.no_grad()
    def step(self, grads: dict[str, torch.Tensor], ok: torch.Tensor) -> None:
        """Apply one update where `ok` (a bool scalar tensor) holds; where it
        does not, parameters and state keep their values."""
        if self.accum > 1:  # optax.MultiSteps: running mean, emit every k-th
            n_acc = self.state["mini_step"]
            acc = {n: self.state[f"acc.{n}"] + (g - self.state[f"acc.{n}"]) / (n_acc + 1)
                   for n, g in grads.items()}
            updates, new = self._adamw(acc)
            emit = n_acc == self.accum - 1
            new = {k: torch.where(emit, v, self.state[k]) for k, v in new.items()}
            for n in grads:
                new[f"acc.{n}"] = torch.where(emit, torch.zeros_like(acc[n]), acc[n])
                updates[n] = torch.where(emit, updates[n], torch.zeros_like(updates[n]))
            new["mini_step"] = (n_acc + 1) % self.accum
        else:
            updates, new = self._adamw(grads)
        for k, v in new.items():
            self.state[k].copy_(torch.where(ok, v, self.state[k]))
        for n, p in self.params.items():
            p.copy_(torch.where(ok, p + updates[n], p))

    def state_dict(self) -> dict:
        return {k: v.detach().cpu() for k, v in self.state.items()}

    def load_state_dict(self, sd: dict) -> None:
        for k, v in self.state.items():
            v.copy_(sd[k])


@dataclasses.dataclass
class TrainState:
    """The port of the JAX TrainState: the model (params and BN statistics),
    the optimizer (its state and schedule), the EMA copy of every parameter
    (or None) and the step, a device scalar. `dp_group`: the process group
    of data-parallel training (None: one device); set it with
    `make_data_parallel`."""
    model: DeepLabViT
    opt: AdamW
    ema_params: Optional[dict]
    step: torch.Tensor
    dp_group: Optional[object] = None


def make_data_parallel(state: TrainState, group) -> TrainState:
    """Train `state` data-parallel over the process group `group`: every
    rank's parameters and BN statistics become rank 0's (the state is
    replicated), the model normalizes over the global batch and draws the
    global dropout mask (`data_parallel_`), and `train_step` averages the
    gradients, the loss and the accuracy across ranks."""
    if dist.get_world_size(group) > 1:
        src = dist.get_global_rank(group, 0)
        with torch.no_grad():
            for t in [*state.model.parameters(), *state.model.buffers()]:
                dist.broadcast(t.data, src, group=group)
            if state.ema_params is not None:
                for t in state.ema_params.values():
                    dist.broadcast(t, src, group=group)
    data_parallel_(state.model, group)
    state.dp_group = group
    return state


def _average_across_ranks(tensors: list, group) -> None:
    """Replace each tensor by its mean over the ranks of `group`, in place,
    with one all-reduce of a flat buffer."""
    n = dist.get_world_size(group)
    if n == 1:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= n
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def create_train_state(cfg: TrainConfig, model: DeepLabViT,
                       backbone_params: Optional[dict] = None,
                       device: str | torch.device | None = None) -> TrainState:
    """Seeded init of `model` (or the DINO-named backbone state dict
    `backbone_params`), moved to `device` (CUDA unless the caller asks for
    the CPU; a CUDA device with no card raises RuntimeError); freeze labels
    per `unfrozen_backbone_layers`; AdamW over the trainable parameters; an
    EMA copy of every parameter with use_ema."""
    device = resolve_device(device, "create_train_state")
    init_deeplab_(model, cfg.seed)
    if backbone_params is not None:
        model.backbone.load_state_dict(backbone_params)
    model.to(device)
    labels = backbone_param_labels(model, cfg.unfrozen_backbone_layers)
    params = {n: p for n, p in model.named_parameters() if labels[n] == "train"}
    ema = {n: p.detach().clone() for n, p in model.named_parameters()} \
        if cfg.use_ema else None
    return TrainState(model=model, opt=AdamW(params, cfg), ema_params=ema,
                      step=torch.zeros((), dtype=torch.int64, device=device))


def loss_and_accuracy(logits: torch.Tensor, labels: torch.Tensor):
    """One-hot cross-entropy averaged over ALL pixels (an out-of-range label
    contributes 0 and still counts, as with jax.nn.one_hot) and pixel
    accuracy. logits (B, H, W, C), labels (B, H, W)."""
    C = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.to(torch.int64)
    valid = (labels >= 0) & (labels < C)
    picked = logp.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
    loss = -torch.where(valid, picked, 0.0).mean()
    acc = (logits.argmax(dim=-1) == labels).to(torch.float32).mean()
    return loss, acc


def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
               generator: Optional[torch.Generator] = None, use_ema: bool = False,
               ema_decay: float = 0.999) -> dict:
    """One optimization step (reference: train.py:204-228). `generator` draws
    the ASPP dropout mask. On a non-finite loss the step reverts the
    parameters, the optimizer state, the BN statistics and the EMA with
    device-side selects (no host sync). The trainable parameters keep this
    step's gradient in `.grad`. Returns {'loss', 'acc'} as device scalars.
    Data-parallel (`state.dp_group`): images and labels are this rank's
    block of the global batch; the gradients, the loss and the accuracy are
    averaged across ranks before the update, so every rank takes the same
    step and agrees on the revert. Spans: `train.forward` (the BN snapshot,
    the model and the loss), `train.backward` (the gradients and their
    average across ranks), `train.optimizer` (the update, the BN revert and
    the EMA)."""
    model = state.model
    model.train()
    with span("train.forward"):
        bn_before = {n: b.clone() for n, b in model.named_buffers()}
        for p in state.opt.params.values():
            p.grad = None
        with exact_f32():
            logits = model(images, generator=generator)
            loss, acc = loss_and_accuracy(logits, labels)
    with span("train.backward"):
        with exact_f32():
            loss.backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in state.opt.params.items()}
        if state.dp_group is not None:
            loss, acc = loss.detach(), acc.detach()
            _average_across_ranks([*grads.values(), loss, acc], state.dp_group)
    with span("train.optimizer"):
        ok = torch.isfinite(loss.detach())
        state.opt.step(grads, ok)
        with torch.no_grad():
            for n, b in model.named_buffers():
                b.copy_(torch.where(ok, b, bn_before[n]))
            if use_ema and state.ema_params is not None:
                for n, p in model.named_parameters():
                    e = state.ema_params[n]
                    e.copy_(torch.where(ok, ema_decay * e + (1 - ema_decay) * p, e))
    state.step += 1
    return {"loss": loss.detach(), "acc": acc}


@torch.no_grad()
def eval_step(state: TrainState, images: torch.Tensor) -> torch.Tensor:
    """Per-pixel argmax of the eval-mode logits of (B, H, W, 3) images."""
    state.model.eval()
    with exact_f32():
        return state.model(images).argmax(dim=-1)


# ------------------------------------------------- bucket-padded evaluation
#
# The reference evaluates val images one at a time at native resolution
# (train.py:278-348, batch size 1). The bucketed path pads them into <= 2
# shape buckets and keeps the padding exactly inert: per-image pos embeds
# interpolated to the image's own grid, token-masked attention, head convs
# that re-zero padded cells, and grid logits edge-replicated into the padded
# cells before the final bilinear upsample. tests/test_torch_train.py holds
# it pixel-exact against the per-image path.

@torch.no_grad()
def eval_step_bucketed(state: TrainState, images: torch.Tensor, vhw: torch.Tensor,
                       pos: torch.Tensor, patch_size: int = 16) -> torch.Tensor:
    """images (B, Hb, Wb, 3) zero-padded; vhw (B, 2) valid pixel dims
    (multiples of patch_size); pos (B, 1+hp*wp, D) per-image pos embeds.
    Returns (B, Hb, Wb) int32 predictions (valid within each image's region)."""
    B, Hb, Wb, _ = images.shape
    P = patch_size
    hp, wp = Hb // P, Wb // P
    dev = images.device
    vh, vw = vhw[:, 0] // P, vhw[:, 1] // P
    gm = (torch.arange(hp, device=dev)[None, :, None] < vh[:, None, None]) & \
         (torch.arange(wp, device=dev)[None, None, :] < vw[:, None, None])
    state.model.eval()
    with exact_f32():
        grid = state.model(images, spatial_mask=gm, pos_embed_override=pos,
                           return_grid=True)               # (B, hp, wp, C)
    ii = torch.minimum(torch.arange(hp, device=dev)[None, :], vh[:, None] - 1)
    jj = torch.minimum(torch.arange(wp, device=dev)[None, :], vw[:, None] - 1)
    rep = grid[torch.arange(B, device=dev)[:, None, None], ii[:, :, None], jj[:, None, :]]
    return resize_bilinear(rep, (Hb, Wb)).argmax(dim=-1).to(torch.int32)


def _eval_buckets(shapes):
    """<= 2 bucket shapes: elementwise max over landscape / portrait groups
    (every image fits its orientation's bucket by construction)."""
    buckets = []
    for grp in ([s for s in shapes if s[1] >= s[0]],
                [s for s in shapes if s[1] < s[0]]):
        if grp:
            buckets.append((max(h for h, _ in grp), max(w for _, w in grp)))
    return sorted(set(buckets))


def _pos_for_bucket(pos_embed: torch.Tensor, vh: int, vw: int, hp: int, wp: int,
                    cache: dict) -> np.ndarray:
    """Stored pos embeds interpolated to the image's own (vh, vw) grid, as an
    unpadded forward computes them, placed at the bucket's valid token
    positions (padding gets zeros; those tokens are attention-masked and
    their features zeroed). Computed on the CPU."""
    key = (vh, vw, hp, wp)
    if key not in cache:
        grid = int(round((pos_embed.shape[1] - 1) ** 0.5))
        native = interpolate_pos_embed(pos_embed.detach().float().cpu(), grid, vh,
                                       vw)[0].numpy()     # (1+vh*vw, D)
        D = native.shape[-1]
        full = np.zeros((1 + hp * wp, D), np.float32)
        full[0] = native[0]
        patch = np.zeros((hp, wp, D), np.float32)
        patch[:vh, :vw] = native[1:].reshape(vh, vw, D)
        full[1:] = patch.reshape(-1, D)
        cache[key] = full
    return cache[key]


def supports_bucketed_eval(state: TrainState) -> bool:
    """Bucketed (shape-padded) evaluation needs per-image interpolated ViT
    position embeddings; ResNet backbones take the per-image path."""
    return isinstance(state.model.backbone, VisionTransformer)


def _patch_size(state: TrainState, patch_size: Optional[int]) -> int:
    """`patch_size`, else the ViT backbone's; 16 for a ResNet (its per-image
    eval crops to multiples of 16)."""
    if patch_size is not None:
        return patch_size
    vit_cfg = getattr(state.model, "vit_cfg", None)
    return vit_cfg.patch_size if vit_cfg is not None else 16


def _device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def _per_image_prediction(state: TrainState, image: np.ndarray, P: int) -> np.ndarray:
    """The eval-mode prediction of one image cropped to a multiple of P (the
    reference's batch-size-1 evaluation)."""
    H, W = image.shape[:2]
    x = normalize_image(image[: (H // P) * P, : (W // P) * P])[None]
    return eval_step(state, torch.from_numpy(np.ascontiguousarray(x)).to(_device(state)))[0] \
        .cpu().numpy()


def bucketed_predictions(state: TrainState, dataset, indices,
                         patch_size: Optional[int] = None, batch_size: int = 8,
                         yield_items: bool = False):
    """Yield (dataset_index, pred (H, W) int32) for each index, or (index,
    pred, dataset_item) with yield_items=True, computed through <= 2 padded
    shape buckets. The shape pass reads only image headers when the dataset
    exposes its paths (`.images`); each image is decoded once, during batch
    assembly."""
    P = _patch_size(state, patch_size)
    pos_embed = state.model.backbone.pos_embed
    dev = pos_embed.device
    shapes = {}
    paths = getattr(dataset, "images", None)
    if paths is not None:
        from PIL import Image as PILImage
        for i in indices:
            with PILImage.open(paths[i]) as im:
                Wd, Hd = im.size
            shapes[i] = ((Hd // P) * P, (Wd // P) * P)
    else:
        for i in indices:
            image, _, _, _ = dataset[i]
            shapes[i] = ((image.shape[0] // P) * P, (image.shape[1] // P) * P)
    buckets = _eval_buckets(list(shapes.values()))
    assign: dict = {b: [] for b in buckets}
    for i, s in shapes.items():
        fits = [b for b in buckets if b[0] >= s[0] and b[1] >= s[1]]
        assign[min(fits, key=lambda b: b[0] * b[1])].append(i)
    pos_cache: dict = {}
    for (Hb, Wb), idxs in assign.items():
        if not idxs:
            continue
        hp, wp = Hb // P, Wb // P
        for c0 in range(0, len(idxs), batch_size):
            chunk = idxs[c0:c0 + batch_size]
            n_real = len(chunk)
            padded_chunk = chunk + [chunk[-1]] * (batch_size - n_real)
            ims = np.zeros((batch_size, Hb, Wb, 3), np.float32)
            vhw = np.zeros((batch_size, 2), np.int64)
            pos = np.zeros((batch_size, 1 + hp * wp, pos_embed.shape[-1]), np.float32)
            items = {}
            for bi, i in enumerate(padded_chunk):
                item = items.get(i)
                if item is None:
                    item = dataset[i]
                    if bi < n_real:
                        items[i] = item
                H, W = shapes[i]
                ims[bi, :H, :W] = normalize_image(item[0][:H, :W])
                vhw[bi] = (H, W)
                pos[bi] = _pos_for_bucket(pos_embed, H // P, W // P, hp, wp, pos_cache)
            preds = eval_step_bucketed(
                state, torch.from_numpy(ims).to(dev), torch.from_numpy(vhw).to(dev),
                torch.from_numpy(pos).to(dev), patch_size=P).cpu().numpy()
            for bi, i in enumerate(chunk[:n_real]):
                H, W = shapes[i]
                if yield_items:
                    yield i, preds[bi, :H, :W], items[i]
                else:
                    yield i, preds[bi, :H, :W]


def evaluate_model(state: TrainState, dataset, num_classes: int = VOC_NUM_CLASSES,
                   ignore_index: int = 255, max_images: Optional[int] = None,
                   bucketed: Optional[bool] = None, batch_size: int = 8,
                   patch_size: Optional[int] = None):
    """Flat-pixel mIoU of model predictions vs GT, assuming the matching was
    already applied as the dataset label_map (reference: train.py:278-348,
    batch-size-1 semantics). bucketed=True batches the images through <= 2
    padded shape buckets (pixel-exact vs the per-image path, bucketed=False);
    None (the default) buckets ViT backbones and not ResNets. Returns (miou,
    per-class Jaccard as numpy)."""
    P = _patch_size(state, patch_size)
    if bucketed is None:
        bucketed = supports_bucketed_eval(state)
    n = len(dataset) if max_images is None else min(len(dataset), max_images)
    preds_all, gts_all = [], []

    def accumulate(pred, target):
        Hp, Wp = pred.shape
        target_c = target[:Hp, :Wp]
        valid = target_c != ignore_index
        preds_all.append(pred[valid])
        gts_all.append(target_c[valid])

    if bucketed:
        tpaths = getattr(dataset, "targets", None)
        if tpaths is not None:
            indices = [i for i in range(n) if tpaths[i].is_file()]
        else:
            indices = [i for i in range(n) if dataset[i][2] is not None]
        for _, pred, item in bucketed_predictions(
                state, dataset, indices, patch_size=P, batch_size=batch_size,
                yield_items=True):
            accumulate(pred, item[2])
    else:
        for i in range(n):
            image, _, target, _ = dataset[i]
            if target is None:
                continue
            accumulate(_per_image_prediction(state, image, P), target)
    jac, miou = M.per_class_jaccard(torch.from_numpy(np.concatenate(preds_all)),
                                    torch.from_numpy(np.concatenate(gts_all)),
                                    num_classes)
    return float(miou), jac.numpy()


def generate_predictions(state: TrainState, dataset, output_dir,
                         max_images: Optional[int] = None,
                         bucketed: Optional[bool] = None, batch_size: int = 8,
                         patch_size: Optional[int] = None) -> None:
    """Dump model predictions (and GT where the dataset has it) as PNGs under
    <output_dir>/pred and /gt: the reference's `generate` job
    (train.py:351-388). bucketed=None buckets ViT backbones through padded
    shape buckets (pixel-exact, see `bucketed_predictions`) and runs ResNets
    one image at a time, each cropped to a multiple of the patch size."""
    out = Path(output_dir)
    (out / "pred").mkdir(parents=True, exist_ok=True)
    (out / "gt").mkdir(parents=True, exist_ok=True)
    n = len(dataset) if max_images is None else min(len(dataset), max_images)
    if bucketed is None:
        bucketed = supports_bucketed_eval(state)
    P = _patch_size(state, patch_size)

    def save(pred, item):
        _, _, target, stem = item
        save_segmap_png(pred.astype(np.uint8), out / "pred" / f"{stem}.png")
        if target is not None:
            save_segmap_png(np.asarray(target, np.uint8), out / "gt" / f"{stem}.png")

    if bucketed:
        for _, pred, item in bucketed_predictions(state, dataset, list(range(n)),
                                                  patch_size=P, batch_size=batch_size,
                                                  yield_items=True):
            save(pred, item)
    else:
        for i in range(n):
            item = dataset[i]
            save(_per_image_prediction(state, item[0], P), item)
    print(f"Wrote {n} predictions to {out}")


# ----------------------------------------------------------- checkpointing

def _ckpt_tree(state: TrainState) -> dict:
    """The full resumable state, as the JAX package checkpoints it: params,
    BN statistics, optimizer state, step and (when used) the EMA."""
    model = state.model
    tree = {"params": {n: p.detach().cpu() for n, p in model.named_parameters()},
            "batch_stats": {n: b.detach().cpu() for n, b in model.named_buffers()},
            "opt_state": state.opt.state_dict(),
            "step": int(state.step)}
    if state.ema_params is not None:
        tree["ema_params"] = {n: e.detach().cpu() for n, e in state.ema_params.items()}
    return tree


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int,
                    keep_best: bool = False) -> Path:
    """`torch.save` of the full train state to <ckpt_dir>/best.pt or
    step_<step>.pt (written to a temporary name, then renamed)."""
    path = Path(ckpt_dir).absolute() / ("best.pt" if keep_best else f"step_{step}.pt")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    torch.save(_ckpt_tree(state), tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(ckpt_dir_or_path: str, state: TrainState) -> TrainState:
    """Load a checkpoint file, or the newest step_*.pt (else best.pt) of a
    directory, into `state`. EMA presence may differ between the checkpoint
    and the current config: a missing EMA keeps its current values, an
    unused one is ignored, each with a warning."""
    path = Path(ckpt_dir_or_path).absolute()
    if path.is_dir():
        steps = sorted(path.glob("step_*.pt"), key=lambda p: int(p.stem.split("_")[1]))
        path = steps[-1] if steps else path / "best.pt"
    tree = torch.load(path, map_location="cpu", weights_only=True)
    model = state.model
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(tree["params"][n])
        for n, b in model.named_buffers():
            b.copy_(tree["batch_stats"][n])
        state.opt.load_state_dict(tree["opt_state"])
        state.step.fill_(tree["step"])
        if state.ema_params is not None:
            if "ema_params" in tree:
                for n, e in state.ema_params.items():
                    e.copy_(tree["ema_params"][n])
            else:
                print("warning: checkpoint has no EMA state — EMA params keep "
                      "their current (re-initialized) values")
        elif "ema_params" in tree:
            print("warning: checkpoint contains EMA state but the current "
                  "config does not use EMA — ignoring it")
    return state


# ----------------------------------------------------------------- train loop

def _step_batch(dataset, cfg: TrainConfig, step: int, rows: range) -> tuple:
    """Rows `rows` of the global batch of `step`, as (images, segmaps) numpy
    stacks. Its row j is the sample at position step * batch_size + j of a
    stream of seeded permutations of the dataset (one an epoch), augmented
    with draws from an rng seeded by (seed, step, j): a row's content does
    not depend on the rank, the thread or the run (resumed or not) that
    makes it."""
    n, ims, segs, perms = len(dataset), [], [], {}
    for j in rows:
        pos = step * cfg.batch_size + j
        epoch = pos // n
        if epoch not in perms:
            perms[epoch] = np.random.default_rng((cfg.seed, epoch)).permutation(n)
        image, seg, _, _ = dataset[int(perms[epoch][pos % n])]
        im, sg = train_augment(np.random.default_rng((cfg.seed, step, j)), image, seg,
                               cfg.resize_size, cfg.crop_size)
        ims.append(im)
        segs.append(sg)
    return np.stack(ims), np.stack(segs)


def train(cfg: TrainConfig, dataset_train, dataset_val=None,
          ckpt_dir: Optional[str] = None, eval_every: int = 1000,
          log_every: int = 50, max_steps: Optional[int] = None,
          backbone_params: Optional[dict] = None,
          metrics_path: Optional[str] = None, resume: Optional[str] = None,
          device: str | torch.device | None = None, mesh=None):
    """Self-training loop (reference: train.py:136-254) on one device: CUDA
    unless the caller asks for the CPU (`device="cpu"`). A CUDA device with
    no card raises RuntimeError. Returns the final state and the best
    validation mIoU.

    With `mesh` (a `parallel.make_mesh` DeviceMesh; one process per device,
    every rank calling `train` alike), training is data-parallel over the
    mesh's first dim, on the mesh's device type (this process's current
    CUDA device, or the CPU): the state is replicated, each rank's
    producers make only its block of every step's seeded global batch and
    the rank trains on it (`make_data_parallel`), and rank 0 alone evaluates, writes
    the checkpoints and the metric log, and prints, as the JAX single
    controller does these once; the other ranks receive its mIoU."""
    from ..parallel import distributed
    from ..utils.logging import MetricWriter
    group, rank, n_ranks = None, 0, 1
    if mesh is not None:
        group = mesh.get_group(mesh.mesh_dim_names[0])
        rank, n_ranks = dist.get_rank(group), dist.get_world_size(group)
        if cfg.batch_size % n_ranks:
            raise ValueError(f"batch {cfg.batch_size} not divisible by mesh dim "
                             f"{mesh.mesh_dim_names[0]!r} ({n_ranks})")
        if device is None:
            device = "cpu" if mesh.device_type == "cpu" else \
                torch.device("cuda", torch.cuda.current_device())
    master = distributed.is_master()
    device = resolve_device(device, "train")
    state = create_train_state(cfg, build_model(cfg), backbone_params, device)
    start_step = 0
    if resume:
        # Continue from the restored step, so only the REMAINING steps run
        # (the schedule's count is part of the optimizer state).
        state = restore_checkpoint(resume, state)
        start_step = int(state.step)
        if master:
            print(f"Resumed from {resume} at step {start_step}")
    if group is not None:
        make_data_parallel(state, group)
    steps = max_steps or cfg.max_train_steps
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    best_miou = -1.0
    writer = MetricWriter(metrics_path) if metrics_path and master else None
    per_rank = cfg.batch_size // n_ranks

    # Prefetching batch producers: dataset read + augmentation run in
    # cfg.num_workers threads ahead of the device (PIL decode/resize release
    # the GIL), consumed in step order. A rank makes only its own rows of
    # each global batch, which are a function of the seed and the step
    # alone (`_step_batch`); each thread takes one slice of a step's rows,
    # so all of them work on the step the loop waits for next, two steps
    # are in flight, and an exit waits for one slice a thread at most.
    n_workers = max(int(cfg.num_workers), 1)
    bounds = [rank * per_rank + per_rank * w // n_workers for w in range(n_workers + 1)]
    slices = [range(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    pool = ThreadPoolExecutor(n_workers, thread_name_prefix="train-batches")
    pending: collections.deque = collections.deque()  # a list of slice futures a step
    next_step = start_step

    try:
        for step in range(start_step, steps):
            while len(pending) < 2 and next_step < steps:
                pending.append([pool.submit(_step_batch, dataset_train, cfg, next_step, r)
                                for r in slices])
                next_step += 1
            parts = [f.result() for f in pending.popleft()]
            ims_np, segs_np = (np.concatenate([part[i] for part in parts]) for i in (0, 1))
            logs = train_step(state, torch.from_numpy(ims_np).to(device),
                              torch.from_numpy(segs_np).to(device), generator,
                              use_ema=cfg.use_ema, ema_decay=cfg.ema_decay)
            if master and log_every and step % log_every == 0:
                print(f"step {step}: loss={float(logs['loss']):.4f} "
                      f"acc={float(logs['acc']):.4f}")
            if writer is not None and step % max(log_every, 1) == 0:
                writer.log(step, loss=float(logs["loss"]), acc=float(logs["acc"]))
            if dataset_val is not None and eval_every and (step + 1) % eval_every == 0:
                miou = -1.0
                if master:
                    miou, _ = evaluate_model(state, dataset_val, cfg.num_classes,
                                             patch_size=_backbone_patch_size(cfg))
                    print(f"step {step}: val mIoU={miou:.4f}")
                    if writer is not None:
                        writer.log(step, val_miou=miou)
                if group is not None:  # rank 0's mIoU on every rank
                    miou = distributed.all_sum_scalar(miou if master else 0.0)
                if miou > best_miou:
                    best_miou = miou
                    if ckpt_dir and master:
                        save_checkpoint(ckpt_dir, state, step + 1, keep_best=True)
            if ckpt_dir and master and (step + 1) % max(eval_every, 1000) == 0:
                save_checkpoint(ckpt_dir, state, step + 1)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        if writer is not None:
            writer.close()
    if master:
        print(f"trained steps {start_step}..{steps}: {max(steps - start_step, 0)} steps")
    return state, best_miou
