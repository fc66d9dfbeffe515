"""Unsupervised object localization (CorLoc): the port of
`deep_spectral_tpu.tasks.localization`, the reference's `object-localization/`
subproject.

Three discovery methods, as in the reference (main.py):
  * eigenseg, the paper's method: a patch mask from the Fiedler vector of
    the precomputed (or on-the-fly) spectral decomposition, its largest
    connected component, the box (object_discovery.py:85-126);
  * LOST, the inverse-degree seed and its expansion (object_discovery.py:129-227);
  * dino_seg, thresholded CLS-attention mass (object_discovery.py:230-277).

The on-the-fly methods run the ViT on the model's device (the flash kernels
on CUDA), eigenseg's solve through `ops.eigen.spectral_decompose` (the
Chebyshev filter kernel at N >= 512) and LOST's affinity there in true f32;
connected components and the boxes are host code (`utils/native_cc`).
VOC XML annotations are parsed directly (the reference wraps
torchvision.VOCDetection), with its GT semantics: the 1-based -> 0-based box
fix (datasets.py:262-264) and the 'hard' image filter (:198-215).
"""
from __future__ import annotations

import pickle
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.affinity import l2_normalize
from ..ops.eigen import spectral_decompose
from ..utils.precision import exact_f32
from ..utils.serialization import load_pth
from ..utils.sizes import infer_patch_grid


# ------------------------------------------------------------------- datasets

def parse_voc_annotation(xml_path: str | Path, remove_hards: bool = False):
    """GT boxes from a VOC XML: [xmin-1, ymin-1, xmax, ymax] (the reference's
    1-based fix, datasets.py:262-264). Returns (boxes (G,4) float32, n_hard)."""
    root = ET.parse(str(xml_path)).getroot()
    boxes, n_hard = [], 0
    for obj in root.findall("object"):
        hard = (int((obj.findtext("truncated") or "0")) == 1 or
                int((obj.findtext("difficult") or "0")) == 1)
        if hard:
            n_hard += 1
            if remove_hards:
                continue
        bb = obj.find("bndbox")
        boxes.append([float(bb.findtext("xmin")) - 1.0,
                      float(bb.findtext("ymin")) - 1.0,
                      float(bb.findtext("xmax")),
                      float(bb.findtext("ymax"))])
    return np.asarray(boxes, np.float32).reshape(-1, 4), n_hard


def load_voc_detection(root: str | Path, year: str = "2012",
                       image_set: str = "trainval"):
    """List of (image_path, annotation_path) for a VOC detection split."""
    root = Path(root)
    base = root if (root / "JPEGImages").is_dir() else root / f"VOC{year}"
    ids = (base / "ImageSets" / "Main" / f"{image_set}.txt").read_text().split()
    return [(base / "JPEGImages" / f"{i}.jpg",
             base / "Annotations" / f"{i}.xml") for i in ids]


def load_coco_detection(images_dir: str | Path, annotations_json: str | Path,
                        subset_ids: Optional[Sequence[int]] = None,
                        remove_iscrowd: bool = True):
    """[(image_path, gt_boxes (G,4) xyxy float32)] from a COCO instances json
    (the reference's extract_gt_COCO, datasets.py:217-235): crowd annotations
    removed by default, xywh boxes converted to xyxy and rounded to integer
    coordinates."""
    import json
    images_dir = Path(images_dir)
    with open(annotations_json) as f:
        ann = json.load(f)
    keep = set(subset_ids) if subset_ids is not None else None
    by_image: dict[int, list] = {}
    for a in ann["annotations"]:
        if keep is not None and a["image_id"] not in keep:
            continue
        if remove_iscrowd and a.get("iscrowd", 0) == 1:
            continue
        x, y, w, h = a["bbox"]
        by_image.setdefault(a["image_id"], []).append(
            [round(x), round(y), round(x + w), round(y + h)])
    pairs = []
    for im in ann["images"]:
        iid = im["id"]
        if keep is not None and iid not in keep:
            continue
        boxes = np.asarray(by_image.get(iid, []), np.float32).reshape(-1, 4)
        pairs.append((images_dir / im["file_name"], boxes))
    return pairs


def select_coco_20k(annotations_json: str | Path,
                    sel_file: Optional[str | Path] = None,
                    seed: int = 42, n: int = 20_000) -> list[int]:
    """Image ids of the COCO20k subset: from LOST's published selection list
    of train2014 file names when `sel_file` is given (the reference's
    `select_coco_20k`, datasets.py:324-368), else a seeded choice over the
    annotation file's images (not the published list, so its CorLoc is not
    comparable to the paper's)."""
    import json
    if sel_file is not None:
        ids = []
        for line in Path(sel_file).read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            # "COCO_train2014_000000000009.jpg" -> 9 (datasets.py:336)
            stem = line.rsplit("/", 1)[-1].split(".")[0]
            ids.append(int(stem.split("_")[-1]))
        return ids
    with open(annotations_json) as f:
        ann = json.load(f)
    image_ids = sorted({im["id"] for im in ann["images"]})
    rng = np.random.default_rng(seed)
    return sorted(rng.choice(np.asarray(image_ids), size=min(n, len(image_ids)),
                             replace=False).tolist())


# ------------------------------------------------------ eigenseg box discovery

def get_bbox_from_patch_mask(patch_mask: np.ndarray,
                             image_hw: tuple[int, int]) -> np.ndarray:
    """Patch mask -> image-space box via its largest 8-connected component
    (reference: object_discovery.py:85-126): the patch grid is inferred from
    the mask length, a mask over half full (or empty) is inverted, and the
    box is scaled by P and clamped to the image."""
    from ..utils import native_cc
    H, W = image_hw
    P, h_lr, w_lr = infer_patch_grid(int(np.size(patch_mask)), H, W)
    mask = np.asarray(patch_mask).reshape(h_lr, w_lr).astype(np.uint8)
    mean = float(mask.mean())
    if 0.5 < mean < 1.0 or mask.sum() == 0:
        mask = 1 - mask
    cc = native_cc.largest_component(mask.astype(bool), connectivity=2)
    ys, xs = np.where(cc)
    if len(ys) == 0:
        xmin = ymin = xmax = ymax = 0
    else:
        ymin, ymax = int(ys.min()), int(ys.max()) + 1
        xmin, xmax = int(xs.min()), int(xs.max()) + 1
    pred = [P * xmin, P * ymin, min(P * xmax, W), min(P * ymax, H)]
    return np.asarray(pred, np.float32)


def eigenseg_box_from_eigs(eigs: dict, image_hw: tuple[int, int],
                           which_matrix: str = "laplacian") -> np.ndarray:
    """Box from a precomputed eigs dict: the Fiedler row 1 for the laplacian
    modes, row 0 for the affinity modes (reference:
    object-localization/main.py:254-272)."""
    row = 1 if which_matrix in ("laplacian", "matting_laplacian") else 0
    vec = np.asarray(eigs["eigenvectors"])[row]
    return get_bbox_from_patch_mask(vec > 0.0, image_hw)


def eigenseg_box_from_features(feats: torch.Tensor, dims: tuple[int, int],
                               image_hw: tuple[int, int],
                               which_matrix: str = "laplacian",
                               K: int = 2) -> np.ndarray:
    """On-the-fly spectral discovery from (N, D) patch features on their
    device (reference: object_discovery.py:16-82 + main.py:281-364)."""
    _, vecs = spectral_decompose(feats, K, which_matrix=which_matrix, normalize=True)
    row = 1 if which_matrix in ("laplacian", "matting_laplacian") else 0
    return get_bbox_from_patch_mask(vecs[row].cpu().numpy() > 0.0, image_hw)


# ------------------------------------------------------------- LOST baseline

@torch.no_grad()
def _lost_core(feats: torch.Tensor, k_patches: int = 100):
    """Device part of LOST (reference: object_discovery.py:129-184): the
    affinity in true f32, inverse-degree scores, the seed and its expansion.
    The degree is an integer count that ties often, so the order of the
    patches is a stable sort, as JAX's is."""
    with exact_f32():
        A = feats @ feats.T
    A_nd = torch.clamp_min(A - torch.diag_embed(torch.diagonal(A)), 0.0)
    cent = -(A_nd > 0).to(torch.float32).sum(dim=1)
    sorted_patches = torch.argsort(-cent, stable=True)  # descending inverse degree
    seed = sorted_patches[0]
    potentials = sorted_patches[:k_patches]
    similar = A[seed, potentials] > 0.0
    Msum = torch.where(similar[:, None], A[potentials, :], 0.0).sum(dim=0)
    return Msum, seed, cent, A


def lost(feats, dims: tuple[int, int], scales: tuple[int, int],
         image_hw: tuple[int, int], k_patches: int = 100) -> np.ndarray:
    """LOST box prediction (reference: object_discovery.py:129-227): the
    connected component of {M > 0} that holds the seed. feats: (N, D),
    l2-normalized, a tensor (on any device) or a numpy array."""
    from ..utils import native_cc
    w_featmap, h_featmap = dims
    Msum, seed, _, _ = _lost_core(torch.as_tensor(feats, dtype=torch.float32), k_patches)
    correl = Msum.cpu().numpy().reshape(w_featmap, h_featmap)
    # 4-connectivity, scipy.ndimage.label's default structure
    labeled, _ = native_cc.cc_label(correl > 0.0, connectivity=1)
    cc = labeled[np.unravel_index(int(seed), (w_featmap, h_featmap))]
    if cc == 0:
        raise ValueError("LOST seed fell in the background component")
    ys, xs = np.where(labeled == cc)
    ymin, ymax = ys.min(), ys.max() + 1
    xmin, xmax = xs.min(), xs.max() + 1
    pred = [scales[1] * xmin, scales[0] * ymin,
            min(scales[1] * xmax, image_hw[1]), min(scales[0] * ymax, image_hw[0])]
    return np.asarray(pred, np.float32)


# --------------------------------------------------------- DINO-seg baseline

def dino_seg(attn: np.ndarray, dims: tuple[int, int], patch_size: int,
             head: int = 0) -> np.ndarray:
    """CLS-attention mass thresholded at 0.6, the box of the biggest
    component (reference: object_discovery.py:230-277). attn: (1, heads,
    1+N, 1+N) on the host."""
    from ..utils import native_cc
    w_featmap, h_featmap = dims
    nh = attn.shape[1]
    att = np.asarray(attn)[0, :, 0, 1:].reshape(nh, -1)
    val = np.sort(att, axis=1)
    idx = np.argsort(att, axis=1)
    val = val / val.sum(axis=1, keepdims=True)
    cumval = np.cumsum(val, axis=1)
    th_attn = cumval > (1 - 0.6)
    idx2 = np.argsort(idx, axis=1)
    th = np.stack([th_attn[h][idx2[h]] for h in range(nh)])
    th = th.reshape(nh, w_featmap, h_featmap).astype(np.float32)
    labeled, _ = native_cc.cc_label(th[head] > 0, connectivity=1)
    sizes = [np.sum(labeled == c) for c in range(labeled.max())]
    biggest = (np.argmax(sizes[1:]) + 1) if len(sizes) > 1 else 0
    ys, xs = np.where(labeled == biggest)
    ymin, ymax = ys.min(), ys.max() + 1
    xmin, xmax = xs.min(), xs.max() + 1
    return np.asarray([xmin * patch_size, ymin * patch_size,
                       xmax * patch_size, ymax * patch_size], np.float32)


# ------------------------------------------------------ on-the-fly methods

@torch.no_grad()
def discover_box(image_rgb: np.ndarray, model, method: str = "eigenseg",
                 which_matrix: str = "laplacian", patch_size: int = 16) -> np.ndarray:
    """Single-image box discovery without precomputed eigs (reference:
    object-localization/main.py:281-364): a ViT forward on the model's
    device, then `method`: 'eigenseg' (spectral), 'lost' or 'dino_seg'."""
    from ..models.vit import extract_patch_keys
    from ..utils.image_io import normalize_imagenet_hwc

    H, W = image_rgb.shape[:2]
    P = patch_size
    hp, wp = H // P, W // P
    dev = next(model.parameters()).device
    x = torch.from_numpy(normalize_imagenet_hwc(image_rgb)[None, : hp * P, : wp * P]).to(dev)
    if method == "dino_seg":
        attn = model(x, want_attn=True, n_intermediates=0, qkv_block=-1)["attn"]
        return dino_seg(attn.float().cpu().numpy(), (hp, wp), P)
    feats = extract_patch_keys(model, x)[0].float()  # (N, D)
    if method == "eigenseg":
        return eigenseg_box_from_features(feats, (hp, wp), (H, W),
                                          which_matrix=which_matrix)
    if method == "lost":
        return lost(l2_normalize(feats), (hp, wp), (P, P), (H, W))
    raise ValueError(f"unknown method {method!r}")


# ---------------------------------------------------------------- CorLoc eval

def evaluate_corloc(
    pairs: Sequence[tuple],   # (image_path, xml_annotation_path | gt_boxes array)
    eigs_dir: Optional[str | Path] = None,
    which_matrix: str = "laplacian",
    output_dir: Optional[str | Path] = None,
    remove_hards: bool = False,
    progress: bool = True,
    method: str = "eigenseg",
    model=None,
    patch_size: int = 16,
):
    """CorLoc over a detection split (reference:
    object-localization/main.py:206-419): a prediction counts when its IoU
    with a GT box is >= 0.5. `pairs` come from `load_voc_detection` (XML
    paths) or `load_coco_detection` (box arrays). Boxes come from the eigs in
    `eigs_dir`, or, with `eigs_dir=None`, are discovered on the fly by
    `model` (the port's ViT) with `method` ('eigenseg', 'lost' or
    'dino_seg'). Writes preds.pkl, gt.pkl and results.txt to `output_dir`
    and returns (score, preds, gts)."""
    from PIL import Image
    if eigs_dir is not None:
        eigs_dir = Path(eigs_dir)
    elif model is None:
        raise ValueError("need eigs_dir, or a model for on-the-fly discovery")
    corloc, preds, gts = [], [], []
    it = pairs
    if progress:
        try:
            from tqdm import tqdm
            it = tqdm(pairs, desc="corloc")
        except ImportError:
            pass
    for image_path, ann in it:
        if isinstance(ann, (str, Path)):
            gt_boxes, _ = parse_voc_annotation(ann, remove_hards=remove_hards)
        else:
            gt_boxes = np.asarray(ann, np.float32).reshape(-1, 4)
        if gt_boxes.shape[0] == 0:
            continue
        if eigs_dir is not None:
            with Image.open(str(image_path)) as im:
                W, H = im.size
            eigs = load_pth(eigs_dir / f"{Path(image_path).stem}.pth")
            pred = eigenseg_box_from_eigs(eigs, (H, W), which_matrix)
        else:
            from ..utils.image_io import load_image_rgb
            rgb = load_image_rgb(image_path)
            pred = discover_box(rgb, model, method=method, which_matrix=which_matrix,
                                patch_size=patch_size)
        # host IoU: one image's boxes are a handful of numbers
        ix1 = np.maximum(pred[0], gt_boxes[:, 0])
        iy1 = np.maximum(pred[1], gt_boxes[:, 1])
        ix2 = np.minimum(pred[2], gt_boxes[:, 2])
        iy2 = np.minimum(pred[3], gt_boxes[:, 3])
        inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
        a1 = (pred[2] - pred[0]) * (pred[3] - pred[1])
        a2 = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])
        ious = inter / np.maximum(a1 + a2 - inter, 1e-16)
        corloc.append(float(ious.max() >= 0.5))
        preds.append(pred)
        gts.append(gt_boxes)
    score = 100.0 * float(np.mean(corloc)) if corloc else 0.0
    if output_dir is not None:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "preds.pkl", "wb") as f:
            pickle.dump(preds, f)
        with open(out / "gt.pkl", "wb") as f:
            pickle.dump(gts, f)
        (out / "results.txt").write_text(f"corloc,{score:.1f},{len(corloc)}\n")
    print(f"corloc: {score:.2f} ({int(np.sum(corloc))}/{len(corloc)})")
    return score, preds, gts
