"""Binary morphology and connected components on patch grids, in PyTorch
(`deep_spectral_tpu.ops.morphology`), batched over images on the device.

Every function takes a mask or segmap whose last two dims are the grid, (h,
w) or (B, h, w), and works per image:
  * erosion and dilation with the cross (connectivity-1) footprint, the
    default of skimage's binary_erosion/dilation (reference:
    extract/extract_utils.py:115-121); erosion pads with 1, dilation with 0;
  * connected components (skimage measure_label, 8-connectivity; scipy's
    4-connectivity with connectivity=1) by min-label propagation to a fixed
    point, each pixel's label the smallest 1-based flat index of its
    component, as the JAX package labels;
  * the largest component (argmax over component sizes, first on ties), its
    bbox, and the border fraction of each segment with the reference's
    corners counted twice (its four 1-D borders, extract_utils.py:124-135).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.device import POLL_EVERY


def _batched(x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    return (x, True) if x.dim() == 3 else (x[None], False)


def _cross(m: torch.Tensor, pad: float, reduce) -> torch.Tensor:
    """One step of `reduce` (amin or amax) over the cross footprint of a
    (B, h, w) float grid padded with `pad`."""
    p = F.pad(m, (1, 1, 1, 1), value=pad)
    stack = torch.stack([p[:, 1:-1, 1:-1], p[:, :-2, 1:-1], p[:, 2:, 1:-1],
                         p[:, 1:-1, :-2], p[:, 1:-1, 2:]])
    return reduce(stack, 0)


def _erode_dilate_once(mask: torch.Tensor, erode: bool) -> torch.Tensor:
    m, batched = _batched(mask.float())
    out = _cross(m, 1.0, torch.amin) if erode else _cross(m, 0.0, torch.amax)
    out = out.bool()
    return out if batched else out[0]


def binary_erode(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    for _ in range(iterations):
        mask = _erode_dilate_once(mask, erode=True)
    return mask


def binary_dilate(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    for _ in range(iterations):
        mask = _erode_dilate_once(mask, erode=False)
    return mask


def erode_or_dilate_mask(mask: torch.Tensor, r: int, erode: bool = True) -> torch.Tensor:
    """r steps, each skipped for an image whose mask it would empty: the
    reference's "do not erode the entire mask away" guard
    (extract/extract_utils.py:115-121)."""
    m = mask.bool()
    for _ in range(r):
        new = _erode_dilate_once(m, erode)
        keep = new.flatten(-2).any(-1)[..., None, None]
        m = torch.where(keep, new, m)
    return m


def label_components(mask: torch.Tensor, connectivity: int = 2) -> torch.Tensor:
    """Connected-component labels (int32, 0 = background) of boolean masks:
    each component takes the smallest 1-based flat index among its pixels.
    connectivity 1: 4-neighbourhood; 2: 8-neighbourhood."""
    m, batched = _batched(mask.bool())
    B, h, w = m.shape
    big = h * w + 2
    seeds = torch.arange(1, h * w + 1, dtype=torch.int32, device=m.device).reshape(1, h, w)
    labels = torch.where(m, seeds, big)
    shifts = [(0, 1), (0, -1), (1, 0), (-1, 0)]
    if connectivity == 2:
        shifts += [(1, 1), (1, -1), (-1, 1), (-1, -1)]
    step = 0
    while True:
        p = F.pad(labels, (1, 1, 1, 1), value=big)
        new = labels
        for dy, dx in shifts:
            new = torch.minimum(new, p[:, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w])
        new = torch.where(m, new, big)
        step += 1
        if step % POLL_EVERY == 0 and not bool((new != labels).any()):
            break
        labels = new
    out = torch.where(m, labels, 0)
    return out if batched else out[0]


def component_sizes(labels: torch.Tensor, max_labels: int) -> torch.Tensor:
    """Histogram of label ids in [0, max_labels) (ids clipped into range),
    per image: (..., max_labels) int32."""
    flat = labels.reshape(*labels.shape[:-2], -1).long().clamp(0, max_labels - 1)
    out = torch.zeros((*flat.shape[:-1], max_labels), dtype=torch.int32, device=labels.device)
    return out.scatter_add_(-1, flat, torch.ones_like(flat, dtype=torch.int32))


def largest_component(mask: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the largest 8-connected component
    (reference: extract/extract_utils.py:107-112); empty stays empty."""
    labels = label_components(mask, connectivity=2)
    h, w = mask.shape[-2:]
    sizes = component_sizes(labels, h * w + 2)
    sizes[..., 0] = 0  # not the background
    best = sizes.argmax(-1)[..., None, None]
    return (labels == best) & mask.bool()


def mask_bbox(mask: torch.Tensor) -> torch.Tensor:
    """[xmin, ymin, xmax, ymax] (exclusive max) of boolean masks, int32;
    zeros for an empty mask."""
    h, w = mask.shape[-2:]
    m = mask.bool()
    any_row, any_col = m.any(-1), m.any(-2)
    rows = torch.arange(h, device=m.device)
    cols = torch.arange(w, device=m.device)
    ymin = torch.where(any_row, rows, h).amin(-1)
    ymax = torch.where(any_row, rows, -1).amax(-1) + 1
    xmin = torch.where(any_col, cols, w).amin(-1)
    xmax = torch.where(any_col, cols, -1).amax(-1) + 1
    box = torch.stack([xmin, ymin, xmax, ymax], -1).to(torch.int32)
    return torch.where(m.flatten(-2).any(-1)[..., None], box, 0)


def largest_component_bbox(mask: torch.Tensor) -> torch.Tensor:
    """[xmin, ymin, xmax, ymax] of the largest 8-connected component
    (reference: object-localization/object_discovery.py:280-287)."""
    return mask_bbox(largest_component(mask))


def _border_weights(h: int, w: int, extents: Optional[torch.Tensor] = None,
                   device=None) -> torch.Tensor:
    """How often each pixel of an (h, w) grid lies on the reference's four
    1-D borders (first and last column, first and last row: corners twice),
    int32; with extents (B, 2) of valid (h_i, w_i) at the top left of
    each grid, the borders of the valid part; (B, h, w), B = 1 without."""
    if extents is None:
        extents = torch.tensor([[h, w]], device=device)
    eh, ew = (extents[:, i, None, None].to(device) for i in (0, 1))
    y = torch.arange(h, device=device)[None, :, None]
    x = torch.arange(w, device=device)[None, None, :]
    inside = (y < eh) & (x < ew)
    count = ((x == 0).int() + (x == ew - 1).int() + (y == 0).int() + (y == eh - 1).int())
    return torch.where(inside, count, 0).to(torch.int32)


def get_border_fraction(segmap: torch.Tensor, num_segments: int,
                        extents: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment border pixel counts (corners twice) and their fractions
    of 2 (h + w); ids clipped into [0, num_segments). segmap (h, w) or
    (B, h, w); extents (B, 2) restrict each image to its valid top-left
    part. Returns ((..., num_segments) int32, (..., num_segments) f32)."""
    h, w = segmap.shape[-2:]
    s, batched = _batched(segmap)
    wgt = _border_weights(h, w, extents, s.device).expand(s.shape[0], h, w)
    ids = s.long().clamp(0, num_segments - 1).flatten(1)
    counts = torch.zeros((s.shape[0], num_segments), dtype=torch.int32, device=s.device)
    counts.scatter_add_(1, ids, wgt.reshape(s.shape[0], -1))
    if extents is None:
        denom = torch.full((s.shape[0], 1), 2.0 * (h + w), device=s.device)
    else:
        denom = 2.0 * extents.to(s.device).sum(-1, keepdim=True).float()
    frac = counts.float() / denom
    return (counts, frac) if batched else (counts[0], frac[0])


def infer_background_swap(segmap: torch.Tensor, num_segments: int,
                          extents: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Relabel so that the segment with the most border pixels (the first
    of them on ties) becomes 0, swapping labels with the old 0
    (reference: extract/extract.py:342-348)."""
    _, frac = get_border_fraction(segmap, num_segments, extents)
    bg = frac.argmax(-1)[..., None, None]
    out = torch.where(segmap == bg, 0, segmap)
    return torch.where(segmap == 0, bg.to(segmap.dtype), out)
