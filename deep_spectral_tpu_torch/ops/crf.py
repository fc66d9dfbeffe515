"""Dense CRF mean-field refinement: the port of `deep_spectral_tpu.ops.crf`.

It takes the place of SimpleCRF's C++ `denseCRF.densecrf(image, unary, (w1,
alpha, beta, w2, gamma, it))` (reference: extract/extract.py:688-710), with
the JAX package's formulation and constants. The bilateral message passing
has two regimes:

  * EXACT DENSE (at the reference's parameters): the guide image is
    box-downsampled by s ~ alpha/8, the kernel's own spatial resolution, and
    the bilateral kernel K_ij = exp(-|dp|^2/2a^2 - |dI|^2/2b^2) over the
    n_lr = (H/s)*(W/s) low-res points is built once per image; each
    mean-field iteration is one (n_lr, n_lr) @ (n_lr, C) matmul and a
    joint-bilateral upsample back to full resolution. The kernel takes
    n_lr^2 f32 per image: 29 MB for a 512x512 bucket at alpha 80 (s = 10,
    n_lr = 2704), 268 MB at the bound n_lr = _DENSE_MAX_POINTS.
  * BILATERAL GRID (n_lr > _DENSE_MAX_POINTS: a small alpha or a large
    image): splat -> separable [1,2,1] blur -> slice through a 5-D
    (y, x, r, g, b) grid. The splat's scatter-add runs in a fixed order on
    every device: the updates are sorted by grid cell (a stable sort), summed
    within each cell by a segmented doubling scan, and written once per
    cell. `index_add_` with float atomics on CUDA would sum in whatever
    order the threads arrive, and the stage must write the same bytes on
    every run.

Energy model (Krahenbuhl & Koltun dense CRF with Potts compatibility):
    E(x) = sum_i -log P(x_i)
         + sum_{i<j} mu(x_i, x_j) [ w1 exp(-|p_i-p_j|^2/2a^2 - |I_i-I_j|^2/2b^2)
                                  + w2 exp(-|p_i-p_j|^2/2g^2) ]
Defaults (w1=10, alpha=80, beta=13, w2=3, gamma=3, it=5) follow the
reference's CRF recipe (extract/extract.py:705-710). Mean-field messages
stay unnormalized (kernel sums, not averages): normalized messages collapse
every image to its majority label.

The helpers take one image (H, W, C) or a batch of same-shape images
(B, H, W, C), and everything runs in true f32 (`exact_f32`): the JAX package
pins the kernel's distance matmul to precision HIGHEST, and its message
matmul on the CPU is f32. `dense_crf` on a batch gives each image what the
single-image call gives: the message matmuls run one image at a time.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.precision import exact_f32

CRFParams = Tuple[float, float, float, float, float, float]
DEFAULT_CRF_PARAMS: CRFParams = (10.0, 80.0, 13.0, 3.0, 3.0, 5.0)

# Exact-dense regime bound: the (n_lr, n_lr) f32 kernel of an image is
# materialized once (~268 MB at 8192); above it the 5-D bilateral grid.
_DENSE_MAX_POINTS = 8192

# Self-gain of the bilateral grid (splat -> unnormalized [1,2,1] blur ->
# slice) per unit of exact kernel mass, calibrated in the JAX package
# against the exact O(N^2) mean-field oracle (tests/crf_oracle.py). Copied
# as it is: the grid regime divides its density by it.
GRID_SELF_GAIN = 14.2


# The JAX functions run jitted, and XLA's CPU code differs from eager torch
# in ways that move the last bit, which the kernel's sq_i + sq_j - 2 dot
# cancellation then amplifies ~100-fold: a reduction adds its elements left
# to right (`_sum_last`, `_box_downsample`), a division by a constant is a
# multiplication by its reciprocal (`_recip`), constant factors are folded
# into one, and a multiply-add rounds once (`_fma`). The port computes the
# bilateral coordinates so.

def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over a short last dim (3 or 5), left to right."""
    out = x[..., 0]
    for j in range(1, x.shape[-1]):
        out = out + x[..., j]
    return out


def _recip(c: float) -> float:
    """1/c rounded to f32: the factor XLA multiplies by where the JAX code
    divides by c."""
    return float(np.float32(1.0 / c))


def _fma(x: torch.Tensor, c: float, b: float) -> torch.Tensor:
    """x * c + b for f32 x, rounded once to f32 (the product of two f32
    values is exact in f64)."""
    return (x.double() * c + b).float()


def _gaussian_kernel_1d(sigma: float) -> torch.Tensor:
    radius = max(int(2.5 * sigma + 0.5), 1)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    return torch.exp(-(x * x) / (2.0 * sigma * sigma))


def _conv_axis(x: torch.Tensor, kernel, axis: int) -> torch.Tensor:
    """1-D convolution along `axis` with zero padding, as shifted-slice
    multiply-adds summed tap by tap in the JAX package's order. `kernel`: a
    1-D f32 tensor or a sequence of floats."""
    taps = kernel.tolist() if isinstance(kernel, torch.Tensor) else list(kernel)
    r = (len(taps) - 1) // 2
    axis = axis % x.ndim
    n = x.shape[axis]
    spec = [0, 0] * (x.ndim - axis)          # F.pad lists the last dim first
    spec[-2:] = [r, r]
    xp = F.pad(x, spec)
    out = xp.narrow(axis, 0, n) * taps[0]
    for t in range(1, len(taps)):
        out += xp.narrow(axis, t, n) * taps[t]
    return out


def gaussian_filter_2d(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable unnormalized Gaussian filter over the two spatial dims of
    (..., H, W, C): the CRF's smoothness kernel (std gamma). Its taps are
    computed on the CPU, the same numbers for every device."""
    k = _gaussian_kernel_1d(sigma)
    return _conv_axis(_conv_axis(x, k, x.ndim - 3), k, x.ndim - 2)


def _bilateral_grid_shape(H: int, W: int, alpha: float, beta: float):
    gy = int(H / alpha) + 3
    gx = int(W / alpha) + 3
    gc = int(255.0 / beta) + 3
    return gy, gx, gc


def _grid_coords(image: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    """(H, W, 5) continuous bilateral-grid coordinates (+1 cell margin)."""
    H, W = image.shape[:2]
    dev = image.device
    yy = _fma(torch.arange(H, dtype=torch.float32, device=dev), _recip(alpha), 1.0)
    xx = _fma(torch.arange(W, dtype=torch.float32, device=dev), _recip(alpha), 1.0)
    col = _fma(image.float(), _recip(beta), 1.0)
    yy, xx = yy[:, None].expand(H, W), xx[None, :].expand(H, W)
    return torch.stack([yy, xx, col[..., 0], col[..., 1], col[..., 2]], dim=-1)


def _windows(x: torch.Tensor, s: int) -> torch.Tensor:
    """(..., H, W, C) padded at the bottom and right by edge replication to
    multiples of s, as (..., H/s, s, W/s, s, C) windows."""
    H, W, C = x.shape[-3:]
    Hp, Wp = -(-H // s) * s, -(-W // s) * s
    dev = x.device
    x = x.index_select(-3, torch.arange(Hp, device=dev).clamp(max=H - 1))
    x = x.index_select(-2, torch.arange(Wp, device=dev).clamp(max=W - 1))
    return x.reshape(*x.shape[:-3], Hp // s, s, Wp // s, s, C)


def _window_sum(x: torch.Tensor, s: int) -> torch.Tensor:
    """Sum of each s x s window of (..., H, W, C), row by row."""
    x = _windows(x, s)
    acc = None
    for i in range(s):
        for j in range(s):
            v = x[..., i, :, j, :]
            acc = v if acc is None else acc + v
    return acc


def _box_downsample(x: torch.Tensor, s: int) -> torch.Tensor:
    """Mean-pool (..., H, W, C) by factor s, padding bottom and right by edge
    replication."""
    return x if s == 1 else _window_sum(x, s) * _recip(s * s)


def _lowres_setup(image: torch.Tensor, alpha: float, beta: float):
    """Box-downsample the guide (..., H, W, 3) by s ~ alpha/8 and return (s,
    img_lr, (..., n_lr, 5) bilateral coordinates of the low-res cell centres
    in the original pixel frame)."""
    s = max(1, int(alpha / 8.0))
    img = image.float()
    if s == 1:
        img_lr, col = img, _fma(img, _recip(beta), 1.0)
    else:
        acc = _window_sum(img, s)
        img_lr = acc * _recip(s * s)
        # XLA folds the mean's 1/s^2 and the 1/beta into one factor
        col = _fma(acc, float(np.float32(_recip(s * s) * _recip(beta))), 1.0)
    hl, wl = img_lr.shape[-3:-1]
    dev = image.device
    yy = _fma(torch.arange(hl, dtype=torch.float32, device=dev) * s + (s - 1) / 2.0,
              _recip(alpha), 1.0)
    # (XLA's code rounds the product of this one before the add)
    xx = (torch.arange(wl, dtype=torch.float32, device=dev) * s + (s - 1) / 2.0) \
        * _recip(alpha) + 1.0
    lead = col.shape[:-3]
    coords = torch.stack([yy[:, None].expand(*lead, hl, wl),
                          xx[None, :].expand(*lead, hl, wl),
                          col[..., 0], col[..., 1], col[..., 2]], dim=-1)
    return s, img_lr, coords.reshape(*lead, hl * wl, 5)


def _dense_kernel(coords: torch.Tensor) -> torch.Tensor:
    """Exact bilateral kernel K_ij = exp(-0.5 |f_i - f_j|^2) over (..., n, 5)
    (pos/alpha, col/beta) features, with |f_i - f_j|^2 as sq_i + sq_j -
    2 f_i.f_j in true f32, as the JAX package computes it."""
    with exact_f32():
        sq = _sum_last(coords * coords)
        dot = torch.matmul(coords, coords.transpose(-1, -2))
        d2 = torch.clamp(sq[..., :, None] + sq[..., None, :] - 2.0 * dot, min=0.0)
        return torch.exp(-0.5 * d2)


def _jbu_plan(img_lr: torch.Tensor, image: torch.Tensor, s: int, beta: float):
    """The image-only part of the joint-bilateral upsample, loop-invariant
    under mean field: for each of a full-res pixel's 4 low-res neighbours,
    its row and column indices and its weight (color similarity x bilinear
    distance, normalized over the 4). img_lr (..., hl, wl, 3), image
    (..., H, W, 3)."""
    H, W = image.shape[-3:-1]
    hl, wl = img_lr.shape[-3:-1]
    dev = image.device
    c0 = (s - 1) / 2.0
    ty = np.clip((np.arange(H) - c0) / s, 0, hl - 1)
    tx = np.clip((np.arange(W) - c0) / s, 0, wl - 1)
    iy0 = np.floor(ty).astype(np.int64)
    ix0 = np.floor(tx).astype(np.int64)
    iy1 = np.minimum(iy0 + 1, hl - 1)
    ix1 = np.minimum(ix0 + 1, wl - 1)
    ry = torch.from_numpy((ty - iy0).astype(np.float32)).to(dev)[:, None]   # (H, 1)
    rx = torch.from_numpy((tx - ix0).astype(np.float32)).to(dev)[None, :]   # (1, W)
    img_f = image.float()
    inv_2b2 = 1.0 / (2.0 * beta * beta)
    taps = []
    wsum = None
    for iy, wy in ((iy0, 1.0 - ry), (iy1, ry)):
        iy = torch.from_numpy(iy).to(dev)
        row = img_lr.index_select(-3, iy)
        for ix, wx in ((ix0, 1.0 - rx), (ix1, rx)):
            ix = torch.from_numpy(ix).to(dev)
            Cn = row.index_select(-2, ix)                     # (..., H, W, 3)
            d2 = _sum_last((img_f - Cn) ** 2)
            # the small floor keeps a plain-bilinear fallback where no
            # neighbour matches the pixel's color (thin structures)
            w = (torch.exp(-d2 * inv_2b2) + 1e-3) * (wy * wx)
            taps.append((iy, ix, w))
            wsum = w if wsum is None else wsum + w
    inv_wsum = 1.0 / torch.clamp(wsum, min=1e-20)
    return [(iy, ix, w * inv_wsum) for iy, ix, w in taps]


def _jbu_apply(M_lr: torch.Tensor, plan) -> torch.Tensor:
    """A `_jbu_plan` applied to low-res messages (..., hl, wl, C): the 4
    neighbours' messages blended with the normalized weights."""
    acc = None
    for iy, ix, w in plan:
        term = M_lr.index_select(-3, iy).index_select(-2, ix) * w[..., None]
        acc = term if acc is None else acc + term
    return acc


# ------------------------------------------------------------- bilateral grid

_CORNERS = [((c >> 2) & 1, (c >> 1) & 1, c & 1) for c in range(8)]


def _grid_corners(coords: torch.Tensor, dims, strides):
    """For (n, 5) grid coordinates: the 8 color-corner cells (8, n) of each
    point (spatial position rounded to its nearest cell, color trilinear)
    and their trilinear weights (8, n)."""
    sp = torch.round(coords[:, :2]).to(torch.int64)
    sp = torch.minimum(sp.clamp(min=0), dims[None, :2] - 1)
    sp_flat = torch.sum(sp * strides[None, :2], dim=1)
    lo = torch.floor(coords[:, 2:])
    frac = coords[:, 2:] - lo
    lo = lo.to(torch.int64)
    idx, wts = [], []
    for o in _CORNERS:
        off = torch.tensor(o, dtype=torch.int64, device=coords.device)
        c = torch.minimum((lo + off[None, :]).clamp(min=0), dims[None, 2:] - 1)
        idx.append(sp_flat + torch.sum(c * strides[None, 2:], dim=1))
        w = [frac[:, j] if o[j] else 1.0 - frac[:, j] for j in range(3)]
        wts.append(w[0] * w[1] * w[2])
    return torch.stack(idx), torch.stack(wts)


class _GridPlan:
    """The image-only part of one image's bilateral-grid filter: splat cells
    and weights, the fixed-order splat reduction (stable sort by cell, the
    steps of a segmented doubling scan, each cell's last update) and the
    slice's cells and weights."""

    def __init__(self, image: torch.Tensor, coords: torch.Tensor, alpha: float,
                 beta: float, s: int):
        H, W = image.shape[:2]
        dev = image.device
        gy, gx, gc = _bilateral_grid_shape(H, W, alpha, beta)
        self.grid_shape = (gy, gx, gc, gc, gc)
        self.G = gy * gx * gc * gc * gc
        dims = torch.tensor(self.grid_shape, dtype=torch.int64, device=dev)
        strides = torch.tensor([gx * gc ** 3, gc ** 3, gc * gc, gc, 1],
                               dtype=torch.int64, device=dev)
        self.n = coords.shape[0]
        self.s = s
        cells, self.splat_w = _grid_corners(coords, dims, strides)    # (8, n)
        flat = cells.reshape(-1)
        keys, self.order = torch.sort(flat, stable=True)
        last = torch.ones_like(keys, dtype=torch.bool)
        last[:-1] = keys[1:] != keys[:-1]
        self.cells, self.last = keys[last], last
        run = int(torch.unique_consecutive(keys, return_counts=True)[1].max())
        self.steps = []
        d = 1
        while d < run:
            self.steps.append((d, (keys[d:] == keys[:-d])[:, None]))
            d *= 2
        slice_coords = (_grid_coords(image, alpha, beta).reshape(-1, 5) if s == 1
                        else coords)
        self.slice_idx, self.slice_w = _grid_corners(slice_coords, dims, strides)

    def splat(self, vals_lr: torch.Tensor) -> torch.Tensor:
        """(n, Ch) low-res values -> the (G, Ch) grid: each update is a
        corner weight x value x s^2, and each cell the sum of its updates,
        in an order fixed by the image alone."""
        Ch = vals_lr.shape[-1]
        upd = (vals_lr.reshape(1, self.n, Ch) * self.splat_w[..., None]
               * float(self.s * self.s)).reshape(8 * self.n, Ch)[self.order]
        for d, same in self.steps:   # inclusive scan within runs of one cell
            upd = torch.cat([upd[:d], upd[d:] + torch.where(same, upd[:-d], 0.0)])
        grid = torch.zeros((self.G, Ch), dtype=torch.float32, device=upd.device)
        grid[self.cells] = upd[self.last]
        return grid

    def blur_and_slice(self, grid: torch.Tensor) -> torch.Tensor:
        """Separable [1, 2, 1] blur along the 5 grid dims, then the slice at
        the plan's points: (n_slice, Ch)."""
        Ch = grid.shape[-1]
        g5 = grid.reshape(*self.grid_shape, Ch)
        for axis in range(5):
            g5 = _conv_axis(g5, (1.0, 2.0, 1.0), axis)
        grid = g5.reshape(self.G, Ch)
        out = None
        for corner in range(8):
            term = grid[self.slice_idx[corner]] * self.slice_w[corner][:, None]
            out = term if out is None else out + term
        return out


def bilateral_filter(values: torch.Tensor, image: torch.Tensor,
                     alpha: float, beta: float):
    """Bilateral filtering of per-pixel vectors, exact-dense or 5-D grid.

    values: (H, W, C) quantities to filter (mean-field marginals Q).
    image:  (H, W, 3) guide image, values in [0, 255].
    Kernel: exp(-|dp|^2/2alpha^2 - |dI|^2/2beta^2), normalized through a
    homogeneous ones-channel.

    Returns (average (H, W, C), density (H, W, 1)): the kernel-weighted mean
    of `values` at each pixel and the kernel mass calibrated to a unit-peak
    exact kernel (the grid's raw mass divided by GRID_SELF_GAIN; the dense
    mass as it is), so `average * density` is the unnormalized message.
    Both regimes aggregate pixels at the kernel's own spatial resolution
    (box downsample by s ~ alpha/8) and joint-bilaterally upsample back; the
    dense regime multiplies by the exact (n_lr, n_lr) kernel, the grid
    regime splats, blurs and slices.
    """
    with exact_f32():
        plan = _filter_plan(image.float(), alpha, beta)
        return _filter_apply(plan, values.float())


def _filter_plan(img: torch.Tensor, alpha: float, beta: float) -> dict:
    """The image-only part of `bilateral_filter` on one (H, W, 3) f32 image."""
    s, img_lr, coords = _lowres_setup(img, alpha, beta)
    hl, wl = img_lr.shape[:2]
    plan = {"s": s, "lr": (hl, wl),
            "jbu": None if s == 1 else _jbu_plan(img_lr, img, s, beta)}
    if hl * wl <= _DENSE_MAX_POINTS:
        plan["Km"] = _dense_kernel(coords)
    else:
        plan["grid"] = _GridPlan(img, coords, alpha, beta, s)
    return plan


def _filter_apply(plan: dict, values: torch.Tensor):
    H, W, C = values.shape
    # (C + the homogeneous 1) padded to a multiple of 8, as the JAX package
    # pads it; the zero channels stay zero and are dropped
    C_pad = -(C + 1) % 8
    if C_pad:
        values = torch.cat([values, values.new_zeros((H, W, C_pad))], dim=-1)
    C_in = C + C_pad
    s, (hl, wl) = plan["s"], plan["lr"]
    n_lr = hl * wl
    vals_lr = _box_downsample(torch.cat([values, values.new_ones((H, W, 1))], dim=-1), s)
    if "Km" in plan:
        M_lr = torch.matmul(plan["Km"], vals_lr.reshape(n_lr, C_in + 1) * float(s * s))
        gain = 1.0
    else:
        grid = plan["grid"]
        M_lr = grid.blur_and_slice(grid.splat(vals_lr.reshape(n_lr, C_in + 1)))
        gain = GRID_SELF_GAIN
    if s == 1:
        filtered, density = M_lr[:, :C], M_lr[:, C_in:]
        avg = (filtered / torch.clamp(density, min=1e-20)).reshape(H, W, C)
        density = density.reshape(H, W, 1)
    else:
        M_full = _jbu_apply(M_lr.reshape(hl, wl, C_in + 1), plan["jbu"])
        filtered, density = M_full[..., :C], M_full[..., C_in:]
        avg = filtered / torch.clamp(density, min=1e-20)
    return avg, (density if gain == 1.0 else density * _recip(gain))


# ------------------------------------------------------------------ mean field

def dense_crf(image: torch.Tensor, segmap: torch.Tensor, *, num_classes: int,
              params: CRFParams = DEFAULT_CRF_PARAMS,
              gt_prob: float = 0.7) -> torch.Tensor:
    """Refine a hard segmentation with dense-CRF mean field.

    image:  (H, W, 3) or a batch (B, H, W, 3) of uint8 or float RGB in
            [0, 255].
    segmap: (H, W) or (B, H, W) int initial labels (the upsampled patch
            segmap, reference: extract/extract.py:679-690).
    Hard labels are softened to `gt_prob` for the labeled class and
    (1-gt_prob)/(C-1) elsewhere (pydensecrf's `unary_from_labels`); a label
    outside [0, num_classes) gets (1-gt_prob)/(C-1) everywhere.
    Returns int32 refined labels of segmap's shape.
    """
    labels = segmap.to(torch.int64)
    onehot = (labels[..., None] == torch.arange(num_classes, device=labels.device)
              ).to(torch.float32)
    other = (1.0 - gt_prob) / max(num_classes - 1, 1)
    probs = onehot * gt_prob + (1.0 - onehot) * other
    return dense_crf_from_probs(image, probs, params=params)


def dense_crf_from_probs(image: torch.Tensor, probs: torch.Tensor, *,
                         params: CRFParams = DEFAULT_CRF_PARAMS) -> torch.Tensor:
    """Mean-field dense CRF from soft unary probabilities (H, W, C), or a
    batch (B, H, W, C) with images (B, H, W, 3); int32 labels."""
    single = probs.ndim == 3
    if single:
        image, probs = image[None], probs[None]
    with exact_f32():
        out = _mean_field(image.float(), probs.float(), params)
    return out[0] if single else out


def _mean_field(img: torch.Tensor, probs: torch.Tensor, params: CRFParams) -> torch.Tensor:
    w1, alpha, beta, w2, gamma, it = params
    B, H, W, C = probs.shape
    unary = -torch.log(torch.clamp(probs, 1e-8, 1.0))
    Q = torch.softmax(-unary, dim=-1)

    # The image-only work is hoisted out of the loop: the exact kernel (times
    # s^2, the mass of a low-res point) and the JBU weights, or each image's
    # grid plan; an iteration is then [downsample Q -> one matmul per image
    # -> JBU blend -> spatial Gaussian -> softmax].
    s, img_lr, coords = _lowres_setup(img, alpha, beta)
    hl, wl = img_lr.shape[1:3]
    n_lr = hl * wl
    if n_lr <= _DENSE_MAX_POINTS:
        Km = _dense_kernel(coords) * float(s * s)
        jbu = None if s == 1 else _jbu_plan(img_lr, img, s, beta)

        def bilat_message(Q):
            """Unnormalized bilateral message: the kernel-weighted label
            mass (no homogeneous channel needed)."""
            Q_lr = _box_downsample(Q, s).reshape(B, n_lr, C)
            M_lr = torch.stack([torch.matmul(Km[b], Q_lr[b]) for b in range(B)])
            if s == 1:
                return M_lr.reshape(B, H, W, C)
            return _jbu_apply(M_lr.reshape(B, hl, wl, C), jbu)
    else:
        plans = [_filter_plan(img[b], alpha, beta) for b in range(B)]

        def bilat_message(Q):
            msgs = []
            for b in range(B):    # the grid regime: calibrated density
                avg, density = _filter_apply(plans[b], Q[b])
                msgs.append(avg * density)
            return torch.stack(msgs)

    for _ in range(int(it)):
        # bilateral (appearance) message, self-interaction removed
        bilat = bilat_message(Q) - Q
        # spatial (smoothness) message, exact unit-peak separable Gaussian
        gauss = gaussian_filter_2d(Q, gamma) - Q
        msg = w1 * bilat + w2 * gauss
        # Potts compatibility: the penalty of label l is sum_{m != l} msg_m
        penalty = torch.sum(msg, dim=-1, keepdim=True) - msg
        Q = torch.softmax(-unary - penalty, dim=-1)
    return torch.argmax(Q, dim=-1).to(torch.int32)
