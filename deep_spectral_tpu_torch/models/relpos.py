"""SAM's windows, decomposed relative positions and preprocessing, for the
port's SAM family (`models/vit.py`; Kirillov et al. 2023,
facebookresearch/segment-anything's `modeling/image_encoder.py` and
`utils/transforms.py`).

  * `window_partition` / `window_unpartition`: SAM's `window_partition`
    (the normed tokens padded with zeros at the bottom and right to whole
    windows, cut into windows in row-major order) and `window_unpartition`
    (the windows put back and cropped to the grid). The padded tokens stay
    in every window as queries and as keys, unmasked, as in SAM.
  * `gathered_rel_pos` and `rel_tables`: SAM's `get_rel_pos` and
    `add_decomposed_rel_pos` for a square s x s grid of queries and keys
    (a window, or the whole grid of a global block). R_h[y, y'] =
    rel_pos_h[y - y' + s - 1] and R_w likewise over columns, shared by all
    heads; `gathered_rel_pos` lays both out per token t = (y_t, x_t) as one
    (T, C, 2s) operand [R_h[y_t]; R_w[x_t]]^T, so that one batched product
    of the unscaled q (T, B x H, C) gives both tables, rel_h[q, y'] = sum_c
    q_c R_h[y_q, y', c] and rel_w[q, x'] = sum_c q_c R_w[x_q, x', c], in
    q's dtype, as (B, H, T, s) views of one (T, B, H, 2s) tensor. Kernel 1
    (`flash_attention_packed(rel_pos=...)`) adds rel_h[q, k // s] +
    rel_w[q, k % s] to each logit inside the softmax, so no (B, H, T, T)
    bias is made.
  * `sam_resized_size` and `sam_preprocess`: `ResizeLongestSide`'s target
    size (the longer side to `long_side`, int(s * scale + 0.5)) and
    `Sam.preprocess`, on the card: each uint8 image resized bilinearly
    (align_corners False, no antialias) in f32, normalized by SAM's pixel
    mean and std, and padded with zeros after normalization at the bottom
    and right to long_side x long_side. SAM resizes with PIL to uint8
    before it normalizes; the port does not round the resized values.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SAM_PIXEL_MEAN = (123.675, 116.28, 103.53)
SAM_PIXEL_STD = (58.395, 57.12, 57.375)


def window_partition(u: torch.Tensor, grid: int, window: int) -> torch.Tensor:
    """(B, grid * grid, D) row-major tokens -> (B * n * n, window * window,
    D) windows, n = ceil(grid / window), zero-padded at the bottom and right."""
    B, _, D = u.shape
    n = -(-grid // window)
    pad = n * window - grid
    x = F.pad(u.reshape(B, grid, grid, D), (0, 0, 0, pad, 0, pad))
    x = x.reshape(B, n, window, n, window, D).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * n * n, window * window, D)


def window_unpartition(h: torch.Tensor, batch: int, grid: int, window: int) -> torch.Tensor:
    """`window_partition`'s inverse: (B * n * n, window * window, D) ->
    (B, grid * grid, D), the padded tokens cropped."""
    D = h.shape[-1]
    n = -(-grid // window)
    x = h.reshape(batch, n, n, window, window, D).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(batch, n * window, n * window, D)[:, :grid, :grid]
    return x.reshape(batch, grid * grid, D)


def gathered_rel_pos(rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """(T, C, 2s) in `dtype`, T = s * s: token t's [R_h[y_t]; R_w[x_t]]^T
    from the (2s - 1, C) tables, R[y, y'] = rel_pos[y - y' + s - 1]."""
    s = (rel_pos_h.shape[0] + 1) // 2
    dev = rel_pos_h.device
    idx = torch.arange(s, device=dev)[:, None] - torch.arange(s, device=dev)[None, :] + s - 1
    y = torch.arange(s * s, device=dev) // s
    x = torch.arange(s * s, device=dev) % s
    R = torch.cat([rel_pos_h[idx][y], rel_pos_w[idx][x]], dim=1)   # (T, 2s, C)
    return R.transpose(1, 2).to(dtype).contiguous()


def rel_tables(q: torch.Tensor, R: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rel_h, rel_w), each (B, H, T, s) in q's dtype, of the unscaled q (B,
    T, H, C) and `gathered_rel_pos`'s R (T, C, 2s): one batched product
    over the tokens, (T, B x H, C) @ (T, C, 2s)."""
    B, T, H, C = q.shape
    s = R.shape[-1] // 2
    qt = q.permute(1, 0, 2, 3).reshape(T, B * H, C)
    rel = torch.bmm(qt, R).reshape(T, B, H, 2 * s).permute(1, 2, 0, 3)
    return rel[..., :s], rel[..., s:]


def sam_resized_size(h: int, w: int, long_side: int) -> tuple[int, int]:
    """`ResizeLongestSide.get_preprocess_shape`: (h', w') with the longer
    side `long_side`."""
    scale = long_side / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def sam_preprocess(images: torch.Tensor, sizes: np.ndarray, long_side: int) -> torch.Tensor:
    """(B, long_side, long_side, 3) f32 inputs of uint8 images (B, H, W, 3)
    whose image b fills its top-left sizes[b] = (h, w) (host ints; (0, 0)
    for a batch's padding row, left zero): resized to `sam_resized_size`,
    normalized, zero-padded (see the module docstring)."""
    B = images.shape[0]
    out = torch.zeros((B, long_side, long_side, 3), dtype=torch.float32, device=images.device)
    mean = torch.tensor(SAM_PIXEL_MEAN, device=images.device)
    std = torch.tensor(SAM_PIXEL_STD, device=images.device)
    for b, (h, w) in enumerate(np.asarray(sizes).reshape(-1, 2).tolist()):
        if h * w == 0:
            continue
        hr, wr = sam_resized_size(h, w, long_side)
        x = images[b, :h, :w].permute(2, 0, 1)[None].float()
        x = F.interpolate(x, size=(hr, wr), mode="bilinear", align_corners=False)
        out[b, :hr, :wr] = (x[0].permute(1, 2, 0) - mean) / std
    return out
