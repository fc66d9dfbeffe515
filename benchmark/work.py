"""The yardstick's arithmetic: operations and bytes of each operation the
metrics read, from its shapes, and the card's peaks.

Operations and bytes count only what the inputs need: valid (unpadded)
tokens, as query rows and as keys, and graph nodes; a key mask is read
whole. Operations count 2 per multiply-add, bytes each input read once and
each output written once. The root `bench.py`'s ViT flop model, copied and
widened to P=8 and the training step, and `chip_smoke.py`'s bound
arithmetic (`bound`, `attention_work`, which counts Q and O at every row)
are rewritten here.
"""
from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (data sheet, dense): bf16 tensor
# cores; TF32 tensor cores, the ceiling of any f32-accurate product (split-
# TF32 and true f32 both read below it); HBM3.
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """The least time the card could take: operations over `peak` or bytes
    over HBM's rate, whichever is larger."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def attention(batch_keys: list[int], T: int, heads: int, hd: int, itemsize: int,
              products: int, tensors: int, stats: int = 0,
              masked: bool = False) -> tuple[float, float]:
    """(flops, bytes) of a flash-attention kernel over a batch whose item b
    has batch_keys[b] valid tokens among T rows, each valid token a query
    row and a key: `products` (rows x keys x hd) matrix products per head
    over the valid rows and keys; `tensors` (rows, heads, hd) tensors read
    or written at the valid rows, `stats` (heads, rows) f32 rows, and a
    bool key mask over all B x T positions when `masked`."""
    rows = sum(batch_keys)
    flops = products * 2.0 * hd * heads * sum(k * k for k in batch_keys)
    nbytes = tensors * rows * heads * hd * itemsize + stats * heads * rows * 4
    return flops, nbytes + (len(batch_keys) * T if masked else 0)


def attention_fwd(batch_keys, T, heads, hd, itemsize, lse=False, masked=False):
    """Forward: S = Q K^T and O = P V; Q, K, V and O; the row lse when kept
    for a backward."""
    return attention(batch_keys, T, heads, hd, itemsize, products=2, tensors=4,
                     stats=1 if lse else 0, masked=masked)


def attention_bwd(batch_keys, T, heads, hd, itemsize, masked=False):
    """Backward from Q, K, V, dO and the lse: S again, dP = dO V^T, dV, dK
    and dQ (5 products); Q, K, V, dO, dQ, dK and dV; lse and D =
    rowsum(dO * O) read."""
    return attention(batch_keys, T, heads, hd, itemsize, products=5, tensors=7,
                     stats=2, masked=masked)


def vit_block(t: int, D: int, mlp_ratio: float) -> float:
    """Flops of one pre-norm block over t tokens: qkv, proj and the MLP
    (2 t D (3D + D + 2 r D)) and the two attention products (4 t^2 D)."""
    return 2.0 * t * D * (4 * D + 2 * mlp_ratio * D) + 4.0 * t * t * D


def patch_embed(n_patches: int, P: int, D: int) -> float:
    return 2.0 * n_patches * P * P * 3 * D


def vit_keys(n_patches: int, cfg: dict) -> float:
    """Stage 1 of one image with n valid patches: the patch embedding,
    depth - 1 whole blocks and the last block's key projection."""
    D, t = cfg["embed_dim"], n_patches + 1
    return (patch_embed(n_patches, cfg["patch_size"], D)
            + (cfg["depth"] - 1) * vit_block(t, D, cfg["mlp_ratio"]) + 2.0 * t * D * D)


def affinity(n: int, D: int) -> float:
    """The Gram product of one image's n valid patch features."""
    return 2.0 * n * n * D


def cheb_chain(n: int, m: int, degree: int) -> tuple[float, float]:
    """(flops, bytes) of one image's filter chain: `degree` products of the
    (n, n) bf16 operator with an (n, m) block; S read once, X read and the
    result written once in f32."""
    return 2.0 * n * n * m * degree, 2.0 * n * n + 2 * 4.0 * n * m


def deeplab_head(hw: int, D: int, num_classes: int, low=48, C=256, rates=3) -> float:
    """Flops of the DeepLabV3+ head on an hw-cell grid: the low-level 1x1,
    the ASPP (a 1x1, `rates` dilated 3x3s, the pooled 1x1, the 1x1
    projection), the fusing 3x3 and the classifier."""
    return 2.0 * (hw * D * low + hw * D * C + rates * hw * 9 * D * C + D * C
                  + hw * C * C * (rates + 2) + hw * 9 * (low + C) * C + hw * C * num_classes)


def upsample_mm(g: int, out: int, num_classes: int) -> float:
    """The logits' bilinear upsample (g x g -> out x out) as two products."""
    return 2.0 * (g * out * g + out * g * out) * num_classes


def train_step(batch: int, crop: int, cfg: dict, num_classes: int, trained_blocks: int) -> float:
    """Model flops of one self-training step: the ViT forward, the head and
    the upsample, and twice the forward of what trains (the trained blocks,
    the head and the upsample) for the backward."""
    P, D, depth = cfg["patch_size"], cfg["embed_dim"], cfg["depth"]
    g = crop // P
    t = g * g + 1
    blk = vit_block(t, D, cfg["mlp_ratio"])
    head = deeplab_head(g * g, D, num_classes) + upsample_mm(g, crop, num_classes)
    fwd = patch_embed(g * g, P, D) + depth * blk + head
    return batch * (fwd + 2.0 * (trained_blocks * blk + head))
