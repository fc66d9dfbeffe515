#!/usr/bin/env python3
"""Correctness smoke of the PyTorch/CUDA port (`deep_spectral_tpu_torch`) on one GPU.

    python3 chip_smoke.py

It times nothing: the benchmark (`python -m benchmark.run`, with `--trace 1`
for the device timeline) is the port's timing harness. Phases, each of
which must pass:
  1. print the card's name and power limit; build the CUDA kernels from
     `deep_spectral_tpu_torch/csrc/` (nvcc) and read the ptxas log: the
     wgmma kernels and the filter's two must not spill registers; count the
     tensor-core instructions in the SASS (`cuobjdump -sass` on the built
     library) of the nine wgmma kernels: HGMMA in the packed flash
     forward (hd 64 and 128), its hd-80 build with the rel-pos bias, its
     lse-writing build, the bf16 dKV and dQ kernels, and TF32
     HGMMA or HMMA in the split-TF32 f32 builds of kernel 3
     (`flash_fwd_f32.cu`), kernel 4 (`flash_bwd_dkv_f32.cu`) and kernel 5
     (`flash_bwd_dq_f32.cu`), each count > 0; and the TMA loads (UTMALDG)
     and HMMA of the filter's two kernels, each > 0;
  2. flash-attention kernel vs its plain twin: at the main path's shape (b24,
     T=901, H=6, hd=64, q/k/v read from the fused qkv layout), at T=3601, at
     phase 9's dino_vits8 512x512 shape (b4, T=4097), at the train path's
     frozen-block shape (b144, T=197) and b4 T=197, at phase 13's PP
     microbatch (b2, T=901), and at phase 10's stage-1 buckets (b4, T=1025
     and 769), with a ragged mask and one all-masked batch row; at phase
     11's stage-6 buckets (b16, T=65, 257 and 1025) with crop masks (mostly
     masked: a 5x30-patch crop keeps 151 of 1025 keys; 3 padding rows with
     the CLS key alone), held on the valid rows and on every CLS row; and
     the fp32 no-grad route (the f32 build of the residual-saving forward,
     split-TF32 wgmma) at b24 T=901 (ragged) and at phase 10's localization
     forwards (b1, T=901 and 601, no mask);
  3. Chebyshev-filter kernel vs its plain twin: b24 N=900 m=8 at degree 10
     with per-image (c, e) and at degree 3 with (2, 1), b2 N=3600, phase 9's
     b4 N=3600 first filter (degree 3) and K=20 block (b24 N=900 m=23),
     phase 10's stage-2 buckets (b4, N=1024 and 640), a late outer's b1
     N=900, and b4 at the first N past the resident build's limit; the build
     its plan picks must be the resident one (one thread-block cluster an
     image) at N=900, 640 and 1024, the plan's shared memory (the Python
     model, `resident_smem` / `stream_smem`) must equal the kernel's layout
     (`dss_cheb_layout_bytes`), and on an H100 the card's count of
     clusters at once by size must equal H100_CLUSTERS_AT_ONCE; the mma.sync
     build (`chebyshev_filter_mma`, one launch a step) and the JAX package's
     XLA chain (`ops.eigen.chebyshev_filter_chain`, the 'xla' filter) are
     held to the twin at every shape too (3c, last: one launch a chain at
     each shape, torch.profiler);
  4. the main path: a seeded random-weight dino_vits16 at 480x480, b24, bf16:
     `extract_patch_keys`, then `spectral_decompose_batched(K=5)` on
     structured features (base + 0.02 * k, rejection-sampled so that every
     graph converges), 5 steps after stage 1's CUDA graph is captured;
     kernel 1 must run 5 x 11 times in the device trace of those steps
     (torch.profiler; stage 1 replays its graph), as its wrapper counts, the
     launch counts of kernel 2 and of the solver's Jacobi eigh
     (`csrc/small_eigh.cu`, counted at each CUDA graph replay that launches
     it) must be > 0, every residual <=
     CHEB_RESIDUAL_TOL, and the eigenpairs must agree with dense eigh; then
     (4b) that solve through each filter request, 'auto' (the kernel), 'xla'
     (the XLA chain) and f32 matvecs (through `_laplacian_eigs_batched` on
     the same affinity), each held to the same dense-eigh gates, the kernel
     launching under 'auto' alone; (4c) the Jacobi eigh on the matrices the
     solves of the first eight images hand it at K=5 (m=8) and K=20 (m=23),
     against f64 eigh on the card (within 8 f32 eps x ||A||_2); (4d) the
     DINOv3 path at dinov3_vit7b16's widths (32 heads of 128) and the COCO
     cell's shapes: kernel 1's hd=128 build vs its twin on a b24 fused qkv
     at T=885, 1205 and 1605, unmasked and with masked tails and an
     all-masked row (FLASH_TOL; the all-masked row exactly 0); the RoPE
     kernel (`apply_rope_`) vs its twin on b24 batches of each stage-1
     bucket's grids, compacted and bucket-padded, in bf16 (ROPE_BF16_REL)
     and f32 (ROPE_F32_REL), the prefix rows, v and the rows outside each
     grid keeping their bits; then `extract_patch_keys` on the model's
     first DINOV3_DEPTH blocks (LayerScales at 1) over a b24 batch of 30x40
     and 26x40 images in the 32x40 bucket, each image handed its grid: the
     blocks run compacted, kernel 1 and the RoPE kernel each launch once a
     block before the last, the padded keys are 0, and each image's keys
     agree with those of its grid's images run in a bucket of their own
     size (DINOV3_KEYS_REL); (4e) the SAM path at sam_vit_h's widths (16
     heads of 80): kernel 1's hd-80 build with the decomposed rel-pos bias
     vs its twin at a b24 batch's two calls, 600 windows of 14x14 and the
     64x64 grid (HD80_TOL, scaled with |twin| above 2; the bias moves the
     twin by more than 0.1), the tables from `models/relpos.py`; then
     `extract_patch_keys` on SAM_DEPTH blocks of sam_vit_h (window blocks
     and global blocks, the last global) over a b24 batch preprocessed on
     the card, kernel 1 launching exactly once a block before the last,
     and the keys of two images against the same blocks in f32 on the
     'einsum' route (SAM_KEYS_REL);
  5. stages 1-2 through `python -m deep_spectral_tpu_torch.pipeline` on six
     synthetic images (480x480 and 320x480) in a temporary directory, with the
     `.pth` schema checked;
  6. the trainable flash kernels (forward with lse, dKV, dQ) vs their twins:
     the train shape (b144, T=197, H=6, fused-qkv views) in bf16 and f32, b4
     T=901 with a ragged mask and an all-masked row in bf16 and f32, and b2
     T=3601 f32; in bf16 also the dKV and dQ kernels' hi/lo precision
     (`hi_lo_reading`: the share of dk and dv entries on valid keys, and of
     dq entries in batch rows with a valid key, not bit-equal to the twin, at
     most DKV_SHARE_MAX and DQ_SHARE_MAX);
  7. the train path: a seeded random-weight DeepLabV3+ over dino_vits16
     (bf16 backbone, flash attention, 21 classes) at crop 224, b144, one
     unfrozen block, lr 5e-3, on synthetic blob images: (a) one step through
     kernels 3-5, with kernel 3's o and lse in the trained block held against
     its twin on the q/k/v the step gave it (o tol 1e-2 scaled by max |o| / 2
     above 2, lse tol 1e-4), and its trained-param gradients against the
     same step with the backward kernels 4-5 twinned (tol 2e-2); (b) 10
     steps on one batch, loss finite and falling, kernels 3-5 launched every
     step and the packed kernel in the frozen blocks; (c) the whole backbone
     unfrozen: 3 steps, every block launching kernels 3-5; (d) the fp32
     recipe (`semantic_train`'s default precision, `build_model`'s 'auto'
     attention), each route one step from the same state under
     deterministic algorithms: kernel 3's o and lse at its 12 launches held
     against its twin (F32_TOL), the gradients against the step with
     kernels 4-5 twinned behind kernel 3's own o and lse (F32_GRAD_REL);
     then 10 steps through the f32 kernels (kernel 3 12 times a step,
     kernels 4-5 once) and through einsum attention (no kernel), loss
     finite and falling in both;
  8. `python -m deep_spectral_tpu_torch.tasks.cli semantic_train` (the yaml's
     defaults: fp32 through the f32 flash kernels, `build_model`'s 'auto'
     attention on the card) on a synthetic VOC tree: 4 steps with evals at 2
     and 4, a checkpoint, and a resume that runs only the remaining steps;
  9. stage 2's other routes: (a) LOBPCG, a seeded random-weight dino_vits8
     at 512x512 (T=4097, N=4096), b4, bf16, then `spectral_decompose_batched`
     (K=5) on base + 0.02 k through 'auto', which must reach LOBPCG, its
     results finite and, on 2 images, within the dense-eigh gates; (b) the
     color-fused graph, phase 4's model's features upsampled to a 60x60 grid
     (`image_downsample_factor` 8, N=3600) plus lambda times `knn_affinity`
     of blob images: the filter kernel against its twin on its whitened
     operator, and the solve through the filter kernel within the same gates;
 10. localization on a synthetic VOC tree (480x480 and 320x480 blob images,
     the blob as the GT box), in this process: stages 1-2
     (`extract_features`, `extract_eigs` with the color-fused graph), then
     `tasks.cli.main(["localization", ...])` with --eigenseg from those eigs
     (CorLoc at least CORLOC_FLOOR) and --lost and --dino_seg on the fly
     (the CLI's f32 ViT: kernel 3's f32 build); each run with the launch
     counts zeroed before it and checked after it (stage 1: the packed kernel
     per block and batch; stage 2: filter chains; LOST and dino_seg: the f32
     forward per block and image, each launch the f32 build's by its own
     count), every kernel shape among those phases 2-3
     hold, each results.txt counting every image; then stages 1-2 again with
     no batch in flight (DSS_TPU_INFLIGHT=0), which must write the same bytes;
 11. stages 1-8 and both evaluations on a synthetic VOC tree (SEG_IMAGES blob
     images, 480x480 and 320x480, GT class maps and saliency masks), in
     this process, at the stages' defaults but stage 1's b4 and stage 2's
     K=5 b4 (phase 10's held shapes): seeded random-weight dino_vits16 in
     bf16; `tasks.cli.main` runs semantic_eval (Hungarian, 21 clusters) on
     stage 8's segmaps and object_segmentation on stage 4's masks. Each run
     with the launch counts zeroed before and checked after (stage 6: kernel
     1 once per block and batch), every kernel shape among those phases 2-3
     hold, every output with the JAX schema, mIoU and IoU finite (random
     weights: a smoke of the path); stages 3 and 6 again with no batch in
     flight must write the same bytes;
 12. the rest of the single-host system, in this process, on phase 11's tree:
     (a) `pipeline.run_all` on the card (dino_vits16 bf16, stage 1 b4, stage
     2 K=5 b4) through both CRF passes, its launches (kernel 1 per block and
     batch in stages 1 and 6, kernel 2 in stage 2) at shapes phases 2-3 hold,
     every output with the JAX schema, stage 9 again with no batch in flight
     writing the same bytes; (b) the CRF on the card against the CPU: stage
     9's batches at the default parameters (label agreement >=
     CRF_AGREEMENT_MIN per image), `bilateral_filter` in both regimes
     (CRF_FILTER_REL), the grid regime twice on the card with the same
     bytes, and the verification recipe's blob probe (IoU > BLOB_IOU_MIN);
     (c) stage 10 (where matplotlib is installed) and `vis_server` in a
     thread; (d) `semantic_train` (bf16, 2 steps, crop 224 b8) on (a)'s CRF
     segmaps and `semantic_generate` from its checkpoint through
     `tasks.cli.main`, kernel 1 launching in the dump's eval forward; (e)
     DeepLabResNet-50 (output stride 8): its f32 forward on the card against
     the CPU (RESNET_REL), 3 train steps at b16 with a finite loss, and
     semantic_generate's per-image path; (f) one 7b and one 7c step with
     remat=True and without, from the same state, under
     torch.use_deterministic_algorithms: gradients and loss bit-equal,
     kernel 3 twice per trained block.
 13. the parallel paths (`deep_spectral_tpu_torch.parallel`) at world 1 in one
     NCCL group (the host has one card; NCCL takes one rank per card; an
     all_reduce, all_gather and broadcast on the card first), each output
     held against the single-card path on the same input by max |diff|
     (F32_TOL in fp32, FLASH_TOL scaled by the magnitude in bf16): (a)
     SP-ViT, dino_vits8 at 736x736 (T=8465) b1 with flash ring hops,
     `sp_vit_forward` then `sp_patch_features` (kernel 3 at T=8465, 12 + 11
     launches), in bf16 and fp32 (kernel 3's f32 build), x_norm, cls, block
     0's q/k/v and the keys; (b) the ring's multi-hop merge in this process:
     block 0's bf16 q/k/v in HOPS shards of HOP_T tokens (the 4th ending in
     3 padding rows, the 5th all padding), each query shard against every
     K/V shard in its ring order through kernel 3 (25 launches at b1
     T=2117), merged by `merge_hops`, held against kernel 1 on the whole
     sequence and the same merge over the twin; (c) PP at S=1, dino_vits16
     480x480 b8 bf16 in 4 microbatches (kernel 1 at b2 T=901, 48 launches);
     (d) DP and TP patch features (kernel 1) and the DP spectral decompose
     (kernel 2, bit-equal) at phase 4's b24 shape, and the row-sharded
     LOBPCG at N=4096 against dense eigh; (e) one data-parallel 7b step
     (kernels 3-5) against the plain step from the same state under
     deterministic algorithms (GRAD_REL_TOL). Kernel 3 at each ring-hop
     shape (T=8465 bf16 and f32, b1 T=2117) is held against its twin (o
     and lse).
`python3 chip_smoke.py 12` (or 13) runs the build and that phase alone, with
no result line. `python3 chip_smoke.py 13 --world N` runs phase 13 at world
N, one process a card (a host with N cards): (a) with the ranks' rows
gathered, (b) as `ring_attention` over N ranks at T=8465 (random q/k/v,
the K/V shards rotating by P2P) against kernel 1, (c) over N stages, (d)
DP over N ranks and TP x DP on an (N / 2, 2) mesh, (e) b144 over N ranks
(loss within 1e-3, every rank's state the same bits), bf16 outputs by the
least per-token cosine (PAR_COS_MIN); and (f) `train()` data-parallel over
N ranks for LOOP_STEPS steps of the 7b configuration on a JPEG tree
(finite losses, every rank's state the same bits, kernels 3-5 once a
step).
`python3 chip_smoke.py 4d` runs the build and phase 4d (`4e`: phase 4e),
with no result line. `python3 chip_smoke.py 3c` runs phase 3's one-launch check alone, on the
library the full run built (the full run starts it so, last).
The last line is one JSON object: {"ok": true, "device": {...}, "kernels":
{name: {"launches": ..., "max_abs_err": ...}}}, each kernel's launches on
the main path (phase 4; 4d's DINOv3 path for kernel 1's hd=128 build,
`flash_attention_packed_hd128`, and the RoPE kernel, `apply_rope_`; 4e's
SAM path for the hd-80 bias build, `flash_attention_packed_hd80`) or the
train path (phase 7) and its largest error against its twin in phases 2,
3, 4c, 4d, 4e and 6 (kernels 3-5's f32 builds are entries of their own,
`*_f32`). It exits non-zero, without that line, if
CUDA is missing or any phase fails. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
B, IMG, K = 24, 480, 5
FLASH_TOL = 1e-2   # bf16 outputs of magnitude <~2 (ulp 2^-7 at 1-2); the kernel's
#                    online softmax rounds p to bf16 at running maxima, the twin at the row max
CHEB_TOL = 1e-3    # |T_d| <= 1 after the rescale; f32 summation order differs, and a
#                    last-bit change of T_j can flip one bf16(T_j) rounding downstream
EIG_TOL = 2e-3     # eigenvalue agreement with dense eigh, = CHEB_RESIDUAL_TOL
SUBSPACE_MIN = 0.99
F32_TOL = 1e-4     # f32 kernels vs twins: true f32 on both sides, summation order differs
GRAD_REL_TOL = 2e-2  # bf16 gradients vs twins, relative to max |twin|; the lse is
#                      f32 in both dtypes (m + log l) and is held to F32_TOL
F32_GRAD_REL = 1e-4  # 7d's fp32 step, f32 kernels vs kernels 4-5 twinned behind kernel 3's
#                      own o and lse, relative to max |twinned|: dq/dk/dv enter the
#                      gradients linearly, and the kernels keep them within ~2e-5 of the twin
DKV_SHARE_MAX = 0.03  # bf16 dk/dv entries not bit-equal to the twin (`hi_lo_reading`):
#                       0.0024-0.0028 with p and ds as hi/lo pairs, 0.416-0.424 for the
#                       single-rounding control build (-DDSS_DKV_SINGLE_ROUNDING;
#                       H100, phase 6's inputs)
DQ_SHARE_MAX = 0.03   # bf16 dq entries not bit-equal to the twin (the same reading):
#                       0.0024-0.0027 with ds as a hi/lo pair, 0.419-0.424 for the
#                       single-rounding control build (-DDSS_DQ_SINGLE_ROUNDING;
#                       H100, phase 6's inputs)
TRAIN_B, CROP, CLASSES = 144, 224, 21
LOOP_STEPS = 3  # 13f: train()'s data-parallel steps at world > 1
LOBPCG_B, LOBPCG_IMG = 4, 512   # dino_vits8: T=4097, N=4096, above CHEB_MAX_N
COLOR_LAMBDA = 1.0
# phase 10's kernel shapes: stage 1 buckets its 480x480 and 320x480 images to
# 32x32 and 24x32 patches (granularity 8) in b4 batches with a padded image,
# stage 2 to 32x32 and 20x32 (granularity 4); the localization forwards see
# one whole image, unmasked, in f32
LOC_FLASH_T = (1025, 769)   # packed kernel, b4 bf16, ragged
LOC_LSE_T = (901, 601)      # kernel 3's f32 build, b1, no mask
LOC_CHEB_N = (1024, 640)    # filter kernel, b4, m=8
# stage 6's kernel shapes: box crops in square power-of-two buckets of 8, 16
# and 32 patches a side (dino_vits16 on images up to 512 pixels), b16
STAGE6_B, STAGE6_T = 16, (65, 257, 1025)
SEG_IMAGES = 24  # phase 11's VOC tree: >= 20 boxes for stage 7's 20 clusters
CORLOC_FLOOR = 80.0  # color-fused eigenseg on phase 10's blob images; the same
#                      script logic found 8/8 blobs on the CPU at lambda 1 and 10
# phase 12's gates and sizes
CRF_AGREEMENT_MIN = 0.999  # CRF labels on the card vs the CPU, share of an image's pixels: a
#                            label flips only where two marginals tie to the last bits
CRF_FILTER_REL = 1e-4      # bilateral_filter on the card vs the CPU, relative to the largest
#                            entry: cuBLAS and MKL round the kernel's 5-term dot differently,
#                            and its sq_i + sq_j - 2 dot cancellation turns one ulp of it
#                            (at |f|^2 ~ 1e3) into ~3e-5 of the kernel
BLOB_IOU_MIN = 0.95        # the verification recipe's CRF probe
RESNET_REL = 1e-4          # DeepLabResNet f32 logits on the card vs the CPU, relative to the
#                            largest: true f32 on both sides, cuDNN's and oneDNN's summation
#                            orders through 53 convolutions
RESNET_B, GEN_B = 16, 8    # phase 12's ResNet train batch, semantic_train's batch before the
#                            prediction dump
# phase 13's shapes and gates: SP at dino_vits8 736x736 (T = 1 + 92^2 = 8465); the
# multi-hop merge over HOPS shards of HOP_T tokens (4 x 2117 - 3 = 8465: the 4th
# shard ends in 3 padding rows, the 5th is padding); PP at b8 in 4 microbatches;
# the row-sharded LOBPCG on a 64 x 64 grid (N=4096)
SP_IMG, HOPS, HOP_T = 736, 5, 2117
PP_B, PP_M, ROW_GRID = 8, 4, 64
PAR_COS_MIN = 0.9999  # world > 1: bf16 paths whose GEMMs run at other shapes than the
#                       single-card path's and whose all-reduces and hop merges add in another
#                       order: least per-token cosine (0.999910 TP x DP, 0.999914 SP measured
#                       at world 4 on four H100s; world 1 is held by max |diff| instead)
# phase 4d's shapes: the COCO cell's stage-1 buckets (h, w) at granularity 8 and
# the image grids (longer side 640, P=16) that fall in each, after CLS and 4
# storage tokens; 4d's main path runs dinov3_vit7b16's first DINOV3_DEPTH blocks
DINOV3_BUCKETS = {(32, 40): ((30, 40), (26, 40)), (40, 32): ((40, 30), (40, 26)),
                  (40, 40): ((40, 40),), (24, 40): ((22, 40),)}
DINOV3_T = (885, 1205, 1605)  # its compacted batches' tokens: 22x40, 30x40 and 40x40 + 5
DINOV3_PREFIX, DINOV3_DEPTH = 5, 4
ROPE_BF16_REL = 2.0 ** -7  # one bf16 ulp of max(|value|, 1): both round one f32 result once
ROPE_F32_REL = 1e-5  # of max(|value|, 1): torch divides by a Python number through its
#                      reciprocal, the kernel divides, so a coordinate can differ in its last bit
DINOV3_KEYS_REL = 2e-2  # 4d: an image's bf16 keys in the compacted b24 batch vs in a batch
#                         of its own grid, ||diff|| / ||alone||: the GEMMs run other shapes
#                         (0 read on an H100; 5.0e-3 on the CPU at test_dinov3_tiny, and
#                         1.5e-1 there with RoPE over the bucket's grid)
# phase 4e's shapes: kernel 1's two calls in a b24 batch of sam_vit_h (batch, grid side s;
# T = s^2): its window blocks' 600 windows of 14x14 and its global blocks' 64x64 grid; 4e's
# main path runs SAM_DEPTH blocks of sam_vit_h's widths, global attention in SAM_GLOBAL (the
# last, whose keys are taken, as the model's block 31) over b24 inputs of SAM_SIZES
SAM_CALLS = ((600, 14), (B, 64))
SAM_DEPTH, SAM_GLOBAL = 4, (1, 3)
SAM_SIZES = ((768, 1024), (1024, 768), (683, 1024), (1024, 1024))
SAM_REL_SIGMA = 0.08  # the main path's rel-pos tables, N(0, 0.08^2) as the benchmark's
#                       configuration draws them (SAM's zero init would hide the bias)
HD80_TOL = 1.6e-2  # 4e: kernel 1's hd-80 bias build vs its twin where |twin| <= 2, and in
#                    proportion above (the bias concentrates the probabilities, so outputs
#                    pass 2, where a bf16 ulp is 2^-6 and more); tests' `_hd80_tolerance`
SAM_KEYS_REL = 4e-2  # 4e: bf16 keys vs the same blocks in f32 on the 'einsum' route,
#                      ||diff|| / ||f32||: the SAM cell's keys limit against its f32 reference
# phase 6 shapes: (batch, T, dtype name, ragged mask with an all-masked row)
TRAIN_KERNEL_SHAPES = [(TRAIN_B, 197, "bfloat16", False), (4, 901, "bfloat16", True),
                       (4, 901, "float32", True), (2, 3601, "float32", True),
                       (TRAIN_B, 197, "float32", False)]


def log(msg: str) -> None:
    print(msg, flush=True)


def _counters():
    """Every kernel wrapper of the port (each counts its own launches)."""
    from deep_spectral_tpu_torch.models import flash_attention as fa
    from deep_spectral_tpu_torch.ops.cheb_filter import chebyshev_filter
    from deep_spectral_tpu_torch.ops.small_eigh import small_eigh
    return (fa.flash_attention_packed, chebyshev_filter, fa.flash_attention_lse,
            fa.flash_bwd_dkv, fa.flash_bwd_dq, small_eigh)


def _launches() -> dict:
    return {f.__name__: f.launches for f in _counters()}


def _f32_launches() -> dict:
    """The f32 builds' launches (kernels 3-5 count them apart from `launches`)."""
    return {f.__name__: f.f32_launches for f in _counters() if hasattr(f, "f32_launches")}


def _zero_launches() -> None:
    for f in _counters():
        f.launches = 0
        if hasattr(f, "f32_launches"):
            f.f32_launches = 0


def structured_features(batch: int, grid: int, D: int, rng) -> np.ndarray:
    """Image-like patch features: low-frequency spatial modes plus an object
    blob (bench.py's generator). Random-weight ViT features alone give graphs
    with no small bottom spectrum, on which no iterative solver converges."""
    N = grid * grid
    feats = np.empty((batch, N, D), np.float32)
    yy, xx = np.mgrid[:grid, :grid] / grid
    for b in range(batch):
        base = np.zeros((grid, grid, D), np.float32)
        for _ in range(6):
            fy, fx = rng.uniform(0.5, 3, 2)
            ph = rng.uniform(0, 2 * np.pi)
            base += np.sin(2 * np.pi * (fy * yy + fx * xx) + ph)[..., None] * \
                rng.standard_normal(D).astype(np.float32)
        cy, cx = rng.integers(6, grid - 6), rng.integers(6, grid - 6)
        blob = ((np.mgrid[:grid, :grid][0] - cy) ** 2 +
                (np.mgrid[:grid, :grid][1] - cx) ** 2) < grid * grid // 36
        base[blob] += 3 * rng.standard_normal(D).astype(np.float32)
        feats[b] = base.reshape(N, D)
    return feats


# The wgmma kernels by mangled-name fragment: name in the SASS and ptxas logs.
WGMMA_KERNELS = {"flash_fwd_packed_kernelILb0ELi128E": "flash_fwd_packed_kernel<false, 128>",
                 "flash_fwd_packed_kernelILb0E": "flash_fwd_packed_kernel<false>",
                 "flash_fwd_packed_kernelILb1E": "flash_fwd_packed_kernel<true>",
                 "flash_fwd_relpos_kernel": "flash_fwd_relpos_kernel",
                 "flash_bwd_dkv_wgmma_kernel": "flash_bwd_dkv_wgmma_kernel",
                 "flash_bwd_dq_wgmma_kernel": "flash_bwd_dq_wgmma_kernel",
                 "flash_fwd_f32_kernel": "flash_fwd_f32_kernel",
                 "flash_bwd_dkv_f32_kernel": "flash_bwd_dkv_f32_kernel",
                 "flash_bwd_dq_f32_kernel": "flash_bwd_dq_f32_kernel"}
# the split-TF32 kernels among them: their tensor-core instructions must be TF32
# ones (HGMMA or HMMA with TF32 operands)
TF32_KERNELS = ("flash_fwd_f32_kernel", "flash_bwd_dkv_f32_kernel", "flash_bwd_dq_f32_kernel")
# the filter's two builds (mma.sync; their operator arrives by TMA: UTMALDG)
TMA_KERNELS = {"cheb_resident_kernel": "cheb_resident_kernel",
               "cheb_stream_kernel": "cheb_stream_kernel"}


def _kernel_label(line: str) -> str:
    for fragment, label in {**WGMMA_KERNELS, **TMA_KERNELS}.items():
        if fragment in line:
            return label
    return line.split("'")[1][:60] if "'" in line else line.split(":")[-1].strip()[:60]


def phase_build():
    from deep_spectral_tpu_torch import _build
    _build.build(force=True)
    _build.load()
    log(f"[1] built {_build.last_build['path']} from "
        f"{[p.name for p in _build._sources()]}")
    func, spills = "", {}
    for line in _build.last_build["log"].splitlines():
        if "Compiling entry function" in line:
            func = _kernel_label(line)
        elif "spill" in line and (func in WGMMA_KERNELS.values() or func in TMA_KERNELS.values()):
            spills[func] = spills.get(func, 0) + sum(
                int(n) for n in re.findall(r"(\d+) bytes spill", line))
    log(f"[1] bytes of register spills by the wgmma and filter kernels (ptxas -v; none "
        f"allowed): {spills}")
    if any(spills.values()):
        raise AssertionError(f"a wgmma or filter kernel spills registers (bytes): {spills}")
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", _build.last_build["path"]],
                          capture_output=True, text=True, check=True).stdout
    hgmma, func = dict.fromkeys(WGMMA_KERNELS.values(), 0), ""
    tf32 = {name: {} for name in TF32_KERNELS}
    tma = {name: {"UTMALDG": 0, "HMMA": 0} for name in TMA_KERNELS.values()}
    for line in sass.splitlines():
        if "Function :" in line:
            func = _kernel_label(line)
        elif func in tma:
            for op in tma[func]:
                tma[func][op] += int(re.search(rf"\b{op}\b", line) is not None)
        elif func in tf32 and (m := re.search(r"\b(HGMMA|HMMA)\.\S*TF32\S*", line)):
            tf32[func][m.group(0)] = tf32[func].get(m.group(0), 0) + 1
            hgmma[func] += 1
        elif "HGMMA" in line and func in hgmma and func not in tf32:
            hgmma[func] += 1
    log(f"[1] tensor-core instructions in the SASS (cuobjdump -sass): {hgmma}; "
        f"the split-TF32 kernels' by kind: {tf32}")
    if min(hgmma.values()) == 0:
        raise AssertionError(f"a wgmma kernel has no HGMMA (TF32 kernels: no TF32 HGMMA or "
                             f"HMMA) instruction: {hgmma}")
    log(f"[1] the filter's kernels (csrc/cheb_filter_sm90.cu), TMA loads and tensor-core "
        f"products in the SASS: {tma}")
    if min(min(ops.values()) for ops in tma.values()) == 0:
        raise AssertionError(f"a filter kernel has no TMA load or no HMMA: {tma}")


def phase_flash(dev) -> float:
    """Phase 2; returns the packed kernel's largest error against its twin."""
    import torch
    from deep_spectral_tpu_torch.models.flash_attention import (
        flash_attention_lse, flash_attention_lse_plain, flash_attention_packed,
        flash_attention_packed_plain)
    g = torch.Generator().manual_seed(1)
    worst = 0.0
    for (b, T, ragged) in [(B, 901, False), (B, 901, True), (PP_B // PP_M, 901, False),
                           (4, 3601, True),
                           (LOBPCG_B, 4097, False), (TRAIN_B, 197, False), (4, 197, True),
                           *((4, t, True) for t in LOC_FLASH_T)]:
        qkv = torch.randn((b, T, 3, 6, 64), generator=g).to(dev, torch.bfloat16)
        q, k, v = qkv.unbind(2)
        mask = torch.ones((b, T), dtype=torch.bool)
        if ragged:
            mask[0, T // 2 + 7:] = False
            mask[1, :] = False
            mask[2, : T // 3] = False
        mask = mask.to(dev)
        out = flash_attention_packed(q, k, v, mask)
        torch.cuda.synchronize()
        ref = flash_attention_packed_plain(q, k, v, mask)
        err = (out.float() - ref.float()).abs()[mask].max().item()
        if ragged and out[1].abs().max().item() != 0.0:
            raise AssertionError("flash: all-masked batch row is not 0")
        if not np.isfinite(err) or err > FLASH_TOL:
            raise AssertionError(f"flash kernel disagrees with its twin: {err}")
        worst = max(worst, err)
        log(f"[2] flash b{b} T={T} H=6 hd=64 bf16 ragged={ragged}: max |kernel - twin| "
            f"on valid rows {err:.3e} (tol {FLASH_TOL})")
    for T in STAGE6_T:
        qkv = torch.randn((STAGE6_B, T, 3, 6, 64), generator=g).to(dev, torch.bfloat16)
        q, k, v = qkv.unbind(2)
        mask = crop_token_masks(math.isqrt(T - 1), g).to(dev)
        out = flash_attention_packed(q, k, v, mask)
        torch.cuda.synchronize()
        ref = flash_attention_packed_plain(q, k, v, mask)
        diff = (out.float() - ref.float()).abs()
        err, cls_err = diff[mask].max().item(), diff[:, 0].max().item()
        if not (np.isfinite(err) and np.isfinite(cls_err)) or max(err, cls_err) > FLASH_TOL:
            raise AssertionError(f"flash kernel disagrees with its twin at stage 6's "
                                 f"b{STAGE6_B} T={T}: {err}, CLS rows {cls_err}")
        worst = max(worst, err, cls_err)
        log(f"[2] flash at stage 6's bucket b{STAGE6_B} T={T} bf16, {int(mask.sum())} of "
            f"{mask.numel()} keys valid: max |kernel - twin| on valid rows {err:.3e}, on the "
            f"CLS rows {cls_err:.3e} (tol {FLASH_TOL})")
    # the fp32 no-grad route (kernel 3's f32 build, split-TF32 wgmma): a ragged
    # b24 batch, and phase 10's localization forwards
    for (b, T, masked) in [(B, 901, True), *((1, t, False) for t in LOC_LSE_T)]:
        qkv = torch.randn((b, T, 3, 6, 64), generator=g).to(dev)
        q, k, v = qkv.unbind(2)
        mask = None
        if masked:
            mask = torch.ones((b, T), dtype=torch.bool, device=dev)
            mask[0, 500:] = False
        out = flash_attention_lse(q, k, v, mask)[0]
        ref = flash_attention_lse_plain(q, k, v, mask)[0]
        err = (out - ref).abs().max().item()
        if not np.isfinite(err) or err > F32_TOL:
            raise AssertionError(f"fp32 flash route disagrees with its twin: {err}")
        log(f"[2] fp32 no-grad route (kernel 3's f32 build) b{b} T={T} masked={masked}: max "
            f"|kernel - twin| {err:.3e} (tol {F32_TOL})")
    return worst


def crop_token_masks(side: int, g):
    """(STAGE6_B, 1 + side^2) key masks as stage 6 makes them: the CLS token,
    then each crop's hp x wp patches at the top left of its side x side
    bucket (the smallest power of two >= max(hp, wp, 8)); row 0 a strip 5
    patches high and side - 2 wide (151 of 1025 keys at side 32), the last
    3 rows the padding images of a short last batch (the CLS token alone)."""
    import torch
    lo = side // 2 + 1 if side > 8 else 1
    masks = torch.zeros((STAGE6_B, side, side), dtype=torch.bool)
    for i in range(STAGE6_B - 3):
        long_ = int(torch.randint(lo, side + 1, (1,), generator=g))
        short = int(torch.randint(1, side + 1, (1,), generator=g))
        hp, wp = (long_, short) if i % 2 else (short, long_)
        if i == 0:
            hp, wp = 5, side - 2
        masks[i, :hp, :wp] = True
    return torch.cat([torch.ones((STAGE6_B, 1), dtype=torch.bool),
                      masks.reshape(STAGE6_B, -1)], 1)


def whitened_operators(b: int, N: int, dev, g):
    import torch
    from deep_spectral_tpu_torch.ops.affinity import degree_vector, feature_affinity
    W = feature_affinity(torch.randn((b, N, 64), generator=g).to(dev))
    s = torch.rsqrt(degree_vector(W))
    return (s[:, :, None] * W * s[:, None, :]).to(torch.bfloat16)


def cheb_device_kernels(fn) -> dict:
    """The filter's device kernels one call of `fn` runs, by name, with their
    counts (torch.profiler)."""
    import torch
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {m.group(0): e.count for e in prof.key_averages()
            if (m := re.search(r"cheb_\w+_kernel", e.key))}


def cheb_shapes() -> list:
    """Phase 3's (batch, N, degree, window, block m): the main path's two
    windows, then phase 9's color-fused first filter at N=3600 and its K=20
    block (m=23), stage 2's buckets in phase 10, a late outer's single image,
    and the first N past the resident build."""
    from deep_spectral_tpu_torch.ops.cheb_filter import first_streamed_n
    return [(B, 900, 10, "per-image", 8), (B, 900, 3, "(2, 1)", 8),
            (2, 3600, 10, "per-image", 8), (LOBPCG_B, 3600, 3, "(2, 1)", 8),
            (B, 900, 10, "per-image", 23), *((4, n, 10, "per-image", 8) for n in LOC_CHEB_N),
            (1, 900, 10, "per-image", 8), (4, first_streamed_n(4, 8), 10, "per-image", 8)]


def kernel_layout_smem(plan, N: int, m: int) -> int:
    """Shared bytes a CTA of the plan's build takes in the kernel's own
    layout (`res_layout` / `stream_layout`), which the plan's model
    (`resident_smem` / `stream_smem`) must equal."""
    import ctypes
    from deep_spectral_tpu_torch import _build
    out = (ctypes.c_int * 2)()
    _build.check(_build.load().dss_cheb_layout_bytes(N, m, plan.rows, plan.cluster,
                                                     plan.key_window, out),
                 "dss_cheb_layout_bytes")
    return out[0 if plan.build == "resident" else 1]


def phase_cheb(dev) -> float:
    """Phase 3; returns the kernel's largest error against its twin."""
    import torch
    from deep_spectral_tpu_torch.ops.cheb_filter import (
        CARD_SMS, H100_CLUSTERS_AT_ONCE, card_clusters_at_once, cheb_filter_plan,
        chebyshev_filter, chebyshev_filter_mma, chebyshev_filter_plain, kernel_operator)
    from deep_spectral_tpu_torch.ops.eigen import chebyshev_filter_chain
    g = torch.Generator().manual_seed(2)
    # the plan's card: its SMs and the clusters of each size it holds at
    # once, asked of the card; on an H100 SXM the CPU's record must agree
    card = card_clusters_at_once(dev)
    log(f"[3] the card holds {dict(enumerate(card[1]))} clusters of each size at once "
        f"(one CTA an SM; {card[0]} SMs)")
    if card[0] == CARD_SMS and "H100" in torch.cuda.get_device_name(dev) and \
            card[1] != H100_CLUSTERS_AT_ONCE:
        raise AssertionError(f"H100_CLUSTERS_AT_ONCE {H100_CLUSTERS_AT_ONCE} is not this "
                             f"card's answer {card[1]}")
    worst = 0.0
    for (b, N, degree, window, m) in cheb_shapes():
        S = whitened_operators(b, N, dev, g)
        Sk = kernel_operator(S)  # the solver's layout: rows padded to 16 bytes
        X = torch.randn((b, N, m), generator=g).to(dev)
        if window == "(2, 1)":
            c, e = 2.0, 1.0
        else:
            lam_cut = (torch.rand(b, generator=g) * 0.9 + 0.05).to(dev)
            c, e = (lam_cut + 2.0) / 2.0, (2.0 - lam_cut) / 2.0
        plan = cheb_filter_plan(b, N, m, *card)
        out = chebyshev_filter(Sk, X, c, e, degree)
        mma = chebyshev_filter_mma(S, X, c, e, degree)
        torch.cuda.synchronize()
        ref = chebyshev_filter_plain(S, X, c, e, degree)
        err = (out - ref).abs().max().item()
        err_mma = (mma - ref).abs().max().item()
        # the JAX package's XLA chain: degree cuBLAS products (bf16 operands,
        # f32 result) and the rescale passes, the solver's 'xla' filter
        chain_err = (chebyshev_filter_chain(S, X, c, e, degree) - ref).abs().max().item()
        if not np.isfinite(err) or err > CHEB_TOL:
            raise AssertionError(f"cheb kernel disagrees with its twin: {err}")
        if not np.isfinite(err_mma) or err_mma > CHEB_TOL:
            raise AssertionError(f"the mma.sync build disagrees with the twin: {err_mma}")
        if not np.isfinite(chain_err) or chain_err > CHEB_TOL:
            raise AssertionError(f"the XLA chain disagrees with the twin: {chain_err}")
        worst = max(worst, err)
        if N in (900, *LOC_CHEB_N) and m == 8 and plan.build != "resident":
            raise AssertionError(f"N={N} m={m} takes the {plan.build} build")
        smem = kernel_layout_smem(plan, N, m)
        if smem != plan.smem:
            raise AssertionError(f"the plan's shared memory {plan.smem} != the kernel's {smem}")
        log(f"[3] cheb b{b} N={N} m={m} degree={degree} (c, e) {window}, the plan's "
            f"{plan.build} build ({smem} B of shared memory a CTA, as the plan's model): "
            f"max |kernel - twin| {err:.3e}, mma.sync build "
            f"{err_mma:.3e}, XLA chain {chain_err:.3e} (tol {CHEB_TOL})")
    return worst


def phase_cheb_launches(dev) -> None:
    """One chain at each of phase 3's shapes under torch.profiler: exactly
    one launch of the kernel of the build its plan picks. Run by `chip_smoke.py
    3c` in a process of its own (torch.profiler slows the launches of the
    process it ran in, and a process that ran other profiler sessions
    reported no events)."""
    import torch
    from deep_spectral_tpu_torch.ops.cheb_filter import (
        card_clusters_at_once, cheb_filter_plan, chebyshev_filter, kernel_operator)
    g = torch.Generator().manual_seed(7)
    seen = []
    for b, N, degree, _, m in cheb_shapes():
        build = cheb_filter_plan(b, N, m, *card_clusters_at_once(dev)).build
        S = kernel_operator(whitened_operators(b, N, dev, g))
        X = torch.randn((b, N, m), generator=g).to(dev)
        ran = cheb_device_kernels(lambda: chebyshev_filter(S, X, 2.0, 1.0, degree))
        if ran != {f"cheb_{'resident' if build == 'resident' else 'stream'}_kernel": 1}:
            raise AssertionError(f"b{b} N={N}: one chain ran {ran}, not one {build} launch")
        seen.append((b, N, m, build))
        del S, X
    log(f"[3c] one launch a chain (torch.profiler), the plan's build, at every phase-3 "
        f"shape: {seen}")


def subspace_cos(V1, V2) -> float:
    import torch
    Q1, _ = torch.linalg.qr(V1.double().T)
    Q2, _ = torch.linalg.qr(V2.double().T)
    return torch.linalg.svdvals(Q1.T @ Q2).min().item()


def main_path_step(dev):
    """Phase 4's step (`extract_patch_keys`, then `spectral_decompose_batched`
    on base + 0.02 k) and a base whose graphs all converge; returns (step,
    base, cfg, mask, out) with out the last step's (k, feats, evals, vecs,
    residuals)."""
    import torch
    from deep_spectral_tpu_torch.models.convert import random_init_
    from deep_spectral_tpu_torch.models.vit import (
        VisionTransformer, extract_patch_keys, get_model_config)
    from deep_spectral_tpu_torch.ops.eigen import (
        CHEB_RESIDUAL_TOL, spectral_decompose_batched)

    cfg = get_model_config("dino_vits16")
    model = random_init_(VisionTransformer(cfg, torch.bfloat16), seed=0).to(dev).eval()
    grid = IMG // cfg.patch_size
    rng = np.random.default_rng(0)
    base_np = structured_features(B, grid, cfg.embed_dim, rng)
    images = torch.from_numpy(
        rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)).to(dev)
    mask = torch.ones((B, grid * grid), dtype=torch.bool, device=dev)

    def step(base):
        k = extract_patch_keys(model, images, token_mask=mask)
        feats = base + 0.02 * k.float()
        return (k, feats, *spectral_decompose_batched(feats, mask, K=K,
                                                       return_residual=True))

    base = torch.from_numpy(base_np).to(dev)
    out = step(base)
    for _ in range(10):  # rejection-sample the rare hard synthetic graph
        bad = np.flatnonzero(out[4].cpu().numpy() > CHEB_RESIDUAL_TOL)
        if bad.size == 0:
            break
        base_np[bad] = structured_features(bad.size, grid, cfg.embed_dim, rng)
        base = torch.from_numpy(base_np).to(dev)
        out = step(base)
    return step, base, cfg, mask, out


def phase_main_path(dev) -> tuple[dict, float]:
    import torch
    from deep_spectral_tpu_torch.models.flash_attention import flash_attention_packed
    from deep_spectral_tpu_torch.ops.cheb_filter import chebyshev_filter
    from deep_spectral_tpu_torch.ops.eigen import (
        CHEB_RESIDUAL_TOL, spectral_decompose_batched)
    from deep_spectral_tpu_torch.ops.small_eigh import small_eigh

    step, base, cfg, mask, out = main_path_step(dev)
    grid = IMG // cfg.patch_size
    out = step(base)  # a second call at least: stage 1's CUDA graph is captured
    _zero_launches()
    n_steps = 5
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            out = step(base)
        torch.cuda.synchronize()
    ran = sum(e.count for e in prof.key_averages() if "flash_fwd_packed_kernel" in e.key)
    launches = {"flash": ran, "cheb": chebyshev_filter.launches, "eigh": small_eigh.launches}
    k, feats, evals, vecs, res = out
    want = n_steps * (cfg.depth - 1)
    log(f"[4] main path dino_vits16 {IMG}x{IMG} b{B} bf16 K={K}: launches over "
        f"{n_steps} steps: {launches}; kernel 1 in the device trace {ran} (11 attending "
        f"blocks a step: {want}), its wrapper's count {flash_attention_packed.launches}")
    if ran != want or flash_attention_packed.launches != want:
        raise AssertionError(f"kernel 1 ran {ran} times on the card and its wrapper counted "
                             f"{flash_attention_packed.launches}, not {want}")
    if tuple(k.shape) != (B, grid * grid, cfg.embed_dim) or not torch.isfinite(k).all():
        raise AssertionError(f"bad features: {tuple(k.shape)}")
    res_max = res.max().item()
    finite = bool(torch.isfinite(evals).all() and torch.isfinite(vecs).all())
    log(f"[4] eig residuals: max {res_max:.3e} (guard {CHEB_RESIDUAL_TOL}); "
        f"eigenpairs finite: {finite}")
    if not (res_max <= CHEB_RESIDUAL_TOL and finite):
        raise AssertionError("an image needed the dense re-solve on the main path")
    ev_d, vec_d = spectral_decompose_batched(feats[:4], mask[:4], K=K, solver="eigh")
    ev_err = (evals[:4] - ev_d).abs().max().item()
    cos = min(subspace_cos(vecs[i], vec_d[i]) for i in range(len(ev_d)))
    log(f"[4] vs dense eigh ({len(ev_d)} images): max |eigenvalue diff| {ev_err:.3e} "
        f"(tol {EIG_TOL}), min subspace cosine {cos:.6f} (min {SUBSPACE_MIN})")
    if not (ev_err <= EIG_TOL and cos >= SUBSPACE_MIN):
        raise AssertionError("main-path eigenpairs disagree with dense eigh")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    filter_routes(feats, mask, ev_d, vec_d)
    return launches, phase_small_eigh(feats, mask)


def phase_small_eigh(feats, mask) -> float:
    """4c: the Jacobi kernel (`csrc/small_eigh.cu`) on the matrices the
    main path's solves hand it, recorded from eager solves (no graphs) of
    phase 4's first eight images at K=5 (m=8) and at the CLI's K=20 (m=23):
    against f64 eigh on the card, eigenvalues and ||A V - V diag(w)|| within
    8 eps ||A||_2, ||V^T V - I|| within 4 m eps (f32 eps). Returns the
    largest error in f32 eps x ||A||_2."""
    import torch
    from deep_spectral_tpu_torch.ops import eigen
    from deep_spectral_tpu_torch.ops.small_eigh import small_eigh
    seen = {}

    def record(M):
        seen.setdefault(M.shape[-1], []).append(M.clone())
        return small_eigh(M)

    saved = eigen.small_eigh, eigen._RR_GRAPH_BYTES
    eigen.small_eigh, eigen._RR_GRAPH_BYTES = record, 0
    try:
        for k in (K, 20):
            eigen.spectral_decompose_batched(feats[:8], mask[:8], K=k)
    finally:
        eigen.small_eigh, eigen._RR_GRAPH_BYTES = saved
    eps = float(np.finfo(np.float32).eps)
    worst = 0.0
    for m in sorted(seen):
        M = torch.cat(seen[m])
        w, V, bad = small_eigh(M)
        w64, V64 = torch.linalg.eigh(M.double())
        A, w, V = M.double(), w.double(), V.double()
        norm = torch.linalg.matrix_norm(A, 2)
        ev_err = ((w - w64).abs().amax(dim=1) / norm).max().item() / eps
        res = ((A @ V - V * w[:, None, :]).abs().amax(dim=(1, 2)) / norm).max().item() / eps
        eye = torch.eye(m, dtype=torch.float64, device=M.device)
        orth = (V.transpose(1, 2) @ V - eye).abs().max().item() / eps
        log(f"[4c] small_eigh m={m}: {M.shape[0]} matrices from the solves' Rayleigh-Ritz "
            f"steps, flagged {int(bad.sum())}; vs f64 eigh, in f32 eps x ||A||_2: eigenvalues "
            f"{ev_err:.2f}, residual {res:.2f} (tol 8); ||V^T V - I|| {orth:.2f} eps (tol "
            f"{4 * m})")
        if bad.any() or not (ev_err <= 8 and res <= 8 and orth <= 4 * m):
            raise AssertionError(f"small_eigh m={m} disagrees with f64 eigh")
        worst = max(worst, ev_err, res)
    if sorted(seen) != [K + 3, 23]:
        raise AssertionError(f"the solves handed the kernel orders {sorted(seen)}")
    return worst


def filter_routes(feats, mask, ev_d, vec_d) -> None:
    """Phase 4's solve on phase 4's features through each filter request:
    'auto' (the kernel) and 'xla' (the JAX package's chain of cuBLAS
    products) through stage 2's `spectral_decompose_batched`, and f32
    matvecs (the chain on the f32 operator) through `_laplacian_eigs_batched`
    on the affinity stage 2 builds, since the batched call takes no
    `matvec_precision`, as in the JAX package. Each held to the first
    images' dense eigh as phase 4 is; the kernel must launch under 'auto'
    alone."""
    import torch
    from deep_spectral_tpu_torch.ops import eigen
    from deep_spectral_tpu_torch.ops.affinity import feature_affinity
    from deep_spectral_tpu_torch.ops.cheb_filter import chebyshev_filter
    N, n = feats.shape[1], len(ev_d)

    def solver(filter_impl, precision):
        if precision == "bf16":
            return lambda **kw: eigen.spectral_decompose_batched(
                feats, mask, K=K, cheb_filter_impl=filter_impl, **kw)

        def per_graph(**kw):
            W = feature_affinity(feats, max_normalize=False, mask=mask)
            w_scale = 1.0 / torch.clamp_min(W.amax(dim=(-2, -1)), 1e-12)
            return eigen._laplacian_eigs_batched(
                W, K, mask=mask, w_scale=w_scale, w_premasked=True,
                cheb_filter_impl=filter_impl, matvec_precision=precision, **kw)
        return per_graph

    for name, filter_impl, precision in (("auto", "auto", "bf16"), ("xla", "xla", "bf16"),
                                         ("f32", "auto", "f32")):
        _zero_launches()
        evals, vecs = solver(filter_impl, precision)()
        torch.cuda.synchronize()
        cheb = chebyshev_filter.launches
        impl = eigen.resolved_cheb_impl(N, filter_impl, precision, K + 3)
        ev_err = (evals[:n] - ev_d).abs().max().item()
        cos = min(subspace_cos(vecs[i], vec_d[i]) for i in range(n))
        log(f"[4b] phase 4's solve b{len(feats)} N={N} K={K} through {name!r} (filter {impl!r}): "
            f"{cheb} kernel launches; vs dense eigh ({n} images): max |eigenvalue diff| "
            f"{ev_err:.3e} (tol {EIG_TOL}), min subspace cosine {cos:.6f} (min {SUBSPACE_MIN})")
        finite = bool(torch.isfinite(evals).all() and torch.isfinite(vecs).all())
        if not (finite and ev_err <= EIG_TOL and cos >= SUBSPACE_MIN):
            raise AssertionError(f"{name}: eigenpairs disagree with dense eigh")
        if (cheb > 0) != (name == "auto") or impl != ("pallas" if name == "auto" else "xla"):
            raise AssertionError(f"{name}: filter {impl!r}, {cheb} kernel launches")


def _rope_rows(plan, T: int):
    """(B, T) bool: the rows the plan rotates (each image's grid, after the
    prefix, its grid rows `stride` apart)."""
    import torch
    rows = torch.zeros((len(plan.host), T), dtype=torch.bool)
    for b, (gh, gw, stride) in enumerate(plan.host.tolist()):
        for i in range(gh):
            start = plan.prefix + i * stride
            rows[b, start:start + gw] = True
    return rows


def phase_dinov3_kernels(dev) -> tuple[float, float]:
    """4d's kernels against their twins; returns the largest error of kernel
    1's hd=128 build and of the RoPE kernel."""
    import torch
    from deep_spectral_tpu_torch.models.flash_attention import (
        flash_attention_packed, flash_attention_packed_plain)
    from deep_spectral_tpu_torch.models.rope import (
        RopePlan, apply_rope_, apply_rope_plain_, rope_periods)
    g = torch.Generator(device=dev).manual_seed(4)
    H = 32
    flash_err = 0.0
    for T in DINOV3_T:
        qkv = torch.randn((B, T, 3, H, 128), generator=g, device=dev).to(torch.bfloat16)
        q, k, v = qkv.unbind(2)
        for masked in (False, True):
            mask = None
            if masked:  # tails of 0, 160 and 313 keys, and an all-masked row
                keep = torch.tensor([T, T - 160, T - 313, 0] * (B // 4), device=dev)
                mask = torch.arange(T, device=dev)[None] < keep[:, None]
            out = flash_attention_packed(q, k, v, mask)
            torch.cuda.synchronize()
            err = 0.0
            for rows in torch.arange(B, device=dev).split(4):  # the twin's scores at b4
                m = None if mask is None else mask[rows]
                ref = flash_attention_packed_plain(q[rows], k[rows], v[rows], m)
                valid = slice(None) if m is None else m.any(dim=1)
                err = max(err, (out[rows][valid].float() - ref[valid].float())
                          .abs().max().item())
            if masked and out[3].abs().max().item() != 0.0:
                raise AssertionError("flash hd=128: all-masked batch row is not 0")
            if not np.isfinite(err) or err > FLASH_TOL:
                raise AssertionError(f"flash hd=128 disagrees with its twin at T={T} "
                                     f"masked={masked}: {err}")
            flash_err = max(flash_err, err)
            log(f"[4d] flash b{B} T={T} H={H} hd=128 bf16 masked={masked}: max |kernel - "
                f"twin| on valid rows {err:.3e} (tol {FLASH_TOL})")
        del qkv, q, k, v
    periods = rope_periods(128, 100.0).to(dev)
    rope_err = 0.0
    for (bh, bw), grids in DINOV3_BUCKETS.items():
        grid_b = np.array([grids[i % len(grids)] for i in range(B)])
        for compacted in (True, False):
            T = DINOV3_PREFIX + (int((grid_b[:, 0] * grid_b[:, 1]).max()) if compacted
                                 else bh * bw)
            plan = RopePlan.make(periods, grid_b, bh, bw, B, DINOV3_PREFIX, compacted)
            rows = _rope_rows(plan, T).to(dev)
            for dtype, rel in ((torch.bfloat16, ROPE_BF16_REL), (torch.float32, ROPE_F32_REL)):
                qkv = torch.randn((B, T, 3, H, 128), generator=g, device=dev).to(dtype)
                before = apply_rope_.launches
                got = apply_rope_(qkv.clone(), plan)
                torch.cuda.synchronize()
                ref = apply_rope_plain_(qkv.clone(), plan)
                diff = (got.float() - ref.float()).abs()
                worst = (diff / ref.float().abs().clamp_min(1.0)).max().item()
                kept = torch.equal(got[:, :, 2], qkv[:, :, 2]) and \
                    torch.equal(got[~rows], qkv[~rows])
                log(f"[4d] RoPE b{B} bucket {bh}x{bw} grids {list(grids)} "
                    f"{'compacted' if compacted else 'bucket-padded'} T={T} {dtype}: max "
                    f"|kernel - twin| {diff.max().item():.3e}, relative to max(|twin|, 1) "
                    f"{worst:.3e} (tol {rel:.3e}); prefix, v and other rows kept: {kept}")
                if apply_rope_.launches != before + 1 or not np.isfinite(worst) \
                        or worst > rel or not kept:
                    raise AssertionError(f"the RoPE kernel disagrees with its twin at bucket "
                                         f"{bh}x{bw} compacted={compacted} {dtype}")
                rope_err = max(rope_err, diff.max().item())
                del qkv, got, ref, diff
    return flash_err, rope_err


def phase_dinov3_main_path(dev) -> dict:
    """4d's main path (see the module docstring); returns the launches of
    kernel 1 and of the RoPE kernel over its one compacted batch."""
    import dataclasses

    import torch
    from deep_spectral_tpu_torch.models.convert import random_init_
    from deep_spectral_tpu_torch.models.flash_attention import flash_attention_packed
    from deep_spectral_tpu_torch.models.rope import apply_rope_
    from deep_spectral_tpu_torch.models.vit import (
        LayerScale, VisionTransformer, extract_patch_keys, get_model_config)
    from deep_spectral_tpu_torch.utils import profiling

    cfg = dataclasses.replace(get_model_config("dinov3_vit7b16"), depth=DINOV3_DEPTH)
    model = random_init_(VisionTransformer(cfg, torch.bfloat16), seed=0)
    with torch.no_grad():
        for m in model.modules():  # the hub's 1e-5 would leave the blocks invisible
            if isinstance(m, LayerScale):
                m.gamma.fill_(1.0)
    model = model.to(dev).eval()
    P = cfg.patch_size
    (bh, bw), grids = next(iter(DINOV3_BUCKETS.items()))
    grid_b = np.array([grids[i % len(grids)] for i in range(B)])
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.zeros((B, bh * P, bw * P, 3), device=dev)
    mask = torch.zeros((B, bh, bw), dtype=torch.bool, device=dev)
    for i, (gh, gw) in enumerate(grid_b):
        x[i, :gh * P, :gw * P] = torch.randn((gh * P, gw * P, 3), generator=g, device=dev)
        mask[i, :gh, :gw] = True
    _zero_launches()
    apply_rope_.launches = 0
    compacted = profiling.totals().get("vit.compacted", 0)
    k = extract_patch_keys(model, x, token_mask=mask.reshape(B, -1), grids=grid_b)
    torch.cuda.synchronize()
    launches = {"flash": flash_attention_packed.launches, "rope": apply_rope_.launches}
    compacted = profiling.totals().get("vit.compacted", 0) - compacted
    k = k.float().reshape(B, bh, bw, -1)
    padded_zero = bool((k[~mask] == 0).all())
    worst = 0.0
    for gh, gw in grids:
        idx = torch.from_numpy(np.flatnonzero((grid_b == (gh, gw)).all(axis=1))).to(dev)
        alone = extract_patch_keys(model, x[idx, :gh * P, :gw * P].contiguous(),
                                   grids=np.tile([gh, gw], (len(idx), 1))).float()
        got = k[idx, :gh, :gw].reshape(len(idx), gh * gw, -1)
        worst = max(worst, ((got - alone).flatten(1).norm(dim=1)
                            / alone.flatten(1).norm(dim=1)).max().item())
    log(f"[4d] main path dinov3_vit7b16 widths, {DINOV3_DEPTH} blocks, b{B} grids "
        f"{list(grids)} in the {bh}x{bw} bucket, bf16: launches {launches}, compacted "
        f"{compacted}, padded keys 0: {padded_zero}; each image vs its grid run alone: "
        f"max ||diff|| / ||alone|| {worst:.3e} (tol {DINOV3_KEYS_REL})")
    want = DINOV3_DEPTH - 1
    if launches != {"flash": want, "rope": want} or compacted != 1 or not padded_zero:
        raise AssertionError(f"the DINOv3 path did not run compacted through both kernels "
                             f"({want} launches each): {launches}, compacted {compacted}")
    if not np.isfinite(worst) or worst > DINOV3_KEYS_REL:
        raise AssertionError(f"DINOv3 keys depend on the batch: {worst}")
    return launches


def phase_sam_kernels(dev) -> float:
    """4e's kernel calls (see the module docstring); returns the largest
    error of kernel 1's hd-80 bias build against its twin."""
    import torch
    from deep_spectral_tpu_torch.models.flash_attention import (
        flash_attention_packed, flash_attention_packed_plain)
    from deep_spectral_tpu_torch.models.relpos import gathered_rel_pos, rel_tables
    g = torch.Generator(device=dev).manual_seed(6)
    H, hd = 16, 80
    worst = 0.0
    for batch, side in SAM_CALLS:
        T = side * side
        qkv = torch.randn((batch, T, 3, H, hd), generator=g, device=dev).to(torch.bfloat16)
        q, k, v = qkv.unbind(2)
        rh, rw = (0.5 * torch.randn((2 * side - 1, hd), generator=g, device=dev)
                  for _ in range(2))
        rel = rel_tables(q, gathered_rel_pos(rh, rw, q.dtype))
        before = flash_attention_packed.launches
        out = flash_attention_packed(q, k, v, rel_pos=rel)
        torch.cuda.synchronize()
        if flash_attention_packed.launches != before + 1:
            raise AssertionError("flash hd=80: the bias call did not launch kernel 1 once")
        err, seen = 0.0, 0.0
        for rows in torch.arange(batch, device=dev).split(max(1, (1 << 29) // (H * T * T))):
            sub = (q[rows], k[rows], v[rows])
            ref = flash_attention_packed_plain(*sub, rel_pos=(rel[0][rows], rel[1][rows]))
            diff = (out[rows].float() - ref.float()).abs()
            if not bool((diff <= HD80_TOL * ref.float().abs().clamp_min(2.0) / 2).all()):
                raise AssertionError(f"flash hd=80 disagrees with its twin at b{batch} "
                                     f"T={T}: max {diff.max().item()}")
            err = max(err, diff.max().item())
            if not seen:  # the bias moves the output
                seen = (flash_attention_packed_plain(*sub).float() - ref.float()).abs().max().item()
            del ref, diff
        log(f"[4e] flash b{batch} T={T} H={H} hd=80 bf16 with the rel-pos bias (s={side}): max "
            f"|kernel - twin| {err:.3e} (tol {HD80_TOL} x max(|twin|, 2) / 2); without the "
            f"bias the twin moves by {seen:.3e}")
        if not np.isfinite(err) or seen < 0.1:
            raise AssertionError(f"flash hd=80 at b{batch} T={T}: error {err}, bias {seen}")
        worst = max(worst, err)
        del qkv, q, k, v, rel, out
    return worst


def phase_sam_main_path(dev) -> int:
    """4e's main path (see the module docstring); returns kernel 1's
    launches over its b24 batch."""
    import dataclasses

    import torch
    from deep_spectral_tpu_torch.models.convert import random_init_
    from deep_spectral_tpu_torch.models.flash_attention import flash_attention_packed
    from deep_spectral_tpu_torch.models.relpos import sam_preprocess
    from deep_spectral_tpu_torch.models.vit import (
        VisionTransformer, extract_patch_keys, get_model_config)

    cfg = dataclasses.replace(get_model_config("sam_vit_h"), depth=SAM_DEPTH,
                              global_blocks=SAM_GLOBAL)
    model = random_init_(VisionTransformer(cfg, torch.bfloat16), seed=0)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for blk in model.blocks:
            for p in (blk.attn.rel_pos_h, blk.attn.rel_pos_w):
                p.copy_(SAM_REL_SIGMA * torch.randn(p.shape, generator=gen))
    state = model.state_dict()
    model = model.to(dev).eval()
    sizes = np.array([SAM_SIZES[i % len(SAM_SIZES)] for i in range(B)])
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randint(0, 256, (B, cfg.img_size, cfg.img_size, 3), generator=g,
                      dtype=torch.uint8, device=dev)
    images = sam_preprocess(x, sizes, cfg.img_size)
    _zero_launches()
    k = extract_patch_keys(model, images)
    torch.cuda.synchronize()
    launches = flash_attention_packed.launches
    del model
    f32 = VisionTransformer(cfg, torch.float32, attention_impl="einsum")
    f32.load_state_dict(state)
    f32 = f32.to(dev).eval()
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = extract_patch_keys(f32, images[:2]).float()
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    gap = ((k[:2].float() - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)).max().item()
    want = SAM_DEPTH - 1
    log(f"[4e] main path sam_vit_h widths, {SAM_DEPTH} blocks (global {list(SAM_GLOBAL)}), "
        f"b{B} inputs of {sorted(set(SAM_SIZES))} preprocessed on the card, bf16: kernel 1 "
        f"launches {launches} (want {want}); keys vs the f32 'einsum' blocks on 2 images: max "
        f"||diff|| / ||f32|| {gap:.3e} (tol {SAM_KEYS_REL})")
    if launches != want:
        raise AssertionError(f"the SAM path launched kernel 1 {launches} times, not {want}")
    if not np.isfinite(gap) or gap > SAM_KEYS_REL:
        raise AssertionError(f"SAM's bf16 keys disagree with its f32 blocks: {gap}")
    return launches


def phase_cli(tmp: Path, device: str) -> None:
    import torch
    from PIL import Image
    images = tmp / "images"
    images.mkdir()
    rng = np.random.default_rng(42)
    names = []
    for i in range(6):
        h, w = [(480, 480), (320, 480)][i % 2]
        img = (rng.random((h, w, 3)) * 100).astype(np.uint8)
        y, x = rng.integers(40, h - 120), rng.integers(40, w - 120)
        img[y:y + 100, x:x + 100] = [210, 70, 60]
        names.append(f"v{i}.jpg")
        Image.fromarray(img).save(images / names[-1], quality=95)
    (tmp / "images.txt").write_text("\n".join(names))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cli = [sys.executable, "-m", "deep_spectral_tpu_torch.pipeline"]
    for args in (["extract_features", "--images_list", str(tmp / "images.txt"),
                  "--images_root", str(images), "--output_dir", str(tmp / "features"),
                  "--model_name", "dino_vits16", "--batch_size", "4",
                  "--device", device],
                 ["extract_eigs", "--images_root", str(images), "--features_dir",
                  str(tmp / "features"), "--output_dir", str(tmp / "eigs"),
                  "--K", str(K), "--batch_size", "4", "--device", device]):
        proc = subprocess.run(cli + args, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        log(f"[5] {args[0]}: rc {proc.returncode}")
        for line in (proc.stdout + proc.stderr).strip().splitlines()[-6:]:
            log(f"    {line}")
        if proc.returncode != 0:
            raise AssertionError(f"{args[0]} failed")
    for name, (h, w) in zip(names, [(480, 480), (320, 480)] * 3):
        stem, n = Path(name).stem, (h // 16) * (w // 16)
        f = torch.load(tmp / "features" / f"{stem}.pth", weights_only=False)
        e = torch.load(tmp / "eigs" / f"{stem}.pth", weights_only=False)
        ok = (set(f) >= {"k", "indices", "file", "id", "model_name", "patch_size", "shape"}
              and f["k"].dtype == torch.float16 and tuple(f["k"].shape) == (1, n, 384)
              and tuple(f["shape"]) == (1, 3, h, w) and f["patch_size"] == 16
              and set(e) == {"eigenvalues", "eigenvectors"}
              and e["eigenvalues"].dtype == torch.float32
              and tuple(e["eigenvalues"].shape) == (K,)
              and tuple(e["eigenvectors"].shape) == (K, n)
              and bool(torch.isfinite(e["eigenvectors"]).all()))
        if not ok:
            raise AssertionError(f"{name}: unexpected .pth schema")
    log(f"[5] {len(names)} feature and eig .pth files have the expected schema")


def dense_gates(what: str, feats, mask, evals, vecs, color_W=None, n: int = 2) -> None:
    """Hold the first `n` images' eigenpairs against dense eigh of the same
    graph: eigenvalues within EIG_TOL, subspace cosine >= SUBSPACE_MIN."""
    from deep_spectral_tpu_torch.ops.eigen import spectral_decompose_batched
    ev_d, vec_d = spectral_decompose_batched(
        feats[:n], mask[:n], None if color_W is None else color_W[:n], K=K, solver="eigh",
        image_color_lambda=COLOR_LAMBDA)
    ev_err = (evals[:n] - ev_d).abs().max().item()
    cos = min(subspace_cos(vecs[i], vec_d[i]) for i in range(n))
    log(f"[9] {what} vs dense eigh ({n} images): max |eigenvalue diff| {ev_err:.3e} "
        f"(tol {EIG_TOL}), min subspace cosine {cos:.6f} (min {SUBSPACE_MIN})")
    if not (ev_err <= EIG_TOL and cos >= SUBSPACE_MIN):
        raise AssertionError(f"{what}: eigenpairs disagree with dense eigh")


def blob_images_lr(b: int, grid: int, rng) -> np.ndarray:
    """(b, grid, grid, 3) float images in [0, 1]: phase 5's 480x480 blob
    images, downsampled as stage 2 loads them (PIL bilinear)."""
    from PIL import Image
    out = np.empty((b, grid, grid, 3), np.float32)
    for i in range(b):
        img = (rng.random((IMG, IMG, 3)) * 100).astype(np.uint8)
        y, x = rng.integers(40, IMG - 120, 2)
        img[y:y + 100, x:x + 100] = [210, 70, 60]
        out[i] = np.asarray(Image.fromarray(img).resize((grid, grid), Image.BILINEAR),
                            np.float32) / 255.0
    return out


def fused_filter_gate(feats, color_W) -> None:
    """Kernel 2 against its twin on the whitened color-fused operator (degree
    10, per-image windows)."""
    import torch
    from deep_spectral_tpu_torch.ops.affinity import degree_vector, feature_affinity
    from deep_spectral_tpu_torch.ops.cheb_filter import (
        chebyshev_filter, chebyshev_filter_plain)
    b, N, _ = feats.shape
    W = feature_affinity(feats) + COLOR_LAMBDA * color_W
    s = torch.rsqrt(degree_vector(W))
    S = (s[:, :, None] * W * s[:, None, :]).to(torch.bfloat16)
    g = torch.Generator().manual_seed(3)
    X = torch.randn((b, N, 8), generator=g).to(feats.device)
    lam_cut = (torch.rand(b, generator=g) * 0.9 + 0.05).to(feats.device)
    c, e = (lam_cut + 2.0) / 2.0, (2.0 - lam_cut) / 2.0
    out = chebyshev_filter(S, X, c, e, 10)
    torch.cuda.synchronize()
    err = (out - chebyshev_filter_plain(S, X, c, e, 10)).abs().max().item()
    log(f"[9b] filter kernel on the fused operator b{b} N={N} m=8 degree 10: max |kernel - "
        f"twin| {err:.3e} (tol {CHEB_TOL})")
    if not np.isfinite(err) or err > CHEB_TOL:
        raise AssertionError(f"cheb kernel disagrees with its twin on the fused graph: {err}")


def phase_stage2_routes(dev) -> None:
    import torch
    from deep_spectral_tpu_torch.models.convert import random_init_
    from deep_spectral_tpu_torch.models.flash_attention import flash_attention_packed
    from deep_spectral_tpu_torch.models.vit import (
        VisionTransformer, extract_patch_keys, get_model_config)
    from deep_spectral_tpu_torch.ops import eigen
    from deep_spectral_tpu_torch.ops.affinity import knn_affinity
    from deep_spectral_tpu_torch.ops.cheb_filter import chebyshev_filter
    from deep_spectral_tpu_torch.ops.resize import resize_bilinear
    rng = np.random.default_rng(9)

    # (a) LOBPCG: dino_vits8 at 512x512, N=4096
    cfg = get_model_config("dino_vits8")
    model = random_init_(VisionTransformer(cfg, torch.bfloat16), seed=0).to(dev).eval()
    grid = LOBPCG_IMG // cfg.patch_size
    N = grid * grid
    if eigen._resolve_solver(N, K + 3, True, "auto") != "lobpcg":
        raise AssertionError(f"'auto' does not send N={N} to LOBPCG")
    images = torch.from_numpy(rng.standard_normal(
        (LOBPCG_B, LOBPCG_IMG, LOBPCG_IMG, 3)).astype(np.float32)).to(dev)
    mask = torch.ones((LOBPCG_B, N), dtype=torch.bool, device=dev)
    _zero_launches()
    k = extract_patch_keys(model, images, token_mask=mask)
    fwd_launches = flash_attention_packed.launches
    base = torch.from_numpy(structured_features(LOBPCG_B, grid, cfg.embed_dim, rng)).to(dev)
    feats = base + 0.02 * k.float()
    calls, orig = [], eigen._lobpcg_laplacian

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    eigen._lobpcg_laplacian = counted
    try:
        _zero_launches()
        evals, vecs = eigen.spectral_decompose_batched(feats, mask, K=K)
    finally:
        eigen._lobpcg_laplacian = orig
    log(f"[9a] dino_vits8 {LOBPCG_IMG}x{LOBPCG_IMG} b{LOBPCG_B} bf16 (T={N + 1}): forward "
        f"{fwd_launches} launches of the packed flash kernel; 'auto' K={K} solve at N={N} "
        f"through LOBPCG ({len(calls)} call), {chebyshev_filter.launches} filter launches")
    # blocks 0..10 attend; the last block's qkv projection is the feature
    if fwd_launches != cfg.depth - 1 or len(calls) != 1 or chebyshev_filter.launches:
        raise AssertionError("phase 9a did not run the packed kernel per block and LOBPCG")
    if not (torch.isfinite(evals).all() and torch.isfinite(vecs).all()):
        raise AssertionError("LOBPCG results are not finite")
    dense_gates("LOBPCG N=4096", feats, mask, evals, vecs)
    del model, images, k, base, feats, evals, vecs
    torch.cuda.empty_cache()

    # (b) the color-fused graph: phase 4's model at 480x480 (30x30 patches),
    # features upsampled to the 60x60 grid of image_downsample_factor 8
    _, base16, cfg16, _, out4 = main_path_step(dev)
    k16 = out4[0][:LOBPCG_B]
    g16, g_lr = IMG // cfg16.patch_size, IMG // 8
    N = g_lr * g_lr
    feats = (base16[:LOBPCG_B] + 0.02 * k16.float()).reshape(LOBPCG_B, g16, g16, -1)
    feats = resize_bilinear(feats, (g_lr, g_lr)).to(torch.float16).float()
    feats = feats.reshape(LOBPCG_B, N, -1)
    mask = torch.ones((LOBPCG_B, N), dtype=torch.bool, device=dev)
    imgs = torch.from_numpy(blob_images_lr(LOBPCG_B, g_lr, rng)).to(dev)
    color_W = knn_affinity(imgs, mask=mask)
    fused_filter_gate(feats, color_W)
    _zero_launches()
    ev_g, vec_g = eigen.spectral_decompose_batched(
        feats, mask, color_W, K=K, image_color_lambda=COLOR_LAMBDA)
    cheb = chebyshev_filter.launches
    log(f"[9b] color-fused graph (lambda {COLOR_LAMBDA}, knn) b{LOBPCG_B} N={N}: 'auto' K={K} "
        f"solve, {cheb} filter launches")
    if cheb <= 0:
        raise AssertionError("the color-fused solve did not run the filter kernel")
    if not (torch.isfinite(ev_g).all() and torch.isfinite(vec_g).all()):
        raise AssertionError("color-fused results are not finite")
    dense_gates("color-fused N=3600", feats, mask, ev_g, vec_g, color_W)


def make_loc_voc(root: Path) -> list:
    """Phase 10's VOC tree: phase 5's blob images, the blob as the GT box."""
    from PIL import Image
    for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (root / d).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(42)
    ids = []
    for i in range(6):
        h, w = [(480, 480), (320, 480)][i % 2]
        img = (rng.random((h, w, 3)) * 100).astype(np.uint8)
        y, x = int(rng.integers(40, h - 120)), int(rng.integers(40, w - 120))
        img[y:y + 100, x:x + 100] = [210, 70, 60]
        ids.append(f"v{i}")
        Image.fromarray(img).save(root / "JPEGImages" / f"v{i}.jpg", quality=95)
        (root / "Annotations" / f"v{i}.xml").write_text(
            f"<annotation><object><name>blob</name><truncated>0</truncated>"
            f"<difficult>0</difficult><bndbox><xmin>{x + 1}</xmin><ymin>{y + 1}</ymin>"
            f"<xmax>{x + 100}</xmax><ymax>{y + 100}</ymax></bndbox></object></annotation>")
    (root / "ImageSets" / "Main" / "trainval.txt").write_text("\n".join(ids))
    return ids


@contextlib.contextmanager
def kernel_shapes(seen: set):
    """Add (kernel, batch, T or N, dtype or block width) to `seen` for every
    kernel wrapper call that the ViT and the eigensolvers make."""
    from deep_spectral_tpu_torch.models import vit
    from deep_spectral_tpu_torch.ops import eigen
    sites = [(vit, "flash_attention_packed", lambda q, *_: (q.shape[0], q.shape[1], q.dtype)),
             (vit, "flash_attention_lse", lambda q, *_: (q.shape[0], q.shape[1], q.dtype)),
             (eigen, "chebyshev_filter", lambda S, X, *_: tuple(X.shape))]
    saved = [getattr(mod, name) for mod, name, _ in sites]
    for (mod, name, shape), fn in zip(sites, saved):
        def call(*a, _fn=fn, _name=name, _shape=shape, **kw):
            seen.add((_name, *_shape(*a)))
            return _fn(*a, **kw)
        setattr(mod, name, call)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(sites, saved):
            setattr(mod, name, fn)


def phase_localization(tmp: Path) -> None:
    """Stages 1-2 and the localization CLI in this process, each with the
    launch counts set to 0 just before it and read just after (every
    kernel-3 launch in the LOST and dino_seg runs must be the f32 build's);
    the shapes they give the kernels must be among those phases 2-3 hold.
    Stages 1-2 run again with no batch in flight and must write the same
    bytes."""
    import torch
    from deep_spectral_tpu_torch.models.vit import get_model_config
    from deep_spectral_tpu_torch.pipeline.extract import extract_eigs, extract_features
    from deep_spectral_tpu_torch.tasks import cli as task_cli
    from deep_spectral_tpu_torch.utils import native_cc
    voc = tmp / "voc"
    ids = make_loc_voc(voc)
    (tmp / "list.txt").write_text("\n".join(f"{i}.jpg" for i in ids))
    # blocks that attend before the feature (the last block's qkv) or the
    # attention map (the last block's, on the einsum route)
    blocks = get_model_config("dino_vits16").depth - 1
    batches = 2  # one b4 batch per image size
    held = ({("flash_attention_packed", 4, t, torch.bfloat16) for t in LOC_FLASH_T}
            | {("flash_attention_lse", 1, t, torch.float32) for t in LOC_LSE_T}
            | {("chebyshev_filter", 4, n, K + 3) for n in LOC_CHEB_N})

    def stages(suffix: str) -> list:
        feats, eigs = str(tmp / f"features{suffix}"), str(tmp / f"eigs{suffix}")
        return [("extract_features" + suffix, lambda: extract_features(
                    str(tmp / "list.txt"), str(voc / "JPEGImages"), "dino_vits16", 4, feats,
                    device="cuda"), {"flash_attention_packed": blocks * batches}),
                ("extract_eigs" + suffix, lambda: extract_eigs(
                    str(voc / "JPEGImages"), feats, eigs, K=K, batch_size=4,
                    image_color_lambda=COLOR_LAMBDA, device="cuda"),
                 {"chebyshev_filter": None, "small_eigh": None})]

    loc = ["localization", "--dataset_root", str(voc), "--model_name", "dino_vits16",
           "--device", "cuda"]
    runs = stages("") + [
        (method, lambda f=flags, m=method: task_cli.main(loc + f + ["--output_dir",
                                                                    str(tmp / m)]), want)
        for method, flags, want in (
            ("eigenseg", ["--eigenseg", "--precomputed_eigs_dir", str(tmp / "eigs")], {}),
            ("lost", ["--lost"], {"flash_attention_lse": blocks * len(ids)}),
            ("dino_seg", ["--dino_seg"], {"flash_attention_lse": blocks * len(ids)}))]
    seen = set()

    def drive(name, run, want):
        """`want`: each kernel's launches, None for at least one; others 0."""
        _zero_launches()
        with kernel_shapes(seen):
            run()
        torch.cuda.synchronize()
        launches, f32_builds = _launches(), _f32_launches()
        log(f"[10] {name}: launches {launches}; of them by the f32 builds {f32_builds}")
        off = {n: c for n, c in launches.items()
               if not (c > 0 if want.get(n, 0) is None else c == want.get(n, 0))}
        if name in ("lost", "dino_seg") and \
                f32_builds["flash_attention_lse"] != launches["flash_attention_lse"]:
            off["flash_attention_lse (f32 build)"] = f32_builds["flash_attention_lse"]
        if off:
            raise AssertionError(f"{name}: launches {off}, expected {want} and no others")

    os.environ.pop("DSS_TPU_INFLIGHT", None)  # the default: one batch in flight
    scores = {}
    for name, run, want in runs:
        drive(name, run, want)
        if name in ("eigenseg", "lost", "dino_seg"):
            _, score, count = (tmp / name / "results.txt").read_text().strip().split(",")
            if int(count) != len(ids):
                raise AssertionError(f"{name}: results.txt counts {count} of {len(ids)} images")
            scores[name] = float(score)
    os.environ["DSS_TPU_INFLIGHT"] = "0"
    try:
        for run in stages("0"):
            drive(*run)
    finally:
        del os.environ["DSS_TPU_INFLIGHT"]
    log(f"[10] kernel shapes of the phase: {sorted(map(str, seen))}")
    if not seen <= held:
        raise AssertionError(f"shapes phases 2-3 do not hold: {seen - held}")
    for kind in ("features", "eigs"):
        files = sorted((tmp / kind).iterdir())
        differ = [f.name for f in files if f.read_bytes() != (tmp / f"{kind}0" / f.name)
                  .read_bytes()]
        if len(files) != len(ids) or differ:
            raise AssertionError(f"{kind}: {len(files)} files, {differ} differ with no batch "
                                 f"in flight")
    log(f"[10] stages 1-2 with no batch in flight (DSS_TPU_INFLIGHT=0) wrote the same bytes "
        f"({len(ids)} feature and {len(ids)} eig files)")
    log(f"[10] CorLoc over {len(ids)} blob images (random-weight dino_vits16, f32 on-the-fly "
        f"forwards): {scores}; connected components: {native_cc.backend()}")
    if scores["eigenseg"] < CORLOC_FLOOR:
        raise AssertionError(f"color-fused eigenseg CorLoc {scores['eigenseg']} is below "
                             f"{CORLOC_FLOOR}")


def make_seg_voc(root: Path) -> list:
    """Phase 11's trees: SEG_IMAGES VOC-layout blob images (480x480 and
    320x480; two blobs of VOC classes; GT SegmentationClass, a third of the
    images in val) and, beside them, the first blob as a 0/255 saliency mask
    for the object-segmentation task."""
    from PIL import Image
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation", "saliency"):
        (root / d).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(11)
    ids = []
    for i in range(SEG_IMAGES):
        h, w = [(480, 480), (320, 480)][i % 2]
        img = (rng.random((h, w, 3)) * 100).astype(np.uint8)
        gt = np.zeros((h, w), np.uint8)
        for j, size in enumerate((120, 80)):
            y, x = int(rng.integers(0, h - size)), int(rng.integers(0, w - size))
            c = int(rng.integers(1, 21))
            img[y:y + size, x:x + size] = [40 + 10 * c, 200 - 8 * c, 60 + 90 * j]
            gt[y:y + size, x:x + size] = c
            if j == 0:
                sal = np.zeros((h, w), np.uint8)
                sal[y:y + size, x:x + size] = 255
        ids.append(f"s{i:02d}")
        Image.fromarray(img).save(root / "JPEGImages" / f"{ids[-1]}.jpg", quality=95)
        Image.fromarray(gt).save(root / "SegmentationClass" / f"{ids[-1]}.png")
        Image.fromarray(sal).save(root / "saliency" / f"{ids[-1]}.png")
    (root / "ImageSets" / "Segmentation" / "val.txt").write_text("\n".join(ids[::3]))
    return ids


def stage6_batches(bbox_file: Path, patch: int = 16) -> dict:
    """{side: batches} of stage 6's square buckets for a bbox file, as the
    stage groups its crops (b STAGE6_B)."""
    import torch
    from deep_spectral_tpu_torch.utils.bucketing import square_pow2_bucket
    sides: dict = {}
    for bd in torch.load(bbox_file, weights_only=False):
        for xmin, ymin, xmax, ymax in bd["bboxes_original_resolution"]:
            side = square_pow2_bucket(max((ymax - ymin) // patch, 1),
                                      max((xmax - xmin) // patch, 1)).h
            sides[side] = sides.get(side, 0) + 1
    return {side: -(-n // STAGE6_B) for side, n in sides.items()}


def _cli_output(argv: list) -> str:
    """Run the port's task CLI in this process; its standard output."""
    from deep_spectral_tpu_torch.tasks import cli as task_cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = task_cli.main(argv)
    out = buf.getvalue()
    for line in out.strip().splitlines()[-4:]:
        log(f"    {line}")
    if rc != 0:
        raise AssertionError(f"{argv[0]}: rc {rc}")
    return out


def phase_segments(tmp: Path) -> None:
    """Stages 1-8 and both evaluations in this process on phase 11's tree
    (dino_vits16, seeded random weights, bf16), each run with the launch
    counts set to 0 just before it and read just after; stage 6 must launch
    kernel 1 once per block and batch, at shapes phase 2 holds; every output
    must have the JAX schema; stages 3 and 6 rerun with no batch in flight
    must write the same bytes."""
    import torch
    from deep_spectral_tpu_torch.models.vit import get_model_config
    from deep_spectral_tpu_torch.pipeline import extract as S
    voc = tmp / "voc"
    ids = make_seg_voc(voc)
    jpegs = str(voc / "JPEGImages")
    (tmp / "list.txt").write_text("\n".join(f"{i}.jpg" for i in ids))
    out = {k: str(tmp / k) for k in ("features", "eigs", "multi", "single", "semantic",
                                     "multi0")}
    boxes, feats6, clusters = (str(tmp / f) for f in ("bboxes.pth", "bbox_features.pth",
                                                      "bbox_clusters.pth"))
    feats6_0 = str(tmp / "inflight0" / "bbox_features.pth")  # same name: same bytes
    blocks = get_model_config("dino_vits16").depth
    held = ({("flash_attention_packed", 4, t, torch.bfloat16) for t in LOC_FLASH_T}
            | {("flash_attention_packed", STAGE6_B, t, torch.bfloat16) for t in STAGE6_T}
            | {("chebyshev_filter", 4, n, K + 3) for n in LOC_CHEB_N})
    seen = set()

    def stage6_want():
        return {"flash_attention_packed": blocks * sum(stage6_batches(Path(boxes)).values())}

    def drive(name, run, want):
        """`want`: each kernel's launches, None for at least one; others 0."""
        _zero_launches()
        with kernel_shapes(seen):
            result = run()
        torch.cuda.synchronize()
        launches = _launches()
        want = want() if callable(want) else want
        log(f"[11] {name}: launches {launches}")
        off = {n: c for n, c in launches.items()
               if not (c > 0 if want.get(n, 0) is None else c == want.get(n, 0))}
        if off:
            raise AssertionError(f"{name}: launches {off}, expected {want} and no others")
        return result

    os.environ.pop("DSS_TPU_INFLIGHT", None)  # the default: one batch in flight
    stage_runs = [
        ("1 extract_features", lambda: S.extract_features(
            str(tmp / "list.txt"), jpegs, "dino_vits16", 4, out["features"], device="cuda"),
         {"flash_attention_packed": (blocks - 1) * 6}),  # 3 b4 batches per image size
        ("2 extract_eigs", lambda: S.extract_eigs(
            jpegs, out["features"], out["eigs"], K=K, batch_size=4, device="cuda"),
         {"chebyshev_filter": None, "small_eigh": None}),
        ("3 extract_multi_region_segmentations", lambda: S.extract_multi_region_segmentations(
            out["features"], out["eigs"], out["multi"], device="cuda"), {}),
        ("4 extract_single_region_segmentations",
         lambda: S.extract_single_region_segmentations(out["features"], out["eigs"],
                                                       out["single"]), {}),
        ("5 extract_bboxes", lambda: S.extract_bboxes(out["features"], out["multi"], boxes), {}),
        ("6 extract_bbox_features", lambda: S.extract_bbox_features(
            jpegs, boxes, "dino_vits16", feats6, device="cuda"), stage6_want),
        ("7 extract_bbox_clusters", lambda: S.extract_bbox_clusters(
            feats6, clusters, device="cuda"), {}),
        ("8 extract_semantic_segmentations", lambda: S.extract_semantic_segmentations(
            out["multi"], clusters, out["semantic"]), {}),
    ]
    for name, run, want in stage_runs:
        if name.startswith("7"):
            n_boxes = sum(len(bd["bboxes"]) for bd in torch.load(boxes, weights_only=False))
            log(f"[11] {n_boxes} boxes for stage 7's 20 clusters")
            if n_boxes < 20:
                raise AssertionError(f"{n_boxes} boxes: fewer than stage 7's 20 clusters")
        drive(name, run, want)
        if name.startswith("6"):
            log(f"[11] stage 6 batches per bucket side: {stage6_batches(Path(boxes))}")
    sem_out = drive("semantic_eval", lambda: _cli_output([
        "semantic_eval", f"data.root={voc}", f"segments_dir={out['semantic']}",
        "visualize=0", "device=cuda"]), {})
    obj_out = drive("object_segmentation", lambda: _cli_output([
        "object_segmentation", f"predictions.root={out['single']}",
        f"datasets.ECSSD.images_dir={jpegs}", f"datasets.ECSSD.labels_dir={voc / 'saliency'}",
        "device=cuda"]), {})
    os.environ["DSS_TPU_INFLIGHT"] = "0"
    try:
        drive("3 with no batch in flight", lambda: S.extract_multi_region_segmentations(
            out["features"], out["eigs"], out["multi0"], device="cuda"), {})
        drive("6 with no batch in flight", lambda: S.extract_bbox_features(
            jpegs, boxes, "dino_vits16", feats6_0, device="cuda"), stage6_want)
    finally:
        del os.environ["DSS_TPU_INFLIGHT"]
    log(f"[11] kernel shapes of the phase: {sorted(map(str, seen))}")
    if not seen <= held:
        raise AssertionError(f"shapes phases 2-3 do not hold: {seen - held}")

    # outputs and their schema
    miou = float(re.search(r"mIoU: ([-\w.]+)", sem_out).group(1))
    acc, iou = (float(x) for x in re.search(r"acc: ([-\w.]+)\s+iou: ([-\w.]+)",
                                            obj_out).groups())
    if not all(np.isfinite(x) for x in (miou, acc, iou)):
        raise AssertionError(f"non-finite scores: mIoU {miou}, acc {acc}, IoU {iou}")
    pngs = {k: sorted(Path(out[k]).iterdir()) for k in ("multi", "single", "semantic")}
    if any(len(v) != len(ids) for v in pngs.values()):
        raise AssertionError(f"segmap counts {({k: len(v) for k, v in pngs.items()})}")
    from PIL import Image
    for f in pngs["single"]:
        if not set(np.unique(np.array(Image.open(f))).tolist()) <= {0, 255}:
            raise AssertionError(f"{f.name}: single-region values other than 0/255")
    box_keys = {"bboxes", "bboxes_original_resolution", "segment_indices", "id", "format"}
    fl, cl = (torch.load(f, weights_only=False) for f in (feats6, clusters))
    for f, c in zip(fl, cl):
        n = len(f["bboxes"])
        if not (set(f) == box_keys | {"features"} and set(c) == box_keys | {"clusters"}
                and f["features"].dtype == torch.float32
                and tuple(f["features"].shape) == (n, 384)
                and bool(torch.isfinite(f["features"]).all())
                and c["clusters"].dtype == torch.int32 and tuple(c["clusters"].shape) == (n,)):
            raise AssertionError(f"{f['id']}: unexpected bbox .pth schema")
    for a in pngs["multi"]:
        if a.read_bytes() != (Path(out["multi0"]) / a.name).read_bytes():
            raise AssertionError(f"stage 3 with no batch in flight: {a.name} differs")
    if Path(feats6).read_bytes() != Path(feats6_0).read_bytes():
        raise AssertionError("stage 6 with no batch in flight wrote other bytes")
    log(f"[11] every output has the JAX schema; stages 3 and 6 with no batch in flight "
        f"(DSS_TPU_INFLIGHT=0) wrote the same bytes")
    log(f"[11] random-weight dino_vits16 (a smoke of the path, not a measurement): "
        f"semantic mIoU {miou}, object segmentation acc {acc} IoU {iou}")


def _max_err(got, ref, valid):
    return (got.float() - ref.float())[valid].abs().max().item()


def train_kernel_inputs(b: int, T: int, dtype, ragged: bool, g, dev):
    """Phase 6's operands: q, k, v (views of one (b, T, 3, 6, 64) qkv), do
    and the (b, T) key mask, ragged with an all-masked batch row 1."""
    import torch
    qkv = torch.randn((b, T, 3, 6, 64), generator=g).to(dev, dtype)
    do = torch.randn((b, T, 6, 64), generator=g).to(dev, dtype)
    mask = torch.ones((b, T), dtype=torch.bool)
    if ragged:
        mask[0, T // 2 + 7:] = False
        mask[1, :] = False
        mask[-1, : T // 3] = False
    return (*qkv.unbind(2), do, mask.to(dev))


def hi_lo_reading(got, ref, rows) -> tuple[float, float]:
    """A bf16 backward kernel's precision reading over the (b, T) bool
    `rows` (kernel 4: the valid keys; kernel 5: every query row of a batch
    row with a valid key): the share of entries not bit-equal to the twin's,
    and the RMS difference over max |twin|. The bf16 output's own rounding
    makes the largest difference one ulp either way; carrying p and ds as
    hi/lo pairs leaves the f32 sums ~1e-6 from the twin's, so few entries
    round differently, where a single bf16 rounding of p and ds moves many
    (the single-rounding control builds of both kernels, README)."""
    sel = rows[:, :, None, None].expand_as(ref)
    d = (got.float() - ref.float())[sel]
    return ((d != 0).float().mean().item(),
            d.square().mean().sqrt().item() / ref.float()[sel].abs().max().item())


def hi_lo_rows(mask) -> dict:
    """The rows `hi_lo_reading` reads for dk, dv and dq, from the (b, T) key
    mask."""
    return {"dk": mask, "dv": mask, "dq": mask.any(dim=1, keepdim=True).expand_as(mask)}


def phase_train_kernels(dev) -> dict:
    """Kernels 3-5 against their twins; returns each build's worst error
    (`flash_attention_lse`, ... for bf16, `flash_attention_lse_f32`, ...
    for f32)."""
    import torch
    from deep_spectral_tpu_torch.models.flash_attention import (
        _row_dot, flash_attention_lse, flash_attention_lse_plain, flash_backward_plain,
        flash_bwd_dkv, flash_bwd_dq)
    g = torch.Generator().manual_seed(6)
    worst = {f"{name}{suffix}": 0.0 for suffix in ("", "_f32")
             for name in ("flash_attention_lse", "flash_bwd_dkv", "flash_bwd_dq")}
    for (b, T, dtype, ragged) in TRAIN_KERNEL_SHAPES:
        dtype = getattr(torch, dtype)
        q, k, v, do, mask = train_kernel_inputs(b, T, dtype, ragged, g, dev)
        o, lse = flash_attention_lse(q, k, v, mask)
        di = _row_dot(o, do)
        dk, dv = flash_bwd_dkv(q, k, v, mask, do, lse, di)
        dq = flash_bwd_dq(q, k, v, mask, do, lse, di)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_lse_plain(q, k, v, mask)
        refs = flash_backward_plain(q, k, v, mask, o, lse, do)
        valid = mask.any(dim=1)
        f32 = dtype == torch.float32
        errs, tols = {}, {}
        errs["o"], tols["o"] = _max_err(o, o_ref, valid), F32_TOL if f32 else FLASH_TOL
        errs["lse"], tols["lse"] = _max_err(lse, lse_ref, valid), F32_TOL
        for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            errs[name] = _max_err(got, ref, valid)
            tols[name] = F32_TOL if f32 else GRAD_REL_TOL * ref.float()[valid].abs().max().item()
        if ragged and any(x[1].abs().max().item() != 0.0 for x in (o, dq, dk, dv)):
            raise AssertionError("trainable flash: the all-masked batch row is not 0")
        bad = {n: e for n, e in errs.items() if not np.isfinite(e) or e > tols[n]}
        if not f32:
            rows, limit = hi_lo_rows(mask), {"dk": DKV_SHARE_MAX, "dv": DKV_SHARE_MAX,
                                             "dq": DQ_SHARE_MAX}
            reading = {n: hi_lo_reading(got, ref, rows[n]) for n, got, ref in
                       (("dk", dk, refs[1]), ("dv", dv, refs[2]), ("dq", dq, refs[0]))}
            log(f"[6] b{b} T={T} bf16 dKV and dQ precision (hi_lo_reading): " + ", ".join(
                f"{n} share not bit-equal {sh:.4f} (max {limit[n]}), RMS diff / max "
                f"|twin| {rms:.3e}" for n, (sh, rms) in reading.items()))
            bad.update({f"{n} share not bit-equal": sh for n, (sh, _) in reading.items()
                        if not sh <= limit[n]})
        if bad:
            raise AssertionError(f"trainable flash kernels disagree with their twins: {bad} "
                                 f"(tolerances {tols})")
        log(f"[6] b{b} T={T} H=6 hd=64 {str(dtype)[6:]} ragged={ragged}: max |kernel - twin| "
            + ", ".join(f"{n} {e:.3e} (tol {tols[n]:.3e})" for n, e in errs.items()))
        suffix = "_f32" if f32 else ""
        for name, e in (("flash_attention_lse", errs["o"]),
                        ("flash_bwd_dkv", max(errs["dk"], errs["dv"])),
                        ("flash_bwd_dq", errs["dq"])):
            worst[name + suffix] = max(worst[name + suffix], e)
    return worst


def blob_batch(b: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """Normalized (b, CROP, CROP, 3) images of class-coloured discs on a
    noisy background of a random colour per image, and their (b, CROP, CROP)
    labels (0 = background). The background colours make the images differ
    globally: on alike images the ASPP pooling branch's BatchNorm (its batch
    is the pooled vectors) sees a variance ~1e3 times below the squared mean,
    where flax's E[x^2] - E[x]^2 cancels and amplifies any rounding."""
    from deep_spectral_tpu_torch.tasks.semantic_segmentation import normalize_image
    colours = rng.integers(0, 256, (CLASSES, 3))
    yy, xx = np.mgrid[:CROP, :CROP]
    images = (rng.integers(0, 256, (b, 1, 1, 3)) * 0.8
              + rng.integers(0, 50, (b, CROP, CROP, 3))).astype(np.uint8)
    labels = np.zeros((b, CROP, CROP), np.int64)
    for i in range(b):
        for _ in range(rng.integers(1, 4)):
            c = int(rng.integers(1, CLASSES))
            cy, cx, r = rng.integers(30, CROP - 30, 2).tolist() + [int(rng.integers(15, 45))]
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            images[i][disc] = colours[c]
            labels[i][disc] = c
    return normalize_image(images), labels


@contextlib.contextmanager
def twins_on_the_card():
    """Route kernels 4-5 (the autograd function's backward) through their
    plain twins on CUDA tensors, behind kernel 3's own o and lse: 7a's and
    7d's reference step. A step with kernel 3 twinned too is no reference:
    this step's gradients move by up to ~10% of their largest entry when any
    block's attention output changes by bf16 rounding alone, even by one ulp
    in 0.01% of its outputs, while two runs of the same route agree to
    within ~2e-3 on an H100: the head's ASPP pooling BatchNorm cancels ~4
    digits on these random-weight features (ROADMAP queue 3). The backward
    kernels enter the gradients linearly."""
    import torch
    from deep_spectral_tpu_torch.models import flash_attention as fa
    saved = fa.flash_backward
    fa.flash_backward = lambda *a: torch.stack(fa.flash_backward_plain(*a), dim=2)
    try:
        yield
    finally:
        fa.flash_backward = saved


def phase_train(dev) -> dict:
    import torch
    from deep_spectral_tpu_torch.models.deeplab import DeepLabViT
    from deep_spectral_tpu_torch.models.vit import get_model_config
    from deep_spectral_tpu_torch.tasks import semantic_segmentation as SS

    def new_state(unfrozen):
        cfg = SS.TrainConfig(backbone="dino_vits16", num_classes=CLASSES, lr=5e-3,
                             batch_size=TRAIN_B, unfrozen_backbone_layers=unfrozen,
                             precision="bf16", seed=0)
        model = DeepLabViT(get_model_config("dino_vits16"), CLASSES,
                           compute_dtype=torch.bfloat16, attention_impl="flash")
        return SS.create_train_state(cfg, model, device=dev)

    rng = np.random.default_rng(7)
    x_np, y_np = blob_batch(TRAIN_B, rng)
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
    state = new_state(1)
    trained = list(state.opt.params)
    if "backbone.blocks.11.attn.qkv.weight" not in trained:
        raise AssertionError("the last block is not trained")

    # (a) one step through kernels 3-5: kernel 3's o and lse in the trained
    # block against its twin on the q/k/v the step gave it, and the
    # gradients against the same step with the backward kernels 4-5 twinned
    # (behind kernel 3's o and lse). The step's gradients are not held
    # against a step with kernel 3 twinned as well: they move by up to ~10%
    # of their largest entry under any bf16 rounding change in a block's
    # attention output (see `twins_on_the_card`), so kernel 3 is held where
    # the step runs it instead.
    from deep_spectral_tpu_torch.models import flash_attention as fa
    weights = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt0 = state.opt.state_dict()
    seen, kernel3 = [], fa.flash_attention_lse

    def capture(q, k, v, kv_mask=None):
        o, lse = kernel3(q, k, v, kv_mask)
        seen.append((q, k, v, kv_mask, o, lse))
        return o, lse

    capture.launches = 0  # the wrapper counts under its module-level name, now this

    grads = {}
    for route in ("kernels", "kernels 4-5 twinned"):
        state.model.load_state_dict(weights)
        state.opt.load_state_dict(opt0)
        gen = torch.Generator(device=dev).manual_seed(11)
        if route == "kernels":
            fa.flash_attention_lse = capture
        try:
            with (twins_on_the_card() if route != "kernels"
                  else contextlib.nullcontext()):
                SS.train_step(state, x, y, gen)
        finally:
            fa.flash_attention_lse = kernel3
        grads[route] = {n: p.grad.detach().float().clone() for n, p in state.opt.params.items()}
    if len(seen) != 1:
        raise AssertionError(f"the step ran kernel 3 {len(seen)} times, not once")
    q, k, v, kv_mask, o, lse = seen[0]
    o_ref, lse_ref = fa.flash_attention_lse_plain(q, k, v, kv_mask)
    err_o, err_lse = (o.float() - o_ref.float()).abs().max().item(), \
        (lse - lse_ref).abs().max().item()
    o_max = o_ref.float().abs().max().item()
    o_tol = FLASH_TOL * max(1.0, o_max / 2)  # FLASH_TOL is for |o| < 2: bf16's ulp
    #                                          doubles with each octave above
    log(f"[7a] one b{TRAIN_B} step, kernel 3 in the trained block (q/k/v "
        f"{tuple(q.shape)} {str(q.dtype)[6:]}, max |o| {o_max:.3f}) vs its twin on the same "
        f"q/k/v: max |o diff| {err_o:.3e} (tol {o_tol:.3e}), max |lse diff| {err_lse:.3e} "
        f"(tol {F32_TOL})")
    if not (err_o <= o_tol and err_lse <= F32_TOL):
        raise AssertionError(f"kernel 3 in the train step disagrees with its twin: o {err_o}, "
                             f"lse {err_lse}")
    rel = {n: (grads["kernels"][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
           for n, g in grads["kernels 4-5 twinned"].items()}
    top = sorted(rel, key=rel.get)[-3:]
    log(f"[7a] one b{TRAIN_B} step, kernels vs kernels 4-5 twinned: {len(rel)} trained "
        f"tensors, worst gradient differences relative to max |twinned| (tol "
        f"{GRAD_REL_TOL}): " + ", ".join(f"{n} {rel[n]:.3e}" for n in top))
    if not all(np.isfinite(v) and v <= GRAD_REL_TOL for v in rel.values()):
        raise AssertionError(f"train-step gradients disagree: {top[-1]} {rel[top[-1]]}")
    del seen, grads, q, k, v, kv_mask, o, lse, o_ref, lse_ref  # freed before 7b

    # (b) the train path: 10 steps on one batch
    state = new_state(1)
    gen = torch.Generator(device=dev).manual_seed(12)
    # a first step, not counted: the gates were set on the steps after one
    SS.train_step(state, x, y, gen)
    n_steps = 10
    _zero_launches()
    losses = [float(SS.train_step(state, x, y, gen)["loss"]) for _ in range(n_steps)]
    launches = _launches()
    log(f"[7b] train dino_vits16 DeepLabV3+ crop {CROP} b{TRAIN_B} bf16 flash, 1 unfrozen "
        f"block: launches over {n_steps} steps after a first one: {launches}")
    log(f"[7b] losses: {' '.join(f'{v:.4f}' for v in losses)}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("train loss not finite or not falling")
    per_step = {n: c / n_steps for n, c in launches.items()}
    if min(per_step["flash_attention_lse"], per_step["flash_bwd_dkv"],
           per_step["flash_bwd_dq"]) < 1 or per_step["flash_attention_packed"] < 11:
        raise AssertionError(f"the train path skipped a kernel: {launches}")

    # (c) the whole backbone unfrozen: every block runs kernels 3-5
    state = new_state(-1)
    gen = torch.Generator(device=dev).manual_seed(13)
    # a first step, not counted: the gates were set on the steps after one
    SS.train_step(state, x, y, gen)
    n_full = 3
    _zero_launches()
    losses = [float(SS.train_step(state, x, y, gen)["loss"]) for _ in range(n_full)]
    full = _launches()
    log(f"[7c] whole backbone unfrozen, b{TRAIN_B}: losses "
        f"{' '.join(f'{v:.4f}' for v in losses)}; launches over {n_full} steps after a "
        f"first one: {full}")
    if not all(np.isfinite(losses)) or any(full[n] != 12 * n_full for n in
                                           ("flash_attention_lse", "flash_bwd_dkv",
                                            "flash_bwd_dq")):
        raise AssertionError(f"unfrozen backbone: expected 12 launches of kernels 3-5 per "
                             f"step: {full}")
    return launches


def phase_train_fp32(dev) -> dict:
    """7d: the fp32 recipe's step, the precision `semantic_train` defaults to:
    `build_model` (DeepLabV3+ over dino_vits16, 'auto' attention: kernel 3's
    f32 build in all 12 blocks, kernels 4-5's f32 builds in the trained one),
    crop 224, b144, one unfrozen block. Both routes are one step from the
    same state under deterministic algorithms, so what differs is the
    kernels. Gated, as 7a gates the bf16 step: kernel 3's o and lse at each
    of the step's 12 launches against its twin on the q/k/v it was given
    (F32_TOL), and the trained gradients against the same step with kernels
    4-5 twinned behind kernel 3's own o and lse (F32_GRAD_REL of the largest
    entry). Then 10 steps through the kernels and through einsum attention,
    each loss finite and falling. Returns the f32 builds' launches over the
    10 kernel steps."""
    import warnings
    import torch
    from deep_spectral_tpu_torch.models import flash_attention as fa
    from deep_spectral_tpu_torch.models import vit
    from deep_spectral_tpu_torch.models.deeplab import DeepLabViT
    from deep_spectral_tpu_torch.models.vit import get_model_config
    from deep_spectral_tpu_torch.tasks import semantic_segmentation as SS
    cfg = SS.TrainConfig(backbone="dino_vits16", num_classes=CLASSES, lr=5e-3,
                         batch_size=TRAIN_B, unfrozen_backbone_layers=1, seed=0)
    if cfg.precision != "fp32":
        raise AssertionError(f"semantic_train's default precision is {cfg.precision}")
    x_np, y_np = blob_batch(TRAIN_B, np.random.default_rng(27))
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)

    def new_state(impl):
        model = SS.build_model(cfg) if impl == "flash" else DeepLabViT(
            get_model_config("dino_vits16"), CLASSES, compute_dtype=torch.float32,
            attention_impl=impl)
        return SS.create_train_state(cfg, model, device=dev)

    kernel3, seen = fa.flash_attention_lse, []

    def capture(q, k, v, kv_mask=None):
        o, lse = kernel3(q, k, v, kv_mask)
        seen.append((q, k, v, kv_mask, o, lse))
        return o, lse

    # the wrapper counts under its module-level name, now this
    capture.launches = capture.f32_launches = 0

    grads, first = {}, None
    for route in ("kernels", "kernels 4-5 twinned"):
        state = new_state("flash")
        _zero_launches()
        if route == "kernels":
            fa.flash_attention_lse = vit.flash_attention_lse = capture
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # cuBLAS's determinism notice
                with (contextlib.nullcontext() if route == "kernels"
                      else twins_on_the_card()):
                    SS.train_step(state, x, y, torch.Generator(device=dev).manual_seed(28))
            torch.cuda.synchronize()
            if route == "kernels":  # kernel 3's count is `capture`'s now
                first = {"flash_attention_lse": capture.f32_launches,
                         "flash_bwd_dkv": fa.flash_bwd_dkv.f32_launches,
                         "flash_bwd_dq": fa.flash_bwd_dq.f32_launches}
        finally:
            torch.use_deterministic_algorithms(False)
            fa.flash_attention_lse = vit.flash_attention_lse = kernel3
        grads[route] = {n: p.grad.detach().clone() for n, p in state.opt.params.items()}
        del state
    if len(seen) != 12:
        raise AssertionError(f"the fp32 step ran kernel 3 {len(seen)} times, not 12")
    err_o = err_lse = 0.0
    for q, k, v, kv_mask, o, lse in seen:
        o_ref, lse_ref = fa.flash_attention_lse_plain(q, k, v, kv_mask)
        err_o = max(err_o, (o - o_ref).abs().max().item())
        err_lse = max(err_lse, (lse - lse_ref).abs().max().item())
    del seen
    log(f"[7d] one fp32 b{TRAIN_B} step: kernel 3 at its 12 launches (11 frozen blocks, the "
        f"trained one) vs its twin on the same q/k/v: max |o diff| {err_o:.3e}, max |lse "
        f"diff| {err_lse:.3e} (tol {F32_TOL}); the step's f32 launches {first}")
    twinned = grads["kernels 4-5 twinned"]
    rel = {n: (grads["kernels"][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
           for n, g in twinned.items()}
    top = sorted(rel, key=rel.get)[-3:]
    log(f"[7d] one fp32 b{TRAIN_B} step (deterministic algorithms), kernels vs kernels 4-5 "
        f"twinned: {len(rel)} trained tensors, worst gradient differences relative to max "
        f"|twinned| (tol {F32_GRAD_REL}): " + ", ".join(f"{n} {rel[n]:.3e}" for n in top))
    worst = max(rel.values())
    if not (err_o <= F32_TOL and err_lse <= F32_TOL and np.isfinite(worst)
            and worst <= F32_GRAD_REL):
        raise AssertionError(f"the fp32 step's f32 kernels disagree with their twins: o "
                             f"{err_o}, lse {err_lse}, gradients {worst}")
    if first != {"flash_attention_lse": 12, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}:
        raise AssertionError(f"the fp32 step's f32 launches: {first}")
    del grads, twinned

    n_steps, launches = 10, {}
    for impl in ("flash", "einsum"):
        state = new_state(impl)
        gen = torch.Generator(device=dev).manual_seed(29)
        # a first step, not counted: the gates were set on the steps after one
        SS.train_step(state, x, y, gen)
        _zero_launches()
        losses = [float(SS.train_step(state, x, y, gen)["loss"]) for _ in range(n_steps)]
        launches[impl] = _f32_launches()
        log(f"[7d] train dino_vits16 DeepLabV3+ crop {CROP} b{TRAIN_B} fp32 {impl}, 1 unfrozen "
            f"block: f32 launches over {n_steps} steps after a first one: {launches[impl]}; "
            f"losses {' '.join(f'{v:.4f}' for v in losses)}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"fp32 {impl} train loss not finite or not falling")
        del state
    want = {"flash_attention_lse": 12 * n_steps, "flash_bwd_dkv": n_steps,
            "flash_bwd_dq": n_steps}
    if launches["flash"] != want or any(launches["einsum"].values()):
        raise AssertionError(f"fp32 steps' f32 launches: {launches}, want {want} through the "
                             f"kernels")
    return launches["flash"]


def make_voc(root: Path) -> None:
    """8 VOC-layout images (2 val with GT) with blob pseudolabels on the
    16-pixel grid."""
    from PIL import Image
    rng = np.random.default_rng(8)
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation", "pseudo"):
        (root / d).mkdir(parents=True, exist_ok=True)
    names = []
    for i in range(8):
        h, w = [(256, 320), (320, 256)][i % 2]
        img = rng.integers(0, 80, (h, w, 3)).astype(np.uint8)
        gt = np.zeros((h, w), np.uint8)
        y0, x0 = int(rng.integers(16, h - 112)), int(rng.integers(16, w - 112))
        c = int(rng.integers(1, 21))
        img[y0:y0 + 96, x0:x0 + 96] = [40 + 10 * c, 200 - 5 * c, 120]
        gt[y0:y0 + 96, x0:x0 + 96] = c
        names.append(f"im{i}")
        Image.fromarray(img).save(root / "JPEGImages" / f"im{i}.jpg", quality=95)
        Image.fromarray(gt).save(root / "SegmentationClass" / f"im{i}.png")
        Image.fromarray(gt[::16, ::16]).save(root / "pseudo" / f"im{i}.png")
    (root / "ImageSets" / "Segmentation" / "val.txt").write_text("\n".join(names[6:]))


def phase_train_cli(tmp: Path) -> None:
    make_voc(tmp / "voc")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cli = [sys.executable, "-m", "deep_spectral_tpu_torch.tasks.cli", "semantic_train",
           f"data.root={tmp / 'voc'}", f"segments_dir={tmp / 'voc' / 'pseudo'}",
           "data.loader.batch_size=4", "eval_every=2", "device=cuda"]
    runs = [("train", ["max_train_steps=4", f"checkpoint.dir={tmp / 'ck'}"]),
            ("resume", ["max_train_steps=6", f"checkpoint.dir={tmp / 'ck2'}",
                        f"checkpoint.resume={tmp / 'ck' / 'best.pt'}"])]
    outs = {}
    for name, args in runs:
        proc = subprocess.run(cli + args, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        outs[name] = proc.stdout
        log(f"[8] semantic_train ({name}): rc {proc.returncode}")
        for line in (proc.stdout + proc.stderr).strip().splitlines()[-6:]:
            log(f"    {line}")
        if proc.returncode != 0:
            raise AssertionError(f"semantic_train ({name}) failed")
    import torch
    best = torch.load(tmp / "ck" / "best.pt", weights_only=True)["step"]
    if "val mIoU=" not in outs["train"] or best not in (2, 4):
        raise AssertionError("semantic_train: no val mIoU line or no best checkpoint")
    if f"at step {best}" not in outs["resume"] or \
            f"trained steps {best}..6: {6 - best} steps" not in outs["resume"]:
        raise AssertionError("semantic_train: the resume did not run only the remaining steps")
    log(f"[8] best checkpoint at step {best}; the resume ran steps {best}..6")


# ----------------------------------------------------------------- phase 12

def _pngs(d) -> list:
    return sorted(Path(d).glob("*.png"))


def phase_run_all(tmp: Path) -> dict:
    """(a) `run_all` on the card over phase 11's tree; returns its output
    dirs and the tree."""
    import torch
    from PIL import Image
    from deep_spectral_tpu_torch.models.vit import get_model_config
    from deep_spectral_tpu_torch.pipeline import extract as S
    from deep_spectral_tpu_torch.pipeline.run_all import run_all
    voc = tmp / "voc"
    ids = make_seg_voc(voc)
    jpegs, listing = voc / "JPEGImages", tmp / "list.txt"
    listing.write_text("\n".join(f"{i}.jpg" for i in ids))
    blocks = get_model_config("dino_vits16").depth
    held = ({("flash_attention_packed", 4, t, torch.bfloat16) for t in LOC_FLASH_T}
            | {("flash_attention_packed", STAGE6_B, t, torch.bfloat16) for t in STAGE6_T}
            | {("chebyshev_filter", 4, n, K + 3) for n in LOC_CHEB_N})
    seen = set()
    os.environ.pop("DSS_TPU_INFLIGHT", None)  # the default: one batch in flight
    _zero_launches()
    with kernel_shapes(seen), contextlib.redirect_stdout(io.StringIO()):
        dirs = run_all(str(listing), str(jpegs), str(tmp / "out"), K=K, batch_size=4,
                       feature_batch_size=4, device="cuda")
    torch.cuda.synchronize()
    launches = _launches()
    log(f"[12a] run_all dino_vits16 bf16 on {len(ids)} images (480x480, 320x480), stage 1 "
        f"b4, stage 2 K={K} b4")
    stage6 = sum(stage6_batches(Path(dirs["bboxes"])).values())
    want = {"flash_attention_packed": (blocks - 1) * 6 + blocks * stage6}
    log(f"[12a] launches {launches}; kernel 1 expected {want['flash_attention_packed']} "
        f"(11 attending blocks x 6 stage-1 batches + 12 blocks x {stage6} stage-6 batches), "
        f"kernel 2 and the Jacobi eigh at least once, no other")
    if launches["flash_attention_packed"] != want["flash_attention_packed"] or \
            launches["chebyshev_filter"] <= 0 or launches["small_eigh"] <= 0 or \
            any(c for n, c in launches.items()
                if n not in ("flash_attention_packed", "chebyshev_filter", "small_eigh")):
        raise AssertionError(f"run_all: launches {launches}")
    log(f"[12a] kernel shapes of run_all: {sorted(map(str, seen))}")
    if not seen <= held:
        raise AssertionError(f"shapes phases 2-3 do not hold: {seen - held}")

    # every output with the JAX schema
    sizes = {i: Image.open(jpegs / f"{i}.jpg").size[::-1] for i in ids}
    for key in ("features", "eigs"):
        if len(list(Path(dirs[key]).glob("*.pth"))) != len(ids):
            raise AssertionError(f"{key}: not one .pth per image")
    for i in ids:
        (h, w), n = sizes[i], (sizes[i][0] // 16) * (sizes[i][1] // 16)
        f = torch.load(Path(dirs["features"]) / f"{i}.pth", weights_only=False)
        e = torch.load(Path(dirs["eigs"]) / f"{i}.pth", weights_only=False)
        if not (f["k"].dtype == torch.float16 and tuple(f["k"].shape) == (1, n, 384)
                and tuple(e["eigenvectors"].shape) == (K, n)):
            raise AssertionError(f"{i}: unexpected feature or eig .pth")
    for key in ("multi", "single", "semantic", "crf", "crf_single"):
        files = _pngs(dirs[key])
        if [f.stem for f in files] != ids:
            raise AssertionError(f"{key}: {len(files)} PNGs for {len(ids)} images")
    for key, top in (("crf", CLASSES), ("crf_single", 2)):
        for f in _pngs(dirs[key]):
            a = np.array(Image.open(f))
            if a.dtype != np.uint8 or a.shape != sizes[f.stem] or a.max() >= top:
                raise AssertionError(f"{key}/{f.name}: CRF PNG {a.dtype} {a.shape}, "
                                     f"max {a.max()}")
    for key in ("bboxes", "bbox_features", "bbox_clusters"):
        if len(torch.load(dirs[key], weights_only=False)) != len(ids):
            raise AssertionError(f"{key}: not one entry per image")
    log(f"[12a] every output has the JAX schema: {len(ids)} feature and eig .pth files, "
        f"segmaps, boxes, CRF PNGs at image size with labels below {CLASSES} (semantic) "
        f"and in {{0, 1}} (single region)")

    # stage 9 again with no batch in flight: the same bytes
    os.environ["DSS_TPU_INFLIGHT"] = "0"
    try:
        _zero_launches()
        for key, src, classes in (("crf", "semantic", CLASSES), ("crf_single", "single", 2)):
            S.extract_crf_segmentations(str(listing), str(jpegs), dirs[src],
                                        str(tmp / f"{key}_inflight0"), num_classes=classes,
                                        device="cuda")
            differ = [f.name for f in _pngs(dirs[key])
                      if f.read_bytes() != (tmp / f"{key}_inflight0" / f.name).read_bytes()]
            if differ:
                raise AssertionError(f"stage 9 ({key}) with no batch in flight: {differ} differ")
    finally:
        del os.environ["DSS_TPU_INFLIGHT"]
    if any(_launches().values()):
        raise AssertionError(f"stage 9 launched a kernel: {_launches()}")
    log(f"[12a] stage 9 with no batch in flight (DSS_TPU_INFLIGHT=0) wrote the same bytes "
        f"({2 * len(ids)} PNGs)")
    return {"dirs": dirs, "voc": voc, "ids": ids, "list": listing}


def _crf_batch(voc: Path, seg_dir: str, ids: list):
    """Stage 9's inputs for `ids` (one size): uint8 images and upsampled
    segmaps edge-replicated into their 64-pixel bucket, and the sizes."""
    from deep_spectral_tpu_torch.pipeline.extract import CRF_GRAN, _upsample_segmap
    from deep_spectral_tpu_torch.utils.image_io import load_image_rgb
    from deep_spectral_tpu_torch.utils.serialization import load_segmap_png
    imgs, segs = [], []
    for i in ids:
        img = load_image_rgb(voc / "JPEGImages" / f"{i}.jpg")
        H, W = img.shape[:2]
        seg = _upsample_segmap(load_segmap_png(Path(seg_dir) / f"{i}.png"), H, W, 16)
        BH, BW = -(-H // CRF_GRAN) * CRF_GRAN, -(-W // CRF_GRAN) * CRF_GRAN
        imgs.append(np.pad(img, ((0, BH - H), (0, BW - W), (0, 0)), mode="edge"))
        segs.append(np.pad(seg, ((0, BH - H), (0, BW - W)), mode="edge").astype(np.uint8))
    return np.stack(imgs), np.stack(segs), (H, W)


def phase_crf(run: dict) -> None:
    """(b) the CRF on the card against the CRF on the CPU: stage 9's batches
    of 4 at the default parameters (dense regime), then one image in the
    grid regime (the dense bound lowered to 0), run twice on the card; the
    verification recipe's blob probe."""
    import torch
    from deep_spectral_tpu_torch.ops import crf as CRF
    voc, ids, dirs = run["voc"], run["ids"], run["dirs"]
    dev = torch.device("cuda")
    by_size = [ids[0:8:2], ids[1:8:2]]           # 480x480 and 320x480, 4 each
    worst = 1.0
    for group in by_size:
        imgs, segs, (H, W) = _crf_batch(voc, dirs["semantic"], group)
        card = CRF.dense_crf(torch.from_numpy(imgs).to(dev), torch.from_numpy(segs).to(dev),
                             num_classes=CLASSES).cpu().numpy()
        cpu = CRF.dense_crf(torch.from_numpy(imgs), torch.from_numpy(segs),
                            num_classes=CLASSES).numpy()
        agree = [float(np.mean(c[:H, :W] == p[:H, :W])) for c, p in zip(card, cpu)]
        log(f"[12b] dense_crf b{len(group)} at the {imgs.shape[1]}x{imgs.shape[2]} bucket of "
            f"{H}x{W} images, 21 classes, default parameters: labels on the card equal to "
            f"the CPU's on {min(agree):.6f} of an image's pixels at least (min "
            f"{CRF_AGREEMENT_MIN})")
        worst = min(worst, *agree)
    if worst < CRF_AGREEMENT_MIN:
        raise AssertionError(f"CRF labels on the card agree with the CPU on {worst} only")

    # bilateral_filter on the card vs the CPU, dense regime, on the first image
    imgs, segs, (H, W) = _crf_batch(voc, dirs["semantic"], by_size[0][:1])
    probs = torch.softmax(torch.from_numpy(np.random.default_rng(12).standard_normal(
        (*segs.shape[1:], CLASSES)).astype(np.float32)), dim=-1)
    img0 = torch.from_numpy(imgs[0]).float()

    def filter_rel(a, b):
        return max(((x.cpu().double() - y.double()).abs().max()
                    / y.double().abs().max()).item() for x, y in zip(a, b))
    rel_dense = filter_rel(CRF.bilateral_filter(probs.to(dev), img0.to(dev), 80.0, 13.0),
                           CRF.bilateral_filter(probs, img0, 80.0, 13.0))
    # the grid regime on the same image: twice on the card, once on the CPU
    saved = CRF._DENSE_MAX_POINTS
    CRF._DENSE_MAX_POINTS = 0
    try:
        grid_card = [CRF.bilateral_filter(probs.to(dev), img0.to(dev), 80.0, 13.0)
                     for _ in range(2)]
        rel_grid = filter_rel(grid_card[0], CRF.bilateral_filter(probs, img0, 80.0, 13.0))
        args = (torch.from_numpy(imgs).to(dev), torch.from_numpy(segs).to(dev))
        labels_card = [CRF.dense_crf(*args, num_classes=CLASSES) for _ in range(2)]
        labels_cpu = CRF.dense_crf(torch.from_numpy(imgs), torch.from_numpy(segs),
                                   num_classes=CLASSES).numpy()
    finally:
        CRF._DENSE_MAX_POINTS = saved
    same = all(torch.equal(a, b) for a, b in zip(*grid_card)) and \
        torch.equal(*labels_card)
    grid_agree = float(np.mean(labels_card[0].cpu().numpy()[0, :H, :W] == labels_cpu[0, :H, :W]))
    log(f"[12b] bilateral_filter on the card vs the CPU ({H}x{W} image in its "
        f"{imgs.shape[1]}-pixel bucket, 21 channels, alpha 80): dense regime max rel diff "
        f"{rel_dense:.3e}, grid regime {rel_grid:.3e} (tol {CRF_FILTER_REL}); grid regime "
        f"twice on the card: the same bytes {same}; grid-regime dense_crf labels equal to "
        f"the CPU's on {grid_agree:.6f} of the pixels")
    if max(rel_dense, rel_grid) > CRF_FILTER_REL or not same or grid_agree < CRF_AGREEMENT_MIN:
        raise AssertionError("the CRF's bilateral filter disagrees, or the grid regime is "
                             "not deterministic on the card")

    # the verification recipe's probe: a 16x-coarse blob mask snaps to the blob
    rng = np.random.default_rng(13)
    img = (rng.random((IMG, IMG, 3)) * 100).astype(np.uint8)
    blob = np.zeros((IMG, IMG), bool)
    blob[37:233, 83:331] = True
    img[blob] = [210, 70, 60]
    seg = np.repeat(np.repeat(blob[8::16, 8::16], 16, 0), 16, 1).astype(np.uint8)
    out = CRF.dense_crf(torch.from_numpy(img).to(dev), torch.from_numpy(seg).to(dev),
                        num_classes=2).cpu().numpy() == 1
    iou_before = (seg.astype(bool) & blob).sum() / (seg.astype(bool) | blob).sum()
    iou = float((out & blob).sum() / (out | blob).sum())
    log(f"[12b] blob probe on the card ({IMG}x{IMG}, 16x-coarse mask): IoU {iou:.4f} "
        f"(min {BLOB_IOU_MIN}; {iou_before:.4f} before the CRF)")
    if iou <= BLOB_IOU_MIN:
        raise AssertionError(f"blob probe IoU {iou}")


def phase_vis(run: dict, tmp: Path) -> None:
    """(c) stage 10 over (a)'s outputs, and `vis_server` in a thread."""
    import importlib.util
    import threading
    import urllib.request
    from PIL import Image
    from deep_spectral_tpu_torch.pipeline import extract as S
    from deep_spectral_tpu_torch.pipeline.vis_server import make_vis_server
    dirs, ids = run["dirs"], run["ids"]
    jpegs = str(run["voc"] / "JPEGImages")
    if importlib.util.find_spec("matplotlib") is None:
        log("[12c] stage 10 (vis_segmentations) not run: it draws with matplotlib, which "
            "this host does not have")
    else:
        S.vis_segmentations(str(run["list"]), jpegs, dirs["crf"], bbox_file=dirs["bboxes"],
                            output_dir=str(tmp / "vis"), max_images=4)
        names = sorted(f.name for f in (tmp / "vis").iterdir())
        log(f"[12c] stage 10: {names}")
        if names != sorted([f"{i}.png" for i in ids[:4]] + ["index.html"]):
            raise AssertionError(f"stage 10 wrote {names}")
    srv = make_vis_server(str(run["list"]), jpegs, dirs["crf"], dirs["bboxes"], dirs["eigs"],
                          port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        got = {}
        for path in ("/api/index", f"/seg/{ids[1]}", f"/eig/{ids[1]}/1"):
            with urllib.request.urlopen(url + path, timeout=30) as r:
                got[path] = (r.status, r.headers.get("Content-Type"), r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    items = json.loads(got["/api/index"][2])["items"]
    seg = np.asarray(Image.open(io.BytesIO(got[f"/seg/{ids[1]}"][2])))
    eig = Image.open(io.BytesIO(got[f"/eig/{ids[1]}/1"][2]))
    log(f"[12c] vis_server on port {srv.server_address[1]}: index of {len(items)} items, "
        f"segmap overlay {seg.shape} RGBA, eigenvector heatmap {eig.size} (W, H); stopped "
        f"(thread alive: {thread.is_alive()})")
    if len(items) != len(ids) or seg.shape != (320, 480, 4) or eig.size != (30, 20) or \
            thread.is_alive() or not all(v[0] == 200 for v in got.values()):
        raise AssertionError("vis_server: unexpected responses")


def phase_generate(run: dict, tmp: Path) -> None:
    """(d) semantic_train (bf16 dino_vits16, 2 steps at crop 224 b8) on (a)'s
    CRF segmaps, then semantic_generate from its checkpoint, each through
    `tasks.cli.main`; the dump's eval forward must launch kernel 1."""
    import torch
    from PIL import Image
    voc, ids, dirs = run["voc"], run["ids"], run["dirs"]
    cfg = [f"data.root={voc}", f"segments_dir={dirs['crf']}", "precision=bf16",
           f"data.loader.batch_size={GEN_B}", "device=cuda"]
    _cli_output(["semantic_train", *cfg, "max_train_steps=2", "eval_every=2",
                 f"checkpoint.dir={tmp / 'ck'}"])
    log(f"[12d] semantic_train bf16 dino_vits16 crop {CROP} b{GEN_B}, 2 steps and an eval")
    seen = set()
    _zero_launches()
    with kernel_shapes(seen):
        _cli_output(["semantic_generate", "--checkpoint", str(tmp / "ck" / "best.pt"),
                     "--output_dir", str(tmp / "gen"), *cfg])
    torch.cuda.synchronize()
    launches = _launches()
    val = ids[::3]
    log(f"[12d] semantic_generate: launches {launches}, kernel shapes "
        f"{sorted(map(str, seen))}")
    # one bucket (480x480 holds every val image), one batch of 8: 12 blocks
    if launches["flash_attention_packed"] != 12 or \
            any(c for n, c in launches.items() if n != "flash_attention_packed"):
        raise AssertionError(f"semantic_generate: launches {launches}")
    preds = _pngs(tmp / "gen" / "pred")
    if [f.stem for f in preds] != val or len(_pngs(tmp / "gen" / "gt")) != len(val):
        raise AssertionError(f"semantic_generate wrote {[f.name for f in preds]}")
    for f in preds:
        a = np.array(Image.open(f))
        h, w = Image.open(voc / "JPEGImages" / f"{f.stem}.jpg").size[::-1]
        if a.shape != ((h // 16) * 16, (w // 16) * 16) or a.max() >= CLASSES:
            raise AssertionError(f"{f.name}: prediction {a.shape}, max {a.max()}")
    log(f"[12d] one prediction PNG per val image ({len(val)}), at the image's size cropped "
        f"to a multiple of 16, labels below {CLASSES}")


def phase_resnet(run: dict, tmp: Path) -> None:
    """(e) DeepLabResNet (ResNet-50, output stride 8) at crop 224, random
    weights: the f32 forward on the card against the CPU, 3 train steps at
    b16, then semantic_generate's per-image path from a checkpoint."""
    import torch
    from deep_spectral_tpu_torch.models.deeplab import DeepLabResNet
    from deep_spectral_tpu_torch.tasks import semantic_segmentation as SS
    from PIL import Image
    dev = torch.device("cuda")
    cfg = SS.TrainConfig(backbone="resnet50", num_classes=CLASSES, crop_size=CROP,
                         batch_size=RESNET_B, unfrozen_backbone_layers=1, seed=0)
    state = SS.create_train_state(cfg, SS.build_model(cfg), device=dev)
    x_np, y_np = blob_batch(RESNET_B, np.random.default_rng(15))
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
    cpu_model = DeepLabResNet(CLASSES).eval()
    cpu_model.load_state_dict(state.model.state_dict())
    state.model.eval()
    with torch.no_grad():
        got = state.model(x[:2]).cpu().double()
        want = cpu_model(torch.from_numpy(x_np[:2])).double()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"[12e] DeepLabResNet-50 OS8 f32 forward b2 crop {CROP} (random weights, eval): card "
        f"vs CPU max rel diff {rel:.3e} (tol {RESNET_REL}), max |logit| "
        f"{want.abs().max().item():.3e}")
    if not rel <= RESNET_REL:
        raise AssertionError(f"DeepLabResNet on the card disagrees with the CPU: {rel}")
    gen = torch.Generator(device=dev).manual_seed(16)
    # a first step, not counted: the gates were set on the steps after one
    SS.train_step(state, x, y, gen)
    losses = [float(SS.train_step(state, x, y, gen)["loss"]) for _ in range(3)]
    log(f"[12e] DeepLabResNet train b{RESNET_B} crop {CROP}, layer4 + head trained, 3 steps "
        f"after a first one: losses {' '.join(f'{v:.4f}' for v in losses)}")
    if not all(np.isfinite(losses)):
        raise AssertionError("DeepLabResNet loss is not finite")
    SS.save_checkpoint(str(tmp / "rck"), state, 4)
    del state
    _zero_launches()
    _cli_output(["semantic_generate", "--checkpoint", str(tmp / "rck" / "step_4.pt"),
                 "--output_dir", str(tmp / "rgen"), "backbone=resnet50",
                 f"data.root={run['voc']}", f"segments_dir={run['dirs']['crf']}", "device=cuda"])
    preds = _pngs(tmp / "rgen" / "pred")
    shapes = {np.array(Image.open(f)).shape for f in preds}
    log(f"[12e] semantic_generate (ResNet, per-image path): {len(preds)} predictions of "
        f"shapes {sorted(shapes)}; launches {_launches()}")
    if [f.stem for f in preds] != run["ids"][::3] or shapes != {(480, 480), (320, 480)} or \
            any(_launches().values()):
        raise AssertionError("ResNet semantic_generate: unexpected output or launches")


def _grad_diff(a: dict, b: dict) -> tuple:
    """(bit-equal count, max relative difference, the names that differ)."""
    import torch
    differ = [n for n in a if not torch.equal(a[n], b[n])]
    rel = max([((b[n] - a[n]).abs().max() / a[n].abs().max().clamp(min=1e-30)).item()
               for n in differ] or [0.0])
    return len(a) - len(differ), rel, differ


def phase_remat(dev) -> None:
    """(f) one 7b step (and one 7c step) with remat=True and one without,
    from the same weights, batch and dropout generator, under
    `torch.use_deterministic_algorithms`: the trained parameters' gradients
    must be bit-equal, and the remat'd step must launch kernel 3 twice per
    trained block."""
    import warnings
    import torch
    from deep_spectral_tpu_torch.models.deeplab import DeepLabViT
    from deep_spectral_tpu_torch.models.vit import get_model_config
    from deep_spectral_tpu_torch.tasks import semantic_segmentation as SS
    x_np, y_np = blob_batch(TRAIN_B, np.random.default_rng(17))
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)

    def first_step(unfrozen, remat):
        """A fresh state's first step: (gradients, loss, launches)."""
        cfg = SS.TrainConfig(backbone="dino_vits16", num_classes=CLASSES, lr=5e-3,
                             batch_size=TRAIN_B, unfrozen_backbone_layers=unfrozen,
                             precision="bf16", seed=0, remat=remat)
        model = DeepLabViT(get_model_config("dino_vits16"), CLASSES,
                           compute_dtype=torch.bfloat16, attention_impl="flash", remat=remat)
        state = SS.create_train_state(cfg, model, device=dev)
        _zero_launches()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # cuBLAS's determinism notice
                loss = SS.train_step(state, x, y,
                                     torch.Generator(device=dev).manual_seed(18))["loss"]
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        grads = {n: p.grad.detach().clone() for n, p in state.opt.params.items()}
        return grads, loss.clone(), _launches()

    for unfrozen, name, trained in ((1, "7b", 1), (-1, "7c", 12)):
        runs = {}
        for remat in (False, True):
            runs[remat] = first_step(unfrozen, remat)
            launches = runs[remat][2]
            if launches["flash_attention_lse"] != trained * (2 if remat else 1) or \
                    launches["flash_bwd_dkv"] != trained or launches["flash_bwd_dq"] != trained:
                raise AssertionError(f"{name} remat={remat}: launches {launches}")
        equal, rel, differ = _grad_diff(runs[False][0], runs[True][0])
        same_loss = torch.equal(runs[False][1], runs[True][1])
        log(f"[12f] {name} under torch.use_deterministic_algorithms: {equal} of "
            f"{len(runs[False][0])} trained gradients bit-equal with and without remat "
            f"(max rel diff {rel:.3e}; differ: {differ[:4]}); loss bit-equal {same_loss}; "
            f"kernel 3 {trained} -> {2 * trained} launches (remat'd step: {runs[True][2]})")
        if differ or not same_loss:
            raise AssertionError(f"{name}: remat changed the step (max rel diff {rel})")
        del runs


def phase_12(tmp: Path, dev) -> None:
    run = phase_run_all(tmp)
    phase_crf(run)
    phase_vis(run, tmp)
    phase_generate(run, tmp)
    phase_resnet(run, tmp)
    phase_remat(dev)


# ----------------------------------------------------------------- phase 13

def _cos_min(a, b) -> float:
    """The least cosine between matching rows (last dim) of a and b."""
    import torch
    a, b = a.double().flatten(0, -2), b.double().flatten(0, -2)
    norms = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1)
    return ((a * b).sum(-1) / norms.clamp(min=1e-30)).min().item()


def _held(what: str, err: float, tol: float) -> None:
    log(f"[13] {what}: max |diff| {err:.3e} (tol {tol:.3e})")
    if not np.isfinite(err) or err > tol:
        raise AssertionError(f"{what}: {err} above {tol}")


def _agree(what: str, got, ref, world: int, f32: bool = False) -> None:
    """A parallel path's output against the single-card path's on the same
    input (`f32`: computed in fp32, else in bf16). At world 1 by max |diff|:
    F32_TOL in fp32, FLASH_TOL in bf16 scaled by the magnitude (FLASH_TOL
    is bf16's bound for |x| < 2, and its ulp doubles with each octave
    above). At world > 1 the GEMMs run at other shapes, and the all-reduces
    and the hop merges add in another order: fp32 by max |diff| within
    F32_TOL of max |ref|, bf16 by the least per-token cosine (PAR_COS_MIN)."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    if f32:
        _held(what, err, F32_TOL * (1.0 if world == 1 else max(1.0, scale)))
    elif world == 1:
        _held(what, err, FLASH_TOL * max(1.0, scale / 2))
    else:
        cos = _cos_min(got, ref)
        log(f"[13] {what}: least per-token cosine {cos:.6f} (min {PAR_COS_MIN}), max |diff| "
            f"{err:.3e}")
        if not cos >= PAR_COS_MIN:
            raise AssertionError(f"{what}: cosine {cos} below {PAR_COS_MIN}")


def _want_launches(what: str, got: dict, want: dict) -> None:
    if any(got[n] != c for n, c in want.items()):
        raise AssertionError(f"{what}: launches {got}, want {want}")


def _gather_tokens(group, x):
    """Every rank's token rows (dim 1; the ranks may hold different counts)
    concatenated in rank order, on every rank."""
    import torch
    import torch.nn.functional as F
    from deep_spectral_tpu_torch.parallel.mesh import gather_rows
    counts = gather_rows(group, torch.tensor([x.shape[1]], device=x.device)).tolist()
    rows = max(counts)
    padded = gather_rows(group, F.pad(x, (0, 0, 0, rows - x.shape[1])).contiguous(), dim=1)
    return torch.cat([b[:, :c] for b, c in zip(padded.split(rows, dim=1), counts)], dim=1)


def _hop_gate(what: str, q, k, v, mask) -> None:
    """Kernel 3 (`flash_attention_lse`) at one ring hop's shape against its
    twin on the same inputs (o: FLASH_TOL in bf16 scaled by |o|, F32_TOL in
    f32; the lse within F32_TOL of max(1, |lse|))."""
    import torch
    from deep_spectral_tpu_torch.models.flash_attention import (
        flash_attention_lse, flash_attention_lse_plain)
    o, lse = flash_attention_lse(q, k, v, mask)
    torch.cuda.synchronize()
    o_ref, lse_ref = flash_attention_lse_plain(q, k, v, mask)
    f32 = q.dtype == torch.float32
    o_tol = F32_TOL if f32 else FLASH_TOL * max(1.0, o_ref.float().abs().max().item() / 2)
    lse_tol = F32_TOL * max(1.0, lse_ref.abs().max().item())
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    b, T = q.shape[:2]
    valid = T if mask is None else int(mask.sum())
    log(f"[13] kernel 3 at the ring hop {what} (b{b} T={T} H=6 hd=64 {str(q.dtype)[6:]}, "
        f"{valid} valid keys): vs its twin o {err_o:.3e} (tol {o_tol:.3e}), lse {err_lse:.3e} "
        f"(tol {lse_tol:.3e})")
    if not (err_o <= o_tol and err_lse <= lse_tol):
        raise AssertionError(f"13: kernel 3 at {what} disagrees with its twin: o {err_o}, "
                             f"lse {err_lse}")


def _parallel_sp(dev, mesh, x, world) -> tuple | None:
    """(a) SP-ViT through kernel 3's ring hops, the ranks' rows gathered,
    against the single-card forward on the same input (kernel 1 in bf16,
    kernel 3's f32 build in fp32); returns block 0's bf16 q/k/v at world 1."""
    import torch
    from deep_spectral_tpu_torch.models.convert import random_init_
    from deep_spectral_tpu_torch.models.vit import (
        VisionTransformer, extract_patch_keys, get_model_config)
    from deep_spectral_tpu_torch.parallel.mesh import MODEL_AXIS
    from deep_spectral_tpu_torch.parallel.sp_vit import sp_patch_features, sp_vit_forward
    cfg = get_model_config("dino_vits8")
    group = mesh.get_group(MODEL_AXIS)
    sd = random_init_(VisionTransformer(cfg), seed=0).state_dict()
    qkv0 = None
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        model = VisionTransformer(cfg, dtype, "flash")
        model.load_state_dict(sd)
        model.to(dev).eval()
        torch.cuda.synchronize()
        _zero_launches()
        out = sp_vit_forward(mesh, model, x, qkv_block=0, attn_impl="flash")
        keys = sp_patch_features(mesh, model, x, attn_impl="flash")
        torch.cuda.synchronize()
        launches = _launches()
        if f32:  # every hop is kernel 3's f32 build
            _want_launches("13a SP f32 (f32 builds)", _f32_launches(), {
                "flash_attention_lse": launches["flash_attention_lse"]})
        x_norm, keys = _gather_tokens(group, out["x_norm"]), _gather_tokens(group, keys)
        qkv = {n: _gather_tokens(group, out["qkv"][n]) for n in "qkv"}
        T = x_norm.shape[1]
        log(f"[13a] SP-ViT dino_vits8 {SP_IMG}x{SP_IMG} (T={T}) b1 {str(dtype)[6:]} flash hops "
            f"at world {world}: sp_vit_forward + sp_patch_features, launches {launches}")
        _want_launches(f"13a SP {str(dtype)[6:]}", launches, {
            "flash_attention_lse": (2 * cfg.depth - 1) * world, "flash_attention_packed": 0})
        with torch.no_grad():
            ref = model(x, qkv_block=0)
            ref_keys = extract_patch_keys(model, x)
        for name, got, want_t in [("x_norm", x_norm, ref["x_norm"]), ("cls", out["cls"], ref["cls"]),
                                  *((n, qkv[n], ref["qkv"][n]) for n in "qkv"),
                                  ("keys", keys, ref_keys)]:
            _agree(f"13a SP {str(dtype)[6:]} {name} vs the single-card forward", got, want_t,
                   world, f32)
        if world == 1:
            q, k, v = (qkv[n].to(dtype).reshape(1, T, cfg.num_heads, -1) for n in "qkv")
            _hop_gate(f"SP world 1 (one hop, T={T})", q, k, v, None)
            if not f32:
                qkv0 = (q, k, v)
        del model, out, keys, ref, ref_keys, x_norm, qkv
    return qkv0


def _parallel_hops(dev, qkv0) -> None:
    """(b) the ring's multi-hop merge in one process: block 0's q/k/v split
    into HOPS shards of HOP_T tokens (the last of the sequence's shards
    ending in padding rows, the last shard all padding); each query shard
    attends to the K/V shards in its ring order through kernel 3, merged by
    `merge_hops`; against kernel 1 on the whole sequence and the same merge
    over the twin."""
    import torch
    import torch.nn.functional as F
    from deep_spectral_tpu_torch.models.flash_attention import (
        MASK_VALUE, flash_attention_lse, flash_attention_lse_plain, flash_attention_packed)
    from deep_spectral_tpu_torch.parallel.ring_attention import merge_hops
    q, k, v = qkv0
    T = q.shape[1]
    pad = HOPS * HOP_T - T
    shards = [[x[:, i * HOP_T:(i + 1) * HOP_T] for i in range(HOPS)]
              for x in (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))]
    mask = (torch.arange(HOPS * HOP_T, device=dev) < T)[None]
    m_s = [mask[:, i * HOP_T:(i + 1) * HOP_T] for i in range(HOPS)]
    if int(m_s[-2].sum()) != HOP_T - 3 or int(m_s[-1].sum()) != 0:
        raise AssertionError("phase 13b's shards are not the ones described")

    def ring(lse_fn):
        outs, pad_lse = [], []
        for r in range(HOPS):
            o_run = lse_run = None
            for j in range(HOPS):
                s = (r - j) % HOPS
                o_i, lse_i = lse_fn(shards[0][r], shards[1][s], shards[2][s], m_s[s])
                if s == HOPS - 1:
                    pad_lse.append(lse_i)
                if j == 0:
                    o_run, lse_run = o_i.float(), lse_i
                else:
                    o_run, lse_run = merge_hops(o_run, lse_run, o_i, lse_i)
            outs.append(o_run.to(q.dtype))
        return torch.cat(outs, dim=1)[:, :T], pad_lse

    _zero_launches()
    got, pad_lse = ring(flash_attention_lse)
    torch.cuda.synchronize()
    launches = _launches()
    twin, _ = ring(flash_attention_lse_plain)
    whole = flash_attention_packed(q, k, v)
    o_max = whole.float().abs().max().item()
    tol = FLASH_TOL * max(1.0, o_max / 2)
    log(f"[13b] {HOPS} shards of {HOP_T} tokens (the 4th ends in {HOPS * HOP_T - T - HOP_T} "
        f"padding rows, the 5th is padding), {HOPS * HOPS} kernel-3 hops merged in ring "
        f"order: launches {launches}; max |o| {o_max:.3f}")
    _want_launches("13b", launches, {"flash_attention_lse": HOPS * HOPS})
    pad_max = max(x.max().item() for x in pad_lse)
    log(f"[13b] the all-padding shard's hops: lse at most {pad_max:.4e} (MASK_VALUE "
        f"{MASK_VALUE:.4e}), so its merge weight underflows to 0")
    if not pad_max < 0.5 * MASK_VALUE:
        raise AssertionError(f"13b: a padding hop's lse {pad_max} is not near MASK_VALUE")
    _held("13b merged kernel-3 hops vs kernel 1 on the whole sequence",
          (got.float() - whole.float()).abs().max().item(), tol)
    _held("13b merged kernel-3 hops vs the same merge over the twin",
          (got.float() - twin.float()).abs().max().item(), tol)
    _hop_gate(f"13b (q shard 0, K/V shard {HOPS - 2})", shards[0][0],
              shards[1][HOPS - 2], shards[2][HOPS - 2], m_s[HOPS - 2])


def _parallel_ring(dev, mesh, world) -> None:
    """(b) at world > 1: `ring_attention` (its default impl, flash hops on
    the card) over random bf16 q/k/v at T=8465 padded to a multiple of the
    world, the K/V shards rotating by P2P, against kernel 1 on the whole
    sequence."""
    import torch
    import torch.nn.functional as F
    from deep_spectral_tpu_torch.models.flash_attention import flash_attention_packed
    from deep_spectral_tpu_torch.parallel.mesh import MODEL_AXIS, local_rows
    from deep_spectral_tpu_torch.parallel.ring_attention import ring_attention
    group = mesh.get_group(MODEL_AXIS)
    T = 1 + (SP_IMG // 8) ** 2
    pad = -T % world
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((1, T, 6, 64), generator=g).to(dev, torch.bfloat16) for _ in range(3))
    mask = (torch.arange(T + pad, device=dev) < T)[None]
    ql, kl, vl = (local_rows(group, F.pad(t, (0, 0, 0, 0, 0, pad)), dim=1) for t in (q, k, v))
    ml = local_rows(group, mask, dim=1)
    _zero_launches()
    o = ring_attention(mesh, ql, kl, vl, ml)
    torch.cuda.synchronize()
    launches = _launches()
    _want_launches("13b ring", launches, {"flash_attention_lse": world})
    o = _gather_tokens(group, o)[:, :T]
    whole = flash_attention_packed(q, k, v)
    _held(f"13b ring attention T={T} at world {world} vs kernel 1 on the whole sequence",
          (o.float() - whole.float()).abs().max().item(),
          FLASH_TOL * max(1.0, whole.float().abs().max().item() / 2))
    log(f"[13b] ring attention T={T} at world {world} (shards of {ql.shape[1]}): launches "
        f"{launches}")


def _parallel_pp(dev, mesh, sd16, cfg16, world) -> None:
    """(c) PP over `world` stages: dino_vits16 480x480 b8 bf16 in 4
    microbatches of 2 (kernel 1 at b2 T=901), each rank holding its blocks
    only, against the single-card forward of b8."""
    import torch
    from deep_spectral_tpu_torch.models.vit import VisionTransformer
    from deep_spectral_tpu_torch.parallel.pp_vit import build_stage, pp_vit_forward
    stage = build_stage(cfg16, sd16, mesh, compute_dtype=torch.bfloat16, attention_impl="flash",
                        device=dev)
    x = torch.from_numpy(np.random.default_rng(31).standard_normal(
        (PP_B, IMG, IMG, 3)).astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    _zero_launches()
    out = pp_vit_forward(mesh, stage, x, n_microbatches=PP_M)
    torch.cuda.synchronize()
    launches = _launches()
    full = VisionTransformer(cfg16, torch.bfloat16, "flash")
    full.load_state_dict(sd16)
    full.to(dev).eval()
    params, n_full = (sum(p.numel() for p in m.parameters()) for m in (stage, full))
    log(f"[13c] PP dino_vits16 {IMG}x{IMG} b{PP_B} bf16 flash, {world} stage(s) of "
        f"{cfg16.depth // world} blocks, {PP_M} microbatches: launches {launches} (kernel 1 at "
        f"b{PP_B // PP_M} T={out['x_norm'].shape[1]}); {params} of {n_full} parameters on a "
        f"rank")
    _want_launches("13c PP", launches, {"flash_attention_packed": cfg16.depth // world * PP_M})
    if world > 1 and not params < n_full:
        raise AssertionError("13c: a PP rank holds every block")
    with torch.no_grad():
        ref = full(x)
    _agree(f"13c PP x_norm vs the single-card b{PP_B} forward", out["x_norm"], ref["x_norm"],
           world)


def _parallel_sharded(dev, world, sd16, cfg16) -> None:
    """(d) DP patch features on a data mesh of `world`, TP x DP patch
    features on a (world / tp, tp) mesh (tp 2 at an even world, else 1),
    and DP eigs, at phase 4's b24 shape, the rows gathered, against the
    single-device functions; the row-sharded LOBPCG at N=4096 against dense
    eigh, every rank's eigenpairs the same bits."""
    import torch
    from deep_spectral_tpu_torch.models.vit import VisionTransformer, extract_patch_keys
    from deep_spectral_tpu_torch.ops.affinity import feature_affinity
    from deep_spectral_tpu_torch.ops.eigen import spectral_decompose_batched
    from deep_spectral_tpu_torch.parallel.mesh import (
        DATA_AXIS, MODEL_AXIS, gather_rows, local_rows, make_mesh)
    from deep_spectral_tpu_torch.parallel.sharded import (
        row_sharded_laplacian_eigs, sharded_patch_features, sharded_spectral_decompose,
        tp_sharded_patch_features)
    tp = 2 if world % 2 == 0 else 1
    dmesh = make_mesh(axes=[(DATA_AXIS, world)])
    mesh2 = make_mesh(axes=[(DATA_AXIS, world // tp), (MODEL_AXIS, tp)])
    data, data2 = dmesh.get_group(DATA_AXIS), mesh2.get_group(DATA_AXIS)
    model = VisionTransformer(cfg16, torch.bfloat16, "flash")
    model.load_state_dict(sd16)
    model.to(dev).eval()
    rng = np.random.default_rng(41)
    grid = IMG // cfg16.patch_size
    x = torch.from_numpy(rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)).to(dev)
    mask = torch.ones((B, grid * grid), dtype=torch.bool, device=dev)
    ref = extract_patch_keys(model, x, token_mask=mask)
    for path, group, fn in (
            ("dp", data, lambda: sharded_patch_features(dmesh, model, local_rows(data, x),
                                                        local_rows(data, mask))),
            ("tp", data2, lambda: tp_sharded_patch_features(mesh2, model, local_rows(data2, x),
                                                            local_rows(data2, mask)))):
        torch.cuda.synchronize()
        _zero_launches()
        keys = gather_rows(group, fn())
        torch.cuda.synchronize()
        launches = _launches()
        what = "DP" if path == "dp" else f"TP x DP ({world // tp} x {tp})"
        log(f"[13d] {what} patch features b{B} T={1 + grid * grid} bf16 at world {world}: "
            f"launches {launches}")
        _want_launches(f"13d {path}", launches, {"flash_attention_packed": cfg16.depth - 1})
        _agree(f"13d {what} patch features vs extract_patch_keys", keys, ref, world)
    feats = torch.from_numpy(structured_features(B, grid, cfg16.embed_dim, rng)).to(dev) \
        + 0.02 * ref.float()
    torch.cuda.synchronize()
    _zero_launches()
    evals, vecs = sharded_spectral_decompose(dmesh, local_rows(data, feats),
                                             local_rows(data, mask), K=K)
    torch.cuda.synchronize()
    eig_launches = _launches()
    ev1, vec1 = spectral_decompose_batched(feats, mask, K=K)
    err = (evals - ev1).abs().max().item()
    cos = min(subspace_cos(vecs[i], vec1[i]) for i in range(B))
    same = torch.equal(evals, ev1) and torch.equal(vecs, vec1)
    log(f"[13d] DP spectral decompose b{B} N={grid * grid} K={K} at world {world}: launches "
        f"{eig_launches}; vs spectral_decompose_batched bit-equal: {same}, max |eigenvalue "
        f"diff| {err:.3e} (tol {EIG_TOL}), least subspace cosine {cos:.6f} (min "
        f"{SUBSPACE_MIN})")
    if eig_launches["chebyshev_filter"] <= 0 or (world == 1 and not same) or \
            not (err <= EIG_TOL and cos >= SUBSPACE_MIN):
        raise AssertionError(f"13d DP eigs: launches {eig_launches}, equal {same}, {err}, {cos}")
    dense_gates("13d DP spectral decompose", feats, mask, evals, vecs)
    rmesh = make_mesh(axes=[(MODEL_AXIS, world)])
    rows = rmesh.get_group(MODEL_AXIS)
    f1 = torch.from_numpy(structured_features(1, ROW_GRID, cfg16.embed_dim, rng)).to(dev)
    W = feature_affinity(f1)[0]
    W_l = local_rows(rows, W)
    evals, vecs = row_sharded_laplacian_eigs(rmesh, W_l, K)
    every = gather_rows(rows, torch.cat([evals, vecs.reshape(-1)])[None])
    same = bool((every == every[0]).all())
    log(f"[13d] row-sharded LOBPCG N={ROW_GRID ** 2} K={K} at world {world}: every rank's "
        f"eigenpairs the same bits: {same}")
    if not same:
        raise AssertionError("13d: the ranks' row-sharded eigenpairs differ")
    dense_gates("13d row-sharded LOBPCG", f1, torch.ones((1, ROW_GRID ** 2), dtype=torch.bool,
                                                         device=dev),
                evals[None], vecs[None], n=1)


def _parallel_train(dev, world) -> None:
    """(e) one data-parallel 7b step, each rank on its rows of the b144
    batch, against the plain step on the whole batch from the same state
    (both under torch.use_deterministic_algorithms): at world 1 every
    gradient within GRAD_REL_TOL; at world > 1 the loss within 1e-3 and
    every rank's trained parameters the same bits (the gradients'
    difference is recorded: bf16 rounding at b36 moves them)."""
    import warnings
    import torch
    from deep_spectral_tpu_torch.models.deeplab import DeepLabViT
    from deep_spectral_tpu_torch.models.vit import get_model_config
    from deep_spectral_tpu_torch.parallel.mesh import DATA_AXIS, gather_rows, local_rows, make_mesh
    from deep_spectral_tpu_torch.tasks import semantic_segmentation as SS
    group = make_mesh(axes=[(DATA_AXIS, world)]).get_group(DATA_AXIS)
    x_np, y_np = blob_batch(TRAIN_B, np.random.default_rng(7))
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
    grads, launches, dp_state = {}, None, None
    for data_parallel in (False, True):
        cfg = SS.TrainConfig(backbone="dino_vits16", num_classes=CLASSES, lr=5e-3,
                             batch_size=TRAIN_B, unfrozen_backbone_layers=1, precision="bf16",
                             seed=0)
        model = DeepLabViT(get_model_config("dino_vits16"), CLASSES,
                           compute_dtype=torch.bfloat16, attention_impl="flash")
        state = SS.create_train_state(cfg, model, device=dev)
        xs, ys = (local_rows(group, x), local_rows(group, y)) if data_parallel else (x, y)
        if data_parallel:
            SS.make_data_parallel(state, group)
        torch.cuda.synchronize()
        _zero_launches()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # cuBLAS's determinism notice
                loss = SS.train_step(state, xs, ys, torch.Generator(device=dev).manual_seed(21))
                torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        if data_parallel:
            launches, dp_state = _launches(), state
        grads[data_parallel] = ({n: p.grad.detach().float().clone()
                                 for n, p in state.opt.params.items()}, float(loss["loss"]))
    equal, rel, differ = _grad_diff(grads[False][0], grads[True][0])
    losses = (grads[True][1], grads[False][1])
    flat = torch.cat([p.detach().float().reshape(-1)[:4096]
                      for p in dp_state.opt.params.values()])
    same = bool((gather_rows(group, flat[None]) == flat).all())
    log(f"[13e] one data-parallel 7b step (b{TRAIN_B} over {world} rank(s)) vs the plain step, "
        f"under deterministic algorithms: launches {launches}; {equal} of {len(grads[False][0])} "
        f"gradients bit-equal, max rel diff {rel:.3e} "
        f"({f'tol {GRAD_REL_TOL}' if world == 1 else 'recorded'}); loss {losses[0]:.6f} vs "
        f"{losses[1]:.6f}; every rank's trained parameters the same bits: {same}")
    _want_launches("13e", launches, {n: 1 for n in ("flash_attention_lse", "flash_bwd_dkv",
                                                    "flash_bwd_dq")})
    if (world == 1 and rel > GRAD_REL_TOL) or not same or \
            not math.isclose(losses[0], losses[1], rel_tol=1e-3):
        raise AssertionError(f"13e: max rel diff {rel}, losses {losses}, same {same}")


def _parallel_loop(dev, world: int, root: Path) -> None:
    """(f) at world > 1: `train()` data-parallel over a data mesh of `world`
    for LOOP_STEPS steps of the 7b configuration, each rank's producer
    threads decoding its rows of every batch from `make_voc`'s JPEG tree in
    `root`: every step's loss finite (rank 0 prints them), the state at
    step LOOP_STEPS with finite parameters, every rank's parameters the
    same bits, and kernels 3-5 once a step on every rank."""
    import torch
    import torch.distributed as dist
    from deep_spectral_tpu_torch.parallel.mesh import DATA_AXIS, gather_rows, make_mesh
    from deep_spectral_tpu_torch.tasks import semantic_segmentation as SS
    cfg = SS.TrainConfig(backbone="dino_vits16", num_classes=CLASSES, lr=5e-3,
                         batch_size=TRAIN_B, unfrozen_backbone_layers=1, precision="bf16",
                         seed=0)
    ds = SS.VOCSegmentationWithPseudolabels(str(root), "train", str(root / "pseudo"))
    mesh = make_mesh(axes=[(DATA_AXIS, world)])
    _zero_launches()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        state, _ = SS.train(cfg, ds, log_every=1, max_steps=LOOP_STEPS, device=dev, mesh=mesh)
    launches = _launches()
    losses = [float(v) for v in re.findall(r"^step \d+: loss=(\S+) ", printed.getvalue(), re.M)]
    flat = torch.cat([p.detach().float().reshape(-1)[:4096] for p in state.opt.params.values()])
    same = bool((gather_rows(mesh.get_group(DATA_AXIS), flat[None]) == flat).all())
    log(f"[13f] train() 7b (b{TRAIN_B}, {cfg.num_workers} producer threads a rank, {len(ds)} "
        f"JPEGs) data-parallel at world {world}: {int(state.step)} steps, losses "
        f"{' '.join(f'{v:.4f}' for v in losses)}; launches {launches}; every rank's "
        f"parameters the same bits: {same}")
    _want_launches("13f", launches, {n: LOOP_STEPS for n in (
        "flash_attention_lse", "flash_bwd_dkv", "flash_bwd_dq")})
    if int(state.step) != LOOP_STEPS or not same or not bool(torch.isfinite(flat).all()) or \
            (dist.get_rank() == 0 and (len(losses) != LOOP_STEPS or not all(np.isfinite(losses)))):
        raise AssertionError(f"13f: step {int(state.step)}, losses {losses}, same {same}")


def phase_parallel(dev, world: int = 1, rank: int = 0, port: int = 0,
                   root: Path | None = None) -> None:
    """Phase 13: the parallel paths on the card in one NCCL group of
    `world` ranks, this process being `rank` (world 1 with no arguments:
    NCCL takes one rank per card). At world > 1 also `train()`'s loop over
    the VOC tree in `root`."""
    import socket
    import torch
    import torch.distributed as dist
    from deep_spectral_tpu_torch.models.convert import random_init_
    from deep_spectral_tpu_torch.models.vit import VisionTransformer, get_model_config
    from deep_spectral_tpu_torch.parallel import distributed as pdist
    from deep_spectral_tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh
    if not port:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
    pdist.initialize(f"tcp://localhost:{port}", world, rank)
    try:
        backend = dist.get_backend()
        probe = torch.full((4,), 2.0, device=dev)
        dist.all_reduce(probe)
        gathered = [torch.empty_like(probe) for _ in range(world)]
        dist.all_gather(gathered, probe)
        dist.broadcast(probe, 0)
        ran = probe.tolist() == [2.0 * world] * 4 and \
            all(g.tolist() == [2.0 * world] * 4 for g in gathered)
        log(f"[13] process group: backend {backend}, world {dist.get_world_size()}, device "
            f"{probe.device}; all_reduce / all_gather / broadcast on the card: {ran}")
        if backend != "nccl" or not ran:
            raise AssertionError(f"phase 13's group is {backend}, collectives {ran}")
        mesh = make_mesh(axes=[(MODEL_AXIS, world)])
        x = torch.from_numpy(np.random.default_rng(30).standard_normal(
            (1, SP_IMG, SP_IMG, 3)).astype(np.float32)).to(dev)
        qkv0 = _parallel_sp(dev, mesh, x, world)
        if world == 1:
            _parallel_hops(dev, qkv0)
        else:
            _parallel_ring(dev, mesh, world)
        cfg16 = get_model_config("dino_vits16")
        sd16 = random_init_(VisionTransformer(cfg16), seed=0).state_dict()
        _parallel_pp(dev, mesh, sd16, cfg16, world)
        _parallel_sharded(dev, world, sd16, cfg16)
        _parallel_train(dev, world)
        if world > 1:
            _parallel_loop(dev, world, root)
    finally:
        dist.destroy_process_group()


def _parallel_rank(rank: int, world: int, port: int, root: str) -> None:
    """One rank of `chip_smoke.py 13 --world N` (rank 0 alone prints)."""
    import torch
    if rank:
        sys.stdout = open(os.devnull, "w")
    phase_parallel(torch.device("cuda", rank), world, rank, port, Path(root))


def run_parallel(world: int) -> None:
    """Phase 13 at world N, one process a card: the kernels built here
    first, 13f's VOC tree made here for every rank."""
    import socket
    import torch
    import torch.multiprocessing as mp
    if world > torch.cuda.device_count():
        raise SystemExit(f"world {world} needs {world} cards; {torch.cuda.device_count()} here")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        make_voc(Path(tmp))
        mp.spawn(_parallel_rank, args=(world, port, tmp), nprocs=world, join=True)


def main(argv: list) -> int:
    """Every phase, then the result line. With arguments, the build and then
    only what they name, and no result line: phase 12 and phase 13 ('12',
    '13'); with '--world N', phase 13 at world N, one process a card."""
    import torch
    only, world = list(argv), 1
    if "--world" in only:
        i = only.index("--world")
        world = int(only[i + 1])
        del only[i:i + 2]
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    if only == ["3c"]:  # the built library is already there: no rebuild
        phase_cheb_launches(dev)
        log("partial run (phase 3c): no result line")
        return 0
    phase_build()
    if only:
        if "12" in only:
            with tempfile.TemporaryDirectory() as tmp:
                phase_12(Path(tmp), dev)
        if "4d" in only:
            phase_dinov3_kernels(dev)
            phase_dinov3_main_path(dev)
        if "4e" in only:
            phase_sam_kernels(dev)
            phase_sam_main_path(dev)
        if "13" in only:
            if world > 1:
                run_parallel(world)
            else:
                phase_parallel(dev)
        log(f"partial run (phases 1 and {only}, world {world}): no result line")
        return 0
    flash_err = phase_flash(dev)
    cheb_err = phase_cheb(dev)
    launches, eigh_err = phase_main_path(dev)
    hd128_err, rope_err = phase_dinov3_kernels(dev)
    dinov3_launches = phase_dinov3_main_path(dev)
    hd80_err = phase_sam_kernels(dev)
    sam_launches = phase_sam_main_path(dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli(Path(tmp), "cuda")
    train_errs = phase_train_kernels(dev)
    train_launches = phase_train(dev)
    fp32_launches = phase_train_fp32(dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_train_cli(Path(tmp))
    phase_stage2_routes(dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_localization(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        phase_segments(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        phase_12(Path(tmp), dev)
    phase_parallel(dev)
    sub = subprocess.run([sys.executable, str(Path(__file__).resolve()), "3c"],
                         capture_output=True, text=True)
    log(sub.stdout.strip().splitlines()[-2] if sub.stdout.strip() else "[3c] no output")
    if sub.returncode != 0:
        raise AssertionError(f"chip_smoke.py 3c failed ({sub.returncode}):\n{sub.stdout}\n"
                             f"{sub.stderr[-3000:]}")
    jax_modules = [m for m in sys.modules if m.split(".")[0] in ("jax", "deep_spectral_tpu")]
    if jax_modules:
        raise AssertionError(f"the port imported JAX or the JAX package: {jax_modules[:5]}")
    log("[13] no module of jax or of the JAX package was imported")
    kernels = {
        "flash_attention_packed": {"launches": launches["flash"], "max_abs_err": flash_err},
        "flash_attention_packed_hd128": {"launches": dinov3_launches["flash"],
                                         "max_abs_err": hd128_err},
        "apply_rope_": {"launches": dinov3_launches["rope"], "max_abs_err": rope_err},
        "flash_attention_packed_hd80": {"launches": sam_launches, "max_abs_err": hd80_err},
        "chebyshev_filter": {"launches": launches["cheb"], "max_abs_err": cheb_err},
        "small_eigh": {"launches": launches["eigh"], "max_eps_norm": eigh_err},
        **{name: {"launches": train_launches[name], "max_abs_err": train_errs[name]}
           for name in ("flash_attention_lse", "flash_bwd_dkv", "flash_bwd_dq")},
        **{f"{name}_f32": {"launches": fp32_launches[name],
                           "max_abs_err": train_errs[f"{name}_f32"]}
           for name in ("flash_attention_lse", "flash_bwd_dkv", "flash_bwd_dq")}}
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}, "kernels": kernels}))
    return 0


if __name__ == "__main__":
    try:
        import deep_spectral_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not next to this script ({exc})",
              file=sys.stderr)
        sys.exit(1)
    sys.exit(main(sys.argv[1:]))
