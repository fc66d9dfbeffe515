#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`deep_spectral_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. print the card's name and power limit; build the CUDA kernels from
     `deep_spectral_tpu_torch/csrc/` (nvcc) and print the build time;
  2. flash-attention kernel vs its plain twin: at the main path's shape (b24,
     T=901, H=6, hd=64, q/k/v read from the fused qkv layout) and at T=3601,
     with a ragged mask and one all-masked batch row;
  3. Chebyshev-filter kernel vs its plain twin: b24 N=900 m=8 at degree 10
     with per-image (c, e) and at degree 3 with (2, 1), and N=3600 (the
     global-scratch path);
  4. the main path: a seeded random-weight dino_vits16 at 480x480, b24, bf16:
     `extract_patch_keys`, then `spectral_decompose_batched(K=5)` on
     structured features (base + 0.02 * k, rejection-sampled so that every
     graph converges); both kernels' launch counts must be > 0, every residual
     <= CHEB_RESIDUAL_TOL, and the eigenpairs must agree with dense eigh;
  5. stages 1-2 through `python -m deep_spectral_tpu_torch.pipeline` on six
     synthetic images (480x480 and 320x480) in a temporary directory, with the
     `.pth` schema checked.
Then it prints one JSON line with each kernel's launches, error and times, the
card's name and power limit, and, last, {"ok": true, "device": {...}}.
It exits non-zero, without that last line, if CUDA is missing or any phase
fails. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
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


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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


def phase_build():
    from deep_spectral_tpu_torch import _build
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.load()
    log(f"[1] built {_build.last_build['path']} from "
        f"{[p.name for p in _build._sources()]} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {_build.last_build['seconds']:.1f} s)")
    for line in _build.last_build["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"    ptxas: {line.strip()}")


def phase_flash(dev) -> dict:
    import torch
    from deep_spectral_tpu_torch.models.flash_attention import (
        flash_attention_packed, flash_attention_packed_plain)
    g = torch.Generator().manual_seed(1)
    worst, main_times = 0.0, None
    for (b, T, ragged) in [(B, 901, False), (B, 901, True), (4, 3601, True)]:
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
        times = (cuda_ms(lambda: flash_attention_packed(q, k, v, mask)),
                 cuda_ms(lambda: flash_attention_packed_plain(q, k, v, mask)))
        log(f"[2] flash b{b} T={T} H=6 hd=64 bf16 ragged={ragged}: max |kernel - twin| "
            f"on valid rows {err:.3e} (tol {FLASH_TOL}); kernel {times[0]:.4f} ms, "
            f"twin {times[1]:.4f} ms (CUDA events, mean of 20)")
        if (b, T, ragged) == (B, 901, False):
            main_times = times
    return {"max_abs_err": worst, "ms": main_times[0], "plain_ms": main_times[1]}


def whitened_operators(b: int, N: int, dev, g):
    import torch
    from deep_spectral_tpu_torch.ops.affinity import degree_vector, feature_affinity
    W = feature_affinity(torch.randn((b, N, 64), generator=g).to(dev))
    s = torch.rsqrt(degree_vector(W))
    return (s[:, :, None] * W * s[:, None, :]).to(torch.bfloat16)


def phase_cheb(dev) -> dict:
    import torch
    from deep_spectral_tpu_torch.ops.cheb_filter import (
        chebyshev_filter, chebyshev_filter_plain)
    g = torch.Generator().manual_seed(2)
    worst, main_times = 0.0, None
    for (b, N, degree, window) in [(B, 900, 10, "per-image"), (B, 900, 3, "(2, 1)"),
                                   (2, 3600, 10, "per-image")]:
        S = whitened_operators(b, N, dev, g)
        X = torch.randn((b, N, 8), generator=g).to(dev)
        if window == "(2, 1)":
            c, e = 2.0, 1.0
        else:
            lam_cut = (torch.rand(b, generator=g) * 0.9 + 0.05).to(dev)
            c, e = (lam_cut + 2.0) / 2.0, (2.0 - lam_cut) / 2.0
        out = chebyshev_filter(S, X, c, e, degree)
        torch.cuda.synchronize()
        ref = chebyshev_filter_plain(S, X, c, e, degree)
        err = (out - ref).abs().max().item()
        if not np.isfinite(err) or err > CHEB_TOL:
            raise AssertionError(f"cheb kernel disagrees with its twin: {err}")
        worst = max(worst, err)
        times = (cuda_ms(lambda: chebyshev_filter(S, X, c, e, degree)),
                 cuda_ms(lambda: chebyshev_filter_plain(S, X, c, e, degree)))
        log(f"[3] cheb b{b} N={N} m=8 degree={degree} (c, e) {window}: max "
            f"|kernel - twin| {err:.3e} (tol {CHEB_TOL}); kernel {times[0]:.4f} ms, "
            f"twin {times[1]:.4f} ms (CUDA events, mean of 20)")
        if (b, N, degree) == (B, 900, 10):
            main_times = times
    return {"max_abs_err": worst, "ms": main_times[0], "plain_ms": main_times[1]}


def subspace_cos(V1, V2) -> float:
    import torch
    Q1, _ = torch.linalg.qr(V1.double().T)
    Q2, _ = torch.linalg.qr(V2.double().T)
    return torch.linalg.svdvals(Q1.T @ Q2).min().item()


def phase_main_path(dev) -> dict:
    import torch
    from deep_spectral_tpu_torch.models.convert import random_init_
    from deep_spectral_tpu_torch.models.flash_attention import flash_attention_packed
    from deep_spectral_tpu_torch.models.vit import (
        VisionTransformer, extract_patch_keys, get_model_config)
    from deep_spectral_tpu_torch.ops.cheb_filter import chebyshev_filter
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

    flash_attention_packed.launches = 0
    chebyshev_filter.launches = 0
    n_steps = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_steps):
        out = step(base)
    end.record()
    end.synchronize()
    launches = {"flash": flash_attention_packed.launches,
                "cheb": chebyshev_filter.launches}
    ms = start.elapsed_time(end) / n_steps
    k, feats, evals, vecs, res = out
    log(f"[4] main path dino_vits16 {IMG}x{IMG} b{B} bf16 K={K}: {ms:.3f} ms/step = "
        f"{B / ms * 1e3:.2f} img/s (CUDA events, mean of {n_steps} steps); "
        f"launches over the {n_steps} steps: {launches}")
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
        t0 = time.perf_counter()
        proc = subprocess.run(cli + args, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        log(f"[5] {args[0]}: rc {proc.returncode} in {time.perf_counter() - t0:.1f} s")
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    phase_build()
    flash = phase_flash(dev)
    cheb = phase_cheb(dev)
    launches = phase_main_path(dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli(Path(tmp), "cuda")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    kernels = [
        {"name": "flash_attention_packed", "route": "cuda",
         "source": "deep_spectral_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "deep_spectral_tpu/models/flash_attention.py:193",
         "launches": launches["flash"], **flash},
        {"name": "chebyshev_filter", "route": "cuda",
         "source": "deep_spectral_tpu_torch/csrc/cheb_filter.cu",
         "replaces": "deep_spectral_tpu/ops/cheb_filter.py:74",
         "launches": launches["cheb"], **cheb},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        import deep_spectral_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not next to this script ({exc})",
              file=sys.stderr)
        sys.exit(1)
    sys.exit(main())
