"""The port's CUDA kernels against their plain twins, and the port's GPU
paths against its CPU paths. Every test needs an NVIDIA GPU and skips
without one. This file imports neither jax nor the JAX package, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: flash outputs are bf16 of magnitude <~2 (ulp 2^-7) and the
kernel rounds p to bf16 at running maxima where the twin uses the row max:
1.6e-2. Filter outputs satisfy |T_d| <= 1 after the rescale; the summation
order differs and a last-bit change can flip one bf16(T_j) rounding
downstream: 1e-3. Solver results: eigenvalues 1e-4, |cosine| >= 0.999.
"""
import numpy as np
import pytest
import torch

from deep_spectral_tpu_torch.models.flash_attention import (
    flash_attention_packed, flash_attention_packed_plain)
from deep_spectral_tpu_torch.ops import affinity as ta
from deep_spectral_tpu_torch.ops import eigen as te
from deep_spectral_tpu_torch.ops.cheb_filter import (chebyshev_filter,
                                                     chebyshev_filter_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _ragged_mask(B, T):
    mask = torch.ones((B, T), dtype=torch.bool)
    mask[0, T - 37:] = False        # ragged end
    mask[1, :] = False              # a batch row with no valid key
    mask[2, : T // 3] = False       # masked start
    return mask


@pytest.mark.parametrize("T", [77, 901, 3601])
def test_flash_kernel_matches_twin(cuda, T):
    """q/k/v as strided views into a fused (B, T, 3, H, hd) projection."""
    g = torch.Generator().manual_seed(T)
    qkv = torch.randn((3, T, 3, 6, 64), generator=g).to(cuda, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    mask = _ragged_mask(3, T).to(cuda)
    before = flash_attention_packed.launches
    out = flash_attention_packed(q, k, v, mask)
    torch.cuda.synchronize()
    assert flash_attention_packed.launches == before + 1
    assert out.shape == q.shape and out.is_contiguous()
    ref = flash_attention_packed_plain(q, k, v, mask)
    valid = mask.any(dim=1)
    assert (out[valid].float() - ref[valid].float()).abs().max().item() <= 1.6e-2
    assert out[1].abs().max().item() == 0.0
    full = flash_attention_packed(q, k, v)
    ref_full = flash_attention_packed_plain(q, k, v)
    assert (full.float() - ref_full.float()).abs().max().item() <= 1.6e-2


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention_packed(x, x, x)
    y = torch.zeros((1, 8, 2, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention_packed(y, y, y)
    z = torch.zeros((1, 8, 2, 65), device=cuda, dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError):
        flash_attention_packed(z, z, z)


def test_vit_runs_the_flash_kernel(cuda):
    """A bf16 ViT on CUDA goes through the kernel and stays close to the same
    model's plain path on the CPU (per-token cosine >= 0.99, bf16)."""
    from deep_spectral_tpu_torch.models.convert import random_init_
    from deep_spectral_tpu_torch.models.vit import (VisionTransformer, ViTConfig,
                                                    extract_patch_keys)
    model = random_init_(VisionTransformer(ViTConfig(16, 128, 2, 2, img_size=64),
                                           torch.bfloat16), seed=0)
    x = torch.randn((2, 96, 80, 3), generator=torch.Generator().manual_seed(0))
    mask = torch.ones((2, 30), dtype=torch.bool)
    mask[1, 20:] = False
    ref = extract_patch_keys(model, x, token_mask=mask).float()
    before = flash_attention_packed.launches
    got = extract_patch_keys(model.to(cuda), x.to(cuda), token_mask=mask.to(cuda))
    assert flash_attention_packed.launches > before
    cos = torch.nn.functional.cosine_similarity(got.float().cpu(), ref, dim=-1)
    assert cos[mask].min().item() >= 0.99


def test_fp32_vit_on_cuda_raises(cuda):
    """The kernel is bf16 only: an fp32 model on CUDA raises rather than
    running the plain attention on the card."""
    from deep_spectral_tpu_torch.models.convert import random_init_
    from deep_spectral_tpu_torch.models.vit import (VisionTransformer, ViTConfig,
                                                    extract_patch_keys)
    model = random_init_(VisionTransformer(ViTConfig(16, 128, 2, 2, img_size=64)),
                         seed=0).to(cuda)
    with pytest.raises(TypeError, match="bf16"):
        extract_patch_keys(model, torch.zeros((1, 64, 64, 3), device=cuda))


def _operators(B, N, seed):
    g = torch.Generator().manual_seed(seed)
    W = ta.feature_affinity(torch.randn((B, N, 32), generator=g))
    s = torch.rsqrt(ta.degree_vector(W))
    return (s[:, :, None] * W * s[:, None, :]).to(torch.bfloat16), g


@pytest.mark.parametrize("N,m,degree", [(900, 8, 10), (333, 13, 3), (2500, 8, 10)])
def test_cheb_kernel_matches_twin(cuda, N, m, degree):
    """Shared-memory (N * 112 B fits) and global-scratch paths, m not a
    multiple of 8."""
    S, g = _operators(2, N, N)
    S = S.to(cuda)
    X = torch.randn((2, N, m), generator=g).to(cuda)
    c, e = torch.tensor([1.5, 1.9], device=cuda), torch.tensor([0.5, 0.1], device=cuda)
    before = chebyshev_filter.launches
    got = chebyshev_filter(S, X, c, e, degree)
    torch.cuda.synchronize()
    assert chebyshev_filter.launches == before + 1
    ref = chebyshev_filter_plain(S, X, c, e, degree)
    assert (got - ref).abs().max().item() <= 1e-3


def _smooth_features(rng, h, w, d=64):
    """Image-like features: low-frequency spatial modes plus an object blob."""
    yy, xx = np.mgrid[:h, :w] / h
    base = np.zeros((h, w, d), np.float32)
    for _ in range(6):
        fy, fx = rng.uniform(0.5, 3, 2)
        ph = rng.uniform(0, 2 * np.pi)
        base += np.sin(2 * np.pi * (fy * yy + fx * xx) + ph)[..., None] * \
            rng.standard_normal(d).astype(np.float32)
    cy, cx = rng.integers(6, h - 6), rng.integers(6, w - 6)
    blob = ((np.mgrid[:h, :w][0] - cy) ** 2 + (np.mgrid[:h, :w][1] - cx) ** 2) < 25
    base[blob] += 3 * rng.standard_normal(d).astype(np.float32)
    return base.reshape(-1, d)


@pytest.mark.parametrize("window_init", ["wide", "estimate"])
def test_solver_on_cuda_matches_cpu(cuda, window_init):
    feats = torch.from_numpy(np.stack([_smooth_features(np.random.default_rng(s), 30, 30)
                                       for s in (7, 8, 9)]))
    kw = dict(K=5, return_residual=True, cheb_window_init=window_init)
    ev, vec, res = te.spectral_decompose_batched(feats, **kw)
    before = chebyshev_filter.launches
    ev_g, vec_g, res_g = te.spectral_decompose_batched(feats.to(cuda), **kw)
    assert chebyshev_filter.launches > before
    assert res_g.max().item() <= te.CHEB_RESIDUAL_TOL
    np.testing.assert_allclose(ev_g.cpu().numpy(), ev.numpy(), atol=1e-4)
    a, b = vec_g.cpu().double(), vec.double()
    cos = (a * b).sum(-1).abs() / (a.norm(dim=-1) * b.norm(dim=-1))
    assert cos.min().item() > 0.999
