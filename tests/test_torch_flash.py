"""The port's flash-attention twin against the JAX package's packed Pallas
kernel (interpret mode, blocks of 128) and its einsum reference, with ragged
masks and an all-masked batch row. (The CUDA kernel against the twin:
tests/test_torch_cuda.py.)

Tolerances: f32 inputs agree to 2e-5 (online vs one-pass softmax differ only
in f32 rounding); bf16 inputs to 1.6e-2 (outputs of magnitude ~1 carry a bf16
ulp of 2^-7..2^-8, and the online kernel rounds p to bf16 relative to running
maxima where the twin uses the row max).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_spectral_tpu.models.flash_attention import (_einsum_attention,
                                                      _flash_forward_packed)
from deep_spectral_tpu_torch.models.flash_attention import (
    flash_attention_packed, flash_attention_packed_plain)


def _inputs(B, T, H, hd, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, T), bool)
    mask[0, T - 37:] = False        # ragged end inside a 128-row block
    mask[1, :] = False              # a batch row with no valid key
    mask[2, : T // 3] = False       # masked start
    return q, k, v, mask


@pytest.mark.parametrize("T,dtype,tol", [(200, "float32", 2e-5), (256, "bfloat16", 1.6e-2)])
def test_twin_matches_pallas_packed(T, dtype, tol):
    B, H, hd = 3, 2, 64
    q, k, v, mask = _inputs(B, T, H, hd)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(_flash_forward_packed(
        *(jnp.asarray(x, jd) for x in (q, k, v)), jnp.asarray(mask), num_heads=H,
        block_q=128, block_k=128, interpret=True), np.float32)
    got = flash_attention_packed_plain(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                                       torch.from_numpy(mask))
    assert got.dtype == td and got.shape == (B, T, H, hd)
    got = got.float().numpy()
    valid = mask.any(axis=1)
    np.testing.assert_allclose(got[valid], ref[valid], atol=tol)
    assert not got[~valid].any() and not ref[~valid].any()  # no valid key -> 0
    if dtype == "float32":
        t = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3))
        ein = np.asarray(_einsum_attention(t(q), t(k), t(v), jnp.asarray(mask)))
        np.testing.assert_allclose(got[valid], ein.transpose(0, 2, 1, 3)[valid], atol=tol)


def test_wrapper_on_cpu_is_the_twin():
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(3, 40, 2, 16, seed=1))
    before = flash_attention_packed.launches
    got = flash_attention_packed(q, k, v, mask)
    assert flash_attention_packed.launches == before
    assert torch.equal(got, flash_attention_packed_plain(q, k, v, mask))
    assert torch.equal(flash_attention_packed(q, k, v, None),
                       flash_attention_packed_plain(q, k, v, torch.ones(3, 40, dtype=torch.bool)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Parallel test workers each get one torch thread: with torch's default
    (all cores) per worker, the workers oversubscribe the CPU many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
