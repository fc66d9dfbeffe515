"""The port's flash-attention twins against the JAX package's Pallas kernels
(interpret mode) and its einsum reference, with ragged masks and an
all-masked batch row, and the autograd function over them. (The CUDA
kernels against the twins: tests/test_torch_cuda.py.)

Tolerances: f32 inputs agree to 2e-5 (online vs one-pass softmax differ only
in f32 rounding; 1e-5 for the residual-saving forward, whose JAX reference
runs one key block); bf16 inputs to 1.6e-2 (outputs of magnitude ~1 carry a
bf16 ulp of 2^-7..2^-8, and the online kernel rounds p to bf16 relative to
running maxima where the twin uses the row max). The backward twin is held
to the JAX package's own backward test tolerance (atol 2e-3, rtol 1e-3).
The torch renderings of the bf16 Hopper kernels' arithmetic (kernel 3's
exp2-domain lse, kernel 4's transposed order and kernel 5's order, each with
the bf16 hi/lo pair) are held to the Pallas kernels within 1e-4 (lse) and
1e-5 of the largest entry (dk, dv, dq).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_spectral_tpu.models.flash_attention import (_einsum_attention,
                                                      _flash_backward,
                                                      _flash_forward,
                                                      _flash_forward_packed)
from deep_spectral_tpu_torch.models.flash_attention import (
    FlashAttentionFn, flash_attention_lse, flash_attention_lse_plain,
    flash_attention_packed, flash_attention_packed_plain, flash_backward,
    flash_backward_plain, flash_bwd_dkv, flash_bwd_dq)


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


def _bhtd(x):
    return jnp.asarray(x.transpose(0, 2, 1, 3))


def _lse_inputs(seed=0):
    """B=2, H=2, T=197, hd=64: a ragged end in batch 0, batch 1 all-masked."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((2, 197, 2, 64)).astype(np.float32)
                   for _ in range(4))
    mask = np.ones((2, 197), bool)
    mask[0, 150:] = False
    mask[1, :] = False
    return q, k, v, do, mask


def test_lse_twin_matches_pallas_forward():
    q, k, v, _, mask = _lse_inputs()
    o_ref, lse_ref = _flash_forward(_bhtd(q), _bhtd(k), _bhtd(v), jnp.asarray(mask),
                                    interpret=True, save_residuals=True)
    o_ref = np.asarray(o_ref).transpose(0, 2, 1, 3)
    lse_ref = np.asarray(lse_ref)[..., :197, 0]
    o, lse = flash_attention_lse_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                       torch.from_numpy(mask))
    assert o.shape == (2, 197, 2, 64) and lse.shape == (2, 2, 197)
    assert o.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), o_ref, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-5, rtol=0)
    assert not o[1].any()                       # no valid key -> 0
    np.testing.assert_array_equal(lse[1].numpy(), lse_ref[1])  # MASK_VALUE + log(1e-30)


def test_backward_twin_matches_pallas_backward():
    q, k, v, do, mask = _lse_inputs(seed=1)
    jq, jk, jv, jdo, jm = _bhtd(q), _bhtd(k), _bhtd(v), _bhtd(do), jnp.asarray(mask)
    o, lse = _flash_forward(jq, jk, jv, jm, interpret=True, save_residuals=True)
    ref = [np.asarray(x).transpose(0, 2, 1, 3)
           for x in _flash_backward(jq, jk, jv, jm, o, lse, jdo, interpret=True)]
    t = [torch.from_numpy(x) for x in (q, k, v)]
    m = torch.from_numpy(mask)
    o_t, lse_t = flash_attention_lse_plain(*t, m)
    got = flash_backward_plain(*t, m, o_t, lse_t, torch.from_numpy(do))
    valid = mask.any(axis=1)                    # batch rows with a valid key
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g.numpy()[valid], r[valid], atol=2e-3, rtol=1e-3,
                                   err_msg=f"d{name}")
        assert not g[1].any(), f"d{name} of the all-masked batch row"
    # the split CPU wrappers are the same twin
    di = (o_t * torch.from_numpy(do)).sum(-1).permute(0, 2, 1).contiguous()
    dk, dv = flash_bwd_dkv(*t, m, torch.from_numpy(do), lse_t, di)
    dq = flash_bwd_dq(*t, m, torch.from_numpy(do), lse_t, di)
    for a, b in zip((dq, dk, dv), got):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def _fused(B, T, H, hd, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((B, T, 3, H, hd), generator=g, dtype=dtype)
    mask = torch.ones((B, T), dtype=torch.bool)
    mask[0, T - 3:] = False
    return qkv, mask, g


def test_flash_fn_gradcheck_float64():
    qkv, mask, _ = _fused(2, 9, 2, 8, torch.float64, seed=3)
    qkv.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda x: FlashAttentionFn.apply(x, mask), (qkv,))


def test_flash_fn_matches_einsum_autograd():
    """Values and qkv gradients of the CPU route against autograd of the
    plain masked softmax (the JAX package's einsum attention), f32, 1e-4."""
    qkv, mask, g = _fused(2, 70, 2, 64, torch.float32, seed=4)
    do = torch.randn((2, 70, 2, 64), generator=g)
    a = qkv.clone().requires_grad_(True)
    counts = (flash_attention_lse.launches, flash_bwd_dkv.launches, flash_bwd_dq.launches)
    out = FlashAttentionFn.apply(a, mask)
    (out * do).sum().backward()
    assert (flash_attention_lse.launches, flash_bwd_dkv.launches,
            flash_bwd_dq.launches) == counts    # CPU tensors launch nothing
    b = qkv.clone().requires_grad_(True)
    q, k, v = b.unbind(2)
    s = torch.einsum("bthd,bshd->bhts", q, k) / 8.0
    s = torch.where(mask[:, None, None, :], s, -1e30)
    ref = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v)
    (ref * do).sum().backward()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-4)


def test_flash_backward_wrapper_on_cpu_is_the_twin():
    qkv, mask, g = _fused(2, 20, 2, 16, torch.float32, seed=5)
    q, k, v = qkv.unbind(2)
    o, lse = flash_attention_lse(q, k, v, mask)
    do = torch.randn(o.shape, generator=g)
    for a, b in zip(flash_backward(q, k, v, mask, o, lse, do).unbind(2),
                    flash_backward_plain(q, k, v, mask, o, lse, do)):
        assert torch.equal(a, b)


# ------------------------------- the Hopper kernels' arithmetic, emulated in torch
#
# Kernels 3 (bf16: csrc/flash_fwd.cu's lse-writing build), 4 (bf16:
# csrc/flash_bwd_dkv.cu) and 5 (bf16: csrc/flash_bwd_dq.cu) cannot run
# here; these render their arithmetic in
# torch f32 on bf16-valued inputs and hold it to the Pallas kernels in
# interpret mode.

LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
KEY_TILE, Q_TILE = 128, 64      # kernel 3's key tile; kernel 4's streamed q tile
DQ_KEY_TILE = 64                # kernel 5's streamed key tile


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _kernel3_lse(q, k, mask):
    """Kernel 3's lse: the scale folded into log2 units (scale log2 e in f32),
    the online max and exp2 sum over key tiles of 128 (keys past T and masked
    keys score MASK_VALUE, already in log2 units, and add p = 0), and the
    epilogue (m + log2(max(l, 1e-30))) ln 2. q, k (B, T, H, hd) f32; mask
    (B, T) bool. Returns (B, H, T)."""
    B, T, H, hd = q.shape
    scale_log2 = _f32(1.0 / np.sqrt(hd)) * _f32(LOG2E)
    qh, kh = q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3)
    m = torch.full((B, H, T), -np.inf)
    l = torch.zeros((B, H, T))
    for k0 in range(0, T, KEY_TILE):
        valid = mask[:, None, None, k0:k0 + KEY_TILE]
        s = torch.where(valid, (qh @ kh[:, :, k0:k0 + KEY_TILE].transpose(-1, -2)) * scale_log2,
                        _f32(-0.7 * np.finfo(np.float32).max))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(valid, torch.exp2(s - m_new[..., None]), 0.0)
        l = torch.exp2(m - m_new) * l + p.sum(-1)
        m = m_new
    return (m + torch.log2(torch.clamp(l, min=1e-30))) * _f32(LN2)


def _bf16_parts(x, hi_lo):
    """x as the bf16 hi/lo pair the backward kernels feed the tensor cores
    (hi = bf16(x), lo = bf16(x - hi)), or (hi_lo=False) its one bf16
    rounding; as f32."""
    hi = x.to(torch.bfloat16).float()
    return (hi, (x - hi).to(torch.bfloat16).float()) if hi_lo else (hi,)


def _kernel4_dkv(q, k, v, do, mask, lse, di, hi_lo=True):
    """Kernel 4's dk and dv in its transposed order: per q tile of 64 rows,
    S^T = K Q^T and dP^T = V dO^T with keys on the rows, P^T = select(key
    valid and q < T, exp2(S^T scale log2 e - lse log2 e), 0), dS^T = P^T
    (dP^T - di), then dV += P^T dO and dK += dS^T Q with P^T and dS^T as a
    bf16 hi/lo pair (hi_lo=False: one bf16 rounding, the design not taken).
    All (B, T, H, hd) f32 but mask (B, T) and lse, di (B, H, T)."""
    B, T, H, hd = q.shape
    scale = _f32(1.0 / np.sqrt(hd))
    qh, kh, vh, doh = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))
    key_ok = mask[:, None, :, None]                                     # (B, 1, T, 1)
    lse2 = lse * _f32(LOG2E)
    dk = torch.zeros((B, H, T, hd))
    dv = torch.zeros((B, H, T, hd))
    for q0 in range(0, T, Q_TILE):
        rows = slice(q0, q0 + Q_TILE)
        sT = kh @ qh[:, :, rows].transpose(-1, -2)                       # (B, H, keys, q)
        dpT = vh @ doh[:, :, rows].transpose(-1, -2)
        pT = torch.where(key_ok, torch.exp2(sT * (scale * _f32(LOG2E)) - lse2[:, :, None, rows]),
                         0.0)
        dsT = pT * (dpT - di[:, :, None, rows])
        for part in _bf16_parts(pT, hi_lo):
            dv += part @ doh[:, :, rows]
        for part in _bf16_parts(dsT, hi_lo):
            dk += part @ qh[:, :, rows]
    return (dk * scale).permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def _kernel5_dq(q, k, v, do, mask, lse, di, hi_lo=True):
    """Kernel 5's dq in its order: per key tile of 64, S = Q K^T and
    dP = dO V^T, P = select(key valid, exp2(S scale log2 e - lse log2 e), 0),
    dS = P (dP - di), then dQ += dS K with dS as a bf16 hi/lo pair, two
    products against bf16 K with f32 accumulation (hi_lo=False: one bf16
    rounding of dS, the design not taken); the epilogue scales and rounds
    once to bf16. All (B, T, H, hd) f32 but mask (B, T) and lse, di
    (B, H, T). Returns dq before and after that rounding."""
    B, T, H, hd = q.shape
    scale = _f32(1.0 / np.sqrt(hd))
    qh, kh, vh, doh = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))
    lse2 = (lse * _f32(LOG2E))[..., None]                               # (B, H, T, 1)
    dq = torch.zeros((B, H, T, hd))
    for k0 in range(0, T, DQ_KEY_TILE):
        keys = slice(k0, k0 + DQ_KEY_TILE)
        s = qh @ kh[:, :, keys].transpose(-1, -2)                        # (B, H, q, keys)
        dp = doh @ vh[:, :, keys].transpose(-1, -2)
        p = torch.where(mask[:, None, None, keys],
                        torch.exp2(s * (scale * _f32(LOG2E)) - lse2), 0.0)
        ds = p * (dp - di[..., None])
        for part in _bf16_parts(ds, hi_lo):
            dq += part @ kh[:, :, keys]
    dq = (dq * scale).permute(0, 2, 1, 3)
    return dq, dq.to(torch.bfloat16)


def _bf16_inputs(T, seed):
    """q, k, v, do (3, T, 2, 64) with bf16 values (what the kernels read),
    as f32; a ragged end in batch 0, batch 1 all-masked, a masked start in 2."""
    q, k, v, mask = _inputs(3, T, 2, 64, seed=seed)
    do = np.random.default_rng(seed + 1).standard_normal(q.shape).astype(np.float32)
    return [torch.from_numpy(x).to(torch.bfloat16).float() for x in (q, k, v, do)] + \
        [torch.from_numpy(mask)]


def _pallas_forward(q, k, v, mask):
    o, lse = _flash_forward(*(_bhtd(x.numpy()) for x in (q, k, v)), jnp.asarray(mask.numpy()),
                            interpret=True, save_residuals=True)
    T = q.shape[1]
    return np.asarray(o), np.asarray(lse)[..., :T, 0]


@pytest.mark.parametrize("T", [1, 63, 65, 197])
def test_kernel3_lse_arithmetic_matches_pallas(T):
    """Kernel 3's exp2-domain lse within 1e-4 of the Pallas forward's on
    every batch row with a valid key (f32 rounding of the folded scale and of
    log2 vs log; lse is O(5)); a row with no valid key gets a finite lse below
    -1e38 (kernel 4 selects p = 0 for it whatever the value)."""
    q, k, v, _, mask = _bf16_inputs(T, seed=T)
    _, lse_ref = _pallas_forward(q, k, v, mask)
    lse = _kernel3_lse(q, k, mask)
    valid = mask.any(dim=1).numpy()
    np.testing.assert_allclose(lse.numpy()[valid], lse_ref[valid], atol=1e-4, rtol=0)
    assert torch.isfinite(lse).all() and (lse[~mask.any(dim=1)] < -1e38).all()


@pytest.mark.parametrize("T", [1, 63, 65, 197])
def test_kernel4_transposed_hi_lo_matches_pallas(T):
    """Kernel 4's transposed order with the bf16 hi/lo pair, fed kernel 3's
    lse, against the Pallas backward (fed its own forward's lse): dk and dv
    within 1e-5 of the largest Pallas entry (the pair keeps ~16 bits of p and
    ds; the rest is f32 summation order and exp2 vs exp). The all-masked batch
    row is exactly 0. Prints the single-rounding design's error beside it."""
    q, k, v, do, mask = _bf16_inputs(T, seed=100 + T)
    jq, jk, jv, jdo = (_bhtd(x.numpy()) for x in (q, k, v, do))
    jm = jnp.asarray(mask.numpy())
    o, lse_j = _flash_forward(jq, jk, jv, jm, interpret=True, save_residuals=True)
    _, dk_ref, dv_ref = (np.asarray(x).transpose(0, 2, 1, 3)
                         for x in _flash_backward(jq, jk, jv, jm, o, lse_j, jdo, interpret=True))
    o = torch.from_numpy(np.array(o)).permute(0, 2, 1, 3)
    di = (o * do).sum(-1).permute(0, 2, 1)
    lse = _kernel3_lse(q, k, mask)
    got = {split: _kernel4_dkv(q, k, v, do, mask, lse, di, hi_lo=split)
           for split in (True, False)}
    valid = mask.any(dim=1).numpy()
    errs = {}
    for split, (dk, dv) in got.items():
        for name, g, r in (("dk", dk, dk_ref), ("dv", dv, dv_ref)):
            errs[split, name] = (np.abs(g.numpy()[valid] - r[valid]).max()
                                 / np.abs(r[valid]).max())
    print(f"T={T}: max |emulated - Pallas| / max |Pallas|: hi/lo pair dk "
          f"{errs[True, 'dk']:.3e} dv {errs[True, 'dv']:.3e}; single bf16 rounding dk "
          f"{errs[False, 'dk']:.3e} dv {errs[False, 'dv']:.3e}")
    assert errs[True, "dk"] <= 1e-5 and errs[True, "dv"] <= 1e-5, errs
    dk, dv = got[True]
    assert not dk[1].any() and not dv[1].any()


@pytest.mark.parametrize("T", [1, 63, 65, 197])
def test_kernel5_hi_lo_matches_pallas(T):
    """Kernel 5's order with dS as a bf16 hi/lo pair, fed kernel 3's lse,
    against the Pallas backward (fed its own forward's lse): dq before the
    output rounding within 1e-5 of the largest Pallas entry (the pair keeps
    ~16 bits of ds; the rest is f32 summation order and exp2 vs exp); at
    T = 1, where dq is mathematically 0, both within 1e-6 of 0. The
    all-masked batch row is exactly 0. Prints the single-rounding design's
    error beside it, and for both the share of bf16 dq entries that are not
    the Pallas dq's own bf16 rounding (the reading chip_smoke gates)."""
    q, k, v, do, mask = _bf16_inputs(T, seed=200 + T)
    jq, jk, jv, jdo = (_bhtd(x.numpy()) for x in (q, k, v, do))
    jm = jnp.asarray(mask.numpy())
    o, lse_j = _flash_forward(jq, jk, jv, jm, interpret=True, save_residuals=True)
    dq_ref = np.asarray(_flash_backward(jq, jk, jv, jm, o, lse_j, jdo,
                                        interpret=True)[0]).transpose(0, 2, 1, 3)
    o = torch.from_numpy(np.array(o)).permute(0, 2, 1, 3)
    di = (o * do).sum(-1).permute(0, 2, 1)
    lse = _kernel3_lse(q, k, mask)
    got = {split: _kernel5_dq(q, k, v, do, mask, lse, di, hi_lo=split)
           for split in (True, False)}
    valid = mask.any(dim=1).numpy()
    ref16 = torch.tensor(dq_ref).to(torch.bfloat16)[valid]
    errs, shares = {}, {}
    for split, (dq, dq16) in got.items():
        errs[split] = np.abs(dq.numpy()[valid] - dq_ref[valid]).max() / np.abs(dq_ref[valid]).max()
        shares[split] = (dq16[valid] != ref16).float().mean().item()
    print(f"T={T}: max |emulated - Pallas| / max |Pallas|: hi/lo pair {errs[True]:.3e}, "
          f"single bf16 rounding {errs[False]:.3e}; bf16 dq not bit-equal to bf16(Pallas): "
          f"{shares[True]:.4f} and {shares[False]:.4f}")
    dq, dq16 = got[True]
    if T == 1:
        # a softmax over one key has no gradient in its score: dq is 0 up to
        # the rounding of dp - di, in the emulation and in Pallas alike
        assert np.abs(dq.numpy()).max() <= 1e-6 and np.abs(dq_ref).max() <= 1e-6
    else:
        assert errs[True] <= 1e-5, errs
    assert not dq[1].any() and not dq16[1].any()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Parallel test workers each get one torch thread: with torch's default
    (all cores) per worker, the workers oversubscribe the CPU many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
