"""The arithmetic of the port's split-TF32 flash kernels (kernel 3's f32 build,
`csrc/flash_fwd_f32.cu`, kernel 4's, `csrc/flash_bwd_dkv_f32.cu`, and
kernel 5's, `csrc/flash_bwd_dq_f32.cu`), rendered in torch and held against
the JAX package's Pallas kernels in interpret mode. (The CUDA kernels against
their twins on the card: tests/test_torch_cuda.py.)

Each f32 product in those kernels runs as three TF32 tensor-core products,
a_hi b_hi + a_hi b_lo + a_lo b_hi with x_hi = tf32(x) and x_lo = tf32(x -
x_hi), both rounded to nearest with ties away from zero (cvt.rna.tf32.f32);
`_tf32` below is that rounding, bit for bit. The renderings keep the
kernels' tile order (kernel 3: key tiles of 64 in the online softmax;
kernel 4: q tiles of 32; kernel 5: key tiles of 32) and hold o and lse
within 1e-5 and dk, dv, dq within 1e-5 of the largest Pallas entry: three
TF32 products keep ~21 significant
bits of each product, the rest is f32 summation order. One TF32 product of
the rounded operands (the single-pass control) keeps ~11 bits and misses
those tolerances; each test prints both errors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_spectral_tpu.models.flash_attention import _flash_backward, _flash_forward
from deep_spectral_tpu_torch.models.flash_attention import (
    _check_tma, flash_attention_lse, flash_bwd_dkv, flash_bwd_dq)

MASK = -0.7 * float(np.finfo(np.float32).max)
KEY_TILE = 64     # kernel 3's key tile
Q_TILE = 32       # kernel 4's streamed q tile
DQ_KEY_TILE = 32  # kernel 5's streamed key tile
TOL = 1e-5


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round an f32 to 10 mantissa bits, to nearest with
    ties away from zero (add half of the dropped 13 bits' range to the
    magnitude's bit pattern, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def _parts(x: torch.Tensor, split: bool):
    hi = _tf32(x)
    return (hi, _tf32(x - hi)) if split else (hi, None)


def _mm(a, b, split: bool):
    """a @ b as the kernels' tensor cores compute it: hi.hi + hi.lo + lo.hi
    in f32 (split=False: the single-pass control, hi.hi alone)."""
    ah, al = _parts(a, split)
    bh, bl = _parts(b, split)
    out = ah @ bh
    return out + ah @ bl + al @ bh if split else out


def _kernel3_f32(q, k, v, mask, split=True):
    """Kernel 3's f32 build: the online softmax over key tiles of 64 in
    natural units (s scaled in f32, masked keys MASK_VALUE and p = 0 by a
    select), S = Q K^T and O += P V as split products; o = acc / l (l == 0:
    o = 0), lse = m + log(max(l, 1e-30)). q, k, v (B, T, H, hd) f32; mask
    (B, T). Returns o (B, T, H, hd), lse (B, H, T)."""
    B, T, H, hd = q.shape
    scale = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32)
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    m = torch.full((B, H, T), -np.inf)
    l = torch.zeros((B, H, T))
    acc = torch.zeros((B, H, T, hd))
    for k0 in range(0, T, KEY_TILE):
        keys = slice(k0, k0 + KEY_TILE)
        valid = mask[:, None, None, keys]
        s = torch.where(valid, _mm(qh, kh[:, :, keys].transpose(-1, -2), split) * scale,
                        torch.tensor(MASK, dtype=torch.float32))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + _mm(p, vh[:, :, keys], split)
        m = m_new
    o = acc * torch.where(l == 0.0, 1.0, 1.0 / l)[..., None]
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return o.permute(0, 2, 1, 3), lse


def _kernel4_f32(q, k, v, do, mask, lse, di, split=True):
    """Kernel 4's f32 build, keys on the rows: per q tile of 32, S^T = K Q^T
    and dP^T = V dO^T as split products, P^T = select(key valid, exp(S^T
    scale - lse), 0), dS^T = P^T (dP^T - di), then dV += P^T dO and dK +=
    dS^T Q as split products; dk scaled at the end. All (B, T, H, hd) f32 but
    mask (B, T) and lse, di (B, H, T)."""
    B, T, H, hd = q.shape
    scale = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32)
    qh, kh, vh, doh = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))
    key_ok = mask[:, None, :, None]
    dk = torch.zeros((B, H, T, hd))
    dv = torch.zeros((B, H, T, hd))
    for q0 in range(0, T, Q_TILE):
        rows = slice(q0, q0 + Q_TILE)
        sT = _mm(kh, qh[:, :, rows].transpose(-1, -2), split)
        dpT = _mm(vh, doh[:, :, rows].transpose(-1, -2), split)
        pT = torch.where(key_ok, torch.exp(sT * scale - lse[:, :, None, rows]), 0.0)
        dsT = pT * (dpT - di[:, :, None, rows])
        dv += _mm(pT, doh[:, :, rows], split)
        dk += _mm(dsT, qh[:, :, rows], split)
    return (dk * scale).permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def _kernel5_f32(q, k, v, do, mask, lse, di, split=True):
    """Kernel 5's f32 build, q rows on the rows: per key tile of 32, S = Q K^T
    and dP = dO V^T as split products, P = select(key valid, exp(S scale -
    lse), 0), dS = P (dP - di), then dQ += dS K as a split product; dq scaled
    at the end. All (B, T, H, hd) f32 but mask (B, T) and lse, di (B, H, T)."""
    B, T, H, hd = q.shape
    scale = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32)
    qh, kh, vh, doh = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))
    dq = torch.zeros((B, H, T, hd))
    for k0 in range(0, T, DQ_KEY_TILE):
        keys = slice(k0, k0 + DQ_KEY_TILE)
        s = _mm(qh, kh[:, :, keys].transpose(-1, -2), split)
        dp = _mm(doh, vh[:, :, keys].transpose(-1, -2), split)
        p = torch.where(mask[:, None, None, keys], torch.exp(s * scale - lse[..., None]), 0.0)
        dq += _mm(p * (dp - di[..., None]), kh[:, :, keys], split)
    return (dq * scale).permute(0, 2, 1, 3)


def _inputs(T, seed):
    """q, k, v, do (3, T, 2, 64) f32 and a mask with a ragged end (batch 0),
    an all-masked row (batch 1) and a masked start (batch 2)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((3, T, 2, 64)).astype(np.float32))
                   for _ in range(4))
    mask = np.ones((3, T), bool)
    mask[0, T - T // 3:] = False
    mask[1, :] = False
    mask[2, : T // 3] = False
    mask[0, 0] = mask[2, -1] = True
    return q, k, v, do, torch.from_numpy(mask)


def _bhtd(x):
    return jnp.asarray(x.numpy().transpose(0, 2, 1, 3))


@pytest.mark.parametrize("T", [1, 63, 65, 197])
def test_kernel3_split_tf32_matches_pallas(T):
    """o and lse within 1e-5 of the Pallas forward on every batch row with a
    valid key; the all-masked row's o is exactly 0 and its lse MASK_VALUE (as
    the twin's); the single-pass control misses 1e-5 on o."""
    q, k, v, _, mask = _inputs(T, seed=T)
    o_ref, lse_ref = _flash_forward(_bhtd(q), _bhtd(k), _bhtd(v), jnp.asarray(mask.numpy()),
                                    interpret=True, save_residuals=True)
    o_ref = np.asarray(o_ref).transpose(0, 2, 1, 3)
    lse_ref = np.asarray(lse_ref)[..., :T, 0]
    valid = mask.any(dim=1).numpy()
    errs = {}
    for split in (True, False):
        o, lse = _kernel3_f32(q, k, v, mask, split)
        errs[split] = (np.abs(o.numpy()[valid] - o_ref[valid]).max(),
                       np.abs(lse.numpy()[valid] - lse_ref[valid]).max())
    print(f"T={T}: max |emulated - Pallas| o, lse: split TF32 {errs[True][0]:.3e}, "
          f"{errs[True][1]:.3e}; single-pass TF32 {errs[False][0]:.3e}, {errs[False][1]:.3e}")
    assert errs[True][0] <= TOL and errs[True][1] <= TOL, errs
    assert errs[False][0] > TOL, errs
    o, lse = _kernel3_f32(q, k, v, mask)
    assert not o[1].any() and (lse[1] == torch.tensor(MASK, dtype=torch.float32)).all()


@pytest.mark.parametrize("T", [1, 63, 65, 197])
def test_kernel4_split_tf32_matches_pallas(T):
    """dk and dv, fed the kernel-3 rendering's lse and di = rowsum(o do) of
    the Pallas o, within 1e-5 of the largest Pallas entry (at T = 1, where dk
    is mathematically 0, both within 1e-6 of 0); the all-masked row exactly
    0; the single-pass control misses 1e-5 on dv."""
    q, k, v, do, mask = _inputs(T, seed=100 + T)
    jq, jk, jv, jdo = (_bhtd(x) for x in (q, k, v, do))
    jm = jnp.asarray(mask.numpy())
    o, lse_j = _flash_forward(jq, jk, jv, jm, interpret=True, save_residuals=True)
    _, dk_ref, dv_ref = (np.asarray(x).transpose(0, 2, 1, 3)
                         for x in _flash_backward(jq, jk, jv, jm, o, lse_j, jdo, interpret=True))
    o = torch.from_numpy(np.array(o)).permute(0, 2, 1, 3)
    di = (o * do).sum(-1).permute(0, 2, 1)
    lse = _kernel3_f32(q, k, v, mask)[1]
    valid = mask.any(dim=1).numpy()
    errs, got = {}, {}
    for split in (True, False):
        got[split] = _kernel4_f32(q, k, v, do, mask, lse, di, split)
        for name, g, r in zip(("dk", "dv"), got[split], (dk_ref, dv_ref)):
            errs[split, name] = (np.abs(g.numpy()[valid] - r[valid]).max()
                                 / np.abs(r[valid]).max())
    print(f"T={T}: max |emulated - Pallas| / max |Pallas|: split TF32 dk "
          f"{errs[True, 'dk']:.3e} dv {errs[True, 'dv']:.3e}; single-pass TF32 dk "
          f"{errs[False, 'dk']:.3e} dv {errs[False, 'dv']:.3e}")
    dk, dv = got[True]
    if T == 1:
        # a softmax over one key has no gradient in its score: dk is 0 up to
        # the rounding of dp - di, in the rendering and in Pallas alike
        assert np.abs(dk.numpy()).max() <= 1e-6 and np.abs(dk_ref).max() <= 1e-6
    else:
        assert errs[True, "dk"] <= TOL, errs
    assert errs[True, "dv"] <= TOL and errs[False, "dv"] > TOL, errs
    assert not dk[1].any() and not dv[1].any()


@pytest.mark.parametrize("T", [1, 63, 65, 197])
def test_kernel5_split_tf32_matches_pallas(T):
    """dq, fed the kernel-3 rendering's lse and di = rowsum(o do) of the
    Pallas o, within 1e-5 of the largest Pallas entry on batch rows with a
    valid key (at T = 1, where dq is mathematically 0, within 1e-6 of 0 in
    the rendering and in Pallas alike); the all-masked row exactly 0; the
    single-pass control misses 1e-5 (at T = 1 in absolute terms)."""
    q, k, v, do, mask = _inputs(T, seed=200 + T)
    jq, jk, jv, jdo = (_bhtd(x) for x in (q, k, v, do))
    jm = jnp.asarray(mask.numpy())
    o, lse_j = _flash_forward(jq, jk, jv, jm, interpret=True, save_residuals=True)
    dq_ref = np.asarray(_flash_backward(jq, jk, jv, jm, o, lse_j, jdo, interpret=True)[0])
    dq_ref = dq_ref.transpose(0, 2, 1, 3)
    o = torch.from_numpy(np.array(o)).permute(0, 2, 1, 3)
    di = (o * do).sum(-1).permute(0, 2, 1)
    lse = _kernel3_f32(q, k, v, mask)[1]
    valid = mask.any(dim=1).numpy()
    # at T = 1 the reference is 0 up to rounding: the errors are absolute there
    norm = 1.0 if T == 1 else np.abs(dq_ref[valid]).max()
    got = {split: _kernel5_f32(q, k, v, do, mask, lse, di, split) for split in (True, False)}
    errs = {split: np.abs(g.numpy()[valid] - dq_ref[valid]).max() / norm
            for split, g in got.items()}
    print(f"T={T}: max |emulated - Pallas| dq / {'1' if T == 1 else 'max |Pallas|'}: "
          f"split TF32 {errs[True]:.3e}; single-pass TF32 {errs[False]:.3e}")
    if T == 1:
        # a softmax over one key has no gradient in its score: dq is 0 up to
        # the rounding of dp - di, in the rendering and in Pallas alike
        assert np.abs(got[True].numpy()).max() <= 1e-6 and np.abs(dq_ref).max() <= 1e-6
    assert errs[True] <= TOL and errs[False] > TOL, errs
    assert not got[True][1].any()


def test_tf32_split_properties():
    """hi keeps at most 10 mantissa bits, ties round away from zero, and
    |hi + lo - x| <= 2^-21 |x| (in f64) over normal f32 values of every
    magnitude and sign."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1 << 16) * np.exp2(rng.integers(-60, 60, 1 << 16))).astype(
        np.float32)
    x = torch.from_numpy(x)
    hi = _tf32(x)
    lo = _tf32(x - hi)
    assert (torch.bitwise_and(hi.view(torch.int32), 0x1FFF) == 0).all()
    assert (torch.bitwise_and(lo.view(torch.int32), 0x1FFF) == 0).all()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()
    assert ((hi.double() - x.double()).abs() <= 2.0 ** -11 * x.double().abs()).all()
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11],
                       dtype=torch.float32)
    assert _tf32(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2.0 ** -9]


def test_f32_tma_check():
    """The f32 kernels read their operands by TMA: views into a fused f32
    (B, T, 3, H, 64) projection pass, a view whose rows are not 16-byte
    multiples or whose data pointer is 4 bytes off raises."""
    qkv = torch.zeros((2, 9, 3, 2, 64))
    for x in qkv.unbind(2):
        _check_tma(x, "q", (2, 9, 2, 64), torch.float32)
    odd_rows = torch.zeros((2, 9, 2, 66))[..., :64]
    shifted = torch.zeros(2 * 9 * 2 * 64 + 1)[1:].view(2, 9, 2, 64)
    for bad in (odd_rows, shifted):
        with pytest.raises(ValueError):
            _check_tma(bad, "k", (2, 9, 2, 64), torch.float32)
    with pytest.raises(TypeError):
        _check_tma(qkv[:, :, 0], "q", (2, 9, 2, 64))   # bf16 expected


def test_f32_launch_counts_skip_the_cpu():
    """On CPU tensors the wrappers run their twins: neither count moves."""
    q, k, v, do, mask = _inputs(9, seed=1)
    before = [(f.launches, f.f32_launches) for f in (flash_attention_lse, flash_bwd_dkv,
                                                       flash_bwd_dq)]
    o, lse = flash_attention_lse(q, k, v, mask)
    di = (o * do).sum(-1).permute(0, 2, 1).contiguous()
    flash_bwd_dkv(q, k, v, mask, do, lse, di)
    flash_bwd_dq(q, k, v, mask, do, lse, di)
    assert [(f.launches, f.f32_launches) for f in (flash_attention_lse, flash_bwd_dkv,
                                                   flash_bwd_dq)] == before


def test_entry_points_match_their_sources():
    """Every C entry point the kernel library binds (`_build._SIGNATURES`)
    is defined in exactly one `csrc/*.cu` with as many parameters as its
    ctypes argtypes, and each single-pass-TF32 control's source defines its
    entry point and reads its define: a wrong name or argument count would
    show only on the card."""
    import re
    from deep_spectral_tpu_torch import _build
    # the split-TF32 entry points, each with its source and the define that
    # builds its single-pass-TF32 control
    CONTROLS = {"dss_flash_fwd_lse_f32": ("flash_fwd_f32.cu", "DSS_F32_SINGLE_TF32"),
                "dss_flash_bwd_dkv_f32": ("flash_bwd_dkv_f32.cu", "DSS_F32_SINGLE_TF32"),
                "dss_flash_bwd_dq_f32": ("flash_bwd_dq_f32.cu", "DSS_F32_SINGLE_TF32")}
    sources = {p.name: p.read_text() for p in _build.CSRC.glob("*.cu")}
    for name, argtypes in _build._SIGNATURES.items():
        defs = [(src, m.group(1)) for src, text in sources.items() for m in
                re.finditer(rf'extern "C" int {name}\(([^)]*)\)\s*{{', text)]
        assert len(defs) == 1, (name, [src for src, _ in defs])
        assert len(defs[0][1].split(",")) == len(argtypes), name
    for name, (source, define) in CONTROLS.items():
        assert f'extern "C" int {name}(' in sources[source], name
        assert '#include "tf32.cuh"' in sources[source]
        assert f"#ifdef {define}" in (_build.CSRC / "tf32.cuh").read_text()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Parallel test workers each get one torch thread: with torch's default
    (all cores) per worker, the workers oversubscribe the CPU many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
