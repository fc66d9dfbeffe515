"""Masked flash attention over the packed (B, T, H, hd) layout: forward and
backward.

Hand-written Hopper kernels, each behind a wrapper that launches it for
CUDA tensors and computes the same function with its plain PyTorch twin for
CPU tensors. There is no other fallback: a CUDA tensor a kernel does not take
raises.
  * `flash_attention_packed` (`csrc/flash_fwd.cu`, the port of the Pallas
    `_flash_kernel_packed`; wgmma products fed by TMA loads): the bf16
    inference forward, at head dim 64 or 128 (`PACKED_HEAD_DIMS`), and at
    head dim 80 with SAM's decomposed relative-position bias
    (`RELPOS_HEAD_DIM`, `rel_pos`; no Pallas kernel has it); twin
    `flash_attention_packed_plain`.
  * `flash_attention_lse` (the port of `_flash_kernel`): forward that also
    returns the row log-sum-exp; bf16 runs `csrc/flash_fwd.cu`'s lse-writing
    instantiation (wgmma + TMA), f32 `csrc/flash_fwd_f32.cu` (wgmma + TMA,
    split-TF32 products); twin `flash_attention_lse_plain`.
  * `flash_bwd_dkv` (the port of `_flash_bwd_dkv_kernel`; bf16
    `csrc/flash_bwd_dkv.cu`, f32 `csrc/flash_bwd_dkv_f32.cu`, split-TF32 on
    wgmma and mma.sync) and `flash_bwd_dq` (`_flash_bwd_dq_kernel`; bf16
    `csrc/flash_bwd_dq.cu` on wgmma + TMA, f32 `csrc/flash_bwd_dq_f32.cu`,
    split-TF32 on wgmma and mma.sync), run together by `flash_backward`;
    twin `flash_backward_plain`.
Each wrapper's `launches` counts its launches in both dtypes,
`f32_launches` those of its f32 build. The two forwards count a call made
while the kernel's device captures a CUDA graph, which launches nothing, in
`captured` (`f32_captured`) instead; whoever replays the graph adds its
captured calls to `launches` (`f32_launches`) at each replay.
`FlashAttentionFn` is the autograd function over them (the port of
`flash_attention_trainable`'s custom VJP).

Semantics (shared by kernel and twin, as in the Pallas kernel): non-causal
softmax(q k^T / sqrt(hd)) v for every (batch, head); keys whose `kv_mask` is
false score MASK_VALUE and get probability exactly 0; statistics in f32; the
probabilities are cast to the value dtype before the P.V product; a query row
with no valid key outputs 0. With `rel_pos` = (rel_h (B, H, T, NY), rel_w
(B, H, T, S)), tables in q's dtype over the keys laid out as an S-wide grid
(key k at row k // S, column k % S), each score adds rel_h[q, k // S] +
rel_w[q, k % S] in f32 before the softmax (SAM's decomposed relative
positions, `add_decomposed_rel_pos`, with the tables computed outside:
`models/relpos.py`).
"""
from __future__ import annotations

import math
import ctypes
from typing import Optional

import torch

from ..utils.precision import exact_f32

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
KERNEL_HEAD_DIM = 64
PACKED_HEAD_DIMS = (64, 128)  # the inference forward's builds (the others: 64)
RELPOS_HEAD_DIM = 80  # the inference forward's build with the relative-position bias
BLOCK = 64  # key rows per step of the online softmax (the kernels' tile)


def relpos_bias(rel_pos: tuple, T: int) -> torch.Tensor:
    """The (B, H, T, T) f32 scores' bias of `rel_pos` (see the module
    docstring): rel_h[..., q, k // S] + rel_w[..., q, k % S]."""
    rel_h, rel_w = rel_pos
    key = torch.arange(T, device=rel_h.device)
    S = rel_w.shape[-1]
    return rel_h.float()[..., key // S] + rel_w.float()[..., key % S]


def flash_attention_packed_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 kv_mask: Optional[torch.Tensor] = None,
                                 rel_pos: Optional[tuple] = None) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: a masked softmax in f32 that masks
    with `where` (p = 0 on masked keys) and casts p to v's dtype before the
    P.V product. q/k/v (B, T, H, hd); kv_mask (B, T) bool; rel_pos the
    relative-position tables (module docstring). Returns (B, T, H, hd) in
    q's dtype."""
    B, T, H, hd = q.shape
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(hd)
    if rel_pos is not None:
        s = s + relpos_bias(rel_pos, T)
    if kv_mask is None:
        valid = torch.ones((B, 1, 1, T), dtype=torch.bool, device=q.device)
    else:
        valid = kv_mask[:, None, None, :].to(torch.bool)
    s = torch.where(valid, s, MASK_VALUE)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(valid, p, 0.0)
    l = p.sum(dim=-1)                                   # (B, H, T)
    o = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(), v.float())
    l = l.permute(0, 2, 1)[..., None]                   # (B, T, H, 1)
    o = o / torch.where(l == 0.0, 1.0, l)
    return o.to(q.dtype)


def _check_tma(x: torch.Tensor, name: str, shape, dtype=torch.bfloat16) -> None:
    """Raise unless x is a `dtype` (bf16 or f32) view of `shape` that the TMA
    loads take: unit stride on hd, every other stride a multiple of 16 bytes
    (8 bf16 or 4 f32 elements), a 16-byte aligned data pointer."""
    if x.dtype != dtype:
        raise TypeError(f"flash kernel takes {str(dtype)[6:]} {name}; got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(x.shape)} != {tuple(shape)}")
    if x.stride(-1) != 1 or any(s % (16 // x.element_size()) for s in x.stride()[:3]):
        raise ValueError(f"{name} strides {x.stride()}: the kernel needs unit "
                         f"stride on hd and 16-byte aligned rows")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} data pointer is not 16-byte aligned")


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_mask: Optional[torch.Tensor] = None,
                           rel_pos: Optional[tuple] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) [+ bias], kv-masked) v over (B, T, H, hd)
    tensors.

    CPU tensors: the plain twin. CUDA tensors: the Hopper kernel, which takes
    bf16 q/k/v with hd 64 or 128 and no `rel_pos`, or hd 80 with `rel_pos`
    and no mask (its tables bf16 on q's device, unit stride on their last
    dim, S even and >= 8, NY x S >= T), q/k/v read through their strides by TMA
    (views into the fused qkv projection need no copy; every stride a
    multiple of 16 bytes); anything else raises. The output is a new
    contiguous (B, T, H, hd) tensor. `flash_attention_packed.launches`
    counts kernel launches, `.captured` calls captured into a CUDA graph."""
    if not q.is_cuda:
        return flash_attention_packed_plain(q, k, v, kv_mask, rel_pos)
    B, T, H, hd = q.shape
    if rel_pos is None and hd not in PACKED_HEAD_DIMS:
        raise ValueError(f"flash kernel is built for hd in {PACKED_HEAD_DIMS}; got {hd}")
    if rel_pos is not None and (hd != RELPOS_HEAD_DIM or kv_mask is not None):
        raise ValueError(f"flash kernel's relative-position build is for hd "
                         f"{RELPOS_HEAD_DIM} without a key mask; got hd {hd}"
                         f"{'' if kv_mask is None else ' and a mask'}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        _check_tma(x, name, (B, T, H, hd))
    if kv_mask is not None:
        if kv_mask.device != q.device or tuple(kv_mask.shape) != (B, T):
            raise ValueError(f"kv_mask must be ({B}, {T}) on {q.device}; got "
                             f"{tuple(kv_mask.shape)} on {kv_mask.device}")
        kv_mask = kv_mask.to(torch.bool).contiguous()
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    if rel_pos is not None:
        captured = _launch_relpos(q, k, v, rel_pos, out)
    else:
        captured = _launch_packed(q, k, v, kv_mask, out, None, "flash_attention_packed")
    if captured:
        flash_attention_packed.captured += 1
    else:
        flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = flash_attention_packed.captured = 0


def _launch_packed(q, k, v, kv_mask, out, lse, what: str) -> bool:
    """`csrc/flash_fwd.cu` on checked operands; lse None: the inference
    build, else the build that also writes the (B, H, T) lse. Returns
    whether the launch was captured into a CUDA graph (q's device's current
    stream was capturing)."""
    from .. import _build
    B, T, H, hd = q.shape
    lib = _build.load()
    with torch.cuda.device(q.device):
        captured = torch.cuda.is_current_stream_capturing()
        err = lib.dss_flash_fwd_packed(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, T, H, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
    _build.check(err, what)
    return captured


def _launch_relpos(q, k, v, rel_pos, out) -> bool:
    """`csrc/flash_fwd.cu`'s hd-80 build on checked q/k/v and the tables
    `rel_pos`, which this checks. Returns whether the launch was captured."""
    from .. import _build
    B, T, H, hd = q.shape
    rel_h, rel_w = rel_pos
    S, NY = rel_w.shape[-1], rel_h.shape[-1]
    for name, x, n in (("rel_h", rel_h, NY), ("rel_w", rel_w, S)):
        if x.dtype != torch.bfloat16 or x.device != q.device or \
                tuple(x.shape) != (B, H, T, n) or x.stride(-1) != 1:
            raise ValueError(f"{name} must be bf16 ({B}, {H}, {T}, {n}) on {q.device} with "
                             f"unit stride on its last dim; got {x.dtype} "
                             f"{tuple(x.shape)} strides {x.stride()} on {x.device}")
    if S < 8 or S % 2 or NY * S < T:
        raise ValueError(f"the bias grid must be an even width of at least 8 and hold the "
                         f"{T} keys; got {NY} x {S}")
    lib = _build.load()
    with torch.cuda.device(q.device):
        captured = torch.cuda.is_current_stream_capturing()
        err = lib.dss_flash_fwd_relpos(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), rel_h.data_ptr(),
            rel_w.data_ptr(), B, T, H, S, NY, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *rel_h.stride()[:3], *rel_w.stride()[:3],
            1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention_packed")
    return captured


# ------------------------------------------------ trainable forward / backward

def _work_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 for bf16/f32 inputs (f64 stays f64, for gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def _heads_first(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).permute(0, 2, 1, 3)            # (B, T, H, hd) -> (B, H, T, hd)


def _key_valid(kv_mask, B: int, T: int, device) -> torch.Tensor:
    """(B, 1, 1, T) bool."""
    if kv_mask is None:
        return torch.ones((B, 1, 1, T), dtype=torch.bool, device=device)
    return kv_mask[:, None, None, :].to(torch.bool)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              kv_mask: Optional[torch.Tensor] = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of kernel 3: the online-softmax recurrence over key tiles of
    BLOCK rows, in true f32 (p rounded to v's dtype before P.V). q/k/v
    (B, T, H, hd). Returns o (B, T, H, hd) in q's dtype and lse (B, H, T) in
    f32, lse = m + log(max(l, 1e-30))."""
    B, T, H, hd = q.shape
    wd = _work_dtype(q)
    scale = 1.0 / math.sqrt(hd)
    valid = _key_valid(kv_mask, B, T, q.device)
    with exact_f32():
        qf, kf, vf = (_heads_first(x, wd) for x in (q, k, v))
        m = torch.full((B, H, T, 1), -math.inf, dtype=wd, device=q.device)
        l = torch.zeros((B, H, T, 1), dtype=wd, device=q.device)
        acc = torch.zeros((B, H, T, hd), dtype=wd, device=q.device)
        for k0 in range(0, T, BLOCK):
            vm = valid[..., k0:k0 + BLOCK]
            s = torch.matmul(qf, kf[:, :, k0:k0 + BLOCK].transpose(-1, -2)) * scale
            s = torch.where(vm, s, MASK_VALUE)
            m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_next)
            p = torch.where(vm, torch.exp(s - m_next), 0.0)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p.to(v.dtype).to(wd),
                                             vf[:, :, k0:k0 + BLOCK])
            m = m_next
        o = acc * torch.where(l == 0.0, 1.0, 1.0 / l)
        lse = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]
    return o.permute(0, 2, 1, 3).to(q.dtype).contiguous(), lse


def _backward_plain(q, k, v, kv_mask, lse, do, di):
    """dq, dk, dv from the saved lse and di = rowsum(o * do) (B, H, T): p, dp
    and ds in true f32, as kernels 4 and 5 compute them."""
    B, T, H, hd = q.shape
    wd = _work_dtype(q)
    scale = 1.0 / math.sqrt(hd)
    valid = _key_valid(kv_mask, B, T, q.device)
    with exact_f32():
        qf, kf, vf, dof = (_heads_first(x, wd) for x in (q, k, v, do))
        s = torch.where(valid, torch.matmul(qf, kf.transpose(-1, -2)) * scale,
                        MASK_VALUE)
        p = torch.where(valid, torch.exp(s - lse[..., None].to(wd)), 0.0)
        dv = torch.matmul(p.transpose(-1, -2), dof)
        dp = torch.matmul(dof, vf.transpose(-1, -2))
        ds = p * (dp - di[..., None].to(wd))
        dk = scale * torch.matmul(ds.transpose(-1, -2), qf)
        dq = scale * torch.matmul(ds, kf)
    back = lambda x: x.permute(0, 2, 1, 3).to(q.dtype)  # noqa: E731
    return back(dq), back(dk), back(dv)


def _row_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(o * do) in f32 (or f64), as (B, H, T)."""
    wd = _work_dtype(o)
    return (o.to(wd) * do.to(wd)).sum(dim=-1).permute(0, 2, 1).contiguous()


def flash_backward_plain(q, k, v, kv_mask, o, lse, do):
    """Plain twin of kernels 4 and 5 (with di = rowsum(o * do) computed as the
    JAX package does, outside them). All (B, T, H, hd) but lse (B, H, T).
    Returns (dq, dk, dv) in q's dtype."""
    return _backward_plain(q, k, v, kv_mask, lse, do, _row_dot(o, do))


def _check_train_args(tensors: dict, kv_mask, B: int, T: int, H: int) -> torch.device:
    """Raise unless every (B, T, H, 64) operand is a bf16 or f32 CUDA tensor of
    one dtype on one device with unit stride on hd."""
    q = next(iter(tensors.values()))
    if q.shape[-1] != KERNEL_HEAD_DIM:
        raise ValueError(f"flash kernels are built for hd={KERNEL_HEAD_DIM}; got {q.shape[-1]}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash kernels take bf16 or f32; got {q.dtype}")
    for name, x in tensors.items():
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}; q is {q.dtype} on {q.device}")
        if tuple(x.shape) != (B, T, H, KERNEL_HEAD_DIM):
            raise ValueError(f"{name} shape {tuple(x.shape)} != {(B, T, H, KERNEL_HEAD_DIM)}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} strides {x.stride()}: hd must have unit stride")
    if kv_mask is not None and (kv_mask.device != q.device or tuple(kv_mask.shape) != (B, T)):
        raise ValueError(f"kv_mask must be ({B}, {T}) on {q.device}; got "
                         f"{tuple(kv_mask.shape)} on {kv_mask.device}")
    return q.device


def _check_stats(name: str, x: torch.Tensor, B: int, H: int, T: int, device) -> None:
    if x.dtype != torch.float32 or tuple(x.shape) != (B, H, T) or x.device != device \
            or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous f32 ({B}, {H}, {T}) tensor on "
                         f"{device}; got {x.dtype} {tuple(x.shape)} on {x.device}")


def _bool_mask(kv_mask):
    return None if kv_mask is None else kv_mask.to(torch.bool).contiguous()


def _strides(*tensors) -> ctypes.Array:
    vals = [s for x in tensors for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T / sqrt(hd), kv-masked) v and the row log-sum-exp.

    q/k/v (B, T, H, hd), read through their strides. CPU tensors: the plain
    twin. CUDA tensors with hd == 64: kernel 3 on wgmma + TMA, bf16 in
    `csrc/flash_fwd.cu` (the build that writes the lse), f32 in
    `csrc/flash_fwd_f32.cu` (split-TF32 products); both need unit stride on
    hd, every other stride a multiple of 16 bytes (8 bf16 or 4 f32
    elements) and 16-byte aligned data pointers, as `flash_attention_packed`
    does; anything else raises. Returns o, a new contiguous (B, T, H, hd)
    tensor in q's dtype, and lse, (B, H, T) f32.
    `flash_attention_lse.launches` counts kernel launches (either build),
    `flash_attention_lse.f32_launches` those of the f32 build, `.captured`
    and `.f32_captured` calls captured into a CUDA graph."""
    if not q.is_cuda:
        return flash_attention_lse_plain(q, k, v, kv_mask)
    B, T, H, hd = q.shape
    dev = _check_train_args({"q": q, "k": k, "v": v}, kv_mask, B, T, H)
    mask = _bool_mask(kv_mask)
    o = torch.empty((B, T, H, hd), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_tma(x, name, (B, T, H, hd), q.dtype)
    f32 = q.dtype != torch.bfloat16
    if not f32:
        captured = _launch_packed(q, k, v, mask, o, lse, "flash_attention_lse")
    else:
        from .. import _build
        lib = _build.load()
        with torch.cuda.device(dev):
            captured = torch.cuda.is_current_stream_capturing()
            err = lib.dss_flash_fwd_lse_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if mask is None else mask.data_ptr(), o.data_ptr(), lse.data_ptr(),
                B, T, H, _strides(q, k, v, o), 1.0 / math.sqrt(hd),
                torch.cuda.current_stream().cuda_stream)
        _build.check(err, "flash_attention_lse")
    if captured:
        flash_attention_lse.captured += 1
        if f32:
            flash_attention_lse.f32_captured += 1
    else:
        flash_attention_lse.launches += 1
        if f32:
            flash_attention_lse.f32_launches += 1
    return o, lse


flash_attention_lse.launches = flash_attention_lse.f32_launches = 0
flash_attention_lse.captured = flash_attention_lse.f32_captured = 0


def _bwd_operands(q, k, v, kv_mask, do, lse, di):
    B, T, H, _ = q.shape
    dev = _check_train_args({"q": q, "k": k, "v": v, "do": do}, kv_mask, B, T, H)
    _check_stats("lse", lse, B, H, T, dev)
    _check_stats("di", di, B, H, T, dev)
    return B, T, H, dev, _bool_mask(kv_mask)


def _launch_bwd(kernel: str, q, k, v, mask, do, lse, di, outs: dict, dev) -> None:
    """Kernel 4 (`kernel` "dkv") or 5 ("dq") on checked operands, writing
    the `outs` views: bf16 on wgmma + TMA (`csrc/flash_bwd_{kernel}.cu`), f32
    on split-TF32 wgmma and mma.sync fed by TMA
    (`csrc/flash_bwd_{kernel}_f32.cu`). All need q, k, v and do's strides but
    hd's a multiple of 16 bytes and 16-byte aligned data pointers, and so do
    the outputs but f32 dq, which is written with scalar stores and needs
    unit stride on hd only."""
    from .. import _build
    B, T, H, hd = q.shape
    _check_train_args({"q": q, **outs}, None, B, T, H)
    bf16 = q.dtype == torch.bfloat16
    tma = {"q": q, "k": k, "v": v, "do": do}
    if bf16 or kernel == "dkv":  # f32 dq is written with scalar stores
        tma.update(outs)
    for name, x in tma.items():
        _check_tma(x, name, (B, T, H, hd), q.dtype)
    launch = getattr(_build.load(), f"dss_flash_bwd_{kernel}_{'bf16' if bf16 else 'f32'}")
    out = list(outs.values())
    with torch.cuda.device(dev):
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), *(x.data_ptr() for x in out), B, T, H,
            _strides(q, k, v, do, *out), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"flash_bwd_{kernel}")


def flash_bwd_dkv(q, k, v, kv_mask, do, lse, di, dk=None, dv=None):
    """dk and dv of masked flash attention from the saved lse and
    di = rowsum(o * do), both (B, H, T) f32. CPU tensors: the plain twin.
    CUDA tensors: kernel 4, writing into `dk`/`dv` when given ((B, T, H, hd)
    views with unit stride on hd, e.g. slices of one (B, T, 3, H, hd)
    buffer); bf16 runs it on wgmma + TMA (`csrc/flash_bwd_dkv.cu`), f32 on
    split-TF32 wgmma and mma.sync fed by TMA (`csrc/flash_bwd_dkv_f32.cu`);
    both need every operand's strides but hd's a multiple of 16 bytes and
    16-byte aligned data pointers. `flash_bwd_dkv.launches` counts launches,
    `flash_bwd_dkv.f32_launches` those of the f32 build."""
    if not q.is_cuda:
        return _backward_plain(q, k, v, kv_mask, lse, do, di)[1:]
    B, T, H, dev, mask = _bwd_operands(q, k, v, kv_mask, do, lse, di)
    dk = torch.empty_like(q, memory_format=torch.contiguous_format) if dk is None else dk
    dv = torch.empty_like(q, memory_format=torch.contiguous_format) if dv is None else dv
    _launch_bwd("dkv", q, k, v, mask, do, lse, di, {"dk": dk, "dv": dv}, dev)
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.f32_launches += q.dtype == torch.float32
    return dk, dv


flash_bwd_dkv.launches = flash_bwd_dkv.f32_launches = 0


def flash_bwd_dq(q, k, v, kv_mask, do, lse, di, dq=None):
    """dq of masked flash attention (see `flash_bwd_dkv`). CPU tensors: the
    plain twin. CUDA tensors: kernel 5, writing into `dq` when given; bf16
    runs it on wgmma + TMA (`csrc/flash_bwd_dq.cu`), f32 on split-TF32 wgmma
    and mma.sync fed by TMA (`csrc/flash_bwd_dq_f32.cu`); both need q, k, v
    and do's strides but hd's a multiple of 16 bytes and 16-byte aligned
    data pointers, as kernel 4 does, and raise otherwise. The bf16 build
    writes `dq` by the same rules; the f32 build takes any `dq` view with
    unit stride on hd. `flash_bwd_dq.launches` counts launches,
    `flash_bwd_dq.f32_launches` those of the f32 build."""
    if not q.is_cuda:
        return _backward_plain(q, k, v, kv_mask, lse, do, di)[0]
    B, T, H, dev, mask = _bwd_operands(q, k, v, kv_mask, do, lse, di)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format) if dq is None else dq
    _launch_bwd("dq", q, k, v, mask, do, lse, di, {"dq": dq}, dev)
    flash_bwd_dq.launches += 1
    flash_bwd_dq.f32_launches += q.dtype == torch.float32
    return dq


flash_bwd_dq.launches = flash_bwd_dq.f32_launches = 0


def flash_backward(q, k, v, kv_mask, o, lse, do) -> torch.Tensor:
    """The gradient of masked flash attention as one (B, T, 3, H, hd) tensor
    (dq, dk, dv along dim 2: the gradient of the fused qkv projection). CPU
    tensors: the plain twin. CUDA tensors: di = rowsum(o * do) in f32 here (as
    the JAX package computes it outside its kernels), then kernels 4 and 5,
    which write straight into slices of that one buffer."""
    if not q.is_cuda:
        return torch.stack(flash_backward_plain(q, k, v, kv_mask, o, lse, do), dim=2)
    B, T, H, hd = q.shape
    di = _row_dot(o, do)
    dqkv = torch.empty((B, T, 3, H, hd), dtype=q.dtype, device=q.device)
    dq, dk, dv = dqkv.unbind(2)
    flash_bwd_dkv(q, k, v, kv_mask, do, lse, di, dk, dv)
    flash_bwd_dq(q, k, v, kv_mask, do, lse, di, dq)
    return dqkv


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable masked flash attention over the fused projection: the
    port of the JAX package's `flash_attention_trainable` (`_fat_fwd` /
    `_fat_bwd`).

    apply(qkv, kv_mask): qkv (B, T, 3, H, hd); returns o (B, T, H, hd) in
    qkv's dtype. Forward: `flash_attention_lse` (kernel 3 on CUDA), saving
    q, k, v (as qkv), the mask, o and lse. Backward: di, then kernels 4 and
    5 on CUDA, which write the (B, T, 3, H, hd) gradient in one buffer, so
    the fused projection gets it with no concatenation. CPU tensors take the
    plain twins through the same plumbing."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, kv_mask: Optional[torch.Tensor] = None):
        q, k, v = qkv.unbind(2)
        o, lse = flash_attention_lse(q, k, v, kv_mask)
        ctx.save_for_backward(qkv, kv_mask, o, lse)
        return o

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        qkv, kv_mask, o, lse = ctx.saved_tensors
        q, k, v = qkv.unbind(2)
        return flash_backward(q, k, v, kv_mask, o, lse, do.contiguous()), None
