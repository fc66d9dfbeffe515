"""Chebyshev filter chain T_degree(((I - S) - c) / e) X, batched over images.

`chebyshev_filter` launches the hand-written Hopper kernel
(`csrc/cheb_filter_sm90.cu`, the port of the JAX package's Pallas
`_cheb_kernel`) for CUDA tensors, and computes the same function with its
plain PyTorch twin, `chebyshev_filter_plain`, for CPU tensors. A CUDA tensor
the kernel does not take raises; there is no other fallback.

Arithmetic (the Pallas form, shared by kernel and twin):
    a_shift(t) = ((1 - c) t - S bf16(t)) * (1 / e)      f32 accumulation
    T_0 = X, T_1 = a_shift(X), T_{j+1} = 2 a_shift(T_j) - T_{j-1}
and every step after the first scales (T_j, T_{j+1}) of each column by
1 / max(max |T_{j+1}|, 1), which keeps |T_j| near 1 (the caller's
Rayleigh-Ritz normalizes the per-column scale away).

The kernel runs one launch per chain, in one of two builds that
`cheb_filter_plan` picks from (B, N, m) before the launch: 'resident' (one
thread-block cluster an image holds the image's operator in shared memory for
the whole chain) when the operator fits up to 16 CTAs' shared memory, else
'streaming' (persistent CTAs stream the operator through shared memory by
TMA). `chebyshev_filter_mma` is the earlier
build (`csrc/cheb_filter.cu`, mma.sync, one launch per step), kept as the
yardstick; no path calls it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Union

import torch

Scalar = Union[float, torch.Tensor]

SMEM_MAX = 232_448           # shared bytes a CTA can use (H100)
KEYS = 64                    # keys per 128-byte swizzled operator row segment (a TMA box)
CARD_SMS = 132               # H100 SXM; the wrapper plans with the card's own count
RESIDENT_UNITS = 2048        # rows x columns (m rounded up to 8) a CTA keeps in registers
RESIDENT_MAX_CLUSTER = 16    # non-portable cluster size, admitted by the card at every
#                              resident plan's shared memory (cudaOccupancyMaxActiveClusters)
# Clusters of each size 1-16 (index 0 unused) that an H100 SXM holds at once
# at one CTA an SM (its 132 SMs in GPCs of 16-18): the card's own answer,
# cudaOccupancyMaxActiveClusters, which the wrapper asks on the card
# (`card_clusters_at_once`); this record of it plans on the CPU, and
# chip_smoke.py phase 3 holds it to the card's answer.
H100_CLUSTERS_AT_ONCE = (0, 132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7)
STREAM_STAGES = 16           # ring stages of 64 rows x 64 keys
STREAM_KEY_WINDOW = 4096     # keys of bf16 T staged at once


class ChebPlan(NamedTuple):
    """How the kernel runs a (B, N, m) chain. 'resident': `cluster` CTAs an
    image, `rows` operator rows a CTA, `ctas` = B * cluster. 'streaming':
    `ctas` persistent CTAs, bf16 T staged in windows of `key_window` keys,
    segments of up to `rows` rows. `smem`: dynamic shared bytes a CTA."""
    build: str
    cluster: int
    rows: int
    smem: int
    ctas: int
    key_window: int


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def resident_smem(N: int, m: int, rows: int, cluster: int) -> int:
    """Shared bytes of the resident build (csrc/cheb_filter_sm90.cu
    `res_layout`): the slab (64-key blocks of `rows` 128-byte rows, 1 KB more
    when a half row block reads past it), bf16 T staged for every column
    group (keys padded to 64, pitch 8 more), the warps' partial sums, every
    peer's column maxima, the local ones and the scale factors, three
    mbarriers, and 1 KB of alignment slack (T_{j-1}, T_j and T_{j+1} of the
    CTA's rows live in registers)."""
    kb = -(-N // KEYS)
    mp = _round_up(m, 8)
    rb = -(-rows // 16)
    ks = max(1, 8 // -(-rb // 2))
    return (1024 + kb * rows * 128 + (1024 if rows % 16 else 0) + mp * (kb * KEYS + 8) * 2
            + ks * rb * 16 * mp * 4 + 3 * mp * 4 + 8 * mp * 4 + 32)


def stream_smem(key_window: int) -> int:
    """Shared bytes of the streaming build (`stream_layout`): the ring, one
    column group's staged window, the four warp groups' partial sums,
    maxima, scale factors, mbarriers, slack."""
    return (1024 + STREAM_STAGES * 64 * 128 + 8 * (key_window + 8) * 2 + 4 * 64 * 8 * 4
            + 8 * 4 + 8 * 4 + 2 * STREAM_STAGES * 8)


def _resident_cost(B: int, N: int, m: int, rows: int, cluster: int, at_once: tuple) -> float:
    """A chain's time in cycles a step, modelled on the H100's readings
    (an ablation build's clock64 timeline at b24 N=900, from the card runs
    of the CHANGES.md entry that opens "redesigned kernel 2 (the Chebyshev
    filter"): ~3,000 cycles of exchange and bookkeeping a step, ~2,000 of
    products for a warp that multiplies two row blocks by a quarter of the
    keys): waves x (fixed + exchange + products),
    the exchange and products growing with N and the column groups, the
    products with the row blocks a warp takes."""
    groups = -(-m // 8)
    pairs = -(-(-(-rows // 16)) // 2)           # a warp multiplies two row blocks
    ks = max(1, 8 // pairs)
    per_warp = -(-pairs * ks // 8) * 2 / ks     # row blocks x key share a warp multiplies
    waves = -(-B // at_once[cluster])
    return waves * (1500 + groups * N / 900 * (1500 + 4000 * per_warp))


@functools.lru_cache(maxsize=256)
def cheb_filter_plan(B: int, N: int, m: int, sms: int = CARD_SMS,
                     at_once: tuple = H100_CLUSTERS_AT_ONCE) -> ChebPlan:
    """The build, cluster size and rows per CTA for a (B, N, m) chain on a
    card of `sms` SMs that holds `at_once[k]` clusters of k CTAs at once.
    Resident when a cluster of at most RESIDENT_MAX_CLUSTER CTAs, every one
    with rows, holds the image's operator (rows per CTA a multiple of 8, at
    most 256, the TMA box's limit, and rows x m within what its threads keep
    in registers): of those, the one `_resident_cost` finds fastest (ties:
    the larger cluster). Else streaming: one CTA an SM (at most one a row
    block), every image streamed at every step."""
    if min(B, N, m) < 1:
        raise ValueError(f"empty chain: B={B}, N={N}, m={m}")
    best = None
    for rows in range(8, 257, 8):
        cluster = -(-N // rows)
        if cluster > RESIDENT_MAX_CLUSTER or (cluster - 1) * rows >= N and cluster > 1:
            continue
        if rows * _round_up(m, 8) > RESIDENT_UNITS or \
                resident_smem(N, m, rows, cluster) > SMEM_MAX:
            continue
        key = (_resident_cost(B, N, m, rows, cluster, at_once), -cluster)
        if best is None or key < best[0]:
            best = (key, rows, cluster)
    if best is not None:
        _, rows, cluster = best
        return ChebPlan("resident", cluster, rows, resident_smem(N, m, rows, cluster),
                        B * cluster, 0)
    ctas = min(sms, B * -(-N // 16))
    window = min(_round_up(N, KEYS), STREAM_KEY_WINDOW)
    return ChebPlan("streaming", 1, 64, stream_smem(window), ctas, window)


def first_streamed_n(B: int, m: int) -> int:
    """The smallest N (a multiple of 8) the plan streams: one past the
    resident build's limit at that batch and block width."""
    return next(n for n in range(8, 1 << 16, 8) if cheb_filter_plan(B, n, m).build != "resident")


def cheb_row_ranges(plan: ChebPlan, B: int, N: int, reverse: bool = False) -> list:
    """The operator rows each CTA owns, as the kernel splits them:
    [(cta, image, lo, hi)]. Resident: CTA `rank` of image b's cluster owns
    [rank rows, +rows). Streaming: the images' row blocks of 16, in order,
    split evenly over the CTAs in contiguous ranges, each cut into segments
    at image ends and every 4 blocks, from its first block or, as the kernel
    traverses them on even steps (`reverse`), from its last."""
    out = []
    if plan.build == "resident":
        for b in range(B):
            for rank in range(plan.cluster):
                lo = rank * plan.rows
                if lo < N:
                    out.append((b * plan.cluster + rank, b, lo, min(lo + plan.rows, N)))
        return out
    rbi = -(-N // 16)
    tot = B * rbi
    for cta in range(plan.ctas):
        first, end = cta * tot // plan.ctas, (cta + 1) * tot // plan.ctas
        blk = first
        while blk < end and not reverse:
            b, rb = divmod(blk, rbi)
            nb = min(4, rbi - rb, end - blk)
            out.append((cta, b, rb * 16, min(rb * 16 + nb * 16, N)))
            blk += nb
        while end > first and reverse:
            b, last = divmod(end - 1, rbi)
            nb = min(4, last + 1, end - first)
            out.append((cta, b, (last + 1 - nb) * 16, min((last + 1) * 16, N)))
            end -= nb
    return out


def _kernel_layout(S: torch.Tensor) -> bool:
    B, N, _ = S.shape
    return (S.dtype == torch.bfloat16 and S.stride(2) == 1 and S.stride(1) % 8 == 0
            and S.stride(1) >= N and S.stride(0) % 8 == 0
            and (B == 1 or S.stride(0) >= N * S.stride(1)) and S.data_ptr() % 16 == 0)


def kernel_operator(S: torch.Tensor) -> torch.Tensor:
    """S (B, N, N) as the kernel reads it: bf16 with 16-byte aligned rows
    (the TMA map's row stride must be a multiple of 16 bytes). S itself when
    it is so; else one copy (cast to bf16 on the way) into a (B, N,
    roundup(N, 8)) buffer, returned as its (B, N, N) view. The solver builds
    its operator this way, so the main path never copies here."""
    if _kernel_layout(S):
        return S
    B, N, _ = S.shape
    buf = torch.empty((B, N, _round_up(N, 8)), dtype=torch.bfloat16, device=S.device)
    view = buf[:, :, :N]
    view.copy_(S)
    return view


def _per_image(x: Scalar, B: int, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(-1).expand(B)


def chebyshev_filter_plain(S: torch.Tensor, X: torch.Tensor, c: Scalar,
                           e: Scalar, degree: int) -> torch.Tensor:
    """Plain PyTorch twin: the operator product is `S.float() @
    bf16(t).float()` (operands rounded to S's dtype, f32 accumulation, as the
    TPU kernel does), not torch's reduced-precision-output matmul.
    S (B, N, N), X (B, N, m) f32, c/e scalars or (B,). Returns (B, N, m) f32."""
    if degree < 1:
        raise ValueError("degree must be >= 1")
    B = X.shape[0]
    c = _per_image(c, B, X.device)[:, None, None]
    inv_e = 1.0 / _per_image(e, B, X.device)[:, None, None]
    Sf = S.float()

    def a_shift(t):
        st = Sf @ t.to(S.dtype).float()
        return ((1.0 - c) * t - st) * inv_e

    one = torch.ones((), dtype=torch.float32, device=X.device)
    t0 = X.float()
    t1 = a_shift(t0)
    for _ in range(degree - 1):
        t2 = 2.0 * a_shift(t1) - t0
        sc = 1.0 / torch.maximum(t2.abs().amax(dim=1, keepdim=True), one)
        t0, t1 = t1 * sc, t2 * sc
    return t1


def _checked(S: torch.Tensor, X: torch.Tensor, c: Scalar, e: Scalar):
    B, N, m = X.shape
    if S.dtype != torch.bfloat16 or X.dtype != torch.float32:
        raise TypeError(f"cheb kernel takes bf16 S and f32 X; got {S.dtype}, {X.dtype}")
    if tuple(S.shape) != (B, N, N):
        raise ValueError(f"S shape {tuple(S.shape)} != {(B, N, N)}")
    if S.device != X.device:
        raise ValueError(f"S is on {S.device}, X on {X.device}")
    if isinstance(c, (int, float)) and isinstance(e, (int, float)):
        # filled on the device: no blocking copy of two host scalars a call
        ce = torch.empty((B, 2), dtype=torch.float32, device=X.device)
        ce[:, 0].fill_(c)
        ce[:, 1].fill_(e)
    else:
        ce = torch.stack([_per_image(c, B, X.device), _per_image(e, B, X.device)],
                         dim=1).contiguous()
    return X.contiguous(), ce


_CARDS: dict = {}


def card_clusters_at_once(device: torch.device) -> tuple:
    """(SMs, clusters of each size 1-16 held at once at one CTA an SM) of
    the card, asked once per device (cudaOccupancyMaxActiveClusters at the
    largest shared memory a CTA can take); the wrapper plans with it."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _CARDS:
        from .. import _build
        lib = _build.load()
        out = ctypes.c_int(0)
        at_once = [0]
        with torch.cuda.device(index):
            for cluster in range(1, RESIDENT_MAX_CLUSTER + 1):
                err = lib.dss_cheb_clusters_at_once(cluster, SMEM_MAX, ctypes.byref(out))
                _build.check(err, "cheb_filter clusters at once")
                at_once.append(out.value)
        _CARDS[index] = (torch.cuda.get_device_properties(index).multi_processor_count,
                         tuple(at_once))
    return _CARDS[index]


def chebyshev_filter(S: torch.Tensor, X: torch.Tensor, c: Scalar, e: Scalar,
                     degree: int) -> torch.Tensor:
    """T_degree(((I - S) - c) / e) X per image.

    S: (B, N, N) whitened operator; X: (B, N, m) f32; c, e: window
    parameters, scalars or per image (B,). CPU tensors run the plain twin.
    CUDA tensors run the kernel, which takes a bf16 S (rows not 16-byte
    aligned are copied once, `kernel_operator`) and f32 X, any m (in groups
    of 8 columns), any N and B. Returns a new (B, N, m) f32 tensor.

    One launch per call, in the build `cheb_filter_plan` picks;
    `chebyshev_filter.launches` counts them."""
    if degree < 1:
        raise ValueError("degree must be >= 1")
    if not X.is_cuda:
        return chebyshev_filter_plain(S, X, c, e, degree)
    B, N, m = X.shape
    X, ce = _checked(S, X, c, e)
    plan = cheb_filter_plan(B, N, m, *card_clusters_at_once(X.device))
    out = launch_plan(kernel_operator(S), X, ce, degree, plan)
    chebyshev_filter.launches += 1
    return out


def launch_plan(S: torch.Tensor, X: torch.Tensor, ce: torch.Tensor, degree: int,
                plan: ChebPlan, lib=None) -> torch.Tensor:
    """One launch of the kernel under `plan` (no checks, no count):
    `chebyshev_filter`'s launch, and the probes' with other plans or another
    build of the library (`lib`). S in the kernel's layout
    (`kernel_operator`), X contiguous f32, ce (B, 2)."""
    B, N, m = X.shape
    out = torch.empty((B, N, m), dtype=torch.float32, device=X.device)
    from .. import _build
    lib = lib or _build.load()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.build == "resident":
            tg = torch.empty((B, _round_up(m, 8), _round_up(N, 8)), dtype=torch.bfloat16,
                             device=X.device)
            err = lib.dss_cheb_filter_resident(
                S.data_ptr(), S.stride(1), S.stride(0), X.data_ptr(), ce.data_ptr(),
                out.data_ptr(), tg.data_ptr(), B, N, m, degree, plan.cluster, plan.rows,
                plan.smem, stream)
        else:
            # the last two steps' unscaled T and each row's scaled T_{j-1}
            # (f32, transposed), and the grid barrier's counter + each step's
            # column maxima
            mp = _round_up(m, 8)
            work = torch.empty((3, B, mp, _round_up(N, KEYS)), dtype=torch.float32,
                               device=X.device)
            flags = torch.empty(1 + (degree + 1) * B * mp, dtype=torch.int32, device=X.device)
            err = lib.dss_cheb_filter_stream(
                S.data_ptr(), S.stride(1), S.stride(0), X.data_ptr(), ce.data_ptr(),
                out.data_ptr(), work.data_ptr(), flags.data_ptr(), B, N, m, degree, plan.ctas,
                plan.key_window, plan.smem, stream)
    _build.check(err, "chebyshev_filter")
    return out


chebyshev_filter.launches = 0


def chebyshev_filter_mma(S: torch.Tensor, X: torch.Tensor, c: Scalar, e: Scalar,
                         degree: int) -> torch.Tensor:
    """The earlier build of the kernel (`csrc/cheb_filter.cu`: mma.sync,
    one launch per step plus a last rescale pass, the operator re-read every
    step), kept as the yardstick of `chebyshev_filter`; no path calls it.
    CUDA tensors only; `chebyshev_filter_mma.launches` counts calls."""
    if degree < 1:
        raise ValueError("degree must be >= 1")
    if not X.is_cuda:
        raise ValueError("chebyshev_filter_mma runs on CUDA tensors only")
    B, N, m = X.shape
    X, ce = _checked(S, X, c, e)
    # the kernel's vector loads need 16-byte aligned bases
    S, X = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (S.contiguous(), X))
    out = torch.empty((B, N, m), dtype=torch.float32, device=X.device)
    # T_{j-1} and the two alternating unscaled T_j, and each step's column maxima
    work = torch.empty((3, B, N, m), dtype=torch.float32, device=X.device)
    colmax = torch.empty((degree + 1, B, m), dtype=torch.int32, device=X.device)
    from .. import _build
    lib = _build.load()
    with torch.cuda.device(X.device):
        err = lib.dss_cheb_filter_mma(
            S.data_ptr(), X.data_ptr(), ce.data_ptr(), out.data_ptr(), work.data_ptr(),
            colmax.data_ptr(), B, N, m, degree, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "chebyshev_filter_mma")
    chebyshev_filter_mma.launches += 1
    return out


chebyshev_filter_mma.launches = 0
