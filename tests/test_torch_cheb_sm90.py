"""The Hopper filter kernel's schedule (`csrc/cheb_filter_sm90.cu`) rendered
in torch, and its plan (`ops/cheb_filter.cheb_filter_plan`), on the CPU.

The renderings follow the kernel's decomposition: the resident build, one
cluster an image, each CTA multiplying its slab of operator rows by the whole
staged bf16(T_j), the cluster-wide column maxima as the maximum of the CTAs'
maxima, (T_j, T_{j+1}) of each CTA's rows scaled in f32 before T_{j+1} is
rounded to bf16 for every CTA, the last step's rescale applied before the
result leaves; and the streaming build, the rows of every image split over
the CTAs in segments (`cheb_row_ranges`, cut from the end on even steps),
T_j leaving each step unscaled with its maxima gathered over the segments,
every CTA staging it times the factors and each owner scaling its rows as
it computes T_{j+1}. Each performs the twin's f32
operations in the twin's order (a row's product is the same dot product
whichever slab holds it; a maximum does not depend on the grouping), so it
matches the twin bit for bit, NaNs in the same places; against the Pallas
kernel (interpret mode) on the same numpy inputs the two differ in summation
order only: 1e-4 on |T_d| <= 1, as for the twin (tests/test_torch_eigen.py).
The kernel itself against the twin: tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_spectral_tpu.ops.cheb_filter import chebyshev_filter as j_cheb
from deep_spectral_tpu_torch.ops import affinity as ta
from deep_spectral_tpu_torch.ops import cheb_filter as cf

SMEM_MAX = 232_448


def _operator(rng, B, N):
    feats = rng.standard_normal((B, N, 16)).astype(np.float32)
    W = ta.feature_affinity(torch.from_numpy(feats))
    s = torch.rsqrt(ta.degree_vector(W))
    return (s[:, :, None] * W * s[:, None, :]).to(torch.bfloat16)


def _window(c, e):
    return c[:, None, None], 1.0 / e[:, None, None]


def _a_shift(S_rows, tb, t1_rows, c, inv_e):
    """a_shift of some rows: their slab times the whole staged bf16(T_j)."""
    y = S_rows.float() @ tb
    return ((1.0 - c) * t1_rows - y) * inv_e


def _scale(colmax):
    return 1.0 / torch.maximum(colmax, torch.ones(()))    # NaN propagates


def _resident(S, X, c, e, degree, plan):
    """The resident build: per image a cluster of `plan.cluster` CTAs, CTA
    `rank` owning rows [rank rows, +rows); T_{j-1}, T_j and T_{j+1} of a
    CTA's rows stay with it, bf16(T_j) of every row is staged in each."""
    B, N, m = X.shape
    out = torch.empty_like(X)
    slabs = {}
    for _, b, lo, hi in cf.cheb_row_ranges(plan, B, N):
        slabs.setdefault(b, []).append((lo, hi))
    for b in range(B):
        cb, inv_e = _window(c[b:b + 1], e[b:b + 1])
        ranks = slabs[b]
        t0 = {r: X[b:b + 1, lo:hi] for r, (lo, hi) in enumerate(ranks)}
        t1 = dict(t0)
        tb = X[b:b + 1].to(torch.bfloat16).float()       # T_0 staged
        for step in range(1, degree + 1):
            w = {}
            for r, (lo, hi) in enumerate(ranks):
                a = _a_shift(S[b:b + 1, lo:hi], tb, t1[r], cb, inv_e)
                w[r] = a if step == 1 else 2.0 * a - t0[r]
            if step > 1:
                # each CTA's column maxima, then the cluster's
                sc = _scale(torch.stack([w[r].abs().amax(dim=1, keepdim=True)
                                         for r in w]).amax(dim=0))
                t0 = {r: t1[r] * sc for r in w}
                t1 = {r: w[r] * sc for r in w}
            else:
                t1 = w
            # the scaled rows, rounded to bf16, staged in every CTA
            tb = torch.cat([t1[r] for r in range(len(ranks))], dim=1).to(torch.bfloat16).float()
        out[b] = torch.cat([t1[r] for r in range(len(ranks))], dim=1)[0]
    return out


def _streaming(S, X, c, e, degree, plan):
    """The streaming build: every image's rows in the CTAs' segments (cut
    from the end on even steps, as the kernel traverses them); a step
    leaves T_j unscaled with its column maxima (gathered over the segments of
    an image); after the step's grid barrier every CTA stages bf16(T_j *
    factor) while the owner of each row scales its T_j and T_{j-1} by the
    same factors as it computes T_{j+1}; the result is the last step's rows
    times its factors."""
    B, N, m = X.shape
    cc, inv_e = _window(c, e)
    segs_by_dir = [[(b, lo, hi) for _, b, lo, hi in cf.cheb_row_ranges(plan, B, N, reverse=r)]
                   for r in (False, True)]
    ones = torch.ones((B, 1, m))
    u, f = X.clone(), ones                       # T_0; factors after steps 0 and 1: 1
    t1 = torch.empty_like(X)                     # each owner's scaled T_{j-1}
    for step in range(1, degree + 1):
        segs = segs_by_dir[step % 2 == 0]        # even steps from the end
        tb = (u * f).to(torch.bfloat16).float()  # what every CTA stages
        new = torch.empty_like(X)
        for b, lo, hi in segs:
            rows = u[b:b + 1, lo:hi] * f[b:b + 1]
            a = _a_shift(S[b:b + 1, lo:hi], tb[b:b + 1], rows, cc[b:b + 1], inv_e[b:b + 1])
            new[b:b + 1, lo:hi] = a if step == 1 else 2.0 * a - t1[b:b + 1, lo:hi] * f[b:b + 1]
            t1[b:b + 1, lo:hi] = rows
        u, f = new, ones.clone()
        if step > 1:
            for b in range(B):
                maxima = [u[b:b + 1, lo:hi].abs().amax(dim=1, keepdim=True)
                          for bb, lo, hi in segs if bb == b]
                f[b] = _scale(torch.stack(maxima).amax(dim=0))[0]
    return u * f


@pytest.mark.parametrize("N,m,degree,B", [(37, 5, 1, 2), (37, 13, 3, 1), (37, 23, 10, 2),
                                          (130, 5, 3, 2), (130, 13, 10, 1), (130, 23, 1, 2)])
def test_cheb_sm90_schedule(N, m, degree, B):
    """Both builds' schedules against the twin (bit for bit) and the Pallas
    kernel (1e-4), N not a multiple of the slab, one NaN column when B=2:
    the resident build at its plan and at a cluster of 4 (uneven slabs),
    the streaming build over 7 CTAs (segments crossing images) and over 2
    (ranges cut into segments of 4 row blocks)."""
    rng = np.random.default_rng(N * m + degree + B)
    S = _operator(rng, B, N)
    X_np = rng.standard_normal((B, N, m)).astype(np.float32)
    if B == 2:
        X_np[1, N // 2, m - 1] = np.nan
    X = torch.from_numpy(X_np)
    c, e = torch.tensor([1.52, 2.0][:B]), torch.tensor([0.48, 1.0][:B])
    ref = cf.chebyshev_filter_plain(S, X, c, e, degree)
    plan = cf.cheb_filter_plan(B, N, m)
    assert plan.build == "resident"
    rows4 = -(-(-(-N // 4)) // 8) * 8
    plans = [plan, plan._replace(cluster=-(-N // rows4), rows=rows4)]
    stream = cf.cheb_filter_plan(B, 4096, m)
    renders = [_resident(S, X, c, e, degree, p) for p in plans] + \
        [_streaming(S, X, c, e, degree, stream._replace(ctas=k)) for k in (7, 2)]
    S_j = jnp.asarray(S.float().numpy()).astype(jnp.bfloat16)
    pallas = np.stack([np.asarray(j_cheb(S_j[b], jnp.asarray(X_np[b]), float(c[b]),
                                         float(e[b]), degree=degree, interpret=True))
                       for b in range(B)])
    for got in renders:
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))
        if B == 2:
            assert torch.isnan(got[1, :, m - 1]).all() and not torch.isnan(got[0]).any()
        np.testing.assert_allclose(got.numpy(), pallas, atol=1e-4)


GRID_N = (64, 640, 900, 1024, 1300, 2048, 3600, 4096)


@pytest.mark.parametrize("N", GRID_N)
def test_cheb_plan_grid(N):
    """Every row of every image covered once, shared memory within the card's,
    legal clusters (1-16 CTAs, none without rows, rows a multiple of 8 and at
    most the TMA box's 256), the streaming grid within the card."""
    for m in (8, 23):
        for B in (1, 4, 24):
            plan = cf.cheb_filter_plan(B, N, m)
            assert plan.smem <= SMEM_MAX
            seen = np.zeros((B, N), np.int64)
            for cta, b, lo, hi in cf.cheb_row_ranges(plan, B, N):
                assert 0 <= cta < plan.ctas and lo < hi
                seen[b, lo:hi] += 1
            assert (seen == 1).all(), (B, N, m, plan)
            if plan.build == "resident":
                assert 1 <= plan.cluster <= cf.RESIDENT_MAX_CLUSTER
                assert plan.rows % 8 == 0 and plan.rows <= 256
                assert (plan.cluster - 1) * plan.rows < N <= plan.cluster * plan.rows
                assert plan.rows * -(-m // 8) * 8 <= cf.RESIDENT_UNITS
                assert plan.smem == cf.resident_smem(N, m, plan.rows, plan.cluster)
                assert plan.ctas == B * plan.cluster
            else:
                assert plan.build == "streaming"
                assert 1 <= plan.ctas <= cf.CARD_SMS
                assert plan.key_window % 64 == 0 and plan.key_window <= cf.STREAM_KEY_WINDOW
                assert plan.smem == cf.stream_smem(plan.key_window)


@pytest.mark.parametrize("B,N", [(4, 1288), (24, 2500), (3, 130)])
def test_cheb_stream_reverse_segments(B, N):
    """The streaming build traverses even steps from the end: each CTA's
    segments cut from its last row block cover the rows it owns going
    forward (the owner of a row stays its owner), once each, in at most 4
    blocks and within one image."""
    plan = cf.cheb_filter_plan(B, 4096, 8)._replace(ctas=min(132, B * -(-N // 16)))
    fwd, rev = (cf.cheb_row_ranges(plan, B, N, reverse=r) for r in (False, True))
    owned = {}
    for ranges in (fwd, rev):
        rows = np.zeros((B, N), np.int64)
        for cta, b, lo, hi in ranges:
            assert 0 < hi - lo <= 64
            rows[b, lo:hi] += 1
            owned.setdefault((cta, ranges is rev), set()).update((b, r) for r in range(lo, hi))
        assert (rows == 1).all()
    for cta in range(plan.ctas):
        assert owned.get((cta, False)) == owned.get((cta, True))


def test_cheb_plan_builds():
    """The main path's N=900 and phase 10's N=640 and 1024 (m=8) are
    resident (a 16-CTA cluster is admitted at N=1024's shared memory on the
    H100); phase 9's N=3600 and LOBPCG's 4096 stream."""
    for N in (640, 900, 1024):
        for B in (1, 4, 24):
            assert cf.cheb_filter_plan(B, N, 8).build == "resident"
    for N in (2048, 3600, 4096):
        assert cf.cheb_filter_plan(4, N, 8).build == "streaming"
    assert cf.cheb_filter_plan(24, 900, 8).cluster == 15   # 64 rows, no idle CTA
    assert cf.first_streamed_n(4, 8) == 1288 and cf.first_streamed_n(24, 23) == 1096
    with pytest.raises(ValueError):
        cf.cheb_filter_plan(0, 900, 8)


def test_cheb_plan_takes_the_cards_clusters():
    """The plan ranks cluster sizes by the waves the card's own count of
    clusters at once gives (the wrapper passes the card's answer): the H100's
    record gives 15-CTA clusters at b24 N=900, a card holding one cluster of
    10 or more CTAs at a time gives clusters of at most 9."""
    at_once = cf.H100_CLUSTERS_AT_ONCE
    assert len(at_once) == cf.RESIDENT_MAX_CLUSTER + 1
    assert cf.cheb_filter_plan(24, 900, 8, cf.CARD_SMS, at_once) == \
        cf.cheb_filter_plan(24, 900, 8)
    few_large = at_once[:10] + (1,) * (cf.RESIDENT_MAX_CLUSTER - 9)
    plan = cf.cheb_filter_plan(24, 900, 8, cf.CARD_SMS, few_large)
    assert plan.build == "resident" and plan.cluster <= 9


def test_kernel_operator_layout():
    """The TMA map needs 16-byte rows: N=900 becomes a view of a padded bf16
    buffer (values as .to(bfloat16)), an aligned bf16 operator passes as it
    is."""
    S = torch.randn((2, 900, 900))
    K = cf.kernel_operator(S)
    assert K.dtype == torch.bfloat16 and K.shape == S.shape and K.stride(1) == 904
    assert torch.equal(K, S.to(torch.bfloat16))
    assert cf.kernel_operator(K) is K
    A = torch.randn((2, 64, 64)).to(torch.bfloat16)
    assert cf.kernel_operator(A) is A
    assert cf.kernel_operator(A[:, :, :60]).stride(1) == 64


def test_mma_build_takes_cuda_only():
    """The mma.sync build is the yardstick on the card; on the CPU it raises
    (no twin route: the wrapper that takes CPU tensors is chebyshev_filter)."""
    S = torch.zeros((1, 16, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        cf.chebyshev_filter_mma(S, torch.zeros((1, 16, 8)), 2.0, 1.0, 3)
