"""The port's stage-2 ops against the JAX package: affinity, the Chebyshev
filter twin (vs the Pallas kernel in interpret mode), sign fix, the dense
Laplacian, the Chebyshev solver (JAX's own start block passed in) and
spectral_decompose_batched in every which_matrix mode and on the
color-fused graph, on image-structured graphs. (The CUDA filter kernel
against the twin: tests/test_torch_cuda.py; LOBPCG: tests/test_torch_lobpcg.py.)

Tolerances: the affinity and dense paths are f32 throughout, 1e-5/1e-6. The
filter twin and the Pallas kernel both take bf16 operands with f32
accumulation; they differ in summation order only, and a last-bit change can
flip one bf16(T_j) rounding downstream: 1e-4 on |T_d| <= 1. Solver
eigenvalues agree to 1e-4 and eigenvector |cosines| to 0.999 (the residual
guard's 2e-3 bounds what either side can leave unconverged). The affinity
modes are one dense eigh (or SVD) of an f32 matrix of norm up to ~500 on
each side: eigenvalues to 1e-5 relative, vectors to |cosine| 0.999.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_spectral_tpu.ops import affinity as ja
from deep_spectral_tpu.ops import eigen as je
from deep_spectral_tpu.ops.cheb_filter import chebyshev_filter as j_cheb
from deep_spectral_tpu.ops.cheb_filter import fits_vmem
from deep_spectral_tpu_torch.ops import affinity as ta
from deep_spectral_tpu_torch.ops import eigen as te
from deep_spectral_tpu_torch.ops.cheb_filter import (chebyshev_filter,
                                                     chebyshev_filter_plain)

sys.path.insert(0, str(Path(__file__).parent))
from test_solver_lobpcg import _smooth_features  # noqa: E402

K, M = 5, 8


def _graphs(seeds, hw):
    feats = np.stack([_smooth_features(np.random.default_rng(s), *hw) for s in seeds])
    W = ta.feature_affinity(torch.from_numpy(feats), max_normalize=False)
    ws = 1.0 / W.amax(dim=(-2, -1))
    d = W.sum(-1) * ws[:, None]
    return feats, W, torch.where(d < 1e-12, 1.0, d), ws


def _jax_start_block(N):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (N, M), jnp.float32))


def _abs_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs((a * b).sum(-1)) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_affinity_matches_jax(rng):
    feats = rng.standard_normal((2, 50, 24)).astype(np.float32)
    mask = np.ones((2, 50), bool)
    mask[1, 31:] = False
    np.testing.assert_allclose(ta.l2_normalize(torch.from_numpy(feats)).numpy(),
                               np.asarray(ja.l2_normalize(jnp.asarray(feats))), atol=1e-6)
    for kw in (dict(), dict(max_normalize=False), dict(threshold_at_zero=False)):
        for b in range(2):
            ref = np.asarray(ja.feature_affinity(jnp.asarray(feats[b]),
                                                 mask=jnp.asarray(mask[b]), **kw))
            got = ta.feature_affinity(torch.from_numpy(feats), mask=torch.from_numpy(mask),
                                      **kw)[b].numpy()
            np.testing.assert_allclose(got, ref, atol=1e-6)
            np.testing.assert_allclose(ta.degree_vector(torch.from_numpy(got)).numpy(),
                                       np.asarray(ja.degree_vector(jnp.asarray(got))),
                                       rtol=1e-5)


@pytest.mark.parametrize("side,degree", [(14, 3), (16, 10)])
def test_cheb_twin_matches_pallas(side, degree):
    N = side * side
    _, W, d, ws = _graphs([N, N + 1], (side, side))
    s = torch.rsqrt(d) * torch.sqrt(ws)[:, None]
    S = (s[:, :, None] * W * s[:, None, :]).to(torch.bfloat16)
    X = torch.from_numpy(np.random.default_rng(N).standard_normal((2, N, M)).astype(np.float32))
    if degree == 3:
        c, e = torch.tensor([2.0, 2.0]), torch.tensor([1.0, 1.0])
    else:
        c, e = torch.tensor([1.52, 1.1]), torch.tensor([0.48, 0.9])
    got = chebyshev_filter_plain(S, X, c, e, degree)
    assert torch.equal(got, chebyshev_filter(S, X, c, e, degree))  # CPU wrapper = twin
    S_j = jnp.asarray(S.float().numpy()).astype(jnp.bfloat16)
    for b in range(2):
        ref = np.asarray(j_cheb(S_j[b], jnp.asarray(X[b].numpy()), float(c[b]), float(e[b]),
                                degree=degree, interpret=True))
        np.testing.assert_allclose(got[b].numpy(), ref, atol=1e-4)



def _filter_by_steps(S, X, c, e, degree, slab=64):
    """The mma.sync build's decomposition of the chain (`csrc/cheb_filter.cu`,
    kept as the yardstick of the Hopper kernel, whose schedules
    tests/test_torch_cheb_sm90.py renders), in plain torch:
    one pass per step over slabs of `slab` operator rows. A step reads the
    previous step's unscaled output R and its column maxima, turns them into
    the factor, scales R (and the carried T_{j-1}, buffer A) in f32 and only
    then rounds to bf16 for the product; it writes T_{j+1} unscaled, the
    scaled T_j back into A (own rows) and the |T_{j+1}| maxima of its rows.
    A last pass applies the last factor."""
    B, N, m = X.shape
    c = c[:, None, None]
    inv_e = 1.0 / e[:, None, None]
    one = torch.ones(())

    def factor(colmax):
        return 1.0 / torch.maximum(colmax, one)         # NaN propagates

    def step(src, sc, a_in, first):
        t1 = src * sc
        tb = t1.to(torch.bfloat16).float()              # rounded after the scaling
        w, a_out, maxima = torch.empty_like(src), torch.empty_like(src), []
        for r0 in range(0, N, slab):
            rows = slice(r0, min(r0 + slab, N))
            y = S[:, rows].float() @ tb
            a = ((1.0 - c) * t1[:, rows] - y) * inv_e
            w[:, rows] = a if first else 2.0 * a - a_in[:, rows] * sc
            a_out[:, rows] = t1[:, rows]
            maxima.append(w[:, rows].abs().amax(dim=1, keepdim=True))
        return w, a_out, torch.stack(maxima).amax(dim=0)

    ones = torch.ones((B, 1, m))
    R, _, _ = step(X, ones, None, True)                 # T_1: no rescale
    if degree == 1:
        return R
    A, sc = X, ones
    for _ in range(2, degree + 1):
        R, A, colmax = step(R, sc, A, False)
        sc = factor(colmax)
    return R * sc


@pytest.mark.parametrize("N,m,degree", [(37, 5, 1), (37, 13, 3), (37, 5, 10),
                                        (130, 13, 10), (130, 5, 3), (130, 13, 1)])
def test_cheb_kernel_step_order(N, m, degree):
    """The mma.sync build's step order (the factor carried into the next step and
    applied before the bf16 rounding, then a final scaling pass) against the
    twin and the Pallas kernel (interpret mode), on the same numpy inputs, N
    not a multiple of the 64-row slab, one column holding a NaN. The
    decomposition performs the twin's f32 operations in the twin's order, so
    it matches the twin bit for bit (NaNs in the same places); against the
    Pallas kernel the two differ in summation order only: 1e-4 on |T_d| <= 1,
    as for the twin."""
    rng = np.random.default_rng(N * m + degree)
    feats = rng.standard_normal((2, N, 16)).astype(np.float32)
    W = ta.feature_affinity(torch.from_numpy(feats))
    s = torch.rsqrt(ta.degree_vector(W))
    S = (s[:, :, None] * W * s[:, None, :]).to(torch.bfloat16)
    X_np = rng.standard_normal((2, N, m)).astype(np.float32)
    X_np[1, N // 2, m - 1] = np.nan
    X = torch.from_numpy(X_np)
    c, e = torch.tensor([1.52, 2.0]), torch.tensor([0.48, 1.0])
    got = _filter_by_steps(S, X, c, e, degree)
    ref = chebyshev_filter_plain(S, X, c, e, degree)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.isnan(got[1, :, m - 1]).all() and not torch.isnan(got[:, :, :m - 1]).any()
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))
    S_j = jnp.asarray(S.float().numpy()).astype(jnp.bfloat16)
    for b in range(2):
        j_ref = np.asarray(j_cheb(S_j[b], jnp.asarray(X_np[b]), float(c[b]), float(e[b]),
                                  degree=degree, interpret=True))
        np.testing.assert_allclose(got[b].numpy(), j_ref, atol=1e-4)

def test_sign_fix_matches_jax(rng):
    v = rng.standard_normal((3, 4, 30)).astype(np.float32)
    v[0, 0] = np.abs(v[0, 0])  # all positive: never flipped
    mask = rng.random((3, 30)) > 0.3
    got = te.sign_fix(torch.from_numpy(v), torch.from_numpy(mask)).numpy()
    for b in range(3):
        np.testing.assert_array_equal(got[b], np.asarray(je.sign_fix(jnp.asarray(v[b]),
                                                                     jnp.asarray(mask[b]))))
    np.testing.assert_array_equal(te.sign_fix(torch.from_numpy(v[0])).numpy(),
                                  np.asarray(je.sign_fix(jnp.asarray(v[0]))))


@pytest.mark.parametrize("lapnorm", [True, False])
def test_dense_laplacian_matches_jax(lapnorm):
    _, W, d, ws = _graphs([3], (14, 14))
    mask = np.ones(196, bool)
    mask[180:] = False
    m = torch.from_numpy(mask)
    Wm = W * m[None, :, None] * m[None, None, :]
    dm = Wm.sum(-1) * ws[:, None]
    dm = torch.where(dm < 1e-12, 1.0, dm)
    ev, vec = te._dense_laplacian(Wm, dm, K, lapnorm, m[None], True, ws)
    jev, jvec = je._dense_laplacian(jnp.asarray(Wm[0].numpy()), jnp.asarray(dm[0].numpy()),
                                    K, lapnorm, jnp.asarray(mask), True, w_scale=float(ws[0]))
    # f32 eigh is accurate to ~eps * ||A||: ||A|| <= 2 whitened, ~20 for D - W
    np.testing.assert_allclose(ev[0].numpy(), np.asarray(jev), atol=1e-5 if lapnorm else 1e-4)
    assert _abs_cos(vec[0].numpy(), np.asarray(jvec)).min() > 0.9999
    assert not vec[0, :, 180:].any()


# Three 24x24 graphs whose Chebyshev solves need 2, 3 and 2 outer iterations
# under each window init.
HW = (24, 24)
LANES = {"wide": [0, 11, 1], "estimate": [0, 15, 1]}


def _port_solve(W, d, ws, window_init, x0, n_outer=4):
    return te._chebyshev_laplacian(W, d, K, M, n_outer, 10, None, True, w_scale=ws,
                                   window_init=window_init, x0=x0)


@pytest.mark.parametrize("window_init", ["wide", "estimate"])
def test_chebyshev_solver_matches_jax(window_init):
    """Same start block, same filter arithmetic: eigenpairs and residuals
    agree with the JAX solver's vmapped while_loop; each lane runs outer
    iterations until its own residual passes the guard, then freezes, so a
    lane alone gives what it gives in the batch.

    Per-lane outer counts are compared with JAX under 'estimate' (the
    3-outer lane misses the guard after 2 outers by 1.4x in both). Under
    'wide' the first degree-10 filter amplifies the bottom of the spectrum
    ~1e7-fold, so the block's upper directions sit at f32 rounding level and
    whether a lane needs 2 or 3 outers depends on rounding: on these 16-graph
    sets JAX and the port each take 3 outers on a different single lane."""
    lanes = LANES[window_init]
    _, W, d, ws = _graphs(lanes, HW)
    x0 = _jax_start_block(W.shape[-1])
    ev, vec, res, outers = _port_solve(W, d, ws, window_init, x0)
    assert outers.tolist() == [2, 3, 2]
    own = [_port_solve(W, d, ws, window_init, x0, n)[2] for n in (1, 2)]
    assert [next(n + 1 for n, r in enumerate(own + [res]) if r[b] <= te.CHEB_RESIDUAL_TOL)
            for b in range(len(lanes))] == outers.tolist()

    def jax_solve(n_outer):
        f = lambda W_, d_, ws_: je._chebyshev_laplacian(
            W_, d_, K, M, n_outer, 10, None, True, w_scale=ws_, filter_impl="pallas",
            window_init=window_init)
        return [np.asarray(o) for o in jax.vmap(f)(
            jnp.asarray(W.numpy()), jnp.asarray(d.numpy()), jnp.asarray(ws.numpy()))]

    jev, jvec, jres = jax_solve(4)
    assert jres.max() <= te.CHEB_RESIDUAL_TOL
    np.testing.assert_allclose(ev.numpy(), jev, atol=1e-4)
    np.testing.assert_allclose(res.numpy(), jres, rtol=0.05)
    assert _abs_cos(vec.numpy(), jvec).min() > 0.999
    if window_init == "estimate":
        jres_by_budget = [jax_solve(n)[2] for n in (1, 2)] + [jres]
        j_outers = [next(n + 1 for n, r in enumerate(jres_by_budget)
                         if r[b] <= te.CHEB_RESIDUAL_TOL) for b in range(len(lanes))]
        assert j_outers == outers.tolist()

    for b in range(len(lanes)):  # lane freezing
        ev1, vec1, res1, out1 = _port_solve(W[b:b + 1], d[b:b + 1], ws[b:b + 1],
                                            window_init, x0)
        assert out1.item() == outers[b].item()
        np.testing.assert_allclose(ev1[0].numpy(), ev[b].numpy(), atol=1e-6)
        np.testing.assert_allclose(vec1[0].numpy(), vec[b].numpy(), atol=1e-6)


def test_spectral_decompose_batched_matches_jax():
    """Masked (bucket-padded) features through affinity, deferred
    max-normalization, the chebyshev solve and, with cheb_degree=1, the
    per-image eigh guard."""
    feats, *_ = _graphs([7, 8], HW)
    mask = np.ones((2, 24, 24), bool)
    mask[1, 21:, :] = False
    mask = mask.reshape(2, -1)
    feats[1][~mask[1]] = 5.0  # garbage in the padding
    x0 = _jax_start_block(feats.shape[1])
    f_t, m_t = torch.from_numpy(feats), torch.from_numpy(mask)
    jf, jm = jnp.asarray(feats), jnp.asarray(mask)
    ev, vec, res = te.spectral_decompose_batched(f_t, m_t, K=K, return_residual=True, x0=x0)
    jev, jvec, jres = (np.asarray(o) for o in je.spectral_decompose_batched(
        jf, jm, K=K, cheb_filter_impl="pallas", return_residual=True))
    assert res.max().item() <= te.CHEB_RESIDUAL_TOL
    np.testing.assert_allclose(ev.numpy(), jev, atol=1e-4)
    assert _abs_cos(vec.numpy(), jvec).min() > 0.999
    assert not vec[1][:, ~mask[1]].any()
    # degree-1 filters cannot converge: the guard re-solves both with eigh
    ev1, vec1 = te.spectral_decompose_batched(f_t, m_t, K=K, cheb_degree=1, x0=x0)
    jev1, jvec1 = (np.asarray(o) for o in je.spectral_decompose_batched(
        jf, jm, K=K, cheb_filter_impl="pallas", cheb_degree=1))
    ev_e, vec_e = te.spectral_decompose_batched(f_t, m_t, K=K, solver="eigh")
    np.testing.assert_array_equal(ev1.numpy(), ev_e.numpy())
    np.testing.assert_allclose(ev1.numpy(), jev1, atol=1e-5)
    assert _abs_cos(vec1.numpy(), jvec1).min() > 0.9999
    ev_s, vec_s = te.spectral_decompose(f_t[0], K, mask=m_t[0], x0=x0)
    np.testing.assert_allclose(ev_s.numpy(), ev[0].numpy(), atol=1e-6)


def test_guard_resolves_non_finite_lobpcg_lanes(monkeypatch):
    """The solver's one fallback covers LOBPCG too: a lane whose result is
    not finite is re-solved with eigh, the other lane is left as solved."""
    feats, *_ = _graphs([7, 8], HW)
    f_t = torch.from_numpy(feats)
    solve = te._lobpcg_laplacian

    def one_nan_lane(*a, **kw):
        evals, vectors = solve(*a, **kw)
        return evals, torch.where(torch.arange(2)[:, None, None] == 1, torch.nan, vectors)

    monkeypatch.setattr(te, "_lobpcg_laplacian", one_nan_lane)
    ev, vec = te.spectral_decompose_batched(f_t, K=K, solver="lobpcg")
    _, vec_raw, _ = te.spectral_decompose_batched(f_t, K=K, solver="lobpcg",
                                                  return_residual=True)
    ev_e, vec_e = te.spectral_decompose_batched(f_t, K=K, solver="eigh")
    assert torch.isnan(vec_raw[1]).all() and torch.isfinite(vec).all()
    np.testing.assert_array_equal(ev[1].numpy(), ev_e[1].numpy())
    np.testing.assert_array_equal(vec[1].numpy(), vec_e[1].numpy())
    np.testing.assert_array_equal(vec[0].numpy(), vec_raw[0].numpy())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Parallel test workers each get one torch thread: with torch's default
    (all cores) per worker, the workers oversubscribe the CPU many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_solver_selection_matches_jax():
    """The chebyshev admission is the JAX package's fits_vmem boundary, and
    'auto' picks the same solver as the JAX package at every size."""
    admitted = [n for n in range(3000, 4500) if fits_vmem(n, m=M)]
    assert max(admitted) == te.CHEB_MAX_N
    assert max(n for n in range(3000, 4500) if fits_vmem(n, m=23)) == te.CHEB_MAX_N
    for N in (100, 511, 512, 900, 2048, 3600, 3856, 3857, 5000):
        for lapnorm in (True, False):
            for m in (M, 23):
                assert (te._resolve_solver(N, m, lapnorm, "auto")
                        == je._resolve_solver(N, m, lapnorm, "auto")), (N, lapnorm, m)


def test_unported_paths_raise():
    """What still raises is a caller's error; the graphs and solvers that
    raised NotImplementedError before run (LOBPCG for lapnorm=False at
    N=600, an affinity mode, the color-fused graph)."""
    with pytest.raises(ValueError):
        te.laplacian_eigs(torch.eye(8), 2, cheb_window_init="narrow")
    f = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 600, 8)).astype(np.float32))
    with pytest.raises(ValueError):
        te.spectral_decompose_batched(f[:, :100], which_matrix="laplacian_sym")
    outs = [te.spectral_decompose_batched(f, lapnorm=False, K=3),
            te.spectral_decompose_batched(f[:, :100], which_matrix="affinity", K=3),
            te.spectral_decompose_batched(f[:, :100], torch.ones((1, 100), dtype=torch.bool),
                                          torch.eye(100)[None], image_color_lambda=1.0, K=3)]
    for (ev, vec), n in zip(outs, (600, 100, 100)):
        assert ev.shape == (1, 3) and vec.shape == (1, 3, n)
        assert torch.isfinite(ev).all() and torch.isfinite(vec).all()


def _masked_batch():
    feats, *_ = _graphs([7, 8], HW)
    mask = np.ones((2, 24, 24), bool)
    mask[1, 21:, :] = False
    mask = mask.reshape(2, -1)
    feats[1][~mask[1]] = 5.0  # garbage in the padding
    return feats, mask


@pytest.mark.parametrize("which_matrix", ["affinity", "affinity_torch", "affinity_svd",
                                          "matting_laplacian"])
def test_which_matrix_modes_match_jax(which_matrix):
    """The reference's other eigen modes, masked and batched: the affinity
    modes' ascending values with descending vectors, the SVD mode, and
    'matting_laplacian' down the laplacian branch (its chebyshev solve from
    JAX's start block)."""
    feats, mask = _masked_batch()
    ev, vec, res = te.spectral_decompose_batched(
        torch.from_numpy(feats), torch.from_numpy(mask), K=K, which_matrix=which_matrix,
        return_residual=True, x0=_jax_start_block(feats.shape[1]))
    jev, jvec, jres = (np.asarray(o) for o in je.spectral_decompose_batched(
        jnp.asarray(feats), jnp.asarray(mask), K=K, which_matrix=which_matrix,
        return_residual=True))
    if which_matrix == "matting_laplacian":
        assert res.max().item() <= te.CHEB_RESIDUAL_TOL and 0 < jres.max() <= te.CHEB_RESIDUAL_TOL
        np.testing.assert_allclose(ev.numpy(), jev, atol=1e-4)
    else:
        assert not res.any() and not jres.any()
        np.testing.assert_allclose(ev.numpy(), jev, rtol=1e-5)
        if which_matrix != "affinity_svd":
            assert (np.diff(ev.numpy(), axis=1) >= 0).all()  # ascending values
    assert _abs_cos(vec.numpy(), jvec).min() > 0.999
    if which_matrix != "affinity_svd":
        assert not vec[1][:, ~mask[1]].any()


@pytest.mark.parametrize("color", ["knn", "rw"])
def test_color_fused_matches_jax(color):
    """W = W_feat / max + lambda W_color (extract/extract.py:199-221) on
    bucket-padded images, the color graph from the port's own affinity."""
    from deep_spectral_tpu_torch.ops import affinity as ta_
    feats, mask = _masked_batch()
    imgs = np.random.default_rng(0).random((2, 24, 24, 3)).astype(np.float32)
    imgs[:, 5:12, 6:15] = [0.9, 0.2, 0.1]
    m_t = torch.from_numpy(mask)
    cw = getattr(ta_, f"{color}_affinity")(torch.from_numpy(imgs), mask=m_t)
    ev, vec, res = te.spectral_decompose_batched(
        torch.from_numpy(feats), m_t, cw, K=K, image_color_lambda=2.0,
        return_residual=True, x0=_jax_start_block(feats.shape[1]))
    jev, jvec, jres = (np.asarray(o) for o in je.spectral_decompose_batched(
        jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(cw.numpy()), K=K,
        image_color_lambda=2.0, return_residual=True))
    assert res.max().item() <= te.CHEB_RESIDUAL_TOL and jres.max() <= te.CHEB_RESIDUAL_TOL
    np.testing.assert_allclose(ev.numpy(), jev, atol=1e-4)
    assert _abs_cos(vec.numpy(), jvec).min() > 0.999
    assert not vec[1][:, ~mask[1]].any()
    ev0, _ = te.spectral_decompose_batched(torch.from_numpy(feats), m_t, K=K,
                                           x0=_jax_start_block(feats.shape[1]))
    assert (ev0 - ev).abs().max() > 1e-3  # the color graph changed the spectrum


def test_auto_reaches_lobpcg_above_cheb_max_n(monkeypatch):
    """At N = 63^2 = 3969 (a P=8 backbone at 504^2) 'auto' routes lapnorm
    graphs to LOBPCG in both packages; the port's solve runs (cut to 2
    iterations here) with the auto iteration budget of 100."""
    N = 63 * 63
    assert je._resolve_solver(N, K + 3, True, "auto") == "lobpcg"
    assert te._resolve_solver(N, K + 3, True, "auto") == "lobpcg"
    budgets, orig = [], te._lobpcg_laplacian

    def short(W, d, K_, m_block, iters, *a, **kw):
        budgets.append((W.shape[-1], m_block, iters))
        return orig(W, d, K_, m_block, 2, *a, **kw)

    monkeypatch.setattr(te, "_lobpcg_laplacian", short)
    f = torch.from_numpy(np.random.default_rng(1).standard_normal((1, N, 8)).astype(np.float32))
    ev, vec = te.spectral_decompose_batched(f, K=K)
    assert budgets == [(N, K + 3, 100)]
    assert vec.shape == (1, K, N) and torch.isfinite(vec).all()


def test_laplacian_eigs_single_image_guard():
    """laplacian_eigs on one (N, N) graph: chebyshev with the guard equals
    dense eigh when the filter budget is too small to converge."""
    _, W, d, ws = _graphs([2], HW)
    ev, vec = te.laplacian_eigs(W[0], K, w_scale=ws[0], cheb_degree=1)
    ev_e, vec_e = te.laplacian_eigs(W[0], K, w_scale=ws[0], solver="eigh")
    np.testing.assert_array_equal(ev.numpy(), ev_e.numpy())
    ev_c, vec_c, res_c = te.laplacian_eigs(W[0], K, w_scale=ws[0], return_residual=True)
    assert res_c.item() <= te.CHEB_RESIDUAL_TOL
    np.testing.assert_allclose(ev_c.numpy(), ev_e.numpy(), atol=1e-4)


def _f64_check(W, ws, evals, vectors):
    """Each lane's largest residual ||A v - theta v|| (v the whitened,
    unit-norm vector) and largest eigenvalue gap against the f64 dense
    solve of the same graph."""
    W64 = W.double() * ws.double()[:, None, None]
    sd = torch.sqrt(W64.sum(-1))
    A = torch.eye(W.shape[-1], dtype=torch.float64) - W64 / sd[:, :, None] / sd[:, None, :]
    lam = torch.linalg.eigvalsh(A)[:, :evals.shape[1]]
    v = sd[:, None, :] * vectors.double()
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    res = torch.linalg.vector_norm(v @ A - evals.double()[:, :, None] * v, dim=-1).amax(-1)
    return res, (evals.double() - lam).abs().amax(-1)


@pytest.mark.parametrize("K_", [5, 20])
def test_guard_resumes_lanes_above_the_tolerance(K_):
    """Three 30x30 graphs at K=5 and at the CLI's K=20 (a 23-wide block).
    At K=20 the first round of 4 outers leaves two lanes above the
    tolerance: the guard resumes them (one reaches CHEB_CONTINUE_TOL in the
    second round, one in the third) and re-solves none densely; the lane
    that converged in round 1 keeps its bits. At K=5 every lane converges
    in round 1 and the guarded solve is that round's, bit for bit, after
    one read. Every lane ends under its tolerance against the f64 dense
    solve."""
    from deep_spectral_tpu_torch.utils import profiling
    _, W, d, ws = _graphs([10, 7, 0], (30, 30))
    kw = dict(w_scale=ws, solver="chebyshev")
    ev1, vec1, res1 = te._laplacian_eigs_batched(W, K_, return_residual=True, **kw)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        ev, vec = te._laplacian_eigs_batched(W, K_, **kw)
    recs = profiling.records()
    profiling.clear()
    total = {n: sum(r["counts"].get(n, 0) for r in recs)
             for n in ("eigs.continued", "eigs.resolved", "eigs.images")}
    guard = next(i for i, r in enumerate(recs) if r["name"] == "eigs.guard")
    children = [r["name"] for r in recs if r["parent"] == guard]
    first = res1 <= te.CHEB_RESIDUAL_TOL
    if K_ == 5:
        assert first.all() and children == ["eigs.sync"]
        assert total == {"eigs.continued": 0, "eigs.resolved": 0, "eigs.images": 3}
    else:
        assert first.tolist() == [True, False, False]
        assert children == ["eigs.sync", "eigs.continue", "eigs.sync", "eigs.continue",
                            "eigs.sync"]
        assert total == {"eigs.continued": 2, "eigs.resolved": 0, "eigs.images": 3}
        assert not torch.equal(ev[1:], ev1[1:])
    assert torch.equal(ev[first], ev1[first]) and torch.equal(vec[first], vec1[first])
    res, gap = _f64_check(W, ws, ev, vec)
    assert res[first].max() <= te.CHEB_RESIDUAL_TOL and gap.max() <= 1e-3
    assert first.all() or res[~first].max() <= te.CHEB_CONTINUE_TOL
