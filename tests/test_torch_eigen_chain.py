"""The port's solver options against the JAX package's: the XLA-chain
filter (`cheb_filter_impl='xla'`), its f32 matvecs (`matvec_precision`),
the filter resolution and the 'auto' solver regime they set, stage 2's
batched call through the chain, and `spectral_decompose(color_W=...)`.
JAX runs its XLA chain on the CPU as it is (no interpret mode).

Graphs, start block and tolerances are `tests/test_torch_eigen.py`'s:
eigenvalues 1e-4, eigenvector |cosines| 0.999, residuals rtol 0.05. Both
chains take the same operands (bf16 products are exact in f32, so only the
summation order differs; f32 products are true f32 on both sides).

Under the 'wide' window (every solve here at N=576) the residual a lane
ends at is set by rounding: the first degree-10 filter amplifies the bottom
of the spectrum ~1e7-fold, so the block's upper directions, and with them
the second window, sit at f32 rounding level. There the residuals are held
within WIDE_RESIDUAL_FACTOR of JAX's, a bound set from the readings that
`python tests/test_torch_eigen_chain.py` prints (repo root on PYTHONPATH):
port / JAX per lane 0.27, 0.20, 1.03 (bf16) and 1.09, 1.49, 1.00 (f32) on
the 'wide' lanes, 1.00 and 3.81 in the batched call; JAX's own Pallas /
XLA filters 0.27, 0.21, 1.00 on the 'wide' lanes (bf16), 1.03 and 0.88 in
the batched call.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_spectral_tpu.ops import eigen as je
from deep_spectral_tpu_torch.ops import affinity as ta
from deep_spectral_tpu_torch.ops import eigen as te
from deep_spectral_tpu_torch.ops.cheb_filter import chebyshev_filter

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_eigen import (HW, LANES, K, M, _abs_cos, _graphs,  # noqa: E402
                              _jax_start_block, _masked_batch)

DTYPES = {"bf16": jnp.bfloat16, "f32": jnp.float32}
# 'wide' residuals: port and JAX within this factor of each other per lane
# (largest reading 4.92; module docstring)
WIDE_RESIDUAL_FACTOR = 5.0


def _within_factor(a, b, factor):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return bool((np.maximum(a / b, b / a) <= factor).all())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Parallel test workers each get one torch thread: with torch's default
    (all cores) per worker, the workers oversubscribe the CPU many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_solve(W, d, ws, window_init, precision, n_outer=4):
    return te._chebyshev_laplacian(W, d, K, M, n_outer, 10, None, True, w_scale=ws,
                                   window_init=window_init, x0=_jax_start_block(W.shape[-1]),
                                   filter_impl="xla", matvec_precision=precision)


@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("window_init", ["wide", "estimate"])
def test_xla_chain_solver_matches_jax(window_init, precision):
    """The chain's solve against JAX's vmapped one from the same start
    block: eigenpairs, residuals and, under 'estimate', each lane's outer
    count (JAX's from its residuals at budgets 1, 2 and 4). The kernel
    launches no time. Under 'wide' the residuals are held within
    WIDE_RESIDUAL_FACTOR of JAX's (module docstring), under 'estimate'
    within rtol 0.05."""
    lanes = LANES[window_init]
    _, W, d, ws = _graphs(lanes, HW)
    before = chebyshev_filter.launches
    ev, vec, res, outers = _port_solve(W, d, ws, window_init, precision)
    assert chebyshev_filter.launches == before

    def jax_solve(n_outer):
        f = lambda W_, d_, ws_: je._chebyshev_laplacian(
            W_, d_, K, M, n_outer, 10, None, True, matvec_dtype=DTYPES[precision],
            w_scale=ws_, filter_impl="xla", window_init=window_init)
        return [np.asarray(o) for o in jax.vmap(f)(
            jnp.asarray(W.numpy()), jnp.asarray(d.numpy()), jnp.asarray(ws.numpy()))]

    jev, jvec, jres = jax_solve(4)
    assert res.max().item() <= te.CHEB_RESIDUAL_TOL and jres.max() <= te.CHEB_RESIDUAL_TOL
    np.testing.assert_allclose(ev.numpy(), jev, atol=1e-4)
    assert _abs_cos(vec.numpy(), jvec).min() > 0.999
    if window_init == "wide":
        assert _within_factor(res.numpy(), jres, WIDE_RESIDUAL_FACTOR), (res, jres)
        return
    np.testing.assert_allclose(res.numpy(), jres, rtol=0.05)
    jres_by_budget = [jax_solve(n)[2] for n in (1, 2)] + [jres]
    j_outers = [next(n + 1 for n, r in enumerate(jres_by_budget)
                     if r[b] <= te.CHEB_RESIDUAL_TOL) for b in range(len(lanes))]
    assert j_outers == outers.tolist() == [2, 3, 2]


GRID_N = (256, 600, 2048, 2049, 3600, 3856, 3857, 4096)


@pytest.mark.parametrize("impl", ["auto", "xla", "pallas"])
def test_filter_resolution_and_regime_match_jax(impl):
    """`resolved_cheb_impl` and the 'auto' solver against JAX's over the
    grid. The port's 'auto' is the kernel on every device, as JAX's 'auto'
    is on a TPU, so it is held to JAX's 'pallas' (JAX's 'auto' off a TPU is
    its XLA chain). One departure: above JAX's admission (CHEB_MAX_N, 3857
    and 4096 here) JAX's 'pallas' on bf16 resolves to its chain and the
    port's stays its kernel, which takes any N. `_resolve_solver` gives
    JAX's answer at every point: above the admission both take LOBPCG."""
    j_impl = "pallas" if impl == "auto" else impl
    for N in GRID_N:
        for precision, dtype in DTYPES.items():
            for m in (M, 23):
                got = te.resolved_cheb_impl(N, impl, precision, m)
                want = je.resolved_cheb_impl(N, j_impl, dtype, m)
                if j_impl == "pallas" and precision == "bf16" and N > te.CHEB_MAX_N:
                    assert (got, want) == ("pallas", "xla"), (N, m)
                else:
                    assert got == want, (N, precision, m)
                for lapnorm in (True, False):
                    assert (te._resolve_solver(N, m, lapnorm, "auto", impl, precision)
                            == je._resolve_solver(N, m, lapnorm, "auto", filter_impl=impl,
                                                  matvec_dtype=dtype)), (N, precision, m)
    assert te._resolve_solver(3600, M, True, "auto") == "chebyshev"
    assert te._resolve_solver(3600, M, True, "auto", "xla") == "lobpcg"


def test_chebyshev_above_the_admission_runs_the_kernel(monkeypatch):
    """solver='chebyshev' above CHEB_MAX_N with the default filter goes
    through the kernel's wrapper (its twin on the CPU), never the chain, as
    before the chain was ported; the 'auto' solver takes LOBPCG there."""
    from test_solver_lobpcg import _smooth_features
    feats = torch.from_numpy(_smooth_features(np.random.default_rng(3), 62, 63, 16))
    N = feats.shape[0]
    assert N > te.CHEB_MAX_N and te._resolve_solver(N, M, True, "auto") == "lobpcg"
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return chebyshev_filter(*a, **kw)

    def no_chain(*a, **kw):
        raise AssertionError("the XLA chain ran")

    monkeypatch.setattr(te, "chebyshev_filter", counted)
    monkeypatch.setattr(te, "chebyshev_filter_chain", no_chain)
    ev, vec, res = te.laplacian_eigs(
        ta.feature_affinity(feats), K, solver="chebyshev", cheb_outer=1,
        cheb_window_init="wide", return_residual=True)
    assert len(calls) == 1 and torch.isfinite(ev).all() and torch.isfinite(vec).all()
    assert te.resolved_cheb_impl(N) == "pallas"


def test_unknown_options_raise():
    with pytest.raises(ValueError):
        te.resolved_cheb_impl(900, "palas")
    with pytest.raises(ValueError):
        te.resolved_cheb_impl(900, "xla", "fp16")
    with pytest.raises(ValueError):
        te.laplacian_eigs(torch.eye(8), 2, cheb_filter_impl="XLA")


def test_spectral_decompose_batched_xla_matches_jax():
    """Masked, bucket-padded features through the chain against JAX's
    default off-TPU path (its 'auto' resolves to the same chain there;
    N=576 takes the 'wide' window, so the residuals are held within
    WIDE_RESIDUAL_FACTOR), then with cheb_degree=1, whose filters cannot
    converge, through the per-image eigh guard."""
    feats, mask = _masked_batch()
    x0 = _jax_start_block(feats.shape[1])
    f_t, m_t = torch.from_numpy(feats), torch.from_numpy(mask)
    jf, jm = jnp.asarray(feats), jnp.asarray(mask)
    before = chebyshev_filter.launches
    ev, vec, res = te.spectral_decompose_batched(f_t, m_t, K=K, cheb_filter_impl="xla",
                                                 return_residual=True, x0=x0)
    jev, jvec, jres = (np.asarray(o) for o in je.spectral_decompose_batched(
        jf, jm, K=K, return_residual=True))
    assert res.max().item() <= te.CHEB_RESIDUAL_TOL and jres.max() <= te.CHEB_RESIDUAL_TOL
    assert _within_factor(res.numpy(), jres, WIDE_RESIDUAL_FACTOR), (res, jres)
    np.testing.assert_allclose(ev.numpy(), jev, atol=1e-4)
    assert _abs_cos(vec.numpy(), jvec).min() > 0.999
    assert not vec[1][:, ~mask[1]].any()
    ev1, vec1 = te.spectral_decompose_batched(f_t, m_t, K=K, cheb_filter_impl="xla",
                                              cheb_degree=1, x0=x0)
    jev1, jvec1 = (np.asarray(o) for o in je.spectral_decompose_batched(
        jf, jm, K=K, cheb_filter_impl="xla", cheb_degree=1))
    ev_e, _ = te.spectral_decompose_batched(f_t, m_t, K=K, solver="eigh")
    np.testing.assert_array_equal(ev1.numpy(), ev_e.numpy())
    np.testing.assert_allclose(ev1.numpy(), jev1, atol=1e-5)
    assert _abs_cos(vec1.numpy(), jvec1).min() > 0.9999
    assert chebyshev_filter.launches == before


def test_laplacian_eigs_f32_matvecs_match_jax():
    """One graph through `laplacian_eigs` with f32 matvecs (the chain on the
    f32 operator, JAX's precision=HIGHEST) and the guard, against JAX's."""
    _, W, d, ws = _graphs([LANES["estimate"][1]], HW)
    kw = dict(cheb_window_init="estimate", matvec_precision="f32")
    ev, vec, res = te.laplacian_eigs(W[0], K, w_scale=ws[0], return_residual=True,
                                     x0=_jax_start_block(W.shape[-1]), **kw)
    jev, jvec, jres = (np.asarray(o) for o in je.laplacian_eigs(
        jnp.asarray(W[0].numpy()), K, w_scale=float(ws[0]), return_residual=True, **kw))
    assert res.item() <= te.CHEB_RESIDUAL_TOL
    np.testing.assert_allclose(ev.numpy(), jev, atol=1e-4)
    np.testing.assert_allclose(res.item(), jres, rtol=0.05)
    assert _abs_cos(vec.numpy(), jvec).min() > 0.999


def test_spectral_decompose_color_w_matches_jax():
    """The single-image wrapper with a color affinity: W = W_feat / max +
    lambda W_color on one bucket-padded image, through the chain, against
    JAX's `spectral_decompose`; without color_W the spectrum differs."""
    from deep_spectral_tpu_torch.ops.affinity import knn_affinity
    feats, mask = _masked_batch()
    img = np.random.default_rng(0).random((1, 24, 24, 3)).astype(np.float32)
    img[:, 5:12, 6:15] = [0.9, 0.2, 0.1]
    m_t = torch.from_numpy(mask[1])
    cw = knn_affinity(torch.from_numpy(img), mask=m_t[None])[0]
    kw = dict(image_color_lambda=2.0, cheb_filter_impl="xla", return_residual=True)
    ev, vec, res = te.spectral_decompose(torch.from_numpy(feats[1]), K, mask=m_t, color_W=cw,
                                         x0=_jax_start_block(feats.shape[1]), **kw)
    jev, jvec, jres = (np.asarray(o) for o in je.spectral_decompose(
        jnp.asarray(feats[1]), K, mask=jnp.asarray(mask[1]), color_W=jnp.asarray(cw.numpy()),
        **kw))
    assert res.item() <= te.CHEB_RESIDUAL_TOL and jres <= te.CHEB_RESIDUAL_TOL
    np.testing.assert_allclose(ev.numpy(), jev, atol=1e-4)
    assert _abs_cos(vec.numpy(), jvec).min() > 0.999
    assert not vec[:, ~mask[1]].any()
    ev0, _, _ = te.spectral_decompose(torch.from_numpy(feats[1]), K, mask=m_t,
                                      x0=_jax_start_block(feats.shape[1]), **kw)
    assert (ev0 - ev).abs().max() > 1e-3


def wide_residual_readings() -> None:
    """Print the per-lane residual ratios that set WIDE_RESIDUAL_FACTOR:
    the port's chain over JAX's on the 'wide' lanes at bf16 and f32 and in
    the batched call, and JAX's Pallas filter (interpret mode) over its XLA
    chain on the same lanes."""
    torch.set_num_threads(1)
    _, W, d, ws = _graphs(LANES["wide"], HW)

    def jax_res(impl, precision):
        f = lambda W_, d_, ws_: je._chebyshev_laplacian(
            W_, d_, K, M, 4, 10, None, True, matvec_dtype=DTYPES[precision], w_scale=ws_,
            filter_impl=impl, window_init="wide")
        return np.asarray(jax.vmap(f)(jnp.asarray(W.numpy()), jnp.asarray(d.numpy()),
                                      jnp.asarray(ws.numpy()))[2])

    for precision in DTYPES:
        res = _port_solve(W, d, ws, "wide", precision)[2].numpy()
        print(f"'wide' lanes {LANES['wide']}, {precision}: port / JAX "
              f"{np.round(res / jax_res('xla', precision), 2)}")
    print(f"'wide' lanes, bf16: JAX Pallas / JAX XLA "
          f"{np.round(jax_res('pallas', 'bf16') / jax_res('xla', 'bf16'), 2)}")
    feats, mask = _masked_batch()
    res = te.spectral_decompose_batched(
        torch.from_numpy(feats), torch.from_numpy(mask), K=K, cheb_filter_impl="xla",
        return_residual=True, x0=_jax_start_block(feats.shape[1]))[2].numpy()
    jres = {impl: np.asarray(je.spectral_decompose_batched(
        jnp.asarray(feats), jnp.asarray(mask), K=K, cheb_filter_impl=impl,
        return_residual=True)[2]) for impl in ("xla", "pallas")}
    print(f"batched N={feats.shape[1]}: port / JAX {np.round(res / jres['xla'], 2)}, "
          f"JAX Pallas / JAX XLA {np.round(jres['pallas'] / jres['xla'], 2)}")


if __name__ == "__main__":
    wide_residual_readings()
