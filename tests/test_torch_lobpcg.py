"""The port's block LOBPCG (`ops/lobpcg.lobpcg_standard` and the stage-2
solver `ops/eigen._lobpcg_laplacian`) against JAX's
`jax.experimental.sparse.linalg.lobpcg_standard` and the JAX package's
solver, from the same start block (JAX's `PRNGKey(0)` draw, passed in as
x0), and against dense eigh on image-structured graphs.

Tolerances: both sides iterate in true f32 and take the same steps, but the
small eigh/QR/SVD steps of LAPACK through torch and through XLA round
differently, so the iterates drift apart at rounding level: eigenvalues
agree to 1e-4 on operators of norm <= 3 (the whitened Laplacian, shifted),
and to 2e-6 of the Gershgorin shift c on D - W (c ~ 130-180 on these
graphs; c times f32's epsilon is ~2e-5 per step), eigenvectors to |cosine|
>= 0.999. Against dense eigh the thresholds are `test_solver_lobpcg.py`'s:
eigenvalues 5e-3 absolute + 5e-2 relative, cosines > 0.999, and at K=20 a
subspace alignment >= 0.98 with the leading 6 vectors at cosine > 0.99.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.sparse.linalg import lobpcg_standard as j_lobpcg

from deep_spectral_tpu.ops import affinity as ja
from deep_spectral_tpu.ops import eigen as je
from deep_spectral_tpu_torch.ops import eigen as te
from deep_spectral_tpu_torch.ops.lobpcg import lobpcg_standard

sys.path.insert(0, str(Path(__file__).parent))
from test_solver_lobpcg import _smooth_features  # noqa: E402

SIDE = 16  # 256-node graphs


def _graphs(seeds, masked=True):
    feats = np.stack([_smooth_features(np.random.default_rng(s), SIDE, SIDE, 32)
                      for s in seeds])
    W = np.stack([np.asarray(ja.feature_affinity(jnp.asarray(f))) for f in feats])
    mask = np.ones(W.shape[:2], bool)
    if masked:
        mask[1, 200:] = False  # a padded image
    return W * mask[:, :, None] * mask[:, None, :], mask


def _x0(N, m):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (N, m), jnp.float32))


def _abs_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs((a * b).sum(-1)) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _subspace(a, b):
    qa, _ = np.linalg.qr(np.asarray(a, np.float64).T)
    qb, _ = np.linalg.qr(np.asarray(b, np.float64).T)
    return np.linalg.svd(qa.T @ qb, compute_uv=False).min()


@pytest.mark.parametrize("tol", [None, 1e-5])
def test_lobpcg_standard_matches_jax(tol):
    """The top-8 pairs of 3I - W: with tol=1e-5 both stop at the same
    iteration; at the default (f32 epsilon) both run to rounding-level
    residuals, where the stopping iteration is itself rounding noise."""
    W, _ = _graphs([0], masked=False)
    A = np.eye(W.shape[-1], dtype=np.float32) * 3 - W[0]
    x0 = _x0(A.shape[0], 8)
    with jax.default_matmul_precision("highest"):
        th_j, U_j, it_j = j_lobpcg(jnp.asarray(A), jnp.asarray(x0), m=60, tol=tol)
    A_t = torch.from_numpy(A)
    th, U, it = lobpcg_standard(lambda X: A_t @ X, torch.from_numpy(x0)[None], m=60, tol=tol)
    np.testing.assert_allclose(th[0].numpy(), np.asarray(th_j), atol=1e-4)
    assert _abs_cos(U[0].numpy().T, np.asarray(U_j).T).min() >= 0.999
    if tol is not None:
        assert it.item() == int(it_j)
    with pytest.raises(ValueError):
        lobpcg_standard(lambda X: X, torch.zeros((1, 40, 8)))  # 5 k >= n


@pytest.mark.parametrize("K,lapnorm", [(5, True), (5, False), (20, True)])
def test_lobpcg_laplacian_matches_jax_and_eigh(K, lapnorm):
    """Three graphs in one batch, one of them padded, through the port's
    batched solver; each against the JAX solver on that graph alone and
    against the port's dense eigh."""
    W, mask = _graphs([0, 1, 2])
    x0 = _x0(W.shape[-1], K + 3)
    W_t, m_t = torch.from_numpy(W), torch.from_numpy(mask)
    ev, vec = te._laplacian_eigs_batched(W_t, K, lapnorm=lapnorm, mask=m_t,
                                         solver="lobpcg", x0=x0)
    ev_e, vec_e = te._laplacian_eigs_batched(W_t, K, lapnorm=lapnorm, mask=m_t,
                                             solver="eigh")
    assert not vec[1][:, ~mask[1]].any()
    for b in range(3):
        jev, jvec = (np.asarray(o) for o in je.laplacian_eigs(
            jnp.asarray(W[b]), K, lapnorm=lapnorm, mask=jnp.asarray(mask[b]),
            solver="lobpcg"))
        d = W[b].sum(1)
        c = 2.0 if lapnorm else (d + np.abs(W[b]).sum(1)).max() + 1.0
        np.testing.assert_allclose(ev[b].numpy(), jev, atol=max(1e-4, 2e-6 * c))
        assert _abs_cos(vec[b].numpy(), jvec).min() >= 0.999
        np.testing.assert_allclose(ev[b].numpy(), ev_e[b].numpy(), atol=5e-3, rtol=5e-2)
        cos = _abs_cos(vec[b].numpy(), vec_e[b].numpy())
        if K == 20:
            assert _subspace(vec[b].numpy(), vec_e[b].numpy()) >= 0.98
            assert cos[:6].min() > 0.99
        else:
            assert cos.min() > 0.999


def test_lobpcg_lanes_freeze():
    """With a loose tolerance the lanes of a batch stop at different
    iterations; each lane gives what it gives alone."""
    W, mask = _graphs([3, 4, 5])
    W_t, m_t = torch.from_numpy(W), torch.from_numpy(mask)
    K, x0 = 5, _x0(W.shape[-1], 8)
    d = te.degree_vector(W_t)
    args = (K, 8, 60, 1e-5, True)
    seen = []
    orig = te.lobpcg_standard

    def spy(*a, **kw):
        out = orig(*a, **kw)
        seen.append(out[2])
        return out

    te.lobpcg_standard = spy
    try:
        ev, vec = te._lobpcg_laplacian(W_t, d, *args, m_t, True, x0=x0)
    finally:
        te.lobpcg_standard = orig
    assert len(set(seen[0].tolist())) > 1, seen[0]
    for b in range(3):
        ev1, vec1 = te._lobpcg_laplacian(W_t[b:b + 1], d[b:b + 1], *args, m_t[b:b + 1],
                                         True, x0=x0)
        np.testing.assert_allclose(ev1[0].numpy(), ev[b].numpy(), atol=1e-6)
        np.testing.assert_allclose(vec1[0].numpy(), vec[b].numpy(), atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Parallel test workers each get one torch thread: with torch's default
    (all cores) per worker, the workers oversubscribe the CPU many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
