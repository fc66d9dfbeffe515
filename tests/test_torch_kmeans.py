"""The port's k-means and PCA (`deep_spectral_tpu_torch.ops.kmeans`) against
the JAX package's, on inputs made from a numpy seed.

JAX draws its k-means++ seeding from `jax.random` and the port from a
`torch.Generator`, so Lloyd is compared from the same initial centers (JAX
`_lloyd(X, c0, ...)`), whole runs of `kmeans` as partitions up to a
permutation on well-separated blobs, and the port's seeding as a valid D^2
draw. Tolerances: labels equal; centers within 1e-5 absolute (f32 sums of
~50 rows of magnitude <~10 in another summation order); inertia within 1e-5
relative; PCA within 1e-4 absolute with the same signs (a true-f32 SVD in
another LAPACK routine).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_spectral_tpu_torch.ops import kmeans as TK

JK = importlib.import_module("deep_spectral_tpu.ops.kmeans")


def blobs(rng, k=4, per=40, d=4, spread=4.0, noise=1.0):
    centers = rng.normal(size=(k, d)) * spread
    X = np.concatenate([c + noise * rng.normal(size=(per, d)) for c in centers])
    return X[rng.permutation(len(X))].astype(np.float32)


def same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    """a and b label the rows alike up to a permutation of the labels."""
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("noise", [0.5, 2.0])  # separated; overlapping (many steps)
@pytest.mark.parametrize("masked", [False, True])
def test_lloyd_matches_jax_from_shared_centers(noise, masked):
    """Every lane of one batched port Lloyd (2 images x 3 restarts, which
    stop after different step counts) against JAX `_lloyd` from the same
    initial centers: labels equal, centers within 1e-5, inertia 1e-5 rel."""
    rng = np.random.default_rng(int(noise * 10) + masked)
    X = np.stack([blobs(rng, noise=noise) for _ in range(2)])       # (2, 160, 4)
    mask = np.ones(X.shape[:2], bool)
    if masked:
        mask[:, -30:] = False
        X[:, -30:] = 0.0
    c0 = np.stack([[X[b, rng.choice(130, 4, replace=False)] for _ in range(3)]
                   for b in range(2)])                                # (2, 3, 4, 4)
    t = TK.lloyd(torch.from_numpy(X), torch.from_numpy(c0),
                 mask=torch.from_numpy(mask) if masked else None)
    assert (t.n_iter > 1).all()
    for b in range(2):
        for r in range(3):
            j = JK._lloyd(jnp.asarray(X[b]), jnp.asarray(c0[b, r]), 300,
                          jnp.asarray(mask[b]) if masked else None, 1e-8)
            np.testing.assert_array_equal(t.labels[b, r].numpy(), np.asarray(j.labels))
            np.testing.assert_allclose(t.centers[b, r].numpy(), np.asarray(j.centers),
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(float(t.inertia[b, r]), float(j.inertia), rtol=1e-5)


def test_kmeanspp_init_is_a_valid_d2_draw():
    """Every center is a valid row of X (masked rows never), the k centers of
    a lane are distinct rows, and the inverse-CDF draw picks row i for a
    share w_i / sum(w) of evenly spaced uniforms (to one grid step)."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(3, 50, 5)).astype(np.float32)
    mask = rng.random((3, 50)) < 0.6
    g = torch.Generator().manual_seed(11)
    u = torch.stack([TK.draw_uniforms(g, 10, 6) for _ in range(3)])
    C = TK.kmeanspp_init(torch.from_numpy(X), 6, u, torch.from_numpy(mask)).numpy()
    for b in range(3):
        valid_rows = X[b][mask[b]]
        for r in range(10):
            hits = [np.flatnonzero((valid_rows == c).all(1)) for c in C[b, r]]
            assert all(len(h) == 1 for h in hits), (b, r)
            assert len({int(h[0]) for h in hits}) == 6
    w = torch.tensor([0.0, 1.0, 0.0, 3.0, 0.5, 0.0, 1.5])
    n = 6000
    u = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    idx = TK._draw(w.expand(n, -1), u, torch.ones(n, 7, dtype=torch.bool))
    share = torch.bincount(idx, minlength=7).double() / n
    np.testing.assert_allclose(share.numpy(), (w / w.sum()).numpy(), atol=2.0 / n)


@pytest.mark.parametrize("k", [3, 5])
def test_kmeans_matches_jax_partition_on_blobs(k):
    """Whole runs (10 restarts each, different draws) on well-separated
    blobs: the same partition as JAX up to a permutation, inertia within
    1e-5 relative."""
    rng = np.random.default_rng(k)
    X = blobs(rng, k=k, per=30, d=6, spread=6.0, noise=0.5)
    j = JK.kmeans(jnp.asarray(X), k, jax.random.PRNGKey(0))
    t = TK.kmeans(torch.from_numpy(X), k, torch.Generator().manual_seed(0))
    assert same_partition(t.labels.numpy(), np.asarray(j.labels))
    np.testing.assert_allclose(float(t.inertia), float(j.inertia), rtol=1e-5)


def test_kmeans_ignores_masked_padding_rows():
    """Rows after the valid ones, masked, change nothing: the same draws,
    labels (-1 on the padding), centers and inertia as without them."""
    rng = np.random.default_rng(7)
    X = blobs(rng, k=3, per=20, d=3)
    pad = np.concatenate([X, 50.0 * rng.normal(size=(17, 3)).astype(np.float32)])
    mask = np.arange(len(pad)) < len(X)
    a = TK.kmeans(torch.from_numpy(X), 3, torch.Generator().manual_seed(2))
    b = TK.kmeans(torch.from_numpy(pad), 3, torch.Generator().manual_seed(2),
                  mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(b.labels[: len(X)].numpy(), a.labels.numpy())
    assert (b.labels[len(X):] == -1).all()
    np.testing.assert_allclose(b.centers.numpy(), a.centers.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(b.inertia), float(a.inertia), rtol=1e-6)


def test_kmeans_batch_does_not_change_an_image():
    """One generator per image: an image's result is its single-image call's,
    whatever else is in the batch."""
    rng = np.random.default_rng(9)
    X = np.stack([blobs(rng, k=4, per=15, d=3, noise=1.5) for _ in range(3)])
    batch = TK.kmeans(torch.from_numpy(X), 4,
                      [torch.Generator().manual_seed(s) for s in (5, 6, 7)])
    for b, s in enumerate((5, 6, 7)):
        one = TK.kmeans(torch.from_numpy(X[b]), 4, torch.Generator().manual_seed(s))
        np.testing.assert_array_equal(batch.labels[b].numpy(), one.labels.numpy())
        np.testing.assert_allclose(batch.centers[b].numpy(), one.centers.numpy(),
                                   rtol=0, atol=1e-6)


def test_pca_matches_jax():
    """Projection within 1e-4 of JAX's, with the same signs."""
    rng = np.random.default_rng(4)
    X = (rng.normal(size=(60, 12)) * np.linspace(3.0, 0.1, 12)).astype(np.float32)
    j = np.asarray(JK.pca(jnp.asarray(X), 5))
    t = TK.pca(torch.from_numpy(X), 5).numpy()
    assert t.shape == j.shape == (60, 5)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-4)


def test_sq_dists_is_true_f32():
    """xn + cn - 2 X C^T, the JAX expression, within f32 rounding of float64."""
    rng = np.random.default_rng(5)
    X, C = rng.normal(size=(40, 8)), rng.normal(size=(5, 8))
    want = ((X[:, None] - C[None]) ** 2).sum(-1)
    got = TK.sq_dists(torch.from_numpy(X.astype(np.float32)),
                      torch.from_numpy(C.astype(np.float32))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(JK._sq_dists(jnp.asarray(X, jnp.float32),
                                                            jnp.asarray(C, jnp.float32))),
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Parallel test workers each get one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
