"""The port's color affinities (`knn_affinity`, `rw_affinity`, batched with a
validity mask) against the JAX package's, on the same seeded numpy images.

Tolerances: `knn_affinity` is held bit-equal, on images of distinct colors
and on flat-color images whose distances tie everywhere: the port sums the
squared norms channel after channel and takes the products as one f32
matmul, as XLA does on the CPU, rounds linspace as `jnp.linspace` does, and
breaks ties to the lowest index with a stable sort, as `top_k` does.
`rw_affinity` adds its offsets in the JAX order, so each entry sums the same
terms in the same order, but its weights come from `exp`, which XLA and
torch round differently in the last bit (and XLA flushes results below
FLT_MIN to zero): entries agree to 2^-23 relative, or 2^-126 absolute.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_spectral_tpu.ops import affinity as ja
from deep_spectral_tpu_torch.ops import affinity as ta

H, W = 12, 14
FLT_MIN = float(np.finfo(np.float32).tiny)


def _images(kind):
    rng = np.random.default_rng(3)
    if kind == "distinct":
        return rng.random((2, H, W, 3)).astype(np.float32)
    img = np.full((2, H, W, 3), 0.4, np.float32)  # flat color: distances tie
    img[0, 3:7, 4:9] = [0.9, 0.1, 0.2]
    return img


def _mask():
    m = np.ones((2, H, W), bool)
    m[1, 9:, :] = False   # a bucket-padded image: valid region top-left
    m[1, :, 11:] = False
    return m.reshape(2, -1)


def _both(fn, images, mask):
    got = getattr(ta, fn)(torch.from_numpy(images),
                          mask=None if mask is None else torch.from_numpy(mask)).numpy()
    ref = np.stack([np.asarray(getattr(ja, fn)(
        jnp.asarray(images[b]), mask=None if mask is None else jnp.asarray(mask[b])))
        for b in range(len(images))])
    return got, ref


@pytest.mark.parametrize("kind", ["distinct", "flat"])
@pytest.mark.parametrize("masked", [False, True])
def test_knn_affinity_bit_equal(kind, masked):
    mask = _mask() if masked else None
    got, ref = _both("knn_affinity", _images(kind), mask)
    np.testing.assert_array_equal(got, ref)
    assert np.array_equal(got, got.transpose(0, 2, 1))
    if masked:
        assert not got[1][~mask[1]].any() and not got[1][:, ~mask[1]].any()


@pytest.mark.parametrize("kind", ["distinct", "flat"])
@pytest.mark.parametrize("masked", [False, True])
def test_rw_affinity_matches_jax(kind, masked):
    mask = _mask() if masked else None
    got, ref = _both("rw_affinity", _images(kind), mask)
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -23, atol=FLT_MIN)
    np.testing.assert_allclose(got.sum(-1), ref.sum(-1), rtol=1e-6)
    if masked:
        assert not got[1][~mask[1]].any() and not got[1][:, ~mask[1]].any()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Parallel test workers each get one torch thread: with torch's default
    (all cores) per worker, the workers oversubscribe the CPU many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
