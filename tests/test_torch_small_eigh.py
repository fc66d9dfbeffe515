"""`ops/small_eigh.py` on the CPU: the routing (the kernel only for CUDA
tensors of order m <= SMALL_EIGH_MAX_M, `eigh_finite` otherwise, which is
the plain twin on CPU tensors), and `_matrix`, the test matrices that
tests/test_torch_cuda.py holds the kernel (`csrc/small_eigh.cu`) to f64
eigh with on the card."""
import numpy as np
import pytest
import torch

from deep_spectral_tpu_torch.ops.lobpcg import eigh_finite
from deep_spectral_tpu_torch.ops.small_eigh import SMALL_EIGH_MAX_M, small_eigh, sync_free

f32 = np.float32


def _matrix(kind: str, m: int, rng) -> np.ndarray:
    if kind == "random":
        A = rng.standard_normal((m, m))
    elif kind == "gram":       # rr's first matrix: nearly dependent unit columns
        X = rng.standard_normal((200, m))
        X[:, -1] = X[:, 0] + 1e-4 * X[:, -1]
        X /= np.linalg.norm(X, axis=0)
        A = X.T @ X
    else:
        Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
        if kind == "clustered":
            lam = 1 + 1e-5 * rng.standard_normal(m)
            lam[: m // 2] = 3 + 1e-6 * rng.standard_normal(m // 2)
        else:                  # exactly degenerate: two eigenvalues, each repeated
            lam = np.repeat([0.5, 2.0], (m + 1) // 2)[:m]
        A = Q @ np.diag(lam) @ Q.T
    return ((A + A.T) / 2).astype(f32)


def test_routing():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not sync_free(cpu, 8)
    assert sync_free(cuda, 8) and sync_free(cuda, SMALL_EIGH_MAX_M)
    assert not sync_free(cuda, SMALL_EIGH_MAX_M + 1)


def test_cpu_tensors_take_the_plain_twin():
    """On CPU tensors `small_eigh` is `eigh_finite` (torch.linalg.eigh, the
    non-finite lane solved as the identity and flagged), launching nothing."""
    rng = np.random.default_rng(1)
    M = torch.from_numpy(np.stack([_matrix("random", 8, rng) for _ in range(3)]))
    M[1, 0, 3] = float("inf")
    before = small_eigh.launches
    got, ref = small_eigh(M), eigh_finite(M)
    assert small_eigh.launches == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert got[2].tolist() == [False, True, False]
    with pytest.raises(ValueError):
        small_eigh(torch.zeros((2, 3, 4)))
