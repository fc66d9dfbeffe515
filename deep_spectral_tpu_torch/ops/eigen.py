"""Batched graph eigensolvers for stage 2 (the port of
`deep_spectral_tpu.ops.eigen`).

The reference solves, per image on the host, (D - W) x = lam D x for the K
smallest eigenpairs with ARPACK (extract/extract.py:227-234). As in the JAX
package, the port whitens (A = I - D^-1/2 W D^-1/2), solves A, and unwhitens
(x = D^-1/2 v, so x^T D x = 1, ARPACK's M-normalization). Solvers:

  * 'eigh': dense `torch.linalg.eigh` (exact; small graphs and the guard's
    re-solve);
  * 'chebyshev': Chebyshev-filtered subspace iteration (`_chebyshev_laplacian`),
    residual-guarded, whose filter chain is, by `cheb_filter_impl`, the
    hand-written CUDA kernel on the GPU (`ops/cheb_filter.py`; 'pallas',
    which the port's 'auto' means) or the JAX package's XLA chain of
    `degree` batched products (`chebyshev_filter_chain`; 'xla');
  * 'lobpcg': block LOBPCG (`ops/lobpcg.py`) on the Gershgorin-shifted
    operator, for graphs above the 'auto' solver's chebyshev limit
    (CHEB_MAX_N, XLA_CHAIN_CHEB_MAX_N under the chain) and for lapnorm=False
    at N >= 512.

`spectral_decompose_batched` also runs the reference's other `which_matrix`
modes ('affinity' and 'affinity_torch': the largest eigenpairs of W;
'affinity_svd': the feature matrix's left singular vectors;
'matting_laplacian', routed down the laplacian branch as in the JAX package)
and the color-fused graph W = W_feat / max + lambda W_color.

Every function here is batched over a leading image dimension. The JAX
package runs its iterative solvers as `lax.while_loop`s under `vmap`, where
a lane that has converged keeps its carry frozen while the batch loops on;
the port loops on the host and freezes converged lanes with `torch.where`,
so an image's result does not depend on its batch-mates.

Host syncs. A guarded Chebyshev solve runs in rounds of `cheb_outer` outer
iterations: after each, its guard reads which lanes fail, resumes the finite
ones above the tolerance for another round (at most CHEB_ROUNDS in all) and
re-solves what is left with dense eigh. On a CUDA device a solve whose block
is at most SMALL_EIGH_MAX_M (`ops/small_eigh.py`) waits for the card once a
round, at the guard's read: its small eighs are the Jacobi kernel, it runs
every outer iteration of a round instead of reading an exit test (converged
lanes stay frozen), each outer's Rayleigh-Ritz step and masked update is
replayed from a CUDA graph (`_GraphedRitzStep`, the same graphs in every
round), and the default start block stays on the device. On CPU tensors,
and on the card for larger blocks, an outer iteration makes three syncs, its
exit test and the two `torch.linalg.eigh` of its Rayleigh-Ritz step
(cuSOLVER's error flags are read back), and a round stops once no lane is
active. LOBPCG waits at each iteration's exit test and eigh
(`ops/lobpcg.py`), a dense solve at its eigh. Each sync is an `eigs.sync`
span and an `eigs.syncs` count (`utils/profiling.py`).

Precision: the solvers' Rayleigh-Ritz products, the residual, LOBPCG and
A_mv run in true f32 (`exact_f32()`, no TF32), the filter chain on a bf16
operator with f32 accumulation (`matvec_precision='bf16'`) or, with
`matvec_precision='f32'`, on the f32 operator in true f32 (the XLA chain:
the kernel takes bf16 only); the small eighs are f32, by `small_eigh`.
"""
from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Optional, Union

import torch

from ..utils.precision import exact_f32
from ..utils.profiling import count, recording, span
from .affinity import degree_vector, feature_affinity, l2_normalize
from .cheb_filter import _per_image, chebyshev_filter, kernel_operator
from .lobpcg import lobpcg_standard
from .small_eigh import small_eigh
from .small_eigh import sync_free as _sync_free

# Convergence guard for the Chebyshev subspace solver: max whitened residual
# ||A x_k - theta_k x_k|| above which a result is rejected and the exact dense
# path used instead (the JAX package's value, calibrated on CPU oracles).
CHEB_RESIDUAL_TOL = 2e-3

# Rounds of `cheb_outer` outer iterations a guarded Chebyshev solve may take:
# after each, the guard's read finds the finite lanes still above their
# tolerance and resumes them (the others frozen); dense eigh takes what is
# left after the last. At the CLI's K=20 (a 23-wide block) on voc480-like
# 30x30 graphs the first 4 outers pass ~7% of lanes; with CHEB_CONTINUE_TOL
# 4 rounds leave ~11% to dense eigh, 3 rounds ~25% (the CPU twin, 640 lanes).
# At K=5 the first round passes nearly every lane, so the later rounds cost
# nothing there.
CHEB_ROUNDS = 4

# The residual a lane the guard resumed must reach. Such a lane is slow
# because its K-th eigenvalue sits in a near-degenerate bulk (at K=20 on
# image graphs, lambda_20 ~ 0.92-0.98 with neighbours 1e-3 apart), and there a
# small residual does not make an accurate eigenvalue: a Ritz vector a v_K +
# b v_K+1 has residual |a b| delta and eigenvalue error b^2 delta (delta =
# lambda_K+1 - lambda_K), up to about the residual itself where delta is twice
# it, against ~residual^2 / delta where the spectrum is separated. Held to
# CHEB_RESIDUAL_TOL, resumed lanes lay up to 8.5e-4 off the dense eigenvalue
# (an H100, 38 batches of 24 voc480-like graphs at K=20), and held to half
# of it up to 3.7e-4 (the CPU twin, 640 lanes), where lanes that pass in the
# first round lie under 1e-4; a quarter keeps them there too.
CHEB_CONTINUE_TOL = CHEB_RESIDUAL_TOL / 4

# First-outer filter window upper edge for window_init='wide'.
_WIDE_INIT_LAM_CUT = 1.0

# 'auto' window-init split: 'wide' for N <= 1600, 'estimate' above.
# Inherited from the JAX package; not yet measured on this card.
_WIDE_INIT_MAX_N = 1600

# Largest N the 'auto' solver sends to chebyshev while the filter is the
# kernel: the JAX package's admission of its Pallas filter
# (`ops.cheb_filter.fits_vmem(N, m=8)`, the same for any block m <= 128).
# The port's kernel itself takes any N, so a filter request is not resolved
# by N (`resolved_cheb_impl`); only the 'auto' solver's regime reads this.
# On an H100 80GB HBM3 at 700 W (the card run of the CHANGES.md entry that
# opens "the port's eigensolver takes every option of the JAX solver") the
# kernel's Chebyshev solve of a b4 N=3600 color-fused graph took 9.53 ms
# against LOBPCG's 36.28, so the crossover lies above 3600 there too; where
# is not measured. The rule stays the JAX package's.
CHEB_MAX_N = 3856

# Largest N the 'auto' solver sends to chebyshev when the filter is the XLA
# chain (cheb_filter_impl='xla' or matvec_precision='f32'): the JAX
# package's `_XLA_CHAIN_CHEB_MAX_N`, LOBPCG above. On an H100 80GB HBM3 at
# 700 W (the same card run) the chain's solve took 12.72 ms a b24 N=900
# batch against the kernel's 6.23 (8.94 with f32 matvecs), and at b4 N=3600
# the chain's Chebyshev 13.41 ms against LOBPCG's 36.28: on that card the
# chain beats LOBPCG above 2048 too. The rule stays the JAX package's.
XLA_CHAIN_CHEB_MAX_N = 2048

# Bytes of static buffers that the Chebyshev solver's Rayleigh-Ritz graphs
# (`_GraphedRitzStep`) hold at once, over all shapes; the least recently used
# shape goes first. A shape whose buffers alone are larger runs its steps
# eagerly (b8 at N=3072 holds 0.30 GB, at CHEB_MAX_N 0.48 GB; b24 at 3856, 1.4).
_RR_GRAPH_BYTES = 1 << 30

_SOLVERS = ("auto", "eigh", "chebyshev", "lobpcg")
_FILTER_IMPLS = ("auto", "xla", "pallas")
_MATVEC_PRECISIONS = ("bf16", "f32")


def sign_fix(eigenvectors: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flip a vector iff strictly more than half (but not all) of its (valid)
    entries are positive (reference: extract/extract.py:237-240).

    eigenvectors: (..., K, N); mask: optional (..., N) validity."""
    pos = (eigenvectors > 0).float()
    if mask is None:
        frac_pos = pos.mean(dim=-1)
    else:
        m = mask.float()
        denom = torch.clamp_min(m.sum(dim=-1, keepdim=True), 1.0)
        frac_pos = (pos * m[..., None, :]).sum(dim=-1) / denom
    flip = (frac_pos > 0.5) & (frac_pos < 1.0)
    return torch.where(flip[..., None], -eigenvectors, eigenvectors)


def _pad_aware_eigh(A: torch.Tensor, mask: Optional[torch.Tensor]):
    """eigh of (B, N, N) symmetric operators whose padded diagonal is pushed
    past the valid spectrum (Gershgorin bound of the valid block + 1)."""
    if mask is not None:
        m = mask.to(A.dtype)
        A = A * m[:, :, None] * m[:, None, :]
        bound = A.abs().sum(dim=-1).amax(dim=-1) + 1.0
        A = A + torch.diag_embed(torch.where(mask, 0.0, bound[:, None]))
    with span("eigs.sync"):
        count("eigs.syncs")
        return torch.linalg.eigh(A)


def _dense_laplacian(W, d, K, lapnorm, mask, apply_sign_fix, w_scale=None):
    """Exact dense eigh path: whitened operator when lapnorm, else D - W.
    W (B, N, N), d (B, N), w_scale (B,) or None."""
    N = W.shape[-1]
    if lapnorm:
        s = torch.rsqrt(d)
        if w_scale is not None:
            s = s * torch.sqrt(w_scale)[:, None]
        A = torch.eye(N, dtype=W.dtype, device=W.device) - s[:, :, None] * W * s[:, None, :]
    else:
        A = torch.diag_embed(d) - (W if w_scale is None else W * w_scale[:, None, None])
    evals, evecs = _pad_aware_eigh(A, mask)
    evals, V = evals[:, :K], evecs[:, :, :K]
    if lapnorm:
        V = torch.rsqrt(d)[:, :, None] * V  # unwhiten: x^T D x = 1
    return evals, _as_vectors(V, mask, apply_sign_fix)


def resolved_cheb_impl(N: int, filter_impl: str = "auto",
                       matvec_precision: str = "bf16", m: int = 8) -> str:
    """The Chebyshev filter that runs for a request, decided before anything
    runs: 'pallas', the hand-written kernel (`ops/cheb_filter.chebyshev_filter`;
    its plain twin on CPU tensors), or 'xla', the chain of batched products
    (`chebyshev_filter_chain`). 'auto' is the port's mapping of JAX's 'auto':
    JAX resolves it to its Pallas kernel on a TPU and to the XLA chain
    elsewhere; the port resolves it to its own kernel on every device, so
    'auto' is 'pallas' here. A 'pallas' request resolves to 'xla' with f32
    matvecs (the kernel takes a bf16 operator), as in the JAX package's
    `resolved_cheb_impl`. N (the operator's size) and m (the solver's block,
    K + lobpcg_block_extra) are that function's arguments and do not change
    the port's answer: the port's kernel takes any (N, m), so where JAX's
    'pallas' resolves to 'xla' above its admission (CHEB_MAX_N at m <= 128)
    the port's stays the kernel. The 'auto' solver still leaves chebyshev
    for LOBPCG above CHEB_MAX_N (`_resolve_solver`), as JAX's does."""
    del N, m
    if filter_impl not in _FILTER_IMPLS:
        raise ValueError(f"cheb_filter_impl must be one of {_FILTER_IMPLS}; "
                         f"got {filter_impl!r}")
    if matvec_precision not in _MATVEC_PRECISIONS:
        raise ValueError(f"matvec_precision must be one of {_MATVEC_PRECISIONS}; "
                         f"got {matvec_precision!r}")
    return "xla" if filter_impl == "xla" or matvec_precision == "f32" else "pallas"


def _resolve_solver(N: int, m_block: int, lapnorm: bool, solver: str,
                    filter_impl: str = "auto", matvec_precision: str = "bf16") -> str:
    """The JAX package's 'auto' selection: dense eigh for small graphs,
    chebyshev for lapnorm graphs from N = 512 up to CHEB_MAX_N while the
    filter is the kernel, and up to XLA_CHAIN_CHEB_MAX_N when it is the XLA
    chain (`resolved_cheb_impl`), lobpcg above (or for lapnorm=False). Its
    answer is JAX's for every request, the port's 'auto' filter taken as
    JAX's 'pallas'."""
    if solver not in _SOLVERS:
        raise ValueError(f"solver must be one of {_SOLVERS}; got {solver!r}")
    impl = resolved_cheb_impl(N, filter_impl, matvec_precision, m_block)
    if solver != "auto":
        return solver
    if N >= 4 * m_block + 1 and N >= 512:
        limit = CHEB_MAX_N if impl == "pallas" else XLA_CHAIN_CHEB_MAX_N
        if lapnorm and N <= limit:
            return "chebyshev"
        return "lobpcg"
    return "eigh"


def validate_cheb_window_init(window_init: str) -> None:
    """Fail fast on an invalid cheb_window_init."""
    if window_init in ("auto", "wide", "estimate"):
        return
    if isinstance(window_init, str) and window_init.startswith("wide@"):
        try:
            float(window_init.split("@", 1)[1])
            return
        except ValueError:
            pass
    raise ValueError(
        f"cheb_window_init must be 'auto', 'wide', 'wide@<lam_cut>' or "
        f"'estimate'; got {window_init!r}")


def default_start_block(N: int, m: int) -> torch.Tensor:
    """The solver's random start block: N(0, 1) entries from a CPU
    `torch.Generator` seeded with 0 (the JAX package draws its block from
    PRNGKey(0); tests pass that block in as x0)."""
    return torch.randn((N, m), generator=torch.Generator().manual_seed(0))


@functools.lru_cache(maxsize=32)
def _resident_start_block(N: int, m: int, device: torch.device) -> torch.Tensor:
    """`default_start_block` on `device`, made once per (N, m, device); its
    copy from pageable host memory is a host sync on a CUDA device. Callers
    share the tensor and never write it."""
    with span("eigs.sync"):
        count("eigs.syncs")
        return default_start_block(N, m).to(device)


def _start_block(x0, B: int, N: int, m: int, mask, device) -> torch.Tensor:
    """The iterative solvers' (B, N, m) start block: x0 (N, m), or
    `default_start_block`, with padded rows zeroed. The default block stays
    on the device (`_resident_start_block`); x0 is copied at every call, a
    host sync on a CUDA device where it comes from host memory."""
    if x0 is None:
        X = _resident_start_block(N, m, torch.device(device))
    else:
        with span("eigs.sync"):
            count("eigs.syncs")
            X = torch.as_tensor(x0, dtype=torch.float32).to(device, torch.float32)
    X = X.expand(B, N, m)
    if mask is not None:
        X = X * mask.to(torch.float32)[:, :, None]
    return X


def _as_vectors(V, mask, apply_sign_fix):
    """(B, N, K) solver columns -> (B, K, N) rows, padding zeroed, signs
    fixed as the reference does."""
    vectors = V.transpose(1, 2)
    if mask is not None:
        vectors = vectors * mask.to(vectors.dtype)[:, None, :]
    if apply_sign_fix:
        vectors = sign_fix(vectors, mask)
    return vectors


def _chain_product(S: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """S T in f32 for the XLA chain: a bf16 S takes bf16(T) with an f32
    result (cuBLAS on CUDA tensors; on CPU tensors, which have no bf16 ->
    f32 product, both operands upcast, exact since products of bf16 values
    are exact in f32); an f32 S multiplies in f32 (the caller's
    `exact_f32()` keeps it off TF32)."""
    if S.dtype != torch.bfloat16:
        return S @ T
    if S.is_cuda:
        return torch.bmm(S, T.to(torch.bfloat16), out_dtype=torch.float32)
    return S.float() @ T.to(torch.bfloat16).float()


def chebyshev_filter_chain(S: torch.Tensor, X: torch.Tensor, c, e,
                           degree: int) -> torch.Tensor:
    """T_degree(((I - S) - c) / e) X per image as the JAX package's XLA
    filter computes it (`ops/eigen.py`'s `filt`): one batched product a
    step, in its arithmetic, A X = X - S X, T_1 = (A X - c X) / e and
    T_{j+1} = 2 (A T_j - c T_j) / e - T_{j-1}, with the joint per-column
    rescale of (T_j, T_{j+1}) by 1 / max(max |T_{j+1}|, 1) after each step
    but the first. S (B, N, N) bf16 or f32, X (B, N, m) f32, c and e
    scalars or (B,). Returns (B, N, m) f32."""
    if degree < 1:
        raise ValueError("degree must be >= 1")
    B = X.shape[0]
    c = _per_image(c, B, X.device)[:, None, None]
    e = _per_image(e, B, X.device)[:, None, None]

    def a_shift(T):
        return ((T - _chain_product(S, T)) - c * T) / e

    one = torch.ones((), dtype=torch.float32, device=X.device)
    T0, T1 = X, a_shift(X)
    for _ in range(degree - 1):
        T2 = 2.0 * a_shift(T1) - T0
        sc = 1.0 / torch.maximum(T2.abs().amax(dim=1, keepdim=True), one)
        T0, T1 = T1 * sc, T2 * sc
    return T1


class _RitzStep:
    """A Chebyshev solve's state between two filters, and the steps of
    `_chebyshev_laplacian`'s loop that are not the filter: the Rayleigh-Ritz
    step of a filtered block and the masked update after it.

    State: X (B, N, m) the block, theta (B, m) its Ritz values, res (B,) the
    largest residual of its K pairs (+inf where not finite), outers (B,)
    int32 the filters each lane took, tol (B,) each lane's residual
    tolerance (CHEB_RESIDUAL_TOL until `resume` sets it), active (B,) the
    lanes the next outer updates (res > tol among those not frozen: a lane
    once inactive stays so, and `resume` freezes more) and c, e (B,) the
    next filter's window. A step binds the state to new tensors and writes
    none it was handed but `active` and `tol`, which `resume` sets in
    place. W (B, N, N) and sc (B, N): A = I - sc W sc, applied in true f32."""

    def __init__(self, W, sc, K):
        self.W, self.sc, self.K = W, sc, K

    def start(self, X, theta, res):
        """The 'wide' start: X the start block, theta and res the first
        window's (every lane active)."""
        self.X, self.theta, self.res = X, theta, res
        self._first_window()

    def estimate(self, F):
        """The 'estimate' start: the Rayleigh-Ritz of the filtered start
        block F gives the first window."""
        self.X, self.theta, self.res = self._rr(F)
        self._first_window()

    def outer(self, F):
        """The rest of an outer iteration after its filter's output F: the
        active lanes take F's Rayleigh-Ritz, the others keep their state."""
        a = self.active
        X, theta, res = self._rr(F)
        self.X = torch.where(a[:, None, None], X, self.X)
        self.theta = torch.where(a[:, None], theta, self.theta)
        self.res = torch.where(a, res, self.res)
        self.outers = self.outers + a.to(torch.int32)
        self._window()

    def resume(self, lanes, tol):
        """Keep only `lanes` (B,) bool active, the others frozen, and hold
        each lane to its residual tolerance `tol` (B,) from now on."""
        self.active &= lanes
        self.tol.copy_(tol)

    def _first_window(self):
        B, dev = self.X.shape[0], self.X.device
        self.outers = torch.zeros(B, dtype=torch.int32, device=dev)
        self.active = torch.ones(B, dtype=torch.bool, device=dev)
        self.tol = torch.full((B,), CHEB_RESIDUAL_TOL, dtype=torch.float32, device=dev)
        self._window()

    def _window(self):
        self.active = self.active & (self.res > self.tol)
        lam_cut = torch.clamp(self.theta[:, self.K - 1] * 1.5 + 1e-3, 1e-3, 1.8)
        self.c, self.e = (lam_cut + 2.0) / 2.0, (2.0 - lam_cut) / 2.0

    def _rr(self, X):
        K, sc = self.K, self.sc
        X = X / torch.clamp_min(torch.linalg.vector_norm(X, dim=1, keepdim=True), 1e-20)
        w, Vg, bad_g = small_eigh(X.transpose(1, 2) @ X)
        Xo = X @ (Vg / torch.sqrt(torch.clamp_min(w, 1e-12))[:, None, :])
        AXo = Xo - sc[:, :, None] * (self.W @ (sc[:, :, None] * Xo))
        T = Xo.transpose(1, 2) @ AXo
        theta, Q, bad_t = small_eigh((T + T.transpose(1, 2)) / 2)
        Xr, AXr = Xo @ Q, AXo @ Q
        R = AXr[:, :, :K] - Xr[:, :, :K] * theta[:, None, :K]
        res = torch.sqrt((R * R).sum(dim=1)).amax(dim=-1)
        res = torch.where(torch.isfinite(res), res, torch.inf)
        bad = bad_g | bad_t  # as under JAX's eigh, a non-finite lane stays NaN
        res = torch.where(bad, torch.inf, res)
        Xr = torch.where(bad[:, None, None], torch.nan, Xr)
        theta = torch.where(bad[:, None], torch.nan, theta)
        return Xr, theta, res


class _GraphedRitzStep(_RitzStep):
    """`_RitzStep` on static buffers, for a sync-free solve on the card: the
    solve copies W and sc in once (`load`) and each filter's output into F,
    and each kind of step ('estimate', 'outer') is replayed from a CUDA graph,
    captured at its first use after one eager run on a side stream (the
    warm-up the capture needs, which does that step's work). Between steps
    the state is the static buffers, which the next solve of the shape
    overwrites: the solver hands back copies."""

    def __init__(self, key, B, N, m, K, device):
        f32 = dict(dtype=torch.float32, device=device)
        super().__init__(torch.empty((B, N, N), **f32), torch.empty((B, N), **f32), K)
        self.key = key
        self.F = torch.empty((B, N, m), **f32)
        self.static = dict(
            X=torch.empty((B, N, m), **f32), theta=torch.empty((B, m), **f32),
            res=torch.empty(B, **f32), outers=torch.empty(B, dtype=torch.int32, device=device),
            active=torch.empty(B, dtype=torch.bool, device=device), tol=torch.empty(B, **f32),
            c=torch.empty(B, **f32), e=torch.empty(B, **f32))
        self.__dict__.update(self.static)
        self.graphs = {}
        self.nbytes = self.static_bytes(B, N, m)

    @staticmethod
    def static_bytes(B, N, m) -> int:
        """The static buffers' bytes (each graph's own pool holds a few (B,
        N, m) intermediates more)."""
        return 4 * B * (N * N + N + 2 * N * m + m + 6) + B

    def load(self, W, sc):
        self.W.copy_(W)
        self.sc.copy_(sc)

    def start(self, X, theta, res):
        self._staged(_RitzStep.start, X, theta, res)

    def estimate(self, F):
        self._replay(_RitzStep.estimate, F)

    def outer(self, F):
        self._replay(_RitzStep.outer, F)

    def _staged(self, step, *args):
        """`step`, then its state copied into the static buffers."""
        step(self, *args)
        for name, buf in self.static.items():
            buf.copy_(getattr(self, name))
        self.__dict__.update(self.static)

    def _replay(self, step, F):
        self.F.copy_(F)
        if step in self.graphs:
            graph, eighs = self.graphs[step]
            graph.replay()
            small_eigh.launches += eighs
            count("eigs.rr_graph_replays")
            return
        dev = self.F.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._staged(step, self.F)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        captured = small_eigh.captured
        with span("eigs.sync"):  # the capture starts with a device-wide synchronize
            count("eigs.syncs")
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._staged(step, self.F)
        self.graphs[step] = (graph, small_eigh.captured - captured)
        count("eigs.rr_graph_captures")


_rr_graphs: "OrderedDict[tuple, _GraphedRitzStep]" = OrderedDict()


def _take_graphed_step(B, N, m, K, device):
    """The cached `_GraphedRitzStep` of (device, current stream, B, N, m,
    K), taken out of the cache while its solve runs (`_return_graphed_step`
    puts it back), or a new one; None where its static buffers alone exceed
    _RR_GRAPH_BYTES."""
    if _GraphedRitzStep.static_bytes(B, N, m) > _RR_GRAPH_BYTES:
        return None
    key = (device, torch.cuda.current_stream(device).cuda_stream, B, N, m, K)
    step = _rr_graphs.pop(key, None)
    return step if step is not None else _GraphedRitzStep(key, B, N, m, K, device)


def _return_graphed_step(step):
    _rr_graphs[step.key] = step
    while sum(s.nbytes for s in _rr_graphs.values()) > _RR_GRAPH_BYTES:
        _rr_graphs.popitem(last=False)


def _chebyshev_laplacian(W, d, K, m_block, n_outer, degree, mask,
                         apply_sign_fix, w_scale=None, window_init="auto",
                         x0=None, filter_impl="auto", matvec_precision="bf16"):
    """Chebyshev-filtered subspace iteration for the smallest-K eigenpairs of
    the whitened Laplacian, batched: W (B, N, N), d (B, N).

    Repeats [filter of `degree` damping [lam_cut, 2] -> orthonormalize ->
    Rayleigh-Ritz] on each lane whose residual max_k ||A x_k - theta_k x_k||
    is above CHEB_RESIDUAL_TOL, at most `n_outer` times (one round; the
    guard of `_laplacian_eigs_batched` may resume a solve for more rounds of
    `n_outer`, `_ChebyshevSolve`); converged lanes freeze. On CPU tensors,
    and on the card for blocks above SMALL_EIGH_MAX_M, the loop reads an
    exit test each outer and stops once no lane is active. On a CUDA device
    otherwise (`small_eigh`'s sync-free route) it reads none and runs all
    `n_outer` outers, the filter on the whole batch each time, with frozen
    lanes unchanged: the results, `outers` included, are those of the loop
    that stops; each outer's Rayleigh-Ritz step and update is a CUDA
    graph's replay where the shape's buffers fit _RR_GRAPH_BYTES
    (`_GraphedRitzStep`), else run eagerly. The filter is the one
    `resolved_cheb_impl` names, launched eagerly through this module's
    `chebyshev_filter` or `chebyshev_filter_chain`: the kernel on the bf16
    operator, or the XLA chain on the bf16 or (matvec_precision='f32') f32
    operator. Returns (evals (B, K), vectors (B, K, N), residual (B,),
    outers (B,)): residual is +inf where non-finite, `outers` counts each
    lane's filter applications that updated it. x0: optional (N, m_block)
    start block (default `default_start_block`)."""
    solve = _ChebyshevSolve(W, d, K, m_block, degree, mask, apply_sign_fix, w_scale,
                            window_init, x0, filter_impl, matvec_precision)
    out = solve.run(n_outer)
    solve.close()
    return out


class _ChebyshevSolve:
    """A Chebyshev solve (`_chebyshev_laplacian`) held between its rounds:
    `run` takes a round of outer iterations and returns the solve's results
    so far, `resume` narrows the active lanes and runs another round on the
    same step (on the card the same CUDA graphs), `close` hands a graphed
    step back to its cache."""

    def __init__(self, W, d, K, m_block, degree, mask, apply_sign_fix, w_scale=None,
                 window_init="auto", x0=None, filter_impl="auto", matvec_precision="bf16"):
        B, N, _ = W.shape
        dev = W.device
        validate_cheb_window_init(window_init)
        if window_init == "auto":
            window_init = "wide" if N <= _WIDE_INIT_MAX_N else "estimate"
        use_kernel = resolved_cheb_impl(N, filter_impl, matvec_precision, m_block) == "pallas"
        self.inv_sqrt_d = torch.rsqrt(d)
        sc = self.inv_sqrt_d if w_scale is None else self.inv_sqrt_d * torch.sqrt(w_scale)[:, None]
        S_fast = sc[:, :, None] * W * sc[:, None, :]
        if matvec_precision == "bf16":
            # the kernel's TMA map needs 16-byte aligned rows: built padded here
            # once, not copied by the wrapper at every filter
            S_fast = (kernel_operator(S_fast) if use_kernel and S_fast.is_cuda
                      else S_fast.to(torch.bfloat16))
        self.S_fast, self.degree = S_fast, degree
        self.filt = chebyshev_filter if use_kernel else chebyshev_filter_chain
        self.K, self.mask, self.apply_sign_fix = K, mask, apply_sign_fix
        X = _start_block(x0, B, N, m_block, mask, dev)
        self.sync_free = _sync_free(dev, m_block)
        step = _take_graphed_step(B, N, m_block, K, dev) if self.sync_free else None
        if step is None:
            step = _RitzStep(W, sc, K)
        else:
            step.load(W, sc)
        self.step = step
        with exact_f32():
            if window_init == "estimate":
                if use_kernel:
                    # T_3(A - 2I) magnifies the bottom of [0, 2] (|T_3|: 26 at 0
                    # -> 0 at 2), then one Rayleigh-Ritz gives the first window.
                    X = chebyshev_filter(S_fast, X, 2.0, 1.0, 3)
                else:
                    # the XLA chain's pre-loop: three normalized power steps of
                    # 2I - A
                    for _ in range(3):
                        X = 2.0 * X - (X - _chain_product(S_fast, X))
                        X = X / torch.clamp_min(
                            torch.linalg.vector_norm(X, dim=1, keepdim=True), 1e-20)
                step.estimate(X)
            else:
                # 'wide' / 'wide@<lam_cut>': the first outer filters with the
                # fixed window [lam_cut0, 2]; res = inf makes every lane run it.
                lam_cut0 = (_WIDE_INIT_LAM_CUT if window_init == "wide"
                            else float(window_init.split("@", 1)[1]))
                step.start(X, torch.full((B, m_block), (lam_cut0 - 1e-3) / 1.5,
                                         dtype=torch.float32, device=dev),
                           torch.full((B,), torch.inf, dtype=torch.float32, device=dev))

    def run(self, n_outer):
        """A round of at most `n_outer` outer iterations; returns (evals,
        vectors, residual, outers), copies (`_chebyshev_laplacian`)."""
        step, B = self.step, self.step.X.shape[0]
        with exact_f32():
            for _ in range(n_outer):
                with span("eigs.outer"):
                    if not self.sync_free:
                        # the exit test, one of the outer's three host syncs
                        # on a CUDA device (rr's two eighs are the others)
                        with span("eigs.sync"):
                            count("eigs.syncs")
                            n_active = int(step.active.sum())
                        if not n_active:
                            break
                    count("cheb.lanes_filtered", B)
                    step.outer(self.filt(self.S_fast, step.X, step.c, step.e, self.degree))
        K = self.K
        theta, res, outers = (t.clone() for t in (step.theta[:, :K], step.res, step.outers))
        vectors = _as_vectors(self.inv_sqrt_d[:, :, None] * step.X[:, :, :K], self.mask,
                              self.apply_sign_fix)
        return theta, vectors, res, outers

    def resume(self, lanes, tol, n_outer):
        """Another round on `lanes` (B,) bool, every other lane frozen, each
        lane held to its tolerance `tol` (B,)."""
        self.step.resume(lanes, tol)
        return self.run(n_outer)

    def close(self):
        if isinstance(self.step, _GraphedRitzStep):
            _return_graphed_step(self.step)


def _lobpcg_laplacian(W, d, K, m_block, iters, tol, lapnorm, mask,
                      apply_sign_fix, w_scale=None, x0=None):
    """Block LOBPCG for the smallest-K Laplacian eigenpairs, batched: the
    largest of the shifted operator c I - A, c a Gershgorin bound per image,
    with a block of m_block = K + extra. Padded rows stay zero (zero start
    rows, zero matvec rows). `iters` caps the iterations and `tol` is
    `lobpcg_standard`'s. x0: optional (N, m_block) start block (default
    `default_start_block`). W (B, N, N), d (B, N), w_scale (B,) or None."""
    B, N, _ = W.shape
    if lapnorm:
        inv_sqrt_d = torch.rsqrt(d)
        s = inv_sqrt_d if w_scale is None else inv_sqrt_d * torch.sqrt(w_scale)[:, None]
        c = 1.0 + (s[:, :, None] * W * s[:, None, :]).abs().sum(dim=2).amax(dim=1)

        def mv(X):
            return (c - 1.0)[:, None, None] * X + s[:, :, None] * (W @ (s[:, :, None] * X))
    else:
        wsc = (torch.ones(B, dtype=W.dtype, device=W.device) if w_scale is None
               else w_scale)
        c = (d + wsc[:, None] * W.abs().sum(dim=2)).amax(dim=1) + 1.0

        def mv(X):
            return ((c[:, None] - d)[:, :, None] * X
                    + wsc[:, None, None] * (W @ X))

    X0 = _start_block(x0, B, N, m_block, mask, W.device)
    with exact_f32():
        theta, V, _ = lobpcg_standard(mv, X0, m=iters, tol=tol)
    V = V[:, :, :K]
    if lapnorm:
        V = torch.rsqrt(d)[:, :, None] * V
    return (c[:, None] - theta)[:, :K], _as_vectors(V, mask, apply_sign_fix)


def _guard(W, d, K, lapnorm, mask, apply_sign_fix, w_scale, evals, vectors, res,
           outers=None, resume=None):
    """The solvers' fallback, as the reference's ARPACK retry
    (extract/extract.py:227-234): a lane whose residual is above
    CHEB_RESIDUAL_TOL or whose result is not finite is re-solved with eigh.
    A Chebyshev solve hands `resume(lanes, tol)`, which runs another round
    of its outers on `lanes` with the others frozen, each lane held to its
    tolerance `tol`, and returns its new (evals, vectors, res, outers): the
    finite lanes above the tolerance are resumed so, held to
    CHEB_CONTINUE_TOL from then on, up to CHEB_ROUNDS rounds in all, and
    eigh takes only what is left.
    One host sync a round reads which lanes fail, which hold a valid node
    (the first round) and the device count `outers` summed (the solve's
    `cheb.lanes_active`, counted as it grows). The counters `eigs.images`,
    `eigs.continued` (a Chebyshev solve's) and `eigs.resolved` take the
    valid lanes checked, the lanes resumed and the lanes re-solved."""
    B = res.shape[0]
    valid = torch.ones_like(res, dtype=torch.bool) if mask is None else mask.any(dim=1)
    rounds = lanes = 0
    tol = CHEB_RESIDUAL_TOL
    while True:
        finite = (torch.isfinite(res) & torch.isfinite(evals).all(dim=1)
                  & torch.isfinite(vectors).flatten(1).all(dim=1))
        # 0 passes, 1 finite above its tolerance (resumable), 2 not finite
        fails = torch.where(finite, (res > tol).to(torch.int32), 2)
        parts = [fails] + ([] if rounds else [valid])
        if outers is not None:
            parts.append(outers.sum().reshape(1))
        with span("eigs.sync"):
            count("eigs.syncs")
            read = torch.cat([t.to(torch.int32) for t in parts]).cpu()
        if outers is not None:
            count("cheb.lanes_active", int(read[-1]) - lanes)
            lanes = int(read[-1])
        resumable = int((read[:B] == 1).sum())
        if not rounds:
            count("eigs.images", int(read[B:2 * B].sum()))
            if resume is not None:
                count("eigs.continued", resumable)
        rounds += 1
        if resume is None or not resumable or rounds == CHEB_ROUNDS:
            break
        with span("eigs.continue"):
            tol = torch.where(fails == 1, CHEB_CONTINUE_TOL, tol)
            evals, vectors, res, outers = resume(fails == 1, tol)
    bad = torch.nonzero(read[:B]).flatten()
    if not bad.numel():
        return evals, vectors
    count("eigs.resolved", bad.numel())
    bad = bad.to(W.device, non_blocking=True)
    with exact_f32():
        ev_d, vec_d = _dense_laplacian(
            W[bad], d[bad], K, lapnorm, None if mask is None else mask[bad], apply_sign_fix,
            None if w_scale is None else w_scale[bad])
    evals, vectors = evals.clone(), vectors.clone()
    evals[bad], vectors[bad] = ev_d, vec_d
    return evals, vectors


def _laplacian_eigs_batched(W, K, *, lapnorm=True, mask=None,
                            apply_sign_fix=True, solver="auto", lobpcg_iters=None,
                            lobpcg_tol=None, lobpcg_block_extra=3, cheb_outer=4,
                            cheb_degree=10, cheb_guard=True,
                            cheb_filter_impl="auto", cheb_window_init="auto",
                            matvec_precision="bf16", return_residual=False,
                            w_scale=None, w_premasked=False, x0=None):
    """`laplacian_eigs` over a batch: W (B, N, N), mask (B, N), w_scale (B,).
    A Chebyshev solve takes rounds of `cheb_outer` outers: one unguarded
    (`return_residual` or not `cheb_guard`), else as many as its guard
    resumes it for (`_guard`, at most CHEB_ROUNDS)."""
    W = W.float()
    B, N, _ = W.shape
    if mask is not None and not w_premasked:
        m = mask.to(W.dtype)
        W = W * m[:, :, None] * m[:, None, :]
    if w_scale is None:
        d = degree_vector(W)
    else:
        w_scale = torch.as_tensor(w_scale, dtype=torch.float32, device=W.device).reshape(B)
        d_raw = W.sum(dim=-1) * w_scale[:, None]
        d = torch.where(d_raw < 1e-12, 1.0, d_raw)

    validate_cheb_window_init(cheb_window_init)
    m_block = K + lobpcg_block_extra
    solver = _resolve_solver(N, m_block, lapnorm, solver, cheb_filter_impl,
                             matvec_precision)
    if solver in ("lobpcg", "chebyshev"):
        solve = outers = None
        if solver == "lobpcg":
            iters = lobpcg_iters if lobpcg_iters is not None else (60 if N <= 2048 else 100)
            with span("eigs.lobpcg"):
                evals, vectors = _lobpcg_laplacian(W, d, K, m_block, iters, lobpcg_tol,
                                                   lapnorm, mask, apply_sign_fix,
                                                   w_scale=w_scale, x0=x0)
            res = torch.zeros(B, dtype=torch.float32, device=W.device)
        else:
            if not lapnorm:
                raise ValueError("solver='chebyshev' supports lapnorm=True only")
            with span("eigs.cheb"):
                solve = _ChebyshevSolve(
                    W, d, K, m_block, cheb_degree, mask, apply_sign_fix, w_scale=w_scale,
                    window_init=cheb_window_init, x0=x0, filter_impl=cheb_filter_impl,
                    matvec_precision=matvec_precision)
                evals, vectors, res, outers = solve.run(cheb_outer)
        if cheb_guard and not return_residual:
            with span("eigs.guard"):
                evals, vectors = _guard(
                    W, d, K, lapnorm, mask, apply_sign_fix, w_scale, evals, vectors, res,
                    outers, None if solve is None
                    else functools.partial(solve.resume, n_outer=cheb_outer))
        elif outers is not None and recording():
            with span("eigs.sync"):  # made only while tracing: no guard reads the count
                count("eigs.syncs")
                count("cheb.lanes_active", int(outers.sum()))
        if solve is not None:
            solve.close()
        return (evals, vectors, res) if return_residual else (evals, vectors)
    with exact_f32():
        out = _dense_laplacian(W, d, K, lapnorm, mask, apply_sign_fix, w_scale)
    if return_residual:
        return (*out, torch.zeros(B, dtype=torch.float32, device=W.device))
    return out


def laplacian_eigs(W: torch.Tensor, K: int, *, lapnorm: bool = True,
                   mask: Optional[torch.Tensor] = None,
                   apply_sign_fix: bool = True, solver: str = "auto",
                   lobpcg_iters: Optional[int] = None,
                   lobpcg_tol: Optional[float] = None,
                   lobpcg_block_extra: int = 3,
                   cheb_outer: int = 4, cheb_degree: int = 10,
                   cheb_guard: bool = True, cheb_filter_impl: str = "auto",
                   cheb_window_init: str = "auto", matvec_precision: str = "bf16",
                   return_residual: bool = False, w_scale=None,
                   w_premasked: bool = False, x0=None):
    """Smallest-K eigenpairs of the graph Laplacian of one (N, N) affinity W.

    lapnorm=True: (D - W) x = lam D x via the whitened operator (the
    reference default); lapnorm=False: (D - W) x = lam x. solver: 'eigh',
    'chebyshev', 'lobpcg' or 'auto' (see `_resolve_solver`). lobpcg_iters
    caps LOBPCG's iterations (None: 60 up to N = 2048, 100 above),
    lobpcg_tol is its exit tolerance (None: f32 epsilon), and its block is
    K + lobpcg_block_extra (also the chebyshev block). cheb_outer and
    cheb_degree: the chebyshev solve's outer iterations a round and its
    filter's degree. With cheb_guard an iterative result that is not finite
    is replaced by the dense solve, and a chebyshev lane whose residual
    exceeds CHEB_RESIDUAL_TOL is resumed for more rounds first (at most
    CHEB_ROUNDS in all), then replaced; return_residual returns (evals,
    vectors, residual) of the first round, unguarded.
    cheb_filter_impl ('auto' | 'xla' | 'pallas') and matvec_precision
    ('bf16' | 'f32') choose the chebyshev filter (`resolved_cheb_impl`) and
    with it the 'auto' solver's regime. w_scale: solve w_scale * W without materializing it;
    w_premasked: W already has zero padded rows and columns. Returns
    eigenvalues (K,) ascending and eigenvectors (K, N)."""
    out = _laplacian_eigs_batched(
        W[None], K, lapnorm=lapnorm, mask=None if mask is None else mask[None],
        apply_sign_fix=apply_sign_fix, solver=solver, lobpcg_iters=lobpcg_iters,
        lobpcg_tol=lobpcg_tol, lobpcg_block_extra=lobpcg_block_extra,
        cheb_outer=cheb_outer,
        cheb_degree=cheb_degree, cheb_guard=cheb_guard,
        cheb_filter_impl=cheb_filter_impl, cheb_window_init=cheb_window_init,
        matvec_precision=matvec_precision, return_residual=return_residual,
        w_scale=None if w_scale is None else torch.as_tensor(w_scale).reshape(1),
        w_premasked=w_premasked, x0=x0)
    return tuple(o[0] for o in out)


def resolve_eig_chunk(eig_chunk: Union[int, str, None], B: int) -> Optional[int]:
    """'auto' = whole batch below b64, chunks of 8 at B >= 64 when 8 divides
    B (the rule is inherited from the JAX package; not yet measured on this
    card). None/0 = whole batch; ints pass through."""
    if eig_chunk == "auto":
        return 8 if (B >= 64 and B % 8 == 0) else None
    return eig_chunk or None


def affinity_eigs(W: torch.Tensor, K: int, *, mask: Optional[torch.Tensor] = None,
                  apply_sign_fix: bool = True):
    """Largest-K eigenpairs of affinities W (B, N, N), with the reference's
    quirk (extract/extract.py:166-172): the eigenvalues ascending (ARPACK's
    order), the eigenvectors (B, K, N) in descending eigenvalue order. Padded
    eigenvalues are pushed below the valid spectrum."""
    W = W.float()
    if mask is not None:
        m = mask.to(W.dtype)
        W = W * m[:, :, None] * m[:, None, :]
        bound = W.abs().sum(dim=-1).amax(dim=-1) + 1.0
        W = W - torch.diag_embed(torch.where(mask, 0.0, bound[:, None]))
    evals, evecs = torch.linalg.eigh(W)
    return evals[:, -K:], _as_vectors(evecs[:, :, -K:].flip(-1), mask, apply_sign_fix)


def affinity_svd_eigs(feats: torch.Tensor, K: int, *,
                      mask: Optional[torch.Tensor] = None,
                      apply_sign_fix: bool = True):
    """The reference's 'affinity_svd' mode (extract/extract.py:160-163): the
    top-K singular values of the (masked) features (B, N, D) and their left
    singular vectors (B, K, N)."""
    f = feats.float()
    if mask is not None:
        f = f * mask.to(f.dtype)[:, :, None]
    U, S, _ = torch.linalg.svd(f, full_matrices=False)
    vectors = U[:, :, :K].transpose(1, 2)
    if apply_sign_fix:
        vectors = sign_fix(vectors, mask)
    return S[:, :K], vectors


_WHICH_MATRIX = ("laplacian", "matting_laplacian", "affinity", "affinity_torch",
                 "affinity_svd")


def spectral_decompose_batched(
        feats: torch.Tensor, masks: Optional[torch.Tensor] = None,
        color_W: Optional[torch.Tensor] = None, *,
        K: int = 5, which_matrix: str = "laplacian", normalize: bool = True,
        threshold_at_zero: bool = True, lapnorm: bool = True,
        image_color_lambda: float = 0.0, solver: str = "auto",
        cheb_filter_impl: str = "auto", cheb_window_init: str = "auto",
        cheb_degree: int = 10, return_residual: bool = False,
        eig_chunk: Union[int, str, None] = "auto", x0=None):
    """Affinity -> Laplacian -> eigensolve for a batch of images.

    feats (B, N, D), masks (B, N) bool, color_W (B, N, N) or None. With
    color_W and image_color_lambda > 0 the solved graph is the reference's
    W_feat / max + lambda W_color (extract/extract.py:199-221); otherwise the
    affinity's max-normalization is deferred into the solver (w_scale).
    which_matrix: 'laplacian' or 'matting_laplacian' (the Laplacian
    eigenpairs), 'affinity' or 'affinity_torch' (`affinity_eigs`),
    'affinity_svd' (`affinity_svd_eigs`). With return_residual, also
    returns the per-image chebyshev residuals (0 for the other solvers and
    modes), unguarded; without it, images whose iterative solve did not
    converge (a residual above CHEB_RESIDUAL_TOL or a non-finite result) are
    re-solved with dense eigh by `_laplacian_eigs_batched`'s guard, which
    counts them (`eigs.resolved`). cheb_filter_impl: the chebyshev filter, as
    `resolved_cheb_impl` resolves it ('auto', the port's default, is the
    kernel). eig_chunk solves the batch in sequential sub-batches (see
    resolve_eig_chunk). x0: the iterative solvers' (N, K + 3) start block.
    Returns eigenvalues (B, K) and eigenvectors (B, K, N)."""
    if which_matrix not in _WHICH_MATRIX:
        raise ValueError(f"unknown which_matrix: {which_matrix}")
    B, N, _ = feats.shape
    if masks is None:
        masks = torch.ones((B, N), dtype=torch.bool, device=feats.device)
    fuse = color_W is not None and image_color_lambda > 0

    def solve(f, m, cw):
        if which_matrix in ("laplacian", "matting_laplacian"):
            kw = dict(lapnorm=lapnorm, mask=m, solver=solver, cheb_degree=cheb_degree,
                      cheb_filter_impl=cheb_filter_impl,
                      cheb_window_init=cheb_window_init,
                      return_residual=return_residual, w_premasked=True, x0=x0)
            with span("eigs.affinity"):
                W = feature_affinity(f, normalize=normalize,
                                     threshold_at_zero=threshold_at_zero,
                                     max_normalize=fuse, mask=m)
            if fuse:
                # both terms have zero padded rows and columns
                return _laplacian_eigs_batched(
                    W + cw.float() * image_color_lambda, K, **kw)
            w_scale = 1.0 / torch.clamp_min(W.amax(dim=(-2, -1)), 1e-12)
            return _laplacian_eigs_batched(W, K, w_scale=w_scale, **kw)
        if which_matrix == "affinity_svd":
            out = affinity_svd_eigs(l2_normalize(f.float()) if normalize else f, K,
                                    mask=m)
        else:
            W = feature_affinity(f, normalize=normalize,
                                 threshold_at_zero=threshold_at_zero,
                                 max_normalize=False, mask=m)
            out = affinity_eigs(W, K, mask=m)
        if return_residual:
            return (*out, torch.zeros(f.shape[0], dtype=torch.float32, device=f.device))
        return out

    chunk = resolve_eig_chunk(eig_chunk, B)
    if chunk and B % chunk:
        raise ValueError(f"eig_chunk={chunk} must divide the batch size {B}")
    with span("eigs.decompose"):
        if not chunk or chunk >= B:
            return solve(feats, masks, color_W)
        parts = [solve(feats[i:i + chunk], masks[i:i + chunk],
                       None if color_W is None else color_W[i:i + chunk])
                 for i in range(0, B, chunk)]
        return tuple(torch.cat(p) for p in zip(*parts))


def spectral_decompose(feats: torch.Tensor, K: int, *,
                       which_matrix: str = "laplacian", normalize: bool = True,
                       threshold_at_zero: bool = True, lapnorm: bool = True,
                       color_W: Optional[torch.Tensor] = None,
                       image_color_lambda: float = 0.0,
                       mask: Optional[torch.Tensor] = None,
                       solver: str = "auto", cheb_filter_impl: str = "auto",
                       cheb_window_init: str = "auto",
                       cheb_degree: int = 10, return_residual: bool = False,
                       x0=None):
    """`spectral_decompose_batched` for one image's (N, D) features, with
    its optional (N, N) color affinity color_W."""
    out = spectral_decompose_batched(
        feats[None], None if mask is None else mask[None],
        None if color_W is None else color_W[None], K=K,
        which_matrix=which_matrix, normalize=normalize,
        threshold_at_zero=threshold_at_zero, lapnorm=lapnorm,
        image_color_lambda=image_color_lambda, solver=solver,
        cheb_filter_impl=cheb_filter_impl, cheb_window_init=cheb_window_init,
        cheb_degree=cheb_degree, return_residual=return_residual, eig_chunk=None,
        x0=x0)
    return tuple(o[0] for o in out)
