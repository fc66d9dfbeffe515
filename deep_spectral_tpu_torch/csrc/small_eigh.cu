// Eigenpairs of a batch of small symmetric f32 matrices (order m <= 32):
// cyclic Jacobi, one CTA a matrix, with no host sync.
//
// Replaces no TPU kernel. The JAX package's Chebyshev solver
// (deep_spectral_tpu/ops/eigen.py, its Rayleigh-Ritz step) calls
// jnp.linalg.eigh on (B, m, m) matrices, which XLA runs on the TPU inside
// the compiled loop. torch.linalg.eigh on a CUDA tensor runs cuSOLVER and
// reads its error flags back to the host, a host sync a call and two a
// Rayleigh-Ritz step. This kernel computes the same pairs on the device
// alone, so the port's Rayleigh-Ritz step (ops/eigen.py) is captured in a
// CUDA graph and a solve waits for the card once, at its guard.
//
// Arithmetic: f32 in and out, as cuSOLVER's f32 eigh, f64 inside. A is the
// lower triangle of M, mirrored (the triangle cuSOLVER reads), V = I. Each round
// rotates m/2 disjoint index pairs (p, q), chosen in the round-robin order
// (m - 1 rounds a sweep meet every pair once; an odd m gets a zero dummy
// index), each by the Jacobi rotation that zeroes A[p][q]:
//   tau = (A_qq - A_pp) / (2 A_pq), t = sign(tau) / (|tau| + hypot(1, tau)),
//   c = 1 / sqrt(1 + t^2), s = t c;   A <- J^T A J, V <- V J,
// the pair's own 2 x 2 block set exactly (A_pp - t A_pq, A_qq + t A_pq, 0).
// Sweeps run until the off-diagonal Frobenius norm is at most f32 eps x
// ||A||_F, the output's own rounding (at most 10 sweeps up to m = 32 on
// random, clustered, degenerate and Gram matrices), or MAX_SWEEPS ran. Why
// f64 inside: each column takes a sweep's m - 1 rotations, and in f32 their
// rounding accumulates to a backward error ||V^T A V - diag(w)|| of 1.6e-6
// (m = 8) to 1.5e-5 (m = 23) at ||A|| ~ 1-3 (tests/test_torch_small_eigh.py's
// matrices), 13-130 f32 ulps, where cuSOLVER's f32 eigh leaves ~1e-6; in f64
// it is the f32 rounding of the result, 6e-8 to 9e-7.
// Eigenvalues come out ascending (ties by index), rounded to f32, and
// eigenvectors as V's columns, as torch.linalg.eigh returns them. A
// matrix with a non-finite entry is solved as the identity and flagged
// (bad = 1), as ops/lobpcg.py's eigh_finite does, with no read-back.
//
// What bounds it: latency, not bytes or flops. A matrix is at most 4 KB and
// a sweep at m = 8 is ~2,000 flops; the time is the chain of rounds, each a
// pass over shared memory between two barriers. So a round is one pass: the
// m/2 rotations, a barrier, then every 2 x 2 block (p, q) x (r, s) of the
// two-sided update by one thread (the blocks on and above the block
// diagonal, each written to both sides, so A stays exactly symmetric) beside
// the columns of V, a barrier. One CTA of 32-256 threads a matrix (one warp
// at m = 8), the batch over as many SMs; results are deterministic (no
// atomics, every sum in one order).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXM = 32;          // largest order taken
constexpr int PITCH = MAXM + 1;   // padded rows: a column walk spreads over the banks
constexpr int MAX_SWEEPS = 24;    // twice the most any test matrix needs
constexpr int MAX_THREADS = 256;

// The index at position `pos` of round `round` of the round-robin schedule
// over n (even) indices: index 0 stays, the others turn one place a round.
__device__ __forceinline__ int player(int pos, int round, int n) {
  return pos == 0 ? 0 : 1 + (pos - 1 + round) % (n - 1);
}

// x summed over the block; every thread gets the same value, summed in one order.
__device__ double block_sum(double x, double* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();  // red's readers of a previous call are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

__global__ void __launch_bounds__(MAX_THREADS)
small_eigh_kernel(const float* __restrict__ M, float* __restrict__ w, float* __restrict__ V,
                  uint8_t* __restrict__ bad, int m) {
  __shared__ double a[MAXM][PITCH];
  __shared__ double v[MAXM][PITCH];
  __shared__ double rot_c[MAXM / 2], rot_s[MAXM / 2], rot_t[MAXM / 2];
  __shared__ int rot_p[MAXM / 2], rot_q[MAXM / 2];
  __shared__ int rank[MAXM];
  __shared__ double red[MAX_THREADS / 32];
  __shared__ int nonfinite;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = m + (m & 1), np = n / 2;
  const float* mb = M + static_cast<size_t>(blockIdx.x) * m * m;

  if (tid == 0) nonfinite = 0;
  __syncthreads();
  for (int k = tid; k < n * n; k += nt) {
    const int i = k / n, j = k % n;
    double x = 0.0;
    if (i < m && j < m) {
      if (!isfinite(mb[i * m + j])) nonfinite = 1;
      x = i >= j ? mb[i * m + j] : mb[j * m + i];
    }
    a[i][j] = x;
    v[i][j] = i == j ? 1.0 : 0.0;
  }
  __syncthreads();
  const bool flagged = nonfinite != 0;  // the same in every thread
  if (flagged) {
    for (int k = tid; k < n * n; k += nt) {
      const int i = k / n, j = k % n;
      a[i][j] = (i == j && i < m) ? 1.0 : 0.0;
    }
  }
  __syncthreads();

  double sq = 0.0;
  for (int k = tid; k < n * n; k += nt) {
    const double x = a[k / n][k % n];
    sq += x * x;
  }
  const double tol2 = static_cast<double>(FLT_EPSILON) * FLT_EPSILON * block_sum(sq, red);

  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    double off = 0.0;
    for (int k = tid; k < n * n; k += nt) {
      const int i = k / n, j = k % n;
      if (i != j) off += a[i][j] * a[i][j];
    }
    if (!(block_sum(off, red) > tol2)) break;
    for (int round = 0; round < n - 1; ++round) {
      if (tid < np) {
        const int p = player(tid, round, n), q = player(n - 1 - tid, round, n);
        const double apq = a[p][q];
        double c = 1.0, s = 0.0, t = 0.0;
        if (apq != 0.0) {
          const double tau = (a[q][q] - a[p][p]) / (2.0 * apq);
          t = copysign(1.0, tau) / (fabs(tau) + hypot(1.0, tau));
          c = 1.0 / sqrt(1.0 + t * t);
          s = t * c;
        }
        rot_p[tid] = p;
        rot_q[tid] = q;
        rot_c[tid] = c;
        rot_s[tid] = s;
        rot_t[tid] = t;
      }
      __syncthreads();
      // A <- J^T A J, block (x, y) = rows (p, q) of pair x by columns (r, s)
      // of pair y; the blocks below the diagonal are the mirrors written here
      for (int k = tid; k < np * np; k += nt) {
        const int x = k / np, y = k % np;
        if (y < x) continue;
        const int p = rot_p[x], q = rot_q[x], r = rot_p[y], s = rot_q[y];
        const double apr = a[p][r], aps = a[p][s], aqr = a[q][r], aqs = a[q][s];
        if (x == y) {
          const double t = rot_t[x];
          a[p][p] = apr - t * aps;
          a[q][q] = aqs + t * aps;
          a[p][q] = 0.0;
          a[q][p] = 0.0;
          continue;
        }
        const double c1 = rot_c[x], s1 = rot_s[x], c2 = rot_c[y], s2 = rot_s[y];
        const double tpr = c1 * apr - s1 * aqr, tps = c1 * aps - s1 * aqs;
        const double tqr = s1 * apr + c1 * aqr, tqs = s1 * aps + c1 * aqs;
        const double npr = c2 * tpr - s2 * tps, nps = s2 * tpr + c2 * tps;
        const double nqr = c2 * tqr - s2 * tqs, nqs = s2 * tqr + c2 * tqs;
        a[p][r] = npr;
        a[r][p] = npr;
        a[p][s] = nps;
        a[s][p] = nps;
        a[q][r] = nqr;
        a[r][q] = nqr;
        a[q][s] = nqs;
        a[s][q] = nqs;
      }
      // V <- V J, row i of pair x's columns
      for (int k = tid; k < n * np; k += nt) {
        const int i = k / np, x = k % np;
        const int p = rot_p[x], q = rot_q[x];
        const double c = rot_c[x], s = rot_s[x];
        const double vp = v[i][p], vq = v[i][q];
        v[i][p] = c * vp - s * vq;
        v[i][q] = s * vp + c * vq;
      }
      __syncthreads();
    }
  }

  // ascending order, NaN last, ties by index: a permutation in every case
  const size_t b = blockIdx.x;
  if (tid < m) {
    const double di = a[tid][tid];
    const double ki = isnan(di) ? INFINITY : di;
    int r = 0;
    for (int j = 0; j < m; ++j) {
      const double kj = isnan(a[j][j]) ? INFINITY : a[j][j];
      r += (kj < ki) || (kj == ki && j < tid);
    }
    rank[tid] = r;
    w[b * m + r] = static_cast<float>(di);
  }
  __syncthreads();
  for (int k = tid; k < m * m; k += nt) {
    const int i = k / m, j = k % m;
    V[b * m * m + i * m + rank[j]] = static_cast<float>(v[i][j]);
  }
  if (tid == 0) bad[b] = flagged ? 1 : 0;
}

}  // namespace

// M: (B, m, m) f32 contiguous; w: (B, m) f32; V: (B, m, m) f32; bad: (B,)
// bytes (torch.bool). Launches on `stream`, does not synchronize.
extern "C" int dss_small_eigh(const void* M, void* w, void* V, void* bad, int B, int m,
                              void* stream) {
  if (B < 1 || m < 1 || m > MAXM) return static_cast<int>(cudaErrorInvalidValue);
  const int n = m + (m & 1);
  int threads = (n * (n / 2) + 31) / 32 * 32;
  threads = threads > MAX_THREADS ? MAX_THREADS : threads;
  small_eigh_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(M), static_cast<float*>(w), static_cast<float*>(V),
      static_cast<uint8_t*>(bad), m);
  return static_cast<int>(cudaGetLastError());
}
