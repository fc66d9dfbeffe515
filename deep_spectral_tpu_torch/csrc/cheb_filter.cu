// Chebyshev filter chain for Hopper (sm_90a): T_degree(((I - S) - c) / e) X,
// batched over images.
//
// Replaces: deep_spectral_tpu/ops/cheb_filter.py::_cheb_kernel (launched by
// chebyshev_filter). Same arithmetic as the Pallas form:
//   a_shift(t) = ((1 - c) t - S bf16(t)) * (1 / e)     (f32 accumulation)
//   T_0 = X, T_1 = a_shift(X),
//   T_{j+1} = 2 a_shift(T_j) - T_{j-1}, then (T_j, T_{j+1}) of each column are
//   both scaled by 1 / max(max_i |T_{j+1}[i]|, 1).
//
// What bounds it on this card: each step is a GEMV-like product of the (N, N)
// bf16 operator with a thin (N, 8) block: 8 FMAs per operator element and no
// reuse of the operator across columns beyond those 8, so the step is bound by
// how fast one SM can stream the operator (1.6 MB at N=900) and issue the FMAs.
// The TPU kernel kept S resident in VMEM for the whole chain; at 1.6-26 MB it
// cannot live in one SM's 227 KB of shared memory here.
//
// What the design does about it (the simple version): one CTA per (image,
// group of 8 columns) runs the whole chain, so the recurrence never leaves the
// CTA and steps are separated by __syncthreads() instead of kernel launches.
// The operator is re-read from L2/HBM every step (the 50 MB L2 holds the
// b24 N=900 batch). The block T_{j-1}, T_j, T_{j+1} (f32) and bf16(T_j) live in
// shared memory when N * 112 bytes fit, else in a global scratch buffer the
// wrapper allocates; the same code serves both through generic pointers. Each
// warp takes 4 operator rows at a time; a transposing butterfly reduction
// leaves one (row, column) dot product per lane. The per-column max for the
// rescale is a warp reduction plus a shared-memory atomicMax.
// The bound to attack later: the grid is B x ceil(m/8) CTAs, 24 of the card's
// 132 SMs on the main path, each streaming its own operator.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MC = 8;          // columns per CTA
constexpr int THREADS = 512;   // 16 warps
constexpr int NWARPS = THREADS / 32;
constexpr int ROWS = 4;        // operator rows per warp pass (ROWS * MC == 32 lanes)
constexpr int FLOATS_PER_ROW = 3 * MC + MC / 2;  // T0, T1, T2 (f32) + Tb (bf16)

// Transposing butterfly over the warp: at stage OFF each lane keeps half of
// its values (the upper half when lane & OFF), summed with its partner's
// matching half. After the five stages lane l holds the warp sum of value l.
template <int OFF>
__device__ __forceinline__ void butterfly(float (&acc)[32], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? acc[i] : acc[i + OFF];
    const float keep = upper ? acc[i + OFF] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
  if constexpr (OFF > 1) butterfly<OFF / 2>(acc, lane);
}

// 1 / max(m, 1) with jnp.maximum's NaN propagation.
__device__ __forceinline__ float rescale_factor(unsigned int max_bits) {
  const float mv = __uint_as_float(max_bits);
  return 1.0f / (isnan(mv) ? mv : fmaxf(mv, 1.0f));
}

// Matvec of rows [row0, row0 + ROWS) of S against bf16 block Tb; returns, in
// every lane, the dot product for (row0 + lane / MC, column lane % MC).
__device__ __forceinline__ float rows_dot(const __nv_bfloat16* __restrict__ S, int N, int row0,
                                          const __nv_bfloat16* Tb, int lane) {
  static_assert(ROWS * MC == 32, "one reduced value per lane");
  float acc[ROWS * MC];
#pragma unroll
  for (int i = 0; i < ROWS * MC; ++i) acc[i] = 0.f;
  const __nv_bfloat16* srow[ROWS];
  bool rvalid[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    rvalid[r] = row0 + r < N;
    srow[r] = S + (long long)(rvalid[r] ? row0 + r : row0) * N;
  }
  for (int kcol = lane; kcol < N; kcol += 32) {
    const uint4 tb4 = *reinterpret_cast<const uint4*>(Tb + (long long)kcol * MC);
    const __nv_bfloat162* tb2 = reinterpret_cast<const __nv_bfloat162*>(&tb4);
    float tv[MC];
#pragma unroll
    for (int i = 0; i < MC / 2; ++i) {
      const float2 f = __bfloat1622float2(tb2[i]);
      tv[2 * i] = f.x;
      tv[2 * i + 1] = f.y;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (!rvalid[r]) continue;
      const float sv = __bfloat162float(srow[r][kcol]);
#pragma unroll
      for (int c = 0; c < MC; ++c) acc[r * MC + c] = fmaf(sv, tv[c], acc[r * MC + c]);
    }
  }
  butterfly<16>(acc, lane);
  return acc[0];
}

__global__ void __launch_bounds__(THREADS)
cheb_filter_kernel(const __nv_bfloat16* __restrict__ S,  // (B, N, N)
                   const float* __restrict__ X,          // (B, N, m)
                   const float* __restrict__ ce,         // (B, 2): c, e
                   float* __restrict__ out,              // (B, N, m)
                   float* scratch,                       // (B, G, N, FLOATS_PER_ROW) or null
                   int N, int m, int degree) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned int colmax[2][MC];

  const int b = blockIdx.x;
  const int grp = blockIdx.y;
  const int col0 = grp * MC;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  float* base = scratch != nullptr
                    ? scratch + ((long long)b * gridDim.y + grp) * (long long)N * FLOATS_PER_ROW
                    : reinterpret_cast<float*>(smem);
  float* T0 = base;
  float* T1 = base + (long long)N * MC;
  float* T2 = base + 2LL * N * MC;
  __nv_bfloat16* Tb = reinterpret_cast<__nv_bfloat16*>(base + 3LL * N * MC);

  const float c = ce[2 * b];
  const float inv_e = 1.0f / ce[2 * b + 1];
  const float one_minus_c = 1.0f - c;
  const __nv_bfloat16* Sb = S + (long long)b * N * N;

  for (int i = tid; i < N * MC; i += THREADS) {
    const int row = i / MC, col = col0 + i % MC;
    const float x = col < m ? X[((long long)b * N + row) * m + col] : 0.f;
    T0[i] = x;
    Tb[i] = __float2bfloat16_rn(x);
  }
  if (tid < 2 * MC) colmax[tid / MC][tid % MC] = 0u;
  __syncthreads();

  const int n_groups = (N + ROWS - 1) / ROWS;
  const int my_r = lane / MC;   // row within the group this lane finishes
  const int my_c = lane % MC;   // column this lane finishes

  // T_1 = a_shift(T_0); no rescale on the first step (as in the Pallas kernel).
  for (int gi = warp; gi < n_groups; gi += NWARPS) {
    const float y = rows_dot(Sb, N, gi * ROWS, Tb, lane);
    const int row = gi * ROWS + my_r;
    if (row < N) {
      const int idx = row * MC + my_c;
      T1[idx] = (one_minus_c * T0[idx] - y) * inv_e;
    }
  }
  __syncthreads();
  for (int i = tid; i < N * MC; i += THREADS) Tb[i] = __float2bfloat16_rn(T1[i]);
  __syncthreads();

  for (int step = 1; step < degree; ++step) {
    unsigned int* cmax = colmax[step & 1];
    // |t| of a non-negative float orders like its bit pattern, NaN above inf.
    unsigned int lane_max = 0u;
    for (int gi = warp; gi < n_groups; gi += NWARPS) {
      const float y = rows_dot(Sb, N, gi * ROWS, Tb, lane);
      const int row = gi * ROWS + my_r;
      if (row < N) {
        const int idx = row * MC + my_c;
        const float a = (one_minus_c * T1[idx] - y) * inv_e;
        const float t2 = 2.0f * a - T0[idx];
        T2[idx] = t2;
        lane_max = max(lane_max, __float_as_uint(fabsf(t2)));
      }
    }
    // Lanes l, l^8, l^16, l^24 finish the same column.
    unsigned int u = lane_max;
    u = max(u, __shfl_xor_sync(0xffffffffu, u, 8));
    u = max(u, __shfl_xor_sync(0xffffffffu, u, 16));
    if (lane < MC) atomicMax(&cmax[lane], u);
    __syncthreads();

    float sc[MC];
#pragma unroll
    for (int cc = 0; cc < MC; ++cc) sc[cc] = rescale_factor(cmax[cc]);
    if (tid < MC) colmax[(step + 1) & 1][tid] = 0u;  // the buffer the next step uses
    for (int i = tid; i < N * MC; i += THREADS) {
      const float s = sc[i % MC];
      T1[i] *= s;
      const float t = T2[i] * s;
      T2[i] = t;
      Tb[i] = __float2bfloat16_rn(t);
    }
    float* old0 = T0;  // rotate: (T0, T1, T2) <- (T1, T2, T0)
    T0 = T1;
    T1 = T2;
    T2 = old0;
    __syncthreads();
  }

  for (int i = tid; i < N * MC; i += THREADS) {
    const int row = i / MC, col = col0 + i % MC;
    if (col < m) out[((long long)b * N + row) * m + col] = T1[i];
  }
}

}  // namespace

extern "C" int dss_cheb_filter_row_bytes() { return FLOATS_PER_ROW * 4; }

extern "C" int dss_cheb_filter(const void* S, const void* X, const void* ce, void* out,
                               void* scratch, int B, int N, int m, int degree, void* stream) {
  const dim3 grid(B, (m + MC - 1) / MC);
  const size_t smem = scratch != nullptr ? 0 : (size_t)N * FLOATS_PER_ROW * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cheb_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cheb_filter_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(S), static_cast<const float*>(X),
      static_cast<const float*>(ce), static_cast<float*>(out), static_cast<float*>(scratch),
      N, m, degree);
  return static_cast<int>(cudaGetLastError());
}
