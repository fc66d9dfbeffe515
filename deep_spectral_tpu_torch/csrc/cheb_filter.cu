// Chebyshev filter chain, the mma.sync build: T_degree(((I - S) - c) / e) X,
// batched over images, one launch per step.
//
// Replaced on every path by csrc/cheb_filter_sm90.cu, but faster than that
// kernel's streaming build at b4 N=1288-2048 (PERF.md); reached through
// ops/cheb_filter.chebyshev_filter_mma and held to the twin. It ported
// deep_spectral_tpu/ops/cheb_filter.py::_cheb_kernel. Same arithmetic as the
// Pallas form:
//   a_shift(t) = ((1 - c) t - S bf16(t)) * (1 / e)     (f32 accumulation)
//   T_0 = X, T_1 = a_shift(X),
//   T_{j+1} = 2 a_shift(T_j) - T_{j-1}, then (T_j, T_{j+1}) of each column are
//   both scaled by 1 / max(max_i |T_{j+1}[i]|, 1).
//
// What bounds it on this card: every step multiplies the (N, N) bf16 operator
// by a thin (N, 8) block, 16 flops per operator element, so a step is a pass
// over the operator (1.6 MB per image at N=900, 26 MB at N=3600) and the chain
// is `degree` such passes: memory bound, from L2 when the batch's operators fit
// its 50 MB (b24 N=900: 38.9 MB) and from HBM when they do not.
//
// What the design does about it: every image is spread over the card. One
// launch per step; the grid is (slab of 64 operator rows, group of 8 columns,
// image), 15 x 1 x 24 = 360 CTAs at b24 N=900 and 57 x 1 x 2 = 114 at b2
// N=3600, so every SM streams its share of the operators. A CTA stages
// bf16(T_j) of its image and column group in shared memory, transposed, in
// windows of KW rows, and its 8 warps (4 row blocks of 16 x 2 halves of the
// key axis, summed through shared memory at the end) run the products on the
// tensor cores with mma.sync m16n8k16 (bf16 x bf16 exact, f32 sums). Each
// thread loads 16 contiguous operator bytes per row and chunk; since a dot
// product may visit k in any order, the A and B fragments both use the
// permutation "logical k {2t, 2t+1, 8+2t, 9+2t} -> physical 8t + {0..3}" (and
// 8t + {4..7} for the second k-step), so no shuffle or ldmatrix is needed.
//
// Steps are separated by launches; the joint rescale crosses the boundary:
// step k writes T_{k+1} unscaled in f32 plus a per-(image, column) atomicMax of
// its |values| (bit patterns of non-negative floats order like the floats, NaN
// above inf); step k + 1 turns the max into the factor, scales its f32 inputs
// and only then rounds to bf16 (bf16(sc t) != sc bf16(t)), and writes the
// scaled T_k back in place; a last pass applies the last factor.
//
// Buffers (the wrapper allocates them): A (B, N, m) holds T_{j-1} for the next
// step (updated in place, each CTA only touches its own rows), R0/R1 (B, N, m)
// alternate as the unscaled T_j (read by every CTA of the image) and T_{j+1}
// (written), and colmax (degree + 1, B, m) holds each step's column maxima.
// The operator is re-read every step; cheb_filter_sm90.cu keeps it on chip
// across the chain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MC = 8;            // columns per CTA (the mma's n)
constexpr int ROWS = 64;         // operator rows per CTA
constexpr int RB = ROWS / 16;    // row blocks of 16 (one per warp)
constexpr int KSPLIT = 2;        // halves of the key axis (warps per row block)
constexpr int NWARPS = RB * KSPLIT;
constexpr int THREADS = NWARPS * 32;
constexpr int CHUNK = 32;        // key rows per mma pair (2 k-steps of 16)
constexpr int KW = 2048;         // key rows staged per window
constexpr int PITCH = KW + 32;   // bf16 per staged column: 4160 B = 64 mod 128 B
constexpr int UNROLL = 4;        // chunks in flight per warp

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 1 / max(m, 1) with jnp.maximum's NaN propagation; no max yet means 1.
__device__ __forceinline__ float rescale_factor(const unsigned int* max_bits) {
  if (max_bits == nullptr) return 1.0f;
  const float mv = __uint_as_float(*max_bits);
  return 1.0f / (isnan(mv) ? mv : fmaxf(mv, 1.0f));
}

// Eight consecutive bf16 of one operator row as four 32-bit words, loaded
// VEC elements at a time (the row start is only VEC-element aligned).
template <int VEC>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, uint32_t (&w)[4]) {
  if constexpr (VEC == 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (VEC == 4) {
    const uint2 v0 = __ldg(reinterpret_cast<const uint2*>(p));
    const uint2 v1 = __ldg(reinterpret_cast<const uint2*>(p + 4));
    w[0] = v0.x; w[1] = v0.y; w[2] = v1.x; w[3] = v1.y;
  } else if constexpr (VEC == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __ldg(reinterpret_cast<const unsigned int*>(p + 2 * i));
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__ldg(q + 2 * i) | ((uint32_t)__ldg(q + 2 * i + 1) << 16);
  }
}

// The same eight values with every key index >= kend read as 0 (the tail).
__device__ __forceinline__ void load8_guarded(const __nv_bfloat16* p, int k, int kend,
                                              uint32_t (&w)[4]) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = k + 2 * i < kend ? __ldg(q + 2 * i) : 0u;
    const uint32_t hi = k + 2 * i + 1 < kend ? __ldg(q + 2 * i + 1) : 0u;
    w[i] = lo | (hi << 16);
  }
}

__device__ __forceinline__ void mma_chunk(float (&acc)[4], const uint32_t (&lo)[4],
                                          const uint32_t (&hi)[4], const uint4& tb) {
  mma_bf16_16816(acc, lo[0], hi[0], lo[1], hi[1], tb.x, tb.y);
  mma_bf16_16816(acc, lo[2], hi[2], lo[3], hi[3], tb.z, tb.w);
}

// One step of the chain for rows [blockIdx.x * ROWS, +ROWS), columns
// [blockIdx.y * MC, +MC) of image blockIdx.z:
//   t1 = src * sc (sc from src_max; 1 when src_max is null)
//   first:  w = a_shift(t1)
//   else:   w = 2 a_shift(t1) - a_in * sc, and a_out = t1 (own rows)
// and, when w_max is given, atomicMax of |w| per column into w_max.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
cheb_step_kernel(const __nv_bfloat16* __restrict__ S,   // (B, N, N)
                 const float* __restrict__ src,         // (B, N, m)
                 const unsigned int* __restrict__ src_max,  // (B, m) or null
                 const float* a_in,                     // (B, N, m) or null (first step)
                 float* a_out,                          // (B, N, m) or null
                 float* __restrict__ w,                 // (B, N, m)
                 unsigned int* __restrict__ w_max,      // (B, m) or null
                 const float* __restrict__ ce,          // (B, 2): c, e
                 int N, int m) {
  __shared__ __align__(16) __nv_bfloat16 Tbt[MC * PITCH];
  __shared__ float red[RB][32][4];
  __shared__ float scale[MC];

  const int row0 = blockIdx.x * ROWS;
  const int col0 = blockIdx.y * MC;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rb = warp % RB;
  const int ks = warp / RB;

  if (tid < MC)
    scale[tid] = col0 + tid < m
                     ? rescale_factor(src_max == nullptr ? nullptr
                                                         : src_max + (long long)b * m + col0 + tid)
                     : 0.f;
  __syncthreads();

  const float* srcb = src + (long long)b * N * m;
  const __nv_bfloat16* Sb = S + (long long)b * N * N;
  // This thread's two operator rows (clamped: rows past N are computed, never stored).
  const int r_lo = min(row0 + rb * 16 + g, N - 1);
  const int r_hi = min(row0 + rb * 16 + g + 8, N - 1);
  const __nv_bfloat16* s_lo = Sb + (long long)r_lo * N + 8 * t;
  const __nv_bfloat16* s_hi = Sb + (long long)r_hi * N + 8 * t;
  const __nv_bfloat16* tb_row = Tbt + g * PITCH + 8 * t;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kw0 = 0; kw0 < N; kw0 += KW) {
    const int len = min(KW, N - kw0);
    const int len_pad = (len + CHUNK - 1) / CHUNK * CHUNK;
    __syncthreads();  // every warp is done with the previous window
    // One row of 8 columns per thread and pass: the row's loads are
    // independent (two float4 when m == 8), and neighbouring threads store
    // neighbouring bf16 of each staged column.
#pragma unroll 2
    for (int r = tid; r < len_pad; r += THREADS) {
      float v[MC];
      if (r < len) {
        const float* srow = srcb + (long long)(kw0 + r) * m + col0;
        if (m == MC) {
          const float4 lo = __ldg(reinterpret_cast<const float4*>(srow));
          const float4 hi = __ldg(reinterpret_cast<const float4*>(srow) + 1);
          v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
          v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
        } else {
#pragma unroll
          for (int cc = 0; cc < MC; ++cc) v[cc] = col0 + cc < m ? __ldg(srow + cc) : 0.f;
        }
#pragma unroll
        for (int cc = 0; cc < MC; ++cc) v[cc] *= scale[cc];
      } else {
#pragma unroll
        for (int cc = 0; cc < MC; ++cc) v[cc] = 0.f;
      }
#pragma unroll
      for (int cc = 0; cc < MC; ++cc) Tbt[cc * PITCH + r] = __float2bfloat16_rn(v[cc]);
    }
    __syncthreads();

    const int n_full = len / CHUNK;
    int ci = ks;
    for (; ci + KSPLIT * (UNROLL - 1) < n_full; ci += KSPLIT * UNROLL) {
      uint32_t lo[UNROLL][4], hi[UNROLL][4];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int k = kw0 + (ci + KSPLIT * u) * CHUNK;
        load8<VEC>(s_lo + k, lo[u]);
        load8<VEC>(s_hi + k, hi[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const uint4 tb =
            *reinterpret_cast<const uint4*>(tb_row + (ci + KSPLIT * u) * CHUNK);
        mma_chunk(acc, lo[u], hi[u], tb);
      }
    }
    for (; ci < n_full; ci += KSPLIT) {
      uint32_t lo[4], hi[4];
      const int k = kw0 + ci * CHUNK;
      load8<VEC>(s_lo + k, lo);
      load8<VEC>(s_hi + k, hi);
      mma_chunk(acc, lo, hi, *reinterpret_cast<const uint4*>(tb_row + ci * CHUNK));
    }
    if (len_pad != len && (n_full % KSPLIT) == ks) {  // the ragged last chunk
      uint32_t lo[4], hi[4];
      const int k = kw0 + n_full * CHUNK;
      load8_guarded(s_lo + k, k + 8 * t, kw0 + len, lo);
      load8_guarded(s_hi + k, k + 8 * t, kw0 + len, hi);
      mma_chunk(acc, lo, hi, *reinterpret_cast<const uint4*>(tb_row + n_full * CHUNK));
    }
  }

  // Sum the key-axis halves: warps of ks > 0 hand their partial sums over.
  if (ks > 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[rb][lane][e] = acc[e];
  }
  __syncthreads();
  if (ks > 0) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += red[rb][lane][e];

  const float c = ce[2 * b];
  const float inv_e = 1.0f / ce[2 * b + 1];
  const float one_minus_c = 1.0f - c;
  unsigned int cmax[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = row0 + rb * 16 + g + 8 * (e >> 1);
    const int cc = 2 * t + (e & 1);
    const int col = col0 + cc;
    if (row >= N || col >= m) continue;
    const long long idx = ((long long)b * N + row) * m + col;
    const float sc = scale[cc];
    const float t1 = srcb[(long long)row * m + col] * sc;
    const float a = __fmul_rn(__fsub_rn(__fmul_rn(one_minus_c, t1), acc[e]), inv_e);
    float out = a;
    if (a_in != nullptr) {
      const float t0 = __fmul_rn(a_in[idx], sc);
      out = __fsub_rn(__fmul_rn(2.0f, a), t0);
      a_out[idx] = t1;
    }
    w[idx] = out;
    cmax[e & 1] = max(cmax[e & 1], __float_as_uint(fabsf(out)));
  }
  if (w_max == nullptr) return;
  // Lanes with the same t hold the same two columns: reduce over g.
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    unsigned int u = cmax[j];
    u = max(u, __shfl_xor_sync(0xffffffffu, u, 4));
    u = max(u, __shfl_xor_sync(0xffffffffu, u, 8));
    u = max(u, __shfl_xor_sync(0xffffffffu, u, 16));
    const int col = col0 + 2 * t + j;
    if (g == 0 && col < m) atomicMax(w_max + (long long)b * m + col, u);
  }
}

// out = r * factor(colmax) per (image, column): the last step's rescale.
__global__ void cheb_finalize_kernel(const float* __restrict__ r,
                                     const unsigned int* __restrict__ colmax,
                                     float* __restrict__ out, long long n, int N, int m) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / ((long long)N * m);
    const int col = (int)(i % m);
    out[i] = r[i] * rescale_factor(colmax + b * m + col);
  }
}

template <int VEC>
cudaError_t launch_steps(const __nv_bfloat16* S, const float* X, const float* ce, float* out,
                         float* work, unsigned int* colmax, int B, int N, int m, int degree,
                         cudaStream_t stream) {
  const dim3 grid((N + ROWS - 1) / ROWS, (m + MC - 1) / MC, B);
  const long long blk = (long long)B * N * m;
  float* A = work;
  float* R[2] = {work + blk, work + 2 * blk};
  // Step 1: T_1 = a_shift(X), no rescale.
  cheb_step_kernel<VEC><<<grid, THREADS, 0, stream>>>(
      S, X, nullptr, nullptr, nullptr, degree == 1 ? out : R[0], nullptr, ce, N, m);
  for (int k = 2; k <= degree; ++k) {
    const float* src = R[k % 2];                   // T_{k-1}, unscaled
    const unsigned int* src_max = k == 2 ? nullptr : colmax + (long long)(k - 1) * B * m;
    cheb_step_kernel<VEC><<<grid, THREADS, 0, stream>>>(
        S, src, src_max, k == 2 ? X : A, A, R[(k + 1) % 2], colmax + (long long)k * B * m,
        ce, N, m);
  }
  if (degree >= 2) {
    const int threads = 256;
    const long long blocks = (blk + threads - 1) / threads;
    cheb_finalize_kernel<<<(unsigned int)(blocks < 4096 ? blocks : 4096), threads, 0, stream>>>(
        R[(degree + 1) % 2], colmax + (long long)degree * B * m, out, blk, N, m);
  }
  return cudaGetLastError();
}

}  // namespace

// work: 3 * B * N * m floats; colmax: (degree + 1) * B * m words, zeroed here.
extern "C" int dss_cheb_filter_mma(const void* S, const void* X, const void* ce, void* out,
                               void* work, void* colmax, int B, int N, int m, int degree,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(colmax, 0, sizeof(unsigned int) * (degree + 1) * B * m, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* s = static_cast<const __nv_bfloat16*>(S);
  const auto* x = static_cast<const float*>(X);
  const auto* c = static_cast<const float*>(ce);
  auto* o = static_cast<float*>(out);
  auto* wk = static_cast<float*>(work);
  auto* cm = static_cast<unsigned int*>(colmax);
  if (N % 8 == 0) err = launch_steps<8>(s, x, c, o, wk, cm, B, N, m, degree, st);
  else if (N % 4 == 0) err = launch_steps<4>(s, x, c, o, wk, cm, B, N, m, degree, st);
  else if (N % 2 == 0) err = launch_steps<2>(s, x, c, o, wk, cm, B, N, m, degree, st);
  else err = launch_steps<1>(s, x, c, o, wk, cm, B, N, m, degree, st);
  return static_cast<int>(err);
}
