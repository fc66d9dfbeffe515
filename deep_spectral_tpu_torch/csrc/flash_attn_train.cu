// Differentiable masked flash attention on the CUDA cores (sm_90a), f32 only:
// the forward that also writes the row log-sum-exp, and the two backward
// kernels, as exact f32 FMAs. All three are kept as the yardstick of their
// split-TF32 tensor-core builds (flash_fwd_f32.cu, flash_bwd_dkv_f32.cu,
// flash_bwd_dq_f32.cu, which the wrappers route f32 to):
// `dss_flash_fwd_lse_f32_fma`, `dss_flash_bwd_dkv_f32_fma` and
// `dss_flash_bwd_dq_f32_fma` are called by chip_smoke.py and probe_f32
// only. (The bf16 builds of all three run on tensor cores: flash_fwd.cu's
// WRITE_LSE build, flash_bwd_dkv.cu and flash_bwd_dq.cu.)
//
// Replaces, in deep_spectral_tpu/models/flash_attention.py, for f32:
//   * _flash_kernel          (launched by _flash_forward, save_residuals=True)
//   * _flash_bwd_dkv_kernel  (launched by _flash_backward)
//   * _flash_bwd_dq_kernel   (launched by _flash_backward)
// Same math. Per (batch, head), with s = q k^T * scale and keys whose kv_mask
// is false scoring MASK_VALUE = -0.7 * FLT_MAX:
//   forward: online softmax over key tiles; l from p; o = acc / l
//            (l == 0 -> o = 0); lse = m + log(max(l, 1e-30)).
//   dKV:     per key tile, over q tiles: p = select(valid, exp(s - lse), 0),
//            dv += p^T do, ds = p * (do v^T - di), dk += scale * ds^T q.
//   dQ:      per q tile, over key tiles: dq += scale * ds k.
// p, dp and ds stay f32, as in the Pallas kernels. di = rowsum(o * do) comes
// from the caller. The mask is on keys only: masked query rows still get o,
// lse and dq.
//
// What bounds it on this card: the design. Every product runs as exact f32
// FMAs on the CUDA cores, so the ceiling is the 67 TFLOP/s f32 rate, and each
// thread reads 8 shared-memory words per 16 FMAs, which caps it at about half
// of that; f32-accurate work on the tensor cores (three TF32 products, 165
// TFLOP/s) would be 2.5x that ceiling. At the train shape (b144, T=197, H=6,
// hd=64) the forward is 8.6 GFLOP and the two backward kernels 30 GFLOP
// together.
//
// Design: one CTA of 256 threads per (64-row tile, head, batch); the other
// sequence axis is a loop inside the CTA (the Pallas grid's sequential axis).
// Tiles are staged in shared memory with a pitch of 65 words, so the
// row-wise and column-wise operand reads of all three product shapes are free
// of bank conflicts. Each thread owns a 4x4 block of every 64x64 tile (rows
// ty + 16 i, columns tx + 16 j); the 16 threads that share a row sit in one
// half-warp, so row max and row sum are four xor-shuffles. q, k, v, do and
// the outputs are read and written through (batch, token, head) strides with
// unit stride on hd: the views into the fused (B, T, 3, H, hd) qkv projection
// need no transposes, and dq/dk/dv can be written into one such buffer. The
// ragged T edge is masked in the kernel; nothing is padded.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;        // head dim
constexpr int BT = 64;        // rows per tile (q rows or key rows)
constexpr int LDS = HD + 1;   // shared-memory pitch in floats
constexpr int TILE = BT * LDS;
constexpr int THREADS = 256;  // 16 x 16; each thread owns 4 x 4 of a tile
constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;

struct Strides {
  long long b, t, h;  // element strides of (batch, token, head); hd is unit stride
};

// Stage rows [r0, r0 + BT) of one (b, h) slice; rows past T are zero.
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          Strides s, int b, int h, int r0, int T_) {
  const float* base = src + b * s.b + h * s.h;
  for (int idx = threadIdx.x; idx < BT * HD; idx += THREADS) {
    const int r = idx / HD, c = idx % HD, t = r0 + r;
    dst[r * LDS + c] = t < T_ ? base[t * s.t + c] : 0.f;
  }
}

// Store this thread's 4 x 4 block (rows ty + 16 i, hd columns tx + 16 j) of a
// (BT x HD) result tile, times `mul`, for rows below T.
__device__ __forceinline__ void store_tile(float* __restrict__ dst, Strides s, int b, int h,
                                           int r0, int T_, const float (&c)[4][4],
                                           float mul, int ty, int tx) {
  float* base = dst + b * s.b + h * s.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = r0 + ty + 16 * i;
    if (t >= T_) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) base[t * s.t + tx + 16 * j] = c[i][j] * mul;
  }
}

// c[i][j] += sum_d A[row i][d] * B[row j][d]         (A B^T)
__device__ __forceinline__ void mm_nt(const float* A, const float* B, float (&c)[4][4],
                                      int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LDS + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = B[(tx + 16 * j) * LDS + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], bb[j], c[i][j]);
  }
}

// c[i][j] += sum_r A[r][col i] * B[r][col j]         (A^T B)
__device__ __forceinline__ void mm_tn(const float* A, const float* B, float (&c)[4][4],
                                      int ty, int tx) {
#pragma unroll 8
  for (int r = 0; r < BT; ++r) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[r * LDS + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = B[r * LDS + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], bb[j], c[i][j]);
  }
}

// c[i][j] += sum_r A[row i][r] * B[r][col j]         (A B)
__device__ __forceinline__ void mm_nn(const float* A, const float* B, float (&c)[4][4],
                                      int ty, int tx) {
#pragma unroll 8
  for (int r = 0; r < BT; ++r) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LDS + r];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = B[r * LDS + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], bb[j], c[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&c)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
}

// Reductions over the 16 threads (one half-warp) that share a tile row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void load_key_valid(int* kvalid, const uint8_t* kv_mask, int b,
                                               int k0, int T_) {
  if (threadIdx.x < BT) {
    const int t = k0 + threadIdx.x;
    kvalid[threadIdx.x] =
        t < T_ && (kv_mask == nullptr || kv_mask[(long long)b * T_ + t] != 0);
  }
}

// Row statistics of one q tile: lse and di for rows below T (0 past T).
__device__ __forceinline__ void load_row_stats(float* lse_s, float* di_s, const float* lse,
                                               const float* di, int b, int h, int H,
                                               int q0, int T_) {
  if (threadIdx.x < BT) {
    const int t = q0 + threadIdx.x;
    const long long off = ((long long)b * H + h) * T_ + t;
    lse_s[threadIdx.x] = t < T_ ? lse[off] : 0.f;
    di_s[threadIdx.x] = t < T_ ? di[off] : 0.f;
  }
}

// Kernel 3 (f32): forward of one 64-row q tile, writing o and lse.
__global__ void __launch_bounds__(THREADS)
flash_fwd_lse_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                     float* __restrict__ o, float* __restrict__ lse, int T_, int H,
                     Strides qs, Strides ks, Strides vs, Strides os, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + TILE;
  float* Vs = Ks + TILE;
  float* Ps = Vs + TILE;
  __shared__ int kvalid[BT];

  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_tile(Qs, q, qs, b, h, q0, T_);

  float m_run[4], l_run[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  zero(acc);

  for (int k0 = 0; k0 < T_; k0 += BT) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile(Ks, k, ks, b, h, k0, T_);
    load_tile(Vs, v, vs, b, h, k0, T_);
    load_key_valid(kvalid, kv_mask, b, k0, T_);
    __syncthreads();

    float s[4][4];
    zero(s);
    mm_nt(Qs, Ks, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = MASK_VALUE;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = kvalid[tx + 16 * j] ? s[i][j] * scale : MASK_VALUE;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], row_max(mx));
      const float alpha = expf(m_run[i] - m_new);  // 0 on the first tile
      m_run[i] = m_new;
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float p = kvalid[col] ? expf(s[i][j] - m_new) : 0.f;
        rsum += p;
        Ps[(ty + 16 * i) * LDS + col] = p;  // p.astype(v.dtype) is p in f32
        acc[i][j] *= alpha;
      }
      l_run[i] = alpha * l_run[i] + row_sum(rsum);
    }
    __syncthreads();
    mm_nn(Ps, Vs, acc, ty, tx);
  }

  float* obase = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T_) continue;
    const float inv = l_run[i] == 0.f ? 1.f : 1.f / l_run[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) obase[t * os.t + tx + 16 * j] = acc[i][j] * inv;
    if (tx == 0)
      lse[((long long)b * H + h) * T_ + t] = m_run[i] + logf(fmaxf(l_run[i], 1e-30f));
  }
}

// p and ds of one (q tile, key tile) pair for this thread's 4 x 4 block.
__device__ __forceinline__ void probs_and_ds(const float* Qs, const float* Ks,
                                             const float* dOs, const float* Vs,
                                             const int* kvalid, const float* lse_s,
                                             const float* di_s, int q0, int T_, float scale,
                                             float (&p)[4][4], float (&ds)[4][4], int ty,
                                             int tx) {
  float dp[4][4];
  zero(p);
  zero(dp);
  mm_nt(Qs, Ks, p, ty, tx);
  mm_nt(dOs, Vs, dp, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const bool row_ok = q0 + r < T_;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // A select, not a product with the mask: exp(s - lse) may be inf here.
      p[i][j] = (row_ok && kvalid[tx + 16 * j]) ? expf(p[i][j] * scale - lse_s[r]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - di_s[r]);
    }
  }
}

// Kernel 4 (f32): dk and dv of one 64-row key tile, accumulated over all q tiles.
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ di, float* __restrict__ dk,
                     float* __restrict__ dv,
                     int T_, int H, Strides qs, Strides ks, Strides vs, Strides dos,
                     Strides dks, Strides dvs, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE;
  float* Qs = Vs + TILE;
  float* dOs = Qs + TILE;
  float* Ps = dOs + TILE;
  float* dSs = Ps + TILE;
  __shared__ int kvalid[BT];
  __shared__ float lse_s[BT], di_s[BT];

  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_tile(Ks, k, ks, b, h, k0, T_);
  load_tile(Vs, v, vs, b, h, k0, T_);
  load_key_valid(kvalid, kv_mask, b, k0, T_);

  float dk_acc[4][4], dv_acc[4][4];  // rows: keys, columns: hd
  zero(dk_acc);
  zero(dv_acc);
  for (int q0 = 0; q0 < T_; q0 += BT) {
    __syncthreads();  // the previous q tile's Q, dO, P and dS are consumed
    load_tile(Qs, q, qs, b, h, q0, T_);
    load_tile(dOs, dout, dos, b, h, q0, T_);
    load_row_stats(lse_s, di_s, lse, di, b, h, H, q0, T_);
    __syncthreads();

    // (q rows, key columns) here; the products below read them transposed.
    float p[4][4], ds[4][4];
    probs_and_ds(Qs, Ks, dOs, Vs, kvalid, lse_s, di_s, q0, T_, scale, p, ds, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(ty + 16 * i) * LDS + tx + 16 * j] = p[i][j];
        dSs[(ty + 16 * i) * LDS + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    mm_tn(Ps, dOs, dv_acc, ty, tx);
    mm_tn(dSs, Qs, dk_acc, ty, tx);
  }
  store_tile(dk, dks, b, h, k0, T_, dk_acc, scale, ty, tx);
  store_tile(dv, dvs, b, h, k0, T_, dv_acc, 1.f, ty, tx);
}

// Kernel 5 (f32): dq of one 64-row q tile, accumulated over all key tiles.
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const uint8_t* __restrict__ kv_mask,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq, int T_, int H,
                    Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
                    float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + TILE;
  float* Ks = dOs + TILE;
  float* Vs = Ks + TILE;
  float* dSs = Vs + TILE;
  __shared__ int kvalid[BT];
  __shared__ float lse_s[BT], di_s[BT];

  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  load_tile(Qs, q, qs, b, h, q0, T_);
  load_tile(dOs, dout, dos, b, h, q0, T_);
  load_row_stats(lse_s, di_s, lse, di, b, h, H, q0, T_);

  float dq_acc[4][4];  // rows: q, columns: hd
  zero(dq_acc);
  for (int k0 = 0; k0 < T_; k0 += BT) {
    __syncthreads();  // the previous key tile's K, V and dS are consumed
    load_tile(Ks, k, ks, b, h, k0, T_);
    load_tile(Vs, v, vs, b, h, k0, T_);
    load_key_valid(kvalid, kv_mask, b, k0, T_);
    __syncthreads();

    float p[4][4], ds[4][4];
    probs_and_ds(Qs, Ks, dOs, Vs, kvalid, lse_s, di_s, q0, T_, scale, p, ds, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(ty + 16 * i) * LDS + tx + 16 * j] = ds[i][j];
    __syncthreads();
    mm_nn(dSs, Ks, dq_acc, ty, tx);
  }
  store_tile(dq, dqs, b, h, q0, T_, dq_acc, scale, ty, tx);
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

template <typename Kernel>
int launch_config(Kernel kernel, int smem_bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
}

}  // namespace

// Entry points. `strides` is a host array of (batch, token, head) element
// strides, three per tensor, in argument order; lse and di are contiguous
// (B, H, T) f32.
extern "C" int dss_flash_fwd_lse_f32_fma(const void* q, const void* k, const void* v,
                                         const void* kv_mask, void* o, void* lse, int B,
                                         int T, int H, const long long* strides, float scale,
                                         void* stream) {
  const int smem = 4 * TILE * sizeof(float);
  if (int err = launch_config(flash_fwd_lse_kernel, smem)) return err;
  const dim3 grid((T + BT - 1) / BT, H, B);
  const long long* s = strides;
  flash_fwd_lse_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(kv_mask), static_cast<float*>(o), static_cast<float*>(lse),
      T, H, strides_at(s, 0), strides_at(s, 1), strides_at(s, 2), strides_at(s, 3), scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dss_flash_bwd_dkv_f32_fma(const void* q, const void* k, const void* v,
                                         const void* kv_mask, const void* dout, const void* lse,
                                         const void* di, void* dk, void* dv, int B, int T,
                                         int H, const long long* strides, float scale,
                                         void* stream) {
  const int smem = 6 * TILE * sizeof(float);
  if (int err = launch_config(flash_bwd_dkv_kernel, smem)) return err;
  const dim3 grid((T + BT - 1) / BT, H, B);
  const long long* s = strides;
  flash_bwd_dkv_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(kv_mask), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<float*>(dk),
      static_cast<float*>(dv), T, H, strides_at(s, 0), strides_at(s, 1), strides_at(s, 2),
      strides_at(s, 3), strides_at(s, 4), strides_at(s, 5), scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dss_flash_bwd_dq_f32_fma(const void* q, const void* k, const void* v,
                                        const void* kv_mask, const void* dout,
                                        const void* lse, const void* di, void* dq, int B,
                                        int T, int H, const long long* strides, float scale,
                                        void* stream) {
  const int smem = 5 * TILE * sizeof(float);
  if (int err = launch_config(flash_bwd_dq_kernel, smem)) return err;
  const dim3 grid((T + BT - 1) / BT, H, B);
  const long long* s = strides;
  flash_bwd_dq_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(kv_mask), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di), static_cast<float*>(dq),
      T, H, strides_at(s, 0), strides_at(s, 1), strides_at(s, 2), strides_at(s, 3),
      strides_at(s, 4), scale);
  return static_cast<int>(cudaGetLastError());
}
