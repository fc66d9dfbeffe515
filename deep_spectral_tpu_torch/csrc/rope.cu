// 2D axial rotary position embedding (RoPE) of DINOv3's ViTs, in place on
// the q and k of a packed (B, T, 3, H, 128) qkv projection.
//
// Replaces no TPU kernel: the JAX package has no DINOv3. Added because the
// plain rotation (f32 casts, chunk, negate, concatenate, two products, a sum
// and a cast back, on each block's q and k) moves about eight passes over q
// and k a block, where one read and one write of each are needed.
//
// Semantics (DINOv3's `rope_apply` with "separate" coordinates, the twin in
// models/rope.py): a patch row n of image b, whose grid is h x w and whose
// rows lie `stride` apart in the layout, is patch (i, j) = (n / stride,
// n % stride), rotated only when i < h and j < w; the prefix rows (CLS and
// the storage tokens) and the rows of padding are left as they are. Its 64
// angles are a_f = 2 pi c_y / p_f and a_{32+f} = 2 pi c_x / p_f (f < 32),
// c_y = 2 (i + 0.5) / h - 1 and c_x = 2 (j + 0.5) / w - 1, p the model's
// periods; element d of a head (and d + 64) takes angle a_d, and
// z <- z cos + rot(z) sin with rot(z) = [-z[64:], z[:64]], each product and
// sum rounded once in f32 (no FMA), cast back to the tensor's type.
//
// What bounds it on this card: bytes. A patch row's q and k are 2 H 128
// values read and written once (16 KB each way in bf16 at H = 32), against 64
// sines and cosines a row. Design: one CTA of 256 threads a ROWS rows of one
// image; its threads first compute the rows' angles and their cosines and
// sines in f32 (one value a thread, accurate sinf/cosf, as torch's) into
// shared memory, so no (B, T, 128) table exists anywhere, then rotate 8
// pairs (d, d + 64) a unit: two 16-byte loads and two stores (bf16), the
// units of neighbouring threads on neighbouring 16-byte chunks of a head.
//
// Requirements the Python wrapper checks: a contiguous (B, T, 3, H, 128)
// bf16 or f32 tensor, grids (B, 3) int32 (h, w, stride; stride >= 1) and
// periods (32,) f32 on its device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RD = 128;        // head dim
constexpr int HALF = RD / 2;   // angles a row
constexpr int ROWS = 4;        // patch rows a CTA
constexpr int THREADS = ROWS * HALF;
constexpr float TWO_PI = 6.283185307179586f;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&x)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rope_rotate_kernel(T* __restrict__ qkv, const int* __restrict__ grids,
                   const float* __restrict__ periods, int n_rows, int prefix, int H) {
  __shared__ float cs[ROWS][HALF];
  __shared__ float sn[ROWS][HALF];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * ROWS;
  const int gh = grids[3 * b], gw = grids[3 * b + 1], stride = grids[3 * b + 2];
  if (gh == 0 || gw == 0 || n0 >= (gh - 1) * stride + gw) return;  // no patch of the image here
  {
    const int r = threadIdx.x / HALF, f = threadIdx.x % HALF;
    const int n = n0 + r, i = n / stride, j = n - (n / stride) * stride;
    float c = 1.f, s = 0.f;
    if (n < n_rows && i < gh && j < gw) {
      const bool y = f < HALF / 2;
      const float coord = __fsub_rn(
          __fmul_rn(2.f, __fdiv_rn(__fadd_rn(static_cast<float>(y ? i : j), 0.5f),
                                   static_cast<float>(y ? gh : gw))), 1.f);
      const float a = __fdiv_rn(__fmul_rn(TWO_PI, coord), periods[f % (HALF / 2)]);
      c = cosf(a);
      s = sinf(a);
    }
    cs[r][f] = c;
    sn[r][f] = s;
  }
  __syncthreads();
  const int per_row = 2 * H * (HALF / 8);  // (q and k heads) x 8-value units of the first half
  const long long row_len = 3LL * H * RD;
  T* base = qkv + ((long long)b * (prefix + n_rows) + prefix + n0) * row_len;
  for (int u = threadIdx.x; u < ROWS * per_row; u += THREADS) {
    const int r = u / per_row, n = n0 + r;
    if (n >= n_rows) break;
    const int i = n / stride, j = n - i * stride;
    if (i >= gh || j >= gw) continue;
    const int rem = u - r * per_row;
    const int d0 = 8 * (rem % (HALF / 8));
    T* p = base + r * row_len + (long long)(rem / (HALF / 8)) * RD + d0;  // q heads, then k heads
    float x0[8], x1[8], y0[8], y1[8];
    load8(p, x0);
    load8(p + HALF, x1);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float c = cs[r][d0 + e], s = sn[r][d0 + e];
      y0[e] = __fadd_rn(__fmul_rn(x0[e], c), __fmul_rn(-x1[e], s));
      y1[e] = __fadd_rn(__fmul_rn(x1[e], c), __fmul_rn(x0[e], s));
    }
    store8(p, y0);
    store8(p + HALF, y1);
  }
}

}  // namespace

// qkv: contiguous (B, T, 3, H, 128), bf16 (f32 = 0) or f32 (f32 = 1); grids
// (B, 3) int32; periods (32,) f32; the T - prefix rows after the prefix.
extern "C" int dss_rope_rotate(void* qkv, int f32, const void* grids, const void* periods,
                               int B, int T, int prefix, int H, void* stream) {
  const int n_rows = T - prefix;
  if (B == 0 || n_rows <= 0) return 0;
  const dim3 grid((n_rows + ROWS - 1) / ROWS, B);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto g = static_cast<const int*>(grids);
  const auto p = static_cast<const float*>(periods);
  if (f32)
    rope_rotate_kernel<float><<<grid, THREADS, 0, st>>>(static_cast<float*>(qkv), g, p, n_rows,
                                                        prefix, H);
  else
    rope_rotate_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<__nv_bfloat16*>(qkv), g, p, n_rows, prefix, H);
  return static_cast<int>(cudaGetLastError());
}
