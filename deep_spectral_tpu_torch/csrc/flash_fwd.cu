// Masked flash-attention forward for Hopper (sm_90a), packed (B, T, H, hd) layout.
//
// Replaces: deep_spectral_tpu/models/flash_attention.py::_flash_kernel_packed
// (launched by _flash_forward_packed). Same math: non-causal
// softmax(q k^T / sqrt(hd)) v per (batch, head); keys whose kv_mask is false
// score MASK_VALUE = -0.7 * FLT_MAX and get p = 0; online-softmax statistics in
// f32; p is rounded to bf16 before the P.V product; a row whose keys are all
// masked outputs 0 (l == 0 -> 1/l taken as 1).
//
// What bounds it on this card: at the main path's shape (B=24, T=901, H=6,
// hd=64) the kernel does 4*T^2*hd flops per (b, h), about 30 GFLOP per ViT
// block, against ~66 MB of q/k/v/out traffic, so it is compute bound: the
// ceiling is the bf16 tensor-core rate, and the softmax exps on the SFU come
// second.
//
// What the design does about it: both products run on the tensor cores with
// mma.sync m16n8k16 (bf16 in, f32 accumulate). One CTA of 4 warps owns a
// 64-row q tile of one (b, h) and keeps it in registers as A fragments; it
// walks the key axis in 64-row K/V tiles staged in shared memory (V stored
// transposed so its B fragments are single 32-bit loads). Scores never leave
// registers: the S accumulator fragment is re-packed in place as the A
// fragment of the P.V product. The ragged T edge is masked in the kernel, so
// no caller pads. The grid is (ceil(T/64), H, B) = 2160 CTAs on the main path.
// Not done yet (later work): wgmma, TMA loads, double-buffered K/V tiles.
//
// q/k/v are read through strides, so they can be views into the fused qkv
// projection output (B, T, 3, H, hd) without a copy. Requirements the Python
// wrapper checks: bf16, hd == 64, unit stride on hd, other strides multiples
// of 8 elements, 16-byte aligned base pointers. out is contiguous (B, T, H, 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;        // head dim
constexpr int BQ = 64;        // q rows per CTA (16 per warp)
constexpr int BK = 64;        // key rows per K/V tile
constexpr int LD = HD + 8;    // smem row pitch (bf16) for Q/K: conflict-free fragment loads
constexpr int LDV = BK + 8;   // smem row pitch (bf16) for transposed V
constexpr int THREADS = 128;
constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_packed_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const uint8_t* __restrict__ kv_mask,  // (B, T) or null
                        __nv_bfloat16* __restrict__ out,      // (B, T, H, HD)
                        int T, int H,
                        long long qsb, long long qst, long long qsh,
                        long long ksb, long long kst, long long ksh,
                        long long vsb, long long vst, long long vsh,
                        float sm_scale) {
  __shared__ __align__(16) __nv_bfloat16 Qs[BQ * LD];
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vt[HD * LDV];
  __shared__ int kvalid[BK];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;    // fragment row group
  const int tig = lane & 3;   // thread in group

  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;

  // Stage the q tile (rows past T are zero; they are never stored).
  for (int c = tid; c < BQ * HD / 8; c += THREADS) {
    const int r = c >> 3, col = (c & 7) * 8;
    const int t = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) val = *reinterpret_cast<const uint4*>(qb + t * qst + col);
    *reinterpret_cast<uint4*>(&Qs[r * LD + col]) = val;
  }
  __syncthreads();

  // This warp's 16 q rows as A fragments, 4 k-steps of 16 over hd.
  const int wr = warp * 16 + g;
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    qf[kk][0] = ld_u32(&Qs[wr * LD + kk * 16 + tig * 2]);
    qf[kk][1] = ld_u32(&Qs[(wr + 8) * LD + kk * 16 + tig * 2]);
    qf[kk][2] = ld_u32(&Qs[wr * LD + kk * 16 + 8 + tig * 2]);
    qf[kk][3] = ld_u32(&Qs[(wr + 8) * LD + kk * 16 + 8 + tig * 2]);
  }

  // Rows wr (index 0) and wr + 8 (index 1) of the tile.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const int n_kv = (T + BK - 1) / BK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int c = tid; c < BK * HD / 8; c += THREADS) {
      const int r = c >> 3, col = (c & 7) * 8;
      const int t = k0 + r;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (t < T) {
        kv4 = *reinterpret_cast<const uint4*>(kb + t * kst + col);
        vv4 = *reinterpret_cast<const uint4*>(vb + t * vst + col);
      }
      *reinterpret_cast<uint4*>(&Ks[r * LD + col]) = kv4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(col + i) * LDV + r] = ve[i];
    }
    if (tid < BK) {
      const int t = k0 + tid;
      kvalid[tid] = (t < T) && (kv_mask == nullptr || kv_mask[(long long)b * T + t] != 0);
    }
    __syncthreads();

    // S = q k^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys).
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const __nv_bfloat16* krow = &Ks[(nt * 8 + g) * LD + tig * 2];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_bf16_16816(s[nt], qf[kk], ld_u32(krow + kk * 16), ld_u32(krow + kk * 16 + 8));
    }

    // Scale, mask, running max over the 4 threads that share a row.
    float mx[2] = {MASK_VALUE, MASK_VALUE};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + tig * 2 + (e & 1);
        const float val = kvalid[col] ? s[nt][e] * sm_scale : MASK_VALUE;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = __expf(m_run[r] - m_new);  // exp(-inf) = 0 on the first tile
      m_run[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + tig * 2 + (e & 1);
        const float p = kvalid[col] ? __expf(s[nt][e] - m_run[e >> 1]) : 0.f;
        s[nt][e] = p;
        rsum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l_run[r] = alpha[r] * l_run[r] + rsum[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];

    // acc += bf16(P) V: the S fragments of n-tiles (2j, 2j+1) are the A
    // fragment of k-step j.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16x2(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16x2(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16x2(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* vrow = &Vt[(nt * 8 + g) * LDV + j * 16 + tig * 2];
        mma_bf16_16816(acc[nt], pa, ld_u32(vrow), ld_u32(vrow + 8));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + wr + 8 * r;
    if (t >= T) continue;
    const float inv = l_run[r] == 0.f ? 1.f : 1.f / l_run[r];
    __nv_bfloat16* orow = out + (((long long)b * T + t) * H + h) * HD;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + tig * 2;
      *reinterpret_cast<__nv_bfloat162*>(orow + col) =
          __floats2bfloat162_rn(acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
    }
  }
}

}  // namespace

extern "C" int dss_flash_fwd_packed(const void* q, const void* k, const void* v,
                                    const void* kv_mask, void* out,
                                    int B, int T, int H,
                                    long long qsb, long long qst, long long qsh,
                                    long long ksb, long long kst, long long ksh,
                                    long long vsb, long long vst, long long vsh,
                                    float sm_scale, void* stream) {
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_packed_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(kv_mask),
      static_cast<__nv_bfloat16*>(out), T, H, qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}
