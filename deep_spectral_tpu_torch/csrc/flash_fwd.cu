// Masked flash-attention forward for Hopper (sm_90a), packed (B, T, H, hd) layout.
//
// Replaces, in deep_spectral_tpu/models/flash_attention.py:
//   * _flash_kernel_packed (launched by _flash_forward_packed): the
//     WRITE_LSE = false instantiation, the inference forward;
//   * _flash_kernel (launched by _flash_forward, save_residuals=True) for bf16:
//     the WRITE_LSE = true instantiation, the forward of every attention whose
//     q/k/v need a gradient, which also writes the row log-sum-exp
//     lse = m + log(max(l, 1e-30)) as (B, H, T) f32. In-kernel m is the max
//     of the scaled scores in log2 units and l the sum of exp2(s - m), so the
//     epilogue writes (m + log2(max(l, 1e-30))) ln 2. A row with no valid key
//     keeps m = MASK_VALUE (log2 units): its lse need not equal the Pallas
//     kernel's, since the backward selects p = 0 on masked keys either way.
//     (The f32 build of _flash_kernel is flash_fwd_f32.cu.)
// Same math in both: non-causal
// softmax(q k^T / sqrt(hd)) v per (batch, head); keys whose kv_mask is false
// score MASK_VALUE = -0.7 * FLT_MAX and get p = 0 by a select; online-softmax
// statistics in f32; p is rounded to bf16 at the running max before the P.V
// product; a row whose keys are all masked outputs 0 (l == 0 -> 1/l taken as 1).
//
// What bounds it on this card: at the main path's shape (B=24, T=901, H=6,
// hd=64) the two products are 4 T^2 hd flops per (b, h), 2.99e10 in all, 30 us
// at the bf16 tensor-core peak, against 66 MB of q/k/v/out traffic (20 us at
// 3.35 TB/s): compute bound. At hd=64 the exponentials (T^2 per (b, h), 117 M)
// cost the SFUs about as long as the products cost the tensor cores. At the
// train shape (B=144, T=197) both builds are bytes bound: 88 MB of q/k/v/out
// (and lse) traffic, 26 us, against 8.6 GFLOP (9 us).
//
// What the design does about it: one CTA per (128-row q tile, head, batch),
// 8 x 6 x 24 = 1152 CTAs on the main path, of three warpgroups. Warpgroup 2
// is the producer: one thread issues TMA loads (q once; K and V tiles of 128
// keys through a 3-stage shared-memory ring, completion on mbarriers) from
// 4-d tensor maps over the strided (hd, H, T, B) views, so the fused qkv
// projection is read in place; rows past T are zero-filled by the TMA unit,
// so the ragged edge needs no branch in the load. Its lane 0 also packs the
// tile's key validity (T edge and kv_mask) into 128 bits beside the tile.
// Warpgroups 0 and 1 (64 q rows each, registers raised with setmaxnreg) run
// S = Q K^T as wgmma m64n128k16 from 128B-swizzled shared memory (4 k-steps
// over hd), the masked online softmax on the accumulator fragments with exp2f
// (sm_scale log2(e) folded into one FFMA; tiles with no invalid key skip the
// mask), and O += bf16(P) V as wgmma m64n64k16 with P from registers (the S
// fragments re-packed in place) and V as the transposed (MN-major) B operand,
// so V is never transposed by hand. Two overlaps keep the tensor cores fed
// while the SFUs run the exponentials: each warpgroup issues S(j) together
// with P(j-1) V(j-1) and runs tile j's softmax while the latter runs, and the
// two warpgroups take turns issuing (named barriers), so one's softmax runs
// against the other's products.
//
// Head dim 128 (DINOv3's 32 heads of 128; the inference build only): the
// same kernel with each q, K and V tile held as two 64-column boxes of 128
// bytes a row (two TMA loads from a map over the 128 columns, each its own
// 128B-swizzled 16 KB block), S = Q K^T in 8 k-steps (4 in each block) and O
// += P V as two m64n64k16 products a 16-key step, one a 64-column half of V,
// into 64 accumulators a thread. 32 KB tiles: q and the 3-stage K/V ring take
// 224 KB of shared memory. At DINOv3-7B's stage-1 shape (b24, T = 885-1605,
// 32 heads) the products are 4 T^2 hd flops per (b, h): compute bound, and
// at hd = 128 the exponentials cost half as much per product as at 64.
//
// Requirements the Python wrapper checks: bf16, hd == 64 (hd == 128 without
// the lse), unit stride on hd, other strides multiples of 8 elements (16
// bytes, as TMA needs), 16-byte aligned base pointers. out is contiguous
// (B, T, H, hd).

#include <math.h>
#include <stdint.h>

#include "errors.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 128;                   // q rows per CTA (64 per consumer warpgroup)
constexpr int BK = 128;                   // keys per K/V tile
constexpr int STAGES = 3;                 // K/V ring depth
constexpr int CONSUMERS = 2;              // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int SUB_BYTES = BK * 128;       // 16 KB: 128 rows of one 64-column box

// A q, K or V tile of head dim HDIM: HALVES boxes of 64 columns, SUB_BYTES
// apart, and the kernel's shared memory.
template <int HDIM>
struct Tile {
  static constexpr int HALVES = HDIM / 64;
  static constexpr int BYTES = SUB_BYTES * HALVES;  // 16 KB at hd 64, 32 KB at 128
  static constexpr int SMEM = 1024 /* alignment slack */ + BYTES * (1 + 2 * STAGES) +
                              16 * STAGES + 8 * (2 * STAGES + 1);
};

// The consumer warpgroups take turns issuing their products (named barriers
// 1 and 2, 256 threads: one warpgroup syncs, the other arrives), so one's
// softmax runs while the other's wgmmas hold the tensor cores.
__device__ __forceinline__ void sched_sync(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void sched_arrive(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(1 + wg) : "memory");
}

// S = Q K^T, 64 x 128 per warpgroup: k-steps of 16 over hd are 32 bytes
// along the swizzled rows (2 descriptor units); at hd = 128 the last four
// read the second 64-column box, SUB_BYTES on.
template <int HDIM>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < HDIM / 16; ++kk) {
    const int off = (kk >> 2) * (SUB_BYTES >> 4) + 2 * (kk & 3);
    wgmma_m64n128k16_ss(s, dq + off, dk + off, kk);
  }
  wgmma_commit();
}

// O += P V: V's tile is [key][hd], hd contiguous, i.e. the MN-major B operand;
// a k-step of 16 keys is 16 rows of 128 bytes (128 descriptor units). At
// hd = 128 each k-step is two products, one a 64-column box of V.
template <int HDIM>
__device__ __forceinline__ void issue_pv(float (&o)[HDIM / 2], const uint32_t (&pa)[8][4],
                                         uint64_t dv) {
  if constexpr (HDIM == 64) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_m64n64k16_rs(o, pa[kk], dv + 128 * kk);
  } else {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      wgmma_m64n64k16_rs_at<0>(o, pa[kk], dv + 128 * kk);
      wgmma_m64n64k16_rs_at<32>(o, pa[kk], dv + (SUB_BYTES >> 4) + 128 * kk);
    }
  }
  wgmma_commit();
}

// bf16(P) as the register A operand: keys 16kk..16kk+15 are the S fragments
// of 8-key blocks 2kk and 2kk + 1.
__device__ __forceinline__ void pack_p(const float (&p)[64], uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16x2(p[8 * kk + 0], p[8 * kk + 1]);
    pa[kk][1] = pack_bf16x2(p[8 * kk + 2], p[8 * kk + 3]);
    pa[kk][2] = pack_bf16x2(p[8 * kk + 4], p[8 * kk + 5]);
    pa[kk][3] = pack_bf16x2(p[8 * kk + 6], p[8 * kk + 7]);
  }
}

// One tile's online softmax in place: s[4j + e] (row g + 8 (e >> 1), key
// 8j + 2t + (e & 1)) goes from q.k to p = exp2(q.k scale_log2 - m); m_run and
// l_run (this thread's share of the row sums) advance; alpha is o's factor.
// MASKED tiles score invalid keys MASK_VALUE and select p = 0 for them.
template <bool MASKED>
__device__ __forceinline__ void softmax_step(float (&s)[64], const uint32_t (&vw)[4], int t,
                                             float scale_log2, float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2]) {
  auto valid = [&](int j, int e) {
    return ((vw[j >> 2] >> (8 * (j & 3) + 2 * t + (e & 1))) & 1u) != 0u;
  };
  float mx[2] = {MASKED ? MASK_VALUE : -INFINITY, MASKED ? MASK_VALUE : -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASKED) {
        mx[e >> 1] = fmaxf(mx[e >> 1], valid(j, e) ? s[4 * j + e] * scale_log2 : MASK_VALUE);
      } else {
        mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
      }
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    if (!MASKED) mx[r] *= scale_log2;  // scale_log2 > 0: the max of the scaled scores
    const float m_new = fmaxf(m_run[r], mx[r]);
    alpha[r] = ex2(m_run[r] - m_new);  // 0 on the first tile (m_run = -inf)
    m_run[r] = m_new;
  }
  float rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(s[4 * j + e], scale_log2, -m_run[e >> 1]));
      if (MASKED) p = valid(j, e) ? p : 0.f;
      s[4 * j + e] = p;
      rsum[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + rsum[r];
}

__device__ __forceinline__ void softmax_tile(float (&s)[64], const uint4& vb, int t,
                                             float scale_log2, float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2]) {
  const uint32_t vw[4] = {vb.x, vb.y, vb.z, vb.w};
  if ((vb.x & vb.y & vb.z & vb.w) == 0xffffffffu)  // the same for the whole CTA
    softmax_step<false>(s, vw, t, scale_log2, m_run, l_run, alpha);
  else
    softmax_step<true>(s, vw, t, scale_log2, m_run, l_run, alpha);
}

// lse is last among the parameters so that the WRITE_LSE = false
// instantiation's code is the same as without it.
template <bool WRITE_LSE, int HDIM>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_packed_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const uint8_t* __restrict__ kv_mask,  // (B, T) or null
                        __nv_bfloat16* __restrict__ out,      // (B, T, H, HDIM)
                        int T, int H, float scale_log2,
                        float* __restrict__ lse) {            // (B, H, T), WRITE_LSE only
  constexpr int TILE_BYTES = Tile<HDIM>::BYTES;
  constexpr int HALVES = Tile<HDIM>::HALVES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);  // 1024-aligned for the swizzle
  const uint32_t q_s = smem_u32(smem);
  const uint32_t k_s = q_s + TILE_BYTES;
  const uint32_t v_s = k_s + STAGES * TILE_BYTES;
  uint4* kvalid = reinterpret_cast<uint4*>(smem + TILE_BYTES * (1 + 2 * STAGES));
  const uint32_t bars = smem_u32(kvalid + STAGES);  // full[STAGES], empty[STAGES], q
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t qbar = bars + 16 * STAGES;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int n_kv = (T + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS * 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == CONSUMERS * 4) {
      if (lane == 0) {
        mbar_arrive_expect_tx(qbar, TILE_BYTES);
        if constexpr (HALVES == 1) {
          tma_load(q_s, &tq, qbar, h, q0, b);
        } else {
          for (int c = 0; c < HALVES; ++c)
            tma_load_at(q_s + c * SUB_BYTES, &tq, qbar, 64 * c, h, q0, b);
        }
      }
      for (int kt = 0; kt < n_kv; ++kt) {
        const int st = kt % STAGES;
        mbar_wait(empty(st), ((kt / STAGES) & 1) ^ 1);
        uint32_t words[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int key = kt * BK + 32 * w + lane;
          const bool ok = key < T && (kv_mask == nullptr || kv_mask[(long long)b * T + key] != 0);
          words[w] = __ballot_sync(0xffffffffu, ok);
        }
        if (lane == 0) {
          kvalid[st] = make_uint4(words[0], words[1], words[2], words[3]);
          mbar_arrive_expect_tx(full(st), 2 * TILE_BYTES);
          if constexpr (HALVES == 1) {
            tma_load(k_s + st * TILE_BYTES, &tk, full(st), h, kt * BK, b);
            tma_load(v_s + st * TILE_BYTES, &tv, full(st), h, kt * BK, b);
          } else {
            for (int c = 0; c < HALVES; ++c) {
              tma_load_at(k_s + st * TILE_BYTES + c * SUB_BYTES, &tk, full(st), 64 * c, h,
                          kt * BK, b);
              tma_load_at(v_s + st * TILE_BYTES + c * SUB_BYTES, &tv, full(st), 64 * c, h,
                          kt * BK, b);
            }
          }
        }
      }
    }
  } else {
    // --------------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int g = lane >> 2;  // fragment row within the warp's 16
    const int t = lane & 3;   // thread in the row's quad
    float o[HDIM / 2];
#pragma unroll
    for (int i = 0; i < HDIM / 2; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
    float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

    mbar_wait(qbar, 0);
    if (wg == 1) sched_arrive(0);  // warpgroup 0 issues first
    const uint64_t dq = smem_desc(q_s + wg * (SUB_BYTES / 2));
    float s[64];
    uint32_t pa[8][4];

    // Tile 0: S only. Every later round issues S(kt) and P(kt-1) V(kt-1)
    // together and runs tile kt's softmax while the P.V product runs.
    mbar_wait(full(0), 0);
    sched_sync(wg);
    wgmma_fence();
    issue_qk<HDIM>(s, dq, smem_desc(k_s));
    sched_arrive(1 - wg);
    wgmma_wait<0>();
    float alpha[2];
    softmax_tile(s, kvalid[0], t, scale_log2, m_run, l_run, alpha);
    pack_p(s, pa);

    for (int kt = 1; kt < n_kv; ++kt) {
      const int st = kt % STAGES;
      const int prev = (kt - 1) % STAGES;
      mbar_wait(full(st), (kt / STAGES) & 1);
      sched_sync(wg);
      wgmma_fence();
      issue_qk<HDIM>(s, dq, smem_desc(k_s + st * TILE_BYTES));
      issue_pv<HDIM>(o, pa, smem_desc(v_s + prev * TILE_BYTES));
      sched_arrive(1 - wg);
      wgmma_wait<1>();  // S(kt) is in; P(kt-1) V(kt-1) may still run
      softmax_tile(s, kvalid[st], t, scale_log2, m_run, l_run, alpha);
      wgmma_wait<0>();
      mbar_arrive(empty(prev));
#pragma unroll
      for (int i = 0; i < HDIM / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p(s, pa);
    }

    const int last = (n_kv - 1) % STAGES;
    sched_sync(wg);
    wgmma_fence();
    issue_pv<HDIM>(o, pa, smem_desc(v_s + last * TILE_BYTES));
    if (wg == 0) sched_arrive(1);  // warpgroup 1's last turn: nothing follows it
    wgmma_wait<0>();
    mbar_arrive(empty(last));

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = l == 0.f ? 1.f : 1.f / l;
      const int row = q0 + wg * 64 + (warp & 3) * 16 + g + 8 * r;
      if (row >= T) continue;
      if constexpr (WRITE_LSE) {
        if (t == 0) lse[((long long)b * H + h) * T + row] = (m_run[r] + log2f(fmaxf(l, 1e-30f))) * LN2;
      }
      __nv_bfloat16* orow = out + (((long long)b * T + row) * H + h) * HDIM;
#pragma unroll
      for (int j = 0; j < HDIM / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <bool WRITE_LSE, int HDIM>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const void* kv_mask, void* out, void* lse, int B, int T, int H, float sm_scale,
           void* stream) {
  auto kernel = flash_fwd_packed_kernel<WRITE_LSE, HDIM>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<HDIM>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, Tile<HDIM>::SMEM, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<const uint8_t*>(kv_mask), static_cast<__nv_bfloat16*>(out), T, H,
      sm_scale * LOG2E, static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lse null: the inference forward (kernel 1), at hd 64 or 128; else also the
// (B, H, T) f32 row log-sum-exp (kernel 3's bf16 route), at hd 64.
extern "C" int dss_flash_fwd_packed(const void* q, const void* k, const void* v,
                                    const void* kv_mask, void* out, void* lse,
                                    int B, int T, int H, int hd,
                                    long long qsb, long long qst, long long qsh,
                                    long long ksb, long long kst, long long ksh,
                                    long long vsb, long long vst, long long vsh,
                                    float sm_scale, void* stream) {
  if (hd != HD && !(hd == 2 * HD && lse == nullptr)) return DSS_ERR_HEAD_DIM;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, T, H, qsb, qst, qsh, BQ, hd) ||
      !make_map(&tk, k, B, T, H, ksb, kst, ksh, BK, hd) ||
      !make_map(&tv, v, B, T, H, vsb, vst, vsh, BK, hd))
    return DSS_ERR_TENSOR_MAP;
  if (hd == 2 * HD) return launch<false, 2 * HD>(tq, tk, tv, kv_mask, out, lse, B, T, H, sm_scale,
                                                 stream);
  return lse == nullptr
             ? launch<false, HD>(tq, tk, tv, kv_mask, out, lse, B, T, H, sm_scale, stream)
             : launch<true, HD>(tq, tk, tv, kv_mask, out, lse, B, T, H, sm_scale, stream);
}
