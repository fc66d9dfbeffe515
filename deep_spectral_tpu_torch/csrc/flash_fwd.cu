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
// Head dim 80 with a decomposed relative-position bias (SAM ViT-H's 16 heads
// of 80; the inference build only, which takes no key mask, as a kernel of
// its own, flash_fwd_relpos_kernel, on the same body): logit(q, k) =
// q.k / sqrt(80) + rel_h[q, k / S] + rel_w[q, k % S] over keys laid out as an
// S-wide grid, rel_h (B, H, T, NY) and rel_w (B, H, T, S) bf16 tables that
// the wrapper computes (q times the gathered relative-position tables), so no
// (B, H, T, T) tensor exists. 80 columns are a 64-column box (128B-swizzled,
// 16 KB a 128-row tile) and a 16-column box (32B-swizzled, 4 KB) loaded from
// a second map of 16-column boxes: S = Q K^T is 4 k-steps in the first and 1
// in the second; O += P V is an m64n64k16 and an m64n16k16 product a 16-key
// step (one wgmma cannot read two swizzle layouts), into 40 accumulators a
// thread. Each CTA stages its 128 rows of both tables in shared memory, as
// f32 scaled by log2(e): rel_h transposed to [y][row], a row's partner 8 rows
// on beside it (a thread's two rows are one 8-byte load), rows of REL_STRIDE
// floats; rel_w to [x / 2][row][x % 2] likewise (a thread's key pair x, x + 1,
// x even, of both its rows is one 16-byte load), rows of 2 REL_STRIDE floats.
// The strides keep a warp's lanes on distinct banks. S is even, so a key pair
// never straddles two grid rows. The softmax adds the two values of each
// (row, key) to the scaled score before the running max. 20 KB tiles: q and
// the 3-stage K/V ring take 140 KB, the tables (NY' + S) x 528 bytes, NY' =
// the rows the CTA's key tiles span (67.6 KB at S = 64, T = 4096; 17.4 KB at
// S = 14, T = 196). At SAM's shapes the products are 4 T^2 hd flops per (b,
// h) (window blocks: T = 196, 25 windows an image; global blocks: T = 4096),
// and the bias costs an 8-byte and a 16-byte shared load per key pair of a
// row pair, beside the exponentials.
//
// Requirements the Python wrapper checks: bf16, hd == 64 (hd == 128 without
// the lse, hd == 80 with the bias and without the lse or a key mask), unit
// stride on hd, other strides multiples of 8 elements (16 bytes, as TMA
// needs), 16-byte aligned base pointers; the bias tables bf16 with unit
// stride on their last dim, S even and >= 8. out is contiguous (B, T, H, hd).

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
constexpr int REL_STRIDE = 132;           // floats a staged bias row: 4 mod 32 banks
constexpr int W_STRIDE = 2 * REL_STRIDE;  // floats a staged rel_w row pair: 8 mod 32 banks

// A q, K or V tile of head dim HDIM: HALVES boxes of 64 columns, SUB_BYTES
// apart, then at hd 80 a 16-column box (TAIL bytes), and the kernel's shared
// memory (at hd 80 before the bias tables, which start at BIAS).
template <int HDIM>
struct Tile {
  static constexpr int HALVES = HDIM / 64;
  static constexpr int TAIL = HDIM % 64 * 2 * BK;  // 4 KB at hd 80
  static constexpr int BYTES = SUB_BYTES * HALVES + TAIL;  // 16, 20 and 32 KB at hd 64, 80, 128
  static constexpr int SMEM = 1024 /* alignment slack */ + BYTES * (1 + 2 * STAGES) +
                              16 * STAGES + 8 * (2 * STAGES + 1);
  static constexpr int BIAS = (SMEM - 1024 + 15) & ~15;
};

// The hd-80 build's relative-position bias: the 16-column boxes' maps and
// the two tables, rel_h (B, H, T, NY) and rel_w (B, H, T, S), by their
// element strides; NYA rows of rel_h are staged (the rows the key tiles
// span, zeros past NY). The other builds take it empty.
struct RelPos {
  CUtensorMap tq, tk, tv;
  const __nv_bfloat16* h;
  const __nv_bfloat16* w;
  long long hsb, hsh, hst, wsb, wsh, wst;
  int S, NY, NYA;
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

// The hd-80 build's S = Q K^T: 4 k-steps in the 64-column boxes (dq, dk),
// the fifth in the 32B-swizzled 16-column boxes (dq1, dk1).
__device__ __forceinline__ void issue_qk_80(float (&s)[64], uint64_t dq, uint64_t dk,
                                            uint64_t dq1, uint64_t dk1) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
  wgmma_m64n128k16_ss(s, dq1, dk1, 1);
  wgmma_commit();
}

// The hd-80 build's O += P V: a 16-key step is 16 rows of 128 bytes in the
// 64-column box (dv) and of 32 bytes in the 16-column box (dv1, 32 units).
__device__ __forceinline__ void issue_pv_80(float (&o)[40], const uint32_t (&pa)[8][4],
                                            uint64_t dv, uint64_t dv1) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_m64n64k16_rs_at<0>(o, pa[kk], dv + 128 * kk);
    wgmma_m64n16k16_rs_at<32>(o, pa[kk], dv1 + 32 * kk);
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

// The hd-80 build's softmax of one tile: s[4j + e] (row g + 8 (e >> 1), key
// 8j + 2t + (e & 1)) goes from q.k to p = exp2(q.k scale_log2 + bias - m),
// bias = sh[y][row] + sw[x / 2][row][x % 2] (log2 units) at the key's grid
// cell (y, x); (y, x / 2) = (y, xp) enters at the thread's first key pair, 2t
// after the tile's start, and steps 8 keys (4 pairs) a j over a grid of SP =
// S / 2 pairs a row (S >= 8: one wrap at most). sh and sw point at the
// thread's row pair. As softmax_step otherwise.
template <bool MASKED>
__device__ __forceinline__ void softmax_step_bias(float (&s)[64], const uint32_t (&vw)[4], int t,
                                                  float scale_log2, const float* sh,
                                                  const float* sw, int SP, int y, int xp,
                                                  float (&m_run)[2], float (&l_run)[2],
                                                  float (&alpha)[2]) {
  auto valid = [&](int j, int e) {
    return ((vw[j >> 2] >> (8 * (j & 3) + 2 * t + (e & 1))) & 1u) != 0u;
  };
  float mx[2] = {MASKED ? MASK_VALUE : -INFINITY, MASKED ? MASK_VALUE : -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 hv = *reinterpret_cast<const float2*>(sh + y * REL_STRIDE);
    const float4 wv = *reinterpret_cast<const float4*>(sw + xp * W_STRIDE);
    const float bias[4] = {hv.x + wv.x, hv.x + wv.y, hv.y + wv.z, hv.y + wv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = fmaf(s[4 * j + e], scale_log2, bias[e]);
      if (MASKED) v = valid(j, e) ? v : MASK_VALUE;
      s[4 * j + e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
    xp += 4;
    if (xp >= SP) {
      xp -= SP;
      ++y;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    alpha[r] = ex2(m_run[r] - m_new);  // 0 on the first tile (m_run = -inf)
    m_run[r] = m_new;
  }
  float rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(s[4 * j + e] - m_run[e >> 1]);
      if (MASKED) p = valid(j, e) ? p : 0.f;
      s[4 * j + e] = p;
      rsum[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + rsum[r];
}

__device__ __forceinline__ void softmax_tile_bias(float (&s)[64], const uint4& vb, int t,
                                                  float scale_log2, const float* sh,
                                                  const float* sw, int SP, int y, int xp,
                                                  float (&m_run)[2], float (&l_run)[2],
                                                  float (&alpha)[2]) {
  const uint32_t vw[4] = {vb.x, vb.y, vb.z, vb.w};
  if ((vb.x & vb.y & vb.z & vb.w) == 0xffffffffu)
    softmax_step_bias<false>(s, vw, t, scale_log2, sh, sw, SP, y, xp, m_run, l_run, alpha);
  else
    softmax_step_bias<true>(s, vw, t, scale_log2, sh, sw, SP, y, xp, m_run, l_run, alpha);
}

// Row r of a CTA's 128 staged at column 16 (r / 16) + 2 (r % 8) + (r / 8) % 2
// of a bias row: rows r and r + 8 (a thread's pair) side by side (rel_w: at
// 2 column + x % 2 of a row pair).
__device__ __forceinline__ int bias_col(int r) { return (r & ~15) | ((r & 7) << 1) | ((r >> 3) & 1); }

// The kernels' body: tq, tk and tv (and rp's maps) are __grid_constant__
// parameters of the kernel that inlines it; rp is the hd-80 build's bias (null
// in the other builds).
template <bool WRITE_LSE, int HDIM>
__device__ __forceinline__ void flash_fwd_body(const CUtensorMap& tq, const CUtensorMap& tk,
                                               const CUtensorMap& tv,
                                               const uint8_t* __restrict__ kv_mask,
                                               __nv_bfloat16* __restrict__ out, int T, int H,
                                               float scale_log2, float* __restrict__ lse,
                                               const RelPos* rp) {
  constexpr int TILE_BYTES = Tile<HDIM>::BYTES;
  constexpr int HALVES = Tile<HDIM>::HALVES;
  constexpr bool RELPOS = HDIM == 80;
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
          if constexpr (RELPOS) tma_load_at(q_s + SUB_BYTES, &rp->tq, qbar, 64, h, q0, b);
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
            if constexpr (RELPOS) {
              tma_load_at(k_s + st * TILE_BYTES + SUB_BYTES, &rp->tk, full(st), 64, h, kt * BK, b);
              tma_load_at(v_s + st * TILE_BYTES + SUB_BYTES, &rp->tv, full(st), 64, h, kt * BK, b);
            }
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

    // The hd-80 build's bias: the CTA's rows of both tables into shared
    // memory (a warp a row at a time, lanes along it), then the thread's
    // first key pair's grid cell (row, pair), stepped a tile at a time.
    const float* sh = nullptr;
    const float* sw = nullptr;
    int sp = 0, ty = 0, txp = 0, dy = 0, dxp = 0;
    if constexpr (RELPOS) {
      float* bias = reinterpret_cast<float*>(smem + Tile<HDIM>::BIAS);
      float* bw = bias + rp->NYA * REL_STRIDE;
      for (int r = warp; r < BQ; r += 2 * 4) {
        const int q = q0 + r;
        const int c = bias_col(r);
        const __nv_bfloat16* hrow = rp->h + b * rp->hsb + h * rp->hsh + (long long)q * rp->hst;
        const __nv_bfloat16* wrow = rp->w + b * rp->wsb + h * rp->wsh + (long long)q * rp->wst;
        for (int y = lane; y < rp->NYA; y += 32)
          bias[y * REL_STRIDE + c] = q < T && y < rp->NY ? __bfloat162float(hrow[y]) * LOG2E : 0.f;
        for (int x = lane; x < rp->S; x += 32)
          bw[(x >> 1) * W_STRIDE + 2 * c + (x & 1)] =
              q < T ? __bfloat162float(wrow[x]) * LOG2E : 0.f;
      }
      asm volatile("bar.sync 3, 256;\n" ::: "memory");
      const int col = wg * 64 + (warp & 3) * 16 + 2 * g;
      sh = bias + col;
      sw = bw + 2 * col;
      sp = rp->S / 2;
      txp = t;
      dy = BK / rp->S;
      dxp = BK % rp->S / 2;
    }

    mbar_wait(qbar, 0);
    if (wg == 1) sched_arrive(0);  // warpgroup 0 issues first
    const uint64_t dq = smem_desc(q_s + wg * (SUB_BYTES / 2));
    const uint64_t dq1 = RELPOS ? smem_desc32(q_s + SUB_BYTES + wg * (Tile<HDIM>::TAIL / 2)) : 0;
    float s[64];
    uint32_t pa[8][4];

    // Tile 0: S only. Every later round issues S(kt) and P(kt-1) V(kt-1)
    // together and runs tile kt's softmax while the P.V product runs.
    mbar_wait(full(0), 0);
    sched_sync(wg);
    wgmma_fence();
    if constexpr (RELPOS)
      issue_qk_80(s, dq, smem_desc(k_s), dq1, smem_desc32(k_s + SUB_BYTES));
    else
      issue_qk<HDIM>(s, dq, smem_desc(k_s));
    sched_arrive(1 - wg);
    wgmma_wait<0>();
    float alpha[2];
    if constexpr (RELPOS) {
      softmax_tile_bias(s, kvalid[0], t, scale_log2, sh, sw, sp, ty, txp, m_run, l_run, alpha);
      txp += dxp;
      ty += dy;
      if (txp >= sp) {
        txp -= sp;
        ++ty;
      }
    } else {
      softmax_tile(s, kvalid[0], t, scale_log2, m_run, l_run, alpha);
    }
    pack_p(s, pa);

    for (int kt = 1; kt < n_kv; ++kt) {
      const int st = kt % STAGES;
      const int prev = (kt - 1) % STAGES;
      mbar_wait(full(st), (kt / STAGES) & 1);
      sched_sync(wg);
      wgmma_fence();
      if constexpr (RELPOS) {
        issue_qk_80(s, dq, smem_desc(k_s + st * TILE_BYTES), dq1,
                    smem_desc32(k_s + st * TILE_BYTES + SUB_BYTES));
        issue_pv_80(o, pa, smem_desc(v_s + prev * TILE_BYTES),
                    smem_desc32(v_s + prev * TILE_BYTES + SUB_BYTES));
      } else {
        issue_qk<HDIM>(s, dq, smem_desc(k_s + st * TILE_BYTES));
        issue_pv<HDIM>(o, pa, smem_desc(v_s + prev * TILE_BYTES));
      }
      sched_arrive(1 - wg);
      wgmma_wait<1>();  // S(kt) is in; P(kt-1) V(kt-1) may still run
      if constexpr (RELPOS) {
        softmax_tile_bias(s, kvalid[st], t, scale_log2, sh, sw, sp, ty, txp, m_run, l_run,
                          alpha);
        txp += dxp;
        ty += dy;
        if (txp >= sp) {
          txp -= sp;
          ++ty;
        }
      } else {
        softmax_tile(s, kvalid[st], t, scale_log2, m_run, l_run, alpha);
      }
      wgmma_wait<0>();
      mbar_arrive(empty(prev));
#pragma unroll
      for (int i = 0; i < HDIM / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p(s, pa);
    }

    const int last = (n_kv - 1) % STAGES;
    sched_sync(wg);
    wgmma_fence();
    if constexpr (RELPOS)
      issue_pv_80(o, pa, smem_desc(v_s + last * TILE_BYTES),
                  smem_desc32(v_s + last * TILE_BYTES + SUB_BYTES));
    else
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
  flash_fwd_body<WRITE_LSE, HDIM>(tq, tk, tv, kv_mask, out, T, H, scale_log2, lse, nullptr);
}

// The hd-80 inference build with the bias: a kernel of its own, so that the
// other builds keep their parameter list.
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_relpos_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        __nv_bfloat16* __restrict__ out,      // (B, T, H, 80)
                        int T, int H, float scale_log2,
                        const __grid_constant__ RelPos rp) {
  flash_fwd_body<false, 80>(tq, tk, tv, nullptr, out, T, H, scale_log2, nullptr, &rp);
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

// The hd-80 inference forward with the decomposed relative-position bias
// over an S-wide key grid: rel_h (B, H, T, NY) and rel_w (B, H, T, S) bf16,
// unit stride on the last dim, T <= NY * S, S even and >= 8.
extern "C" int dss_flash_fwd_relpos(const void* q, const void* k, const void* v, void* out,
                                    const void* rel_h, const void* rel_w,
                                    int B, int T, int H, int S, int NY,
                                    long long qsb, long long qst, long long qsh,
                                    long long ksb, long long kst, long long ksh,
                                    long long vsb, long long vst, long long vsh,
                                    long long hsb, long long hsh, long long hst,
                                    long long wsb, long long wsh, long long wst,
                                    float sm_scale, void* stream) {
  constexpr int HDIM = 80;
  if (S < 8 || S % 2 != 0 || (long long)NY * S < T) return DSS_ERR_PLAN;
  RelPos rp{};
  rp.h = static_cast<const __nv_bfloat16*>(rel_h);
  rp.w = static_cast<const __nv_bfloat16*>(rel_w);
  rp.hsb = hsb, rp.hsh = hsh, rp.hst = hst, rp.wsb = wsb, rp.wsh = wsh, rp.wst = wst;
  rp.S = S;
  rp.NY = NY;
  rp.NYA = ((T + BK - 1) / BK * BK + S - 1) / S;  // the rows the key tiles span
  const int smem = 1024 + Tile<HDIM>::BIAS + (rp.NYA + S) * REL_STRIDE * 4;
  if (smem > 232448) return DSS_ERR_PLAN;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, T, H, qsb, qst, qsh, BQ, HDIM) ||
      !make_map(&tk, k, B, T, H, ksb, kst, ksh, BK, HDIM) ||
      !make_map(&tv, v, B, T, H, vsb, vst, vsh, BK, HDIM) ||
      !make_map(&rp.tq, q, B, T, H, qsb, qst, qsh, BQ, HDIM, 16, CU_TENSOR_MAP_SWIZZLE_32B) ||
      !make_map(&rp.tk, k, B, T, H, ksb, kst, ksh, BK, HDIM, 16, CU_TENSOR_MAP_SWIZZLE_32B) ||
      !make_map(&rp.tv, v, B, T, H, vsb, vst, vsh, BK, HDIM, 16, CU_TENSOR_MAP_SWIZZLE_32B))
    return DSS_ERR_TENSOR_MAP;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_relpos_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_relpos_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), T, H, sm_scale * LOG2E, rp);
  return static_cast<int>(cudaGetLastError());
}
