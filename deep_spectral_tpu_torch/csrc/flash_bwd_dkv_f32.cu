// dK and dV of masked flash attention for Hopper (sm_90a), f32, packed
// (B, T, H, hd) layout, on TF32 tensor cores as split-TF32 (3xTF32) products,
// keys on the M side.
//
// Replaces: deep_spectral_tpu/models/flash_attention.py::_flash_bwd_dkv_kernel
// (launched by _flash_backward) for f32. (The bf16 build is
// flash_bwd_dkv.cu.) Same math, per (batch, head) and key tile, summed over q tiles,
// with s = q k^T * scale and the saved lse and di = rowsum(o do):
//   p  = select(key valid && q < T, exp(s - lse), 0)   (a select: exp(s - lse)
//                                                       may be inf on masked keys)
//   dv = sum p^T do,   ds = p * (do v^T - di),   dk = scale * sum ds^T q.
// p, dp and ds stay f32, as in the Pallas kernel, and every product is
// f32-accurate: three TF32 products of hi/lo splits (tf32.cuh: hi and lo
// rounded to nearest, ties away from zero). Keys past T and masked keys write
// dk = dv = 0, so a batch row with no valid key comes out exactly 0.
// Defining DSS_F32_SINGLE_TF32 builds the single-pass control (tf32.cuh).
//
// What bounds it on this card: at the fp32 recipe's shape (B=144, T=197,
// H=6, hd=64) the four T x T x 64 products are 17.2 GFLOP over the valid
// keys, 104 us at the split-TF32 peak (495 / 3 = 165 TFLOP/s), against 262
// MB of q/k/v/do/dk/dv and lse/di traffic (78 us at 3.35 TB/s): operations
// bound.
//
// What the design does about it: one CTA per (128-key tile, head, batch),
// 2 x 6 x 144 = 1728 CTAs at the recipe's shape, of three warpgroups. tf32
// wgmma has no transposed operand, and the products dV += P^T dO and
// dK += dS^T Q contract over q, which is dO's and Q's row index, so their B
// operand would need transposed copies of dO and Q (hi and lo), which with
// K and V's 128 KB do not fit beside a ring. Those two run on mma.sync
// m16n8k8 tf32 instead, whose B fragments each lane loads by hand from the
// row-major tiles (two rows of one hd column: no copy, no bank conflict under
// the 128B swizzle); S^T = K Q^T and dP^T = V dO^T, K-major as TMA loads them,
// run on wgmma:
//   * warp 8 loads K and V (128 keys) once and streams Q and dO tiles of 32
//     rows through a 2-stage ring by TMA, from 4-d (hd, H, T, B) maps over
//     the strided views (the fused qkv is read in place; rows past T
//     zero-filled), each tile as two 128-byte-wide halves of hd; its lanes
//     load the tile's lse and di rows into shared memory (0 past T);
//   * warps 9-11 (96 threads) split each Q and dO tile in place into hi,
//     with lo tiles beside them, then a proxy fence and an arrive; each
//     consumer warpgroup splits its own 64 keys of K and V the same way
//     while they split the first stage;
//   * warpgroups 0 and 1 (64 keys each) run S^T and dP^T as wgmma m64n32k8
//     (8 k-steps over hd x hi.hi, hi.lo, lo.hi), P^T and dS^T on the
//     accumulator fragments, which are mma.sync's A fragments as they lie
//     once the q order of each 8-block is permuted (k_perm) in the B loads,
//     and dV, dK += on mma.sync (4 k-steps over q x 8 hd blocks x 3).
// Shared memory: K and V hi/lo 128 KB, each stage Q and dO hi/lo 32 KB.
//
// Requirements the Python wrapper checks: f32, hd == 64, unit stride on hd,
// other strides multiples of 4 elements (16 bytes, as TMA needs), 16-byte
// aligned base pointers; lse and di contiguous (B, H, T) f32. dk and dv are
// written through their strides.

#include <math.h>
#include <stdint.h>

#include "errors.cuh"
#include "tf32.cuh"

namespace {

constexpr int BKV = 128;                   // keys per CTA (64 per consumer warpgroup)
constexpr int BQ = 32;                     // q rows per streamed tile
constexpr int STAGES = 2;                  // Q/dO ring depth
constexpr int CONSUMERS = 2;               // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int SPLITTERS = 96;              // warps 9-11
constexpr int KV_BYTES = BKV * HD * 4;     // 32 KB: two 16 KB halves of hd
constexpr int Q_BYTES = BQ * HD * 4;       // 8 KB: two 4 KB halves of hd
constexpr int STAGE_BYTES = 4 * Q_BYTES;   // Q hi, Q lo, dO hi, dO lo
constexpr int STATS_BYTES = 2 * BQ * 4;    // lse and di of one q tile
static_assert(Q_BYTES / 2 == X_HALF, "mma_acc reads Q and dO tiles of 32 rows");
constexpr int SMEM_BYTES = 1024 /* alignment slack */ + 4 * KV_BYTES +
                           STAGES * (STAGE_BYTES + STATS_BYTES) + 8 * (3 * STAGES + 1);

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_f32_kernel(const __grid_constant__ CUtensorMap tq,   // boxes of BQ rows
                         const __grid_constant__ CUtensorMap tk,   // boxes of BKV rows
                         const __grid_constant__ CUtensorMap tv,   // boxes of BKV rows
                         const __grid_constant__ CUtensorMap tdo,  // boxes of BQ rows
                         const uint8_t* __restrict__ kv_mask,      // (B, T) or null
                         const float* __restrict__ lse,            // (B, H, T)
                         const float* __restrict__ di,             // (B, H, T)
                         float* __restrict__ dk, float* __restrict__ dv,
                         long long dksb, long long dkst, long long dksh,
                         long long dvsb, long long dvst, long long dvsh,
                         int T, int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);  // 1024-aligned for the swizzle
  // K hi, K lo, V hi, V lo (TMA lands K and V in the hi tiles, split in place)
  uint8_t* k_hi = smem;
  uint8_t* v_hi = smem + 2 * KV_BYTES;
  // per stage: Q hi, Q lo, dO hi, dO lo
  auto stage = [&](int st) { return smem + 4 * KV_BYTES + st * STAGE_BYTES; };
  float* stats = reinterpret_cast<float*>(stage(STAGES));
  auto lse_s = [&](int st) { return stats + st * 2 * BQ; };  // lse, then di
  const uint32_t bars = smem_u32(stats + STAGES * 2 * BQ);
  auto full = [&](int s) { return bars + 8 * s; };
  auto ready = [&](int s) { return bars + 8 * (STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * STAGES + s); };
  const uint32_t kvfull = bars + 24 * STAGES;

  const int k0 = blockIdx.x * BKV;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int n_q = (T + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 32);  // every producer lane: its stats stores, lane 0 the TMA bytes
      mbar_init(ready(s), SPLITTERS);
      mbar_init(empty(s), CONSUMERS * 128);
    }
    mbar_init(kvfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == CONSUMERS * 4) {
      // ------------------------------------------------------- TMA producer
      if (lane == 0) {
        mbar_arrive_expect_tx(kvfull, 2 * KV_BYTES);
        tma_load_f32(smem_u32(k_hi), &tk, kvfull, 0, h, k0, b);
        tma_load_f32(smem_u32(k_hi) + KV_BYTES / 2, &tk, kvfull, HD / 2, h, k0, b);
        tma_load_f32(smem_u32(v_hi), &tv, kvfull, 0, h, k0, b);
        tma_load_f32(smem_u32(v_hi) + KV_BYTES / 2, &tv, kvfull, HD / 2, h, k0, b);
      }
      const long long row0 = ((long long)b * H + h) * T;
      for (int qt = 0; qt < n_q; ++qt) {
        const int st = qt % STAGES;
        mbar_wait(empty(st), ((qt / STAGES) & 1) ^ 1);
        float* ls = lse_s(st);
        const int tq0 = qt * BQ + lane;
        ls[lane] = tq0 < T ? lse[row0 + tq0] : 0.f;
        ls[BQ + lane] = tq0 < T ? di[row0 + tq0] : 0.f;
        if (lane == 0) {
          const uint32_t q_s = smem_u32(stage(st)), do_s = q_s + 2 * Q_BYTES;
          mbar_arrive_expect_tx(full(st), 2 * Q_BYTES);
          tma_load_f32(q_s, &tq, full(st), 0, h, qt * BQ, b);
          tma_load_f32(q_s + Q_BYTES / 2, &tq, full(st), HD / 2, h, qt * BQ, b);
          tma_load_f32(do_s, &tdo, full(st), 0, h, qt * BQ, b);
          tma_load_f32(do_s + Q_BYTES / 2, &tdo, full(st), HD / 2, h, qt * BQ, b);
        } else {
          mbar_arrive(full(st));
        }
      }
    } else {
      // ---------------------------------------------- splitters (warps 9-11)
      const int tid = threadIdx.x - (CONSUMERS * 4 + 1) * 32;
      for (int qt = 0; qt < n_q; ++qt) {
        const int st = qt % STAGES;
        mbar_wait(full(st), (qt / STAGES) & 1);
        uint8_t* s = stage(st);
        split_tile(reinterpret_cast<float4*>(s), reinterpret_cast<float4*>(s + Q_BYTES),
                   Q_BYTES / 16, tid, SPLITTERS);
        split_tile(reinterpret_cast<float4*>(s + 2 * Q_BYTES),
                   reinterpret_cast<float4*>(s + 3 * Q_BYTES), Q_BYTES / 16, tid, SPLITTERS);
        fence_async_shared();
        mbar_arrive(ready(st));
      }
    }
  } else {
    // --------------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // K's and V's hd halves are 16 KB apart, this warpgroup's 64 keys 8 KB into
    // each; the warpgroup splits its keys itself while the splitters take the
    // first Q/dO stage
    mbar_wait(kvfull, 0);
#pragma unroll 1
    for (int i = 0; i < 4; ++i) {
      uint8_t* x = (i < 2 ? k_hi : v_hi) + (i & 1) * (KV_BYTES / 2) + wg * (KV_BYTES / 4);
      split_tile(reinterpret_cast<float4*>(x), reinterpret_cast<float4*>(x + KV_BYTES),
                 KV_BYTES / 64, threadIdx.x & 127, 128);
    }
    fence_async_shared();
    warpgroup_sync(wg);
    const int g = lane >> 2;  // fragment row within the warp's 16
    const int t = lane & 3;   // thread in the row's quad
    bool key_ok[2];           // this thread's keys: fragment rows g and g + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + wg * 64 + (warp & 3) * 16 + g + 8 * r;
      key_ok[r] = key < T && (kv_mask == nullptr || kv_mask[(long long)b * T + key] != 0);
    }
    float dk_acc[32], dv_acc[32];  // [4j + e]: key row g + 8 (e >> 1), hd 8j + 2t + (e & 1)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dk_acc[i] = 0.f;
      dv_acc[i] = 0.f;
    }
    const uint32_t kh_s = smem_u32(k_hi) + wg * (KV_BYTES / 4), kl_s = kh_s + KV_BYTES;
    const uint32_t vh_s = smem_u32(v_hi) + wg * (KV_BYTES / 4), vl_s = vh_s + KV_BYTES;

    for (int qt = 0; qt < n_q; ++qt) {
      const int st = qt % STAGES;
      mbar_wait(ready(st), (qt / STAGES) & 1);
      const uint8_t* s_ptr = stage(st);
      const uint32_t qh_s = smem_u32(s_ptr), ql_s = qh_s + Q_BYTES;
      const uint32_t doh_s = qh_s + 2 * Q_BYTES, dol_s = qh_s + 3 * Q_BYTES;

      // S^T = K Q^T and dP^T = V dO^T: k-step kk is 8 floats (32 bytes, 2
      // descriptor units) along hd half kk / 4.
      float s[16], dp[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t ko = (kk >> 2) * (KV_BYTES / 2), qo = (kk >> 2) * (Q_BYTES / 2);
        const int c = 2 * (kk & 3);
        wgmma_tf32_n32(s, smem_desc(kh_s + ko) + c, smem_desc(qh_s + qo) + c, kk);
        wgmma_tf32_n32(s, smem_desc(kh_s + ko) + c, smem_desc(ql_s + qo) + c, 1);
        wgmma_tf32_n32(s, smem_desc(kl_s + ko) + c, smem_desc(qh_s + qo) + c, 1);
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t ko = (kk >> 2) * (KV_BYTES / 2), qo = (kk >> 2) * (Q_BYTES / 2);
        const int c = 2 * (kk & 3);
        wgmma_tf32_n32(dp, smem_desc(vh_s + ko) + c, smem_desc(doh_s + qo) + c, kk);
        wgmma_tf32_n32(dp, smem_desc(vh_s + ko) + c, smem_desc(dol_s + qo) + c, 1);
        wgmma_tf32_n32(dp, smem_desc(vl_s + ko) + c, smem_desc(doh_s + qo) + c, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();

      // s[4j + e]: key row g + 8 (e >> 1), q column 8j + 2t + (e & 1).
      const float* ls = lse_s(st);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c0 = 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c0);
        const float2 d2 = *reinterpret_cast<const float2*>(ls + BQ + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = key_ok[e >> 1] && qt * BQ + c0 + (e & 1) < T;
          const float p = __expf(s[4 * j + e] * scale - ((e & 1) ? l2.y : l2.x));
          s[4 * j + e] = ok ? p : 0.f;
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
        }
      }
      // dV += P^T dO, dK += dS^T Q on mma.sync, each warp its 16 keys.
      float a_hi[4][4], a_lo[4][4];
      split_a16(s, a_hi, a_lo);
      mma_acc(dv_acc, a_hi, a_lo, s_ptr + 2 * Q_BYTES, s_ptr + 3 * Q_BYTES, g, t);
      split_a16(dp, a_hi, a_lo);
      mma_acc(dk_acc, a_hi, a_lo, s_ptr, s_ptr + Q_BYTES, g, t);
      mbar_arrive(empty(st));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + wg * 64 + (warp & 3) * 16 + g + 8 * r;
      if (key >= T) continue;
      float* krow = dk + b * dksb + key * dkst + h * dksh;
      float* vrow = dv + b * dvsb + key * dvst + h * dvsh;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(krow + 8 * j + 2 * t) =
            make_float2(dk_acc[4 * j + 2 * r] * scale, dk_acc[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<float2*>(vrow + 8 * j + 2 * t) =
            make_float2(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

}  // namespace

// Entry point. `strides` is a host array of (batch, token, head) element
// strides, three per tensor, in the order q, k, v, do, dk, dv; lse and di are
// contiguous (B, H, T) f32.
extern "C" int dss_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                     const void* kv_mask, const void* dout, const void* lse,
                                     const void* di, void* dk, void* dv, int B, int T, int H,
                                     const long long* strides, float scale, void* stream) {
  const long long* s = strides;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map_f32(&tq, q, B, T, H, s[0], s[1], s[2], BQ) ||
      !make_map_f32(&tk, k, B, T, H, s[3], s[4], s[5], BKV) ||
      !make_map_f32(&tv, v, B, T, H, s[6], s[7], s[8], BKV) ||
      !make_map_f32(&tdo, dout, B, T, H, s[9], s[10], s[11], BQ))
    return DSS_ERR_TENSOR_MAP;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BKV - 1) / BKV, H, B);
  flash_bwd_dkv_f32_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const uint8_t*>(kv_mask), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<float*>(dk), static_cast<float*>(dv), s[12],
      s[13], s[14], s[15], s[16], s[17], T, H, scale);
  return static_cast<int>(cudaGetLastError());
}

