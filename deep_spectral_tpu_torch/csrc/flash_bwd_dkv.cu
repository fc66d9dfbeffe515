// dK and dV of masked flash attention for Hopper (sm_90a), bf16, packed
// (B, T, H, hd) layout, on wgmma with keys on the M side.
//
// Replaces: deep_spectral_tpu/models/flash_attention.py::_flash_bwd_dkv_kernel
// (launched by _flash_backward) for bf16. (The f32 build is
// flash_bwd_dkv_f32.cu.) Same math, per (batch, head) and key tile, summed
// over q tiles, with s = q k^T * scale and the saved lse and di = rowsum(o do):
//   p  = select(key valid, exp(s - lse), 0)   (a select: exp(s - lse) may be
//                                               inf on masked keys)
//   dv = sum p^T do,   ds = p * (do v^T - di),   dk = scale * sum ds^T q.
// p, dp and ds stay f32, as in the Pallas kernel: p^T and ds^T enter the
// tensor cores as a bf16 hi/lo pair (hi = bf16(x), lo = bf16(x - hi), two
// products against the same bf16 operand), which carries ~16 significant
// bits of each into the f32 accumulator. A single bf16 rounding of p and ds
// would be a different kernel (tests/test_torch_flash.py prints its error).
// Defining DSS_DKV_SINGLE_ROUNDING builds that kernel (the lo products left
// out), the control behind chip_smoke.py's DKV_SHARE_MAX (README); the
// port's build never defines it.
// Keys past T and masked keys write dk = dv = 0, so a batch row with no
// valid key comes out exactly 0.
//
// What bounds it on this card: at the train shape (B=144, T=197, H=6,
// hd=64) the four T x T x 64 products are 17.2 GFLOP over the valid keys,
// 17 us at the bf16 tensor-core peak, against 131 MB of q/k/v/do/dk/dv
// traffic (39 us at 3.35 TB/s): bytes bound on paper, but T=197 pads to two
// key tiles of 128 and four q tiles of 64 (1.7x the needed products), the
// hi/lo pair makes six products of four, and p needs T^2 exponentials per
// (b, h) on the SFUs, so the products and exponentials come close to the
// bytes' time.
//
// What the design does about it: one CTA per (128-key tile, head, batch),
// 2 x 6 x 144 = 1728 CTAs at the train shape, of three warpgroups.
// Warpgroup 2 is the producer: one thread loads the CTA's K and V tiles once
// by TMA and streams Q and dO tiles of 64 rows through a 3-stage ring, from
// the same 4-d (hd, H, T, B) tensor maps over strided views as the forward
// (the fused qkv is read in place; rows past T are zero-filled). lse and di
// rows are (B, H, T) f32 whose row pitch (4 T bytes) TMA cannot take at odd
// T, so the producer warp's 32 lanes load them with plain coalesced loads
// into shared memory beside the tile (lse times log2 e; 0 past T), and each
// lane arrives on the stage's barrier. Warpgroups 0 and 1 (64 keys each,
// registers raised with setmaxnreg) run, per q tile:
//   S^T = K Q^T and dP^T = V dO^T as wgmma m64n64k16, both operands K-major
//     in 128B-swizzled shared memory (the forward's S = Q K^T, roles swapped);
//   P^T = select(key valid && q < T, exp2(S^T scale log2 e - lse log2 e), 0)
//     and dS^T = P^T (dP^T - di) on the accumulator fragments (the key mask is
//     per fragment row, lse and di per column);
//   dV += P^T dO and dK += dS^T Q as wgmma m64n64k16 with A from registers
//     (the fragments split into hi/lo and re-packed in place, as the forward
//     packs P) and dO or Q as the transposed (MN-major) B operand, as the
//     forward reads V, so nothing is transposed by hand.
// The epilogue scales dK and writes dk and dv through their strides, e.g.
// straight into the (B, T, 3, H, hd) gradient of the fused projection.
//
// Requirements the Python wrapper checks: bf16, hd == 64, unit stride on hd,
// other strides multiples of 8 elements (16 bytes, as TMA needs), 16-byte
// aligned base pointers; lse and di contiguous (B, H, T) f32.

#include <math.h>
#include <stdint.h>

#include "errors.cuh"
#include "hopper.cuh"

namespace {

constexpr int BKV = 128;                   // keys per CTA (64 per consumer warpgroup)
constexpr int BQ = 64;                     // q rows per streamed tile
constexpr int STAGES = 3;                  // Q/dO ring depth
constexpr int CONSUMERS = 2;               // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int KV_BYTES = BKV * HD * 2;     // 16 KB
constexpr int Q_BYTES = BQ * HD * 2;       // 8 KB
constexpr int STATS_BYTES = 2 * BQ * 4;    // lse and di of one q tile
constexpr int SMEM_BYTES = 1024 /* alignment slack */ + 2 * KV_BYTES +
                           STAGES * (2 * Q_BYTES + STATS_BYTES) + 8 * (2 * STAGES + 1);

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,   // boxes of BQ rows
                           const __grid_constant__ CUtensorMap tk,   // boxes of BKV rows
                           const __grid_constant__ CUtensorMap tv,   // boxes of BKV rows
                           const __grid_constant__ CUtensorMap tdo,  // boxes of BQ rows
                           const uint8_t* __restrict__ kv_mask,      // (B, T) or null
                           const float* __restrict__ lse,            // (B, H, T)
                           const float* __restrict__ di,             // (B, H, T)
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           long long dksb, long long dkst, long long dksh,
                           long long dvsb, long long dvst, long long dvsh,
                           int T, int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);  // 1024-aligned for the swizzle
  const uint32_t k_s = smem_u32(smem);
  const uint32_t v_s = k_s + KV_BYTES;
  auto q_s = [&](int st) { return v_s + KV_BYTES + st * 2 * Q_BYTES; };
  auto do_s = [&](int st) { return q_s(st) + Q_BYTES; };
  float* stats = reinterpret_cast<float*>(smem + 2 * KV_BYTES + STAGES * 2 * Q_BYTES);
  auto lse_s = [&](int st) { return stats + st * 2 * BQ; };  // lse log2(e), then di
  const uint32_t bars = smem_u32(stats + STAGES * 2 * BQ);   // full[STAGES], empty[STAGES], kv
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t kvbar = bars + 16 * STAGES;

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
      mbar_init(empty(s), CONSUMERS * 128);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == CONSUMERS * 4) {
      if (lane == 0) {
        mbar_arrive_expect_tx(kvbar, 2 * KV_BYTES);
        tma_load(k_s, &tk, kvbar, h, k0, b);
        tma_load(v_s, &tv, kvbar, h, k0, b);
      }
      const long long row0 = ((long long)b * H + h) * T;
      for (int qt = 0; qt < n_q; ++qt) {
        const int st = qt % STAGES;
        mbar_wait(empty(st), ((qt / STAGES) & 1) ^ 1);
        float* ls = lse_s(st);
        for (int i = lane; i < BQ; i += 32) {
          const int t = qt * BQ + i;
          ls[i] = t < T ? lse[row0 + t] * LOG2E : 0.f;
          ls[BQ + i] = t < T ? di[row0 + t] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(full(st), 2 * Q_BYTES);
          tma_load(q_s(st), &tq, full(st), h, qt * BQ, b);
          tma_load(do_s(st), &tdo, full(st), h, qt * BQ, b);
        } else {
          mbar_arrive(full(st));
        }
      }
    }
  } else {
    // --------------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int g = lane >> 2;  // fragment row within the warp's 16
    const int t = lane & 3;   // thread in the row's quad
    const float scale_log2 = scale * LOG2E;
    bool key_ok[2];           // this thread's keys: fragment rows g and g + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + wg * 64 + (warp & 3) * 16 + g + 8 * r;
      key_ok[r] = key < T && (kv_mask == nullptr || kv_mask[(long long)b * T + key] != 0);
    }
    float dk_acc[32], dv_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dk_acc[i] = 0.f;
      dv_acc[i] = 0.f;
    }
    mbar_wait(kvbar, 0);
    const uint64_t desc_k = smem_desc(k_s + wg * (KV_BYTES / 2));
    const uint64_t desc_v = smem_desc(v_s + wg * (KV_BYTES / 2));

    for (int qt = 0; qt < n_q; ++qt) {
      const int st = qt % STAGES;
      mbar_wait(full(st), (qt / STAGES) & 1);
      const uint64_t desc_q = smem_desc(q_s(st));
      const uint64_t desc_do = smem_desc(do_s(st));
      // S^T = K Q^T and dP^T = V dO^T: k-steps of 16 over hd are 32 bytes
      // along the swizzled rows (2 descriptor units).
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss(s, desc_k + 2 * kk, desc_q + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss(dp, desc_v + 2 * kk, desc_do + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();

      // s[4j + e]: key row g + 8 (e >> 1), q column 8j + 2t + (e & 1).
      const float* ls = lse_s(st);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c0 = 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + c0);
        const float2 d2 = *reinterpret_cast<const float2*>(ls + BQ + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = key_ok[e >> 1] && qt * BQ + c0 + (e & 1) < T;
          const float p = ex2(fmaf(s[4 * j + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
          s[4 * j + e] = ok ? p : 0.f;
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
        }
      }
      uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
      split_hi_lo(s, p_hi, p_lo);
      split_hi_lo(dp, ds_hi, ds_lo);

      // dV += P^T dO, dK += dS^T Q: dO and Q tiles are [q][hd], hd contiguous,
      // i.e. the MN-major B operand; a k-step of 16 q rows is 16 rows of 128
      // bytes (128 descriptor units).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n64k16_rs(dv_acc, p_hi[kk], desc_do + 128 * kk);
#ifndef DSS_DKV_SINGLE_ROUNDING
        wgmma_m64n64k16_rs(dv_acc, p_lo[kk], desc_do + 128 * kk);
#endif
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n64k16_rs(dk_acc, ds_hi[kk], desc_q + 128 * kk);
#ifndef DSS_DKV_SINGLE_ROUNDING
        wgmma_m64n64k16_rs(dk_acc, ds_lo[kk], desc_q + 128 * kk);
#endif
      }
      wgmma_commit();
      wgmma_wait<0>();
      mbar_arrive(empty(st));
    }

    // dk_acc[4j + 2r + c]: key row g + 8r, hd column 8j + 2t + c.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + wg * 64 + (warp & 3) * 16 + g + 8 * r;
      if (key >= T) continue;
      __nv_bfloat16* krow = dk + b * dksb + key * dkst + h * dksh;
      __nv_bfloat16* vrow = dv + b * dvsb + key * dvst + h * dvsh;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j + 2 * t) =
            __floats2bfloat162_rn(dk_acc[4 * j + 2 * r] * scale, dk_acc[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j + 2 * t) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

}  // namespace

// Entry point. `strides` is a host array of (batch, token, head) element
// strides, three per tensor, in the order q, k, v, do, dk, dv; lse and di are
// contiguous (B, H, T) f32.
extern "C" int dss_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                      const void* kv_mask, const void* dout, const void* lse,
                                      const void* di, void* dk, void* dv, int B, int T, int H,
                                      const long long* strides, float scale, void* stream) {
  const long long* s = strides;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, B, T, H, s[0], s[1], s[2], BQ) ||
      !make_map(&tk, k, B, T, H, s[3], s[4], s[5], BKV) ||
      !make_map(&tv, v, B, T, H, s[6], s[7], s[8], BKV) ||
      !make_map(&tdo, dout, B, T, H, s[9], s[10], s[11], BQ))
    return DSS_ERR_TENSOR_MAP;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BKV - 1) / BKV, H, B);
  flash_bwd_dkv_wgmma_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const uint8_t*>(kv_mask), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), s[12], s[13], s[14], s[15], s[16], s[17], T, H, scale);
  return static_cast<int>(cudaGetLastError());
}

