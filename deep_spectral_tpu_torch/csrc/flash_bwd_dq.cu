// dQ of masked flash attention for Hopper (sm_90a), bf16, packed (B, T, H, hd)
// layout, on wgmma with q rows on the M side.
//
// Replaces: deep_spectral_tpu/models/flash_attention.py::_flash_bwd_dq_kernel
// (launched by _flash_backward) for bf16. (The f32 build is
// flash_bwd_dq_f32.cu.) Same math, per (batch, head) and q tile, summed over
// key tiles, with s = q k^T * scale and the saved lse and di = rowsum(o do):
//   p  = select(key valid, exp(s - lse), 0)   (a select: exp(s - lse) may be
//                                               inf on masked keys)
//   ds = p * (do v^T - di),   dq = scale * sum ds k.
// p, dp and ds stay f32, as in the Pallas kernel (which casts k to f32): ds
// enters the tensor cores as a bf16 hi/lo pair (hi = bf16(x), lo = bf16(x -
// hi), two products against the same bf16 K), which carries ~16 significant
// bits of ds into the f32 accumulator; K is exact in bf16. A single bf16
// rounding of ds would be a different kernel (tests/test_torch_flash.py prints
// its error). Defining DSS_DQ_SINGLE_ROUNDING builds that kernel (the lo
// products left out), the control behind chip_smoke.py's DQ_SHARE_MAX
// (README); the port's build never defines it.
// The mask is on keys only: masked query rows still get their dq, and a batch
// row with no valid key comes out exactly 0 (every p is selected to 0).
//
// What bounds it on this card: at the train shape (B=144, T=197, H=6, hd=64)
// the three T x T x 64 products are 12.9 GFLOP over the valid keys, 13 us at
// the bf16 tensor-core peak, against 110 MB of q/k/v/do/dq and lse/di traffic
// (33 us at 3.35 TB/s): bytes bound on paper, but T=197 pads to two q tiles
// of 128 and four key tiles of 64 (1.7x the needed products), the hi/lo pair
// makes four products of three, and p needs T^2 exponentials per (b, h) on
// the SFUs, so the products and exponentials come close to the bytes' time.
//
// What the design does about it: one CTA per (128-row q tile, head, batch),
// 2 x 6 x 144 = 1728 CTAs at the train shape, of three warpgroups: the dKV
// kernel's template (flash_bwd_dkv.cu) in the forward's orientation.
// Warpgroup 2 is the producer: one thread loads the CTA's Q and dO tiles once
// by TMA and streams K and V tiles of 64 keys through a 3-stage ring, from the
// same 4-d (hd, H, T, B) tensor maps over strided views as the forward (the
// fused qkv is read in place; rows past T are zero-filled). The producer
// warp's lanes also test each key of the tile (key < T and kv_mask), and lane
// 0 stores the 64 flags beside the tile before it arrives on the stage's
// barrier. Warpgroups 0 and 1 (64 q rows each, registers raised with
// setmaxnreg) hold their two rows' lse (times log2 e) and di in registers,
// loaded once, and run per key tile:
//   S = Q K^T and dP = dO V^T as wgmma m64n64k16, both operands K-major in
//     128B-swizzled shared memory (the forward's S);
//   P = select(key valid, exp2(S scale log2 e - lse log2 e), 0) and
//     dS = P (dP - di) on the accumulator fragments (the key mask per
//     fragment column, lse and di per row);
//   dQ += dS K as wgmma m64n64k16 with A from registers (dS split into
//     hi/lo and re-packed in place, as the forward packs P) and K as the
//     transposed (MN-major) B operand, as the forward reads V, so nothing
//     is transposed by hand.
// The epilogue scales dQ, rounds once to bf16 and writes dq through its
// strides, e.g. straight into the (B, T, 3, H, hd) gradient of the fused
// projection; no row past T is written.
//
// Requirements the Python wrapper checks: bf16, hd == 64, unit stride on hd,
// other strides multiples of 8 elements (16 bytes, as TMA needs), 16-byte
// aligned base pointers; lse and di contiguous (B, H, T) f32.

#include <math.h>
#include <stdint.h>

#include "errors.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 128;                    // q rows per CTA (64 per consumer warpgroup)
constexpr int BK = 64;                     // keys per streamed K/V tile
constexpr int STAGES = 3;                  // K/V ring depth
constexpr int CONSUMERS = 2;               // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int Q_BYTES = BQ * HD * 2;       // 16 KB
constexpr int KV_BYTES = BK * HD * 2;      // 8 KB
constexpr int SMEM_BYTES = 1024 /* alignment slack */ + 2 * Q_BYTES +
                           STAGES * (2 * KV_BYTES + 8) + 8 * (2 * STAGES + 1);

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,   // boxes of BQ rows
                          const __grid_constant__ CUtensorMap tk,   // boxes of BK rows
                          const __grid_constant__ CUtensorMap tv,   // boxes of BK rows
                          const __grid_constant__ CUtensorMap tdo,  // boxes of BQ rows
                          const uint8_t* __restrict__ kv_mask,      // (B, T) or null
                          const float* __restrict__ lse,            // (B, H, T)
                          const float* __restrict__ di,             // (B, H, T)
                          __nv_bfloat16* __restrict__ dq,
                          long long dqsb, long long dqst, long long dqsh,
                          int T, int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);  // 1024-aligned for the swizzle
  const uint32_t q_s = smem_u32(smem);
  const uint32_t do_s = q_s + Q_BYTES;
  auto k_s = [&](int st) { return do_s + Q_BYTES + st * 2 * KV_BYTES; };
  auto v_s = [&](int st) { return k_s(st) + KV_BYTES; };
  uint2* kvalid = reinterpret_cast<uint2*>(smem + 2 * Q_BYTES + STAGES * 2 * KV_BYTES);
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
        mbar_arrive_expect_tx(qbar, 2 * Q_BYTES);
        tma_load(q_s, &tq, qbar, h, q0, b);
        tma_load(do_s, &tdo, qbar, h, q0, b);
      }
      for (int kt = 0; kt < n_kv; ++kt) {
        const int st = kt % STAGES;
        mbar_wait(empty(st), ((kt / STAGES) & 1) ^ 1);
        uint32_t words[2];
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int key = kt * BK + 32 * w + lane;
          const bool ok = key < T && (kv_mask == nullptr || kv_mask[(long long)b * T + key] != 0);
          words[w] = __ballot_sync(0xffffffffu, ok);
        }
        if (lane == 0) {
          kvalid[st] = make_uint2(words[0], words[1]);
          mbar_arrive_expect_tx(full(st), 2 * KV_BYTES);
          tma_load(k_s(st), &tk, full(st), h, kt * BK, b);
          tma_load(v_s(st), &tv, full(st), h, kt * BK, b);
        }
      }
    }
  } else {
    // --------------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int g = lane >> 2;  // fragment row within the warp's 16
    const int t = lane & 3;   // thread in the row's quad
    const float scale_log2 = scale * LOG2E;
    float lse2[2], di_r[2];   // this thread's q rows: fragment rows g and g + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wg * 64 + (warp & 3) * 16 + g + 8 * r;
      const long long at = ((long long)b * H + h) * T + row;
      lse2[r] = row < T ? lse[at] * LOG2E : 0.f;
      di_r[r] = row < T ? di[at] : 0.f;
    }
    float dq_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
    mbar_wait(qbar, 0);
    const uint64_t desc_q = smem_desc(q_s + wg * (Q_BYTES / 2));
    const uint64_t desc_do = smem_desc(do_s + wg * (Q_BYTES / 2));

    for (int kt = 0; kt < n_kv; ++kt) {
      const int st = kt % STAGES;
      mbar_wait(full(st), (kt / STAGES) & 1);
      const uint64_t desc_k = smem_desc(k_s(st));
      const uint64_t desc_v = smem_desc(v_s(st));
      // S = Q K^T and dP = dO V^T: k-steps of 16 over hd are 32 bytes along
      // the swizzled rows (2 descriptor units).
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss(s, desc_q + 2 * kk, desc_k + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss(dp, desc_do + 2 * kk, desc_v + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();

      // s[4j + e]: q row g + 8 (e >> 1), key column 8j + 2t + (e & 1).
      const uint2 vb = kvalid[st];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t word = j < 4 ? vb.x : vb.y;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = ((word >> (8 * (j & 3) + 2 * t + (e & 1))) & 1u) != 0u;
          const float p = ex2(fmaf(s[4 * j + e], scale_log2, -lse2[e >> 1]));
          dp[4 * j + e] = ok ? p * (dp[4 * j + e] - di_r[e >> 1]) : 0.f;
        }
      }
      uint32_t ds_hi[4][4], ds_lo[4][4];
      split_hi_lo(dp, ds_hi, ds_lo);

      // dQ += dS K: the K tile is [key][hd], hd contiguous, i.e. the MN-major
      // B operand; a k-step of 16 keys is 16 rows of 128 bytes (128
      // descriptor units).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n64k16_rs(dq_acc, ds_hi[kk], desc_k + 128 * kk);
#ifndef DSS_DQ_SINGLE_ROUNDING
        wgmma_m64n64k16_rs(dq_acc, ds_lo[kk], desc_k + 128 * kk);
#endif
      }
      wgmma_commit();
      wgmma_wait<0>();
      mbar_arrive(empty(st));
    }

    // dq_acc[4j + 2r + c]: q row g + 8r, hd column 8j + 2t + c.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wg * 64 + (warp & 3) * 16 + g + 8 * r;
      if (row >= T) continue;
      __nv_bfloat16* qrow = dq + b * dqsb + row * dqst + h * dqsh;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * j + 2 * t) =
            __floats2bfloat162_rn(dq_acc[4 * j + 2 * r] * scale, dq_acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

}  // namespace

// Entry point. `strides` is a host array of (batch, token, head) element
// strides, three per tensor, in the order q, k, v, do, dq; lse and di are
// contiguous (B, H, T) f32.
extern "C" int dss_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* kv_mask, const void* dout, const void* lse,
                                     const void* di, void* dq, int B, int T, int H,
                                     const long long* strides, float scale, void* stream) {
  const long long* s = strides;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, B, T, H, s[0], s[1], s[2], BQ) ||
      !make_map(&tk, k, B, T, H, s[3], s[4], s[5], BK) ||
      !make_map(&tv, v, B, T, H, s[6], s[7], s[8], BK) ||
      !make_map(&tdo, dout, B, T, H, s[9], s[10], s[11], BQ))
    return DSS_ERR_TENSOR_MAP;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_bwd_dq_wgmma_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const uint8_t*>(kv_mask), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<__nv_bfloat16*>(dq), s[12], s[13], s[14], T, H,
      scale);
  return static_cast<int>(cudaGetLastError());
}

