// dQ of masked flash attention for Hopper (sm_90a), f32, packed (B, T, H, hd)
// layout, on TF32 tensor cores as split-TF32 (3xTF32) products, q rows on
// the M side.
//
// Replaces: deep_spectral_tpu/models/flash_attention.py::_flash_bwd_dq_kernel
// (launched by _flash_backward) for f32. (The bf16 build is
// flash_bwd_dq.cu.) Same math, per (batch, head) and q tile, summed over key
// tiles, with s = q k^T * scale and the saved lse and di = rowsum(o do):
//   p  = select(key valid, exp(s - lse), 0)   (a select: keys past T come in
//                                               zero-filled, and an
//                                               all-masked row's lse is
//                                               MASK_VALUE, so exp(s - lse)
//                                               is not 0 there)
//   ds = p * (do v^T - di),   dq = scale * sum ds k.
// p, dp and ds stay f32, as in the Pallas kernel, and every product is
// f32-accurate: three TF32 products of hi/lo splits (tf32.cuh: hi and lo
// rounded to nearest, ties away from zero). The mask is on keys only: masked
// query rows still get their dq, and a batch row with no valid key comes
// out exactly 0. Defining DSS_F32_SINGLE_TF32 builds the single-pass control
// (tf32.cuh).
//
// What bounds it on this card: at the fp32 recipe's shape (B=144, T=197,
// H=6, hd=64) the three T x T x 64 products are 12.9 GFLOP over the valid
// keys, 78 us at the split-TF32 peak (495 / 3 = 165 TFLOP/s), against 219 MB
// of q/k/v/do/dq and lse/di traffic (65 us at 3.35 TB/s): operations bound.
//
// What the design does about it: flash_bwd_dkv_f32.cu with the roles of q
// and keys swapped, and the forward's (flash_fwd_f32.cu) register-A Q. One
// CTA per (128-row q tile, head, batch), 2 x 6 x 144 = 1728 CTAs at the
// recipe's shape, of three warpgroups. S = Q K^T and dP = dO V^T contract
// over hd, and Q, dO, K and V are all K-major for that as TMA loads them, so
// both run on wgmma; dQ += dS K contracts over keys, K's row index, which
// tf32 wgmma (no transposed operand) cannot take without a transposed K
// hi/lo copy, so it runs on mma.sync m16n8k8 with K's B fragments loaded by
// hand from the row-major tiles (mma_acc):
//   * warp 8 loads Q and dO (128 rows) once and streams K and V tiles of 32
//     keys through a 2-stage ring by TMA, from 4-d (hd, H, T, B) maps over
//     the strided views (the fused qkv is read in place; rows past T
//     zero-filled), each tile as two 128-byte-wide halves of hd; its lanes
//     test each key of the tile (key < T and kv_mask) into a 32-bit word
//     beside it;
//   * warps 9-11 (96 threads) split each K and V tile in place into hi, with
//     lo tiles beside them, then a proxy fence and an arrive;
//   * warpgroups 0 and 1 (64 q rows each) take their rows of Q and dO as
//     register A fragments while the splitters split the first stage, keep
//     the hi parts there and write the lo parts back in place, and hold
//     their rows' lse and di in registers; then per key tile they run S and
//     dP as wgmma m64n32k8 (8 k-steps over hd x hi.hi and hi.lo with A from
//     registers, lo.hi from shared memory: at n32 an A read from shared
//     memory is 2 KB per 1 KB of B, so a k-step's three products read 5 KB
//     where they would read 9), P and dS on the accumulator fragments,
//     which are mma.sync's A fragments as they lie once the key order of
//     each 8-block is permuted (k_perm) in the B loads, and dQ += dS K on
//     mma.sync (4 k-steps over keys x 8 hd blocks x 3). A key tile with no
//     valid key adds nothing (every p is 0) and is skipped.
// Shared memory: Q and dO lo 64 KB, each stage K and V hi/lo 32 KB. Stages
// of 64 keys (wgmma m64n64k8) fit too, but pad the recipe's T=197 to 256
// keys, where 32-key stages pad it to 224; tried, they were faster at long
// T only, and a third stage of 32 was no faster at all.
//
// Requirements the Python wrapper checks: f32, hd == 64, unit stride on q,
// k, v and do's hd, their other strides multiples of 4 elements (16 bytes,
// as TMA needs), 16-byte aligned base pointers; lse and di contiguous
// (B, H, T) f32. dq is written through its strides with scalar stores, so it
// may be any view with unit stride on hd.

#include <math.h>
#include <stdint.h>

#include "errors.cuh"
#include "tf32.cuh"

namespace {

constexpr int BQ = 128;                    // q rows per CTA (64 per consumer warpgroup)
constexpr int BK = 32;                     // keys per streamed K/V tile
constexpr int STAGES = 2;                  // K/V ring depth
constexpr int CONSUMERS = 2;               // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int SPLITTERS = 96;              // warps 9-11
constexpr int Q_BYTES = BQ * HD * 4;       // 32 KB: two 16 KB halves of hd
constexpr int K_BYTES = BK * HD * 4;       // 8 KB: two 4 KB halves of hd
constexpr int STAGE_BYTES = 4 * K_BYTES;   // K hi, K lo, V hi, V lo
static_assert(K_BYTES / 2 == X_HALF, "mma_acc reads K tiles of 32 rows");
constexpr int SMEM_BYTES = 1024 /* alignment slack */ + 2 * Q_BYTES + STAGES * STAGE_BYTES +
                           8 * STAGES /* key words */ + 8 * (3 * STAGES + 1);

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap tq,   // boxes of BQ rows
                        const __grid_constant__ CUtensorMap tk,   // boxes of BK rows
                        const __grid_constant__ CUtensorMap tv,   // boxes of BK rows
                        const __grid_constant__ CUtensorMap tdo,  // boxes of BQ rows
                        const uint8_t* __restrict__ kv_mask,      // (B, T) or null
                        const float* __restrict__ lse,            // (B, H, T)
                        const float* __restrict__ di,             // (B, H, T)
                        float* __restrict__ dq, long long dqsb, long long dqst,
                        long long dqsh, int T, int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);  // 1024-aligned for the swizzle
  // Q and dO (TMA lands them raw; consumers take hi into registers and leave
  // lo in place)
  uint8_t* q_s = smem;
  uint8_t* do_s = smem + Q_BYTES;
  // per stage: K hi, K lo, V hi, V lo
  auto stage = [&](int st) { return smem + 2 * Q_BYTES + st * STAGE_BYTES; };
  uint32_t* kvalid = reinterpret_cast<uint32_t*>(stage(STAGES));  // 2 words a stage, 1 used
  const uint32_t bars = smem_u32(kvalid + 2 * STAGES);
  auto full = [&](int s) { return bars + 8 * s; };
  auto ready = [&](int s) { return bars + 8 * (STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * STAGES + s); };
  const uint32_t qfull = bars + 24 * STAGES;

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
      mbar_init(ready(s), SPLITTERS);
      mbar_init(empty(s), CONSUMERS * 128);
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == CONSUMERS * 4) {
      // ------------------------------------------------------- TMA producer
      if (lane == 0) {
        mbar_arrive_expect_tx(qfull, 2 * Q_BYTES);
        tma_load_f32(smem_u32(q_s), &tq, qfull, 0, h, q0, b);
        tma_load_f32(smem_u32(q_s) + Q_BYTES / 2, &tq, qfull, HD / 2, h, q0, b);
        tma_load_f32(smem_u32(do_s), &tdo, qfull, 0, h, q0, b);
        tma_load_f32(smem_u32(do_s) + Q_BYTES / 2, &tdo, qfull, HD / 2, h, q0, b);
      }
      for (int kt = 0; kt < n_kv; ++kt) {
        const int st = kt % STAGES;
        mbar_wait(empty(st), ((kt / STAGES) & 1) ^ 1);
        const int key = kt * BK + lane;
        const bool ok = key < T && (kv_mask == nullptr || kv_mask[(long long)b * T + key] != 0);
        const uint32_t word = __ballot_sync(0xffffffffu, ok);
        if (lane == 0) {
          kvalid[2 * st] = word;
          const uint32_t k_s = smem_u32(stage(st)), v_s = k_s + 2 * K_BYTES;
          mbar_arrive_expect_tx(full(st), 2 * K_BYTES);
          tma_load_f32(k_s, &tk, full(st), 0, h, kt * BK, b);
          tma_load_f32(k_s + K_BYTES / 2, &tk, full(st), HD / 2, h, kt * BK, b);
          tma_load_f32(v_s, &tv, full(st), 0, h, kt * BK, b);
          tma_load_f32(v_s + K_BYTES / 2, &tv, full(st), HD / 2, h, kt * BK, b);
        }
      }
    } else {
      // ---------------------------------------------- splitters (warps 9-11)
      const int tid = threadIdx.x - (CONSUMERS * 4 + 1) * 32;
      for (int kt = 0; kt < n_kv; ++kt) {
        const int st = kt % STAGES;
        mbar_wait(full(st), (kt / STAGES) & 1);
        uint8_t* s = stage(st);
        split_tile(reinterpret_cast<float4*>(s), reinterpret_cast<float4*>(s + K_BYTES),
                   K_BYTES / 16, tid, SPLITTERS);
        split_tile(reinterpret_cast<float4*>(s + 2 * K_BYTES),
                   reinterpret_cast<float4*>(s + 3 * K_BYTES), K_BYTES / 16, tid, SPLITTERS);
        fence_async_shared();
        mbar_arrive(ready(st));
      }
    }
  } else {
    // --------------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int g = lane >> 2;  // fragment row within the warp's 16
    const int t = lane & 3;   // thread in the row's quad
    float lse_r[2], di_r[2];  // this thread's q rows: fragment rows g and g + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wg * 64 + (warp & 3) * 16 + g + 8 * r;
      const long long off = ((long long)b * H + h) * T + row;
      lse_r[r] = row < T ? lse[off] : 0.f;
      di_r[r] = row < T ? di[off] : 0.f;
    }
    // Q and dO: this thread's A fragments (rows g, g + 8 of the warp's 16; hd
    // columns t and t + 4 of each 8-block) split into hi, kept in registers,
    // and lo, written back in place for the lo.hi products. The hd halves
    // are 16 KB apart, this warpgroup's 64 rows 8 KB into each.
    mbar_wait(qfull, 0);
    float q_hi[8][4], do_hi[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = (warp & 3) * 16 + g + 8 * (i & 1);
        const int col = 8 * (kk & 3) + t + 4 * (i >> 1);
        const int off = wg * (Q_BYTES / 4) + (kk >> 2) * (Q_BYTES / 2) + swz(row, col * 4);
        float* x = reinterpret_cast<float*>(q_s + off);
        float* y = reinterpret_cast<float*>(do_s + off);
        float lo;
        split_tf32(*x, q_hi[kk][i], lo);
        *x = lo;
        split_tf32(*y, do_hi[kk][i], lo);
        *y = lo;
      }
    fence_async_shared();
    warpgroup_sync(wg);
    float dq_acc[32];  // [4j + e]: q row g + 8 (e >> 1), hd 8j + 2t + (e & 1)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
    const uint32_t ql_s = smem_u32(q_s) + wg * (Q_BYTES / 4);
    const uint32_t dol_s = smem_u32(do_s) + wg * (Q_BYTES / 4);

    for (int kt = 0; kt < n_kv; ++kt) {
      const int st = kt % STAGES;
      mbar_wait(ready(st), (kt / STAGES) & 1);
      const uint32_t word = kvalid[2 * st];  // the same for the whole CTA
      if (word != 0u) {
        const uint8_t* s_ptr = stage(st);
        const uint32_t kh_s = smem_u32(s_ptr), kl_s = kh_s + K_BYTES;
        const uint32_t vh_s = kh_s + 2 * K_BYTES, vl_s = kh_s + 3 * K_BYTES;

        // S = Q K^T and dP = dO V^T, hi parts from registers: k-step kk is 8
        // floats (32 bytes, 2 descriptor units) along hd half kk / 4.
        float s[16], dp[16];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint32_t qo = (kk >> 2) * (Q_BYTES / 2), ko = (kk >> 2) * (K_BYTES / 2);
          const int c = 2 * (kk & 3);
          wgmma_tf32_rs_n32(s, q_hi[kk], smem_desc(kh_s + ko) + c, kk);
          wgmma_tf32_rs_n32(s, q_hi[kk], smem_desc(kl_s + ko) + c);
          wgmma_tf32_n32(s, smem_desc(ql_s + qo) + c, smem_desc(kh_s + ko) + c, 1);
        }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint32_t qo = (kk >> 2) * (Q_BYTES / 2), ko = (kk >> 2) * (K_BYTES / 2);
          const int c = 2 * (kk & 3);
          wgmma_tf32_rs_n32(dp, do_hi[kk], smem_desc(vh_s + ko) + c, kk);
          wgmma_tf32_rs_n32(dp, do_hi[kk], smem_desc(vl_s + ko) + c);
          wgmma_tf32_n32(dp, smem_desc(dol_s + qo) + c, smem_desc(vh_s + ko) + c, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();

        // s[4j + e]: q row g + 8 (e >> 1), key 8j + 2t + (e & 1); dS in dp.
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = (word >> (8 * j + 2 * t + (e & 1))) & 1u;
            const float p = ok ? __expf(s[4 * j + e] * scale - lse_r[e >> 1]) : 0.f;
            dp[4 * j + e] = p * (dp[4 * j + e] - di_r[e >> 1]);
          }
        // dQ += dS K on mma.sync, each warp its 16 q rows.
        float a_hi[4][4], a_lo[4][4];
        split_a16(dp, a_hi, a_lo);
        mma_acc(dq_acc, a_hi, a_lo, s_ptr, s_ptr + K_BYTES, g, t);
      }
      mbar_arrive(empty(st));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wg * 64 + (warp & 3) * 16 + g + 8 * r;
      if (row >= T) continue;
      float* qrow = dq + b * dqsb + row * dqst + h * dqsh;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qrow[8 * j + 2 * t] = dq_acc[4 * j + 2 * r] * scale;
        qrow[8 * j + 2 * t + 1] = dq_acc[4 * j + 2 * r + 1] * scale;
      }
    }
  }
}

}  // namespace

// Entry point. `strides` is a host array of (batch, token, head) element
// strides, three per tensor, in the order q, k, v, do, dq; lse and di are
// contiguous (B, H, T) f32.
extern "C" int dss_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                    const void* kv_mask, const void* dout, const void* lse,
                                    const void* di, void* dq, int B, int T, int H,
                                    const long long* strides, float scale, void* stream) {
  const long long* s = strides;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map_f32(&tq, q, B, T, H, s[0], s[1], s[2], BQ) ||
      !make_map_f32(&tk, k, B, T, H, s[3], s[4], s[5], BK) ||
      !make_map_f32(&tv, v, B, T, H, s[6], s[7], s[8], BK) ||
      !make_map_f32(&tdo, dout, B, T, H, s[9], s[10], s[11], BQ))
    return DSS_ERR_TENSOR_MAP;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_bwd_dq_f32_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const uint8_t*>(kv_mask), static_cast<const float*>(lse),
      static_cast<const float*>(di), static_cast<float*>(dq), s[12], s[13], s[14], T, H,
      scale);
  return static_cast<int>(cudaGetLastError());
}

