// Masked flash-attention forward with the row log-sum-exp for Hopper
// (sm_90a), f32, packed (B, T, H, hd) layout, on TF32 tensor cores as
// split-TF32 (3xTF32) products.
//
// Replaces: deep_spectral_tpu/models/flash_attention.py::_flash_kernel
// (launched by _flash_forward, save_residuals=True) for f32. (The bf16 build
// is flash_fwd.cu's WRITE_LSE instantiation.) Same math: non-causal
// softmax(q k^T / sqrt(hd)) v per (batch, head); keys whose kv_mask is false
// score MASK_VALUE = -0.7 * FLT_MAX and get p = 0 by a select; the online
// max m, sum l and o in f32, in natural units as the Pallas kernel keeps them;
// o = acc / l (l == 0 -> o = 0) and lse = m + log(max(l, 1e-30)), so a row
// with no valid key gets o = 0 and lse = MASK_VALUE, as the twin.
// Both products are f32-accurate: S = Q K^T and O += P V each run as three
// TF32 products of hi/lo splits (tf32.cuh: hi and lo rounded to nearest,
// ties away from zero), ~21 significant bits a product where one TF32 product
// keeps ~11. Defining DSS_F32_SINGLE_TF32 builds the single-pass control
// (tf32.cuh).
//
// What bounds it on this card: f32-accurate work costs three TF32 products,
// so its peak is 495 / 3 = 165 TFLOP/s. At the fp32 recipe's shape (B=144,
// T=197, H=6, hd=64) the two products are 8.6 GFLOP (52 us) against 175 MB
// of q/k/v/o/lse traffic (52 us at 3.35 TB/s): both sides alike. At the
// localization and SP-hop shapes (b1, T=901 to 8465) it is operations bound
// (T=8465: 110 GFLOP, 0.67 ms).
//
// What the design does about it: a persistent grid of three-warpgroup CTAs,
// one an SM (224 KB of shared memory), each walking work items (128-row q
// tile, head, batch; a head's q tiles adjacent, so neighbouring CTAs share
// K/V in L2). The hard part is that tf32 wgmma has no transposed operand:
// both shared-memory operands must be K-major, and a register A operand's
// fragment is not the accumulator's. Q K^T is K-major as TMA loads it; for
// P V, V arrives (key, hd) and must become (hd, key). So:
//   * warp 8 issues TMA loads from 4-d (hd, H, T, B) maps over the strided
//     views (the fused qkv is read in place; rows past T zero-filled), each
//     tile as two 128-byte-wide halves of hd (the widest 128B-swizzled box):
//     an item's q into one of two Q buffers, as soon as the item before
//     last has done its last S, so it lands while the previous item runs;
//     K and V tiles of 64 keys through a 2-stage ring that runs on across
//     items; and the tile's key validity (T edge, kv_mask) in 64 bits;
//   * warps 9-11 (96 threads) split each K/V stage: K in place into hi and
//     a lo tile beside it, and V, transposed, into K-major V^T hi and lo
//     tiles (the pass that transposes also splits), with the keys of each
//     8-key block permuted (k_perm) so that P's accumulator fragments are the
//     A operand as they lie; then a proxy fence and an mbarrier arrive;
//   * warpgroups 0 and 1 (64 q rows each) take their rows of q as register
//     A fragments, keep the hi parts there and write the lo parts back in
//     place, then per key tile run S = Q K^T as 24 wgmma m64n64k8 (8
//     k-steps x hi.hi and hi.lo with A from registers, lo.hi from shared
//     memory: two thirds of the shared-memory reads three products with A
//     from shared memory take), the masked online softmax on the fragments,
//     split P in registers, and O += P V^T as 24 more with P from
//     registers. The two consumer warpgroups run independently, so one's
//     softmax can overlap the other's products.
// Shared memory: two Q buffers 64 KB, each stage K hi/lo, V and V^T hi/lo 80
// KB: 224 KB.
//
// Requirements the Python wrapper checks: f32, hd == 64, unit stride on hd,
// other strides multiples of 4 elements (16 bytes, as TMA needs), 16-byte
// aligned base pointers. o is written through its strides; lse is a
// contiguous (B, H, T) f32.

#include <math.h>
#include <stdint.h>

#include "errors.cuh"
#include "tf32.cuh"

namespace {

constexpr int BQ = 128;                    // q rows per work item (64 per consumer warpgroup)
constexpr int BK = 64;                     // keys per K/V tile
constexpr int STAGES = 2;                  // K/V ring depth
constexpr int CONSUMERS = 2;               // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int SPLITTERS = 96;              // warps 9-11
constexpr int Q_BYTES = BQ * HD * 4;       // 32 KB: two 16 KB halves of hd
constexpr int T_BYTES = BK * HD * 4;       // 16 KB: a K, V or V^T tile (two 8 KB halves)
constexpr int STAGE_BYTES = 5 * T_BYTES;   // K hi, K lo, V, V^T hi, V^T lo
constexpr int SMEM_BYTES = 1024 /* alignment slack */ + 2 * Q_BYTES + STAGES * STAGE_BYTES +
                           8 * STAGES + 8 * (3 * STAGES + 4);

// S = Q K^T (64 x 64 per warpgroup), split: Q hi from registers (8 k-steps of
// A fragments), Q lo and K hi/lo from shared memory; k-step kk is 8 floats
// (32 bytes, 2 descriptor units) along hd half kk / 4 (Q's halves 16 KB
// apart, K's 8 KB).
__device__ __forceinline__ void issue_s(float (&s)[32], const float (&q_hi)[8][4],
                                        uint32_t ql_s, uint32_t k_s) {
  const uint32_t kl_s = k_s + T_BYTES;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t qo = (kk >> 2) * (Q_BYTES / 2), ko = (kk >> 2) * (T_BYTES / 2);
    const int c = 2 * (kk & 3);
    wgmma_tf32_rs(s, q_hi[kk], smem_desc(k_s + ko) + c, kk);
    wgmma_tf32_rs(s, q_hi[kk], smem_desc(kl_s + ko) + c);
    wgmma_tf32_ss(s, smem_desc(ql_s + qo) + c, smem_desc(k_s + ko) + c, 1);
  }
  wgmma_commit();
}

// O += P V: P from registers (hi, lo), V^T K-major with permuted keys; k-step
// kk is keys 8kk..8kk+7, in key half kk / 4 of the stage's V^T tiles.
__device__ __forceinline__ void issue_pv(float (&o)[32], const float (&p_hi)[8][4],
                                         const float (&p_lo)[8][4], uint32_t k_s) {
  const uint32_t vth_s = k_s + 3 * T_BYTES, vtl_s = k_s + 4 * T_BYTES;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t vo = (kk >> 2) * (T_BYTES / 2);
    const int c = 2 * (kk & 3);
    wgmma_tf32_rs(o, p_hi[kk], smem_desc(vth_s + vo) + c);
    wgmma_tf32_rs(o, p_hi[kk], smem_desc(vtl_s + vo) + c);
    wgmma_tf32_rs(o, p_lo[kk], smem_desc(vth_s + vo) + c);
  }
  wgmma_commit();
}

// One tile's online softmax in place, in natural units as the Pallas kernel:
// s[4j + e] (row g + 8 (e >> 1), key 8j + 2t + (e & 1)) goes from q.k to
// p = exp(q.k scale - m), with exp(x) as ex2(x log2 e) and the scale folded
// into one FFMA; m_run and l_run (this thread's share of the row sums)
// advance; alpha is o's factor. The tile's max is taken over the valid keys'
// raw q.k and then scaled (scale > 0: the same value as the max of the scaled
// scores), MASK_VALUE where the tile has none, as the masked scores would
// give. MASKED tiles select p = 0 for invalid keys: a select, since an
// all-masked row's -m log2 e overflows to +inf.
template <bool MASKED>
__device__ __forceinline__ void softmax_step(float (&s)[32], uint2 vb, int t, float scale,
                                             float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2]) {
  auto valid = [&](int j, int e) {
    const uint32_t w = (j >> 2) ? vb.y : vb.x;
    return ((w >> (8 * (j & 3) + 2 * t + (e & 1))) & 1u) != 0u;
  };
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!MASKED || valid(j, e)) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
  float neg_m2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_tile = mx[r] == -INFINITY ? MASK_VALUE : mx[r] * scale;
    const float m_new = fmaxf(m_run[r], m_tile);
    alpha[r] = ex2((m_run[r] - m_new) * LOG2E);  // 0 on the first tile (m_run = -inf)
    m_run[r] = m_new;
    neg_m2[r] = -m_new * LOG2E;
  }
  const float scale_log2 = scale * LOG2E;
  float rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(s[4 * j + e], scale_log2, neg_m2[e >> 1]));
      if (MASKED) p = valid(j, e) ? p : 0.f;
      s[4 * j + e] = p;
      rsum[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + rsum[r];
}

__device__ __forceinline__ void softmax_tile(float (&s)[32], uint2 vb, int t, float scale,
                                             float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2]) {
  if ((vb.x & vb.y) == 0xffffffffu)  // the same for the whole CTA
    softmax_step<false>(s, vb, t, scale, m_run, l_run, alpha);
  else
    softmax_step<true>(s, vb, t, scale, m_run, l_run, alpha);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap tq,   // boxes of BQ rows
                     const __grid_constant__ CUtensorMap tk,   // boxes of BK rows
                     const __grid_constant__ CUtensorMap tv,   // boxes of BK rows
                     const uint8_t* __restrict__ kv_mask,      // (B, T) or null
                     float* __restrict__ out, long long osb, long long ost, long long osh,
                     float* __restrict__ lse,                  // (B, H, T)
                     int B, int T, int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);  // 1024-aligned for the swizzle
  // two Q buffers (TMA lands q raw; consumers take hi into registers and leave
  // lo in place), then the K/V stages
  auto q_buf = [&](int qb) { return smem + qb * Q_BYTES; };
  auto stage = [&](int st) { return smem + 2 * Q_BYTES + st * STAGE_BYTES; };
  // per stage: K hi (TMA lands K here, split in place), K lo, V, V^T hi, V^T lo
  uint2* kvalid = reinterpret_cast<uint2*>(stage(STAGES));
  const uint32_t bars = smem_u32(kvalid + STAGES);
  auto full = [&](int s) { return bars + 8 * s; };
  auto ready = [&](int s) { return bars + 8 * (STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * STAGES + s); };
  auto qfull = [&](int qb) { return bars + 8 * (3 * STAGES + qb); };
  auto qempty = [&](int qb) { return bars + 8 * (3 * STAGES + 2 + qb); };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const int n_kv = (T + BK - 1) / BK;
  const int n_qt = (T + BQ - 1) / BQ;
  const int n_items = B * H * n_qt;  // (q tile, head, batch), q tiles of a head adjacent
  auto item = [&](int w, int& q0, int& h, int& b) {
    q0 = (w % n_qt) * BQ;
    h = (w / n_qt) % H;
    b = w / (n_qt * H);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), SPLITTERS);
      mbar_init(empty(s), CONSUMERS * 128);
    }
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(qfull(qb), 1);
      mbar_init(qempty(qb), CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (warp == CONSUMERS * 4) {
      // ------------------------------------------------------- TMA producer
      // Each item's q goes into the Q buffer its item-before-last used, once
      // that item's last S is done, so it lands while the previous item runs.
      int tile = 0, it = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
        int q0, h, b;
        item(w, q0, h, b);
        const int qb = it & 1;
        mbar_wait(qempty(qb), ((it >> 1) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(qfull(qb), Q_BYTES);
          tma_load_f32(smem_u32(q_buf(qb)), &tq, qfull(qb), 0, h, q0, b);
          tma_load_f32(smem_u32(q_buf(qb)) + Q_BYTES / 2, &tq, qfull(qb), HD / 2, h, q0, b);
        }
        for (int kt = 0; kt < n_kv; ++kt, ++tile) {
          const int st = tile % STAGES;
          mbar_wait(empty(st), ((tile / STAGES) & 1) ^ 1);
          uint32_t words[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int key = kt * BK + 32 * i + lane;
            const bool ok =
                key < T && (kv_mask == nullptr || kv_mask[(long long)b * T + key] != 0);
            words[i] = __ballot_sync(0xffffffffu, ok);
          }
          if (lane == 0) {
            kvalid[st] = make_uint2(words[0], words[1]);
            const uint32_t k_s = smem_u32(stage(st)), v_s = k_s + 2 * T_BYTES;
            mbar_arrive_expect_tx(full(st), 2 * T_BYTES);
            tma_load_f32(k_s, &tk, full(st), 0, h, kt * BK, b);
            tma_load_f32(k_s + T_BYTES / 2, &tk, full(st), HD / 2, h, kt * BK, b);
            tma_load_f32(v_s, &tv, full(st), 0, h, kt * BK, b);
            tma_load_f32(v_s + T_BYTES / 2, &tv, full(st), HD / 2, h, kt * BK, b);
          }
        }
      }
    } else {
      // ---------------------------------------------- splitters (warps 9-11)
      const int tid = threadIdx.x - (CONSUMERS * 4 + 1) * 32;
      const int tiles = n_kv * ((n_items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x);
      for (int tile = 0; tile < tiles; ++tile) {
        const int st = tile % STAGES;
        mbar_wait(full(st), (tile / STAGES) & 1);
        uint8_t* s = stage(st);
        split_tile(reinterpret_cast<float4*>(s), reinterpret_cast<float4*>(s + T_BYTES),
                   T_BYTES / 16, tid, SPLITTERS);
        transpose_split(s + 2 * T_BYTES, s + 3 * T_BYTES, s + 4 * T_BYTES, tid >> 5,
                        SPLITTERS / 32, lane);
        fence_async_shared();
        mbar_arrive(ready(st));
      }
    }
  } else {
    // --------------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int g = lane >> 2;  // fragment row within the warp's 16
    const int t = lane & 3;   // thread in the row's quad
    int tile = 0, it = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
      int q0, h, b;
      item(w, q0, h, b);
      const int qb = it & 1;
      // Q: this thread's A fragments (rows g, g + 8 of the warp's 16; hd
      // columns t and t + 4 of each 8-block) split into hi, kept in
      // registers, and lo, written back in place for the lo.hi product. Q's
      // hd halves are 16 KB apart, this warpgroup's 64 rows 8 KB into each.
      mbar_wait(qfull(qb), (it >> 1) & 1);
      uint8_t* qw = q_buf(qb) + wg * (Q_BYTES / 4);
      float q_hi[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = (warp & 3) * 16 + g + 8 * (i & 1);
          const int col = 8 * (kk & 3) + t + 4 * (i >> 1);
          float* x = reinterpret_cast<float*>(qw + (kk >> 2) * (Q_BYTES / 2) + swz(row, col * 4));
          float lo;
          split_tf32(*x, q_hi[kk][i], lo);
          *x = lo;
        }
      fence_async_shared();
      warpgroup_sync(wg);
      const uint32_t ql_s = smem_u32(qw);

      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
      float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums
      // One key tile a round: S, the softmax, P V, then the stage goes back to
      // the producer. (Issuing S(kt) with P(kt-1) V(kt-1), as the bf16 build
      // does, would hold two stages a round, and a third stage does not fit.)
      float s[32], alpha[2];
      float p_hi[8][4], p_lo[8][4];
      for (int kt = 0; kt < n_kv; ++kt, ++tile) {
        const int st = tile % STAGES;
        const uint32_t k_s = smem_u32(stage(st));
        mbar_wait(ready(st), (tile / STAGES) & 1);
        wgmma_fence();
        issue_s(s, q_hi, ql_s, k_s);
        wgmma_wait<0>();
        if (kt == n_kv - 1) mbar_arrive(qempty(qb));  // this item's Q is used up
        softmax_tile(s, kvalid[st], t, scale, m_run, l_run, alpha);
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
        split_a(s, p_hi, p_lo);
        wgmma_fence();
        issue_pv(o, p_hi, p_lo, k_s);
        wgmma_wait<0>();
        mbar_arrive(empty(st));
      }

      // o[4j + 2r + c]: row g + 8r, hd column 8j + 2t + c.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = l == 0.f ? 1.f : 1.f / l;
        const int row = q0 + wg * 64 + (warp & 3) * 16 + g + 8 * r;
        if (row >= T) continue;
        if (t == 0) lse[((long long)b * H + h) * T + row] = m_run[r] + logf(fmaxf(l, 1e-30f));
        float* orow = out + b * osb + row * ost + h * osh;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
              make_float2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// Persistent grid: one CTA an SM (224 KB of shared memory each), or one an
// item when there are fewer.
int grid_size(int B, int T, int H) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int items = B * H * ((T + BQ - 1) / BQ);
  return items < sms ? items : sms;
}

}  // namespace

// `strides` is a host array of (batch, token, head) element strides, three
// per tensor, in the order q, k, v, o; lse is a contiguous (B, H, T) f32.
extern "C" int dss_flash_fwd_lse_f32(const void* q, const void* k, const void* v,
                                     const void* kv_mask, void* o, void* lse, int B, int T,
                                     int H, const long long* strides, float scale,
                                     void* stream) {
  const long long* s = strides;
  CUtensorMap tq, tk, tv;
  if (!make_map_f32(&tq, q, B, T, H, s[0], s[1], s[2], BQ) ||
      !make_map_f32(&tk, k, B, T, H, s[3], s[4], s[5], BK) ||
      !make_map_f32(&tv, v, B, T, H, s[6], s[7], s[8], BK))
    return DSS_ERR_TENSOR_MAP;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_f32_kernel<<<grid_size(B, T, H), THREADS, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<const uint8_t*>(kv_mask), static_cast<float*>(o), s[9], s[10],
      s[11], static_cast<float*>(lse), B, T, H, scale);
  return static_cast<int>(cudaGetLastError());
}
