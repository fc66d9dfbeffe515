// Masked flash-attention forward for Hopper (sm_90a), packed (B, T, H, hd) layout.
//
// Replaces: deep_spectral_tpu/models/flash_attention.py::_flash_kernel_packed
// (launched by _flash_forward_packed). Same math: non-causal
// softmax(q k^T / sqrt(hd)) v per (batch, head); keys whose kv_mask is false
// score MASK_VALUE = -0.7 * FLT_MAX and get p = 0 by a select; online-softmax
// statistics in f32; p is rounded to bf16 at the running max before the P.V
// product; a row whose keys are all masked outputs 0 (l == 0 -> 1/l taken as 1).
//
// What bounds it on this card: at the main path's shape (B=24, T=901, H=6,
// hd=64) the two products are 4 T^2 hd flops per (b, h), 2.99e10 in all, 30 us
// at the bf16 tensor-core peak, against 66 MB of q/k/v/out traffic (20 us at
// 3.35 TB/s): compute bound. At hd=64 the exponentials (T^2 per (b, h), 117 M)
// cost the SFUs about as long as the products cost the tensor cores.
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
// Requirements the Python wrapper checks: bf16, hd == 64, unit stride on hd,
// other strides multiples of 8 elements (16 bytes, as TMA needs), 16-byte
// aligned base pointers. out is contiguous (B, T, H, 64).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "errors.cuh"

namespace {

constexpr int HD = 64;                    // head dim: one 128-byte row per token
constexpr int BQ = 128;                   // q rows per CTA (64 per consumer warpgroup)
constexpr int BK = 128;                   // keys per K/V tile
constexpr int STAGES = 3;                 // K/V ring depth
constexpr int CONSUMERS = 2;              // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int TILE_BYTES = BK * HD * 2;   // 16 KB, also the q tile's size
constexpr int SMEM_BYTES = 1024 /* alignment slack */ + TILE_BYTES * (1 + 2 * STAGES) +
                           16 * STAGES + 8 * (2 * STAGES + 1);
constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// One box of the 4-d map (hd, H, T, B) at (0, h, t0, b) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int h, int t0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(0), "r"(h), "r"(t0), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled tile whose 8-row groups
// are 1024 bytes apart: start address, both byte offsets (1024; the one that
// is not the 8-row stride is unused at these shapes) and the 128B layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64 x 128, f32) (+)= A(64 x 16) B(16 x 128): A and B K-major in 128B-swizzled
// shared memory; scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64 x 64, f32) += A(64 x 16, registers) B(16 x 64): B MN-major (transposed)
// in 128B-swizzled shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The consumer warpgroups take turns issuing their products (named barriers
// 1 and 2, 256 threads: one warpgroup syncs, the other arrives), so one's
// softmax runs while the other's wgmmas hold the tensor cores.
__device__ __forceinline__ void sched_sync(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void sched_arrive(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(1 + wg) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// S = Q K^T, 64 x 128 per warpgroup: k-steps of 16 over hd are 32 bytes
// along the swizzled rows (2 descriptor units).
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16_ss(s, dq + 2 * kk, dk + 2 * kk, kk);
  wgmma_commit();
}

// O += P V: V's tile is [key][hd], hd contiguous, i.e. the MN-major B operand;
// a k-step of 16 keys is 16 rows of 128 bytes (128 descriptor units).
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pa)[8][4], uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_m64n64k16_rs(o, pa[kk], dv + 128 * kk);
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

__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_packed_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const uint8_t* __restrict__ kv_mask,  // (B, T) or null
                        __nv_bfloat16* __restrict__ out,      // (B, T, H, HD)
                        int T, int H, float scale_log2) {
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
        tma_load(q_s, &tq, qbar, h, q0, b);
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
          tma_load(k_s + st * TILE_BYTES, &tk, full(st), h, kt * BK, b);
          tma_load(v_s + st * TILE_BYTES, &tv, full(st), h, kt * BK, b);
        }
      }
    }
  } else {
    // --------------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int g = lane >> 2;  // fragment row within the warp's 16
    const int t = lane & 3;   // thread in the row's quad
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
    float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

    mbar_wait(qbar, 0);
    if (wg == 1) sched_arrive(0);  // warpgroup 0 issues first
    const uint64_t dq = smem_desc(q_s + wg * (TILE_BYTES / 2));
    float s[64];
    uint32_t pa[8][4];

    // Tile 0: S only. Every later round issues S(kt) and P(kt-1) V(kt-1)
    // together and runs tile kt's softmax while the P.V product runs.
    mbar_wait(full(0), 0);
    sched_sync(wg);
    wgmma_fence();
    issue_qk(s, dq, smem_desc(k_s));
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
      issue_qk(s, dq, smem_desc(k_s + st * TILE_BYTES));
      issue_pv(o, pa, smem_desc(v_s + prev * TILE_BYTES));
      sched_arrive(1 - wg);
      wgmma_wait<1>();  // S(kt) is in; P(kt-1) V(kt-1) may still run
      softmax_tile(s, kvalid[st], t, scale_log2, m_run, l_run, alpha);
      wgmma_wait<0>();
      mbar_arrive(empty(prev));
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p(s, pa);
    }

    const int last = (n_kv - 1) % STAGES;
    sched_sync(wg);
    wgmma_fence();
    issue_pv(o, pa, smem_desc(v_s + last * TILE_BYTES));
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
      __nv_bfloat16* orow = out + (((long long)b * T + row) * H + h) * HD;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (hd, H, T, B) view of one of q/k/v with its element strides, in boxes
// of (64, 1, 128, 1), 128B-swizzled, zero-filled out of range.
bool make_map(CUtensorMap* map, const void* base, int B, int T, int H, long long sb,
              long long st, long long sh) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {HD, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {HD, 1, BK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Launch geometry: grid (x, y, z), threads per CTA, dynamic shared bytes.
extern "C" int dss_flash_fwd_packed_shape(int B, int T, int H, int* shape5) {
  shape5[0] = (T + BQ - 1) / BQ;
  shape5[1] = H;
  shape5[2] = B;
  shape5[3] = THREADS;
  shape5[4] = SMEM_BYTES;
  return 0;
}

extern "C" int dss_flash_fwd_packed(const void* q, const void* k, const void* v,
                                    const void* kv_mask, void* out,
                                    int B, int T, int H,
                                    long long qsb, long long qst, long long qsh,
                                    long long ksb, long long kst, long long ksh,
                                    long long vsb, long long vst, long long vsh,
                                    float sm_scale, void* stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, T, H, qsb, qst, qsh) || !make_map(&tk, k, B, T, H, ksb, kst, ksh) ||
      !make_map(&tv, v, B, T, H, vsb, vst, vsh))
    return DSS_ERR_TENSOR_MAP;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_packed_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<const uint8_t*>(kv_mask), static_cast<__nv_bfloat16*>(out), T, H,
      sm_scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}
