// Chebyshev filter chain for Hopper (sm_90a), one launch per chain:
// T_degree(((I - S) - c) / e) X, batched over images.
//
// Replaces: deep_spectral_tpu/ops/cheb_filter.py::_cheb_kernel (launched by
// chebyshev_filter). Same arithmetic as the Pallas form:
//   a_shift(t) = ((1 - c) t - S bf16(t)) * (1 / e)     (f32 accumulation)
//   T_0 = X, T_1 = a_shift(X),
//   T_{j+1} = 2 a_shift(T_j) - T_{j-1}, then (T_j, T_{j+1}) of each column are
//   both scaled by 1 / max(max_i |T_{j+1}[i]|, 1), in f32, before T_{j+1} is
//   rounded to bf16 for the next product (NaN propagates as jnp.maximum).
// Only the order of the sums differs from the Pallas kernel and the twin.
//
// What bounds it on this card: each step multiplies the (N, N) bf16 operator
// by a thin (N, 8) block, 16 flops per operator element, so the work is
// reading S (1.62 MB an image at N=900, 25.9 MB at N=3600). The TPU kernel
// keeps S in VMEM and reads it once per chain; the least time here is S read
// once from HBM (3.35 TB/s), plus X in and the result out.
//
// What the design does about it (two builds, chosen by the caller's plan,
// ops/cheb_filter.py::cheb_filter_plan, from (B, N, m) before the launch):
//
// Resident (the operator of one image fits a cluster's shared memory): one
// thread-block cluster of CS CTAs (1-16, non-portable above 8; the plan
// sizes it so that every CTA has rows) owns an image. Each CTA loads its
// slab of R operator rows once, by TMA (a 3-d map over (keys, rows, image),
// boxes of 64 keys x R rows, 128-byte swizzle, keys and rows past N
// zero-filled), and keeps it for all `degree` steps and all column groups.
// bf16(T_j) of the whole image is staged, transposed, in every CTA; T_{j-1},
// T_j and T_{j+1} of the CTA's rows stay in its threads' registers. A step,
// with no cluster barrier: the products (slab x staged block); T_{j+1} of the
// own rows and its column maxima (warp shuffles); the maxima into every
// peer by red.async max, each CTA waiting on its own mbarrier for the
// cluster's bytes; each CTA scales (T_j, T_{j+1}) of its rows in f32, rounds
// T_{j+1} to bf16 into its own staging rows and into global memory (L2),
// and one multicast bulk copy a column (the TMA engine) carries those rows
// from L2 into every peer's staging buffer, completing on the peer's
// mbarrier. The exchange of the maxima orders the rest: a peer writes
// T_{j+1} into a CTA's staging only after it has that CTA's maxima of step j,
// sent after that CTA's last read of T_j, so one buffer of each suffices.
// The last step's rescale is applied on chip; only the result leaves. HBM
// traffic is S once, X in, the result out (and T's own rows through L2).
// Clusters beyond what the card holds at once run in waves.
//
// Streaming (larger graphs): persistent CTAs, one an SM, launched
// cooperatively so that all are resident and a grid-wide barrier (a counter
// in global memory, release/acquire) is sound; the whole chain is one launch.
// The rows of every image, in blocks of 16, are split evenly over the CTAs
// (contiguous ranges, which may cross images). A producer warp streams the
// CTA's operator rows (boxes of 64 keys x 16 rows) through a ring of 16
// shared-memory stages filled by TMA, with full/empty mbarriers, so loads
// stay in flight while the consumer warps run the products; it runs ahead
// across steps, since S does not change. The traversal alternates direction
// step by step (segments, then keys, from the end on even steps), so a step
// first reads the operator rows the step before read last, which are still
// in L2 when the operators do not all fit it. Four groups of 2 consumer
// warps take every 4th stage, a warp two row blocks of it, all 64 keys
// (fragments loaded before the products).
// One grid barrier a step: T_j goes to global memory unscaled (f32,
// transposed, one buffer a step parity) with its column maxima (atomicMax).
// After the barrier every CTA stages bf16(T_j * factor) of the image in key
// windows of up to 4096, scaling in f32 before the rounding, 8 key blocks at
// a time: a chunk's loads are issued as the products of the chunk before it
// start, and rounded into shared memory as they end. The owner of a row
// scales its T_j and T_{j-1} by the same factors as it computes T_{j+1}
// (its inputs loaded before the products). Measured against a first form
// with two barriers a step (the owners scaled and rounded their rows between
// them; bf16 staging), images in groups that fit the L2 (slower: more
// barriers), bulk copies (TMA) for the staging (slower: queued behind the
// ring's loads), fewer CTAs and one warp a stage (slower): PERF.md.
//
// Tensor cores: mma.sync m16n8k16 (bf16 x bf16 exact, f32 sums), A fragments
// by ldmatrix from the swizzled operator in shared memory (a warp takes two
// row blocks, so each B fragment feeds two products), B fragments by
// ldmatrix from the staged block (row pitch 16 bytes off a multiple of 128,
// so the 8 columns' rows fall in distinct banks). At 8 flops per byte of S the
// product is bound by moving S into shared memory (and, resident, by reading
// it out of shared memory once a step), not by the tensor cores. A build
// with the products on wgmma (m64n8k16, the slab and the staged block both
// read from shared memory) was measured and was slower: at n=8 each wgmma
// moves 2 KB of the slab for 16 KFLOP, and ldmatrix + mma.sync kept the
// products shorter. What a resident
// step costs on the H100 (clock64 phases of an ablation build, CHANGES.md):
// the products, then the cluster's exchange and the bookkeeping around it.
//
// S is read through a TMA map, which needs a row stride of a multiple of 16
// bytes: the caller hands the operator as a view of a buffer with rows padded
// to a multiple of 8 elements (ops/cheb_filter.kernel_operator; the solver
// builds its operator that way).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "errors.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

// DSS_CHEB_ABLATE, set only in control builds of this file alone (README).
// Bits 1 and 2 (wrong results, times only): the resident build without its
// products (1) or without the exchange with the peers (2: each CTA keeps its
// maxima and rows to itself, behind a CTA barrier). Bit 4 (a correct
// build): CTA 0 of the first cluster records clock64() at the step's phase
// boundaries (`dss_cheb_timeline`). Bit 8 (a correct build, the sums in
// another order): the streaming build traverses every step forward.
#ifndef DSS_CHEB_ABLATE
#define DSS_CHEB_ABLATE 0
#endif
// Bit 4 also makes the streaming build's CTA 0 record, a step: the cycles it
// spent staging T's first chunks, waiting for ring stages and in the
// epilogues, clock64() when its products are done and past the grid
// barrier, and the cycles its producer waited for free stages.
#if DSS_CHEB_ABLATE & 4
constexpr int TL_PHASES = 6;
__device__ long long dss_timeline[2 + 32 * TL_PHASES];
#define TL_ON (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0)
#define TIMELINE(i) \
  if (TL_ON && (i) < 2 + 32 * TL_PHASES) dss_timeline[i] = clock64();
#define TL_CLOCK() clock64()
#define TL_ADD(i, v) \
  if (TL_ON && (i) < 2 + 32 * TL_PHASES) dss_timeline[i] += (v);
#define TL_ADD_PRODUCER(i, v) \
  if (tid == THREADS && blockIdx.x == 0 && (i) < 2 + 32 * TL_PHASES) dss_timeline[i] += (v);
#else
#define TIMELINE(i)
#define TL_CLOCK() 0LL
#define TL_ADD(i, v) (void)(v);
#define TL_ADD_PRODUCER(i, v) (void)(v);
#endif

namespace {

constexpr int KT = 64;             // keys per 128-byte (swizzled) operator row segment
constexpr int MC = 8;              // columns per group (the mma's n)
constexpr int NWARPS = 8;          // resident: all warps compute
constexpr int THREADS = NWARPS * 32;
constexpr int STAGES = 16;         // streaming: ring stages of 64 rows x 64 keys
constexpr int STAGE_BYTES = 64 * 128;
constexpr int BOX_ROWS = 16;       // streaming: rows per TMA box
constexpr int SEG_BLOCKS = 4;      // streaming: row blocks of 16 per segment (the stage)
constexpr int GROUPS = 4;          // streaming: consumer warp groups, taking every 4th stage
constexpr int CHUNK = 8;           // streaming: key blocks of T staged at once
constexpr int STREAM_THREADS = THREADS + 32;  // 8 consumer warps + the producer warp
constexpr int UPT = 4;             // resident: (column, 2 rows) units a thread keeps
constexpr int NBW = 2;             // resident: row blocks a warp multiplies by one B fragment

// ------------------------------------------------------------------ layouts

// Resident shared memory (byte offsets after the 1024-byte alignment slack).
struct ResLayout {
  int KB, TP, MP, RB, KS;
  long long slab, sT, part, cmx, cm, sc, wm, bar, total;
};

__host__ __device__ inline ResLayout res_layout(int N, int m, int R, int CS) {
  ResLayout L;
  L.KB = (N + KT - 1) / KT;
  L.TP = L.KB * KT + 8;  // staged keys per column: 16 bytes past a multiple of 128
  L.MP = (m + MC - 1) / MC * MC;
  L.RB = (R + 15) / 16;
  const int groups = (L.RB + NBW - 1) / NBW;  // row blocks a warp shares B over
  L.KS = NWARPS / groups > 1 ? NWARPS / groups : 1;
  long long o = 0;
  L.slab = o;
  o += (long long)L.KB * R * 128 + (R % 16 ? 1024 : 0);  // a half row block reads 8 rows on
  L.sT = o;
  o += (long long)L.MP * L.TP * 2;
  L.part = o;
  o += (long long)L.KS * L.RB * 16 * L.MP * 4;
  L.cmx = o;  // the cluster's column maxima (every peer's red.async)
  o += (long long)L.MP * 4;
  L.cm = o;
  o += (long long)L.MP * 4;
  L.sc = o;
  o += (long long)L.MP * 4;
  L.wm = o;  // each warp's column maxima
  o += (long long)NWARPS * L.MP * 4;
  L.bar = o;  // the slab's, the column maxima's, the staged block's
  o += 32;
  L.total = 1024 + o;
  return L;
}

// Streaming shared memory.
struct StreamLayout {
  int TPs;
  long long ring, sT, part, cm, sf, bars, total;
};

__host__ __device__ inline StreamLayout stream_layout(int KW) {
  StreamLayout L;
  L.TPs = KW + 8;
  long long o = 0;
  L.ring = o;
  o += (long long)STAGES * STAGE_BYTES;
  L.sT = o;
  o += (long long)MC * L.TPs * 2;
  L.part = o;
  o += (long long)GROUPS * 64 * MC * 4;
  L.cm = o;
  o += MC * 4;
  L.sf = o;  // the staged columns' scale factors
  o += MC * 4;
  L.bars = o;
  o += 2LL * STAGES * 8;
  L.total = 1024 + o;
  return L;
}

// ------------------------------------------------------------ primitives

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One box of the 3-d map (keys, rows, image) at (k0, r0, b) into shared memory.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int k0, int r0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(r0), "r"(b)
      : "memory");
}

// Address of the 16-byte chunk `chunk` (0..7) of row `row` of a 128B-swizzled
// block of 128-byte rows starting at the 1024-aligned `base`.
__device__ __forceinline__ uint32_t swz(uint32_t base, int row, int chunk) {
  return base + row * 128 + ((chunk ^ (row & 7)) << 4);
}

// The resident slab's k-steps [kbeg, kend) for row blocks rb .. rb + nb - 1
// (nb <= NB): each B fragment (ldmatrix) feeds all nb products, and the loads
// of two k-steps are issued before their products.
template <int NB>
__device__ __forceinline__ void mma_ksteps(float (&acc)[NB][4], uint32_t slab, int R, int rb,
                                           int nb, int kbeg, int kend, uint32_t tcol,
                                           int lane) {
  const int q = lane >> 3;
  const int row = rb * 16 + (lane & 7) + 8 * (q & 1);
  const uint32_t tq = tcol + 16 * (q & 1);
  int s = kbeg;
  for (; s + 2 <= kend; s += 2) {
    uint32_t a[2][NB][4], bf[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = s + u;
      const uint32_t block = slab + (k >> 2) * R * 128;
      const int chunk = 2 * (k & 3) + (q >> 1);
#pragma unroll
      for (int i = 0; i < NB; ++i)
        if (i < nb) ldsm_x4(a[u][i], swz(block, row + 16 * i, chunk));
      ldsm_x2(bf[u], tq + k * 32);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int i = 0; i < NB; ++i)
        if (i < nb) mma_16816(acc[i], a[u][i], bf[u]);
  }
  if (s < kend) {
    uint32_t a[NB][4], bf[2];
    const uint32_t block = slab + (s >> 2) * R * 128;
    const int chunk = 2 * (s & 3) + (q >> 1);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      if (i < nb) ldsm_x4(a[i], swz(block, row + 16 * i, chunk));
    ldsm_x2(bf, tq + s * 32);
#pragma unroll
    for (int i = 0; i < NB; ++i)
      if (i < nb) mma_16816(acc[i], a[i], bf);
  }
}

// The shared::cluster address of `local` (this CTA's shared memory) in CTA
// `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

// A wait that has spun this many clock cycles (seconds) traps: a protocol
// fault ends the launch with an error instead of hanging the card.
constexpr long long SPIN_LIMIT = 1LL << 35;

// `bytes` (a multiple of 16) of global memory into the same offset of the
// shared memory of every CTA in `mask`, completing on each one's mbarrier
// at the offset of `bar`.
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src, uint32_t bytes,
                                               uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// max(*addr, v) in a peer's shared memory, completing 4 bytes on the peer's
// mbarrier.
__device__ __forceinline__ void red_async_max(uint32_t addr, uint32_t v, uint32_t bar) {
  asm volatile(
      "red.async.relaxed.cluster.shared::cluster.mbarrier::complete_tx::bytes.max.u32 "
      "[%0], %1, [%2];\n" :: "r"(addr), "r"(v), "r"(bar) : "memory");
}

// Wait for the phase of the given parity, with the peers' stores that
// completed it visible (acquire at cluster scope).
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > SPIN_LIMIT) __trap();
  }
}

// 1 / max(mv, 1) with jnp.maximum's NaN propagation.
__device__ __forceinline__ float factor_of(unsigned int bits) {
  const float mv = __uint_as_float(bits);
  return 1.0f / (isnan(mv) ? mv : fmaxf(mv, 1.0f));
}

// |x| as bits that order like the floats (NaN above inf).
__device__ __forceinline__ unsigned int abs_bits(float x) { return __float_as_uint(fabsf(x)); }

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 p;
  p.x = pack_bf16x2(v[0], v[1]);
  p.y = pack_bf16x2(v[2], v[3]);
  p.z = pack_bf16x2(v[4], v[5]);
  p.w = pack_bf16x2(v[6], v[7]);
  return p;
}

// a_shift's f32 operations in the twin's order, unfused.
__device__ __forceinline__ float a_shift(float omc, float t1, float y, float inv_e) {
  return __fmul_rn(__fsub_rn(__fmul_rn(omc, t1), y), inv_e);
}

// ---------------------------------------------------------------- resident

// grid (CS, B), cluster (CS, 1, 1): CTA `rank` of cluster b owns rows
// [rank R, rank R + R) of image b. No cluster barrier inside the chain: the
// column maxima go to every peer by red.async and the bf16 rows of T by a
// multicast bulk copy from L2, each receiver waits on its own mbarrier for the bytes it expects, and the
// exchange of the maxima orders the rest (a peer writes T_{j+1} into this
// CTA's staging only after it has this CTA's maxima of step j, sent after
// this CTA's last read of T_j; it sends its maxima of step j + 1 only after
// it has this CTA's T_{j+1}, sent after this CTA's last read of the maxima
// of step j), so one buffer of each suffices.
__global__ void __launch_bounds__(THREADS, 1)
cheb_resident_kernel(const __grid_constant__ CUtensorMap tS,
                     const float* __restrict__ X,    // (B, N, m)
                     const float* __restrict__ ce,   // (B, 2): c, e
                     float* __restrict__ out,        // (B, N, m)
                     __nv_bfloat16* __restrict__ tg, // (B, MP, N rounded up to 8)
                     int N, int m, int R, int degree) {
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const ResLayout L = res_layout(N, m, R, CS);
  const int MP = L.MP;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);  // 1024-aligned for the swizzle
  const uint32_t slab = smem_u32(smem + L.slab);
  __nv_bfloat16* sT = reinterpret_cast<__nv_bfloat16*>(smem + L.sT);
  float* part = reinterpret_cast<float*>(smem + L.part);
  unsigned int* cmx = reinterpret_cast<unsigned int*>(smem + L.cmx);
  unsigned int* cm = reinterpret_cast<unsigned int*>(smem + L.cm);
  float* scs = reinterpret_cast<float*>(smem + L.sc);
  unsigned int* wm = reinterpret_cast<unsigned int*>(smem + L.wm);
  const uint32_t bar = smem_u32(smem + L.bar);  // the slab's TMA
  const uint32_t maxbar = bar + 8;              // every peer's column maxima
  const uint32_t tbar = bar + 16;               // every peer's rows of bf16 T

  const int row0 = rank * R;
  const bool has_rows = row0 < N;
  const float* Xb = X + (long long)b * N * m;
  const float c = ce[2 * b];
  const float inv_e = 1.0f / ce[2 * b + 1];
  const float omc = 1.0f - c;
  const int n8 = (N + 7) / 8;
  // this CTA's rows below N in chunks of 8, sent to every peer with rows (a
  // CTA with no rows multiplies nothing and receives none)
  const int own8 = has_rows ? min(R, n8 * 8 - row0) / 8 : 0;
  const int with_rows = (N + R - 1) / R;  // CTAs 0 .. with_rows - 1
  const uint32_t max_bytes = (uint32_t)(CS * MP * 4);
  const uint32_t t_bytes = (uint32_t)(MP * (n8 - own8) * 16);

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(maxbar, 1);
    mbar_init(tbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < MP) cmx[tid] = 0u;
  __syncthreads();
  // The slab, once: KB boxes of 64 keys x R rows.
  if (tid == 0 && has_rows) {
    mbar_arrive_expect_tx(bar, (uint32_t)(L.KB * R * 128));
    for (int kb = 0; kb < L.KB; ++kb)
      tma_load_3d(slab + kb * R * 128, &tS, bar, kb * KT, row0, b);
  }
  // Meanwhile: the staged block = bf16(X) (zero past N and past m).
  {
    uint4* z = reinterpret_cast<uint4*>(sT);
    for (int i = tid; i < MP * L.TP / 8; i += THREADS) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  for (int u = tid; u < m * n8; u += THREADS) {
    const int col = u % m;
    const int k0 = (u / m) * 8;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = k0 + i < N ? Xb[(long long)(k0 + i) * m + col] : 0.f;
    *reinterpret_cast<uint4*>(sT + col * L.TP + k0) = pack8(v);
  }
  // Each thread keeps units u = tid + THREADS i (column u % MP, local rows
  // 2 (u / MP) and + 1) of T_{j-1} and T_j in registers across the chain.
  const int units_all = R / 2 * MP;
  const int nui = (units_all + THREADS - 1) / THREADS;  // <= UPT (the plan's limit)
  float t0r[UPT][2], t1r[UPT][2], wr[UPT][2];
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    const int u = tid + THREADS * i, col = u % MP, r = 2 * (u / MP);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = i < nui && u < units_all && row0 + r + h < N && col < m;
      t0r[i][h] = ok ? Xb[(long long)(row0 + r + h) * m + col] : 0.f;
      t1r[i][h] = t0r[i][h];
      wr[i][h] = 0.f;
    }
  }
  TIMELINE(0)
  cluster.sync();  // every peer's barriers and staging are initialized
  if (has_rows) mbar_wait(bar, 0);
  TIMELINE(1)

  const int NKS = L.KB * 4;  // k-steps of 16 keys
  const int groups = (L.RB + NBW - 1) / NBW;
  const int units = groups * L.KS;
  const int g = lane >> 2, t = lane & 3;
  const bool shfl = 32 % MP == 0;  // a warp's lanes l, l + MP, ... hold one column
  for (int step = 1; step <= degree; ++step) {
    const bool first = step == 1, last = step == degree;
    const uint32_t parity = (step - 1) & 1;
    if (tid == 0 && !(DSS_CHEB_ABLATE & 2)) {
      mbar_arrive_expect_tx(maxbar, max_bytes);
      if (!last && has_rows) mbar_arrive_expect_tx(tbar, t_bytes);
    }
    if (tid < MP) cm[tid] = 0u;
    // y = slab x bf16(T_j): warps over (pair of row blocks, key range), each
    // column group in turn
    for (int u = warp; u < units && has_rows && !(DSS_CHEB_ABLATE & 1); u += NWARPS) {
      const int rb = NBW * (u % groups), ks = u / groups;
      const int kbeg = ks * NKS / L.KS, kend = (ks + 1) * NKS / L.KS;
      const int nb = min(NBW, L.RB - rb);
      for (int gi = 0; gi < MP / MC; ++gi) {
        const uint32_t tcol = smem_u32(sT + (gi * MC + (lane & 7)) * L.TP);
        float acc[NBW][4];
#pragma unroll
        for (int h = 0; h < NBW; ++h)
          acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.f;
        mma_ksteps<NBW>(acc, slab, R, rb, nb, kbeg, kend, tcol, lane);
#pragma unroll
        for (int h = 0; h < NBW; ++h) {
          if (h >= nb) break;
          float* p = part + ((ks * L.RB + rb + h) * 16) * MP + gi * MC;
          p[g * MP + 2 * t] = acc[h][0];
          p[g * MP + 2 * t + 1] = acc[h][1];
          p[(g + 8) * MP + 2 * t] = acc[h][2];
          p[(g + 8) * MP + 2 * t + 1] = acc[h][3];
        }
      }
    }
    __syncthreads();
    TIMELINE(2 + (step - 1) * TL_PHASES)
    // T_{j+1} of the thread's units, unscaled, and the column maxima (lanes,
    // then warps)
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      if (i >= nui) break;
      const int u = tid + THREADS * i, col = u % MP, r = 2 * (u / MP);
      unsigned int mx = 0u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float w = 0.f;
        if (u < units_all && row0 + r + h < N && col < m) {
          float y = 0.f;
          for (int ks = 0; ks < L.KS; ++ks) y += part[(ks * L.RB * 16 + r + h) * MP + col];
          const float a = a_shift(omc, t1r[i][h], y, inv_e);
          w = first ? a : __fsub_rn(__fmul_rn(2.0f, a), t0r[i][h]);
        }
        wr[i][h] = w;
        mx = max(mx, abs_bits(w));
      }
      if (shfl) {
        for (int o = MP; o < 32; o <<= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (lane < MP) wm[warp * MP + lane] = i == 0 ? mx : max(wm[warp * MP + lane], mx);
      } else if (u < units_all) {
        atomicMax(cm + col, mx);
      }
    }
    __syncthreads();
    if (shfl && tid < MP) {
      unsigned int mx = 0u;
      for (int w = 0; w < NWARPS; ++w) mx = max(mx, wm[w * MP + tid]);
      cm[tid] = mx;
    }
    __syncthreads();
    TIMELINE(3 + (step - 1) * TL_PHASES)
    // the column maxima into every peer's (red.async max; in the first step
    // they only say that this CTA is done reading T_0)
    if (DSS_CHEB_ABLATE & 2) {
      if (tid < MP) cmx[tid] = cm[tid];
      __syncthreads();
    } else {
      for (int i = tid; i < CS * MP; i += THREADS)
        red_async_max(peer_addr(smem_u32(cmx + i % MP), i / MP), cm[i % MP],
                      peer_addr(maxbar, i / MP));
      mbar_wait_cluster(maxbar, parity);
    }
    TIMELINE(4 + (step - 1) * TL_PHASES)
    if (tid < MP) scs[tid] = first ? 1.0f : factor_of(cmx[tid]);
    __syncthreads();
    // (a peer's maxima of the next step come after this CTA's T_{j+1})
    if (tid < MP) cmx[tid] = 0u;
    // scale (T_j, T_{j+1}) in f32, then round T_{j+1} to bf16 into the own
    // rows of the staging buffer (or, last, write the result)
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      if (i >= nui) break;
      const int u = tid + THREADS * i, col = u % MP, r = 2 * (u / MP);
      if (u >= units_all) continue;
      const float sc = scs[col];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!first) t0r[i][h] = t1r[i][h] * sc;
        t1r[i][h] = first ? wr[i][h] : wr[i][h] * sc;
        if (last && row0 + r + h < N && col < m)
          out[((long long)b * N + row0 + r + h) * m + col] = t1r[i][h];
      }
      if (!last && row0 + r < n8 * 8) {  // the own chunks, zero past N and past m
        const uint32_t pk = pack_bf16x2(row0 + r < N && col < m ? t1r[i][0] : 0.f,
                                        row0 + r + 1 < N && col < m ? t1r[i][1] : 0.f);
        *reinterpret_cast<uint32_t*>(sT + col * L.TP + row0 + r) = pk;
        *reinterpret_cast<uint32_t*>(tg + ((long long)b * MP + col) * (n8 * 8) + row0 + r) = pk;
      }
    }
    TIMELINE(5 + (step - 1) * TL_PHASES)
    if (!last) {  // the own rows into every peer's staging buffer
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      __syncthreads();
      if (DSS_CHEB_ABLATE & 2) {
        __syncthreads();
      } else {
        // each column's own rows from global memory (L2) into every peer
        // with rows: one multicast copy a column, the TMA engine's work
        const uint16_t mask = (uint16_t)(((1u << with_rows) - 1u) & ~(1u << rank));
        if (tid < MP && own8 > 0 && mask != 0)
          bulk_multicast(smem_u32(sT + tid * L.TP + row0),
                         tg + ((long long)b * MP + tid) * (n8 * 8) + row0, (uint32_t)(own8 * 16),
                         tbar, mask);
        TIMELINE(6 + (step - 1) * TL_PHASES)
        if (has_rows) mbar_wait_cluster(tbar, parity);  // T_{j+1} staged
      }
    }
    TIMELINE(7 + (step - 1) * TL_PHASES)
  }
  cluster.sync();  // no CTA leaves while a peer's stores may still be in flight
}

// --------------------------------------------------------------- streaming

struct StreamArgs {
  const float* X;        // (B, N, m)
  const float* ce;       // (B, 2)
  float* out;            // (B, N, m)
  float* u;              // (2, B, MP, NT): T_j unscaled, transposed, by step parity
  float* t1;             // (B, MP, NT): the scaled T_{j-1} of each row, kept by its owner
  unsigned int* colmax;  // (degree + 1, B, MP)
  unsigned int* counter; // grid barrier
  int B, N, m, degree, KW;
};

// The CTA's share: row blocks [lo, hi) of the images in order, cut at image
// ends and every SEG_BLOCKS blocks; from the last block back when `rev`.
template <typename F>
__device__ __forceinline__ void for_each_segment(const StreamArgs& a, bool rev, F&& fn) {
  const int RBI = (a.N + 15) / 16;
  const long long tot = (long long)a.B * RBI;
  const long long lo = (long long)blockIdx.x * tot / gridDim.x;
  const long long hi = (long long)(blockIdx.x + 1) * tot / gridDim.x;
  if (!rev) {
    for (long long blk = lo; blk < hi;) {
      const int bi = (int)(blk / RBI), rb = (int)(blk % RBI);
      const int nb = (int)min((long long)min(SEG_BLOCKS, RBI - rb), hi - blk);
      fn(bi, rb * 16, min(nb * 16, a.N - rb * 16), nb);
      blk += nb;
    }
    return;
  }
  for (long long end = hi; end > lo;) {  // blocks [end - nb, end)
    const int bi = (int)((end - 1) / RBI), re = (int)((end - 1) % RBI) + 1;
    const int nb = (int)min((long long)min(SEG_BLOCKS, re), end - lo);
    const int rb = re - nb;
    fn(bi, rb * 16, min(nb * 16, a.N - rb * 16), nb);
    end -= nb;
  }
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(THREADS) : "memory");
}

// Grid-wide barrier number `n` (1, 2, ...) of the consumer threads of all
// CTAs; sound because the launch is cooperative (all CTAs resident).
__device__ __forceinline__ void grid_sync(unsigned int* counter, unsigned int n) {
  consumer_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    const unsigned int target = n * gridDim.x;
    const long long start = clock64();
    unsigned int v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(counter) : "memory");
      if (clock64() - start > SPIN_LIMIT) __trap();
    } while (v < target);
    __threadfence();
  }
  consumer_sync();
}

// Row blocks rb and rb + 1 (the first nbr of them) of a ring stage (row
// blocks of 16 x 64 keys): four k-steps, their fragments loaded before the
// products, each B fragment feeding both row blocks. The stage's products
// accumulate from zero and are added to acc in f32 (rounded to nearest): a
// tensor-core accumulation chain stays four products long (chains across
// stages measured up to 2.9e-3 off the twin on an ill-conditioned column,
// where the twin's f32 sums were 3.6e-6 off f64 ones; PERF.md).
__device__ __forceinline__ void mma_stage(float (&acc)[2][4], uint32_t block, int rb, int nbr,
                                          uint32_t tcol, int key, int lane) {
  uint32_t a[2][4][4], bf[4][2];
  float d[2][4] = {};
  const int q = lane >> 3;
  const int row = rb * 16 + (lane & 7) + 8 * (q & 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldsm_x2(bf[kk], tcol + (key + 16 * kk + 8 * (q & 1)) * 2);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (h < nbr) ldsm_x4(a[h][kk], swz(block, row + 16 * h, 2 * kk + (q >> 1)));
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (h < nbr) mma_16816(d[h], a[h][kk], bf[kk]);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[h][i] = __fadd_rn(acc[h][i], d[h][i]);
}

// The scale factor of column `col` of image b after step `step` (1 after
// step 0, the start, and step 1, which the twin does not scale).
__device__ __forceinline__ float step_factor(const StreamArgs& a, int step, int b, int col,
                                            int MP) {
  return step >= 2 && col < a.m
             ? factor_of(__ldcg(a.colmax + ((long long)step * a.B + b) * MP + col))
             : 1.0f;
}

__global__ void __launch_bounds__(STREAM_THREADS, 1)
cheb_stream_kernel(const __grid_constant__ CUtensorMap tS, const StreamArgs a) {
  const StreamLayout L = stream_layout(a.KW);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t ring = smem_u32(smem + L.ring);
  __nv_bfloat16* sT = reinterpret_cast<__nv_bfloat16*>(smem + L.sT);
  float* part = reinterpret_cast<float*>(smem + L.part);
  unsigned int* cm = reinterpret_cast<unsigned int*>(smem + L.cm);
  float* sf = reinterpret_cast<float*>(smem + L.sf);
  const uint32_t bars = smem_u32(smem + L.bars);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int N = a.N, m = a.m, B = a.B;
  const int MP = (m + MC - 1) / MC * MC;
  const int NT = (N + KT - 1) / KT * KT;
  const long long UB = (long long)B * MP * NT;  // one step's buffer of u
  const int nwin = (NT + a.KW - 1) / a.KW;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NWARPS / GROUPS);  // the warps of the stage's group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NWARPS) {
    // ------------------------------------------------------------ producer
    if (lane == 0) {
      int it = 0;
      for (int step = 1; step <= a.degree; ++step) {
        const bool rev = !(DSS_CHEB_ABLATE & 8) && !(step & 1);
        for_each_segment(a, rev, [&](int b, int r0, int cnt, int nb) {
          for (int gi = 0; gi < MP / MC; ++gi)
            for (int kb = 0; kb < NT / KT; ++kb, ++it) {
              const int k0 = (rev ? NT / KT - 1 - kb : kb) * KT;
              const int s = it % STAGES;
              const long long t_e = TL_CLOCK();
              mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
              TL_ADD_PRODUCER(2 + (step - 1) * 6 + 5, TL_CLOCK() - t_e)
              mbar_arrive_expect_tx(full(s), nb * BOX_ROWS * 128);
              for (int i = 0; i < nb; ++i)
                tma_load_3d(ring + s * STAGE_BYTES + i * BOX_ROWS * 128, &tS, full(s), k0,
                            r0 + i * BOX_ROWS, b);
            }
        });
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int g = lane >> 2, t = lane & 3;
  // group grp takes stages it with it % GROUPS == grp, a warp row blocks rb, rb + 1
  const int rb = (warp & 1) * 2, grp = warp >> 1;
  unsigned int nbar = 0;
#if DSS_CHEB_ABLATE & 4
  if (TL_ON)
    for (int i = 0; i < 2 + 32 * TL_PHASES; ++i) dss_timeline[i] = 0;
#endif
  TIMELINE(0)
  // T_0 = X, transposed, into u's buffer 0 (rows below N, columns below m)
  for (long long i = (long long)blockIdx.x * THREADS + tid; i < (long long)B * N * m;
       i += (long long)gridDim.x * THREADS) {
    const int col = (int)(i % m);
    const long long bn = i / m;
    const int b = (int)(bn / N), n = (int)(bn % N);
    a.u[((long long)b * MP + col) * NT + n] = a.X[i];
  }
  grid_sync(a.counter, ++nbar);
  TIMELINE(1)

  int it = 0;
  long long staged = -1;  // (step, image, column group, window) of the staged block
  for (int step = 1; step <= a.degree; ++step) {
    const float* uin = a.u + (long long)((step - 1) & 1) * UB;  // T_{j-1} unscaled
    float* uout = a.u + (long long)(step & 1) * UB;
    unsigned int* cmax = a.colmax + (long long)step * B * MP;
    const int tl = 2 + (step - 1) * 6;  // this step's timeline slots
    const bool rev = !(DSS_CHEB_ABLATE & 8) && !(step & 1);
    for_each_segment(a, rev, [&](int b, int r0, int cnt, int nb) {
      const float c = a.ce[2 * b];
      const float inv_e = 1.0f / a.ce[2 * b + 1];
      const float omc = 1.0f - c;
      for (int gi = 0; gi < MP / MC; ++gi) {
        const float* ucol = uin + ((long long)b * MP + gi * MC) * NT;
        // the epilogue's inputs, loaded while the products run
        float pu[2], pt[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = tid + q * THREADS, cc = i / max(cnt, 1), r = i % max(cnt, 1);
          const bool ok = i < cnt * MC && gi * MC + cc < m;
          const long long idx = ((long long)b * MP + gi * MC + cc) * NT + r0 + r;
          pu[q] = ok ? __ldcg(uin + idx) : 0.f;
          pt[q] = ok && step > 1 ? a.t1[idx] : 0.f;
        }
        float acc[2][4] = {};
        for (int wi = 0; wi < nwin; ++wi) {
          const int w = rev ? nwin - 1 - wi : wi;
          const int kw0 = w * a.KW, len = min(a.KW, NT - kw0), nkb = len / KT;
          const int nch = (nkb + CHUNK - 1) / CHUNK;
          // bf16(T_{j-1}) of the window: the previous step's unscaled rows
          // times its column factors, in f32, then rounded (zero past N and
          // m), a chunk of CHUNK key blocks (in the order of the traversal)
          // at a time; each chunk's loads are issued as the products of the
          // chunk before it start, and stored as they end
          float4 v[2][2];
          auto chunk_keys = [&](int q, int& lo, int& nbk) {
            const int p0 = q * CHUNK, p1 = min(nkb, p0 + CHUNK);
            lo = rev ? nkb - p1 : p0;
            nbk = p1 - p0;
          };
          auto stage_load = [&](int q) {
            int lo, nbk;
            chunk_keys(q, lo, nbk);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int u = tid + h * THREADS;  // 8 keys of a column
              if (u < MC * 8 * nbk) {
                const float4* src = reinterpret_cast<const float4*>(
                    ucol + (long long)(u / (8 * nbk)) * NT + kw0 + lo * KT + (u % (8 * nbk)) * 8);
                v[h][0] = __ldcg(src);
                v[h][1] = __ldcg(src + 1);
              }
            }
          };
          auto stage_store = [&](int q) {
            int lo, nbk;
            chunk_keys(q, lo, nbk);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int u = tid + h * THREADS;
              if (u < MC * 8 * nbk) {
                const int cc = u / (8 * nbk), k = lo * KT + (u % (8 * nbk)) * 8;
                const bool col_ok = gi * MC + cc < m;
                const float f = sf[cc];
                const float x[8] = {v[h][0].x, v[h][0].y, v[h][0].z, v[h][0].w,
                                    v[h][1].x, v[h][1].y, v[h][1].z, v[h][1].w};
                float y[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) y[i] = col_ok && kw0 + k + i < N ? x[i] * f : 0.f;
                *reinterpret_cast<uint4*>(sT + cc * L.TPs + k) = pack8(y);
              }
            }
          };
          const long long tag = (((long long)step * B + b) * (MP / MC) + gi) * nwin + w;
          int next = nch;  // the next chunk to stage
          if (tag != staged) {
            const long long t_s = TL_CLOCK();
            consumer_sync();  // every warp is done with the staged window
            if (tid < MC) sf[tid] = step_factor(a, step - 1, b, gi * MC + tid, MP);
            stage_load(0);
            consumer_sync();
            stage_store(0);
            consumer_sync();
            staged = tag;
            next = 1;
            TL_ADD(tl, TL_CLOCK() - t_s)
          }
          const uint32_t tcol = smem_u32(sT + (lane & 7) * L.TPs);
          for (int pi = 0; pi < nkb; ++pi, ++it) {
            const bool ahead = next < nch && next == pi / CHUNK + 1;
            if (ahead && pi % CHUNK == 0) stage_load(next);
            if ((it % GROUPS) == grp) {
              const int s = it % STAGES;
              const long long t_w = TL_CLOCK();
              mbar_wait(full(s), (it / STAGES) & 1);
              TL_ADD(tl + 1, TL_CLOCK() - t_w)
              const int k0 = (rev ? nkb - 1 - pi : pi) * KT;
              if (rb < nb) mma_stage(acc, ring + s * STAGE_BYTES, rb, nb - rb, tcol, k0, lane);
              __syncwarp();
              if (lane == 0) mbar_arrive(empty(s));
            }
            if (ahead && (pi % CHUNK == CHUNK - 1 || pi == nkb - 1)) {
              stage_store(next++);
              consumer_sync();
            }
          }
        }
        const long long t_p = TL_CLOCK();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (rb + h >= nb) break;
          float* p = part + (grp * 64 + (rb + h) * 16) * MC;
          p[g * MC + 2 * t] = acc[h][0];
          p[g * MC + 2 * t + 1] = acc[h][1];
          p[(g + 8) * MC + 2 * t] = acc[h][2];
          p[(g + 8) * MC + 2 * t + 1] = acc[h][3];
        }
        if (tid < MC) cm[tid] = 0u;
        consumer_sync();
        // the own rows (rows fastest): T_{j-1} and T_{j-2} scaled by the
        // previous step's factors, T_j unscaled, its column maxima
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = tid + q * THREADS, cc = i / max(cnt, 1), r = i % max(cnt, 1);
          const int col = gi * MC + cc;
          const bool ok = i < cnt * MC && col < m;
          unsigned int mx = 0u;
          if (ok) {
            const float y = part[r * MC + cc] + part[(64 + r) * MC + cc] +
                            part[(128 + r) * MC + cc] + part[(192 + r) * MC + cc];
            const long long idx = ((long long)b * MP + col) * NT + r0 + r;
            const float f = sf[cc];
            const float t1 = pu[q] * f;
            const float av = a_shift(omc, t1, y, inv_e);
            float wv = av;
            if (step > 1) {
              wv = __fsub_rn(__fmul_rn(2.0f, av), pt[q] * f);
              mx = abs_bits(wv);
            }
            a.t1[idx] = t1;
            uout[idx] = wv;
          }
          // the column maxima: the warp's lanes of a column first, then one
          // shared-memory atomic a column a warp
          if (step > 1) {
            const unsigned int same = __match_any_sync(0xffffffffu, ok ? cc : MC);
            mx = __reduce_max_sync(same, mx);
            if (ok && lane == __ffs(same) - 1) atomicMax(cm + cc, mx);
          }
        }
        consumer_sync();
        if (step > 1 && tid < MC && gi * MC + tid < m)
          atomicMax(cmax + (long long)b * MP + gi * MC + tid, cm[tid]);
        TL_ADD(tl + 4, TL_CLOCK() - t_p)
      }
    });
    TIMELINE(tl + 2)
    grid_sync(a.counter, ++nbar);  // T_j and its column maxima complete
    TIMELINE(tl + 3)
  }
  // the result: the last step's own rows times its factors
  const float* ulast = a.u + (long long)(a.degree & 1) * UB;
  for_each_segment(a, false, [&](int b, int r0, int cnt, int nb) {
    for (int i = tid; i < cnt * m; i += THREADS) {
      const int r = i / m, col = i % m;
      a.out[((long long)b * N + r0 + r) * m + col] =
          __ldcg(ulast + ((long long)b * MP + col) * NT + r0 + r) *
          step_factor(a, a.degree, b, col, MP);
    }
  });
}

// The 3-d map (keys, rows, image) of a bf16 operator with row stride `ld` and
// image stride `bs` (elements), boxes of 64 keys x `rows`, 128B-swizzled,
// zero-filled past N.
bool make_operator_map(CUtensorMap* map, const void* S, int B, int N, long long ld,
                       long long bs, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)bs * 2};
  const cuuint32_t box[3] = {KT, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(S), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaLaunchConfig_t resident_config(int B, int cluster, int smem, cudaStream_t st,
                                   cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel's shared-memory limit raised to `smem` (kept from call to
// call: it only grows) and non-portable clusters allowed.
cudaError_t resident_attributes(int smem) {
  static int set_smem = -1;
  if (smem <= set_smem) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(cheb_resident_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cheb_resident_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) set_smem = smem;
  return err;
}

cudaError_t stream_attributes(int smem) {
  static int set_smem = -1;
  if (smem <= set_smem) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      cheb_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) set_smem = smem;
  return err;
}

// Clusters of `cluster` CTAs with `smem` shared bytes each that the card
// holds at once (cudaOccupancyMaxActiveClusters), remembered per size.
cudaError_t active_clusters(int cluster, int smem, int* clusters) {
  static int known_smem[17] = {0}, known[17] = {0};
  if (known_smem[cluster] == smem) {
    *clusters = known[cluster];
    return cudaSuccess;
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = resident_config(1, cluster, smem, nullptr, attr);
  const cudaError_t err = cudaOccupancyMaxActiveClusters(clusters, cheb_resident_kernel, &cfg);
  if (err == cudaSuccess) {
    known_smem[cluster] = smem;
    known[cluster] = *clusters;
  }
  return err;
}

bool resident_plan_ok(int N, int m, int cluster, int rows, int smem) {
  if (cluster < 1 || cluster > 16 || rows < 8 || rows > 256 || rows % 8 != 0) return false;
  if ((long long)cluster * rows < N || rows * ((m + MC - 1) / MC * MC) > 2 * THREADS * UPT)
    return false;
  return res_layout(N, m, rows, cluster).total <= smem;
}

}  // namespace

// Clusters of `cluster` CTAs with `smem` shared bytes each that the card
// holds at once (the plan's input, ops/cheb_filter.card_clusters_at_once).
extern "C" int dss_cheb_clusters_at_once(int cluster, int smem, int* clusters) {
  if (cluster < 1 || cluster > 16) return DSS_ERR_PLAN;
  const cudaError_t err = resident_attributes(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(active_clusters(cluster, smem, clusters));
}

// Shared bytes a CTA of each build's layout takes, for the check that the
// plan's model (ops/cheb_filter.resident_smem, stream_smem) matches them:
// totals2 = {resident (N, m, rows, cluster), streaming (key_window)}.
extern "C" int dss_cheb_layout_bytes(int N, int m, int rows, int cluster, int key_window,
                                     int* totals2) {
  totals2[0] = (int)res_layout(N, m, rows, cluster).total;
  totals2[1] = (int)stream_layout(key_window).total;
  return 0;
}

#if DSS_CHEB_ABLATE & 4
// The timeline of the last launch (bit-4 builds only): 2 + 32 * 6 clock64()
// readings of CTA 0 of the first cluster.
extern "C" int dss_cheb_timeline(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, dss_timeline, sizeof(dss_timeline)));
}
#endif

// The resident build: one cluster of `cluster` CTAs an image, `rows`
// operator rows a CTA, `smem` dynamic shared bytes (the plan's). S is
// (B, N, N) bf16 with row stride ld and image stride bs (multiples of 8).
extern "C" int dss_cheb_filter_resident(const void* S, long long ld, long long bs,
                                        const void* X, const void* ce, void* out, void* tglobal,
                                        int B, int N, int m, int degree, int cluster, int rows,
                                        int smem, void* stream) {
  if (!resident_plan_ok(N, m, cluster, rows, smem) || degree < 1) return DSS_ERR_PLAN;
  CUtensorMap map;
  if (!make_operator_map(&map, S, B, N, ld, bs, rows)) return DSS_ERR_TENSOR_MAP;
  cudaError_t err = resident_attributes(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int clusters = 0;
  err = active_clusters(cluster, smem, &clusters);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return DSS_ERR_OCCUPANCY;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      resident_config(B, cluster, smem, static_cast<cudaStream_t>(stream), attr);
  const float* xp = static_cast<const float*>(X);
  const float* cep = static_cast<const float*>(ce);
  float* op = static_cast<float*>(out);
  __nv_bfloat16* tgp = static_cast<__nv_bfloat16*>(tglobal);
  void* args[] = {&map, &xp, &cep, &op, &tgp, &N, &m, &rows, &degree};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(cheb_resident_kernel), args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The streaming build: `ctas` persistent CTAs (cooperative launch), every
// image streamed at every step, bf16 T staged in windows of `key_window` keys
// (a multiple of 64). work: 3 B MP NT floats (MP = m rounded up to 8, NT = N
// rounded up to 64); flags: 1 + (degree + 1) B MP words, zeroed here.
extern "C" int dss_cheb_filter_stream(const void* S, long long ld, long long bs,
                                      const void* X, const void* ce, void* out, void* work,
                                      void* flags, int B, int N, int m, int degree, int ctas,
                                      int key_window, int smem, void* stream) {
  if (ctas < 1 || key_window < KT || key_window % KT != 0 || degree < 1 ||
      stream_layout(key_window).total > smem)
    return DSS_ERR_PLAN;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long MP = (m + MC - 1) / MC * MC;
  const long long NT = (N + KT - 1) / KT * KT;
  cudaError_t err = cudaMemsetAsync(
      flags, 0, sizeof(unsigned int) * (1 + (long long)(degree + 1) * B * MP), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  if (!make_operator_map(&map, S, B, N, ld, bs, BOX_ROWS)) return DSS_ERR_TENSOR_MAP;
  err = stream_attributes(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* wk = static_cast<float*>(work);
  unsigned int* fl = static_cast<unsigned int*>(flags);
  StreamArgs args{static_cast<const float*>(X), static_cast<const float*>(ce),
                  static_cast<float*>(out), wk, wk + 2 * B * MP * NT, fl + 1, fl,
                  B, N, m, degree, key_window};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(STREAM_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* params[] = {&map, &args};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(cheb_stream_kernel), params);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
