// Split-TF32 building blocks of the f32 tensor-core attention kernels
// (flash_fwd_f32.cu, flash_bwd_dkv_f32.cu, flash_bwd_dq_f32.cu): the hi/lo
// split, f32 tensor maps in 128-byte halves of hd, the 128B-swizzle address,
// the tf32 wgmma products, and the mma.sync products whose B fragments are
// loaded by hand from a row-major tile (where a product contracts over the
// tile's rows, which tf32 wgmma, with no transposed operand, cannot take).
// Everything here is inline or in an anonymous namespace, as in hopper.cuh.
//
// An f32 product a.b runs as three TF32 tensor-core products,
// a_hi b_hi + a_hi b_lo + a_lo b_hi, accumulated in f32, with
// x_hi = tf32(x) and x_lo = tf32(x - x_hi), each rounded to nearest with ties
// away from zero, as cvt.rna.tf32.f32 rounds (an f32 whose low 13 mantissa
// bits are 0), but in two full-rate integer operations on the bit pattern
// (add half of the dropped range to the magnitude, clear it) where the
// conversion runs at a quarter of their rate; the same bits for every finite
// x.
// x_hi + x_lo is x to within 2^-22 |x|, and the dropped a_lo b_lo term is
// below 2^-22 |a b|, so each product carries ~21 significant bits into the
// f32 sum. Defining DSS_F32_SINGLE_TF32 sets every lo part to 0, so the lo
// products run on zeros and add nothing: one TF32 product of the rounded
// operands in the port's own instruction stream: a control build of
// kernels 3-5 f32 (README), whose error against the twin must be the larger
// by far; the port never defines it.
#pragma once

#include "hopper.cuh"

namespace {

#ifdef DSS_F32_SINGLE_TF32
constexpr bool SPLIT_TF32 = false;
#else
constexpr bool SPLIT_TF32 = true;
#endif

__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = SPLIT_TF32 ? tf32_rna(x - hi) : 0.f;
}

// Byte offset of element byte `col` (0..127) of row `row` in a 128B-swizzled
// tile of 128-byte rows (1024-byte aligned): the 16-byte chunk index XOR row % 8.
__device__ __forceinline__ int swz(int row, int col) {
  return row * 128 + (col ^ ((row & 7) << 4));
}

// One box of the 4-d f32 map (hd, H, T, B) at (c0, h, t0, b): 32 floats of hd
// (one 128-byte swizzled row) from c0, `rows` tokens.
__device__ __forceinline__ void tma_load_f32(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int c0, int h, int t0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(h), "r"(t0), "r"(b)
      : "memory");
}

// The (hd, H, T, B) view of an f32 (B, T, H, 64) tensor with its element
// strides, in boxes of (32, 1, rows, 1) (half of hd: 128 bytes, the widest
// 128B-swizzled box), zero-filled out of range.
bool make_map_f32(CUtensorMap* map, const void* base, int B, int T, int H, long long sb,
                  long long st, long long sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {HD, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 4, (cuuint64_t)st * 4, (cuuint64_t)sb * 4};
  const cuuint32_t box[4] = {HD / 2, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Split a tile in place: hi over x, lo at the same offset in `lo` (the split
// is elementwise, so the swizzled layout carries over).
__device__ __forceinline__ void split_tile(float4* x, float4* lo, int n4, int tid, int nthreads) {
#pragma unroll 2
  for (int i = tid; i < n4; i += nthreads) {
    const float4 v = x[i];
    float4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    x[i] = h;
    lo[i] = l;
  }
}

// A k-step's key order in a transposed (K-major) operand: the register A
// fragment of a tf32 wgmma holds columns t and t + 4 of each 8-column block
// (a0/a1 and a2/a3), the f32 accumulator that fills it columns 2t and 2t + 1.
// Feeding the accumulator's columns as they are and permuting the other
// operand's k rows to match keeps every fragment in place: k position kp of a
// block of 8 is key 2 (kp % 4) + kp / 4.
__device__ __forceinline__ int k_perm(int kp) {
  return (kp & ~7) | ((kp & 3) << 1) | ((kp >> 2) & 1);
}

// Transpose a (64 rows x 64 hd) f32 tile, swizzled as TMA loads it (hd halves
// of 32 at +0 and +8 KB), into its K-major (64 hd x 64 rows) hi and lo tiles:
// row halves of 32 (k positions, permuted by k_perm) at +0 and +8 KB, each a
// 64 x 128-byte swizzled tile. Lane = k position within a half; one task is
// 4 hd values of one half. Reads: 4 lanes per 16-byte chunk column (the
// swizzle spreads the rows), writes: one 128-byte row per instruction.
__device__ __forceinline__ void transpose_split(const uint8_t* src, uint8_t* hi, uint8_t* lo,
                                                int warp, int nwarps, int lane) {
#pragma unroll 2
  for (int task = warp; task < 32; task += nwarps) {
    const int half = task >> 4, d0 = 4 * (task & 15);
    const int row = k_perm(32 * half + lane);
    const float4 x = *reinterpret_cast<const float4*>(
        src + (d0 >> 5) * 8192 + swz(row, (d0 & 31) * 4));
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = half * 8192 + swz(d0 + i, lane * 4);
      float h, l;
      split_tf32(xs[i], h, l);
      *reinterpret_cast<float*>(hi + off) = h;
      *reinterpret_cast<float*>(lo + off) = l;
    }
  }
}

// Make this thread's generic-proxy shared-memory writes visible to wgmma
// (the async proxy) before it signals the consumers.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One consumer warpgroup's barrier (named barrier 1 + wg, 128 threads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// D(64 x 64, f32) (+)= A(64 x 8) B(8 x 64), tf32: A and B K-major in
// 128B-swizzled shared memory (tf32 has no transposed operand); scale_d == 0
// overwrites D.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64 x 64, f32) (+)= A(64 x 8, registers: rows g and g + 8 of the warp's 16,
// columns t and t + 4) B(8 x 64), tf32: B K-major in 128B-swizzled shared
// memory; scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const float (&a)[4],
                                              uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "l"(desc_b), "r"(scale_d));
}

// An accumulator tile (64 x 64 per warpgroup: d[4j + e] at row g + 8 (e >> 1),
// column 8j + 2t + (e & 1)) as the hi and lo register A operands of 8 k-steps:
// k-step j takes block j's fragments in the order (row g, col 2t), (g + 8, 2t),
// (g, 2t + 1), (g + 8, 2t + 1), i.e. k positions t and t + 4 are columns 2t and
// 2t + 1 (k_perm on the other operand).
__device__ __forceinline__ void split_a(const float (&x)[32], float (&hi)[8][4],
                                        float (&lo)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    split_tf32(x[4 * j + 0], hi[j][0], lo[j][0]);
    split_tf32(x[4 * j + 2], hi[j][1], lo[j][1]);
    split_tf32(x[4 * j + 1], hi[j][2], lo[j][2]);
    split_tf32(x[4 * j + 3], hi[j][3], lo[j][3]);
  }
}

// D(64 x 32, f32) (+)= A(64 x 8) B(8 x 32), tf32, both K-major in
// 128B-swizzled shared memory; scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64 x 32, f32) (+)= A(64 x 8, registers: rows g and g + 8 of the warp's 16,
// columns t and t + 4) B(8 x 32), tf32: B K-major in 128B-swizzled shared
// memory; scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16], const float (&a)[4],
                                                  uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "l"(desc_b), "r"(scale_d));
}

// D(16 x 8) += A(16 x 8) B(8 x 8), tf32, f32 accumulate: a as split_a's
// fragments (rows g, g + 8; k positions t, t + 4), b0/b1 at k positions t,
// t + 4 of column g; d at rows g, g + 8, columns 2t, 2t + 1.
__device__ __forceinline__ void mma_tf32(float* d, const float (&a)[4], float b0, float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// acc (this warp's 16 M rows x 64 hd) += A (16 x 32: 4 k-steps of split
// fragments) X (32 rows x 64 hd, hi and lo tiles as TMA laid them out: two
// 4 KB hd halves). k-step kk's k positions t and t + 4 are X rows 8kk + 2t
// and 8kk + 2t + 1 (k_perm). Each lane loads its B fragments by hand, two
// rows of one hd column, free of bank conflicts under the 128B swizzle.
constexpr int X_HALF = 32 * 128;  // bytes between mma_acc's X tile's hd halves

__device__ __forceinline__ void mma_acc(float (&acc)[32], const float (&a_hi)[4][4],
                                        const float (&a_lo)[4][4], const uint8_t* x_hi,
                                        const uint8_t* x_lo, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int r0 = 8 * kk + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + g;  // hd column
      const int o0 = (col >> 5) * X_HALF + swz(r0, (col & 31) * 4);
      const int o1 = (col >> 5) * X_HALF + swz(r0 + 1, (col & 31) * 4);
      const float h0 = *reinterpret_cast<const float*>(x_hi + o0);
      const float h1 = *reinterpret_cast<const float*>(x_hi + o1);
      const float l0 = *reinterpret_cast<const float*>(x_lo + o0);
      const float l1 = *reinterpret_cast<const float*>(x_lo + o1);
      mma_tf32(&acc[4 * j], a_hi[kk], h0, h1);
      mma_tf32(&acc[4 * j], a_hi[kk], l0, l1);
      mma_tf32(&acc[4 * j], a_lo[kk], h0, h1);
    }
  }
}

// 16 accumulator fragments (64 x 32 per warpgroup) as 4 k-steps of hi and lo
// A fragments (split_a's order, for a 32-column tile).
__device__ __forceinline__ void split_a16(const float (&x)[16], float (&hi)[4][4],
                                          float (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split_tf32(x[4 * j + 0], hi[j][0], lo[j][0]);
    split_tf32(x[4 * j + 2], hi[j][1], lo[j][1]);
    split_tf32(x[4 * j + 1], hi[j][2], lo[j][2]);
    split_tf32(x[4 * j + 3], hi[j][3], lo[j][3]);
  }
}

}  // namespace
