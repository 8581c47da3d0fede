// The Hopper wgmma machinery of the bf16 attention kernels
// (flash_attention.cu's forward at D = 64, 96, 128 and (192, 128),
// flash_attention_bwd.cu's backward at D = 64, 96, (128, 128) and (192,
// 128)): 64-row tiles of 64 bf16 columns ("slabs") in shared memory in the
// 128-byte swizzle, and (at D = 96, whose 192-byte rows are no whole
// number of them) of 32 columns in the 64-byte swizzle, filled by
// cp.async; their wgmma descriptors; wgmma m64n64k16 with A from shared
// memory or registers (and m64n128k16 over two 64-column slabs, m64n96k16
// over three 32-column ones, A in registers); the fences and waits around
// it; named barriers; and the products built from them.

#pragma once

#include "flash_attention.cuh"

namespace fa {

constexpr int kTileBytes = 64 * 128;   // 64 rows of 64 bf16

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// byte offset of 16-byte chunk c (0..3) of row r in a 64-byte-swizzled
// tile of 32 columns (rows of 64 bytes; chunk bits 4-5 XOR address bits
// 7-8, CUTLASS's Swizzle<2, 4, 3>): the 8 rows of a core matrix land in 8
// distinct 16-byte bank groups
__device__ __forceinline__ uint32_t sw64(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// 4 bytes global -> shared, asynchronously; in = false writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// rows [row0, row0 + 64) of src (n_rows rows of 64 bf16) into the swizzled
// tile at shared address dst; rows past n_rows are zero-filled
__device__ __forceinline__ void load_tile_sw(uint32_t dst,
                                             const __nv_bfloat16* src,
                                             int row0, int n_rows, int tid) {
  for (int i = tid; i < 64 * 8; i += kThreadsTC) {
    const int r = i >> 3, c = i & 7;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + sw128(r, c),
               src + static_cast<long long>(in ? row0 + r : 0) * 64 + 8 * c,
               in ? 16 : 0);
  }
}

// The wgmma descriptor of a 128-byte-swizzled tile from shared address
// addr: 8-row groups 1,024 bytes apart (SBO), 128-byte swizzle; the leading
// offset is unused at these shapes. K-major (the K of the product along a
// row) steps 16 columns by +32 bytes, MN-major 16 rows by +2,048 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// desc_sw128 with its leading byte offset set to lbo: for an MN-major
// operand wider than one 64-column slab, the stride between its slabs
__device__ __forceinline__ uint64_t desc_sw128_lbo(uint32_t addr,
                                                   uint32_t lbo) {
  return (desc_sw128(addr) & ~(static_cast<uint64_t>(0x3FFF) << 16)) |
         (static_cast<uint64_t>(lbo >> 4) << 16);
}

// The wgmma descriptor of a 64-byte-swizzled tile of 32 columns from
// shared address addr (512-byte aligned): 8-row groups 512 bytes apart
// (SBO), swizzle mode 2 (64 bytes) in bits 62-63; K-major steps 16 columns
// by +32 bytes, MN-major 16 rows by +1,024 bytes
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}
// desc_sw64 with its leading byte offset set to lbo: for an MN-major
// operand wider than one 32-column slab, the stride between its slabs
__device__ __forceinline__ uint64_t desc_sw64_lbo(uint32_t addr,
                                                  uint32_t lbo) {
  return (desc_sw64(addr) & ~(static_cast<uint64_t>(0x3FFF) << 16)) |
         (static_cast<uint64_t>(lbo >> 4) << 16);
}

// A slab of W = 64 columns (128-byte swizzle) or W = 32 (64-byte swizzle):
// its bytes, the offset of a row's 16-byte chunk and its descriptor
template <int W>
__host__ __device__ constexpr int slab_bytes() {
  static_assert(W == 64 || W == 32, "slabs of 64 or 32 columns");
  return 64 * 2 * W;
}
template <int W>
__device__ __forceinline__ uint32_t slab_at(int r, int c) {
  return W == 64 ? sw128(r, c) : sw64(r, c);
}
template <int W>
__device__ __forceinline__ uint64_t slab_desc(uint32_t addr) {
  return W == 64 ? desc_sw128(addr) : desc_sw64(addr);
}
// the columns of a slab of the wgmma attention kernels at (D, DV): 64, in
// the 128-byte swizzle, where both are multiples of 64; else (D = DV = 96,
// 192-byte rows) 32, in the 64-byte swizzle, three slabs a row. (With 64 at
// D = 96 the rows are zero-filled to two 64-column slabs in shared memory,
// a quarter of the products on zeros: the forward ran 22 % slower with p in
// float32 and 11 % with p rounded at phi-3-vision's prefill on an H100.)
template <int D, int DV>
__host__ __device__ constexpr int slab_cols() {
  return D % 64 == 0 && DV % 64 == 0 ? 64 : 32;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// every wgmma the warpgroup committed is done
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// every wgmma group the warpgroup committed but the last N is done
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the accumulator registers are live here (no move of them across a wait)
template <int N>
__device__ __forceinline__ void wg_fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
// shared memory written by cp.async becomes visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64 fp32, the m64n64 accumulator layout: warp w rows 16 w.., n-tile
// j, element e as mma.sync's) (+)= A B, A and B from shared memory
template <int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB));
}
// the same with A (16 columns of the 64 rows) in registers, in the
// mma.sync A-fragment layout of each warp's 16 rows
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(kTransB));
}

// the same (A in registers) at N = 128: d the 64 x 128 accumulator, n-tile
// j (columns 8 j..) as above; b an MN-major operand two 64-column slabs
// wide, its descriptor's leading byte offset the slabs' stride
template <int kTransB>
__device__ __forceinline__ void wgmma_rs128(float (&d)[16][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(kTransB));
}

// the same (A in registers) at N = 96: d the 64 x 96 accumulator, n-tile
// j (columns 8 j..) as above; b an MN-major operand three 32-column slabs
// wide (64-byte swizzle), its descriptor's leading byte offset the slabs'
// stride
template <int kTransB>
__device__ __forceinline__ void wgmma_rs96(float (&d)[12][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}"
      ", {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(kTransB));
}

// named barrier `id` over n threads, which may wait at different places
// in the code: bar_arrive does not wait; bar_sync waits for n arrivals,
// and the shared-memory writes made before them are visible after it
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// rows [row0, row0 + 64) of src (n_rows rows of kCols = NS W bf16) into NS
// swizzled slabs of W columns at shared address dst (slab s: columns W s..),
// by NT threads (tid < NT): a thread's 16-byte chunk of every slab at one
// offset, W / 8 neighbouring threads on a slab row's 2 W bytes, 64 W / 8 /
// NT chunks a thread a slab, every index by shifts; rows past n_rows are
// zero-filled
template <int W, int NS, int NT, int kCols>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n_rows, int tid) {
  constexpr int kChunks = W / 8, kShift = W == 64 ? 3 : 2;
  static_assert(kCols == NS * W, "whole rows of NS slabs");
  static_assert(64 * kChunks % NT == 0, "whole rows of NT threads");
#pragma unroll
  for (int m = 0; m < 64 * kChunks / NT; ++m) {
    const int i = tid + m * NT, r = i >> kShift, c = i & (kChunks - 1);
    const bool in = row0 + r < n_rows;
    const __nv_bfloat16* row =
        src + static_cast<long long>(in ? row0 + r : 0) * kCols + 8 * c;
    const uint32_t at = dst + slab_at<W>(r, c);
#pragma unroll
    for (int s = 0; s < NS; ++s)
      cp_async16(at + s * slab_bytes<W>(), row + W * s, in ? 16 : 0);
  }
}

// 2^x on the SFU, results below 2^-126 flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the register A operands of rows [r0, r0 + 16) of NS swizzled slabs of W
// columns at t, every k-step kk (16 columns, in slab kk / (W / 16)):
// ldmatrix, lane l at row r0 + l % 16, 16-byte chunk 2 (kk % (W / 16)) + l
// / 16 of its slab
template <int NS, int W = 64>
__device__ __forceinline__ void ldsm_a_slabs(uint32_t (&a)[NS * W / 16][4],
                                             uint32_t t, int r0, int lane) {
  constexpr int kSteps = W / 16;
  const int r = r0 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < kSteps * NS; ++kk)
    ldsm_x4(a[kk], t + (kk / kSteps) * slab_bytes<W>() +
                       slab_at<W>(r, 2 * (kk % kSteps) + (lane >> 4)));
}

// piece s (columns 64 s..) of a 64-row accumulator 8 N wide, as the m64n64
// accumulator a wgmma takes
using Acc64 = float[8][4];
template <int N>
__device__ __forceinline__ Acc64& piece(float (&acc)[N][4], int s) {
  return *reinterpret_cast<Acc64*>(acc[8 * s]);
}

// issue c (64 x 64) = a (64 rows, W NS columns, register A operands)
// b^T, b the 64 rows of NS swizzled slabs of W columns at b_s read
// K-major, W / 16 k-steps a slab (descriptors by constant steps from the
// first, as issue_product_ss's)
template <int NS, int W = 64>
__device__ __forceinline__ void issue_product_t(
    float (&c)[8][4], const uint32_t (&a)[NS * W / 16][4], uint32_t b_s) {
  constexpr int kSteps = W / 16;
  const uint64_t db = slab_desc<W>(b_s);
#pragma unroll
  for (int kk = 0; kk < kSteps * NS; ++kk)
    wgmma_rs<0>(c, a[kk],
                db + (kk / kSteps) * (slab_bytes<W>() >> 4) +
                    2 * (kk % kSteps),
                kk);
}
// issue c (64 x 64) = a b^T, a the 64 rows of NS swizzled slabs of W
// columns at a_s and b those at b_s, both read K-major from shared memory,
// W / 16 k-steps a slab
// (descriptors of the slabs and k-steps by constant steps from the first:
// below 256 KB, desc(a + d) = desc(a) + d / 16)
template <int NS, int W = 64>
__device__ __forceinline__ void issue_product_ss(float (&c)[8][4],
                                                 uint32_t a_s, uint32_t b_s) {
  constexpr int kSteps = W / 16;
  const uint64_t da = slab_desc<W>(a_s), db = slab_desc<W>(b_s);
#pragma unroll
  for (int kk = 0; kk < kSteps * NS; ++kk) {
    const int step = (kk / kSteps) * (slab_bytes<W>() >> 4) +
                     2 * (kk % kSteps);
    wgmma_ss<0>(c, da + step, db + step, kk);
  }
}
// the same as issue_product_t, waited for
template <int NS, int W = 64>
__device__ __forceinline__ void wg_product_t(
    float (&c)[8][4], const uint32_t (&a)[NS * W / 16][4], uint32_t b_s) {
  wg_fence();
  issue_product_t<NS, W>(c, a, b_s);
  wg_commit();
  wg_wait_all();
  wg_fence_acc(c);
}

// issue acc (64 x W NS) += x b, x (64 x 64 fp32) as bf16 hi + lo register
// A operands (xh, xl: read by the products until they are done), b the 64
// rows of NS swizzled slabs of W columns at b_s read MN-major: one m64n64
// piece of acc a 64-column slab, or one m64n96k16 product over three
// 32-column slabs a k-step (16 rows of 64 bytes, 1,024 bytes on; the
// descriptor's leading byte offset the slabs' stride); each k-step's
// operands are made just before its products, so that the first products
// start while the rest are converted
template <int NS, int W = 64>
__device__ __forceinline__ void issue_accumulate(float (&acc)[NS * W / 8][4],
                                                 const float (&x)[8][4],
                                                 uint32_t (&xh)[4][4],
                                                 uint32_t (&xl)[4][4],
                                                 uint32_t b_s) {
  static_assert(W == 64 || NS == 3, "32-column slabs: three of them");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    acc_to_a<true>(x, kk, xh[kk], xl[kk]);
    wg_fence();
    if constexpr (W == 32) {   // one m64n96k16 product over the three slabs
      const uint64_t b = desc_sw64_lbo(b_s + kk * 1024, slab_bytes<32>());
      wgmma_rs96<1>(acc, xh[kk], b, 1);
      wgmma_rs96<1>(acc, xl[kk], b, 1);
    } else if constexpr (NS == 2) {   // one m64n128k16 product over both slabs
      const uint64_t b = desc_sw128_lbo(b_s + kk * 2048, kTileBytes);
      wgmma_rs128<1>(acc, xh[kk], b, 1);
      wgmma_rs128<1>(acc, xl[kk], b, 1);
    } else {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const uint64_t b = desc_sw128(b_s + s * kTileBytes + kk * 2048);
        wgmma_rs<1>(piece(acc, s), xh[kk], b, 1);
        wgmma_rs<1>(piece(acc, s), xl[kk], b, 1);
      }
    }
  }
}

// issue acc (64 x W NS) += x b, x's bf16 hi (and, with kSplit, lo) A
// operands made beforehand (xh, xl: read by the products until they are
// done), b the 64 rows of NS swizzled slabs of W columns at b_s read
// MN-major: with W = 64 one m64n64 piece of acc a slab (as
// issue_accumulate), with W = 32 (three slabs) one m64n96k16 product over
// all of them a k-step
template <int NS, bool kSplit, int W = 64>
__device__ __forceinline__ void issue_accumulate_a(
    float (&acc)[NS * W / 8][4], const uint32_t (&xh)[4][4],
    const uint32_t (&xl)[4][4], uint32_t b_s) {
  if constexpr (W == 64) {
    const uint64_t db = desc_sw128(b_s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const uint64_t b = db + ((s * kTileBytes + kk * 2048) >> 4);
        wgmma_rs<1>(piece(acc, s), xh[kk], b, 1);
        if constexpr (kSplit) wgmma_rs<1>(piece(acc, s), xl[kk], b, 1);
      }
  } else {
    static_assert(W == 32 && NS == 3, "32-column slabs: three of them");
    const uint64_t db = desc_sw64_lbo(b_s, slab_bytes<32>());
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // 16 rows of 64 bytes a k-step
      const uint64_t b = db + ((kk * 1024) >> 4);
      wgmma_rs96<1>(acc, xh[kk], b, 1);
      if constexpr (kSplit) wgmma_rs96<1>(acc, xl[kk], b, 1);
    }
  }
}

// every product the warpgroup issued is done: its accumulators and x live
template <int N>
__device__ __forceinline__ void wg_done(float (&acc)[N][4],
                                        float (&x)[8][4]) {
  wg_commit();
  wg_wait_all();
  wg_fence_acc(acc);
  wg_fence_acc(x);
}

}  // namespace fa
