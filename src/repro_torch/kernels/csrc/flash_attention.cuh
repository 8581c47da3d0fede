// What the flash-attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu) kernels share: the tile sizes, the mask and the
// kv tiles a q tile visits (so that the backward visits exactly the tiles
// the forward does), and the mma.sync / ldmatrix / cp.async helpers of the
// bf16 tensor-core kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // kv rows per tile (ref.BLOCK_K)
// -0.7 * FLT_MAX, rounded once from double, as the plain version has it
constexpr float kNeg = static_cast<float>(-0.7 * 3.4028234663852886e38);
constexpr float kLog2e = 1.4426950408889634f;

// the mask, with window <= 0 meaning no window
struct Mask {
  int Sk, causal, window, sink;
  __device__ __forceinline__ bool visible(int r, int c) const {
    return c < Sk && (!causal || (c <= r && (window <= 0 || r - c < window ||
                                             c < sink)));
  }
  // whether some (row, key) of the tile (q0.., k0..) is masked
  __device__ __forceinline__ bool partial(int q0, int k0) const {
    if (k0 + kBK > Sk) return true;
    if (!causal) return false;
    if (k0 + kBK - 1 > q0) return true;
    return window > 0 && q0 + kBQ - 1 - k0 >= window && k0 + kBK > sink;
  }
};

// the kv tiles a q tile visits, in increasing order: tile i < n_sink is i,
// the others first + (i - n_sink)
struct Tiles {
  int n_sink, first, n;
  __device__ __forceinline__ int operator[](int i) const {
    return i < n_sink ? i : first + (i - n_sink);
  }
  // whether kv tile t is one of them
  __device__ __forceinline__ bool visits(int t) const {
    return t < n_sink || (t >= first && t < first + (n - n_sink));
  }
};

__device__ __forceinline__ Tiles tiles_of(const Mask& mk, int q0, int S) {
  int hi = (mk.Sk + kBK - 1) / kBK - 1;
  int first = 0, n_sink = 0;
  if (mk.causal) {
    hi = min(hi, (min(q0 + kBQ, S) - 1) / kBK);
    if (mk.window > 0) {
      first = max(0, q0 - mk.window + 1) / kBK;
      n_sink = min((mk.sink + kBK - 1) / kBK, first);
    }
  }
  return Tiles{n_sink, first, n_sink + max(hi - first + 1, 0)};
}

// ---------------------------------------------------------------------------
// bf16 tensor-core helpers
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreadsTC = 32 * kWarps;
constexpr int kPad = 8;  // row pitch D + kPad bf16: rows 16 bytes apart

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// the part of each float that bf16 rounding dropped, as bf16x2
__device__ __forceinline__ uint32_t pack_bf16_residual(float lo, float hi,
                                                       uint32_t rounded) {
  const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(&rounded);
  return pack_bf16(lo - __bfloat162float(r.x), hi - __bfloat162float(r.y));
}

// The A fragments (16 x 16, k-step kk) of a 16 x 64 fp32 accumulator tile
// s[8][4] (n-tiles of 8 columns), as bf16 hi and, with kSplit, the bf16 of
// the residual lo, so that hi + lo keeps ~17 bits: accumulator n-tiles 2 kk
// and 2 kk + 1 are the fragment's columns 0-7 and 8-15.
template <bool kSplit>
__device__ __forceinline__ void acc_to_a(const float (&s)[8][4], int kk,
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  hi[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  hi[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  hi[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  hi[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  if constexpr (kSplit) {
    lo[0] = pack_bf16_residual(s[2 * kk][0], s[2 * kk][1], hi[0]);
    lo[1] = pack_bf16_residual(s[2 * kk][2], s[2 * kk][3], hi[1]);
    lo[2] = pack_bf16_residual(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2]);
    lo[3] = pack_bf16_residual(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3]);
  }
}

// 64 rows of D bf16 from rows [row0, row0 + 64) of src (n_rows rows) into
// dst with pitch D + kPad; rows past n_rows are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n_rows, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  constexpr int LD = D + kPad;
  for (int i = tid; i < kBK * kChunks; i += kThreadsTC) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < n_rows;
    const __nv_bfloat16* s =
        src + static_cast<long long>(in ? row0 + r : 0) * D + c * 8;
    cp_async16(smem_u32(dst + r * LD + c * 8), s, in ? 16 : 0);
  }
}

// The B fragments of n-tiles j and j + 1 (8 rows each) of a 64 x D tile t
// stored [row][col] with pitch LD, read as B = t^T (k = col, n = row; the
// K of S = Q K^T): lane l addresses row 8 (j + l / 16) + l % 8 at column
// 16 kk + 8 ((l / 8) % 2)
template <int LD>
__device__ __forceinline__ void ldsm_b_rows(uint32_t (&b)[4],
                                            const __nv_bfloat16* t, int j,
                                            int kk, int lane) {
  ldsm_x4(b, smem_u32(t + (8 * (j + (lane >> 4)) + (lane & 7)) * LD +
                      16 * kk + 8 * ((lane >> 3) & 1)));
}
// The B fragments of n-tiles j and j + 1 (8 columns each) of a 64 x D tile
// t stored [row][col], read as B = t (k = row, n = col; the V of O = P V):
// lane l addresses row 16 kk + 8 ((l / 8) % 2) + l % 8 at column 8 (j + l /
// 16)
template <int LD>
__device__ __forceinline__ void ldsm_b_cols(uint32_t (&b)[4],
                                            const __nv_bfloat16* t, int j,
                                            int kk, int lane) {
  ldsm_x4_trans(b, smem_u32(t + (16 * kk + 8 * ((lane >> 3) & 1) +
                                 (lane & 7)) * LD +
                            8 * (j + (lane >> 4))));
}
// A fragments (16 x 16, k-step kk) of rows [r0, r0 + 16) of a tile stored
// [row][col]: lane l addresses row r0 + l % 16, column 16 kk + 8 (l / 16)
template <int LD>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* t, int r0, int kk,
                                       int lane) {
  ldsm_x4(a, smem_u32(t + (r0 + (lane & 15)) * LD + 16 * kk +
                      8 * (lane >> 4)));
}

}  // namespace fa
