// Flash-attention backward (training), for Hopper (sm_90a).
//
// The gradient of the forward of flash_attention.cu: given q, k, v, the
// forward's output o, its upstream gradient dO and the row log-sum-exps lse
// the forward wrote, it returns dQ, dK and dV. The TPU kernel it stands
// beside (repro/kernels/flash_attention.py::flash_attention) is forward
// only; the JAX model trains through autodiff of its blocked jnp attention,
// repro/models/attention.py::causal_attention. The plain version is autograd
// through repro_torch/kernels/ref.py::attention_ref (ref.attention_ref_grads).
//
// Same mask, GQA and kv tiles as the forward (flash_attention.cuh): key c is
// visible to row r when c <= r and (no window, or r - c < window, or c <
// sink); only the (q tile, kv tile) pairs the forward visits are visited,
// and a masked (row, key) has p = 0 exactly, as its plain version's
// exp(NEG - m) = 0. p is kept at fp32 precision (the model's round_p = 0).
//
//   P  = exp(S * scale - lse)              (S = Q K^T, recomputed)
//   dV = P^T dO
//   dP = dO V^T,   dS = P * (dP - Delta),  Delta_r = sum_d dO[r, d] O[r, d]
//   dQ = scale * dS K,   dK = scale * dS^T Q
//
// Delta is computed from o as the forward returned it (in bf16 for bf16
// inputs), as FlashAttention-2 does; autograd of the plain version
// differentiates the fp32 accumulator instead, and the two differ by the
// rounding of o (chip_smoke.py phase 19 prints the gap against its gate).
//
// What bounds it on this card: per visible score it does 10 D flops on the
// tensor cores (S, dP, dV, dK, dQ; the dQ pass recomputes S and dP, 4 D
// more) and a few fp32 operations, on ~q, k, v, o, dO read once: operations,
// far above the bytes-per-op ridge at hymba's shape, as for the forward.
// P and dS enter the products as bf16 hi + bf16 lo (the forward's split for
// p in fp32), so they keep ~17 bits: with the recomputation, ~20 D tensor
// flops a score.
//
// The first port (0.60 ms at hymba's (4, 25, 5, 1128, 64), PERF.md) spent
// most of it in its dK/dV kernel: one block per (b, kv head, key tile)
// looped over the G query heads and the q tiles that visit its tile, 5 to
// 90 items a block, 360 blocks, so the first key tiles set the time; its
// products were on mma.sync. The redesign, one launch
// (flash_attention_bwd_launch) of three kernels:
//   1. delta: Delta in fp32 into the scratch, 8 lanes a row with 16-byte
//      loads (bf16);
//   2. dK, dV: one block per (b, query head, key tile), at most ceil(S / 64)
//      q tiles (18 at hymba's shape) each, 1,800 blocks; the blocks of the
//      first key tiles (the most q tiles, under a causal mask) start first
//      (the key tile is the grid's slow axis). Each writes fp32 dK/dV
//      partials of its head to the scratch (2 B H Sk D floats);
//   3. dQ: one block per (b, head, q tile), over the kv tiles of the
//      forward's walk, recomputing S and dP (a second pass in place of
//      atomics across kv tiles), the longest q tiles first; then, in the
//      same launch, blocks that sum the dK/dV partials over the G heads of
//      each kv head in head order, scale and round them to bf16 (they
//      start as the dQ blocks drain, so their bytes overlap the last dQ
//      products).
// No atomics: nothing depends on the order blocks run in.
// The products, bf16 at D = 64 (hymba's head size): Hopper's wgmma, one
// warpgroup of 4 warps a block, m64n64k16, fp32 accumulators:
//   - K, V (dK/dV) or Q, dO (dQ) and a cp.async double buffer of the other
//     pair's tiles sit in shared memory in the 128-byte swizzle wgmma reads
//     (a 64-bf16 row is one 128-byte line; 16-byte chunk c of row r at
//     chunk c ^ (r % 8)), so one tile serves as a K-major operand (S^T = K
//     Q^T, dP^T = V dO^T; S = Q K^T, dP = dO V^T) and as an MN-major one
//     (dV += P^T dO, dK += dS^T Q; dQ += dS K);
//   - P^T and dS^T (P and dS in the dQ pass) go from the accumulators into
//     bf16 hi and lo A fragments in registers, the accumulator layout being
//     the register-A layout, with no shared-memory round trip;
//   - the rows' lse and Delta come with their Q and dO tiles by cp.async,
//     so no warp waits on a load the warpgroup's next product needs;
//   - occupancy (-Xptxas -v): dK/dV 168 registers under its launch bound,
//     3 blocks an SM; dQ 122 registers, 4 blocks; 51 KB of shared memory
//     a block.
// Other D: mma.sync.m16n8k16 with the same work split (4 warps of 16 keys
// or rows, ldmatrix fragments, rows padded by 16 bytes).
// fp32 inputs: IEEE fp32 FMAs out of shared memory (no TF32), four threads
// a key (dK, dV) or a q row (dQ); their dK/dV kernel sums the G heads
// inside the block. No --use_fast_math.

#include "flash_attention.cuh"

namespace {

using namespace fa;
using bf16 = __nv_bfloat16;

constexpr int kThreadsF = 256;   // fp32 kernels: 4 threads a key or row

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// ---------------------------------------------------------------------------
// 1. Delta = rowsum(dO * O), fp32
// ---------------------------------------------------------------------------

// fp32: a warp a row
__global__ void __launch_bounds__(256)
delta_kernel(const float* __restrict__ o, const float* __restrict__ dO,
             float* __restrict__ delta, long long rows, int D) {
  const long long row = blockIdx.x * 8LL + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(dO[row * D + d], o[row * D + d], acc);
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) delta[row] = acc;
}

// bf16: 8 lanes a row, 8 values (16 bytes) a load
__global__ void __launch_bounds__(256)
delta_kernel_bf16(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                  float* __restrict__ delta, long long rows, int D) {
  const long long row = blockIdx.x * 32LL + (threadIdx.x >> 3);
  const int l8 = threadIdx.x & 7;
  float acc = 0.0f;
  if (row < rows) {
    for (int c = l8; c < D / 8; c += 8) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + row * D + 8 * c);
      const uint4 dv = *reinterpret_cast<const uint4*>(dO + row * D + 8 * c);
      const bf16* op = reinterpret_cast<const bf16*>(&ov);
      const bf16* dp = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc = fmaf(__bfloat162float(dp[e]), __bfloat162float(op[e]), acc);
    }
  }
#pragma unroll
  for (int m = 4; m >= 1; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (row < rows && l8 == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// wgmma helpers (bf16, D = 64)
// ---------------------------------------------------------------------------

constexpr int kTileBytes = 64 * 128;   // 64 rows of 64 bf16

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
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
__device__ __forceinline__ void load_tile_sw(uint32_t dst, const bf16* src,
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
// the accumulator registers are live here (no move of them across a wait)
__device__ __forceinline__ void wg_fence_acc(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
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

// ---------------------------------------------------------------------------
// 2. dK, dV per (b, query head, key tile), fp32 partials (bf16 inputs)
// ---------------------------------------------------------------------------

// what both dK/dV kernels share: the block's head and key tile, and the
// q tiles that visit the key tile, in increasing order
struct KvBlock {
  int bh, kvh, t_kv, k0, n_qt;
  __device__ __forceinline__ KvBlock(int H, int K, int S) {
    bh = blockIdx.x;                                 // b * H + h
    kvh = (bh / H) * K + (bh % H) / (H / K);
    t_kv = blockIdx.y;
    k0 = t_kv * kBK;
    n_qt = (S + kBQ - 1) / kBQ;
  }
  // the first q tile >= qt whose walk visits the key tile, or -1
  __device__ __forceinline__ int next(const Mask& mk, int qt, int S) const {
    for (; qt < n_qt; ++qt)
      if (tiles_of(mk, qt * kBQ, S).visits(t_kv)) return qt;
    return -1;
  }
};

// P^T and dS^T of a (64 keys x 64 q rows) tile pair from the accumulator
// fragments of S^T and dP^T (fragment (j, e): key key0 + 8 (e / 2), q row
// q0 + 8 j + quad_col + e % 2), in place; lse and dl are the q tile's rows'
// lse and Delta (zero past S, where the rows of Q and dO are zero too, so
// that those rows add nothing)
__device__ __forceinline__ void p_ds_t(float (&st)[8][4], float (&dpt)[8][4],
                                       const float* lse, const float* dl,
                                       const Mask& mk, int q0, int k0,
                                       int key0, int quad_col, float c2) {
  const bool part = mk.partial(q0, k0);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 8 * j + quad_col + (e & 1);
      float p = exp2f(fmaf(st[j][e], c2, -(lse[r] * kLog2e)));
      if (part && !mk.visible(q0 + r, key0 + 8 * (e >> 1))) p = 0.0f;
      st[j][e] = p;
      dpt[j][e] = p * (dpt[j][e] - dl[r]);
    }
}

// fp32 partials of the block's 64 keys: rows key0, key0 + 8 of the
// accumulator fragments, unscaled
template <int D>
__device__ __forceinline__ void store_partials(const float (&dk)[D / 8][4],
                                               const float (&dv)[D / 8][4],
                                               float* pk, float* pv,
                                               long long bh, int Sk, int key0,
                                               int quad_col) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= Sk) continue;
    const long long off = (bh * Sk + key) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(pk + off + 8 * j + quad_col) =
          make_float2(dk[j][2 * h], dk[j][2 * h + 1]);
      *reinterpret_cast<float2*>(pv + off + 8 * j + quad_col) =
          make_float2(dv[j][2 * h], dv[j][2 * h + 1]);
    }
  }
}

constexpr size_t smem_bytes_wg() {
  // six swizzled tiles (two fixed, a double buffer of two), 2 x 2 x 64
  // floats of lse and Delta (dK/dV), and 1 KB to align the tiles
  return 6 * kTileBytes + sizeof(float) * 4 * kBQ + 1024;
}

// wgmma, D = 64: S^T = K Q^T and dP^T = V dO^T (K-major), then dV += P^T dO
// and dK += dS^T Q (dO and Q MN-major), P^T and dS^T as register A
// operands. Three blocks an SM overlap one block's elementwise work with
// another's products (issuing item i + 1's S^T before item i's dV, dK in
// one block needs 234 registers, 2 blocks an SM, and was slower).
__global__ void __launch_bounds__(kThreadsTC, 3)
dkdv_kernel_wg(const bf16* __restrict__ q,      // (B, H, S, 64)
               const bf16* __restrict__ k,      // (B, K, Sk, 64)
               const bf16* __restrict__ v,      // (B, K, Sk, 64)
               const bf16* __restrict__ dO,     // (B, H, S, 64)
               const float* __restrict__ lse,   // (B, H, S)
               const float* __restrict__ delta, // (B, H, S)
               float* __restrict__ pk,          // (B, H, Sk, 64)
               float* __restrict__ pv,          // (B, H, Sk, 64)
               int H, int K, int S, Mask mk, float scale) {
  constexpr int D = 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_s = base, v_s = base + kTileBytes;
  const uint32_t q_s = base + 2 * kTileBytes;    // 2 tiles
  const uint32_t do_s = base + 4 * kTileBytes;   // 2 tiles
  float* lse_s = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                          6 * kTileBytes);  // 2 x kBQ
  float* dl_s = lse_s + 2 * kBQ;                            // 2 x kBQ

  const KvBlock blk(H, K, S);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int key0 = blk.k0 + warp * 16 + (lane >> 2);   // keys key0, key0 + 8
  const int quad_col = 2 * (lane & 3);
  const long long qo = static_cast<long long>(blk.bh) * S;

  auto load_item = [&](int qt, int buf) {
    const int q0 = qt * kBQ;
    load_tile_sw(q_s + buf * kTileBytes, q + qo * D, q0, S, tid);
    load_tile_sw(do_s + buf * kTileBytes, dO + qo * D, q0, S, tid);
    if (tid < kBQ) {
      const int r = q0 + tid;
      const long long i = qo + (r < S ? r : 0);
      cp_async4(lse_s + buf * kBQ + tid, lse + i, r < S);
      cp_async4(dl_s + buf * kBQ + tid, delta + i, r < S);
    }
  };

  const long long kv_off = static_cast<long long>(blk.kvh) * mk.Sk * D;
  load_tile_sw(k_s, k + kv_off, blk.k0, mk.Sk, tid);
  load_tile_sw(v_s, v + kv_off, blk.k0, mk.Sk, tid);
  int qt = blk.next(mk, 0, S);
  if (qt >= 0) load_item(qt, 0);
  cp_async_commit();

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;
  const float c2 = scale * kLog2e;
  const uint64_t dK = desc_sw128(k_s), dV = desc_sw128(v_s);

  for (int buf = 0; qt >= 0; buf ^= 1) {
    const int nxt = blk.next(mk, qt + 1, S);
    if (nxt >= 0) {
      // buffer buf ^ 1 was last read before the __syncthreads that ended
      // the previous item
      load_item(nxt, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const int q0 = qt * kBQ;
    const uint32_t qt_s = q_s + buf * kTileBytes;
    const uint32_t dot_s = do_s + buf * kTileBytes;
    const uint64_t dQ = desc_sw128(qt_s), dD = desc_sw128(dot_s);

    float st[8][4], dpt[8][4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0>(st, dK + 2 * kk, dQ + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0>(dpt, dV + 2 * kk, dD + 2 * kk, kk);
    wg_commit();
    wg_wait_all();
    wg_fence_acc(st);
    wg_fence_acc(dpt);
    p_ds_t(st, dpt, lse_s + buf * kBQ, dl_s + buf * kBQ, mk, q0, blk.k0, key0,
           quad_col, c2);

    // every A fragment first: wgmma reads them after it is issued
    uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      acc_to_a<true>(st, kk, ph[kk], pl[kk]);
      acc_to_a<true>(dpt, kk, sh[kk], sl[kk]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      const uint64_t bdo = desc_sw128(dot_s + kk * 2048);
      const uint64_t bq = desc_sw128(qt_s + kk * 2048);
      wgmma_rs<1>(dv, ph[kk], bdo, 1);
      wgmma_rs<1>(dv, pl[kk], bdo, 1);
      wgmma_rs<1>(dk, sh[kk], bq, 1);
      wgmma_rs<1>(dk, sl[kk], bq, 1);
    }
    wg_commit();
    wg_wait_all();
    wg_fence_acc(dk);
    wg_fence_acc(dv);
    __syncthreads();  // every warp is done with buf before it is refilled
    qt = nxt;
  }
  cp_async_wait<0>();   // a key tile no q tile visits loaded K and V only
  store_partials<D>(dk, dv, pk, pv, blk.bh, mk.Sk, key0, quad_col);
}

// mma.sync, any D
template <int D>
constexpr size_t smem_bytes_dkdv_tc() {
  // K and V tiles, a double buffer of Q and dO tiles, and the two buffers'
  // lse and Delta
  return sizeof(bf16) * (D + kPad) * (2 * kBK + 4 * kBQ) +
         sizeof(float) * 4 * kBQ;
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC)
dkdv_kernel_tc(const bf16* __restrict__ q,      // (B, H, S, D)
               const bf16* __restrict__ k,      // (B, K, Sk, D)
               const bf16* __restrict__ v,      // (B, K, Sk, D)
               const bf16* __restrict__ dO,     // (B, H, S, D)
               const float* __restrict__ lse,   // (B, H, S)
               const float* __restrict__ delta, // (B, H, S)
               float* __restrict__ pk,          // (B, H, Sk, D)
               float* __restrict__ pv,          // (B, H, Sk, D)
               int H, int K, int S, Mask mk, float scale) {
  constexpr int LD = D + kPad;
  constexpr int NT = kBQ / 8;    // n-tiles of 8 q rows
  constexpr int KQ = D / 16;     // k-steps over D
  constexpr int NO = D / 8;      // output n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kBK * LD;
  bf16* q_s = v_s + kBK * LD;            // 2 x kBQ x LD
  bf16* do_s = q_s + 2 * kBQ * LD;       // 2 x kBQ x LD
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kBQ * LD);  // 2 x kBQ
  float* dl_s = lse_s + 2 * kBQ;                                 // 2 x kBQ

  const KvBlock blk(H, K, S);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int key0 = blk.k0 + warp * 16 + (lane >> 2);   // keys key0, key0 + 8
  const int quad_col = 2 * (lane & 3);
  const long long qo = static_cast<long long>(blk.bh) * S;

  auto load_item = [&](int qt, int buf) {
    const int q0 = qt * kBQ;
    load_tile<D>(q_s + buf * kBQ * LD, q + qo * D, q0, S, tid);
    load_tile<D>(do_s + buf * kBQ * LD, dO + qo * D, q0, S, tid);
    if (tid < kBQ) {
      const int r = q0 + tid;
      const long long i = qo + (r < S ? r : 0);
      cp_async4(lse_s + buf * kBQ + tid, lse + i, r < S);
      cp_async4(dl_s + buf * kBQ + tid, delta + i, r < S);
    }
  };

  const long long kv_off = static_cast<long long>(blk.kvh) * mk.Sk * D;
  load_tile<D>(k_s, k + kv_off, blk.k0, mk.Sk, tid);
  load_tile<D>(v_s, v + kv_off, blk.k0, mk.Sk, tid);
  int qt = blk.next(mk, 0, S);
  if (qt >= 0) load_item(qt, 0);
  cp_async_commit();

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;
  const float c2 = scale * kLog2e;

  for (int buf = 0; qt >= 0; buf ^= 1) {
    const int nxt = blk.next(mk, qt + 1, S);
    if (nxt >= 0) {
      load_item(nxt, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qt * kBQ;
    const bf16* qt_s = q_s + buf * kBQ * LD;
    const bf16* dot = do_s + buf * kBQ * LD;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x the 64 q rows
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_a<LD>(ka, k_s, warp * 16, kk, lane);
      ldsm_a<LD>(va, v_s, warp * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldsm_b_rows<LD>(b, qt_s, j, kk, lane);
        mma_bf16(st[j], ka, b[0], b[1]);
        mma_bf16(st[j + 1], ka, b[2], b[3]);
        ldsm_b_rows<LD>(b, dot, j, kk, lane);
        mma_bf16(dpt[j], va, b[0], b[1]);
        mma_bf16(dpt[j + 1], va, b[2], b[3]);
      }
    }
    p_ds_t(st, dpt, lse_s + buf * kBQ, dl_s + buf * kBQ, mk, q0, blk.k0, key0,
           quad_col, c2);

    // dV += P^T dO and dK += dS^T Q, 16 q rows a k-step
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      acc_to_a<true>(st, kk, ph, pl);
      acc_to_a<true>(dpt, kk, sh, sl);
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t b[4];
        ldsm_b_cols<LD>(b, dot, j, kk, lane);
        mma_bf16(dv_acc[j], ph, b[0], b[1]);
        mma_bf16(dv_acc[j + 1], ph, b[2], b[3]);
        mma_bf16(dv_acc[j], pl, b[0], b[1]);
        mma_bf16(dv_acc[j + 1], pl, b[2], b[3]);
        ldsm_b_cols<LD>(b, qt_s, j, kk, lane);
        mma_bf16(dk_acc[j], sh, b[0], b[1]);
        mma_bf16(dk_acc[j + 1], sh, b[2], b[3]);
        mma_bf16(dk_acc[j], sl, b[0], b[1]);
        mma_bf16(dk_acc[j + 1], sl, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
    qt = nxt;
  }
  cp_async_wait<0>();   // a key tile no q tile visits loaded K and V only
  store_partials<D>(dk_acc, dv_acc, pk, pv, blk.bh, mk.Sk, key0, quad_col);
}

// ---------------------------------------------------------------------------
// 3. dQ per (b, head, q tile) (bf16 inputs)
// ---------------------------------------------------------------------------

// dS of a (64 q rows x 64 keys) tile pair in place from the fragments of S
// and dP (fragment (j, e): row row0 + 8 (e / 2), key k0 + 8 j + quad_col +
// e % 2)
__device__ __forceinline__ void ds_of(float (&s)[8][4], const float (&dp)[8][4],
                                      const float (&l2)[2], const float (&dl)[2],
                                      const Mask& mk, int q0, int k0,
                                      int row0, int quad_col, float c2) {
  const bool part = mk.partial(q0, k0);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float p = exp2f(fmaf(s[j][e], c2, -l2[h]));
      if (part && !mk.visible(row0 + 8 * h, k0 + 8 * j + quad_col + (e & 1)))
        p = 0.0f;
      s[j][e] = p * (dp[j][e] - dl[h]);
    }
}

// dK, dV from the per-head partials (bf16 inputs): the blocks of the dQ
// launch past its q tiles.
struct Combine {
  static constexpr int kIters = 8;             // float4s a thread
  const float* pk;                             // (B, H, Sk, D)
  const float* pv;                             // (B, H, Sk, D)
  bf16* dk;                                    // (B, K, Sk, D)
  bf16* dv;                                    // (B, K, Sk, D)
  long long per_head, n4;                      // Sk D; B K Sk D / 4
  int H, K;
  float scale;

  // the grid rows (of B H blocks) the combine takes
  int rows(int BH) const {
    const long long blocks = (n4 + kIters * kThreadsTC - 1) /
                             (kIters * kThreadsTC);
    return static_cast<int>((blocks + BH - 1) / BH);
  }
  // four consecutive elements: the G query heads of the kv head summed in
  // head order, dK scaled, both rounded to bf16
  __device__ __forceinline__ void four(long long i) const {
    const long long e = 4 * i;                 // element of (B, K, Sk, D)
    const long long bkv = e / per_head, rem = e % per_head;
    const int G = H / K;
    const long long h0 = (bkv / K) * H + (bkv % K) * G;
    float4 sk = make_float4(0.0f, 0.0f, 0.0f, 0.0f), sv = sk;
    for (int g = 0; g < G; ++g) {
      const long long src = (h0 + g) * per_head + rem;
      const float4 a = *reinterpret_cast<const float4*>(pk + src);
      const float4 b = *reinterpret_cast<const float4*>(pv + src);
      sk.x += a.x, sk.y += a.y, sk.z += a.z, sk.w += a.w;
      sv.x += b.x, sv.y += b.y, sv.z += b.z, sv.w += b.w;
    }
    *reinterpret_cast<uint2*>(dk + e) = make_uint2(
        pack_bf16(sk.x * scale, sk.y * scale),
        pack_bf16(sk.z * scale, sk.w * scale));
    *reinterpret_cast<uint2*>(dv + e) =
        make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
  }
  // the block's slice of the float4s
  __device__ __forceinline__ void slice(long long blk) const {
#pragma unroll
    for (int r = 0; r < kIters; ++r) {
      const long long i = (blk * kIters + r) * kThreadsTC + threadIdx.x;
      if (i < n4) four(i);
    }
  }
};

// what both dQ kernels share: the block's head and q tile (the last q tile
// first), its rows' lse * log2(e) and Delta, and the bf16 store
struct QBlock {
  int bh, kvh, q0;
  __device__ __forceinline__ QBlock(int H, int K, int row, int n_qt) {
    bh = blockIdx.x;                                 // b * H + h
    kvh = (bh / H) * K + (bh % H) / (H / K);
    q0 = (n_qt - 1 - row) * kBQ;
  }
  __device__ __forceinline__ void rows(const float* lse, const float* delta,
                                       int row0, int S, float (&l2)[2],
                                       float (&dl)[2]) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      const long long i = static_cast<long long>(bh) * S + r;
      l2[h] = r < S ? lse[i] * kLog2e : inf();
      dl[h] = r < S ? delta[i] : 0.0f;
    }
  }
  template <int D>
  __device__ __forceinline__ void store(const float (&acc)[D / 8][4], bf16* dq,
                                        int row0, int quad_col, int S,
                                        float scale) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= S) continue;
      bf16* dst = dq + (static_cast<long long>(bh) * S + row) * D + quad_col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[j][2 * h] * scale,
                                  acc[j][2 * h + 1] * scale);
    }
  }
};

// wgmma, D = 64: S = Q K^T and dP = dO V^T (K-major), dQ += dS K (K
// MN-major), dS as register A operands
__global__ void __launch_bounds__(kThreadsTC)
dq_kernel_wg(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int H, int K, int S, Mask mk,
             float scale, int n_qt, Combine cb) {
  constexpr int D = 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, do_s = base + kTileBytes;
  const uint32_t k_s = base + 2 * kTileBytes;    // 2 tiles
  const uint32_t v_s = base + 4 * kTileBytes;    // 2 tiles

  const int row = blockIdx.y;
  if (row >= n_qt) {                  // the combine's rows
    cb.slice(static_cast<long long>(row - n_qt) * gridDim.x + blockIdx.x);
    return;
  }
  const QBlock blk(H, K, row, n_qt);
  const int Sk = mk.Sk;
  const long long q_off = static_cast<long long>(blk.bh) * S * D;
  const bf16* kp = k + static_cast<long long>(blk.kvh) * Sk * D;
  const bf16* vp = v + static_cast<long long>(blk.kvh) * Sk * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blk.q0 + warp * 16 + (lane >> 2);   // rows row0, row0 + 8
  const int quad_col = 2 * (lane & 3);

  const Tiles tiles = tiles_of(mk, blk.q0, S);
  load_tile_sw(q_s, q + q_off, blk.q0, S, tid);
  load_tile_sw(do_s, dO + q_off, blk.q0, S, tid);
  if (tiles.n > 0) {
    load_tile_sw(k_s, kp, tiles[0] * kBK, Sk, tid);
    load_tile_sw(v_s, vp, tiles[0] * kBK, Sk, tid);
  }
  cp_async_commit();
  float l2[2], dl[2];
  blk.rows(lse, delta, row0, S, l2, dl);
  const float c2 = scale * kLog2e;
  const uint64_t dQ = desc_sw128(q_s), dD = desc_sw128(do_s);
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int i = 0; i < tiles.n; ++i) {
    const int buf = i & 1;
    if (i + 1 < tiles.n) {
      const int k1 = tiles[i + 1] * kBK;
      load_tile_sw(k_s + (buf ^ 1) * kTileBytes, kp, k1, Sk, tid);
      load_tile_sw(v_s + (buf ^ 1) * kTileBytes, vp, k1, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const int k0 = tiles[i] * kBK;
    const uint32_t kt_s = k_s + buf * kTileBytes;
    const uint32_t vt_s = v_s + buf * kTileBytes;
    const uint64_t dK = desc_sw128(kt_s), dV = desc_sw128(vt_s);

    float s[8][4], dp[8][4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0>(s, dQ + 2 * kk, dK + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0>(dp, dD + 2 * kk, dV + 2 * kk, kk);
    wg_commit();
    wg_wait_all();
    wg_fence_acc(s);
    wg_fence_acc(dp);
    ds_of(s, dp, l2, dl, mk, blk.q0, k0, row0, quad_col, c2);

    uint32_t sh[4][4], sl[4][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      acc_to_a<true>(s, kk, sh[kk], sl[kk]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t bk = desc_sw128(kt_s + kk * 2048);
      wgmma_rs<1>(acc, sh[kk], bk, 1);
      wgmma_rs<1>(acc, sl[kk], bk, 1);
    }
    wg_commit();
    wg_wait_all();
    wg_fence_acc(acc);
    __syncthreads();  // every warp is done with buf before it is refilled
  }
  blk.store<D>(acc, dq, row0, quad_col, S, scale);
}

// mma.sync, any D
template <int D>
constexpr size_t smem_bytes_dq_tc() {
  // Q and dO tiles, a double buffer of K and V tiles
  return sizeof(bf16) * (D + kPad) * (2 * kBQ + 4 * kBK);
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC)
dq_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int H, int K, int S, Mask mk,
             float scale, int n_qt, Combine cb) {
  constexpr int LD = D + kPad;
  constexpr int NT = kBK / 8;    // n-tiles of 8 keys
  constexpr int KQ = D / 16;     // k-steps over D
  constexpr int NO = D / 8;      // output n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kBQ * LD;
  bf16* k_s = do_s + kBQ * LD;           // 2 x kBK x LD
  bf16* v_s = k_s + 2 * kBK * LD;        // 2 x kBK x LD

  const int row = blockIdx.y;
  if (row >= n_qt) {                  // the combine's rows
    cb.slice(static_cast<long long>(row - n_qt) * gridDim.x + blockIdx.x);
    return;
  }
  const QBlock blk(H, K, row, n_qt);
  const int Sk = mk.Sk;
  const long long q_off = static_cast<long long>(blk.bh) * S * D;
  const bf16* kp = k + static_cast<long long>(blk.kvh) * Sk * D;
  const bf16* vp = v + static_cast<long long>(blk.kvh) * Sk * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blk.q0 + warp * 16 + (lane >> 2);   // rows row0, row0 + 8
  const int quad_col = 2 * (lane & 3);

  const Tiles tiles = tiles_of(mk, blk.q0, S);
  load_tile<D>(q_s, q + q_off, blk.q0, S, tid);
  load_tile<D>(do_s, dO + q_off, blk.q0, S, tid);
  cp_async_commit();
  if (tiles.n > 0) {
    load_tile<D>(k_s, kp, tiles[0] * kBK, Sk, tid);
    load_tile<D>(v_s, vp, tiles[0] * kBK, Sk, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[KQ][4], df[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    ldsm_a<LD>(qf[kk], q_s, warp * 16, kk, lane);
    ldsm_a<LD>(df[kk], do_s, warp * 16, kk, lane);
  }
  float l2[2], dl[2];
  blk.rows(lse, delta, row0, S, l2, dl);
  const float c2 = scale * kLog2e;
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int i = 0; i < tiles.n; ++i) {
    const int buf = i & 1;
    if (i + 1 < tiles.n) {
      const int k1 = tiles[i + 1] * kBK;
      load_tile<D>(k_s + (buf ^ 1) * kBK * LD, kp, k1, Sk, tid);
      load_tile<D>(v_s + (buf ^ 1) * kBK * LD, vp, k1, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = tiles[i] * kBK;
    const bf16* kt = k_s + buf * kBK * LD;
    const bf16* vt = v_s + buf * kBK * LD;

    // S = Q K^T and dP = dO V^T
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldsm_b_rows<LD>(b, kt, j, kk, lane);
        mma_bf16(s[j], qf[kk], b[0], b[1]);
        mma_bf16(s[j + 1], qf[kk], b[2], b[3]);
        ldsm_b_rows<LD>(b, vt, j, kk, lane);
        mma_bf16(dp[j], df[kk], b[0], b[1]);
        mma_bf16(dp[j + 1], df[kk], b[2], b[3]);
      }
    }
    ds_of(s, dp, l2, dl, mk, blk.q0, k0, row0, quad_col, c2);
    // dQ += dS K, 16 keys a k-step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t sh[4], sl[4];
      acc_to_a<true>(s, kk, sh, sl);
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t b[4];
        ldsm_b_cols<LD>(b, kt, j, kk, lane);
        mma_bf16(acc[j], sh, b[0], b[1]);
        mma_bf16(acc[j + 1], sh, b[2], b[3]);
        mma_bf16(acc[j], sl, b[0], b[1]);
        mma_bf16(acc[j + 1], sl, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }
  blk.store<D>(acc, dq, row0, quad_col, S, scale);
}

// ---------------------------------------------------------------------------
// fp32: IEEE FMAs
// ---------------------------------------------------------------------------

// rows [row0, row0 + 64) of src (n_rows rows, D floats each) into dst with
// pitch D + 1; rows past n_rows read as 0
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int n_rows) {
  for (int i = threadIdx.x; i < kBK * D; i += kThreadsF) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] =
        row0 + r < n_rows ? src[static_cast<long long>(row0 + r) * D + d]
                          : 0.0f;
  }
}

template <int D>
constexpr size_t smem_bytes_dkdv_f32() {
  return sizeof(float) * (4 * kBK * (D + 1) + 2 * kBQ + 2 * kBK * (kBQ + 1));
}

// one block per (batch * kv head, 64-key tile); thread 4 c + ph owns key c
// of the tile and output columns ph + 4 j
template <int D>
__global__ void __launch_bounds__(kThreadsF)
dkdv_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dO,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int H, int K, int S, Mask mk,
                float scale) {
  constexpr int LD = D + 1, LP = kBQ + 1;
  extern __shared__ float smem[];
  float* k_s = smem;                 // kBK x LD
  float* v_s = k_s + kBK * LD;       // kBK x LD
  float* q_s = v_s + kBK * LD;       // kBQ x LD
  float* do_s = q_s + kBQ * LD;      // kBQ x LD
  float* lse_s = do_s + kBQ * LD;    // kBQ
  float* dl_s = lse_s + kBQ;         // kBQ
  float* p_s = dl_s + kBQ;           // kBK x LP: p[key][row]
  float* ds_s = p_s + kBK * LP;      // kBK x LP

  const int bkv = blockIdx.y;
  const int G = H / K;
  const int hq0 = (bkv / K) * H + (bkv % K) * G;
  const int t_kv = blockIdx.x;
  const int k0 = t_kv * kBK;
  const int Sk = mk.Sk;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int c = threadIdx.x >> 2, ph = threadIdx.x & 3;
  const int key = k0 + c;
  const long long kv_off = static_cast<long long>(bkv) * Sk * D;
  load_tile_f32<D>(k_s, k + kv_off, k0, Sk);
  load_tile_f32<D>(v_s, v + kv_off, k0, Sk);

  float dk_acc[D / 4], dv_acc[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) dk_acc[j] = dv_acc[j] = 0.0f;

  for (int it = 0; it < G * n_qt; ++it) {
    const int q0 = (it % n_qt) * kBQ;
    if (!tiles_of(mk, q0, S).visits(t_kv)) continue;   // same for the block
    const long long bh = hq0 + it / n_qt;
    __syncthreads();  // the previous item's readers are done
    load_tile_f32<D>(q_s, q + bh * S * D, q0, S);
    load_tile_f32<D>(do_s, dO + bh * S * D, q0, S);
    if (threadIdx.x < kBQ) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < S ? lse[bh * S + r] : inf();
      dl_s[threadIdx.x] = r < S ? delta[bh * S + r] : 0.0f;
    }
    __syncthreads();

    // scores and dP of key c against q rows ph + 4 j
    float s[kBQ / 4], dp[kBQ / 4];
#pragma unroll
    for (int j = 0; j < kBQ / 4; ++j) s[j] = dp[j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float kc = k_s[c * LD + d], vc = v_s[c * LD + d];
#pragma unroll
      for (int j = 0; j < kBQ / 4; ++j) {
        s[j] = fmaf(q_s[(ph + 4 * j) * LD + d], kc, s[j]);
        dp[j] = fmaf(do_s[(ph + 4 * j) * LD + d], vc, dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBQ / 4; ++j) {
      const int r = ph + 4 * j;
      const float p = mk.visible(q0 + r, key)
                          ? expf(s[j] * scale - lse_s[r]) : 0.0f;
      p_s[c * LP + r] = p;
      ds_s[c * LP + r] = p * (dp[j] - dl_s[r]);
    }
    __syncwarp();  // key c's p and dS were written by the lanes that read them
    for (int r = 0; r < kBQ; ++r) {
      const float p = p_s[c * LP + r], ds = ds_s[c * LP + r];
#pragma unroll
      for (int j = 0; j < D / 4; ++j) {
        dv_acc[j] = fmaf(p, do_s[r * LD + ph + 4 * j], dv_acc[j]);
        dk_acc[j] = fmaf(ds, q_s[r * LD + ph + 4 * j], dk_acc[j]);
      }
    }
  }
  if (key < Sk) {
    const long long off = kv_off + static_cast<long long>(key) * D;
#pragma unroll
    for (int j = 0; j < D / 4; ++j) {
      dk[off + ph + 4 * j] = dk_acc[j] * scale;
      dv[off + ph + 4 * j] = dv_acc[j];
    }
  }
}

template <int D>
constexpr size_t smem_bytes_dq_f32() {
  return sizeof(float) * (4 * kBK * (D + 1) + kBQ * (kBK + 1));
}

// one block per (batch * head, 64-row q tile); thread 4 r + ph owns q row r
// of the tile and output columns ph + 4 j
template <int D>
__global__ void __launch_bounds__(kThreadsF)
dq_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dO,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int H, int K, int S, Mask mk,
              float scale) {
  constexpr int LD = D + 1, LP = kBK + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                 // kBQ x LD
  float* do_s = q_s + kBQ * LD;      // kBQ x LD
  float* k_s = do_s + kBQ * LD;      // kBK x LD
  float* v_s = k_s + kBK * LD;       // kBK x LD
  float* ds_s = v_s + kBK * LD;      // kBQ x LP

  const int bh = blockIdx.y;
  const int kvh = (bh / H) * K + (bh % H) / (H / K);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int Sk = mk.Sk;
  const long long q_off = static_cast<long long>(bh) * S * D;
  const float* kp = k + static_cast<long long>(kvh) * Sk * D;
  const float* vp = v + static_cast<long long>(kvh) * Sk * D;
  const int r = threadIdx.x >> 2, ph = threadIdx.x & 3;
  const int row = q0 + r;
  load_tile_f32<D>(q_s, q + q_off, q0, S);
  load_tile_f32<D>(do_s, dO + q_off, q0, S);
  const float l = row < S ? lse[static_cast<long long>(bh) * S + row] : inf();
  const float dl = row < S ? delta[static_cast<long long>(bh) * S + row] : 0.0f;

  float acc[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc[j] = 0.0f;

  const Tiles tiles = tiles_of(mk, q0, S);
  for (int i = 0; i < tiles.n; ++i) {
    const int k0 = tiles[i] * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_tile_f32<D>(k_s, kp, k0, Sk);
    load_tile_f32<D>(v_s, vp, k0, Sk);
    __syncthreads();

    // scores and dP of row r against keys ph + 4 j, in the forward's order
    float s[kBK / 4], dp[kBK / 4];
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) s[j] = dp[j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float qv = q_s[r * LD + d], dov = do_s[r * LD + d];
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j) {
        s[j] = fmaf(qv, k_s[(ph + 4 * j) * LD + d], s[j]);
        dp[j] = fmaf(dov, v_s[(ph + 4 * j) * LD + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const float p = mk.visible(row, k0 + ph + 4 * j)
                          ? expf(s[j] * scale - l) : 0.0f;
      ds_s[r * LP + ph + 4 * j] = p * (dp[j] - dl);
    }
    __syncwarp();  // row r's dS was written by the lanes that read it
    for (int c = 0; c < kBK; ++c) {
      const float ds = ds_s[r * LP + c];
#pragma unroll
      for (int j = 0; j < D / 4; ++j)
        acc[j] = fmaf(ds, k_s[c * LD + ph + 4 * j], acc[j]);
    }
  }
  if (row < S) {
#pragma unroll
    for (int j = 0; j < D / 4; ++j)
      dq[q_off + static_cast<long long>(row) * D + ph + 4 * j] =
          acc[j] * scale;
  }
}


// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// the scratch, in floats: Delta (B H S), then, for bf16, the fp32 dK and dV
// partials of every query head (B H Sk D each), from a multiple of 4
struct Scratch {
  long long delta, part;
  long long part_at() const { return (delta + 3) & ~3LL; }
  long long floats() const { return part_at() + 2 * part; }
};

Scratch scratch_of(int B, int H, int S, int Sk, int D, int bf16_in) {
  return Scratch{static_cast<long long>(B) * H * S,
                 bf16_in ? static_cast<long long>(B) * H * Sk * D : 0};
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dO, const float* lse, float* scratch,
                   long long scratch_floats, void* dq, void* dk, void* dv,
                   int B, int H, int K, int S, Mask mk, float scale,
                   int bf16_in, cudaStream_t stream) {
  const Scratch sc = scratch_of(B, H, S, mk.Sk, D, bf16_in);
  if (sc.floats() > scratch_floats) return cudaErrorInvalidValue;
  float* delta = scratch;
  const long long rows = static_cast<long long>(B) * H * S;
  const int n_kt = (mk.Sk + kBK - 1) / kBK, n_qt = (S + kBQ - 1) / kBQ;
  cudaError_t err;
  if (bf16_in) {
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
               *vb = static_cast<const bf16*>(v), *ob = static_cast<const bf16*>(o),
               *db = static_cast<const bf16*>(dO);
    float* pk = scratch + sc.part_at();
    float* pv = pk + sc.part;
    // the key tile (dK/dV) and the q tile (dQ) are the slow grid axes, so
    // the blocks with the most tiles to visit start first
    const dim3 grid_kv(B * H, n_kt);
    delta_kernel_bf16<<<static_cast<unsigned>((rows + 31) / 32), 256, 0,
                        stream>>>(ob, db, delta, rows, D);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if constexpr (D == 64) {
      constexpr size_t s_kv = smem_bytes_wg();
      if ((err = allow_smem(dkdv_kernel_wg, s_kv)) != cudaSuccess) return err;
      dkdv_kernel_wg<<<grid_kv, kThreadsTC, s_kv, stream>>>(
          qb, kb, vb, db, lse, delta, pk, pv, H, K, S, mk, scale);
    } else {
      constexpr size_t s_kv = smem_bytes_dkdv_tc<D>();
      if ((err = allow_smem(dkdv_kernel_tc<D>, s_kv)) != cudaSuccess)
        return err;
      dkdv_kernel_tc<D><<<grid_kv, kThreadsTC, s_kv, stream>>>(
          qb, kb, vb, db, lse, delta, pk, pv, H, K, S, mk, scale);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // dQ and the combine: one launch, the combine's rows after the q tiles
    const Combine cb{pk, pv, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                     static_cast<long long>(mk.Sk) * D,
                     static_cast<long long>(B) * K * mk.Sk * D / 4, H, K,
                     scale};
    const dim3 grid_q(B * H, n_qt + cb.rows(B * H));
    bf16* dqb = static_cast<bf16*>(dq);
    if constexpr (D == 64) {
      constexpr size_t s_q = smem_bytes_wg();
      if ((err = allow_smem(dq_kernel_wg, s_q)) != cudaSuccess) return err;
      dq_kernel_wg<<<grid_q, kThreadsTC, s_q, stream>>>(
          qb, kb, vb, db, lse, delta, dqb, H, K, S, mk, scale, n_qt, cb);
    } else {
      constexpr size_t s_q = smem_bytes_dq_tc<D>();
      if ((err = allow_smem(dq_kernel_tc<D>, s_q)) != cudaSuccess) return err;
      dq_kernel_tc<D><<<grid_q, kThreadsTC, s_q, stream>>>(
          qb, kb, vb, db, lse, delta, dqb, H, K, S, mk, scale, n_qt, cb);
    }
    return cudaGetLastError();
  }
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *of = static_cast<const float*>(o),
              *df = static_cast<const float*>(dO);
  delta_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      of, df, delta, rows, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t s_kv = smem_bytes_dkdv_f32<D>();
  if ((err = allow_smem(dkdv_kernel_f32<D>, s_kv)) != cudaSuccess) return err;
  dkdv_kernel_f32<D><<<dim3(n_kt, B * K), kThreadsF, s_kv, stream>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), H, K, S, mk, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t s_q = smem_bytes_dq_f32<D>();
  if ((err = allow_smem(dq_kernel_f32<D>, s_q)) != cudaSuccess) return err;
  dq_kernel_f32<D><<<dim3(n_qt, B * H), kThreadsF, s_q, stream>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dq), H, K, S, mk,
      scale);
  return cudaGetLastError();
}

}  // namespace

// The floats of scratch a launch at this shape needs (0: a D not taken).
extern "C" long long flash_attention_bwd_scratch_floats(int B, int H, int K,
                                                        int S, int Sk, int D,
                                                        int bf16_in) {
  if (B <= 0 || H <= 0 || K <= 0 || S < 0 || Sk < 0) return 0;
  switch (D) {
    case 16: case 32: case 64: case 96: case 128:
      return scratch_of(B, H, S, Sk, D, bf16_in).floats();
    default: return 0;
  }
}

// Launch on `stream`; returns the cudaError_t of the first launch that
// failed (0 = success). Same layouts, D, mask arguments and dtype switch as
// flash_attention_launch (window <= 0: no window); o and lse are the
// forward's outputs (lse from a launch that asked for it), dO has o's
// layout and dtype (bf16: o and dO 16-byte aligned), scratch holds
// scratch_floats floats, at least flash_attention_bwd_scratch_floats(...),
// and dq, dk, dv take q's, k's and v's layouts and dtype. p is taken in
// fp32 (round_p = 0).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const float* lse, float* scratch, long long scratch_floats,
    void* dq, void* dk, void* dv, int B, int H, int K, int S, int Sk, int D,
    float scale, int bf16_in, int causal, int window, int sink,
    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (K <= 0 || H % K != 0 || Sk <= 0 || sink < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask mk{Sk, causal, window, sink};
  switch (D) {
    case 16: return launch<16>(q, k, v, o, dO, lse, scratch, scratch_floats, dq, dk, dv, B, H, K, S, mk, scale, bf16_in, s);
    case 32: return launch<32>(q, k, v, o, dO, lse, scratch, scratch_floats, dq, dk, dv, B, H, K, S, mk, scale, bf16_in, s);
    case 64: return launch<64>(q, k, v, o, dO, lse, scratch, scratch_floats, dq, dk, dv, B, H, K, S, mk, scale, bf16_in, s);
    case 96: return launch<96>(q, k, v, o, dO, lse, scratch, scratch_floats, dq, dk, dv, B, H, K, S, mk, scale, bf16_in, s);
    case 128: return launch<128>(q, k, v, o, dO, lse, scratch, scratch_floats, dq, dk, dv, B, H, K, S, mk, scale, bf16_in, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
