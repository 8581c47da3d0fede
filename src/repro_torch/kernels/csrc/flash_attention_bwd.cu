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
// As the forward, it takes a value head dim DV apart from the query/key one
// D (template arguments; MLA's (192, 128), and (32, 16) for the reduced MLA,
// whose q and k the wrapper pads from 24 with zeros): S, dQ and dK are D
// wide, while Delta, dP = dO V^T and dV = P^T dO run over DV. With DV = D
// each kernel keeps the loops of the one-D kernel it was.
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
//      partials of its head to the scratch (B H Sk (D + DV) floats);
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
// bf16 at (D, DV) = (128, 128) (the dense family's heads, moonshot's),
// MLA's (192, 128) (deepseek-v3's training path) and (96, 96)
// (phi-3-vision-4.2b's heads): wgmma too, with two warpgroups a block
// (dkdv_kernel_wg2, dq_kernel_wg2). One warpgroup cannot hold a dK/dV
// block's sums (at (192, 128) dK 96 fp32 registers a thread, dV 64, S^T
// and dP^T 32 each; at (128, 128) 64 + 64 + 32 + 32; at (96, 96) 48 + 48 +
// 32 + 32 and the fixed A operand's 24 beside them: the mma.sync kernels
// these replace held 255 registers and spilled 428 and 128 bytes at the
// first two). Of the two splits weighed -- (a) two consumer warpgroups sharing
// P^T and dS^T through shared memory, (b) dK and dV in blocks of their own,
// S^T computed in both (+23 % of the stage's products at (192, 128)) --
// this is (a), split by gradient rather than by columns: dK's and dV's 96 +
// 96 / 64 + 64 columns would need MN-major operands starting inside a
// 128-byte swizzle atom of Q's and dO's slabs, and S^T cut by q columns
// (m64n32) reads more shared memory a flop.
//   - dK/dV: warpgroup 0 computes S^T = K Q^T, P^T and dV += P^T dO;
//     warpgroup 1 dP^T = V dO^T, dS^T = P^T (dP^T - Delta) and dK += dS^T
//     Q. P^T goes over in fp32 through shared memory at a named barrier, so
//     every product is done once and P^T and dS^T are register A operands
//     (bf16 hi + lo) of the warpgroup that made them. K's (warpgroup 0) and
//     V's (1) A operands stay in registers for the block's walk. dQ: warp-
//     group 0 computes S = Q K^T and dP = dO V^T (Q's and dO's A operands in
//     registers) and dS, warpgroup 1 dQ += dS K;
//   - the streamed tiles (Q, dO with lse and Delta; K, V) are 64-column
//     slabs in the 128-byte swizzle (D / 64 for Q and K, DV / 64 for dO and
//     V), read K-major by the first products and MN-major by the second
//     (m64n64k16 chains; m64n128k16 over two slabs, below); at D = 96,
//     whose 192-byte rows are no whole number of 128-byte lines, three
//     32-column slabs in the 64-byte swizzle each (slab_cols, the
//     forward's layout; load_rows fills them, ldsm_a_slabs reads the fixed
//     A operands out of them): the first products six m64n64k16 k-steps,
//     two a slab, the second one m64n96k16 a k-step over all three slabs
//     (the descriptor's leading byte offset their stride), so that nothing
//     is padded and no product runs on zeros; the tiles pass
//     through a ring of three slots that warpgroup 1 fills two items ahead
//     with cp.async and hands over at named barriers, and warpgroup 0 runs
//     up to an item ahead of it;
//   - the query heads of a dK/dV block: where the launch still has
//     kSumHeadsBlocks (512, ~4 waves of one block an SM) blocks with one
//     a kv head, a block takes the kv head's G query heads in turn (its
//     items are G x its q tiles, (head, q tile) packed in an int so that a
//     step divides nothing) and stores dK and dV itself (bf16, through
//     shared memory, 16 bytes a store), so at one query head a kv head
//     always; else (granite-34b's MQA: 72 such blocks at (4, 48, 1,
//     1,128)) a block a query head writes its fp32 partials, which the dQ
//     launch's combine blocks sum in head order (Combine::slice, on the
//     first warpgroup: with all 256 threads, each thread's loads of a
//     head in flight together, half as many blocks left granite's combine
//     on 71 of the 132 SMs, and slower). At
//     internlm2-1.8b's shape (G = 2, 576 blocks) the partials' round trip
//     and the combine cost more than the longer blocks' imbalance, which
//     PR 19 left this design for at G = 5 and which the key tile as the
//     slow axis keeps small here (2 to 36 items a block, ~83 an SM);
//   - a one-dimensional grid of these units by key tiles: the key tile
//     the slow axis (the blocks with the most items start first) where a
//     block sums G > 1 heads (the blocks of a kv head walk the same Q and
//     dO together) or every head's Q and dO fit in the L2 (kL2Bytes: 37
//     MB at internlm2's and moonshot's shapes); a unit's tiles adjacent
//     otherwise, so that the blocks on the card at once share their heads'
//     streamed tiles in L2 (at deepseek-v3's shape, 328 MB of Q and dO:
//     2.13-2.16 ms against 2.66 with the tile on the slow axis); dQ's grid
//     has a head's q tiles adjacent, the last first (the q tile as the
//     slow axis was no faster);
//   - each item's second product is issued together with the next item's
//     first (hi + lo operands converted a k-step at a time, just before its
//     products), so one warpgroup's elementwise work runs under the
//     other's products (issuing warpgroup 0's next S^T first and making
//     P^T under dV, or splitting dQ's work as dK/dV's, was no faster), and
//     a product over two 64-column slabs (dV; dK and dQ at D = 128) is one
//     m64n128k16 a k-step, the same sums bit for bit as two m64n64k16;
//     each choice measured by tools/attention_bwd_variants.py (PERF.md,
//     PR 28);
//   - 195 KB (192, 128) / 163 KB (128, 128) / 130 KB (96, 96) of shared
//     memory and 256 threads a block, one block an SM; -Xptxas -v: no spill
//     stores (chip_smoke.py phase 19 prints the registers and fails on a
//     spill).
// The other bf16 (D, DV) -- the reduced configs' (32, 32), (16, 16), (32,
// 16): mma.sync m16n8k16 with the same work split as D = 64 (dkdv_kernel_tc,
// dq_kernel_tc: 4 warps of 16 keys or rows, ldmatrix fragments, rows padded
// by 16 bytes); (96, 96) ran on them too before the two-warpgroup pair took
// it.
// fp32 inputs: IEEE fp32 FMAs out of shared memory (no TF32), four threads
// a key (dK, dV) or a q row (dQ); their dK/dV kernel sums the G heads
// inside the block. No --use_fast_math.

#include <type_traits>

#include "wgmma.cuh"

namespace {

using namespace fa;
using bf16 = __nv_bfloat16;

constexpr int kThreadsF = 256;   // fp32 kernels: 4 threads a key or row

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// ---------------------------------------------------------------------------
// 1. Delta = rowsum(dO * O), fp32
// ---------------------------------------------------------------------------

// fp32: a warp a row (o and dO are Dv wide)
__global__ void __launch_bounds__(256)
delta_kernel(const float* __restrict__ o, const float* __restrict__ dO,
             float* __restrict__ delta, long long rows, int Dv) {
  const long long row = blockIdx.x * 8LL + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.0f;
  for (int d = lane; d < Dv; d += 32)
    acc = fmaf(dO[row * Dv + d], o[row * Dv + d], acc);
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) delta[row] = acc;
}

// bf16: 8 lanes a row, 8 values (16 bytes) a load, a lane's loads all
// issued before its sums
template <int DV>
__global__ void __launch_bounds__(256)
delta_kernel_bf16(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                  float* __restrict__ delta, long long rows) {
  constexpr int kChunks = DV / 8, kPer = (kChunks + 7) / 8;
  const long long row = blockIdx.x * 32LL + (threadIdx.x >> 3);
  const int l8 = threadIdx.x & 7;
  float acc = 0.0f;
  if (row < rows) {
    uint4 ov[kPer], dv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = l8 + 8 * i;
      if (c >= kChunks) continue;
      ov[i] = *reinterpret_cast<const uint4*>(o + row * DV + 8 * c);
      dv[i] = *reinterpret_cast<const uint4*>(dO + row * DV + 8 * c);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (l8 + 8 * i >= kChunks) continue;
      const bf16* op = reinterpret_cast<const bf16*>(&ov[i]);
      const bf16* dp = reinterpret_cast<const bf16*>(&dv[i]);
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
// 2. dK, dV per (b, query head, key tile), fp32 partials (bf16 inputs)
// ---------------------------------------------------------------------------

// what both dK/dV kernels share: the block's head and key tile, and the
// q tiles that visit the key tile, in increasing order
struct KvBlock {
  int bh, kvh, t_kv, k0, n_qt;
  // head bh_ (b * H + h), key tile t
  __device__ __forceinline__ KvBlock(int H, int K, int S, int bh_, int t) {
    bh = bh_;
    kvh = (bh / H) * K + (bh % H) / (H / K);
    t_kv = t;
    k0 = t_kv * kBK;
    n_qt = (S + kBQ - 1) / kBQ;
  }
  // the head on the grid's x axis, the key tile on its y axis
  __device__ __forceinline__ KvBlock(int H, int K, int S)
      : KvBlock(H, K, S, blockIdx.x, blockIdx.y) {}
  // the first q tile >= qt whose walk visits the key tile, or -1
  __device__ __forceinline__ int next(const Mask& mk, int qt, int S) const {
    for (; qt < n_qt; ++qt)
      if (tiles_of(mk, qt * kBQ, S).visits(t_kv)) return qt;
    return -1;
  }
  // over the nh query heads bh, bh + 1, ..: items g << 16 | qt (q tile
  // qt of head bh + g; no division a step); the first item at or past it
  // whose q tile visits the key tile, or -1
  __device__ __forceinline__ int next_item(const Mask& mk, int it, int S,
                                           int nh) const {
    for (int g = it >> 16, qt = it & 0xFFFF; g < nh; ++g, qt = 0)
      for (; qt < n_qt; ++qt)
        if (tiles_of(mk, qt * kBQ, S).visits(t_kv)) return g << 16 | qt;
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
// accumulator fragments, unscaled; dK is D wide, dV DV wide
template <int D, int DV>
__device__ __forceinline__ void store_partials(const float (&dk)[D / 8][4],
                                               const float (&dv)[DV / 8][4],
                                               float* pk, float* pv,
                                               long long bh, int Sk, int key0,
                                               int quad_col) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= Sk) continue;
    const long long row = bh * Sk + key;
    if constexpr (D == DV) {
      const long long off = row * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(pk + off + 8 * j + quad_col) =
            make_float2(dk[j][2 * h], dk[j][2 * h + 1]);
        *reinterpret_cast<float2*>(pv + off + 8 * j + quad_col) =
            make_float2(dv[j][2 * h], dv[j][2 * h + 1]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(pk + row * D + 8 * j + quad_col) =
            make_float2(dk[j][2 * h], dk[j][2 * h + 1]);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<float2*>(pv + row * DV + 8 * j + quad_col) =
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
  store_partials<D, D>(dk, dv, pk, pv, blk.bh, mk.Sk, key0, quad_col);
}

// mma.sync, any (D, DV)
template <int D, int DV>
constexpr size_t smem_bytes_dkdv_tc() {
  // K and V tiles, a double buffer of Q and dO tiles, and the two buffers'
  // lse and Delta
  return sizeof(bf16) * ((D + kPad) + (DV + kPad)) * (kBK + 2 * kBQ) +
         sizeof(float) * 4 * kBQ;
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreadsTC)
dkdv_kernel_tc(const bf16* __restrict__ q,      // (B, H, S, D)
               const bf16* __restrict__ k,      // (B, K, Sk, D)
               const bf16* __restrict__ v,      // (B, K, Sk, DV)
               const bf16* __restrict__ dO,     // (B, H, S, DV)
               const float* __restrict__ lse,   // (B, H, S)
               const float* __restrict__ delta, // (B, H, S)
               float* __restrict__ pk,          // (B, H, Sk, D)
               float* __restrict__ pv,          // (B, H, Sk, DV)
               int H, int K, int S, Mask mk, float scale) {
  constexpr int LD = D + kPad, LDV = DV + kPad;
  constexpr int NT = kBQ / 8;    // n-tiles of 8 q rows
  constexpr int KQ = D / 16;     // k-steps over D
  constexpr int KV = DV / 16;    // k-steps over DV
  constexpr int NO = D / 8;      // dK's n-tiles of 8 columns
  constexpr int NOV = DV / 8;    // dV's
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kBK * LD;            // kBK x LDV
  bf16* q_s = v_s + kBK * LDV;           // 2 x kBQ x LD
  bf16* do_s = q_s + 2 * kBQ * LD;       // 2 x kBQ x LDV
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kBQ * LDV);  // 2 x kBQ
  float* dl_s = lse_s + 2 * kBQ;                                  // 2 x kBQ

  const KvBlock blk(H, K, S);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int key0 = blk.k0 + warp * 16 + (lane >> 2);   // keys key0, key0 + 8
  const int quad_col = 2 * (lane & 3);
  const long long qo = static_cast<long long>(blk.bh) * S;

  auto load_item = [&](int qt, int buf) {
    const int q0 = qt * kBQ;
    load_tile<D>(q_s + buf * kBQ * LD, q + qo * D, q0, S, tid);
    load_tile<DV>(do_s + buf * kBQ * LDV, dO + qo * DV, q0, S, tid);
    if (tid < kBQ) {
      const int r = q0 + tid;
      const long long i = qo + (r < S ? r : 0);
      cp_async4(lse_s + buf * kBQ + tid, lse + i, r < S);
      cp_async4(dl_s + buf * kBQ + tid, delta + i, r < S);
    }
  };

  const long long kv_row = static_cast<long long>(blk.kvh) * mk.Sk;
  load_tile<D>(k_s, k + kv_row * D, blk.k0, mk.Sk, tid);
  load_tile<DV>(v_s, v + kv_row * DV, blk.k0, mk.Sk, tid);
  int qt = blk.next(mk, 0, S);
  if (qt >= 0) load_item(qt, 0);
  cp_async_commit();

  float dk_acc[NO][4], dv_acc[NOV][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = 0.0f;
#pragma unroll
  for (int j = 0; j < NOV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv_acc[j][e] = 0.0f;
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
    const bf16* dot = do_s + buf * kBQ * LDV;

    // S^T = K Q^T (over D) and dP^T = V dO^T (over DV): this warp's 16
    // keys x the 64 q rows
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
    if constexpr (D == DV) {
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
    } else {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        uint32_t ka[4];
        ldsm_a<LD>(ka, k_s, warp * 16, kk, lane);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          ldsm_b_rows<LD>(b, qt_s, j, kk, lane);
          mma_bf16(st[j], ka, b[0], b[1]);
          mma_bf16(st[j + 1], ka, b[2], b[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < KV; ++kk) {
        uint32_t va[4];
        ldsm_a<LDV>(va, v_s, warp * 16, kk, lane);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          ldsm_b_rows<LDV>(b, dot, j, kk, lane);
          mma_bf16(dpt[j], va, b[0], b[1]);
          mma_bf16(dpt[j + 1], va, b[2], b[3]);
        }
      }
    }
    p_ds_t(st, dpt, lse_s + buf * kBQ, dl_s + buf * kBQ, mk, q0, blk.k0, key0,
           quad_col, c2);

    // dV += P^T dO (DV wide) and dK += dS^T Q (D wide), 16 q rows a
    // k-step
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      acc_to_a<true>(st, kk, ph, pl);
      acc_to_a<true>(dpt, kk, sh, sl);
      if constexpr (D == DV) {
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
      } else {
#pragma unroll
        for (int j = 0; j < NOV; j += 2) {
          uint32_t b[4];
          ldsm_b_cols<LDV>(b, dot, j, kk, lane);
          mma_bf16(dv_acc[j], ph, b[0], b[1]);
          mma_bf16(dv_acc[j + 1], ph, b[2], b[3]);
          mma_bf16(dv_acc[j], pl, b[0], b[1]);
          mma_bf16(dv_acc[j + 1], pl, b[2], b[3]);
        }
#pragma unroll
        for (int j = 0; j < NO; j += 2) {
          uint32_t b[4];
          ldsm_b_cols<LD>(b, qt_s, j, kk, lane);
          mma_bf16(dk_acc[j], sh, b[0], b[1]);
          mma_bf16(dk_acc[j + 1], sh, b[2], b[3]);
          mma_bf16(dk_acc[j], sl, b[0], b[1]);
          mma_bf16(dk_acc[j + 1], sl, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
    qt = nxt;
  }
  cp_async_wait<0>();   // a key tile no q tile visits loaded K and V only
  store_partials<D, DV>(dk_acc, dv_acc, pk, pv, blk.bh, mk.Sk, key0,
                        quad_col);
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

// The combine where DV != D: the float4s of dK (B K Sk D / 4 of them)
// first, then those of dV, each summed over its G query heads as above.
struct CombineKV {
  static constexpr int kIters = Combine::kIters;
  const float* pk;                             // (B, H, Sk, D)
  const float* pv;                             // (B, H, Sk, DV)
  bf16* dk;                                    // (B, K, Sk, D)
  bf16* dv;                                    // (B, K, Sk, DV)
  long long per_k, per_v;                      // Sk D; Sk DV
  long long n4k, n4;                           // dK's float4s; all
  int H, K;
  float scale;

  int rows(int BH) const {
    const long long blocks = (n4 + kIters * kThreadsTC - 1) /
                             (kIters * kThreadsTC);
    return static_cast<int>((blocks + BH - 1) / BH);
  }
  // four consecutive elements e.. of one (B, K, Sk, per / Sk) gradient
  __device__ __forceinline__ void sum4(const float* p, bf16* out,
                                       long long per, long long e,
                                       float s) const {
    const long long bkv = e / per, rem = e % per;
    const int G = H / K;
    const long long h0 = (bkv / K) * H + (bkv % K) * G;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int g = 0; g < G; ++g) {
      const float4 a =
          *reinterpret_cast<const float4*>(p + (h0 + g) * per + rem);
      acc.x += a.x, acc.y += a.y, acc.z += a.z, acc.w += a.w;
    }
    *reinterpret_cast<uint2*>(out + e) = make_uint2(
        pack_bf16(acc.x * s, acc.y * s), pack_bf16(acc.z * s, acc.w * s));
  }
  __device__ __forceinline__ void slice(long long blk) const {
#pragma unroll
    for (int r = 0; r < kIters; ++r) {
      const long long i = (blk * kIters + r) * kThreadsTC + threadIdx.x;
      if (i < n4k) sum4(pk, dk, per_k, 4 * i, scale);
      else if (i < n4) sum4(pv, dv, per_v, 4 * (i - n4k), 1.0f);
    }
  }
};

template <int D, int DV>
using CombineOf = std::conditional_t<D == DV, Combine, CombineKV>;

// what both dQ kernels share: the block's head and q tile (the last q tile
// first), its rows' lse * log2(e) and Delta, and the bf16 store
struct QBlock {
  int bh, kvh, q0;
  // head bh_ (b * H + h), the row-th q tile from the last
  __device__ __forceinline__ QBlock(int H, int K, int row, int n_qt, int bh_) {
    bh = bh_;
    kvh = (bh / H) * K + (bh % H) / (H / K);
    q0 = (n_qt - 1 - row) * kBQ;
  }
  // the head on the grid's x axis
  __device__ __forceinline__ QBlock(int H, int K, int row, int n_qt)
      : QBlock(H, K, row, n_qt, blockIdx.x) {}
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

// mma.sync, any (D, DV)
template <int D, int DV>
constexpr size_t smem_bytes_dq_tc() {
  // Q and dO tiles, a double buffer of K and V tiles
  return sizeof(bf16) * ((D + kPad) + (DV + kPad)) * (kBQ + 2 * kBK);
}

// Q's and dO's A fragments stay in registers for the whole kv loop.
template <int D, int DV>
__global__ void __launch_bounds__(kThreadsTC)
dq_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int H, int K, int S, Mask mk,
             float scale, int n_qt, CombineOf<D, DV> cb) {
  constexpr int LD = D + kPad, LDV = DV + kPad;
  constexpr int NT = kBK / 8;    // n-tiles of 8 keys
  constexpr int KQ = D / 16;     // k-steps over D
  constexpr int KV = DV / 16;    // k-steps over DV
  constexpr int NO = D / 8;      // output n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kBQ * LD;           // kBQ x LDV
  bf16* k_s = do_s + kBQ * LDV;          // 2 x kBK x LD
  bf16* v_s = k_s + 2 * kBK * LD;        // 2 x kBK x LDV

  const int row = blockIdx.y;
  if (row >= n_qt) {                  // the combine's rows
    cb.slice(static_cast<long long>(row - n_qt) * gridDim.x + blockIdx.x);
    return;
  }
  const QBlock blk(H, K, row, n_qt);
  const int Sk = mk.Sk;
  const long long q_row = static_cast<long long>(blk.bh) * S;
  const bf16* kp = k + static_cast<long long>(blk.kvh) * Sk * D;
  const bf16* vp = v + static_cast<long long>(blk.kvh) * Sk * DV;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blk.q0 + warp * 16 + (lane >> 2);   // rows row0, row0 + 8
  const int quad_col = 2 * (lane & 3);

  const Tiles tiles = tiles_of(mk, blk.q0, S);
  load_tile<D>(q_s, q + q_row * D, blk.q0, S, tid);
  load_tile<DV>(do_s, dO + q_row * DV, blk.q0, S, tid);
  cp_async_commit();
  if (tiles.n > 0) {
    load_tile<D>(k_s, kp, tiles[0] * kBK, Sk, tid);
    load_tile<DV>(v_s, vp, tiles[0] * kBK, Sk, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[KQ][4], df[KV][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk)
    ldsm_a<LD>(qf[kk], q_s, warp * 16, kk, lane);
#pragma unroll
  for (int kk = 0; kk < KV; ++kk)
    ldsm_a<LDV>(df[kk], do_s, warp * 16, kk, lane);
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
      load_tile<DV>(v_s + (buf ^ 1) * kBK * LDV, vp, k1, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = tiles[i] * kBK;
    const bf16* kt = k_s + buf * kBK * LD;
    const bf16* vt = v_s + buf * kBK * LDV;

    // S = Q K^T (over D) and dP = dO V^T (over DV)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    if constexpr (D == DV) {
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
    } else {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          ldsm_b_rows<LD>(b, kt, j, kk, lane);
          mma_bf16(s[j], qf[kk], b[0], b[1]);
          mma_bf16(s[j + 1], qf[kk], b[2], b[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < KV; ++kk) {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          ldsm_b_rows<LDV>(b, vt, j, kk, lane);
          mma_bf16(dp[j], df[kk], b[0], b[1]);
          mma_bf16(dp[j + 1], df[kk], b[2], b[3]);
        }
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
// wgmma at (D, DV) = (128, 128), MLA's (192, 128) and (96, 96): two
// warpgroups a block
// ---------------------------------------------------------------------------

constexpr int kThreadsWG2 = 2 * kThreadsTC;
// the dK/dV blocks (of one an SM) a launch needs before a block sums the
// G query heads of its kv head: ~4 waves of an H100's 132 SMs
constexpr long long kSumHeadsBlocks = 512;
// an H100's L2 cache
constexpr long long kL2Bytes = 50LL << 20;
// the ring of streamed tiles (Q and dO in dK/dV, K and V in dQ), and the
// named barriers of the hand-overs between the warpgroups (0 is
// __syncthreads'): P (dS in dQ) of item m from warpgroup 0 to 1 (kBarP +
// m % 2), slot s loaded, from warpgroup 1 to 0 (kBarSlot + s), and each
// warpgroup alone
constexpr int kSlots = 3;
constexpr int kBarP = 1, kBarSlot = 3, kBarWG1 = kBarSlot + kSlots;
constexpr int kBarWG0 = kBarWG1 + 1;   // warpgroup 0 alone

// P^T of a (64 keys x 64 q rows) tile pair in place from S^T's accumulator
// fragments, as p_ds_t has it (fragment (j, e): key key0 + 8 (e / 2), q row
// q0 + 8 j + quad_col + e % 2; lse the q tile's rows') but with ex2, the
// mask tested only in a tile it cuts
__device__ __forceinline__ void p_from_st(float (&st)[8][4], const float* lse,
                                          const Mask& mk, int q0, int k0,
                                          int key0, int quad_col, float c2) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float l2 = lse[8 * j + quad_col + h] * kLog2e;
      st[j][h] = ex2(fmaf(st[j][h], c2, -l2));
      st[j][h + 2] = ex2(fmaf(st[j][h + 2], c2, -l2));
    }
  if (!mk.partial(q0, k0)) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!mk.visible(q0 + 8 * j + quad_col + (e & 1), key0 + 8 * (e >> 1)))
        st[j][e] = 0.0f;
}

// P of a (64 q rows x 64 keys) tile pair in place from S's fragments, as
// ds_of has it (fragment (j, e): row row0 + 8 (e / 2), key k0 + 8 j +
// quad_col + e % 2) but with ex2, the mask tested only in a tile it cuts
__device__ __forceinline__ void p_from_s(float (&s)[8][4],
                                         const float (&l2)[2],
                                         const Mask& mk, int q0, int k0,
                                         int row0, int quad_col, float c2) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = ex2(fmaf(s[j][e], c2, -l2[e >> 1]));
  if (!mk.partial(q0, k0)) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!mk.visible(row0 + 8 * (e >> 1), k0 + 8 * j + quad_col + (e & 1)))
        s[j][e] = 0.0f;
}

// the fp32 partial of one gradient, N wide, of the block's 64 keys: rows
// key0, key0 + 8 of the accumulator fragments (n-tile j: columns 8 j..),
// unscaled
template <int N>
__device__ __forceinline__ void store_partial(const float (&acc)[N / 8][4],
                                              float* p, long long bh, int Sk,
                                              int key0, int quad_col) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= Sk) continue;
    float* row = p + (bh * Sk + key) * N + quad_col;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// A warpgroup's 64-row accumulator N wide (n-tile j: columns 8 j..) times
// scale, rounded to bf16, into rows [row_base, row_base + 64) of out (rows
// N apart; rows at or past n_rows are skipped), through shared memory at
// stage (64 rows of N + 8 bf16, idle by then; rows 4 banks apart), so that
// each store is 16 bytes of a row; bar: the warpgroup's own barrier
template <int N>
__device__ __forceinline__ void store_tile_bf16(const float (&acc)[N / 8][4],
                                                bf16* stage, bf16* out,
                                                int row_base, int n_rows,
                                                int t, float scale, int bar) {
  constexpr int LD = N + 8, kChunks = N / 8;
  const int r0 = (t >> 5) * 16 + ((t & 31) >> 2), quad_col = 2 * (t & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(stage + (r0 + 8 * h) * LD + 8 * j +
                                         quad_col) =
          __floats2bfloat162_rn(acc[j][2 * h] * scale,
                                acc[j][2 * h + 1] * scale);
  bar_sync(bar, kThreadsTC);
#pragma unroll 4
  for (int i = t; i < 64 * kChunks; i += kThreadsTC) {
    const int r = i / kChunks, c = i % kChunks;
    if (row_base + r < n_rows)
      *reinterpret_cast<uint4*>(out + static_cast<long long>(row_base + r) * N +
                                8 * c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + 8 * c);
  }
}

template <int D, int DV>
constexpr size_t smem_bytes_wg2() {
  // the fixed pair's slabs (read once into registers) and kSlots of the
  // streamed pair's (64 rows of D + DV bf16 each, whatever the slabs'
  // width), P in fp32 twice, kSlots x 2 x 64 floats of lse and Delta
  // (dK/dV), and 1 KB to align the slabs
  return (1 + kSlots) * (D + DV) / 64 * kTileBytes +
         sizeof(float) * (2 * kBQ * kBK + 2 * kSlots * kBQ) + 1024;
}

// P (dS in dQ) of item m from warpgroup 0 to warpgroup 1 through p_s[m %
// 2] (each thread its own fragments): 8 float4s a thread
__device__ __forceinline__ void put_p(float4* p_s, int m, int t,
                                      const float (&x)[8][4]) {
  float4* dst = p_s + (m & 1) * 8 * kThreadsTC;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    dst[j * kThreadsTC + t] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
  bar_arrive(kBarP + (m & 1), kThreadsWG2);
}
__device__ __forceinline__ const float4* get_p(const float4* p_s, int m,
                                               int t) {
  bar_sync(kBarP + (m & 1), kThreadsWG2);
  return p_s + (m & 1) * 8 * kThreadsTC + t;
}

// warpgroup 1 at the start of item m: its loads of item m + 1 (issued
// during item m - 1, or before the first item) have landed; hand the slot
// to warpgroup 0, and make it visible to warpgroup 1's own threads
__device__ __forceinline__ void slot_ready(int m) {
  cp_async_wait<0>();
  fence_async_smem();
  bar_arrive(kBarSlot + (m + 1) % kSlots, kThreadsWG2);
  bar_sync(kBarWG1, kThreadsTC);
}

// One warpgroup of a dK/dV block. kRole 0: S^T = K Q^T, P^T (to the other
// warpgroup through shared memory), dV += P^T dO; kRole 1: dP^T = V dO^T,
// dS^T = P^T (dP^T - Delta), dK += dS^T Q. K's (role 0) or V's (role 1)
// A operands stay in registers for the whole walk. The block takes nh query
// heads (1, or the G of its kv head) and its items are their (head, q tile)
// pairs, a head's q tiles in turn; they stream through a ring of kSlots
// slots of Q, dO, lse and Delta: warpgroup 1 loads item m + 2 while it
// works on item m (into the slot item m - 1 left), and warpgroup 0 runs up
// to one item ahead of it. With nh = G the sums are dK and dV, else the
// head's fp32 partials.
template <int kRole, int D, int DV>
__device__ __forceinline__ void dkdv_wg2_role(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ pk, float* __restrict__ pv, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int H, int K, int S, const Mask& mk, float scale,
    int nh, int tile_slow) {
  constexpr int W = slab_cols<D, DV>(), kSlab = slab_bytes<W>();
  constexpr int NQ = D / W, NV = DV / W;     // slabs of a q / k, v / dO row
  constexpr int NA = kRole == 0 ? NQ : NV;   // slabs of the fixed A operand
  constexpr int NO = kRole == 0 ? NV : NQ;   // slabs of the sum
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_s = base, v_s = base + NQ * kSlab;
  const uint32_t q_s = v_s + NV * kSlab;                   // kSlots x NQ
  const uint32_t do_s = q_s + kSlots * NQ * kSlab;         // kSlots x NV
  float4* p_s = reinterpret_cast<float4*>(
      smem_raw + (base - raw) + (1 + kSlots) * (NQ + NV) * kSlab);
  float* lse_s = reinterpret_cast<float*>(p_s + 16 * kThreadsTC);
  float* dl_s = lse_s + kSlots * kBQ;                      // kSlots x kBQ

  // a one-dimensional grid of units (unit u: query heads u nh..) by key
  // tiles: with tile_slow the key tile is the slow axis (the blocks of the
  // first key tiles, which take the most items, start first), else a
  // unit's key tiles are adjacent (first first), so that the blocks
  // running together share their heads' Q and dO in L2
  const int n_kt = (mk.Sk + kBK - 1) / kBK, n_units = gridDim.x / n_kt;
  const int unit = tile_slow ? blockIdx.x % n_units : blockIdx.x / n_kt;
  const int tile = tile_slow ? blockIdx.x / n_units : blockIdx.x % n_kt;
  const KvBlock blk(H, K, S, unit * nh, tile);
  const int tid = threadIdx.x, t = tid & (kThreadsTC - 1);
  const int warp = t >> 5, lane = tid & 31;
  const int key0 = blk.k0 + warp * 16 + (lane >> 2);   // keys key0, key0 + 8
  const int quad_col = 2 * (lane & 3);

  // item it into slot, by NT threads
  auto load_item = [&](auto nt, int it, int slot, int ltid) {
    constexpr int NT = decltype(nt)::value;
    const long long qo = static_cast<long long>(blk.bh + (it >> 16)) * S;
    const int q0 = (it & 0xFFFF) * kBQ;
    load_rows<W, NQ, NT, D>(q_s + slot * NQ * kSlab, q + qo * D, q0, S,
                            ltid);
    load_rows<W, NV, NT, DV>(do_s + slot * NV * kSlab, dO + qo * DV, q0, S,
                             ltid);
    if (ltid < kBQ) {
      const int r = q0 + ltid;
      const long long i = qo + (r < S ? r : 0);
      cp_async4(lse_s + slot * kBQ + ltid, lse + i, r < S);
      cp_async4(dl_s + slot * kBQ + ltid, delta + i, r < S);
    }
  };
  using All = std::integral_constant<int, kThreadsWG2>;
  using One = std::integral_constant<int, kThreadsTC>;

  // K, V and the first item by the whole block; the second by warpgroup 1,
  // handed over as every later one is
  const long long kv_row = static_cast<long long>(blk.kvh) * mk.Sk;
  load_rows<W, NQ, kThreadsWG2, D>(k_s, k + kv_row * D, blk.k0, mk.Sk, tid);
  load_rows<W, NV, kThreadsWG2, DV>(v_s, v + kv_row * DV, blk.k0, mk.Sk,
                                    tid);
  int it = blk.next_item(mk, 0, S, nh);
  int it1 = it >= 0 ? blk.next_item(mk, it + 1, S, nh) : -1;
  if (it >= 0) load_item(All(), it, 0, tid);
  cp_async_commit();
  if (kRole == 1 && it1 >= 0) load_item(One(), it1, 1, t);
  cp_async_commit();
  cp_async_wait<1>();
  fence_async_smem();
  bar_sync(0, kThreadsWG2);
  uint32_t af[NA * W / 16][4];
  ldsm_a_slabs<NA, W>(af, kRole == 0 ? k_s : v_s, warp * 16, lane);

  float acc[NO * W / 8][4];
#pragma unroll
  for (int j = 0; j < NO * W / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const float c2 = scale * kLog2e;

  // Each item's second product is issued together with the next item's
  // first, so that the elementwise work of one runs under the other. The
  // next item's is issued after the last item too (on a slot no one writes
  // then; its result is unused): a wgmma in a branch would be serialized.
  float x[8][4];   // S^T, then P^T (role 0); dP^T, then dS^T (role 1)
  uint32_t xh[4][4], xl[4][4];
  if (it >= 0) wg_product_t<NA, W>(x, af, kRole == 0 ? q_s : do_s);
  for (int m = 0; it >= 0; ++m) {
    const int it2 = it1 >= 0 ? blk.next_item(mk, it1 + 1, S, nh) : -1;
    const int slot = m % kSlots, slot1 = (m + 1) % kSlots;
    if constexpr (kRole == 0) {
      p_from_st(x, lse_s + slot * kBQ, mk, (it & 0xFFFF) * kBQ, blk.k0, key0,
                quad_col, c2);
      put_p(p_s, m, t, x);
      if (it1 >= 0) bar_sync(kBarSlot + slot1, kThreadsWG2);
      issue_accumulate<NO, W>(acc, x, xh, xl, do_s + slot * NV * kSlab);
      issue_product_t<NA, W>(x, af, q_s + slot1 * NQ * kSlab);
    } else {
      if (it1 >= 0) slot_ready(m);
      const float4* p = get_p(p_s, m, t);
      if (it2 >= 0) {   // item m - 1's slot: both warpgroups are past it
        load_item(One(), it2, (m + 2) % kSlots, t);
        cp_async_commit();
      }
      const float* dl = dl_s + slot * kBQ;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 pj = p[j * kThreadsTC];
        const float d0 = dl[8 * j + quad_col], d1 = dl[8 * j + quad_col + 1];
        x[j][0] = pj.x * (x[j][0] - d0);
        x[j][1] = pj.y * (x[j][1] - d1);
        x[j][2] = pj.z * (x[j][2] - d0);
        x[j][3] = pj.w * (x[j][3] - d1);
      }
      issue_accumulate<NO, W>(acc, x, xh, xl, q_s + slot * NQ * kSlab);
      issue_product_t<NA, W>(x, af, do_s + slot1 * NV * kSlab);
    }
    wg_done(acc, x);
    it = it1;
    it1 = it2;
  }
  cp_async_wait<0>();
  if (nh == H / K) {   // the kv head's every query head: dK and dV
    // staged where neither warpgroup reads any more once both are past
    // their walks: K's slabs and on into V's (role 0; 17 KB of stage, 16 KB
    // of K at D = 128) and P's buffers (role 1)
    static_assert(64 * (DV + 8) * sizeof(bf16) <= (NQ + NV) * kSlab &&
                  64 * (D + 8) * sizeof(bf16) <= 16 * kThreadsTC *
                                                     sizeof(float4),
                  "the dK / dV stage does not fit");
    bar_sync(0, kThreadsWG2);
    if constexpr (kRole == 0)
      store_tile_bf16<DV>(acc, reinterpret_cast<bf16*>(smem_raw + (base - raw)),
                          dv + kv_row * DV, blk.k0, mk.Sk, t, 1.0f, kBarWG0);
    else
      store_tile_bf16<D>(acc, reinterpret_cast<bf16*>(p_s), dk + kv_row * D,
                         blk.k0, mk.Sk, t, scale, kBarWG1);
  } else if constexpr (kRole == 0) {
    store_partial<DV>(acc, pv, blk.bh, mk.Sk, key0, quad_col);
  } else {
    store_partial<D>(acc, pk, blk.bh, mk.Sk, key0, quad_col);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreadsWG2, 1)
dkdv_kernel_wg2(const bf16* __restrict__ q,      // (B, H, S, D)
                const bf16* __restrict__ k,      // (B, K, Sk, D)
                const bf16* __restrict__ v,      // (B, K, Sk, DV)
                const bf16* __restrict__ dO,     // (B, H, S, DV)
                const float* __restrict__ lse,   // (B, H, S)
                const float* __restrict__ delta, // (B, H, S)
                float* __restrict__ pk,          // (B, H, Sk, D)
                float* __restrict__ pv,          // (B, H, Sk, DV)
                bf16* __restrict__ dk,           // (B, K, Sk, D)
                bf16* __restrict__ dv,           // (B, K, Sk, DV)
                int H, int K, int S, Mask mk, float scale, int nh,
                int tile_slow) {
  if (threadIdx.x < kThreadsTC)
    dkdv_wg2_role<0, D, DV>(q, k, v, dO, lse, delta, pk, pv, dk, dv, H, K, S,
                            mk, scale, nh, tile_slow);
  else
    dkdv_wg2_role<1, D, DV>(q, k, v, dO, lse, delta, pk, pv, dk, dv, H, K, S,
                            mk, scale, nh, tile_slow);
}

// One warpgroup of a dQ block. kRole 0: S = Q K^T and dP = dO V^T (Q's and
// dO's A operands in registers for the whole kv-tile walk), P and dS = P
// (dP - Delta), dS to the other warpgroup through shared memory; kRole 1:
// dQ += dS K, and the loads. K and V stream through kSlots slots as Q and
// dO do in dK/dV.
template <int kRole, int D, int DV>
__device__ __forceinline__ void dq_wg2_role(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int H, int K, int S, const Mask& mk, float scale,
    int n_qt) {
  constexpr int W = slab_cols<D, DV>(), kSlab = slab_bytes<W>();
  constexpr int NQ = D / W, NV = DV / W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base, do_s = base + NQ * kSlab;
  const uint32_t k_s = do_s + NV * kSlab;                  // kSlots x NQ
  const uint32_t v_s = k_s + kSlots * NQ * kSlab;          // kSlots x NV
  float4* p_s = reinterpret_cast<float4*>(
      smem_raw + (base - raw) + (1 + kSlots) * (NQ + NV) * kSlab);

  // as in dK/dV: a head's q tiles adjacent (the last first), sharing K, V
  const QBlock blk(H, K, blockIdx.x % n_qt, n_qt, blockIdx.x / n_qt);
  const int Sk = mk.Sk;
  const long long q_row = static_cast<long long>(blk.bh) * S;
  const bf16* kp = k + static_cast<long long>(blk.kvh) * Sk * D;
  const bf16* vp = v + static_cast<long long>(blk.kvh) * Sk * DV;
  const int tid = threadIdx.x, t = tid & (kThreadsTC - 1);
  const int warp = t >> 5, lane = tid & 31;
  const int row0 = blk.q0 + warp * 16 + (lane >> 2);   // rows row0, row0 + 8
  const int quad_col = 2 * (lane & 3);

  // kv tile i of the walk into slot, by NT threads
  const Tiles tiles = tiles_of(mk, blk.q0, S);
  auto load_tile = [&](auto nt, int i, int slot, int ltid) {
    constexpr int NT = decltype(nt)::value;
    const int k0 = tiles[i] * kBK;
    load_rows<W, NQ, NT, D>(k_s + slot * NQ * kSlab, kp, k0, Sk, ltid);
    load_rows<W, NV, NT, DV>(v_s + slot * NV * kSlab, vp, k0, Sk, ltid);
  };
  using All = std::integral_constant<int, kThreadsWG2>;
  using One = std::integral_constant<int, kThreadsTC>;

  // Q, dO and the first kv tile by the whole block; the second by
  // warpgroup 1, handed over as every later one is
  load_rows<W, NQ, kThreadsWG2, D>(q_s, q + q_row * D, blk.q0, S, tid);
  load_rows<W, NV, kThreadsWG2, DV>(do_s, dO + q_row * DV, blk.q0, S, tid);
  if (tiles.n > 0) load_tile(All(), 0, 0, tid);
  cp_async_commit();
  if (kRole == 1 && tiles.n > 1) load_tile(One(), 1, 1, t);
  cp_async_commit();
  cp_async_wait<1>();
  fence_async_smem();
  bar_sync(0, kThreadsWG2);

  if constexpr (kRole == 0) {
    uint32_t qf[NQ * W / 16][4], df[NV * W / 16][4];
    ldsm_a_slabs<NQ, W>(qf, q_s, warp * 16, lane);
    ldsm_a_slabs<NV, W>(df, do_s, warp * 16, lane);
    float l2[2], dl[2];
    blk.rows(lse, delta, row0, S, l2, dl);
    const float c2 = scale * kLog2e;
    float x[8][4], y[8][4];   // S, then P, then dS; dP
    for (int m = 0; m < tiles.n; ++m) {
      const int slot = m % kSlots;
      if (m > 0) bar_sync(kBarSlot + slot, kThreadsWG2);
      wg_fence();
      issue_product_t<NQ, W>(x, qf, k_s + slot * NQ * kSlab);
      issue_product_t<NV, W>(y, df, v_s + slot * NV * kSlab);
      wg_commit();
      wg_wait_all();
      wg_fence_acc(x);
      wg_fence_acc(y);
      p_from_s(x, l2, mk, blk.q0, tiles[m] * kBK, row0, quad_col, c2);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] *= y[j][e] - dl[e >> 1];
      put_p(p_s, m, t, x);
    }
  } else {
    float acc[NQ * W / 8][4];   // dQ
#pragma unroll
    for (int j = 0; j < NQ * W / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    float x[8][4];          // dS
    uint32_t xh[4][4], xl[4][4];
    for (int m = 0; m < tiles.n; ++m) {
      if (m + 1 < tiles.n) slot_ready(m);
      const float4* p = get_p(p_s, m, t);
      if (m + 2 < tiles.n) {   // tile m - 1's slot: both are past it
        load_tile(One(), m + 2, (m + 2) % kSlots, t);
        cp_async_commit();
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 pj = p[j * kThreadsTC];
        x[j][0] = pj.x, x[j][1] = pj.y, x[j][2] = pj.z, x[j][3] = pj.w;
      }
      issue_accumulate<NQ, W>(acc, x, xh, xl, k_s + (m % kSlots) * NQ * kSlab);
      wg_done(acc, x);
    }
    cp_async_wait<0>();
    // staged in P's buffers, past the last dS
    store_tile_bf16<D>(acc, reinterpret_cast<bf16*>(p_s), dq + q_row * D,
                       blk.q0, S, t, scale, kBarWG1);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreadsWG2, 1)
dq_kernel_wg2(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dO,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int H, int K, int S, Mask mk,
              float scale, int n_qt, long long n_q_blocks,
              CombineOf<D, DV> cb) {
  if (blockIdx.x >= n_q_blocks) {   // the combine's, on the first warpgroup
    if (threadIdx.x < kThreadsTC) cb.slice(blockIdx.x - n_q_blocks);
    return;
  }
  if (threadIdx.x < kThreadsTC)
    dq_wg2_role<0, D, DV>(q, k, v, dO, lse, delta, dq, H, K, S, mk, scale,
                          n_qt);
  else
    dq_wg2_role<1, D, DV>(q, k, v, dO, lse, delta, dq, H, K, S, mk, scale,
                          n_qt);
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

// K and Q tiles D + 1 wide, V and dO tiles DV + 1 (at MLA's (192, 128):
// 199 KB, where four tiles D + 1 wide would take 226 KB)
template <int D, int DV>
constexpr size_t smem_bytes_dkdv_f32() {
  return sizeof(float) * (2 * kBK * (D + 1) + 2 * kBK * (DV + 1) + 2 * kBQ +
                          2 * kBK * (kBQ + 1));
}

// one block per (batch * kv head, 64-key tile); thread 4 c + ph owns key c
// of the tile and output columns ph + 4 j
template <int D, int DV>
__global__ void __launch_bounds__(kThreadsF)
dkdv_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dO,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int H, int K, int S, Mask mk,
                float scale) {
  constexpr int LD = D + 1, LDV = DV + 1, LP = kBQ + 1;
  extern __shared__ float smem[];
  float* k_s = smem;                 // kBK x LD
  float* v_s = k_s + kBK * LD;       // kBK x LDV
  float* q_s = v_s + kBK * LDV;      // kBQ x LD
  float* do_s = q_s + kBQ * LD;      // kBQ x LDV
  float* lse_s = do_s + kBQ * LDV;   // kBQ
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
  const long long kv_row = static_cast<long long>(bkv) * Sk;
  load_tile_f32<D>(k_s, k + kv_row * D, k0, Sk);
  load_tile_f32<DV>(v_s, v + kv_row * DV, k0, Sk);

  float dk_acc[D / 4], dv_acc[DV / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) dk_acc[j] = 0.0f;
#pragma unroll
  for (int j = 0; j < DV / 4; ++j) dv_acc[j] = 0.0f;

  for (int it = 0; it < G * n_qt; ++it) {
    const int q0 = (it % n_qt) * kBQ;
    if (!tiles_of(mk, q0, S).visits(t_kv)) continue;   // same for the block
    const long long bh = hq0 + it / n_qt;
    __syncthreads();  // the previous item's readers are done
    load_tile_f32<D>(q_s, q + bh * S * D, q0, S);
    load_tile_f32<DV>(do_s, dO + bh * S * DV, q0, S);
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
    if constexpr (D == DV) {
      for (int d = 0; d < D; ++d) {
        const float kc = k_s[c * LD + d], vc = v_s[c * LD + d];
#pragma unroll
        for (int j = 0; j < kBQ / 4; ++j) {
          s[j] = fmaf(q_s[(ph + 4 * j) * LD + d], kc, s[j]);
          dp[j] = fmaf(do_s[(ph + 4 * j) * LD + d], vc, dp[j]);
        }
      }
    } else {
      for (int d = 0; d < D; ++d) {
        const float kc = k_s[c * LD + d];
#pragma unroll
        for (int j = 0; j < kBQ / 4; ++j)
          s[j] = fmaf(q_s[(ph + 4 * j) * LD + d], kc, s[j]);
      }
      for (int d = 0; d < DV; ++d) {
        const float vc = v_s[c * LDV + d];
#pragma unroll
        for (int j = 0; j < kBQ / 4; ++j)
          dp[j] = fmaf(do_s[(ph + 4 * j) * LDV + d], vc, dp[j]);
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
      for (int j = 0; j < DV / 4; ++j)
        dv_acc[j] = fmaf(p, do_s[r * LDV + ph + 4 * j], dv_acc[j]);
#pragma unroll
      for (int j = 0; j < D / 4; ++j)
        dk_acc[j] = fmaf(ds, q_s[r * LD + ph + 4 * j], dk_acc[j]);
    }
  }
  if (key < Sk) {
    const long long row = kv_row + key;
#pragma unroll
    for (int j = 0; j < D / 4; ++j)
      dk[row * D + ph + 4 * j] = dk_acc[j] * scale;
#pragma unroll
    for (int j = 0; j < DV / 4; ++j) dv[row * DV + ph + 4 * j] = dv_acc[j];
  }
}

template <int D, int DV>
constexpr size_t smem_bytes_dq_f32() {
  return sizeof(float) * (2 * kBK * (D + 1) + 2 * kBK * (DV + 1) +
                          kBQ * (kBK + 1));
}

// one block per (batch * head, 64-row q tile); thread 4 r + ph owns q row r
// of the tile and output columns ph + 4 j
template <int D, int DV>
__global__ void __launch_bounds__(kThreadsF)
dq_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dO,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int H, int K, int S, Mask mk,
              float scale) {
  constexpr int LD = D + 1, LDV = DV + 1, LP = kBK + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                 // kBQ x LD
  float* do_s = q_s + kBQ * LD;      // kBQ x LDV
  float* k_s = do_s + kBQ * LDV;     // kBK x LD
  float* v_s = k_s + kBK * LD;       // kBK x LDV
  float* ds_s = v_s + kBK * LDV;     // kBQ x LP

  const int bh = blockIdx.y;
  const int kvh = (bh / H) * K + (bh % H) / (H / K);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int Sk = mk.Sk;
  const long long q_row = static_cast<long long>(bh) * S;
  const long long q_off = q_row * D;
  const float* kp = k + static_cast<long long>(kvh) * Sk * D;
  const float* vp = v + static_cast<long long>(kvh) * Sk * DV;
  const int r = threadIdx.x >> 2, ph = threadIdx.x & 3;
  const int row = q0 + r;
  load_tile_f32<D>(q_s, q + q_off, q0, S);
  load_tile_f32<DV>(do_s, dO + q_row * DV, q0, S);
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
    load_tile_f32<DV>(v_s, vp, k0, Sk);
    __syncthreads();

    // scores and dP of row r against keys ph + 4 j, in the forward's order
    float s[kBK / 4], dp[kBK / 4];
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) s[j] = dp[j] = 0.0f;
    if constexpr (D == DV) {
      for (int d = 0; d < D; ++d) {
        const float qv = q_s[r * LD + d], dov = do_s[r * LD + d];
#pragma unroll
        for (int j = 0; j < kBK / 4; ++j) {
          s[j] = fmaf(qv, k_s[(ph + 4 * j) * LD + d], s[j]);
          dp[j] = fmaf(dov, v_s[(ph + 4 * j) * LD + d], dp[j]);
        }
      }
    } else {
      for (int d = 0; d < D; ++d) {
        const float qv = q_s[r * LD + d];
#pragma unroll
        for (int j = 0; j < kBK / 4; ++j)
          s[j] = fmaf(qv, k_s[(ph + 4 * j) * LD + d], s[j]);
      }
      for (int d = 0; d < DV; ++d) {
        const float dov = do_s[r * LDV + d];
#pragma unroll
        for (int j = 0; j < kBK / 4; ++j)
          dp[j] = fmaf(dov, v_s[(ph + 4 * j) * LDV + d], dp[j]);
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

// the most blocks a grid's y axis takes: launch refuses a shape whose
// grids pass it (cudaErrorInvalidConfiguration) before its first launch
constexpr long long kMaxGridY = 65535;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// whether the bf16 kernels at (D, Dv) are the two-warpgroup wgmma pair
constexpr bool wg2_pair(int D, int Dv) {
  return (Dv == 128 && (D == 128 || D == 192)) || (D == 96 && Dv == 96);
}

// the query heads a dK/dV block of the two-warpgroup pair takes: the kv
// head's G where that leaves the launch kSumHeadsBlocks blocks or more
// (the block then writes dK and dV itself), else one
int wg2_heads(int B, int K, int Sk, int G) {
  const long long n_kt = (Sk + kBK - 1) / kBK;
  return static_cast<long long>(B) * K * n_kt >= kSumHeadsBlocks ? G : 1;
}

// the scratch, in floats: Delta (B H S), then, for bf16 where a dK/dV
// block takes one query head of several, the fp32 dK and dV partials of
// every query head (B H Sk D and B H Sk Dv), from a multiple of 4
struct Scratch {
  long long delta, part_k, part_v;
  long long part_at() const { return (delta + 3) & ~3LL; }
  long long floats() const { return part_at() + part_k + part_v; }
};

Scratch scratch_of(int B, int H, int K, int S, int Sk, int D, int Dv,
                   int bf16_in) {
  const int G = H / K;
  const bool partials =
      bf16_in && !(wg2_pair(D, Dv) && wg2_heads(B, K, Sk, G) == G);
  const long long rows = partials ? static_cast<long long>(B) * H * Sk : 0;
  return Scratch{static_cast<long long>(B) * H * S, rows * D, rows * Dv};
}

template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dO, const float* lse, float* scratch,
                   long long scratch_floats, void* dq, void* dk, void* dv,
                   int B, int H, int K, int S, Mask mk, float scale,
                   int bf16_in, cudaStream_t stream) {
  const Scratch sc = scratch_of(B, H, K, S, mk.Sk, D, DV, bf16_in);
  if (sc.floats() > scratch_floats) return cudaErrorInvalidValue;
  float* delta = scratch;
  const long long rows = static_cast<long long>(B) * H * S;
  const int n_kt = (mk.Sk + kBK - 1) / kBK, n_qt = (S + kBQ - 1) / kBQ;
  // the bf16 pairs on two wgmma warpgroups a block; the query heads their
  // dK/dV blocks take: the kv head's G where that leaves the card
  // kSumHeadsBlocks blocks or more (no partials, no combine), else one;
  // and their grid's order: the key tile the slow axis where a block
  // takes G > 1 heads (the blocks of a kv head walk the same Q and dO
  // together) or where every head's Q and dO fit in L2, a unit's key tiles
  // adjacent otherwise
  constexpr bool kWG2 = wg2_pair(D, DV);
  const int G = H / K, nh = wg2_heads(B, K, mk.Sk, G);
  const int tile_slow =
      nh > 1 || rows * (D + DV) * static_cast<long long>(sizeof(bf16)) <=
                    kL2Bytes;
  cudaError_t err;
  if (bf16_in) {
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
               *vb = static_cast<const bf16*>(v), *ob = static_cast<const bf16*>(o),
               *db = static_cast<const bf16*>(dO);
    float* pk = scratch + sc.part_at();
    float* pv = pk + sc.part_k;
    // dQ and the combine: one launch, the combine's rows after the q tiles
    const long long kv_rows = static_cast<long long>(B) * K * mk.Sk;
    CombineOf<D, DV> cb;
    if constexpr (D == DV)
      cb = Combine{pk, pv, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                   static_cast<long long>(mk.Sk) * D, kv_rows * D / 4, H, K,
                   scale};
    else
      cb = CombineKV{pk, pv, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                     static_cast<long long>(mk.Sk) * D,
                     static_cast<long long>(mk.Sk) * DV, kv_rows * D / 4,
                     kv_rows * (D + DV) / 4, H, K, scale};
    // the key tile (dK/dV) and the q tile (dQ) are the slow grid axes, so
    // the blocks with the most tiles to visit start first (the two-warpgroup
    // pair's grids are one-dimensional)
    const long long q_rows = static_cast<long long>(n_qt) + cb.rows(B * H);
    if (!kWG2 && (n_kt > kMaxGridY || q_rows > kMaxGridY))
      return cudaErrorInvalidConfiguration;
    const dim3 grid_kv(B * H, n_kt);
    delta_kernel_bf16<DV><<<static_cast<unsigned>((rows + 31) / 32), 256, 0,
                            stream>>>(ob, db, delta, rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if constexpr (D == 64 && DV == 64) {
      constexpr size_t s_kv = smem_bytes_wg();
      if ((err = allow_smem(dkdv_kernel_wg, s_kv)) != cudaSuccess) return err;
      dkdv_kernel_wg<<<grid_kv, kThreadsTC, s_kv, stream>>>(
          qb, kb, vb, db, lse, delta, pk, pv, H, K, S, mk, scale);
    } else if constexpr (kWG2) {
      constexpr size_t s_kv = smem_bytes_wg2<D, DV>();
      if ((err = allow_smem(dkdv_kernel_wg2<D, DV>, s_kv)) != cudaSuccess)
        return err;
      dkdv_kernel_wg2<D, DV><<<n_kt * B * H / nh, kThreadsWG2, s_kv,
                               stream>>>(
          qb, kb, vb, db, lse, delta, pk, pv, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), H, K, S, mk, scale, nh, tile_slow);
    } else {
      constexpr size_t s_kv = smem_bytes_dkdv_tc<D, DV>();
      if ((err = allow_smem(dkdv_kernel_tc<D, DV>, s_kv)) != cudaSuccess)
        return err;
      dkdv_kernel_tc<D, DV><<<grid_kv, kThreadsTC, s_kv, stream>>>(
          qb, kb, vb, db, lse, delta, pk, pv, H, K, S, mk, scale);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const dim3 grid_q(B * H, static_cast<unsigned>(q_rows));
    bf16* dqb = static_cast<bf16*>(dq);
    if constexpr (D == 64 && DV == 64) {
      constexpr size_t s_q = smem_bytes_wg();
      if ((err = allow_smem(dq_kernel_wg, s_q)) != cudaSuccess) return err;
      dq_kernel_wg<<<grid_q, kThreadsTC, s_q, stream>>>(
          qb, kb, vb, db, lse, delta, dqb, H, K, S, mk, scale, n_qt, cb);
    } else if constexpr (kWG2) {
      constexpr size_t s_q = smem_bytes_wg2<D, DV>();
      if ((err = allow_smem(dq_kernel_wg2<D, DV>, s_q)) != cudaSuccess)
        return err;
      // the q tiles' blocks, then the combine's, none where dK/dV stored
      // the gradients themselves (nh = G)
      const long long n_q_blocks = static_cast<long long>(n_qt) * B * H;
      const int n_combine = nh == G ? 0 : cb.rows(1);
      dq_kernel_wg2<D, DV><<<static_cast<unsigned>(n_q_blocks + n_combine),
                             kThreadsWG2, s_q, stream>>>(
          qb, kb, vb, db, lse, delta, dqb, H, K, S, mk, scale, n_qt,
          n_q_blocks, cb);
    } else {
      constexpr size_t s_q = smem_bytes_dq_tc<D, DV>();
      if ((err = allow_smem(dq_kernel_tc<D, DV>, s_q)) != cudaSuccess)
        return err;
      dq_kernel_tc<D, DV><<<grid_q, kThreadsTC, s_q, stream>>>(
          qb, kb, vb, db, lse, delta, dqb, H, K, S, mk, scale, n_qt, cb);
    }
    return cudaGetLastError();
  }
  // dK/dV's grid takes B K blocks on y, dQ's B H
  if (static_cast<long long>(B) * H > kMaxGridY)
    return cudaErrorInvalidConfiguration;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *of = static_cast<const float*>(o),
              *df = static_cast<const float*>(dO);
  delta_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      of, df, delta, rows, DV);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t s_kv = smem_bytes_dkdv_f32<D, DV>();
  if ((err = allow_smem(dkdv_kernel_f32<D, DV>, s_kv)) != cudaSuccess)
    return err;
  dkdv_kernel_f32<D, DV><<<dim3(n_kt, B * K), kThreadsF, s_kv, stream>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), H, K, S, mk, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t s_q = smem_bytes_dq_f32<D, DV>();
  if ((err = allow_smem(dq_kernel_f32<D, DV>, s_q)) != cudaSuccess) return err;
  dq_kernel_f32<D, DV><<<dim3(n_qt, B * H), kThreadsF, s_q, stream>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dq), H, K, S, mk,
      scale);
  return cudaGetLastError();
}

// whether the kernels are instantiated for (D, Dv): the forward's pairs
bool takes(int D, int Dv) {
  if (D == 192 && Dv == 128) return true;
  if (D == 32 && Dv == 16) return true;
  return Dv == D && (D == 16 || D == 32 || D == 64 || D == 96 || D == 128);
}

}  // namespace

// The floats of scratch a launch at this shape needs (0: a (D, Dv) not
// taken).
extern "C" long long flash_attention_bwd_scratch_floats(int B, int H, int K,
                                                        int S, int Sk, int D,
                                                        int Dv, int bf16_in) {
  if (B <= 0 || H <= 0 || K <= 0 || S < 0 || Sk < 0 || !takes(D, Dv))
    return 0;
  return scratch_of(B, H, K, S, Sk, D, Dv, bf16_in).floats();
}

// Launch on `stream`; returns the cudaError_t of the first launch that
// failed (0 = success), or cudaErrorInvalidConfiguration, with nothing
// launched, where a grid would take more than kMaxGridY blocks on y. Same layouts, (D, Dv) pairs, mask arguments and
// dtype switch as flash_attention_launch (window <= 0: no window): q and k
// have head dim D, v, o and dO Dv; o and lse are the forward's outputs (lse
// from a launch that asked for it), dO has o's layout and dtype (bf16: o
// and dO 16-byte aligned), scratch holds scratch_floats floats, at least
// flash_attention_bwd_scratch_floats(...), and dq, dk, dv take q's, k's and
// v's layouts and dtype. p is taken in fp32 (round_p = 0).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const float* lse, float* scratch, long long scratch_floats,
    void* dq, void* dk, void* dv, int B, int H, int K, int S, int Sk, int D,
    int Dv, float scale, int bf16_in, int causal, int window, int sink,
    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (K <= 0 || H % K != 0 || Sk <= 0 || sink < 0 || !takes(D, Dv))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask mk{Sk, causal, window, sink};
  if (D == 192)
    return launch<192, 128>(q, k, v, o, dO, lse, scratch, scratch_floats, dq, dk, dv, B, H, K, S, mk, scale, bf16_in, s);
  if (Dv == 16 && D == 32)
    return launch<32, 16>(q, k, v, o, dO, lse, scratch, scratch_floats, dq, dk, dv, B, H, K, S, mk, scale, bf16_in, s);
  switch (D) {
    case 16: return launch<16, 16>(q, k, v, o, dO, lse, scratch, scratch_floats, dq, dk, dv, B, H, K, S, mk, scale, bf16_in, s);
    case 32: return launch<32, 32>(q, k, v, o, dO, lse, scratch, scratch_floats, dq, dk, dv, B, H, K, S, mk, scale, bf16_in, s);
    case 64: return launch<64, 64>(q, k, v, o, dO, lse, scratch, scratch_floats, dq, dk, dv, B, H, K, S, mk, scale, bf16_in, s);
    case 96: return launch<96, 96>(q, k, v, o, dO, lse, scratch, scratch_floats, dq, dk, dv, B, H, K, S, mk, scale, bf16_in, s);
    default: return launch<128, 128>(q, k, v, o, dO, lse, scratch, scratch_floats, dq, dk, dv, B, H, K, S, mk, scale, bf16_in, s);
  }
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
