// Flash-attention forward (serving prefill), for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention (body
// _flash_kernel). Same function: o = softmax(q k^T * scale + mask) v with
// an online softmax over kv tiles, m, l and the accumulator in fp32, masked
// scores set to -0.7 * FLT_MAX, l summing the unrounded p and clamped to
// >= 1e-30, output in q's dtype. Beyond the TPU kernel it takes
//   - grouped-query attention: query head h reads kv head h / (H / K), so K
//     and V are never repeated in memory;
//   - a value head dim DV apart from the query/key one D (a template
//     argument beside D: MLA's (192, 128), and (32, 16) for the reduced
//     MLA, whose q and k the wrapper pads from 24 with zeros): the V tiles,
//     the PV product and the output are DV wide. With DV = D the layout and
//     the arithmetic are those of the one-D kernel it was;
//   - any sequence length (the ragged last tiles are masked);
//   - a sliding window with a sink, the mask of the model's
//     repro/models/attention.py::causal_attention with the queries at
//     positions 0..S-1: key c is visible to row r when c <= r and
//     (no window, or r - c < window, or c < sink);
//   - two treatments of p in the PV product: rounded to v's dtype
//     (round_p = 1, the TPU kernel's), or kept at fp32 precision (round_p =
//     0, what the model's blocked computation does).
// The plain PyTorch version is repro_torch/kernels/ref.py::attention_ref,
// which uses the same kv tile width and mask. When asked (a non-null lse
// pointer: the training call), it also writes each row's log-sum-exp, from
// which flash_attention_bwd.cu recomputes p; the serving call does not ask.
// The tile sizes, the mask, the tile walk and the mma helpers are in
// flash_attention.cuh, the wgmma helpers in wgmma.cuh, both shared with
// the backward.
//
// What bounds it on this card: at hymba's prefill shape (4, 25, 5, 1128, 64)
// the causal work is ~16 GFLOP on ~35 MB, far above the bytes-per-op ridge,
// so operations bound it, and in bf16 only the tensor cores reach them.
//
// bf16 inputs at (D, DV) = (64, 64) (hymba, musicgen), (96, 96)
// (phi-3-vision), (128, 128) (moonshot, granite, qwen3, internlm2) and
// (192, 128) (deepseek-v3's MLA): Hopper's wgmma, flash_kernel_wg. The
// mma.sync kernel below took 2.6-3.1x SDPA's time at D = 128 and 1.9x at
// D = 64 and 96: 2 blocks an SM at 87-112 KB of shared memory, synchronous
// products that each warp feeds from ldmatrix, the softmax waiting on a
// tile's products and the next tile's products on the softmax, and 238-250
// registers at D = 192.
//   - one block of three warpgroups per (batch * head, 128-row q tile), over
//     a (ceil(S / 128), B * H) grid, the q tiles in reverse order: two
//     consumers, each owning 64 rows of the tile, and a producer that gives
//     them its registers (setmaxnreg); one block an SM (the consumer count
//     is wg_consumers, the barriers and registers follow it: WgShape);
//   - Q and the K and V tiles sit in shared memory as 64-row slabs
//     (wgmma.cuh): of 64 columns in the 128-byte swizzle, or at D = 96,
//     whose 192-byte rows are no whole number of those, of 32 columns in
//     the 64-byte swizzle (one swizzle for all three operands, and PV one
//     m64n96k16 product a k-step); loaded by the producer with cp.async
//     through a ring of 4 (K, V) slots and handed over at named barriers
//     (slot loaded, to each consumer; slot free, to the producer);
//   - S = Q K^T: wgmma m64n64k16 with both operands in shared memory
//     (K-major), so Q holds no registers; O += P V: P from S's accumulator
//     registers into register A operands, V read MN-major, one m64n64
//     product a 64-column piece of O (m64n96 at D = 96);
//   - the consumers issue their products in turn (named barriers), so that
//     one's softmax runs while the other's products are on the tensor
//     cores; within a consumer, tile i's S and tile i - 1's PV are issued
//     together;
//   - the tile walk is the union of the two 64-row halves' (tiles_of with
//     128 rows); the mask is applied per consumer, on its own 64 rows, as
//     comparisons and selects (no branch per element), and a tile wholly
//     masked for a consumer adds exactly nothing (p = 0, alpha = 1);
//   - exp2 as ex2.approx.ftz (the SFU alone; relative error ~2^-22), p =
//     2^(s c2 - m c2) in one FMA, with m c2 taken as 0 while a row has seen
//     only masked keys; m, p's reference point, follows the row max only
//     when the max grows by more than 2^8 (p <= 2^8, far inside fp32's
//     and bf16's range), so most tiles rescale no O (a warp whose rows all
//     kept theirs skips the multiplies); the row max and sum as trees; each
//     lane sums its own part of l, reduced once at the end; o = acc * (1 /
//     l);
//   - round_p = 0: p's hi and lo products as in the mma.sync kernel;
//   - 209 KB (D = 192), 161 KB (128), 121 KB (96) or 81 KB (64) of shared
//     memory a block; -Xptxas -v: no spill stores (chip_smoke.py phases
//     22 and 26 print the registers and fail on a spill).
// Other bf16 (D, DV): tensor cores through mma.sync.m16n8k16 (fp32
// accumulate), the FlashAttention-2 layout, flash_kernel_tc:
//   - one block of 4 warps per (batch * head, 64-row q tile), over a
//     (ceil(S / 64), B * H) grid, the q tiles in reverse order so that the
//     longest causal rows start first; each warp owns 16 q rows;
//   - Q and a double buffer of 64-row K and V tiles are brought into shared
//     memory by cp.async (rows past the end zero-filled), rows padded by 16
//     bytes so that ldmatrix reads 8 rows from 8 distinct bank groups;
//   - S = Q K^T: Q's A fragments stay in registers for the whole kv loop,
//     K's B fragments come from ldmatrix; the online softmax runs on the
//     fp32 accumulator fragments, the row max and sum reduced over the 4
//     lanes of a row with shuffles, exp(x) as exp2f(x * log2(e));
//   - O += P V: P goes from the accumulator fragments straight into bf16 A
//     fragments (no shared-memory round trip), V's B fragments come from
//     ldmatrix.trans;
//   - round_p = 0 splits p = p_hi + p_lo with p_hi = bf16(p) and p_lo =
//     bf16(p - p_hi) and issues both products into the same fp32
//     accumulator: p keeps ~17 bits (relative error ~2^-17, far below one
//     bf16 ulp of the output) for 1.5x the tensor-core work of round_p = 1.
//     TF32 for PV would need V widened and P in tf32 fragments, twice the
//     registers of the bf16 split, for no more precision.
// fp32 inputs: IEEE fp32 FMAs out of shared memory (no TF32), so that the
// 2e-5 gate of the reference's tests holds; there round_p changes nothing.
//   - one block of 256 threads per (batch * head, 64-row q tile); four
//     threads share a q row, each owning 16 of the 64 score columns and DV/4
//     of the output columns; q, k and v tiles staged in shared memory, rows
//     of q and k padded by one word; p goes through shared memory.
// Both visit only the kv tiles that some row of the q tile can see: the
// sink tiles [0, ceil(sink / 64)), then the tiles from the one holding key
// q0 - window + 1 up to the one that meets the diagonal of the tile's last
// real row. The per-element mask runs only on tiles that cross the diagonal,
// the window's edge or the end of the keys. Skipping gives the plain
// version's result in exact arithmetic: every real row sees its own key, in
// a visited tile; a tile that is wholly masked for a row either finds that
// row with real keys already (p = exp(NEG - m) = 0 and alpha = 1: m, l and
// the accumulator are unchanged), or with none yet (m = NEG), and then
// whatever it added is wiped by alpha = exp(NEG - m) = 0 when the row's
// first real key arrives. IEEE expf in the fp32 kernel, no
// --use_fast_math anywhere.

#include <type_traits>

#include "wgmma.cuh"

namespace {

using namespace fa;

template <int D, int DV>
constexpr size_t smem_bytes_tc() {
  return sizeof(__nv_bfloat16) *
         ((D + kPad) * (kBQ + 2 * kBK) + (DV + kPad) * 2 * kBK);
}

template <int D, int DV, bool kSplitP>
__global__ void __launch_bounds__(kThreadsTC)
flash_kernel_tc(const __nv_bfloat16* __restrict__ q,   // (B, H, S, D)
                const __nv_bfloat16* __restrict__ k,   // (B, K, Sk, D)
                const __nv_bfloat16* __restrict__ v,   // (B, K, Sk, DV)
                __nv_bfloat16* __restrict__ o,         // (B, H, S, DV)
                float* __restrict__ lse,               // (B, H, S) or null
                int H, int K, int S, Mask mk, float scale) {
  constexpr int LD = D + kPad;
  constexpr int LDV = DV + kPad;
  constexpr int NT = kBK / 8;    // score n-tiles of 8 keys
  constexpr int KQ = D / 16;     // k-steps of S = Q K^T
  constexpr int NO = DV / 8;     // output n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBQ * LD;          // 2 x kBK x LD
  __nv_bfloat16* v_s = k_s + 2 * kBK * LD;      // 2 x kBK x LDV

  const int bh = blockIdx.y;                    // b * H + h
  const int kvh = (bh / H) * K + (bh % H) / (H / K);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int Sk = mk.Sk;
  const __nv_bfloat16* qp = q + static_cast<long long>(bh) * S * D;
  const __nv_bfloat16* kp = k + static_cast<long long>(kvh) * Sk * D;
  const __nv_bfloat16* vp = v + static_cast<long long>(kvh) * Sk * DV;
  __nv_bfloat16* op = o + static_cast<long long>(bh) * S * DV;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = q0 + warp * 16 + (lane >> 2);   // rows row0, row0 + 8
  const int quad_col = 2 * (lane & 3);             // fragment column

  const Tiles tiles = tiles_of(mk, q0, S);
  load_tile<D>(q_s, qp, q0, S, tid);
  cp_async_commit();
  load_tile<D>(k_s, kp, tiles[0] * kBK, Sk, tid);
  load_tile<DV>(v_s, vp, tiles[0] * kBK, Sk, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // Q's A fragments: ldmatrix lane l addresses row l % 16, column 8 (l / 16)
  uint32_t qf[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk)
    ldsm_x4(qf[kk], smem_u32(q_s + (warp * 16 + (lane & 15)) * LD + 16 * kk +
                             8 * (lane >> 4)));

  const float c2 = scale * kLog2e;  // exp(x * scale) = exp2(x * c2)
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
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
    const __nv_bfloat16* kt = k_s + buf * kBK * LD;
    const __nv_bfloat16* vt = v_s + buf * kBK * LDV;

    // S = Q K^T (unscaled). ldmatrix x4 gives the B fragments of n-tiles
    // j and j + 1: lane l addresses key 8 (j + l / 16) + l % 8 at column
    // 16 kk + 8 ((l / 8) % 2)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(kt + (8 * (j + (lane >> 4)) + (lane & 7)) * LD +
                            16 * kk + 8 * ((lane >> 3) & 1)));
        mma_bf16(s[j], qf[kk], b[0], b[1]);
        mma_bf16(s[j + 1], qf[kk], b[2], b[3]);
      }
    }
    // fragment (j, e): row row0 + 8 (e / 2), key k0 + 8 j + quad_col + e % 2
    if (mk.partial(q0, k0)) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!mk.visible(row0 + 8 * (e >> 1), k0 + 8 * j + quad_col + (e & 1)))
            s[j][e] = kNeg;
    }

    // online softmax of the two rows this thread holds
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // (s - mx) * c2, not fmaf(s, c2, -mx * c2): while a row has seen
      // only masked keys (mx = NEG) the difference must be exactly 0
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[j][e] = exp2f((s[j][e] - mx) * c2);
          ps += s[j][e];
        }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      alpha[h] = exp2f((m[h] - mx) * c2);
      l[h] = l[h] * alpha[h] + ps;
      m[h] = mx;
    }
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // O += P V, 16 keys a k-step. P's A fragment of k-step kk is score
    // n-tiles 2 kk and 2 kk + 1; V's B fragments of output n-tiles j and
    // j + 1 come from ldmatrix.trans: lane l addresses key 16 kk + 8
    // ((l / 8) % 2) + l % 8 at column 8 (j + l / 16)
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      ph[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      ph[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      ph[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      ph[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      if constexpr (kSplitP) {
        pl[0] = pack_bf16_residual(s[2 * kk][0], s[2 * kk][1], ph[0]);
        pl[1] = pack_bf16_residual(s[2 * kk][2], s[2 * kk][3], ph[1]);
        pl[2] = pack_bf16_residual(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2]);
        pl[3] = pack_bf16_residual(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3]);
      }
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, smem_u32(vt + (16 * kk + 8 * ((lane >> 3) & 1) +
                                        (lane & 7)) * LDV +
                                  8 * (j + (lane >> 4))));
        mma_bf16(acc[j], ph, b[0], b[1]);
        mma_bf16(acc[j + 1], ph, b[2], b[3]);
        if constexpr (kSplitP) {
          mma_bf16(acc[j], pl, b[0], b[1]);
          mma_bf16(acc[j + 1], pl, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= S) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    // m is the unscaled row max: p = exp((s - m) * scale)
    if (lse != nullptr && (lane & 3) == 0)
      lse[static_cast<long long>(bh) * S + row] = m[h] * scale + logf(denom);
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(
          op + static_cast<long long>(row) * DV + 8 * j + quad_col) =
          __floats2bfloat162_rn(acc[j][2 * h] / denom,
                                acc[j][2 * h + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// bf16 at (D, DV) = (64, 64), (96, 96), (128, 128) and (192, 128): wgmma,
// consumer warpgroups and a producer warpgroup a block
// ---------------------------------------------------------------------------

template <int D, int DV>
constexpr bool wgmma_forward() {
  return (D == DV && (D == 64 || D == 96)) ||
         ((D == 128 || D == 192) && DV == 128);
}

// the consumer warpgroups of a block at (D, DV), each owning 64 rows of
// the block's q tile. (Three, on 192-row q tiles, ran 3.8 % faster at
// hymba's S = 1,128 with p in float32, but 6.5 % slower at musicgen's S =
// 1,000, whose last tile holds 40 of 192 rows, and 16-19 % slower at
// phi-3-vision's D = 96, on an H100: tools/attention_fwd_variants.py.)
template <int D, int DV>
__host__ __device__ constexpr int wg_consumers() {
  return 2;
}

// The block's shape with NC consumers: its threads; the registers a
// consumer and a producer thread hold after setmaxnreg (NC x 128 x consumer
// + 128 x producer <= 65,536: at two consumers 232 / 40 where the producer
// loads 64-column slabs (at the 168 a thread an even split leaves, ptxas
// waits for a product early to free registers, and the kernel ran slower),
// 216 / 72 where it loads 32-column ones (at 40, a loader of a row's 16-byte
// chunks by division spilled 60 B at D = 96); at three 152 / 56); the ring
// of (K, V) tile pairs, tile i of the walk in slot i % kSlots, refilled
// once every consumer's products that read it are done; and the named
// barriers (0 is __syncthreads'): the issue turns of the consumers
// (kBarTurn + w), slot s loaded, to consumer w (kBarFull + NC s + w), slot
// s free, to the producer (kBarEmpty + s)
template <int NC, bool kSlabs64>
struct WgShape {
  static_assert(NC != 2 || 2 * kBQ == kBQWG, "two consumers: kBQWG rows");
  static constexpr int kThreads = (NC + 1) * kThreadsTC;
  static constexpr int kRegsConsumer = NC == 2 ? (kSlabs64 ? 232 : 216)
                                               : 152;
  static constexpr int kRegsProducer = NC == 2 ? (kSlabs64 ? 40 : 72)
                                               : 56;
  static constexpr int kSlots = NC == 2 ? 4 : 3;
  static constexpr int kBarTurn = 1, kBarFull = kBarTurn + NC,
                       kBarEmpty = kBarFull + NC * kSlots;
  static_assert(NC * kThreadsTC * kRegsConsumer +
                        kThreadsTC * kRegsProducer <= 65536,
                "65,536 registers a block");
  static_assert(kBarEmpty + kSlots <= 16, "16 named barriers a block");
};
// the shape of a block at (D, DV)
template <int D, int DV>
using WgShapeOf =
    WgShape<wg_consumers<D, DV>(), slab_cols<D, DV>() == 64>;

template <int D, int DV>
constexpr size_t smem_bytes_wg() {
  // Q (each consumer's 64 rows), the ring, and 1 KB to align the slabs
  constexpr int W = slab_cols<D, DV>(), NC = wg_consumers<D, DV>();
  constexpr int NQ = (D + W - 1) / W, NV = (DV + W - 1) / W;
  return (NC * NQ + WgShapeOf<D, DV>::kSlots * (NQ + NV)) * slab_bytes<W>() +
         1024;
}

// p's reference point lags the row max by up to this much in the exponent
constexpr float kLazyLog2 = 8.0f;

// The online softmax of a warpgroup's 64 x 64 tile of scores s (the m64n64
// accumulator; this thread's rows row0 and row0 + 8, keys k0 + 8 j +
// quad_col + e % 2), in place: the mask where the tile cuts the
// warpgroup's rows (from qw), the row's reference point m (its max, moved
// lazily), p = 2^(s c2 - m c2) with m c2 taken as 0 while the row has seen
// only masked keys (m = NEG: p is then 0, and the row's first real key
// finds l = 0 and an accumulator of zeros), this lane's part of l, and
// alpha, the factor of the accumulator. The output o = acc / l and lse =
// m scale + log l do not depend on the reference point.
// The mask is Mask::visible without branches: key k0 + quad_col + x (x = 8
// j + e % 2, a constant) of row r is visible when x <= hi (causal: c <= r;
// c < Sk) and (x >= lo (r - c < window) or x < sk (c < sink))
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const Mask& mk, int qw, int k0,
                                             int row0, int quad_col,
                                             float c2) {
  if (mk.partial(qw, k0)) {
    const int cb = k0 + quad_col;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h - cb;   // the row, less the first column
      const int hi = mk.causal ? min(r, mk.Sk - 1 - cb) : mk.Sk - 1 - cb;
      const bool win = mk.causal && mk.window > 0;
      const int lo = win ? r - mk.window + 1 : -kBK;
      const int sk = win ? mk.sink - cb : -kBK;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const int x = 8 * j + (e & 1);
          const bool vis = (x <= hi) & ((x >= lo) | (x < sk));
          s[j][e] = vis ? s[j][e] : kNeg;
        }
    }
  }
  // the row max and sum as trees over the thread's 16 keys of a row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = fmaxf(s[j][2 * h], s[j][2 * h + 1]);
#pragma unroll
    for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
    float mx = fmaxf(m[h], t[0]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // p's reference point m moves to the new max only when the max grew
    // by more than 8 in the exponent: p <= 2^8 otherwise, and O needs no
    // rescale (alpha = 1)
    const bool grow = (mx - m[h]) * c2 > kLazyLog2;
    const float mr = grow ? mx : m[h];
    const float mc = mr == kNeg ? 0.0f : mr * c2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][2 * h] = ex2(fmaf(s[j][2 * h], c2, -mc));
      s[j][2 * h + 1] = ex2(fmaf(s[j][2 * h + 1], c2, -mc));
      t[j] = s[j][2 * h] + s[j][2 * h + 1];
    }
#pragma unroll
    for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] += t[j + w];
    const float ps = t[0];
    alpha[h] = grow ? ex2((m[h] - mx) * c2) : 1.0f;
    l[h] = l[h] * alpha[h] + ps;
    m[h] = mr;
  }
}

// One block a (batch * head, q tile of 64 NC rows): consumer warpgroup w
// owns rows q0 + 64 w.. and keeps its O (64 x DV fp32), its scores and P's
// A operands in registers; the producer warpgroup loads Q and the walk's
// (K, V) tiles into the ring with cp.async and hands each slot over at
// named barriers, so that no consumer waits for another's loads. Iteration
// i (tiles 1..n - 1 of the walk), in consumer w: slot i has landed; at w's
// turn (the consumers issue their products in turn, 0, 1, .., NC - 1, 0,
// ..) S_i = Q K_i^T is issued (both operands in shared memory), O is
// rescaled and O += P_{i-1} V_{i-1} issued (P in registers: hi, and lo
// with kSplitP); S_i and PV_{i-1} are waited for (ptxas puts the second
// wait ahead of the softmax wherever the source has it), slot i - 1 is
// freed, and the softmax of S_i runs and P_i is made while the other
// consumers' products are on the tensor cores. Every product is waited for
// in the iteration that issues it: ptxas serializes wgmma whose wait lies
// in a later iteration. Rows are whole W-column slabs (slab_cols), zero-
// filled past S and Sk in shared memory.
template <int D, int DV, bool kSplitP>
__global__ void __launch_bounds__((WgShapeOf<D, DV>::kThreads), 1)
flash_kernel_wg(const __nv_bfloat16* __restrict__ q,   // (B, H, S, D)
                const __nv_bfloat16* __restrict__ k,   // (B, K, Sk, D)
                const __nv_bfloat16* __restrict__ v,   // (B, K, Sk, DV)
                __nv_bfloat16* __restrict__ o,         // (B, H, S, DV)
                float* __restrict__ lse,               // (B, H, S) or null
                int H, int K, int S, Mask mk, float scale) {
  constexpr int NC = wg_consumers<D, DV>();
  using Sh = WgShapeOf<D, DV>;
  constexpr int W = slab_cols<D, DV>(), kSlab = slab_bytes<W>();
  constexpr int NQ = (D + W - 1) / W, NV = (DV + W - 1) / W;   // slabs a row
  constexpr int NO = NV * W / 8;    // n-tiles of 8 columns of O's registers
  constexpr int kRows = 64 * NC;    // q rows a block
  constexpr int kSlots = Sh::kSlots;
  constexpr int kSlotBytes = (NQ + NV) * kSlab;   // K, then V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;                      // NC x NQ slabs
  const uint32_t ring = q_s + NC * NQ * kSlab;    // kSlots slots

  const int bh = blockIdx.y;                    // b * H + h
  const int kvh = (bh / H) * K + (bh % H) / (H / K);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int Sk = mk.Sk;
  const Tiles tiles = tiles_of<kRows>(mk, q0, S);
  const int n = tiles.n;
  auto slot = [&](int i) { return ring + (i % kSlots) * kSlotBytes; };
  const int tid = threadIdx.x;
  constexpr int kFull = 2 * kThreadsTC, kEmpty = (NC + 1) * kThreadsTC;

  if (tid >= NC * kThreadsTC) {   // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Sh::kRegsProducer));
    const int t = tid - NC * kThreadsTC;
    const __nv_bfloat16* qp = q + static_cast<long long>(bh) * S * D;
    const __nv_bfloat16* kp = k + static_cast<long long>(kvh) * Sk * D;
    const __nv_bfloat16* vp = v + static_cast<long long>(kvh) * Sk * DV;
#pragma unroll
    for (int w = 0; w < NC; ++w)
      load_rows<W, NQ, kThreadsTC, D>(q_s + w * NQ * kSlab, qp, q0 + 64 * w,
                                      S, t);
    auto handed = [&](int i) {   // tile i has landed: to every consumer
      fence_async_smem();
#pragma unroll
      for (int w = 0; w < NC; ++w)
        bar_arrive(Sh::kBarFull + NC * (i % kSlots) + w, kFull);
    };
    for (int i = 0; i < n; ++i) {
      if (i >= kSlots) bar_sync(Sh::kBarEmpty + i % kSlots, kEmpty);
      const int k0 = tiles[i] * kBK;
      load_rows<W, NQ, kThreadsTC, D>(slot(i), kp, k0, Sk, t);
      load_rows<W, NV, kThreadsTC, DV>(slot(i) + NQ * kSlab, vp, k0, Sk, t);
      cp_async_commit();
      if (i > 0) {
        cp_async_wait<1>();
        handed(i - 1);
      }
    }
    cp_async_wait<0>();
    handed(n - 1);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      Sh::kRegsConsumer));

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int qw = q0 + 64 * wg;                      // the warpgroup's rows
  const int row0 = qw + warp * 16 + (lane >> 2);    // rows row0, row0 + 8
  const int quad_col = 2 * (lane & 3);              // fragment column
  const uint32_t qa = q_s + wg * NQ * kSlab;
  auto landed = [&](int i) {
    bar_sync(Sh::kBarFull + NC * (i % kSlots) + wg, kFull);
  };
  // tile i's products are done: the producer may refill its slot (if it
  // will: a dangling arrival would outlive the block)
  auto free_slot = [&](int i) {
    if (i + kSlots < n) bar_arrive(Sh::kBarEmpty + i % kSlots, kEmpty);
  };
  // the turns: consumer 0 first, then each in turn (the last does not hand
  // its last turn on, which no one would take)
  auto my_turn = [&]() { bar_sync(Sh::kBarTurn + wg, 2 * kThreadsTC); };
  auto your_turn = [&](bool last) {
    if (!(last && wg == NC - 1))
      bar_arrive(Sh::kBarTurn + (wg + 1) % NC, 2 * kThreadsTC);
  };
  if (wg == NC - 1) bar_arrive(Sh::kBarTurn, 2 * kThreadsTC);

  const float c2 = scale * kLog2e;  // exp(x * scale) = exp2(x * c2)
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};   // l: this lane's part
  float alpha[2];
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float s[8][4];                 // S, then P
  uint32_t ph[4][4], pl[4][4];   // P's A operands, hi and lo
  // P's operands and O's rescaled sums are made before the wgmma.fence
  // that the products reading them follow: made after it, they would need
  // one that ptxas inserts itself and, on the consumers' divergent path,
  // serializes the products for
  auto make_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_a<kSplitP>(s, kk, ph[kk], pl[kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        asm volatile("" : "+r"(ph[kk][e])::"memory");
        if constexpr (kSplitP) asm volatile("" : "+r"(pl[kk][e])::"memory");
      }
    }
  };
  auto rescale = [&]() {
    // (a warp whose rows all kept their reference point skips it)
    if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f))
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    wg_fence_acc(acc);
  };

  landed(0);
  my_turn();
  wg_fence();
  issue_product_ss<NQ, W>(s, qa, slot(0));
  wg_commit();
  your_turn(false);
  wg_wait<0>();
  wg_fence_acc(s);
  softmax_tile(s, m, l, alpha, mk, qw, tiles[0] * kBK, row0, quad_col, c2);
  make_p();
  for (int i = 1; i < n; ++i) {
    landed(i);
    my_turn();
    wg_fence();
    issue_product_ss<NQ, W>(s, qa, slot(i));
    wg_commit();
    rescale();
    wg_fence();
    issue_accumulate_a<NV, kSplitP, W>(acc, ph, pl, slot(i - 1) + NQ * kSlab);
    wg_commit();
    your_turn(false);
    wg_wait<1>();   // S_i done; PV_{i-1} may still run
    wg_fence_acc(s);
    softmax_tile(s, m, l, alpha, mk, qw, tiles[i] * kBK, row0, quad_col, c2);
    wg_wait<0>();
    wg_fence_acc(acc);
    free_slot(i - 1);
    make_p();
  }
  my_turn();
  rescale();
  wg_fence();
  issue_accumulate_a<NV, kSplitP, W>(acc, ph, pl, slot(n - 1) + NQ * kSlab);
  wg_commit();
  your_turn(true);
  wg_wait<0>();
  wg_fence_acc(acc);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __nv_bfloat16* op = o + static_cast<long long>(bh) * S * DV;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= S) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    // m is the unscaled row max: p = exp((s - m) * scale)
    if (lse != nullptr && (lane & 3) == 0)
      lse[static_cast<long long>(bh) * S + row] = m[h] * scale + logf(denom);
    const float inv = 1.0f / denom;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(
          op + static_cast<long long>(row) * DV + 8 * j + quad_col) =
          __floats2bfloat162_rn(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// fp32: IEEE FMAs
// ---------------------------------------------------------------------------

constexpr int kThreadsF = 256;  // 4 threads per q row

template <int D, int DV>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * DV +
                          kBQ * (kBK + 1));
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreadsF)
flash_kernel_f32(const float* __restrict__ q,   // (B, H, S, D)
                 const float* __restrict__ k,   // (B, K, Sk, D)
                 const float* __restrict__ v,   // (B, K, Sk, DV)
                 float* __restrict__ o,         // (B, H, S, DV)
                 float* __restrict__ lse,       // (B, H, S) or null
                 int H, int K, int S, Mask mk, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int LP = kBK + 1;
  float* q_s = smem;                 // kBQ x LD
  float* k_s = q_s + kBQ * LD;       // kBK x LD
  float* v_s = k_s + kBK * LD;       // kBK x DV
  float* p_s = v_s + kBK * DV;       // kBQ x LP

  const int bh = blockIdx.y;         // b * H + h
  const int kvh = (bh / H) * K + (bh % H) / (H / K);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int Sk = mk.Sk;
  const float* qp = q + static_cast<long long>(bh) * S * D;
  const float* kp = k + static_cast<long long>(kvh) * Sk * D;
  const float* vp = v + static_cast<long long>(kvh) * Sk * DV;
  float* op = o + static_cast<long long>(bh) * S * DV;

  const int tid = threadIdx.x;
  const int r = tid >> 2;            // q row within the tile
  const int c4 = tid & 3;            // column phase
  const int row = q0 + r;

  // q tile; rows past S read as 0 and are never stored
  for (int i = tid; i < kBQ * D; i += kThreadsF) {
    const int rr = i / D, dd = i % D;
    q_s[rr * LD + dd] =
        q0 + rr < S ? qp[static_cast<long long>(q0 + rr) * D + dd] : 0.0f;
  }

  float m = kNeg, l = 0.0f;
  float acc[DV / 4];
#pragma unroll
  for (int j = 0; j < DV / 4; ++j) acc[j] = 0.0f;

  const Tiles tiles = tiles_of(mk, q0, S);
  for (int i = 0; i < tiles.n; ++i) {
    const int k0 = tiles[i] * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int t = tid; t < kBK * D; t += kThreadsF) {
      const int rr = t / D, dd = t % D;
      k_s[rr * LD + dd] =
          k0 + rr < Sk ? kp[static_cast<long long>(k0 + rr) * D + dd] : 0.0f;
    }
    for (int t = tid; t < kBK * DV; t += kThreadsF) {
      const int rr = t / DV, dd = t % DV;
      v_s[rr * DV + dd] =
          k0 + rr < Sk ? vp[static_cast<long long>(k0 + rr) * DV + dd] : 0.0f;
    }
    __syncthreads();

    // scores of row r at columns c4 + 4 j
    float s[kBK / 4];
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) s[j] = 0.0f;
    for (int dd = 0; dd < D; ++dd) {
      const float qv = q_s[r * LD + dd];
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j)
        s[j] = fmaf(qv, k_s[(c4 + 4 * j) * LD + dd], s[j]);
    }
    float mx = kNeg;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const float sv = mk.visible(row, k0 + c4 + 4 * j) ? s[j] * scale : kNeg;
      s[j] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float ps = 0.0f;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const float p = expf(s[j] - m_new);
      ps += p;
      p_s[r * LP + c4 + 4 * j] = p;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + ps;
    m = m_new;
    __syncwarp();  // row r's p was written by the lanes that read it

#pragma unroll
    for (int j = 0; j < DV / 4; ++j) acc[j] *= alpha;
    for (int c = 0; c < kBK; ++c) {
      const float p = p_s[r * LP + c];
#pragma unroll
      for (int j = 0; j < DV / 4; ++j)
        acc[j] = fmaf(p, v_s[c * DV + c4 + 4 * j], acc[j]);
    }
  }

  if (row < S) {
    const float denom = fmaxf(l, 1e-30f);
    // m is the scaled row max: p = exp(s * scale - m)
    if (lse != nullptr && c4 == 0)
      lse[static_cast<long long>(bh) * S + row] = m + logf(denom);
#pragma unroll
    for (int j = 0; j < DV / 4; ++j)
      op[static_cast<long long>(row) * DV + c4 + 4 * j] = acc[j] / denom;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int K, int S, Mask mk,
                   float scale, int bf16, int round_p, cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  if (!bf16) {
    constexpr size_t smem = smem_bytes_f32<D, DV>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel_f32<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_kernel_f32<D, DV><<<grid, kThreadsF, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, H, K, S,
        mk, scale);
    return cudaGetLastError();
  }
  if constexpr (wgmma_forward<D, DV>()) {
    constexpr size_t smem = smem_bytes_wg<D, DV>();
    constexpr int NC = wg_consumers<D, DV>();
    auto kernel = round_p ? flash_kernel_wg<D, DV, false>
                          : flash_kernel_wg<D, DV, true>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<dim3((S + 64 * NC - 1) / (64 * NC), B * H),
             WgShapeOf<D, DV>::kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), lse, H, K, S, mk, scale);
  } else {
    constexpr size_t smem = smem_bytes_tc<D, DV>();
    auto kernel = round_p ? flash_kernel_tc<D, DV, false>
                          : flash_kernel_tc<D, DV, true>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreadsTC, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), lse, H, K, S, mk, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// bf16 != 0: q, k, v, o are bfloat16 (16-byte aligned), else float32. q and
// k have head dim D, v and o Dv: (D, Dv) must be (16, 16), (32, 32), (64,
// 64), (96, 96), (128, 128), (32, 16) or (192, 128); scale multiplies the
// scores (the wrapper passes 1/sqrt of q's unpadded width). H must be a
// multiple of K. window <= 0 means
// no window (and sink is then ignored); window and sink apply only with
// causal != 0. round_p != 0 rounds p to v's dtype before the PV product.
// lse (B, H, S) fp32, when not null, receives each row's log-sum-exp of the
// scaled scores, m + log(l), which the backward (flash_attention_bwd.cu)
// recomputes p from; the serving call passes null.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int H,
                                      int K, int S, int Sk, int D, int Dv,
                                      float scale, int bf16, int causal,
                                      int window, int sink, int round_p,
                                      void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (K <= 0 || H % K != 0 || Sk <= 0 || sink < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask mk{Sk, causal, window, sink};
  if (D == 192 && Dv == 128)
    return launch<192, 128>(q, k, v, o, lse, B, H, K, S, mk, scale, bf16, round_p, s);
  if (D == 32 && Dv == 16)
    return launch<32, 16>(q, k, v, o, lse, B, H, K, S, mk, scale, bf16, round_p, s);
  if (Dv != D) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16: return launch<16, 16>(q, k, v, o, lse, B, H, K, S, mk, scale, bf16, round_p, s);
    case 32: return launch<32, 32>(q, k, v, o, lse, B, H, K, S, mk, scale, bf16, round_p, s);
    case 64: return launch<64, 64>(q, k, v, o, lse, B, H, K, S, mk, scale, bf16, round_p, s);
    case 96: return launch<96, 96>(q, k, v, o, lse, B, H, K, S, mk, scale, bf16, round_p, s);
    case 128: return launch<128, 128>(q, k, v, o, lse, B, H, K, S, mk, scale, bf16, round_p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
