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
//
// One launch (flash_attention_bwd_launch) runs three kernels on the stream:
//   1. delta: one warp per row, Delta in fp32 into a scratch the wrapper
//      allocates;
//   2. dK, dV: one block per (batch * kv head, 64-key tile); it loops over
//      the G = H / K query heads of its kv head and over the q tiles that
//      visit its kv tile, so the GQA sum over heads stays inside the block
//      (no atomics, a fixed order). bf16: 4 warps of 16 keys each compute
//      S^T = K Q^T and dP^T = V dO^T on mma.sync (K and V are the A
//      operands, so P^T and dS^T land in accumulator fragments that are
//      already the A fragments of dV = P^T dO and dK = dS^T Q), with a
//      cp.async double buffer of Q and dO tiles;
//   3. dQ: one block per (batch * head, 64-row q tile), over the kv tiles
//      of the forward's walk, recomputing S and dP (a second pass in place
//      of atomics across kv tiles: the result does not depend on the order
//      blocks run in).
// P and dS enter the products as bf16 hi + bf16 lo (the forward's split for
// p in fp32), so they keep ~17 bits: 2x the tensor-core work of bf16 P and
// dS. fp32 inputs: IEEE fp32 FMAs out of shared memory (no TF32), four
// threads a key (dK, dV) or a q row (dQ). No --use_fast_math.

#include "flash_attention.cuh"

namespace {

using namespace fa;
using bf16 = __nv_bfloat16;

constexpr int kThreadsF = 256;   // fp32 kernels: 4 threads a key or row

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// 1. Delta = rowsum(dO * O), fp32
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
             float* __restrict__ delta, long long rows, int D) {
  const long long row = blockIdx.x * 8LL + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f(dO[row * D + d]), to_f(o[row * D + d]), acc);
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// 2. dK, dV (bf16: tensor cores)
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t smem_bytes_dkdv_tc() {
  // K and V tiles, a double buffer of Q and dO tiles, and the two buffers'
  // lse * log2(e) and Delta
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
               bf16* __restrict__ dk,           // (B, K, Sk, D)
               bf16* __restrict__ dv,           // (B, K, Sk, D)
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
  float* l2_s = reinterpret_cast<float*>(do_s + 2 * kBQ * LD);  // 2 x kBQ
  float* dl_s = l2_s + 2 * kBQ;                                 // 2 x kBQ

  const int bkv = blockIdx.y;            // b * K + kv head
  const int G = H / K;
  const int hq0 = (bkv / K) * H + (bkv % K) * G;   // first query head (b, h)
  const int t_kv = blockIdx.x;
  const int k0 = t_kv * kBK;
  const int Sk = mk.Sk;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int key0 = k0 + warp * 16 + (lane >> 2);   // keys key0, key0 + 8
  const int quad_col = 2 * (lane & 3);

  // work items it = g * n_qt + qt: head g of the group, q tile qt, taken
  // when the forward's walk of q tile qt visits this kv tile
  auto next = [&](int it) {
    for (; it < G * n_qt; ++it)
      if (tiles_of(mk, (it % n_qt) * kBQ, S).visits(t_kv)) return it;
    return -1;
  };
  auto load_item = [&](int it, int buf) {
    const long long bh = hq0 + it / n_qt;
    const int q0 = (it % n_qt) * kBQ;
    load_tile<D>(q_s + buf * kBQ * LD, q + bh * S * D, q0, S, tid);
    load_tile<D>(do_s + buf * kBQ * LD, dO + bh * S * D, q0, S, tid);
    if (tid < kBQ) {
      const int r = q0 + tid;
      // a row past S gets p = exp2(-inf) = 0
      l2_s[buf * kBQ + tid] = r < S ? lse[bh * S + r] * kLog2e : inf();
      dl_s[buf * kBQ + tid] = r < S ? delta[bh * S + r] : 0.0f;
    }
  };

  const long long kv_off = static_cast<long long>(bkv) * Sk * D;
  load_tile<D>(k_s, k + kv_off, k0, Sk, tid);
  load_tile<D>(v_s, v + kv_off, k0, Sk, tid);
  int it = next(0);
  if (it >= 0) load_item(it, 0);
  cp_async_commit();

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;
  const float c2 = scale * kLog2e;

  for (int buf = 0; it >= 0; buf ^= 1) {
    const int nxt = next(it + 1);
    if (nxt >= 0) {
      // buffer buf ^ 1 was last read before the __syncthreads that ended
      // the previous item
      load_item(nxt, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (it % n_qt) * kBQ;
    const bf16* qt = q_s + buf * kBQ * LD;
    const bf16* dot = do_s + buf * kBQ * LD;
    const float* l2 = l2_s + buf * kBQ;
    const float* dl = dl_s + buf * kBQ;

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
        ldsm_b_rows<LD>(b, qt, j, kk, lane);
        mma_bf16(st[j], ka, b[0], b[1]);
        mma_bf16(st[j + 1], ka, b[2], b[3]);
        ldsm_b_rows<LD>(b, dot, j, kk, lane);
        mma_bf16(dpt[j], va, b[0], b[1]);
        mma_bf16(dpt[j + 1], va, b[2], b[3]);
      }
    }
    // fragment (j, e): key key0 + 8 (e / 2), q row q0 + 8 j + quad_col +
    // e % 2; st becomes P^T and dpt dS^T
    const bool part = mk.partial(q0, k0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + quad_col + (e & 1);
        float p = exp2f(fmaf(st[j][e], c2, -l2[r]));
        if (part && !mk.visible(q0 + r, key0 + 8 * (e >> 1))) p = 0.0f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dl[r]);
      }

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
        ldsm_b_cols<LD>(b, qt, j, kk, lane);
        mma_bf16(dk_acc[j], sh, b[0], b[1]);
        mma_bf16(dk_acc[j + 1], sh, b[2], b[3]);
        mma_bf16(dk_acc[j], sl, b[0], b[1]);
        mma_bf16(dk_acc[j + 1], sl, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
    it = nxt;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= Sk) continue;
    const long long off = (static_cast<long long>(bkv) * Sk + key) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j + quad_col) =
          __floats2bfloat162_rn(dk_acc[j][2 * h] * scale,
                                dk_acc[j][2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j + quad_col) =
          __floats2bfloat162_rn(dv_acc[j][2 * h], dv_acc[j][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ (bf16: tensor cores)
// ---------------------------------------------------------------------------

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
             float scale) {
  constexpr int LD = D + kPad;
  constexpr int NT = kBK / 8;    // n-tiles of 8 keys
  constexpr int KQ = D / 16;     // k-steps over D
  constexpr int NO = D / 8;      // output n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kBQ * LD;
  bf16* k_s = do_s + kBQ * LD;           // 2 x kBK x LD
  bf16* v_s = k_s + 2 * kBK * LD;        // 2 x kBK x LD

  const int bh = blockIdx.y;             // b * H + h
  const int kvh = (bh / H) * K + (bh % H) / (H / K);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int Sk = mk.Sk;
  const long long q_off = static_cast<long long>(bh) * S * D;
  const bf16* kp = k + static_cast<long long>(kvh) * Sk * D;
  const bf16* vp = v + static_cast<long long>(kvh) * Sk * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = q0 + warp * 16 + (lane >> 2);   // rows row0, row0 + 8
  const int quad_col = 2 * (lane & 3);

  const Tiles tiles = tiles_of(mk, q0, S);
  load_tile<D>(q_s, q + q_off, q0, S, tid);
  load_tile<D>(do_s, dO + q_off, q0, S, tid);
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
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    l2[h] = r < S ? lse[static_cast<long long>(bh) * S + r] * kLog2e : inf();
    dl[h] = r < S ? delta[static_cast<long long>(bh) * S + r] : 0.0f;
  }
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
    // fragment (j, e): row row0 + 8 (e / 2), key k0 + 8 j + quad_col + e % 2;
    // s becomes dS
    const bool part = mk.partial(q0, k0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = exp2f(fmaf(s[j][e], c2, -l2[h]));
        if (part && !mk.visible(row0 + 8 * h, k0 + 8 * j + quad_col + (e & 1)))
          p = 0.0f;
        s[j][e] = p * (dp[j][e] - dl[h]);
      }
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

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(
          dq + q_off + static_cast<long long>(row) * D + 8 * j + quad_col) =
          __floats2bfloat162_rn(acc[j][2 * h] * scale,
                                acc[j][2 * h + 1] * scale);
  }
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

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dO, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, int B, int H, int K, int S, Mask mk,
                   float scale, int bf16_in, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * H * S;
  const dim3 grid_rows(static_cast<unsigned>((rows + 7) / 8));
  const dim3 grid_kv((mk.Sk + kBK - 1) / kBK, B * K);
  const dim3 grid_q((S + kBQ - 1) / kBQ, B * H);
  cudaError_t err;
  if (bf16_in) {
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
               *vb = static_cast<const bf16*>(v), *ob = static_cast<const bf16*>(o),
               *db = static_cast<const bf16*>(dO);
    delta_kernel<bf16><<<grid_rows, 256, 0, stream>>>(ob, db, delta, rows, D);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    constexpr size_t s_kv = smem_bytes_dkdv_tc<D>(), s_q = smem_bytes_dq_tc<D>();
    if ((err = allow_smem(dkdv_kernel_tc<D>, s_kv)) != cudaSuccess) return err;
    if ((err = allow_smem(dq_kernel_tc<D>, s_q)) != cudaSuccess) return err;
    dkdv_kernel_tc<D><<<grid_kv, kThreadsTC, s_kv, stream>>>(
        qb, kb, vb, db, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), H, K, S, mk, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    dq_kernel_tc<D><<<grid_q, kThreadsTC, s_q, stream>>>(
        qb, kb, vb, db, lse, delta, static_cast<bf16*>(dq), H, K, S, mk,
        scale);
    return cudaGetLastError();
  }
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *of = static_cast<const float*>(o),
              *df = static_cast<const float*>(dO);
  delta_kernel<float><<<grid_rows, 256, 0, stream>>>(of, df, delta, rows, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t s_kv = smem_bytes_dkdv_f32<D>(), s_q = smem_bytes_dq_f32<D>();
  if ((err = allow_smem(dkdv_kernel_f32<D>, s_kv)) != cudaSuccess) return err;
  if ((err = allow_smem(dq_kernel_f32<D>, s_q)) != cudaSuccess) return err;
  dkdv_kernel_f32<D><<<grid_kv, kThreadsF, s_kv, stream>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), H, K, S, mk, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel_f32<D><<<grid_q, kThreadsF, s_q, stream>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dq), H, K, S, mk,
      scale);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the first launch that
// failed (0 = success). Same layouts, D, mask arguments and dtype switch as
// flash_attention_launch (window <= 0: no window); o and lse are the
// forward's outputs (lse from a launch that asked for it), dO has o's
// layout and dtype, delta is a (B, H, S) fp32 scratch, and dq, dk, dv take
// q's, k's and v's layouts and dtype. p is taken in fp32 (round_p = 0).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int H, int K, int S, int Sk, int D, float scale,
    int bf16_in, int causal, int window, int sink, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (K <= 0 || H % K != 0 || Sk <= 0 || sink < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask mk{Sk, causal, window, sink};
  switch (D) {
    case 16: return launch<16>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, H, K, S, mk, scale, bf16_in, s);
    case 32: return launch<32>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, H, K, S, mk, scale, bf16_in, s);
    case 64: return launch<64>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, H, K, S, mk, scale, bf16_in, s);
    case 96: return launch<96>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, H, K, S, mk, scale, bf16_in, s);
    case 128: return launch<128>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, H, K, S, mk, scale, bf16_in, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
