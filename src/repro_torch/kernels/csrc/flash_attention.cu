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
// flash_attention.cuh, shared with the backward.
//
// What bounds it on this card: at hymba's prefill shape (4, 25, 5, 1128, 64)
// the causal work is ~16 GFLOP on ~35 MB, far above the bytes-per-op ridge,
// so operations bound it, and in bf16 only the tensor cores reach them.
//
// bf16 inputs: tensor cores through mma.sync.m16n8k16 (fp32 accumulate),
// the FlashAttention-2 layout. wgmma would reach a higher peak (and its
// asynchronous issue would let one warpgroup's softmax overlap another's
// products); mma.sync keeps to register fragments whose layout is fixed by
// the instruction, with no shared-memory descriptors to get right.
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

#include "flash_attention.cuh"

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
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, H, K, S, mk, scale);
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
