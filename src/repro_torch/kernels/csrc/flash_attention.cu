// Flash-attention forward (serving prefill), for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention (body
// _flash_kernel). Same function: o = softmax(q k^T / sqrt(D) + mask) v with
// an online softmax over kv tiles, m, l and the accumulator in fp32,
// entries above the diagonal (causal) set to -0.7 * FLT_MAX, p rounded to
// v's dtype before the PV product, l clamped to >= 1e-30, output in q's
// dtype. Beyond the TPU kernel it takes grouped-query attention (query head
// h reads kv head h / (H / K), so K and V are never repeated in memory) and
// any sequence length (the ragged last tile is masked). The plain PyTorch
// version is repro_torch/kernels/ref.py::attention_ref, which uses the same
// kv tile width.
//
// What bounds it on this card: at hymba's prefill shape the work is
// ~16 GFLOP on ~35 MB, far above the bytes-per-op ridge, so operations
// bound it. This first version does them as fp32 FMAs from shared memory,
// not on the tensor cores (wgmma is later work), which also keeps fp32
// inputs in IEEE fp32, as the reference's 2e-5 gate needs (TF32 could not
// meet it). The design:
//   - one block of 256 threads per (batch * head, 64-row q tile), over a
//     (ceil(S / 64), B * H) grid; four threads share a q row, each owning
//     16 of the 64 score columns and D/4 of the output columns;
//   - the q tile stays in shared memory (fp32) for the whole kv loop; each
//     64-row kv tile of K and V is staged in shared memory (fp32, rows of K
//     padded by one word so the row-strided reads hit distinct banks);
//   - the row max and row sum of a tile reduce over the four threads of a
//     row with warp shuffles; p goes through shared memory (a row's p is
//     written and read by the same four lanes, so a warp barrier orders it);
//   - with causal masking the loop stops at the last kv tile that meets
//     the diagonal of the tile's last real row: tiles above it are never
//     loaded (the TPU kernel skips them too);
//   - D is a template parameter (16, 32, 64, 96, 128), so the per-thread
//     accumulator is an unrolled register array.
// IEEE expf, no --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // kv rows per tile (ref.BLOCK_K)
constexpr int kThreads = 256;  // 4 threads per q row
// -0.7 * FLT_MAX, rounded once from double, as the plain version has it
constexpr float kNeg = static_cast<float>(-0.7 * 3.4028234663852886e38);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// p as the PV product sees it: rounded to v's dtype
template <typename T> __device__ __forceinline__ float round_p(float p) {
  return to_f(from_f<T>(p));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D +
                          kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q,   // (B, H, S, D)
             const T* __restrict__ k,   // (B, K, Sk, D)
             const T* __restrict__ v,   // (B, K, Sk, D)
             T* __restrict__ o,         // (B, H, S, D)
             int H, int K, int S, int Sk, float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int LP = kBK + 1;
  float* q_s = smem;                 // kBQ x LD
  float* k_s = q_s + kBQ * LD;       // kBK x LD
  float* v_s = k_s + kBK * LD;       // kBK x D
  float* p_s = v_s + kBK * D;        // kBQ x LP

  const int bh = blockIdx.y;         // b * H + h
  const int kvh = (bh / H) * K + (bh % H) / (H / K);
  const int q0 = blockIdx.x * kBQ;
  const T* qp = q + static_cast<long long>(bh) * S * D;
  const T* kp = k + static_cast<long long>(kvh) * Sk * D;
  const T* vp = v + static_cast<long long>(kvh) * Sk * D;
  T* op = o + static_cast<long long>(bh) * S * D;

  const int tid = threadIdx.x;
  const int r = tid >> 2;            // q row within the tile
  const int c4 = tid & 3;            // column phase
  const int row = q0 + r;

  // q tile; rows past S read as 0 and are never stored
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, dd = i % D;
    q_s[rr * LD + dd] =
        q0 + rr < S ? to_f(qp[static_cast<long long>(q0 + rr) * D + dd]) : 0.0f;
  }

  float m = kNeg, l = 0.0f;
  float acc[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc[j] = 0.0f;

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBQ, S) - 1) / kBK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int rr = i / D, dd = i % D;
      const bool in = k0 + rr < Sk;
      const long long g = static_cast<long long>(k0 + rr) * D + dd;
      k_s[rr * LD + dd] = in ? to_f(kp[g]) : 0.0f;
      v_s[rr * D + dd] = in ? to_f(vp[g]) : 0.0f;
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
      const int col = k0 + c4 + 4 * j;
      float sv = s[j] * scale;
      if (col >= Sk || (causal && col > row)) sv = kNeg;
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
      p_s[r * LP + c4 + 4 * j] = round_p<T>(p);
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + ps;
    m = m_new;
    __syncwarp();  // row r's p was written by the lanes that read it

#pragma unroll
    for (int j = 0; j < D / 4; ++j) acc[j] *= alpha;
    for (int c = 0; c < kBK; ++c) {
      const float p = p_s[r * LP + c];
#pragma unroll
      for (int j = 0; j < D / 4; ++j)
        acc[j] = fmaf(p, v_s[c * D + c4 + 4 * j], acc[j]);
    }
  }

  if (row < S) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 4; ++j)
      op[static_cast<long long>(row) * D + c4 + 4 * j] =
          from_f<T>(acc[j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int K, int S, int Sk, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, K, S, Sk, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int K, int S, int Sk, int D, float scale,
                     int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, K, S, Sk, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, B, H, K, S, Sk, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, K, S, Sk, scale, causal, s);
    case 96: return launch<T, 96>(q, k, v, o, B, H, K, S, Sk, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, K, S, Sk, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// bf16 != 0: q, k, v, o are bfloat16, else float32. D must be 16, 32, 64,
// 96 or 128, and H a multiple of K.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int K, int S, int Sk, int D,
                                      float scale, int bf16, int causal,
                                      void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (K <= 0 || H % K != 0 || Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, H, K, S, Sk, D, scale,
                                     causal, s)
           : dispatch<float>(q, k, v, o, B, H, K, S, Sk, D, scale, causal, s);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
