// Selective scan of hymba's SSM heads (prefill, h0 = 0), for Hopper (sm_90a).
//
// Replaces repro/kernels/ssm_scan.py::ssm_scan_pallas (body _ssm_kernel).
// Same function, per batch row b, channel d and state j < n:
//   h_j = exp(dt_t * A[d, j]) * h_j + (dt_t * x_t) * B[b, t, j]
//   y[b, t, d] = sum_j h_j * C[b, t, j] + D[d] * x_t
// and, unlike the TPU kernel, it also writes the final state h_final (B, di,
// n), which the model keeps as the decode cache, and, when asked (the
// training call), the state entering every kStateEvery = 64-th step, from
// which the backward (ssm_scan_bwd.cu) recomputes the rest. The plain
// PyTorch version is repro_torch/kernels/ref.py::ssm_scan_ref. The step's
// arithmetic (ex2 and one FMA) is in ssm_scan.cuh, shared with the backward.
//
// What bounds it: the bytes. The function reads x and dt and writes y once,
// 12 bytes per (batch, step, channel) (175 MB, 0.052 ms at hymba's prefill
// shape B = 4, S = 1,128, di = 3,200, n = 16). It also computes one
// exponential per (batch, step, channel, state), 231 M of them: 0.055 ms
// on the SMs' special-function units (16 a clock per SM) alone, but an
// exponential can also be a polynomial on the FMA pipe, and the two pipes
// together take less than the bytes. Each channel's S steps are a
// dependent chain, so the card fills only with many channels in flight at
// once. On the card the kernel issues ~8.4 instructions a state at ~40 %
// of the SMs' issue rate; neither occupancy, the bytes nor the SFU holds
// it there (moving exponentials to the FMA pipe made it slower), and which
// stall does is not measured (PERF.md).
// The design:
//   - the n states of a channel are split over a group of kGroup = 2 lanes
//     (adjacent lanes of one warp), each holding n / 2 states and its slice
//     of A in registers for the whole scan; y_t is the group's sum, one
//     __shfl_xor_sync step, and the group's first lane adds D * x_t and
//     stores, so a warp's y stores cover 16 adjacent channels. At hymba's
//     shape that is 25,600 threads in 400 blocks of 32 channels, 6 warps on
//     each of the 132 SMs (one thread per channel, the first port, gave 100
//     blocks: 32 SMs idle). 4 and 8 lanes cost more shared-memory loads and
//     shuffles per state than they gain in warps (PERF.md);
//   - per round of kChunk = 32 timesteps the block stages x and dt of its
//     channels and the rows of B and C in shared memory with cp.async, double
//     buffered: round k + 1's loads are in flight while round k is computed;
//   - the steps go in batches of kBatch = 8, written as all loads, then all
//     exponentials (none depends on h), then the recurrence, then the
//     shuffles and stores: only the recurrence h = e h + dt x B is a chain
//     from step to step. (A plain unrolled loop is issued by the compiler as
//     one dependent chain a step, LDS -> MUFU -> FFMA -> store.)
//   - channels beyond di are zero-filled and masked (so di need not be a
//     multiple of anything), and a round beyond S is cut short;
//   - exp(dt * A) is 2^(dt * (A * log2(e))), A * log2(e) taken once per
//     (channel, state), by the SFU's ex2.approx.ftz: one instruction,
//     within 2 ulp, results below 2^-126 flushed to zero. This is a
//     deviation from IEEE expf: flushing a factor that small moves h_j by
//     less than 2^-126 |h_j|, and the gap to the plain version stays far
//     inside its 1e-4 gate. exp2f and expf were slower (PERF.md).
// Splitting S into chunks with a carry pass was not taken: correcting y for
// the carried state costs n more exponentials per (step, channel): twice
// the exponentials, whose SFU time alone already exceeds the bytes'.
// The TPU kernel tiles di by a divisor block and carries h across a
// sequential grid axis in VMEM; here the time loop is inside the thread.
// No --use_fast_math.

#include "ssm_scan.cuh"

namespace {

using namespace ssm;

constexpr int kChunk = 32;          // timesteps staged per round
constexpr int kBatch = 8;           // timesteps a batch of loads and exps
static_assert(kStateEvery % kChunk == 0, "a saved state starts a round");

// NL consecutive floats of shared memory into registers, 16 bytes a load
// where NL allows it
template <int NL>
__device__ __forceinline__ void load_row(float (&r)[NL], const float* p) {
  if constexpr (NL % 4 == 0) {
#pragma unroll
    for (int j = 0; j < NL; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      r[j] = v.x, r[j + 1] = v.y, r[j + 2] = v.z, r[j + 3] = v.w;
    }
  } else if constexpr (NL % 2 == 0) {
#pragma unroll
    for (int j = 0; j < NL; j += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + j);
      r[j] = v.x, r[j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NL; ++j) r[j] = p[j];
  }
}

// one round's inputs: x and dt of the block's CH channels, B and C rows
template <int N, int CH>
struct __align__(16) Stage {
  float x[kChunk][CH];
  float dt[kChunk][CH];
  float b[kChunk][N];
  float c[kChunk][N];
};

// issue the cp.async copies of the T = min(kChunk, S - t0) steps from t0
template <int N, int CH>
__device__ __forceinline__ void stage_round(
    Stage<N, CH>& s, const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bc, const float* __restrict__ Cc, long long row0,
    int t0, int S, int d0, int di) {
  const int T = min(kChunk, S - t0);
  for (int e = threadIdx.x; e < T * CH; e += kThreads) {
    const int t = e / CH, c = e % CH;
    const bool in = d0 + c < di;
    const long long off = in ? (row0 + t0 + t) * di + d0 + c : 0;
    cp_async4(&s.x[t][c], x + off, in);
    cp_async4(&s.dt[t][c], dt + off, in);
  }
  const long long boff = (row0 + t0) * N;
  for (int e = threadIdx.x; e < T * N; e += kThreads) {
    cp_async4(&s.b[0][0] + e, Bc + boff + e, true);
    cp_async4(&s.c[0][0] + e, Cc + boff + e, true);
  }
}

// U steps from t of one lane: every load, then every exponential, then the
// recurrence and the lane's share of y_t, sum_j h_j C_j; then the butterfly
// over the group, and the group's first lane stores y_t (y_c points at the
// lane's channel in step 0 of the round).
template <int U, int G, int NL, int N, int CH>
__device__ __forceinline__ void scan_steps(const Stage<N, CH>& s, int t,
                                           int c, int g, const float (&a)[NL],
                                           float (&h)[NL], float d_coef,
                                           bool store, float* y_c, int di) {
  float xv[U], dtv[U], bv[U][NL], cv[U][NL], e[U][NL], acc[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    xv[u] = s.x[t + u][c];
    dtv[u] = s.dt[t + u][c];
    load_row<NL>(bv[u], &s.b[t + u][g * NL]);
    load_row<NL>(cv[u], &s.c[t + u][g * NL]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int j = 0; j < NL; ++j) e[u][j] = exp_of(dtv[u] * a[j]);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float dtx = dtv[u] * xv[u];
    acc[u] = 0.0f;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      h[j] = scan_step(e[u][j], h[j], dtx, bv[u][j]);
      acc[u] += h[j] * cv[u][j];
    }
  }
  // every lane runs every step: the shuffles need the whole warp
#pragma unroll
  for (int m = 1; m < G; m <<= 1)
#pragma unroll
    for (int u = 0; u < U; ++u)
      acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], m);
  if (store) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      y_c[static_cast<long long>(t + u) * di] = acc[u] + d_coef * xv[u];
  }
}

// kSaveStates: write the state entering every kStateEvery-th step (the
// training launch); a template argument, so the serving launch runs code
// with no trace of it
template <int N, bool kSaveStates>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ x,    // (B, S, di)
                const float* __restrict__ dt,   // (B, S, di)
                const float* __restrict__ A,    // (di, N)
                const float* __restrict__ Bc,   // (B, S, N)
                const float* __restrict__ Cc,   // (B, S, N)
                const float* __restrict__ D,    // (di,)
                float* __restrict__ y,          // (B, S, di)
                float* __restrict__ h_final,    // (B, di, N)
                float* __restrict__ states,     // (B, n_states, di, N) or null
                int S, int di) {
  constexpr int G = Split<N>::G, NL = Split<N>::NL, CH = Split<N>::CH;
  __shared__ Stage<N, CH> stage[2];
  const int c = threadIdx.x / G;               // channel within the block
  const int g = threadIdx.x % G;               // lane within the group
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const bool active = d < di;
  const long long row0 = static_cast<long long>(b) * S;  // row (b, t = 0)

  float a[NL], h[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    a[j] = active ? A[static_cast<long long>(d) * N + g * NL + j] * kLog2e
                  : 0.0f;
    h[j] = 0.0f;
  }
  const float d_coef = active ? D[d] : 0.0f;

  const int rounds = (S + kChunk - 1) / kChunk;
  stage_round<N, CH>(stage[0], x, dt, Bc, Cc, row0, 0, S, d0, di);
  cp_async_commit();
  for (int r = 0; r < rounds; ++r) {
    const int t0 = r * kChunk;
    if (r + 1 < rounds) {
      // the buffer of round r + 1 was last read in round r - 1, before the
      // __syncthreads that ended it
      stage_round<N, CH>(stage[(r + 1) & 1], x, dt, Bc, Cc, row0,
                         t0 + kChunk, S, d0, di);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // round r's copies, from every thread, have landed
    const Stage<N, CH>& s = stage[r & 1];
    const int T = min(kChunk, S - t0);
    if (kSaveStates && t0 % kStateEvery == 0 && active) {
      // the state entering step t0, which the backward restarts from
      const int n_states = (S + kStateEvery - 1) / kStateEvery;
      float* hs = states + ((static_cast<long long>(b) * n_states +
                             t0 / kStateEvery) * di + d) * N + g * NL;
#pragma unroll
      for (int j = 0; j < NL; ++j) hs[j] = h[j];
    }
    float* y_c = y + (row0 + t0) * di + d;
    const bool store = g == 0 && active;
    int t = 0;
    for (; t + kBatch <= T; t += kBatch)
      scan_steps<kBatch, G>(s, t, c, g, a, h, d_coef, store, y_c, di);
    for (; t < T; ++t)
      scan_steps<1, G>(s, t, c, g, a, h, d_coef, store, y_c, di);
    __syncthreads();   // every read of stage[r & 1] is done
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < NL; ++j)
      h_final[(static_cast<long long>(b) * di + d) * N + g * NL + j] = h[j];
  }
}

template <int N>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* Bc, const float* Cc, const float* D, float* y,
                   float* h_final, float* states, int B, int S, int di,
                   cudaStream_t stream) {
  constexpr int CH = Split<N>::CH;
  dim3 grid((di + CH - 1) / CH, B);
  auto kernel = states != nullptr ? ssm_scan_kernel<N, true>
                                  : ssm_scan_kernel<N, false>;
  kernel<<<grid, kThreads, 0, stream>>>(x, dt, A, Bc, Cc, D, y, h_final,
                                        states, S, di);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// n must be 4, 8, 16 or 32. states, when not null, is (B, ceil(S /
// kStateEvery), di, n) and receives the state entering every kStateEvery-th
// step (the first is h0 = 0), from which ssm_scan_bwd.cu recomputes the
// others; the serving call passes null.
extern "C" int ssm_scan_launch(const float* x, const float* dt, const float* A,
                               const float* Bc, const float* Cc,
                               const float* D, float* y, float* h_final,
                               float* states, int B, int S, int di, int n,
                               void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n) {
    case 4: err = launch<4>(x, dt, A, Bc, Cc, D, y, h_final, states, B, S, di, s); break;
    case 8: err = launch<8>(x, dt, A, Bc, Cc, D, y, h_final, states, B, S, di, s); break;
    case 16: err = launch<16>(x, dt, A, Bc, Cc, D, y, h_final, states, B, S, di, s); break;
    case 32: err = launch<32>(x, dt, A, Bc, Cc, D, y, h_final, states, B, S, di, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
