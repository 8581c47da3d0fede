// Selective scan of hymba's SSM heads (prefill, h0 = 0), for Hopper (sm_90a).
//
// Replaces repro/kernels/ssm_scan.py::ssm_scan_pallas (body _ssm_kernel).
// Same function, per batch row b, channel d and state j < n:
//   h_j = exp(dt_t * A[d, j]) * h_j + (dt_t * x_t) * B[b, t, j]
//   y[b, t, d] = sum_j h_j * C[b, t, j] + D[d] * x_t
// and, unlike the TPU kernel, it also writes the final state h_final (B, di,
// n), which the model keeps as the decode cache. The plain PyTorch version
// is repro_torch/kernels/ref.py::ssm_scan_ref.
//
// What bounds it: bytes. The function reads x and dt and writes y once,
// 12 bytes per (batch, step, channel) (175 MB at hymba's prefill shape
// B = 4, S = 1,128, di = 3,200), against 7 fp32 operations per state and
// step (one of them an IEEE expf), so the least time is the memory's. But
// each channel's S steps are a dependent chain, and B * di = 12,800
// threads fill the card only thinly, so this first version is bound by the
// latency of that chain, not by either peak.
// The design:
//   - one thread per (batch row, channel), blocks of 128 channels over a
//     (ceil(di / 128), B) grid; channels beyond di are masked, so di need
//     not be a multiple of anything (hymba's di = 3200 is 25 blocks);
//   - the n states and the row of A live in registers for the whole scan
//     (n is a template parameter, so the state arrays are fully unrolled);
//   - per chunk of 32 timesteps the block stages B_t and C_t (shared by all
//     its channels) and each thread's own x, dt column in shared memory, so
//     the 32 global loads of a column are in flight together instead of
//     one dependent load per step;
//   - y is written at every step, h_final once at the end.
// The TPU kernel tiles di by a divisor block and carries h across a
// sequential grid axis in VMEM; here the time loop is inside the thread.
// IEEE expf, no --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;   // channels per block
constexpr int kChunk = 32;    // timesteps staged per round

template <int N>
__global__ void __launch_bounds__(kBlock)
ssm_scan_kernel(const float* __restrict__ x,    // (B, S, di)
                const float* __restrict__ dt,   // (B, S, di)
                const float* __restrict__ A,    // (di, N)
                const float* __restrict__ Bc,   // (B, S, N)
                const float* __restrict__ Cc,   // (B, S, N)
                const float* __restrict__ D,    // (di,)
                float* __restrict__ y,          // (B, S, di)
                float* __restrict__ h_final,    // (B, di, N)
                int S, int di) {
  __shared__ float b_s[kChunk][N];
  __shared__ float c_s[kChunk][N];
  __shared__ float x_s[kChunk][kBlock];
  __shared__ float dt_s[kChunk][kBlock];

  const int b = blockIdx.y;
  const int d = blockIdx.x * kBlock + threadIdx.x;
  const bool active = d < di;
  const long long row0 = static_cast<long long>(b) * S;  // row (b, t = 0)

  float a[N], h[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    a[j] = active ? A[static_cast<long long>(d) * N + j] : 0.0f;
    h[j] = 0.0f;
  }
  const float d_coef = active ? D[d] : 0.0f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int T = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < T * N; i += kBlock) {
      b_s[i / N][i % N] = Bc[(row0 + t0) * N + i];
      c_s[i / N][i % N] = Cc[(row0 + t0) * N + i];
    }
    if (active) {
#pragma unroll 8
      for (int t = 0; t < T; ++t) {
        const long long off = (row0 + t0 + t) * di + d;
        x_s[t][threadIdx.x] = x[off];
        dt_s[t][threadIdx.x] = dt[off];
      }
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < T; ++t) {
      const float x_t = x_s[t][threadIdx.x];
      const float dt_t = dt_s[t][threadIdx.x];
      const float dtx = dt_t * x_t;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        h[j] = expf(dt_t * a[j]) * h[j] + dtx * b_s[t][j];
        acc += h[j] * c_s[t][j];
      }
      y[(row0 + t0 + t) * di + d] = acc + d_coef * x_t;
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      h_final[(static_cast<long long>(b) * di + d) * N + j] = h[j];
  }
}

template <int N>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* Bc, const float* Cc, const float* D, float* y,
                   float* h_final, int B, int S, int di, cudaStream_t stream) {
  dim3 grid((di + kBlock - 1) / kBlock, B);
  ssm_scan_kernel<N><<<grid, kBlock, 0, stream>>>(x, dt, A, Bc, Cc, D, y,
                                                   h_final, S, di);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// n must be 4, 8, 16 or 32.
extern "C" int ssm_scan_launch(const float* x, const float* dt, const float* A,
                               const float* Bc, const float* Cc,
                               const float* D, float* y, float* h_final,
                               int B, int S, int di, int n, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n) {
    case 4: err = launch<4>(x, dt, A, Bc, Cc, D, y, h_final, B, S, di, s); break;
    case 8: err = launch<8>(x, dt, A, Bc, Cc, D, y, h_final, B, S, di, s); break;
    case 16: err = launch<16>(x, dt, A, Bc, Cc, D, y, h_final, B, S, di, s); break;
    case 32: err = launch<32>(x, dt, A, Bc, Cc, D, y, h_final, B, S, di, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
