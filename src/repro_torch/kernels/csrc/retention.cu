// Batched transient retention of gain-cell storage nodes, for Hopper (sm_90a).
//
// Replaces repro/kernels/retention_kernel.py::retention_pallas (body
// _retention_kernel). Same function: for each packed config row
// [vt, n, ispec, eta, i_floor, jg, c_sn, w, v0, v_min], RK4 of
//   dV/dt = -((max(I_ch(V), 0) + i_floor) * w + jg * V) / max(c_sn, 1e-18)
// with I_ch the EKV subthreshold current at vgs = 0 (F(u) = softplus(u/2)^2),
// over the shared log time grid ts, V clipped to [0, 2] after every step,
// and the first crossing below v_min interpolated log-linearly. A row that
// never crosses, or that starts crossed (v0 < v_min), returns ts[N].
// The plain PyTorch version is repro_torch/kernels/ref.py::retention_ref.
//
// What bounds it: fp32 arithmetic and transcendental throughput. A row
// moves 40 bytes in and 4 bytes out, but runs 480 sequential steps of four
// derivative evaluations, each with two expf, two log1pf and three IEEE
// divisions. The design keeps the card's lanes busy on that arithmetic and
// touches memory once:
//   - one thread per row, over a 1-D grid of ceil(B/128) blocks; the
//     ragged tail is masked, so no padding rows are computed;
//   - v, t_ret and found live in registers for all 480 steps;
//   - ts (481 floats, 1.9 KB) is staged once per block in shared memory;
//     every lane reads the same word, a broadcast;
//   - params are field-major (10, B), so a warp's loads are coalesced;
//   - the crossing's logf/expf run only on the step where the row crosses
//     (the result is the same as computing them every step and selecting).
// IEEE expf/log1pf/logf, no --use_fast_math, so the kernel agrees with its
// plain version to float32 rounding.

#include <cuda_runtime.h>

namespace {

constexpr float kUT = 0.02585f;   // thermal voltage at 300 K [V]
constexpr int kBlock = 128;

__device__ __forceinline__ float softplus_sq(float u) {
  float sp = u > 40.0f ? u / 2.0f : log1pf(expf(fminf(u / 2.0f, 40.0f)));
  return sp * sp;
}

struct Row {
  float vt, n, ispec, eta, i_floor, jg, c_sn, w;
};

// dV/dt at V (V already clipped at 0 by the caller's fmaxf)
__device__ __forceinline__ float dvdt(const Row& r, float v) {
  float vt_eff = r.vt - r.eta * v;
  float nut = r.n * kUT;
  float i_ch = r.ispec * (softplus_sq((0.0f - vt_eff) / nut)
                          - softplus_sq((0.0f - vt_eff - r.n * v) / nut));
  float leak = (fmaxf(i_ch, 0.0f) + r.i_floor) * r.w + r.jg * v;
  return -leak / fmaxf(r.c_sn, 1e-18f);
}

__global__ void __launch_bounds__(kBlock)
retention_kernel(const float* __restrict__ params_t,  // (10, B) field-major
                 const float* __restrict__ ts,        // (n_steps + 1,)
                 float* __restrict__ out,             // (B,)
                 long long B, int n_steps) {
  extern __shared__ float ts_s[];
  for (int j = threadIdx.x; j <= n_steps; j += blockDim.x) ts_s[j] = ts[j];
  __syncthreads();

  long long row = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (row >= B) return;

  Row r;
  r.vt = params_t[0 * B + row];
  r.n = params_t[1 * B + row];
  r.ispec = params_t[2 * B + row];
  r.eta = params_t[3 * B + row];
  r.i_floor = params_t[4 * B + row];
  r.jg = params_t[5 * B + row];
  r.c_sn = params_t[6 * B + row];
  r.w = params_t[7 * B + row];
  float v = params_t[8 * B + row];
  const float v_min = params_t[9 * B + row];

  float t_ret = ts_s[n_steps];
  bool found = v < v_min;
  for (int i = 0; i < n_steps; ++i) {
    float t0 = ts_s[i];
    float t1 = ts_s[i + 1];
    float dt = t1 - t0;
    float k1 = dvdt(r, fmaxf(v, 0.0f));
    float k2 = dvdt(r, fmaxf(v + 0.5f * dt * k1, 0.0f));
    float k3 = dvdt(r, fmaxf(v + 0.5f * dt * k2, 0.0f));
    float k4 = dvdt(r, fmaxf(v + dt * k3, 0.0f));
    float v_new = v + dt / 6.0f * (k1 + 2.0f * k2 + 2.0f * k3 + k4);
    v_new = fminf(fmaxf(v_new, 0.0f), 2.0f);
    if (!found && v_new < v_min) {
      float frac = (v - v_min) / fmaxf(v - v_new, 1e-9f);
      frac = fminf(fmaxf(frac, 0.0f), 1.0f);
      float l0 = logf(t0);
      t_ret = expf(l0 + frac * (logf(t1) - l0));
      found = true;
    }
    v = v_new;
  }
  out[row] = t_ret;
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int retention_launch(const float* params_t, const float* ts,
                                float* out, long long B, int n_steps,
                                void* stream) {
  if (B <= 0) return 0;
  unsigned int blocks = static_cast<unsigned int>((B + kBlock - 1) / kBlock);
  size_t smem = static_cast<size_t>(n_steps + 1) * sizeof(float);
  retention_kernel<<<blocks, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      params_t, ts, out, B, n_steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* retention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
