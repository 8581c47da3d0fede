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
// UT, the thermal voltage of the operating corner, is one float argument of
// the launch (the Pallas kernel fixes it at 0.02585 V, 300 K): the packed
// rows cannot carry it, since the subthreshold term needs n v and n UT
// apart. The host passes ut and inv_ut = 1.0f / ut, both float32, so the
// nominal launch computes what the former constants 0.02585f and
// 1.0f / 0.02585f gave.
// The plain PyTorch version is repro_torch/kernels/ref.py::retention_ref.
//
// What bounds it: fp32 arithmetic and transcendental throughput. A row
// moves 40 bytes in and 4 bytes out, but runs 480 sequential steps of four
// derivative evaluations, each with two expf and two log1pf. With few rows
// (explore's B = 120 is one block, one warp on each of four schedulers) the
// time is the steps' dependent chain; with many (2^20) it is the
// instructions issued. Both fall with the instructions of one step.
//
// What holds it to the plain version at every corner: the subthreshold
// current is exp(u1) with u1 = -vt_eff / (n UT), and |u1| reaches ~35 at
// 233 K, so a relative error e in u1 becomes ~35 e in the current and in
// the retention time. Multiplying by a per-row reciprocal of n UT (and of
// c_sn) instead of dividing put the kernel 1.1e-5 from the plain version on
// rows perturbed at (1.2 V, 233 K) (2.9e-6 at nominal), over the gate. So
// the evaluation rounds as retention_ref does: u1 = -vt_eff / nut and
// -leak / c are correctly rounded quotients, and the products and sums
// the plain version rounds apart are written with __fmul_rn / __fadd_rn,
// which the compiler never contracts into FMAs. Each quotient x / y takes
// the per-row reciprocal r = 1 / y (one IEEE division per row) and
// Markstein's correction, q = x r, e = fma(-q, y, x) (exact), q + e r
// rounded: with r correctly rounded and q within an ulp, that is the
// correctly rounded x / y while no term underflows, which the rows'
// magnitudes rule out. Three instructions instead of div.rn's sequence
// with its slow-path branch: on the card the outputs are bit for bit
// those of div.rn on every row of 2 x 2^20 perturbed rows, the paper grid
// and the wide grid at five corners, at 0.416 ms instead of 0.496 ms
// (B = 120) and 7.37 instead of 8.39 ms (B = 2^20)
// (tools/retention_quotients.py; PERF.md, PR 15).
// (-vt_eff - n v) / nut is taken as u1 - v * inv_ut, inv_ut = 1 / UT from
// the host: while V is above the threshold, exp(u2) is below exp(u1) by
// e^(V / UT) > e^10 (the least threshold over ut of the cells at any
// corner here is 10.2, at low_vdd), so its rounding does not reach the
// result. Also:
//   - per step, once per block in shared memory: dt = ts[i+1] - ts[i],
//     0.5 * dt and dt / 6, the float32 expressions retention_ref uses, so
//     those three values are the plain version's bit for bit;
//   - one thread per row, over a 1-D grid of ceil(B / 128) blocks; the
//     ragged tail is masked, so no padding rows are computed;
//   - v, t_ret and found live in registers for all the steps;
//   - params are field-major (10, B), so a warp's loads are coalesced;
//   - the crossing's logf/expf run only on the step where the row crosses
//     (the result is the same as computing them every step and selecting),
//     from ts staged in shared memory.
// The kernel is held to the plain version at rtol 1e-5 (chip_smoke.py,
// tests/test_torch_cuda.py) at every corner, and the same order of
// operations in float32 on the CPU at the same gate
// (tests/test_torch_retention.py). IEEE expf/log1pf/logf, no
// --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

__device__ __forceinline__ float softplus_sq(float u) {
  float sp = u > 40.0f ? u / 2.0f : log1pf(expf(fminf(u / 2.0f, 40.0f)));
  return __fmul_rn(sp, sp);   // rounded before F(u1) - F(u2), as the plain
                              // version rounds it
}

struct Row {
  float vt, eta, nut, inv_nut, inv_ut, ispec, i_floor, w, jg, c, inv_c;
};

// x / y correctly rounded, from r = 1 / y correctly rounded (Markstein)
__device__ __forceinline__ float div_by(float x, float y, float r) {
  float q = __fmul_rn(x, r);
  float e = __fmaf_rn(-q, y, x);
  return __fmaf_rn(e, r, q);
}

// dV/dt at V (V already clipped at 0 by the caller's fmaxf), rounded as
// retention_ref rounds it
__device__ __forceinline__ float dvdt(const Row& r, float v) {
  float vt_eff = __fsub_rn(r.vt, __fmul_rn(r.eta, v));
  float u1 = div_by(0.0f - vt_eff, r.nut, r.inv_nut);
  float u2 = __fsub_rn(u1, __fmul_rn(v, r.inv_ut));
  float i_ch = r.ispec * (softplus_sq(u1) - softplus_sq(u2));
  float leak = __fadd_rn(__fmul_rn(fmaxf(i_ch, 0.0f) + r.i_floor, r.w),
                         __fmul_rn(r.jg, v));
  return div_by(-leak, r.c, r.inv_c);
}

__global__ void __launch_bounds__(kBlock)
retention_kernel(const float* __restrict__ params_t,  // (10, B) field-major
                 const float* __restrict__ ts,        // (n_steps + 1,)
                 float* __restrict__ out,             // (B,)
                 long long B, int n_steps, float ut, float inv_ut) {
  // ts, then dt, dt / 2 and dt / 6 of each step
  extern __shared__ float smem[];
  float* ts_s = smem;
  float* dt_s = ts_s + n_steps + 1;
  float* half_dt_s = dt_s + n_steps;
  float* sixth_dt_s = half_dt_s + n_steps;
  for (int j = threadIdx.x; j <= n_steps; j += blockDim.x) ts_s[j] = ts[j];
  for (int j = threadIdx.x; j < n_steps; j += blockDim.x) {
    const float dt = ts[j + 1] - ts[j];
    dt_s[j] = dt;
    half_dt_s[j] = 0.5f * dt;
    sixth_dt_s[j] = dt / 6.0f;
  }
  __syncthreads();

  long long row = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (row >= B) return;

  Row r;
  r.vt = params_t[0 * B + row];
  const float n = params_t[1 * B + row];
  r.ispec = params_t[2 * B + row];
  r.eta = params_t[3 * B + row];
  r.i_floor = params_t[4 * B + row];
  r.jg = params_t[5 * B + row];
  r.c = fmaxf(params_t[6 * B + row], 1e-18f);
  r.w = params_t[7 * B + row];
  float v = params_t[8 * B + row];
  const float v_min = params_t[9 * B + row];
  r.nut = n * ut;
  r.inv_nut = 1.0f / r.nut;
  r.inv_c = 1.0f / r.c;
  r.inv_ut = inv_ut;

  float t_ret = ts_s[n_steps];
  bool found = v < v_min;
  for (int i = 0; i < n_steps; ++i) {
    const float dt = dt_s[i];
    const float half_dt = half_dt_s[i];
    float k1 = dvdt(r, fmaxf(v, 0.0f));
    float k2 = dvdt(r, fmaxf(__fadd_rn(v, __fmul_rn(half_dt, k1)), 0.0f));
    float k3 = dvdt(r, fmaxf(__fadd_rn(v, __fmul_rn(half_dt, k2)), 0.0f));
    float k4 = dvdt(r, fmaxf(__fadd_rn(v, __fmul_rn(dt, k3)), 0.0f));
    // 2 k is exact, so k1 + 2 k2 rounds once, fused or not
    float sum = k1 + 2.0f * k2 + 2.0f * k3 + k4;
    float v_new = __fadd_rn(v, __fmul_rn(sixth_dt_s[i], sum));
    v_new = fminf(fmaxf(v_new, 0.0f), 2.0f);
    if (!found && v_new < v_min) {
      float frac = (v - v_min) / fmaxf(v - v_new, 1e-9f);
      frac = fminf(fmaxf(frac, 0.0f), 1.0f);
      float l0 = logf(ts_s[i]);
      t_ret = expf(__fadd_rn(l0, __fmul_rn(frac, logf(ts_s[i + 1]) - l0)));
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
                                float ut, float inv_ut, void* stream) {
  if (B <= 0) return 0;
  unsigned int blocks = static_cast<unsigned int>((B + kBlock - 1) / kBlock);
  size_t smem = static_cast<size_t>(4 * n_steps + 1) * sizeof(float);
  // a grid of more than ~3,000 points needs more than the 48 KB a launch
  // gets without opting in
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        retention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  retention_kernel<<<blocks, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      params_t, ts, out, B, n_steps, ut, inv_ut);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* retention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
