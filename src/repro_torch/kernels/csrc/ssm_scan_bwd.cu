// Selective-scan backward (training), for Hopper (sm_90a).
//
// The gradient of the scan of ssm_scan.cu (h0 = 0): given its inputs, the
// states it saved entering every kStateEvery = 64-th step, dy and dh_final,
// it returns dx, ddt, dA, dB, dC and dD. The TPU kernel it stands beside
// (repro/kernels/ssm_scan.py::ssm_scan_pallas) is forward only; the JAX
// model trains through autodiff of repro/models/ssm.py::ssm_scan_chunked.
// The plain version is autograd through repro_torch/kernels/ref.py::
// ssm_scan_ref (ref.ssm_scan_ref_grads).
//
// With a_t = exp(dt_t A) and g_t = dL/dh_t, the adjoint runs backward in time
//   g_t = C_t dy_t + a_{t+1} g_{t+1},   g_{S-1} = C_{S-1} dy_{S-1} + dh_final
// and per (b, t, channel d, state j)
//   dx_t  = D dy_t + dt_t sum_j g_j B_j
//   ddt_t = sum_j g_j (A_j a_j h_{t-1, j} + x_t B_j)
//   dA_j += g_j dt_t a_j h_{t-1, j}      (sum over b and t)
//   dB_j += g_j dt_t x_t                 (sum over the channels)
//   dC_j += dy_t h_{t, j}                (sum over the channels)
//   dD   += dy_t x_t                     (sum over b and t)
//
// What bounds it: the bytes at hymba's shape (x, dt, dy read and dx, ddt
// written, 20 bytes a (batch, step, channel)), as for the forward, with
// ~20 fp32 operations and at least one exponential a state; each channel's
// steps are again one dependent chain, now run backward.
//
// The design: the forward's block (64 threads, 32 channels, a channel's n
// states over kGroup = 2 lanes) walks the chunks of kStateEvery steps from
// the last to the first. Per chunk it stages x, dt, dy, B and C in shared
// memory and recomputes the chunk's states from the saved one with the
// forward's arithmetic (ssm_scan.cuh: the same ex2 and FMA, so the states
// are the forward's bit for bit; h_{t-1} is never recovered by dividing
// by a_t, which underflows for the strongly decaying channels). Registers
// hold U steps of states and factors, so the chunk is recomputed twice:
// once to keep the state entering each U-step sub-chunk (in shared
// memory), once per sub-chunk into registers, which the backward walk then
// reads in reverse. The reductions, each in a fixed order:
//   - dx and ddt: the group's two lanes, one shuffle;
//   - dB and dC (over channels): each thread writes its states' terms of a
//     sub-chunk to shared memory and the block sums its 32 channels in
//     order; the per-block sums go to a scratch, and a second kernel of
//     this launch (ssm_scan_bwd_reduce) sums the blocks in order;
//   - dA and dD (over b and t): in registers over t, one partial per batch
//     row to the scratch, summed over b in order by the second kernel.
// No --use_fast_math.

#include "ssm_scan.cuh"

namespace {

using namespace ssm;

constexpr int kT = kStateEvery;     // steps of a chunk

template <int N>
struct Bwd {
  static constexpr int G = Split<N>::G, NL = Split<N>::NL, CH = Split<N>::CH;
  // steps a sub-chunk: (U + 1) states and U factors of NL each in registers
  static constexpr int U = NL <= 8 ? 8 : 4;
  static constexpr int NSUB = kT / U;
};

template <int N>
struct Smem {
  static constexpr int CH = Bwd<N>::CH, NL = Bwd<N>::NL, U = Bwd<N>::U;
  float x[kT][CH];
  float dt[kT][CH];
  float dy[kT][CH];
  float b[kT][N];
  float c[kT][N];
  float hb[Bwd<N>::NSUB][kThreads][NL];  // state entering each sub-chunk
  float rb[U][N][CH + 1];                // a sub-chunk's dB terms
  float rc[U][N][CH + 1];                // a sub-chunk's dC terms
};

template <int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const float* __restrict__ x,        // (B, S, di)
                    const float* __restrict__ dt,       // (B, S, di)
                    const float* __restrict__ A,        // (di, N)
                    const float* __restrict__ Bc,       // (B, S, N)
                    const float* __restrict__ Cc,       // (B, S, N)
                    const float* __restrict__ D,        // (di,)
                    const float* __restrict__ states,   // (B, n_states, di, N)
                    const float* __restrict__ dy,       // (B, S, di)
                    const float* __restrict__ dh_final, // (B, di, N) or null
                    float* __restrict__ dx,             // (B, S, di)
                    float* __restrict__ ddt,            // (B, S, di)
                    float* __restrict__ pB,             // (nblk, B, S, N)
                    float* __restrict__ pC,             // (nblk, B, S, N)
                    float* __restrict__ pA,             // (B, di, N)
                    float* __restrict__ pD,             // (B, di)
                    int S, int di) {
  using P = Bwd<N>;
  constexpr int G = P::G, NL = P::NL, CH = P::CH, U = P::U;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<N>& s = *reinterpret_cast<Smem<N>*>(smem_raw);
  const int tid = threadIdx.x;
  const int c = tid / G;                       // channel within the block
  const int gl = tid % G;                      // lane within the group
  const int j0 = gl * NL;                      // the lane's first state
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const bool active = d < di;
  const int n_states = (S + kT - 1) / kT;
  const long long row0 = static_cast<long long>(b) * S;  // row (b, t = 0)

  float a2[NL], an[NL], g[NL], dA[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    an[j] = active ? A[static_cast<long long>(d) * N + j0 + j] : 0.0f;
    a2[j] = an[j] * kLog2e;                    // as the forward takes it
    g[j] = active && dh_final != nullptr
               ? dh_final[(static_cast<long long>(b) * di + d) * N + j0 + j]
               : 0.0f;
    dA[j] = 0.0f;
  }
  const float d_coef = active ? D[d] : 0.0f;
  float dD = 0.0f;

  for (int ch = n_states - 1; ch >= 0; --ch) {
    const int t0 = ch * kT;
    const int T = min(kT, S - t0);
    __syncthreads();   // every read of the previous chunk's stage is done
    for (int e = tid; e < T * CH; e += kThreads) {
      const int t = e / CH, cc = e % CH;
      const bool in = d0 + cc < di;
      const long long off = (row0 + t0 + t) * di + d0 + cc;
      s.x[t][cc] = in ? x[off] : 0.0f;
      s.dt[t][cc] = in ? dt[off] : 0.0f;
      s.dy[t][cc] = in ? dy[off] : 0.0f;
    }
    for (int e = tid; e < T * N; e += kThreads) {
      (&s.b[0][0])[e] = Bc[(row0 + t0) * N + e];
      (&s.c[0][0])[e] = Cc[(row0 + t0) * N + e];
    }
    float h[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j)
      h[j] = active ? states[((static_cast<long long>(b) * n_states + ch) *
                                  di + d) * N + j0 + j]
                    : 0.0f;
    __syncthreads();

    // the state entering each sub-chunk (each thread reads back only its
    // own, so this needs no barrier)
    const int nsub = (T + U - 1) / U;
    for (int sb = 0; sb < nsub; ++sb) {
#pragma unroll
      for (int j = 0; j < NL; ++j) s.hb[sb][tid][j] = h[j];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = sb * U + u;
        if (t < T) {
          const float dtv = s.dt[t][c], dtx = dtv * s.x[t][c];
#pragma unroll
          for (int j = 0; j < NL; ++j)
            h[j] = scan_step(exp_of(dtv * a2[j]), h[j], dtx, s.b[t][j0 + j]);
        }
      }
    }

    for (int sb = nsub - 1; sb >= 0; --sb) {
      // hs[u] = h_{t-1} and hs[u + 1] = h_t of step t = sb U + u; ea[u] = a_t
      float hs[U + 1][NL], ea[U][NL];
#pragma unroll
      for (int j = 0; j < NL; ++j) hs[0][j] = s.hb[sb][tid][j];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = sb * U + u;
        if (t < T) {
          const float dtv = s.dt[t][c], dtx = dtv * s.x[t][c];
#pragma unroll
          for (int j = 0; j < NL; ++j) {
            ea[u][j] = exp_of(dtv * a2[j]);
            hs[u + 1][j] = scan_step(ea[u][j], hs[u][j], dtx, s.b[t][j0 + j]);
          }
        }
      }
#pragma unroll
      for (int u = U - 1; u >= 0; --u) {
        const int t = sb * U + u;
        if (t < T) {   // the same for every thread: the shuffles are safe
          const float dyv = s.dy[t][c], xv = s.x[t][c], dtv = s.dt[t][c];
          const float dtx = dtv * xv;
          float px = 0.0f, pt = 0.0f;
#pragma unroll
          for (int j = 0; j < NL; ++j) {
            const float bj = s.b[t][j0 + j], cj = s.c[t][j0 + j];
            g[j] = fmaf(cj, dyv, g[j]);               // g_t
            const float ah = ea[u][j] * hs[u][j];     // a_t h_{t-1}
            px = fmaf(g[j], bj, px);
            pt = fmaf(g[j], fmaf(an[j], ah, xv * bj), pt);
            dA[j] = fmaf(g[j] * dtv, ah, dA[j]);
            s.rb[u][j0 + j][c] = g[j] * dtx;
            s.rc[u][j0 + j][c] = dyv * hs[u + 1][j];
            g[j] *= ea[u][j];                         // a_t g_t, for t - 1
          }
#pragma unroll
          for (int m = 1; m < G; m <<= 1) {
            px += __shfl_xor_sync(0xffffffffu, px, m);
            pt += __shfl_xor_sync(0xffffffffu, pt, m);
          }
          if (gl == 0 && active) {
            const long long off = (row0 + t0 + t) * di + d;
            dx[off] = fmaf(d_coef, dyv, dtv * px);
            ddt[off] = pt;
          }
          dD = fmaf(dyv, xv, dD);
        }
      }
      __syncthreads();   // every term of the sub-chunk is in rb and rc
      // dB and dC of the sub-chunk's steps: the block's channels in order
      const int Us = min(U, T - sb * U);
      for (int o = tid; o < 2 * Us * N; o += kThreads) {
        const int which = o / (Us * N), r = o % (Us * N);
        const int u = r / N, j = r % N;
        const float* src = which ? &s.rc[u][j][0] : &s.rb[u][j][0];
        float acc = 0.0f;
        for (int cc = 0; cc < CH; ++cc) acc += src[cc];
        float* dst = which ? pC : pB;
        dst[((static_cast<long long>(blockIdx.x) * gridDim.y + b) * S + t0 +
             sb * U + u) * N + j] = acc;
      }
      __syncthreads();   // rb and rc are read before the next sub-chunk
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < NL; ++j)
      pA[(static_cast<long long>(b) * di + d) * N + j0 + j] = dA[j];
    if (gl == 0) pD[static_cast<long long>(b) * di + d] = dD;
  }
}

// dB, dC: the blocks' partials summed in block order; dA, dD: the batch
// rows' partials summed in row order
__global__ void __launch_bounds__(256)
ssm_scan_bwd_reduce(const float* __restrict__ pB, const float* __restrict__ pC,
                    const float* __restrict__ pA, const float* __restrict__ pD,
                    float* __restrict__ dB, float* __restrict__ dC,
                    float* __restrict__ dA, float* __restrict__ dD, int B,
                    int S, int di, int N, int nblk) {
  const long long nBC = static_cast<long long>(B) * S * N;
  const long long nA = static_cast<long long>(di) * N;
  const long long total = 2 * nBC + nA + di;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += gridDim.x * 256LL) {
    float acc = 0.0f;
    if (i < 2 * nBC) {
      const bool is_c = i >= nBC;
      const long long e = is_c ? i - nBC : i;
      const float* p = is_c ? pC : pB;
      for (int k = 0; k < nblk; ++k) acc += p[k * nBC + e];
      (is_c ? dC : dB)[e] = acc;
    } else if (i < 2 * nBC + nA) {
      const long long e = i - 2 * nBC;
      for (int k = 0; k < B; ++k) acc += pA[k * nA + e];
      dA[e] = acc;
    } else {
      const long long e = i - 2 * nBC - nA;
      for (int k = 0; k < B; ++k) acc += pD[k * static_cast<long long>(di) + e];
      dD[e] = acc;
    }
  }
}

template <int N>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* Bc, const float* Cc, const float* D,
                   const float* states, const float* dy,
                   const float* dh_final, float* dx, float* ddt, float* dA,
                   float* dB, float* dC, float* dD, float* scratch,
                   long long scratch_floats, int B, int S, int di,
                   cudaStream_t stream) {
  const int nblk = (di + Bwd<N>::CH - 1) / Bwd<N>::CH;
  const long long nBC = static_cast<long long>(B) * S * N;
  float* pB = scratch;
  float* pC = pB + nblk * nBC;
  float* pA = pC + nblk * nBC;
  float* pD = pA + static_cast<long long>(B) * di * N;
  if (pD + static_cast<long long>(B) * di > scratch + scratch_floats)
    return cudaErrorInvalidValue;
  constexpr size_t smem = sizeof(Smem<N>);
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssm_scan_bwd_kernel<N><<<dim3(nblk, B), kThreads, smem, stream>>>(
      x, dt, A, Bc, Cc, D, states, dy, dh_final, dx, ddt, pB, pC, pA, pD, S,
      di);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long total = 2 * nBC + static_cast<long long>(di) * N + di;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  ssm_scan_bwd_reduce<<<blocks, 256, 0, stream>>>(pB, pC, pA, pD, dB, dC, dA,
                                                  dD, B, S, di, N, nblk);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the first launch that
// failed (0 = success). All float32 and contiguous: x, dt, dy (B, S, di);
// A (di, n); Bc, Cc (B, S, n); D (di,); states (B, ceil(S / 64), di, n) as
// ssm_scan_launch wrote them; dh_final (B, di, n) or null (no gradient of
// the final state). Outputs dx, ddt (B, S, di), dA (di, n), dB, dC (B, S,
// n), dD (di,). scratch holds scratch_floats floats, at least 2 ceil(di /
// 32) B S n + B di n + B di. n must be 4, 8, 16 or 32.
extern "C" int ssm_scan_bwd_launch(
    const float* x, const float* dt, const float* A, const float* Bc,
    const float* Cc, const float* D, const float* states, const float* dy,
    const float* dh_final, float* dx, float* ddt, float* dA, float* dB,
    float* dC, float* dD, float* scratch, long long scratch_floats, int B,
    int S, int di, int n, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4: return launch<4>(x, dt, A, Bc, Cc, D, states, dy, dh_final, dx, ddt, dA, dB, dC, dD, scratch, scratch_floats, B, S, di, s);
    case 8: return launch<8>(x, dt, A, Bc, Cc, D, states, dy, dh_final, dx, ddt, dA, dB, dC, dD, scratch, scratch_floats, B, S, di, s);
    case 16: return launch<16>(x, dt, A, Bc, Cc, D, states, dy, dh_final, dx, ddt, dA, dB, dC, dD, scratch, scratch_floats, B, S, di, s);
    case 32: return launch<32>(x, dt, A, Bc, Cc, D, states, dy, dh_final, dx, ddt, dA, dB, dC, dD, scratch, scratch_floats, B, S, di, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ssm_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
