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
//   ddt_t = sum_j A_j (g_j a_j h_{t-1, j}) + x_t sum_j g_j B_j
//   dA_j += dt_t (g_j a_j h_{t-1, j})    (sum over b and t)
//   dB_j += g_j dt_t x_t                 (sum over the channels)
//   dC_j += dy_t h_{t, j}                (sum over the channels)
//   dD   += dy_t x_t                     (sum over b and t)
//
// What bounds it: the bytes at hymba's shape (x, dt, dy read and dx, ddt
// written, 20 bytes a (batch, step, channel): 0.091 ms), with ~20 fp32
// operations and at least one exponential a state. Each channel's steps are
// one dependent chain, run backward, so the card fills only with many
// chains in flight. The first port walked each (batch, 32 channels) block
// through all S steps: 400 blocks of 2 warps at 83 KB of shared memory
// each, 4 warps an SM (PERF.md).
//
// The design splits the sequence at the saved states. The adjoint is linear
// in the gradient it carries: the carry out of chunk k (a_{t0} g_{t0}, t0
// its first step) is L_k + P_k * r_k, where r_k is the carry into the chunk
// from the right (dh_final for the last), L_k the chunk's adjoint walk
// started from zero and P_k the product of its a_t. One launch runs four
// kernels on the stream:
//   1. ssm_scan_bwd_chunk_adjoint, per (32 channels, chunk k >= 1, b):
//      L_k and P_k (it needs dt, A, C and dy, not the states), 2 lanes a
//      channel as the forward;
//   2. ssm_scan_bwd_carries, per (b, d, j): r_k for every chunk, from
//      dh_final in chunk order, r_{k-1} = fma(P_k, r_k, L_k);
//   3. ssm_scan_bwd_grads, per (32 channels, chunk, b): the first port's
//      body from r_k for one chunk, 4 lanes a channel. It recomputes the
//      chunk's states from the saved one with the forward's arithmetic
//      (ssm_scan.cuh: the same ex2 and FMA, so the states are the forward's
//      bit for bit; h_{t-1} is never recovered by dividing by a_t, which
//      underflows for the strongly decaying channels): once to keep the
//      state entering each U-step sub-chunk, once per sub-chunk into
//      registers, which the walk then reads in reverse. It writes dx and
//      ddt, a dA/dD partial per (b, chunk) and a dB/dC partial per (channel
//      block, b, t);
//   4. ssm_scan_bwd_reduce: dB and dC summed over the channel blocks, dA
//      and dD over (b, chunk), each in order.
// At hymba's shape (B 4, S 1,128, di 3,200, n 16) that is 18 chunks and
// 7,200 blocks in stages 1 and 3, in place of 400. The sums over channels
// of dB and dC run in registers with warp shuffles (warp_channel_sum: a
// fixed tree over a warp's 8 channels), then over the block's 4 warps in
// order; the first port's 33 KB of per-step terms and its serial 32-term
// sums are gone. Stage 3's block (128 threads) holds 56 KB of shared memory
// (x, dt and dy of the chunk, B and C rows, the sub-chunk states, a double
// buffer of the warps' sums), and its threads are held to 128 registers
// (-Xptxas -v: 168 unbounded, 4 bytes spilled at 128), so 4 blocks, 16
// warps, sit on an SM; a full sub-chunk runs without a branch. Neither 2
// lanes a channel (64 threads, 236 registers: 8 warps an SM), nor 3 blocks
// an SM, nor 4-step sub-chunks (fewer registers, twice the sub-chunk
// states in shared memory) was faster. By the code's count it issues ~28
// instructions a state and step, 2 of them exponentials and ~6
// shared-memory loads and shuffles (PERF.md). Neither the results nor the order
// of any sum depends on the order blocks run in; there are no atomics. No
// --use_fast_math.

#include <type_traits>

#include "ssm_scan.cuh"

namespace {

using namespace ssm;

constexpr int kT = kStateEvery;     // steps of a chunk
// stage 3's split: a channel's n states over kG3 = 4 lanes (stages 1 and the
// forward: ssm_scan.cuh's 2), 32 channels in a block of 4 warps
constexpr int kLogG3 = 2, kG3 = 1 << kLogG3;
constexpr int kThreads3 = 128, kWarps3 = kThreads3 / 32;
constexpr int kBlocks3 = 4;   // blocks an SM: registers capped at 128

template <int N>
struct Grad {
  static constexpr int G = kG3, NL = N / kG3, CH = kThreads3 / kG3;
  // steps a sub-chunk: (U + 1) states and U factors of NL each in registers
  static constexpr int U = 8;
  static constexpr int NSUB = kT / U;
  // a lane's channel bits (lane = G c + lane of the group), and how many of
  // them halve what it carries in warp_channel_sum: log2(NL), at most all
  static constexpr int CB = 5 - kLogG3;
  static constexpr int LOG_NL = NL >= 8 ? 3 : NL >= 4 ? 2 : NL >= 2 ? 1 : 0;
  static constexpr int H = LOG_NL < CB ? LOG_NL : CB;
};
static_assert(Split<4>::CH == Grad<4>::CH, "stages 1 and 3 split di alike");

// The stage-3 block's shared memory
template <int N>
struct Smem {
  static constexpr int CH = Grad<N>::CH, NL = Grad<N>::NL, U = Grad<N>::U;
  float x[kT][CH];
  float dt[kT][CH];
  float dy[kT][CH];
  float b[kT][N];
  float c[kT][N];
  float hb[Grad<N>::NSUB][kThreads3][NL];  // state entering each sub-chunk
  float red[2][2][kWarps3][U][N];  // [sub-chunk parity][dB, dC][warp][u][j]
};

// The sum of v over the warp's 8 channels (lane = 4 c + lane of the group),
// a fixed tree: lane bit 4 first (channels c and c ^ 4), then bits 3, 2.
// The first H steps halve what a lane carries: of its NL states it keeps
// the half its side of the pair owns and sends the other half. Returns the
// lane's one sum, that of its state j0 + state_of(lane).
template <int NL, int H>
__device__ __forceinline__ float warp_channel_sum(float (&v)[NL], int lane) {
#pragma unroll
  for (int s = 0; s < H; ++s) {
    const int bit = 4 - s;
    const int half = NL >> (s + 1);
    const bool up = (lane >> bit) & 1;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 1 << bit);
    }
  }
  float r = v[0];
#pragma unroll
  for (int bit = 4 - H; bit >= kLogG3; --bit)
    r += __shfl_xor_sync(0xffffffffu, r, 1 << bit);
  return r;
}
// The state (of the lane's NL) whose sum warp_channel_sum leaves in a lane
template <int NL, int H>
__device__ __forceinline__ int state_of(int lane) {
  int j = 0;
#pragma unroll
  for (int s = 0; s < H; ++s) j += ((lane >> (4 - s)) & 1) * (NL >> (s + 1));
  return j;
}

// ---------------------------------------------------------------------------
// 1. L_k, P_k of chunks k >= 1
// ---------------------------------------------------------------------------

template <int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_chunk_adjoint(const float* __restrict__ dt,   // (B, S, di)
                           const float* __restrict__ A,    // (di, N)
                           const float* __restrict__ Cc,   // (B, S, N)
                           const float* __restrict__ dy,   // (B, S, di)
                           float* __restrict__ L,          // (B, K, di, N)
                           float* __restrict__ P,          // (B, K, di, N)
                           int S, int di) {
  constexpr int G = Split<N>::G, NL = Split<N>::NL, CH = Split<N>::CH;
  __shared__ float dts[kT][CH], dys[kT][CH];
  __shared__ __align__(16) float cs[kT][N];
  const int tid = threadIdx.x;
  const int c = tid / G, j0 = (tid % G) * NL;
  const int k = blockIdx.y + 1, K = gridDim.y + 1, b = blockIdx.z;
  const int d0 = blockIdx.x * CH, d = d0 + c;
  const bool active = d < di;
  const int t0 = k * kT, T = min(kT, S - t0);
  const long long row0 = static_cast<long long>(b) * S + t0;
  for (int e = tid; e < T * CH; e += kThreads) {
    const int t = e / CH, cc = e % CH;
    const bool in = d0 + cc < di;
    const long long off = in ? (row0 + t) * di + d0 + cc : 0;
    cp_async4(&dts[t][cc], dt + off, in);
    cp_async4(&dys[t][cc], dy + off, in);
  }
  for (int e = tid; e < T * N; e += kThreads)
    cp_async4(&cs[0][0] + e, Cc + row0 * N + e, true);
  cp_async_commit();

  float a2[NL], g[NL], p[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    a2[j] = active ? A[static_cast<long long>(d) * N + j0 + j] * kLog2e : 0.0f;
    g[j] = 0.0f;
    p[j] = 1.0f;
  }
  cp_async_wait<0>();
  __syncthreads();
  auto step = [&](int t) {
    const float dtv = dts[t][c], dyv = dys[t][c];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const float e = exp_of(dtv * a2[j]);
      g[j] = fmaf(cs[t][j0 + j], dyv, g[j]) * e;
      p[j] *= e;
    }
  };
  int t = T - 1;
  for (; t >= 7; t -= 8) {   // 8 steps without a branch
#pragma unroll
    for (int u = 0; u < 8; ++u) step(t - u);
  }
  for (; t >= 0; --t) step(t);
  if (active) {
    const long long off = ((static_cast<long long>(b) * K + k) * di + d) * N
                          + j0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      L[off + j] = g[j];
      P[off + j] = p[j];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the carry into every chunk
// ---------------------------------------------------------------------------

// LR holds L_k on entry and r_k on exit (r_{K-1} = dh_final, or 0)
__global__ void __launch_bounds__(256)
ssm_scan_bwd_carries(const float* __restrict__ dh_final,   // (B, di, N) or null
                     float* __restrict__ LR,               // (B, K, di, N)
                     const float* __restrict__ P,          // (B, K, di, N)
                     int B, int K, long long per_b) {      // per_b = di * N
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= B * per_b) return;
  const long long b = i / per_b, e = i % per_b;
  float r = dh_final != nullptr ? dh_final[i] : 0.0f;
  for (int k = K - 1; k >= 1; --k) {
    const long long off = (b * K + k) * per_b + e;
    const float l = LR[off], p = P[off];
    LR[off] = r;
    r = fmaf(p, r, l);
  }
  LR[b * K * per_b + e] = r;
}

// ---------------------------------------------------------------------------
// 3. the gradients of one chunk from its carry
// ---------------------------------------------------------------------------

template <int N>
__global__ void __launch_bounds__(kThreads3, kBlocks3)
ssm_scan_bwd_grads(const float* __restrict__ x,        // (B, S, di)
                   const float* __restrict__ dt,       // (B, S, di)
                   const float* __restrict__ A,        // (di, N)
                   const float* __restrict__ Bc,       // (B, S, N)
                   const float* __restrict__ Cc,       // (B, S, N)
                   const float* __restrict__ D,        // (di,)
                   const float* __restrict__ states,   // (B, K, di, N)
                   const float* __restrict__ dy,       // (B, S, di)
                   const float* __restrict__ R,        // (B, K, di, N): r_k
                   float* __restrict__ dx,             // (B, S, di)
                   float* __restrict__ ddt,            // (B, S, di)
                   float* __restrict__ pB,             // (nblk, B, S, N)
                   float* __restrict__ pC,             // (nblk, B, S, N)
                   float* __restrict__ pA,             // (B, K, di, N)
                   float* __restrict__ pD,             // (B, K, di)
                   int S, int di) {
  using W = Grad<N>;
  constexpr int G = W::G, NL = W::NL, CH = W::CH, U = W::U, H = W::H;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<N>& s = *reinterpret_cast<Smem<N>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid / G;                       // channel within the block
  const int gl = tid % G;                      // lane within the group
  const int j0 = gl * NL;                      // the lane's first state
  const int k = blockIdx.y, K = gridDim.y, b = blockIdx.z;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const bool active = d < di;
  const int t0 = k * kT, T = min(kT, S - t0);
  const long long row0 = static_cast<long long>(b) * S + t0;  // row (b, t0)
  const long long kd = (static_cast<long long>(b) * K + k) * di + d;

  for (int e = tid; e < T * CH; e += kThreads3) {
    const int t = e / CH, cc = e % CH;
    const bool in = d0 + cc < di;
    const long long off = in ? (row0 + t) * di + d0 + cc : 0;
    cp_async4(&s.x[t][cc], x + off, in);
    cp_async4(&s.dt[t][cc], dt + off, in);
    cp_async4(&s.dy[t][cc], dy + off, in);
  }
  for (int e = tid; e < T * N; e += kThreads3) {
    cp_async4(&s.b[0][0] + e, Bc + row0 * N + e, true);
    cp_async4(&s.c[0][0] + e, Cc + row0 * N + e, true);
  }
  cp_async_commit();
  float a2[NL], an[NL], g[NL], dA[NL], h[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    an[j] = active ? A[static_cast<long long>(d) * N + j0 + j] : 0.0f;
    a2[j] = an[j] * kLog2e;                    // as the forward takes it
    g[j] = active ? R[kd * N + j0 + j] : 0.0f;
    h[j] = active ? states[kd * N + j0 + j] : 0.0f;
    dA[j] = 0.0f;
  }
  const float d_coef = active ? D[d] : 0.0f;
  float dD = 0.0f;
  cp_async_wait<0>();
  __syncthreads();

  // the state entering each sub-chunk (each thread reads back only its own,
  // so this needs no barrier). A whole sub-chunk's U steps run without a
  // branch (the kFull instance of each lambda), so that they schedule
  // together; only a short last one tests each step.
  const int nsub = (T + U - 1) / U;
  for (int sb = 0; sb < nsub; ++sb) {
#pragma unroll
    for (int j = 0; j < NL; ++j) s.hb[sb][tid][j] = h[j];
    auto states_of = [&](auto full) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = sb * U + u;
        if (decltype(full)::value || t < T) {
          const float dtv = s.dt[t][c], dtx = dtv * s.x[t][c];
#pragma unroll
          for (int j = 0; j < NL; ++j)
            h[j] = scan_step(exp_of(dtv * a2[j]), h[j], dtx, s.b[t][j0 + j]);
        }
      }
    };
    if (sb * U + U <= T)
      states_of(std::true_type{});
    else
      states_of(std::false_type{});
  }

  const int my_j = j0 + state_of<NL, H>(lane);
  const bool writer = ((lane >> kLogG3) & ((1 << (W::CB - H)) - 1)) == 0;
  for (int sb = nsub - 1; sb >= 0; --sb) {
    const int Us = min(U, T - sb * U);
    float (&red)[2][kWarps3][U][N] = s.red[sb & 1];
    auto walk = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
      // hs[u] = h_{t-1} and hs[u + 1] = h_t of step t = sb U + u; ea[u] = a_t
      float hs[U + 1][NL], ea[U][NL];
#pragma unroll
      for (int j = 0; j < NL; ++j) hs[0][j] = s.hb[sb][tid][j];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = sb * U + u;
        if (kFull || u < Us) {
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
        if (kFull || u < Us) {  // the same for every thread: shuffles are safe
          const float dyv = s.dy[t][c], xv = s.x[t][c], dtv = s.dt[t][c];
          const float dtx = dtv * xv;
          float px = 0.0f, pq = 0.0f, tb[NL], tc[NL];
#pragma unroll
          for (int j = 0; j < NL; ++j) {
            const float bj = s.b[t][j0 + j], cj = s.c[t][j0 + j];
            g[j] = fmaf(cj, dyv, g[j]);                    // g_t
            const float q = g[j] * (ea[u][j] * hs[u][j]);  // g_t a_t h_{t-1}
            pq = fmaf(an[j], q, pq);
            dA[j] = fmaf(dtv, q, dA[j]);
            px = fmaf(g[j], bj, px);
            tb[j] = g[j] * dtx;
            tc[j] = dyv * hs[u + 1][j];
            g[j] *= ea[u][j];                              // a_t g_t, for t - 1
          }
#pragma unroll
          for (int m = 1; m < G; m <<= 1) {
            px += __shfl_xor_sync(0xffffffffu, px, m);
            pq += __shfl_xor_sync(0xffffffffu, pq, m);
          }
          if (gl == 0 && active) {
            const long long off = (row0 + t) * di + d;
            dx[off] = fmaf(d_coef, dyv, dtv * px);
            ddt[off] = fmaf(xv, px, pq);
          }
          dD = fmaf(dyv, xv, dD);
          const float sbv = warp_channel_sum<NL, H>(tb, lane);
          const float scv = warp_channel_sum<NL, H>(tc, lane);
          if (writer) {
            red[0][warp][u][my_j] = sbv;
            red[1][warp][u][my_j] = scv;
          }
        }
      }
    };
    if (Us == U)
      walk(std::true_type{});
    else
      walk(std::false_type{});
    // every warp's sums of the sub-chunk are in red (the next sub-chunk
    // writes the other buffer; the one after it comes after the next
    // barrier, when these reads are done)
    __syncthreads();
    for (int o = tid; o < 2 * Us * N; o += kThreads3) {
      const int which = o / (Us * N), r = o % (Us * N);
      const int u = r / N, j = r % N;
      float acc = red[which][0][u][j];
#pragma unroll
      for (int w = 1; w < kWarps3; ++w) acc += red[which][w][u][j];
      float* dst = which ? pC : pB;
      dst[((static_cast<long long>(blockIdx.x) * gridDim.z + b) * S + t0 +
           sb * U + u) * N + j] = acc;
    }
  }
  if (active) {
#pragma unroll
    for (int j = 0; j < NL; ++j) pA[kd * N + j0 + j] = dA[j];
    if (gl == 0) pD[kd] = dD;
  }
}

// ---------------------------------------------------------------------------
// 4. dB, dC: the channel blocks' partials summed in block order; dA, dD:
//    the (b, chunk) partials summed in that order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
ssm_scan_bwd_reduce(const float* __restrict__ pB, const float* __restrict__ pC,
                    const float* __restrict__ pA, const float* __restrict__ pD,
                    float* __restrict__ dB, float* __restrict__ dC,
                    float* __restrict__ dA, float* __restrict__ dD, int B,
                    int S, int di, int N, int nblk, int K) {
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
#pragma unroll 8
      for (int k = 0; k < nblk; ++k) acc += p[k * nBC + e];
      (is_c ? dC : dB)[e] = acc;
    } else if (i < 2 * nBC + nA) {
      const long long e = i - 2 * nBC;
      for (int k = 0; k < B * K; ++k) acc += pA[k * nA + e];
      dA[e] = acc;
    } else {
      const long long e = i - 2 * nBC - nA;
      for (int k = 0; k < B * K; ++k)
        acc += pD[k * static_cast<long long>(di) + e];
      dD[e] = acc;
    }
  }
}

// the scratch, in floats: LR (L_k, then r_k) and P (P_k, then the dA
// partials), each (B, K, di, N); pB and pC, each (nblk, B, S, N); pD
// (B, K, di)
struct Scratch {
  long long nK, nBC, nD;
  long long floats() const { return 2 * nK + 2 * nBC + nD; }
};

template <int N>
Scratch scratch_of(int B, int S, int di) {
  const long long K = (S + kT - 1) / kT;
  const long long nblk = (di + Grad<N>::CH - 1) / Grad<N>::CH;
  return Scratch{B * K * di * N, nblk * B * S * N, B * K * di};
}

template <int N>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* Bc, const float* Cc, const float* D,
                   const float* states, const float* dy,
                   const float* dh_final, float* dx, float* ddt, float* dA,
                   float* dB, float* dC, float* dD, float* scratch,
                   long long scratch_floats, int B, int S, int di,
                   cudaStream_t stream) {
  const int K = (S + kT - 1) / kT;
  const int nblk = (di + Grad<N>::CH - 1) / Grad<N>::CH;
  const Scratch sc = scratch_of<N>(B, S, di);
  if (sc.floats() > scratch_floats) return cudaErrorInvalidValue;
  float* lr = scratch;
  float* p = lr + sc.nK;
  float* pB = p + sc.nK;
  float* pC = pB + sc.nBC;
  float* pD = pC + sc.nBC;
  cudaError_t err;
  if (K > 1) {
    ssm_scan_bwd_chunk_adjoint<N><<<dim3(nblk, K - 1, B), kThreads, 0,
                                    stream>>>(dt, A, Cc, dy, lr, p, S, di);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long n = static_cast<long long>(B) * di * N;
  ssm_scan_bwd_carries<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                         stream>>>(dh_final, lr, p, B, K,
                                   static_cast<long long>(di) * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr size_t smem = sizeof(Smem<N>);
  err = cudaFuncSetAttribute(ssm_scan_bwd_grads<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssm_scan_bwd_grads<N><<<dim3(nblk, K, B), kThreads3, smem, stream>>>(
      x, dt, A, Bc, Cc, D, states, dy, lr, dx, ddt, pB, pC, p, pD, S, di);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long total = 2LL * B * S * N + static_cast<long long>(di) * N
                          + di;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  ssm_scan_bwd_reduce<<<blocks, 256, 0, stream>>>(pB, pC, p, pD, dB, dC, dA,
                                                  dD, B, S, di, N, nblk, K);
  return cudaGetLastError();
}

}  // namespace

// The floats of scratch a launch at this shape needs (0: n not taken).
extern "C" long long ssm_scan_bwd_scratch_floats(int B, int S, int di, int n) {
  if (B <= 0 || S <= 0 || di <= 0) return 0;
  switch (n) {
    case 4: return scratch_of<4>(B, S, di).floats();
    case 8: return scratch_of<8>(B, S, di).floats();
    case 16: return scratch_of<16>(B, S, di).floats();
    case 32: return scratch_of<32>(B, S, di).floats();
    default: return 0;
  }
}

// Launch on `stream`; returns the cudaError_t of the first launch that
// failed (0 = success). All float32 and contiguous: x, dt, dy (B, S, di);
// A (di, n); Bc, Cc (B, S, n); D (di,); states (B, ceil(S / 64), di, n) as
// ssm_scan_launch wrote them; dh_final (B, di, n) or null (no gradient of
// the final state). Outputs dx, ddt (B, S, di), dA (di, n), dB, dC (B, S,
// n), dD (di,). scratch holds scratch_floats floats, at least
// ssm_scan_bwd_scratch_floats(B, S, di, n). n must be 4, 8, 16 or 32.
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
