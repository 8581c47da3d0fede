// What the selective-scan forward (ssm_scan.cu) and backward
// (ssm_scan_bwd.cu) kernels share: the split of a channel's states over
// lanes, the interval of the saved states, the cp.async staging helpers and
// the step's arithmetic, so that the backward's recomputed states are the
// forward's bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssm {

constexpr int kGroup = 2;           // lanes per channel (power of 2)
constexpr int kThreads = 64;        // threads per block
constexpr int kStateEvery = 64;     // steps between saved states
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
struct Split {
  static constexpr int G = kGroup;                    // lanes of a channel
  static constexpr int NL = N / G;                    // states per lane
  static constexpr int CH = kThreads / G;             // channels per block
};

// 2^x, so exp(dt * A) for x = dt * A * log2(e)
__device__ __forceinline__ float exp_of(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, asynchronously; in = false writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// h <- e h + (dt x) b, one rounding for the sum (an explicit FMA, so the
// forward and the backward's recomputation round alike)
__device__ __forceinline__ float scan_step(float e, float h, float dtx,
                                           float b) {
  return fmaf(e, h, dtx * b);
}

}  // namespace ssm
