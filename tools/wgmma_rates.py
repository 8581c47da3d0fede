#!/usr/bin/env python3
"""What Hopper's ``wgmma`` reaches on this card by shape: bf16 inputs, fp32
sums, m64nNk16 with A in registers (RS) or shared memory (SS).

    python3 tools/wgmma_rates.py [--iters 4000]

Writes a CUDA program to a temporary directory, builds it with ``nvcc``
for ``sm_90a`` and runs it: one block a streaming multiprocessor, one or
two warpgroups a block, each issuing batches of ``chain`` products into
each of ``nacc`` accumulators (one commit and one wait a batch, as the
attention backward's kernels do), on zeroed operands. It prints each
configuration's bf16 TFLOP/s and its share of the 989 TFLOP/s dense peak.
With ``--random`` the operands are random bf16 values instead of zeros, as
real data are: the card then draws more power and may run at a lower
clock. It needs one CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

PEAK_BF16_TC = 989e12
# (N, A in registers, products a batch into each accumulator, accumulators,
# B MN-major): B is K-major unless the last is True (at N = 64, one
# 128-byte-swizzled slab, as the attention backward's second products read)
CONFIGS = [(64, True, 12, 1, False), (64, False, 12, 1, False),
           (64, True, 8, 3, False), (64, True, 8, 3, True),
           (64, True, 8, 2, False), (64, True, 8, 2, True),
           (128, True, 8, 1, False), (192, True, 8, 1, False),
           (256, True, 8, 1, False), (128, False, 8, 1, False),
           (256, False, 8, 1, False)]


def wgmma_fn(n: int, rs: bool, mn: bool = False) -> str:
    """A device function issuing one m64n{n}k16 product that adds to d (A
    from registers with ``rs``, else from shared memory; B MN-major with
    ``mn``, else K-major)."""
    regs = n // 2
    outs = ", ".join(f'"+f"(d[{i // 4}][{i % 4}])' for i in range(regs))
    dlist = ", ".join(f"%{i}" for i in range(regs))
    if rs:
        a = "{" + ", ".join(f"%{regs + i}" for i in range(4)) + "}"
        ins = '"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)'
        ops = f"{a}, %{regs + 4}, p, 1, 1, {int(mn)}"
        one = regs + 5
    else:
        ins = '"l"(da), "l"(db), "r"(1)'
        ops = f"%{regs}, %{regs + 1}, p, 1, 1, 0, {int(mn)}"
        one = regs + 2
    return f'''
__device__ __forceinline__ void mma_{"rs" if rs else "ss"}{"_mn" if mn else ""}_{n}(
    float (&d)[{n // 8}][4], const uint32_t (&a)[4], uint64_t da,
    uint64_t db) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{one}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{dlist}}}, {ops};\\n}}\\n"
      : {outs}
      : {ins});
}}'''


def source(iters: int, random: bool) -> str:
    fns = "".join(wgmma_fn(n, rs) for n in (64, 128, 192, 256)
                  for rs in (True, False)) + wgmma_fn(64, True, True)
    kernels, runs = [], []
    for i, (n, rs, chain, nacc, mn) in enumerate(CONFIGS):
        kind = ("rs" if rs else "ss") + ("_mn" if mn else "")
        kernels.append(f'''
__global__ void __launch_bounds__(256, 1) bench{i}(float* out, int iters) {{
  extern __shared__ __align__(1024) unsigned char smem[];
  for (int j = threadIdx.x; j < 65536 / 16; j += blockDim.x)
    reinterpret_cast<uint4*>(smem)[j] = fill(j);
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  float d[{nacc}][{n // 8}][4];
  for (int c = 0; c < {nacc}; ++c)
    for (int j = 0; j < {n // 8}; ++j)
      for (int e = 0; e < 4; ++e) d[c][j][e] = 0.0f;
  const uint4 f = fill(threadIdx.x + 7919);
  uint32_t a[4] = {{f.x, f.y, f.z, f.w}};
  const uint64_t da = desc(base), db = desc(base + 8192);
  for (int it = 0; it < iters; ++it) {{
    asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < {chain}; ++k)
#pragma unroll
      for (int c = 0; c < {nacc}; ++c)
        mma_{kind}_{n}(d[c], a, da + {"128 * (k & 3)" if mn else "2 * (k & 3)"},
                       db + {"128 * (k & 3)" if mn else "2 * (k & 3)"});
    asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
    for (int c = 0; c < {nacc}; ++c)
      for (int j = 0; j < {n // 8}; ++j)
        for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[c][j][e])::"memory");
  }}
  float s = 0.0f;
  for (int c = 0; c < {nacc}; ++c)
    for (int j = 0; j < {n // 8}; ++j)
      for (int e = 0; e < 4; ++e) s += d[c][j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}}''')
        runs.append(f"  run(bench{i}, {n}, {int(rs)}, {chain}, {nacc}, "
                    f"{int(mn)});")
    fill = ("""
  // bf16 values in [2^-7, 2^-6) of either sign, from a hash of j
  uint32_t w[4];
  for (int i = 0; i < 4; ++i) {
    uint32_t h = (j * 4 + i) * 2654435761u;
    h ^= h >> 15;
    h *= 2246822519u;
    w[i] = (h & 0x807f807fu) | 0x3c003c00u;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);""" if random else """
  return make_uint4(0, 0, 0, 0);""")
    return f'''#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ uint4 fill(uint32_t j) {{{fill}
}}
__device__ __forceinline__ uint64_t desc(uint32_t addr) {{
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}}
{fns}
{"".join(kernels)}
float* out;
int sms;
template <typename K>
void run(K kernel, int n, int rs, int chain, int nacc, int mn) {{
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       65536);
  for (int wgs = 1; wgs <= 2; ++wgs) {{
    kernel<<<sms, 128 * wgs, 65536>>>(out, 10);
    cudaEvent_t t0, t1;
    cudaEventCreate(&t0);
    cudaEventCreate(&t1);
    cudaEventRecord(t0);
    kernel<<<sms, 128 * wgs, 65536>>>(out, {iters});
    cudaEventRecord(t1);
    cudaEventSynchronize(t1);
    float ms;
    cudaEventElapsedTime(&ms, t0, t1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {{
      printf("error %s\\n", cudaGetErrorString(err));
      return;
    }}
    const double flops = 2.0 * 64 * n * 16 * chain * nacc * (double){iters} *
                         sms * wgs;
    printf("m64n%dk16 %s, B %s-major, %d products a batch into each of "
           "%d accumulators, %d warpgroup(s) a block: %.1f TFLOP/s, %.1f %% "
           "of the bf16 peak\\n", n, rs ? "RS" : "SS", mn ? "MN" : "K",
           chain, nacc, wgs,
           flops / ms / 1e9, 100.0 * flops / ms / 1e9 / {PEAK_BF16_TC / 1e12});
  }}
}}
int main() {{
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaMalloc(&out, sms * 256 * sizeof(float));
{chr(10).join(runs)}
  return 0;
}}
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=4000)
    ap.add_argument("--random", action="store_true",
                    help="random bf16 operands instead of zeros")
    args = ap.parse_args()
    nvcc = next((str(Path(h) / "bin" / "nvcc")
                 for h in (os.environ.get("CUDA_HOME"), "/usr/local/cuda")
                 if h and (Path(h) / "bin" / "nvcc").is_file()),
                shutil.which("nvcc"))
    if nvcc is None:
        raise SystemExit("nvcc not found")
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = Path(tmp) / "wgmma_rates.cu", Path(tmp) / "wgmma_rates"
        src.write_text(source(args.iters, args.random))
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-O3", "-std=c++17", "-o", str(exe), str(src)],
                       check=True)
        return subprocess.run([str(exe)]).returncode


if __name__ == "__main__":
    sys.exit(main())
