#!/usr/bin/env python3
"""Measure the card's mma.sync rates: the ceiling of a kernel built on them.

    python3 mma_rate.py

Builds a small CUDA program with nvcc (sm_90a) into a temporary directory
and runs it: each warp of 132 (and 264) blocks of 1 to 16 warps issues
eight independent mma.sync.aligned.m16n8k8 TF32 products in a loop, and one
warp a dependent chain of them. Prints the card's name and power limit,
then TFLOP/s, mma per clock and SM, and the chain's cycles per mma. The
tiled matmul's f32 path runs three such products per f32 product (3xTF32,
src/repro_torch/kernels/csrc/gemm_tf32.cuh), so its ceiling is a third of
the TF32 rate measured here.
"""

import os
import shutil
import subprocess
import sys
import tempfile

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
template <int NI>
__global__ void bench(float* out, int iters, uint32_t seed) {
  float c[NI][4] = {};
  uint32_t a[4] = {seed, seed + 1, seed + 2, seed + 3}, b[2] = {seed ^ 5u, seed ^ 7u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < NI; ++i)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int i = 0; i < NI; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  float* out;
  cudaMalloc(&out, 1 << 24);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  int khz, sms;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int iters = 4096;
  for (int blocks : {sms, 2 * sms})
    for (int warps : {1, 2, 4, 8, 16}) {
      bench<8><<<blocks, 32 * warps>>>(out, 16, 1);
      cudaEventRecord(e0);
      bench<8><<<blocks, 32 * warps>>>(out, iters, 1);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms;
      cudaEventElapsedTime(&ms, e0, e1);
      const double mma = (double)blocks * warps * iters * 8;
      printf("TF32 mma.sync.m16n8k8, %d blocks x %d warps, 8 independent a warp: %.1f TFLOP/s, "
             "%.3f mma per clock and SM at %d MHz\n", blocks, warps,
             mma * 2 * 16 * 8 * 8 / (ms * 1e9), mma / (ms * 1e-3 * khz * 1e3) / sms, khz / 1000);
    }
  bench<1><<<1, 32>>>(out, 16, 1);
  cudaEventRecord(e0);
  bench<1><<<1, 32>>>(out, 65536, 1);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  printf("one warp, one dependent chain: %.1f cycles per mma\n", ms * 1e-3 * khz * 1e3 / 65536);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""


def main() -> int:
    nvcc = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                                "bin", "nvcc")
    if not os.path.isfile(nvcc):
        print("mma_rate: nvcc not found; this script needs the CUDA toolkit and a card",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory(prefix="mma_rate_") as tmp:
        src, exe = os.path.join(tmp, "mma_rate.cu"), os.path.join(tmp, "mma_rate")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o", exe, src],
                       check=True, timeout=300)
        return subprocess.run([exe], timeout=300).returncode


if __name__ == "__main__":
    sys.exit(main())
