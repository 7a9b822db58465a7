#!/usr/bin/env python3
"""Measure the card's instruction rates: the ceilings of the tiled matmul
(mma.sync TF32) and of the min-plus kernel (FADD and FMNMX).

    python3 mma_rate.py

Builds a small CUDA program with nvcc (sm_90a) into a temporary directory
and runs it. Prints the card's name and power limit, then:

  * mma.sync: each warp of 132 (and 264) blocks of 1 to 16 warps issues
    eight independent mma.sync.aligned.m16n8k8 TF32 products in a loop, and
    one warp a dependent chain of them: TFLOP/s, mma per clock and SM, and
    the chain's cycles per mma. The tiled matmul's f32 path runs three such
    products per f32 product (3xTF32,
    src/repro_torch/kernels/csrc/gemm_tf32.cuh), so its ceiling is a third
    of the TF32 rate measured here.
  * f32 ALU: 4 blocks of 256 threads an SM, each thread updating 16
    independent f32 accumulators in a loop, in four forms: the relaxation
    acc = min(acc, x + d) (an FADD and an FMNMX), FMNMX alone, FADD alone
    and FFMA alone (the reference: the data sheet's 67 TFLOP/s is 128 FFMA
    per clock and SM at 1,980 MHz): results per second and per clock and SM
    at the card's maximum SM clock (cudaDevAttrClockRate). A relaxation of
    the min-plus kernel (src/repro_torch/kernels/csrc/floyd_warshall.cu) is
    one FADD and one FMNMX, so its ceiling is the smaller of the FMNMX rate
    and half the issue rate.

Last, the SM clock nvidia-smi reads during the run.
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
__global__ void mma_bench(float* out, int iters, uint32_t seed) {
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
// MODE 0: acc_i = min(acc_i, acc_j + d); 1: acc_i = min(acc_i, acc_j);
// 2: acc_i = acc_j + d; 3: acc_i = fma(acc_j, e, d); j = (i + 5) mod 16, so
// each update reads another accumulator and nothing is loop-invariant
template <int MODE>
__global__ void alu_bench(float* out, int iters, float d, float e) {
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = threadIdx.x * 0.5f + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float x = acc[(i + 5) & 15];
      if (MODE == 0) acc[i] = fminf(acc[i], x + d);
      if (MODE == 1) acc[i] = fminf(acc[i], x);
      if (MODE == 2) acc[i] = x + d;
      if (MODE == 3) acc[i] = fmaf(x, e, d);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int MODE>
float alu_run(float* out, int blocks, int iters) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  alu_bench<MODE><<<blocks, 256>>>(out, 64, 1e-7f, 0.999f);
  cudaEventRecord(e0);
  alu_bench<MODE><<<blocks, 256>>>(out, iters, 1e-7f, 0.999f);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
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
      mma_bench<8><<<blocks, 32 * warps>>>(out, 16, 1);
      cudaEventRecord(e0);
      mma_bench<8><<<blocks, 32 * warps>>>(out, iters, 1);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms;
      cudaEventElapsedTime(&ms, e0, e1);
      const double mma = (double)blocks * warps * iters * 8;
      printf("TF32 mma.sync.m16n8k8, %d blocks x %d warps, 8 independent a warp: %.1f TFLOP/s, "
             "%.3f mma per clock and SM at %d MHz\n", blocks, warps,
             mma * 2 * 16 * 8 * 8 / (ms * 1e9), mma / (ms * 1e-3 * khz * 1e3) / sms, khz / 1000);
    }
  mma_bench<1><<<1, 32>>>(out, 16, 1);
  cudaEventRecord(e0);
  mma_bench<1><<<1, 32>>>(out, 65536, 1);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  printf("one warp, one dependent chain: %.1f cycles per mma\n", ms * 1e-3 * khz * 1e3 / 65536);
  {
    const int iters = 1 << 16, blocks = 4 * sms;
    const char* names[4] = {"relaxation min(acc, x + d) (FADD + FMNMX)", "FMNMX alone",
                            "FADD alone", "FFMA alone"};
    for (int rep = 0; rep < 2; ++rep)
      for (int mode = 0; mode < 4; ++mode) {
        float ms = mode == 0   ? alu_run<0>(out, blocks, iters)
                   : mode == 1 ? alu_run<1>(out, blocks, iters)
                   : mode == 2 ? alu_run<2>(out, blocks, iters)
                               : alu_run<3>(out, blocks, iters);
        const double ops = 16.0 * iters * blocks * 256;
        const double rate = ops / (ms * 1e-3);
        printf("%s: %.3f T results/s, %.1f per clock and SM at %d MHz (%.3f ms)\n", names[mode],
               rate / 1e12, rate / (khz * 1e3) / sms, khz / 1000, ms);
      }
  }
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) { printf("CUDA error %s\n", cudaGetErrorString(err)); return 1; }
  return 0;
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
        proc = subprocess.Popen([exe])
        clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                                capture_output=True, text=True, timeout=60).stdout.strip()
        rc = proc.wait(timeout=600)
    print(f"SM clock read by nvidia-smi during the run: {clocks}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
