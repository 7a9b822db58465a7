#!/usr/bin/env python3
"""Measure the card's instruction rates: the ceilings of the tiled matmul
(mma.sync TF32) and of the min-plus kernel (FADD and FMNMX); and the
dependency floor of the single-block helpers (the LU diagonal factor and
the Floyd-Warshall closure).

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

Then the dependency floor probe (:func:`dependency_floor`, which
chip_smoke.py also calls). It is timed as the helpers are: device kernel
durations under torch.profiler, which leave the host's gap between
launches out. It gives the least duration of an empty kernel (one warp), and
the duration of one exchange step of a chain of them inside one kernel (a
block of T threads: a shared store, a barrier, a load that feeds the next
store; one warp: a shuffle; a thread-block cluster of 8 CTAs of 256
threads: one CTA's distributed-shared-memory stores into every CTA, a
cluster barrier, a load), from the least duration at 4,096 steps less the
least at 0. A helper that takes bs dependent steps on T threads cannot run
in less than an empty kernel plus bs such steps: that is its floor.

Last, the SM clock nvidia-smi reads during the run.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

FLOOR_SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
__global__ void floor_empty() {}
// one exchange step an iteration: a shared store, a barrier, a load that
// feeds the next store (double-buffered, so one barrier a step suffices)
template <int T>
__global__ void __launch_bounds__(T) floor_barrier(float* out, int steps) {
  __shared__ float buf[2][T];
  float x = threadIdx.x;
  for (int s = 0; s < steps; ++s) {
    buf[s & 1][threadIdx.x] = x;
    __syncthreads();
    x = buf[s & 1][(threadIdx.x + 1) % T] + 1.f;
  }
  out[threadIdx.x] = x;
}
__global__ void __launch_bounds__(32) floor_shuffle(float* out, int steps) {
  float x = threadIdx.x;
  for (int s = 0; s < steps; ++s) x = __shfl_sync(0xffffffffu, x, s & 31) + 1.f;
  out[threadIdx.x] = x;
}
// one CTA's stores reach every CTA of the cluster, then a cluster barrier
template <int CL>
__global__ void __launch_bounds__(256) floor_cluster(float* out, int steps) {
  __shared__ float buf[2][256];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  float x = threadIdx.x;
  cl.sync();
  for (int s = 0; s < steps; ++s) {
    if (rank == s % CL)
      for (int c = 0; c < CL; ++c) cl.map_shared_rank(&buf[s & 1][0], c)[threadIdx.x] = x;
    cl.sync();
    x = buf[s & 1][threadIdx.x] + 1.f;
  }
  out[blockIdx.x * 256 + threadIdx.x] = x;
}
// kind 0: the empty kernel; 1: a warp's shuffles; 2, 3: barrier steps among
// 256, 512 threads; 4: cluster steps among 8 CTAs. out holds 2,048 floats.
extern "C" int floor_launch(int kind, float* out, int steps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case 0: floor_empty<<<1, 32, 0, s>>>(); break;
    case 1: floor_shuffle<<<1, 32, 0, s>>>(out, steps); break;
    case 2: floor_barrier<256><<<1, 256, 0, s>>>(out, steps); break;
    case 3: floor_barrier<512><<<1, 512, 0, s>>>(out, steps); break;
    case 4: {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(8);
      cfg.blockDim = dim3(256);
      cfg.stream = s;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 8;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      const cudaError_t e = cudaLaunchKernelEx(&cfg, floor_cluster<8>, out, steps);
      if (e != cudaSuccess) return (int)e;
      break;
    }
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""
# the probe's step kinds: the name in ``step_ns`` -> floor_launch's kind
FLOOR_STEPS = {"warp shuffle": 1, "256 threads": 2, "512 threads": 3, "cluster of 8": 4}


def _nvcc() -> str | None:
    nvcc = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                                "bin", "nvcc")
    return nvcc if os.path.isfile(nvcc) else None


def _kernel_us(launch, n: int) -> float:
    """The least device duration (us) of ``n`` launches by ``launch()``
    under torch.profiler (after one unprofiled warm-up launch): the
    yardstick chip_smoke.py times the helpers by."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            launch()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="dep_floor_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    durs = [float(e["dur"]) for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") == "kernel" and "floor_" in e.get("name", "")]
    # a profiler session on this card may drop an event now and then; the
    # least duration needs only the ones it kept
    if not durs:
        raise RuntimeError(f"mma_rate.dependency_floor: the profiler saw none of {n} launches")
    return min(durs)


def dependency_floor() -> dict:
    """Build and run the dependency floor probe on the current card:
    ``empty_kernel_us`` (the least device duration of an empty kernel) and
    ``step_ns`` (one exchange step by the helpers' thread maps, keys of
    :data:`FLOOR_STEPS`), all device durations under torch.profiler. Raises
    without nvcc or a card."""
    import ctypes

    import torch

    nvcc = _nvcc()
    if nvcc is None:
        raise RuntimeError("mma_rate.dependency_floor: nvcc not found")
    with tempfile.TemporaryDirectory(prefix="dep_floor_") as tmp:
        src, lib_path = os.path.join(tmp, "floor.cu"), os.path.join(tmp, "floor.so")
        with open(src, "w") as f:
            f.write(FLOOR_SOURCE)
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", lib_path, src],
                       check=True, timeout=300)
        lib = ctypes.CDLL(lib_path)
    lib.floor_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.floor_launch.restype = ctypes.c_int
    out = torch.empty(2048, device="cuda")

    def launcher(kind, steps):
        def launch():
            err = lib.floor_launch(kind, out.data_ptr(), steps,
                                   torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"mma_rate.dependency_floor: kind {kind} launch error {err}")
        return launch

    steps = 4096
    return {"empty_kernel_us": _kernel_us(launcher(0, 0), 200),
            "step_ns": {name: (_kernel_us(launcher(kind, steps), 5)
                               - _kernel_us(launcher(kind, 0), 20)) * 1e3 / steps
                        for name, kind in FLOOR_STEPS.items()}}


def floor_ms(probe: dict, steps: dict) -> float:
    """The floor of a helper whose dependent steps are ``steps`` (a key of
    ``probe["step_ns"]`` -> how many such exchange steps it takes): one
    empty kernel plus those steps, in ms."""
    return (probe["empty_kernel_us"] * 1e3
            + sum(n * probe["step_ns"][key] for key, n in steps.items())) / 1e6


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
    nvcc = _nvcc()
    if nvcc is None:
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
    if rc == 0:
        probe = dependency_floor()
        print(f"dependency floor probe: {json.dumps(probe)}", flush=True)
        for name, steps in (("closure and lu_factor_diag at bs 32 (one warp)",
                             {"warp shuffle": 32}),
                            ("closure at bs 64 (256 threads)", {"256 threads": 64}),
                            ("lu_factor_diag at bs 64 (512 threads)", {"512 threads": 64}),
                            ("closure at bs 256 (a cluster of 8, a cluster barrier every 8 "
                             "steps)", {"256 threads": 256 - 32, "cluster of 8": 32})):
            print(f"  floor of the {name}: {floor_ms(probe, steps) * 1e3:.2f} us", flush=True)
    print(f"SM clock read by nvidia-smi during the run: {clocks}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
