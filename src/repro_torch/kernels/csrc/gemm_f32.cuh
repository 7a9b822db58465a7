// The main loop shared by syr2k.cu, matmul.cu and covariance.cu: f32 FFMA
// products on the CUDA cores of an H100, fed by a ring of shared-memory
// stages that cp.async fills while the previous chunk's multiply-adds run.
// decode_attention.cu streams its cache through the same ring and copies.
//
// What bounds these products: at the paper's LARGE sizes they are
// compute-bound on the CUDA cores (f32 FFMA, 67 TFLOP/s), not on HBM; the
// f32 tolerances rule out TF32 tensor cores (see syr2k.cu). A skinny product
// (the model's decode unembed, 4 x 896 @ 896 x 151,936) is bound by the bytes
// of its B operand instead. So the loop has to keep the FFMA pipes busy with
// few other instructions, and keep enough copies in flight that HBM never
// waits on the block.
//
// What the design does about it:
//   * Staging is coalesced and asynchronous. Tiles keep their global
//     orientation in shared memory (k-contiguous rows of a row-major operand,
//     n-contiguous rows of matmul's B); consecutive threads copy consecutive
//     16-byte pieces of a row with cp.async (copy_box). Where a base, a row
//     stride or a chunk step is not 16-byte aligned (ragged shapes), the
//     launcher picks the element form instead: 4-byte cp.async for f32, a
//     plain load and store for bf16. Either form zero-fills past the valid
//     box, so the inner loop runs over whole float4s.
//   * A ring of up to MAX_STAGES = 3 chunks (run_ring): chunks c+1 and c+2
//     are copied while chunk c is multiplied, with one cp.async.wait_group
//     and one barrier per chunk (covariance.cu runs up to six small stages). The depth is the deepest that fits the
//     device's shared memory per block, read at run time (ring_stages); a
//     tile that fits only one stage runs unpipelined rather than being
//     refused. Each thread's share of a chunk's copies is planned once per
//     kernel (plan_box), not divided out per piece.
//   * Rows of k-contiguous chunks are padded to an odd number of 16-byte
//     words (kpitch), so the float4 reads of 8 consecutive rows hit 8
//     different bank quads: the inner loop reads without bank conflicts.
//   * A thread map sized to the tile: extents are padded to multiples of 8
//     (not 64), and each thread owns an RT x RT register tile, RT = 8 when an
//     extent passes 64 and 4 otherwise (reg_tile), so a (pm/RT) x (pn/RT)
//     block of at most 256 threads covers the padded tile (matmul gives an
//     8-row tile 1 x 4 a thread instead). A 4-row tile costs 8 rows of work,
//     not 64.
//   * FFMA per shared-memory load: matmul reads RT float4 of A (four k of a
//     row each) and RT float4 of B (four columns of one k, for four k) per
//     four k, against 4*RT*RT FFMA: 8 FFMA per LDS.128 at RT = 4 (the 64x64
//     default), 16 at RT = 8 (128x128). syr2k reads four chunks for two
//     FFMA per accumulator and k: the same 8 and 16.
//
// Every output element is summed with k ascending, one fmaf per term, and no
// split of k across blocks, so its bits do not depend on the tile or the ring.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm {

constexpr int ALIGN = 8;         // tile extents are padded to multiples of 8
constexpr int MAX_TILE = 128;    // largest tile extent (16 threads x RT = 8)
constexpr int MAX_THREADS = 256; // (128 / 8)^2
constexpr int MAX_STAGES = 3;
constexpr int MAX_DEEP_STAGES = 6;  // run_ring's deepest ring (covariance.cu's small stages)

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Register tile edge per thread for padded extents pm x pn.
__host__ __device__ inline int reg_tile(int pm, int pn) { return (pm > 64 || pn > 64) ? 8 : 4; }

// Byte pitch of a staged k-contiguous row of bk elements of `size` bytes: a
// whole number of 16-byte words (cp.async's destination alignment), and an
// odd one, so that 8 consecutive rows start in 8 different bank quads.
__host__ __device__ inline int kpitch(int bk, int size) { return round_up(bk * size, 32) + 16; }

// The deepest ring (max_stages down to 1) whose stages, or the epilogue's
// `floor` bytes if larger, fit in `limit`; 1 if none does (the caller then
// reports the bytes and the wrapper refuses the tile). Deeper rings bought
// nothing on the skinny products and cost the unembed blocks per SM, so the
// depth stops at 3 there.
__host__ __device__ inline int ring_stages(long long stage, long long floor, long long limit,
                                           int max_stages = MAX_STAGES) {
  int s = max_stages;
  while (s > 1 && (s * stage > limit || floor > limit)) --s;
  return s;
}

// ---- PTX -------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 (4) bytes from global src to shared dst; bytes past src_bytes
// (0 or the full size here) are written as zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---- staging ---------------------------------------------------------------

// Which pieces of a rows x cols box of T thread tid of nthreads copies:
// pieces tid, tid + nthreads, ..., piece i being (r, p) = (i / per_row,
// i % per_row). The plan holds the first and the step, so the copy makes no
// division per piece, and a kernel makes its plans once, not once a chunk.
// VEC16 pieces are 16 bytes, otherwise one element.
struct Plan { int per_row, total, r, p, dr, dp; };

template <typename T, bool VEC16>
__device__ __forceinline__ Plan plan_box(int rows, int cols, int tid, int nthreads) {
  constexpr int E = VEC16 ? 16 / (int)sizeof(T) : 1;  // elements per piece
  Plan q;
  q.per_row = cols / E;
  q.total = rows * q.per_row;
  q.dr = nthreads / q.per_row;
  q.dp = nthreads - q.dr * q.per_row;
  q.r = tid / q.per_row;
  q.p = tid - q.r * q.per_row;
  return q;
}

// Copy the box of plan q (cols contiguous in global memory, row stride ld
// elements, starting at X) into shared memory at s, rows `pitch` bytes apart:
// consecutive threads copy consecutive pieces of a row. Elements outside the
// valid rows_v x cols_v corner are zeros. VEC16 needs cols, cols_v, ld and X
// 16-byte aligned (the launcher checks).
template <typename T, bool VEC16>
__device__ __forceinline__ void copy_box(const Plan& q, char* s, int pitch, const T* X, int ld,
                                         int rows_v, int cols_v, int tid, int nthreads) {
  constexpr int E = VEC16 ? 16 / (int)sizeof(T) : 1;
  const int per_row = q.per_row, dr = q.dr, dp = q.dp;
  int r = q.r, p = q.p;
  for (int i = tid; i < q.total; i += nthreads) {
    const int c = p * E;
    char* dst = s + r * pitch + c * (int)sizeof(T);
    const bool in = r < rows_v && c < cols_v;
    const T* src = in ? X + (size_t)r * ld + c : X;
    if constexpr (VEC16) {
      cp_async16(dst, src, in ? 16 : 0);
    } else if constexpr (sizeof(T) == 4) {
      cp_async4(dst, src, in ? 4 : 0);
    } else {  // 2-byte elements: below cp.async's 4-byte minimum
      *reinterpret_cast<uint16_t*>(dst) = in ? *reinterpret_cast<const uint16_t*>(src) : 0;
    }
    r += dr;
    p += dp;
    if (p >= per_row) { p -= per_row; ++r; }
  }
}

// The ring. load(c, slot) issues the copies of chunk c into stage `slot`;
// compute(c, slot) consumes it. Chunks c+1 .. c+stages-1 are in flight while
// chunk c is computed. One barrier per chunk: after it, chunk c has landed
// for every thread and every thread is done with chunk c-1, whose stage the
// next load reuses. With one stage the loop is unpipelined (two barriers per
// chunk). On return every copy has landed and every thread is past the last
// compute, so the caller may reuse the ring's memory.
// landed(c, slot) runs in each thread after its own copies of chunk c have
// landed (cp.async.wait_group makes them visible to the thread that issued
// them) and before the barrier that publishes them to the block: a thread may
// rewrite the pieces it copied itself there (covariance.cu centres them).
template <typename Load, typename Landed, typename Compute>
__device__ __forceinline__ void run_ring(int nchunks, int stages, Load&& load, Landed&& landed,
                                         Compute&& compute) {
  for (int s = 0; s < stages - 1; ++s) {
    if (s < nchunks) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    if (stages == 1) {
      if (c > 0) __syncthreads();
      load(c, 0);
      cp_async_commit();
    }
    switch (stages) {  // chunks c+1 .. c+stages-2 may still be pending
      case 6: cp_async_wait<4>(); break;
      case 5: cp_async_wait<3>(); break;
      case 4: cp_async_wait<2>(); break;
      case 3: cp_async_wait<1>(); break;
      default: cp_async_wait<0>();
    }
    landed(c, c % stages);
    __syncthreads();
    if (stages >= 2) {
      const int n = c + stages - 1;
      if (n < nchunks) load(n, n % stages);
      cp_async_commit();
    }
    compute(c, c % stages);
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <typename Load, typename Compute>
__device__ __forceinline__ void run_ring(int nchunks, int stages, Load&& load,
                                         Compute&& compute) {
  run_ring(nchunks, stages, load, [](int, int) {}, compute);
}

// ---- reads -----------------------------------------------------------------

// Four consecutive elements as f32: one 16-byte (f32) or 8-byte (bf16)
// shared-memory read; bf16 widens exactly by a shift of its bits.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void unpack(float (&v)[4], float4 q) {
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// Four consecutive f32 of global memory at X[k .. k+3], of which the first
// `valid` count (zeros past them): one 16-byte read where VEC16 guarantees
// alignment and a whole float4 inside the chunk, else four scalar reads.
template <bool VEC16>
__device__ __forceinline__ float4 ldg4(const float* X, int valid) {
  if (VEC16) return __ldg(reinterpret_cast<const float4*>(X));
  return make_float4(valid > 0 ? __ldg(X) : 0.f, valid > 1 ? __ldg(X + 1) : 0.f,
                     valid > 2 ? __ldg(X + 2) : 0.f, valid > 3 ? __ldg(X + 3) : 0.f);
}

// Let `kernel` take `bytes` of dynamic shared memory where they pass the
// default 48 KB: its cap is raised to the most it can have (the device's
// opt-in maximum less the kernel's static shared memory), once per device
// (`done`, the caller's per-instantiation record: cudaFuncSetAttribute on
// every launch would cost the host microseconds per call). The cap is that
// one value whatever the launch, never the launch's own bytes: host threads
// launching one kernel with different tiles (the background tuner's workers
// beside the serving thread) would otherwise lower it under each other's
// launches, which then fail.
template <typename F>
inline cudaError_t allow_smem(F* kernel, long long bytes, long long (&done)[16]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 16 && done[dev] >= bytes) return cudaSuccess;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  const long long cap = (long long)optin - (long long)attr.sharedSizeBytes;
  if (bytes > cap) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cap);
  if (e == cudaSuccess && dev < 16) done[dev] = cap;
  return e;
}

// True when p is 16-byte aligned: one condition of the 16-byte copy form, whose
// launchers also check every row stride and chunk step.
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace gemm
