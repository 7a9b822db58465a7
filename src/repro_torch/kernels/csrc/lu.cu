// LU's diagonal-block factor on Hopper, f32: unblocked Doolittle without
// pivoting on the bs x bs block at (off, off) of A (row stride ld), in
// place: L's multipliers below the diagonal (unit diagonal implied), U on
// and above it.
//
// Replaces: src/repro/kernels/lu.py:_factor_diag (lu.py:33), plain array
// code in the JAX package, not a Pallas kernel. It is written by hand here
// only so that step (a) of each block step of the blocked LU is one launch
// and not a host loop of bs row steps. The block step's trailing update runs
// through matmul.cu (the port of _mm_kernel_pack/_nopack).
//
// What bounds it on an H100: a bs x bs factor is 2/3 bs^3 flops (175 kflop
// at bs = 64) in bs - 1 dependent row steps, each needing the pivot row as
// the step before left it: it is bound by the chain of steps, not by
// operations or bytes. Its floor is an empty kernel's device duration plus
// bs times one exchange step among its threads (a shared store, a barrier,
// a load; mma_rate.py measures both).
//
// Design: up to bs = 128 the block lives in registers and only the pivot
// row moves.
//   * bs <= 32 (instantiations 8, 16, 32): one warp, lane i holds row i.
//     At step r lane r's row is the pivot row: the pivot and u_rj come by
//     __shfl_sync from lane r, each lane below it divides its own a_ir into
//     the multiplier and updates its row. No barrier; the row loop is
//     unrolled over the instantiation, so every index is a register's.
//   * bs <= 64, 128: TPR threads a row within one warp (8 at 64, 4 at 128),
//     each a segment of 8 or 32 consecutive columns in registers: 512
//     threads. At step r the thread holding a_ir divides it by the pivot
//     and __shfl_sync's the multiplier to its row's threads; each thread
//     updates its segment against the pivot row, which the owners of row r
//     published into a double-buffered shared row at the end of step r - 1.
//     One barrier a step (a reader of buffer r & 1 in step r is past that
//     step's barrier before it is written again, in step r + 1). The step's
//     chain (barrier, the pivot's load, an IEEE division, a shuffle, a
//     multiply then a subtract, the next row's store) is what bounds it;
//     on the card fewer threads a row, skipping finished warps, or a rolled
//     row loop each ran slower.
//   * bs past 128: the block no longer fits one CTA's registers (64 K
//     floats at 128 x 4 threads of 32 columns would take them all at 256),
//     so it is held in shared memory (row stride bs + 1, so column reads
//     are free of bank conflicts; up to bs = 240 in the H100's 227 KB) by a
//     block of 32 x 32 threads: per row step the multipliers of column r, a
//     barrier, the rank-1 update of the trailing block, a barrier.
// The arithmetic is written with round-to-nearest intrinsics in the
// reference's order, m_i = a_ir / a_rr (__fdiv_rn) and a_ij - (m_i * u_rj)
// (__fmul_rn, __fsub_rn: no contraction into an FMA), so it gives the
// plain version's bits. Rows and columns past bs (a bs between
// instantiations) are computed on zeros and never stored.
//
// Interface: lu_factor_diag_smem_bytes() gives the shared memory the
// helper's block uses for a bs x bs block (-1 for bs < 1); the wrapper
// checks it against the device's limit. lu_factor_diag_launch()
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_REG_BS = 128;  // the widest block held in registers
constexpr int LT = 32;           // past it: LT x LT threads, the block in shared memory

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// bs <= BS <= 32: lane i holds row i. The block is staged through shared
// memory only to read and write it in whole rows (coalesced).
template <int BS>
__global__ void __launch_bounds__(32) lu_warp_kernel(float* A, int ld, int off, int bs) {
  __shared__ float s[BS][BS + 1];
  const int lane = threadIdx.x;
  float* G = A + (size_t)off * ld + off;
  if (lane < BS)
    for (int r = 0; r < BS; ++r) s[r][lane] = (r < bs && lane < bs) ? G[(size_t)r * ld + lane] : 0.f;
  __syncwarp();
  float a[BS];
#pragma unroll
  for (int j = 0; j < BS; ++j) a[j] = lane < BS ? s[lane][j] : 0.f;
#pragma unroll
  for (int r = 0; r < BS - 1; ++r) {
    if (r >= bs - 1) break;
    const float piv = __shfl_sync(FULL, a[r], r);
    const float m = __fdiv_rn(a[r], piv);
    const bool below = lane > r;
    if (below) a[r] = m;
#pragma unroll
    for (int j = r + 1; j < BS; ++j) {
      const float u = __shfl_sync(FULL, a[j], r);
      if (below) a[j] = __fsub_rn(a[j], __fmul_rn(m, u));
    }
  }
  __syncwarp();
  if (lane < BS) {
#pragma unroll
    for (int j = 0; j < BS; ++j) s[lane][j] = a[j];
  }
  __syncwarp();
  if (lane < bs)
    for (int r = 0; r < bs; ++r) G[(size_t)r * ld + lane] = s[r][lane];
}

// bs <= BS (64 or 128): thread (i, t) of TPR threads a row holds columns
// t*SEG .. t*SEG + SEG - 1 of row i.
template <int BS, int TPR>
__global__ void __launch_bounds__(BS * TPR) lu_tile_kernel(float* A, int ld, int off, int bs,
                                                           int vec) {
  constexpr int SEG = BS / TPR;
  __shared__ __align__(16) float prow[2][BS];  // the pivot row, double-buffered
  const int tid = threadIdx.x, i = tid / TPR, t = tid - i * TPR, c0 = t * SEG;
  const int lead = (tid & 31) - t;  // lane of the row's first thread
  float* G = A + (size_t)off * ld + off;
  float* g = G + (size_t)i * ld + c0;

  float a[SEG];
#pragma unroll
  for (int q = 0; q < SEG; q += 4) {
    if (i < bs && vec && c0 + q + 3 < bs) {
      const float4 x = *reinterpret_cast<const float4*>(g + q);
      a[q] = x.x; a[q + 1] = x.y; a[q + 2] = x.z; a[q + 3] = x.w;
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w) a[q + w] = (i < bs && c0 + q + w < bs) ? g[q + w] : 0.f;
    }
  }
  auto publish = [&](int b) {
#pragma unroll
    for (int q = 0; q < SEG; q += 4)
      *reinterpret_cast<float4*>(&prow[b][c0 + q]) =
          make_float4(a[q], a[q + 1], a[q + 2], a[q + 3]);
  };
  if (i == 0) publish(0);
  __syncthreads();

  for (int r0 = 0; r0 < bs - 1; r0 += SEG) {
    const int tr = r0 / SEG;  // the thread of a row holding columns r0 .. r0 + SEG - 1
#pragma unroll
    for (int rr = 0; rr < SEG; ++rr) {
      const int r = r0 + rr;
      if (r >= bs - 1) break;
      const float* u = prow[r & 1];
      // thread tr of each row divides a_ir (its register rr) by the pivot;
      // every thread divides, so the shuffle's lanes never diverge
      const float m = __shfl_sync(FULL, __fdiv_rn(a[rr], u[r]), lead + tr);
      if (i > r && t >= tr) {
        if (t == tr) a[rr] = m;
#pragma unroll
        for (int q = 0; q < SEG; q += 4) {
          const float4 x = *reinterpret_cast<const float4*>(u + c0 + q);
          const float uv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int w = 0; w < 4; ++w)
            if (c0 + q + w > r) a[q + w] = __fsub_rn(a[q + w], __fmul_rn(m, uv[w]));
        }
      }
      if (i == r + 1) publish((r + 1) & 1);
      __syncthreads();
    }
  }

  if (i >= bs) return;
#pragma unroll
  for (int q = 0; q < SEG; q += 4) {
    if (vec && c0 + q + 3 < bs) {
      *reinterpret_cast<float4*>(g + q) = make_float4(a[q], a[q + 1], a[q + 2], a[q + 3]);
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (c0 + q + w < bs) g[q + w] = a[q + w];
    }
  }
}

// bs past MAX_REG_BS: the block in shared memory (row stride bs + 1), two
// barriers a row step among LT x LT threads.
__global__ void __launch_bounds__(LT * LT) lu_smem_kernel(float* A, int ld, int off, int bs) {
  extern __shared__ float s[];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * LT + tx;
  const int ldm = bs + 1;
  float* G = A + (size_t)off * ld + off;
  for (int i = ty; i < bs; i += LT)
    for (int j = tx; j < bs; j += LT) s[i * ldm + j] = G[(size_t)i * ld + j];
  __syncthreads();
  for (int r = 0; r < bs - 1; ++r) {
    const float piv = s[r * ldm + r];
    for (int i = r + 1 + tid; i < bs; i += LT * LT) s[i * ldm + r] = __fdiv_rn(s[i * ldm + r], piv);
    __syncthreads();
    for (int i = r + 1 + ty; i < bs; i += LT) {
      const float m = s[i * ldm + r];
      for (int j = r + 1 + tx; j < bs; j += LT)
        s[i * ldm + j] = __fsub_rn(s[i * ldm + j], __fmul_rn(m, s[r * ldm + j]));
    }
    __syncthreads();
  }
  for (int i = ty; i < bs; i += LT)
    for (int j = tx; j < bs; j += LT) G[(size_t)i * ld + j] = s[i * ldm + j];
}

// The register instantiation a bs runs at (-1 past MAX_REG_BS).
int instantiation(int bs) {
  if (bs < 1 || bs > MAX_REG_BS) return -1;
  int b = 8;
  while (b < bs) b *= 2;
  return b;
}

}  // namespace

extern "C" long long lu_factor_diag_smem_bytes(int bs) {
  if (bs < 1) return -1;
  if (bs > MAX_REG_BS) return (long long)sizeof(float) * bs * (bs + 1);
  const int b = instantiation(bs);
  return b <= 32 ? (long long)sizeof(float) * b * (b + 1) : (long long)sizeof(float) * 2 * b;
}

extern "C" int lu_factor_diag_launch(void* A, int ld, int off, int bs, void* stream) {
  if (bs < 1 || off < 0 || off + bs > ld) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* a = (float*)A;
  if (bs > MAX_REG_BS) {
    const long long smem = lu_factor_diag_smem_bytes(bs);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          lu_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    lu_smem_kernel<<<1, dim3(LT, LT), (size_t)smem, s>>>(a, ld, off, bs);
    return (int)cudaGetLastError();
  }
  const int vec = aligned16(A) && ld % 4 == 0 && off % 4 == 0;  // float4 rows
  switch (instantiation(bs)) {
    case 8: lu_warp_kernel<8><<<1, 32, 0, s>>>(a, ld, off, bs); break;
    case 16: lu_warp_kernel<16><<<1, 32, 0, s>>>(a, ld, off, bs); break;
    case 32: lu_warp_kernel<32><<<1, 32, 0, s>>>(a, ld, off, bs); break;
    case 64: lu_tile_kernel<64, 8><<<1, 64 * 8, 0, s>>>(a, ld, off, bs, vec); break;
    default: lu_tile_kernel<128, 4><<<1, 128 * 4, 0, s>>>(a, ld, off, bs, vec);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
