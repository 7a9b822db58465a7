// syr2k on Hopper: O = beta*C + alpha*(A*B^T + B*A^T), A and B N x M, C N x N, f32.
//
// Replaces: src/repro/kernels/syr2k.py:_syr2k_kernel (the Pallas TPU kernel
// behind repro.kernels.syr2k.syr2k, the paper's Sec. 4.1 case study).
//
// What bounds it on an H100: the function needs one product, since
// B*A^T = (A*B^T)^T: at the paper's LARGE size (N=1200, M=1000) that is
// 2*N^2*M = 2.88 GFLOP of f32 multiply-adds, 43 us at the 67 TFLOP/s f32
// rate of the CUDA cores, against 21 MB of compulsory traffic (A, B, C read
// once, O written once), 6 us at 3.35 TB/s. So it is compute-bound, on the
// CUDA cores: the reference and the JAX suite hold syr2k to 5e-3, and a TF32
// tensor-core sum over M=1000 terms keeps about three digits, so the kernel
// stays in full f32 FFMA on purpose. This kernel computes both products
// (4*N^2*M flops), twice the work the bound counts: each block owns one
// tile of O and would otherwise need the transposed tile's product from
// another block.
//
// Design: one thread block of 16x16 threads per bi x bj tile of O (tiles up
// to 128 x 128). Thread (tx, ty) owns rows 64h + 4ty + u and columns
// 64g + 4tx + v of the tile (h, g < 2; u, v < 4): up to 8x8 f32 accumulators
// in registers, two FFMAs per accumulator and k. A loop inside the block
// walks M in bk-wide chunks (the TPU's sequential k grid axis becomes that
// loop), unrolled by 4. To keep the FFMA pipes, not shared memory, the
// limit, staged operands are stored k-major with 16-byte aligned rows, so a
// thread reads its four rows (or columns) of one k as one float4; while
// staging, consecutive threads take consecutive rows, so the transposing
// shared-memory stores are free of bank conflicts, and each thread keeps 8
// loads in flight. The schedule knobs change the generated code:
//   PACK_A      stage the A_i and A_j chunks in shared memory, so the inner
//               loop reads each A value from shared memory; without it the
//               inner loop reads A from global memory (through L1/L2).
//   PACK_B      the same for B_i and B_j.
//   INTERCHANGE which tile axis blockIdx.x walks (the raster order): j by
//               default, as the TPU grid (i, j, k) runs j fastest; i with it.
// Ragged edges (N not a multiple of bi or bj, M not a multiple of bk) are
// masked: staged rows past the edge are zero and out-of-range outputs are not
// stored. There is no padding of N to lcm(bi, bj) as the TPU BlockSpecs need.
// The whole N x N result is computed, as the reference does. Every output
// element is summed in the same order (k ascending, one fused multiply-add
// per term) whatever the knobs, so all configurations give the same bits.
//
// Interface: syr2k_smem_bytes() gives the dynamic shared memory a block
// needs for a tile and knobs (-1 for a tile the register tile cannot hold),
// from the same layout() the kernel carves its buffers from; the wrapper
// checks it against the device's limit before launch. syr2k_launch()
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError(). Tile extents are runtime values; only the three knobs
// are template parameters (8 instantiations).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TD = 16;          // threads per tile dimension
constexpr int VEC = 4;          // consecutive rows (cols) per thread and group
constexpr int GROUP = TD * VEC; // rows covered by one group: 64
constexpr int MAXG = 2;         // groups per tile dimension: tiles up to 128
constexpr int PAD = 4;          // row padding of staged chunks (keeps float4 alignment)
constexpr int INFLIGHT = 8;     // staging loads each thread keeps in flight

struct Args {
  const float* C; const float* A; const float* B; float* O;
  int N, M; float alpha, beta; int bi, bj, bk;
};

// Shared-memory layout of one block, in floats: [A_i | A_j] if PACK_A, then
// [B_i | B_j] if PACK_B, each a k-major chunk of bk rows of the tile extent
// padded to whole groups (pi, pj) plus PAD.
struct Layout {
  int pi, pj, ldi, ldj;  // padded tile extents, leading dimensions
  int ai, aj, bi, bj;    // offsets of the four chunks
  int floats;            // total
};

__host__ __device__ inline Layout layout(int bi, int bj, int bk, bool pack_a, bool pack_b) {
  Layout L;
  L.pi = (bi + GROUP - 1) / GROUP * GROUP;
  L.pj = (bj + GROUP - 1) / GROUP * GROUP;
  L.ldi = L.pi + PAD;
  L.ldj = L.pj + PAD;
  L.ai = 0;
  L.aj = L.ai + (pack_a ? bk * L.ldi : 0);
  L.bi = L.aj + (pack_a ? bk * L.ldj : 0);
  L.bj = L.bi + (pack_b ? bk * L.ldi : 0);
  L.floats = L.bj + (pack_b ? bk * L.ldj : 0);
  return L;
}

// Stage rows [r0, r0 + rows_pad) x cols [k0, k0 + kc) of X (N x M) into
// s[k * ld + r], k-major; rows past the tile (r >= rows) or past N are zero.
// Consecutive threads take consecutive rows (conflict-free shared stores);
// each thread issues INFLIGHT independent loads before it stores them, so
// their L2 round trips overlap instead of queueing one after another.
// rows_pad is 64 or 128, so the split of an index is a shift and a mask.
__device__ __forceinline__ void stage(float* s, int ld, const float* X, int N, int M,
                                      int r0, int rows, int rows_pad, int k0, int kc) {
  const int tid = threadIdx.y * TD + threadIdx.x;
  const int shift = __ffs(rows_pad) - 1, mask = rows_pad - 1;
  const int total = rows_pad * kc;
  for (int base = tid; base < total; base += TD * TD * INFLIGHT) {
    float v[INFLIGHT];
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) {
      const int idx = base + u * TD * TD, k = idx >> shift, r = idx & mask, g = r0 + r;
      v[u] = (idx < total && r < rows && g < N) ? __ldg(X + (size_t)g * M + k0 + k) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) {
      const int idx = base + u * TD * TD;
      if (idx < total) s[(idx >> shift) * ld + (idx & mask)] = v[u];
    }
  }
}

// The VEC values of group h at step k: a float4 from a staged chunk, or
// VEC scalar reads of global memory at the clamped rows g[].
template <bool STAGED>
__device__ __forceinline__ void fetch(float (&v)[MAXG * VEC], int h, const float* s, int ld,
                                      int lane, int k, const float* X, const int (&g)[MAXG * VEC],
                                      int M, int kg) {
  if (STAGED) {
    const float4 q = *reinterpret_cast<const float4*>(s + k * ld + GROUP * h + VEC * lane);
    v[VEC * h + 0] = q.x; v[VEC * h + 1] = q.y; v[VEC * h + 2] = q.z; v[VEC * h + 3] = q.w;
  } else {
#pragma unroll
    for (int u = 0; u < VEC; ++u) v[VEC * h + u] = __ldg(X + (size_t)g[VEC * h + u] * M + kg);
  }
}

template <bool PACK_A, bool PACK_B, bool INTERCHANGE>
__global__ void __launch_bounds__(TD * TD) syr2k_kernel(Args p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ti = INTERCHANGE ? blockIdx.x : blockIdx.y;
  const int tj = INTERCHANGE ? blockIdx.y : blockIdx.x;
  const int i0 = ti * p.bi, j0 = tj * p.bj;
  const Layout L = layout(p.bi, p.bj, p.bk, PACK_A, PACK_B);
  const int pi = L.pi, pj = L.pj, ldi = L.ldi, ldj = L.ldj;
  const int Gi = pi / GROUP, Gj = pj / GROUP;
  const int tx = threadIdx.x, ty = threadIdx.y;
  float* sAi = smem + L.ai;
  float* sAj = smem + L.aj;
  float* sBi = smem + L.bi;
  float* sBj = smem + L.bj;

  // global rows of this thread's rows/cols, clamped into range so an
  // unstaged read never leaves the array (masked rows are never stored)
  int gi[MAXG * VEC], gj[MAXG * VEC];
#pragma unroll
  for (int h = 0; h < MAXG; ++h)
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      gi[VEC * h + u] = min(i0 + GROUP * h + VEC * ty + u, p.N - 1);
      gj[VEC * h + u] = min(j0 + GROUP * h + VEC * tx + u, p.N - 1);
    }

  float acc[MAXG * VEC][MAXG * VEC];
#pragma unroll
  for (int a = 0; a < MAXG * VEC; ++a)
#pragma unroll
    for (int b = 0; b < MAXG * VEC; ++b) acc[a][b] = 0.f;

  for (int k0 = 0; k0 < p.M; k0 += p.bk) {
    const int kc = min(p.bk, p.M - k0);
    if (PACK_A || PACK_B) {
      __syncthreads();  // previous chunk fully consumed
      if (PACK_A) {
        stage(sAi, ldi, p.A, p.N, p.M, i0, p.bi, pi, k0, kc);
        stage(sAj, ldj, p.A, p.N, p.M, j0, p.bj, pj, k0, kc);
      }
      if (PACK_B) {
        stage(sBi, ldi, p.B, p.N, p.M, i0, p.bi, pi, k0, kc);
        stage(sBj, ldj, p.B, p.N, p.M, j0, p.bj, pj, k0, kc);
      }
      __syncthreads();
    }
#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      float ai[MAXG * VEC], bi[MAXG * VEC], aj[MAXG * VEC], bj[MAXG * VEC];
#pragma unroll
      for (int h = 0; h < MAXG; ++h) {
        if (h < Gi) {
          fetch<PACK_A>(ai, h, sAi, ldi, ty, k, p.A, gi, p.M, k0 + k);
          fetch<PACK_B>(bi, h, sBi, ldi, ty, k, p.B, gi, p.M, k0 + k);
        }
        if (h < Gj) {
          fetch<PACK_A>(aj, h, sAj, ldj, tx, k, p.A, gj, p.M, k0 + k);
          fetch<PACK_B>(bj, h, sBj, ldj, tx, k, p.B, gj, p.M, k0 + k);
        }
      }
#pragma unroll
      for (int hi = 0; hi < MAXG; ++hi)
#pragma unroll
        for (int hj = 0; hj < MAXG; ++hj)
          if (hi < Gi && hj < Gj) {
#pragma unroll
            for (int u = 0; u < VEC; ++u)
#pragma unroll
              for (int v = 0; v < VEC; ++v) {
                const int a = VEC * hi + u, b = VEC * hj + v;
                acc[a][b] = fmaf(ai[a], bj[b], fmaf(bi[a], aj[b], acc[a][b]));
              }
          }
    }
  }

#pragma unroll
  for (int a = 0; a < MAXG * VEC; ++a) {
    const int r = GROUP * (a / VEC) + VEC * ty + a % VEC, gr = i0 + r;
    if (a / VEC >= Gi || r >= p.bi || gr >= p.N) continue;
#pragma unroll
    for (int b = 0; b < MAXG * VEC; ++b) {
      const int c = GROUP * (b / VEC) + VEC * tx + b % VEC, gc = j0 + c;
      if (b / VEC >= Gj || c >= p.bj || gc >= p.N) continue;
      const size_t o = (size_t)gr * p.N + gc;
      p.O[o] = p.beta * __ldg(p.C + o) + p.alpha * acc[a][b];
    }
  }
}

template <bool PA, bool PB, bool IC>
cudaError_t launch(const Args& p, size_t smem, cudaStream_t stream) {
  const int ni = (p.N + p.bi - 1) / p.bi, nj = (p.N + p.bj - 1) / p.bj;
  const dim3 grid = IC ? dim3(ni, nj) : dim3(nj, ni);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(syr2k_kernel<PA, PB, IC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  syr2k_kernel<PA, PB, IC><<<grid, dim3(TD, TD), smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool PA, bool PB>
cudaError_t launch_ic(const Args& p, int ic, size_t smem, cudaStream_t s) {
  return ic ? launch<PA, PB, true>(p, smem, s) : launch<PA, PB, false>(p, smem, s);
}

}  // namespace

extern "C" long long syr2k_smem_bytes(int bi, int bj, int bk, int pack_a, int pack_b) {
  if (bi < 1 || bj < 1 || bk < 1 || bi > GROUP * MAXG || bj > GROUP * MAXG) return -1;
  return (long long)sizeof(float) * layout(bi, bj, bk, pack_a, pack_b).floats;
}

extern "C" int syr2k_launch(const void* C, const void* A, const void* B, void* O,
                            int N, int M, float alpha, float beta, int bi, int bj, int bk,
                            int pack_a, int pack_b, int interchange, void* stream) {
  const long long smem = syr2k_smem_bytes(bi, bj, bk, pack_a, pack_b);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  Args p{(const float*)C, (const float*)A, (const float*)B, (float*)O,
         N, M, alpha, beta, bi, bj, bk};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (pack_a && pack_b) e = launch_ic<true, true>(p, interchange, smem, s);
  else if (pack_a)      e = launch_ic<true, false>(p, interchange, smem, s);
  else if (pack_b)      e = launch_ic<false, true>(p, interchange, smem, s);
  else                  e = launch_ic<false, false>(p, interchange, smem, s);
  return (int)e;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
