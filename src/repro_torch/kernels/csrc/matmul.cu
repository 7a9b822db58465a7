// Tiled matmul on Hopper: O = A @ B, A M x K, B K x N, inputs f32 or bf16
// (both the same), output f32 or bf16.
//
// Replaces: src/repro/kernels/matmul.py:_mm_kernel_pack and _mm_kernel_nopack
// (the Pallas TPU kernels behind repro.kernels.matmul.tiled_matmul; mm3 is
// three calls of it, src/repro/kernels/m3mm.py).
//
// What bounds it on an H100: the three products of mm3 at the paper's LARGE
// size (P..T = 800, 900, 1000, 1100, 1200) are 2*(PQR + RST + PRT) = 6.0
// GFLOP, 90 us at the 67 TFLOP/s f32 rate of the CUDA cores, against 36 MB
// of f32 operands and results over the three launches (11 us at 3.35 TB/s):
// compute-bound. The products accumulate in f32 on the CUDA cores (FFMA),
// like the f32 reference they are held to; tensor cores (TF32/bf16 wgmma)
// are a later optimisation.
//
// Design: one 16x16-thread block per bm x bn tile of O (tiles up to 128 x
// 128); thread (tx, ty) owns rows 64h + 4ty + u and columns 64g + 4tx + v
// (h, g < 2; u, v < 4): up to 8x8 f32 accumulators in registers. A loop
// inside the block walks K in bk-wide chunks: the A chunk (transposed to
// k-major) and the B chunk are staged in shared memory as f32 (bf16 is
// widened with __bfloat162float while staging) with 16-byte aligned rows,
// and every thread runs its register tile over the chunk, reading its four
// rows and four columns of one k as one float4 each (the k loop unrolled by
// 4). While staging, consecutive threads take consecutive rows of A (and
// columns of B), so the shared-memory stores are free of bank conflicts, and
// each thread keeps 8 loads in flight.
// Every output element is summed in the same order (k ascending, one fused
// multiply-add per term) whatever the tiles. The schedule knobs change the
// code:
//   PACK=true   accumulate the whole K range in f32 registers and store O
//               once, in its dtype (the TPU kernel's f32 VMEM accumulator);
//   PACK=false  after every bk chunk, load the O tile, add the chunk's partial
//               product rounded to O's dtype, and store it again in O's dtype
//               (the TPU kernel's read-modify-write of the output block: the
//               knob's precision trade-off in bf16);
//   INTERCHANGE which tile axis blockIdx.x walks: j (columns) by default, as
//               the TPU grid (i, j, k) runs j fastest; i with it.
// Ragged edges are masked (staged zeros, masked stores); nothing is padded.
//
// Interface: matmul_smem_bytes() gives the dynamic shared memory a block
// needs for a tile (-1 for a tile the register tile cannot hold), from the
// same layout() the kernel carves its buffers from; the wrapper checks it
// against the device's limit before launch. matmul_launch() launches on the
// given stream, does not synchronise, and returns cudaGetLastError(). Tile
// extents are runtime values; dtype pair, PACK and INTERCHANGE are template
// parameters (16 instantiations).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TD = 16;          // threads per tile dimension
constexpr int VEC = 4;          // consecutive rows (cols) per thread and group
constexpr int GROUP = TD * VEC; // rows covered by one group: 64
constexpr int MAXG = 2;         // groups per tile dimension: tiles up to 128
constexpr int PAD = 4;          // row padding of staged chunks (keeps float4 alignment)
constexpr int R = MAXG * VEC;   // max rows (cols) per thread
constexpr int INFLIGHT = 8;     // staging loads each thread keeps in flight

struct Args {
  const void* A; const void* B; void* O;
  int M, K, N, bm, bn, bk;
};

// Shared-memory layout of one block, in floats: the A chunk then the B
// chunk, each k-major, bk rows of the tile extent padded to whole groups
// (pm, pn) plus PAD.
struct Layout {
  int pm, pn, lda, ldb;  // padded tile extents, leading dimensions
  int b;                 // offset of the B chunk (A's is 0)
  int floats;            // total
};

__host__ __device__ inline Layout layout(int bm, int bn, int bk) {
  Layout L;
  L.pm = (bm + GROUP - 1) / GROUP * GROUP;
  L.pn = (bn + GROUP - 1) / GROUP * GROUP;
  L.lda = L.pm + PAD;
  L.ldb = L.pn + PAD;
  L.b = bk * L.lda;
  L.floats = L.b + bk * L.ldb;
  return L;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Both staging loops: consecutive threads take consecutive rows of A (or
// columns of B), so the shared-memory stores are free of bank conflicts; each
// thread issues INFLIGHT independent loads before it stores them, so their
// L2 round trips overlap. The padded extents are 64 or 128: an index splits
// with a shift and a mask.

// A rows [r0, r0 + rows_pad) x cols [k0, k0 + kc) (A is M x K) into
// s[k * ld + r] as f32, k-major; rows past the tile or past M are zero.
template <typename T>
__device__ __forceinline__ void stage_rows_kmajor(float* s, int ld, const T* X, int M, int K,
                                                  int r0, int rows, int rows_pad, int k0, int kc) {
  const int tid = threadIdx.y * TD + threadIdx.x;
  const int shift = __ffs(rows_pad) - 1, mask = rows_pad - 1;
  const int total = rows_pad * kc;
  for (int base = tid; base < total; base += TD * TD * INFLIGHT) {
    float v[INFLIGHT];
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) {
      const int idx = base + u * TD * TD, k = idx >> shift, r = idx & mask, g = r0 + r;
      v[u] = (idx < total && r < rows && g < M) ? to_f32(X[(size_t)g * K + k0 + k]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) {
      const int idx = base + u * TD * TD;
      if (idx < total) s[(idx >> shift) * ld + (idx & mask)] = v[u];
    }
  }
}

// B rows [k0, k0 + kc) x cols [c0, c0 + cols_pad) (B is K x N) into
// s[k * ld + c] as f32; columns past the tile or past N are zero.
template <typename T>
__device__ __forceinline__ void stage_rows(float* s, int ld, const T* X, int N,
                                           int c0, int cols, int cols_pad, int k0, int kc) {
  const int tid = threadIdx.y * TD + threadIdx.x;
  const int shift = __ffs(cols_pad) - 1, mask = cols_pad - 1;
  const int total = cols_pad * kc;
  for (int base = tid; base < total; base += TD * TD * INFLIGHT) {
    float v[INFLIGHT];
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) {
      const int idx = base + u * TD * TD, k = idx >> shift, c = idx & mask, g = c0 + c;
      v[u] = (idx < total && c < cols && g < N) ? to_f32(X[(size_t)(k0 + k) * N + g]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) {
      const int idx = base + u * TD * TD;
      if (idx < total) s[(idx >> shift) * ld + (idx & mask)] = v[u];
    }
  }
}

template <typename TI, typename TO, bool PACK, bool INTERCHANGE>
__global__ void __launch_bounds__(TD * TD) matmul_kernel(Args p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const TI* A = (const TI*)p.A;
  const TI* B = (const TI*)p.B;
  TO* O = (TO*)p.O;
  const int ti = INTERCHANGE ? blockIdx.x : blockIdx.y;
  const int tj = INTERCHANGE ? blockIdx.y : blockIdx.x;
  const int i0 = ti * p.bm, j0 = tj * p.bn;
  const Layout L = layout(p.bm, p.bn, p.bk);
  const int pm = L.pm, pn = L.pn, lda = L.lda, ldb = L.ldb;
  const int Gm = pm / GROUP, Gn = pn / GROUP;
  float* sA = smem;          // [bk][lda], k-major
  float* sB = smem + L.b;    // [bk][ldb]
  const int tx = threadIdx.x, ty = threadIdx.y;

  float acc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) acc[a][b] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += p.bk) {
    const int kc = min(p.bk, p.K - k0);
    __syncthreads();  // previous chunk fully consumed
    // consecutive threads take consecutive rows (A) or columns (B):
    // conflict-free shared stores
    stage_rows_kmajor(sA, lda, A, p.M, p.K, i0, p.bm, pm, k0, kc);
    stage_rows(sB, ldb, B, p.N, j0, p.bn, pn, k0, kc);
    __syncthreads();

    if (!PACK) {
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) acc[a][b] = 0.f;
    }
#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      float av[R], bv[R];
#pragma unroll
      for (int h = 0; h < MAXG; ++h) {
        if (h < Gm) {
          const float4 q = *reinterpret_cast<const float4*>(sA + k * lda + GROUP * h + VEC * ty);
          av[VEC * h + 0] = q.x; av[VEC * h + 1] = q.y; av[VEC * h + 2] = q.z; av[VEC * h + 3] = q.w;
        }
        if (h < Gn) {
          const float4 q = *reinterpret_cast<const float4*>(sB + k * ldb + GROUP * h + VEC * tx);
          bv[VEC * h + 0] = q.x; bv[VEC * h + 1] = q.y; bv[VEC * h + 2] = q.z; bv[VEC * h + 3] = q.w;
        }
      }
#pragma unroll
      for (int hm = 0; hm < MAXG; ++hm)
#pragma unroll
        for (int hn = 0; hn < MAXG; ++hn)
          if (hm < Gm && hn < Gn) {
#pragma unroll
            for (int u = 0; u < VEC; ++u)
#pragma unroll
              for (int v = 0; v < VEC; ++v) {
                const int a = VEC * hm + u, b = VEC * hn + v;
                acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
              }
          }
    }

    if (!PACK) {  // read-modify-write of the O tile in O's dtype
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int r = GROUP * (a / VEC) + VEC * ty + a % VEC, gr = i0 + r;
        if (a / VEC >= Gm || r >= p.bm || gr >= p.M) continue;
#pragma unroll
        for (int b = 0; b < R; ++b) {
          const int c = GROUP * (b / VEC) + VEC * tx + b % VEC, gc = j0 + c;
          if (b / VEC >= Gn || c >= p.bn || gc >= p.N) continue;
          const size_t o = (size_t)gr * p.N + gc;
          const float old = k0 == 0 ? 0.f : to_f32(O[o]);
          O[o] = from_f32<TO>(old + to_f32(from_f32<TO>(acc[a][b])));
        }
      }
    }
  }

  if (PACK) {
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int r = GROUP * (a / VEC) + VEC * ty + a % VEC, gr = i0 + r;
      if (a / VEC >= Gm || r >= p.bm || gr >= p.M) continue;
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const int c = GROUP * (b / VEC) + VEC * tx + b % VEC, gc = j0 + c;
        if (b / VEC >= Gn || c >= p.bn || gc >= p.N) continue;
        O[(size_t)gr * p.N + gc] = from_f32<TO>(acc[a][b]);
      }
    }
  }
}

template <typename TI, typename TO, bool PK, bool IC>
cudaError_t launch(const Args& p, size_t smem, cudaStream_t stream) {
  const int mi = (p.M + p.bm - 1) / p.bm, nj = (p.N + p.bn - 1) / p.bn;
  const dim3 grid = IC ? dim3(mi, nj) : dim3(nj, mi);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(matmul_kernel<TI, TO, PK, IC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  matmul_kernel<TI, TO, PK, IC><<<grid, dim3(TD, TD), smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t launch_knobs(const Args& p, int pack, int ic, size_t smem, cudaStream_t s) {
  if (pack) return ic ? launch<TI, TO, true, true>(p, smem, s) : launch<TI, TO, true, false>(p, smem, s);
  return ic ? launch<TI, TO, false, true>(p, smem, s) : launch<TI, TO, false, false>(p, smem, s);
}

}  // namespace

extern "C" long long matmul_smem_bytes(int bm, int bn, int bk) {
  if (bm < 1 || bn < 1 || bk < 1 || bm > GROUP * MAXG || bn > GROUP * MAXG) return -1;
  return (long long)sizeof(float) * layout(bm, bn, bk).floats;
}

extern "C" int matmul_launch(const void* A, const void* B, void* O, int M, int K, int N,
                             int bm, int bn, int bk, int pack, int interchange,
                             int in_bf16, int out_bf16, void* stream) {
  const long long smem = matmul_smem_bytes(bm, bn, bk);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  Args p{A, B, O, M, K, N, bm, bn, bk};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (in_bf16) {
    e = out_bf16 ? launch_knobs<__nv_bfloat16, __nv_bfloat16>(p, pack, interchange, smem, s)
                 : launch_knobs<__nv_bfloat16, float>(p, pack, interchange, smem, s);
  } else {
    e = out_bf16 ? launch_knobs<float, __nv_bfloat16>(p, pack, interchange, smem, s)
                 : launch_knobs<float, float>(p, pack, interchange, smem, s);
  }
  return (int)e;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
