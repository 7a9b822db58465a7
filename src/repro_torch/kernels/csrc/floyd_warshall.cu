// Blocked Floyd-Warshall on Hopper, f32: the min-plus product
// O = min(D, A (x) B), o_ij = min(d_ij, min_k a_ik + b_kj), with D n x m,
// A n x bs, B bs x m, and the in-block closure of a bs x bs diagonal block.
//
// Replaces: src/repro/kernels/floyd_warshall.py:_minplus_kernel (the Pallas
// TPU kernel behind repro.kernels.floyd_warshall.minplus_update, which
// serves phases 2 and 3 of the blocked algorithm). The closure helper
// replaces _closure_in_block (floyd_warshall.py:93), plain array code in
// the JAX package, so that phase 1 is one launch and not a host loop of bs
// steps.
//
// What bounds it on an H100: each relaxation is one FADD and one FMNMX on
// the CUDA cores; there is no tensor-core form of (min, +). All-pairs
// shortest paths need N^3 relaxations: at the paper's LARGE size (N=2800)
// 2.2e10, 1.31 ms at one f32 instruction per lane and clock (the 67 TFLOP/s
// f32 rate counts an FFMA as two operations, so 33.5e12 instructions/s),
// against 63 MB of compulsory traffic, 19 us at 3.35 TB/s: compute-bound.
//
// Design of the min-plus kernel: matmul.cu's, with (min, +) in place of
// (+, *). One 16x16-thread block per bi x bj tile of O (tiles up to
// 128 x 128); thread (tx, ty) owns rows 64h + 4ty + u and columns
// 64g + 4tx + v (h, g < 2; u, v < 4): up to 8x8 f32 running minima in
// registers, started from D. The bs-wide contraction is streamed through
// shared memory in chunks of KC = 32 (k-major A chunk, B chunk, rows padded
// for 16-byte alignment), so bs=256 with 128-wide tiles needs 34 KB, not the
// 256 KB the whole A and B panels would. The inner loop reads four rows
// (columns) of one k as one float4. The schedule knob changes the code:
//   UNROLL      the unroll factor of the k loop (1, 2, 4, 8), a template
//               parameter: the loop body is replicated UNROLL times per
//               iteration, with a rolled remainder loop, and UNROLL=1 is
//               kept rolled (#pragma unroll 1).
// Ragged edges are masked (rows past n and columns past m are not stored);
// the wrapper always writes a fresh O, since the row panel of phase 2 is
// passed as both D and B. Min is exact and each candidate a_ik + b_kj is
// one rounded add, so the result does not depend on tiles, chunks or order:
// it equals the plain version bit for bit.
//
// Design of the closure helper: one block of 32x32 threads runs the bs
// steps k of in-block Floyd-Warshall, D_ij = min(D_ij, D_ik + D_kj), with a
// __syncthreads() between steps, in place. In place is exact because
// D_kk >= 0 (zero on the diagonal, 1e18 on padded nodes): step k leaves row
// and column k as they are, so the helper skips them and every other
// element reads only values no thread writes in that step. A block up to
// CLOSURE_SMEM_BS = 128 wide is held in shared memory (row stride bs + 1, so
// row and column reads are free of bank conflicts; 66 KB at 128); a wider one
// (bs = 256: 263 KB) works in global memory, through L1 and L2.
//
// Interface: minplus_smem_bytes() gives the dynamic shared memory a block
// of the min-plus kernel needs (-1 for a tile the register tile cannot
// hold), from the same layout() the kernel carves its buffers from.
// minplus_launch() and closure_launch() launch on the given stream, do not
// synchronise, and return cudaGetLastError().

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
constexpr int KC = 32;          // contraction chunk streamed through shared memory
constexpr int CT = 32;          // closure helper: CT x CT threads
constexpr int CLOSURE_SMEM_BS = 128;  // widest closure block held in shared memory

struct Args {
  const float* D; const float* A; const float* B; float* O;
  int n, m, bs, bi, bj;
};

// Shared-memory layout of one min-plus block, in floats: the A chunk then
// the B chunk, each k-major, kc rows of the tile extent padded to whole
// groups (pi, pj) plus PAD.
struct Layout {
  int pi, pj, lda, ldb;  // padded tile extents, leading dimensions
  int b;                 // offset of the B chunk (A's is 0)
  int floats;            // total
};

__host__ __device__ inline Layout layout(int bi, int bj, int bs) {
  const int kc = bs < KC ? bs : KC;
  Layout L;
  L.pi = (bi + GROUP - 1) / GROUP * GROUP;
  L.pj = (bj + GROUP - 1) / GROUP * GROUP;
  L.lda = L.pi + PAD;
  L.ldb = L.pj + PAD;
  L.b = kc * L.lda;
  L.floats = L.b + kc * L.ldb;
  return L;
}

// A rows [r0, r0 + rows_pad) x cols [k0, k0 + kc) (A is n x bs) into
// s[k * ld + r], k-major; consecutive threads take consecutive rows (the
// transposing stores are free of bank conflicts). Rows past the tile or
// past n are staged as 0: their results are never stored.
__device__ __forceinline__ void stage_a(float* s, int ld, const Args& p, int r0, int rows,
                                        int rows_pad, int k0, int kc) {
  const int tid = threadIdx.y * TD + threadIdx.x;
  const int shift = __ffs(rows_pad) - 1, mask = rows_pad - 1;
  const int total = rows_pad * kc;
  for (int base = tid; base < total; base += TD * TD * INFLIGHT) {
    float v[INFLIGHT];
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) {
      const int idx = base + u * TD * TD, k = idx >> shift, r = idx & mask, g = r0 + r;
      v[u] = (idx < total && r < rows && g < p.n) ? p.A[(size_t)g * p.bs + k0 + k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) {
      const int idx = base + u * TD * TD;
      if (idx < total) s[(idx >> shift) * ld + (idx & mask)] = v[u];
    }
  }
}

// B rows [k0, k0 + kc) x cols [c0, c0 + cols_pad) (B is bs x m) into
// s[k * ld + c]; consecutive threads take consecutive columns.
__device__ __forceinline__ void stage_b(float* s, int ld, const Args& p, int c0, int cols,
                                        int cols_pad, int k0, int kc) {
  const int tid = threadIdx.y * TD + threadIdx.x;
  const int shift = __ffs(cols_pad) - 1, mask = cols_pad - 1;
  const int total = cols_pad * kc;
  for (int base = tid; base < total; base += TD * TD * INFLIGHT) {
    float v[INFLIGHT];
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) {
      const int idx = base + u * TD * TD, k = idx >> shift, c = idx & mask, g = c0 + c;
      v[u] = (idx < total && c < cols && g < p.m) ? p.B[(size_t)(k0 + k) * p.m + g] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) {
      const int idx = base + u * TD * TD;
      if (idx < total) s[(idx >> shift) * ld + (idx & mask)] = v[u];
    }
  }
}

// One relaxation step k of the register tile.
__device__ __forceinline__ void relax(float (&acc)[R][R], const float* sA, int lda,
                                      const float* sB, int ldb, int k, int Gi, int Gj) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  float av[R], bv[R];
#pragma unroll
  for (int h = 0; h < MAXG; ++h) {
    if (h < Gi) {
      const float4 q = *reinterpret_cast<const float4*>(sA + k * lda + GROUP * h + VEC * ty);
      av[VEC * h + 0] = q.x; av[VEC * h + 1] = q.y; av[VEC * h + 2] = q.z; av[VEC * h + 3] = q.w;
    }
    if (h < Gj) {
      const float4 q = *reinterpret_cast<const float4*>(sB + k * ldb + GROUP * h + VEC * tx);
      bv[VEC * h + 0] = q.x; bv[VEC * h + 1] = q.y; bv[VEC * h + 2] = q.z; bv[VEC * h + 3] = q.w;
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
            acc[a][b] = fminf(acc[a][b], av[a] + bv[b]);
          }
      }
}

template <int UNROLL>
__global__ void __launch_bounds__(TD * TD) minplus_kernel(Args p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int i0 = blockIdx.y * p.bi, j0 = blockIdx.x * p.bj;
  const Layout L = layout(p.bi, p.bj, p.bs);
  const int Gi = L.pi / GROUP, Gj = L.pj / GROUP;
  float* sA = smem;          // [kc][lda], k-major
  float* sB = smem + L.b;    // [kc][ldb]
  const int tx = threadIdx.x, ty = threadIdx.y;

  float acc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int r = GROUP * (a / VEC) + VEC * ty + a % VEC, gr = i0 + r;
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const int c = GROUP * (b / VEC) + VEC * tx + b % VEC, gc = j0 + c;
      const bool in = a / VEC < Gi && b / VEC < Gj && r < p.bi && gr < p.n && c < p.bj && gc < p.m;
      acc[a][b] = in ? p.D[(size_t)gr * p.m + gc] : 0.f;
    }
  }

  for (int k0 = 0; k0 < p.bs; k0 += KC) {
    const int kc = min(KC, p.bs - k0);
    __syncthreads();  // previous chunk fully consumed
    stage_a(sA, L.lda, p, i0, p.bi, L.pi, k0, kc);
    stage_b(sB, L.ldb, p, j0, p.bj, L.pj, k0, kc);
    __syncthreads();

    int k = 0;
#pragma unroll 1
    for (; k + UNROLL <= kc; k += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) relax(acc, sA, L.lda, sB, L.ldb, k + u, Gi, Gj);
    }
#pragma unroll 1
    for (; k < kc; ++k) relax(acc, sA, L.lda, sB, L.ldb, k, Gi, Gj);
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int r = GROUP * (a / VEC) + VEC * ty + a % VEC, gr = i0 + r;
    if (a / VEC >= Gi || r >= p.bi || gr >= p.n) continue;
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const int c = GROUP * (b / VEC) + VEC * tx + b % VEC, gc = j0 + c;
      if (b / VEC >= Gj || c >= p.bj || gc >= p.m) continue;
      p.O[(size_t)gr * p.m + gc] = acc[a][b];
    }
  }
}

template <int UNROLL>
cudaError_t launch_minplus(const Args& p, size_t smem, cudaStream_t stream) {
  const dim3 grid((p.m + p.bj - 1) / p.bj, (p.n + p.bi - 1) / p.bi);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(minplus_kernel<UNROLL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  minplus_kernel<UNROLL><<<grid, dim3(TD, TD), smem, stream>>>(p);
  return cudaGetLastError();
}

// In-block closure of the bs x bs block at (off, off) of D (row stride ld).
// SMEM: the block is copied into shared memory (row stride bs + 1) and back.
template <bool SMEM>
__global__ void __launch_bounds__(CT * CT) closure_kernel(float* D, int ld, int off, int bs) {
  extern __shared__ float s[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  float* G = D + (size_t)off * ld + off;
  float* M = SMEM ? s : G;
  const int ldm = SMEM ? bs + 1 : ld;
  if (SMEM) {
    for (int i = ty; i < bs; i += CT)
      for (int j = tx; j < bs; j += CT) M[i * ldm + j] = G[(size_t)i * ld + j];
    __syncthreads();
  }
  for (int k = 0; k < bs; ++k) {
    for (int i = ty; i < bs; i += CT) {
      if (i == k) continue;
      const float dik = M[(size_t)i * ldm + k];
      for (int j = tx; j < bs; j += CT) {
        if (j == k) continue;
        float* x = M + (size_t)i * ldm + j;
        *x = fminf(*x, dik + M[(size_t)k * ldm + j]);
      }
    }
    __syncthreads();
  }
  if (SMEM) {
    for (int i = ty; i < bs; i += CT)
      for (int j = tx; j < bs; j += CT) G[(size_t)i * ld + j] = M[i * ldm + j];
  }
}

}  // namespace

extern "C" long long minplus_smem_bytes(int bi, int bj, int bs) {
  if (bi < 1 || bj < 1 || bs < 1 || bi > GROUP * MAXG || bj > GROUP * MAXG) return -1;
  return (long long)sizeof(float) * layout(bi, bj, bs).floats;
}

extern "C" int minplus_launch(const void* D, const void* A, const void* B, void* O, int n,
                              int m, int bs, int bi, int bj, int unroll, void* stream) {
  const long long smem = minplus_smem_bytes(bi, bj, bs);
  if (smem < 0 || n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  Args p{(const float*)D, (const float*)A, (const float*)B, (float*)O, n, m, bs, bi, bj};
  cudaStream_t s = (cudaStream_t)stream;
  switch (unroll) {
    case 1: return (int)launch_minplus<1>(p, smem, s);
    case 2: return (int)launch_minplus<2>(p, smem, s);
    case 4: return (int)launch_minplus<4>(p, smem, s);
    case 8: return (int)launch_minplus<8>(p, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int closure_launch(void* D, int ld, int off, int bs, void* stream) {
  if (bs < 1 || off < 0 || off + bs > ld) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bs <= CLOSURE_SMEM_BS) {
    const int smem = (int)sizeof(float) * bs * (bs + 1);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(closure_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    closure_kernel<true><<<1, dim3(CT, CT), smem, s>>>((float*)D, ld, off, bs);
  } else {
    closure_kernel<false><<<1, dim3(CT, CT), 0, s>>>((float*)D, ld, off, bs);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
