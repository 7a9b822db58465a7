// covariance on Hopper: O = (D - mu)^T (D - mu) / (N - 1), D N x M (N data
// points of M attributes, row-major), mu the M column means, O M x M; f32.
//
// Replaces: src/repro/kernels/covariance.py:_cov_kernel (the Pallas TPU
// kernel behind repro.kernels.covariance.covariance, the paper's Sec. 4.5).
//
// What bounds it on an H100: the output is symmetric, so the function needs
// M(M+1)/2 dot products of length N: M(M+1)N = 2.02 GFLOP at the paper's
// LARGE size (N=1400, M=1200), 30 us at the 67 TFLOP/s f32 rate of the CUDA
// cores, against 12.5 MB of compulsory traffic (D read once, O written
// once), 4 us at 3.35 TB/s: compute-bound. It sums in full f32 FFMA, as
// matmul.cu does. This kernel computes both halves of O (2*M^2*N flops),
// as the TPU kernel does; a block pairing the tiles (i, j) and (j, i) would
// halve that (a design gap, recorded in ROADMAP.md).
//
// Design: matmul.cu's. One 16x16-thread block per bi x bj tile of O (tiles
// up to 128 x 128); thread (tx, ty) owns rows 64h + 4ty + u and columns
// 64g + 4tx + v (h, g < 2; u, v < 4): up to 8x8 f32 accumulators in
// registers. A loop inside the block walks the N data points in bk-row
// chunks (the TPU's sequential k grid axis). Both operands are column slabs
// of D, which row-major D already holds k-major: the chunk of columns i and
// the chunk of columns j are staged as they lie, consecutive threads on
// consecutive columns (coalesced loads, conflict-free stores), 8 loads in
// flight per thread, into rows padded for 16-byte alignment; the inner loop
// reads four rows (columns) of one k as one float4. The knobs change the
// generated code:
//   FUSE_CENTER subtract mu_i (mu_j) from each value while staging it, so
//               the centring is fused into the update loop; without it the
//               wrapper centres D in a separate pass first and the kernel
//               stages the values as they are.
//   INTERCHANGE which tile axis blockIdx.x walks (the raster order): j by
//               default, as the TPU grid (i, j, k) runs j fastest; i with it.
// Rows past N and columns past M are masked (staged as exact zeros after
// centring, not stored), where the TPU kernel pads M to lcm(bi, bj) and
// fills padded rows with the means. Every output element is summed in the
// same order (k ascending, one fused multiply-add per term) whatever the
// tiles, then divided by N - 1.
//
// Interface: covariance_smem_bytes() gives the dynamic shared memory a
// block needs for a tile (-1 for a tile the register tile cannot hold), from
// the same layout() the kernel carves its buffers from; the wrapper checks
// it against the device's limit before launch. covariance_launch() launches
// on the given stream, does not synchronise, and returns cudaGetLastError().
// Tile extents are runtime values; FUSE_CENTER and INTERCHANGE are template
// parameters (4 instantiations).

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
  const float* D; const float* mean; float* O;
  int N, M, bi, bj, bk;
};

// Shared-memory layout of one block, in floats: the chunk of columns i then
// the chunk of columns j, each bk rows of the tile extent padded to whole
// groups (pi, pj) plus PAD.
struct Layout {
  int pi, pj, ldi, ldj;  // padded tile extents, leading dimensions
  int j;                 // offset of the j chunk (the i chunk's is 0)
  int floats;            // total
};

__host__ __device__ inline Layout layout(int bi, int bj, int bk) {
  Layout L;
  L.pi = (bi + GROUP - 1) / GROUP * GROUP;
  L.pj = (bj + GROUP - 1) / GROUP * GROUP;
  L.ldi = L.pi + PAD;
  L.ldj = L.pj + PAD;
  L.j = bk * L.ldi;
  L.floats = L.j + bk * L.ldj;
  return L;
}

// D rows [k0, k0 + kc) x columns [c0, c0 + cols_pad) into s[k * ld + c],
// minus the column mean with FUSE; columns past the tile or past M, and
// rows past N (kc stops at N), are zero. The padded extents are 64 or 128:
// an index splits with a shift and a mask.
template <bool FUSE>
__device__ __forceinline__ void stage(float* s, int ld, const Args& p, int c0, int cols,
                                      int cols_pad, int k0, int kc) {
  const int tid = threadIdx.y * TD + threadIdx.x;
  const int shift = __ffs(cols_pad) - 1, mask = cols_pad - 1;
  const int total = cols_pad * kc;
  for (int base = tid; base < total; base += TD * TD * INFLIGHT) {
    float v[INFLIGHT];
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) {
      const int idx = base + u * TD * TD, k = idx >> shift, c = idx & mask, g = c0 + c;
      const bool in = idx < total && c < cols && g < p.M;
      v[u] = in ? p.D[(size_t)(k0 + k) * p.M + g] : 0.f;
      if (FUSE && in) v[u] -= p.mean[g];
    }
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) {
      const int idx = base + u * TD * TD;
      if (idx < total) s[(idx >> shift) * ld + (idx & mask)] = v[u];
    }
  }
}

template <bool FUSE, bool INTERCHANGE>
__global__ void __launch_bounds__(TD * TD) covariance_kernel(Args p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ti = INTERCHANGE ? blockIdx.x : blockIdx.y;
  const int tj = INTERCHANGE ? blockIdx.y : blockIdx.x;
  const int i0 = ti * p.bi, j0 = tj * p.bj;
  const Layout L = layout(p.bi, p.bj, p.bk);
  const int Gi = L.pi / GROUP, Gj = L.pj / GROUP;
  float* sI = smem;        // [bk][ldi]
  float* sJ = smem + L.j;  // [bk][ldj]
  const int tx = threadIdx.x, ty = threadIdx.y;

  float acc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) acc[a][b] = 0.f;

  for (int k0 = 0; k0 < p.N; k0 += p.bk) {
    const int kc = min(p.bk, p.N - k0);
    __syncthreads();  // previous chunk fully consumed
    stage<FUSE>(sI, L.ldi, p, i0, p.bi, L.pi, k0, kc);
    stage<FUSE>(sJ, L.ldj, p, j0, p.bj, L.pj, k0, kc);
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      float av[R], bv[R];
#pragma unroll
      for (int h = 0; h < MAXG; ++h) {
        if (h < Gi) {
          const float4 q = *reinterpret_cast<const float4*>(sI + k * L.ldi + GROUP * h + VEC * ty);
          av[VEC * h + 0] = q.x; av[VEC * h + 1] = q.y; av[VEC * h + 2] = q.z; av[VEC * h + 3] = q.w;
        }
        if (h < Gj) {
          const float4 q = *reinterpret_cast<const float4*>(sJ + k * L.ldj + GROUP * h + VEC * tx);
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
                acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
              }
          }
    }
  }

  const float denom = (float)(p.N - 1);
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int r = GROUP * (a / VEC) + VEC * ty + a % VEC, gr = i0 + r;
    if (a / VEC >= Gi || r >= p.bi || gr >= p.M) continue;
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const int c = GROUP * (b / VEC) + VEC * tx + b % VEC, gc = j0 + c;
      if (b / VEC >= Gj || c >= p.bj || gc >= p.M) continue;
      p.O[(size_t)gr * p.M + gc] = acc[a][b] / denom;
    }
  }
}

template <bool FUSE, bool IC>
cudaError_t launch(const Args& p, size_t smem, cudaStream_t stream) {
  const int ni = (p.M + p.bi - 1) / p.bi, nj = (p.M + p.bj - 1) / p.bj;
  const dim3 grid = IC ? dim3(ni, nj) : dim3(nj, ni);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(covariance_kernel<FUSE, IC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  covariance_kernel<FUSE, IC><<<grid, dim3(TD, TD), smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long covariance_smem_bytes(int bi, int bj, int bk) {
  if (bi < 1 || bj < 1 || bk < 1 || bi > GROUP * MAXG || bj > GROUP * MAXG) return -1;
  return (long long)sizeof(float) * layout(bi, bj, bk).floats;
}

extern "C" int covariance_launch(const void* data, const void* mean, void* O, int N, int M,
                                 int bi, int bj, int bk, int fuse_center, int interchange,
                                 void* stream) {
  const long long smem = covariance_smem_bytes(bi, bj, bk);
  if (smem < 0 || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  Args p{(const float*)data, (const float*)mean, (float*)O, N, M, bi, bj, bk};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (fuse_center) {
    e = interchange ? launch<true, true>(p, smem, s) : launch<true, false>(p, smem, s);
  } else {
    e = interchange ? launch<false, true>(p, smem, s) : launch<false, false>(p, smem, s);
  }
  return (int)e;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
