// heat-3d on Hopper, f32: passes of FUSE_T masked 7-point stencil steps
// over an n0 x n1 x n2 grid. One step: every interior point gets
//   0.125*((a[i+1] - 2a) + a[i-1]) + 0.125*(the same along j)
//   + 0.125*(the same along k) + a,
// every point on the grid's faces keeps its value.
//
// Replaces: src/repro/kernels/heat3d.py:_heat_kernel (the Pallas TPU kernel
// behind repro.kernels.heat3d.heat3d_step, the paper's Sec. 4.4), with its
// global-index interior mask (_masked_update).
//
// What bounds it on an H100: the paper's LARGE size (N=120, 500 time steps)
// is 2*500 steps over 118^3 interior points at 13 operations each (three
// differences of two operations, 2a, three scalings, three adds): 2.1e10
// operations, 0.32 ms at 67 TFLOP/s. The grid (6.9 MB) fits in the 50 MB L2,
// so device memory holds it back little. With one launch per pass, 1,000 or
// 500 launches of a few microseconds each are likely to set the pace.
//
// Design: the TPU kernel keeps whole j x k planes resident; at N=120 one
// f32 plane is 57.6 KB, so an 8-row slab would be several times a block's
// shared memory. Here a block owns a bi x TJ x TK box (TJ = TK = 16, fixed:
// the JAX space tunes only bi and fuse_t) and loads the box with its
// FUSE_T-deep halo, (bi + 2h) x (TJ + 2h) x (TK + 2h), into shared memory
// straight from global memory (the halo is read from global memory, so
// bi = 1 with fuse_t = 2 is right). Step s = 1..h computes the box grown by
// h - s on every side (overlapped tiling: with fuse_t = 2 the first step is
// recomputed on the one-deep halo) into a second buffer, and the last step
// writes the box to global memory. The interior mask uses global indices,
// so values loaded from outside the grid (zeros) only ever feed points that
// keep their value. 256 threads walk the (j, k) columns of a step's region,
// k fastest (coalesced loads and stores), each column over i. The
// arithmetic is written with round-to-nearest intrinsics in the reference's
// order (no contraction into FMAs), so a step gives the plain version's
// bits.
//
// heat3d_launch() runs all `passes` passes of one call from C, ping-ponging
// between two buffers so that the last pass writes O (the input is never
// written): one heat3d evaluation is one call from Python. It launches on
// the given stream, does not synchronise, and returns the first nonzero
// cudaGetLastError(). heat3d_smem_bytes() gives the dynamic shared memory a
// block needs, from the same layout() the kernel carves its buffers from.
// FUSE_T is a template parameter (2 instantiations).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TJ = 16, TK = 16;  // fixed j x k extent of a block's box
constexpr int THREADS = 256;

struct Args {
  const float* in; float* out;
  int n0, n1, n2, bi;
};

// Shared-memory layout of one block, in floats: the loaded box with its
// h-deep halo, then (h = 2) a second buffer of the same extents for the
// intermediate step.
struct Layout {
  int e0, e1, e2;  // extents of the box with its halo
  int vol;         // floats of one buffer
  int floats;      // total
};

__host__ __device__ inline Layout layout(int bi, int h) {
  Layout L;
  L.e0 = bi + 2 * h;
  L.e1 = TJ + 2 * h;
  L.e2 = TK + 2 * h;
  L.vol = L.e0 * L.e1 * L.e2;
  L.floats = (h > 1 ? 2 : 1) * L.vol;
  return L;
}

template <int H>
__global__ void __launch_bounds__(THREADS) heat3d_kernel(Args p) {
  extern __shared__ float smem[];
  const Layout L = layout(p.bi, H);
  const int e12 = L.e1 * L.e2;
  // global coordinates of the box's first halo point
  const int gi0 = blockIdx.z * p.bi - H, gj0 = blockIdx.y * TJ - H, gk0 = blockIdx.x * TK - H;
  const size_t s0 = (size_t)p.n1 * p.n2;

  for (int c = threadIdx.x; c < e12; c += THREADS) {
    const int lj = c / L.e2, lk = c - lj * L.e2, gj = gj0 + lj, gk = gk0 + lk;
    const bool jk = gj >= 0 && gj < p.n1 && gk >= 0 && gk < p.n2;
    for (int li = 0; li < L.e0; ++li) {
      const int gi = gi0 + li;
      smem[li * e12 + c] =
          (jk && gi >= 0 && gi < p.n0) ? p.in[(size_t)gi * s0 + (size_t)gj * p.n2 + gk] : 0.f;
    }
  }
  __syncthreads();

  const float* src = smem;
#pragma unroll
  for (int s = 1; s <= H; ++s) {
    float* dst = smem + (s & 1) * L.vol;  // s = 1 (of 2) writes the second buffer
    const int r1 = L.e1 - 2 * s, r2 = L.e2 - 2 * s;
    for (int c = threadIdx.x; c < r1 * r2; c += THREADS) {
      const int lj = s + c / r2, lk = s + c % r2, gj = gj0 + lj, gk = gk0 + lk;
      const bool jk = gj > 0 && gj < p.n1 - 1 && gk > 0 && gk < p.n2 - 1;
      for (int li = s; li < L.e0 - s; ++li) {
        const int gi = gi0 + li, o = li * e12 + lj * L.e2 + lk;
        const float a = src[o];
        float v = a;
        if (jk && gi > 0 && gi < p.n0 - 1) {
          const float a2 = __fmul_rn(2.f, a);
          const float di = __fadd_rn(__fsub_rn(src[o + e12], a2), src[o - e12]);
          const float dj = __fadd_rn(__fsub_rn(src[o + L.e2], a2), src[o - L.e2]);
          const float dk = __fadd_rn(__fsub_rn(src[o + 1], a2), src[o - 1]);
          v = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(0.125f, di), __fmul_rn(0.125f, dj)),
                                  __fmul_rn(0.125f, dk)),
                        a);
        }
        if (s == H) {
          if (gi < p.n0 && gj < p.n1 && gk < p.n2)
            p.out[(size_t)gi * s0 + (size_t)gj * p.n2 + gk] = v;
        } else {
          dst[o] = v;
        }
      }
    }
    if (s < H) __syncthreads();
    src = dst;
  }
}

// All passes of one call: the last pass writes O, the one before it T, and
// so on back, the first reading A.
template <int H>
cudaError_t run_passes(const float* A, float* O, float* T, int n0, int n1, int n2, int bi,
                       int passes, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(heat3d_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((n2 + TK - 1) / TK, (n1 + TJ - 1) / TJ, (n0 + bi - 1) / bi);
  const float* src = A;
  for (int q = 0; q < passes; ++q) {
    float* dst = (passes - 1 - q) % 2 == 0 ? O : T;
    heat3d_kernel<H><<<grid, THREADS, smem, stream>>>(Args{src, dst, n0, n1, n2, bi});
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" long long heat3d_smem_bytes(int bi, int fuse_t) {
  if (bi < 1 || fuse_t < 1 || fuse_t > 2) return -1;
  return (long long)sizeof(float) * layout(bi, fuse_t).floats;
}

extern "C" int heat3d_launch(const void* A, void* O, void* T, int n0, int n1, int n2, int bi,
                             int fuse_t, int passes, void* stream) {
  const long long smem = heat3d_smem_bytes(bi, fuse_t);
  if (smem < 0 || n0 < 1 || n1 < 1 || n2 < 1 || passes < 1) return (int)cudaErrorInvalidValue;
  const float* a = (const float*)A;
  float *o = (float*)O, *t = (float*)T;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(fuse_t == 2 ? run_passes<2>(a, o, t, n0, n1, n2, bi, passes, smem, s)
                           : run_passes<1>(a, o, t, n0, n1, n2, bi, passes, smem, s));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
