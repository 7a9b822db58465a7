// syr2k on Hopper: O = beta*C + alpha*(A*B^T + B*A^T), A and B N x M, C N x N, f32.
//
// Replaces: src/repro/kernels/syr2k.py:_syr2k_kernel (the Pallas TPU kernel
// behind repro.kernels.syr2k.syr2k, the paper's Sec. 4.1 case study).
//
// What bounds it on an H100: the function needs one product, since
// S = A*B^T + B*A^T is symmetric: at the paper's LARGE size (N=1200, M=1000)
// that is 2*N^2*M = 2.88 GFLOP of f32 multiply-adds, 43 us at the 67 TFLOP/s
// f32 rate of the CUDA cores, against 21 MB of compulsory traffic (A, B, C
// read once, O written once), 6 us at 3.35 TB/s. So it is compute-bound, on
// the CUDA cores: the reference and the JAX suite hold syr2k to 5e-3, and a
// TF32 tensor-core sum over M=1000 terms keeps about three digits, so the
// kernel stays in full f32 FFMA on purpose.
//
// Design: the shared main loop of gemm_f32.cuh, and one product per pair of
// mirrored elements. The grid is one block per bi x bj tile of O, but a block
// whose rectangle lies wholly above the diagonal (its last row
// min((ti+1)*bi, N) - 1 before its first column tj*bj) exits at once. Every
// other block computes S[r][c] = sum_k fmaf(A[r]B[c], fmaf(B[r]A[c], .)) for
// its rows r and columns c, k ascending, and writes O[r][c] for r >= c from
// registers and O[c][r] for r > c through shared memory (the ring, reused
// after the main loop, so both the transposed store and its read of C are
// coalesced). Each element of O is written exactly once, by the block that
// holds it at (max, min) of its indices, so its bits do not depend on bi, bj,
// bk, the raster or the ring, and the FFMA count falls from 4*N^2*M to about
// 2*N^2*M plus the masked half of the diagonal blocks.
// Tiles are padded to multiples of 8; (pi/RT) x (pj/RT) threads each own an
// RT x RT register tile (RT = 4 up to 64-wide tiles, 8 past), at rows
// ty + TY*u and columns tx + TX*v, interleaved, so that a warp's float4 reads
// of the k-contiguous chunks (four k of one row each) and its stores of O
// are free of bank conflicts and coalesced. The schedule knobs:
//   PACK_A      stage the A_i and A_j chunks (pi and pj rows of bk k-
//               contiguous floats) in the ring by cp.async, so the inner loop
//               reads each A value from shared memory; without it the inner
//               loop reads A from global memory (float4 along k where
//               aligned, through L1/L2).
//   PACK_B      the same for B_i and B_j.
//   interchange which tile axis blockIdx.x walks (the raster order): j by
//               default, as the TPU grid (i, j, k) runs j fastest; i with it.
// Ragged edges (N not a multiple of bi or bj, M not a multiple of bk) are
// zero-filled while staged and masked when stored; there is no padding of N
// to lcm(bi, bj) as the TPU BlockSpecs need.
//
// Interface: syr2k_smem_bytes() gives the dynamic shared memory a block needs
// for a tile and knobs under a device limit (the ring as deep as fits, -1 for
// a tile past 128), from the same layout() the launcher passes the kernel;
// the wrapper checks it against the limit before launch. syr2k_launch()
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError(). Tile extents, the ring's depth and interchange are
// runtime values; PACK_A, PACK_B, RT and the copy form are template
// parameters (16 instantiations).

#include "gemm_f32.cuh"

namespace {

// Shared-memory layout of one block: `stages` stages of [A_i | A_j] if
// PACK_A, then [B_i | B_j] if PACK_B, each chunk pi (pj) rows `pitch` bytes
// apart; after the main loop the same memory holds the pi x (pj + 1) f32
// tile of S for the transposed store.
struct Layout {
  int pi, pj, rt;           // padded tile extents, register tile edge
  int pitch;                // row pitch of a chunk, bytes
  int ai, aj, bi, bj;       // offsets of the four chunks in a stage, bytes
  int stage, stages;
  long long bytes;          // total dynamic shared memory
};

Layout layout(int bi, int bj, int bk, bool pack_a, bool pack_b, long long limit) {
  Layout L;
  L.pi = gemm::round_up(bi, gemm::ALIGN);
  L.pj = gemm::round_up(bj, gemm::ALIGN);
  L.rt = gemm::reg_tile(L.pi, L.pj);
  L.pitch = gemm::kpitch(bk, 4);
  const int ci = L.pi * L.pitch, cj = L.pj * L.pitch;
  L.ai = 0;
  L.aj = L.ai + (pack_a ? ci : 0);
  L.bi = L.aj + (pack_a ? cj : 0);
  L.bj = L.bi + (pack_b ? ci : 0);
  L.stage = L.bj + (pack_b ? cj : 0);
  const long long epi = 4LL * L.pi * (L.pj + 1);
  L.stages = gemm::ring_stages(L.stage, epi, limit);
  L.bytes = (long long)L.stages * L.stage > epi ? (long long)L.stages * L.stage : epi;
  return L;
}

struct Args {
  const float* C; const float* A; const float* B; float* O;
  int N, M; float alpha, beta; int bi, bj, bk, interchange;
  Layout L;
};

// O's element from S: beta*C + alpha*S, one explicit rounding pattern in
// every instantiation and both store paths
__device__ __forceinline__ float blend(float alpha, float beta, float c, float s) {
  return fmaf(alpha, s, beta * c);
}

template <bool PACK_A, bool PACK_B, int RT, bool VEC16>
__global__ void __launch_bounds__(gemm::MAX_THREADS) syr2k_kernel(Args p) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout& L = p.L;
  const int ti = p.interchange ? blockIdx.x : blockIdx.y;
  const int tj = p.interchange ? blockIdx.y : blockIdx.x;
  const int i0 = ti * p.bi, j0 = tj * p.bj;
  if (min(i0 + p.bi, p.N) - 1 < j0) return;  // wholly above the diagonal
  const int TY = L.pi / RT, TX = L.pj / RT, nthreads = TY * TX;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid - ty * TX;

  float acc[RT][RT];
#pragma unroll
  for (int u = 0; u < RT; ++u)
#pragma unroll
    for (int v = 0; v < RT; ++v) acc[u][v] = 0.f;

  // the i chunks are pi rows of kcp k, the j chunks pj rows (kcp = bk
  // rounded up to 4, less in a ragged last chunk, which plans anew)
  const int kfull = gemm::round_up(p.bk, 4);
  const gemm::Plan plan_i = gemm::plan_box<float, VEC16>(L.pi, kfull, tid, nthreads);
  const gemm::Plan plan_j = gemm::plan_box<float, VEC16>(L.pj, kfull, tid, nthreads);
  auto load = [&](int c, int slot) {
    char* s = smem + slot * L.stage;
    const int k0 = c * p.bk, kc = min(p.bk, p.M - k0), kcp = gemm::round_up(kc, 4);
    const int vi = min(L.pi, p.N - i0), vj = min(L.pj, p.N - j0);
    const bool full = kcp == kfull;
    const gemm::Plan qi = full ? plan_i : gemm::plan_box<float, VEC16>(L.pi, kcp, tid, nthreads);
    const gemm::Plan qj = full ? plan_j : gemm::plan_box<float, VEC16>(L.pj, kcp, tid, nthreads);
    if (PACK_A) {
      gemm::copy_box<float, VEC16>(qi, s + L.ai, L.pitch, p.A + (size_t)i0 * p.M + k0, p.M,
                                   vi, kc, tid, nthreads);
      gemm::copy_box<float, VEC16>(qj, s + L.aj, L.pitch, p.A + (size_t)j0 * p.M + k0, p.M,
                                   vj, kc, tid, nthreads);
    }
    if (PACK_B) {
      gemm::copy_box<float, VEC16>(qi, s + L.bi, L.pitch, p.B + (size_t)i0 * p.M + k0, p.M,
                                   vi, kc, tid, nthreads);
      gemm::copy_box<float, VEC16>(qj, s + L.bj, L.pitch, p.B + (size_t)j0 * p.M + k0, p.M,
                                   vj, kc, tid, nthreads);
    }
  };

  // this thread's rows and columns, clamped into range for the unstaged
  // reads (rows past N feed only elements that are never stored)
  auto grow = [&](int u) { return min(i0 + ty + TY * u, p.N - 1); };
  auto gcol = [&](int v) { return min(j0 + tx + TX * v, p.N - 1); };

  auto compute = [&](int c, int slot) {
    const char* s = smem + slot * L.stage;
    const int k0 = c * p.bk, kc = min(p.bk, p.M - k0), kcp = gemm::round_up(kc, 4);
    const float* sAi = reinterpret_cast<const float*>(s + L.ai + ty * L.pitch);
    const float* sAj = reinterpret_cast<const float*>(s + L.aj + tx * L.pitch);
    const float* sBi = reinterpret_cast<const float*>(s + L.bi + ty * L.pitch);
    const float* sBj = reinterpret_cast<const float*>(s + L.bj + tx * L.pitch);
    const int ui = TY * L.pitch / 4, uj = TX * L.pitch / 4;  // floats between owned rows
#pragma unroll 1
    for (int k = 0; k < kcp; k += 4) {
      float ai[RT][4], bi[RT][4];
#pragma unroll
      for (int u = 0; u < RT; ++u) {
        const size_t g = (size_t)grow(u) * p.M + k0 + k;
        gemm::unpack(ai[u], PACK_A ? gemm::load4(sAi + u * ui + k)
                                   : gemm::ldg4<VEC16>(p.A + g, kc - k));
        gemm::unpack(bi[u], PACK_B ? gemm::load4(sBi + u * ui + k)
                                   : gemm::ldg4<VEC16>(p.B + g, kc - k));
      }
#pragma unroll
      for (int q = 0; q < RT / 4; ++q) {  // four columns at a time
        float aj[4][4], bj[4][4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int v = 4 * q + w;
          const size_t g = (size_t)gcol(v) * p.M + k0 + k;
          gemm::unpack(aj[w], PACK_A ? gemm::load4(sAj + v * uj + k)
                                     : gemm::ldg4<VEC16>(p.A + g, kc - k));
          gemm::unpack(bj[w], PACK_B ? gemm::load4(sBj + v * uj + k)
                                     : gemm::ldg4<VEC16>(p.B + g, kc - k));
        }
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int u = 0; u < RT; ++u)
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              float& a = acc[u][4 * q + w];
              a = fmaf(ai[u][t], bj[w][t], fmaf(bi[u][t], aj[w][t], a));
            }
      }
    }
  };

  gemm::run_ring((p.M + p.bk - 1) / p.bk, L.stages, load, compute);

  // S into shared memory for the transposed store, and O[r][c] for r >= c
  // straight from the registers (coalesced along tx)
  const int pitch_t = L.pj + 1;  // floats; odd, so column reads are conflict-free
  float* sT = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int u = 0; u < RT; ++u) {
    const int r = ty + TY * u, gr = i0 + r;
#pragma unroll
    for (int v = 0; v < RT; ++v) {
      const int c = tx + TX * v, gc = j0 + c;
      sT[r * pitch_t + c] = acc[u][v];
      if (r < p.bi && gr < p.N && c < p.bj && gc <= gr) {
        const size_t o = (size_t)gr * p.N + gc;
        p.O[o] = blend(p.alpha, p.beta, __ldg(p.C + o), acc[u][v]);
      }
    }
  }
  __syncthreads();
  // O[c][r] for r > c: consecutive threads take consecutive r, so the read
  // of C and the store of O run along a row of O
  for (int idx = tid; idx < L.pi * L.pj; idx += nthreads) {
    const int c = idx / L.pi, r = idx - c * L.pi, gr = i0 + r, gc = j0 + c;
    if (r < p.bi && c < p.bj && gr < p.N && gc < gr) {
      const size_t o = (size_t)gc * p.N + gr;
      p.O[o] = blend(p.alpha, p.beta, __ldg(p.C + o), sT[r * pitch_t + c]);
    }
  }
}

template <bool PA, bool PB, int RT, bool V16>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  const int ni = (p.N + p.bi - 1) / p.bi, nj = (p.N + p.bj - 1) / p.bj;
  const dim3 grid = p.interchange ? dim3(ni, nj) : dim3(nj, ni);
  const int threads = (p.L.pi / RT) * (p.L.pj / RT);
  if (p.L.bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(syr2k_kernel<PA, PB, RT, V16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.L.bytes);
    if (e != cudaSuccess) return e;
  }
  syr2k_kernel<PA, PB, RT, V16><<<grid, threads, p.L.bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool PA, bool PB>
cudaError_t launch_rt(const Args& p, bool vec16, cudaStream_t s) {
  if (p.L.rt == 8) return vec16 ? launch<PA, PB, 8, true>(p, s) : launch<PA, PB, 8, false>(p, s);
  return vec16 ? launch<PA, PB, 4, true>(p, s) : launch<PA, PB, 4, false>(p, s);
}

}  // namespace

extern "C" long long syr2k_smem_bytes(int bi, int bj, int bk, int pack_a, int pack_b,
                                      int limit) {
  if (bi < 1 || bj < 1 || bk < 1 || bi > gemm::MAX_TILE || bj > gemm::MAX_TILE) return -1;
  return layout(bi, bj, bk, pack_a, pack_b, limit).bytes;
}

extern "C" int syr2k_launch(const void* C, const void* A, const void* B, void* O,
                            int N, int M, float alpha, float beta, int bi, int bj, int bk,
                            int pack_a, int pack_b, int interchange, int limit,
                            void* stream) {
  const long long smem = syr2k_smem_bytes(bi, bj, bk, pack_a, pack_b, limit);
  if (smem < 0 || smem > limit) return (int)cudaErrorInvalidValue;
  // 16-byte pieces (and float4 reads of unstaged rows): aligned bases, and
  // rows and chunk steps of whole 16-byte words
  const bool vec16 = gemm::aligned16(A) && gemm::aligned16(B) && M % 4 == 0 && bk % 4 == 0;
  Args p{(const float*)C, (const float*)A, (const float*)B, (float*)O,
         N, M, alpha, beta, bi, bj, bk, interchange,
         layout(bi, bj, bk, pack_a, pack_b, limit)};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (pack_a && pack_b) e = launch_rt<true, true>(p, vec16, s);
  else if (pack_a)      e = launch_rt<true, false>(p, vec16, s);
  else if (pack_b)      e = launch_rt<false, true>(p, vec16, s);
  else                  e = launch_rt<false, false>(p, vec16, s);
  return (int)e;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
