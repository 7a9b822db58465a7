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
// matmul.cu does (the f32 tolerances rule out TF32 tensor cores).
//
// Design: the shared main loop of gemm_f32.cuh, and one product per pair of
// mirrored elements, as syr2k.cu. The grid is one block per bi x bj tile of
// O; a block whose rectangle lies wholly above the diagonal (its last row
// min((ti+1)*bi, M) - 1 before its first column tj*bj) exits at once. Every
// other block computes its rows r and columns c, writes O[r][c] for r >= c
// from registers and O[c][r] for r > c through shared memory (the ring,
// reused after the main loop, so the transposed store is coalesced). Each
// element of O is written exactly once, by the block that holds it at (max,
// min) of its indices: at 64 x 64 tiles and LARGE, 190 of 361 blocks work,
// and the FFMA count falls from 2*M^2*N to 2*N*64^2*190 = 2.18 GFLOP, 1.08x
// the bound's M(M+1)*N (the diagonal tiles compute their upper half too, and
// the ragged last tile is padded to 64).
// Both operands are column slabs of row-major D: chunk c of the i slab is
// rows [c*bk, c*bk + kc) of D, columns [i0, i0 + pi), n-contiguous, staged
// as they lie (as matmul.cu stages its B) by cp.async in coalesced 16-byte
// pieces (4-byte pieces where D, M, bi or bj is off 16-byte words) into a
// ring whose depth follows the device's shared memory (gemm::ring_stages):
// three stages, or up to six where a stage is small (six of 16 KB at the
// default 64 x 64 x 32, 97 KB with the means, two blocks an SM). A chunk
// holds one product's multiply-adds, half of a syr2k chunk's, so three
// 32-row stages left too few copies in flight to cover their latency. Tiles are padded to multiples of 8; (pi/RT) x (pj/RT)
// threads each own an RT x RT register tile (RT = 4 up to 64-wide tiles, 8
// past), four contiguous rows and four contiguous columns per group of four,
// so every operand read is one float4 and a 64 x 64 tile runs 8 FFMA per
// shared-memory load. The knobs change the generated code:
//   FUSE_CENTER subtract mu from the values of each chunk in shared memory:
//               the block stages its columns' means once, before the loop,
//               and each thread centres the pieces of chunk c that it copied
//               itself, after its cp.async.wait_group (which makes its own
//               copies visible to it) and before the ring's barrier (which
//               publishes them); without it the wrapper centres D in a
//               separate pass first and the kernel stages the values as
//               they are. Either way the product runs on d - mu, rounded
//               once, as _cov_kernel does (di - mi_ref).
//   INTERCHANGE which tile axis blockIdx.x walks (the raster order): j by
//               default, as the TPU grid (i, j, k) runs j fastest; i with it.
// Rows past N are not staged and columns past M are zero-filled and never
// centred, so they stay exact zeros; the TPU kernel pads M to lcm(bi, bj)
// and fills padded rows with the means. Every element is summed with k
// ascending, one fmaf(d[k][max], d[k][min], .) per term, N never split
// across blocks, then divided by N - 1: its bits do not depend on bi, bj,
// bk, the raster or the ring's depth, and O is exactly symmetric.
//
// Interface: covariance_smem_bytes() gives the dynamic shared memory a block
// needs for a tile under a device limit (the ring as deep as fits, -1 for a
// tile past 128), from the same layout() the launcher passes the kernel; the
// wrapper checks it against the limit before launch. covariance_launch()
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError(). Tile extents, the ring's depth and interchange are
// runtime values; FUSE_CENTER, RT and the copy form are template parameters
// (8 instantiations).

#include "gemm_f32.cuh"

namespace {

// Ring bytes below which small stages deepen the ring: two blocks an SM
constexpr long long RING_BUDGET = 110 * 1024;

// Shared-memory layout of one block: the column means of the i and j slabs
// (pi + pj floats), then `stages` stages of [i slab | j slab], each bk rows
// of pi (pj) floats; after the main loop the memory from offset 0 holds the
// pi x (pj + 1) f32 tile of O for the transposed store.
struct Layout {
  int pi, pj, rt;           // padded tile extents, register tile edge
  int mean;                 // bytes of the means, where the ring starts
  int j;                    // offset of the j slab in a stage, bytes
  int stage, stages;
  long long bytes;          // total dynamic shared memory
};

Layout layout(int bi, int bj, int bk, long long limit) {
  Layout L;
  L.pi = gemm::round_up(bi, gemm::ALIGN);
  L.pj = gemm::round_up(bj, gemm::ALIGN);
  L.rt = gemm::reg_tile(L.pi, L.pj);
  L.mean = 4 * (L.pi + L.pj);  // a multiple of 64 bytes
  L.j = bk * 4 * L.pi;
  L.stage = L.j + bk * 4 * L.pj;
  const long long epi = 4LL * L.pi * (L.pj + 1);
  // three stages as deep as the limit allows, or more small ones (up to
  // six) within RING_BUDGET, so that a short chunk's copies are issued far
  // enough ahead and two blocks still share an SM
  const int deep = gemm::ring_stages(L.stage, epi - L.mean, RING_BUDGET - L.mean,
                                     gemm::MAX_DEEP_STAGES);
  L.stages = gemm::ring_stages(L.stage, epi - L.mean, limit - L.mean);
  if (deep > L.stages && L.mean + (long long)deep * L.stage <= limit) L.stages = deep;
  const long long ring = L.mean + (long long)L.stages * L.stage;
  L.bytes = ring > epi ? ring : epi;
  return L;
}

struct Args {
  const float* D; const float* mean; float* O;
  int N, M, bi, bj, bk, interchange;
  Layout L;
};

// Subtract mean[c] from the pieces of the box of plan q (rows `pitch` bytes
// apart) that this thread copied: the same pieces, in the same order, as
// gemm::copy_box. Columns from cols_v on were zero-filled and stay zeros.
template <bool VEC16>
__device__ __forceinline__ void center_box(const gemm::Plan& q, char* s, int pitch,
                                           const float* mean, int cols_v, int tid,
                                           int nthreads) {
  constexpr int E = VEC16 ? 4 : 1;
  int r = q.r, pc = q.p;
  for (int i = tid; i < q.total; i += nthreads) {
    const int c = pc * E;
    if (c < cols_v) {
      float* x = reinterpret_cast<float*>(s + r * pitch) + c;
      if constexpr (VEC16) {
        float4 v = *reinterpret_cast<float4*>(x);
        v.x -= mean[c]; v.y -= mean[c + 1]; v.z -= mean[c + 2]; v.w -= mean[c + 3];
        *reinterpret_cast<float4*>(x) = v;
      } else {
        *x -= mean[c];
      }
    }
    pc += q.dp;
    r += q.dr;
    if (pc >= q.per_row) { pc -= q.per_row; ++r; }
  }
}

template <bool FUSE, int RT, bool VEC16>
__global__ void __launch_bounds__(gemm::MAX_THREADS) covariance_kernel(Args p) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout& L = p.L;
  const int ti = p.interchange ? blockIdx.x : blockIdx.y;
  const int tj = p.interchange ? blockIdx.y : blockIdx.x;
  const int i0 = ti * p.bi, j0 = tj * p.bj;
  if (min(i0 + p.bi, p.M) - 1 < j0) return;  // wholly above the diagonal
  const int TY = L.pi / RT, TX = L.pj / RT, nthreads = TY * TX;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid - ty * TX;
  // columns of each slab inside D (the padding and the columns past M are
  // zero-filled)
  const int vi = min(L.pi, p.M - i0), vj = min(L.pj, p.M - j0);
  float* sMi = reinterpret_cast<float*>(smem);
  float* sMj = sMi + L.pi;
  char* ring = smem + L.mean;

  if (FUSE) {  // the means, before the first chunk is centred
    for (int c = tid; c < L.pi; c += nthreads) sMi[c] = c < vi ? p.mean[i0 + c] : 0.f;
    for (int c = tid; c < L.pj; c += nthreads) sMj[c] = c < vj ? p.mean[j0 + c] : 0.f;
    __syncthreads();
  }

  float acc[RT][RT];
#pragma unroll
  for (int u = 0; u < RT; ++u)
#pragma unroll
    for (int v = 0; v < RT; ++v) acc[u][v] = 0.f;

  // a chunk is kc rows of each slab; a ragged last chunk plans anew
  const gemm::Plan plan_i = gemm::plan_box<float, VEC16>(p.bk, L.pi, tid, nthreads);
  const gemm::Plan plan_j = gemm::plan_box<float, VEC16>(p.bk, L.pj, tid, nthreads);
  auto rows = [&](int c) { return min(p.bk, p.N - c * p.bk); };
  auto plan_i_of = [&](int kc) {
    return kc == p.bk ? plan_i : gemm::plan_box<float, VEC16>(kc, L.pi, tid, nthreads);
  };
  auto plan_j_of = [&](int kc) {
    return kc == p.bk ? plan_j : gemm::plan_box<float, VEC16>(kc, L.pj, tid, nthreads);
  };
  auto load = [&](int c, int slot) {
    char* s = ring + slot * L.stage;
    const int kc = rows(c);
    const float* X = p.D + (size_t)c * p.bk * p.M;
    gemm::copy_box<float, VEC16>(plan_i_of(kc), s, 4 * L.pi, X + i0, p.M, kc, vi, tid, nthreads);
    gemm::copy_box<float, VEC16>(plan_j_of(kc), s + L.j, 4 * L.pj, X + j0, p.M, kc, vj, tid,
                                 nthreads);
  };
  auto landed = [&](int c, int slot) {
    if (!FUSE) return;
    char* s = ring + slot * L.stage;
    const int kc = rows(c);
    center_box<VEC16>(plan_i_of(kc), s, 4 * L.pi, sMi, vi, tid, nthreads);
    center_box<VEC16>(plan_j_of(kc), s + L.j, 4 * L.pj, sMj, vj, tid, nthreads);
  };

  // this thread's rows 4ty + 4TY*h + w and columns 4tx + 4TX*h + w
  auto row = [&](int u) { return 4 * ty + 4 * TY * (u / 4) + u % 4; };
  auto col = [&](int v) { return 4 * tx + 4 * TX * (v / 4) + v % 4; };

  auto compute = [&](int c, int slot) {
    const float* sI = reinterpret_cast<const float*>(ring + slot * L.stage) + 4 * ty;
    const float* sJ = reinterpret_cast<const float*>(ring + slot * L.stage + L.j) + 4 * tx;
    const int kc = rows(c);
#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      float a[RT], b[RT];
#pragma unroll
      for (int h = 0; h < RT / 4; ++h) {
        float q[4];
        gemm::unpack(q, gemm::load4(sI + k * L.pi + 4 * TY * h));
#pragma unroll
        for (int w = 0; w < 4; ++w) a[4 * h + w] = q[w];
        gemm::unpack(q, gemm::load4(sJ + k * L.pj + 4 * TX * h));
#pragma unroll
        for (int w = 0; w < 4; ++w) b[4 * h + w] = q[w];
      }
#pragma unroll
      for (int u = 0; u < RT; ++u)
#pragma unroll
        for (int v = 0; v < RT; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
  };

  gemm::run_ring((p.N + p.bk - 1) / p.bk, L.stages, load, landed, compute);

  // the tile into shared memory for the transposed store, and O[r][c] for
  // r >= c straight from the registers
  const float denom = (float)(p.N - 1);
  const int pitch_t = L.pj + 1;  // floats; odd, so column reads are conflict-free
  float* sT = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int u = 0; u < RT; ++u) {
    const int r = row(u), gr = i0 + r;
#pragma unroll
    for (int v = 0; v < RT; ++v) {
      const int c = col(v), gc = j0 + c;
      const float o = acc[u][v] / denom;
      sT[r * pitch_t + c] = o;
      if (r < p.bi && gr < p.M && c < p.bj && gc <= gr) p.O[(size_t)gr * p.M + gc] = o;
    }
  }
  __syncthreads();
  // O[c][r] for r > c: consecutive threads take consecutive r, so the store
  // runs along a row of O
  for (int idx = tid; idx < L.pi * L.pj; idx += nthreads) {
    const int c = idx / L.pi, r = idx - c * L.pi, gr = i0 + r, gc = j0 + c;
    if (r < p.bi && c < p.bj && gr < p.M && gc < gr)
      p.O[(size_t)gc * p.M + gr] = sT[r * pitch_t + c];
  }
}

template <bool FUSE, int RT, bool V16>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  const int ni = (p.M + p.bi - 1) / p.bi, nj = (p.M + p.bj - 1) / p.bj;
  const dim3 grid = p.interchange ? dim3(ni, nj) : dim3(nj, ni);
  const int threads = (p.L.pi / RT) * (p.L.pj / RT);
  static long long done[16] = {};
  const cudaError_t e = gemm::allow_smem(covariance_kernel<FUSE, RT, V16>, p.L.bytes, done);
  if (e != cudaSuccess) return e;
  covariance_kernel<FUSE, RT, V16><<<grid, threads, p.L.bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool FUSE>
cudaError_t launch_rt(const Args& p, bool vec16, cudaStream_t s) {
  if (p.L.rt == 8) return vec16 ? launch<FUSE, 8, true>(p, s) : launch<FUSE, 8, false>(p, s);
  return vec16 ? launch<FUSE, 4, true>(p, s) : launch<FUSE, 4, false>(p, s);
}

}  // namespace

extern "C" long long covariance_smem_bytes(int bi, int bj, int bk, int limit) {
  if (bi < 1 || bj < 1 || bk < 1 || bi > gemm::MAX_TILE || bj > gemm::MAX_TILE) return -1;
  return layout(bi, bj, bk, limit).bytes;
}

extern "C" int covariance_launch(const void* data, const void* mean, void* O, int N, int M,
                                 int bi, int bj, int bk, int fuse_center, int interchange,
                                 int limit, void* stream) {
  const long long smem = covariance_smem_bytes(bi, bj, bk, limit);
  if (smem < 0 || smem > limit || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  // 16-byte pieces: an aligned base, and rows and tile origins on whole
  // 16-byte words (M, bi and bj multiples of 4), so that no piece straddles
  // a tile edge or M
  const bool vec16 = gemm::aligned16(data) && M % 4 == 0 && bi % 4 == 0 && bj % 4 == 0;
  Args p{(const float*)data, (const float*)mean, (float*)O, N, M, bi, bj, bk, interchange,
         layout(bi, bj, bk, limit)};
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = fuse_center ? launch_rt<true>(p, vec16, s)
                                    : launch_rt<false>(p, vec16, s);
  return (int)e;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
