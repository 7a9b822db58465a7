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
// the CUDA cores; there is no tensor-core form of (min, +). FMNMX issues at
// 64 results per clock and SM (half the FADD rate), and the two instructions
// fill every issue slot, so the card does at most 64 relaxations per clock
// and SM: 16.75e12 a second. One trailing update at the paper's LARGE size
// (N = 2800 padded to 2816, bs = 64) is 5.07e8 relaxations, 30.3 us, against
// 63 MB of D read and O written (19 us at 3.35 TB/s): compute-bound, and
// every instruction that is not an FADD or an FMNMX costs a relaxation's
// issue slot.
//
// Design of the min-plus kernel: gemm_f32.cuh's main loop (the one matmul,
// syr2k and covariance run) with (min, +) in place of fmaf. A is a row-major,
// k-contiguous n x bs operand and B a row-major, n-contiguous bs x m one,
// exactly matmul's A and B, each with its own leading dimension (as are D
// and O), so the blocked driver passes views of its distance matrix and
// copies nothing.
//   * One block per bi x bj tile of O. The tile is padded to a multiple of
//     the register tile only (a 24-row tile costs 24 rows, not 64): each
//     of (pm/TM) x (pn/TN) threads, at most 256, holds TM x TN running
//     minima, 4 x 4 below 64 x 64 (the panels and short tiles: more threads,
//     less work each), 8 x 4 from 64 x 64 (fewer shared-memory reads a
//     relaxation; the default 64 x 64 tile is 128 threads), 8 x 8 where 8 x 4
//     would need more than 256 threads. Thread (ty, tx) owns rows ty + TY*u
//     (interleaved, so a warp's reads of A's k-contiguous rows fall in
//     distinct bank quads) and columns 4tx + 4TX*h + w (four contiguous per
//     group). A tile extent may reach 256, so a panel of phase 2 can be one
//     tile across its whole bs side (256 x 16 at bs = 256: 256 threads).
//   * The running minima start from D, read as float4 (one 16-byte load per
//     row and column group; coalesced across tx), and O is stored as float4,
//     where D, O, their leading dimensions and bj are whole 16-byte words;
//     otherwise element by element. D is read with plain (coherent) loads,
//     since a panel's D is also the O it writes.
//   * The bs-wide contraction streams through gemm::run_ring in chunks of
//     KC = 32 k, copied by cp.async in coalesced 16-byte pieces
//     (gemm::copy_box; 4-byte pieces where A, B, their leading dimensions,
//     bs, m or bj are off 16-byte words), the ring as deep as the chunks
//     (bs = 64: both chunks in flight at once) and the device's shared memory
//     allow (gemm::ring_stages, at most three). Rows of A's chunk are padded
//     to an odd number of 16-byte words (gemm::kpitch). Unlike a sum, min-plus
//     has no neutral zero, so the loop runs exactly over the valid k of a
//     chunk: the copies' zero fill past bs is never read.
//   * Per read of W consecutive k of A's TM rows (W = min(UNROLL, 4): one
//     float4 a row at W = 4) and of B's TN columns of each of those k (TN/4
//     float4 a k), 2 * TM * TN * W relaxation instructions: at the 64 x 64
//     default (8 x 4, UNROLL = 4) 12 shared-memory reads for 256 FADD/FMNMX
//     per four k.
//   * Tried and dropped (slower on the card): one wave of persistent blocks
//     streaming each tile's D and chunks through one ring across tiles; an
//     8 x 8 register tile at 64 x 64 (64 threads a block); 4 x 4 at 64 x 64.
// The schedule knob changes the code:
//   UNROLL      the unroll factor of the k loop (1, 2, 4, 8), a template
//               parameter: one iteration relaxes UNROLL k, reading A W = min
//               (UNROLL, 4) k at a time (a 4-, 8- or 16-byte read a row), so
//               UNROLL = 8 is two float4 steps an iteration; a rolled
//               remainder loop takes the last k of a chunk one at a time.
// Ragged edges are masked (rows past n or bi and columns past m or bj are
// neither staged from outside the tile nor stored). In place: O may be D
// itself when no block reads another block's tile of it, as in the blocked
// driver's panels: the row panel (A the diagonal block's copy, B = D = O,
// one tile spanning all bs rows) and the column panel (A = D = O, B the
// copy, one tile spanning all bs columns). A block reads all of its D, A and
// B before it stores (run_ring returns after every copy has landed and every
// thread is past the last chunk), and its tile is the only part of O it
// reads. Min is exact and each candidate a_ik + b_kj is one rounded add, so
// the result does not depend on tiles, chunks or order: it equals the plain
// version bit for bit.
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
// of the min-plus kernel needs for a tile and contraction width under a
// device limit (-1 for a tile past 256 or past 256 threads), from the same
// layout() the launcher passes the kernel. minplus_launch() and
// closure_launch() launch on the given stream, do not synchronise, and
// return cudaGetLastError(). The register tile (4 x 4, 8 x 4, 8 x 8),
// UNROLL and the copy form are template parameters of the min-plus kernel
// (24 instantiations).

#include "gemm_f32.cuh"

namespace {

constexpr int KC = 32;             // contraction chunk streamed through the ring
constexpr int MAX_EXTENT = 256;    // largest (padded) tile extent
constexpr int MAX_THREADS = 256;
constexpr int CT = 32;             // closure helper: CT x CT threads
constexpr int CLOSURE_SMEM_BS = 128;  // widest closure block held in shared memory

// Shared-memory layout of one min-plus block: `stages` stages, each A's
// chunk (pm rows of kfull k, pitch_a bytes apart) then B's (kfull rows of pn
// columns, pitch_b bytes apart).
struct Layout {
  int tm, tn;              // register tile: tm rows x tn columns a thread
  int pm, pn;              // tile extents padded to tm, tn
  int threads;
  int kfull;               // k of a full chunk
  int pitch_a, pitch_b;    // row pitches, bytes
  int a_bytes, stage, stages;
  long long bytes;
};

Layout layout(int bi, int bj, int bs, long long limit) {
  Layout L;
  // 4 x 4 for tiles below 64 x 64 (the panels, short tiles: more threads,
  // less work each); 8 x 4 from 64 x 64 (fewer shared-memory reads a
  // relaxation), 8 x 8 where 8 x 4 would need more than 256 threads
  auto threads = [&](int tm, int tn) {
    return (gemm::round_up(bi, tm) / tm) * (gemm::round_up(bj, tn) / tn);
  };
  L.tm = L.tn = 4;
  if (bi >= 64 && bj >= 64) L.tm = 8;
  if (threads(L.tm, L.tn) > MAX_THREADS) L.tm = L.tn = 8;
  L.pm = gemm::round_up(bi, L.tm);
  L.pn = gemm::round_up(bj, L.tn);
  L.threads = threads(L.tm, L.tn);
  L.kfull = bs < KC ? bs : KC;
  L.pitch_a = gemm::kpitch(L.kfull, 4);
  L.pitch_b = 4 * L.pn;
  L.a_bytes = L.pm * L.pitch_a;
  L.stage = L.a_bytes + L.kfull * L.pitch_b;
  const int nchunks = (bs + KC - 1) / KC;
  L.stages = gemm::ring_stages(L.stage, 0, limit,
                               nchunks < gemm::MAX_STAGES ? nchunks : gemm::MAX_STAGES);
  L.bytes = (long long)L.stages * L.stage;
  return L;
}

struct Args {
  const float* D; const float* A; const float* B; float* O;
  int ldd, lda, ldb, ldo;
  int n, m, bs, bi, bj;
  int vec_io;  // float4 reads of D and stores of O
  Layout L;
};

// W consecutive floats of a staged A row (W = 1, 2 or 4; 4W-byte aligned)
template <int W>
__device__ __forceinline__ void load_w(const char* p, float (&x)[W]) {
  if constexpr (W == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else if constexpr (W == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x; x[1] = q.y;
  } else {
    x[0] = *reinterpret_cast<const float*>(p);
  }
}

// Relax the register tile over k .. k + W - 1: A's rows at pa + u * ua
// (bytes), B's row k at pb + k * ldb_s (floats), column group h hb floats on.
template <int TM, int TN, int W>
__device__ __forceinline__ void relax(float (&acc)[TM][TN], const char* pa, int ua,
                                      const float* pb, int ldb_s, int hb, int k) {
  float a[TM][W];
#pragma unroll
  for (int u = 0; u < TM; ++u) load_w<W>(pa + u * ua + 4 * k, a[u]);
#pragma unroll
  for (int t = 0; t < W; ++t) {
    float b[TN];
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const float4 q = *reinterpret_cast<const float4*>(pb + (k + t) * ldb_s + h * hb);
      b[4 * h] = q.x; b[4 * h + 1] = q.y; b[4 * h + 2] = q.z; b[4 * h + 3] = q.w;
    }
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v) acc[u][v] = fminf(acc[u][v], a[u][t] + b[v]);
  }
}

template <int TM, int TN, int UNROLL, bool VEC16>
__global__ void __launch_bounds__(MAX_THREADS) minplus_kernel(Args p) {
  constexpr int W = UNROLL < 4 ? UNROLL : 4;  // k per read of A
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout& L = p.L;
  const int i0 = blockIdx.y * p.bi, j0 = blockIdx.x * p.bj;
  const int TY = L.pm / TM, TX = L.pn / TN, nthreads = TY * TX;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid - ty * TX;
  const int rows_v = min(p.bi, p.n - i0), cols_v = min(p.bj, p.m - j0);
  auto row = [&](int u) { return ty + TY * u; };
  auto col = [&](int h) { return 4 * tx + 4 * TX * h; };

  // the running minima start from D (plain loads: a panel's D is its O)
  float acc[TM][TN];
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int r = row(u);
    const float* d = p.D + (size_t)(i0 + r) * p.ldd + j0;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int c = col(h);
      if (r < rows_v && p.vec_io && c + 3 < cols_v) {
        const float4 q = *reinterpret_cast<const float4*>(d + c);
        acc[u][4 * h] = q.x; acc[u][4 * h + 1] = q.y;
        acc[u][4 * h + 2] = q.z; acc[u][4 * h + 3] = q.w;
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w)
          acc[u][4 * h + w] = (r < rows_v && c + w < cols_v) ? d[c + w] : 0.f;
      }
    }
  }

  // A's chunk: pm rows of kc k (zero past rows_v); B's: kc rows of pn
  // columns (zero past cols_v). A ragged last chunk plans anew.
  const gemm::Plan plan_a = gemm::plan_box<float, VEC16>(L.pm, L.kfull, tid, nthreads);
  const gemm::Plan plan_b = gemm::plan_box<float, VEC16>(L.kfull, L.pn, tid, nthreads);
  auto load = [&](int c, int slot) {
    char* sA = smem + slot * L.stage;
    char* sB = sA + L.a_bytes;
    const int k0 = c * KC, kc = min(KC, p.bs - k0);
    const int kcp = VEC16 ? gemm::round_up(kc, 4) : kc;
    const bool full = kcp == L.kfull;
    gemm::copy_box<float, VEC16>(
        full ? plan_a : gemm::plan_box<float, VEC16>(L.pm, kcp, tid, nthreads), sA, L.pitch_a,
        p.A + (size_t)i0 * p.lda + k0, p.lda, rows_v, kc, tid, nthreads);
    gemm::copy_box<float, VEC16>(
        full ? plan_b : gemm::plan_box<float, VEC16>(kcp, L.pn, tid, nthreads), sB, L.pitch_b,
        p.B + (size_t)k0 * p.ldb + j0, p.ldb, kc, cols_v, tid, nthreads);
  };

  auto compute = [&](int c, int slot) {
    const char* sA = smem + slot * L.stage;
    const float* sB = reinterpret_cast<const float*>(sA + L.a_bytes);
    const int kc = min(KC, p.bs - c * KC);
    const char* pa = sA + ty * L.pitch_a;
    const int ua = TY * L.pitch_a;
    const float* pb = sB + col(0);
    const int ldb_s = L.pn, hb = 4 * TX;
    int k = 0;
#pragma unroll 1
    for (; k + UNROLL <= kc; k += UNROLL) {
#pragma unroll
      for (int s = 0; s < UNROLL; s += W) relax<TM, TN, W>(acc, pa, ua, pb, ldb_s, hb, k + s);
    }
#pragma unroll 1
    for (; k < kc; ++k) relax<TM, TN, 1>(acc, pa, ua, pb, ldb_s, hb, k);
  };

  gemm::run_ring((p.bs + KC - 1) / KC, L.stages, load, compute);

#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int r = row(u);
    if (r >= rows_v) continue;
    float* o = p.O + (size_t)(i0 + r) * p.ldo + j0;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int c = col(h);
      if (p.vec_io && c + 3 < cols_v) {
        *reinterpret_cast<float4*>(o + c) =
            make_float4(acc[u][4 * h], acc[u][4 * h + 1], acc[u][4 * h + 2], acc[u][4 * h + 3]);
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (c + w < cols_v) o[c + w] = acc[u][4 * h + w];
      }
    }
  }
}

template <int TM, int TN, int UNROLL, bool VEC16>
cudaError_t launch_minplus(const Args& p, cudaStream_t stream) {
  const dim3 grid((p.m + p.bj - 1) / p.bj, (p.n + p.bi - 1) / p.bi);
  static long long done[16] = {};
  const cudaError_t e = gemm::allow_smem(minplus_kernel<TM, TN, UNROLL, VEC16>, p.L.bytes, done);
  if (e != cudaSuccess) return e;
  minplus_kernel<TM, TN, UNROLL, VEC16><<<grid, p.L.threads, p.L.bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int TM, int TN, bool VEC16>
cudaError_t launch_unroll(const Args& p, int unroll, cudaStream_t s) {
  switch (unroll) {
    case 1: return launch_minplus<TM, TN, 1, VEC16>(p, s);
    case 2: return launch_minplus<TM, TN, 2, VEC16>(p, s);
    case 4: return launch_minplus<TM, TN, 4, VEC16>(p, s);
    case 8: return launch_minplus<TM, TN, 8, VEC16>(p, s);
  }
  return cudaErrorInvalidValue;
}

template <bool VEC16>
cudaError_t launch_tile(const Args& p, int unroll, cudaStream_t s) {
  if (p.L.tm == 8 && p.L.tn == 8) return launch_unroll<8, 8, VEC16>(p, unroll, s);
  if (p.L.tm == 8) return launch_unroll<8, 4, VEC16>(p, unroll, s);
  return launch_unroll<4, 4, VEC16>(p, unroll, s);
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

extern "C" long long minplus_smem_bytes(int bi, int bj, int bs, int limit) {
  if (bi < 1 || bj < 1 || bs < 1) return -1;
  const Layout L = layout(bi, bj, bs, limit);
  if (L.pm > MAX_EXTENT || L.pn > MAX_EXTENT || L.threads > MAX_THREADS) return -1;
  return L.bytes;
}

extern "C" int minplus_launch(const void* D, int ldd, const void* A, int lda, const void* B,
                              int ldb, void* O, int ldo, int n, int m, int bs, int bi, int bj,
                              int unroll, int limit, void* stream) {
  const long long smem = minplus_smem_bytes(bi, bj, bs, limit);
  if (smem < 0 || smem > limit || n < 1 || m < 1 || ldd < m || ldo < m || lda < bs || ldb < m)
    return (int)cudaErrorInvalidValue;
  // 16-byte copy pieces: aligned bases, leading dimensions, chunk steps and
  // tile edges (bs, m and bj whole 16-byte words), so no piece straddles the
  // valid box
  const bool vec16 = gemm::aligned16(A) && gemm::aligned16(B) && lda % 4 == 0 && ldb % 4 == 0
                     && bs % 4 == 0 && m % 4 == 0 && bj % 4 == 0;
  const int vec_io = gemm::aligned16(D) && gemm::aligned16(O) && ldd % 4 == 0 && ldo % 4 == 0
                     && bj % 4 == 0;
  Args p{(const float*)D, (const float*)A, (const float*)B, (float*)O, ldd, lda, ldb, ldo,
         n, m, bs, bi, bj, vec_io, layout(bi, bj, bs, limit)};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  e = vec16 ? launch_tile<true>(p, unroll, s) : launch_tile<false>(p, unroll, s);
  return (int)e;
}

extern "C" int closure_launch(void* D, int ld, int off, int bs, void* stream) {
  if (bs < 1 || off < 0 || off + bs > ld) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bs <= CLOSURE_SMEM_BS) {
    const int smem = (int)sizeof(float) * bs * (bs + 1);
    static long long done[16] = {};
    const cudaError_t e = gemm::allow_smem(closure_kernel<true>, smem, done);
    if (e != cudaSuccess) return (int)e;
    closure_kernel<true><<<1, dim3(CT, CT), smem, s>>>((float*)D, ld, off, bs);
  } else {
    closure_kernel<false><<<1, dim3(CT, CT), 0, s>>>((float*)D, ld, off, bs);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
