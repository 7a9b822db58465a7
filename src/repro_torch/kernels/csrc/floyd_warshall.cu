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
// Design of the closure helper (phase 1: bs dependent steps k of D_ij =
// min(D_ij, D_ik + D_kj) on one bs x bs block, in place). What bounds it is
// the chain of steps, not bytes or operations: bs^3 relaxations are 0.26 M
// at bs = 64 (16 ns at the card's minimum rate), but each step needs row and
// column k as the step before left them. Its floor is an empty kernel's
// device duration plus bs times one exchange step among its threads (a
// shared store, a barrier, a load; mma_rate.py measures both). So the block is held in
// registers and only row k and column k move each step:
//   * bs <= 32: one warp, lane i holds row i; D_ik is the lane's own
//     register (the k loop unrolled over the instantiation, 16 or 32), D_kj
//     comes by __shfl_sync from lane k. No barrier.
//   * bs <= 64, 128: one CTA of 256 threads, each a 4 x 4 (64) or 16 x 4
//     (128) tile of registers; after step k the owners of row k + 1 and
//     column k + 1 write them into a double-buffered shared row and column:
//     one barrier a step.
//   * bs <= 256 (256 KB: more than one CTA's shared memory or registers): a
//     thread-block cluster of CLOSURE_CLUSTER = 8 CTAs, each a band of 32
//     rows in registers (the same thread map, 8 x 4 a thread). Row k + 1
//     reaching every CTA through distributed shared memory with a cluster
//     barrier every step costs about 0.6 us a step (mma_rate.py's probe),
//     so the rows come in panels of CLOSURE_PANEL = 8: the owner of the
//     next 8 rows writes them into every CTA's panel buffer once, and each
//     CTA advances its own copy of the panel step by step beside its band
//     (the same operation on the same values as the owner's, so the same
//     bits): a CTA barrier a step, a cluster barrier every 8 steps. On the
//     card a cluster barrier every step took 224-236 us at 256 (4 or 8
//     CTAs), the panel form 124-126 us.
//   * bs past 256: one CTA of 32 x 32 threads works on the block in global
//     memory (through L1 and L2), one barrier a step; no gpu-space point is
//     this wide, but the JAX reference takes any bs.
// Every step computes every element from the previous step's values, as
// closure_plain does; in place is exact because D_kk >= 0 (zero on the
// diagonal, 1e18 on padded nodes), so rows and columns k do not change in
// step k. Rows and columns past bs (a bs between instantiations) are
// computed on zeros and never stored. The result equals the plain version
// bit for bit.
//
// Interface: minplus_smem_bytes() gives the dynamic shared memory a block
// of the min-plus kernel needs for a tile and contraction width under a
// device limit (-1 for a tile past 256 or past 256 threads), from the same
// layout() the launcher passes the kernel. minplus_launch() and
// closure_launch() launch on the given stream, do not synchronise, and
// return cudaGetLastError(). The register tile (4 x 4, 8 x 4, 8 x 8),
// UNROLL and the copy form are template parameters of the min-plus kernel
// (24 instantiations).

#include <cooperative_groups.h>

#include "gemm_f32.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int KC = 32;             // contraction chunk streamed through the ring
constexpr int MAX_EXTENT = 256;    // largest (padded) tile extent
constexpr int MAX_THREADS = 256;

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

// ---- the in-block closure -----------------------------------------------
//
// D_ij = min(D_ij, D_ik + D_kj) for k = 0 .. bs - 1 on the bs x bs block at
// (off, off) of D (row stride ld), in place. Step k computes every element
// from the values after step k - 1, as closure_plain does (rows and columns
// k included: they do not change, since D_kk >= 0), so the result is the
// plain version's bit for bit whatever the thread map.

constexpr unsigned FULL = 0xffffffffu;

// bs <= BS <= 32: one warp, lane i holds row i in registers, the k loop
// unrolled over BS: D_ik is the lane's own register, D_kj comes by shuffle
// from lane k. No barrier at all. Rows and columns past bs are computed on
// zeros and never stored. The block is staged through shared memory only
// to read and write it in whole rows (coalesced).
template <int BS>
__global__ void __launch_bounds__(32) closure_warp_kernel(float* D, int ld, int off, int bs) {
  __shared__ float s[BS][BS + 1];
  const int lane = threadIdx.x;
  float* G = D + (size_t)off * ld + off;
  if (lane < BS)
    for (int r = 0; r < BS; ++r) s[r][lane] = (r < bs && lane < bs) ? G[(size_t)r * ld + lane] : 0.f;
  __syncwarp();
  float d[BS];
#pragma unroll
  for (int j = 0; j < BS; ++j) d[j] = lane < BS ? s[lane][j] : 0.f;
#pragma unroll
  for (int k = 0; k < BS; ++k) {
    if (k >= bs) break;
    const float dik = d[k];
#pragma unroll
    for (int j = 0; j < BS; ++j) d[j] = fminf(d[j], dik + __shfl_sync(FULL, d[j], k));
  }
  __syncwarp();
  if (lane < BS) {
#pragma unroll
    for (int j = 0; j < BS; ++j) s[lane][j] = d[j];
  }
  __syncwarp();
  if (lane < bs)
    for (int r = 0; r < bs; ++r) G[(size_t)r * ld + lane] = s[r][lane];
}

// BS = 64, 128: one CTA of 256 threads, thread (ty, tx) holding rows
// ty*TM .. ty*TM + TM - 1 and columns 4tx .. 4tx + 3 in registers. Step k
// reads column k of its rows and row k from a double-buffered shared row
// and column; after the step the owners of row k + 1 (the threads of one
// ty) and of column k + 1 (the threads of one tx) write them into the
// buffers, then one barrier. A reader of buffer k & 1 in step k is past
// that step's barrier before any thread writes the buffer again, in step
// k + 1.
constexpr int CLOSURE_THREADS = 256;
constexpr int CLOSURE_CLUSTER = 8;  // CTAs of the bs = 256 cluster
constexpr int CLOSURE_PANEL = 8;    // its pivot rows a cluster barrier
constexpr int CLOSURE_REG_BS = 256;  // the widest block held in registers
constexpr int CT = 32;               // past it: CT x CT threads, the block in global memory

template <int BS, int CL>
struct ClosureMap {
  static constexpr int RB = BS / CL;                 // rows of a CTA's band
  static constexpr int TX = BS / 4;                  // threads across a row
  static constexpr int TY = CLOSURE_THREADS / TX;
  static constexpr int TM = RB / TY;                 // rows a thread
  static_assert(TM % 4 == 0 && TM * TY == RB, "closure thread map");
};

template <int BS>
__global__ void __launch_bounds__(CLOSURE_THREADS, 1) closure_tile_kernel(float* D, int ld, int off,
                                                                       int bs, int vec) {
  using Map = ClosureMap<BS, 1>;
  constexpr int TX = Map::TX, TM = Map::TM;
  __shared__ __align__(16) float rowk[2][BS];  // row k of the block
  __shared__ __align__(16) float colk[2][BS];  // column k of the block
  const int tid = threadIdx.x, ty = tid / TX, tx = tid - ty * TX;
  const int r0 = ty * TM, c0 = 4 * tx;  // this thread's first row and column
  float* G = D + (size_t)off * ld + off;

  float d[TM][4];
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int r = r0 + u;
    const float* g = G + (size_t)r * ld + c0;
    if (r < bs && vec && c0 + 3 < bs) {
      const float4 q = *reinterpret_cast<const float4*>(g);
      d[u][0] = q.x; d[u][1] = q.y; d[u][2] = q.z; d[u][3] = q.w;
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w) d[u][w] = (r < bs && c0 + w < bs) ? g[w] : 0.f;
    }
  }

  // row k1 and column k1 (k1 < bs) into buffer k1 & 1, u1 = k1 % TM and
  // w1 = k1 % 4: constants wherever the unrolled loop below calls it, so
  // the selects fold away and the tile stays in registers
  auto publish = [&](int k1, int u1, int w1) {
    const int b = k1 & 1;
    if (k1 / TM == ty) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < TM; ++u)
        if (u == u1) v = make_float4(d[u][0], d[u][1], d[u][2], d[u][3]);
      *reinterpret_cast<float4*>(&rowk[b][c0]) = v;
    }
    if ((k1 >> 2) == tx) {
      float x[TM];
#pragma unroll
      for (int u = 0; u < TM; ++u)
        x[u] = w1 == 0 ? d[u][0] : w1 == 1 ? d[u][1] : w1 == 2 ? d[u][2] : d[u][3];
#pragma unroll
      for (int u = 0; u < TM; u += 4)
        *reinterpret_cast<float4*>(&colk[b][ty * TM + u]) =
            make_float4(x[u], x[u + 1], x[u + 2], x[u + 3]);
    }
  };

  publish(0, 0, 0);
  __syncthreads();
  for (int k0 = 0; k0 < bs; k0 += TM) {
#pragma unroll
    for (int kk = 0; kk < TM; ++kk) {
      const int k = k0 + kk;
      if (k >= bs) break;
      const int b = k & 1;
      float a[TM];
#pragma unroll
      for (int u = 0; u < TM; u += 4) {
        const float4 q = *reinterpret_cast<const float4*>(&colk[b][ty * TM + u]);
        a[u] = q.x; a[u + 1] = q.y; a[u + 2] = q.z; a[u + 3] = q.w;
      }
      const float4 q = *reinterpret_cast<const float4*>(&rowk[b][c0]);
      const float rv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) d[u][w] = fminf(d[u][w], a[u] + rv[w]);
      if (k + 1 < bs) publish(k + 1, (kk + 1) % TM, (kk + 1) & 3);
      __syncthreads();
    }
  }

#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int r = r0 + u;
    if (r >= bs) continue;
    float* g = G + (size_t)r * ld + c0;
    if (vec && c0 + 3 < bs) {
      *reinterpret_cast<float4*>(g) = make_float4(d[u][0], d[u][1], d[u][2], d[u][3]);
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (c0 + w < bs) g[w] = d[u][w];
    }
  }
}

// BS = 256 on a cluster of CL CTAs with P pivot rows a cluster barrier:
// every CTA keeps its own copy of the next P rows of the block (the
// "panel", broadcast once through distributed shared memory by the CTA
// that owns them) and advances it itself, step by step, beside its band:
// row k + i of the panel, as of step k + i - 1, is the pivot row of step
// k + i. A panel row is updated by the same operation, on the same values,
// as its owner's copy in registers, so every copy holds the same bits. A
// step then needs only its CTA's barrier (for the column buffer and the
// panel's column k); the cluster barrier comes once a panel, after its
// owner has written the next one into every CTA's other panel buffer.
template <int BS, int CL, int P>
__global__ void __launch_bounds__(CLOSURE_THREADS, 1) closure_panel_kernel(float* D, int ld,
                                                                           int off, int bs,
                                                                           int vec) {
  using Map = ClosureMap<BS, CL>;
  constexpr int RB = Map::RB, TX = Map::TX, TM = Map::TM;
  static_assert(TM % P == 0 || P % TM == 0, "closure panel map");
  __shared__ __align__(16) float pan[2][P][BS];  // the next P rows of the block
  __shared__ __align__(16) float colk[2][RB];    // column k of this CTA's band
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, ty = tid / TX, tx = tid - ty * TX;
  const int rank = (int)cluster.block_rank();
  const int r0 = rank * RB + ty * TM, c0 = 4 * tx;
  float* G = D + (size_t)off * ld + off;

  float d[TM][4];
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int r = r0 + u;
    const float* g = G + (size_t)r * ld + c0;
    if (r < bs && vec && c0 + 3 < bs) {
      const float4 q = *reinterpret_cast<const float4*>(g);
      d[u][0] = q.x; d[u][1] = q.y; d[u][2] = q.z; d[u][3] = q.w;
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w) d[u][w] = (r < bs && c0 + w < bs) ? g[w] : 0.f;
    }
  }

  // rows k1 .. k1 + P - 1, as this thread holds them, into every CTA's
  // panel buffer pb (the caller's cluster barrier publishes them)
  auto publish_panel = [&](int k1, int pb) {
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      const int j = r0 + u - k1;
      if (j >= 0 && j < P) {
        const float4 v = make_float4(d[u][0], d[u][1], d[u][2], d[u][3]);
#pragma unroll
        for (int c = 0; c < CL; ++c)
          *reinterpret_cast<float4*>(cluster.map_shared_rank(&pan[pb][j][c0], c)) = v;
      }
    }
  };
  // column k1 of the band into buffer k1 & 1 (w1 = k1 % 4, a constant below)
  auto publish_col = [&](int k1, int w1) {
    if ((k1 >> 2) == tx) {
      float x[TM];
#pragma unroll
      for (int u = 0; u < TM; ++u)
        x[u] = w1 == 0 ? d[u][0] : w1 == 1 ? d[u][1] : w1 == 2 ? d[u][2] : d[u][3];
#pragma unroll
      for (int u = 0; u < TM; u += 4)
        *reinterpret_cast<float4*>(&colk[k1 & 1][ty * TM + u]) =
            make_float4(x[u], x[u + 1], x[u + 2], x[u + 3]);
    }
  };

  cluster.sync();  // every CTA's buffers exist
  publish_panel(0, 0);
  publish_col(0, 0);
  cluster.sync();
  for (int k0 = 0; k0 < bs; k0 += P) {
    const int pb = (k0 / P) & 1;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int k = k0 + i;
      if (k >= bs) break;
      const int b = k & 1;
      float a[TM];
#pragma unroll
      for (int u = 0; u < TM; u += 4) {
        const float4 q = *reinterpret_cast<const float4*>(&colk[b][ty * TM + u]);
        a[u] = q.x; a[u + 1] = q.y; a[u + 2] = q.z; a[u + 3] = q.w;
      }
      const float4 q = *reinterpret_cast<const float4*>(&pan[pb][i][c0]);
      const float rv[4] = {q.x, q.y, q.z, q.w};
      // the panel's later rows (their column k, as of step k - 1, read
      // before this step's writes: only the owner of column k writes it,
      // and leaves it as it is, since D_kk >= 0)
      float pk[P];
#pragma unroll
      for (int j = i + 1; j < P; ++j) pk[j] = pan[pb][j][k];
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) d[u][w] = fminf(d[u][w], a[u] + rv[w]);
#pragma unroll
      for (int j = i + 1; j < P; ++j) {
        float4 x = *reinterpret_cast<const float4*>(&pan[pb][j][c0]);
        x.x = fminf(x.x, pk[j] + rv[0]);
        x.y = fminf(x.y, pk[j] + rv[1]);
        x.z = fminf(x.z, pk[j] + rv[2]);
        x.w = fminf(x.w, pk[j] + rv[3]);
        *reinterpret_cast<float4*>(&pan[pb][j][c0]) = x;
      }
      if (k + 1 < bs) publish_col(k + 1, (i + 1) & 3);
      if (i == P - 1 && k + 1 < bs) {
        publish_panel(k + 1, pb ^ 1);  // the next panel, as of this step
        cluster.sync();
      } else {
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int r = r0 + u;
    if (r >= bs) continue;
    float* g = G + (size_t)r * ld + c0;
    if (vec && c0 + 3 < bs) {
      *reinterpret_cast<float4*>(g) = make_float4(d[u][0], d[u][1], d[u][2], d[u][3]);
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (c0 + w < bs) g[w] = d[u][w];
    }
  }
}

cudaError_t launch_closure_panel(float* D, int ld, int off, int bs, int vec, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLOSURE_CLUSTER);
  cfg.blockDim = dim3(CLOSURE_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLOSURE_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, closure_panel_kernel<CLOSURE_REG_BS, CLOSURE_CLUSTER, CLOSURE_PANEL>, D, ld, off, bs,
      vec);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// bs past CLOSURE_REG_BS: CT x CT threads on the block in global memory, one
// barrier a step. Step k skips row and column k (they do not change), so
// every other element reads only values no thread writes in that step.
__global__ void __launch_bounds__(CT * CT) closure_global_kernel(float* D, int ld, int off, int bs) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  float* G = D + (size_t)off * ld + off;
  for (int k = 0; k < bs; ++k) {
    for (int i = ty; i < bs; i += CT) {
      if (i == k) continue;
      const float dik = G[(size_t)i * ld + k];
      for (int j = tx; j < bs; j += CT) {
        if (j == k) continue;
        float* x = G + (size_t)i * ld + j;
        *x = fminf(*x, dik + G[(size_t)k * ld + j]);
      }
    }
    __syncthreads();
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
  float* d = (float*)D;
  // float4 rows: an aligned base, leading dimension and offset
  const int vec = gemm::aligned16(D) && ld % 4 == 0 && off % 4 == 0;
  if (bs <= 16) closure_warp_kernel<16><<<1, 32, 0, s>>>(d, ld, off, bs);
  else if (bs <= 32) closure_warp_kernel<32><<<1, 32, 0, s>>>(d, ld, off, bs);
  else if (bs <= 64) closure_tile_kernel<64><<<1, CLOSURE_THREADS, 0, s>>>(d, ld, off, bs, vec);
  else if (bs <= 128) closure_tile_kernel<128><<<1, CLOSURE_THREADS, 0, s>>>(d, ld, off, bs, vec);
  else if (bs <= CLOSURE_REG_BS) return (int)launch_closure_panel(d, ld, off, bs, vec, s);
  else closure_global_kernel<<<1, dim3(CT, CT), 0, s>>>(d, ld, off, bs);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
