// Tiled matmul on Hopper: O = A @ B, A M x K, B K x N, inputs f32 or bf16
// (both the same), output f32 or bf16.
//
// Replaces: src/repro/kernels/matmul.py:_mm_kernel_pack and _mm_kernel_nopack
// (the Pallas TPU kernels behind repro.kernels.matmul.tiled_matmul; mm3 is
// three calls of it, src/repro/kernels/m3mm.py; lu's trailing update and the
// model's output projection and unembed call it too).
//
// What bounds it on an H100: the three products of mm3 at the paper's LARGE
// size (P..T = 800, 900, 1000, 1100, 1200) are 2*(PQR + RST + PRT) = 6.0
// GFLOP, 36 us at the 165 TFLOP/s of 3xTF32 on the tensor cores, against 36
// MB of f32 operands and results (11 us at 3.35 TB/s): compute-bound. The
// decode step's products have 4 rows: the unembed (4, 896) @ (896, 151936)
// is 1.1 GFLOP against 545 MB of B (0.163 ms; 0.081 ms from bf16 weights),
// the output projection (4, 4096) @ (4096, 4096) in bf16 34 MB (0.010 ms):
// bound by B's bytes, and at these sizes by how soon the card has enough of
// them in flight. The bf16 forward products (mixtral's output projection at
// 512 rows: 17 GFLOP, 17 us at the data sheet's 989 TFLOP/s, against 42 MB,
// 13 us) are compute-bound on the tensor cores.
//
// Four routes, chosen on the host before the launch (route(), reported
// through matmul_launch's *route):
//   * SPLIT (tiles of at most 8 rows, f32 and bf16: the decode's products):
//     a split-K stream. B never passes through shared memory: each thread
//     owns a group of 16 bytes of columns (4 f32, 8 bf16) for all of the
//     tile's rows (padded to 4 or 8) and streams B's rows from device
//     memory into registers with 16-byte non-caching loads (narrower where
//     a base, N or bn is off 16 bytes: whisper's N = 51,866), two rounds of
//     U = 4 loads in flight; the block's threads split its K range between
//     them (thread (s, g) takes k = s, s + KS, ...). A's rows of the range
//     are staged in shared memory as f32 (k, row) pairs, 32 KB at a time.
//     Where the column tiles alone leave SMs idle, K is split further
//     across the CTAs of a thread-block cluster (split_count(): up to 8,
//     from M, K, N, bn, the SM count the wrapper reads at run time and the
//     instance's occupancy, so that the CTAs fill whole waves): each
//     CTA sums its slice in f32, the block's threads add theirs in a fixed
//     order through shared memory, and the cluster adds the CTAs' tiles
//     through distributed shared memory, every element over the ranks in
//     rank order, each CTA storing its share of the tile (spread over the
//     ranks rather than all on rank 0, so that no one CTA's stores trail
//     the rest). One launch, no workspace, no atomics: the same inputs give
//     the same bits on every call. pack=False runs the same kernel unsplit
//     (a cluster of one): after every bk chunk, in ascending order, the
//     block's sum is read-modify-written into O in O's dtype. O's tile is
//     stored 4 columns a thread (16 bytes f32, 8 bf16) where aligned.
//     What bounds it: B's bytes, and at the decode's sizes the latency of
//     a CTA's few rounds of loads (a CTA streams about 9 GB/s with its 128
//     threads' 4-8 loads in flight), which the split spreads over more CTAs
//     in one wave. Tried on the card and not kept: a ring of 16 cp.async
//     slots a thread in shared memory (1.4-1.6x slower), 8 loads a round
//     (fewer CTAs an SM by registers).
//   * WGMMA (bf16 tiles past 8 rows, pack=True, both bases 16-byte aligned
//     and K and N multiples of 8, TMA's constraints): one or two consumer
//     warpgroups (bm padded to 64 or 128 rows) run
//     wgmma.mma_async.m64nNk16 (N = bn padded to 64 or 128) on both
//     operands in shared memory, fed by a ring of up to 4 stages that one
//     producer thread fills with TMA boxes (gemm_wgmma.cuh: A K-major, B as
//     the port stores it, n contiguous, through wgmma's transpose bit) behind
//     full/empty mbarriers; TMA's out-of-bounds fill zeroes the ragged
//     edges in M, N and K. A chunk is bk rounded up to a multiple of 16 (bk
//     4, 8 -> 16, 24 -> 32: more k a chunk, never zeros) and sums in a
//     fresh accumulator (scale-d 0 on its first k16 step), added into the
//     running sum on the CUDA cores: the tensor cores' own f32
//     accumulation drifts over a long K (measured below), so it
//     never carries a sum across chunks. What bounds it: at the 64 x 64
//     default the L2's rate (mixtral's (512, 4096) @ (4096, 4096) streams
//     537 MB of tiles through L2 for 34 MB of operands); at 128 x 128 the
//     chunk's serial order (its products, then the add, then the next
//     chunk's). Tried on the card and not kept: two fresh tiles in turn
//     (spills at 128 x 128, fewer CTAs an SM at 64 x 64), a cluster of two
//     CTAs multicasting the shared operand (1.4-2.1x slower).
//   * MMA_SYNC (f32 tiles past 8 rows in 3xTF32; bf16 tiles past 8 rows
//     with pack=False, a base off 16 bytes, or K or N off a multiple of 8):
//     one block per bm x bn tile walks K in bk-deep chunks through
//     gemm_f32.cuh's ring of cp.async stages (A's chunk as k-contiguous
//     rows padded to an odd number of 16-byte words, B's n-contiguous).
//     Warp (wr, wc) of (pm/32) x (pn/32) holds a 32 x 32 piece of the tile
//     padded to whole pieces (no mma under a predicate) as 2 x 4 mma tiles,
//     each chunk summed in a fresh tile and added into the running sum on
//     the CUDA cores. f32 (gemm_tf32.cuh): each value split into two TF32
//     parts as it is read, three mma.sync.m16n8k8 a k step of 8 (lo*hi,
//     hi*lo, hi*hi), about f32's accuracy. bf16 (gemm_bf16.cuh): one
//     mma.sync.m16n8k16 a k step of 16, fragments by ldmatrix (B's rows
//     transposed by .trans); chunks padded to the mma's k with zeros.
//   * FFMA (f32 128-row tiles with chunks of 192 or 256, whose padded
//     mma.sync layout does not fit the shared memory): the same ring, each
//     thread an RT x RT register tile (RT = 4 up to 64-wide tiles, 8 past),
//     widened to f32 as the inner loop reads it.
// The schedule knobs:
//   PACK=true   accumulate the whole K range in f32 and store O once, in its
//               dtype (the TPU kernel's f32 VMEM accumulator);
//   PACK=false  after every bk chunk, load the O tile, add the chunk's partial
//               product rounded to O's dtype, and store it again in O's dtype
//               (the TPU kernel's read-modify-write of the output block: the
//               knob's precision trade-off in bf16);
//   interchange which tile axis the grid walks first: j (columns) by
//               default, as the TPU grid (i, j, k) runs j fastest; i with it.
//
// Interface: matmul_smem_bytes() gives the dynamic shared memory a block
// needs for a tile and input dtype under a device limit (for a bf16 tile
// past 8 rows the larger of its two routes' layouts; -1 for a tile past
// 128), from the same plans the launcher passes the kernels; the wrapper
// checks it against the limit before launch. matmul_splits() gives the
// split route's CTAs a column tile. matmul_launch() launches on the given
// stream, does not synchronise, writes the route it took to *route (FFMA 0,
// MMA_SYNC 1, WGMMA 2, SPLIT 3) and returns cudaGetLastError() (or the
// tensor map's encoding failure as cudaErrorInvalidValue): a route that
// cannot run raises in the wrapper, never retried on another.

#include <cooperative_groups.h>

#include "gemm_bf16.cuh"
#include "gemm_f32.cuh"
#include "gemm_tf32.cuh"
#include "gemm_wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

enum Route { FFMA = 0, MMA_SYNC = 1, WGMMA = 2, SPLIT = 3 };

constexpr int MMA_M = 16, MMA_N = 8;
// an mma's depth in k: m16n8k8 for TF32 (f32 inputs), m16n8k16 for bf16
__host__ __device__ constexpr int mma_k(int size) { return size == 4 ? 8 : 16; }
constexpr int WM = 32, WN = 32;             // a warp's piece of the tile (tensor cores)
constexpr int MT = WM / MMA_M, NT = WN / MMA_N;
constexpr int MAX_TC_THREADS = 32 * (gemm::MAX_TILE / WM) * (gemm::MAX_TILE / WN);  // 512

// Shared-memory layout of one block of the ring routes (MMA_SYNC, FFMA):
// `stages` stages, each A's chunk (pm rows of kfull elements, pitch_a bytes
// apart) then B's (kfull rows, pitch_b bytes). Tensor cores: pm and pn
// padded to 32, kfull to the mma's k (8 for f32, 16 for bf16), B rows padded
// by 8 elements; FFMA: pm and pn padded to 8, kfull to 4.
struct Layout {
  bool tc;                  // the tensor cores' kernel
  int pm, pn, tm, tn;       // padded tile extents; FFMA register tile per thread
  int wr, wc;               // tensor cores: warps along M and N
  int kfull;                // k elements of a staged chunk
  int pitch_a, pitch_b;     // row pitches, bytes
  int a_bytes, stage;       // A's chunk, one whole stage
  int threads, stages;
  long long bytes;          // total dynamic shared memory
};

Layout layout(int bm, int bn, int bk, int size, long long limit, bool tc) {
  Layout L;
  L.tc = tc;
  if (L.tc) {
    // whole warp pieces, so that no mma runs under a predicate: the rows and
    // columns past the tile are staged (zeros past the operands) and not
    // stored
    L.pm = gemm::round_up(bm, WM);
    L.pn = gemm::round_up(bn, WN);
    L.tm = L.tn = 0;
    L.wr = L.pm / WM;
    L.wc = L.pn / WN;
    L.threads = 32 * L.wr * L.wc;
    L.kfull = gemm::round_up(bk, mma_k(size));
    // f32: B's fragment reads (lanes (t, g) read row t, column g), so rows
    // 8 mod 32 words apart put the four rows on distinct banks; bf16:
    // ldmatrix's 16-byte rows, an odd number of 16-byte words apart (2 pn
    // bytes is a multiple of 64), so a matrix's 8 rows take 8 bank quads
    L.pitch_b = size * (L.pn + 8);
  } else {
    L.pm = gemm::round_up(bm, gemm::ALIGN);
    L.pn = gemm::round_up(bn, gemm::ALIGN);
    L.tm = L.tn = gemm::reg_tile(L.pm, L.pn);
    L.wr = L.wc = 0;
    L.threads = (L.pm / L.tm) * (L.pn / L.tn);
    L.kfull = gemm::round_up(bk, 4);
    L.pitch_b = gemm::round_up(L.pn * size, 16);
  }
  L.pitch_a = gemm::kpitch(L.kfull, size);
  L.a_bytes = L.pm * L.pitch_a;
  L.stage = L.a_bytes + L.kfull * L.pitch_b;
  L.stages = gemm::ring_stages(L.stage, 0, limit);
  L.bytes = (long long)L.stages * L.stage;
  return L;
}

// Tiles past 8 rows on the ring take the tensor cores where one stage of
// their padded layout fits the limit; the others the FFMA loop (so the
// tensor cores refuse no tile of the gpu space that the FFMA loop takes)
Layout layout(int bm, int bn, int bk, int size, long long limit) {
  const Layout L = layout(bm, bn, bk, size, limit, true);
  if (L.bytes <= limit) return L;
  return layout(bm, bn, bk, size, limit, false);
}

// ---- SPLIT: the plan ---------------------------------------------------------

namespace split {
constexpr int THREADS = 128;    // the most threads a block
constexpr int U = 4;            // B loads a round a thread (two rounds in flight)
constexpr int MAX_SPLIT = 8;    // CTAs of a cluster on one column tile
constexpr int A_BYTES = 32768;  // A's staged piece (f32, k by row)
constexpr int MIN_KC = 64;      // the least K range a CTA of a split takes
// a CTA's fixed cost (A's piece, the block's and the cluster's sums, the
// launch of its 128 threads: about 3.5 us), as the bytes of B one CTA
// streams meanwhile (about 9 GB/s on an H100)
constexpr long long FIXED_BYTES = 32768;

struct Plan {
  int tm, vw;         // rows (4 or 8), columns a thread (16 bytes of the input)
  int cg, ks;         // column groups and k slices of the block
  int threads, ka;    // threads, k of A's staged piece
  long long bytes;    // A's piece and the block's reduction buffer
};

__host__ __device__ inline Plan plan(int bm, int bn, int bk, int size) {
  Plan q;
  q.tm = bm <= 4 ? 4 : 8;
  q.vw = 16 / size;
  q.cg = (bn + q.vw - 1) / q.vw;
  q.ks = THREADS / q.cg > 1 ? THREADS / q.cg : 1;
  q.threads = q.cg * q.ks;
  q.ka = A_BYTES / (4 * q.tm);
  if (bk < q.ka) q.ka = q.ka / bk * bk;  // pack=False: whole chunks a piece
  q.bytes = (long long)q.ka * q.tm * 4 + (long long)q.threads * q.tm * q.vw * 4;
  return q;
}

// CTAs on one column tile (1 for pack=False): 1 where the column tiles fill
// between half and all of one wave (slots[1] CTAs fit the card at once: they
// share its bandwidth already, and a split only adds its fixed cost); else
// the count of least modelled time, waves of CTAs (slots[s] of them fit at
// once in clusters of s) times one CTA's work, its share of the tile's bytes
// of B plus FIXED_BYTES, each CTA at least MIN_KC of K. A decode output
// projection (a few dozen tiles) splits up to 8; a tile count just past a
// wave splits to even the waves out (mamba2's unembed, 786 tiles: 6-9%
// faster at 2-3 than unsplit; mixtral's, 500 tiles in one wave, 7% slower
// at 6; an H100 80GB HBM3 at 700 W).
inline int best_splits(long long tiles, long long tile_bytes, int K, int pack,
                       const long long* slots) {
  if (!pack || (2 * tiles >= slots[1] && tiles <= slots[1])) return 1;
  int best = 1;
  double best_cost = 0.0;
  const int most = K / MIN_KC < MAX_SPLIT ? (K / MIN_KC > 1 ? K / MIN_KC : 1) : MAX_SPLIT;
  for (int s = 1; s <= most; ++s) {
    const double waves = (double)((tiles * s + slots[s] - 1) / slots[s]);
    const double cost = waves * ((double)tile_bytes / s + (double)FIXED_BYTES);
    if (s == 1 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}
}  // namespace split

// ---- WGMMA: the plan ---------------------------------------------------------

namespace wg {
constexpr int MAX_STAGES = 4;
constexpr int ALIGN_SLACK = 1024;  // the dynamic base rounded up to the swizzle's period

struct Plan {
  int groups, pm, pn;   // consumer warpgroups, padded rows (64 a group) and columns
  int kc, kbox;         // k of a chunk (bk rounded up to 16) and of one A box
  int a_box, b_box;     // bytes of one A box (pm x kbox) and one B box (kc x 64)
  int stage, stages;
  long long bytes;
};

__host__ __device__ inline Plan plan(int bm, int bn, int bk, long long limit) {
  Plan w;
  w.groups = bm > 64 ? 2 : 1;
  w.pm = 64 * w.groups;
  w.pn = bn > 64 ? 128 : 64;
  w.kc = gemm::round_up(bk, 16);
  w.kbox = w.kc % 64 == 0 ? 64 : w.kc % 32 == 0 ? 32 : 16;
  w.a_box = w.pm * w.kbox * 2;
  w.b_box = w.kc * 128;
  w.stage = w.pm * w.kc * 2 + w.kc * w.pn * 2;
  const long long fixed = ALIGN_SLACK + 16LL * MAX_STAGES;  // + the full/empty barriers
  w.stages = MAX_STAGES;
  while (w.stages > 1 && fixed + (long long)w.stages * w.stage > limit) --w.stages;
  w.bytes = fixed + (long long)w.stages * w.stage;
  return w;
}
}  // namespace wg

struct Args {
  const void* A; const void* B; void* O;
  int M, K, N, bm, bn, bk;
  int interchange, out_bf16, vec_out;
  Layout L;
};

__device__ __forceinline__ float round_out(bool bf16, float v) {
  return bf16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

__device__ __forceinline__ float load_out(const void* O, bool bf16, size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(O)[i])
              : static_cast<const float*>(O)[i];
}

__device__ __forceinline__ void store_out(void* O, bool bf16, size_t i, float v) {
  if (bf16) static_cast<__nv_bfloat16*>(O)[i] = __float2bfloat16(v);
  else static_cast<float*>(O)[i] = v;
}

template <typename TI, bool PACK, int TM, int TN, bool VEC16>
__global__ void __launch_bounds__(gemm::MAX_THREADS) matmul_kernel(Args p) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout& L = p.L;
  const TI* A = static_cast<const TI*>(p.A);
  const TI* B = static_cast<const TI*>(p.B);
  const bool bf16 = p.out_bf16;
  const int ti = p.interchange ? blockIdx.x : blockIdx.y;
  const int tj = p.interchange ? blockIdx.y : blockIdx.x;
  const int i0 = ti * p.bm, j0 = tj * p.bn;
  const int TY = L.pm / TM, TX = L.pn / TN, nthreads = TY * TX;
  const int tid = threadIdx.x, ty = tid / TX, tx = tid - ty * TX;
  constexpr int SZ = sizeof(TI);

  float acc[TM][TN];
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < TN; ++v) acc[u][v] = 0.f;

  // A's chunk is pm rows of kcp k; B's kcp rows of pn columns (kcp = bk
  // rounded up to 4, less in a ragged last chunk, which plans anew)
  const int kfull = L.kfull;
  const gemm::Plan plan_a = gemm::plan_box<TI, VEC16>(L.pm, kfull, tid, nthreads);
  const gemm::Plan plan_b = gemm::plan_box<TI, VEC16>(kfull, L.pn, tid, nthreads);
  auto load = [&](int c, int slot) {
    char* sA = smem + slot * L.stage;
    char* sB = sA + L.a_bytes;
    const int k0 = c * p.bk, kc = min(p.bk, p.K - k0), kcp = gemm::round_up(kc, 4);
    const bool full = kcp == kfull;
    gemm::copy_box<TI, VEC16>(full ? plan_a : gemm::plan_box<TI, VEC16>(L.pm, kcp, tid, nthreads),
                              sA, L.pitch_a, A + (size_t)i0 * p.K + k0, p.K,
                              min(L.pm, p.M - i0), kc, tid, nthreads);
    gemm::copy_box<TI, VEC16>(full ? plan_b : gemm::plan_box<TI, VEC16>(kcp, L.pn, tid, nthreads),
                              sB, L.pitch_b, B + (size_t)k0 * p.N + j0, p.N,
                              kc, min(L.pn, p.N - j0), tid, nthreads);
  };

  // O's row of register row u, and the first of the four columns of group h
  auto row = [&](int u) { return ty + TY * u; };
  auto col = [&](int h) { return 4 * tx + 4 * TX * h; };

  auto store_tile = [&](bool accumulate) {
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      const int r = row(u), gr = i0 + r;
      if (r >= p.bm || gr >= p.M) continue;
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const int c = col(h), gc = j0 + c;
        const size_t o = (size_t)gr * p.N + gc;
        if (!accumulate && p.vec_out && c + 3 < p.bn && gc + 3 < p.N) {
          *reinterpret_cast<float4*>(static_cast<float*>(p.O) + o) =
              make_float4(acc[u][4 * h], acc[u][4 * h + 1], acc[u][4 * h + 2], acc[u][4 * h + 3]);
          continue;
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          if (c + w >= p.bn || gc + w >= p.N) continue;
          float v = acc[u][4 * h + w];
          if (accumulate) v = load_out(p.O, bf16, o + w) + round_out(bf16, v);
          store_out(p.O, bf16, o + w, v);
        }
      }
    }
  };

  auto compute = [&](int c, int slot) {
    const char* sA = smem + slot * L.stage;
    const char* sB = sA + L.a_bytes;
    const int k0 = c * p.bk, kcp = gemm::round_up(min(p.bk, p.K - k0), 4);
    const char* pa = sA + ty * L.pitch_a;
    const int ua = TY * L.pitch_a;
    const char* pb = sB + col(0) * SZ;
    const int hb = 4 * TX * SZ;
#pragma unroll 2
    for (int k = 0; k < kcp; k += 4) {
      // all of this step's reads (four k of A's rows, B's four rows) before
      // its multiply-adds, so that a block of few warps waits on them once
      float a[TM][4], b[4][TN];
#pragma unroll
      for (int u = 0; u < TM; ++u)
        gemm::unpack(a[u], gemm::load4(reinterpret_cast<const TI*>(pa + u * ua + k * SZ)));
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          float q[4];
          gemm::unpack(q, gemm::load4(reinterpret_cast<const TI*>(pb + (k + t) * L.pitch_b
                                                                  + h * hb)));
#pragma unroll
          for (int w = 0; w < 4; ++w) b[t][4 * h + w] = q[w];
        }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int u = 0; u < TM; ++u)
#pragma unroll
          for (int v = 0; v < TN; ++v) acc[u][v] = fmaf(a[u][t], b[t][v], acc[u][v]);
    }
    if (!PACK) {  // read-modify-write of the O tile in O's dtype, then a fresh chunk
      store_tile(k0 > 0);
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) acc[u][v] = 0.f;
    }
  };

  gemm::run_ring((p.K + p.bk - 1) / p.bk, L.stages, load, compute);
  if (PACK) store_tile(false);
}

// The tensor cores' path (see the top of the file): f32 inputs in 3xTF32,
// bf16 inputs one m16n8k16 product a k step of 16.
template <typename TI, bool PACK, bool VEC16>
__global__ void __launch_bounds__(MAX_TC_THREADS) matmul_tc_kernel(Args p) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout& L = p.L;
  const TI* A = static_cast<const TI*>(p.A);
  const TI* B = static_cast<const TI*>(p.B);
  const bool bf16 = p.out_bf16;
  const int ti = p.interchange ? blockIdx.x : blockIdx.y;
  const int tj = p.interchange ? blockIdx.y : blockIdx.x;
  const int i0 = ti * p.bm, j0 = tj * p.bn;
  const int tid = threadIdx.x, nthreads = L.threads;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int r0 = warp / L.wc * WM, c0 = warp % L.wc * WN;  // the warp's piece
  constexpr int KSTEP = mma_k(sizeof(TI));

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // A's chunk is pm rows of kcp k; B's kcp rows of pn columns (kcp = bk
  // rounded up to the k step, less in a ragged last chunk, which plans anew)
  const gemm::Plan plan_a = gemm::plan_box<TI, VEC16>(L.pm, L.kfull, tid, nthreads);
  const gemm::Plan plan_b = gemm::plan_box<TI, VEC16>(L.kfull, L.pn, tid, nthreads);
  auto load = [&](int c, int slot) {
    char* sA = smem + slot * L.stage;
    char* sB = sA + L.a_bytes;
    const int k0 = c * p.bk, kc = min(p.bk, p.K - k0), kcp = gemm::round_up(kc, KSTEP);
    const bool full = kcp == L.kfull;
    gemm::copy_box<TI, VEC16>(
        full ? plan_a : gemm::plan_box<TI, VEC16>(L.pm, kcp, tid, nthreads), sA, L.pitch_a,
        A + (size_t)i0 * p.K + k0, p.K, min(L.pm, p.M - i0), kc, tid, nthreads);
    gemm::copy_box<TI, VEC16>(
        full ? plan_b : gemm::plan_box<TI, VEC16>(kcp, L.pn, tid, nthreads), sB, L.pitch_b,
        B + (size_t)k0 * p.N + j0, p.N, kc, min(L.pn, p.N - j0), tid, nthreads);
  };

  auto store_tile = [&](bool accumulate) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = c0 + MMA_N * nt + 2 * t, gc = j0 + c;
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the mma tile
          const int r = r0 + MMA_M * mt + g + 8 * h, gr = i0 + r;
          if (r >= p.bm || gr >= p.M) continue;
          const size_t o = (size_t)gr * p.N + gc;
          const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
          if (!accumulate && p.vec_out && c + 1 < p.bn && gc + 1 < p.N) {
            *reinterpret_cast<float2*>(static_cast<float*>(p.O) + o) = make_float2(v0, v1);
            continue;
          }
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            if (c + w >= p.bn || gc + w >= p.N) continue;
            float v = w ? v1 : v0;
            if (accumulate) v = load_out(p.O, bf16, o + w) + round_out(bf16, v);
            store_out(p.O, bf16, o + w, v);
          }
        }
      }
    }
  };

  auto compute = [&](int c, int slot) {
    const char* sA = smem + slot * L.stage;
    const char* sB = sA + L.a_bytes;
    const int k0 = c * p.bk, kcp = gemm::round_up(min(p.bk, p.K - k0), KSTEP);
    // the chunk's products in a fresh f32 tile, added into acc on the CUDA
    // cores (rounding to nearest): mma.sync's own f32 accumulation rounds
    // toward zero, so a sum carried through it over all of K drifts toward
    // zero as K grows (at K = 4096 the largest error was 1.5e-4 of the
    // output's rms, torch.matmul's 3.3e-6; H100, ab_kernels.py)
    float part[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
    if constexpr (sizeof(TI) == 4) {
      const int lda = L.pitch_a / 4, ldb = L.pitch_b / 4;  // in floats
      const float* pa = reinterpret_cast<const float*>(sA) + (r0 + g) * lda + t;
      const float* pb = reinterpret_cast<const float*>(sB) + t * ldb + c0 + g;
#pragma unroll 2
      for (int k = 0; k < kcp; k += KSTEP) {
        uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* q = pa + MMA_M * mt * lda + k;
          tf32::split(q[0], ah[mt][0], al[mt][0]);
          tf32::split(q[8 * lda], ah[mt][1], al[mt][1]);
          tf32::split(q[4], ah[mt][2], al[mt][2]);
          tf32::split(q[8 * lda + 4], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float* q = pb + k * ldb + MMA_N * nt;
          tf32::split(q[0], bh[nt][0], bl[nt][0]);
          tf32::split(q[4 * ldb], bh[nt][1], bl[nt][1]);
        }
        // the three terms in turn over the warp's mma tiles, so that each
        // round issues up to eight independent products
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            tf32::mma(part[mt][nt], al[mt], bh[nt]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            tf32::mma(part[mt][nt], ah[mt], bl[nt]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            tf32::mma(part[mt][nt], ah[mt], bh[nt]);
      }
    } else {
      // ldmatrix rows: lane l names row l % 8 of matrix l / 8. A's four
      // matrices are rows +0/+8 (bit 0) by k +0/+8 (bit 1): a0..a3; B's are
      // k +0/+8 (bit 0) by columns +0/+8 (bit 1): b0, b1 of two n8 tiles
      const int lr = (lane & 7) + 8 * ((lane >> 3) & 1), lk = 8 * (lane >> 4);
      const char* pa = sA + (r0 + lr) * L.pitch_a + lk * 2;
      const char* pb = sB + lr * L.pitch_b + (c0 + lk) * 2;
#pragma unroll 2
      for (int k = 0; k < kcp; k += KSTEP) {
        uint32_t a[MT][4], b[NT / 2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          bf16mma::ldmatrix_x4(a[mt], pa + MMA_M * mt * L.pitch_a + k * 2);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np)
          bf16mma::ldmatrix_x4_trans(b[np], pb + k * L.pitch_b + 2 * MMA_N * np * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            bf16mma::mma(part[mt][nt], a[mt], b[nt / 2][2 * (nt & 1)],
                         b[nt / 2][2 * (nt & 1) + 1]);
      }
    }
    // PACK: the running sum; else the chunk alone, for the read-modify-write
    // of the O tile in O's dtype
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][nt][e] = PACK ? acc[mt][nt][e] + part[mt][nt][e] : part[mt][nt][e];
    if (!PACK) store_tile(k0 > 0);
  };

  gemm::run_ring((p.K + p.bk - 1) / p.bk, L.stages, load, compute);
  if (PACK) store_tile(false);
}

// ---- SPLIT: the kernel -------------------------------------------------------

struct SplitArgs {
  const void* A; const void* B; void* O;
  int M, K, N, bm, bn, bk;
  int interchange, out_bf16, vec_out;
  int cg, ks, ka;        // the plan's column groups, k slices, A's piece
  int splits, kc;        // CTAs of a column tile (the cluster) and K a CTA
};

// 16 bytes of a row of B (4 f32, 8 bf16) as four words, in pieces of LB
// bytes (16 where the base, N and bn allow it; narrower otherwise). B is
// read once: the 16-byte form skips L1.
template <int LB>
__device__ __forceinline__ void ld_group(const void* p, uint32_t (&w)[4]) {
  if constexpr (LB == 16) {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "l"(p));
  } else if constexpr (LB == 8) {
    const uint2 a = __ldg(static_cast<const uint2*>(p)), b = __ldg(static_cast<const uint2*>(p) + 1);
    w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
  } else if constexpr (LB == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __ldg(static_cast<const unsigned int*>(p) + i);
  } else {
    const unsigned short* h = static_cast<const unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__ldg(h + 2 * i) | ((uint32_t)__ldg(h + 2 * i + 1) << 16);
  }
}

// the group's first `valid` elements (the ragged column edge), zeros past
template <typename TI>
__device__ __forceinline__ void ld_edge(const TI* p, int valid, uint32_t (&w)[4]) {
  if constexpr (sizeof(TI) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = i < valid ? __ldg(reinterpret_cast<const unsigned int*>(p) + i) : 0u;
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (2 * i < valid ? (uint32_t)__ldg(h + 2 * i) : 0u)
             | (2 * i + 1 < valid ? (uint32_t)__ldg(h + 2 * i + 1) << 16 : 0u);
  }
}

// the group's elements as f32 (bf16 widens exactly by a shift of its bits)
template <typename TI>
__device__ __forceinline__ void widen(const uint32_t (&w)[4], float (&b)[16 / sizeof(TI)]) {
  if constexpr (sizeof(TI) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[2 * i] = __uint_as_float(w[i] << 16);
      b[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// four consecutive columns of O from element o, the first `valid` of them;
// vec: one 16-byte (f32) or 8-byte (bf16) access; accumulate: the
// read-modify-write of pack=False (O + the value rounded to O's dtype)
__device__ __forceinline__ void store4(void* O, bool bf16, size_t o, float (&v)[4], int valid,
                                       bool vec, bool accumulate) {
  if (vec && valid == 4) {
    if (bf16) {
      uint2* q = reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(O) + o);
      if (accumulate) {
        const uint2 old = *q;
        v[0] = __uint_as_float(old.x << 16) + round_out(true, v[0]);
        v[1] = __uint_as_float(old.x & 0xffff0000u) + round_out(true, v[1]);
        v[2] = __uint_as_float(old.y << 16) + round_out(true, v[2]);
        v[3] = __uint_as_float(old.y & 0xffff0000u) + round_out(true, v[3]);
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      *q = make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
    } else {
      float4* q = reinterpret_cast<float4*>(static_cast<float*>(O) + o);
      if (accumulate) {
        const float4 old = *q;
        v[0] += old.x; v[1] += old.y; v[2] += old.z; v[3] += old.w;
      }
      *q = make_float4(v[0], v[1], v[2], v[3]);
    }
    return;
  }
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    if (w >= valid) break;
    float x = v[w];
    if (accumulate) x = load_out(O, bf16, o + w) + round_out(bf16, x);
    store_out(O, bf16, o + w, x);
  }
}

// One CTA: rank blockIdx.x of p.splits on column tile (ti, tj), K range
// [rank kc, (rank + 1) kc); TM rows (the tile's bm <= TM, zeros past M).
template <typename TI, int TM, int LB, bool PACK>
__global__ void __launch_bounds__(split::THREADS) matmul_split_kernel(SplitArgs p) {
  constexpr int VW = 16 / (int)sizeof(TI), U = split::U;
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);  // A's piece: [k][TM] f32
  float* red = sA + p.ka * TM;                  // [ks][TM][cw]: the threads' sums
  const TI* A = static_cast<const TI*>(p.A);
  const TI* B = static_cast<const TI*>(p.B);
  const bool bf16 = p.out_bf16;
  const int tid = threadIdx.x, nthreads = blockDim.x, ks = p.ks;
  const int g = tid % p.cg, s = tid / p.cg;
  const int rank = blockIdx.x, S = p.splits;
  const int ti = p.interchange ? blockIdx.y : blockIdx.z;
  const int tj = p.interchange ? blockIdx.z : blockIdx.y;
  const int i0 = ti * p.bm, j0 = tj * p.bn;
  const int rows = min(p.bm, p.M - i0), ncols = min(p.bn, p.N - j0);
  const int cw = p.cg * VW;                     // the block's columns (padded)
  const int cvalid = min(VW, ncols - g * VW);   // this thread's (<= 0: none)
  const TI* Bg = B + j0 + g * VW;
  const int kb = rank * p.kc, ke = min(p.K, kb + p.kc);

  float acc[TM][VW];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int v = 0; v < VW; ++v) acc[r][v] = 0.f;

  // U rows of B, k, k + ks, ..., those below c1
  auto load_round = [&](int k, int c1, uint32_t (&w)[U][4]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k + u * ks;
      if (kk < c1 && cvalid > 0) {
        const TI* q = Bg + (size_t)kk * p.N;
        if (cvalid == VW) ld_group<LB>(q, w[u]);
        else ld_edge(q, cvalid, w[u]);
      } else {
        w[u][0] = w[u][1] = w[u][2] = w[u][3] = 0u;
      }
    }
  };
  auto fma_round = [&](int k, int c1, int a0, const uint32_t (&w)[U][4]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k + u * ks;
      if (kk < c1) {
        float a[TM], b[VW];
        const float4* pa = reinterpret_cast<const float4*>(sA + (kk - a0) * TM);
#pragma unroll
        for (int r = 0; r < TM; r += 4) {
          const float4 x = pa[r / 4];
          a[r] = x.x; a[r + 1] = x.y; a[r + 2] = x.z; a[r + 3] = x.w;
        }
        widen<TI>(w[u], b);
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int v = 0; v < VW; ++v) acc[r][v] = fmaf(a[r], b[v], acc[r][v]);
      }
    }
  };
  // A's rows i0.. of k in [a0, a1) as f32 (k, row) pairs, zeros past M:
  // eight reads in flight a thread, then their stores (consecutive threads
  // store 16 bytes apart: a 16-byte read of a row's k would store its
  // elements 16 x VW bytes apart, on one bank, and ran the unembeds 12-20%
  // slower)
  auto stage_a = [&](int a0, int a1) {
    const int len = a1 - a0, total = TM * len;
    for (int e0 = tid; e0 < total; e0 += 8 * nthreads) {
      float v[8];
      int at[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = e0 + j * nthreads, r = e / len, kk = e - r * len;
        at[j] = e < total ? kk * TM + r : -1;
        v[j] = e < total && r < rows ? to_f32(A[(size_t)(i0 + r) * p.K + a0 + kk]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (at[j] >= 0) sA[at[j]] = v[j];
    }
  };
  // the block's sum in red[0 .. TM cw): each thread's, then every element
  // over the k slices in order
  auto reduce_block = [&]() {
    __syncthreads();  // the previous tile's readers are done with red
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int v = 0; v < VW; v += 4)
        *reinterpret_cast<float4*>(red + (s * TM + r) * cw + g * VW + v) =
            make_float4(acc[r][v], acc[r][v + 1], acc[r][v + 2], acc[r][v + 3]);
    __syncthreads();
    for (int e = 4 * tid; e < TM * cw; e += 4 * nthreads) {
      float4 t = *reinterpret_cast<const float4*>(red + e);
      for (int q = 1; q < ks; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(red + q * TM * cw + e);
        t.x += x.x; t.y += x.y; t.z += x.z; t.w += x.w;
      }
      *reinterpret_cast<float4*>(red + e) = t;
    }
    __syncthreads();
  };
  // this CTA's share of O's tile (4 columns a unit, units rank, rank + S,
  // ...), each the cluster's CTAs' sums added in rank order
  auto store_tile = [&](bool accumulate) {
    const int per_row = cw / 4;
    for (int u = tid * S + rank; u < TM * per_row; u += nthreads * S) {
      const int r = u / per_row, c = 4 * (u - r * per_row);
      if (r >= rows || c >= ncols) continue;
      float4* mine = reinterpret_cast<float4*>(red + r * cw + c);
      float4 t;
      if (S > 1) {
        cg::cluster_group cl = cg::this_cluster();
        t = *cl.map_shared_rank(mine, 0);
        for (int q = 1; q < S; ++q) {
          const float4 x = *cl.map_shared_rank(mine, q);
          t.x += x.x; t.y += x.y; t.z += x.z; t.w += x.w;
        }
      } else {
        t = *mine;
      }
      float v[4] = {t.x, t.y, t.z, t.w};
      store4(p.O, bf16, (size_t)(i0 + r) * p.N + j0 + c, v, min(4, ncols - c), p.vec_out,
             accumulate);
    }
  };

  const int seg = PACK ? p.ka : p.bk;  // pack=False: one bk chunk at a time
  for (int a0 = kb; a0 < ke; a0 += p.ka) {
    const int a1 = min(ke, a0 + p.ka);
    for (int c0 = a0; c0 < a1; c0 += seg) {
      const int c1 = min(a1, c0 + seg);
      uint32_t w0[U][4], w1[U][4];
      int k = c0 + s;
      load_round(k, c1, w0);  // in flight while A's piece is staged
      if (c0 == a0) {
        __syncthreads();      // every thread is done with the previous piece
        stage_a(a0, a1);
        __syncthreads();
      }
      for (; k < c1; k += 2 * U * ks) {
        load_round(k + U * ks, c1, w1);
        fma_round(k, c1, a0, w0);
        load_round(k + 2 * U * ks, c1, w0);
        fma_round(k + U * ks, c1, a0, w1);
      }
      if (!PACK) {
        reduce_block();
        store_tile(c0 > 0);
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int v = 0; v < VW; ++v) acc[r][v] = 0.f;
      }
    }
  }
  if (PACK) {
    reduce_block();
    if (S > 1) {
      cg::cluster_group cl = cg::this_cluster();
      cl.sync();  // every CTA's sum is in its shared memory
      store_tile(false);
      cl.sync();  // no CTA leaves while another still reads its sum
    } else {
      store_tile(false);
    }
  }
}

// ---- WGMMA: the kernel -------------------------------------------------------

struct WgmmaArgs {
  void* O;
  int M, K, N, bm, bn;
  int interchange, out_bf16, vec_out;
  int kc, kbox, a_box, b_box, stage, stages;
};

// GROUPS consumer warpgroups (64 rows each) and one producer warp; BN the
// instruction's N (64 or 128 columns)
template <int GROUPS, int BN>
__global__ void __launch_bounds__(128 * GROUPS + 32)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb, WgmmaArgs p) {
  constexpr int PM = 64 * GROUPS, R = BN / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((wg::ALIGN_SLACK - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)p.stages * p.stage);
  uint64_t* empty = full + p.stages;
  const int a_bytes = PM * p.kc * 2;
  const int ti = p.interchange ? blockIdx.x : blockIdx.y;
  const int tj = p.interchange ? blockIdx.y : blockIdx.x;
  const int i0 = ti * p.bm, j0 = tj * p.bn;
  const int nchunks = (p.K + p.kc - 1) / p.kc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * GROUPS);  // every consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * GROUPS) {  // the producer: one thread issues every copy
    if (lane == 0) {
      hopper::tma_prefetch_map(&ta);
      hopper::tma_prefetch_map(&tb);
      for (int c = 0; c < nchunks; ++c) {
        const int s = c % p.stages, use = c / p.stages;
        if (use > 0) hopper::mbar_wait(&empty[s], (use - 1) & 1);
        uint8_t* sa = smem + (size_t)s * p.stage;
        uint8_t* sb = sa + a_bytes;
        hopper::mbar_expect_tx(&full[s], p.stage);
        const int k0 = c * p.kc;
        for (int b = 0; b < p.kc / p.kbox; ++b)
          hopper::tma_load_2d(sa + b * p.a_box, &ta, &full[s], k0 + b * p.kbox, i0);
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          hopper::tma_load_2d(sb + b * p.b_box, &tb, &full[s], j0 + 64 * b, k0);
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 grp .. of the tile
  const int grp = warp >> 2;
  const uint64_t a_swizzle = p.kbox == 64 ? hopper::SWIZZLE_128B
                             : p.kbox == 32 ? hopper::SWIZZLE_64B : hopper::SWIZZLE_32B;
  const uint32_t a_stride = 16 * p.kbox;  // 8 rows of 2 kbox bytes
  // chunk c's k16 steps into d, fresh (scale-d 0 on the first)
  auto issue = [&](int c, float (&d)[R]) {
    const int s = c % p.stages;
    hopper::mbar_wait(&full[s], (c / p.stages) & 1);
    const uint8_t* sa = smem + (size_t)s * p.stage + grp * 64 * 2 * p.kbox;
    const uint8_t* sb = smem + (size_t)s * p.stage + a_bytes;
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
    hopper::wgmma_fence();
    for (int kk = 0; kk < p.kc; kk += 16) {
      const uint64_t da = hopper::desc(sa + (kk / p.kbox) * p.a_box + (kk % p.kbox) * 2, 16,
                                       a_stride, a_swizzle);
      const uint64_t db = hopper::desc(sb + kk * 128, p.b_box, 1024, hopper::SWIZZLE_128B);
      hopper::wgmma<BN>(d, da, db, kk > 0);
    }
    hopper::wgmma_commit();
  };
  // chunk c's products have completed: its stage goes back to the producer,
  // and d may be read
  auto release = [&](int c, float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
    if (lane == 0) hopper::mbar_arrive(&empty[c % p.stages]);
  };
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  // one fresh tile a chunk, added into the sum once its products complete
  // (the tensor cores' own f32 accumulation drifts over a long K: carried
  // across chunks, the largest error at K = 16,384 was 7.9e-5 of the
  // output's rms against 4.2e-6 for fresh tiles and 1.4e-6 for
  // torch.matmul in f32; M = N = 256, H100 80GB HBM3 at 700 W)
  float part[R];
#pragma unroll
  for (int i = 0; i < R; ++i) part[i] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    issue(c, part);
    hopper::wgmma_wait<0>();
    release(c, part);
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] += part[i];
  }

  const bool bf16 = p.out_bf16;
  const int w4 = warp & 3, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * grp + 16 * w4 + gq + 8 * h, c = 8 * j + 2 * tq;
      const int gr = i0 + r, gc = j0 + c;
      if (r >= p.bm || gr >= p.M || c >= p.bn || gc >= p.N) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      const size_t o = (size_t)gr * p.N + gc;
      const bool pair = c + 1 < p.bn && gc + 1 < p.N;
      if (p.vec_out && pair) {
        if (bf16)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.O) + o) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(p.O) + o) = make_float2(v0, v1);
      } else {
        store_out(p.O, bf16, o, v0);
        if (pair) store_out(p.O, bf16, o + 1, v1);
      }
    }
}

// ---- launchers -----------------------------------------------------------------

// `done`: the kernel's gemm::allow_smem record (one per instantiation)
template <typename F>
cudaError_t launch_kernel(F* kernel, const Args& p, long long (&done)[16],
                          cudaStream_t stream) {
  const int mi = (p.M + p.bm - 1) / p.bm, nj = (p.N + p.bn - 1) / p.bn;
  const dim3 grid = p.interchange ? dim3(mi, nj) : dim3(nj, mi);
  const cudaError_t e = gemm::allow_smem(kernel, p.L.bytes, done);
  if (e != cudaSuccess) return e;
  kernel<<<grid, p.L.threads, p.L.bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool PK>
cudaError_t launch_tc(const Args& p, bool vec16, cudaStream_t s) {
  static long long done[2][16] = {};
  return vec16 ? launch_kernel(matmul_tc_kernel<T, PK, true>, p, done[1], s)
               : launch_kernel(matmul_tc_kernel<T, PK, false>, p, done[0], s);
}

template <bool PK>
cudaError_t launch_tc(const Args& p, bool in_bf16, bool vec16, cudaStream_t s) {
  return in_bf16 ? launch_tc<__nv_bfloat16, PK>(p, vec16, s)
                 : launch_tc<float, PK>(p, vec16, s);
}

// FFMA: f32 operands only (bf16 tiles past 8 rows always fit a tensor-core
// stage)
template <bool PK, int RT>
cudaError_t launch_ffma(const Args& p, bool vec16, cudaStream_t s) {
  static long long done[2][16] = {};
  return vec16 ? launch_kernel(matmul_kernel<float, PK, RT, RT, true>, p, done[1], s)
               : launch_kernel(matmul_kernel<float, PK, RT, RT, false>, p, done[0], s);
}

template <bool PK>
cudaError_t launch_ffma(const Args& p, bool vec16, cudaStream_t s) {
  return p.L.tm == 8 ? launch_ffma<PK, 8>(p, vec16, s) : launch_ffma<PK, 4>(p, vec16, s);
}

template <typename T, int TM, int LB, bool PK>
cudaError_t launch_split(const SplitArgs& p, const split::Plan& q, cudaStream_t s) {
  static long long done[16] = {};
  auto* kernel = matmul_split_kernel<T, TM, LB, PK>;
  cudaError_t e = gemm::allow_smem(kernel, q.bytes, done);
  if (e != cudaSuccess) return e;
  const int mi = (p.M + p.bm - 1) / p.bm, nj = (p.N + p.bn - 1) / p.bn;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = p.interchange ? dim3(p.splits, mi, nj) : dim3(p.splits, nj, mi);
  cfg.blockDim = dim3(q.threads);
  cfg.dynamicSmemBytes = q.bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;  // one CTA a tile: a plain launch
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int TM, bool PK>
cudaError_t launch_split(const SplitArgs& p, const split::Plan& q, int lb, cudaStream_t s) {
  if (lb == 16) return launch_split<T, TM, 16, PK>(p, q, s);
  if (lb == 8) return launch_split<T, TM, 8, PK>(p, q, s);
  if constexpr (sizeof(T) == 2) {
    if (lb == 2) return launch_split<T, TM, 2, PK>(p, q, s);
  }
  return launch_split<T, TM, 4, PK>(p, q, s);
}

template <typename T>
cudaError_t launch_split(const SplitArgs& p, const split::Plan& q, int lb, bool pack,
                         cudaStream_t s) {
  if (q.tm == 4) return pack ? launch_split<T, 4, true>(p, q, lb, s)
                             : launch_split<T, 4, false>(p, q, lb, s);
  return pack ? launch_split<T, 8, true>(p, q, lb, s) : launch_split<T, 8, false>(p, q, lb, s);
}

// the split count for this instantiation's occupancy on the current device
// (the pack=True, 16-byte instance's: the others differ only in their
// loads), its slots a cluster size looked up once
template <typename T, int TM>
int split_count(int M, int K, int N, int bm, int bn, int pack, int sms, const split::Plan& q) {
  if (!pack) return 1;
  static long long done[16] = {};
  static long long slots[16][split::MAX_SPLIT + 1] = {};
  auto* kernel = matmul_split_kernel<T, TM, 16, true>;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 16
      || gemm::allow_smem(kernel, q.bytes, done) != cudaSuccess)
    return 1;
  long long* mine = slots[dev];
  for (int s = 1; s <= split::MAX_SPLIT; ++s) {
    if (mine[s] > 0) continue;
    int n = 0;
    if (s == 1) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, q.threads, q.bytes);
      mine[s] = (long long)n * sms;
    } else {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(s);
      cfg.blockDim = dim3(q.threads);
      cfg.dynamicSmemBytes = q.bytes;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = s;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      mine[s] = (long long)n * s;
    }
    if (mine[s] < 1) mine[s] = 1;
  }
  cudaGetLastError();  // an occupancy query that failed leaves no error behind
  const long long tiles = (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  return split::best_splits(tiles, (long long)K * bn * sizeof(T), K, pack, mine);
}

template <typename T>
int split_count(int M, int K, int N, int bm, int bn, int pack, int sms, const split::Plan& q) {
  return q.tm == 4 ? split_count<T, 4>(M, K, N, bm, bn, pack, sms, q)
                   : split_count<T, 8>(M, K, N, bm, bn, pack, sms, q);
}

// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint
// (so the library links no libcuda), looked up once
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                                  cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? (EncodeTiled)f : nullptr;
  }();
  return fn;
}

// a 2-D bf16 map of rows x cols (cols contiguous) in boxes of box_cols x
// box_rows, swizzled at box_cols * 2 bytes, zeros out of bounds
bool encode_map(CUtensorMap* map, const void* base, int rows, int cols, int box_cols,
                int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

template <int GROUPS, int BN>
cudaError_t launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb, const WgmmaArgs& p,
                         long long bytes, cudaStream_t s) {
  static long long done[16] = {};
  auto* kernel = matmul_wgmma_kernel<GROUPS, BN>;
  const cudaError_t e = gemm::allow_smem(kernel, bytes, done);
  if (e != cudaSuccess) return e;
  const int mi = (p.M + p.bm - 1) / p.bm, nj = (p.N + p.bn - 1) / p.bn;
  const dim3 grid = p.interchange ? dim3(mi, nj) : dim3(nj, mi);
  kernel<<<grid, 128 * GROUPS + 32, bytes, s>>>(ta, tb, p);
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const void* A, const void* B, void* O, int M, int K, int N, int bm,
                         int bn, int bk, int interchange, int out_bf16, int limit,
                         cudaStream_t s) {
  const wg::Plan w = wg::plan(bm, bn, bk, limit);
  CUtensorMap ta, tb;
  if (!encode_map(&ta, A, M, K, w.kbox, w.pm) || !encode_map(&tb, B, K, N, 64, w.kc))
    return cudaErrorInvalidValue;
  const int vec_out = gemm::aligned16(O) && N % 2 == 0 && bn % 2 == 0;
  const WgmmaArgs p{O, M, K, N, bm, bn, interchange, out_bf16, vec_out,
                    w.kc, w.kbox, w.a_box, w.b_box, w.stage, w.stages};
  if (w.groups == 2)
    return w.pn == 128 ? launch_wgmma<2, 128>(ta, tb, p, w.bytes, s)
                       : launch_wgmma<2, 64>(ta, tb, p, w.bytes, s);
  return w.pn == 128 ? launch_wgmma<1, 128>(ta, tb, p, w.bytes, s)
                     : launch_wgmma<1, 64>(ta, tb, p, w.bytes, s);
}

}  // namespace

extern "C" long long matmul_smem_bytes(int bm, int bn, int bk, int in_bf16, int limit) {
  if (bm < 1 || bn < 1 || bk < 1 || bm > gemm::MAX_TILE || bn > gemm::MAX_TILE) return -1;
  const int size = in_bf16 ? 2 : 4;
  if (bm <= gemm::ALIGN) return split::plan(bm, bn, bk, size).bytes;
  const long long ring = layout(bm, bn, bk, size, limit).bytes;
  if (!in_bf16) return ring;
  const long long w = wg::plan(bm, bn, bk, limit).bytes;  // the tile may take either route
  return ring > w ? ring : w;
}

extern "C" int matmul_splits(int M, int K, int N, int bm, int bn, int bk, int pack,
                             int in_bf16, int sms) {
  if (bm > gemm::ALIGN) return 1;
  const split::Plan q = split::plan(bm, bn, bk, in_bf16 ? 2 : 4);
  return in_bf16 ? split_count<__nv_bfloat16>(M, K, N, bm, bn, pack, sms, q)
                 : split_count<float>(M, K, N, bm, bn, pack, sms, q);
}

extern "C" int matmul_launch(const void* A, const void* B, void* O, int M, int K, int N,
                             int bm, int bn, int bk, int pack, int interchange,
                             int in_bf16, int out_bf16, int limit, int sms, void* stream,
                             long long* route) {
  const long long smem = matmul_smem_bytes(bm, bn, bk, in_bf16, limit);
  if (smem < 0 || smem > limit) return (int)cudaErrorInvalidValue;
  const int size = in_bf16 ? 2 : 4;
  cudaStream_t s = (cudaStream_t)stream;
  if (bm <= gemm::ALIGN) {
    *route = SPLIT;
    const split::Plan q = split::plan(bm, bn, bk, size);
    const int S = in_bf16 ? split_count<__nv_bfloat16>(M, K, N, bm, bn, pack, sms, q)
                          : split_count<float>(M, K, N, bm, bn, pack, sms, q);
    // B's loads: the widest piece the base, the row stride (N) and the tile
    // step (bn) keep aligned
    const uintptr_t b = reinterpret_cast<uintptr_t>(B);
    int lb = 16;
    while (lb > size && (b % lb || (N * size) % lb || (bn * size) % lb)) lb /= 2;
    // O's 4-column units: an aligned base, N and bn multiples of 4
    const int vec_out = (reinterpret_cast<uintptr_t>(O) % (out_bf16 ? 8 : 16)) == 0
                        && N % 4 == 0 && bn % 4 == 0;
    const SplitArgs p{A, B, O, M, K, N, bm, bn, bk, interchange, out_bf16, vec_out,
                      q.cg, q.ks, q.ka, S, (K + S - 1) / S};
    return (int)(in_bf16 ? launch_split<__nv_bfloat16>(p, q, lb, pack, s)
                         : launch_split<float>(p, q, lb, pack, s));
  }
  // TMA: 16-byte aligned bases and row strides
  if (in_bf16 && pack && gemm::aligned16(A) && gemm::aligned16(B) && K % 8 == 0 && N % 8 == 0
      && wg::plan(bm, bn, bk, limit).bytes <= limit) {
    *route = WGMMA;
    return (int)launch_wgmma(A, B, O, M, K, N, bm, bn, bk, interchange, out_bf16, limit, s);
  }
  // 16-byte pieces: aligned bases, row strides and chunk steps (K, N, bk
  // and bn whole 16-byte words), so no piece straddles a chunk or an edge
  const bool vec16 = gemm::aligned16(A) && gemm::aligned16(B) && (K * size) % 16 == 0
                     && (N * size) % 16 == 0 && (bk * size) % 16 == 0
                     && (bn * size) % 16 == 0;
  // vector stores of O (float4 in the FFMA kernel, float2 in the tensor
  // cores'): every tile's first column (tj*bn) and row (gr*N) start on a
  // 16-byte (8-byte) word
  const Layout L = layout(bm, bn, bk, size, limit);
  const int vec_out = !out_bf16 && gemm::aligned16(O)
                      && (L.tc ? N % 2 == 0 && bn % 2 == 0 : N % 4 == 0 && bn % 4 == 0);
  Args p{A, B, O, M, K, N, bm, bn, bk, interchange, out_bf16, vec_out, L};
  *route = L.tc ? MMA_SYNC : FFMA;
  if (!L.tc && in_bf16) return (int)cudaErrorInvalidValue;  // every bf16 tile fits a stage
  cudaError_t e;
  if (L.tc) e = pack ? launch_tc<true>(p, in_bf16, vec16, s) : launch_tc<false>(p, in_bf16, vec16, s);
  else e = pack ? launch_ffma<true>(p, vec16, s) : launch_ffma<false>(p, vec16, s);
  return (int)e;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
