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
// operations, 0.32 ms at 67 TFLOP/s (0.64 us a pass of two steps). Each
// operation is its own rounded instruction (no FMA contraction, to keep the
// reference's bits), so a pass is at least 13 instructions a point and step
// on the CUDA cores, plus what it costs to bring each point its six
// neighbours. The grid (6.9 MB) and its second buffer fit in the 50 MB L2,
// so device memory holds it back little.
//
// Design: a block owns a slab of bi planes along i (the knob) of a tile of
// TJ rows along j and TK = 120 columns along k, and marches along i through
// the slab and its FUSE_T-deep halo on either side, one plane at a time.
//   * Boxes: a plane of the tile is staged with its halo as TJ + 2*FUSE_T
//     rows of 128 floats (one warp's 32 segments of four), columns k0 - 4 ..
//     k0 + 123, so each row starts on a 16-byte word and is one coalesced
//     512-byte copy: warp r copies row r, lane l its four columns, by
//     cp.async (16 bytes where n2 is a whole number of 16-byte words, else
//     four 4-byte copies), zero-filled outside the grid.
//   * Streaming: the planes pass through a ring of RING = 6 in shared
//     memory, up to three ahead of the plane being computed in flight, one
//     barrier a plane (a plane's slot is refilled only after the barrier
//     that ends its last reads). Each thread keeps its four columns of
//     planes i-1, i and i+1 in registers, so a step reads only its j
//     neighbours (two float4) and its two k neighbours from shared memory
//     (shuffles for the k neighbours cost more: the compiler guards them for
//     divergence). A plane on a face or outside the grid is skipped by the
//     whole block.
//   * Fusion: with FUSE_T = 2 the second step lags the first by one plane
//     in the same march: the first step's plane goes to a two-plane buffer
//     in shared memory (for its j neighbours) and into the registers of the
//     thread that computed it (its own i neighbours), and the second step
//     reads it there; no second full-box buffer. The first step runs on rows
//     1 .. TJ + 2 and planes i0 - 1 .. i0 + bi of the box (the halo it has
//     to recompute), the second on rows 2 .. TJ + 1 and the slab. The
//     plane loop is unrolled by the ring's six slots, so slots are immediate
//     offsets and the registers of the three planes rotate by renaming
//     (slots and addresses computed per plane cost about as many
//     instructions as the stencil).
//   * Launch size: tile_rows() picks TJ (up to 20 rows with the halo
//     as warps of one block) for the fewest step rows on the busiest SM:
//     ceil(blocks / SMs) blocks, each a plane's rows of both steps, so the
//     grid is about one wave (at LARGE, bi = 8, fuse_t = 2: TJ = 15, 15 x 8
//     = 120 blocks of 19 warps on 132 SMs).
// What holds it (PERF.md, Findings): besides its stencil arithmetic a thread
// still spends about as many instructions a plane on addresses, bounds and
// masks (read from the compiled SASS), one block of 19 warps an SM hides
// little latency, and each pass pays a fixed cost (the launch, the march's
// first planes) that a deeper ring did not shorten.
// The interior mask uses global indices, so values staged from outside the
// grid (zeros) only ever feed points that keep their value, and the halo is
// read from global memory, so bi = 1 with fuse_t = 2 is right. The
// arithmetic is written with round-to-nearest intrinsics in the reference's
// order (no contraction into FMAs), so a pass gives the plain version's bits.
//
// heat3d_launch() runs all `passes` passes of one call from C, ping-ponging
// between two buffers so that the last pass writes O (the input is never
// written): one heat3d evaluation is one call from Python. The passes are
// launched with programmatic stream serialization, so a pass's blocks are
// launched as the one before it finishes and wait in griddepcontrol.wait:
// the launch gap between passes is hidden. It launches on
// the given stream, does not synchronise, and returns the first nonzero
// cudaGetLastError(). heat3d_plan() reports the launch one pass makes
// (TJ, blocks, threads and the dynamic shared memory a block carves its
// buffers from), from the same code the launcher uses. FUSE_T and the copy form are template parameters (4 instantiations).

#include <mutex>

#include "gemm_f32.cuh"

namespace {

constexpr int VK = 4;                     // k columns per thread: one float4
constexpr int BOXK = 32 * VK;             // floats of a staged row: one warp's
constexpr int HALO_K = 4;                 // staged columns before the tile's first
constexpr int TK = BOXK - 2 * HALO_K;     // the tile's k extent: 120
constexpr int RING = 6;                   // input planes in shared memory
constexpr int MAX_WARPS = 24;             // staged rows (warps) of one block
constexpr int MAX_THREADS = 32 * MAX_WARPS;

struct Args {
  const float* in; float* out;
  int n0, n1, n2, bi, tj;  // tj: the tile's j rows
  int nj, nk;              // tiles along j and k
};

// floats of one block's shared memory: RING input planes, and (FUSE_T = 2)
// two planes of the first step, each TJ + 2*FUSE_T rows of BOXK floats
__host__ __device__ inline int smem_floats(int tj, int h) {
  return BOXK * (tj + 2 * h) * (RING + (h == 2 ? 2 : 0));
}

// One masked step at four columns: c the point's values, ip/im its i+1/i-1
// neighbours, jp/jm its j neighbours, km/kp its k neighbours; in[e] says
// whether column e is an interior point.
__device__ __forceinline__ void step4(const float (&c)[4], const float (&ip)[4],
                                      const float (&im)[4], const float4 jp, const float4 jm,
                                      float km, float kp, const bool (&in)[4], float (&o)[4]) {
  const float jpv[4] = {jp.x, jp.y, jp.z, jp.w}, jmv[4] = {jm.x, jm.y, jm.z, jm.w};
  const float kpv[4] = {c[1], c[2], c[3], kp}, kmv[4] = {km, c[0], c[1], c[2]};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float a = c[e], a2 = __fmul_rn(2.f, a);
    const float di = __fadd_rn(__fsub_rn(ip[e], a2), im[e]);
    const float dj = __fadd_rn(__fsub_rn(jpv[e], a2), jmv[e]);
    const float dk = __fadd_rn(__fsub_rn(kpv[e], a2), kmv[e]);
    const float v = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(0.125f, di), __fmul_rn(0.125f, dj)),
                                        __fmul_rn(0.125f, dk)),
                              a);
    o[e] = in[e] ? v : a;
  }
}

template <int J> struct Int { static constexpr int value = J; };

__device__ __forceinline__ void lds4(const float* p, float (&x)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
}

template <int H, bool VEC16>
__global__ void __launch_bounds__(MAX_THREADS) heat3d_kernel(Args p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rows = p.tj + 2 * H, plane = rows * BOXK;
  float* ring = smem;                 // [RING][rows][BOXK]
  float* s1 = smem + RING * plane;    // [2][rows][BOXK] (H = 2)
  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;  // row r, columns VK*lane ..
  int b = blockIdx.x;
  const int tk = b % p.nk;
  b /= p.nk;
  const int i0 = b / p.nj * p.bi, j0 = b % p.nj * p.tj, k0 = tk * TK;
  const int gj = j0 - H + r, gk = k0 - HALO_K + VK * lane;  // this thread's row and columns
  const int nplanes = p.bi + 2 * H;                          // global i of plane q: i0 - H + q
  const long long s0 = (long long)p.n1 * p.n2;
  const bool row_in = gj >= 0 && gj < p.n1;
  const int own = r * BOXK + VK * lane;  // this thread's float4 in a staged plane
  const bool first = r >= 1 && r <= rows - 2;           // rows of the first step
  const bool second = H == 2 && r >= 2 && r <= rows - 3;  // and of the second
  // per column: interior along j and k; copied (inside the grid); stored
  // (the tile's, inside the grid). With VEC16 (n2 % 4 == 0) the four
  // columns are all inside or all outside.
  bool kin[4], cin[4], sin[4];
  const int kend = min(k0 + TK, p.n2);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = VEC16 ? gk : gk + e;
    kin[e] = gj > 0 && gj < p.n1 - 1 && gk + e > 0 && gk + e < p.n2 - 1;
    cin[e] = row_in && k >= 0 && k < p.n2;
    sin[e] = gj < p.n1 && k >= k0 && k < kend;
  }
  // element offset of this thread's first column at plane q: off0 + q * s0
  const long long off0 = (long long)(i0 - H) * s0 + (long long)gj * p.n2 + gk;
  const int iend = min(i0 + p.bi, p.n0);

  auto load = [&](int q, long long off, float* dst) {  // plane q (at off) into a ring slot
    const int gi = i0 - H + q;
    const bool in = gi >= 0 && gi < p.n0;
    const float* src = p.in + (in ? off : 0);
    if (VEC16) {
      gemm::cp_async16(dst, in && cin[0] ? src : p.in, in && cin[0] ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        gemm::cp_async4(dst + e, in && cin[e] ? src + e : p.in, in && cin[e] ? 4 : 0);
    }
  };

  auto store = [&](int q, long long off, const float (&o)[4]) {
    if (i0 - H + q >= iend) return;
    float* dst = p.out + off;
    if (VEC16) {
      if (sin[0]) *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (sin[e]) dst[e] = o[e];
    }
  };

  // one masked step of this thread's four columns at plane q (pl: its
  // float4 of the staged plane, whose row holds the k neighbours and whose
  // rows r +- 1 the j neighbours) with its values c and i neighbours ip, im.
  // A plane on a face or outside the grid keeps its values: the whole block
  // skips it (gi is the same for every thread). For lanes 0 and 31 a k
  // neighbour is a column of the next row: it only feeds columns never used.
  auto step = [&](const float* pl, int q, const float (&c)[4], const float (&ip)[4],
                  const float (&im)[4], float (&o)[4]) {
    const int gi = i0 - H + q;
    if (gi <= 0 || gi >= p.n0 - 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = c[e];
      return;
    }
    const float4 jp = *reinterpret_cast<const float4*>(pl + BOXK);
    const float4 jm = *reinterpret_cast<const float4*>(pl - BOXK);
    step4(c, ip, im, jp, jm, pl[-1], pl[VK], kin, o);
  };

  // plane q = q0 + J, J = q % RING a constant (the loop is unrolled by the
  // ring's length, so every slot is an immediate offset): wait for it, then
  // (one barrier) prefetch plane q + RING - 2 into the slot of plane q - 2,
  // which no warp reads after the barrier; the first step at plane q - 1
  // writes its plane to s1 slot (q - 1) & 1, and the second step at plane
  // q - 2 reads s1 slot q & 1, which the first step of plane q - 1 wrote
  // before this barrier. a* and s* are this column's input at planes q-2,
  // q-1, q and first step at q-3, q-2, q-1, passed rotated so that the
  // registers are renamed, not moved. `base` is the offset of plane q0.
  auto plane_step = [&](auto jc, int q, long long base, const float (&a_prev)[4],
                        const float (&a_cur)[4], float (&a_next)[4], const float (&s_prev)[4],
                        const float (&s_cur)[4], float (&s_next)[4]) {
    constexpr int J = decltype(jc)::value;
    gemm::cp_async_wait<RING - 3>();  // plane q has landed; q+1 .. q+3 may be in flight
    __syncthreads();
    if (q + RING - 2 < nplanes)
      load(q + RING - 2, base + (J + RING - 2) * s0, ring + ((J + RING - 2) % RING) * plane + own);
    gemm::cp_async_commit();
    lds4(ring + J * plane + own, a_next);
    if (q >= 2 && first) {  // the first step at plane q - 1 (warp-uniform)
      float o[4];
      step(ring + ((J + RING - 1) % RING) * plane + own, q - 1, a_cur, a_next, a_prev, o);
      if (H == 1) {
        store(q - 1, base + (J - 1) * s0, o);
      } else {
        *reinterpret_cast<float4*>(s1 + ((J + 1) & 1) * plane + own) =
            make_float4(o[0], o[1], o[2], o[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) s_next[e] = o[e];
      }
    }
    if (q >= 4 && second) {  // the second step at plane q - 2
      float o[4];
      step(s1 + (J & 1) * plane + own, q - 2, s_cur, s_next, s_prev, o);
      store(q - 2, base + (J - 2) * s0, o);
    }
  };

  // programmatic dependent launch: the block may have started while the
  // pass before it drains; wait for that grid's writes of the input (and
  // its reads of the buffer this pass writes) before touching either
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int q = 0; q < RING - 2; ++q) {
    if (q < nplanes) load(q, off0 + q * s0, ring + q * plane + own);
    gemm::cp_async_commit();
  }
  float a0[4], a1[4], a2[4], t0[4], t1[4], t2[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) a0[e] = a1[e] = a2[e] = t0[e] = t1[e] = t2[e] = 0.f;
  static_assert(RING == 6, "the plane loop below is unrolled by RING; the registers rotate by 3");
  for (int q0 = 0; q0 < nplanes; q0 += RING) {
    const long long base = off0 + q0 * s0;
    plane_step(Int<0>{}, q0, base, a0, a1, a2, t0, t1, t2);
    if (q0 + 1 < nplanes) plane_step(Int<1>{}, q0 + 1, base, a1, a2, a0, t1, t2, t0);
    if (q0 + 2 < nplanes) plane_step(Int<2>{}, q0 + 2, base, a2, a0, a1, t2, t0, t1);
    if (q0 + 3 < nplanes) plane_step(Int<3>{}, q0 + 3, base, a0, a1, a2, t0, t1, t2);
    if (q0 + 4 < nplanes) plane_step(Int<4>{}, q0 + 4, base, a1, a2, a0, t1, t2, t0);
    if (q0 + 5 < nplanes) plane_step(Int<5>{}, q0 + 5, base, a2, a0, a1, t2, t0, t1);
  }
  gemm::cp_async_wait<0>();
  // the march is done: the next pass may launch (its blocks wait above).
  // Triggered at the start instead, the waiting blocks held SMs that a grid
  // of more than one wave still needed, and larger slabs ran slower.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int H, bool VEC16>
cudaError_t set_smem(long long bytes) {
  static long long done[16] = {};
  return gemm::allow_smem(heat3d_kernel<H, VEC16>, bytes, done);
}

// The tile's j rows for this grid and slab: of the tiles whose block (TJ +
// 2H warps) fits an SM, the one with the fewest step rows on the busiest SM,
// ceil(blocks / SMs) * (rows of the first step, if fused, + TJ); ties to the
// larger TJ. 0 if none fits. Cached per device and shape: the occupancy
// queries cost microseconds, a heat3d call is one launcher call.
template <int H>
int tile_rows(int n0, int n1, int n2, int bi) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  struct Entry { int dev, n0, n1, n2, bi, tj; };
  constexpr int SLOTS = 64;
  static std::mutex mu;
  static Entry cache[SLOTS];
  static int filled = 0, next = 0;  // entries in use; the slot the next one takes
  std::lock_guard<std::mutex> lock(mu);
  for (int c = 0; c < filled; ++c)
    if (cache[c].dev == dev && cache[c].n0 == n0 && cache[c].n1 == n1 && cache[c].n2 == n2
        && cache[c].bi == bi)
      return cache[c].tj;
  const long long base = (long long)cdiv(n0, bi) * cdiv(n2, TK);
  int best = 0;
  long long best_cost = 0;
  for (int tj = 1; tj <= MAX_WARPS - 2 * H && tj <= n1; ++tj) {
    const long long bytes = 4LL * smem_floats(tj, H);
    int occ = 0;
    if (set_smem<H, false>(bytes) != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, heat3d_kernel<H, false>,
                                                         32 * (tj + 2 * H), bytes) != cudaSuccess
        || occ < 1)
      continue;
    const long long blocks = base * cdiv(n1, tj);
    const long long cost = (blocks + sms - 1) / sms * ((H == 2 ? tj + 2 : 0) + tj);
    if (best == 0 || cost <= best_cost) {
      best = tj;
      best_cost = cost;
    }
  }
  cudaGetLastError();  // clear a refused attribute of a tile that did not fit
  if (best > 0) {
    cache[next] = Entry{dev, n0, n1, n2, bi, best};
    next = (next + 1) % SLOTS;
    if (filled < SLOTS) ++filled;
  }
  return best;
}

// One pass's launch for this grid and slab on the current card (tj = 0 if
// no tile fits): the launcher launches it, heat3d_plan() reports it.
struct Plan { int tj, nj, nk, blocks, threads; long long bytes; };

template <int H>
Plan make_plan(int n0, int n1, int n2, int bi) {
  Plan pl = {};
  pl.tj = tile_rows<H>(n0, n1, n2, bi);
  if (pl.tj < 1) return pl;
  pl.nj = cdiv(n1, pl.tj);
  pl.nk = cdiv(n2, TK);
  pl.blocks = cdiv(n0, bi) * pl.nj * pl.nk;
  pl.threads = 32 * (pl.tj + 2 * H);
  pl.bytes = 4LL * smem_floats(pl.tj, H);
  return pl;
}

// All passes of one call: the last pass writes O, the one before it T, and
// so on back, the first reading A.
template <int H, bool VEC16>
cudaError_t run_passes(const float* A, float* O, float* T, int n0, int n1, int n2, int bi,
                       int passes, cudaStream_t stream) {
  const Plan pl = make_plan<H>(n0, n1, n2, bi);
  if (pl.tj < 1) return cudaErrorInvalidConfiguration;
  cudaError_t e = set_smem<H, VEC16>(pl.bytes);
  if (e != cudaSuccess) return e;
  // each pass may launch while the one before it drains (programmatic
  // stream serialization): the kernel waits for its input with
  // griddepcontrol.wait before it reads or writes global memory
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.blocks);
  cfg.blockDim = dim3(pl.threads);
  cfg.dynamicSmemBytes = pl.bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const float* src = A;
  for (int q = 0; q < passes; ++q) {
    float* dst = (passes - 1 - q) % 2 == 0 ? O : T;
    e = cudaLaunchKernelEx(&cfg, heat3d_kernel<H, VEC16>, Args{src, dst, n0, n1, n2, bi, pl.tj, pl.nj, pl.nk});
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace

// out = {tj, blocks, threads, dynamic shared memory bytes} of one pass, as
// heat3d_launch() launches it; {0, 0, 0, -1} where no tile fits.
extern "C" int heat3d_plan(int n0, int n1, int n2, int bi, int fuse_t, long long* out) {
  if (fuse_t < 1 || fuse_t > 2 || n0 < 1 || n1 < 1 || n2 < 1 || bi < 1)
    return (int)cudaErrorInvalidValue;
  const Plan pl = fuse_t == 2 ? make_plan<2>(n0, n1, n2, bi) : make_plan<1>(n0, n1, n2, bi);
  out[0] = pl.tj;
  out[1] = pl.blocks;
  out[2] = pl.threads;
  out[3] = pl.tj > 0 ? pl.bytes : -1;
  return (int)cudaSuccess;
}

extern "C" int heat3d_launch(const void* A, void* O, void* T, int n0, int n1, int n2, int bi,
                             int fuse_t, int passes, void* stream) {
  if (fuse_t < 1 || fuse_t > 2 || n0 < 1 || n1 < 1 || n2 < 1 || bi < 1 || passes < 1)
    return (int)cudaErrorInvalidValue;
  const float* a = (const float*)A;
  float *o = (float*)O, *t = (float*)T;
  // 16-byte copies and stores: aligned buffers and rows of whole 16-byte words
  const bool vec16 = gemm::aligned16(A) && gemm::aligned16(O) && gemm::aligned16(T)
                     && n2 % 4 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (fuse_t == 2)
    e = vec16 ? run_passes<2, true>(a, o, t, n0, n1, n2, bi, passes, s)
              : run_passes<2, false>(a, o, t, n0, n1, n2, bi, passes, s);
  else
    e = vec16 ? run_passes<1, true>(a, o, t, n0, n1, n2, bi, passes, s)
              : run_passes<1, false>(a, o, t, n0, n1, n2, bi, passes, s);
  return (int)e;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
