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
// GFLOP, 36 us at the 165 TFLOP/s of 3xTF32 on the tensor cores (90 us at
// the 67 TFLOP/s of f32 FFMA on the CUDA cores), against 36 MB of f32
// operands and results over the three launches (11 us at 3.35 TB/s):
// compute-bound. The model's decode unembed, (4, 896) @ (896, 151936), is
// the other extreme: 1.1 GFLOP against 545 MB of B, bound by HBM bytes
// (0.163 ms).
//
// Design: one block per bm x bn tile of O. The block walks K in bk-deep
// chunks through gemm_f32.cuh's ring of shared-memory stages: A's chunk as
// rows of k-contiguous elements (padded to an odd number of 16-byte words),
// B's as rows of n-contiguous ones, both in the input dtype, copied by
// cp.async (16-byte pieces where aligned, VEC16).
//   * f32 inputs past 8 rows run on the tensor cores in 3xTF32
//     (gemm_tf32.cuh): each f32 value is split into two TF32 parts as it is
//     read from shared memory, and three mma.sync.m16n8k8 products with f32
//     accumulation (lo*hi, hi*lo, hi*hi) keep about f32's accuracy. Warp
//     (wr, wc) of (pm/32) x (pn/32) warps holds a 32 x 32 piece of the tile
//     as 2 x 4 mma tiles (32 f32 accumulators a thread); the tile is staged
//     padded to whole pieces (a 24-row tile computes 32 rows, a 40-row one
//     64; rows and columns past the operands are zeros), so that no mma runs
//     under a predicate (a version that skipped the padding's mma tiles
//     under predicates ran markedly slower). Each
//     k step of 8 reads 16 A and 8 B values a thread (fragment reads free of
//     bank conflicts: A's odd pitch, B's pitch 8 words past a multiple of 32)
//     for 24 mma; a chunk is padded to a multiple of 8 in k with zeros.
//   * bf16 inputs, f32 tiles of at most 8 rows, and the few f32 tiles whose
//     padded layout does not fit the shared memory (128-row tiles with
//     chunks of 192 or 256) keep the FFMA loop: the
//     tile padded to multiples of 8 (pm x pn); (pm/TM) x (pn/TN) threads,
//     each with a TM x TN register tile: RT x RT (RT = 4 up to 64-wide
//     tiles, 8 past), or 1 x 4 for an 8-row tile. Thread (ty, tx) owns rows
//     ty + TY*u (interleaved, so a warp's reads of A's k-contiguous rows are
//     free of bank conflicts) and columns 4tx + 4TX*h + w (four contiguous,
//     so each read of B is one piece), widened to f32 as the inner loop
//     reads them. At a skinny M (the decode's unembed and output projection:
//     bm clamped to 4) an 8-row tile is a 128-thread block that streams 8 KB
//     of B a chunk with two more chunks in flight: bound by B's bytes, where
//     the tensor cores would buy nothing (they ran the decode unembed 1.7x
//     slower, padded to 16 rows).
// The schedule knobs:
//   PACK=true   accumulate the whole K range in f32 registers and store O
//               once, in its dtype (the TPU kernel's f32 VMEM accumulator);
//   PACK=false  after every bk chunk, load the O tile, add the chunk's partial
//               product rounded to O's dtype, and store it again in O's dtype
//               (the TPU kernel's read-modify-write of the output block: the
//               knob's precision trade-off in bf16);
//   interchange which tile axis blockIdx.x walks: j (columns) by default, as
//               the TPU grid (i, j, k) runs j fastest; i with it.
// Ragged edges are zero-filled while staged and masked when stored. K is
// walked in ascending chunks and k steps, with no split of K across blocks,
// whatever the tiles.
//
// Interface: matmul_smem_bytes() gives the dynamic shared memory a block
// needs for a tile and input dtype under a device limit (the ring as deep
// as fits, -1 for a tile past 128), from the same layout() the launcher
// passes the kernel; the wrapper checks it against the limit before launch.
// matmul_launch() launches on the given stream, does not synchronise, and
// returns cudaGetLastError(). Tile extents, the ring's depth, interchange
// and the output dtype are runtime values; PACK and the copy form are
// template parameters of both kernels, and of the FFMA kernel also the
// input dtype and register tile (1x4, 4x4, 8x8): 4 tensor-core and 24 FFMA
// instantiations.

#include "gemm_f32.cuh"
#include "gemm_tf32.cuh"

namespace {

constexpr int MMA_M = 16, MMA_N = 8, MMA_K = 8;
constexpr int WM = 32, WN = 32;             // a warp's piece of the tile (tensor cores)
constexpr int MT = WM / MMA_M, NT = WN / MMA_N;
constexpr int MAX_TC_THREADS = 32 * (gemm::MAX_TILE / WM) * (gemm::MAX_TILE / WN);  // 512

// Shared-memory layout of one block: `stages` stages, each A's chunk (pm
// rows of kfull elements, pitch_a bytes apart) then B's (kfull rows,
// pitch_b bytes). Tensor cores: pm and pn padded to 32, kfull to 8, B rows
// padded by 8 words; FFMA: pm and pn padded to 8, kfull to 4.
struct Layout {
  bool tc;                  // the tensor cores' kernel (f32 past 8 rows)
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
    L.kfull = gemm::round_up(bk, MMA_K);
    // B's fragment reads: lanes (t, g) read row t, column g, so rows 8 mod
    // 32 words apart put the four rows on distinct banks
    L.pitch_b = 4 * (L.pn + 8);
  } else {
    L.pm = gemm::round_up(bm, gemm::ALIGN);
    L.pn = gemm::round_up(bn, gemm::ALIGN);
    // an 8-row tile (a skinny M) gives each thread one row of four columns,
    // so that 8 x pn/4 threads stream B; otherwise RT x RT
    L.tm = L.pm == gemm::ALIGN ? 1 : gemm::reg_tile(L.pm, L.pn);
    L.tn = L.pm == gemm::ALIGN ? 4 : L.tm;
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

// f32 tiles past 8 rows take the tensor cores where one stage of their
// padded layout fits the limit; the others, and bf16, the FFMA loop (so the
// tensor cores refuse no tile of the gpu space that the FFMA loop takes)
Layout layout(int bm, int bn, int bk, int size, long long limit) {
  if (size == 4 && bm > gemm::ALIGN) {
    const Layout L = layout(bm, bn, bk, size, limit, true);
    if (L.bytes <= limit) return L;
  }
  return layout(bm, bn, bk, size, limit, false);
}

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

// The f32 path: 3xTF32 on the tensor cores (see the top of the file).
template <bool PACK, bool VEC16>
__global__ void __launch_bounds__(MAX_TC_THREADS) matmul_tf32_kernel(Args p) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout& L = p.L;
  const float* A = static_cast<const float*>(p.A);
  const float* B = static_cast<const float*>(p.B);
  const bool bf16 = p.out_bf16;
  const int ti = p.interchange ? blockIdx.x : blockIdx.y;
  const int tj = p.interchange ? blockIdx.y : blockIdx.x;
  const int i0 = ti * p.bm, j0 = tj * p.bn;
  const int tid = threadIdx.x, nthreads = L.threads;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int r0 = warp / L.wc * WM, c0 = warp % L.wc * WN;  // the warp's piece
  const int lda = L.pitch_a / 4, ldb = L.pitch_b / 4;       // in floats

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // A's chunk is pm rows of kcp k; B's kcp rows of pn columns (kcp = bk
  // rounded up to 8, less in a ragged last chunk, which plans anew)
  const gemm::Plan plan_a = gemm::plan_box<float, VEC16>(L.pm, L.kfull, tid, nthreads);
  const gemm::Plan plan_b = gemm::plan_box<float, VEC16>(L.kfull, L.pn, tid, nthreads);
  auto load = [&](int c, int slot) {
    char* sA = smem + slot * L.stage;
    char* sB = sA + L.a_bytes;
    const int k0 = c * p.bk, kc = min(p.bk, p.K - k0), kcp = gemm::round_up(kc, MMA_K);
    const bool full = kcp == L.kfull;
    gemm::copy_box<float, VEC16>(
        full ? plan_a : gemm::plan_box<float, VEC16>(L.pm, kcp, tid, nthreads), sA, L.pitch_a,
        A + (size_t)i0 * p.K + k0, p.K, min(L.pm, p.M - i0), kc, tid, nthreads);
    gemm::copy_box<float, VEC16>(
        full ? plan_b : gemm::plan_box<float, VEC16>(kcp, L.pn, tid, nthreads), sB, L.pitch_b,
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
    const float* sA = reinterpret_cast<const float*>(smem + slot * L.stage);
    const float* sB = reinterpret_cast<const float*>(smem + slot * L.stage + L.a_bytes);
    const int k0 = c * p.bk, kcp = gemm::round_up(min(p.bk, p.K - k0), MMA_K);
    const float* pa = sA + (r0 + g) * lda + t;
    const float* pb = sB + t * ldb + c0 + g;
#pragma unroll 2
    for (int k = 0; k < kcp; k += MMA_K) {
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
          tf32::mma(acc[mt][nt], al[mt], bh[nt]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          tf32::mma(acc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          tf32::mma(acc[mt][nt], ah[mt], bh[nt]);
    }
    if (!PACK) {  // read-modify-write of the O tile in O's dtype, then a fresh chunk
      store_tile(k0 > 0);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  };

  gemm::run_ring((p.K + p.bk - 1) / p.bk, L.stages, load, compute);
  if (PACK) store_tile(false);
}

template <typename F>
cudaError_t launch_kernel(F* kernel, const Args& p, cudaStream_t stream) {
  const int mi = (p.M + p.bm - 1) / p.bm, nj = (p.N + p.bn - 1) / p.bn;
  const dim3 grid = p.interchange ? dim3(mi, nj) : dim3(nj, mi);
  if (p.L.bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.L.bytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, p.L.threads, p.L.bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool PK>
cudaError_t launch_tf32(const Args& p, bool vec16, cudaStream_t s) {
  return vec16 ? launch_kernel(matmul_tf32_kernel<PK, true>, p, s)
               : launch_kernel(matmul_tf32_kernel<PK, false>, p, s);
}

template <typename T, bool PK, int TM, int TN>
cudaError_t launch_vec(const Args& p, bool vec16, cudaStream_t s) {
  return vec16 ? launch_kernel(matmul_kernel<T, PK, TM, TN, true>, p, s)
               : launch_kernel(matmul_kernel<T, PK, TM, TN, false>, p, s);
}

template <typename T, bool PK>
cudaError_t launch_ffma(const Args& p, bool vec16, cudaStream_t s) {
  if (p.L.tm == 1) return launch_vec<T, PK, 1, 4>(p, vec16, s);
  if (p.L.tm == 8) return launch_vec<T, PK, 8, 8>(p, vec16, s);
  return launch_vec<T, PK, 4, 4>(p, vec16, s);
}

template <bool PK>
cudaError_t launch_ffma(const Args& p, bool in_bf16, bool vec16, cudaStream_t s) {
  return in_bf16 ? launch_ffma<__nv_bfloat16, PK>(p, vec16, s)
                 : launch_ffma<float, PK>(p, vec16, s);
}

}  // namespace

extern "C" long long matmul_smem_bytes(int bm, int bn, int bk, int in_bf16, int limit) {
  if (bm < 1 || bn < 1 || bk < 1 || bm > gemm::MAX_TILE || bn > gemm::MAX_TILE) return -1;
  return layout(bm, bn, bk, in_bf16 ? 2 : 4, limit).bytes;
}

extern "C" int matmul_launch(const void* A, const void* B, void* O, int M, int K, int N,
                             int bm, int bn, int bk, int pack, int interchange,
                             int in_bf16, int out_bf16, int limit, void* stream) {
  const long long smem = matmul_smem_bytes(bm, bn, bk, in_bf16, limit);
  if (smem < 0 || smem > limit) return (int)cudaErrorInvalidValue;
  const int size = in_bf16 ? 2 : 4;
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
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (p.L.tc) e = pack ? launch_tf32<true>(p, vec16, s) : launch_tf32<false>(p, vec16, s);
  else e = pack ? launch_ffma<true>(p, in_bf16, vec16, s) : launch_ffma<false>(p, in_bf16, vec16, s);
  return (int)e;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
