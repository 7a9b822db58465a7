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
// GFLOP, 90 us at the 67 TFLOP/s f32 rate of the CUDA cores, against 36 MB
// of f32 operands and results over the three launches (11 us at 3.35 TB/s):
// compute-bound, on f32 FFMA like the f32 reference it is held to. The
// model's decode unembed, (4, 896) @ (896, 151936), is the other extreme:
// 1.1 GFLOP against 545 MB of B, bound by HBM bytes (0.163 ms).
//
// Design: the shared main loop of gemm_f32.cuh. One block per bm x bn tile
// of O, the tile padded to multiples of 8 (pm x pn); (pm/TM) x (pn/TN)
// threads, each with a TM x TN register tile: RT x RT (RT = 4 up to 64-wide
// tiles, 8 past), or 1 x 4 for an 8-row tile. Thread (ty, tx) owns rows
// ty + TY*u (interleaved, so a warp's reads of A's k-contiguous rows are
// free of bank conflicts) and columns 4tx + 4TX*h + w (four contiguous, so
// each read of B is one float4, and each store of an f32 O too where N and
// bn are multiples of 4; else four scalar stores). The block walks K in
// bk-deep chunks through a ring of shared-memory stages: A's chunk as pm rows
// of bk k-contiguous elements, B's as bk rows of pn n-contiguous ones, both
// in the input dtype, copied by cp.async (16-byte pieces where aligned,
// VEC16) and widened to f32 as the inner loop reads them. At a skinny M (the
// decode's unembed and output projection: bm clamped to 4, pm = 8) a tile is
// a 128-thread block that streams 8 KB of B a chunk with two more chunks in
// flight: the unembed's 2,374 such blocks keep HBM busy; the output
// projection's 14 (896 / 64 columns) leave most SMs idle, and with no split
// of K allowed each runs its 28 chunks in turn.
// The schedule knobs:
//   PACK=true   accumulate the whole K range in f32 registers and store O
//               once, in its dtype (the TPU kernel's f32 VMEM accumulator);
//   PACK=false  after every bk chunk, load the O tile, add the chunk's partial
//               product rounded to O's dtype, and store it again in O's dtype
//               (the TPU kernel's read-modify-write of the output block: the
//               knob's precision trade-off in bf16);
//   interchange which tile axis blockIdx.x walks: j (columns) by default, as
//               the TPU grid (i, j, k) runs j fastest; i with it.
// Ragged edges are zero-filled while staged and masked when stored. Every
// output element is summed in the same order (k ascending, one fmaf per
// term) whatever the tiles.
//
// Interface: matmul_smem_bytes() gives the dynamic shared memory a block
// needs for a tile under a device limit (the ring as deep as fits, -1 for a
// tile past 128), from the same layout() the launcher passes the kernel; the
// wrapper checks it against the limit before launch. matmul_launch()
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError(). Tile extents, the ring's depth, interchange and the
// output dtype are runtime values; the input dtype, PACK, the register tile
// (1x4, 4x4, 8x8) and the copy form are template parameters (24
// instantiations).

#include "gemm_f32.cuh"

namespace {

// Shared-memory layout of one block: `stages` stages, each A's chunk (pm
// rows, pitch_a bytes apart) then B's (round_up(bk, 4) rows, pitch_b bytes).
struct Layout {
  int pm, pn, tm, tn;       // padded tile extents, register tile per thread
  int pitch_a, pitch_b;     // row pitches, bytes
  int a_bytes, stage;       // A's chunk, one whole stage
  int stages;
  long long bytes;          // total dynamic shared memory
};

Layout layout(int bm, int bn, int bk, int size, long long limit) {
  Layout L;
  L.pm = gemm::round_up(bm, gemm::ALIGN);
  L.pn = gemm::round_up(bn, gemm::ALIGN);
  // an 8-row tile (a skinny M) gives each thread one row of four columns,
  // so that 8 x pn/4 threads stream B; otherwise RT x RT
  L.tm = L.pm == gemm::ALIGN ? 1 : gemm::reg_tile(L.pm, L.pn);
  L.tn = L.pm == gemm::ALIGN ? 4 : L.tm;
  L.pitch_a = gemm::kpitch(bk, size);
  L.pitch_b = gemm::round_up(L.pn * size, 16);
  L.a_bytes = L.pm * L.pitch_a;
  L.stage = L.a_bytes + gemm::round_up(bk, 4) * L.pitch_b;
  L.stages = gemm::ring_stages(L.stage, 0, limit);
  L.bytes = (long long)L.stages * L.stage;
  return L;
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
  const int kfull = gemm::round_up(p.bk, 4);
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

template <typename TI, bool PK, int TM, int TN, bool V16>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  const int mi = (p.M + p.bm - 1) / p.bm, nj = (p.N + p.bn - 1) / p.bn;
  const dim3 grid = p.interchange ? dim3(mi, nj) : dim3(nj, mi);
  const int threads = (p.L.pm / TM) * (p.L.pn / TN);
  if (p.L.bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(matmul_kernel<TI, PK, TM, TN, V16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.L.bytes);
    if (e != cudaSuccess) return e;
  }
  matmul_kernel<TI, PK, TM, TN, V16><<<grid, threads, p.L.bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename TI, bool PK, int TM, int TN>
cudaError_t launch_vec(const Args& p, bool vec16, cudaStream_t s) {
  return vec16 ? launch<TI, PK, TM, TN, true>(p, s) : launch<TI, PK, TM, TN, false>(p, s);
}

template <typename TI, bool PK>
cudaError_t launch_rt(const Args& p, bool vec16, cudaStream_t s) {
  if (p.L.tm == 1) return launch_vec<TI, PK, 1, 4>(p, vec16, s);
  if (p.L.tm == 8) return launch_vec<TI, PK, 8, 8>(p, vec16, s);
  return launch_vec<TI, PK, 4, 4>(p, vec16, s);
}

template <typename TI>
cudaError_t launch_pack(const Args& p, int pack, bool vec16, cudaStream_t s) {
  return pack ? launch_rt<TI, true>(p, vec16, s) : launch_rt<TI, false>(p, vec16, s);
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
  // float4 stores of O: every tile's first column (tj*bn) and row (gr*N)
  // start on a 16-byte word
  const int vec_out = !out_bf16 && gemm::aligned16(O) && N % 4 == 0 && bn % 4 == 0;
  Args p{A, B, O, M, K, N, bm, bn, bk, interchange, out_bf16, vec_out,
         layout(bm, bn, bk, size, limit)};
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = in_bf16 ? launch_pack<__nv_bfloat16>(p, pack, vec16, s)
                                : launch_pack<float>(p, pack, vec16, s);
  return (int)e;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
