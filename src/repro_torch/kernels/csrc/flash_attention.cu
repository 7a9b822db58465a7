// Flash attention forward on Hopper: O = softmax(Q K^T * scale + mask) V per
// row of BH (batch*heads), Q BH x Sq x hd, K/V BH x Sk x hd, f32 or bf16
// inputs (all three the same), f32 math, output in the inputs' dtype.
//
// Replaces: src/repro/kernels/flash_attention.py:_flash_kernel (the Pallas
// TPU kernel behind repro.kernels.flash_attention.flash_attention).
//
// What bounds it on an H100: two products per (q, k) pair, 4*BH*Sq*Sk*hd
// flops (half of that under the causal mask), against the compulsory
// traffic of Q, K, V read once and O written once. At the LARGE serving
// shape (BH=16, S=4096, hd=128, causal) that is 68.7 GFLOP, 1.03 ms at the
// 67 TFLOP/s f32 rate of the CUDA cores, against 134 MB (40 us at 3.35
// TB/s): compute-bound. The products run as f32 FFMA on the CUDA cores, as
// the f32 reference does, so the loop has to keep the FFMA pipes fed from
// shared memory with few other instructions, and the copies out of its way.
//
// Design: one block per (row of BH, bq-row tile of Q) of 4*bq threads; the
// TPU grid's sequential key axis becomes a loop inside the block.
//   * Staging: the Q tile once, then each bk-key block's K and V as two
//     chunks of gemm_f32.cuh's cp.async ring (run_ring, up to two stages of
//     one bk x hd tile each), so V's copies run under the score pass and the
//     next K's under the P V pass; two barriers a key block. Tiles keep
//     their global orientation and input dtype (K is not transposed), in
//     16-byte pieces where the operands are aligned, zero-filled past Sq and
//     Sk. K and V rows are unpadded; their 16-byte chunks are XOR-swizzled by
//     the row (chunk c of row r at c ^ (r & 7)), so the reads below are free
//     of bank conflicts without padding. Shared memory at hd 128 and the
//     default 64x64 tile, f32: Q 32 KB + two 32 KB stages + P 16 KB = 112
//     KB, so two blocks (16 warps) share an SM.
//   * Thread map: thread (tr, tc), tc the 16 lanes of a half-warp, owns
//     query rows 4tr .. 4tr + 3 in both passes (their Q rows at immediate
//     offsets; P holds them side by side, one float4 per key).
//   * Scores: per step of 64 keys, lane tc takes keys tc + 16j (j < 4: eight
//     consecutive lanes read eight consecutive K rows, distinct chunks after
//     the swizzle); per 16-byte chunk along hd it reads its four Q rows (the
//     half-warp reads one address: a broadcast) and its four K rows, then
//     4 x 4 x 4 (f32) FFMA. Scores are scaled by scale * log2(e) in one
//     multiply, masked with -1e30 and written to the P tile; each lane then
//     reads back the keys it wrote, the half-warp's shuffles give the row's
//     max and sum, p = exp2f(s - m) with masked p zeroed, and the
//     accumulator is rescaled by alpha in registers.
//   * P V: per key a thread reads one float4 of P (its four rows; a
//     broadcast) and its hd/16 columns of V (lanes on consecutive pieces of
//     one row: conflict-free), 4 x hd/16 FFMA.
//   * The causal grid launches the heaviest q tiles first (blockIdx.y counts
//     tiles down from the last), so their long key loops do not form a tail.
// Key blocks wholly above the diagonal are skipped, which is exact (in the
// TPU kernel they add exp(-1e30 - m) = 0 with alpha = 1). Rows past Sq are
// computed on zeros and not stored. The output is acc / max(l, 1e-30), as in
// the TPU kernel.
//
// Head sizes past 256 (flash_wide_kernel; the TPU kernel blocks the full
// hd): a thread's accumulator holds at most 256 columns (64 registers at
// RQ = 4), so a grid dimension takes column groups of WGR = 256 output
// columns, one block each. Every block of a q tile computes the full
// scores: hd streams through the same ring in score chunks of WCH = 128
// columns, each stage holding Q's and K's chunk ([bq][128] and [bk][128],
// K swizzled as above), and the chunks' partial scores add up in P in the
// lane that owns them; the last chunk scales and masks them and the online
// softmax follows; then a ring chunk of V's column group ([bk][256],
// unswizzled: a half-warp reads consecutive pieces of one row) feeds P V for
// the block's own columns. All groups of a tile compute the same scores in
// the same order, so their softmax statistics agree bit for bit. The price
// is the score work once per group, (ceil(hd / 256) - 1) extra Q K^T
// products, and Q read again for every key block (from L2). The wrapper
// pads hd to a multiple of 64 (exact zero columns), so a last chunk of 64
// columns is still whole periods of the swizzle. Every tile up to 128 x 128
// fits (f32: one 128 KB stage and 64 KB of P).
//
// Interface: flash_attention_smem_bytes() gives the dynamic shared memory a
// block needs for (bq, bk, hd, dtype) under a device limit (the ring two
// stages deep where it fits, else one; -1 for a tile or head size the
// kernel does not take: bq and bk multiples of 16 up to 128, hd one of 16,
// 32, 64, 128, 256 or a multiple of 64 past 256), from the same layout() or
// wide_layout() the launcher passes the kernel;
// the wrapper checks it against the limit before launch.
// flash_attention_launch() launches on the given stream, does not
// synchronise, and returns cudaGetLastError(). bq and bk are runtime values;
// dtype, hd and causal are template parameters (20 instantiations, and 8 of
// the kernel past 256, whose hd is a runtime value: dtype, causal, and a
// 256- or 512-thread register budget).

#include "gemm_f32.cuh"

namespace {

constexpr int TC = 16;           // lanes sharing a row group: a half-warp
constexpr int RQ = 4;            // query rows per thread
constexpr int KJ = 4;            // keys per lane in a score step (tc + 16j)
constexpr int KSTEP = TC * KJ;   // keys per score step
constexpr int STEP = 16;         // tile extents are multiples of 16
constexpr int MAX_TILE = 128;
constexpr int MAX_THREADS = MAX_TILE / RQ * TC;  // 512
constexpr int MAX_STAGES = 2;
constexpr float NEG = -1.0e30f;  // the TPU kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAXHD = 256;       // the largest head size of one block's accumulator
// head sizes past 256 (flash_wide_kernel)
constexpr int WCH = 128;         // score chunk: hd columns of Q and K staged together
constexpr int WGR = 256;         // output columns of one block: a column group
constexpr int WIDE_STEP = 64;    // such a head size is zero-padded to a multiple of 64

// Shared-memory layout of one block, in bytes: the Q tile [bq][hd], the
// ring's stages (each one K or V block [bk][hd]), all in the input dtype
// with unpadded rows, then the P tile [bq/4][bk][4] f32.
struct Layout {
  int pitch;        // bytes of a staged row
  int stage;        // bytes of one ring stage
  int ring, p;      // offsets of the ring and of P (Q's is 0)
  int stages;
  long long bytes;
};

__host__ __device__ inline Layout layout(int bq, int bk, int hd, int size, long long limit) {
  Layout L;
  L.pitch = hd * size;
  L.stage = bk * L.pitch;
  L.ring = bq * L.pitch;
  const long long fixed = (long long)L.ring + 4LL * bq * bk;
  L.stages = gemm::ring_stages(L.stage, 0, limit - fixed, MAX_STAGES);
  L.p = L.ring + L.stages * L.stage;
  L.bytes = fixed + (long long)L.stages * L.stage;
  return L;
}

// Past 256: each ring stage holds one score chunk (Q [bq][WCH] then K
// [bk][WCH]) or one column group of V ([bk][WGR]), whichever is larger; then
// the P tile [bq/4][bk][4] f32.
__host__ __device__ inline Layout wide_layout(int bq, int bk, int size, long long limit) {
  Layout L;
  L.pitch = WCH * size;
  const int qk = (bq + bk) * WCH * size, v = bk * WGR * size;
  L.stage = qk > v ? qk : v;
  L.ring = 0;
  const long long fixed = 4LL * bq * bk;
  L.stages = gemm::ring_stages(L.stage, 0, limit - fixed, MAX_STAGES);
  L.p = L.stages * L.stage;
  L.bytes = fixed + (long long)L.stages * L.stage;
  return L;
}

struct Args {
  const void* q; const void* k; const void* v; void* o;
  int Sq, Sk, bq, bk, vec16;
  float scale2;  // scale * log2(e)
  Layout L;
  int hdp;       // head size past 256: the rows' length (a multiple of WIDE_STEP)
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N consecutive elements at p (N * sizeof(T) bytes, a power of two up to 16,
// aligned to its size) as f32; bf16 widens exactly by a shift of its bits.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const char* p, float (&x)[N]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (N == 4) {
      const float4 u = *reinterpret_cast<const float4*>(p);
      x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
    } else if constexpr (N == 2) {
      const float2 u = *reinterpret_cast<const float2*>(p);
      x[0] = u.x; x[1] = u.y;
    } else {
      x[0] = *reinterpret_cast<const float*>(p);
    }
  } else {
    if constexpr (N == 1) {
      x[0] = __uint_as_float((uint32_t)*reinterpret_cast<const uint16_t*>(p) << 16);
    } else {
      uint32_t w[N / 2];
      if constexpr (N == 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
      } else if constexpr (N == 4) {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        w[0] = u.x; w[1] = u.y;
      } else {
        w[0] = *reinterpret_cast<const uint32_t*>(p);
      }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        x[2 * i] = __uint_as_float(w[i] << 16);
        x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

// Copy rows x hd of X (rows hd elements apart) into s, rows `pitch` bytes
// apart, 16-byte chunk c of row r at chunk c ^ (r & sw); rows at or past
// rows_v are zeros. The pieces each thread copies follow gemm::plan_box:
// 16 bytes (VEC16, aligned operands) or one element.
template <typename T, bool VEC16>
__device__ __forceinline__ void copy_rows(const gemm::Plan& q, char* s, int pitch, int sw,
                                          const T* X, int hd, int rows_v, int tid,
                                          int nthreads) {
  constexpr int E = VEC16 ? 16 / (int)sizeof(T) : 1;
  const int per_row = q.per_row, dr = q.dr, dp = q.dp;
  int r = q.r, p = q.p;
  for (int i = tid; i < q.total; i += nthreads) {
    const int c = p * E, b = c * (int)sizeof(T);
    char* dst = s + r * pitch + ((((b >> 4) ^ (r & sw)) << 4) | (b & 15));
    const bool in = r < rows_v;
    const T* src = in ? X + (size_t)r * hd + c : X;
    if constexpr (VEC16) {
      gemm::cp_async16(dst, src, in ? 16 : 0);
    } else if constexpr (sizeof(T) == 4) {
      gemm::cp_async4(dst, src, in ? 4 : 0);
    } else {  // 2-byte elements: below cp.async's 4-byte minimum
      *reinterpret_cast<uint16_t*>(dst) = in ? *reinterpret_cast<const uint16_t*>(src) : 0;
    }
    r += dr;
    p += dp;
    if (p >= per_row) { p -= per_row; ++r; }
  }
}

// A rows x hd box's plan, in 16-byte pieces or elements
template <typename T>
__device__ __forceinline__ gemm::Plan plan_rows(bool vec16, int rows, int hd, int tid,
                                                int nthreads) {
  return vec16 ? gemm::plan_box<T, true>(rows, hd, tid, nthreads)
               : gemm::plan_box<T, false>(rows, hd, tid, nthreads);
}

template <typename T>
__device__ __forceinline__ void copy_rows(bool vec16, const gemm::Plan& q, char* s, int pitch,
                                          int sw, const T* X, int hd, int rows_v, int tid,
                                          int nthreads) {
  if (vec16) copy_rows<T, true>(q, s, pitch, sw, X, hd, rows_v, tid, nthreads);
  else copy_rows<T, false>(q, s, pitch, sw, X, hd, rows_v, tid, nthreads);
}

__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Raw scores s[a][j] = q(row a) . k(key j) of this lane's RQ rows (qrow +
// a * pitch) and NJ keys (krow + 16j * pitch, chunk c at (c ^ sk), skk = sk
// << 4): per 16-byte chunk along hd, RQ chunks of Q and NJ of K, then RQ x
// NJ x E FFMA; over the first cpr chunks of the staged rows (all of them by
// default).
template <typename T, int HD, int NJ>
__device__ __forceinline__ void score_step(float (&s)[RQ][KJ], const char* qrow,
                                           const char* krow, int skk,
                                           int cpr = HD * (int)sizeof(T) / 16) {
  constexpr int E = 16 / (int)sizeof(T);     // elements per chunk
  constexpr int CPR = HD / E;                // chunks per staged row
  constexpr int GROUP = CPR < 8 ? CPR : 8;   // the swizzle's period
  constexpr int PITCH = HD * (int)sizeof(T);
#pragma unroll
  for (int a = 0; a < RQ; ++a)
#pragma unroll
    for (int j = 0; j < KJ; ++j) s[a][j] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < cpr; c0 += GROUP) {  // cpr: the chunks to run, whole GROUPs
    const char* qc = qrow + c0 * 16;
    const char* kc = krow + c0 * 16;
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      float qv[RQ][E];
#pragma unroll
      for (int a = 0; a < RQ; ++a) load_vec<T, E>(qc + a * PITCH + i * 16, qv[a]);
      const char* ki = kc + ((i << 4) ^ skk);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float kv[E];
        load_vec<T, E>(ki + j * TC * PITCH, kv);
#pragma unroll
        for (int e = 0; e < E; ++e)
#pragma unroll
          for (int a = 0; a < RQ; ++a) s[a][j] = fmaf(qv[a][e], kv[e], s[a][j]);
      }
    }
  }
}

// Online softmax of a thread's RQ rows over one key block of P (scaled,
// masked scores, the four rows side by side per key): each lane reads back
// the keys it wrote (x = tc mod 16), the half-warp's shuffles give the
// rows' max and sum, P becomes p = exp2(s - m) (0 where masked), and the
// accumulator is rescaled by alpha.
template <int CT, typename Valid>
__device__ __forceinline__ void online_softmax(float4* prow, int bk, int k0, int tc,
                                               Valid&& valid, float (&m)[RQ], float (&l)[RQ],
                                               float (&acc)[RQ][CT]) {
  float mx[RQ], sum[RQ];
#pragma unroll
  for (int a = 0; a < RQ; ++a) mx[a] = NEG, sum[a] = 0.f;
  for (int x = tc; x < bk; x += TC) {
    float w[RQ];
    load_vec<float, 4>(reinterpret_cast<const char*>(prow + x), w);
#pragma unroll
    for (int a = 0; a < RQ; ++a) mx[a] = fmaxf(mx[a], w[a]);
  }
#pragma unroll
  for (int a = 0; a < RQ; ++a) mx[a] = fmaxf(m[a], half_max(mx[a]));  // the new max
  for (int x = tc; x < bk; x += TC) {
    float w[RQ];
    load_vec<float, 4>(reinterpret_cast<const char*>(prow + x), w);
#pragma unroll
    for (int a = 0; a < RQ; ++a) {
      w[a] = valid(a, k0 + x) ? exp2f(w[a] - mx[a]) : 0.f;
      sum[a] += w[a];
    }
    prow[x] = make_float4(w[0], w[1], w[2], w[3]);
  }
#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    const float alpha = exp2f(m[a] - mx[a]);
    l[a] = l[a] * alpha + half_sum(sum[a]);
    m[a] = mx[a];
#pragma unroll
    for (int e = 0; e < CT; ++e) acc[a][e] *= alpha;
  }
}

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(MAX_THREADS) flash_kernel(Args p) {
  constexpr int SZ = sizeof(T);
  constexpr int PITCH = HD * SZ;
  constexpr int CPR = PITCH / 16;                // 16-byte chunks per row
  constexpr int SW = (CPR < 8 ? CPR : 8) - 1;    // the K/V swizzle mask
  constexpr int CT = HD / TC;                    // output columns per thread
  constexpr int PE = CT * SZ < 16 ? CT : 16 / SZ;  // elements per V read
  constexpr int NP = CT / PE;                    // V reads per key
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout& L = p.L;
  const int bq = p.bq, bk = p.bk, nthreads = bq / RQ * TC;
  const int tid = threadIdx.x, tr = tid / TC, tc = tid % TC;
  const int bh = blockIdx.x;
  const int nq = gridDim.y;
  const int qt = CAUSAL ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;  // heavy tiles first
  const int q0 = qt * bq, qpos = q0 + RQ * tr;  // this thread's rows: qpos + a
  const T* Q = static_cast<const T*>(p.q) + (size_t)bh * p.Sq * HD;
  const T* K = static_cast<const T*>(p.k) + (size_t)bh * p.Sk * HD;
  const T* V = static_cast<const T*>(p.v) + (size_t)bh * p.Sk * HD;
  T* O = static_cast<T*>(p.o) + (size_t)bh * p.Sq * HD;
  char* sQ = smem;
  char* ring = smem + L.ring;
  // P [bq/4][bk] float4: the four rows of a thread side by side per key
  float4* prow = reinterpret_cast<float4*>(smem + L.p) + tr * bk;
  const char* qrow = sQ + RQ * tr * PITCH;
  // this lane's V piece h: elements col(h) .. col(h) + PE - 1 of a row
  auto col = [&](int h) { return PE * tc + TC * PE * h; };
  const int vb = col(0) * SZ;  // its byte offset in an unswizzled row

  float acc[RQ][CT], m[RQ], l[RQ];
#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    m[a] = NEG;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < CT; ++e) acc[a][e] = 0.f;
  }

  int nkb = (p.Sk + bk - 1) / bk;
  if (CAUSAL) {  // key blocks wholly above the diagonal add nothing
    const int qmax = min(q0 + bq, p.Sq) - 1;
    nkb = min(nkb, qmax / bk + 1);
  }

  // the Q tile joins the ring's first group of copies
  const bool vec16 = p.vec16;
  copy_rows<T>(vec16, plan_rows<T>(vec16, bq, HD, tid, nthreads), sQ, PITCH, 0,
               Q + (size_t)q0 * HD, HD, min(bq, p.Sq - q0), tid, nthreads);
  const gemm::Plan plan = plan_rows<T>(vec16, bk, HD, tid, nthreads);
  auto load = [&](int c, int slot) {  // chunk 2kb: K block kb; 2kb + 1: V block kb
    const int k0 = (c >> 1) * bk;
    copy_rows<T>(vec16, plan, ring + slot * L.stage, PITCH, SW,
                 ((c & 1) ? V : K) + (size_t)k0 * HD, HD, min(bk, p.Sk - k0), tid, nthreads);
  };

  auto valid = [&](int a, int key) { return key < p.Sk && (!CAUSAL || qpos + a >= key); };

  auto scores = [&](int k0, const char* sK) {
    const int skk = (tc & SW) << 4;  // K rows tc + 16j all swizzle by tc & SW
    for (int base = 0; base < bk; base += KSTEP) {
      float s[RQ][KJ];
      const char* krow = sK + (base + tc) * PITCH;
      const int nj = min(KJ, (bk - base) / TC);  // the same in every lane
      switch (nj) {
        case 4: score_step<T, HD, 4>(s, qrow, krow, skk); break;
        case 3: score_step<T, HD, 3>(s, qrow, krow, skk); break;
        case 2: score_step<T, HD, 2>(s, qrow, krow, skk); break;
        default: score_step<T, HD, 1>(s, qrow, krow, skk);
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        if (j >= nj) break;
        const int x = base + tc + TC * j, key = k0 + x;
        float w[RQ];
#pragma unroll
        for (int a = 0; a < RQ; ++a) w[a] = valid(a, key) ? s[a][j] * p.scale2 : NEG;
        prow[x] = make_float4(w[0], w[1], w[2], w[3]);
      }
    }
    online_softmax(prow, bk, k0, tc, valid, m, l, acc);
  };

  auto pv_pass = [&](int kc, const char* sV) {
    constexpr int KU = SW + 1;  // keys a step: one swizzle period
#pragma unroll 1
    for (int k = 0; k < kc; k += KU) {
#pragma unroll
      for (int t = 0; t < KU; ++t) {
        float pk[RQ];
        load_vec<float, 4>(reinterpret_cast<const char*>(prow + k + t), pk);
        // key k + t swizzles by t (k is a whole number of periods)
        const char* vr = sV + (k + t) * PITCH + (vb ^ (t << 4));
#pragma unroll
        for (int h = 0; h < NP; ++h) {
          float vv[PE];
          load_vec<T, PE>(vr + h * TC * 16, vv);
#pragma unroll
          for (int e = 0; e < PE; ++e)
#pragma unroll
            for (int a = 0; a < RQ; ++a) acc[a][h * PE + e] = fmaf(pk[a], vv[e], acc[a][h * PE + e]);
        }
      }
    }
  };

  gemm::run_ring(2 * nkb, L.stages, load, [&](int c, int slot) {
    const char* tile = ring + slot * L.stage;
    const int k0 = (c >> 1) * bk;
    if ((c & 1) == 0) scores(k0, tile);
    else pv_pass(min(bk, p.Sk - k0), tile);
  });

#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    const int r = qpos + a;
    if (r >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[a], 1e-30f);
    T* orow = O + (size_t)r * HD;
#pragma unroll
    for (int h = 0; h < NP; ++h) {
      if constexpr (sizeof(T) == 4 && PE == 4) {
        *reinterpret_cast<float4*>(orow + col(h)) =
            make_float4(acc[a][h * PE] * inv, acc[a][h * PE + 1] * inv,
                        acc[a][h * PE + 2] * inv, acc[a][h * PE + 3] * inv);
      } else {
#pragma unroll
        for (int e = 0; e < PE; ++e) orow[col(h) + e] = from_f32<T>(acc[a][h * PE + e] * inv);
      }
    }
  }
}

// Head sizes past 256: one block per (row of BH, q tile, column group of
// WGR output columns). Every block of a q tile computes the full scores,
// hd in chunks of WCH columns of Q and K through the ring (each chunk's
// partial scores added into P by the lane that owns them, the last chunk
// scaling and masking them), then the softmax, then P V for its own column
// group of V only. All groups of a tile compute the same scores in the same
// order, so their softmax statistics agree bit for bit; the price is the
// score work done once per group. hd is padded to a multiple of 64 in the
// wrapper (zero columns after the real ones: exact +0*0 terms), so every
// chunk is whole groups of the K swizzle's period.
template <typename T>
__device__ __forceinline__ void copy_box_any(bool vec16, int rows, int cols, char* s, int pitch,
                                             const T* X, int ld, int rows_v, int cols_v,
                                             int tid, int nthreads) {
  if (vec16)
    gemm::copy_box<T, true>(gemm::plan_box<T, true>(rows, cols, tid, nthreads), s, pitch, X, ld,
                            rows_v, cols_v, tid, nthreads);
  else
    gemm::copy_box<T, false>(gemm::plan_box<T, false>(rows, cols, tid, nthreads), s, pitch, X,
                             ld, rows_v, cols_v, tid, nthreads);
}

template <typename T, bool CAUSAL, int MAXT>
__global__ void __launch_bounds__(MAXT) flash_wide_kernel(Args p) {
  constexpr int SZ = sizeof(T);
  constexpr int CPITCH = WCH * SZ;                 // a staged Q or K chunk row, bytes
  constexpr int CSW = 7;                           // the K chunk swizzle mask
  constexpr int VPITCH = WGR * SZ;                 // a staged V row (unswizzled)
  constexpr int CT = WGR / TC;                     // output columns per thread
  constexpr int PE = CT * SZ < 16 ? CT : 16 / SZ;  // elements per V read
  constexpr int NP = CT / PE;                      // V reads per key
  constexpr int VSPAN = TC * PE;                   // columns one V read of a half-warp covers
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout& L = p.L;
  const int bq = p.bq, bk = p.bk, hdp = p.hdp, nthreads = bq / RQ * TC;
  const int tid = threadIdx.x, tr = tid / TC, tc = tid % TC;
  const int bh = blockIdx.x;
  const int nq = gridDim.y;
  const int qt = CAUSAL ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;  // heavy tiles first
  const int q0 = qt * bq, qpos = q0 + RQ * tr;
  const int col0 = blockIdx.z * WGR, gw = min(WGR, hdp - col0);  // this block's columns
  const int nsc = (hdp + WCH - 1) / WCH, per = nsc + 1;  // score chunks; ring chunks a key block
  const int wlast = hdp - (nsc - 1) * WCH;               // the last score chunk's width
  const T* Q = static_cast<const T*>(p.q) + (size_t)bh * p.Sq * hdp;
  const T* K = static_cast<const T*>(p.k) + (size_t)bh * p.Sk * hdp;
  const T* V = static_cast<const T*>(p.v) + (size_t)bh * p.Sk * hdp;
  T* O = static_cast<T*>(p.o) + (size_t)bh * p.Sq * hdp;
  float4* prow = reinterpret_cast<float4*>(smem + L.p) + tr * bk;
  auto col = [&](int h) { return PE * tc + VSPAN * h; };
  const int vb = col(0) * SZ;

  float acc[RQ][CT], m[RQ], l[RQ];
#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    m[a] = NEG;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < CT; ++e) acc[a][e] = 0.f;
  }

  int nkb = (p.Sk + bk - 1) / bk;
  if (CAUSAL) {
    const int qmax = min(q0 + bq, p.Sq) - 1;
    nkb = min(nkb, qmax / bk + 1);
  }

  const bool vec16 = p.vec16;
  // each chunk plans its copies anew (a division a box): plans held across
  // the loop would cost the accumulator registers
  auto load = [&](int c, int slot) {  // chunk t < nsc of key block kb: Q and K; t = nsc: V
    const int kb = c / per, t = c - kb * per, k0 = kb * bk;
    char* st = smem + slot * L.stage;
    if (t < nsc) {
      const int w = t < nsc - 1 ? WCH : wlast;
      copy_rows<T>(vec16, plan_rows<T>(vec16, bq, w, tid, nthreads), st, CPITCH, 0,
                   Q + (size_t)q0 * hdp + t * WCH, hdp, min(bq, p.Sq - q0), tid, nthreads);
      copy_rows<T>(vec16, plan_rows<T>(vec16, bk, w, tid, nthreads), st + bq * CPITCH, CPITCH,
                   CSW, K + (size_t)k0 * hdp + t * WCH, hdp, min(bk, p.Sk - k0), tid, nthreads);
    } else {  // the group's columns, zeros up to a whole V read of the half-warp
      copy_box_any<T>(vec16, bk, gemm::round_up(gw, VSPAN), st, VPITCH, V + (size_t)k0 * hdp + col0,
                      hdp, min(bk, p.Sk - k0), gw, tid, nthreads);
    }
  };

  auto valid = [&](int a, int key) { return key < p.Sk && (!CAUSAL || qpos + a >= key); };

  auto scores = [&](int t, int k0, const char* st) {  // score chunk t of a key block
    const char* qrow = st + RQ * tr * CPITCH;
    const char* sK = st + bq * CPITCH;
    const int cpr = (t == nsc - 1 ? wlast : WCH) * SZ / 16;
    const int skk = (tc & CSW) << 4;
    const bool last = t == nsc - 1;
    for (int base = 0; base < bk; base += KSTEP) {
      float s[RQ][KJ];
      const char* krow = sK + (base + tc) * CPITCH;
      const int nj = min(KJ, (bk - base) / TC);
      switch (nj) {
        case 4: score_step<T, WCH, 4>(s, qrow, krow, skk, cpr); break;
        case 3: score_step<T, WCH, 3>(s, qrow, krow, skk, cpr); break;
        case 2: score_step<T, WCH, 2>(s, qrow, krow, skk, cpr); break;
        default: score_step<T, WCH, 1>(s, qrow, krow, skk, cpr);
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        if (j >= nj) break;
        const int x = base + tc + TC * j, key = k0 + x;
        float w[RQ];
        if (t > 0) {  // the partial sums of the chunks before, written by this lane
          load_vec<float, 4>(reinterpret_cast<const char*>(prow + x), w);
#pragma unroll
          for (int a = 0; a < RQ; ++a) w[a] += s[a][j];
        } else {
#pragma unroll
          for (int a = 0; a < RQ; ++a) w[a] = s[a][j];
        }
        if (last) {
#pragma unroll
          for (int a = 0; a < RQ; ++a) w[a] = valid(a, key) ? w[a] * p.scale2 : NEG;
        }
        prow[x] = make_float4(w[0], w[1], w[2], w[3]);
      }
    }
    if (last) online_softmax(prow, bk, k0, tc, valid, m, l, acc);
  };

  auto pv_pass = [&](int kc, const char* sV) {
#pragma unroll 1
    for (int k = 0; k < kc; k += 8) {  // rows past kc are zeros, as are their p
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        float pk[RQ];
        load_vec<float, 4>(reinterpret_cast<const char*>(prow + k + t), pk);
        const char* vr = sV + (k + t) * VPITCH + vb;
#pragma unroll
        for (int h = 0; h < NP; ++h) {
          if (h * VSPAN >= gw) break;
          float vv[PE];
          load_vec<T, PE>(vr + h * TC * 16, vv);
#pragma unroll
          for (int e = 0; e < PE; ++e)
#pragma unroll
            for (int a = 0; a < RQ; ++a) acc[a][h * PE + e] = fmaf(pk[a], vv[e], acc[a][h * PE + e]);
        }
      }
    }
  };

  gemm::run_ring(per * nkb, L.stages, load, [&](int c, int slot) {
    const int kb = c / per, t = c - kb * per, k0 = kb * bk;
    const char* st = smem + slot * L.stage;
    if (t < nsc) scores(t, k0, st);
    else pv_pass(min(bk, p.Sk - k0), st);
  });

#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    const int r = qpos + a;
    if (r >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[a], 1e-30f);
    T* orow = O + (size_t)r * hdp + col0;
#pragma unroll
    for (int h = 0; h < NP; ++h) {
      const int c = col(h);
      if constexpr (sizeof(T) == 4 && PE == 4) {
        if (c + 3 < gw)
          *reinterpret_cast<float4*>(orow + c) =
              make_float4(acc[a][h * PE] * inv, acc[a][h * PE + 1] * inv,
                          acc[a][h * PE + 2] * inv, acc[a][h * PE + 3] * inv);
      } else {
#pragma unroll
        for (int e = 0; e < PE; ++e)
          if (c + e < gw) orow[c + e] = from_f32<T>(acc[a][h * PE + e] * inv);
      }
    }
  }
}

// Tiles up to 64 query rows (256 threads) run an instantiation allowed 255
// registers a thread, so the 64 accumulators and the score chunk's operands
// stay in registers; a 128-row tile (512 threads, at most 128 registers)
// spills some.
template <typename T, bool CAUSAL, int MAXT>
cudaError_t launch_wide_t(const Args& p, int BH, cudaStream_t stream) {
  const dim3 grid(BH, (p.Sq + p.bq - 1) / p.bq, (p.hdp + WGR - 1) / WGR);
  static long long done[16] = {};
  const cudaError_t e = gemm::allow_smem(flash_wide_kernel<T, CAUSAL, MAXT>, p.L.bytes, done);
  if (e != cudaSuccess) return e;
  flash_wide_kernel<T, CAUSAL, MAXT><<<grid, p.bq / RQ * TC, p.L.bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool CAUSAL>
cudaError_t launch_wide(const Args& p, int BH, cudaStream_t stream) {
  return p.bq / RQ * TC <= MAX_THREADS / 2 ? launch_wide_t<T, CAUSAL, MAX_THREADS / 2>(p, BH, stream)
                                           : launch_wide_t<T, CAUSAL, MAX_THREADS>(p, BH, stream);
}

template <typename T, int HD, bool CAUSAL>
cudaError_t launch(const Args& p, int BH, cudaStream_t stream) {
  const dim3 grid(BH, (p.Sq + p.bq - 1) / p.bq);
  static long long done[16] = {};
  const cudaError_t e = gemm::allow_smem(flash_kernel<T, HD, CAUSAL>, p.L.bytes, done);
  if (e != cudaSuccess) return e;
  flash_kernel<T, HD, CAUSAL><<<grid, p.bq / RQ * TC, p.L.bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_hd(const Args& p, int BH, int causal, cudaStream_t s) {
  return causal ? launch<T, HD, true>(p, BH, s) : launch<T, HD, false>(p, BH, s);
}

template <typename T>
cudaError_t launch_t(const Args& p, int BH, int hd, int causal, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_hd<T, 16>(p, BH, causal, s);
    case 32: return launch_hd<T, 32>(p, BH, causal, s);
    case 64: return launch_hd<T, 64>(p, BH, causal, s);
    case 128: return launch_hd<T, 128>(p, BH, causal, s);
    case 256: return launch_hd<T, 256>(p, BH, causal, s);
  }
  if (hd > MAXHD && hd % WIDE_STEP == 0)
    return causal ? launch_wide<T, true>(p, BH, s) : launch_wide<T, false>(p, BH, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" long long flash_attention_smem_bytes(int bq, int bk, int hd, int bf16, int limit) {
  if (bq < STEP || bk < STEP || bq % STEP || bk % STEP || bq > MAX_TILE || bk > MAX_TILE)
    return -1;
  if (hd > MAXHD) return hd % WIDE_STEP ? -1 : wide_layout(bq, bk, bf16 ? 2 : 4, limit).bytes;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256) return -1;
  return layout(bq, bk, hd, bf16 ? 2 : 4, limit).bytes;
}

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int BH, int Sq, int Sk, int hd, int bq, int bk,
                                      float scale, int causal, int bf16, int limit,
                                      void* stream) {
  const long long smem = flash_attention_smem_bytes(bq, bk, hd, bf16, limit);
  if (smem < 0 || smem > limit || BH < 1 || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  // 16-byte pieces: aligned bases (every row is hd * size bytes, a multiple
  // of 16 for every hd taken)
  const bool vec16 = gemm::aligned16(q) && gemm::aligned16(k) && gemm::aligned16(v);
  const int size = bf16 ? 2 : 4;
  Args p{q, k, v, o, Sq, Sk, bq, bk, vec16, scale * LOG2E,
         hd > MAXHD ? wide_layout(bq, bk, size, limit) : layout(bq, bk, hd, size, limit), hd};
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = bf16 ? launch_t<__nv_bfloat16>(p, BH, hd, causal, s)
                             : launch_t<float>(p, BH, hd, causal, s);
  return (int)e;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
