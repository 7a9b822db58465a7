// Decode attention on Hopper: one new token's G query heads per cache row
// attend to that row's S cached keys, O[r] = softmax(q[r] K[r]^T * scale +
// mask(cur_pos[r])) V[r], q BH x G x hd, K/V BH rows of S x hd, cur_pos a
// per-row int32 vector; f32 or bf16 inputs (all three the same), f32 math,
// output in the inputs' dtype.
//
// Replaces: src/repro/kernels/decode_attention.py:_decode_kernel (the
// Pallas TPU kernel behind repro.kernels.decode_attention.decode_attention).
//
// What bounds it on an H100: every cached key and value is read once for G
// queries (4*G*hd flops per slot, against 2*hd*4 bytes in f32): at G = 8 and
// below that is 4 flops a byte, far under the card's 20 f32 flops a byte,
// so it is bound by the bytes, (2*BH*S*hd + 2*BH*G*hd) * 4 B over 3.35
// TB/s: 20 us at the LARGE serving shape (BH=16, G=8, S=4096, hd=128).
// HBM reaches that rate only with loads in flight on most SMs, so the key
// axis is split across blocks.
//
// Design: a grid of nsplit x ceil(BH / hg) blocks of 256 threads. Block
// (s, g) walks rows g*hg .. g*hg + hg - 1 in turn (the TPU grid's hg rows of
// one cell) over split s of the slots: spb = ceil(nkb / nsplit) whole bk
// blocks, nkb = ceil(S / bk). The launcher's caller picks nsplit from the
// shapes and the SM count (decode_attention_splits: about four blocks per
// SM, at most 32 splits; 16 rows x 32 splits = 512 blocks at LARGE, 9
// splits of 32 slots at the model's bucket of 288 and bk = 32), never from
// cur_pos, which lives on the device.
// Each split runs the TPU kernel's online-softmax recurrence over its slots:
//   * Staging: K and V stream through gemm_f32.cuh's ring (three stages of
//     SUB = 32 slots, ~33 KB each in f32 at hd = 128, so two blocks fit an
//     SM; a bk block is 32-slot sub-chunks of the ring), in the input dtype,
//     by cp.async in coalesced 16-byte pieces where the cache's base and
//     strides allow (else 4-byte cp.async for f32, plain copies for bf16).
//     Chunks c+1 and c+2 are in flight while chunk c is computed. K rows are
//     padded to an odd number of 16-byte words (gemm::kpitch), so the score
//     pass reads 8 consecutive slots from 8 different bank quads.
//   * Scores: each (slot, head) pair of a sub-chunk has lpp lanes (the
//     largest power of two with 32 * G * lpp <= 256 threads, at most hd/4),
//     which split its hd reduction into float4 pieces with four independent
//     partial sums and finish it with shuffles: at G = 8 every thread takes
//     one pair, a chain of hd/4 multiply-adds; at G = 1 eight lanes share a
//     slot. q is staged once per row in f32, its head rows padded so that
//     the G heads' float4 reads fall in distinct bank quads. (Holding a
//     thread's slice of q in registers instead saved those reads but ran
//     slower at LARGE: the compiler holds the kernel to 128 registers a
//     thread, and the bf16 instantiations spilled.)
//   * Softmax: warp w takes heads w, w + 8, ..., one lane per slot of the
//     sub-chunk (max and sum by shuffles; m, l and alpha in shared memory).
//   * P V: thread (d4, hgi, sg) accumulates columns 4*d4 .. 4*d4 + 3 of up
//     to 8 heads in registers over the slots j = sg mod nsg of each chunk,
//     one float4 read of V per slot and head group (so a V row is read once
//     at G <= 8, not once per head); the nsg slot groups' sums meet in
//     shared memory once per row, in a fixed order.
// The mask is _decode_mask's: slot j of a ring cache holds absolute position
// cur_pos - ((cur_pos - j) mod S); positions past cur_pos, negative, or
// (window > 0) window or more behind cur_pos are masked, and p is 0 on them,
// so a masked sub-chunk adds nothing (alpha = 1). Without the ring a row's
// valid slots are known before its loop (up to cur_pos, from cur_pos -
// window + 1), so a split walks only the slots that can be valid and skips
// the rest exactly; a split with none issues no load and writes m = -1e30,
// l = 0, acc = 0.
// Combine: with one split the block writes acc / max(l, 1e-30). With more
// (at most 32), each split writes (m, l, acc[G][hd]) in f32 to a workspace,
// then __threadfence() and one atomicAdd on its row group's arrival counter;
// the last split of the group to arrive merges the partials in a fixed
// order, so two calls give identical bits: per head a warp takes the splits
// one a lane, M = max_s m_s and L = sum_s l_s exp(m_s - M) by shuffles, the
// weights exp(m_s - M) into the score rows; then each thread sums four
// columns of acc_s exp(m_s - M) with the splits ascending (L2 reads, eight
// in flight) and divides by max(L, 1e-30). A fully masked split adds exact
// zeros and a row with cur_pos = -1 still returns exactly 0. The last split
// resets the counter to 0, so the next launch on the stream finds it so.
// One launch per call, no host synchronisation, and a workspace whose size
// depends only on the shapes (BH*nsplit*G*(hd+2) f32 and ceil(BH/hg) int32
// counters): capturable by a CUDA graph. At the model's shape (bucket 288,
// nine splits at bk = 32) the merge reads nine partials per row (16 KB) in
// the last of nine blocks: a fence, an atomic and two dependent rounds of
// L2 reads after that block's own work, a few microseconds of latency that
// the key axis split buys back many times over at LARGE.
//
// Cache layout: row r of K/V starts at (r / Kh) * stride_b + (r % Kh) *
// stride_h, and slot s lies stride_s elements after slot s - 1, with hd
// contiguous. A (BH, S, hd) tensor is Kh = 1; the model's (B, S, Kh, hd)
// cache is read in place, row b*Kh + h at (b, h), with no copy.
//
// Head sizes: every multiple of 16 from 16 to 256 is an instantiation, HD;
// a head size hd in between runs at the next of them, HD = round_up(hd, 16),
// without copying anything: the cache is read in place, and its loads are
// masked past hd (the MASK instantiations: the ring's element-form copies,
// which zero-fill columns hd .. HD - 1 of every staged K and V row), q's
// staged row is zero there too, and only the hd real columns of O are
// stored; the other instantiations keep hd = HD a constant. The zero columns
// come after the real ones in every dot product and add exact +0*0 terms, so
// the scores keep their bits. NV = HD / 4 float4 columns, the score pass's
// lanes stride HD by 4 * lpp, and the P V pass's threads are (NV, head
// group, slot group) with the slot groups nsg = 256 / (NV * nhg), so a head
// size that is not a power of two leaves a few threads out of that pass
// (hd 80: 240 of 256).
// Head sizes past 256 (the WIDE instantiations, HD = WCH = 256; the TPU
// kernel blocks the full hd): a grid dimension takes column groups of 256
// columns of V and O, one block each, and every block computes the full
// scores. Each sub-chunk of 32 slots is ceil(hd / 256) ring chunks of K (256
// columns each, the last masked past hd and cut to hd rounded up to 16),
// whose partial scores add up in the score rows in the thread that owns
// them, the last one scaling them and the softmax following, then one ring
// chunk of the block's column group of V: a stage holds one of them, not
// both (3 x 33 KB in f32). q's whole row is staged once per row (zeros past
// hd). The key-axis split and its merge are unchanged; each column group
// has its own partials and arrival counters. K is read once per group:
// (ceil(hd / 256) - 1) extra reads of the keys, and the scores' work again.
// A launch takes 8 heads (or fewer where q's rows would pass 64 KB).
// q and O rows hold Gq >= G heads, so a launch can take heads g0 .. g0 + G
// - 1 of each row (q and O passed from head g0): the wrapper splits a G
// past the kernel's 8 * 256 / HD (past 256: 8) into groups that fit, one
// launch each.
//
// Interface: decode_attention_smem_bytes() gives the dynamic shared memory
// a block needs for (G, bk, hd, dtype) (-1 for what the kernel does not
// take: bk from 1 to 256, G at most 8 * 256 / HD, so 8 at hd 256, and 8 or
// fewer past it), from the same layout() the launcher passes the
// kernel; the wrapper checks it against the device's limit before launch
// (at hd 256 and G = 8 in f32 the three ring stages take 198 KB, one block
// an SM).
// decode_attention_splits() and decode_attention_workspace_bytes() size the
// split and the workspace; decode_attention_launch() launches on the given
// stream, does not synchronise, and returns cudaGetLastError(). dtype, hd
// and the copy form are template parameters (96 instantiations: three copy
// forms for each of the 16 head sizes and two dtypes; and 4 WIDE ones: two
// copy forms and two dtypes).

#include "gemm_f32.cuh"

namespace {

constexpr int NT = 256;            // threads per block
constexpr int NW = NT / 32;        // warps per block
constexpr int SUB = 32;            // slots per ring chunk: one per lane in the softmax
constexpr int MAXGPT = 8;          // heads per thread in the P V pass
constexpr int MAXBK = 256;         // largest bk (the gpu space's)
constexpr int MAXSPLIT = 32;       // splits of the key axis: one per lane in the combine
constexpr int QPAD = 4;            // q row padding: the G heads' rows in distinct bank quads
constexpr int MAXHD = 256;         // head sizes: the multiples of 16 up to 256
// head sizes past 256 (the WIDE instantiations): score chunks of WCH
// columns of K, then one column group of WCH columns of V per block
constexpr int WCH = 256;
constexpr int WIDE_QFLOATS = 16384;  // q's staged rows of one launch, f32 (64 KB)
constexpr float NEG = -1.0e30f;    // the TPU kernel's mask value

// Shared-memory layout of one block, in bytes: q of the current row
// [G][hd + QPAD] f32, scores and then probabilities [G][SUB + 1] f32, per head m,
// l, alpha [3][G] f32, then the ring: `stages` stages of K [SUB] rows
// kpitch bytes apart and V [SUB] rows vpitch bytes apart, in the input
// dtype, whose memory holds the P V pass's nsg x G x hd f32 sums after a
// row's loop (and is at least that large).
struct Layout {
  int kpitch, vpitch, lds;   // K and V row pitches (bytes), score row (floats)
  int s, stats, ring;        // offsets (q's is 0)
  int stage, stages;
  int gpt, nhg, nsg;         // the P V pass's map (pv_map)
  long long bytes;
};

// The P V pass: thread (d4, hgi, sg) holds columns 4*d4 .. 4*d4 + 3 of the
// gpt heads hgi*gpt .. hgi*gpt + gpt - 1 and takes the slots j = sg mod nsg
// of each chunk; the nsg slot groups' sums meet once per row.
__host__ __device__ inline void pv_map(int G, int hd, int& gpt, int& nhg, int& nsg) {
  gpt = G < MAXGPT ? G : MAXGPT;
  nhg = (G + gpt - 1) / gpt;
  nsg = NT / (hd / 4 * nhg);
}

// hd: the instantiation's head size (WCH for a WIDE one); hdq: the length
// of q's staged rows (hd, or past 256 the head size padded to 16). A WIDE
// stage holds one chunk of K or one column group of V, not both.
__host__ __device__ inline Layout layout(int G, int hd, int size, int hdq = 0, bool wide = false) {
  Layout L;
  if (hdq == 0) hdq = hd;
  pv_map(G, hd, L.gpt, L.nhg, L.nsg);
  L.kpitch = gemm::kpitch(hd, size);
  L.vpitch = hd * size;
  L.lds = SUB + 1;
  L.s = 4 * G * (hdq + QPAD);
  L.stats = L.s + 4 * G * L.lds;
  L.ring = gemm::round_up(L.stats + 4 * 3 * G, 16);
  L.stage = wide ? SUB * (L.kpitch > L.vpitch ? L.kpitch : L.vpitch) : SUB * (L.kpitch + L.vpitch);
  L.stages = gemm::MAX_STAGES;  // at most 110 KB (G = 16, hd = 128, f32)
  // after a row's loop the ring holds the slot groups' sums, nsg x G x hd f32
  const long long ring = (long long)L.stages * L.stage, red = 4LL * L.nsg * G * hd;
  L.bytes = L.ring + (ring > red ? ring : red);
  return L;
}

struct Args {
  const void* q; const void* k; const void* v; const int* cur_pos; void* o;
  float* ws; int* counters;
  long long stride_b, stride_s, stride_h;
  int Gq;  // query heads of a row of q and O (G of them from the launch's first)
  int BH, Kh, G, S, bk, hg, nsplit, spb, ring, window;
  float scale;
  Layout L;
  int hd;  // the real head size: with MASK, columns hd .. HD - 1 are zeros, never stored
  int hdp; // WIDE: hd padded to 16, the length of q's staged rows
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Columns 4 * (idx % NV) .. + 3 of head idx / NV of row r of O (rows of Gq
// heads of hd columns): with MASK those below hd only; WIDE, of the column
// group from col0 on, those below hd only.
template <bool MASK, int HD, bool WIDE = false, typename T>
__device__ __forceinline__ void store4(T* Og, int r, int idx, int Gq, int hd, int col0,
                                       float4 v) {
  constexpr int NV = HD / 4;
  if constexpr (MASK || WIDE) {
    const int g = idx / NV, col = (WIDE ? col0 : 0) + 4 * (idx % NV);
    T* o = Og + ((size_t)r * Gq + g) * hd + col;
    const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (col + i < hd) o[i] = from_f32<T>(w[i]);
  } else {
    T* o = Og + (size_t)r * Gq * HD + 4 * idx;
    o[0] = from_f32<T>(v.x);
    o[1] = from_f32<T>(v.y);
    o[2] = from_f32<T>(v.z);
    o[3] = from_f32<T>(v.w);
  }
}

// _decode_mask (src/repro/kernels/decode_attention.py:47) for one slot
__device__ __forceinline__ bool slot_valid(int slot, int cp, int S, int ring, int window) {
  int kpos = slot;
  if (ring) {
    int r = (cp - slot) % S;
    if (r < 0) r += S;  // jnp.mod: the sign of the divisor
    kpos = cp - r;
  }
  bool valid = slot < S && kpos >= 0 && kpos <= cp;
  if (window > 0) valid = valid && (cp - kpos) < window;
  return valid;
}

template <typename T, int HD, bool VEC16, bool MASK, bool WIDE>
__global__ void __launch_bounds__(NT) decode_kernel(Args p) {
  constexpr int NV = HD / 4;  // float4 columns of a head (of a column group: WIDE)
  const int hd = (MASK || WIDE) ? p.hd : HD;  // the real head size
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout& L = p.L;
  float* sQ = reinterpret_cast<float*>(smem);  // [G][HD + QPAD]
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sM = reinterpret_cast<float*>(smem + L.stats);
  float* sL = sM + p.G;
  float* sA = sL + p.G;
  char* ring = smem + L.ring;
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.x, grp = blockIdx.y;
  const T* Qg = static_cast<const T*>(p.q);
  const T* Kg = static_cast<const T*>(p.k);
  const T* Vg = static_cast<const T*>(p.v);
  T* Og = static_cast<T*>(p.o);
  // WIDE: the block's column group of V and O (blockIdx.z; gw columns, hd
  // padded to 16 in the last), the score chunks of K (nsc, the last wlast
  // wide), q's staged rows, and the group's partials and counters
  const int col0 = WIDE ? (int)blockIdx.z * HD : 0;
  const int gw = WIDE ? min(HD, p.hdp - col0) : HD;
  const int nsc = WIDE ? (p.hdp + HD - 1) / HD : 1;
  const int wlast = WIDE ? p.hdp - (nsc - 1) * HD : HD;
  const int qs = WIDE ? p.hdp + QPAD : HD + QPAD;
  float* ws = p.ws + (WIDE ? (size_t)blockIdx.z * p.BH * p.nsplit * p.G * (HD + 2) : 0);
  int* counters = p.counters + (WIDE ? blockIdx.z * gridDim.y : 0);

  // score pass: lpp lanes per (slot, head) pair, ppi pairs per pass
  const int pairs = SUB * p.G;
  int lpp = 1;
  while (lpp < NV && pairs * lpp * 2 <= NT) lpp *= 2;
  const int ppi = NT / lpp, li = tid % lpp;
  // P V pass: columns 4*d4 .. 4*d4 + 3 of heads hgi*gpt + u, slots sg mod nsg
  const int gpt = L.gpt, nhg = L.nhg, nsg = L.nsg;
  const int d4 = tid % NV, hgi = tid / NV % nhg, sg = tid / (NV * nhg);
  const bool pv = sg < nsg && (!WIDE || 4 * d4 < gw);

  // this split's slots
  const int span = p.spb * p.bk;
  const int a = split * span, b = min(p.S, a + span);
  const gemm::Plan plan = gemm::plan_box<T, VEC16>(SUB, HD, tid, NT);
  const gemm::Plan plan_last = gemm::plan_box<T, VEC16>(SUB, wlast, tid, NT);  // WIDE
  const gemm::Plan plan_v = gemm::plan_box<T, VEC16>(SUB, gw, tid, NT);        // WIDE

  for (int h = 0; h < p.hg; ++h) {
    const int r = grp * p.hg + h;
    if (r >= p.BH) break;
    const int cp = p.cur_pos[r];
    const size_t base = (size_t)(r / p.Kh) * p.stride_b + (size_t)(r % p.Kh) * p.stride_h;
    const T* K = Kg + base;
    const T* V = Vg + base;
    // the slots that can be valid; all of the split's under the ring
    int x0 = a, x1 = b;
    if (!p.ring) {
      const int hi = min(cp, p.S - 1);
      const int lo = p.window > 0 ? max(0, cp - p.window + 1) : 0;
      x0 = max(a, lo);
      x1 = min(b, hi + 1);
    }
    const int nsub = x1 > x0 ? (x1 - x0 + SUB - 1) / SUB : 0;
    // WIDE: nsc chunks of K, then V's column group, a sub-chunk of slots
    const int nchunks = WIDE ? nsub * (nsc + 1) : nsub;

    __syncthreads();  // the previous row's q, stats and ring are consumed
    if (nchunks > 0)
      for (int idx = tid; idx < p.G * (WIDE ? p.hdp : HD); idx += NT) {
        if constexpr (WIDE) {  // the whole head, zeros past hd
          const int g = idx / p.hdp, e = idx - g * p.hdp;
          sQ[g * qs + e] = e < hd ? to_f32(Qg[((size_t)r * p.Gq + g) * hd + e]) : 0.f;
        } else if constexpr (MASK) {  // q's columns past hd are zeros
          const int g = idx / HD, e = idx - g * HD;
          sQ[g * (HD + QPAD) + e] = e < hd ? to_f32(Qg[((size_t)r * p.Gq + g) * hd + e]) : 0.f;
        } else {
          sQ[idx / HD * (HD + QPAD) + idx % HD] = to_f32(Qg[(size_t)r * p.Gq * HD + idx]);
        }
      }
    for (int g = tid; g < p.G; g += NT) {
      sM[g] = NEG;
      sL[g] = 0.f;
    }
    float acc[MAXGPT][4];
#pragma unroll
    for (int u = 0; u < MAXGPT; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) acc[u][w] = 0.f;

    auto load = [&](int c, int slot) {
      if constexpr (WIDE) {  // K's chunk t, or (t = nsc) V's column group
        const int sub = c / (nsc + 1), t = c - sub * (nsc + 1);
        const int s0 = x0 + sub * SUB, kc = min(SUB, x1 - s0);
        char* st = ring + slot * L.stage;
        const size_t off = (size_t)s0 * p.stride_s;
        if (t < nsc)
          gemm::copy_box<T, VEC16>(t < nsc - 1 ? plan : plan_last, st, L.kpitch,
                                   K + off + t * HD, (int)p.stride_s, kc, min(HD, hd - t * HD),
                                   tid, NT);
        else
          gemm::copy_box<T, VEC16>(plan_v, st, L.vpitch, V + off + col0, (int)p.stride_s, kc,
                                   min(gw, hd - col0), tid, NT);
      } else {
        const int s0 = x0 + c * SUB, kc = min(SUB, x1 - s0);
        char* st = ring + slot * L.stage;
        const size_t off = (size_t)s0 * p.stride_s;
        gemm::copy_box<T, VEC16>(plan, st, L.kpitch, K + off, (int)p.stride_s, kc, hd, tid, NT);
        gemm::copy_box<T, VEC16>(plan, st + SUB * L.kpitch, L.vpitch, V + off, (int)p.stride_s,
                                 kc, hd, tid, NT);
      }
    };

    // scores of the kc slots of a sub-chunk over `cols` columns of K (qoff
    // on in q's rows): written (first), or added to the chunks' before;
    // scaled after the last
    auto score_pass = [&](const char* sK, int kc, int qoff, int cols, bool first, bool last) {
      for (int p0 = 0; p0 < pairs; p0 += ppi) {
        const int pr = p0 + tid / lpp;
        const int j = pr / p.G, g = pr - j * p.G;
        const bool in = pr < pairs && j < kc;
        float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in) {
          const T* kr = reinterpret_cast<const T*>(sK + j * L.kpitch);
          const float* qr = sQ + g * qs + qoff;
#pragma unroll 4
          for (int e = 4 * li; e < cols; e += 4 * lpp) {
            const float4 kv = gemm::load4(kr + e);
            const float4 qv = *reinterpret_cast<const float4*>(qr + e);
            part.x = fmaf(qv.x, kv.x, part.x);
            part.y = fmaf(qv.y, kv.y, part.y);
            part.z = fmaf(qv.z, kv.z, part.z);
            part.w = fmaf(qv.w, kv.w, part.w);
          }
        }
        float s = (part.x + part.y) + (part.z + part.w);
        for (int off = lpp / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (in && li == 0) {  // the same thread owns (j, g) in every chunk
          float* o = sS + g * L.lds + j;
          const float tot = first ? s : *o + s;
          *o = last ? tot * p.scale : tot;
        }
      }
    };

    // online softmax: warp w takes heads w, w + NW, ...; lane j slot s0 + j
    auto softmax_pass = [&](int s0, int kc) {
      const bool valid = lane < kc && slot_valid(s0 + lane, cp, p.S, p.ring, p.window);
      for (int g = warp; g < p.G; g += NW) {
        const float sc = valid ? sS[g * L.lds + lane] : NEG;
        const float m_prev = sM[g];
        const float m_new = fmaxf(m_prev, warp_max(sc));
        const float pj = valid ? expf(sc - m_new) : 0.f;
        sS[g * L.lds + lane] = pj;
        const float sum = warp_sum(pj);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          sA[g] = alpha;
          sL[g] = sL[g] * alpha + sum;
          sM[g] = m_new;
        }
      }
    };

    // acc = acc * alpha + P V over this thread's slots of the chunk
    auto pv_pass = [&](const char* sV, int kc) {
      if (pv) {
#pragma unroll
        for (int u = 0; u < MAXGPT; ++u) {
          const int g = hgi * gpt + u;
          if (u < gpt && g < p.G) {
            const float al = sA[g];
#pragma unroll
            for (int w = 0; w < 4; ++w) acc[u][w] *= al;
          }
        }
        for (int j = sg; j < kc; j += nsg) {
          const float4 vv = gemm::load4(reinterpret_cast<const T*>(sV + j * L.vpitch) + 4 * d4);
#pragma unroll
          for (int u = 0; u < MAXGPT; ++u) {
            const int g = hgi * gpt + u;
            if (u < gpt && g < p.G) {
              const float pj = sS[g * L.lds + j];
              acc[u][0] = fmaf(pj, vv.x, acc[u][0]);
              acc[u][1] = fmaf(pj, vv.y, acc[u][1]);
              acc[u][2] = fmaf(pj, vv.z, acc[u][2]);
              acc[u][3] = fmaf(pj, vv.w, acc[u][3]);
            }
          }
        }
      }
    };

    auto compute = [&](int c, int slot) {
      const char* st = ring + slot * L.stage;
      if constexpr (WIDE) {  // the ring's barrier orders a chunk's softmax before P V
        const int sub = c / (nsc + 1), t = c - sub * (nsc + 1);
        const int s0 = x0 + sub * SUB, kc = min(SUB, x1 - s0);
        if (t < nsc) {
          score_pass(st, kc, t * HD, t < nsc - 1 ? HD : wlast, t == 0, t == nsc - 1);
          if (t == nsc - 1) {
            __syncthreads();
            softmax_pass(s0, kc);
          }
        } else {
          pv_pass(st, kc);
        }
      } else {
        const int s0 = x0 + c * SUB, kc = min(SUB, x1 - s0);
        score_pass(st, kc, 0, HD, true, true);
        __syncthreads();
        softmax_pass(s0, kc);
        __syncthreads();
        pv_pass(st + SUB * L.kpitch, kc);
      }
    };

    gemm::run_ring(nchunks, L.stages, load, compute);  // ends with a barrier: sM, sL final

    // the slot groups' sums into the ring's memory, then summed in sg order
    float* red = reinterpret_cast<float*>(ring);  // [nsg][G][HD]
    if (pv) {
#pragma unroll
      for (int u = 0; u < MAXGPT; ++u) {
        const int g = hgi * gpt + u;
        if (u < gpt && g < p.G)
          *reinterpret_cast<float4*>(red + ((size_t)sg * p.G + g) * HD + 4 * d4) =
              make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
      }
    }
    __syncthreads();
    const size_t part = (size_t)r * p.nsplit + split;
    for (int idx = tid; idx < p.G * NV; idx += NT) {  // four columns of head idx / NV
      if (WIDE && 4 * (idx % NV) >= gw) continue;  // past the column group
      float4 o4 = *reinterpret_cast<const float4*>(red + 4 * idx);
      for (int s = 1; s < nsg; ++s) {
        const float4 x = *reinterpret_cast<const float4*>(red + (size_t)s * p.G * HD + 4 * idx);
        o4.x += x.x; o4.y += x.y; o4.z += x.z; o4.w += x.w;
      }
      if (p.nsplit == 1) {
        const float den = fmaxf(sL[idx / NV], 1e-30f);
        store4<MASK, HD, WIDE>(Og, r, idx, p.Gq, hd, col0,
                               make_float4(o4.x / den, o4.y / den, o4.z / den, o4.w / den));
      } else {  // this split's partial: acc [G][hd]
        *reinterpret_cast<float4*>(ws + part * p.G * HD + 4 * idx) = o4;
      }
    }
    if (p.nsplit > 1) {  // and (m, l) per head
      float* ml = ws + (size_t)p.BH * p.nsplit * p.G * HD + part * p.G * 2;
      for (int g = tid; g < p.G; g += NT) {
        ml[2 * g] = sM[g];
        ml[2 * g + 1] = sL[g];
      }
    }
  }
  if (p.nsplit == 1) return;

  // the last split of the row group to arrive merges the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counters + grp, 1) == p.nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const size_t nacc = (size_t)p.nsplit * p.G * HD;  // floats of one row's partials
  for (int h = 0; h < p.hg; ++h) {
    const int r = grp * p.hg + h;
    if (r >= p.BH) break;
    const float* acc_r = ws + (size_t)r * nacc;
    const float* ml_r = ws + (size_t)p.BH * nacc + (size_t)r * p.nsplit * p.G * 2;
    __syncthreads();  // the previous row's weights are consumed
    // per head, lane s takes split s: M = max_s m_s, e_s = exp(m_s - M) into
    // the score rows, L = sum_s l_s e_s (a fixed shuffle order)
    for (int g = warp; g < p.G; g += NW) {
      const bool in = lane < p.nsplit;
      const float m = in ? __ldcg(ml_r + 2 * (lane * p.G + g)) : NEG;
      const float l = in ? __ldcg(ml_r + 2 * (lane * p.G + g) + 1) : 0.f;
      const float M = warp_max(m);
      const float e = in ? expf(m - M) : 0.f;
      const float L_ = warp_sum(l * e);
      sS[g * L.lds + lane] = e;
      if (lane == 0) sL[g] = fmaxf(L_, 1e-30f);
    }
    __syncthreads();
    // O = sum_s acc_s e_s / max(L, 1e-30), splits ascending, four columns a thread
    for (int idx = tid; idx < p.G * NV; idx += NT) {
      if (WIDE && 4 * (idx % NV) >= gw) continue;  // past the column group
      const int g = idx / NV;
      const float* a4 = acc_r + 4 * idx;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int s = 0; s < p.nsplit; ++s) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(a4 + (size_t)s * p.G * HD));
        const float e = sS[g * L.lds + s];
        o.x = fmaf(x.x, e, o.x);
        o.y = fmaf(x.y, e, o.y);
        o.z = fmaf(x.z, e, o.z);
        o.w = fmaf(x.w, e, o.w);
      }
      const float den = sL[g];
      store4<MASK, HD, WIDE>(Og, r, idx, p.Gq, hd, col0,
                             make_float4(o.x / den, o.y / den, o.z / den, o.w / den));
    }
  }
  if (tid == 0) counters[grp] = 0;  // for the next launch on this stream
}

template <typename T, int HD, bool V16, bool MASK, bool WIDE = false>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  const dim3 grid(p.nsplit, (p.BH + p.hg - 1) / p.hg, WIDE ? (p.hdp + HD - 1) / HD : 1);
  static long long done[16] = {};
  const cudaError_t e = gemm::allow_smem(decode_kernel<T, HD, V16, MASK, WIDE>, p.L.bytes, done);
  if (e != cudaSuccess) return e;
  decode_kernel<T, HD, V16, MASK, WIDE><<<grid, NT, p.L.bytes, stream>>>(p);
  return cudaGetLastError();
}

// the copy form: 16-byte pieces, elements, or elements masked past hd < HD
template <typename T, int HD>
cudaError_t launch_vec(const Args& p, bool vec16, cudaStream_t s) {
  if (p.hd != HD) return launch<T, HD, false, true>(p, s);
  return vec16 ? launch<T, HD, true, false>(p, s) : launch<T, HD, false, false>(p, s);
}

// hd = HD, HD + 16, ..., 256
template <typename T, int HD = 16>
cudaError_t launch_hd(const Args& p, int hd, bool vec16, cudaStream_t s) {
  if (hd == HD) return launch_vec<T, HD>(p, vec16, s);
  if constexpr (HD < MAXHD) return launch_hd<T, HD + 16>(p, hd, vec16, s);
  return cudaErrorInvalidValue;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// The instantiated head size a head size hd runs at: the next multiple of 16.
inline int padded_hd(int hd) { return gemm::round_up(hd, 16); }

// Query heads one launch takes: 8 * 256 / HD up to 256; past it 8, or as
// many as keep q's staged rows within WIDE_QFLOATS.
inline int max_heads(int hd) {
  const int hdp = padded_hd(hd);
  if (hdp <= MAXHD) return 8 * NT / hdp;
  const int fit = WIDE_QFLOATS / (hdp + QPAD);
  return fit < MAXGPT ? fit : MAXGPT;
}

// Column groups of WCH columns a head size past 256 is split into (1 below).
inline int column_groups(int hd) { return hd > MAXHD ? cdiv(padded_hd(hd), WCH) : 1; }

inline Layout layout_for(int G, int hd, int size) {
  const int hdp = padded_hd(hd);
  return hdp > MAXHD ? layout(G, WCH, size, hdp, true) : layout(G, hdp, size);
}

extern "C" long long decode_attention_smem_bytes(int G, int bk, int hd, int bf16) {
  if (hd < 1) return -1;
  if (G < 1 || G > max_heads(hd) || bk < 1 || bk > MAXBK) return -1;
  return layout_for(G, hd, bf16 ? 2 : 4).bytes;
}

// Splits of the key axis: about four blocks per SM over the row groups, each
// split a whole number of bk blocks.
extern "C" int decode_attention_splits(int BH, int S, int bk, int hg, int sms) {
  if (BH < 1 || S < 1 || bk < 1 || hg < 1 || sms < 1) return 1;
  const int groups = cdiv(BH, hg), nkb = cdiv(S, bk);
  int want = cdiv(4 * sms, groups);
  want = want < nkb ? want : nkb;
  want = want < MAXSPLIT ? want : MAXSPLIT;
  return cdiv(nkb, cdiv(nkb, want));
}

// f32 workspace for the partials of nsplit > 1 splits: acc [BH][nsplit][G][HD]
// then (m, l) [BH][nsplit][G][2]
extern "C" long long decode_attention_workspace_bytes(int BH, int G, int hd, int nsplit) {
  const int cols = hd > MAXHD ? WCH : padded_hd(hd);  // past 256: each column group's
  return nsplit > 1 ? 4LL * column_groups(hd) * BH * nsplit * G * (cols + 2) : 0;
}

extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* cur_pos, void* o, void* ws, void* counters,
                                       int BH, int G, int S, int hd, int Kh, long long stride_b,
                                       long long stride_s, long long stride_h, int Gq,
                                       int bk, int hg,
                                       int nsplit, int ring, int window, float scale, int bf16,
                                       void* stream) {
  const long long smem = decode_attention_smem_bytes(G, bk, hd, bf16);
  const int nkb = cdiv(S, bk > 0 ? bk : 1);
  if (smem < 0 || BH < 1 || S < 1 || hg < 1 || Kh < 1 || nsplit < 1 || nsplit > nkb
      || nsplit > MAXSPLIT || Gq < G
      || (nsplit > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int size = bf16 ? 2 : 4, hdp = padded_hd(hd);
  // 16-byte pieces: aligned bases, and every row and slot on a 16-byte word
  // (hd * size is a multiple of 16 for every unmasked hd)
  const bool vec16 = gemm::aligned16(k) && gemm::aligned16(v) && (stride_b * size) % 16 == 0
                     && (stride_s * size) % 16 == 0 && (stride_h * size) % 16 == 0;
  Args p{q, k, v, (const int*)cur_pos, o, (float*)ws, (int*)counters,
         stride_b, stride_s, stride_h, Gq, BH, Kh, G, S, bk, hg, nsplit, cdiv(nkb, nsplit),
         ring, window, scale, layout_for(G, hd, size), hd, hdp};
  cudaStream_t s = (cudaStream_t)stream;
  if (hdp > MAXHD) {  // column groups of WCH (grid z); 16-byte pieces need whole rows of them
    const bool v16 = vec16 && (hd * size) % 16 == 0;
    if (bf16)
      return (int)(v16 ? launch<__nv_bfloat16, WCH, true, false, true>(p, s)
                       : launch<__nv_bfloat16, WCH, false, false, true>(p, s));
    return (int)(v16 ? launch<float, WCH, true, false, true>(p, s)
                     : launch<float, WCH, false, false, true>(p, s));
  }
  const cudaError_t e = bf16 ? launch_hd<__nv_bfloat16>(p, hdp, vec16, s)
                             : launch_hd<float>(p, hdp, vec16, s);
  return (int)e;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
