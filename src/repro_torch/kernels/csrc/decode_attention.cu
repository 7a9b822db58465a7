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
//
// Design: one block of 256 threads per hg consecutive rows, which it walks
// one after the other (the TPU kernel's hg rows of one grid cell); the TPU
// grid's sequential key axis becomes a loop inside the block. For each
// bk-slot block of a row, K and V are staged in shared memory with
// coalesced loads (consecutive threads on consecutive elements); thread j
// computes the scores of slot j for all G heads (K rows padded for
// conflict-free float4 reads, q broadcast), each warp then runs the online
// softmax of G/8 heads over the block (max and sum by warp shuffles, m, l
// and alpha kept in shared memory), and thread (d, g-group) accumulates
// P V for column d of its heads in registers. The mask is
// _decode_mask's: slot j of a ring cache holds absolute position
// cur_pos - ((cur_pos - j) mod S); positions past cur_pos, negative, or
// (window > 0) window or more behind cur_pos are masked, and p is set to 0
// on masked slots, so a fully masked block adds nothing and a row with
// cur_pos = -1 returns exactly 0, as in the TPU kernel. Without the ring
// the masked slots of a row are known before its loop (slots past cur_pos,
// and before cur_pos - window + 1), so the blocks that hold only such
// slots are skipped; that is exact, since such a block adds 0 with alpha =
// 1. The output is acc / max(l, 1e-30).
//
// Cache layout: row r of K/V starts at (r / Kh) * stride_b + (r % Kh) *
// stride_h, and slot s lies stride_s elements after slot s - 1, with hd
// contiguous. A (BH, S, hd) tensor is Kh = 1; the model's (B, S, Kh, hd)
// cache is read in place, row b*Kh + h at (b, h), with no copy.
//
// Interface: decode_attention_smem_bytes() gives the dynamic shared memory
// a block needs for (G, bk, hd) (-1 for what the kernel does not take: bk
// from 1 to 256, hd one of 16, 32, 64, 128, G at most 8 * 256 / hd), from
// the same layout() the kernel carves its buffers from; the wrapper checks
// it against the device's limit before launch. decode_attention_launch()
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError(). dtype and hd are template parameters (8
// instantiations).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int NW = NT / 32;        // warps per block
constexpr int GC = 8;              // heads per score pass (registers)
constexpr int MAXGPT = 8;          // heads per thread in the P V accumulation
constexpr int KPAD = 4;            // K row padding (keeps float4 alignment)
constexpr int MAXBK = 256;         // slots per block: one per thread
constexpr float NEG = -1.0e30f;    // the TPU kernel's mask value

struct Args {
  const void* q; const void* k; const void* v; const int* cur_pos; void* o;
  long long stride_b, stride_s, stride_h;
  int BH, Kh, G, S, bk, hg, ring, window;
  float scale;
};

// Shared-memory layout of one block, in floats: q of the current row
// [G][hd], K block [bk][hd + KPAD], V block [bk][hd], scores and then
// probabilities [G][bk + 1], and per head m, l, alpha [3][G].
struct Layout {
  int ldk, lds;
  int k, v, s, stats;  // offsets (q's is 0)
  int floats;
};

__host__ __device__ inline Layout layout(int G, int bk, int hd) {
  Layout L;
  L.ldk = hd + KPAD;
  L.lds = bk + 1;
  L.k = G * hd;
  L.v = L.k + bk * L.ldk;
  L.s = L.v + bk * hd;
  L.stats = L.s + G * L.lds;
  L.floats = L.stats + 3 * G;
  return L;
}

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

template <typename T, int HD>
__global__ void __launch_bounds__(NT) decode_kernel(Args p) {
  constexpr int NGRP = NT / HD;  // thread groups over the heads in the P V pass
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = layout(p.G, p.bk, HD);
  float* sQ = smem;
  float* sK = smem + L.k;
  float* sV = smem + L.v;
  float* sS = smem + L.s;
  float* sM = smem + L.stats;
  float* sL = sM + p.G;
  float* sA = sL + p.G;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int d = tid % HD, grp = tid / HD;  // this thread's column and head group
  const T* Qg = (const T*)p.q;
  const T* Kg = (const T*)p.k;
  const T* Vg = (const T*)p.v;
  T* Og = (T*)p.o;

  for (int h = 0; h < p.hg; ++h) {
    const int r = blockIdx.x * p.hg + h;
    if (r >= p.BH) break;
    const int cp = p.cur_pos[r];
    const size_t base = (size_t)(r / p.Kh) * p.stride_b + (size_t)(r % p.Kh) * p.stride_h;
    const T* K = Kg + base;
    const T* V = Vg + base;

    __syncthreads();  // the previous row's buffers are consumed
    for (int idx = tid; idx < p.G * HD; idx += NT)
      sQ[idx] = to_f32(Qg[(size_t)r * p.G * HD + idx]);
    for (int g = tid; g < p.G; g += NT) {
      sM[g] = NEG;
      sL[g] = 0.f;
    }
    float acc[MAXGPT];
#pragma unroll
    for (int u = 0; u < MAXGPT; ++u) acc[u] = 0.f;

    // the blocks holding a valid slot; all of them under the ring
    int kb_lo = 0, kb_hi = (p.S + p.bk - 1) / p.bk;
    if (!p.ring) {
      const int hi = min(cp, p.S - 1);
      const int lo = p.window > 0 ? max(0, cp - p.window + 1) : 0;
      kb_lo = lo / p.bk;
      kb_hi = hi < lo ? kb_lo : hi / p.bk + 1;
    }
    for (int kb = kb_lo; kb < kb_hi; ++kb) {
      const int k0 = kb * p.bk, kc = min(p.bk, p.S - k0);
      __syncthreads();  // the previous block's K, V and P are consumed
      for (int idx = tid; idx < p.bk * HD; idx += NT) {
        const int c = idx / HD, e = idx % HD;
        const bool in = c < kc;
        const size_t off = (size_t)(k0 + c) * p.stride_s + e;
        sK[c * L.ldk + e] = in ? to_f32(K[off]) : 0.f;
        sV[c * HD + e] = in ? to_f32(V[off]) : 0.f;
      }
      __syncthreads();

      // scores: thread j takes slot k0 + j for every head
      for (int j = tid; j < p.bk; j += NT) {
        const bool valid = j < kc && slot_valid(k0 + j, cp, p.S, p.ring, p.window);
        for (int g0 = 0; g0 < p.G; g0 += GC) {
          float s[GC];
#pragma unroll
          for (int u = 0; u < GC; ++u) s[u] = 0.f;
#pragma unroll 4
          for (int e = 0; e < HD; e += 4) {
            const float4 kv = *reinterpret_cast<const float4*>(sK + j * L.ldk + e);
#pragma unroll
            for (int u = 0; u < GC; ++u) {
              if (g0 + u >= p.G) continue;
              const float4 qv = *reinterpret_cast<const float4*>(sQ + (g0 + u) * HD + e);
              s[u] = fmaf(qv.x, kv.x, s[u]);
              s[u] = fmaf(qv.y, kv.y, s[u]);
              s[u] = fmaf(qv.z, kv.z, s[u]);
              s[u] = fmaf(qv.w, kv.w, s[u]);
            }
          }
#pragma unroll
          for (int u = 0; u < GC; ++u)
            if (g0 + u < p.G) sS[(g0 + u) * L.lds + j] = valid ? s[u] * p.scale : NEG;
        }
      }
      __syncthreads();

      // online softmax: warp w takes heads w, w + NW, ...
      for (int g = warp; g < p.G; g += NW) {
        float mx = NEG;
        for (int j = lane; j < kc; j += 32) mx = fmaxf(mx, sS[g * L.lds + j]);
        const float m_prev = sM[g];
        const float m_new = fmaxf(m_prev, warp_max(mx));
        float sum = 0.f;
        for (int j = lane; j < p.bk; j += 32) {
          const bool valid = j < kc && slot_valid(k0 + j, cp, p.S, p.ring, p.window);
          const float pv = valid ? expf(sS[g * L.lds + j] - m_new) : 0.f;
          sS[g * L.lds + j] = pv;
          sum += pv;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          sA[g] = alpha;
          sL[g] = sL[g] * alpha + sum;
          sM[g] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * alpha + P V for column d of heads grp, grp + NGRP, ...
#pragma unroll
      for (int u = 0; u < MAXGPT; ++u) {
        const int g = grp + NGRP * u;
        if (g < p.G) acc[u] *= sA[g];
      }
#pragma unroll 4
      for (int c = 0; c < kc; ++c) {
        const float vv = sV[c * HD + d];
#pragma unroll
        for (int u = 0; u < MAXGPT; ++u) {
          const int g = grp + NGRP * u;
          if (g < p.G) acc[u] = fmaf(sS[g * L.lds + c], vv, acc[u]);
        }
      }
    }

    __syncthreads();  // sL is final
#pragma unroll
    for (int u = 0; u < MAXGPT; ++u) {
      const int g = grp + NGRP * u;
      if (g < p.G)
        Og[((size_t)r * p.G + g) * HD + d] = from_f32<T>(acc[u] / fmaxf(sL[g], 1e-30f));
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& p, size_t smem, cudaStream_t stream) {
  const int grid = (p.BH + p.hg - 1) / p.hg;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  decode_kernel<T, HD><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Args& p, int hd, size_t smem, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(p, smem, s);
    case 32: return launch<T, 32>(p, smem, s);
    case 64: return launch<T, 64>(p, smem, s);
    case 128: return launch<T, 128>(p, smem, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" long long decode_attention_smem_bytes(int G, int bk, int hd) {
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128) return -1;
  if (G < 1 || G > MAXGPT * (NT / hd) || bk < 1 || bk > MAXBK) return -1;
  return (long long)sizeof(float) * layout(G, bk, hd).floats;
}

extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* cur_pos, void* o, int BH, int G, int S, int hd,
                                       int Kh, long long stride_b, long long stride_s,
                                       long long stride_h, int bk, int hg, int ring, int window,
                                       float scale, int bf16, void* stream) {
  const long long smem = decode_attention_smem_bytes(G, bk, hd);
  if (smem < 0 || BH < 1 || S < 1 || hg < 1 || Kh < 1) return (int)cudaErrorInvalidValue;
  Args p{q, k, v, (const int*)cur_pos, o, stride_b, stride_s, stride_h, BH, Kh, G, S, bk, hg, ring, window,
         scale};
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = bf16 ? launch_hd<__nv_bfloat16>(p, hd, smem, s)
                             : launch_hd<float>(p, hd, smem, s);
  return (int)e;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
