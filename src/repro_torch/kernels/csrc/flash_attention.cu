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
// the f32 reference does; tensor cores (TF32/bf16 wgmma) are a later
// optimisation.
//
// Design: one 16x16-thread block per (row of BH, bq-row tile of Q); the TPU
// grid's sequential key axis becomes a loop inside the block. The Q tile is
// staged once in shared memory; for each bk-key block the K block is staged
// transposed (hd x bk, so that the 16 lanes of a half-warp read 16
// consecutive keys) and the V block as it lies. Thread (tx, ty) owns query
// rows ty + 16a (a < bq/16) and, in the score tile, keys tx + 16b (b <
// bk/16); in the output tile, columns tx + 16e (e < hd/16). It computes its
// scores in registers, reduces each row's maximum and sum across the 16
// lanes that share the row (warp shuffles), keeps the running max m, the
// denominator l and the output accumulator in registers (the TPU kernel's
// VMEM scratch), and writes p = exp(s - m) to shared memory for the P V
// product. Keys at or past Sk are masked (staged as zeros, scores masked);
// with the causal mask, key blocks wholly above the diagonal are skipped,
// which is exact (in the TPU kernel they add exp(-1e30 - m) = 0 with alpha
// = 1). Rows past Sq are computed on zeros and not stored. The output is
// acc / max(l, 1e-30), as in the TPU kernel. Nothing is padded or copied.
//
// Interface: flash_attention_smem_bytes() gives the dynamic shared memory a
// block needs for (bq, bk, hd) (-1 for a tile or head size the kernel does
// not take: bq and bk multiples of 16 up to 128, hd one of 16, 32, 64,
// 128), from the same layout() the kernel carves its buffers from; the
// wrapper checks it against the device's limit before launch.
// flash_attention_launch() launches on the given stream, does not
// synchronise, and returns cudaGetLastError(). bq and bk are runtime values;
// dtype, hd and causal are template parameters (16 instantiations).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TD = 16;             // threads per block dimension
constexpr int NT = TD * TD;        // threads per block
constexpr int MAXR = 8;            // rows (keys) per thread: tiles up to 128
constexpr int QPAD = 4;            // Q row padding (keeps float4 alignment)
constexpr float NEG = -1.0e30f;    // the TPU kernel's mask value

struct Args {
  const void* q; const void* k; const void* v; void* o;
  int Sq, Sk, bq, bk;
  float scale;
};

// Shared-memory layout of one block, in floats: Q tile [bq][hd + QPAD], K
// block transposed [hd][bk + 1], V block [bk][hd], P tile [bq][bk + 1]. The
// odd leading dimensions keep the transposed stores and the P reads of the
// two half-warps on distinct banks.
struct Layout {
  int ldq, ldk, ldp;
  int k, v, p;   // offsets of the K, V and P buffers (Q's is 0)
  int floats;
};

__host__ __device__ inline Layout layout(int bq, int bk, int hd) {
  Layout L;
  L.ldq = hd + QPAD;
  L.ldk = bk + 1;
  L.ldp = bk + 1;
  L.k = bq * L.ldq;
  L.v = L.k + hd * L.ldk;
  L.p = L.v + bk * hd;
  L.floats = L.p + bq * L.ldp;
  return L;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float comp(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// reductions over the 16 lanes of a half-warp (the lanes sharing ty)
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

template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(NT) flash_kernel(Args p) {
  constexpr int RD = HD / TD;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = layout(p.bq, p.bk, HD);
  float* sQ = smem;
  float* sK = smem + L.k;  // [HD][ldk], transposed
  float* sV = smem + L.v;  // [bk][HD]
  float* sP = smem + L.p;  // [bq][ldp]
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TD + tx;
  const int bh = blockIdx.y, q0 = blockIdx.x * p.bq;
  const int RQ = p.bq / TD, RK = p.bk / TD;
  const T* Q = (const T*)p.q + (size_t)bh * p.Sq * HD;
  const T* K = (const T*)p.k + (size_t)bh * p.Sk * HD;
  const T* V = (const T*)p.v + (size_t)bh * p.Sk * HD;
  T* O = (T*)p.o + (size_t)bh * p.Sq * HD;

  // the Q tile, once; rows past Sq are zeros
  for (int idx = tid; idx < p.bq * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    sQ[r * L.ldq + d] = q0 + r < p.Sq ? to_f32(Q[(size_t)(q0 + r) * HD + d]) : 0.f;
  }

  float acc[MAXR][RD], m[MAXR], l[MAXR];
#pragma unroll
  for (int a = 0; a < MAXR; ++a) {
    m[a] = NEG;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < RD; ++e) acc[a][e] = 0.f;
  }

  int nkb = (p.Sk + p.bk - 1) / p.bk;
  if (CAUSAL) {  // key blocks wholly above the diagonal add nothing
    const int qmax = min(q0 + p.bq, p.Sq) - 1;
    nkb = min(nkb, qmax / p.bk + 1);
  }
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * p.bk, kc = min(p.bk, p.Sk - k0);
    __syncthreads();  // the previous block's K, V and P are consumed
    for (int idx = tid; idx < p.bk * HD; idx += NT) {
      const int c = idx / HD, d = idx % HD;
      const bool in = c < kc;
      sK[d * L.ldk + c] = in ? to_f32(K[(size_t)(k0 + c) * HD + d]) : 0.f;
      sV[c * HD + d] = in ? to_f32(V[(size_t)(k0 + c) * HD + d]) : 0.f;
    }
    __syncthreads();

    // scores of this thread's (row, key) pairs
    float s[MAXR][MAXR];
#pragma unroll
    for (int a = 0; a < MAXR; ++a)
#pragma unroll
      for (int b = 0; b < MAXR; ++b) s[a][b] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 qv[MAXR];
#pragma unroll
      for (int a = 0; a < MAXR; ++a)
        if (a < RQ) qv[a] = *reinterpret_cast<const float4*>(sQ + (ty + TD * a) * L.ldq + d);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        float kv[MAXR];
#pragma unroll
        for (int b = 0; b < MAXR; ++b)
          if (b < RK) kv[b] = sK[(d + dd) * L.ldk + tx + TD * b];
#pragma unroll
        for (int a = 0; a < MAXR; ++a)
#pragma unroll
          for (int b = 0; b < MAXR; ++b)
            if (a < RQ && b < RK) s[a][b] = fmaf(comp(qv[a], dd), kv[b], s[a][b]);
      }
    }

    // online softmax, one row at a time; the 16 lanes of the row reduce
#pragma unroll
    for (int a = 0; a < MAXR; ++a) {
      if (a >= RQ) continue;
      const int qpos = q0 + ty + TD * a;
      float mx = NEG;
#pragma unroll
      for (int b = 0; b < MAXR; ++b) {
        if (b >= RK) continue;
        const int kpos = k0 + tx + TD * b;
        const bool valid = kpos < p.Sk && (!CAUSAL || qpos >= kpos);
        s[a][b] = valid ? s[a][b] * p.scale : NEG;
        mx = fmaxf(mx, s[a][b]);
      }
      const float m_new = fmaxf(m[a], half_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < MAXR; ++b) {
        if (b >= RK) continue;
        const int kpos = k0 + tx + TD * b;
        const bool valid = kpos < p.Sk && (!CAUSAL || qpos >= kpos);
        const float pv = valid ? expf(s[a][b] - m_new) : 0.f;
        sum += pv;
        sP[(ty + TD * a) * L.ldp + tx + TD * b] = pv;
      }
      const float alpha = expf(m[a] - m_new);
      l[a] = l[a] * alpha + half_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int e = 0; e < RD; ++e) acc[a][e] *= alpha;
    }
    __syncthreads();

    // acc += P V over the block's keys
#pragma unroll 4
    for (int c = 0; c < kc; ++c) {
      float vv[RD];
#pragma unroll
      for (int e = 0; e < RD; ++e) vv[e] = sV[c * HD + tx + TD * e];
#pragma unroll
      for (int a = 0; a < MAXR; ++a) {
        if (a >= RQ) continue;
        const float pv = sP[(ty + TD * a) * L.ldp + c];
#pragma unroll
        for (int e = 0; e < RD; ++e) acc[a][e] = fmaf(pv, vv[e], acc[a][e]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < MAXR; ++a) {
    const int r = q0 + ty + TD * a;
    if (a >= RQ || r >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int e = 0; e < RD; ++e) O[(size_t)r * HD + tx + TD * e] = from_f32<T>(acc[a][e] * inv);
  }
}

template <typename T, int HD, bool CAUSAL>
cudaError_t launch(const Args& p, int BH, size_t smem, cudaStream_t stream) {
  const dim3 grid((p.Sq + p.bq - 1) / p.bq, BH);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, HD, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  flash_kernel<T, HD, CAUSAL><<<grid, dim3(TD, TD), smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_causal(const Args& p, int BH, int causal, size_t smem, cudaStream_t s) {
  return causal ? launch<T, HD, true>(p, BH, smem, s) : launch<T, HD, false>(p, BH, smem, s);
}

template <typename T>
cudaError_t launch_hd(const Args& p, int BH, int hd, int causal, size_t smem, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_causal<T, 16>(p, BH, causal, smem, s);
    case 32: return launch_causal<T, 32>(p, BH, causal, smem, s);
    case 64: return launch_causal<T, 64>(p, BH, causal, smem, s);
    case 128: return launch_causal<T, 128>(p, BH, causal, smem, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" long long flash_attention_smem_bytes(int bq, int bk, int hd) {
  if (bq < TD || bk < TD || bq % TD || bk % TD || bq > TD * MAXR || bk > TD * MAXR) return -1;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128) return -1;
  return (long long)sizeof(float) * layout(bq, bk, hd).floats;
}

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int BH, int Sq, int Sk, int hd, int bq, int bk,
                                      float scale, int causal, int bf16, void* stream) {
  const long long smem = flash_attention_smem_bytes(bq, bk, hd);
  if (smem < 0 || BH < 1 || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  Args p{q, k, v, o, Sq, Sk, bq, bk, scale};
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = bf16 ? launch_hd<__nv_bfloat16>(p, BH, hd, causal, smem, s)
                             : launch_hd<float>(p, BH, hd, causal, smem, s);
  return (int)e;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
