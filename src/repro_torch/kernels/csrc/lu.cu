// LU's diagonal-block factor on Hopper, f32: unblocked Doolittle without
// pivoting on the bs x bs block at (off, off) of A (row stride ld), in
// place: L's multipliers below the diagonal (unit diagonal implied), U on
// and above it.
//
// Replaces: src/repro/kernels/lu.py:_factor_diag (lu.py:33), plain array
// code in the JAX package, not a Pallas kernel. It is written by hand here
// only so that step (a) of each block step of the blocked LU is one launch
// and not a host loop of bs row steps. The block step's trailing update runs
// through matmul.cu (the port of _mm_kernel_pack/_nopack).
//
// What bounds it on an H100: a bs x bs factor is 2/3 bs^3 flops (175 kflop
// at bs = 64) in bs - 1 dependent row steps: it is bound by the steps'
// latency (two block-wide barriers each), not by operations or bytes.
//
// Design: one block of 32x32 threads copies the block into shared memory
// (row stride bs + 1: column reads are free of bank conflicts; 66 KB at
// bs = 128) and runs the row steps r there: the multipliers of column r
// (divided by the pivot), a barrier, the rank-1 update of the trailing
// (bs - r - 1)^2 block, a barrier; then it copies the block back. The
// arithmetic is written with round-to-nearest intrinsics in the reference's
// order, a_ij - (m_i * u_rj) with no contraction into an FMA, so it gives
// the plain version's bits.
//
// Interface: lu_factor_diag_smem_bytes() gives the dynamic shared memory
// the block needs; the wrapper checks it against the device's limit.
// lu_factor_diag_launch() launches on the given stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LT = 32;  // LT x LT threads

__global__ void __launch_bounds__(LT * LT) lu_factor_diag_kernel(float* A, int ld, int off,
                                                                 int bs) {
  extern __shared__ float s[];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * LT + tx;
  const int ldm = bs + 1;
  float* G = A + (size_t)off * ld + off;
  for (int i = ty; i < bs; i += LT)
    for (int j = tx; j < bs; j += LT) s[i * ldm + j] = G[(size_t)i * ld + j];
  __syncthreads();

  for (int r = 0; r < bs - 1; ++r) {
    const float piv = s[r * ldm + r];
    for (int i = r + 1 + tid; i < bs; i += LT * LT) s[i * ldm + r] = __fdiv_rn(s[i * ldm + r], piv);
    __syncthreads();
    for (int i = r + 1 + ty; i < bs; i += LT) {
      const float m = s[i * ldm + r];
      for (int j = r + 1 + tx; j < bs; j += LT)
        s[i * ldm + j] = __fsub_rn(s[i * ldm + j], __fmul_rn(m, s[r * ldm + j]));
    }
    __syncthreads();
  }

  for (int i = ty; i < bs; i += LT)
    for (int j = tx; j < bs; j += LT) G[(size_t)i * ld + j] = s[i * ldm + j];
}

}  // namespace

extern "C" long long lu_factor_diag_smem_bytes(int bs) {
  if (bs < 1) return -1;
  return (long long)sizeof(float) * bs * (bs + 1);
}

extern "C" int lu_factor_diag_launch(void* A, int ld, int off, int bs, void* stream) {
  const long long smem = lu_factor_diag_smem_bytes(bs);
  if (smem < 0 || off < 0 || off + bs > ld) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lu_factor_diag_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lu_factor_diag_kernel<<<1, dim3(LT, LT), (size_t)smem, (cudaStream_t)stream>>>(
      (float*)A, ld, off, bs);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
