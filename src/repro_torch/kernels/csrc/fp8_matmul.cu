// fp8 matrix product C = (A_q @ B_q) * sx * sw for Hopper (sm_90a): the
// port of the Pallas kernel `fp8_matmul` (fp8_matmul_kernel) of
// src/repro/kernels/fp8_matmul.py, the paper's QGMMA analog.
//
// A_q [M,K] and B_q [K,N] hold e4m3 or e5m2 codes (one byte each: half
// the bytes of bf16).  As in the TPU kernel, each code is upcast to
// bf16 inside the tile — here while the K slice is staged into shared
// memory, which is exact (every e4m3/e5m2 value is a bf16 value) — and
// the product runs on the tensor cores as bf16 mma.sync m16n8k16 with
// a float32 accumulator.  The per-tensor scales are read from device
// memory (no host read) and applied once in the epilogue, sx * sw in
// float32, then the accumulator times that scale is rounded to bf16.
// Grid (N/bn, M/bm), one block of 256 threads per output tile, the K
// walk a loop inside the block (tile_common.cuh).
//
// What bounds it: the same as matmul.cu's bf16 path (compute bound at
// the full-width shapes, this simple kernel far from the peak); the
// byte saving only shows where the product is memory bound.  A native
// e4m3 wgmma (QGMMA) at twice the bf16 rate is the redesign.
//
// Entry points return the CUDA error of the launch (0 = launched).

#include "tile_common.cuh"

namespace {

using namespace tile;

struct ScaledBf16 {
  float scale;
  __device__ __nv_bfloat16 operator()(float v) const {
    return __float2bfloat16(v * scale);
  }
};

template <class G>
__global__ void __launch_bounds__(kThreads)
    fp8_matmul_kernel(const G* A, const G* B, const float* sx, const float* sw,
                      __nv_bfloat16* C, int M, int N, int K, int bm, int bn,
                      int bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ScaledBf16 cast{sx[0] * sw[0]};
  mma_tile<G, __nv_bfloat16, __nv_bfloat16>(A, B, C, M, N, K, blockIdx.y * bm,
                                            blockIdx.x * bn, bm, bn, bk, smem,
                                            cast);
}

template <class G>
int launch(const void* a, const void* b, const float* sx, const float* sw,
           void* c, int M, int N, int K, int bm, int bn, int bk, int smem,
           cudaStream_t stream) {
  auto kernel = fp8_matmul_kernel<G>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const G*>(a), static_cast<const G*>(b), sx, sw,
      static_cast<__nv_bfloat16*>(c), M, N, K, bm, bn, bk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Staged as bf16: the same shared memory as matmul.cu's bf16 path.
int fp8_matmul_smem_bytes(int bm, int bn, int bk) {
  return mma_stage_bytes<__nv_bfloat16>(bm, bn, bk);
}

// fmt 0 = e4m3 codes, 1 = e5m2 codes; sx, sw one float32 each on the
// device; C bf16.
int fp8_matmul_fwd(int fmt, const void* a, const void* b, const void* sx,
                   const void* sw, void* c, int M, int N, int K, int bm,
                   int bn, int bk, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      (M + bm - 1) / bm > 65535)
    return cudaErrorInvalidValue;
  const int smem = mma_stage_bytes<__nv_bfloat16>(bm, bn, bk);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const float* fx = static_cast<const float*>(sx);
  const float* fw = static_cast<const float*>(sw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case 0: return launch<E4M3>(a, b, fx, fw, c, M, N, K, bm, bn, bk, smem, st);
    case 1: return launch<E5M2>(a, b, fx, fw, c, M, N, K, bm, bn, bk, smem, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
