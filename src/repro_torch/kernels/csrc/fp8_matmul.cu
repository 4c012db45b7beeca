// fp8 matrix product C = (A_q @ B_q) * sx * sw for Hopper (sm_90a): the
// port of the Pallas kernel `fp8_matmul` (fp8_matmul_kernel) of
// src/repro/kernels/fp8_matmul.py, the paper's QGMMA.
//
// A_q [M,K] and B_q [K,N] hold e4m3 or e5m2 codes (one byte each).  The
// tile rule (fp8_matmul_body; kernels/matmul.py `body`) picks one of two
// bodies:
//
//   * wgmma (wgmma_common.cuh): tiles on the warpgroup grid (bm 64 or
//     128, bn 64 or 128, bk a multiple of 128) and operands TMA can read
//     (16-byte aligned, K a multiple of 16).  The codes go from device
//     memory to shared memory by TMA, one byte each, and are multiplied
//     by native m64nNk32 e4m3 / e5m2 wgmma at the fp8 rate.  Both
//     operands are K-major: B arrives as [N, K] row-major (the wrapper
//     passes a column-major B view as it is, or copies a row-major one).
//     Each 128 values of K go into a zeroed partial accumulator that is
//     added to the float32 accumulator in registers: Hopper's fp8 wgmma
//     adds with a reduced-precision adder, and this promotion is what
//     torch._scaled_mm does by default.
//   * mma_sync (any other tile or operand; tile_common.cuh): each code is
//     upcast to bf16 while the K slice is staged into shared memory
//     (exact: every e4m3/e5m2 value is a bf16 value) and multiplied by
//     bf16 mma.sync m16n8k16 with a float32 accumulator.  B row-major.
//
// Both read the per-tensor scales from device memory (no host read) and
// apply them once in the epilogue, sx * sw in float32, then round the
// accumulator times that scale to bf16.
//
// What bounds it: at the full-width shapes the product is compute
// bound at the fp8 rate (1979 TFLOP/s).  The wgmma body waits for each
// box's four instructions before promoting, so the tensor pipe drains
// once per 128 values of K within a warpgroup, and the other consumer
// warpgroup's instructions fill the gap; a deeper bk (two boxes a
// stage) halves the stage handshakes.  A contiguous B costs a K-major
// copy in the wrapper, more than the product itself at full width.
//
// Entry points return the CUDA error of the launch (0 = launched).

#include "tile_common.cuh"
#include "wgmma_common.cuh"

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

bool wgmma_body(int M, int N, int K, int bm, int bn, int bk, bool aligned) {
  return wg::on_grid(1, true, bm, bn, bk) &&
         wg::tma_ready(1, N, K, bn, aligned);
}

}  // namespace

extern "C" {

// The mma_sync body stages as bf16: the same shared memory as
// matmul.cu's bf16 mma_sync body.
int fp8_matmul_smem_bytes(int bm, int bn, int bk) {
  return mma_stage_bytes<__nv_bfloat16>(bm, bn, bk);
}

// The wgmma body's ring of stages (one byte a code).
int fp8_matmul_wgmma_smem_bytes(int bm, int bn, int bk) {
  return wg::smem_bytes(1, bm, bn, bk);
}

// The body fp8_matmul_fwd runs: 0 wgmma, 1 mma_sync.
int fp8_matmul_body(int M, int N, int K, int bm, int bn, int bk,
                    int aligned) {
  return wgmma_body(M, N, K, bm, bn, bk, aligned != 0) ? 0 : 1;
}

// fmt 0 = e4m3 codes, 1 = e5m2 codes; sx, sw one float32 each on the
// device; C bf16.  b is row-major [K, N] (b_kmajor 0) or, on the wgmma
// body only, K-major: row-major [N, K] (b_kmajor 1).
int fp8_matmul_fwd(int fmt, const void* a, const void* b, const void* sx,
                   const void* sw, void* c, int M, int N, int K, int bm,
                   int bn, int bk, int b_kmajor, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      (fmt != 0 && fmt != 1))
    return cudaErrorInvalidValue;
  const float* fx = static_cast<const float*>(sx);
  const float* fw = static_cast<const float*>(sw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = !(reinterpret_cast<uintptr_t>(a) % 16) &&
                       !(reinterpret_cast<uintptr_t>(b) % 16);
  if (wgmma_body(M, N, K, bm, bn, bk, aligned)) {
    if (!b_kmajor || wg::smem_bytes(1, bm, bn, bk) > wg::kSmemLimit)
      return cudaErrorInvalidValue;
    const wg::StoreBF16 epi{static_cast<__nv_bfloat16*>(c), fx, fw, 0.f};
    return fmt == 0 ? wg::launch<wg::OpFP8<false>>(a, b, epi, M, N, K, bm,
                                                   bn, bk, st)
                    : wg::launch<wg::OpFP8<true>>(a, b, epi, M, N, K, bm,
                                                  bn, bk, st);
  }
  const int smem = mma_stage_bytes<__nv_bfloat16>(bm, bn, bk);
  if (b_kmajor || smem > kSmemLimit || (M + bm - 1) / bm > 65535)
    return cudaErrorInvalidValue;
  switch (fmt) {
    case 0: return launch<E4M3>(a, b, fx, fw, c, M, N, K, bm, bn, bk, smem, st);
    case 1: return launch<E5M2>(a, b, fx, fw, c, M, N, K, bm, bn, bk, smem, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
