// Tiled matrix product C = A @ B for Hopper (sm_90a): the port of the
// Pallas kernels `matmul` (matmul_kernel) and `single_tile_matmul` of
// src/repro/kernels/matmul.py.
//
// matmul_fwd: grid (N/bn, M/bm), one block of 256 threads per (bm, bn)
// output tile.  The TPU kernel carries an accumulator across a
// sequential K grid axis in VMEM scratch; here the K walk is a loop
// inside the block (blocks run in parallel, in no order), each K slice
// staged through shared memory, the accumulator in registers
// (tile_common.cuh).  bf16 and int8 run on the tensor cores through
// warp-level mma.sync (m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32, the
// paper's Table VII instructions); float32 runs on the CUDA cores in
// fmaf, not TF32 (the reference holds float32 to rtol 1e-5).  Output:
// float32 for float32 in, bf16 for bf16 in (f32 accumulator rounded
// once), int32 for int8 in.
//
// single_tile_matmul_fwd: the synchronous one-tile analog — a single
// block computes the whole product, walking K in slices of bk with the
// same instructions.  Its output is the accumulator's type: float32 for
// float32 and bf16 in, int32 for int8 in.
//
// What bounds it: at the full-width shapes (2048 x 4096 x 11008) the
// product is compute bound on the card (arithmetic intensity in the
// hundreds of FLOP/byte); this kernel's staging is element by element
// with one __syncthreads pair per slice and no copy/compute overlap, so
// it runs well below the tensor-core peak.  wgmma with TMA staging is
// the redesign.
//
// Entry points return the CUDA error of the launch (0 = launched).

#include "tile_common.cuh"

namespace {

using namespace tile;

enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <class S, class Out>
__global__ void __launch_bounds__(kThreads)
    mma_matmul_kernel(const S* A, const S* B, Out* C, int M, int N, int K,
                      int bm, int bn, int bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  mma_tile<S, S, Out>(A, B, C, M, N, K, blockIdx.y * bm, blockIdx.x * bn, bm,
                      bn, bk, smem, OutCast<Out>());
}

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads)
    fma_matmul_kernel(const float* A, const float* B, float* C, int M, int N,
                      int K, int bm, int bn, int bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  fma_tile<TM, TN, float>(A, B, C, M, N, K, blockIdx.y * bm, blockIdx.x * bn,
                          bm, bn, bk, smem);
}

int smem_bytes(int dtype, int bm, int bn, int bk) {
  switch (dtype) {
    case kF32: return fma_stage_bytes(bm, bn, bk);
    case kBF16: return mma_stage_bytes<__nv_bfloat16>(bm, bn, bk);
    case kI8: return mma_stage_bytes<int8_t>(bm, bn, bk);
  }
  return -1;
}

// float32: the micro-tile that covers the sub-tile (16 TM x 16 TN)
template <int TM, int TN>
int launch_fma(dim3 grid, int smem, cudaStream_t stream, const float* a,
               const float* b, float* c, int M, int N, int K, int bm, int bn,
               int bk) {
  auto kernel = fma_matmul_kernel<TM, TN>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a, b, c, M, N, K, bm, bn, bk);
  return cudaGetLastError();
}

int dispatch_fma(dim3 grid, int smem, cudaStream_t stream, const float* a,
                 const float* b, float* c, int M, int N, int K, int bm, int bn,
                 int bk) {
  const int sm = imin(bm, kMaxSubM), sn = imin(bn, kMaxSubN);
  if (sm <= 32 && sn <= 32)
    return launch_fma<2, 2>(grid, smem, stream, a, b, c, M, N, K, bm, bn, bk);
  if (sm <= 64 && sn <= 64)
    return launch_fma<4, 4>(grid, smem, stream, a, b, c, M, N, K, bm, bn, bk);
  if (sm <= 128 && sn <= 128)
    return launch_fma<8, 8>(grid, smem, stream, a, b, c, M, N, K, bm, bn, bk);
  return launch_fma<8, 16>(grid, smem, stream, a, b, c, M, N, K, bm, bn, bk);
}

template <class S, class Out>
int launch_mma(dim3 grid, int smem, cudaStream_t stream, const void* a,
               const void* b, void* c, int M, int N, int K, int bm, int bn,
               int bk) {
  auto kernel = mma_matmul_kernel<S, Out>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const S*>(a), static_cast<const S*>(b),
      static_cast<Out*>(c), M, N, K, bm, bn, bk);
  return cudaGetLastError();
}

// Launch one product with `out_acc`: output in the accumulator's type
// (single_tile) instead of the input's (matmul).
int run(int dtype, const void* a, const void* b, void* c, int M, int N, int K,
        int bm, int bn, int bk, bool out_acc, dim3 grid, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0)
    return cudaErrorInvalidValue;
  const int smem = smem_bytes(dtype, bm, bn, bk);
  if (smem < 0 || smem > kSmemLimit) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return dispatch_fma(grid, smem, stream, static_cast<const float*>(a),
                          static_cast<const float*>(b), static_cast<float*>(c),
                          M, N, K, bm, bn, bk);
    case kBF16:
      return out_acc
                 ? launch_mma<__nv_bfloat16, float>(grid, smem, stream, a, b,
                                                    c, M, N, K, bm, bn, bk)
                 : launch_mma<__nv_bfloat16, __nv_bfloat16>(
                       grid, smem, stream, a, b, c, M, N, K, bm, bn, bk);
    case kI8:
      return launch_mma<int8_t, int32_t>(grid, smem, stream, a, b, c, M, N, K,
                                         bm, bn, bk);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block stages for (bm, bn, bk).
int matmul_smem_bytes(int dtype, int bm, int bn, int bk) {
  return smem_bytes(dtype, bm, bn, bk);
}

// dtype 0 float32 -> float32, 1 bf16 -> bf16, 2 int8 -> int32.
// Tiles need not divide the problem: ragged edges are masked.
int matmul_fwd(int dtype, const void* a, const void* b, void* c, int M, int N,
               int K, int bm, int bn, int bk, void* stream) {
  if (bm <= 0 || bn <= 0 || (M + bm - 1) / bm > 65535)
    return cudaErrorInvalidValue;
  dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm);
  return run(dtype, a, b, c, M, N, K, bm, bn, bk, false, grid,
             static_cast<cudaStream_t>(stream));
}

// One block: dtype 0 float32 -> float32, 1 bf16 -> float32,
// 2 int8 -> int32; K walked in slices of bk.
int single_tile_matmul_fwd(int dtype, const void* a, const void* b, void* c,
                           int M, int N, int K, int bk, void* stream) {
  return run(dtype, a, b, c, M, N, K, M, N, bk, true, dim3(1, 1),
             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
