// Tiled matrix product C = A @ B for Hopper (sm_90a): the port of the
// Pallas kernels `matmul` (matmul_kernel) and `single_tile_matmul` of
// src/repro/kernels/matmul.py.
//
// matmul_fwd runs one of three bodies, chosen by the tile rule
// (matmul_body; kernels/matmul.py mirrors it as `body`):
//
//   * wgmma (bf16, int8; wgmma_common.cuh): when (bm, bn, bk) lie on the
//     warpgroup grid (bm 64 or 128, bn 64/128/256, bk whole 128-byte
//     box rows; bf16 bk <= 256) and TMA can read the operands (16-byte
//     aligned bases, row strides of whole 16 bytes).  Grid (M/bm, N/bn),
//     M tiles fastest so a wave of blocks shares B's columns in L2.  A
//     producer warp keeps a ring of TMA stages full; one consumer
//     warpgroup per 64 rows multiplies with m64nNk16 bf16 -> f32 (B
//     row-major, read MN-major through the transpose bit: no copy) or
//     m64nNk32 s8 -> s32 (B K-major, [N, K]: the wrapper passes a
//     column-major view as it is or copies a row-major one).  bf16 out
//     rounds the float32 accumulator once; int8 out is int32, exact.
//   * mma_sync (bf16, int8, any other tile or operand; tile_common.cuh):
//     one block of 256 threads per (bm, bn) tile walks K in slices of bk
//     staged element by element through shared memory, with warp-level
//     mma.sync (m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32, the paper's
//     Table VII instructions).  B row-major.
//   * fma (float32, always): the same walk on the CUDA cores in fmaf,
//     not TF32 (the reference holds float32 to rtol 1e-5).
//
// single_tile_matmul_fwd: the synchronous one-tile analog — a single
// block computes the whole product on the mma_sync / fma bodies,
// walking K in slices of bk.  Its output is the accumulator's type:
// float32 for float32 and bf16 in, int32 for int8 in.
//
// What bounds it: at the full-width shapes (2048 x 4096 x 11008) the
// product is compute bound (arithmetic intensity in the hundreds of
// FLOP/byte).  The wgmma body feeds the tensor cores from TMA stages
// that overlap the loads of later stages, with one wgmma group kept in
// flight, and reaches about half the bf16 peak there.  More K a stage
// and more stages both help it (a handshake a stage per warpgroup);
// sharing B between the two blocks of a cluster by TMA multicast and a
// persistent tile walk were both slower on the card, so neither is
// here.  The mma_sync body stages element by element with a
// __syncthreads pair per slice and stays well below the tensor-core
// peak.
//
// Entry points return the CUDA error of the launch (0 = launched).

#include "tile_common.cuh"
#include "wgmma_common.cuh"

namespace {

using namespace tile;

enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2 };
enum Body { kWgmma = 0, kMmaSync = 1, kFma = 2 };

int elt_of(int dtype) { return dtype == kBF16 ? 2 : 1; }

// The tile rule: which body a product runs.
int body_of(int dtype, int M, int N, int K, int bm, int bn, int bk,
            bool aligned) {
  if (dtype == kF32) return kFma;
  const int elt = elt_of(dtype);
  if (wg::on_grid(elt, false, bm, bn, bk) &&
      wg::tma_ready(elt, N, K, bn, aligned))
    return kWgmma;
  return kMmaSync;
}

bool aligned16(const void* a, const void* b) {
  return !(reinterpret_cast<uintptr_t>(a) % 16) &&
         !(reinterpret_cast<uintptr_t>(b) % 16);
}

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

// Bytes of dynamic shared memory one block stages for (bm, bn, bk) on
// the mma_sync / fma bodies.
int matmul_smem_bytes(int dtype, int bm, int bn, int bk) {
  return smem_bytes(dtype, bm, bn, bk);
}

// The same for the wgmma body (bf16, int8): its ring of stages.
int matmul_wgmma_smem_bytes(int dtype, int bm, int bn, int bk) {
  return wg::smem_bytes(elt_of(dtype), bm, bn, bk);
}

// The body matmul_fwd runs: 0 wgmma, 1 mma_sync, 2 fma.  `aligned`:
// both operands' base addresses are 16-byte aligned.
int matmul_body(int dtype, int M, int N, int K, int bm, int bn, int bk,
                int aligned) {
  return body_of(dtype, M, N, K, bm, bn, bk, aligned != 0);
}

// dtype 0 float32 -> float32, 1 bf16 -> bf16, 2 int8 -> int32.
// Tiles need not divide the problem: ragged edges are masked.  b is
// row-major [K, N] (b_kmajor 0) or, for int8 on the wgmma body only,
// K-major: row-major [N, K] (b_kmajor 1).
int matmul_fwd(int dtype, const void* a, const void* b, void* c, int M, int N,
               int K, int bm, int bn, int bk, int b_kmajor, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body_of(dtype, M, N, K, bm, bn, bk, aligned16(a, b)) == kWgmma) {
    if (b_kmajor != (dtype == kI8)) return cudaErrorInvalidValue;
    if (wg::smem_bytes(elt_of(dtype), bm, bn, bk) > wg::kSmemLimit)
      return cudaErrorInvalidValue;
    if (dtype == kBF16)
      return wg::launch<wg::OpBF16>(
          a, b, wg::StoreBF16{static_cast<__nv_bfloat16*>(c), nullptr,
                              nullptr, 0.f},
          M, N, K, bm, bn, bk, st);
    return wg::launch<wg::OpS8>(a, b, wg::StoreI32{static_cast<int*>(c)},
                                M, N, K, bm, bn, bk, st);
  }
  if (b_kmajor || (M + bm - 1) / bm > 65535) return cudaErrorInvalidValue;
  dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm);
  return run(dtype, a, b, c, M, N, K, bm, bn, bk, false, grid, st);
}

// One block: dtype 0 float32 -> float32, 1 bf16 -> float32,
// 2 int8 -> int32; K walked in slices of bk.
int single_tile_matmul_fwd(int dtype, const void* a, const void* b, void* c,
                           int M, int N, int K, int bk, void* stream) {
  return run(dtype, a, b, c, M, N, K, M, N, bk, true, dim3(1, 1),
             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
