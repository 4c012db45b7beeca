// Tensor Memory Accelerator (TMA) and mbarrier pieces shared by the
// Hopper (sm_90a) kernels that stage operands through shared memory:
// the wgmma bodies (wgmma_common.cuh), the single-block mma.sync /
// fmaf product (matmul.cu), the staged float32 product (fma_pipe.cuh)
// and the flash-attention wgmma body (flash_attention.cu).
//
//   * make_map encodes a 2-D tensor map of a row-major matrix, and
//     make_map_4d one of a rank-4 tensor (flash_attention.cu's
//     [B, S, heads, hd] operands, zero-filled past each batch's S),
//     through cuTensorMapEncodeTiled, looked up at run time through
//     cudaGetDriverEntryPoint, so nothing links against libcuda.  The
//     swizzle follows the box's row bytes: 128 -> SWIZZLE_128B, 64 ->
//     SWIZZLE_64B, 32 -> SWIZZLE_32B, anything else SWIZZLE_NONE.  Loads
//     past the tensor's edge fill zeros.
//   * swizzle(x, row_bytes) is where TMA put the byte at offset x of a
//     box in shared memory (the box 1024-byte aligned): the 16-byte chunk
//     index (bits 4..6) XOR the 128-byte line index (bits 7..9), masked
//     to the swizzle's width.  A consumer reading a swizzled box with
//     16-byte loads goes through it.
//   * mbarriers: init, arrive, arrive with an expected transaction count,
//     and a wait that traps after kHangCycles instead of hanging the card.
//   * tma_load / tma_load_4d: one box into shared memory, completing a
//     barrier's transaction count.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

constexpr long long kHangCycles = 1LL << 34;  // ~8.7 s at 1.98 GHz

// ---------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The swizzle TMA applies to a box whose rows are `row_bytes` long.
inline CUtensorMapSwizzle swizzle_for(int row_bytes) {
  switch (row_bytes) {
    case 128: return CU_TENSOR_MAP_SWIZZLE_128B;
    case 64: return CU_TENSOR_MAP_SWIZZLE_64B;
    case 32: return CU_TENSOR_MAP_SWIZZLE_32B;
  }
  return CU_TENSOR_MAP_SWIZZLE_NONE;
}

// A row-major [rows, cols] matrix of 1-, 2- (bf16) or 4-byte (float32)
// elements, read in boxes of box_rows x box_cols, swizzled by the box's
// row bytes, zeros past the edge.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int elt,
                            uint64_t rows, uint64_t cols, uint32_t box_rows,
                            uint32_t box_cols) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorInitializationError;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elt};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUtensorMapDataType type =
      elt == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : elt == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                  estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  swizzle_for(static_cast<int>(box_cols) * elt),
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A rank-4 tensor, dims[0] innermost and contiguous, strides[i] the
// byte stride of dims[i + 1] (whole 16 bytes), read in boxes of box[]
// values, swizzled by the box's row bytes (box[0] * elt), zeros past
// every dimension's edge: e.g. [B, S, heads, hd] as (hd, heads, S, B),
// so a box of S rows stops at its own batch's last row.
inline cudaError_t make_map_4d(CUtensorMap* map, const void* ptr, int elt,
                               const uint64_t (&dims)[4],
                               const uint64_t (&strides)[3],
                               const uint32_t (&box)[4]) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorInitializationError;
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t st[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t bx[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type =
      elt == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : elt == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUresult r = fn(map, type, 4, const_cast<void*>(ptr), d, st, bx, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  swizzle_for(static_cast<int>(box[0]) * elt),
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// device: swizzled addresses, shared memory, mbarriers, TMA
// ---------------------------------------------------------------------
// Offset of byte x of a box (1024-byte aligned) whose rows are
// row_bytes long, as TMA wrote it.
__host__ __device__ inline uint32_t swizzle(uint32_t x, int row_bytes) {
  const uint32_t mask = row_bytes == 128 ? 7 : row_bytes == 64 ? 3
                        : row_bytes == 32 ? 1 : 0;
  return x ^ (((x >> 7) & mask) << 4);
}

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ inline void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ inline void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ inline void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed.  A barrier
// that never completes (a refused TMA load) traps after kHangCycles
// instead of hanging the card.
__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0)
      t0 = clock64();
    else if (clock64() - t0 > kHangCycles)
      __trap();
  }
}

// One box of a 2-D tensor map at (c0 inner, c1 outer) into shared memory
// at `dst`, completing `bar`'s transaction count.
__device__ inline void tma_load(uint32_t dst, const CUtensorMap* map,
                                uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One box of a rank-4 tensor map at (c0 innermost .. c3).
__device__ inline void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                   uint32_t bar, int c0, int c1, int c2,
                                   int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Named barrier `id` (1..15; 0 is __syncthreads) among the `threads`
// threads, whole warps, that reach it.
__device__ inline void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace tma
