// Probe: do tma_common.cuh's float32 tensor maps and its swizzle()
// agree with the hardware?  One block loads one box of a row-major
// float32 matrix by TMA (the swizzle chosen by the box's row bytes:
// 128 -> 128B, 64 -> 64B, 32 -> 32B, 16 -> none), waits on one
// mbarrier, and reads the box back element by element through
// swizzle() into a dense [box_rows][box_cols] output, which the caller
// compares with the matrix's corner.  A wrong swizzle gives wrong
// numbers, not an error.  Not a kernel of any path; chip_smoke.py and
// the card tests build this source on their own.

#include "tma_common.cuh"

namespace {

__global__ void tma_probe_kernel(const __grid_constant__ CUtensorMap map,
                                 float* out, int box_rows, int box_cols) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* box = smem_raw + ((1024 - tma::smem_u32(smem_raw) % 1024)
                                   % 1024);
  const int row_bytes = box_cols * 4;
  const uint32_t bytes = box_rows * row_bytes;
  const uint32_t bar = tma::smem_u32(box + ((bytes + 7) / 8) * 8);
  if (threadIdx.x == 0) {
    tma::mbar_init(bar, 1);
    tma::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    tma::mbar_arrive_expect_tx(bar, bytes);
    tma::tma_load(tma::smem_u32(box), &map, bar, 0, 0);
  }
  tma::mbar_wait(bar, 0);
  for (int i = threadIdx.x; i < box_rows * box_cols; i += blockDim.x) {
    const int r = i / box_cols, c = i % box_cols;
    out[i] = *reinterpret_cast<const float*>(
        box + tma::swizzle(r * row_bytes + c * 4, row_bytes));
  }
}

}  // namespace

// src [rows, cols] float32 row-major; out [box_rows, box_cols].
extern "C" int tma_probe(const void* src, void* out, int rows, int cols,
                         int box_rows, int box_cols, void* stream) {
  CUtensorMap map;
  cudaError_t err = tma::make_map(&map, src, 4, rows, cols, box_rows,
                                  box_cols);
  if (err != cudaSuccess) return err;
  const int smem = 1024 + box_rows * box_cols * 4 + 16;
  err = cudaFuncSetAttribute(tma_probe_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  tma_probe_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<float*>(out), box_rows, box_cols);
  return cudaGetLastError();
}
