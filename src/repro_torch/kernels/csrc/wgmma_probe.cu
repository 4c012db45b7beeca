// Probe: do the TMA maps, the mbarrier and the wgmma descriptors of
// wgmma_common.cuh compute a product?  One warpgroup loads A [64, 64]
// bf16 (K-major) and B [64, 128] bf16 row-major (two 64-column boxes,
// read MN-major through the transpose bit) by TMA with 128-byte
// swizzle, waits on one mbarrier and runs four m64n128k16 wgmma into a
// 64 x 128 float32 C.  B's leading and stride byte offsets come from the
// caller, so a run can show which field order is right (the usual
// failure: wrong numbers, no error).  Not a kernel of any path;
// chip_smoke.py builds this source on its own and reports the outcome
// as a finding.

#include "wgmma_common.cuh"

namespace {

__global__ void wgmma_probe_kernel(const __grid_constant__ CUtensorMap ma,
                                   const __grid_constant__ CUtensorMap mb,
                                   float* C, int lbo, int sbo) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (wg::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sa = base, sb = base + 64 * 128;
  const uint32_t bar = base + 64 * 128 + 2 * 64 * 128;
  if (threadIdx.x == 0) {
    wg::mbar_init(bar, 1);
    wg::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::mbar_arrive_expect_tx(bar, 3 * 64 * 128);
    wg::tma_load(sa, &ma, bar, 0, 0);
    wg::tma_load(sb, &mb, bar, 0, 0);
    wg::tma_load(sb + 64 * 128, &mb, bar, 64, 0);
  }
  wg::mbar_wait(bar, 0);
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  wg::wgmma_fence();
#pragma unroll
  for (int q = 0; q < 4; ++q)
    wg::wgmma_bf16_n128<1>(d, wg::make_desc(sa + 32 * q, 16, 1024),
                           wg::make_desc(sb + q * 16 * 128, lbo, sbo), 1);
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg::fence_regs(d);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
    const int c = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
    C[r * 128 + c] = d[i];
  }
}

}  // namespace

// a [64, 64] and b [64, 128] bf16 row-major, c [64, 128] float32.
extern "C" int wgmma_probe(const void* a, const void* b, void* c, int lbo,
                           int sbo, void* stream) {
  CUtensorMap ma, mb;
  cudaError_t err = wg::make_map(&ma, a, 2, 64, 64, 64, 64);
  if (err != cudaSuccess) return err;
  err = wg::make_map(&mb, b, 2, 64, 128, 64, 64);
  if (err != cudaSuccess) return err;
  const int smem = 1024 + 3 * 64 * 128 + 64;
  err = cudaFuncSetAttribute(wgmma_probe_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  wgmma_probe_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      ma, mb, static_cast<float*>(c), lbo, sbo);
  return cudaGetLastError();
}
