// Matrix product with hand-staged copies for Hopper (sm_90a): the port
// of the Pallas kernel `pipelined_matmul` (_pipelined_kernel) of
// src/repro/kernels/async_pipeline.py, the paper's
// globalToShmemAsyncCopy (Tables XIII/XIV).
//
// Grid (N/bn, M/bm), one block of 256 threads per (bm, bn) output tile
// (walked in sub-tiles of at most 128 x 256), K walked in slices of bk
// inside the block, float32 accumulated on the CUDA cores (fmaf) in
// registers, float32 out.
//
//   stages = 1  SyncShare: every thread loads its elements of the A and
//               B slices from global memory into shared memory with
//               plain loads, __syncthreads, compute, __syncthreads.  The
//               copy and the compute of a slice never overlap.
//   stages >= 2 AsyncPipe: a ring of `stages` shared-memory buffers
//               filled with cp.async (4 bytes an element, committed as
//               one group per slice).  The copies of the next
//               stages - 1 slices are in flight while a slice computes:
//               at slice k, cp.async.wait_group(stages - 2) lands slice
//               k, one __syncthreads publishes it and frees the buffer
//               slice k - 1 used, and the copy of slice k + stages - 1
//               is issued into that buffer before computing slice k.
//
// The TPU kernel prefetches one slice ahead for any stages >= 2; here
// the ring is kept full (stages - 1 ahead), which is the same for
// stages = 2.  TMA with mbarriers is the redesign.
//
// What bounds it: at 64 x 64 x 64 tiles the arithmetic intensity of a
// block is 16 FLOP per staged byte, so on the card it is bound by the
// CUDA cores' float32 rate and shared-memory traffic; the copies are
// what the pipeline hides.
//
// Entry points return the CUDA error of the launch (0 = launched).

#include "tile_common.cuh"

namespace {

using namespace tile;

constexpr int kMaxStages = 4;

__device__ inline void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `stage` of tile_common.cuh with cp.async: valid elements are copied
// asynchronously, the zero padding is stored directly.
__device__ inline void stage_async(float* s, int s_row, int s_col,
                                   const float* g, size_t ldg, int rows,
                                   int cols, int rows_valid, int cols_valid) {
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols, c = i % cols;
    float* dst = s + r * s_row + c * s_col;
    if (r < rows_valid && c < cols_valid)
      cp_async4(dst, g + r * ldg + c);
    else
      *dst = 0.f;
  }
}

template <int TM, int TN, int STAGES>
__global__ void __launch_bounds__(kThreads)
    pipelined_kernel(const float* A, const float* B, float* C, int M, int N,
                     int K, int bm, int bn, int bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sub_m = imin(bm, kMaxSubM), sub_n = imin(bn, kMaxSubN);
  const int buf_elems = bk * (sub_m + sub_n);
  float* ring = reinterpret_cast<float*>(smem);
  const int tm0 = blockIdx.y * bm, tn0 = blockIdx.x * bn;
  const int nk = (K + bk - 1) / bk;
  for (int pm = 0; pm < bm; pm += sub_m)
    for (int pn = 0; pn < bn; pn += sub_n) {
      const int m0 = tm0 + pm, n0 = tn0 + pn;
      const int rows = imin(imin(sub_m, bm - pm), M - m0);
      const int cols = imin(imin(sub_n, bn - pn), N - n0);
      if (rows <= 0 || cols <= 0) continue;
      const float* a0 = A + (size_t)m0 * K;
      const float* b0 = B + n0;
      float acc[TM][TN];
      fma_zero(acc);
      if constexpr (STAGES == 1) {
        float* sa = ring;
        float* sb = ring + bk * sub_m;
        for (int ks = 0; ks < nk; ++ks) {
          const int k0 = ks * bk, kk = imin(bk, K - k0);
          __syncthreads();              // the last slice is consumed
          stage<float, float>(sa, 1, rows, a0 + k0, K, rows, kk, rows, kk);
          stage<float, float>(sb, cols, 1, b0 + (size_t)k0 * N, N, kk, cols,
                              kk, cols);
          __syncthreads();              // the slice is in shared memory
          fma_slice(acc, sa, sb, kk, rows, cols);
        }
      } else {
        // slice ks into buffer ks % STAGES; one commit group per slice
        // (empty past the last slice, so the group count stays uniform)
        auto issue = [&](int ks) {
          if (ks < nk) {
            float* sa = ring + (ks % STAGES) * buf_elems;
            float* sb = sa + bk * sub_m;
            const int k0 = ks * bk, kk = imin(bk, K - k0);
            stage_async(sa, 1, rows, a0 + k0, K, rows, kk, rows, kk);
            stage_async(sb, cols, 1, b0 + (size_t)k0 * N, N, kk, cols, kk,
                        cols);
          }
          cp_async_commit();
        };
        __syncthreads();                // the previous sub-tile is done
#pragma unroll
        for (int s = 0; s < STAGES - 1; ++s) issue(s);
        for (int ks = 0; ks < nk; ++ks) {
          cp_async_wait<STAGES - 2>();  // this thread's copies of slice ks
          __syncthreads();              // everyone's; buffer of ks-1 free
          issue(ks + STAGES - 1);       // in flight during compute(ks)
          const float* sa = ring + (ks % STAGES) * buf_elems;
          fma_slice(acc, sa, sa + bk * sub_m, imin(bk, K - ks * bk), rows,
                    cols);
        }
        cp_async_wait<0>();
      }
      fma_store(acc, C + (size_t)m0 * N + n0, N, rows, cols);
    }
}

template <int TM, int TN, int STAGES>
int launch(const float* a, const float* b, float* c, int M, int N, int K,
           int bm, int bn, int bk, int smem, cudaStream_t stream) {
  auto kernel = pipelined_kernel<TM, TN, STAGES>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm);
  kernel<<<grid, kThreads, smem, stream>>>(a, b, c, M, N, K, bm, bn, bk);
  return cudaGetLastError();
}

template <int TM, int TN>
int by_stages(int stages, const float* a, const float* b, float* c, int M,
              int N, int K, int bm, int bn, int bk, int smem,
              cudaStream_t stream) {
  switch (stages) {
    case 1: return launch<TM, TN, 1>(a, b, c, M, N, K, bm, bn, bk, smem, stream);
    case 2: return launch<TM, TN, 2>(a, b, c, M, N, K, bm, bn, bk, smem, stream);
    case 3: return launch<TM, TN, 3>(a, b, c, M, N, K, bm, bn, bk, smem, stream);
    case 4: return launch<TM, TN, 4>(a, b, c, M, N, K, bm, bn, bk, smem, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// `stages` buffers of one float32 A slice and one B slice each.
int pipelined_matmul_smem_bytes(int bm, int bn, int bk, int stages) {
  return stages * fma_stage_bytes(bm, bn, bk);
}

// float32 A [M,K], B [K,N] -> C [M,N]; stages 1 .. 4.
int pipelined_matmul_fwd(const void* a, const void* b, void* c, int M, int N,
                         int K, int bm, int bn, int bk, int stages,
                         void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      stages < 1 || stages > kMaxStages || (M + bm - 1) / bm > 65535)
    return cudaErrorInvalidValue;
  const int smem = stages * fma_stage_bytes(bm, bn, bk);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fc = static_cast<float*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sm = imin(bm, kMaxSubM), sn = imin(bn, kMaxSubN);
  if (sm <= 32 && sn <= 32)
    return by_stages<2, 2>(stages, fa, fb, fc, M, N, K, bm, bn, bk, smem, st);
  if (sm <= 64 && sn <= 64)
    return by_stages<4, 4>(stages, fa, fb, fc, M, N, K, bm, bn, bk, smem, st);
  if (sm <= 128 && sn <= 128)
    return by_stages<8, 8>(stages, fa, fb, fc, M, N, K, bm, bn, bk, smem, st);
  return by_stages<8, 16>(stages, fa, fb, fc, M, N, K, bm, bn, bk, smem, st);
}

}  // extern "C"
