// Matrix product with hand-staged copies for Hopper (sm_90a): the port
// of the Pallas kernel `pipelined_matmul` (_pipelined_kernel) of
// src/repro/kernels/async_pipeline.py, the paper's
// globalToShmemAsyncCopy (Tables XIII/XIV).  float32 in, float32
// accumulated on the CUDA cores (fmaf, never TF32), float32 out.
//
// Two bodies, chosen by a rule on the tile and the operands
// (pipelined_matmul_body; kernels/async_pipeline.py mirrors it as
// `body`), never as a fallback:
//
//   * tma (bm, bn, bk each 16, 32, 64 or 128; 16-byte-aligned bases; K
//     and N multiples of 4, so TMA can read both row strides; at most
//     65535 column tiles): the ring of fma_pipe.cuh, shared with
//     matmul.cu's float32 fma_tma body.  Grid (M/bm, N/bn), M tiles
//     fastest so a wave of blocks shares B's columns in L2.  One block
//     per (bm, bn) output tile: a producer warp, one thread of which
//     issues the TMA loads of A's [bm][bk] and B's [bk][bn] slices
//     (boxes of at most 32 floats a row, swizzled 64B or 128B by their
//     row bytes, tma_common.cuh), and consumer threads running the
//     register-blocked float32 tile of fma_tile.cuh on each slice (a
//     one-warp 16 x 16 tile and the 8 x 8 two-warp 64 x 64 tile run as
//     two K groups, each over half of every slice, for more warps an
//     SM).  A ring of `stages` buffers with a
//     `full` mbarrier (armed with the slice's bytes, completed by TMA)
//     and an `empty` mbarrier (every consumer thread arrives once it has
//     read the buffer) per buffer.
//       stages = 1  SyncShare: one buffer.  The producer issues slice k,
//                   the consumers wait on its full barrier and compute,
//                   and only after their arrival on its empty barrier
//                   does the copy of slice k + 1 start: copy and compute
//                   never overlap.
//       stages >= 2 AsyncPipe: while the consumers compute slice k the
//                   producer keeps slices k + 1 .. k + stages - 1 in
//                   flight.
//     Both use the same copy engine, so the two differ only in overlap,
//     as on the TPU, and no compute thread spends an instruction on a
//     copy.  Loads past the edge fill zeros (ragged M, N, K exact).
//   * cp_async (every other tile or operand): grid (N/bn, M/bm), one
//     block of 256 threads per tile (walked in sub-tiles of at most
//     128 x 256) and tile_common.cuh's fma_slice.  stages = 1 stages
//     every element with plain loads, __syncthreads, computes,
//     __syncthreads; stages >= 2 fills a ring of `stages` buffers with
//     cp.async (4 bytes an element, one commit group per slice): at slice
//     k, cp.async.wait_group(stages - 2) lands slice k, one
//     __syncthreads publishes it and frees the buffer slice k - 1 used,
//     and the copy of slice k + stages - 1 is issued into that buffer
//     before computing slice k.  The compute threads issue every copy.
//
// The TPU kernel prefetches one slice ahead for any stages >= 2; both
// bodies keep the ring full (stages - 1 ahead), which is the same for
// stages = 2.
//
// What bounds it: at 64 x 64 x 64 tiles a block does 16 FLOP per staged
// byte, so the card is bound by the CUDA cores' float32 rate; at 16^3
// tiles 4 FLOP per staged byte, and the bytes from L2 bound it.
//
// Entry points return the CUDA error of the launch (0 = launched).

#include "fma_pipe.cuh"
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


// ---------------------------------------------------------------------
// the tma body: fma_pipe.cuh's ring
// ---------------------------------------------------------------------
enum Body { kTma = 0, kCpAsync = 1 };

// The body a tile takes on operands TMA can read.
int tile_body(int bm, int bn, int bk) {
  return fpipe::on_grid(bm) && fpipe::on_grid(bn) && fpipe::on_grid(bk)
             ? kTma
             : kCpAsync;
}

// The rule: the tma body where the tile is on its grid and TMA can read
// both operands (16-byte-aligned bases, row strides K * 4 and N * 4
// whole 16 bytes, the N extent of the grid within 65535 blocks).
int body_of(int N, int K, int bm, int bn, int bk, bool aligned) {
  return tile_body(bm, bn, bk) == kTma && fpipe::tma_ready(N, K, bn, aligned)
             ? kTma
             : kCpAsync;
}

int smem_of(int body, int bm, int bn, int bk, int stages) {
  if (body == kTma) return fpipe::smem_bytes(bm, bn, bk, stages);
  return stages * fma_stage_bytes(bm, bn, bk);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the body a tile takes on operands TMA can
// read: tma, `stages` buffers of A and B slices plus alignment and
// barriers; cp_async, `stages` buffers of one A and one B slice each.
int pipelined_matmul_smem_bytes(int bm, int bn, int bk, int stages) {
  return smem_of(tile_body(bm, bn, bk), bm, bn, bk, stages);
}

// The body pipelined_matmul_fwd runs: 0 tma, 1 cp_async.  `aligned`:
// both operands' base addresses are 16-byte aligned.
int pipelined_matmul_body(int M, int N, int K, int bm, int bn, int bk,
                          int aligned) {
  (void)M;
  return body_of(N, K, bm, bn, bk, aligned != 0);
}

// float32 A [M,K], B [K,N] -> C [M,N]; stages 1 .. 4.
int pipelined_matmul_fwd(const void* a, const void* b, void* c, int M, int N,
                         int K, int bm, int bn, int bk, int stages,
                         void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      stages < 1 || stages > kMaxStages)
    return cudaErrorInvalidValue;
  const bool aligned = !(reinterpret_cast<uintptr_t>(a) % 16) &&
                       !(reinterpret_cast<uintptr_t>(b) % 16);
  const int body = body_of(N, K, bm, bn, bk, aligned);
  const int smem = smem_of(body, bm, bn, bk, stages);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fc = static_cast<float*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == kTma)
    return fpipe::run(bm, bn, fa, fb, fc, M, N, K, bk, stages, st);
  if ((M + bm - 1) / bm > 65535) return cudaErrorInvalidValue;
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
