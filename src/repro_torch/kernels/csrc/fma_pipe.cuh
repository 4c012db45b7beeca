// A TMA + mbarrier ring over the register-blocked tile of fma_tile.cuh:
// the tma body of async_pipeline.cu (pipelined_matmul) and the fma_tma
// body of matmul.cu (matmul's float32 products), on FmaOp; the tma body
// of dpx.cu's tropical_matmul, on MaxPlusOp (int32 operands through the
// same 4-byte tensor maps: TMA copies bits).
//
// One block per (BM, BN) output tile, BM and BN each 16, 32, 64 or 128;
// grid (M/BM, N/BN), M tiles fastest so a wave of blocks shares B's
// columns in L2.  A producer warp, one thread of which issues the TMA
// loads of A's [BM][bk] and B's [bk][BN] slices (boxes of at most 32
// floats a row, swizzled 64B or 128B by their row bytes,
// tma_common.cuh), and consumer threads running the float32 tile on
// each slice.  A ring of `stages` buffers with a `full` mbarrier (armed
// with the slice's bytes, completed by TMA) and an `empty` mbarrier
// (every consumer thread arrives once it has read the buffer) per
// buffer.  Loads past the edge fill zeros (ragged M, N, K exact for
// FmaOp; for MaxPlusOp a zero past K is not neutral, so its caller runs
// the ring only where bk divides K).
//
// K groups: a tile of one warp (16 x 16) or an 8 x 8 tile of two warps
// (64 x 64) runs two copies of itself, each over half of every stage's
// K, and adds the halves at the end through the ring's memory, so its
// block holds twice the consumer warps.  On an H100 at M=2048, K=4096,
// N=11008 that took 64^3 tiles (stages 2) from 5.87 to 4.97 ms and 16^3
// from 19.8 to 14.6 ms; the 4 x 4 tile of 32^3 ran slower with two
// groups and keeps one.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fma_tile.cuh"
#include "tma_common.cuh"

namespace fpipe {

constexpr int kSlack = 1024 + 128;   // 1024-byte alignment + mbarriers

// BM, BN and bk of the ring: each 16, 32, 64 or 128.
__host__ __device__ constexpr bool on_grid(int x) {
  return x == 16 || x == 32 || x == 64 || x == 128;
}

// TMA can read the operands of a (bm, bn) tile: 16-byte-aligned bases,
// row strides K * 4 and N * 4 whole 16 bytes, at most 65535 column tiles.
__host__ __device__ constexpr bool tma_ready(int N, int K, int bn,
                                             bool aligned) {
  return aligned && !(K % 4) && !(N % 4) && (N + bn - 1) / bn <= 65535;
}

// Threads of the float32 tile of a bm x bn block (fma_tile.cuh's rule).
__host__ __device__ constexpr int tile_threads(int bm, int bn) {
  return (bm >= 64 ? bm / 8 : 8) * (bn >= 64 ? bn / 8 : bn / 4);
}

__host__ __device__ constexpr int k_groups(int bm, int bn) {
  return tile_threads(bm, bn) <= 32 ||
                 (bm >= 64 && bn >= 64 && tile_threads(bm, bn) <= 64)
             ? 2
             : 1;
}

// Dynamic shared memory: `stages` buffers of an A and a B slice (or,
// with two K groups, the bm x bn partial sums if larger) plus alignment
// and barriers.
__host__ __device__ inline int smem_bytes(int bm, int bn, int bk,
                                          int stages) {
  const int ring = stages * 4 * bk * (bm + bn);
  const int red = k_groups(bm, bn) > 1 ? 4 * bm * bn : 0;
  return kSlack + (ring > red ? ring : red);
}

template <int BM, int BN, class Op = ftile::FmaOp>
struct Pipe {
  using Tile = ftile::Tile<BM, BN, Op>;
  static_assert(Tile::kThreads == tile_threads(BM, BN), "tile threads");
  static constexpr int KG = k_groups(BM, BN);
  static constexpr int kConsumers = KG * Tile::kThreads;
  static constexpr int kThreads = kConsumers + 32;   // + a producer warp
};

template <int BM, int BN, class Op = ftile::FmaOp>
__global__ void __launch_bounds__(Pipe<BM, BN, Op>::kThreads)
    tma_pipelined_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b,
                         typename Op::T* C, int M, int N, int K, int bk,
                         int stages, int vec) {
  using P = Pipe<BM, BN, Op>;
  using Tile = typename P::Tile;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - tma::smem_u32(smem_raw) % 1024)
                                    % 1024);
  const uint32_t base_u = tma::smem_u32(base);
  const int a_bytes = BM * bk * 4, st_bytes = a_bytes + bk * BN * 4;
  const int data = smem_bytes(BM, BN, bk, stages) - kSlack;
  const uint32_t full = base_u + data;                // stages x 8 bytes
  const uint32_t empty = full + stages * 8;
  const int nk = (K + bk - 1) / bk;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      tma::mbar_init(full + 8 * s, 1);
      tma::mbar_init(empty + 8 * s, P::kConsumers);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= P::kConsumers) {
    // producer: one thread keeps the ring full
    if (threadIdx.x != P::kConsumers) return;
    const int abk = ftile::box_vals(bk), bbn = Tile::BBN;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % stages;
      tma::mbar_wait(empty + 8 * s, ((kt / stages) & 1) ^ 1);
      const uint32_t sa = base_u + s * st_bytes, sb = sa + a_bytes;
      const uint32_t bar = full + 8 * s;
      tma::mbar_arrive_expect_tx(bar, st_bytes);
      const int k0 = kt * bk;
      for (int j = 0; j < bk / abk; ++j)
        tma::tma_load(sa + j * BM * abk * 4, &map_a, bar, k0 + j * abk, m0);
      for (int j = 0; j < BN / bbn; ++j)
        tma::tma_load(sb + j * bk * bbn * 4, &map_b, bar, n0 + j * bbn, k0);
    }
    return;
  }

  // consumer thread t of K group grp: K [grp * kh, (grp + 1) * kh) of
  // every stage
  const int grp = threadIdx.x / Tile::kThreads;
  const int t = threadIdx.x % Tile::kThreads;
  const int kh = bk / P::KG;
  Tile ft(t);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % stages;
    tma::mbar_wait(full + 8 * s, (kt / stages) & 1);
    const unsigned char* sa = base + s * st_bytes;
    ft.slice(sa, sa + a_bytes, bk, grp * kh, (grp + 1) * kh);
    tma::mbar_arrive(empty + 8 * s);
  }
  if constexpr (P::KG > 1) {
    // every load has landed and every stage is read: join the halves
    // through the ring's memory
    auto* red = reinterpret_cast<typename Op::T*>(base);
    tma::bar_sync(1, P::kConsumers);
    if (grp == 1) ft.spill(red, t);
    tma::bar_sync(1, P::kConsumers);
    if (grp == 1) return;
    ft.add(red, t);
  }
  ft.store(C + (size_t)m0 * N + n0, N, min(BM, M - m0), min(BN, N - n0),
           vec != 0);
}

template <int BM, int BN, class Op = ftile::FmaOp>
cudaError_t launch(const typename Op::T* a, const typename Op::T* b,
                   typename Op::T* c, int M, int N, int K, int bk,
                   int stages, cudaStream_t stream) {
  CUtensorMap ma, mb;
  cudaError_t err =
      tma::make_map(&ma, a, 4, M, K, BM, ftile::box_vals(bk));
  if (err != cudaSuccess) return err;
  err = tma::make_map(&mb, b, 4, K, N, bk, ftile::box_vals(BN));
  if (err != cudaSuccess) return err;
  auto kernel = tma_pipelined_kernel<BM, BN, Op>;
  const int smem = smem_bytes(BM, BN, bk, stages);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int vec = !(N % 4) && !(reinterpret_cast<uintptr_t>(c) % 16);
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, Pipe<BM, BN, Op>::kThreads, smem, stream>>>(
      ma, mb, c, M, N, K, bk, stages, vec);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_bn(int bn, const float* a, const float* b, float* c,
                      int M, int N, int K, int bk, int stages,
                      cudaStream_t st) {
  switch (bn) {
    case 16: return launch<BM, 16>(a, b, c, M, N, K, bk, stages, st);
    case 32: return launch<BM, 32>(a, b, c, M, N, K, bk, stages, st);
    case 64: return launch<BM, 64>(a, b, c, M, N, K, bk, stages, st);
    case 128: return launch<BM, 128>(a, b, c, M, N, K, bk, stages, st);
  }
  return cudaErrorInvalidValue;
}

// One product on the ring: (bm, bn) on the grid, bk 16 .. 128 floats a
// stage, `stages` buffers.  The caller has checked that TMA can read
// the operands (16-byte-aligned bases, K and N multiples of 4).
inline cudaError_t run(int bm, int bn, const float* a, const float* b,
                       float* c, int M, int N, int K, int bk, int stages,
                       cudaStream_t st) {
  switch (bm) {
    case 16: return launch_bn<16>(bn, a, b, c, M, N, K, bk, stages, st);
    case 32: return launch_bn<32>(bn, a, b, c, M, N, K, bk, stages, st);
    case 64: return launch_bn<64>(bn, a, b, c, M, N, K, bk, stages, st);
    case 128: return launch_bn<128>(bn, a, b, c, M, N, K, bk, stages, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace fpipe
