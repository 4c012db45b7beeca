// A register-blocked float32 tile on the CUDA cores (fmaf) that reads
// operand slices as TMA writes them (tma_common.cuh): the consumer of
// async_pipeline.cu's TMA body and of matmul.cu's single-block float32
// product.
//
// Stage layout, for a BM x BN output tile and a K slice of bk values
// (bk 16, 32, 64 or 128):
//   A [BM][bk], K fastest, as bk / abk boxes of [BM][abk] floats, abk =
//     min(bk, 32): box rows of 64 or 128 bytes, swizzled 64B / 128B;
//   B [bk][BN], N fastest, as BN / bbn boxes of [bk][bbn] floats, bbn =
//     min(BN, 32), swizzled the same way.
// Every box starts on 1024 bytes.
//
// Each of NTR x NTC threads owns a TM x TN micro-tile: rows tr + NTR i
// (i < TM) and TN / 4 groups of four contiguous columns 4 tc + 4 NTC g.
// Per four values of K a thread reads its TM rows of A and, for each k,
// its column groups of B as float4 (16-byte) shared loads through the
// swizzle, then runs TM * TN * 4 fmaf: at 8 x 8, 16 loads per 256 FMAs.
// slice() takes a range of a stage's K, so two copies of a tile can
// split each stage (K groups) and add their partial sums through shared
// memory at the end (spill, add).
// The strides are chosen for the banks: NTR is a multiple of 8, so a
// thread's rows share one swizzle phase, and the 32 / NTC consecutive
// thread rows of a warp (at most eight) read rows in distinct 16-byte
// bank groups; the column groups of a warp's threads are adjacent
// 16-byte chunks.  The accumulator is
// float32 and every add an fmaf, not TF32 (which keeps about three
// decimal digits and misses the reference's 1e-4 at K = 4096).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ftile {

// Values in one box row of an operand whose slice is `width` wide.
__host__ __device__ constexpr int box_vals(int width) {
  return width < 32 ? width : 32;
}

template <int BM, int BN>
struct Tile {
  static constexpr int TM = BM >= 64 ? 8 : BM / 8;
  static constexpr int TN = BN >= 64 ? 8 : 4;
  static constexpr int NTR = BM / TM;   // thread rows
  static constexpr int NTC = BN / TN;   // thread columns
  static constexpr int kThreads = NTR * NTC;
  static constexpr int G = TN / 4;      // float4 column groups
  static constexpr int BBN = box_vals(BN);
  static constexpr int BRB = BBN * 4;   // B box row bytes
  static_assert(NTR % 8 == 0 && TN % 4 == 0 && BN % (4 * NTC) == 0,
                "tile shape");

  float acc[TM][TN];
  int tr, tc;

  __device__ explicit Tile(int t) : tr(t / NTC), tc(t % NTC) { zero(); }

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  // acc += A_slice @ B_slice over K values [k0, k1) of a stage bk deep
  // (k0, k1 multiples of 8).
  __device__ void slice(const unsigned char* sa, const unsigned char* sb,
                        int bk, int k0, int k1) {
    const int abk = box_vals(bk), arb = 4 * abk;
    // a thread's rows all sit at row % 8 == tr % 8: one swizzle phase
    const int key_a = arb == 128 ? (tr & 7) : ((tr >> 1) & 3);
    const unsigned char* pa = sa + tr * arb;
    // B: box and 16-byte chunk of each column group
    int b_off[G], b_chunk[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = 4 * tc + 4 * NTC * g;
      b_off[g] = (c / BBN) * bk * BRB;
      b_chunk[g] = (c % BBN) / 4;
    }
    for (int k8 = k0; k8 < k1; k8 += 8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k4 = k8 + 4 * h;
        const unsigned char* pa_k =
            pa + (k4 / abk) * BM * arb + ((((k4 % abk) >> 2) ^ key_a) << 4);
        float4 a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          a[i] = *reinterpret_cast<const float4*>(pa_k + NTR * i * arb);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // k % 8 == 4h + kk: the swizzle key of row k is a constant
          const int key = BRB == 128 ? 4 * h + kk : (2 * h + kk / 2) & 3;
          const unsigned char* pb = sb + (k4 + kk) * BRB;
          float4 b[G];
#pragma unroll
          for (int g = 0; g < G; ++g)
            b[g] = *reinterpret_cast<const float4*>(
                pb + b_off[g] + ((b_chunk[g] ^ key) << 4));
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                             : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
            for (int g = 0; g < G; ++g) {
              float* c = &acc[i][4 * g];
              c[0] = fmaf(av, b[g].x, c[0]);
              c[1] = fmaf(av, b[g].y, c[1]);
              c[2] = fmaf(av, b[g].z, c[2]);
              c[3] = fmaf(av, b[g].w, c[3]);
            }
          }
        }
      }
    }
  }

  // Partial sums across threads: spill this thread's accumulator to
  // red (kThreads x TM x TN floats, thread-interleaved float4s), or add
  // another thread group's spilled accumulator to it.
  __device__ void spill(float* red, int t) const {
#pragma unroll
    for (int q = 0; q < TM * TN / 4; ++q)
      reinterpret_cast<float4*>(red)[q * kThreads + t] = make_float4(
          acc[q / G][4 * (q % G)], acc[q / G][4 * (q % G) + 1],
          acc[q / G][4 * (q % G) + 2], acc[q / G][4 * (q % G) + 3]);
  }
  __device__ void add(const float* red, int t) {
#pragma unroll
    for (int q = 0; q < TM * TN / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(red)[q * kThreads + t];
      float* c = &acc[q / G][4 * (q % G)];
      c[0] += v.x;
      c[1] += v.y;
      c[2] += v.z;
      c[3] += v.w;
    }
  }

  // Store the tile at C (its [0, 0] element, leading dimension ldc),
  // masked to rows x cols; float4 stores where C's rows are 16-byte
  // aligned (`vec`).
  __device__ void store(float* C, size_t ldc, int rows, int cols,
                        bool vec) const {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = tr + NTR * i;
      if (r >= rows) continue;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int c = 4 * tc + 4 * NTC * g;
        float* p = C + r * ldc + c;
        if (vec && c + 3 < cols) {
          *reinterpret_cast<float4*>(p) = make_float4(
              acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
              acc[i][4 * g + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < cols) p[j] = acc[i][4 * g + j];
        }
      }
    }
  }
};

}  // namespace ftile
