// A register-blocked tile on the CUDA cores that reads operand slices
// as TMA writes them (tma_common.cuh): the consumer of async_pipeline.cu's
// TMA body and of matmul.cu's single-block float32 product (FmaOp:
// float32, acc = fmaf(a, b, acc)), and of dpx.cu's (max,+) product
// (MaxPlusOp: int32, acc = __viaddmax_s32(a, b, acc) = max(a + b, acc),
// the sums wrapping).  Both element types are 4 bytes, so one layout
// and one set of shared loads serve both.
//
// Stage layout, for a BM x BN output tile and a K slice of bk values
// (bk 16, 32, 64 or 128):
//   A [BM][bk], K fastest, as bk / abk boxes of [BM][abk] values, abk =
//     min(bk, 32): box rows of 64 or 128 bytes, swizzled 64B / 128B;
//   B [bk][BN], N fastest, as BN / bbn boxes of [bk][bbn] values, bbn =
//     min(BN, 32), swizzled the same way.
// Every box starts on 1024 bytes.
//
// Each of NTR x NTC threads owns a TM x TN micro-tile: rows tr + NTR i
// (i < TM) and TN / 4 groups of four contiguous columns 4 tc + 4 NTC g.
// Per four values of K a thread reads its TM rows of A and, for each k,
// its column groups of B as 16-byte shared loads through the swizzle,
// then runs TM * TN * 4 steps: at 8 x 8, 16 loads per 256 steps.
// slice() takes a range of a stage's K, so two copies of a tile can
// split each stage (K groups) and add their partial sums through shared
// memory at the end (spill, add: a sum, or a max for (max,+)).
// The strides are chosen for the banks: NTR is a multiple of 8, so a
// thread's rows share one swizzle phase, and the 32 / NTC consecutive
// thread rows of a warp (at most eight) read rows in distinct 16-byte
// bank groups; the column groups of a warp's threads are adjacent
// 16-byte chunks.  FmaOp's accumulator is
// float32 and every add an fmaf, not TF32 (which keeps about three
// decimal digits and misses the reference's 1e-4 at K = 4096).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ftile {

// The tile's arithmetic: its element type, the accumulator's start, the
// inner step and how two partial accumulators combine.
struct FmaOp {
  using T = float;
  using V4 = float4;
  static constexpr float kInit = 0.f;
  __device__ __forceinline__ static float step(float a, float b, float c) {
    return fmaf(a, b, c);
  }
  __device__ __forceinline__ static float join(float x, float y) { return x + y; }
};

struct MaxPlusOp {
  using T = int;
  using V4 = int4;
  static constexpr int kInit = -1073741824;   // iinfo(int32).min // 2
  __device__ __forceinline__ static int step(int a, int b, int c) {
    return __viaddmax_s32(a, b, c);
  }
  __device__ __forceinline__ static int join(int x, int y) { return max(x, y); }
};

// Values in one box row of an operand whose slice is `width` wide.
__host__ __device__ constexpr int box_vals(int width) {
  return width < 32 ? width : 32;
}

template <int BM, int BN, class Op = FmaOp>
struct Tile {
  using T = typename Op::T;
  using V4 = typename Op::V4;
  static constexpr int TM = BM >= 64 ? 8 : BM / 8;
  static constexpr int TN = BN >= 64 ? 8 : 4;
  static constexpr int NTR = BM / TM;   // thread rows
  static constexpr int NTC = BN / TN;   // thread columns
  static constexpr int kThreads = NTR * NTC;
  static constexpr int G = TN / 4;      // 16-byte column groups
  static constexpr int BBN = box_vals(BN);
  static constexpr int BRB = BBN * 4;   // B box row bytes
  static_assert(NTR % 8 == 0 && TN % 4 == 0 && BN % (4 * NTC) == 0,
                "tile shape");

  T acc[TM][TN];
  int tr, tc;

  __device__ explicit Tile(int t) : tr(t / NTC), tc(t % NTC) { zero(); }

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = Op::kInit;
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
        V4 a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          a[i] = *reinterpret_cast<const V4*>(pa_k + NTR * i * arb);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // k % 8 == 4h + kk: the swizzle key of row k is a constant
          const int key = BRB == 128 ? 4 * h + kk : (2 * h + kk / 2) & 3;
          const unsigned char* pb = sb + (k4 + kk) * BRB;
          V4 b[G];
#pragma unroll
          for (int g = 0; g < G; ++g)
            b[g] = *reinterpret_cast<const V4*>(
                pb + b_off[g] + ((b_chunk[g] ^ key) << 4));
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const T av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
            for (int g = 0; g < G; ++g) {
              T* c = &acc[i][4 * g];
              c[0] = Op::step(av, b[g].x, c[0]);
              c[1] = Op::step(av, b[g].y, c[1]);
              c[2] = Op::step(av, b[g].z, c[2]);
              c[3] = Op::step(av, b[g].w, c[3]);
            }
          }
        }
      }
    }
  }

  // Partial accumulators across threads: spill this thread's
  // accumulator to red (kThreads x TM x TN values, thread-interleaved
  // 16-byte vectors), or join another thread group's spilled
  // accumulator to it.
  __device__ void spill(T* red, int t) const {
#pragma unroll
    for (int q = 0; q < TM * TN / 4; ++q)
      reinterpret_cast<V4*>(red)[q * kThreads + t] =
          V4{acc[q / G][4 * (q % G)], acc[q / G][4 * (q % G) + 1],
             acc[q / G][4 * (q % G) + 2], acc[q / G][4 * (q % G) + 3]};
  }
  __device__ void add(const T* red, int t) {
#pragma unroll
    for (int q = 0; q < TM * TN / 4; ++q) {
      const V4 v = reinterpret_cast<const V4*>(red)[q * kThreads + t];
      T* c = &acc[q / G][4 * (q % G)];
      c[0] = Op::join(c[0], v.x);
      c[1] = Op::join(c[1], v.y);
      c[2] = Op::join(c[2], v.z);
      c[3] = Op::join(c[3], v.w);
    }
  }

  // Store the tile at C (its [0, 0] element, leading dimension ldc),
  // masked to rows x cols; 16-byte stores where C's rows are 16-byte
  // aligned (`vec`).
  __device__ void store(T* C, size_t ldc, int rows, int cols,
                        bool vec) const {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = tr + NTR * i;
      if (r >= rows) continue;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int c = 4 * tc + 4 * NTC * g;
        T* p = C + r * ldc + c;
        if (vec && c + 3 < cols) {
          *reinterpret_cast<V4*>(p) =
              V4{acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                 acc[i][4 * g + 3]};
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
