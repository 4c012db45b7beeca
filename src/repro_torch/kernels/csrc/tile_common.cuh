// Shared pieces of the tiled matrix-product kernels (matmul.cu,
// fp8_matmul.cu, async_pipeline.cu).
//
// One thread block of kThreads threads owns an output tile and walks it
// in sub-tiles of at most kMaxSubM x kMaxSubN; for each sub-tile it
// walks K in slices, stages the A and B slices through shared memory
// and accumulates in registers.  Two ways to multiply a staged slice:
//
//   * fma_slice — float32 on the CUDA cores (fmaf), each thread a
//     TM x TN micro-tile (rows ty + 16 i, cols tx + 16 j of a 16 x 16
//     thread grid).  Staged A is k-major (sa[k][m]) so the rows a
//     thread reads at one k are a broadcast; staged B is sb[k][n].
//   * mma_slice — warp-level mma.sync on the tensor cores: bf16
//     m16n8k16 -> f32, or s8 m16n8k32 -> s32 (the paper's Table VII
//     instructions).  Eight warps split the sub-tile 2 (rows) x 4
//     (cols), each warp up to 4 x 8 fragments of 16 x 8.  Staged A is
//     row-major sa[m][k], staged B is transposed sb[n][k], so every
//     fragment register is one aligned 32-bit shared-memory load; a row
//     is padded by 16 bytes against bank conflicts.  The slice is
//     zero-padded to whole fragments (16 rows, 8 cols, KF deep), so a
//     tile smaller than a fragment is still right.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

constexpr int kThreads = 256;            // 8 warps
constexpr int kMaxSubM = 128;            // output rows of one sub-tile
constexpr int kMaxSubN = 256;            // output cols of one sub-tile
constexpr int kSmemLimit = 232448;       // shared memory one block may use
constexpr int kWarpsM = 2, kWarpsN = 4;  // mma: warp grid over a sub-tile
constexpr int kFragM = 4, kFragN = 8;    // mma: fragments a warp holds

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// fp8 codes as they lie in device memory (one byte each)
struct E4M3 { uint8_t code; };
struct E5M2 { uint8_t code; };

// ---------------------------------------------------------------------
// element conversions: global element -> staged element, acc -> out
// ---------------------------------------------------------------------
template <class S> __device__ inline S zero();
template <> __device__ inline float zero<float>() { return 0.f; }
template <> __device__ inline __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
template <> __device__ inline int8_t zero<int8_t>() { return 0; }

template <class G, class S> struct Convert {
  __device__ static S f(G x) { return x; }
};
// fp8 -> bf16 is exact: both fp8 formats' values are bf16 values
template <> struct Convert<E4M3, __nv_bfloat16> {
  __device__ static __nv_bfloat16 f(E4M3 x) {
    __nv_fp8_e4m3 v;
    v.__x = x.code;
    return __float2bfloat16(static_cast<float>(v));
  }
};
template <> struct Convert<E5M2, __nv_bfloat16> {
  __device__ static __nv_bfloat16 f(E5M2 x) {
    __nv_fp8_e5m2 v;
    v.__x = x.code;
    return __float2bfloat16(static_cast<float>(v));
  }
};

template <class Out> __device__ inline Out out_cast(float v);
template <> __device__ inline float out_cast<float>(float v) { return v; }
template <> __device__ inline __nv_bfloat16 out_cast<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);           // round to nearest even
}

// accumulator (float or int) -> output element
template <class Out> struct OutCast {
  template <class Acc> __device__ Out operator()(Acc v) const {
    return static_cast<Out>(v);
  }
};
template <> struct OutCast<__nv_bfloat16> {
  __device__ __nv_bfloat16 operator()(float v) const {
    return out_cast<__nv_bfloat16>(v);
  }
};

// ---------------------------------------------------------------------
// staging: a rows x cols window of a row-major global matrix (leading
// dimension ldg, already offset to the window) into shared memory at
// s[r * s_row + c * s_col], converted to S, zero outside the valid
// rows_valid x cols_valid part.  Column index fastest: neighbouring
// threads read neighbouring global addresses.
// ---------------------------------------------------------------------
template <class G, class S>
__device__ inline void stage(S* s, int s_row, int s_col, const G* g,
                             size_t ldg, int rows, int cols, int rows_valid,
                             int cols_valid) {
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols, c = i % cols;
    s[r * s_row + c * s_col] = (r < rows_valid && c < cols_valid)
                                   ? Convert<G, S>::f(g[r * ldg + c])
                                   : zero<S>();
  }
}

// ---------------------------------------------------------------------
// CUDA-core float32 path
// ---------------------------------------------------------------------
template <int TM, int TN>
__device__ inline void fma_zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// sa[k][m] (m stride 1, k stride sub_m), sb[k][n] (k stride sub_n)
template <int TM, int TN>
__device__ inline void fma_slice(float (&acc)[TM][TN], const float* sa,
                                 const float* sb, int kk, int sub_m,
                                 int sub_n) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k = 0; k < kk; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + 16 * i;
      a[i] = r < sub_m ? sa[k * sub_m + r] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx + 16 * j;
      b[j] = c < sub_n ? sb[k * sub_n + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int TM, int TN, class Out>
__device__ inline void fma_store(float (&acc)[TM][TN], Out* C,
                                 size_t ldc, int rows_valid, int cols_valid) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      if (r < rows_valid && c < cols_valid)
        C[r * ldc + c] = out_cast<Out>(acc[i][j]);
    }
}

// Shared-memory bytes of one float32 staging buffer (A slice + B slice).
__host__ __device__ inline int fma_stage_bytes(int bm, int bn, int bk) {
  return 4 * bk * (imin(bm, kMaxSubM) + imin(bn, kMaxSubN));
}

// ---------------------------------------------------------------------
// tensor-core path (mma.sync)
// ---------------------------------------------------------------------
template <class S> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  using Acc = float;
  static constexpr int KF = 16;         // m16n8k16
  __device__ static void run(float (&c)[4], const uint32_t (&a)[4],
                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <> struct Mma<int8_t> {
  using Acc = int;
  static constexpr int KF = 32;         // m16n8k32
  __device__ static void run(int (&c)[4], const uint32_t (&a)[4],
                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Row stride (elements) of a staged mma slice bk deep: whole fragments
// plus 16 bytes of padding.
template <class S> __host__ __device__ inline int mma_lds(int bk) {
  return round_up(bk, Mma<S>::KF) + 16 / static_cast<int>(sizeof(S));
}

template <class S>
__host__ __device__ inline int mma_stage_bytes(int bm, int bn, int bk) {
  const int rows = round_up(imin(bm, kMaxSubM), 16) +
                   round_up(imin(bn, kMaxSubN), 8);
  return rows * mma_lds<S>(bk) * static_cast<int>(sizeof(S));
}

// The part of a sub-tile one warp owns: rows [wm * wrows, +wrows),
// cols [wn * wcols, +wcols), in whole fragments.
struct WarpTile {
  int wm, wn, wrows, wcols, g, t;
  __device__ WarpTile(int sub_m, int sub_n) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    wm = warp / kWarpsN;
    wn = warp % kWarpsN;
    wrows = round_up((sub_m + kWarpsM - 1) / kWarpsM, 16);
    wcols = round_up((sub_n + kWarpsN - 1) / kWarpsN, 8);
    g = lane >> 2;
    t = lane & 3;
  }
  __device__ bool row_frag(int i, int sub_m) const {
    return i * 16 < wrows && wm * wrows + i * 16 < sub_m;
  }
  __device__ bool col_frag(int j, int sub_n) const {
    return j * 8 < wcols && wn * wcols + j * 8 < sub_n;
  }
};

__device__ inline uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <class S, class Acc>
__device__ inline void mma_zero(Acc (&acc)[kFragM][kFragN][4]) {
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

// sa[m][k] and sb[n][k], row stride lds, k_pad deep (a multiple of KF)
template <class S>
__device__ inline void mma_slice(typename Mma<S>::Acc (&acc)[kFragM][kFragN][4],
                                 const S* sa, const S* sb, int lds, int k_pad,
                                 int sub_m, int sub_n) {
  constexpr int KF = Mma<S>::KF;
  constexpr int EPW = 4 / sizeof(S);    // elements per 32-bit register
  const WarpTile w(sub_m, sub_n);
  for (int kf = 0; kf < k_pad; kf += KF) {
    uint32_t a[kFragM][4];
#pragma unroll
    for (int i = 0; i < kFragM; ++i) {
      if (!w.row_frag(i, sub_m)) continue;
      const S* p = sa + (w.wm * w.wrows + i * 16 + w.g) * lds + kf + w.t * EPW;
      a[i][0] = ld32(p);                       // row g,   k t*EPW
      a[i][1] = ld32(p + 8 * lds);             // row g+8, k t*EPW
      a[i][2] = ld32(p + KF / 2);              // row g,   k t*EPW + KF/2
      a[i][3] = ld32(p + 8 * lds + KF / 2);    // row g+8, k t*EPW + KF/2
    }
#pragma unroll
    for (int j = 0; j < kFragN; ++j) {
      if (!w.col_frag(j, sub_n)) continue;
      const S* p = sb + (w.wn * w.wcols + j * 8 + w.g) * lds + kf + w.t * EPW;
      const uint32_t b0 = ld32(p), b1 = ld32(p + KF / 2);
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
        if (w.row_frag(i, sub_m)) Mma<S>::run(acc[i][j], a[i], b0, b1);
    }
  }
}

// Fragment element e of acc[i][j] sits at row g + 8 * (e / 2), col
// 2 t + e % 2 of the fragment.  `cast` turns an accumulator into Out.
template <class S, class Out, class Cast>
__device__ inline void mma_store(typename Mma<S>::Acc (&acc)[kFragM][kFragN][4],
                                 Out* C, size_t ldc, int sub_m, int sub_n,
                                 Cast cast) {
  const WarpTile w(sub_m, sub_n);
#pragma unroll
  for (int i = 0; i < kFragM; ++i) {
    if (!w.row_frag(i, sub_m)) continue;
#pragma unroll
    for (int j = 0; j < kFragN; ++j) {
      if (!w.col_frag(j, sub_n)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = w.wm * w.wrows + i * 16 + w.g + 8 * (e / 2);
        const int c = w.wn * w.wcols + j * 8 + 2 * w.t + e % 2;
        if (r < sub_m && c < sub_n) C[r * ldc + c] = cast(acc[i][j][e]);
      }
    }
  }
}

// One block's output tile [tm0, tm0 + bm) x [tn0, tn0 + bn) on the
// tensor cores: sub-tiles of at most kMaxSubM x kMaxSubN, K in slices
// of bk, global G converted to staged S while staging.
template <class G, class S, class Out, class Cast>
__device__ inline void mma_tile(const G* A, const G* B, Out* C, int M, int N,
                                int K, int tm0, int tn0, int bm, int bn,
                                int bk, unsigned char* smem, Cast cast) {
  using Acc = typename Mma<S>::Acc;
  const int lds = mma_lds<S>(bk);
  const int sub_m = imin(bm, kMaxSubM), sub_n = imin(bn, kMaxSubN);
  S* sa = reinterpret_cast<S*>(smem);
  S* sb = sa + round_up(sub_m, 16) * lds;
  for (int pm = 0; pm < bm; pm += sub_m)
    for (int pn = 0; pn < bn; pn += sub_n) {
      const int m0 = tm0 + pm, n0 = tn0 + pn;
      const int rows = imin(imin(sub_m, bm - pm), M - m0);
      const int cols = imin(imin(sub_n, bn - pn), N - n0);
      if (rows <= 0 || cols <= 0) continue;
      Acc acc[kFragM][kFragN][4];
      mma_zero<S>(acc);
      for (int k0 = 0; k0 < K; k0 += bk) {
        const int kk = imin(bk, K - k0);
        const int k_pad = round_up(kk, Mma<S>::KF);
        __syncthreads();                 // the last slice is consumed
        stage<G, S>(sa, lds, 1, A + (size_t)m0 * K + k0, K,
                    round_up(rows, 16), k_pad, rows, kk);
        stage<G, S>(sb, 1, lds, B + (size_t)k0 * N + n0, N, k_pad,
                    round_up(cols, 8), kk, cols);
        __syncthreads();
        mma_slice<S>(acc, sa, sb, lds, k_pad, rows, cols);
      }
      mma_store<S, Out>(acc, C + (size_t)m0 * N + n0, N, rows, cols, cast);
    }
}

// The same on the CUDA cores in float32.
template <int TM, int TN, class Out>
__device__ inline void fma_tile(const float* A, const float* B, Out* C, int M,
                                int N, int K, int tm0, int tn0, int bm, int bn,
                                int bk, unsigned char* smem) {
  const int sub_m = imin(bm, kMaxSubM), sub_n = imin(bn, kMaxSubN);
  float* sa = reinterpret_cast<float*>(smem);
  float* sb = sa + bk * sub_m;
  for (int pm = 0; pm < bm; pm += sub_m)
    for (int pn = 0; pn < bn; pn += sub_n) {
      const int m0 = tm0 + pm, n0 = tn0 + pn;
      const int rows = imin(imin(sub_m, bm - pm), M - m0);
      const int cols = imin(imin(sub_n, bn - pn), N - n0);
      if (rows <= 0 || cols <= 0) continue;
      float acc[TM][TN];
      fma_zero(acc);
      for (int k0 = 0; k0 < K; k0 += bk) {
        const int kk = imin(bk, K - k0);
        __syncthreads();
        stage<float, float>(sa, 1, rows, A + (size_t)m0 * K + k0, K, rows,
                            kk, rows, kk);
        stage<float, float>(sb, cols, 1, B + (size_t)k0 * N + n0, N, kk,
                            cols, kk, cols);
        __syncthreads();
        fma_slice(acc, sa, sb, kk, rows, cols);
      }
      fma_store(acc, C + (size_t)m0 * N + n0, N, rows, cols);
    }
}

// Dynamic shared memory above 48 KB must be opted into per kernel.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace tile
