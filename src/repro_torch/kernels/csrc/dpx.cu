// DPX kernels for Hopper (sm_90a): the port of the Pallas kernels
// `tropical_matmul` (_tropical_kernel) and `smith_waterman` (_sw_kernel)
// of src/repro/kernels/dpx_kernel.py, and of the fused DPX function
// family of src/repro/core/dpx.py (FUSED).
//
// Hopper fuses min/max with an add or a relu into one instruction
// (__viaddmax_s32, __vimax3_s32_relu, ... and the _s16x2 forms on
// packed halfword pairs; SASS VIADDMNMX / VIMNMX3).  The TPU kernels
// write the same expressions as one VPU loop; here each one is the
// intrinsic.
//
// dpx_fused_fwd: one elementwise pass out = f(a, b, c) for f in
//   {viaddmax, viaddmin, viaddmax_relu, vimax3, vimax3_relu}, int32 or
//   int16.  int16 runs on packed pairs (one _s16x2 instruction per two
//   elements) with an odd last element done alone.  Bound by bytes:
//   three inputs read and one output written, 16 bytes of four 32-bit
//   words a thread per load.
//
// tropical_matmul_fwd: int32 C[i,j] = max(INT_MIN, max_k(A[i,k]+B[k,j]))
//   with INT_MIN = iinfo(int32).min // 2 (dpx_kernel.py:27), the sums
//   wrapping in int32 as JAX's do.  Bound by operations: one DPX
//   instruction (acc = __viaddmax_s32(a, b, acc)) per (i, j, k), at the
//   int32 rate of 64 lanes an SM a clock.  The TPU kernel carries its
//   accumulator across a sequential K grid axis; here K is a loop inside
//   the block.  Two bodies, which the caller names (the rule is
//   kernels/dpx_kernel.py `body`):
//   * tma: fma_pipe.cuh's ring on MaxPlusOp.  One block per 128 x 128
//     output tile, a producer warp's TMA loads of 32-deep K slices into
//     a four-stage mbarrier ring, and 256 consumer threads of 8 x 8
//     accumulators reading A and B as 16-byte shared loads (16 LDS.128
//     per 256 DPX instructions, half the shared-memory bandwidth at the
//     DPX rate).  TMA fills past the edge with zeros, which is not
//     neutral for (max,+) past K, so it runs only where 32 divides K;
//     rows and columns past M and N are never stored.  The caller's
//     tiles do not shape it.
//   * staged (any other operands): one block of 256 threads per (bm, bn)
//     tile, K walked in bk slices copied element by element into shared
//     memory; a block holds at most a 64 x 64 sub-tile of accumulators
//     in registers (16 a thread) and walks a larger tile sub-tile by
//     sub-tile.  Shared-memory loads, not the DPX rate, limit it (two
//     scalar loads per 1-4 DPX instructions).
//
// smith_waterman_fwd: best local-alignment score per pair, linear gap:
//   H[i][j] = max(H[i-1][j-1] + s, H[i-1][j] + gap, H[i][j-1] + gap, 0),
//   H = 0 on row and column 0, s = match where the symbols are equal,
//   else mismatch (symbols are any int32 values); the score is the
//   largest H.  The TPU kernel walks anti-diagonals, one grid step each,
//   over host-packed substitution lanes.  Here a warp computes a band of
//   32 S columns, S a lane, in registers: at step t lane l computes row
//   i = t - l of its columns, and lane l - 1 hands it by __shfl_up_sync
//   the left neighbour H[i][j0-1] (its last column, computed one step
//   earlier), the diagonal H[i-1][j0-1] (what it handed one step
//   earlier) and the row's symbol.  A cell is two DPX instructions:
//     e = __viaddmax_s32_relu(diag, s, up + gap) = max(diag+s, up+gap, 0)
//     H = __viaddmax_s32(left, gap, e)           = max(left + gap, e),
//   the same four terms as the plain version's, so equal bit for bit
//   (sums wrap in int32); only the second is on the chain along the row.
//   No block barrier runs inside the row loop.  A band's right edge (one
//   int32 a row) goes to the next band through a scratch tensor the
//   caller allocates; the warps of a pair's block take its bands in
//   turn (band k on warp k % warps), and a warp publishes its rows in
//   shared memory every 32 rows, so band k + 1 trails band k by about
//   64 rows.  Shared memory does not grow with the lengths.  The caller
//   passes the longer sequence as the rows (the score is symmetric) and
//   the plan (S, warps, pairs a block; kernels/dpx_kernel.py
//   `smith_waterman_plan`).  Bound by operations: about six int32
//   instructions a cell (the compare and select of s, an add, two DPX
//   instructions, a running max), all on the integer pipe (16 lanes a
//   clock a quarter SM).  Steps run in chunks of 32, unrolled by 8: a
//   chunk loads 32 rows' symbols (and the left edge) one a lane, so the
//   per-step work besides the cells is three or four shuffles and the
//   row test, not a chunk test and index arithmetic on every step.
//
// Entry points return the CUDA error of the launch (0 = launched).

#include <cuda_runtime.h>

#include <cstdint>

#include "fma_pipe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;          // per-block shared memory
constexpr int kIntMinHalf = -1073741824;    // iinfo(int32).min // 2
constexpr int kSub = 64;                    // largest sub-tile edge

enum Fn { kViaddmax = 0, kViaddmin, kViaddmaxRelu, kVimax3, kVimax3Relu };
enum Dtype { kI32 = 0, kI16 = 1 };

template <int F>
__device__ __forceinline__ unsigned op_s32(unsigned a, unsigned b,
                                           unsigned c) {
  const int x = static_cast<int>(a), y = static_cast<int>(b),
            z = static_cast<int>(c);
  int r;
  if constexpr (F == kViaddmax) r = __viaddmax_s32(x, y, z);
  else if constexpr (F == kViaddmin) r = __viaddmin_s32(x, y, z);
  else if constexpr (F == kViaddmaxRelu) r = __viaddmax_s32_relu(x, y, z);
  else if constexpr (F == kVimax3) r = __vimax3_s32(x, y, z);
  else r = __vimax3_s32_relu(x, y, z);
  return static_cast<unsigned>(r);
}

template <int F>
__device__ __forceinline__ unsigned op_s16x2(unsigned a, unsigned b,
                                             unsigned c) {
  if constexpr (F == kViaddmax) return __viaddmax_s16x2(a, b, c);
  else if constexpr (F == kViaddmin) return __viaddmin_s16x2(a, b, c);
  else if constexpr (F == kViaddmaxRelu) return __viaddmax_s16x2_relu(a, b, c);
  else if constexpr (F == kVimax3) return __vimax3_s16x2(a, b, c);
  else return __vimax3_s16x2_relu(a, b, c);
}

template <int F, bool kHalf>
__device__ __forceinline__ unsigned word_op(unsigned a, unsigned b,
                                            unsigned c) {
  if constexpr (kHalf) return op_s16x2<F>(a, b, c);
  else return op_s32<F>(a, b, c);
}

// `words` 32-bit words (int32 elements or int16 pairs); with `vec` the
// first words/4 are read and written as 16-byte vectors.  With
// `odd_tail` (int16 of odd length) thread 0 also does the last element,
// packed with zeros in the high halfword.
template <int F, bool kHalf>
__global__ void __launch_bounds__(kThreads)
    dpx_fused_kernel(const unsigned* __restrict__ a,
                     const unsigned* __restrict__ b,
                     const unsigned* __restrict__ c,
                     unsigned* __restrict__ out, long long words, bool vec,
                     bool odd_tail) {
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long n4 = words / 4;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    const uint4* c4 = reinterpret_cast<const uint4*>(c);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < n4; i += stride) {
      const uint4 x = a4[i], y = b4[i], z = c4[i];
      uint4 r;
      r.x = word_op<F, kHalf>(x.x, y.x, z.x);
      r.y = word_op<F, kHalf>(x.y, y.y, z.y);
      r.z = word_op<F, kHalf>(x.z, y.z, z.z);
      r.w = word_op<F, kHalf>(x.w, y.w, z.w);
      o4[i] = r;
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < words; i += stride)
    out[i] = word_op<F, kHalf>(a[i], b[i], c[i]);
  if constexpr (kHalf) {
    if (odd_tail && tid == 0) {
      const auto* a16 = reinterpret_cast<const unsigned short*>(a);
      const auto* b16 = reinterpret_cast<const unsigned short*>(b);
      const auto* c16 = reinterpret_cast<const unsigned short*>(c);
      const long long last = 2 * words;
      const unsigned r = word_op<F, kHalf>(a16[last], b16[last], c16[last]);
      reinterpret_cast<unsigned short*>(out)[last] =
          static_cast<unsigned short>(r & 0xffffu);
    }
  }
}

template <int F>
int launch_fused(int dtype, const void* a, const void* b, const void* c,
                 void* out, long long n, cudaStream_t stream) {
  const bool half = dtype == kI16;
  const long long words = half ? n / 2 : n;
  const bool odd_tail = half && (n & 1);
  auto aligned = [](const void* p, uintptr_t m) {
    return (reinterpret_cast<uintptr_t>(p) & (m - 1)) == 0;
  };
  if (!(aligned(a, 4) && aligned(b, 4) && aligned(c, 4) && aligned(out, 4)))
    return cudaErrorMisalignedAddress;
  const bool vec = aligned(a, 16) && aligned(b, 16) && aligned(c, 16) &&
                   aligned(out, 16);
  long long work = vec ? words / 4 + words % 4 : words;
  if (work < 1) work = 1;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  const auto* ua = static_cast<const unsigned*>(a);
  const auto* ub = static_cast<const unsigned*>(b);
  const auto* uc = static_cast<const unsigned*>(c);
  auto* uo = static_cast<unsigned*>(out);
  if (half)
    dpx_fused_kernel<F, true><<<static_cast<int>(blocks), kThreads, 0,
                                stream>>>(ua, ub, uc, uo, words, vec,
                                          odd_tail);
  else
    dpx_fused_kernel<F, false><<<static_cast<int>(blocks), kThreads, 0,
                                 stream>>>(ua, ub, uc, uo, words, vec,
                                           false);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// tropical (max, +) product
// ---------------------------------------------------------------------

enum TropicalBody { kTropTma = 0, kTropStaged = 1 };
// the tma body's tile: 128 x 128 outputs, 32-deep K slices, four stages
constexpr int kTropTile = 128, kTropBk = 32, kTropStages = 4;

// the staged body's shared memory: a bk-deep slice of A (rows padded by
// one word) and of B for one sub-tile of at most kSub x kSub
int tropical_smem(int bm, int bn, int bk) {
  const int sm = bm < kSub ? bm : kSub, sn = bn < kSub ? bn : kSub;
  return 4 * bk * ((sm + 1) + sn);
}

// A 16 x 16 thread grid; thread (ty, tx) owns rows ty + 16 r and
// columns tx + 16 c (r, c < R) of the current sub-tile.
template <int R>
__global__ void __launch_bounds__(kThreads)
    tropical_kernel(const int* __restrict__ A, const int* __restrict__ B,
                    int* __restrict__ C, int N, int K, int bm, int bn,
                    int bk) {
  extern __shared__ int smem[];
  const int sm = min(bm, kSub), sn = min(bn, kSub);
  const int lda = sm + 1;                    // odd stride: no bank clash
  int* As = smem;                            // [bk][lda], k-major
  int* Bs = smem + bk * lda;                 // [bk][sn]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * bm, col0 = blockIdx.x * bn;
  for (int si = 0; si < bm; si += sm) {
    for (int sj = 0; sj < bn; sj += sn) {
      const int rows = min(sm, bm - si), cols = min(sn, bn - sj);
      int acc[R][R];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) acc[r][c] = kIntMinHalf;
      for (int k0 = 0; k0 < K; k0 += bk) {
        const int kk = min(bk, K - k0);
        __syncthreads();                     // the last slice is read
        for (int t = threadIdx.x; t < rows * kk; t += blockDim.x) {
          const int r = t / kk, k = t % kk;
          As[k * lda + r] =
              A[static_cast<size_t>(row0 + si + r) * K + k0 + k];
        }
        for (int t = threadIdx.x; t < kk * cols; t += blockDim.x) {
          const int k = t / cols, c = t % cols;
          Bs[k * sn + c] =
              B[static_cast<size_t>(k0 + k) * N + col0 + sj + c];
        }
        __syncthreads();
        for (int k = 0; k < kk; ++k) {
          int av[R], bv[R];
#pragma unroll
          for (int r = 0; r < R; ++r)
            av[r] = As[k * lda + min(ty + 16 * r, sm - 1)];
#pragma unroll
          for (int c = 0; c < R; ++c)
            bv[c] = Bs[k * sn + min(tx + 16 * c, sn - 1)];
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int c = 0; c < R; ++c)
              acc[r][c] = __viaddmax_s32(av[r], bv[c], acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int i = ty + 16 * r, j = tx + 16 * c;
          if (i < rows && j < cols)
            C[static_cast<size_t>(row0 + si + i) * N + col0 + sj + j] =
                acc[r][c];
        }
    }
  }
}

template <int R>
int launch_tropical(dim3 grid, int smem, cudaStream_t stream, const int* a,
                    const int* b, int* c, int N, int K, int bm, int bn,
                    int bk) {
  auto kernel = tropical_kernel<R>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a, b, c, N, K, bm, bn, bk);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// Smith-Waterman: a register wavefront in warps
// ---------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSwMaxWarps = 16;

// Dynamic shared memory of a pair's block of `warps` warps: the rows
// each warp has published (8 bytes) and its best score (4 bytes); none
// when a warp holds a whole pair.
int sw_smem(int warps) { return warps > 1 ? 12 * warps : 0; }

// A block runs `pairs` pairs of one band each (warps == 1), or one pair
// whose bands its `warps` warps take in turn.  rseq [B, rows] holds the
// rows' symbols, cseq [B, cols] the columns'; edge [B, bands - 1, rows]
// the right edge of every band but the last.
template <int S>
__global__ void __launch_bounds__(kSwMaxWarps * 32)
    sw_band_kernel(const int* __restrict__ rseq,
                   const int* __restrict__ cseq, int* __restrict__ out,
                   int* __restrict__ edge, int B, int rows, int cols,
                   int warps, int pairs, int match, int mismatch, int gap) {
  extern __shared__ long long sw_shared[];
  long long* prog = sw_shared;                        // [warps]
  int* red = reinterpret_cast<int*>(prog + warps);    // [warps]
  constexpr int W = 32 * S;
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int w = wid % warps;
  const long long pair = static_cast<long long>(blockIdx.x) * pairs +
                         wid / warps;
  const int bands = (cols + W - 1) / W;
  const long long span = rows + 1LL;       // prog = band * span + rows done
  if (warps > 1) {                         // then pairs == 1: no early exit
    if (lane == 0) prog[w] = -1;
    __syncthreads();
  }
  if (pair >= B) return;
  const int* A = rseq + pair * rows;
  const int* Bs = cseq + pair * cols;
  int* E = edge + pair * (bands - 1) * static_cast<long long>(rows);
  int best = 0;
  for (int k = w; k < bands; k += warps) {
    const int c0 = k * W + lane * S;
    const int nv = min(max(cols - c0, 0), S);    // this lane's columns
    int sym[S], h[S], top[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sym[s] = s < nv ? Bs[c0 + s] : 0;
      h[s] = 0;                                  // row 0
      top[s] = 0;                                // best H of the column
    }
    const bool feeds = k < bands - 1;
    const int* e_in = E + (k - 1) * static_cast<long long>(rows);
    int* e_out = E + k * static_cast<long long>(rows);
    const bool edge_lane = feeds && lane == 31;
    int a_next = lane < rows ? A[lane] : 0;
    int e_chunk = 0, a_cur = 0, left_prev = 0;
    // 32 steps a chunk: at step t = base + 1 + r lane l computes row
    // i = t - l; lane 0 takes row t's symbol (and, past band 0, the
    // left edge) from the chunk's registers, lane r holding row base + r
    for (int base = 0; base < rows + 31; base += 32) {
      const int a_chunk = a_next;
      a_next = base + 32 + lane < rows ? A[base + 32 + lane] : 0;
      if (k > 0 && base < rows) {
        // band k - 1's edge for these rows, once its warp published them
        const long long need = (k - 1) * span + min(base + 32, rows);
        const volatile long long* p = prog + (k - 1) % warps;
        while (*p < need) {
        }
        __threadfence_block();
        e_chunk = base + lane < rows ? __ldcg(e_in + base + lane) : 0;
      }
      const int n = min(32, rows + 31 - base);
#pragma unroll 8
      for (int r = 0; r < n; ++r) {
        const int left_up = __shfl_up_sync(kFull, h[S - 1], 1);
        const int a_up = __shfl_up_sync(kFull, a_cur, 1);
        const int a0 = __shfl_sync(kFull, a_chunk, r);
        const int left0 = k > 0 ? __shfl_sync(kFull, e_chunk, r) : 0;
        const int left = lane == 0 ? left0 : left_up;  // H[i][j0 - 1]
        a_cur = lane == 0 ? a0 : a_up;                 // a[i - 1]
        int diag = left_prev;                          // H[i - 1][j0 - 1]
        left_prev = left;
        const int i = base + 1 + r - lane;
        if (static_cast<unsigned>(i - 1) < static_cast<unsigned>(rows)) {
          int hl = left;                               // H[i][j - 1]
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int up = h[s];
            const int sc = a_cur == sym[s] ? match : mismatch;
            const int e = __viaddmax_s32_relu(diag, sc, up + gap);
            hl = __viaddmax_s32(hl, gap, e);
            top[s] = max(top[s], hl);
            diag = up;
            h[s] = hl;
          }
          if (edge_lane) {
            e_out[i - 1] = hl;
            if (i % 32 == 0 || i == rows) {
              __threadfence_block();
              *reinterpret_cast<volatile long long*>(prog + w) =
                  k * span + i;
            }
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (s < nv) best = max(best, top[s]);
  }
  best = __reduce_max_sync(kFull, best);
  if (warps == 1) {
    if (lane == 0) out[pair] = best;
    return;
  }
  if (lane == 0) red[w] = best;
  __syncthreads();
  if (wid == 0) {
    int v = lane < warps ? red[lane] : 0;
    v = __reduce_max_sync(kFull, v);
    if (lane == 0) out[pair] = v;
  }
}

template <int S>
int launch_sw(const int* rseq, const int* cseq, int* out, int* edge, int B,
              int rows, int cols, int warps, int pairs, int match,
              int mismatch, int gap, cudaStream_t stream) {
  const int grid = (B + pairs - 1) / pairs;
  sw_band_kernel<S><<<grid, 32 * warps * pairs, sw_smem(warps), stream>>>(
      rseq, cseq, out, edge, B, rows, cols, warps, pairs, match, mismatch,
      gap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// f: 0 viaddmax, 1 viaddmin, 2 viaddmax_relu, 3 vimax3, 4 vimax3_relu;
// dtype 0 int32, 1 int16 (pointers 4-byte aligned); n elements.
int dpx_fused_fwd(int f, int dtype, const void* a, const void* b,
                  const void* c, void* out, long long n, void* stream) {
  if (n < 0 || (dtype != kI32 && dtype != kI16)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (f) {
    case kViaddmax: return launch_fused<kViaddmax>(dtype, a, b, c, out, n, s);
    case kViaddmin: return launch_fused<kViaddmin>(dtype, a, b, c, out, n, s);
    case kViaddmaxRelu:
      return launch_fused<kViaddmaxRelu>(dtype, a, b, c, out, n, s);
    case kVimax3: return launch_fused<kVimax3>(dtype, a, b, c, out, n, s);
    case kVimax3Relu:
      return launch_fused<kVimax3Relu>(dtype, a, b, c, out, n, s);
  }
  return cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory one staged tropical block stages.
int tropical_smem_bytes(int bm, int bn, int bk) {
  return tropical_smem(bm, bn, bk);
}

// int32 [M,K] (max,+) [K,N] -> int32 [M,N] on `body` (0 tma, 1 staged).
// tma: 32 divides K, N % 4 == 0, A and B start on 16 bytes; staged:
// (bm, bn, bk) divide the problem and their staging fits.
int tropical_matmul_fwd(const void* a, const void* b, void* c, int M, int N,
                        int K, int bm, int bn, int bk, int body,
                        void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const int*>(a);
  const auto* pb = static_cast<const int*>(b);
  auto* pc = static_cast<int*>(c);
  if (body == kTropTma) {
    const bool aligned = !(reinterpret_cast<uintptr_t>(a) % 16) &&
                         !(reinterpret_cast<uintptr_t>(b) % 16);
    if (K % kTropBk || !fpipe::tma_ready(N, K, kTropTile, aligned))
      return cudaErrorInvalidValue;
    return fpipe::launch<kTropTile, kTropTile, ftile::MaxPlusOp>(
        pa, pb, pc, M, N, K, kTropBk, kTropStages, s);
  }
  if (body != kTropStaged || bm <= 0 || bn <= 0 || bk <= 0 || M % bm ||
      N % bn || K % bk || M / bm > 65535)
    return cudaErrorInvalidValue;
  const int smem = tropical_smem(bm, bn, bk);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const int sm = bm < kSub ? bm : kSub, sn = bn < kSub ? bn : kSub;
  const int edge = sm > sn ? sm : sn;
  dim3 grid(N / bn, M / bm);
  if (edge <= 16)
    return launch_tropical<1>(grid, smem, s, pa, pb, pc, N, K, bm, bn, bk);
  if (edge <= 32)
    return launch_tropical<2>(grid, smem, s, pa, pb, pc, N, K, bm, bn, bk);
  return launch_tropical<4>(grid, smem, s, pa, pb, pc, N, K, bm, bn, bk);
}

// Bytes of dynamic shared memory a Smith-Waterman block of `warps`
// warps uses.
int smith_waterman_smem_bytes(int warps) { return sw_smem(warps); }

// int32 rseq [B,rows], cseq [B,cols] -> int32 best score [B], on the plan
// (S columns a lane; `warps` warps a pair, or `pairs` pairs of one warp
// a block); edge: int32 [B, bands - 1, rows] scratch (unused with one
// band).
int smith_waterman_fwd(const void* rseq, const void* cseq, void* out,
                       void* edge, int B, int rows, int cols, int S,
                       int warps, int pairs, int match, int mismatch,
                       int gap, void* stream) {
  if (B <= 0 || rows <= 0 || cols <= 0 ||
      (S != 1 && S != 2 && S != 4 && S != 8) || warps < 1 ||
      pairs < 1 || (warps > 1 && pairs > 1) || warps * pairs > kSwMaxWarps)
    return cudaErrorInvalidValue;
  // several bands need their hand-off: two warps or more, and the edge
  const int bands = (cols + 32 * S - 1) / (32 * S);
  if (bands > 1 && (warps < 2 || edge == nullptr))
    return cudaErrorInvalidValue;
  const auto* r = static_cast<const int*>(rseq);
  const auto* c = static_cast<const int*>(cseq);
  auto* o = static_cast<int*>(out);
  auto* e = static_cast<int*>(edge);
  auto st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: return launch_sw<1>(r, c, o, e, B, rows, cols, warps, pairs,
                                match, mismatch, gap, st);
    case 2: return launch_sw<2>(r, c, o, e, B, rows, cols, warps, pairs,
                                match, mismatch, gap, st);
    case 4: return launch_sw<4>(r, c, o, e, B, rows, cols, warps, pairs,
                                match, mismatch, gap, st);
    case 8: return launch_sw<8>(r, c, o, e, B, rows, cols, warps, pairs,
                                match, mismatch, gap, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
