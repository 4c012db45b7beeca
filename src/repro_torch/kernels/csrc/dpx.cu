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
//   wrapping in int32 as JAX's do.  One block of 256 threads per
//   (bm, bn) output tile; the TPU kernel carries its accumulator across
//   a sequential K grid axis, here K is a loop inside the block, walked
//   in bk slices staged in shared memory.  A block holds at most a
//   64 x 64 sub-tile of accumulators in registers (16 a thread) and
//   walks a larger tile sub-tile by sub-tile.  Inner step:
//   acc = __viaddmax_s32(a, b, acc).  Bound by operations (one DPX
//   instruction per (i, j, k)); this simple kernel reads two shared
//   words per 1-4 instructions, so shared-memory loads, not the DPX
//   rate, limit it.
//
// smith_waterman_fwd: best local-alignment score per pair.  One block
//   per pair; both sequences staged in shared memory and the
//   substitution score computed on the fly (the TPU kernel reads
//   host-packed [D, 2, width] lanes instead).  The two previous
//   anti-diagonals and the current one rotate through three
//   shared-memory rows, one barrier per diagonal; threads stride over
//   the columns j of a diagonal, so any length works.  Each diagonal
//   writes its valid cells and the one cell past each end (0, as
//   `valid` makes them at dpx_kernel.py:96), which is every cell the
//   next two diagonals read.  Recurrence:
//   H = __viaddmax_s32_relu(diag, s, __viaddmax_s32(up, gap, left + gap))
//     = max(diag + s, up + gap, left + gap, 0).
//   A block max reduction gives the score.  Bound by the per-diagonal
//   barrier at these lengths: a diagonal holds at most min(La, Lb) + 2
//   cells for up to 1024 threads.
//
// Entry points return the CUDA error of the launch (0 = launched).

#include <cuda_runtime.h>

#include <cstdint>

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
// Smith-Waterman wavefront
// ---------------------------------------------------------------------

int sw_smem(int la, int lb) { return 4 * (la + lb + 3 * (lb + 1) + 32); }

int sw_threads(int la, int lb) {
  int cells = (la + 2 < lb + 1) ? la + 2 : lb + 1;   // widest diagonal
  int t = (cells + 31) / 32 * 32;
  return t > 1024 ? 1024 : t;
}

__global__ void sw_kernel(const int* __restrict__ seq_a,
                          const int* __restrict__ seq_b,
                          int* __restrict__ out, int la, int lb, int match,
                          int mismatch, int gap) {
  extern __shared__ int smem[];
  int* sa = smem;                            // [la]
  int* sb = sa + la;                         // [lb]
  int* rows3 = sb + lb;                      // 3 x [lb + 1] diagonals
  int* red = rows3 + 3 * (lb + 1);           // [32] warp maxima
  const size_t pair = blockIdx.x;
  for (int t = threadIdx.x; t < la; t += blockDim.x)
    sa[t] = seq_a[pair * la + t];
  for (int t = threadIdx.x; t < lb; t += blockDim.x)
    sb[t] = seq_b[pair * lb + t];
  for (int t = threadIdx.x; t < 3 * (lb + 1); t += blockDim.x) rows3[t] = 0;
  __syncthreads();
  int* h2 = rows3;                           // diagonal d - 2, by column
  int* h1 = rows3 + (lb + 1);                // diagonal d - 1
  int* cur = rows3 + 2 * (lb + 1);           // diagonal d
  int best = 0;
  for (int d = 1; d <= la + lb; ++d) {
    const int lo = max(0, d - la - 1), hi = min(lb, d);
    for (int j = lo + threadIdx.x; j <= hi; j += blockDim.x) {
      const int i = d - j;
      int h = 0;
      if (j >= 1 && i >= 1 && i <= la) {
        const int s = sa[i - 1] == sb[j - 1] ? match : mismatch;
        h = __viaddmax_s32_relu(h2[j - 1], s,
                                __viaddmax_s32(h1[j], gap, h1[j - 1] + gap));
        best = max(best, h);
      }
      cur[j] = h;
    }
    __syncthreads();                         // diagonal d is complete
    int* t = h2;
    h2 = h1;
    h1 = cur;
    cur = t;
  }
  best = __reduce_max_sync(0xffffffffu, best);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = best;
  __syncthreads();
  if (warp == 0) {
    int v = lane < static_cast<int>(blockDim.x / 32) ? red[lane] : 0;
    v = __reduce_max_sync(0xffffffffu, v);
    if (lane == 0) out[pair] = v;
  }
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

// Bytes of dynamic shared memory one tropical block stages.
int tropical_smem_bytes(int bm, int bn, int bk) {
  return tropical_smem(bm, bn, bk);
}

// int32 [M,K] (max,+) [K,N] -> int32 [M,N]; tiles divide the problem.
int tropical_matmul_fwd(const void* a, const void* b, void* c, int M, int N,
                        int K, int bm, int bn, int bk, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      M % bm || N % bn || K % bk || M / bm > 65535)
    return cudaErrorInvalidValue;
  const int smem = tropical_smem(bm, bn, bk);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const int sm = bm < kSub ? bm : kSub, sn = bn < kSub ? bn : kSub;
  const int edge = sm > sn ? sm : sn;
  dim3 grid(N / bn, M / bm);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const int*>(a);
  const auto* pb = static_cast<const int*>(b);
  auto* pc = static_cast<int*>(c);
  if (edge <= 16)
    return launch_tropical<1>(grid, smem, s, pa, pb, pc, N, K, bm, bn, bk);
  if (edge <= 32)
    return launch_tropical<2>(grid, smem, s, pa, pb, pc, N, K, bm, bn, bk);
  return launch_tropical<4>(grid, smem, s, pa, pb, pc, N, K, bm, bn, bk);
}

// Bytes of dynamic shared memory one Smith-Waterman block uses.
int smith_waterman_smem_bytes(int la, int lb) { return sw_smem(la, lb); }

// int32 seq_a [B,La], seq_b [B,Lb] -> int32 best score [B].
int smith_waterman_fwd(const void* seq_a, const void* seq_b, void* out,
                       int B, int la, int lb, int match, int mismatch,
                       int gap, void* stream) {
  if (B <= 0 || la <= 0 || lb <= 0) return cudaErrorInvalidValue;
  const int smem = sw_smem(la, lb);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  sw_kernel<<<B, sw_threads(la, lb), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seq_a), static_cast<const int*>(seq_b),
      static_cast<int*>(out), la, lb, match, mismatch, gap);
  return cudaGetLastError();
}

}  // extern "C"
