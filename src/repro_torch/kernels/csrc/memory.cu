// Memory-hierarchy microbenchmarks for Hopper (sm_90a): the paper's
// Tables IV (latency) and V (throughput) measured on the card.
//
// Replaces no TPU kernel.  The reference (benchmarks/memory.py) times
// the host, a numpy pointer chase and a jitted stream, because a TPU
// offers no pointer chase and its own hierarchy (VREG, VMEM, HBM) is
// printed as data-sheet constants.  On the H100 the levels the paper
// measures are the card's own: L1, shared memory, L2 and device memory.
//
// pchase_fwd: one thread walks a chain of dependent 8-byte loads,
//   i = chain[i], the load chosen at compile time: ld.global.ca (through
//   L1), ld.global.cg (L2 and device memory, past L1) or ld.shared (the
//   chain first copied into dynamic shared memory by the whole block).
//   `warm` untimed hops, then `iters` hops between reads of clock64 and
//   %globaltimer.  Writes the last index, the SM cycles and the ns.  The
//   loads are inline `asm volatile`, so the compiler neither hoists nor
//   merges them, and each clock read waits on the chain's value (a store
//   of it to shared memory comes first).  A hop also computes the
//   address (chain + i): one or two dependent integer instructions,
//   as in the paper's own chase.  Bound: latency, not bytes or
//   operations (one load in flight).
// stream_fwd: y = 2x + 1 over float32 (the reference's stream), 16-byte
//   vector loads (ld.global.cg) and stores, four in flight a thread, a
//   grid-stride loop over 8 blocks of 256 threads an SM, `passes` times
//   over the same arrays (an L2-resident pair is read and written from
//   L2).  Bound: bytes (read + write) over the device-memory rate.
// onchip_bw_fwd: one block an SM (its 116 KB of dynamic shared memory
//   lets no second block in) reads 16 KB `reps` times in 16-byte
//   vectors, eight in flight a thread, each warp a 512-byte row that
//   moves on every rep: from shared memory (mode 0) or from a global
//   array held in L1 by ld.global.ca (mode 1).  Each block keeps a
//   32-bit checksum (a wrapping sum of every word it loaded) and its
//   clock64 cycles.  Bound: 32 banks x 4 bytes = 128 bytes a clock an
//   SM for shared memory.
//
// Entry points return the CUDA error of the launch (0 = launched).

#include <cuda_runtime.h>

namespace {

constexpr int kSmemLimit = 232448;
constexpr int kStreamThreads = 256;
constexpr int kStreamBlocksPerSm = 8;
constexpr int kStreamUnroll = 4;
constexpr int kBwThreads = 1024;
constexpr int kBwWords = 4 * kBwThreads;           // 16 KB of uint32
constexpr int kBwUnroll = 8;
constexpr int kBwSmem = 116 * 1024;                // > half an SM's 227 KB

enum Load { kCa = 0, kCg = 1, kShared = 2 };

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ long long clock_after(unsigned sink,
                                                 long long value) {
  // the store needs `value`, so the clock is read after it arrived
  asm volatile("st.volatile.shared.s64 [%0], %1;" ::"r"(sink), "l"(value)
               : "memory");
  return clock64();
}

template <int LOAD>
__device__ __forceinline__ long long hop(const long long* chain,
                                         unsigned sbase, long long i) {
  long long v;
  if constexpr (LOAD == kCa) {
    asm volatile("ld.global.ca.s64 %0, [%1];" : "=l"(v) : "l"(chain + i));
  } else if constexpr (LOAD == kCg) {
    asm volatile("ld.global.cg.s64 %0, [%1];" : "=l"(v) : "l"(chain + i));
  } else {
    asm volatile("ld.shared.s64 %0, [%1];"
                 : "=l"(v)
                 : "r"(sbase + static_cast<unsigned>(i) * 8u));
  }
  return v;
}

template <int LOAD>
__global__ void pchase_kernel(const long long* __restrict__ chain,
                              long long n, long long warm, int iters,
                              long long* __restrict__ out) {
  extern __shared__ __align__(16) long long s_chain[];
  __shared__ long long s_sink;
  if constexpr (LOAD == kShared) {
    for (long long j = threadIdx.x; j < n; j += blockDim.x)
      s_chain[j] = chain[j];
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const unsigned sbase =
      static_cast<unsigned>(__cvta_generic_to_shared(s_chain));
  const unsigned sink = static_cast<unsigned>(__cvta_generic_to_shared(&s_sink));
  long long i = 0;
  for (long long h = 0; h < warm; ++h) i = hop<LOAD>(chain, sbase, i);
  const long long c0 = clock_after(sink, i);
  const unsigned long long t0 = global_ns();
  for (int h = 0; h < iters; ++h) i = hop<LOAD>(chain, sbase, i);
  const long long c1 = clock_after(sink, i);
  const unsigned long long t1 = global_ns();
  out[0] = i;
  out[1] = c1 - c0;
  out[2] = static_cast<long long>(t1 - t0);
}

__global__ void __launch_bounds__(kStreamThreads)
    stream_kernel(const float* __restrict__ x, float* __restrict__ y,
                  long long n, int passes) {
  const long long n4 = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  for (int p = 0; p < passes; ++p) {
    for (long long base = first; base < n4; base += kStreamUnroll * stride) {
      float4 v[kStreamUnroll];
#pragma unroll
      for (int u = 0; u < kStreamUnroll; ++u) {
        const long long i = base + u * stride;
        if (i < n4)
          asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
                       : "=f"(v[u].x), "=f"(v[u].y), "=f"(v[u].z),
                         "=f"(v[u].w)
                       : "l"(x + 4 * i));
      }
#pragma unroll
      for (int u = 0; u < kStreamUnroll; ++u) {
        const long long i = base + u * stride;
        if (i < n4)
          asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(
                           y + 4 * i),
                       "f"(fmaf(v[u].x, 2.f, 1.f)),
                       "f"(fmaf(v[u].y, 2.f, 1.f)),
                       "f"(fmaf(v[u].z, 2.f, 1.f)),
                       "f"(fmaf(v[u].w, 2.f, 1.f))
                       : "memory");
      }
    }
    for (long long i = 4 * n4 + first; i < n; i += stride)
      y[i] = fmaf(x[i], 2.f, 1.f);
  }
}

template <int MODE>
__device__ __forceinline__ uint4 bw_load(const unsigned* g, unsigned s) {
  uint4 v;
  if constexpr (MODE == 0) {
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(s));
  } else {
    asm volatile("ld.global.ca.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(g));
  }
  return v;
}

// src2 holds the 16 KB array twice (32 rows of 512 bytes, then the same
// 32 rows again).  Warp w reads row (w + r) mod 32 at rep r, one
// 16-byte vector a lane, so a block reads every row once a rep, each
// warp access 512 contiguous bytes (no bank conflict).  A load's
// address differs from rep to rep, so ptxas merges none of them (the
// same address every rep it would, volatile asm or not); the second
// copy lets the eight loads of an unrolled step run past row 31 with
// immediate offsets.
template <int MODE>
__global__ void __launch_bounds__(kBwThreads)
    onchip_bw_kernel(const unsigned* __restrict__ src2, int reps,
                     unsigned* __restrict__ sums,
                     long long* __restrict__ cycles) {
  extern __shared__ __align__(16) unsigned s_buf[];
  __shared__ unsigned s_sum;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane_bytes = (t & 31) * 16;
  // shared: copy both halves in; global: a first .ca pass puts them in L1
  const uint4 lo = bw_load<1>(src2 + 4 * t, 0);
  const uint4 hi = bw_load<1>(src2 + 4 * (t + kBwThreads), 0);
  if constexpr (MODE == 0) {
    reinterpret_cast<uint4*>(s_buf)[t] = lo;
    reinterpret_cast<uint4*>(s_buf)[t + kBwThreads] = hi;
  }
  if (t == 0) s_sum = 0;
  __syncthreads();
  const unsigned s_base =
      static_cast<unsigned>(__cvta_generic_to_shared(s_buf)) + lane_bytes;
  const char* g_base = reinterpret_cast<const char*>(src2) + lane_bytes;
  const long long c0 = clock64();
  unsigned acc = 0;
  for (int r = 0; r < reps; r += kBwUnroll) {
    const int row_bytes = ((warp + r) & 31) * 512;
    uint4 v[kBwUnroll];
#pragma unroll
    for (int u = 0; u < kBwUnroll; ++u)
      v[u] = bw_load<MODE>(
          reinterpret_cast<const unsigned*>(g_base + row_bytes + u * 512),
          s_base + row_bytes + u * 512);
#pragma unroll
    for (int u = 0; u < kBwUnroll; ++u) acc += v[u].x + v[u].y + v[u].z + v[u].w;
  }
  __syncthreads();
  const long long c1 = clock64();
  atomicAdd(&s_sum, acc);
  __syncthreads();
  if (t == 0) {
    sums[blockIdx.x] = s_sum;
    cycles[blockIdx.x] = c1 - c0;
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int LOAD>
cudaError_t launch_pchase(const long long* chain, long long n,
                          long long warm, int iters, long long* out,
                          cudaStream_t stream) {
  const int smem = LOAD == kShared ? static_cast<int>(n * 8) : 0;
  cudaError_t err = allow_smem(pchase_kernel<LOAD>, smem);
  if (err != cudaSuccess) return err;
  pchase_kernel<LOAD><<<1, LOAD == kShared ? 1024 : 32, smem, stream>>>(
      chain, n, warm, iters, out);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_bw(const unsigned* src, int reps, int blocks,
                      unsigned* sums, long long* cycles,
                      cudaStream_t stream) {
  cudaError_t err = allow_smem(onchip_bw_kernel<MODE>, kBwSmem);
  if (err != cudaSuccess) return err;
  onchip_bw_kernel<MODE><<<blocks, kBwThreads, kBwSmem, stream>>>(
      src, reps, sums, cycles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// chain [n] int64, a permutation's cycle of indices, walked from entry
// 0; load 0 (.ca), 1 (.cg) or 2 (shared: n * 8 bytes must fit a
// block's shared memory); out [3] int64: last index, cycles, ns of the
// `iters` timed hops.
int pchase_fwd(int load, const void* chain, long long n, long long warm,
               int iters, void* out, void* stream) {
  if (n <= 0 || warm < 0 || iters < 0) return cudaErrorInvalidValue;
  auto c = static_cast<const long long*>(chain);
  auto o = static_cast<long long*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (load) {
    case kCa: return launch_pchase<kCa>(c, n, warm, iters, o, s);
    case kCg: return launch_pchase<kCg>(c, n, warm, iters, o, s);
    case kShared:
      if (n * 8 > kSmemLimit - 16) return cudaErrorInvalidValue;
      return launch_pchase<kShared>(c, n, warm, iters, o, s);
    default: return cudaErrorInvalidValue;
  }
}

// x, y [n] float32 on 16-byte boundaries; y = 2x + 1, `passes` times.
int stream_fwd(const void* x, void* y, long long n, int passes,
               void* stream) {
  if (n <= 0 || passes <= 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long n4 = n / 4;
  long long blocks = (n4 + kStreamThreads - 1) / kStreamThreads;
  if (blocks > static_cast<long long>(sms) * kStreamBlocksPerSm)
    blocks = static_cast<long long>(sms) * kStreamBlocksPerSm;
  if (blocks < 1) blocks = 1;
  stream_kernel<<<static_cast<unsigned>(blocks), kStreamThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n, passes);
  return cudaGetLastError();
}

// src2 [2 * kBwWords] 32-bit words, the array twice; mode 0
// shared, 1 global (.ca);
// reps a positive multiple of 8; sums [blocks] uint32, cycles [blocks]
// int64.
int onchip_bw_fwd(int mode, const void* src, int reps, int blocks,
                  void* sums, void* cycles, void* stream) {
  if (reps <= 0 || reps % kBwUnroll || blocks <= 0)
    return cudaErrorInvalidValue;
  auto g = static_cast<const unsigned*>(src);
  auto su = static_cast<unsigned*>(sums);
  auto cy = static_cast<long long*>(cycles);
  auto s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return launch_bw<0>(g, reps, blocks, su, cy, s);
  if (mode == 1) return launch_bw<1>(g, reps, blocks, su, cy, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
