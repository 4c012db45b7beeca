// Probe: the rate of the DPX instructions themselves, with the operands
// in registers (no memory traffic), against the same function written
// as plain C.  Not a kernel of any path; chip_smoke.py builds this
// source on its own, times each variant and reads the SASS of each, and
// reports the outcome as a finding.
//
// Each thread runs kChains independent chains, a[j] = f(a[j], b[j],
// a[j+1]), `iters` times (kChains DPX instructions an iteration), and
// writes the xor of its chains so that nothing is dead.  Functions:
//   op 0  viaddmax_s32          max(a + b, c)
//   op 1  viaddmax_s32_relu     max(a + b, c, 0)
//   op 2  viaddmax_s16x2_relu   the same on each halfword of a pair
// `fused` 1 calls the intrinsic, 0 the plain expression (what the
// compiler makes of it is in the SASS).

#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ unsigned relu_addmax16(unsigned a, unsigned b,
                                                  unsigned c) {
  unsigned r = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const short x = static_cast<short>(a >> (16 * h));
    const short y = static_cast<short>(b >> (16 * h));
    const short z = static_cast<short>(c >> (16 * h));
    short s = static_cast<short>(x + y);       // wraps, as the intrinsic
    s = s > z ? s : z;
    s = s > 0 ? s : static_cast<short>(0);
    r |= static_cast<unsigned>(static_cast<unsigned short>(s)) << (16 * h);
  }
  return r;
}

template <int OP, bool kFused>
__device__ __forceinline__ int step(int a, int b, int c) {
  if constexpr (OP == 0) {
    if constexpr (kFused) return __viaddmax_s32(a, b, c);
    else return max(a + b, c);
  } else if constexpr (OP == 1) {
    if constexpr (kFused) return __viaddmax_s32_relu(a, b, c);
    else return max(max(a + b, c), 0);
  } else {
    const unsigned ua = a, ub = b, uc = c;
    if constexpr (kFused) return static_cast<int>(
        __viaddmax_s16x2_relu(ua, ub, uc));
    else return static_cast<int>(relu_addmax16(ua, ub, uc));
  }
}

template <int OP, bool kFused>
__global__ void __launch_bounds__(kThreads)
    dpx_rate_kernel(const int* __restrict__ seed, int* __restrict__ out,
                    int iters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  int a[kChains], b[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    a[j] = seed[j] ^ t;
    b[j] = seed[kChains + j];
  }
#pragma unroll 4
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kChains; ++j)
      a[j] = step<OP, kFused>(a[j], b[j], a[(j + 1) % kChains]);
  }
  int x = 0;
#pragma unroll
  for (int j = 0; j < kChains; ++j) x ^= a[j];
  out[t] = x;
}

template <int OP>
cudaError_t launch(int fused, const int* seed, int* out, int blocks,
                   int iters, cudaStream_t s) {
  if (fused)
    dpx_rate_kernel<OP, true><<<blocks, kThreads, 0, s>>>(seed, out, iters);
  else
    dpx_rate_kernel<OP, false><<<blocks, kThreads, 0, s>>>(seed, out, iters);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Threads a block: the probe's out holds blocks * this many int32.
int dpx_rate_probe_threads() { return kThreads; }

// seed: 2 * 8 int32 on the card; out: blocks * 256 int32.  Each thread
// issues 8 * iters instructions of function `op`.
int dpx_rate_probe(int op, int fused, const void* seed, void* out,
                   int blocks, int iters, void* stream) {
  if (blocks < 1 || iters < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int* ps = static_cast<const int*>(seed);
  int* po = static_cast<int*>(out);
  switch (op) {
    case 0: return launch<0>(fused, ps, po, blocks, iters, s);
    case 1: return launch<1>(fused, ps, po, blocks, iters, s);
    case 2: return launch<2>(fused, ps, po, blocks, iters, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
