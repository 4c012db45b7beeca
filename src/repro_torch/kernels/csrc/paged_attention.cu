// Paged decode and chunk attention over a block-table KV pool, for
// Hopper (sm_90a).  Plain C interface, loaded from Python with ctypes
// (repro_torch/kernels/paged_attention.py).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/paged_attention.py:
//   paged_decode_fwd  <- paged_decode (:163, body _decode_kernel:132)
//   paged_chunk_fwd   <- paged_chunk  (:252, body _chunk_kernel:215)
// The fp8-pool bodies (_decode_kernel_fp8, _chunk_kernel_fp8) are not
// ported here.
//
// What it computes: exactly the reference's `sdpa_rows` over each query
// row's valid positions.  Scores are sum(q*k) in float32, times
// hd**-0.5 after the sum; positions t >= bound are excluded (the
// reference masks them to -1e30, whose softmax weight underflows to an
// exact 0); m = max, e = exp(s - m), p = e / sum(e); p is ROUNDED TO
// THE POOL DTYPE before the PV product; PV is a float32 sum and the
// output is cast to the query dtype.  Rounding the normalised p before
// PV rules out an online softmax, so the scores of a row are kept whole
// in shared memory (three passes: scores, softmax, PV).
//
// Grid (B, KH, C), C = 1 for decode: one block per (slot, kv head,
// query row) serves the G = H/KH query heads of that kv head, so the G
// rows share every K/V load.  Row c of slot b attends t < base[b] + off
// + c (decode: base = kv_len, off = 0; chunk: base = pos, off = 1),
// capped at the table width MB*bs.  The walk reads only the
// ceil(bound/bs) table entries that bound covers; a -1 entry among them
// is clamped to block 0 as the reference's maximum(bt, 0) does (only
// chunk rows past a slot's valid count reach one, and their output is
// garbage the caller discards), so no pointer goes out of the pool.
//
// Bound: decode reads every valid K/V row once and does ~4*hd flops
// per (query head, position), so it is bound by the bytes of K/V read
// from HBM.  This first design reads each K/V row once per block with
// coalesced warp loads and keeps q, the scores and p in shared memory;
// it does not use wgmma, TMA or split-K, so a block's K/V stream is
// one SM's worth of bandwidth and small batches leave SMs idle.
// Shared memory holds G * MB * bs float scores: the wrapper refuses
// tables past the 227 KB per-block limit (split-K with a log-sum-exp
// combine is the redesign for longer contexts).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowBatch = 8;          // query rows per PV register batch

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// q/out [B, C, H, HD]; pools [NB, bs, KH, HD]; block_table [B, MB];
// base [B].  Dynamic shared memory: q_s [G][HD], p_s [G][MB*bs],
// red [kThreads / HD][kRowBatch][HD] (float).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kpool,
    const T* __restrict__ vpool, const int* __restrict__ block_table,
    const int* __restrict__ base, T* __restrict__ out, int C, int H,
    int KH, int bs, int MB, int off, float scale) {
  constexpr int kParts = kThreads / HD;     // token partitions in PV
  constexpr int kPerLane = (HD + 31) / 32;  // k elements per lane
  const int b = blockIdx.x, kh = blockIdx.y, c = blockIdx.z;
  const int G = H / KH;
  const int t_cap = MB * bs;
  const int n = min(base[b] + off + c, t_cap);  // attend t < n
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* p_s = q_s + G * HD;
  float* red = p_s + (size_t)G * t_cap;

  const size_t row0 = ((size_t)(b * C + c) * H + (size_t)kh * G) * HD;
  const T* qb = q + row0;
  T* ob = out + row0;
  if (n <= 0) {
    for (int i = tid; i < G * HD; i += kThreads) ob[i] = from_f<T>(0.f);
    return;
  }
  for (int i = tid; i < G * HD; i += kThreads) q_s[i] = to_f(qb[i]);
  __syncthreads();

  const int* bt = block_table + (size_t)b * MB;
  const size_t tok_stride = (size_t)KH * HD;    // one pool row, all heads

  // pass 1: scores, one warp per position, lanes across head_dim
  for (int t = warp; t < n; t += kWarps) {
    const int blk = max(bt[t / bs], 0);
    const T* kr = kpool + ((size_t)blk * bs + t % bs) * tok_stride
                  + (size_t)kh * HD;
    float kv[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int e = lane + 32 * j;
      kv[j] = e < HD ? to_f(kr[e]) : 0.f;
    }
    for (int g = 0; g < G; ++g) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int e = lane + 32 * j;
        if (e < HD) acc += q_s[g * HD + e] * kv[j];
      }
      acc = warp_sum(acc);
      if (lane == 0) p_s[(size_t)g * t_cap + t] = acc * scale;
    }
  }
  __syncthreads();

  // pass 2: softmax per row, one warp per row; p rounded to the pool dtype
  for (int g = warp; g < G; g += kWarps) {
    float* s = p_s + (size_t)g * t_cap;
    float m = __int_as_float(0xff800000);   // -inf
    for (int t = lane; t < n; t += 32) m = fmaxf(m, s[t]);
    m = warp_max(m);
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float e = expf(s[t] - m);
      s[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int t = lane; t < n; t += 32) s[t] = to_f(from_f<T>(s[t] / sum));
  }
  __syncthreads();

  // pass 3: PV in float32 registers; thread = (token partition, dim)
  const int d = tid % HD, part = tid / HD;
  for (int g0 = 0; g0 < G; g0 += kRowBatch) {
    const int gn = min(kRowBatch, G - g0);
    float acc[kRowBatch];
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) acc[i] = 0.f;
    for (int t = part; t < n; t += kParts) {
      const int blk = max(bt[t / bs], 0);
      const float v = to_f(vpool[((size_t)blk * bs + t % bs) * tok_stride
                                 + (size_t)kh * HD + d]);
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i)
        if (i < gn) acc[i] += p_s[(size_t)(g0 + i) * t_cap + t] * v;
    }
    if constexpr (kParts > 1) {
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i)
        red[(part * kRowBatch + i) * HD + d] = acc[i];
      __syncthreads();
      if (part == 0) {
        for (int i = 0; i < gn; ++i) {
          float s = 0.f;
          for (int pp = 0; pp < kParts; ++pp)
            s += red[(pp * kRowBatch + i) * HD + d];
          ob[(size_t)(g0 + i) * HD + d] = from_f<T>(s);
        }
      }
      __syncthreads();
    } else {
      for (int i = 0; i < gn; ++i)
        ob[(size_t)(g0 + i) * HD + d] = from_f<T>(acc[i]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bt, const void* base, void* out, int B,
                   int C, int H, int KH, int bs, int MB, int off,
                   float scale, cudaStream_t stream) {
  const int G = H / KH;
  const size_t smem = ((size_t)G * HD + (size_t)G * MB * bs
                       + (size_t)kThreads * kRowBatch) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, KH, C);
  paged_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(bt),
      static_cast<const int*>(base), static_cast<T*>(out), C, H, KH, bs,
      MB, off, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_head_dim(int hd, const void* q, const void* k,
                        const void* v, const void* bt, const void* base,
                        void* out, int B, int C, int H, int KH, int bs,
                        int MB, int off, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, bt, base, out, B, C, H, KH, bs, MB, off, scale, s);
    case 32: return launch<T, 32>(q, k, v, bt, base, out, B, C, H, KH, bs, MB, off, scale, s);
    case 64: return launch<T, 64>(q, k, v, bt, base, out, B, C, H, KH, bs, MB, off, scale, s);
    case 128: return launch<T, 128>(q, k, v, bt, base, out, B, C, H, KH, bs, MB, off, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16 (q, both pools and out share it)
int run(int dtype, int hd, const void* q, const void* k, const void* v,
        const void* bt, const void* base, void* out, int B, int C, int H,
        int KH, int bs, int MB, int off, float scale, void* stream) {
  if (B <= 0 || C <= 0 || KH <= 0 || H % KH != 0 || bs <= 0 || MB <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)by_head_dim<float>(hd, q, k, v, bt, base, out, B, C, H, KH,
                                   bs, MB, off, scale, s);
  if (dtype == 1)
    return (int)by_head_dim<__nv_bfloat16>(hd, q, k, v, bt, base, out, B,
                                           C, H, KH, bs, MB, off, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q/out [B, 1, H, hd]; kv_len [B] int32.  Returns cudaGetLastError().
int paged_decode_fwd(int dtype, int hd, const void* q, const void* k,
                     const void* v, const void* block_table,
                     const void* kv_len, void* out, int B, int H, int KH,
                     int bs, int MB, float scale, void* stream) {
  return run(dtype, hd, q, k, v, block_table, kv_len, out, B, 1, H, KH, bs,
             MB, 0, scale, stream);
}

// q/out [B, C, H, hd]; pos [B] int32 (cache length before the chunk).
int paged_chunk_fwd(int dtype, int hd, const void* q, const void* k,
                    const void* v, const void* block_table, const void* pos,
                    void* out, int B, int C, int H, int KH, int bs, int MB,
                    float scale, void* stream) {
  return run(dtype, hd, q, k, v, block_table, pos, out, B, C, H, KH, bs, MB,
             1, scale, stream);
}

}  // extern "C"
