// Paged decode and chunk attention over a block-table KV pool, for
// Hopper (sm_90a).  Plain C interface, loaded from Python with ctypes
// (repro_torch/kernels/paged_attention.py).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/paged_attention.py,
// each with its bf16/float32-pool body and its e4m3-pool body:
//   paged_decode_fwd      <- paged_decode (:163), body _decode_kernel:132
//   paged_decode_fp8_fwd  <- paged_decode, body _decode_kernel_fp8:147
//                            (+ _fetch_blocks_fp8:105)
//   paged_chunk_fwd       <- paged_chunk  (:252), body _chunk_kernel:215
//   paged_chunk_fp8_fwd   <- paged_chunk, body _chunk_kernel_fp8:234
//
// What it computes: exactly the reference's `sdpa_rows` over each query
// row's valid positions.  Scores are sum(q*k) in float32, times
// hd**-0.5 after the sum; positions t >= bound are excluded (the
// reference masks them to -1e30, whose softmax weight underflows to an
// exact 0); m = max, e = exp(s - m), p = e / sum(e); p is ROUNDED TO
// THE COMPUTE TYPE T before the PV product; PV is a float32 sum and the
// output is cast to T.  T is q's dtype: on bf16/float32 pools the pool
// has T too (the reference rounds p to the pool dtype), on e4m3 pools
// the reference's scratch, and so p, has q's dtype.  Rounding the
// normalised p before PV rules out an online softmax, so the scores of
// a row are kept whole in shared memory (three passes: scores,
// softmax, PV).
//
// e4m3 pools: each K/V element is float(code) * scale rounded to T,
// with one float32 scale per (token, kv head) row, scale pool
// [NB, bs, KH, 1] -- the reference's in-tile dequant
// (codes.astype(f32) * scale).astype(q.dtype), bit for bit.
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
// from HBM (1 byte per element plus 4 bytes of scale per row on e4m3
// pools).  This first design reads each K/V row once per block with
// coalesced warp loads and keeps q, the scores and p in shared memory;
// it does not use wgmma, TMA or split-K, so a block's K/V stream is
// one SM's worth of bandwidth and small batches leave SMs idle.
// Shared memory holds G * MB * bs float scores: the wrapper refuses
// tables past the 227 KB per-block limit (split-K with a log-sum-exp
// combine is the redesign for longer contexts).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>

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

// One K/V element of pool row `row` (= (block*bs + t%bs)*KH + kh) as
// the kernel computes with it: a T element, or an e4m3 code times the
// row's scale rounded to T.  `sc` is the row's scale (unused on T pools).
template <typename T, int HD, bool FP8>
__device__ __forceinline__ float load_kv(const void* pool, size_t row,
                                         int e, float sc) {
  if constexpr (FP8) {
    const __nv_fp8_e4m3 c =
        static_cast<const __nv_fp8_e4m3*>(pool)[row * HD + e];
    return to_f(from_f<T>(static_cast<float>(c) * sc));
  } else {
    return to_f(static_cast<const T*>(pool)[row * HD + e]);
  }
}

template <bool FP8>
__device__ __forceinline__ float row_scale(const float* scale, size_t row) {
  if constexpr (FP8) return scale[row];
  return 1.f;
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

// q/out [B, C, H, HD] of type T; pools [NB, bs, KH, HD] of type T, or
// e4m3 codes with scales [NB, bs, KH, 1] float (FP8); block_table
// [B, MB]; base [B].  Dynamic shared memory: q_s [G][HD], p_s
// [G][MB*bs], red [kThreads / HD][kRowBatch][HD] (float).
template <typename T, int HD, bool FP8>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const void* __restrict__ kpool,
    const void* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ block_table,
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
  // pool row of position t: one (token, kv head) row of HD elements
  auto pool_row = [&](int t) -> size_t {
    const int blk = max(bt[t / bs], 0);
    return ((size_t)blk * bs + t % bs) * KH + kh;
  };

  // pass 1: scores, one warp per position, lanes across head_dim
  for (int t = warp; t < n; t += kWarps) {
    const size_t r = pool_row(t);
    const float ks = row_scale<FP8>(kscale, r);
    float kv[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int e = lane + 32 * j;
      kv[j] = e < HD ? load_kv<T, HD, FP8>(kpool, r, e, ks) : 0.f;
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

  // pass 2: softmax per row, one warp per row; p rounded to T
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
      const size_t r = pool_row(t);
      const float v = load_kv<T, HD, FP8>(vpool, r, d,
                                          row_scale<FP8>(vscale, r));
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

// The operands of one launch; pools are T or e4m3, scales null for T.
struct Args {
  const void* q; const void* k; const void* v;
  const float* ks; const float* vs;
  const int* bt; const int* base; void* out;
  int B, C, H, KH, bs, MB, off;
  float scale;
};

template <typename T, int HD, bool FP8>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.KH;
  const size_t smem = ((size_t)G * HD + (size_t)G * a.MB * a.bs
                       + (size_t)kThreads * kRowBatch) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T, HD, FP8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B, a.KH, a.C);
  paged_attention_kernel<T, HD, FP8><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), a.k, a.v, a.ks, a.vs, a.bt, a.base,
      static_cast<T*>(a.out), a.C, a.H, a.KH, a.bs, a.MB, a.off, a.scale);
  return cudaGetLastError();
}

template <typename T, bool FP8>
cudaError_t by_head_dim(int hd, const Args& a, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16, FP8>(a, s);
    case 32: return launch<T, 32, FP8>(a, s);
    case 64: return launch<T, 64, FP8>(a, s);
    case 128: return launch<T, 128, FP8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// dtype of q and out: 0 = float32, 1 = bfloat16; the pools share it
// unless fp8, where they hold e4m3 codes with float32 scales.
int run(int dtype, int hd, bool fp8, const Args& a, void* stream) {
  if (a.B <= 0 || a.C <= 0 || a.KH <= 0 || a.H % a.KH != 0 || a.bs <= 0
      || a.MB <= 0 || (fp8 && (a.ks == nullptr || a.vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(fp8 ? by_head_dim<float, true>(hd, a, s)
                     : by_head_dim<float, false>(hd, a, s));
  if (dtype == 1)
    return (int)(fp8 ? by_head_dim<__nv_bfloat16, true>(hd, a, s)
                     : by_head_dim<__nv_bfloat16, false>(hd, a, s));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q/out [B, 1, H, hd]; kv_len [B] int32.  Returns cudaGetLastError().
int paged_decode_fwd(int dtype, int hd, const void* q, const void* k,
                     const void* v, const void* block_table,
                     const void* kv_len, void* out, int B, int H, int KH,
                     int bs, int MB, float scale, void* stream) {
  const Args a{q, k, v, nullptr, nullptr,
               static_cast<const int*>(block_table),
               static_cast<const int*>(kv_len), out, B, 1, H, KH, bs, MB,
               0, scale};
  return run(dtype, hd, false, a, stream);
}

// q/out [B, C, H, hd]; pos [B] int32 (cache length before the chunk).
int paged_chunk_fwd(int dtype, int hd, const void* q, const void* k,
                    const void* v, const void* block_table, const void* pos,
                    void* out, int B, int C, int H, int KH, int bs, int MB,
                    float scale, void* stream) {
  const Args a{q, k, v, nullptr, nullptr,
               static_cast<const int*>(block_table),
               static_cast<const int*>(pos), out, B, C, H, KH, bs, MB, 1,
               scale};
  return run(dtype, hd, false, a, stream);
}

// e4m3 pools k/v [NB, bs, KH, hd] with float32 scales k_scale/v_scale
// [NB, bs, KH, 1]; otherwise as paged_decode_fwd.
int paged_decode_fp8_fwd(int dtype, int hd, const void* q, const void* k,
                         const void* v, const void* k_scale,
                         const void* v_scale, const void* block_table,
                         const void* kv_len, void* out, int B, int H,
                         int KH, int bs, int MB, float scale,
                         void* stream) {
  const Args a{q, k, v, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(block_table),
               static_cast<const int*>(kv_len), out, B, 1, H, KH, bs, MB,
               0, scale};
  return run(dtype, hd, true, a, stream);
}

// e4m3 pools with scales; otherwise as paged_chunk_fwd.
int paged_chunk_fp8_fwd(int dtype, int hd, const void* q, const void* k,
                        const void* v, const void* k_scale,
                        const void* v_scale, const void* block_table,
                        const void* pos, void* out, int B, int C, int H,
                        int KH, int bs, int MB, float scale, void* stream) {
  const Args a{q, k, v, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(block_table),
               static_cast<const int*>(pos), out, B, C, H, KH, bs, MB, 1,
               scale};
  return run(dtype, hd, true, a, stream);
}

}  // extern "C"
