// Flash-attention forward (blockwise online softmax, GQA) for Hopper
// (sm_90a).  Plain C interface, loaded from Python with ctypes
// (repro_torch/kernels/flash_attention.py).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention_fwd <- flash_attention (:62, pallas_call at :85),
//                          body _flash_kernel:25
// and covers every argument of models/attention.flash_attention
// (_attn_fwd:222 with its causal pair scan _attn_fwd_pairs:160), so the
// training forward on the card never needs the plain path: q [B,Sq,H,hd],
// k/v [B,Sk,KH,hd] with H % KH == 0 (query head h reads kv head
// h / (H/KH)), causal, a sliding window, q_offset (q row i sits at
// position q_offset + i), Sq != Sk and ragged tails.  It also writes
// the log-sum-exp rows [B,H,Sq] the blockwise backward reads.
//
// Numerics, as the reference's: scores are fp32 dot products times
// hd**-0.5; a masked score is -1e30 (not -inf); the online-softmax state
// (m, l, acc) is fp32; p = exp(s - m_new) is ROUNDED TO v's dtype before
// the PV product, whose sum is fp32; l is clamped with max(l, 1e-30);
// lse = m + log(max(l, 1e-30)); the output is acc / max(l, 1e-30) cast
// to q's dtype.  Tiles differ from the reference's chunks (64 or 32 keys
// against 512), so sums are grouped and rescaled in another order: the
// two agree to fp32 rounding, and for bf16 to a rounding step of p or o.
//
// Skipped key tiles.  A block walks only the key tiles that some row of
// its query tile may attend (causal: keys <= the last row's position;
// window: keys > the first row's position - window).  For a row with a
// valid key that is exact: a tile wholly masked for it either comes
// after its first valid key (p = exp(-1e30 - m) = 0 and corr = 1) or
// before it (the garbage it would add is multiplied by
// corr = exp(-1e30 - m) = 0 at the first valid key).  A row with no
// valid key at all (only a window or q_offset past the keys can make
// one) keeps m = -1e30 throughout, and the reference then averages v
// over all nk*kc of its padded key chunk positions with p = 1: such a
// row is written here as sum_{t<Sk} v[t] / n_pad_keys, with n_pad_keys
// = nk*kc passed by the wrapper, and lse = -1e30 + log(n_pad_keys).
//
// Design.  bf16: one block of 4 warps per (64-row query tile, b*H + h);
// each warp owns 16 query rows, keeps its Q fragments in registers, and
// walks 64-key K/V tiles staged in shared memory through warp-level
// mma.sync m16n8k16 (bf16 x bf16 -> fp32): S = Q K^T, the online
// softmax on the S fragments in registers, then P (rounded to bf16,
// re-packed as the A fragments of the next product) times V, whose B
// fragments come from ldmatrix.trans.  float32: one block of 128
// threads per (32-row query tile, b*H + h), scores and PV by fmaf on
// the CUDA cores (tensor-core TF32 would round q and k to 10 bits).
// Grid (query tiles, b*H + h), the heads split over grid.y (65535 at
// most) and grid.z past that, so B*H is not held to grid.y's limit; one
// head's query tiles run together, issued last-first so the long
// causal rows start early.  The G = H/KH heads of a group read the same
// K/V tiles through L2, not through one shared copy.
//
// Bound: at the training shapes (S = 4096, hd = 128) the causal forward
// does 4*hd operations per attended (query head, key) pair, ~2.7e11 at
// B=2, H=32, against ~0.1 GB of q, k, v, o: it is bound by operations
// (0.28 ms at the bf16 tensor-core peak).  This first design stages K/V
// synchronously (no cp.async/TMA double buffering), uses mma.sync, not
// wgmma, and exponentiates with expf, so it runs well below that bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;       // the reference's NEG_INF
constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;
// bf16 (mma.sync) kernel: 64 query rows x 64 keys a tile
constexpr int kBQ = 64, kBK = 64;
// float32 (fmaf) kernel: 32 query rows x 32 keys a tile
constexpr int kFQ = 32, kFK = 32;

struct Args {
  const void* q; const void* k; const void* v;
  void* o; float* lse;
  int B, Sq, Sk, H, KH, causal, window, q_offset, n_pad_keys;
  float scale;
};

__device__ __forceinline__ bool valid_key(const Args& a, int qpos, int t) {
  return t < a.Sk && (!a.causal || t <= qpos) &&
         (!a.window || t > qpos - a.window);
}

// Keys [lo, hi) that some row of query rows [r0, r0 + rows) may attend.
__device__ __forceinline__ void key_range(const Args& a, int r0, int rows,
                                          int& lo, int& hi) {
  const int p_lo = a.q_offset + r0, p_hi = a.q_offset + r0 + rows - 1;
  hi = a.causal ? min(a.Sk, p_hi + 1) : a.Sk;
  lo = a.window ? max(0, p_lo - a.window + 1) : 0;
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);   // round to nearest
  return *reinterpret_cast<uint32_t*>(&p);
}

// Four 8x8 b16 matrices, transposed: lane i receives, of matrix j,
// the elements (row 2*(i%4), col i/4) and (row 2*(i%4)+1, col i/4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// sum_{t < Sk} v[t, d] in fp32 for d < HD, into vsum (shared): the PV
// sum of a row with no valid key, where every p is 1.
template <typename T, int HD>
__device__ void sum_v(const T* vbase, size_t ld, int Sk, float* vsum) {
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float acc = 0.f;
    for (int t = 0; t < Sk; ++t) {
      if constexpr (sizeof(T) == 2)
        acc += __bfloat162float(vbase[(size_t)t * ld + d]);
      else
        acc += vbase[(size_t)t * ld + d];
    }
    vsum[d] = acc;
  }
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------

// rows x HD bf16 of a global matrix with row stride ld into shared
// memory with row stride LD, zero past `valid` rows; 16-byte moves.
template <int HD, int LD>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* s,
                                           const __nv_bfloat16* g, size_t ld,
                                           int rows, int valid) {
  constexpr int kVec = HD / 8;
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) x = *reinterpret_cast<const uint4*>(g + r * ld + c);
    *reinterpret_cast<uint4*>(s + r * LD + c) = x;
  }
}

// At most 168 registers, so three blocks share an SM (at 172, two do,
// and on an H100 the yi-6b training shape takes 1.37x as long).
template <int HD>
__global__ void __launch_bounds__(kThreads, 3)
flash_fwd_bf16(const Args a) {
  constexpr int LD = HD + 8;            // shared row stride, 16 B of pad
  constexpr int KS = HD / 16;           // k-steps of Q K^T
  constexpr int NF = HD / 8;            // n-fragments of O
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);   // [kBQ][LD]
  bf16* sk = sq + kBQ * LD;                   // [kBK][LD]
  bf16* sv = sk + kBK * LD;                   // [kBK][LD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  if (bh >= a.B * a.H) return;          // the last z slice's tail
  const int b = bh / a.H, h = bh % a.H;
  const int kh = h / (a.H / a.KH);
  const int rows = min(kBQ, a.Sq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t ldq = (size_t)a.H * HD, ldk = (size_t)a.KH * HD;
  const bf16* qb = static_cast<const bf16*>(a.q) +
                   ((size_t)b * a.Sq * a.H + h) * HD;
  const bf16* kb = static_cast<const bf16*>(a.k) +
                   ((size_t)b * a.Sk * a.KH + kh) * HD;
  const bf16* vb = static_cast<const bf16*>(a.v) +
                   ((size_t)b * a.Sk * a.KH + kh) * HD;
  bf16* ob = static_cast<bf16*>(a.o) + ((size_t)b * a.Sq * a.H + h) * HD;

  stage_bf16<HD, LD>(sq, qb + (size_t)q0 * ldq, ldq, kBQ, rows);
  __syncthreads();
  const int wr = warp * 16;             // the warp's first row in the tile
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bf16* p = sq + (wr + g) * LD + ks * 16 + 2 * t4;
    qf[ks][0] = tile::ld32(p);
    qf[ks][1] = tile::ld32(p + 8 * LD);
    qf[ks][2] = tile::ld32(p + 8);
    qf[ks][3] = tile::ld32(p + 8 * LD + 8);
  }
  // this thread's two rows: g and g + 8 of the warp's 16
  const int qpos[2] = {a.q_offset + q0 + wr + g, a.q_offset + q0 + wr + g + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NF][4];
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  int lo, hi;
  key_range(a, q0, rows, lo, hi);
  for (int k0 = lo / kBK * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();                    // the last tile is consumed
    const int kvalid = min(kBK, a.Sk - k0);
    stage_bf16<HD, LD>(sk, kb + (size_t)k0 * ldk, ldk, kBK, kvalid);
    stage_bf16<HD, LD>(sv, vb + (size_t)k0 * ldk, ldk, kBK, kvalid);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys a warp, 8 fragments of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const bf16* p = sk + (j * 8 + g) * LD + ks * 16 + 2 * t4;
        tile::Mma<bf16>::run(s[j], qf[ks], tile::ld32(p), tile::ld32(p + 8));
      }
    }
    // scale, mask, online softmax; element e of fragment j sits at row
    // g + 8 * (e / 2), key k0 + 8 j + 2 t4 + e % 2
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = k0 + j * 8 + 2 * t4 + (e & 1);
        const float x = s[j][e] * a.scale;
        s[j][e] = valid_key(a, qpos[e >> 1], t) ? x : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        psum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      o[n][0] *= corr[0]; o[n][1] *= corr[0];
      o[n][2] *= corr[1]; o[n][3] *= corr[1];
    }
    // O += P V: P rounded to bf16 as the A fragments, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NF; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sv + (kk * 16 + (lane & 15)) * LD + n * 8 +
                                  (lane >> 4) * 8);
        tile::Mma<bf16>::run(o[n], pa, vf[0], vf[1]);
        tile::Mma<bf16>::run(o[n + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  const bool empty[2] = {row[0] < a.Sq && m[0] == kNegInf,
                         row[1] < a.Sq && m[1] == kNegInf};
  float* vsum = reinterpret_cast<float*>(sq);   // Q now lives in registers
  if (__syncthreads_or(empty[0] || empty[1])) {
    sum_v<bf16, HD>(vb, ldk, a.Sk, vsum);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.Sq) continue;
    const float L = empty[r] ? (float)a.n_pad_keys : fmaxf(l[r], 1e-30f);
    bf16* orow = ob + (size_t)row[r] * ldq;
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      const int c = n * 8 + 2 * t4;
      const float x0 = empty[r] ? vsum[c] : o[n][2 * r];
      const float x1 = empty[r] ? vsum[c + 1] : o[n][2 * r + 1];
      *reinterpret_cast<__nv_bfloat162*>(orow + c) =
          __floats2bfloat162_rn(x0 / L, x1 / L);
    }
    if (t4 == 0) a.lse[(size_t)bh * a.Sq + row[r]] = m[r] + logf(L);
  }
}

// ---------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const Args a) {
  constexpr int LDK = HD + 1;           // K rows padded against conflicts
  constexpr int LDS = kFK + 1;
  constexpr int kStride = kThreads / HD;   // rows apart of a thread's outputs
  constexpr int kPer = kFQ / kStride;      // outputs of a thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);   // [kFQ][HD]
  float* sk = sq + kFQ * HD;                    // [kFK][LDK]
  float* sv = sk + kFK * LDK;                   // [kFK][HD]
  float* ss = sv + kFK * HD;                    // [kFQ][LDS] scores, then p
  float* s_m = ss + kFQ * LDS;                  // [kFQ]
  float* s_l = s_m + kFQ;                       // [kFQ]
  float* s_c = s_l + kFQ;                       // [kFQ] corr
  float* vsum = s_c + kFQ;                      // [HD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFQ;
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  if (bh >= a.B * a.H) return;          // the last z slice's tail
  const int b = bh / a.H, h = bh % a.H;
  const int kh = h / (a.H / a.KH);
  const int rows = min(kFQ, a.Sq - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t ldq = (size_t)a.H * HD, ldk = (size_t)a.KH * HD;
  const float* qb = static_cast<const float*>(a.q) +
                    ((size_t)b * a.Sq * a.H + h) * HD;
  const float* kb = static_cast<const float*>(a.k) +
                    ((size_t)b * a.Sk * a.KH + kh) * HD;
  const float* vb = static_cast<const float*>(a.v) +
                    ((size_t)b * a.Sk * a.KH + kh) * HD;
  float* ob = static_cast<float*>(a.o) + ((size_t)b * a.Sq * a.H + h) * HD;

  for (int i = tid; i < kFQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    sq[i] = r < rows ? qb[(size_t)(q0 + r) * ldq + d] : 0.f;
  }
  if (tid < kFQ) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }
  const int d = tid % HD, r0 = tid / HD;   // outputs (r0 + j*kStride, d)
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.f;

  int lo, hi;
  key_range(a, q0, rows, lo, hi);
  for (int k0 = lo / kFK * kFK; k0 < hi; k0 += kFK) {
    __syncthreads();
    for (int i = tid; i < kFK * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      const bool ok = k0 + r < a.Sk;
      sk[r * LDK + c] = ok ? kb[(size_t)(k0 + r) * ldk + c] : 0.f;
      sv[i] = ok ? vb[(size_t)(k0 + r) * ldk + c] : 0.f;
    }
    __syncthreads();
    // scores: lane = key, warp w takes rows w, w + 4, ...
    for (int r = warp; r < kFQ; r += kThreads / 32) {
      float x = 0.f;
#pragma unroll 8
      for (int c = 0; c < HD; ++c) x = fmaf(sq[r * HD + c], sk[lane * LDK + c], x);
      x *= a.scale;
      ss[r * LDS + lane] =
          valid_key(a, a.q_offset + q0 + r, k0 + lane) ? x : kNegInf;
    }
    __syncthreads();
    // online softmax, one warp a row, lane = key (fp32 p: no rounding)
    for (int r = warp; r < kFQ; r += kThreads / 32) {
      const float x = ss[r * LDS + lane];
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float p = expf(x - m_new);
      const float ps = warp_sum(p);
      ss[r * LDS + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s_c[r] = corr;
        s_l[r] = s_l[r] * corr + ps;
        s_m[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int r = r0 + j * kStride;
      float pv = 0.f;
#pragma unroll 8
      for (int c = 0; c < kFK; ++c) pv = fmaf(ss[r * LDS + c], sv[c * HD + d], pv);
      acc[j] = acc[j] * s_c[r] + pv;
    }
  }
  __syncthreads();
  if (__syncthreads_or(tid < rows && s_m[tid] == kNegInf)) {
    sum_v<float, HD>(vb, ldk, a.Sk, vsum);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = r0 + j * kStride;
    if (r >= rows) continue;
    const bool empty = s_m[r] == kNegInf;
    const float L = empty ? (float)a.n_pad_keys : fmaxf(s_l[r], 1e-30f);
    ob[(size_t)(q0 + r) * ldq + d] = (empty ? vsum[d] : acc[j]) / L;
  }
  if (tid < rows) {
    const bool empty = s_m[tid] == kNegInf;
    const float L = empty ? (float)a.n_pad_keys : fmaxf(s_l[tid], 1e-30f);
    a.lse[(size_t)bh * a.Sq + q0 + tid] = s_m[tid] + logf(L);
  }
}

// ---------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------

template <int HD>
int bf16_smem_bytes() { return (kBQ + 2 * kBK) * (HD + 8) * 2; }

template <int HD>
int f32_smem_bytes() {
  return 4 * (kFQ * HD + kFK * (HD + 1) + kFK * HD + kFQ * (kFK + 1) +
              3 * kFQ + HD);
}

// (query tiles, b*H + h) with b*H + h = blockIdx.z * gridDim.y +
// blockIdx.y: up to 65535 heads on grid.y, z slices past that.
dim3 grid_of(const Args& a, int rows) {
  const int bh = a.B * a.H;
  const int y = bh < kMaxGridY ? bh : kMaxGridY;
  return dim3((a.Sq + rows - 1) / rows, y, (bh + y - 1) / y);
}

template <int HD>
cudaError_t launch(int dtype, const Args& a, cudaStream_t s) {
  cudaError_t err;
  if (dtype == 1) {
    const int smem = bf16_smem_bytes<HD>();
    err = tile::allow_smem(flash_fwd_bf16<HD>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid = grid_of(a, kBQ);
    flash_fwd_bf16<HD><<<grid, kThreads, smem, s>>>(a);
  } else {
    const int smem = f32_smem_bytes<HD>();
    err = tile::allow_smem(flash_fwd_f32<HD>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid = grid_of(a, kFQ);
    flash_fwd_f32<HD><<<grid, kThreads, smem, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of q, k, v and o: 0 = float32, 1 = bfloat16.  q/o [B,Sq,H,hd],
// k/v [B,Sk,KH,hd], lse [B,H,Sq] float32, all contiguous.  n_pad_keys:
// nk*kc of the reference's key chunking (the denominator of a row with
// no valid key).  Returns cudaGetLastError() of the launch.
int flash_attention_fwd(int dtype, int hd, const void* q, const void* k,
                        const void* v, void* o, void* lse, int B, int Sq,
                        int Sk, int H, int KH, int causal, int window,
                        int q_offset, int n_pad_keys, float scale,
                        void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || H % KH != 0 ||
      (dtype != 0 && dtype != 1) || window < 0 || q_offset < 0 ||
      n_pad_keys < Sk || (long long)B * H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, static_cast<float*>(lse), B, Sq, Sk, H, KH,
               causal, window, q_offset, n_pad_keys, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)launch<16>(dtype, a, s);
    case 32: return (int)launch<32>(dtype, a, s);
    case 64: return (int)launch<64>(dtype, a, s);
    case 128: return (int)launch<128>(dtype, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
