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
// to q's dtype.  Tiles differ from the reference's chunks (128, 64 or 32
// keys against 512), so sums are grouped and rescaled in another order:
// the two agree to fp32 rounding, and for bf16 to a rounding step of p
// or o.
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
// Design.  Three bodies, chosen by a rule on (dtype, hd)
// (flash_attention_body; kernels/flash_attention.py mirrors it as
// `body`), never as a fallback:
//   * wgmma (bf16, hd 64 and 128: whole 128-byte TMA box rows of hd):
//     one block per (128-row query tile, b*H + h), a producer warpgroup
//     and two consumer warpgroups of 64 rows (setmaxnreg: 240 registers
//     a consumer thread).  One producer thread loads Q once and K / V
//     tiles of 128 keys into a ring of two stages by TMA, through
//     rank-4 tensor maps over [B, S, heads, hd] that fill zeros past
//     each batch's S (a 2-D map over B*S rows would read the next
//     batch's rows, and p = 0 times a non-finite v is NaN).  Each
//     consumer computes S = Q K^T by wgmma m64n128k16 with both operands
//     in shared memory (K is K-major, hd contiguous), the online softmax
//     on the accumulator fragments with exp2 (scale * log2(e) folded
//     into the scores, so m lives in the log2 domain; lse converts back),
//     masks only the tiles that cross the causal diagonal, the window's
//     edge or Sk, rounds P to bf16 in registers, and adds P V by the
//     register-A wgmma (the m64nN accumulator's layout, packed pairwise,
//     is the A fragment's) with V read MN-major through the transpose
//     bit.  K and V have their own full / empty mbarriers.  Within a
//     warpgroup, S of the next tile and P V of this one are issued
//     together, so the next softmax runs while P V does; the two
//     warpgroups take turns to issue (ping-pong, named barriers), so
//     one's softmax runs while the other's products hold the tensor
//     cores.  The output is staged through the warpgroup's own rows of
//     Q's shared memory (Q is no longer read) into 16-byte row stores.
//   * mma_sync (bf16, hd 16, 32 and 80): one block of 4 warps per
//     (64-row query tile, b*H + h); each warp owns 16 query rows, keeps
//     its Q fragments in registers, and walks 64-key K/V tiles staged
//     synchronously in shared memory through warp-level mma.sync
//     m16n8k16 (bf16 x bf16 -> fp32): S = Q K^T, the online softmax on
//     the S fragments in registers (expf), then P (rounded to bf16,
//     re-packed as the A fragments of the next product) times V, whose
//     B fragments come from ldmatrix.trans.
//   * fma (float32): one block of 128 threads per (32-row query tile,
//     b*H + h), scores and PV by fmaf on the CUDA cores (tensor-core
//     TF32 would round q and k to 10 bits).
// Grid (query tiles, b*H + h), the heads split over grid.y (65535 at
// most) and grid.z past that, so B*H is not held to grid.y's limit.
// mma_sync and fma run one head's query tiles together, issued
// last-first so the long causal rows start early; wgmma (one block an
// SM) runs every head's last query tile before any head's next-to-last,
// longest first, so the last wave holds the shortest blocks.  The G =
// H/KH heads of a group read the same K/V tiles through L2, not through
// one shared copy.
//
// Bound: at the training shapes (S = 4096, hd = 128) the causal forward
// does 4*hd operations per attended (query head, key) pair, ~2.7e11 at
// B=2, H=32, against ~0.1 GB of q, k, v, o: it is bound by operations
// (0.28 ms at the bf16 tensor-core peak).  The wgmma body overlaps the
// loads with the products (TMA ring), and the softmax (one exp2 a score
// on the special-function unit) with the products, within a warpgroup
// and across the two.  It is not persistent: each block fills and
// drains its own pipeline.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tile_common.cuh"
#include "tma_common.cuh"
#include "wgmma_common.cuh"

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
// sum of a row with no valid key, where every p is 1.  Thread `tid` of
// `nthreads` takes columns tid, tid + nthreads, ...
template <typename T, int HD>
__device__ void sum_v(const T* vbase, size_t ld, int Sk, float* vsum,
                      int tid, int nthreads) {
  for (int d = tid; d < HD; d += nthreads) {
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
    sum_v<bf16, HD>(vb, ldk, a.Sk, vsum, threadIdx.x, kThreads);
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
  // outputs of a thread: (row, d) of flat index tid + j * kThreads, each
  // (row, d) of the tile owned by one thread (HD need not divide 128)
  static_assert(kFQ * HD % kThreads == 0, "whole outputs a thread");
  constexpr int kPer = kFQ * HD / kThreads;
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
      const int r = (tid + j * kThreads) / HD, d = (tid + j * kThreads) % HD;
      float pv = 0.f;
#pragma unroll 8
      for (int c = 0; c < kFK; ++c) pv = fmaf(ss[r * LDS + c], sv[c * HD + d], pv);
      acc[j] = acc[j] * s_c[r] + pv;
    }
  }
  __syncthreads();
  if (__syncthreads_or(tid < rows && s_m[tid] == kNegInf)) {
    sum_v<float, HD>(vb, ldk, a.Sk, vsum, threadIdx.x, kThreads);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = (tid + j * kThreads) / HD, d = (tid + j * kThreads) % HD;
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
// bf16 on the warpgroup tensor cores (wgmma), head_dim 64 and 128
// ---------------------------------------------------------------------
namespace fw {

constexpr int kRows = 128;           // query rows a block: two warpgroups
constexpr int kKeys = 128;           // keys a K / V tile
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;   // + a producer warpgroup
// registers a thread after setmaxnreg: 2 x 128 x 240 + 128 x 24 <= 65536
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
constexpr int kBoxRow = 128;         // bytes of a box row: 64 bf16
// K / V stages: on an H100 a third stage made the yi-6b training shape
// slower (one block an SM either way), so the ring holds two
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: 1024-byte alignment, Q, the ring of K and V tiles, the
// two warpgroups' sum_v rows and the mbarriers (q_full; k_full, k_empty,
// v_full, v_empty a stage).
template <int HD>
struct Geo {
  static constexpr int kBoxes = HD / 64;              // 64-wide hd boxes
  static constexpr int kQBytes = kRows * HD * 2;
  static constexpr int kTileBytes = kKeys * HD * 2;   // a K or a V tile
  static constexpr int kSmem = 1024 + kQBytes + kStages * 2 * kTileBytes +
                               2 * HD * 4 + 8 * (1 + 4 * kStages);
  static_assert(kSmem <= tile::kSmemLimit, "shared memory");
};

// OR of `v` over the `n` threads of named barrier `id`.
__device__ __forceinline__ bool bar_or(int id, int n, bool v) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, %3, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(v)), "r"(id), "r"(n)
      : "memory");
  return r != 0;
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// 2**x on the special-function unit, results below 2**-126 flushed to
// zero (p is rounded to bf16 and summed against a row maximum of 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int R>
__device__ __forceinline__ void fence_u32(uint32_t (&x)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// One block per (128-row query tile, b*H + h): a producer warpgroup, one
// thread of which loads Q once and K / V tiles into a ring of kStages
// stages by TMA (rank-4 maps over [B, S, heads, hd]: zeros past each
// batch's S), and two consumer warpgroups of 64 rows each.  A consumer
// warpgroup computes S = Q K^T by wgmma m64n128k16 from shared memory
// (K is K-major: hd contiguous), the online softmax on the accumulator
// fragments in registers (exp2 with scale * log2(e) folded in; the mask
// only on tiles that cross the causal diagonal, the window's edge or
// Sk), rounds P to bf16 in registers, and adds P V by wgmma with A from
// registers and V read MN-major (transpose bit).  K and V have their
// own full / empty mbarriers, so S of a tile starts before its V lands.
// Within a warpgroup S of the next tile and P V of this one go out
// together and the next softmax overlaps P V; the two warpgroups take
// turns to issue (ping-pong), so one's softmax overlaps the other's
// products.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const Args a) {
  using G = Geo<HD>;
  using bf16 = __nv_bfloat16;
  constexpr int S = kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - tma::smem_u32(smem_raw) % 1024)
                                    % 1024);
  const uint32_t sq = tma::smem_u32(base);
  const uint32_t ring = sq + G::kQBytes;
  float* vsum_all = reinterpret_cast<float*>(base + G::kQBytes +
                                             S * 2 * G::kTileBytes);
  const uint32_t bars = tma::smem_u32(vsum_all + 2 * HD);
  const uint32_t q_full = bars;
  auto k_tile = [&](int s) { return ring + s * 2 * G::kTileBytes; };
  auto v_tile = [&](int s) { return k_tile(s) + G::kTileBytes; };
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + S + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + 2 * S + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * S + s); };

  // Longest first: the grid's linear block index walks every head's
  // last query tile (whose causal rows attend the most keys) before any
  // head's next-to-last, so the last wave holds the shortest blocks.
  const long long heads = (long long)gridDim.y * gridDim.z;
  const long long lin =
      blockIdx.x +
      (long long)gridDim.x * (blockIdx.y + (long long)gridDim.y * blockIdx.z);
  const int q0 = (gridDim.x - 1 - (int)(lin / heads)) * kRows;
  const int bh = (int)(lin % heads);
  if (bh >= a.B * a.H) return;          // the last z slice's tail
  const int b = bh / a.H, h = bh % a.H;
  const int kh = h / (a.H / a.KH);
  int lo, hi;
  key_range(a, q0, min(kRows, a.Sq - q0), lo, hi);
  const int k_first = lo / kKeys * kKeys;
  const int n_tiles = hi > k_first ? (hi - k_first + kKeys - 1) / kKeys : 0;

  if (threadIdx.x == 0) {
    tma::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      tma::mbar_init(k_full(s), 1);
      tma::mbar_init(v_full(s), 1);
      tma::mbar_init(k_empty(s), kConsumers);
      tma::mbar_init(v_empty(s), kConsumers);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread issues every load, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != kConsumers) return;
    tma::mbar_arrive_expect_tx(q_full, G::kQBytes);
    for (int j = 0; j < G::kBoxes; ++j)
      tma::tma_load_4d(sq + j * kRows * kBoxRow, &map_q, q_full, 64 * j, h,
                       q0, b);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % S, k0 = k_first + i * kKeys;
      const uint32_t ph = ((i / S) & 1) ^ 1;
      tma::mbar_wait(k_empty(s), ph);
      tma::mbar_arrive_expect_tx(k_full(s), G::kTileBytes);
      for (int j = 0; j < G::kBoxes; ++j)
        tma::tma_load_4d(k_tile(s) + j * kKeys * kBoxRow, &map_k, k_full(s),
                         64 * j, kh, k0, b);
      tma::mbar_wait(v_empty(s), ph);
      tma::mbar_arrive_expect_tx(v_full(s), G::kTileBytes);
      for (int j = 0; j < G::kBoxes; ++j)
        tma::tma_load_4d(v_tile(s) + j * kKeys * kBoxRow, &map_v, v_full(s),
                         64 * j, kh, k0, b);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int r_lo = q0 + wgi * 64;       // the warpgroup's first row
  const int p_lo = a.q_offset + r_lo, p_hi = p_lo + 63;
  // this thread's rows: 16 warp + g and + 8 of the warpgroup's 64
  const int row0 = r_lo + warp * 16 + g;
  const int qpos[2] = {a.q_offset + row0, a.q_offset + row0 + 8};
  const float sl2 = a.scale * kLog2e;   // scores in the log2 domain
  const uint32_t qa = sq + wgi * 64 * kBoxRow;   // its rows in each box
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // A tile no row of this warpgroup attends (causal: past its last row;
  // window: before its first row's window) is released untouched.  Such
  // tiles are a prefix (window) or a suffix (causal) of the walk.
  auto dead = [&](int it) {
    const int k0 = k_first + it * kKeys;
    return (a.causal && k0 > p_hi) ||
           (a.window && k0 + kKeys - 1 <= p_lo - a.window);
  };
  auto release = [&](int it) {
    const int s = it % S;
    const uint32_t ph = (it / S) & 1;
    tma::mbar_wait(k_full(s), ph);
    tma::mbar_arrive(k_empty(s));
    tma::mbar_wait(v_full(s), ph);
    tma::mbar_arrive(v_empty(s));
  };
  // S = Q K^T of the K tile in stage s, one wgmma group (the first
  // instruction overwrites sc)
  auto mma_s = [&](float (&sc)[kKeys / 2], int s) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int j = kk / 4, q = kk % 4;
      const uint64_t da =
          wg::make_desc(qa + j * kRows * kBoxRow + 32 * q, 16, 1024);
      const uint64_t db =
          wg::make_desc(k_tile(s) + j * kKeys * kBoxRow + 32 * q, 16, 1024);
      wg::wgmma_bf16_n128<0>(sc, da, db, kk > 0);
    }
    wg::wgmma_commit();
  };
  // O += P V of the V tile in stage s, one wgmma group
  auto mma_pv = [&](uint32_t (&pa)[kKeys / 16][4], int s) {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint64_t db = wg::make_desc(v_tile(s) + kk * 16 * kBoxRow,
                                        kKeys * kBoxRow, 1024);
      if constexpr (HD == 64)
        wg::wgmma_bf16_rs_n64<1>(o, pa[kk], db, 1);
      else
        wg::wgmma_bf16_rs_n128<1>(o, pa[kk], db, 1);
    }
    wg::wgmma_commit();
  };
  // The online softmax of tile `it` on its scores sc (element i at row
  // g + 8 ((i / 2) % 2) of the warp's 16, key k0 + 8 (i / 4) + 2 t4 +
  // i % 2): scale into the log2 domain, mask where the tile crosses an
  // edge, update m and l, and leave p in sc.  corr is the factor the
  // running O must be scaled by.
  auto softmax = [&](float (&sc)[kKeys / 2], int it, float (&corr)[2]) {
    const int k0 = k_first + it * kKeys;
    const bool edge = k0 + kKeys > a.Sk ||
                      (a.causal && k0 + kKeys - 1 > p_lo) ||
                      (a.window && k0 <= p_hi - a.window);
    float mx[2] = {kNegInf, kNegInf};
    if (edge) {
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const int r = (i >> 1) & 1;
        const int t = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        sc[i] = valid_key(a, qpos[r], t) ? sc[i] * sl2 : kNegInf;
        mx[r] = fmaxf(mx[r], sc[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        sc[i] *= sl2;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      sc[i] = ex2(sc[i] - m[(i >> 1) & 1]);
      psum[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
  };
  // p rounded to bf16 as the register A operand of P V, 16 keys a
  // k-step: pa[kk][j] = the pair (sc[8 kk + 2 j], sc[8 kk + 2 j + 1])
  auto pack = [&](const float (&sc)[kKeys / 2],
                  uint32_t (&pa)[kKeys / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
  };

  // Ping-pong: the two warpgroups take turns to issue their products
  // (named barrier 3 + w: "warpgroup w may issue"), so one's softmax runs
  // while the other's products hold the tensor cores.  Each takes
  // n_tiles + 1 turns; warpgroup 1 lets warpgroup 0 go first and skips
  // its last hand-over, so every arrival is consumed.
  const int turns = n_tiles + 1;
  int turn = 0;
  auto turn_wait = [&]() { tma::bar_sync(3 + wgi, 256); };
  auto turn_pass = [&]() {
    if (!(wgi == 1 && turn == turns - 1)) bar_arrive(3 + (wgi ^ 1), 256);
    ++turn;
  };
  tma::mbar_wait(q_full, 0);
  if (n_tiles > 0) {
    if (wgi == 1) bar_arrive(3, 256);
    int first = 0, last = n_tiles;
    while (first < last && dead(first)) {
      turn_wait();
      release(first++);
      turn_pass();
    }
    while (last > first && dead(last - 1)) --last;
    if (first < last) {
      // The live tiles, software-pipelined within the warpgroup: S of
      // tile it + 1 and P V of tile it go out in one wgmma stage, and the
      // softmax of tile it + 1 runs while the tensor cores work on P V of
      // tile it.  The last P V is peeled off, so no wgmma sits on a
      // branch (ptxas would serialize every wgmma of the kernel).
      float sc[kKeys / 2], corr[2];
      uint32_t pa[kKeys / 16][4];
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.f;
      tma::mbar_wait(k_full(first % S), (first / S) & 1);
      turn_wait();
      wg::fence_regs(sc);
      wg::wgmma_fence();
      mma_s(sc, first % S);
      turn_pass();
      wg::wgmma_wait<0>();
      wg::fence_regs(sc);
      tma::mbar_arrive(k_empty(first % S));
      softmax(sc, first, corr);       // O is zero: corr needs no rescale
      pack(sc, pa);
      for (int it = first; it + 1 < last; ++it) {
        const int sn = (it + 1) % S, sv = it % S;
        tma::mbar_wait(k_full(sn), ((it + 1) / S) & 1);
        tma::mbar_wait(v_full(sv), (it / S) & 1);
        turn_wait();
        wg::fence_regs(sc);
        wg::fence_regs(o);
        fence_u32(pa);
        wg::wgmma_fence();
        mma_s(sc, sn);
        mma_pv(pa, sv);
        turn_pass();
        wg::wgmma_wait<1>();            // S of tile it + 1 is done
        wg::fence_regs(sc);
        tma::mbar_arrive(k_empty(sn));
        softmax(sc, it + 1, corr);
        wg::wgmma_wait<0>();            // P V of tile it is done
        wg::fence_regs(o);
        fence_u32(pa);
        tma::mbar_arrive(v_empty(sv));
        pack(sc, pa);
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      }
      const int sv = (last - 1) % S;
      tma::mbar_wait(v_full(sv), ((last - 1) / S) & 1);
      turn_wait();
      wg::fence_regs(o);
      fence_u32(pa);
      wg::wgmma_fence();
      mma_pv(pa, sv);
      turn_pass();
      wg::wgmma_wait<0>();
      wg::fence_regs(o);
      fence_u32(pa);
      tma::mbar_arrive(v_empty(sv));
    } else {
      turn_wait();                      // the turn of a first S
      turn_pass();
    }
    for (int it = last; it < n_tiles; ++it) {
      turn_wait();
      release(it);
      turn_pass();
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row[2] = {row0, row0 + 8};
  const bool empty[2] = {row[0] < a.Sq && m[0] == kNegInf,
                         row[1] < a.Sq && m[1] == kNegInf};
  const size_t ldq = (size_t)a.H * HD, ldk = (size_t)a.KH * HD;
  float* vsum = vsum_all + wgi * HD;
  if (bar_or(1 + wgi, 128, empty[0] || empty[1])) {
    const bf16* vb = static_cast<const bf16*>(a.v) +
                     ((size_t)b * a.Sk * a.KH + kh) * HD;
    sum_v<bf16, HD>(vb, ldk, a.Sk, vsum, tid, 128);
    tma::bar_sync(1 + wgi, 128);
  }
  // o / L rounded to bf16 into this warpgroup's rows of the Q boxes
  // (128B swizzle, as TMA laid Q out), then 16-byte row pieces out
  unsigned char* stage = base + wgi * 64 * kBoxRow;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float L = empty[r] ? (float)a.n_pad_keys : fmaxf(l[r], 1e-30f);
    const int lr = warp * 16 + g + 8 * r;
#pragma unroll
    for (int c8 = 0; c8 < HD / 8; ++c8) {
      const int c = 8 * c8 + 2 * t4;
      const float x0 = empty[r] ? vsum[c] : o[4 * c8 + 2 * r];
      const float x1 = empty[r] ? vsum[c + 1] : o[4 * c8 + 2 * r + 1];
      const int cc = c % 64;
      *reinterpret_cast<uint32_t*>(
          stage + (c / 64) * kRows * kBoxRow + lr * kBoxRow +
          (((cc / 8) ^ (lr & 7)) << 4) + (cc % 8) * 2) =
          pack_bf16(x0 / L, x1 / L);
    }
    if (t4 == 0 && row[r] < a.Sq)
      a.lse[(size_t)bh * a.Sq + row[r]] =
          empty[r] ? kNegInf + logf(L) : m[r] / kLog2e + logf(L);
  }
  tma::bar_sync(1 + wgi, 128);
  bf16* ob = static_cast<bf16*>(a.o) + ((size_t)b * a.Sq * a.H + h) * HD;
  constexpr int kChunks = HD / 8;       // 16-byte pieces of a row
#pragma unroll
  for (int it = 0; it < 64 * kChunks / 128; ++it) {
    const int ci = tid + 128 * it;
    const int lr = ci / kChunks, ch = ci % kChunks;
    if (r_lo + lr >= a.Sq) continue;
    const uint4 x = *reinterpret_cast<const uint4*>(
        stage + (ch / 8) * kRows * kBoxRow + lr * kBoxRow +
        (((ch % 8) ^ (lr & 7)) << 4));
    *reinterpret_cast<uint4*>(ob + (size_t)(r_lo + lr) * ldq + ch * 8) = x;
  }
}

}  // namespace fw

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

enum Body { kWgmma = 0, kMmaSync = 1, kFma = 2 };

// The rule: wgmma for bf16 at head_dim 64 and 128 (whole 128-byte box
// rows of hd), mma_sync for bf16 at 16, 32 and 80, fma for float32.
int body_of(int dtype, int hd) {
  if (dtype == 0) return kFma;
  return hd == 64 || hd == 128 ? kWgmma : kMmaSync;
}

// q [B,Sq,H,hd] as (hd, H, Sq, B) in boxes of (64, 1, rows, 1).
cudaError_t map_of(CUtensorMap* map, const void* p, int hd, int heads,
                   int S, int B, int rows) {
  const uint64_t dims[4] = {(uint64_t)hd, (uint64_t)heads, (uint64_t)S,
                            (uint64_t)B};
  const uint64_t row = (uint64_t)heads * hd * 2;
  const uint64_t strides[3] = {(uint64_t)hd * 2, row, row * S};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return tma::make_map_4d(map, p, 2, dims, strides, box);
}

template <int HD>
cudaError_t launch_wgmma(const Args& a, cudaStream_t s) {
  if constexpr (HD % 64 != 0) {
    return cudaErrorInvalidValue;
  } else {
    CUtensorMap mq, mk, mv;
    cudaError_t err = map_of(&mq, a.q, HD, a.H, a.Sq, a.B, fw::kRows);
    if (err == cudaSuccess)
      err = map_of(&mk, a.k, HD, a.KH, a.Sk, a.B, fw::kKeys);
    if (err == cudaSuccess)
      err = map_of(&mv, a.v, HD, a.KH, a.Sk, a.B, fw::kKeys);
    if (err != cudaSuccess) return err;
    auto kernel = fw::flash_fwd_wgmma<HD>;
    err = tile::allow_smem(kernel, fw::Geo<HD>::kSmem);
    if (err != cudaSuccess) return err;
    kernel<<<grid_of(a, fw::kRows), fw::kThreads, fw::Geo<HD>::kSmem, s>>>(
        mq, mk, mv, a);
    return cudaGetLastError();
  }
}

template <int HD>
cudaError_t launch(int dtype, const Args& a, cudaStream_t s) {
  cudaError_t err;
  if (body_of(dtype, HD) == kWgmma) return launch_wgmma<HD>(a, s);
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

// The body flash_attention_fwd runs for (dtype, hd): 0 wgmma, 1
// mma_sync, 2 fma.
int flash_attention_body(int dtype, int hd) { return body_of(dtype, hd); }

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
    case 80: return (int)launch<80>(dtype, a, s);
    case 128: return (int)launch<128>(dtype, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
