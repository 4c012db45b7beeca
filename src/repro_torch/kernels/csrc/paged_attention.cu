// Paged decode and chunk attention over a block-table KV pool, for
// Hopper (sm_90a): one split-K thread-block-cluster kernel.  Plain C
// interface, loaded from Python with ctypes
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
// has T too, on e4m3 pools each K/V element is float(code) * scale
// rounded to T, with one float32 scale per (token, kv head) row (scale
// pool [NB, bs, KH, 1]) -- the reference's in-tile dequant, bit for bit.
//
// Row c of slot b attends t < base[b] + off + c (decode: base = kv_len,
// off = 0, C = 1; chunk: base = pos, off = 1), capped at the table
// width T = MB*bs.  Query rows of a (slot, kv head) are flattened
// c-major (row = c*G + g), so a row group holds whole chunk positions.
//
// Design.  Bytes bound the work (decode reads every valid K/V row once
// and does ~4*hd operations per (query head, position)).  The grid is
// B * KH * RG clusters of S blocks ("splits"), RG row groups of `rows`
// query rows each (decode: the G heads of a kv head; chunk: up to 128 of
// its C*G rows, so one cluster reads the K/V rows once for all of them).
// Block rank r of a cluster takes positions [r*L, (r+1)*L), L a multiple
// of 16, and streams their K rows, then their V rows, in 128-position
// tiles through two shared-memory slots: while tile u is computed, each
// thread holds its 16-byte pieces of tile u + 2 in registers
// (ld.global.v4, rows addressed through the block table, the entry read
// a tile ahead), then stores them into the slot tile u leaves, e4m3
// codes times their row's scale rounded to T on the way.  (A ring of 2-8
// stages filled by cp.async, and one cp.async.bulk a row, ran slower on
// the H100: PERF.md, Findings.)  Rounding p after normalisation rules out
// an online softmax, so the cluster keeps every score of its rows in
// shared memory, spread over its blocks, and combines over distributed
// shared memory in a fixed order:
//   1. scores of the split into shared memory, row maxima;
//   2. cluster.sync(); every block reads the peers' maxima (max is exact
//      in any order), forms e = exp(s - m) and its partial row sums;
//   3. cluster.sync(); every block adds the partial sums in rank order,
//      so all hold the same l, and forms p = round_T(e / l), then its
//      partial PV in float32 (the first V tiles are already loaded);
//   4. cluster.sync(); each rank sums its share of the output elements
//      over the ranks' partial outputs in rank order and writes T;
//   5. cluster.sync() before exit: peers read this block's memory.
// No float atomics: the same inputs give the same bits on every call.
//
// Plans that recompute the scores (RECOMP, the plan's `recompute`): a
// table whose split's float32 scores do not fit a block (past ~80k
// positions at bf16 hd 128) keeps one tile of scores, not the split's,
// and reads K twice and V once, 1.5x the bytes of the plan that holds
// them.  The order of the softmax stays the one above:
//   1. pass 1 streams the split's K tiles: each tile's scores, then each
//      row's running maximum m and sum l of exp(s - m), rescaled by
//      exp(m_old - m_new) when the maximum grows;
//   2. cluster.sync(); the peers' maxima give the cluster's m; each block
//      rescales its l to that m; cluster.sync(); the sums in rank order
//      give l;
//   3. pass 2 streams K tile j, then V tile j: the tile's scores again,
//      p = round_T(exp(s - m) / l), and the partial PV;
//   4-5. as above.
// l is summed in another order than the held plan's (a running rescaled
// sum), so the two plans agree to float32 rounding, not bitwise.
//
// Bodies (by q's dtype, as the wrapper's `body` names them):
//   * mma_sync (bf16 q; bf16 pools or e4m3 pools dequantized to bf16):
//     S^T = K q^T and O^T = V^T P^T by mma.sync m16n8k16 with float32
//     accumulators: positions (scores) or head_dim (PV) on m, query rows
//     on n = 8, so decode's G <= 8 heads fill n; K by ldmatrix, V by
//     ldmatrix.trans, q by ldmatrix, p read from the float32 scores
//     (already bf16 values) and packed.  Products of bf16 are exact in
//     float32: only the order of the sums changes.
//   * fma (float32 q; float32 pools or e4m3 pools dequantized to float32):
//     the same phases on fmaf (never TF32): a thread per (position, row
//     set) for scores and one owner per (row, d) for PV, any head_dim.
//
// The plan (splits, rows, recompute) is the caller's: the wrapper's
// `plan` picks it from shapes alone, never from the lengths, so one plan
// serves every step of a server and a CUDA graph can capture the call.
// The source lays it out (split length, row groups, shared memory) and
// refuses a plan the kernel does not take or whose block does not fit.
// Edge rules: a row with no valid position writes zeros; a split with
// no valid position adds nothing; -1 table entries inside a row's bound
// are clamped to block 0 (the reference's maximum(bt, 0)); nothing past
// the cluster's bound (its last row's) is read, and tile rows past the
// block's share are zeroed in shared memory before any product, so a
// masked p of 0 never meets a stale or non-finite row.
//
// Launches the card ran: the grid's first thread adds one to a device
// counter (`g_launches`, one atomicAdd a launch), read by
// paged_attention_device_launches.  The wrappers count launches on the
// host when they are called; a CUDA graph replays captured launches
// without calling them, and this counter sees every launch that runs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include "tile_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;        // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;           // positions a staged tile holds
constexpr int kMaxRows = 128;        // query rows a cluster serves
constexpr int kPortableSplits = 8;
constexpr int kMaxSplits = 16;
constexpr int kSmemLimit = 232448;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Byte offsets of a block's shared memory: q rows [rows][hd + pad] of T;
// scores [rows][L + 8] float32 (L: the split's positions, or one tile's
// when the plan recomputes them); the work region (two tile slots
// [128][hd + pad] of T; after the last product the partial output
// [rows][hd] float32); per row its maximum, sum, bound and cluster-wide
// value; the peers' maxima or sums [splits][rows] gathered over DSM.
// Rows are padded by 16 bytes against bank conflicts.
struct Layout {
  int q, s, work, stats, total, slot;
  __host__ __device__ Layout(int tsz, int hd, int rows, int L, int splits) {
    q = 0;
    s = rows * (hd * tsz + 16);
    work = s + rows * (L + 8) * 4;
    slot = kTile * (hd * tsz + 16);
    stats = work + imax(2 * slot, rows * hd * 4);
    total = stats + (4 + splits) * rows * 4;
  }
};

struct Plan {
  int splits, rows, smem, split_len, groups;
  bool recompute;
};

// The launch shape of `splits` blocks a cluster (1-16, a power of two)
// and `rows` query rows a cluster (a multiple of 8 up to 128) over a
// table of T positions, holding the split's scores or recomputing them;
// false when the kernel does not take them or a block's shared memory
// passes the limit.
bool lay_out(int dtype, int hd, int G, int C, int T, int splits, int rows,
             int recompute, Plan* out) {
  if (G <= 0 || C <= 0 || T <= 0) return false;
  if (rows < 8 || rows % 8 || rows > kMaxRows) return false;
  if (splits < 1 || splits > kMaxSplits || (splits & (splits - 1)))
    return false;
  if (recompute != 0 && recompute != 1) return false;
  const int L = round_up((T + splits - 1) / splits, 16);
  const int smem = Layout(dtype == 0 ? 4 : 2, hd, rows,
                          recompute ? kTile : L, splits).total;
  if (smem > kSmemLimit) return false;
  *out = Plan{splits, rows, smem, L, (C * G + rows - 1) / rows,
              recompute != 0};
  return true;
}

// ---------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------
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

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

// two float32 values rounded to bf16 (nearest even), packed (lo first)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// eight e4m3 codes times one scale, rounded to T, into dst (16-byte
// aligned): the reference's (codes.astype(f32) * scale).astype(T)
template <typename T>
__device__ __forceinline__ void dequant8(T* dst, uint2 codes, float sc) {
  const uint32_t w[2] = {codes.x, codes.y};
  float f[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    __nv_fp8_e4m3 c;
    c.__x = static_cast<__nv_fp8_storage_t>((w[i / 4] >> (8 * (i % 4))) & 0xff);
    f[i] = static_cast<float>(c) * sc;
  }
  if constexpr (sizeof(T) == 2) {
    uint4 o;
    o.x = pack_bf16(f[0], f[1]);          // round to nearest even
    o.y = pack_bf16(f[2], f[3]);
    o.z = pack_bf16(f[4], f[5]);
    o.w = pack_bf16(f[6], f[7]);
    *reinterpret_cast<uint4*>(dst) = o;
  } else {
    reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// ---------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------

__device__ unsigned long long g_launches;   // launches run on this device

// q/out [B, C, H, HD] of type T; pools [NB, bs, KH, HD] of type T, or
// e4m3 codes with scales [NB, bs, KH, 1] float (FP8); block_table
// [B, MB] int32; base [B] int32.
struct Params {
  const void* q; const void* k; const void* v;
  const float* ks; const float* vs;
  const int* bt; const int* base; void* out;
  int C, H, KH, G, bs, MB, off, T;
  int rows, groups, split_len;
  float scale;
};

template <typename T, int HD, bool FP8, bool RECOMP>
__global__ void __launch_bounds__(kThreads, 1)
    paged_attention_kernel(const Params p) {
  constexpr int TSZ = sizeof(T);
  constexpr int PSZ = FP8 ? 1 : TSZ;       // bytes of a pool element
  constexpr int KS = HD + 16 / TSZ;        // T row stride of q and tiles
  constexpr bool MMA = TSZ == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / S;
  const int rg = cid % p.groups, bkh = cid / p.groups;
  const int kh = bkh % p.KH, b = bkh / p.KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = p.rows, L = p.split_len, G = p.G;
  const int Lsc = RECOMP ? kTile : L;      // score columns a row holds
  const int Ls = Lsc + 8;                  // score row stride (floats)
  const Layout lay(TSZ, HD, R, Lsc, S);
  T* qs = reinterpret_cast<T*>(smem + lay.q);
  float* sb = reinterpret_cast<float*>(smem + lay.s);
  unsigned char* slots = smem + lay.work;
  float* opart = reinterpret_cast<float*>(smem + lay.work);
  float* mpart = reinterpret_cast<float*>(smem + lay.stats);
  float* lpart = mpart + R;
  int* rbound = reinterpret_cast<int*>(lpart + R);
  float* rowv = lpart + 2 * R;             // the cluster's max, then sum
  float* gath = rowv + R;                  // [S][R] from the peers

  if (blockIdx.x == 0 && tid == 0) atomicAdd(&g_launches, 1ull);

  const int row0 = rg * R;
  const int nrows = imin(R, p.C * G - row0);
  const T* qg = static_cast<const T*>(p.q);
  // q rows by 16-byte cp.async (zeros past the valid rows), landing
  // while the first tiles load
  constexpr int QC = HD * TSZ / 16;         // 16-byte chunks a q row
  for (int c = tid; c < R * QC; c += kThreads) {
    const int i = c / QC, q16 = c % QC;
    unsigned char* dst =
        reinterpret_cast<unsigned char*>(qs + i * KS) + q16 * 16;
    if (i < nrows) {
      const int cq = (row0 + i) / G, g = (row0 + i) % G;
      cp_async16(dst, reinterpret_cast<const unsigned char*>(
                          qg + (((size_t)b * p.C + cq) * p.H +
                                (size_t)kh * G + g) * HD) + q16 * 16);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }

  const int base = p.base[b];
  // the cluster's bound: its last row's (rows are c-major)
  const int n_max = imax(0, imin(base + p.off + (row0 + nrows - 1) / G, p.T));
  const int t0 = rank * L;
  const int t1 = imin(t0 + L, n_max);
  const int len = imax(t1 - t0, 0);
  const int ntile = (len + kTile - 1) / kTile;
  const int nt = (RECOMP ? 3 : 2) * ntile; // tiles streamed
  const int* bt = p.bt + (size_t)b * p.MB;

  for (int i = tid; i < R; i += kThreads) {
    rbound[i] = i < nrows
                    ? imax(0, imin(base + p.off + (row0 + i) / G, p.T))
                    : 0;
    if constexpr (RECOMP) {                // running maximum and sum
      mpart[i] = neg_inf();
      lpart[i] = 0.f;
    }
  }
  // Tile u of the stream: the split's K tiles 0..ntile-1, then its V
  // tiles (RECOMP: K tile j, V tile j for each j); tile_idx is its index
  // within the split.  Register staging: thread (row r, part) holds its
  // 16-byte chunks of tile u + 2 in registers (ld.global.v4) while tile
  // u is computed, then stores them (e4m3 dequantized on the way) into
  // the slot tile u left; pool rows past t1 are zeros.  Its table entry
  // for the next tile is read one tile ahead.
  const int bs_shift = (p.bs & (p.bs - 1)) ? -1 : __ffs(p.bs) - 1;
  auto div_bs = [&](int t) { return bs_shift >= 0 ? t >> bs_shift : t / p.bs; };
  auto tile_idx = [&](int u) {
    return u < ntile ? u : RECOMP ? (u - ntile) >> 1 : u - ntile;
  };
  auto is_v = [&](int u) {
    return u >= ntile && (!RECOMP || ((u - ntile) & 1));
  };
  auto tile_start = [&](int u) { return t0 + tile_idx(u) * kTile; };
  constexpr int CPR = HD * PSZ / 16;       // 16-byte chunks a pool row
  constexpr int TPR = kThreads / kTile;   // threads a row
  constexpr int NCH = (CPR + TPR - 1) / TPR;
  const int r_own = tid / TPR, part = tid % TPR;
  uint4 stg[NCH];
  float stg_sc = 0.f;
  auto entry = [&](int u) {                // table entry of this row
    const int t = tile_start(u) + r_own;
    return u < nt && t < t1 ? imax(bt[div_bs(t)], 0) : -1;
  };
  int ent_next = entry(0);
  auto load = [&](int u) {
    if (u >= nt) return;
    const int blk = ent_next;
    ent_next = entry(u + 1);
    const int t = tile_start(u) + r_own;
#pragma unroll
    for (int i = 0; i < NCH; ++i) stg[i] = make_uint4(0, 0, 0, 0);
    stg_sc = 0.f;
    if (blk < 0) return;
    const size_t row = ((size_t)blk * p.bs + (t - div_bs(t) * p.bs)) * p.KH + kh;
    const uint4* src = reinterpret_cast<const uint4*>(
        static_cast<const unsigned char*>(is_v(u) ? p.v : p.k) +
        row * (HD * PSZ));
#pragma unroll
    for (int i = 0; i < NCH; ++i)
      if (part + TPR * i < CPR) stg[i] = src[part + TPR * i];
    if constexpr (FP8) stg_sc = (is_v(u) ? p.vs : p.ks)[row];
  };
  auto store = [&](int u) {
    if (u >= nt) return;
    T* dst = reinterpret_cast<T*>(slots + (u % 2) * lay.slot) + r_own * KS;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int k = part + TPR * i;
      if (k >= CPR) continue;
      if constexpr (FP8) {
        dequant8<T>(dst + 16 * k, make_uint2(stg[i].x, stg[i].y), stg_sc);
        dequant8<T>(dst + 16 * k + 8, make_uint2(stg[i].z, stg[i].w), stg_sc);
      } else {
        reinterpret_cast<uint4*>(dst)[k] = stg[i];
      }
    }
  };
  // tile u is in slot u % 2 once the barrier after store(u) has passed
  auto advance = [&](int u) {
    store(u + 1);
    load(u + 2);
    __syncthreads();
  };
  auto tile_of = [&](int u) -> const T* {
    return reinterpret_cast<const T*>(slots + (u % 2) * lay.slot);
  };
  // positions of the split's tile of stream tile u
  auto tile_len = [&](int u) { return imin(kTile, len - tile_idx(u) * kTile); };

  // The scores of the K tile of stream tile u into score columns col0 +
  // [0, tile_len), -inf at positions past each row's bound.
  auto score = [&](int u, int col0) {
    const T* kt = tile_of(u);
    const int tl = tile_len(u);
    const int tpos = t0 + tile_idx(u) * kTile;   // the tile's first position
    if constexpr (MMA) {
      // S^T = K q^T: warp w takes m-tile w (16 positions of the tile's
      // 128) and every n-frag (8 rows)
      const int m = warp, nf = R / 8;
      if (m * 16 < tl) {
        float acc[kMaxRows / 8][4];
#pragma unroll
        for (int j = 0; j < kMaxRows / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < HD; kk += 16) {
          uint32_t a[4];
          ldmatrix_x4(a, kt + (m * 16 + (lane & 15)) * KS + kk +
                             (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < kMaxRows / 8; ++j) {
            const int n = j;
            if (n < nf) {
              uint32_t b0, b1;
              ldmatrix_x2(b0, b1, qs + (n * 8 + (lane & 7)) * KS + kk +
                                      ((lane >> 3) & 1) * 8);
              tile::Mma<__nv_bfloat16>::run(acc[j], a, b0, b1);
            }
          }
        }
        const int g4 = lane >> 2, t4 = lane & 3;
#pragma unroll
        for (int j = 0; j < kMaxRows / 8; ++j) {
          const int n = j;
          if (n >= nf) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pl = m * 16 + g4 + 8 * (e / 2);
            const int row = n * 8 + 2 * t4 + (e % 2);
            sb[row * Ls + col0 + pl] =
                tpos + pl < rbound[row] ? acc[j][e] * p.scale : neg_inf();
          }
        }
      }
    } else {
      // a thread per (position, row set): rows rq, rq + RQ, ... in passes
      // of 8, the dot product over d in order
      constexpr int RQ = kThreads / kTile;
      const int t = tid % kTile, rq = tid / kTile;
      if (t < tl) {
        const float4* k4 = reinterpret_cast<const float4*>(kt + t * KS);
        for (int rb = 0; rb < R; rb += 8 * RQ) {
          float acc[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll 4
          for (int d4 = 0; d4 < HD / 4; ++d4) {
            const float4 kv = k4[d4];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int r = rb + rq + RQ * j;
              if (r < R) {
                const float4 qv =
                    reinterpret_cast<const float4*>(qs + r * KS)[d4];
                acc[j] = fmaf(qv.x, kv.x, acc[j]);
                acc[j] = fmaf(qv.y, kv.y, acc[j]);
                acc[j] = fmaf(qv.z, kv.z, acc[j]);
                acc[j] = fmaf(qv.w, kv.w, acc[j]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int r = rb + rq + RQ * j;
            if (r < R)
              sb[r * Ls + col0 + t] = tpos + t < rbound[r]
                                          ? acc[j] * p.scale
                                          : neg_inf();
          }
        }
      }
    }
  };

  load(0);
  store(0);
  load(1);
  cp_async_wait_all();                     // q
  __syncthreads();

  // ---- phase 1: scores of this split ---------------------------------
  for (int u = 0; u < ntile; ++u) {
    score(u, RECOMP ? 0 : u * kTile);
    if constexpr (RECOMP) {
      // fold the tile into each row's running maximum and sum
      __syncthreads();
      const int tl = tile_len(u);
      for (int r = warp; r < R; r += kWarps) {
        float mt = neg_inf();
        for (int t = lane; t < tl; t += 32) mt = fmaxf(mt, sb[r * Ls + t]);
        mt = warp_max(mt);
        const float m0 = mpart[r], m1 = fmaxf(m0, mt);
        float sum = 0.f;
        if (m1 != neg_inf()) {
          for (int t = lane; t < tl; t += 32) {
            const float s = sb[r * Ls + t];
            sum += s == neg_inf() ? 0.f : expf(s - m1);
          }
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          lpart[r] = (m0 == neg_inf() ? 0.f : lpart[r] * expf(m0 - m1)) + sum;
          mpart[r] = m1;
        }
      }
    }
    advance(u);
  }
  __syncthreads();

  // ---- phase 2: softmax over the cluster -----------------------------
  // every peer value of every row at once, then one thread a row
  auto gather = [&](float* part, bool is_max) {
    for (int i = tid; i < S * R; i += kThreads)
      gath[i] = cluster.map_shared_rank(part, i / R)[i % R];
    __syncthreads();
    for (int r = tid; r < R; r += kThreads) {
      float v = is_max ? neg_inf() : 0.f;
      for (int k = 0; k < S; ++k)       // rank order: the same in every block
        v = is_max ? fmaxf(v, gath[k * R + r]) : v + gath[k * R + r];
      rowv[r] = v;
    }
    __syncthreads();
  };
  if constexpr (RECOMP) {
    cluster.sync();                        // running maxima, sums written
    gather(mpart, true);
    for (int r = tid; r < R; r += kThreads)  // this block's sum at m
      lpart[r] = mpart[r] == neg_inf() ? 0.f
                                       : lpart[r] * expf(mpart[r] - rowv[r]);
    cluster.sync();                        // sums written, maxima read
    for (int r = tid; r < R; r += kThreads) mpart[r] = rowv[r];
    gather(lpart, false);                  // mpart: m, rowv: l
  } else {
    for (int r = warp; r < R; r += kWarps) {
      float m = neg_inf();
      for (int t = lane; t < len; t += 32) m = fmaxf(m, sb[r * Ls + t]);
      m = warp_max(m);
      if (lane == 0) mpart[r] = m;
    }
    cluster.sync();                        // maxima are written
    gather(mpart, true);
    for (int r = warp; r < R; r += kWarps) {
      const float m = rowv[r];
      float sum = 0.f;
      for (int t = lane; t < len; t += 32) {
        const float s = sb[r * Ls + t];
        const float e = s == neg_inf() ? 0.f : expf(s - m);
        sb[r * Ls + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) lpart[r] = sum;
    }
    cluster.sync();                        // partial sums are written
    gather(lpart, false);
    const int len16 = round_up(len, 16);
    for (int r = warp; r < R; r += kWarps) {
      const float l = rowv[r];
      for (int t = lane; t < len16; t += 32) {
        const float e = t < len ? sb[r * Ls + t] : 0.f;
        sb[r * Ls + t] = l > 0.f ? to_f(from_f<T>(e / l)) : 0.f;
      }
    }
    __syncthreads();
  }

  // ---- phase 3: partial P V of this split ----------------------------
  constexpr int MT = HD / 16;               // mma: m-tiles of head_dim
  constexpr int JP = MMA ? (MT * (kMaxRows / 8) + kWarps - 1) / kWarps : 1;
  constexpr int KO = MMA ? 1 : (kMaxRows * HD + kThreads - 1) / kThreads;
  float oacc[MMA ? JP : KO][MMA ? 4 : 1];
#pragma unroll
  for (int j = 0; j < (MMA ? JP : KO); ++j)
#pragma unroll
    for (int e = 0; e < (MMA ? 4 : 1); ++e) oacc[j][e] = 0.f;
  const int nf = R / 8;
  // the V tile of stream tile u against p in score columns pt + [0, tl)
  auto pv = [&](int u, int pt) {
    const T* vt = tile_of(u);
    const int tl = tile_len(u);
    if constexpr (MMA) {
      // O^T = V^T P^T: warp w takes tiles i = w + 8 j of (m-tile of hd,
      // n-frag of rows), i -> (i % MT, i / MT)
      const int g4 = lane >> 2, t4 = lane & 3;
      for (int k0 = 0; k0 < tl; k0 += 16) {
#pragma unroll
        for (int j = 0; j < JP; ++j) {
          const int i = warp + kWarps * j;
          if (i < MT * nf) {
            const int mt = i % MT, nt_ = i / MT;
            uint32_t a[4];
            ldmatrix_x4_trans(a, vt + (k0 + (lane & 7) + 8 * (lane >> 4)) * KS +
                                     mt * 16 + 8 * ((lane >> 3) & 1));
            const float* pr = sb + (nt_ * 8 + g4) * Ls + pt + k0 + 2 * t4;
            const float2 x0 = *reinterpret_cast<const float2*>(pr);
            const float2 x1 = *reinterpret_cast<const float2*>(pr + 8);
            tile::Mma<__nv_bfloat16>::run(oacc[j], a, pack_bf16(x0.x, x0.y),
                                          pack_bf16(x1.x, x1.y));
          }
        }
      }
    } else {
      // one owner per (row, d): outputs tid + 256 k, positions in order
      for (int t = 0; t < tl; ++t) {
#pragma unroll
        for (int k = 0; k < KO; ++k) {
          const int o = tid + kThreads * k;
          if (o < R * HD) {
            const int r = o / HD, d = o % HD;
            oacc[k][0] = fmaf(sb[r * Ls + pt + t], to_f(vt[t * KS + d]),
                              oacc[k][0]);
          }
        }
      }
    }
  };
  if constexpr (RECOMP) {
    // pass 2: K tile j's scores again, p = round_T(exp(s - m) / l) over
    // whole 16-column steps, then V tile j
    for (int u = ntile; u < nt; u += 2) {
      score(u, 0);
      __syncthreads();
      const int tl = tile_len(u), tl16 = round_up(tl, 16);
      for (int r = warp; r < R; r += kWarps) {
        const float m = mpart[r], l = rowv[r];
        for (int t = lane; t < tl16; t += 32) {
          const float s = t < tl ? sb[r * Ls + t] : neg_inf();
          sb[r * Ls + t] = l > 0.f && s != neg_inf()
                               ? to_f(from_f<T>(expf(s - m) / l))
                               : 0.f;
        }
      }
      advance(u);                          // p written, V tile j in place
      pv(u + 1, 0);
      advance(u + 1);
    }
  } else {
    for (int u = ntile; u < nt; ++u) {
      pv(u, (u - ntile) * kTile);
      advance(u);
    }
  }
  __syncthreads();                         // the slots are free: opart
  if constexpr (MMA) {
    const int g4 = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int j = 0; j < JP; ++j) {
      const int i = warp + kWarps * j;
      if (i < MT * nf) {
        const int mt = i % MT, nt_ = i / MT;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          opart[(nt_ * 8 + 2 * t4 + (e % 2)) * HD + mt * 16 + g4 + 8 * (e / 2)] =
              oacc[j][e];
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < KO; ++k) {
      const int o = tid + kThreads * k;
      if (o < R * HD) opart[o] = oacc[k][0];
    }
  }
  cluster.sync();                          // partial outputs are written

  // ---- combine: this rank's share of the output, ranks in order ------
  {
    const int E4 = nrows * HD / 4;           // float4 groups of one row
    const int per = (E4 + S - 1) / S;
    const int e1 = imin(E4, (rank + 1) * per);
    T* og = static_cast<T*>(p.out);
    for (int e = rank * per + tid; e < e1; e += kThreads) {
      float4 v[kMaxSplits];
#pragma unroll
      for (int k = 0; k < kMaxSplits; ++k)
        if (k < S)
          v[k] = reinterpret_cast<const float4*>(
              cluster.map_shared_rank(opart, k))[e];
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kMaxSplits; ++k)
        if (k < S) {
          acc.x += v[k].x;
          acc.y += v[k].y;
          acc.z += v[k].z;
          acc.w += v[k].w;
        }
      const int i = e * 4 / HD, d = e * 4 % HD;
      const int c = (row0 + i) / G, g = (row0 + i) % G;
      T* o = og + (((size_t)b * p.C + c) * p.H + (size_t)kh * G + g) * HD + d;
      if constexpr (MMA) {
        *reinterpret_cast<uint2*>(o) =
            make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
      } else {
        *reinterpret_cast<float4*>(o) = acc;
      }
    }
  }
  cluster.sync();                          // peers are done reading
}

// The operands of one launch; pools are T or e4m3, scales null for T.
struct Args {
  const void* q; const void* k; const void* v;
  const float* ks; const float* vs;
  const int* bt; const int* base; void* out;
  int B, C, H, KH, bs, MB, off, splits, rows, recompute;
  float scale;
};

// Allow the kernel `smem` bytes of dynamic shared memory and, for
// clusters past 8 blocks, non-portable cluster sizes, once a device (the
// attributes persist; a serving step or a graph capture sets nothing).
template <typename T, int HD, bool FP8, bool RECOMP>
cudaError_t allow(const Plan& plan) {
  constexpr int kDevices = 64;
  static int smem_set[kDevices], nonportable_set[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kDevices;
  auto kernel = paged_attention_kernel<T, HD, FP8, RECOMP>;
  if (!known || smem_set[dev] < plan.smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (err != cudaSuccess) return err;
    if (known) smem_set[dev] = plan.smem;
  }
  if (plan.splits > kPortableSplits && (!known || !nonportable_set[dev])) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    if (known) nonportable_set[dev] = 1;
  }
  return cudaSuccess;
}

template <typename T, int HD, bool FP8, bool RECOMP>
cudaError_t launch(const Args& a, const Plan& plan, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T, HD, FP8, RECOMP>;
  cudaError_t err = allow<T, HD, FP8, RECOMP>(plan);
  if (err != cudaSuccess) return err;
  const Params p{a.q, a.k, a.v, a.ks, a.vs, a.bt, a.base, a.out,
                 a.C, a.H, a.KH, a.H / a.KH, a.bs, a.MB, a.off,
                 a.MB * a.bs, plan.rows, plan.groups, plan.split_len,
                 a.scale};
  const long long blocks =
      (long long)a.B * a.KH * plan.groups * plan.splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of the plan that fit the card at once (0: it cannot run).
template <typename T, int HD, bool FP8, bool RECOMP>
cudaError_t max_clusters(const Plan& plan, int* n) {
  auto kernel = paged_attention_kernel<T, HD, FP8, RECOMP>;
  cudaError_t err = allow<T, HD, FP8, RECOMP>(plan);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.splits, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = plan.smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
}

// Call F<T, HD, FP8, RECOMP>::run(args...) for the runtime dtype, hd,
// fp8 and the plan's recompute.
template <template <typename, int, bool, bool> class F, typename... A>
cudaError_t dispatch(int dtype, int hd, bool fp8, bool recompute,
                     A&&... args) {
#define PA_HD(T, P, R)                                         \
  switch (hd) {                                                \
    case 16: return F<T, 16, P, R>::run(args...);              \
    case 32: return F<T, 32, P, R>::run(args...);              \
    case 64: return F<T, 64, P, R>::run(args...);              \
    case 80: return F<T, 80, P, R>::run(args...);              \
    case 128: return F<T, 128, P, R>::run(args...);            \
    default: return cudaErrorInvalidValue;                     \
  }
#define PA_R(T, P)                                             \
  if (recompute) { PA_HD(T, P, true) } else { PA_HD(T, P, false) }
  if (dtype == 0) {
    if (fp8) { PA_R(float, true) } else { PA_R(float, false) }
  }
  if (dtype == 1) {
    if (fp8) { PA_R(__nv_bfloat16, true) } else { PA_R(__nv_bfloat16, false) }
  }
#undef PA_R
#undef PA_HD
  return cudaErrorInvalidValue;
}

template <typename T, int HD, bool FP8, bool RECOMP> struct Launch {
  static cudaError_t run(const Args& a, const Plan& plan, cudaStream_t s) {
    return launch<T, HD, FP8, RECOMP>(a, plan, s);
  }
};

template <typename T, int HD, bool FP8, bool RECOMP> struct MaxClusters {
  static cudaError_t run(const Plan& plan, int* n) {
    return max_clusters<T, HD, FP8, RECOMP>(plan, n);
  }
};

// dtype of q and out: 0 = float32, 1 = bfloat16; the pools share it
// unless fp8, where they hold e4m3 codes with float32 scales.
int run(int dtype, int hd, bool fp8, const Args& a, void* stream) {
  if (a.B <= 0 || a.C <= 0 || a.KH <= 0 || a.H % a.KH != 0 || a.bs <= 0
      || a.MB <= 0 || (fp8 && (a.ks == nullptr || a.vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  Plan plan;
  if (!lay_out(dtype, hd, a.H / a.KH, a.C, a.MB * a.bs, a.splits, a.rows,
               a.recompute, &plan))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<Launch>(dtype, hd, fp8, plan.recompute, a, plan,
                               static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Clusters of a plan the card holds at once, into *n (0: the launch
// would be refused).  Returns the CUDA error of the query.
int paged_attention_max_clusters(int dtype, int fp8, int hd, int G, int C,
                                 int T, int splits, int rows, int recompute,
                                 int* n) {
  Plan plan;
  if ((dtype != 0 && dtype != 1) ||
      !lay_out(dtype, hd, G, C, T, splits, rows, recompute, &plan))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<MaxClusters>(dtype, hd, fp8 != 0, plan.recompute,
                                    plan, n);
}

// Launches of the kernel the current device has run since the library
// was loaded, into *n (launches still running may or may not be in it:
// the caller synchronizes the device first).  Returns the CUDA error of
// the copy.
int paged_attention_device_launches(unsigned long long* n) {
  return (int)cudaMemcpyFromSymbol(n, g_launches, sizeof(*n));
}

// q/out [B, 1, H, hd]; kv_len [B] int32; splits, rows and recompute: the
// plan.  Returns the CUDA error of the launch (0 = launched).
int paged_decode_fwd(int dtype, int hd, const void* q, const void* k,
                     const void* v, const void* block_table,
                     const void* kv_len, void* out, int B, int H, int KH,
                     int bs, int MB, int splits, int rows, int recompute,
                     float scale, void* stream) {
  const Args a{q, k, v, nullptr, nullptr,
               static_cast<const int*>(block_table),
               static_cast<const int*>(kv_len), out, B, 1, H, KH, bs, MB,
               0, splits, rows, recompute, scale};
  return run(dtype, hd, false, a, stream);
}

// q/out [B, C, H, hd]; pos [B] int32 (cache length before the chunk);
// splits, rows and recompute: the plan.
int paged_chunk_fwd(int dtype, int hd, const void* q, const void* k,
                    const void* v, const void* block_table, const void* pos,
                    void* out, int B, int C, int H, int KH, int bs, int MB,
                    int splits, int rows, int recompute, float scale,
                    void* stream) {
  const Args a{q, k, v, nullptr, nullptr,
               static_cast<const int*>(block_table),
               static_cast<const int*>(pos), out, B, C, H, KH, bs, MB, 1,
               splits, rows, recompute, scale};
  return run(dtype, hd, false, a, stream);
}

// e4m3 pools k/v [NB, bs, KH, hd] with float32 scales k_scale/v_scale
// [NB, bs, KH, 1]; otherwise as paged_decode_fwd.
int paged_decode_fp8_fwd(int dtype, int hd, const void* q, const void* k,
                         const void* v, const void* k_scale,
                         const void* v_scale, const void* block_table,
                         const void* kv_len, void* out, int B, int H,
                         int KH, int bs, int MB, int splits, int rows,
                         int recompute, float scale, void* stream) {
  const Args a{q, k, v, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(block_table),
               static_cast<const int*>(kv_len), out, B, 1, H, KH, bs, MB,
               0, splits, rows, recompute, scale};
  return run(dtype, hd, true, a, stream);
}

// e4m3 pools with scales; otherwise as paged_chunk_fwd.
int paged_chunk_fp8_fwd(int dtype, int hd, const void* q, const void* k,
                        const void* v, const void* k_scale,
                        const void* v_scale, const void* block_table,
                        const void* pos, void* out, int B, int C, int H,
                        int KH, int bs, int MB, int splits, int rows,
                        int recompute, float scale, void* stream) {
  const Args a{q, k, v, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(block_table),
               static_cast<const int*>(pos), out, B, C, H, KH, bs, MB, 1,
               splits, rows, recompute, scale};
  return run(dtype, hd, true, a, stream);
}

}  // extern "C"
