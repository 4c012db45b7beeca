// Tiled matrix product C = A @ B for Hopper (sm_90a): the port of the
// Pallas kernels `matmul` (matmul_kernel) and `single_tile_matmul` of
// src/repro/kernels/matmul.py.
//
// matmul_fwd runs one of three bodies, chosen by the tile rule
// (matmul_body; kernels/matmul.py mirrors it as `body`):
//
//   * wgmma (bf16, int8; wgmma_common.cuh): when (bm, bn, bk) lie on the
//     warpgroup grid (bm 64 or 128, bn 64/128/256, bk whole 128-byte
//     box rows; bf16 bk <= 256) and TMA can read the operands (16-byte
//     aligned bases, row strides of whole 16 bytes).  Grid (M/bm, N/bn),
//     M tiles fastest so a wave of blocks shares B's columns in L2.  A
//     producer warp keeps a ring of TMA stages full; one consumer
//     warpgroup per 64 rows multiplies with m64nNk16 bf16 -> f32 (B
//     row-major, read MN-major through the transpose bit: no copy) or
//     m64nNk32 s8 -> s32 (B K-major, [N, K]: the wrapper passes a
//     column-major view as it is or copies a row-major one).  bf16 out
//     rounds the float32 accumulator once; int8 out is int32, exact.
//   * mma_sync (bf16, int8, any other tile or operand; tile_common.cuh):
//     one block of 256 threads per (bm, bn) tile walks K in slices of bk
//     staged element by element through shared memory, with warp-level
//     mma.sync (m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32, the paper's
//     Table VII instructions).  B row-major.
//   * fma_tma (float32, bm and bn each 16, 32, 64 or 128, operands TMA
//     can read: 16-byte-aligned bases, K and N multiples of 4, at most
//     65535 column tiles): fma_pipe.cuh's ring, the tma body of
//     pipelined_matmul (async_pipeline.cu).  A producer warp issues TMA
//     loads of 64-float-deep K slices (two 128-byte boxes a row,
//     whatever bk is) into a ring of two stages (64 KB each at
//     128 x 128) with full / empty mbarriers, and the consumers run
//     fma_tile.cuh's register-blocked fmaf tile on each (64 x 64 as two
//     K groups).  Four stages of 32-float slices ran slower at both
//     tiles on an H100 at M=2048, K=4096, N=11008, and more stages
//     gained nothing (chip_smoke.py phase 8 times both rings through
//     pipelined_matmul, which runs this kernel).  The tile's bk keeps
//     its meaning for the shared-memory check: a float32 tile is held to
//     the bytes the fma body would stage, so a tile refused before is
//     refused still.
//   * fma (float32, every other tile or operand): the mma_sync walk on
//     the CUDA cores in fmaf.  Both float32 bodies accumulate in fmaf,
//     never TF32 (the reference holds float32 to rtol 1e-5).
//
// single_tile_matmul_fwd: the synchronous one-tile analog (the paper's
// Tables VI/VII, whose subject is the synchronous mma) -- a single block
// computes the whole product.  Two bodies, chosen by a rule on the
// operands (single_tile_matmul_body; kernels/matmul.py mirrors it as
// `single_tile_body`):
//
//   * tma (16-byte-aligned bases, K and N rows whole 16 bytes): a
//     producer warpgroup, one thread of which issues TMA loads of
//     128-byte-deep K slices (bk = 32 float32, 64 bf16, 128 int8 values)
//     into an mbarrier ring of four A stages ([128 rows][bk], 128B
//     swizzle) and a ring of B stages ([bk][128 / elt] boxes, 128B
//     swizzle), so the copy of slice k + 1 overlaps the products of
//     slice k; two consumer warpgroups (eight warps; setmaxnreg moves
//     registers from the producer to them: 232 a thread) walk the output
//     in sub-tiles of 128 x 256 (bf16, int8) or 128 x 128 (float32),
//     since a 256 x 256 float32 accumulator (256 KB) is four times what
//     one SM's registers hold.  bf16 keeps mma.sync m16n8k16 -> f32 with
//     A fragments from ldmatrix.x4 and B, row-major, from
//     ldmatrix.x4.trans, the next 32 bytes of K loaded while the current
//     ones multiply; int8 keeps m16n8k32 s8 -> s32, whose B must be
//     K-major: the consumers transpose each TMA'd B slice in shared
//     memory (4 x 4 byte blocks, prmt, a bank-conflict-free lane map)
//     into a swizzled [n][k] copy that ldmatrix.x4 reads, then free the
//     TMA stage; float32 runs the register-blocked fmaf tile of
//     fma_tile.cuh.  The walk takes
//     column blocks outside and row blocks inside, and where the whole
//     K of a column block's B (transposed, for int8) fits beside the A
//     ring it stays in shared memory for every row block: B is read
//     once (the 256^3 cases), not once per 128-row block.  The bf16 and
//     int8 epilogue stages each warp's rows in shared memory and writes
//     them as 256-byte row pieces (the fragments' own layout would give
//     32-byte pieces).
//   * staged (any other operands): the mma_sync / fma walk of
//     tile_common.cuh, each K slice staged element by element.
// Output in the accumulator's type: float32 for float32 and bf16 in,
// int32 for int8 in.
//
// What bounds it: at the full-width shapes (2048 x 4096 x 11008) the
// product is compute bound (arithmetic intensity in the hundreds of
// FLOP/byte).  The wgmma body feeds the tensor cores from TMA stages
// that overlap the loads of later stages, with one wgmma group kept in
// flight, and reaches about half the bf16 peak there.  More K a stage
// and more stages both help it (a handshake a stage per warpgroup);
// sharing B between the two blocks of a cluster by TMA multicast and a
// persistent tile walk were both slower on the card, so neither is
// here.  The mma_sync body stages element by element with a
// __syncthreads pair per slice and stays well below the tensor-core
// peak.  float32 is bound by the CUDA cores' fmaf rate: the fma_tma body
// keeps the copies off the compute threads and out of their barriers.
//
// Entry points return the CUDA error of the launch (0 = launched).

#include <type_traits>

#include "fma_pipe.cuh"
#include "fma_tile.cuh"
#include "tile_common.cuh"
#include "tma_common.cuh"
#include "wgmma_common.cuh"

namespace {

using namespace tile;

enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2 };
enum Body { kWgmma = 0, kMmaSync = 1, kFma = 2, kFmaTma = 3 };
// the fma_tma body's ring: 64-float K slices, two stages
constexpr int kFmaTmaBk = 64, kFmaTmaStages = 2;

int elt_of(int dtype) { return dtype == kBF16 ? 2 : 1; }

// The tile rule: which body a product runs.
int body_of(int dtype, int M, int N, int K, int bm, int bn, int bk,
            bool aligned) {
  if (dtype == kF32)   // the TMA ring: (bm, bn) on its grid, TMA-ready
    return fpipe::on_grid(bm) && fpipe::on_grid(bn) &&
                   fpipe::tma_ready(N, K, bn, aligned)
               ? kFmaTma
               : kFma;
  const int elt = elt_of(dtype);
  if (wg::on_grid(elt, false, bm, bn, bk) &&
      wg::tma_ready(elt, N, K, bn, aligned))
    return kWgmma;
  return kMmaSync;
}

bool aligned16(const void* a, const void* b) {
  return !(reinterpret_cast<uintptr_t>(a) % 16) &&
         !(reinterpret_cast<uintptr_t>(b) % 16);
}

template <class S, class Out>
__global__ void __launch_bounds__(kThreads)
    mma_matmul_kernel(const S* A, const S* B, Out* C, int M, int N, int K,
                      int bm, int bn, int bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  mma_tile<S, S, Out>(A, B, C, M, N, K, blockIdx.y * bm, blockIdx.x * bn, bm,
                      bn, bk, smem, OutCast<Out>());
}

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads)
    fma_matmul_kernel(const float* A, const float* B, float* C, int M, int N,
                      int K, int bm, int bn, int bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  fma_tile<TM, TN, float>(A, B, C, M, N, K, blockIdx.y * bm, blockIdx.x * bn,
                          bm, bn, bk, smem);
}

int smem_bytes(int dtype, int bm, int bn, int bk) {
  switch (dtype) {
    case kF32: return fma_stage_bytes(bm, bn, bk);
    case kBF16: return mma_stage_bytes<__nv_bfloat16>(bm, bn, bk);
    case kI8: return mma_stage_bytes<int8_t>(bm, bn, bk);
  }
  return -1;
}

// float32: the micro-tile that covers the sub-tile (16 TM x 16 TN)
template <int TM, int TN>
int launch_fma(dim3 grid, int smem, cudaStream_t stream, const float* a,
               const float* b, float* c, int M, int N, int K, int bm, int bn,
               int bk) {
  auto kernel = fma_matmul_kernel<TM, TN>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a, b, c, M, N, K, bm, bn, bk);
  return cudaGetLastError();
}

int dispatch_fma(dim3 grid, int smem, cudaStream_t stream, const float* a,
                 const float* b, float* c, int M, int N, int K, int bm, int bn,
                 int bk) {
  const int sm = imin(bm, kMaxSubM), sn = imin(bn, kMaxSubN);
  if (sm <= 32 && sn <= 32)
    return launch_fma<2, 2>(grid, smem, stream, a, b, c, M, N, K, bm, bn, bk);
  if (sm <= 64 && sn <= 64)
    return launch_fma<4, 4>(grid, smem, stream, a, b, c, M, N, K, bm, bn, bk);
  if (sm <= 128 && sn <= 128)
    return launch_fma<8, 8>(grid, smem, stream, a, b, c, M, N, K, bm, bn, bk);
  return launch_fma<8, 16>(grid, smem, stream, a, b, c, M, N, K, bm, bn, bk);
}

template <class S, class Out>
int launch_mma(dim3 grid, int smem, cudaStream_t stream, const void* a,
               const void* b, void* c, int M, int N, int K, int bm, int bn,
               int bk) {
  auto kernel = mma_matmul_kernel<S, Out>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const S*>(a), static_cast<const S*>(b),
      static_cast<Out*>(c), M, N, K, bm, bn, bk);
  return cudaGetLastError();
}

// Launch one product with `out_acc`: output in the accumulator's type
// (single_tile) instead of the input's (matmul).
int run(int dtype, const void* a, const void* b, void* c, int M, int N, int K,
        int bm, int bn, int bk, bool out_acc, dim3 grid, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0)
    return cudaErrorInvalidValue;
  const int smem = smem_bytes(dtype, bm, bn, bk);
  if (smem < 0 || smem > kSmemLimit) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return dispatch_fma(grid, smem, stream, static_cast<const float*>(a),
                          static_cast<const float*>(b), static_cast<float*>(c),
                          M, N, K, bm, bn, bk);
    case kBF16:
      return out_acc
                 ? launch_mma<__nv_bfloat16, float>(grid, smem, stream, a, b,
                                                    c, M, N, K, bm, bn, bk)
                 : launch_mma<__nv_bfloat16, __nv_bfloat16>(
                       grid, smem, stream, a, b, c, M, N, K, bm, bn, bk);
    case kI8:
      return launch_mma<int8_t, int32_t>(grid, smem, stream, a, b, c, M, N, K,
                                         bm, bn, bk);
  }
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------
// single_tile_matmul: the tma body
// ---------------------------------------------------------------------
namespace st {

constexpr int kSubM = 128;             // output rows of a sub-tile
constexpr int kConsumers = 256;        // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;   // and a producer warpgroup
// registers a thread: consumers 232, the producer warpgroup 40
// (2 x 128 x 232 + 128 x 40 <= 65536)
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kStagesA = 4;
constexpr int kStagesB = 4;            // a B ring that streams
constexpr int kSlack = 1024 + 256;     // 1024-byte alignment + mbarriers
constexpr int kRow = 128;              // bytes of a box row, of a slice
// mma epilogue: each consumer warp stages 8 output rows of 64 values
// (rows padded to 68 values against bank conflicts) before coalesced
// 16-byte stores
constexpr int kEpiRow = 68;
constexpr int kEpilogueBytes = 8 * 8 * kEpiRow * 4;

// Sizes of one product on the tma body (host and device).
struct Geo {
  int elt, bk, sub_n, box_n, b_boxes, a_bytes, b_box_bytes, b_bytes,
      t_bytes, e_bytes, nk, tm, tn, sb, ts;
  bool resident;
  __host__ __device__ Geo(int elt_, int M, int N, int K) : elt(elt_) {
    bk = kRow / elt;                   // K values of a slice
    box_n = kRow / elt;                // N values of a B box row
    sub_n = elt == 4 ? 128 : 256;
    b_boxes = sub_n / box_n;
    a_bytes = kSubM * kRow;
    b_box_bytes = bk * kRow;
    b_bytes = b_boxes * b_box_bytes;
    t_bytes = elt == 1 ? sub_n * kRow : 0;   // int8: B transposed
    e_bytes = elt == 4 ? 0 : kEpilogueBytes; // mma: the store staging
    nk = (K + bk - 1) / bk;
    tm = (M + kSubM - 1) / kSubM;
    tn = (N + sub_n - 1) / sub_n;
    const int fixed = kSlack + kStagesA * a_bytes + e_bytes;
    // keep a column block's whole B (transposed, for int8) for its rows
    resident = tm > 1 &&
               fixed + (elt == 1 ? 2 * b_bytes + nk * t_bytes
                                 : nk * b_bytes) <= tile::kSmemLimit;
    sb = elt == 1 ? 2 : resident ? nk : kStagesB;   // TMA B stages
    ts = elt == 1 ? (resident ? nk : 2) : 0;        // transposed stages
  }
  __host__ __device__ int smem() const {
    return kSlack + kStagesA * a_bytes + sb * b_bytes + ts * t_bytes +
           e_bytes;
  }
};

__device__ inline void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ inline void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// int8: a TMA'd B slice ([128 k][128 n] boxes, 128B swizzle; `boxes` of
// them loaded) into a [256 n][128 k] copy, 128B swizzle by n, as 4 x 4
// byte blocks (kb = k / 4, n4 = n / 4).  The lane map puts the 32 reads
// and the 32 writes of each instruction in 32 distinct banks (a lane's
// bits pick n4's low bits and, crossed, kb's; the warp and iteration
// bits pick the rest).
__device__ inline void transpose_b8(const unsigned char* src,
                                    unsigned char* dst, int boxes) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int l0 = lane & 1, l1 = (lane >> 1) & 1, l2 = (lane >> 2) & 1,
            l3 = (lane >> 3) & 1, l4 = lane >> 4;
  const int e0 = w & 1, e1 = (w >> 1) & 1, f0 = w >> 2;
  if (e1 >= boxes) return;             // that box was not loaded
  const int n4 = l0 | l1 << 1 | l3 << 2 | l4 << 3 | e0 << 4 | e1 << 5;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int f1 = it & 1, f2 = (it >> 1) & 1, f3 = it >> 2;
    const int kb = l2 | (l3 ^ f0) << 1 | (l1 ^ f1) << 2 | (l4 ^ f2) << 3 |
                   f3 << 4;
    const unsigned char* s = src + (n4 >> 5) * (kRow * kRow) + (n4 & 3) * 4;
    const int chunk = (n4 & 31) >> 2;
    uint32_t v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = 4 * kb + r;
      v[r] = *reinterpret_cast<const uint32_t*>(
          s + k * kRow + ((chunk ^ (k & 7)) << 4));
    }
    const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);
    const uint32_t t1 = __byte_perm(v[0], v[1], 0x7362);
    const uint32_t t2 = __byte_perm(v[2], v[3], 0x5140);
    const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
    const uint32_t o[4] = {__byte_perm(t0, t2, 0x5410),
                           __byte_perm(t0, t2, 0x7632),
                           __byte_perm(t1, t3, 0x5410),
                           __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = 4 * n4 + c;
      *reinterpret_cast<uint32_t*>(dst + n * kRow +
                                   (((kb >> 2) ^ (n & 7)) << 4) +
                                   (kb & 3) * 4) = o[c];
    }
  }
}

// bf16 / int8 consumer: warps 2 (rows) x 4 (cols), each a 64 x 64 warp
// tile of 4 x 8 mma fragments.  A warp whose tile lies wholly past the
// sub-tile's edge skips the slice; one that overlaps it computes every
// fragment (rows past M are TMA's zeros, columns past N are never
// stored), so the inner loop has no branch.
template <class S>
struct MmaConsumer {
  using Acc = typename Mma<S>::Acc;
  Acc acc[kFragM][kFragN][4];
  int wm, wn, lane;
  __device__ MmaConsumer() {
    const int warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    wm = warp / 4;
    wn = warp % 4;
  }
  __device__ void zero() { mma_zero<S>(acc); }
  __device__ bool active(int rows, int cols) const {
    return wm * 64 < rows && wn * 64 < cols;
  }
  // The A and B fragments of one 32-byte step of K: sa is the A stage
  // [128][128 bytes]; sb the bf16 B stage ([64 k][64 n] boxes) or the
  // int8 transposed B [256 n][128 k bytes]; all 128B-swizzled.
  __device__ void load(int step, uint32_t sa, uint32_t sb,
                       uint32_t (&af)[kFragM][4],
                       uint32_t (&bf)[kFragN / 2][4]) const {
#pragma unroll
    for (int i = 0; i < kFragM; ++i) {
      const int r = wm * 64 + i * 16 + (lane & 15);
      const int ch = 2 * step + (lane >> 4);
      ldsm_x4(af[i], sa + r * kRow + ((ch ^ (r & 7)) << 4));
    }
#pragma unroll
    for (int jp = 0; jp < kFragN / 2; ++jp) {
      const int nw = wn * 64 + jp * 16;
      if constexpr (sizeof(S) == 2) {
        const int kr = step * 16 + (lane & 15);
        const int n = nw + (lane >> 4) * 8;
        ldsm_x4_trans(bf[jp], sb + (n / 64) * (64 * kRow) + kr * kRow +
                                  (((n % 64 / 8) ^ (kr & 7)) << 4));
      } else {
        const int n = nw + (lane & 7) + (lane >> 4) * 8;
        const int ch = 2 * step + ((lane >> 3) & 1);
        ldsm_x4(bf[jp], sb + n * kRow + ((ch ^ (n & 7)) << 4));
      }
    }
  }
  // acc += the slice's product; the next step's fragments are loaded
  // before the current step's mma.sync.
  __device__ void slice(uint32_t sa, uint32_t sb) {
    uint32_t af[2][kFragM][4], bf[2][kFragN / 2][4];
    load(0, sa, sb, af[0], bf[0]);
#pragma unroll
    for (int step = 0; step < 4; ++step) {   // 32 bytes of K each
      const int cur = step & 1;
      if (step < 3) load(step + 1, sa, sb, af[cur ^ 1], bf[cur ^ 1]);
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
#pragma unroll
        for (int jp = 0; jp < kFragN / 2; ++jp) {
          Mma<S>::run(acc[i][2 * jp], af[cur][i], bf[cur][jp][0],
                      bf[cur][jp][1]);
          Mma<S>::run(acc[i][2 * jp + 1], af[cur][i], bf[cur][jp][2],
                      bf[cur][jp][3]);
        }
    }
  }
  // Fragment element e of acc[i][j] sits at row g + 8 (e / 2), col
  // 2 t + e % 2.  Each 8-row half of a fragment row goes through the
  // warp's staging rows in shared memory and out as 16-byte stores, two
  // 256-byte row segments a warp instruction (straight from the
  // fragments, a warp instruction would write eight 32-byte pieces).
  template <class Out>
  __device__ void store(Out* C, int M, int N, int m0, int n0,
                        unsigned char* stage) const {
    static_assert(sizeof(Out) == 4, "32-bit outputs");
    Out* e = reinterpret_cast<Out*>(stage) + (threadIdx.x / 32) * 8 * kEpiRow;
    const int g = lane >> 2, t = lane & 3;
    const int c = n0 + wn * 64 + 4 * (lane & 15);
#pragma unroll
    for (int i = 0; i < kFragM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < kFragN; ++j) {
          Out* p = e + g * kEpiRow + 8 * j + 2 * t;
          p[0] = static_cast<Out>(acc[i][j][2 * h]);
          p[1] = static_cast<Out>(acc[i][j][2 * h + 1]);
        }
        __syncwarp();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int rr = (lane >> 4) + 2 * q;
          const int r = m0 + wm * 64 + i * 16 + 8 * h + rr;
          const Out* src = e + rr * kEpiRow + 4 * (lane & 15);
          if (r >= M) continue;
          Out* dst = C + static_cast<size_t>(r) * N + c;
          if (c + 3 < N && !(N & 3)) {     // 16-byte aligned row pieces
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(src);
          } else {
            for (int x = 0; x < 4; ++x)
              if (c + x < N) dst[x] = src[x];
          }
        }
        __syncwarp();
      }
  }
};

// float32 consumer: the register-blocked tile, 16 x 16 threads of 8 x 8.
struct FmaConsumer {
  ftile::Tile<kSubM, 128> ft;
  __device__ FmaConsumer() : ft(threadIdx.x) {}
  __device__ void zero() { ft.zero(); }
  __device__ bool active(int, int) const { return true; }
  __device__ void slice(const unsigned char* sa, const unsigned char* sb) {
    ft.slice(sa, sb, kRow / 4, 0, kRow / 4);
  }
  __device__ void store(float* C, int M, int N, int m0, int n0,
                        unsigned char*) const {
    ft.store(C + static_cast<size_t>(m0) * N + n0, N, imin(kSubM, M - m0),
             imin(128, N - n0),
             !(N % 4) && !(reinterpret_cast<uintptr_t>(C) % 16));
  }
};

template <class S, class Out>
__global__ void __launch_bounds__(kThreads, 1)
    single_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b, Out* C,
                      int M, int N, int K) {
  constexpr bool kI8 = sizeof(S) == 1, kF32 = sizeof(S) == 4;
  const Geo geo(sizeof(S), M, N, K);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - tma::smem_u32(smem_raw) % 1024)
                                    % 1024);
  unsigned char* a_ring = base;
  unsigned char* b_ring = a_ring + kStagesA * geo.a_bytes;
  unsigned char* t_ring = b_ring + geo.sb * geo.b_bytes;
  unsigned char* e_ring = t_ring + geo.ts * geo.t_bytes;
  const uint32_t bars = tma::smem_u32(e_ring + geo.e_bytes);
  const uint32_t a_ring_u = tma::smem_u32(a_ring);
  const uint32_t b_ring_u = tma::smem_u32(b_ring);
  auto a_full = [&](int s) { return bars + 8 * s; };
  auto a_empty = [&](int s) { return bars + 8 * (kStagesA + s); };
  auto b_full = [&](int s) { return bars + 8 * (2 * kStagesA + s); };
  auto b_empty = [&](int s) {
    return bars + 8 * (2 * kStagesA + geo.sb + s);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesA; ++s) {
      tma::mbar_init(a_full(s), 1);
      tma::mbar_init(a_empty(s), kConsumers);
    }
    for (int s = 0; s < geo.sb; ++s) {
      tma::mbar_init(b_full(s), 1);
      tma::mbar_init(b_empty(s), kConsumers);
    }
    tma::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread issues every load, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != kConsumers) return;
    int ia = 0, ib = 0;
    for (int pn = 0; pn < geo.tn; ++pn) {
      const int n0 = pn * geo.sub_n;
      const int cols = imin(geo.sub_n, N - n0);
      const int boxes = (cols + geo.box_n - 1) / geo.box_n;
      for (int pm = 0; pm < geo.tm; ++pm)
        for (int kt = 0; kt < geo.nk; ++kt) {
          if (!geo.resident || pm == 0) {
            const int s = ib % geo.sb;
            tma::mbar_wait(b_empty(s), ((ib / geo.sb) & 1) ^ 1);
            tma::mbar_arrive_expect_tx(b_full(s), boxes * geo.b_box_bytes);
            for (int j = 0; j < boxes; ++j)
              tma::tma_load(b_ring_u + s * geo.b_bytes + j * geo.b_box_bytes,
                            &map_b, b_full(s), n0 + j * geo.box_n,
                            kt * geo.bk);
            ++ib;
          }
          const int s = ia % kStagesA;
          tma::mbar_wait(a_empty(s), ((ia / kStagesA) & 1) ^ 1);
          tma::mbar_arrive_expect_tx(a_full(s), geo.a_bytes);
          tma::tma_load(a_ring_u + s * geo.a_bytes, &map_a, a_full(s),
                        kt * geo.bk, pm * kSubM);
          ++ia;
        }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  using Consumer = std::conditional_t<kF32, FmaConsumer, MmaConsumer<S>>;
  Consumer cons;
  int ia = 0, ib = 0;
  for (int pn = 0; pn < geo.tn; ++pn) {
    const int n0 = pn * geo.sub_n;
    const int cols = imin(geo.sub_n, N - n0);
    const int boxes = (cols + geo.box_n - 1) / geo.box_n;
    for (int pm = 0; pm < geo.tm; ++pm) {
      const int m0 = pm * kSubM;
      const int rows = imin(kSubM, M - m0);
      cons.zero();
      for (int kt = 0; kt < geo.nk; ++kt) {
        const bool load_b = !geo.resident || pm == 0;
        const int jb = geo.resident ? pn * geo.nk + kt : ib++;
        const int sbs = jb % geo.sb;
        if (load_b) tma::mbar_wait(b_full(sbs), (jb / geo.sb) & 1);
        uint32_t b_src = b_ring_u + sbs * geo.b_bytes;
        if constexpr (kI8) {
          const int ts = geo.resident ? kt : (jb & 1);
          unsigned char* t = t_ring + ts * geo.t_bytes;
          if (load_b) {
            // resident: the last column block's copy is read by all
            if (geo.resident && pn > 0 && kt == 0)
              tma::bar_sync(1, kConsumers);
            transpose_b8(b_ring + sbs * geo.b_bytes, t, boxes);
            tma::mbar_arrive(b_empty(sbs));
            tma::bar_sync(1, kConsumers);
          }
          b_src = tma::smem_u32(t);
        }
        const int s = ia % kStagesA;
        tma::mbar_wait(a_full(s), (ia / kStagesA) & 1);
        if (cons.active(rows, cols)) {
          if constexpr (kF32)
            cons.slice(a_ring + s * geo.a_bytes, b_ring + sbs * geo.b_bytes);
          else
            cons.slice(a_ring_u + s * geo.a_bytes, b_src);
        }
        tma::mbar_arrive(a_empty(s));
        ++ia;
        if (!kI8 && (!geo.resident || pm == geo.tm - 1))
          tma::mbar_arrive(b_empty(sbs));
      }
      if (cons.active(rows, cols)) cons.store(C, M, N, m0, n0, e_ring);
    }
  }
}

// The rule: the tma body where TMA can read both operands.
bool single_tma_ready(int elt, int N, int K, bool aligned) {
  return aligned && !((K * elt) % 16) && !((N * elt) % 16);
}

template <class S, class Out>
int launch_single_tma(const void* a, const void* b, void* c, int M, int N,
                      int K, cudaStream_t stream) {
  constexpr int elt = sizeof(S);
  const Geo geo(elt, M, N, K);
  CUtensorMap ma, mb;
  cudaError_t err = tma::make_map(&ma, a, elt, M, K, kSubM, geo.bk);
  if (err != cudaSuccess) return err;
  err = tma::make_map(&mb, b, elt, K, N, geo.bk, geo.box_n);
  if (err != cudaSuccess) return err;
  auto kernel = single_tma_kernel<S, Out>;
  const int smem = geo.smem();
  if (smem > tile::kSmemLimit) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, kThreads, smem, stream>>>(ma, mb, static_cast<Out*>(c), M, N,
                                        K);
  return cudaGetLastError();
}

}  // namespace st

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block stages for (bm, bn, bk) on
// the mma_sync / fma bodies.
int matmul_smem_bytes(int dtype, int bm, int bn, int bk) {
  return smem_bytes(dtype, bm, bn, bk);
}

// The same for the wgmma body (bf16, int8): its ring of stages.
int matmul_wgmma_smem_bytes(int dtype, int bm, int bn, int bk) {
  return wg::smem_bytes(elt_of(dtype), bm, bn, bk);
}

// The body matmul_fwd runs: 0 wgmma, 1 mma_sync, 2 fma, 3 fma_tma.
// `aligned`: both operands' base addresses are 16-byte aligned.
int matmul_body(int dtype, int M, int N, int K, int bm, int bn, int bk,
                int aligned) {
  return body_of(dtype, M, N, K, bm, bn, bk, aligned != 0);
}

// dtype 0 float32 -> float32, 1 bf16 -> bf16, 2 int8 -> int32.
// Tiles need not divide the problem: ragged edges are masked.  b is
// row-major [K, N] (b_kmajor 0) or, for int8 on the wgmma body only,
// K-major: row-major [N, K] (b_kmajor 1).
int matmul_fwd(int dtype, const void* a, const void* b, void* c, int M, int N,
               int K, int bm, int bn, int bk, int b_kmajor, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int body = body_of(dtype, M, N, K, bm, bn, bk, aligned16(a, b));
  if (body == kFmaTma) {
    // held to the bytes the fma body would stage for (bm, bn, bk)
    if (b_kmajor || smem_bytes(kF32, bm, bn, bk) > kSmemLimit)
      return cudaErrorInvalidValue;
    return fpipe::run(bm, bn, static_cast<const float*>(a),
                      static_cast<const float*>(b), static_cast<float*>(c),
                      M, N, K, kFmaTmaBk, kFmaTmaStages, st);
  }
  if (body == kWgmma) {
    if (b_kmajor != (dtype == kI8)) return cudaErrorInvalidValue;
    if (wg::smem_bytes(elt_of(dtype), bm, bn, bk) > wg::kSmemLimit)
      return cudaErrorInvalidValue;
    if (dtype == kBF16)
      return wg::launch<wg::OpBF16>(
          a, b, wg::StoreBF16{static_cast<__nv_bfloat16*>(c), nullptr,
                              nullptr, 0.f},
          M, N, K, bm, bn, bk, st);
    return wg::launch<wg::OpS8>(a, b, wg::StoreI32{static_cast<int*>(c)},
                                M, N, K, bm, bn, bk, st);
  }
  if (b_kmajor || (M + bm - 1) / bm > 65535) return cudaErrorInvalidValue;
  dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm);
  return run(dtype, a, b, c, M, N, K, bm, bn, bk, false, grid, st);
}

// The body single_tile_matmul_fwd runs: 0 tma, 1 staged.  `aligned`:
// both operands' base addresses are 16-byte aligned.
int single_tile_matmul_body(int dtype, int M, int N, int K, int aligned) {
  (void)M;
  const int elt = dtype == kF32 ? 4 : elt_of(dtype);
  return st::single_tma_ready(elt, N, K, aligned != 0) ? 0 : 1;
}

// Dynamic shared memory of the tma body for an M x N x K product.
int single_tile_matmul_smem_bytes(int dtype, int M, int N, int K) {
  const int elt = dtype == kF32 ? 4 : elt_of(dtype);
  return st::Geo(elt, M, N, K).smem();
}

// One block: dtype 0 float32 -> float32, 1 bf16 -> float32,
// 2 int8 -> int32; K walked in slices of bk (the tma body's bk is
// 128 bytes of K: 32, 64 or 128 values).
int single_tile_matmul_fwd(int dtype, const void* a, const void* b, void* c,
                           int M, int N, int K, int bk, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bk <= 0 || dtype < 0 || dtype > 2)
    return cudaErrorInvalidValue;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int elt = dtype == kF32 ? 4 : elt_of(dtype);
  if (!st::single_tma_ready(elt, N, K, aligned16(a, b)))
    return run(dtype, a, b, c, M, N, K, M, N, bk, true, dim3(1, 1), strm);
  if (bk != st::kRow / elt) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return st::launch_single_tma<float, float>(a, b, c, M, N, K, strm);
    case kBF16:
      return st::launch_single_tma<__nv_bfloat16, float>(a, b, c, M, N, K,
                                                         strm);
    default:
      return st::launch_single_tma<int8_t, int32_t>(a, b, c, M, N, K, strm);
  }
}

}  // extern "C"
