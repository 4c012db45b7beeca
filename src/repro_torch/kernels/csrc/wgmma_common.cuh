// Shared machinery of the warpgroup (wgmma) matrix-product kernels for
// Hopper (sm_90a): matmul.cu's bf16 and int8 bodies and fp8_matmul.cu;
// flash_attention.cu's wgmma body takes its descriptors, instructions
// and synchronisation.
//
// One thread block owns a bm x bn output tile (bm 64 or 128, bn 64, 128
// or 256) and walks K in stages of bk values:
//
//   * TMA.  The host encodes one 2-D tensor map per operand
//     (tma_common.cuh's make_map) with 128-byte swizzle: a box row is
//     128 bytes, so a stage of A is bk * elt / 128
//     boxes of bm rows, and the maps go to the kernel as
//     __grid_constant__ parameters.  Loads past the tensor's edge fill
//     zeros, which makes ragged M, N and K exact.
//   * An mbarrier ring of `stages` shared-memory stages (as many as fit
//     232448 bytes, at most kMaxStages): a `full` barrier per stage that
//     the producer arms with the stage's byte count (expect_tx) and TMA
//     completes, and an `empty` barrier per stage on which every consumer
//     thread arrives once its wgmma has read the stage.  Phase parity
//     flips each time the ring wraps.
//   * Warp specialisation: the last warpgroup is the producer (one thread
//     issues every TMA load); bm / 64 consumer warpgroups each own 64
//     rows of the tile and multiply from shared memory into registers.
//   * wgmma: m64nNk16 bf16 -> f32 with B read MN-major (the row-major
//     [K, N] operand as it lies, through the descriptor's transpose
//     bit), m64nNk32 e4m3 / e5m2 -> f32 and s8 -> s32 with both
//     operands K-major (8-bit operands have no transpose).  bf16 also
//     in the register-A form (A from registers, B from shared memory),
//     which flash_attention.cu uses for P V.  One
//     instruction reads 32 bytes of K; a 128-byte box row holds four.
//     The next instruction's operand starts 32 bytes further into the
//     swizzled row (the address bits the swizzle reads stay those of the
//     1024-byte-aligned atom).
//   * fp8 promotion: Hopper's fp8 wgmma adds with a reduced-precision
//     adder, so each 128 values of K (one box, four k32 instructions)
//     go into a zeroed partial accumulator that is then added to the
//     float32 one in registers (as torch._scaled_mm does by default).
//   * Epilogue: each consumer thread stores its fragment pairs straight
//     from registers, masked at the tensor's edge.
//
// No generic-proxy write to shared memory is read by the async proxy
// here (TMA writes the stages and wgmma reads them, both async proxy),
// so the kernels need no fence.proxy.async.shared::cta; a kernel that
// stages through registers into a stage wgmma reads would.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_common.cuh"

namespace wg {

// the tensor maps, mbarriers and TMA loads of tma_common.cuh
using tma::fence_barrier_init;
using tma::make_map;
using tma::mbar_arrive;
using tma::mbar_arrive_expect_tx;
using tma::mbar_init;
using tma::mbar_wait;
using tma::smem_u32;
using tma::tma_load;

constexpr int kSmemLimit = 232448;   // shared memory one block may use
constexpr int kMaxStages = 6;
constexpr int kSmemSlack = 1024 + 128;  // 1024-byte alignment + barriers
constexpr int kBoxBytes = 128;          // one swizzled row of a box

// ---------------------------------------------------------------------
// the tile rule (host; kernels/matmul.py mirrors it)
// ---------------------------------------------------------------------
// Bytes of one stage: A is bk * elt / 128 boxes of bm rows, B the same
// bytes for bn columns.
inline int stage_bytes(int elt, int bm, int bn, int bk) {
  return (bm + bn) * bk * elt;
}

inline int stages_for(int elt, int bm, int bn, int bk) {
  const int s = (kSmemLimit - kSmemSlack) / stage_bytes(elt, bm, bn, bk);
  return s < kMaxStages ? s : kMaxStages;
}

// Dynamic shared memory of the wgmma body (over the limit when not even
// one stage fits).
inline int smem_bytes(int elt, int bm, int bn, int bk) {
  const int s = stages_for(elt, bm, bn, bk);
  return kSmemSlack + (s > 0 ? s : 1) * stage_bytes(elt, bm, bn, bk);
}

// (bm, bn, bk) on the warpgroup grid: bm one or two 64-row warpgroups,
// bn a wgmma width (fp8's promoted accumulators double the registers, so
// at most 128), bk whole 128-byte box rows (four 32-byte wgmma depths);
// a 16-bit B box is bk rows of K, at most 256.
inline bool on_grid(int elt, bool fp8, int bm, int bn, int bk) {
  if (bm != 64 && bm != 128) return false;
  if (bn != 64 && bn != 128 && !(bn == 256 && !fp8)) return false;
  if (bk <= 0 || (bk * elt) % kBoxBytes) return false;
  return elt == 1 || bk <= 256;
}

// TMA can read the operands: 16-byte-aligned bases and row strides
// that are whole 16 bytes (A [M, K] and K-major B [N, K] by K; a 16-bit
// row-major B [K, N] by N), and the grid's N extent.
inline bool tma_ready(int elt, int N, int K, int bn, bool aligned) {
  if (!aligned || (K * elt) % 16) return false;
  if (elt == 2 && (N * elt) % 16) return false;
  return (N + bn - 1) / bn <= 65535;
}

// ---------------------------------------------------------------------
// device: wgmma descriptors and synchronisation
// ---------------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1):
// start address, leading-dimension byte offset (LBO) and stride byte
// offset (SBO), each in 16-byte units; base offset 0 (every atom is
// 1024-byte aligned).  K-major operand: rows of 128 bytes, SBO = 1024
// between 8-row groups, LBO unused (K fits the swizzle width).
// MN-major operand: 64 values of M/N a 128-byte row, rows along K,
// SBO = 1024 between 8-row groups of K, LBO between 64-wide column
// blocks.
__device__ inline uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                     uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across a
// wgmma wait: the registers are written by the asynchronous unit.
template <int R> __device__ inline void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R> __device__ inline void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---------------------------------------------------------------------
// device: wgmma instructions.  d += A (64 x k, descriptor da) times
// B (k x N, descriptor db); scale_d == 0 overwrites d instead.  bf16:
// k = 16, TransB = 1 for an MN-major B; 8-bit: k = 32, both K-major.
// ---------------------------------------------------------------------
template <int TransB>
__device__ inline void wgmma_bf16_n64(float (&d)[32], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ inline void wgmma_bf16_n128(float (&d)[64], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TransB));
}

template <int TransB>
__device__ inline void wgmma_bf16_n256(float (&d)[128], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TransB));
}

// The register-A form (bf16): A, 64 x 16, from registers, four 32-bit
// registers of bf16 pairs a thread in mma.sync m16n8k16's A layout per
// warp (warp w holds rows 16 w .. 16 w + 15: a0 (row g, k 2t, 2t + 1),
// a1 (row g + 8, same k), a2 (row g, k 2t + 8, 2t + 9), a3 (row g + 8,
// same k); g = lane / 4, t = lane % 4).  That is the m64nN f32
// accumulator's own layout for 16 of its columns packed pairwise, so an
// accumulator rounded to bf16 feeds the next product without a trip
// through shared memory (flash_attention.cu's P V).
template <int TransB>
__device__ inline void wgmma_bf16_rs_n64(float (&d)[32],
                                        const uint32_t (&a)[4], uint64_t db,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TransB));
}

template <int TransB>
__device__ inline void wgmma_bf16_rs_n128(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TransB));
}

__device__ inline void wgmma_e4m3_n64(float (&d)[32], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ inline void wgmma_e4m3_n128(float (&d)[64], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ inline void wgmma_e4m3_n256(float (&d)[128], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ inline void wgmma_e5m2_n64(float (&d)[32], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.f32.e5m2.e5m2 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ inline void wgmma_e5m2_n128(float (&d)[64], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e5m2.e5m2 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ inline void wgmma_e5m2_n256(float (&d)[128], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.f32.e5m2.e5m2 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ inline void wgmma_s8_n64(int (&d)[32], uint64_t da,
                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ inline void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ inline void wgmma_s8_n256(int (&d)[128], uint64_t da,
                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------
// operand types: element bytes, B's major, promotion, the instruction
// ---------------------------------------------------------------------
struct OpBF16 {
  using Acc = float;
  static constexpr int kElt = 2;
  static constexpr bool kKMajorB = false;  // row-major [K, N] B, MN-major
  static constexpr bool kPromote = false;
  template <int N>
  __device__ static void mma(float (&d)[N / 2], uint64_t da, uint64_t db,
                             int sc) {
    if constexpr (N == 64) wgmma_bf16_n64<1>(d, da, db, sc);
    else if constexpr (N == 128) wgmma_bf16_n128<1>(d, da, db, sc);
    else wgmma_bf16_n256<1>(d, da, db, sc);
  }
};

struct OpS8 {
  using Acc = int;
  static constexpr int kElt = 1;
  static constexpr bool kKMajorB = true;
  static constexpr bool kPromote = false;  // s32 sums are exact
  template <int N>
  __device__ static void mma(int (&d)[N / 2], uint64_t da, uint64_t db,
                             int sc) {
    if constexpr (N == 64) wgmma_s8_n64(d, da, db, sc);
    else if constexpr (N == 128) wgmma_s8_n128(d, da, db, sc);
    else wgmma_s8_n256(d, da, db, sc);
  }
};

template <bool E5M2>
struct OpFP8 {
  using Acc = float;
  static constexpr int kElt = 1;
  static constexpr bool kKMajorB = true;
  static constexpr bool kPromote = true;
  template <int N>
  __device__ static void mma(float (&d)[N / 2], uint64_t da, uint64_t db,
                             int sc) {
    if constexpr (E5M2) {
      if constexpr (N == 64) wgmma_e5m2_n64(d, da, db, sc);
      else if constexpr (N == 128) wgmma_e5m2_n128(d, da, db, sc);
      else wgmma_e5m2_n256(d, da, db, sc);
    } else {
      if constexpr (N == 64) wgmma_e4m3_n64(d, da, db, sc);
      else if constexpr (N == 128) wgmma_e4m3_n128(d, da, db, sc);
      else wgmma_e4m3_n256(d, da, db, sc);
    }
  }
};

// ---------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------
constexpr int kWarpgroup = 128;
constexpr int kMaxThreads = 3 * kWarpgroup;  // two consumers + producer

// Epi: init() once per thread (e.g. reads the scales), then
// store(r, c, v0, v1, M, N) for the elements (r, c) and (r, c + 1).
template <class Op, int BN, class Epi>
__global__ void __launch_bounds__(kMaxThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, Epi epi, int M,
                int N, int K, int bm, int bk, int stages) {
  using Acc = typename Op::Acc;
  constexpr int kElt = Op::kElt;
  constexpr int kVals = kBoxBytes / kElt;       // values in a box row
  constexpr int kStep = 32 / kElt;              // K of one instruction
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int consumers = bm / 64;
  const int boxes = bk * kElt / kBoxBytes;      // box rows of K a stage
  const uint32_t a_bytes = bm * bk * kElt;
  const uint32_t st_bytes = a_bytes + BN * bk * kElt;
  const uint32_t full = base + stages * st_bytes;   // stages x 8 bytes
  const uint32_t empty = full + stages * 8;
  const int nk = (K + bk - 1) / bk;
  const int m0 = blockIdx.x * bm, n0 = blockIdx.y * BN;
  const int wgi = threadIdx.x / kWarpgroup, t = threadIdx.x % kWarpgroup;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, consumers * kWarpgroup);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wgi == consumers) {
    // producer: one thread keeps the ring full
    if (t != 0) return;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % stages;
      mbar_wait(empty + 8 * s, ((kt / stages) & 1) ^ 1);
      const uint32_t sa = base + s * st_bytes, sb = sa + a_bytes;
      const uint32_t bar = full + 8 * s;
      mbar_arrive_expect_tx(bar, st_bytes);
      const int k0 = kt * bk;
      for (int j = 0; j < boxes; ++j)
        tma_load(sa + j * bm * kBoxBytes, &map_a, bar, k0 + j * kVals, m0);
      if constexpr (Op::kKMajorB) {
        for (int j = 0; j < boxes; ++j)
          tma_load(sb + j * BN * kBoxBytes, &map_b, bar, k0 + j * kVals, n0);
      } else {
        for (int j = 0; j < BN / kVals; ++j)
          tma_load(sb + j * bk * kBoxBytes, &map_b, bar, n0 + j * kVals, k0);
      }
    }
    return;
  }

  // consumer warpgroup wgi: rows [m0 + 64 wgi, +64) of the tile
  Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const uint32_t a_off = wgi * 64 * kBoxBytes;
  if constexpr (Op::kPromote) {
    float part[BN / 2];
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % stages;
      mbar_wait(full + 8 * s, (kt / stages) & 1);
      const uint32_t sa = base + s * st_bytes + a_off;
      const uint32_t sb = base + s * st_bytes + a_bytes;
      for (int j = 0; j < boxes; ++j) {
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < kBoxBytes / 32; ++q) {
          const uint64_t da = make_desc(sa + j * bm * kBoxBytes + 32 * q,
                                        16, 1024);
          const uint64_t db = make_desc(sb + j * BN * kBoxBytes + 32 * q,
                                        16, 1024);
          Op::template mma<BN>(part, da, db, q > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
      }
      mbar_arrive(empty + 8 * s);
    }
  } else {
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % stages;
      mbar_wait(full + 8 * s, (kt / stages) & 1);
      const uint32_t sa = base + s * st_bytes + a_off;
      const uint32_t sb = base + s * st_bytes + a_bytes;
      wgmma_fence();
      for (int j = 0; j < boxes; ++j) {
#pragma unroll
        for (int q = 0; q < kBoxBytes / 32; ++q) {
          const uint64_t da = make_desc(sa + j * bm * kBoxBytes + 32 * q,
                                        16, 1024);
          uint64_t db;
          if constexpr (Op::kKMajorB)
            db = make_desc(sb + j * BN * kBoxBytes + 32 * q, 16, 1024);
          else   // K rows (j * 4 + q) * kStep onward, 64-column blocks
            db = make_desc(sb + (j * 4 + q) * kStep * kBoxBytes,
                           bk * kBoxBytes, 1024);
          Op::template mma<BN>(acc, da, db, 1);
        }
      }
      wgmma_commit();
      if (stages > 1) {
        // the previous stage's instructions are done: release its stage
        wgmma_wait<1>();
        if (kt > 0) mbar_arrive(empty + 8 * ((kt - 1) % stages));
      } else {   // one stage: the producer waits for this one
        wgmma_wait<0>();
        mbar_arrive(empty + 8 * s);
      }
    }
    wgmma_wait<0>();
  }
  fence_regs(acc);

  // epilogue: element i of the fragment is at row 16 warp + lane / 4 +
  // 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2
  epi.init();
  const int warp = t / 32, lane = t % 32;
  const int r0 = m0 + wgi * 64 + warp * 16 + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int r = r0 + 8 * ((i / 2) % 2), c = c0 + 8 * (i / 4);
    epi.store(r, c, acc[i], acc[i + 1], M, N);
  }
}

// Launch one product on the wgmma body.  A [M, K] row-major; B
// row-major [K, N] (Op::kKMajorB false) or K-major, i.e. [N, K]
// row-major (true).  The caller has checked on_grid and tma_ready.
template <class Op, int BN, class Epi>
cudaError_t launch_bn(const void* a, const void* b, Epi epi, int M, int N,
                      int K, int bm, int bk, cudaStream_t stream) {
  constexpr int kElt = Op::kElt, kVals = kBoxBytes / kElt;
  const int stages = stages_for(kElt, bm, BN, bk);
  if (stages < 1) return cudaErrorInvalidValue;
  const int smem = kSmemSlack + stages * stage_bytes(kElt, bm, BN, bk);
  CUtensorMap ma, mb;
  cudaError_t err = make_map(&ma, a, kElt, M, K, bm, kVals);
  if (err != cudaSuccess) return err;
  err = Op::kKMajorB ? make_map(&mb, b, kElt, N, K, BN, kVals)
                     : make_map(&mb, b, kElt, K, N, bk, kVals);
  if (err != cudaSuccess) return err;
  auto kernel = gemm_kernel<Op, BN, Epi>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + bm - 1) / bm, (N + BN - 1) / BN);
  kernel<<<grid, (bm / 64 + 1) * kWarpgroup, smem, stream>>>(
      ma, mb, epi, M, N, K, bm, bk, stages);
  return cudaGetLastError();
}

template <class Op, class Epi>
cudaError_t launch(const void* a, const void* b, Epi epi, int M, int N,
                   int K, int bm, int bn, int bk, cudaStream_t stream) {
  switch (bn) {
    case 64:
      return launch_bn<Op, 64>(a, b, epi, M, N, K, bm, bk, stream);
    case 128:
      return launch_bn<Op, 128>(a, b, epi, M, N, K, bm, bk, stream);
    case 256:
      if constexpr (!Op::kPromote)
        return launch_bn<Op, 256>(a, b, epi, M, N, K, bm, bk, stream);
  }
  return cudaErrorInvalidValue;
}

// Epilogues: bf16 out (optionally times a device-resident scale), int32.
struct StoreBF16 {
  __nv_bfloat16* C;
  const float* sx;   // null: no scale
  const float* sw;
  float scale;
  __device__ void init() { scale = sx ? sx[0] * sw[0] : 1.f; }
  __device__ void store(int r, int c, float v0, float v1, int M,
                        int N) const {
    if (r >= M || c >= N) return;
    if (sx) {
      v0 *= scale;
      v1 *= scale;
    }
    __nv_bfloat16* p = C + static_cast<size_t>(r) * N + c;
    if (c + 1 < N && !(N & 1)) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    } else {
      p[0] = __float2bfloat16(v0);
      if (c + 1 < N) p[1] = __float2bfloat16(v1);
    }
  }
};

struct StoreI32 {
  int* C;
  __device__ void init() {}
  __device__ void store(int r, int c, int v0, int v1, int M, int N) const {
    if (r >= M || c >= N) return;
    int* p = C + static_cast<size_t>(r) * N + c;
    if (c + 1 < N && !(N & 1)) {
      *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
    } else {
      p[0] = v0;
      if (c + 1 < N) p[1] = v1;
    }
  }
};

}  // namespace wg
