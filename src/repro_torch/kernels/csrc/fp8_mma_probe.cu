// Probe: does the native e4m3 mma.sync (m16n8k32, f32 accumulate)
// compile for sm_90a and compute the product?  One warp multiplies a
// 16 x 32 e4m3 A (row-major) by a 32 x 8 e4m3 B (row-major) into a
// 16 x 8 float32 C.  Not a kernel of any path: fp8_matmul.cu upcasts
// to bf16 instead; chip_smoke.py builds this source on its own and
// reports the outcome as a finding.
//
// Fragment layout as for s8 m16n8k32: A register r holds the 4 bytes
// at row g + 8 (r % 2), cols 4 t + 16 (r / 2); B register r the 4
// k-consecutive bytes at k = 4 t + 16 r, col g; C element e at row
// g + 8 (e / 2), col 2 t + e % 2 (g = lane / 4, t = lane % 4).

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void fp8_mma_probe_kernel(const uint8_t* A, const uint8_t* B,
                                     float* C) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  uint32_t a[4], b[2];
  for (int r = 0; r < 4; ++r)
    a[r] = *reinterpret_cast<const uint32_t*>(A + (g + 8 * (r % 2)) * 32 +
                                              4 * t + 16 * (r / 2));
  for (int r = 0; r < 2; ++r) {
    b[r] = 0;
    for (int e = 0; e < 4; ++e)
      b[r] |= static_cast<uint32_t>(B[(4 * t + 16 * r + e) * 8 + g]) << (8 * e);
  }
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  for (int e = 0; e < 4; ++e)
    C[(g + 8 * (e / 2)) * 8 + 2 * t + e % 2] = c[e];
}

extern "C" int fp8_mma_probe(const void* a, const void* b, void* c,
                             void* stream) {
  fp8_mma_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<float*>(c));
  return cudaGetLastError();
}
