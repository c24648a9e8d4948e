// The exact-fp32 GEMM main loop's pieces, shared by the LSTM scan's
// scan_gemm_kernel (lstm_scan.cu) and the head's proj_ms_f32_kernel
// (project_lse.cu): FMAs on the CUDA cores, no TF32.
//
// 256 threads; a block tile of 128 x 128 and K chunks of 16, both operands
// staged as [k][m] / [k][n] (a thread's 8 rows and 8 columns are two
// float4 reads each a k).  A K-major operand is loaded as float4 along k
// (four lanes a row: full 32-byte sectors) and stored transposed with an
// XOR swizzle of m by 8 (k / 4 % 4), which keeps both its scalar stores
// and the float4 reads conflict-free; a [K][N] operand is stored as it
// lies.  The caller holds the next chunk's loads in flight during the
// current chunk's 1,024 FMAs a thread (ldg4_at, a volatile asm: under the
// 128-register cap of two blocks an SM the compiler otherwise sinks the
// loads to their stores, after the products), with one barrier a chunk.
// Warps as 4 (rows) x 2 (columns), a warp 4 x 8 threads: a k's A reads hit
// 4 addresses, its B reads 8 (one wavefront each).  Thread (ty, tx) keeps
// rows 4 ty + {0..3} + {0, 64} and columns 4 tx + {0..3} + {0, 64}.
#pragma once

#include "common.cuh"

namespace jlm {
namespace gemm {

constexpr int BM = 128, BN = 128, BK = 16;  // 256 threads a block
constexpr int TILE = BK * BM;  // floats of one operand's stage

// Offset of (k, m) in a swizzled [BK][128] stage.
__device__ __forceinline__ int swz(int k, int m) { return k * BM + (m ^ (8 * ((k >> 2) & 3))); }

// The thread's row and column groups: ty over 16 rows of 4, tx over 16
// columns of 4.
__device__ __forceinline__ int ty_of(int tid) { return ((tid >> 5) & 3) * 4 + ((tid & 31) >> 3); }
__device__ __forceinline__ int tx_of(int tid) { return (tid >> 7) * 8 + (tid & 7); }

// Row of acc[i]: 4 ty + i, or 64 + 4 ty + i - 4.
__device__ __forceinline__ int row_of(int ty, int i) {
  return i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4;
}

// 16 bytes from global memory, or zeros where !ok (p must be a valid
// address either way), as a volatile asm: the compiler keeps the load where
// it is written instead of sinking it to the value's first use, so a chunk's
// loads stay in flight during the previous chunk's products.
__device__ __forceinline__ float4 ldg4_at(const float* p, bool ok) {
  float4 v;
  asm volatile(
      "{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %5, 0;\n\t"
      "mov.b32 %0, 0;\n\tmov.b32 %1, 0;\n\tmov.b32 %2, 0;\n\tmov.b32 %3, 0;\n\t"
      "@q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n\t}"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "r"((int)ok));
  return v;
}

// The same for 16 bytes of any type.
__device__ __forceinline__ uint4 ldg16_at(const void* p, bool ok) {
  uint4 v;
  asm volatile(
      "{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %5, 0;\n\t"
      "mov.b32 %0, 0;\n\tmov.b32 %1, 0;\n\tmov.b32 %2, 0;\n\tmov.b32 %3, 0;\n\t"
      "@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n\t}"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "r"((int)ok));
  return v;
}

// Piece i (< 512; two a thread) of a K-major operand's chunk: row r0 + i /
// 4 of rows < M, K [k0 + 4 (i % 4), + 4) of K < ke (zeros elsewhere); the
// address is clamped into the operand ([M, K], row stride ld).
__device__ __forceinline__ float4 kmajor_at(const float* A, int ld, int r0, int M, int k0,
                                            int ke, int K, int i) {
  const int r = i >> 2, k = k0 + 4 * (i & 3);
  return ldg4_at(A + (size_t)min(r0 + r, M - 1) * ld + min(k, K - 4), r0 + r < M && k < ke);
}

// Piece i of a K-major chunk into stage s, transposed and swizzled.
__device__ __forceinline__ void put_kmajor(float* s, int i, float4 v) {
  const int r = i >> 2, k = 4 * (i & 3);
  s[swz(k, r)] = v.x, s[swz(k + 1, r)] = v.y;
  s[swz(k + 2, r)] = v.z, s[swz(k + 3, r)] = v.w;
}

// One chunk's FMAs into acc from stages a ([k][m], swizzled) and b ([k][n],
// swizzled where B_SWZ: a K-major operand).
template <bool B_SWZ>
__device__ __forceinline__ void chunk_fma(float (&acc)[8][8], const float* a, const float* b,
                                          int ty, int tx) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const int x = 8 * ((k >> 2) & 3);
    const int ma = (4 * ty) ^ x, nb = B_SWZ ? (4 * tx) ^ x : 4 * tx;
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * BM + ma);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * BM + ma + 64);
    const float4 b0 = *reinterpret_cast<const float4*>(b + k * BN + nb);
    const float4 b1 = *reinterpret_cast<const float4*>(b + k * BN + nb + 64);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

}  // namespace gemm
}  // namespace jlm
