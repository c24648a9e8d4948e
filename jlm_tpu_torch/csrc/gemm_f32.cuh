// The exact-fp32 GEMM main loop's pieces, shared by the LSTM scan's
// scan_gemm_kernel (lstm_scan.cu), the head's proj_ms_f32_kernel
// (project_lse.cu) and the fused CE's ce_fwd_f32_kernel (softmax_ce.cu):
// FMAs on the CUDA cores, no TF32.  The last two also share the online
// logsumexp over the loop's output tiles (lse_* below).
//
// 256 threads; a block tile of 128 x 128 and K chunks of 16, both operands
// staged as [k][m] / [k][n] (a thread's 8 rows and 8 columns are two
// float4 reads each a k).  A K-major operand is loaded as float4 along k
// (four lanes a row: full 32-byte sectors) and stored transposed with an
// XOR swizzle of m by 8 (k / 4 % 4), which keeps both its scalar stores
// and the float4 reads conflict-free; a [K][N] operand is stored as it
// lies, through registers (kn_at, put_kn) or by cp.async (copy_kn).  The
// caller holds the next chunk's loads in flight during the current chunk's
// 1,024 FMAs a thread (ldg4_at, a volatile asm: under the 128-register cap
// of two blocks an SM the compiler otherwise sinks the loads to their
// stores, after the products; so does a fetch under a branch), with one
// barrier a chunk.
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

// Piece i (< 512; two a thread) of a [K][N] operand's chunk: row k0 + i /
// 32 of rows < ke, columns [n0 + 4 (i % 32), + 4) of N (a multiple of 4;
// zeros elsewhere, where ok is false); the address is clamped into the
// operand ([K, N], row stride ld).
__device__ __forceinline__ const float* kn_src(const float* B, int ld, int k0, int ke, int K,
                                               int n0, int N, int i, bool& ok) {
  const int kr = k0 + (i >> 5), n = n0 + 4 * (i & 31);
  ok = kr < ke && n < N;
  return B + (size_t)min(kr, K - 1) * ld + min(n, N - 4);
}

// Offset of piece i in a [K][N] stage: stored as it lies.
__device__ __forceinline__ int kn_off(int i) { return (i >> 5) * BN + 4 * (i & 31); }

// Piece i through registers (the scan's loop) ...
__device__ __forceinline__ float4 kn_at(const float* B, int ld, int k0, int ke, int K, int n0,
                                        int N, int i) {
  bool ok;
  const float* p = kn_src(B, ld, k0, ke, K, n0, N, i, ok);
  return ldg4_at(p, ok);
}
__device__ __forceinline__ void put_kn(float* s, int i, float4 v) {
  *reinterpret_cast<float4*>(s + kn_off(i)) = v;
}

// ... or straight into stage s by cp.async (the fused CE forward's: no
// registers held under the FMAs; the caller commits and waits).
__device__ __forceinline__ void copy_kn(float* s, const float* B, int ld, int k0, int ke, int K,
                                        int n0, int N, int i) {
  bool ok;
  const float* p = kn_src(B, ld, k0, ke, K, n0, N, i, ok);
  cp_async16(s + kn_off(i), p, ok);
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

// ---- The online logsumexp over a block's 128-column output tiles ----
// Each thread keeps the running (m, s) of its 8 rows over its own columns
// in shared memory, not registers (the loop's 64 sums and 16 in-flight load
// registers fill the 128-register cap of two blocks an SM): st holds m
// [8][256], s [8][256] and the column warps' exchange [2][16][8].  A
// tile's epilogue (lse_tile) adds the bias, masks columns >= V to -inf,
// hands each logit to the caller and folds the tile into (m, s) with
// accurate expf; lse_finish merges a row's 16 column threads once at the
// end.  m starts at -1e30, as the reference's bias padding does.
constexpr int LSE_FLOATS = 16 * 256 + 2 * 16 * 8;
constexpr float LSE_NEG = -1e30f;

// Column of acc[.][j] in the tile: 64 (j / 4) + 4 tx + j % 4.
__device__ __forceinline__ int col_of(int tx, int j) { return 64 * (j >> 2) + 4 * tx + (j & 3); }

__device__ __forceinline__ void lse_pair(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void lse_init(float* st, int tid) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    st[i * 256 + tid] = LSE_NEG;
    st[(8 + i) * 256 + tid] = 0.0f;
  }
}

// Fold the tile of columns n0 .. n0 + 127 (acc, zeroed here) into the
// running (m, s); each(i, j, x) sees the logit x of acc[i][j] (-inf past V).
template <typename Each>
__device__ __forceinline__ void lse_tile(float (&acc)[8][8], float* st, const float* bias, int n0,
                                         int V, int tid, int tx, Each each) {
  float bj[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + col_of(tx, j);
    bj[j] = n < V ? __ldg(bias + n) : -INFINITY;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float x[8], tmax = LSE_NEG;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j] = acc[i][j] + bj[j];  // -inf past V
      each(i, j, x[j]);
      tmax = fmaxf(tmax, x[j]);
      acc[i][j] = 0.0f;
    }
    const float m_old = st[i * 256 + tid], m_new = fmaxf(m_old, tmax);
    float s = st[(8 + i) * 256 + tid] * expf(m_old - m_new);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += expf(x[j] - m_new);
    st[i * 256 + tid] = m_new;
    st[(8 + i) * 256 + tid] = s;
  }
}

// Merge the 8 column lanes of each row group (lane bits 0-2) by shuffles,
// then the row's two column warps through shared memory, and write the
// block's rows' (m, s) as split `split` of m_part / s_part [splits, R].
// Every thread of the block calls it (one barrier).
__device__ __forceinline__ void lse_finish(float* st, float* m_part, float* s_part, int split,
                                           int m0, int R, int tid, int ty, int tx) {
  float* xM = st + 16 * 256;
  float* xS = xM + 16 * 8;
  float m[8], s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = st[i * 256 + tid];
    s[i] = st[(8 + i) * 256 + tid];
#pragma unroll
    for (int off = 1; off <= 4; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[i], off);
      lse_pair(m[i], s[i], m2, s2);
    }
  }
  const bool lead = (tid & 7) == 0;
  if (lead && tx >= 8) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      xM[ty * 8 + i] = m[i];
      xS[ty * 8 + i] = s[i];
    }
  }
  __syncthreads();
  if (lead && tx < 8) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      lse_pair(m[i], s[i], xM[ty * 8 + i], xS[ty * 8 + i]);
      const int row = m0 + row_of(ty, i);
      if (row < R) {
        m_part[(size_t)split * R + row] = m[i];
        s_part[(size_t)split * R + row] = s[i];
      }
    }
  }
}

}  // namespace gemm
}  // namespace jlm
