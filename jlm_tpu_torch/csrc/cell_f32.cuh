// The fp32 cell's block body, shared by lstm_cell_f32_kernel (lstm_cell.cu)
// and the fused frame's cell_cand_f32_kernel (cell_cand.cu): one block's
// product z = [x, h] @ W[:, its units in 4 gates] + b in exact fp32 FMAs on
// the CUDA cores (no TF32) and its gate epilogue with accurate expf and
// tanhf.  Design and bound: lstm_cell.cu's note.
#pragma once

#include "common.cuh"

namespace jlm {

// The shape: FR rows x FJ units (4 FJ gate columns) a block, K in chunks
// of FK, KS parts of FR / 8 x TX threads, part p taking chunks p, p + KS,
// ... through a ring of its own of PST stages; a thread keeps 8 rows x NG
// groups of 4 neighbouring columns, the groups 4 FJ / NG columns apart.
struct F32Tile {
  static constexpr int FR = 64, FJ = 32, KS = 2, FK = 32, NG = 2, PST = 4;
  static constexpr int TX = FJ / NG;                  // threads across the columns
  static constexpr int GS = 4 * FJ / NG;              // columns between a thread's groups
  static constexpr int PART = FR / 8 * TX;            // threads of a part
  static constexpr int THREADS = KS * PART;
  static constexpr int LDA = FK + 4;                  // [row][k] stage row, padded
  static constexpr int A = FR * LDA;                  // floats of a stage's x|h tile
  static constexpr int B = FK * 4 * FJ;               // floats of a stage's W tile
  static constexpr int RING = KS * PST * (A + B) * 4;
  static constexpr int RED = KS * FR * 4 * FJ * 4;    // every part's sums, over the ring
  static constexpr int MAIN = RING > RED ? RING : RED;
  static constexpr int SMEM = MAIN + 4 * FJ * 4 + FR * FJ * 4;  // + biases, c (fp32 at most)
};

// Part threads t < F32Tile::PART issue chunk kc's loads into (sA, sB): x|h
// rows [row0, row0 + FR) x K [kc FK, +FK) as [row][k] (zeros at rows >= R),
// and W's rows of that K for the block's FJ units in 4 gates as
// [k][gate][unit].
__device__ __forceinline__ void load_f32_chunk(float* sA, float* sB, const float* x,
                                               const float* h, const float* W, int kc, int t,
                                               int row0, int j0, int R, int E, int H) {
  using T = F32Tile;
  const int k0 = kc * T::FK;
  const float* src = k0 < E ? x : h;
  const int lds = k0 < E ? E : H, kx = k0 < E ? k0 : k0 - E;
  for (int i = t; i < T::FR * T::FK / 4; i += T::PART) {
    const int r = i / (T::FK / 4), q = i % (T::FK / 4), row = row0 + r;
    cp_async16(sA + r * T::LDA + 4 * q, src + (size_t)(row < R ? row : 0) * lds + kx + 4 * q,
               row < R);
  }
  for (int i = t; i < T::FK * T::FJ; i += T::PART) {
    const int kr = i / T::FJ, g = (i / (T::FJ / 4)) % 4, q = i % (T::FJ / 4);
    cp_async16(sB + (kr * 4 + g) * T::FJ + 4 * q,
               W + (size_t)(k0 + kr) * 4 * H + g * H + j0 + 4 * q, true);
  }
}

// One block of F32Tile::THREADS threads: rows [row0, row0 + FR) that lie
// below R, units [j0, j0 + FJ); x [R, E], h [R, H], W [E+H, 4H] fp32, c
// [R, H] CIn, b [4H]; E and H multiples of FK.  Thread (ty, tx) of part p
// keeps rows ty + FR/8 i (i < 8) over its part's chunks; a warp's ty read
// neighbouring rows (no bank conflict).  A part loads its own chunks and
// meets only its own threads at a named barrier, so the parts drift apart
// and their shared loads spread out.  Once every part is done with the
// ring, drained() runs (every thread; the ring past the parts' sums,
// F32Tile::RED bytes, is free from there on), the parts' sums meet in
// shared memory, and every thread takes cells of the epilogue:
// cell(r, u, idx, c', h') for row row0 + r, unit j0 + u, idx = row H + j.
template <typename CIn, typename Drained, typename Cell>
__device__ __forceinline__ void cell_f32_block(float* fsmem, const float* __restrict__ x,
                                               const float* __restrict__ h,
                                               const CIn* __restrict__ c,
                                               const float* __restrict__ W,
                                               const float* __restrict__ b, int row0, int R,
                                               int j0, int E, int H, float forget_bias,
                                               Drained&& drained, Cell&& cell) {
  using T = F32Tile;
  constexpr int FR = T::FR, FJ = T::FJ, KS = T::KS, FK = T::FK, LDA = T::LDA, TY = FR / 8;
  constexpr int NG = T::NG, GS = T::GS, PST = T::PST;
  const int part = threadIdx.x / T::PART, t = threadIdx.x % T::PART;
  const int ty = t / T::TX, tx = t % T::TX;
  const int nk = (E + H) / FK, nkp = part < nk ? (nk - part + KS - 1) / KS : 0;
  auto sA = [&](int i) { return fsmem + (part * PST + i % PST) * (T::A + T::B); };
  auto load = [&](int i) {  // the part's i-th chunk, one commit group
    if (i < nkp)
      load_f32_chunk(sA(i), sA(i) + T::A, x, h, W, part + i * KS, t, row0, j0, R, E, H);
    cp_async_commit();
  };
  float acc[8][NG][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.0f;
  // The epilogue's operands arrive with the first chunk: the block's 4 x FJ
  // biases and its FR x FJ tile of c (zeros past R).
  float* sbias = fsmem + T::MAIN / 4;
  CIn* sc = reinterpret_cast<CIn*>(sbias + 4 * FJ);
  {
    constexpr int CPR = FJ * sizeof(CIn) / 16;  // 16-byte pieces of a row of c
    for (int i = threadIdx.x; i < FR * CPR + FJ; i += T::THREADS) {
      if (i < FR * CPR) {
        const int r = i / CPR, q = i % CPR, row = row0 + r;
        cp_async16(reinterpret_cast<unsigned char*>(sc) + 16 * i,
                   reinterpret_cast<const unsigned char*>(
                       c + (size_t)(row < R ? row : 0) * H + j0) + 16 * q,
                   row < R);
      } else {
        const int g = (i - FR * CPR) / (FJ / 4), q = (i - FR * CPR) % (FJ / 4);
        cp_async16(sbias + g * FJ + 4 * q, b + g * H + j0 + 4 * q, true);
      }
    }
  }
  for (int i = 0; i < PST - 1; ++i) load(i);
  for (int i = 0; i < nkp; ++i) {
    cp_async_wait<PST - 2>();  // this thread's pieces of chunk i have landed
    // every piece of chunk i has landed, and chunk i - 1's stage is free
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + part), "n"(T::PART) : "memory");
    load(i + PST - 1);
    const float* a_t = sA(i) + ty * LDA;
    const float* b_t = sA(i) + T::A + 4 * tx;
#pragma unroll
    for (int k4 = 0; k4 < FK; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        a[r] = *reinterpret_cast<const float4*>(a_t + r * TY * LDA + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 w[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g)
          w[g] = *reinterpret_cast<const float4*>(b_t + (k4 + kk) * 4 * FJ + g * GS);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float av = kk == 0 ? a[r].x : kk == 1 ? a[r].y : kk == 2 ? a[r].z : a[r].w;
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            acc[r][g][0] = fmaf(av, w[g].x, acc[r][g][0]);
            acc[r][g][1] = fmaf(av, w[g].y, acc[r][g][1]);
            acc[r][g][2] = fmaf(av, w[g].z, acc[r][g][2]);
            acc[r][g][3] = fmaf(av, w[g].w, acc[r][g][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every part is done with the ring, and c and the biases have landed
  drained();
  // every part's sums, [part][row][gate][unit], over the ring
  float* red = fsmem + part * FR * 4 * FJ;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
      *reinterpret_cast<float4*>(red + (ty + TY * i) * 4 * FJ + g * GS + 4 * tx) =
          make_float4(acc[i][g][0], acc[i][g][1], acc[i][g][2], acc[i][g][3]);
  __syncthreads();
  for (int e = threadIdx.x; e < FR * FJ; e += T::THREADS) {
    const int r = e / FJ, u = e % FJ, row = row0 + r;
    if (row >= R) break;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      z[g] = sbias[g * FJ + u];
#pragma unroll
      for (int p = 0; p < KS; ++p) z[g] += fsmem[((p * FR + r) * 4 + g) * FJ + u];
    }
    const float cn = sigmoidf(z[2] + forget_bias) * static_cast<float>(sc[e]) +
                     sigmoidf(z[0]) * tanhf(z[1]);
    cell(r, u, (size_t)row * H + j0 + u, cn, sigmoidf(z[3]) * tanhf(cn));
  }
}

}  // namespace jlm
