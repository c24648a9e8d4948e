// Fused softmax cross-entropy over a large vocabulary, for training:
//   forward   per row  m = max_v l,  s = sum_v exp(l - m),  t = l[y]
//   backward  gp = ga * exp(l - lse) + gb * onehot(y)
//             dh = gp @ W^T,  dW = h^T @ gp,  db = sum_rows gp
// with  l = h @ W + b  recomputed per vocab tile and never written to
// device memory (at N = 1,024 rows and V = 50,000 the fp32 logits would be
// 205 MB, written once and read twice per step).
//
// Replaces jlm_tpu/ops/softmax_ce.py::_ce_fwd_kernel, _ce_bwd_dh_kernel and
// _ce_bwd_dw_kernel in both compute dtypes.  bf16 compute: h and W arrive
// as bf16, products accumulate in fp32, gp is rounded to bf16 before both
// backward products, and db sums the unrounded fp32 gp, as the Pallas
// kernels do.  fp32 compute (``precision="highest"``, the parity mode): h
// and W stay fp32, gp is not rounded, and every product is an exact fp32
// FMA on the CUDA cores -- TF32 would round the operands.
//
// Bound: compute.  Each product is 2*N*D*V flops (52 GFLOP at N = 1,024,
// D = 512, V = 50,000; the forward runs one, each backward kernel two,
// the logits recomputed) against ~51 MB of bf16 W (102 MB in fp32), which
// the L2 serves while the row blocks re-stream it.  In fp32 the bound is
// the 67 TFLOP/s of the CUDA cores: ~0.78 ms a product.
//
// Layouts: h [N, D] and W [D, V] bf16 row-major, W in its own layout: the
// wrapper casts the [D, V] fp32 master to bf16 once per forward and once
// per backward (~150 MB of traffic, ~0.05 ms at V = 50,000) and never
// transposes it.  ldmatrix.trans turns a [k][n] tile of W into mma's
// col-major B fragment, and a plain ldmatrix of the same shared tile read
// as [n][k] gives W^T's fragment for dh.
// Columns >= V are masked (p = 0, no target), as the reference's -1e30
// bias padding does; V must be a multiple of 8 (16-byte row chunks) and
// D a multiple of 128.
//
// Hidden slices wider than KW = 512: what a kernel keeps D-wide on chip
// (h rows and W tiles in shared memory, dh or dW in registers) is cut into
// K chunks of at most 512.  The logits accumulate over the chunks, each
// staged in turn into the buffers a 512-wide slice uses (at D <= 512 one
// chunk, staged as before); a D-wide output is split over the grid (dh
// over grid.z, dW over grid.y), each slice of at most 512 recomputing the
// logits and taking its chunk last, so that the chunk left in shared
// memory is the one its product needs.  Only ce_fwd_f32 needs no change:
// it streams K in chunks of 32 at every D.
//
// Design (simple first: mma.sync m16n8k16, no cp.async/TMA pipeline):
// - ce_fwd: a block owns 128 rows and loops over its share of 64-column
//   vocab tiles (the TPU kernel's sequential vocab axis); the vocab is
//   split over grid.y so 8 row blocks still fill the card, and a small
//   second kernel merges the split partials (m, s).  The one column that
//   matches a row's target writes t directly: a write, not a one-hot sum.
// - ce_bwd_dh: a block owns 32 rows; per 64-column tile it recomputes the
//   logits, forms gp in registers, stages it as bf16 in shared memory and
//   accumulates dh [32, D] (64 fp32 registers a thread at D = 512).  The
//   vocab is split over grid.y into fp32 partial dh buffers, summed by a
//   second kernel (deterministic, no atomics).
// - ce_bwd_dw: a block owns 32 vocab columns and loops over the rows in
//   chunks of 64; it accumulates dW [D, 32] (64 registers a thread) and
//   db, and writes each once.
// fp32 compute (the *_f32 kernels; the bf16 tiling does not carry over:
// 128 rows x D of fp32 h would be 256 KB at D = 512):
// - ce_fwd_f32: a block owns 64 rows, K streams through shared memory in
//   chunks of 32 (h transposed, W in its own [D, V] layout); each thread
//   keeps a 4 x 4 tile of logits and an online (m, s) for its 4 rows.
// - ce_bwd_dh_f32: a block owns 32 rows, all of h's D columns resident; per
//   64-column tile the whole W tile is staged once, transposed, and read
//   twice (logits, then gp @ W^T); dh [32, D] lives in registers.
// - ce_bwd_dw_f32: a block owns 32 vocab columns (their W staged once,
//   transposed) and loops over the rows in chunks of 32.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr float NEG = -1e30f;

constexpr int F_TR = 128, F_TV = 64;  // ce_fwd: rows per block, tile columns
constexpr int H_TR = 32, H_TV = 64;   // ce_bwd_dh
constexpr int W_TR = 64, W_TV = 32;   // ce_bwd_dw: row chunk, columns per block

__device__ __forceinline__ uint4 ld16(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
}

// Columns [0, width) of rows [row0, row0 + rows) of h [N, hld] -> s
// [rows][ld], zero past N.
__device__ __forceinline__ void stage_rows(bf16* s, int ld, const bf16* h, int hld,
                                           int row0, int rows, int N, int width) {
  const int chunks = width / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += THREADS) {
    const int r = i / chunks, cc = i % chunks, row = row0 + r;
    *reinterpret_cast<uint4*>(s + r * ld + cc * 8) =
        ld16(h + (size_t)row * hld + cc * 8, row < N);
  }
}

// Columns [n0, n0 + cols) of rows [0, depth) of W [., ldw] -> s [depth][ld],
// zero past ldw.
__device__ __forceinline__ void stage_cols(bf16* s, int ld, const bf16* W,
                                           int n0, int cols, int depth, int ldw) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < depth * chunks; i += THREADS) {
    const int k = i / chunks, cc = i % chunks, n = n0 + cc * 8;
    *reinterpret_cast<uint4*>(s + k * ld + cc * 8) =
        ld16(W + (size_t)k * ldw + n, n < ldw);
  }
}

// K chunks of a D-wide product: chunk c covers [c * KW, c * KW + kw).
constexpr int KW = 512;
__device__ __forceinline__ int n_chunks(int D) { return (D + KW - 1) / KW; }
__device__ __forceinline__ int chunk_width(int D, int c) { return min(KW, D - c * KW); }
// The i-th chunk a slice z walks: z's own chunk last.
__device__ __forceinline__ int chunk_at(int i, int z, int nkc) { return (z + 1 + i) % nkc; }

// Per-row inputs of the backward kernels; rows past N get ga = gb = 0 and
// are masked again where gp is formed.
__device__ __forceinline__ void stage_row_terms(int* sY, float* sGa, float* sGb,
                                                float* sLse, const int* y,
                                                const float* ga, const float* gb,
                                                const float* lse, int row0,
                                                int rows, int N) {
  for (int i = threadIdx.x; i < rows; i += THREADS) {
    const int row = row0 + i;
    const bool ok = row < N;
    sY[i] = ok ? y[row] : -1;
    sGa[i] = ok ? ga[row] : 0.0f;
    sGb[i] = ok ? gb[row] : 0.0f;
    sLse[i] = ok ? lse[row] : 0.0f;
  }
}

__device__ __forceinline__ void merge_ms(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------- forward

size_t fwd_smem(int D) {
  D = D < KW ? D : KW;  // a wider slice goes in chunks of KW
  return (size_t)F_TR * (D + 8) * 2 + (size_t)D * (F_TV + 8) * 2 +
         (F_TV + 3 * F_TR) * sizeof(float);
}

__global__ void __launch_bounds__(THREADS, 1)
ce_fwd_kernel(const bf16* __restrict__ h, const bf16* __restrict__ W,
              const float* __restrict__ bias, const int* __restrict__ y,
              float* __restrict__ m_part, float* __restrict__ s_part,
              float* __restrict__ t_out, int N, int D, int V,
              int ldw, int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nkc = n_chunks(D), DC = min(D, KW);
  const int lda = DC + 8, ldb = F_TV + 8;
  bf16* sA = reinterpret_cast<bf16*>(smem);                 // [F_TR][lda]
  bf16* sB = sA + F_TR * lda;                                // [DC][ldb]
  float* sBias = reinterpret_cast<float*>(sB + DC * ldb);    // [F_TV]
  int* sY = reinterpret_cast<int*>(sBias + F_TV);            // [F_TR]
  float* sRed = reinterpret_cast<float*>(sY + F_TR);         // [2][F_TR]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps of 32 x 32
  const int gid = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;
  const int row0 = blockIdx.x * F_TR;
  const int n_tiles = (V + F_TV - 1) / F_TV;
  const int vt_begin = blockIdx.y * tiles_per_split;
  const int vt_end = min(vt_begin + tiles_per_split, n_tiles);

  if (nkc == 1) stage_rows(sA, lda, h, D, row0, F_TR, N, D);  // resident
  for (int i = tid; i < F_TR; i += THREADS) sY[i] = row0 + i < N ? y[row0 + i] : -1;

  float m_run[4], s_run[4];  // rows wm*32 + mi*16 + half*8 + gid, idx mi*2+half
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG;
    s_run[i] = 0.0f;
  }

  for (int vt = vt_begin; vt < vt_end; ++vt) {
    __syncthreads();  // previous tile consumed (and rows staged)
    const int n0 = vt * F_TV;
    for (int i = tid; i < F_TV; i += THREADS) sBias[i] = n0 + i < V ? bias[n0 + i] : 0.0f;

    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

    for (int c = 0; c < nkc; ++c) {
      const int kw = chunk_width(D, c);
      if (c > 0) __syncthreads();  // the previous chunk consumed
      if (nkc > 1) stage_rows(sA, lda, h + c * KW, D, row0, F_TR, N, kw);
      stage_cols(sB, ldb, W + (size_t)c * KW * ldw, n0, F_TV, kw, ldw);
      __syncthreads();
      for (int k0 = 0; k0 < kw; k0 += 16) {
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm * 32 + mi * 16 + (mat & 1) * 8 + mr;
          jlm::ldsm_x4(a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                       sA + r * lda + k0 + (mat >> 1) * 8);
        }
#pragma unroll
        for (int nj = 0; nj < 4; nj += 2) {
          const int kr = k0 + (mat & 1) * 8 + mr;
          const int col = wn * 32 + nj * 8 + (mat >> 1) * 8;
          jlm::ldsm_x4_trans(b[nj][0], b[nj][1], b[nj + 1][0], b[nj + 1][1],
                             sB + kr * ldb + col);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            jlm::mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    }

    // ---- epilogue: logits in registers -> online (m, s), target logit ----
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = wm * 32 + mi * 16 + half * 8 + gid;
        const int yr = sY[rl];
        float x[8];
        float tmax = NEG;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = wn * 32 + ni * 8 + tig * 2 + e;
            float v = acc[mi][ni][half * 2 + e] + sBias[cl];
            if (n0 + cl >= V)
              v = -INFINITY;
            else if (n0 + cl == yr)
              t_out[row0 + rl] = v;  // the one column that matches
            x[ni * 2 + e] = v;
            tmax = fmaxf(tmax, v);
          }
        const int i = mi * 2 + half;
        const float m_new = fmaxf(m_run[i], tmax);
        float s = s_run[i] * expf(m_run[i] - m_new);
#pragma unroll
        for (int q = 0; q < 8; ++q) s += expf(x[q] - m_new);
        m_run[i] = m_new;
        s_run[i] = s;
      }
  }

  // ---- merge partials: the 4 lanes of a quad, then the 2 column warps ----
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m_run[i], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s_run[i], off);
      merge_ms(m_run[i], s_run[i], m2, s2);
    }
  __syncthreads();
  if (wn == 1 && tig == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = wm * 32 + (i >> 1) * 16 + (i & 1) * 8 + gid;
      sRed[rl] = m_run[i];
      sRed[F_TR + rl] = s_run[i];
    }
  }
  __syncthreads();
  if (wn == 0 && tig == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = wm * 32 + (i >> 1) * 16 + (i & 1) * 8 + gid;
      const int row = row0 + rl;
      float m = m_run[i], s = s_run[i];
      merge_ms(m, s, sRed[rl], sRed[F_TR + rl]);
      if (row < N) {
        m_part[(size_t)blockIdx.y * N + row] = m;
        s_part[(size_t)blockIdx.y * N + row] = s;
      }
    }
  }
}

// Merge the vocab splits of each row: m = max_k m_k, s = sum_k s_k e^(m_k - m).
__global__ void ms_merge_kernel(const float* __restrict__ m_part,
                                const float* __restrict__ s_part,
                                float* __restrict__ m_out,
                                float* __restrict__ s_out, int N, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float m = NEG;
  for (int k = 0; k < splits; ++k) m = fmaxf(m, m_part[(size_t)k * N + row]);
  float s = 0.0f;
  for (int k = 0; k < splits; ++k)
    s += s_part[(size_t)k * N + row] * expf(m_part[(size_t)k * N + row] - m);
  m_out[row] = m;
  s_out[row] = s;
}

// ------------------------------------------------------------ backward dh

size_t dh_smem(int D) {
  D = D < KW ? D : KW;
  return (size_t)H_TR * (D + 8) * 2 + (size_t)D * (H_TV + 8) * 2 +
         (size_t)H_TR * (H_TV + 8) * 2 + (H_TV + 4 * H_TR) * sizeof(float);
}

// grid.z: the 512-wide slice of dh's columns a block writes.  Two blocks
// an SM (the wrapper's plan, _DH_TILE): at most 128 registers a thread.
__global__ void __launch_bounds__(THREADS, 2)
ce_bwd_dh_kernel(const bf16* __restrict__ h, const bf16* __restrict__ W,
                 const float* __restrict__ bias, const int* __restrict__ y,
                 const float* __restrict__ ga, const float* __restrict__ gb,
                 const float* __restrict__ lse, float* __restrict__ dh_part,
                 int N, int D, int V, int ldw_g, int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nkc = n_chunks(D), DC = min(D, KW), z = blockIdx.z;
  const int lda = DC + 8, ldw = H_TV + 8, ldg = H_TV + 8;
  bf16* sA = reinterpret_cast<bf16*>(smem);               // [H_TR][lda]  h rows
  bf16* sW = sA + H_TR * lda;                              // [DC][ldw]    W tile
  bf16* sG = sW + DC * ldw;                                // [H_TR][ldg]  gp
  float* sBias = reinterpret_cast<float*>(sG + H_TR * ldg);  // [H_TV]
  float* sGa = sBias + H_TV;                               // [H_TR] each
  float* sGb = sGa + H_TR;
  float* sLse = sGb + H_TR;
  int* sY = reinterpret_cast<int*>(sLse + H_TR);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;
  // logits: 2 x 4 warps of 16 rows x 16 columns; dh: warp owns 1/8 of the
  // slice's columns
  const int wm = warp >> 2, wn = warp & 3;
  const int nt = chunk_width(D, z) / 64;  // n8 tiles of dh per warp (2, 4, 6 or 8)
  const int dcol0 = warp * nt * 8;
  const int row0 = blockIdx.x * H_TR;
  const int n_tiles = (V + H_TV - 1) / H_TV;
  const int vt_begin = blockIdx.y * tiles_per_split;
  const int vt_end = min(vt_begin + tiles_per_split, n_tiles);

  if (nkc == 1) stage_rows(sA, lda, h, D, row0, H_TR, N, D);  // resident
  stage_row_terms(sY, sGa, sGb, sLse, y, ga, gb, lse, row0, H_TR, N);

  float acc[2][8][4];  // dh [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  for (int vt = vt_begin; vt < vt_end; ++vt) {
    __syncthreads();  // previous tile's W and gp consumed
    const int n0 = vt * H_TV;
    for (int i = tid; i < H_TV; i += THREADS) sBias[i] = n0 + i < V ? bias[n0 + i] : 0.0f;

    // ---- recompute the tile's logits, chunk by chunk (z's chunk last) ----
    float lg[2][4];
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) lg[ni][e] = 0.0f;
    for (int i = 0; i < nkc; ++i) {
      const int c = chunk_at(i, z, nkc), kw = chunk_width(D, c);
      if (i > 0) __syncthreads();  // the previous chunk consumed
      if (nkc > 1) stage_rows(sA, lda, h + c * KW, D, row0, H_TR, N, kw);
      stage_cols(sW, ldw, W + (size_t)c * KW * ldw_g, n0, H_TV, kw, ldw_g);
      __syncthreads();
      for (int k0 = 0; k0 < kw; k0 += 16) {
        uint32_t a[4], b0, b1, b2, b3;
        jlm::ldsm_x4(a[0], a[1], a[2], a[3],
                     sA + (wm * 16 + (mat & 1) * 8 + mr) * lda + k0 + (mat >> 1) * 8);
        jlm::ldsm_x4_trans(b0, b1, b2, b3,
                           sW + (k0 + (mat & 1) * 8 + mr) * ldw + wn * 16 + (mat >> 1) * 8);
        jlm::mma_bf16(lg[0], a, b0, b1);
        jlm::mma_bf16(lg[1], a, b2, b3);
      }
    }

    // ---- gp = ga * exp(l - lse) + gb * onehot(y), staged as bf16 ----
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = wm * 16 + half * 8 + gid;
        const int cl = wn * 16 + ni * 8 + tig * 2;
        float g[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + cl + e;
          g[e] = 0.0f;
          if (n < V && row0 + rl < N) {
            const float p = expf(lg[ni][half * 2 + e] + sBias[cl + e] - sLse[rl]);
            g[e] = sGa[rl] * p + (n == sY[rl] ? sGb[rl] : 0.0f);
          }
        }
        *reinterpret_cast<uint32_t*>(sG + rl * ldg + cl) = pack_bf16(g[0], g[1]);
      }
    __syncthreads();

    // ---- dh[:, warp's columns of slice z] += gp @ W_tile^T (sW: chunk z) ----
#pragma unroll
    for (int ks = 0; ks < H_TV; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        jlm::ldsm_x4(a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                     sG + (mi * 16 + (mat & 1) * 8 + mr) * ldg + ks + (mat >> 1) * 8);
#pragma unroll
      for (int nj = 0; nj < 8; nj += 2) {
        if (nj < nt) {
          uint32_t b0, b1, b2, b3;
          const int n = dcol0 + nj * 8 + (mat >> 1) * 8 + mr;
          jlm::ldsm_x4(b0, b1, b2, b3, sW + n * ldw + ks + (mat & 1) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            jlm::mma_bf16(acc[mi][nj], a[mi], b0, b1);
            jlm::mma_bf16(acc[mi][nj + 1], a[mi], b2, b3);
          }
        }
      }
    }
  }

  float* out = dh_part + (size_t)blockIdx.y * N * D + z * KW;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + mi * 16 + half * 8 + gid;
        if (ni < nt && row < N)
          *reinterpret_cast<float2*>(out + (size_t)row * D + dcol0 + ni * 8 + tig * 2) =
              make_float2(acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]);
      }
}

// out[i] = sum_k part[k][i]
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, size_t count,
                                  int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * count + i];
    out[i] = s;
  }
}

// ------------------------------------------------------- backward dW, db

size_t dw_smem(int D) {
  D = D < KW ? D : KW;
  return (size_t)D * (W_TV + 8) * 2 + (size_t)W_TR * (D + 8) * 2 +
         (size_t)W_TR * (W_TV + 8) * 2 +
         (W_TV + 4 * W_TR + 4 * W_TV) * sizeof(float);
}

// grid.y: the 512-row slice of dW a block writes (slice 0 also writes db).
__global__ void __launch_bounds__(THREADS, 1)
ce_bwd_dw_kernel(const bf16* __restrict__ h, const bf16* __restrict__ W,
                 const float* __restrict__ bias, const int* __restrict__ y,
                 const float* __restrict__ ga, const float* __restrict__ gb,
                 const float* __restrict__ lse, float* __restrict__ dW,
                 float* __restrict__ db, int N, int D, int V, int ldw_g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nkc = n_chunks(D), DC = min(D, KW), z = blockIdx.y;
  const int ldw = W_TV + 8, lda = DC + 8, ldg = W_TV + 8;
  bf16* sW = reinterpret_cast<bf16*>(smem);               // [DC][ldw]    W columns
  bf16* sA = sW + DC * ldw;                                // [W_TR][lda]  h rows
  bf16* sG = sA + W_TR * lda;                              // [W_TR][ldg]  gp
  float* sBias = reinterpret_cast<float*>(sG + W_TR * ldg);  // [W_TV]
  float* sGa = sBias + W_TV;                               // [W_TR] each
  float* sGb = sGa + W_TR;
  float* sLse = sGb + W_TR;
  float* sDb = sLse + W_TR;                                // [4][W_TV]
  int* sY = reinterpret_cast<int*>(sDb + 4 * W_TV);        // [W_TR]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;
  // logits: 4 x 2 warps of 16 rows x 16 columns; dW: warp owns the m16
  // tiles warp, warp + 8, ... of the slice's rows
  const int wm = warp >> 1, wn = warp & 1;
  const int mt = chunk_width(D, z) / 16;
  const int n0 = blockIdx.x * W_TV;

  if (nkc == 1) stage_cols(sW, ldw, W, n0, W_TV, D, ldw_g);  // resident
  for (int i = tid; i < W_TV; i += THREADS) sBias[i] = n0 + i < V ? bias[n0 + i] : 0.0f;

  float acc[4][4][4];  // dW [m16 tile j][n8 tile][fragment]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][ni][e] = 0.0f;
  float dbacc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // [n8 tile][column]

  for (int r0 = 0; r0 < N; r0 += W_TR) {
    __syncthreads();  // previous chunk's rows and gp consumed
    stage_row_terms(sY, sGa, sGb, sLse, y, ga, gb, lse, r0, W_TR, N);

    // ---- recompute the chunk's logits [64, 32], K chunk by K chunk (z's last) ----
    float lg[2][4];
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) lg[ni][e] = 0.0f;
    for (int i = 0; i < nkc; ++i) {
      const int c = chunk_at(i, z, nkc), kw = chunk_width(D, c);
      if (i > 0) __syncthreads();  // the previous K chunk consumed
      stage_rows(sA, lda, h + c * KW, D, r0, W_TR, N, kw);
      if (nkc > 1) stage_cols(sW, ldw, W + (size_t)c * KW * ldw_g, n0, W_TV, kw, ldw_g);
      __syncthreads();
      for (int k0 = 0; k0 < kw; k0 += 16) {
        uint32_t a[4], b0, b1, b2, b3;
        jlm::ldsm_x4(a[0], a[1], a[2], a[3],
                     sA + (wm * 16 + (mat & 1) * 8 + mr) * lda + k0 + (mat >> 1) * 8);
        jlm::ldsm_x4_trans(b0, b1, b2, b3,
                           sW + (k0 + (mat & 1) * 8 + mr) * ldw + wn * 16 + (mat >> 1) * 8);
        jlm::mma_bf16(lg[0], a, b0, b1);
        jlm::mma_bf16(lg[1], a, b2, b3);
      }
    }

    // ---- gp, its fp32 column sums, and its bf16 copy ----
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = wm * 16 + half * 8 + gid;
        const int cl = wn * 16 + ni * 8 + tig * 2;
        float g[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + cl + e;
          g[e] = 0.0f;
          if (n < V && r0 + rl < N) {
            const float p = expf(lg[ni][half * 2 + e] + sBias[cl + e] - sLse[rl]);
            g[e] = sGa[rl] * p + (n == sY[rl] ? sGb[rl] : 0.0f);
          }
          dbacc[ni][e] += g[e];
        }
        *reinterpret_cast<uint32_t*>(sG + rl * ldg + cl) = pack_bf16(g[0], g[1]);
      }
    __syncthreads();

    // ---- dW[slice z] += h_chunk^T @ gp (sA: h's columns of chunk z) ----
#pragma unroll
    for (int ks = 0; ks < W_TR; ks += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int nj = 0; nj < 4; nj += 2)
        jlm::ldsm_x4_trans(b[nj][0], b[nj][1], b[nj + 1][0], b[nj + 1][1],
                           sG + (ks + (mat & 1) * 8 + mr) * ldg + nj * 8 + (mat >> 1) * 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = warp + 8 * j;
        if (t < mt) {
          uint32_t a[4];  // h^T tile [16 d][16 rows], read transposed from [row][d]
          jlm::ldsm_x4_trans(a[0], a[1], a[2], a[3],
                             sA + (ks + (mat >> 1) * 8 + mr) * lda + t * 16 + (mat & 1) * 8);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) jlm::mma_bf16(acc[j][ni], a, b[ni][0], b[ni][1]);
        }
      }
    }
  }

  // ---- db (slice 0): sum over the 8 row groups of a warp, then the 4 row warps ----
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off <= 16; off <<= 1)
        dbacc[ni][e] += __shfl_xor_sync(0xffffffffu, dbacc[ni][e], off);
  if (gid == 0) {
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) sDb[wm * W_TV + wn * 16 + ni * 8 + tig * 2 + e] = dbacc[ni][e];
  }
  __syncthreads();
  for (int c = tid; c < W_TV; c += THREADS) {
    if (z == 0 && n0 + c < V)
      db[n0 + c] = sDb[c] + sDb[W_TV + c] + sDb[2 * W_TV + c] + sDb[3 * W_TV + c];
  }

#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = warp + 8 * j;
        const int d = z * KW + t * 16 + half * 8 + gid;
        const int n = n0 + ni * 8 + tig * 2;  // even; n + 1 < ldw_g
        if (t < mt && n < V)
          *reinterpret_cast<float2*>(dW + (size_t)d * ldw_g + n) =
              make_float2(acc[j][ni][half * 2], acc[j][ni][half * 2 + 1]);
      }
}

// ---------------------------------------------------------- fp32 compute

constexpr int G_R = 64, G_V = 64, G_K = 32;  // ce_fwd_f32: rows, columns, K stage
constexpr int GH_R = 32, GH_V = 64;          // ce_bwd_dh_f32: rows, tile columns
constexpr int GW_R = 32, GW_V = 32;          // ce_bwd_dw_f32: row chunk, columns
constexpr int MAX_DJ = 8;                    // D / 64 at D = 512

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Columns [0, width) of rows [row0, row0 + rows) of h [N, hld] fp32 -> s
// [rows][ld], zero past N.
__device__ __forceinline__ void stage_rows_f32(float* s, int ld, const float* h, int hld,
                                               int row0, int rows, int N, int width) {
  const int q = width / 4;
  for (int i = threadIdx.x; i < rows * q; i += THREADS) {
    const int r = i / q, kq = i % q, row = row0 + r;
    *reinterpret_cast<float4*>(s + r * ld + 4 * kq) =
        row < N ? ld4(h + (size_t)row * hld + 4 * kq) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Columns [n0, n0 + cols) of rows [0, depth) of W [., V] fp32 -> s [cols][ld]
// (transposed), zero past V.
__device__ __forceinline__ void stage_cols_t_f32(float* s, int ld, const float* W, int n0,
                                                 int cols, int depth, int V) {
  for (int i = threadIdx.x; i < depth * cols; i += THREADS) {
    const int k = i / cols, c = i % cols, n = n0 + c;
    s[c * ld + k] = n < V ? W[(size_t)k * V + n] : 0.0f;
  }
}

// gp of one logit: ga * exp(l - lse) + gb * onehot(y); 0 past N or V.
__device__ __forceinline__ float gp_of(float logit, int n, int V, bool row_ok,
                                       float ga, float gb, float lse, int y) {
  if (n >= V || !row_ok) return 0.0f;
  return ga * expf(logit - lse) + (n == y ? gb : 0.0f);
}

// Thread (ty, tx) of a 16 x 16 grid owns rows ty*4..ty*4+3 and columns
// tx*4..tx*4+3 of each 64 x 64 logits tile.
__global__ void __launch_bounds__(THREADS)
ce_fwd_f32_kernel(const float* __restrict__ h, const float* __restrict__ W,
                  const float* __restrict__ bias, const int* __restrict__ y,
                  float* __restrict__ m_part, float* __restrict__ s_part,
                  float* __restrict__ t_out, int N, int D, int V,
                  int tiles_per_split) {
  __shared__ __align__(16) float sA[G_K][G_R];  // [k][row]
  __shared__ __align__(16) float sB[G_K][G_V];  // [k][col]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int row0 = blockIdx.x * G_R;
  const int n_tiles = (V + G_V - 1) / G_V;
  const int vt_begin = blockIdx.y * tiles_per_split;
  const int vt_end = min(vt_begin + tiles_per_split, n_tiles);

  int yr[4];
  float m_run[4], s_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    yr[i] = row < N ? y[row] : -1;
    m_run[i] = NEG;
    s_run[i] = 0.0f;
  }
  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int n0 = vt * G_V;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < D; k0 += G_K) {
      __syncthreads();  // previous stage consumed
      for (int i = tid; i < G_R * G_K / 4; i += THREADS) {
        const int r = i % G_R, kq = i / G_R, row = row0 + r;
        const float4 v = row < N ? ld4(h + (size_t)row * D + k0 + 4 * kq)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        sA[4 * kq + 0][r] = v.x;
        sA[4 * kq + 1][r] = v.y;
        sA[4 * kq + 2][r] = v.z;
        sA[4 * kq + 3][r] = v.w;
      }
      for (int i = tid; i < G_K * G_V; i += THREADS) {
        const int k = i / G_V, c = i % G_V, n = n0 + c;
        sB[k][c] = n < V ? W[(size_t)(k0 + k) * V + n] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < G_K; ++k) {
        const float4 a = ld4(&sA[k][ty * 4]), b = ld4(&sB[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x[4], tmax = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        x[j] = n < V ? acc[i][j] + bias[n] : -INFINITY;
        if (n < V && n == yr[i]) t_out[row0 + ty * 4 + i] = x[j];  // the one match
        tmax = fmaxf(tmax, x[j]);
      }
      const float m_new = fmaxf(m_run[i], tmax);
      float s = s_run[i] * expf(m_run[i] - m_new);
#pragma unroll
      for (int j = 0; j < 4; ++j) s += expf(x[j] - m_new);
      m_run[i] = m_new;
      s_run[i] = s;
    }
  }

  // ---- merge the 16 column threads of each row group (one half-warp) ----
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 1; off <= 8; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m_run[i], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s_run[i], off);
      merge_ms(m_run[i], s_run[i], m2, s2);
    }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
      if (row < N) {
        m_part[(size_t)blockIdx.y * N + row] = m_run[i];
        s_part[(size_t)blockIdx.y * N + row] = s_run[i];
      }
    }
  }
}

size_t dh_f32_smem(int D) {
  D = D < KW ? D : KW;
  return ((size_t)(GH_R + GH_V) * (D + 4) + GH_R * (GH_V + 1) + GH_V + 4 * GH_R) *
         sizeof(float);
}

// Thread (ty, tx): logits of rows ty*2, ty*2+1 at columns tx + 16j (j < 4);
// dh of the same rows at columns tx*4 + 64jj + e (jj < 8, e < 4) of the
// 512-wide slice grid.z.
__global__ void __launch_bounds__(THREADS, 1)
ce_bwd_dh_f32_kernel(const float* __restrict__ h, const float* __restrict__ W,
                     const float* __restrict__ bias, const int* __restrict__ y,
                     const float* __restrict__ ga, const float* __restrict__ gb,
                     const float* __restrict__ lse, float* __restrict__ dh_part,
                     int N, int D, int V, int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nkc = n_chunks(D), z = blockIdx.z;
  const int ld = min(D, KW) + 4, ldg = GH_V + 1;
  float* sH = reinterpret_cast<float*>(smem);  // [GH_R][ld]   h rows
  float* sWT = sH + GH_R * ld;                 // [GH_V][ld]   W tile, transposed
  float* sG = sWT + GH_V * ld;                 // [GH_R][ldg]  gp
  float* sBias = sG + GH_R * ldg;              // [GH_V]
  float* sGa = sBias + GH_V;                   // [GH_R] each
  float* sGb = sGa + GH_R;
  float* sLse = sGb + GH_R;
  int* sY = reinterpret_cast<int*>(sLse + GH_R);

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nj = chunk_width(D, z) / 64;
  const int row0 = blockIdx.x * GH_R;
  const int n_tiles = (V + GH_V - 1) / GH_V;
  const int vt_begin = blockIdx.y * tiles_per_split;
  const int vt_end = min(vt_begin + tiles_per_split, n_tiles);

  if (nkc == 1) stage_rows_f32(sH, ld, h, D, row0, GH_R, N, D);  // resident
  stage_row_terms(sY, sGa, sGb, sLse, y, ga, gb, lse, row0, GH_R, N);

  float acc[2][MAX_DJ][4];  // dh [row][64-column group][column]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < MAX_DJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.0f;

  for (int vt = vt_begin; vt < vt_end; ++vt) {
    __syncthreads();  // previous tile's W and gp consumed (and rows staged)
    const int n0 = vt * GH_V;
    for (int i = tid; i < GH_V; i += THREADS) sBias[i] = n0 + i < V ? bias[n0 + i] : 0.0f;

    // ---- recompute the tile's logits, chunk by chunk (z's chunk last) ----
    float lg[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) lg[i][j] = 0.0f;
    for (int i = 0; i < nkc; ++i) {
      const int c = chunk_at(i, z, nkc), kw = chunk_width(D, c);
      if (i > 0) __syncthreads();  // the previous chunk consumed
      if (nkc > 1) stage_rows_f32(sH, ld, h + c * KW, D, row0, GH_R, N, kw);
      stage_cols_t_f32(sWT, ld, W + (size_t)c * KW * V, n0, GH_V, kw, V);
      __syncthreads();
      for (int k = 0; k < kw; k += 4) {
        const float4 a0 = ld4(sH + (ty * 2) * ld + k), a1 = ld4(sH + (ty * 2 + 1) * ld + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 b = ld4(sWT + (tx + 16 * j) * ld + k);
          lg[0][j] = dot4(lg[0][j], a0, b);
          lg[1][j] = dot4(lg[1][j], a1, b);
        }
      }
    }

    // ---- gp = ga * exp(l - lse) + gb * onehot(y), kept in fp32 ----
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rl = ty * 2 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        sG[rl * ldg + cl] = gp_of(lg[i][j] + sBias[cl], n0 + cl, V, row0 + rl < N,
                                  sGa[rl], sGb[rl], sLse[rl], sY[rl]);
      }
    }
    __syncthreads();

    // ---- dh[rows, slice z] += gp @ W_tile^T (sWT: chunk z) ----
    for (int n = 0; n < GH_V; ++n) {
      const float g0 = sG[(ty * 2) * ldg + n], g1 = sG[(ty * 2 + 1) * ldg + n];
#pragma unroll
      for (int jj = 0; jj < MAX_DJ; ++jj) {
        if (jj < nj) {
          const float4 w = ld4(sWT + n * ld + tx * 4 + 64 * jj);
          acc[0][jj][0] = fmaf(g0, w.x, acc[0][jj][0]);
          acc[0][jj][1] = fmaf(g0, w.y, acc[0][jj][1]);
          acc[0][jj][2] = fmaf(g0, w.z, acc[0][jj][2]);
          acc[0][jj][3] = fmaf(g0, w.w, acc[0][jj][3]);
          acc[1][jj][0] = fmaf(g1, w.x, acc[1][jj][0]);
          acc[1][jj][1] = fmaf(g1, w.y, acc[1][jj][1]);
          acc[1][jj][2] = fmaf(g1, w.z, acc[1][jj][2]);
          acc[1][jj][3] = fmaf(g1, w.w, acc[1][jj][3]);
        }
      }
    }
  }

  float* out = dh_part + (size_t)blockIdx.y * N * D + z * KW;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + ty * 2 + i;
#pragma unroll
    for (int jj = 0; jj < MAX_DJ; ++jj)
      if (jj < nj && row < N)
        *reinterpret_cast<float4*>(out + (size_t)row * D + tx * 4 + 64 * jj) =
            make_float4(acc[i][jj][0], acc[i][jj][1], acc[i][jj][2], acc[i][jj][3]);
  }
}

size_t dw_f32_smem(int D) {
  D = D < KW ? D : KW;
  return ((size_t)(GW_V + GW_R) * (D + 4) + GW_R * (GW_V + 2) + GW_V + 4 * GW_R +
          16 * GW_V) * sizeof(float);
}

// Thread (ty, tx): logits of chunk rows ty*2, ty*2+1 at columns tx + 16j
// (j < 2), whose gp it sums into db; dW at columns tx*2, tx*2+1 and rows
// ty*4 + 64jj + e (jj < 8, e < 4) of the 512-row slice grid.y.
__global__ void __launch_bounds__(THREADS, 1)
ce_bwd_dw_f32_kernel(const float* __restrict__ h, const float* __restrict__ W,
                     const float* __restrict__ bias, const int* __restrict__ y,
                     const float* __restrict__ ga, const float* __restrict__ gb,
                     const float* __restrict__ lse, float* __restrict__ dW,
                     float* __restrict__ db, int N, int D, int V) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nkc = n_chunks(D), z = blockIdx.y;
  const int ld = min(D, KW) + 4, ldg = GW_V + 2;
  float* sWT = reinterpret_cast<float*>(smem);  // [GW_V][ld]   W columns, transposed
  float* sH = sWT + GW_V * ld;                  // [GW_R][ld]   h rows
  float* sG = sH + GW_R * ld;                   // [GW_R][ldg]  gp
  float* sBias = sG + GW_R * ldg;               // [GW_V]
  float* sGa = sBias + GW_V;                    // [GW_R] each
  float* sGb = sGa + GW_R;
  float* sLse = sGb + GW_R;
  float* sDb = sLse + GW_R;                     // [16][GW_V]
  int* sY = reinterpret_cast<int*>(sDb + 16 * GW_V);

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nj = chunk_width(D, z) / 64;
  const int n0 = blockIdx.x * GW_V;

  if (nkc == 1) stage_cols_t_f32(sWT, ld, W, n0, GW_V, D, V);  // resident
  for (int i = tid; i < GW_V; i += THREADS) sBias[i] = n0 + i < V ? bias[n0 + i] : 0.0f;

  float acc[MAX_DJ][4][2];  // dW [64-row group][row][column]
#pragma unroll
  for (int jj = 0; jj < MAX_DJ; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jj][e][0] = acc[jj][e][1] = 0.0f;
  float dbacc[2] = {0.0f, 0.0f};  // columns tx, tx + 16

  for (int r0 = 0; r0 < N; r0 += GW_R) {
    __syncthreads();  // previous chunk's rows and gp consumed
    stage_row_terms(sY, sGa, sGb, sLse, y, ga, gb, lse, r0, GW_R, N);

    // ---- recompute the chunk's logits [32, 32], K chunk by K chunk (z's last) ----
    float lg[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    for (int i = 0; i < nkc; ++i) {
      const int c = chunk_at(i, z, nkc), kw = chunk_width(D, c);
      if (i > 0) __syncthreads();  // the previous K chunk consumed
      stage_rows_f32(sH, ld, h + c * KW, D, r0, GW_R, N, kw);
      if (nkc > 1) stage_cols_t_f32(sWT, ld, W + (size_t)c * KW * V, n0, GW_V, kw, V);
      __syncthreads();
      for (int k = 0; k < kw; k += 4) {
        const float4 a0 = ld4(sH + (ty * 2) * ld + k), a1 = ld4(sH + (ty * 2 + 1) * ld + k);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 b = ld4(sWT + (tx + 16 * j) * ld + k);
          lg[0][j] = dot4(lg[0][j], a0, b);
          lg[1][j] = dot4(lg[1][j], a1, b);
        }
      }
    }

    // ---- gp in fp32, its column sums ----
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rl = ty * 2 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int cl = tx + 16 * j;
        const float g = gp_of(lg[i][j] + sBias[cl], n0 + cl, V, r0 + rl < N, sGa[rl],
                              sGb[rl], sLse[rl], sY[rl]);
        sG[rl * ldg + cl] = g;
        dbacc[j] += g;
      }
    }
    __syncthreads();

    // ---- dW[slice z] += h_chunk^T @ gp (sH: h's columns of chunk z) ----
    for (int r = 0; r < GW_R; ++r) {
      const float2 g = *reinterpret_cast<const float2*>(sG + r * ldg + tx * 2);
#pragma unroll
      for (int jj = 0; jj < MAX_DJ; ++jj) {
        if (jj < nj) {
          const float4 a = ld4(sH + r * ld + ty * 4 + 64 * jj);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[jj][e][0] = fmaf(av[e], g.x, acc[jj][e][0]);
            acc[jj][e][1] = fmaf(av[e], g.y, acc[jj][e][1]);
          }
        }
      }
    }
  }

  // ---- db (slice 0): the 16 row threads of each column ----
#pragma unroll
  for (int j = 0; j < 2; ++j) sDb[ty * GW_V + tx + 16 * j] = dbacc[j];
  __syncthreads();
  for (int c = tid; c < GW_V; c += THREADS) {
    float s = 0.0f;
    for (int t = 0; t < 16; ++t) s += sDb[t * GW_V + c];
    if (z == 0 && n0 + c < V) db[n0 + c] = s;
  }
#pragma unroll
  for (int jj = 0; jj < MAX_DJ; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = z * KW + ty * 4 + 64 * jj + e;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = n0 + tx * 2 + q;
        if (jj < nj && n < V) dW[(size_t)d * V + n] = acc[jj][e][q];
      }
    }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

// h [N, D] bf16; W [D, ldw] bf16 (ldw >= V, a multiple of 8; columns >= V
// are masked); or, when f32, h [N, D] and W [D, V] fp32 (ldw == V); bias
// [V] fp32; y [N] int32 (a target outside [0, V) matches no column);
// m_part/s_part [splits, N] scratch; m_out/s_out [N]; t_out [N] must be
// zeroed by the caller (rows whose target is in range get their logit
// written).
int jlm_ce_fwd(const void* h, const void* W, const float* bias, const int* y,
               float* m_part, float* s_part, float* m_out, float* s_out,
               float* t_out, int N, int D, int V, int ldw, int f32, int splits,
               int tiles_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (f32) {
    dim3 grid((N + G_R - 1) / G_R, splits);
    ce_fwd_f32_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(h), static_cast<const float*>(W), bias, y, m_part,
        s_part, t_out, N, D, V, tiles_per_split);
  } else {
    const size_t smem = fwd_smem(D);
    err = set_smem(ce_fwd_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + F_TR - 1) / F_TR, splits);
    ce_fwd_kernel<<<grid, THREADS, smem, st>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(W), bias, y,
        m_part, s_part, t_out, N, D, V, ldw, tiles_per_split);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ms_merge_kernel<<<(N + 255) / 256, 256, 0, st>>>(m_part, s_part, m_out,
                                                   s_out, N, splits);
  return (int)cudaGetLastError();
}

// As jlm_ce_fwd, plus ga, gb, lse [N] fp32; dh_part [splits, N, D] fp32
// scratch (may equal dh when splits == 1); dh [N, D] fp32.  The grid is
// row blocks x splits x the 512-wide slices of D.
int jlm_ce_bwd_dh(const void* h, const void* W, const float* bias,
                  const int* y, const float* ga, const float* gb,
                  const float* lse, float* dh_part, float* dh, int N, int D,
                  int V, int ldw, int f32, int splits, int tiles_per_split,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (f32) {
    const size_t smem = dh_f32_smem(D);
    err = set_smem(ce_bwd_dh_f32_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + GH_R - 1) / GH_R, splits, (D + KW - 1) / KW);
    ce_bwd_dh_f32_kernel<<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(h), static_cast<const float*>(W), bias, y, ga, gb,
        lse, dh_part, N, D, V, tiles_per_split);
  } else {
    const size_t smem = dh_smem(D);
    err = set_smem(ce_bwd_dh_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + H_TR - 1) / H_TR, splits, (D + KW - 1) / KW);
    ce_bwd_dh_kernel<<<grid, THREADS, smem, st>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(W), bias, y, ga,
        gb, lse, dh_part, N, D, V, ldw, tiles_per_split);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t count = (size_t)N * D;
  const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  sum_splits_kernel<<<blocks, 256, 0, st>>>(dh_part, dh, count, splits);
  return (int)cudaGetLastError();
}

// As jlm_ce_bwd_dh; dW [D, ldw] and db [V] fp32, each element of the first V
// columns written once.  The grid is column blocks x the 512-row slices of D.
int jlm_ce_bwd_dw(const void* h, const void* W, const float* bias,
                  const int* y, const float* ga, const float* gb,
                  const float* lse, float* dW, float* db, int N, int D, int V,
                  int ldw, int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (f32) {
    const size_t smem = dw_f32_smem(D);
    err = set_smem(ce_bwd_dw_f32_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((V + GW_V - 1) / GW_V, (D + KW - 1) / KW);
    ce_bwd_dw_f32_kernel<<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(h), static_cast<const float*>(W), bias, y, ga, gb,
        lse, dW, db, N, D, V);
  } else {
    const size_t smem = dw_smem(D);
    err = set_smem(ce_bwd_dw_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((V + W_TV - 1) / W_TV, (D + KW - 1) / KW);
    ce_bwd_dw_kernel<<<grid, THREADS, smem, st>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(W), bias, y, ga,
        gb, lse, dW, db, N, D, V, ldw);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
