// Vocab-tiled output projection with online logsumexp: per-row (m, s) or
// lse = m + log(s) of  logits = h @ W + b  over a full head or over the
// blocks of a D-softmax head.
//
// Replaces jlm_tpu/ops/project.py::_proj_kernel: the LSE-only path (the
// decode frame's normalizer, called once per frame on every beam row, once
// per D-softmax block) and, with the CAND template flag, candidate
// extraction (project_candidates*: log softmax(h @ W + b)[:, cand]).
//
// Bound: compute.  At the serving shapes (R = 20,480 beam rows) one call is
// 2*R*sum_k(d_k*s_k) operations: 1.05 TOP for the 50k full head (H = 512),
// 0.954 TOP for the 100k D-softmax head of BASELINE config 5 (blocks of
// 16,000 x 512, 34,000 x 256, 50,000 x 128).  The int8 heads (25.6 and
// 23.3 MB) stay in the 50 MB L2 while row blocks stream them, so device
// memory traffic is small.  Logits never leave registers.
//
// Design:
// - One launch per block of the head (a full head is one block).  A block
//   reads its hidden slice in place: h points at the slice's first column
//   and ldh is the row stride of the whole [R, H] activation, so the
//   D-softmax prefix h[:, :d_k] and a disjoint slice cost no copy.  Every
//   launch writes its vocab splits' partial (m, s) into one shared
//   [2, splits, R] buffer, and one merge launch combines splits and blocks:
//   m_g = max_k m_k,  s_g = sum_k s_k * exp(m_k - m_g)  (project.py:436-440).
// - Tensor-core modes: a block owns TR = 128 rows and loops over its share
//   of the vocab in tiles of TV = 64 columns (the TPU kernel's sequential
//   vocab grid axis becomes this loop); the vocab is also split across
//   blocks (grid.y = splits) so that a small row count still fills the card.
//   * int8 x int8 -> int32 (``int8_mxu``): each block quantizes its rows
//     once into shared memory exactly as project.py:83-89, over the BLOCK'S
//     OWN SLICE of h: s = max(max|h[:, slice]|, 1e-30) / 127 (IEEE
//     division), q = round-half-even(h / s); mma.sync m16n8k32 s8
//     accumulates exactly in int32 and the epilogue rescales
//     acc * s_row * scale_col + bias.
//   * bf16 weights: the rows are copied, mma.sync m16n8k16, fp32 accumulate.
//   * int8 dequant (``int8_mxu=False``, bf16 compute; project.py:114-119):
//     each int8 W^T row is staged and dequantized in shared memory to
//     bf16(q * scale_col), rounded once, before the product; then the bf16
//     path.  The dequant precedes the product; it is not a rescale after.
//   8 warps in a 4 x 2 grid, each a 32 x 32 tile of the block's 128 x 64
//   output tile; each thread keeps an online (m, s) for its 4 rows over its
//   columns; quads and the two column warps merge at the end.  The head is
//   read as its transposed copy W^T [V, d] (K contiguous), the layout mma's
//   col-major B operand wants; shared-memory rows are padded by 16 bytes so
//   ldmatrix reads are free of bank conflicts.
// - fp32 compute (fp32 weights, or int8 dequantized to fp32 in shared
//   memory): exact fp32 FMAs on the CUDA cores -- TF32 would round the
//   operands and break the parity mode.  A block owns FR = 64 rows; K
//   streams through shared memory in chunks of 32, transposed so that each
//   of the 256 threads reads float4s of 4 rows and 4 columns and keeps a
//   4 x 4 tile of logits; the online (m, s) is as above.
// - The ragged vocab edge is masked (columns >= V contribute exp(-inf) = 0),
//   equivalent to the reference's -1e30 bias padding; m starts at -1e30.
// - Candidate extraction (CAND, off for the lse-only calls): the wrapper
//   passes the candidate ids sorted (with their output slots).  Per vocab
//   tile, one thread per column binary-searches the run of candidates equal
//   to that column's global id (id_base + n; a D-softmax block's columns
//   are a range of global ids), and the epilogue stores each logit that a
//   candidate asks for -- the same fp32 value the online lse takes, from
//   the register that holds it -- into its [R, C] slot.  A column lies in
//   one tile of one split of one block, so each store is plain, with no
//   atomics and no sum, and repeated ids get one store each.  The merge
//   launch turns the raw logits into raw - (m + log s); an id that no
//   column matches keeps 0 (the caller zeroes the buffer) and gets -lse, as
//   the reference's one-hot product gives it.
// Simple first: no cp.async/TMA pipeline and no wgmma yet; two blocks share
// an SM in the tensor-core modes so one block's loads overlap the other's
// math.
#include "common.cuh"

namespace {

// Weight modes; the numbering is the wrapper's (ops/project.py).
enum Mode : int { kBf16 = 0, kInt8Mxu = 1, kDequantBf16 = 2, kFp32 = 3, kDequantFp32 = 4 };

constexpr int TR = 128;
constexpr int TV = 64;
constexpr int THREADS = 256;
constexpr int FR = 64;  // fp32 kernel: rows per block
constexpr int FV = 64;  //              vocab columns per tile
constexpr int FK = 32;  //              K per shared-memory stage
constexpr float NEG = -1e30f;

__device__ __forceinline__ void merge_ms(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ float load_act(const void* h, int h_bf16, size_t i) {
  return h_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(h)[i])
                : static_cast<const float*>(h)[i];
}

// Byte b (0..3) of a little-endian word, as a signed int8 value.
__device__ __forceinline__ float s8_at(uint32_t word, int b) {
  return static_cast<float>(static_cast<signed char>((word >> (8 * b)) & 0xffu));
}

// Bytes of one shared-memory row of K values (A and B alike).
__host__ __device__ constexpr int row_bytes(int mode, int D) {
  return D * (mode == kInt8Mxu ? 1 : 2);
}

size_t smem_bytes(int mode, int D, bool cand) {
  const int ld = row_bytes(mode, D) + 16;
  return (size_t)(TR + TV) * ld + (2 * TV + 3 * TR) * sizeof(float) +
         (cand ? 2 * TV * sizeof(int) : 0);
}

// Candidates of one launch: ids [C] sorted ascending with their output
// slots, the global id of the block's column 0, and out [R, C] fp32.
struct Cand {
  const int* ids;
  const int* slots;
  int C;
  int id_base;
  float* out;
};

// First index p in ids[0, C) with ids[p] >= v.
__device__ __forceinline__ int first_at_least(const int* ids, int C, int v) {
  int lo = 0, hi = C;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ids[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The candidate run [lo[i], hi[i]) of each column n0 + i of a tile (empty
// past V).
__device__ __forceinline__ void cand_table(int* lo, int* hi, const Cand& cd, int n0,
                                           int cols, int V) {
  for (int i = threadIdx.x; i < cols; i += THREADS) {
    const int n = n0 + i;
    int a = 0, b = 0;
    if (n < V) {
      a = first_at_least(cd.ids, cd.C, cd.id_base + n);
      b = first_at_least(cd.ids, cd.C, cd.id_base + n + 1);
    }
    lo[i] = a;
    hi[i] = b;
  }
}

// Store logit v of (row, column i of the tile) into every slot that asks
// for it.
__device__ __forceinline__ void cand_store(const Cand& cd, const int* lo, const int* hi,
                                           int i, int row, int R, float v) {
  if (row >= R) return;
  for (int p = lo[i]; p < hi[i]; ++p) cd.out[(size_t)row * cd.C + cd.slots[p]] = v;
}

template <int MODE, bool CAND>
__global__ void __launch_bounds__(THREADS, 2)
proj_ms_kernel(const void* __restrict__ h, int ldh, int h_bf16,
               const void* __restrict__ wt, const float* __restrict__ scale,
               const float* __restrict__ bias, float* __restrict__ m_part,
               float* __restrict__ s_part, int R, int D, int V,
               int tiles_per_split, Cand cd) {
  constexpr bool S8 = MODE == kInt8Mxu;
  using Acc = typename std::conditional<S8, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kb = row_bytes(MODE, D);  // bytes per shared row
  const int ld = kb + 16;             // padded shared-memory row stride
  unsigned char* sA = smem;                              // [TR][ld]
  unsigned char* sB = sA + TR * ld;                      // [TV][ld]
  float* sScale = reinterpret_cast<float*>(sB + TV * ld);  // [TV]
  float* sBias = sScale + TV;                            // [TV]
  float* sHs = sBias + TV;                               // [TR] row scales
  float* sRed = sHs + TR;                                // [2][TR]
  int* sLo = reinterpret_cast<int*>(sRed + 2 * TR);      // [TV] (CAND)
  int* sHi = sLo + TV;                                   // [TV] (CAND)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * TR;
  const int n_tiles = (V + TV - 1) / TV;
  const int vt_begin = blockIdx.y * tiles_per_split;
  const int vt_end = min(vt_begin + tiles_per_split, n_tiles);

  // ---- stage the block's activation rows (its slice of h) ----
  if constexpr (S8) {
    for (int r = warp; r < TR; r += THREADS / 32) {
      const int row = row0 + r;
      float amax = 0.0f;
      if (row < R)
        for (int k = lane; k < D; k += 32)
          amax = fmaxf(amax, fabsf(load_act(h, h_bf16, (size_t)row * ldh + k)));
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      const float s = fmaxf(amax, 1e-30f) / 127.0f;
      for (int k = lane; k < D; k += 32) {
        const float v = row < R ? load_act(h, h_bf16, (size_t)row * ldh + k) : 0.0f;
        sA[r * ld + k] = static_cast<unsigned char>(
            static_cast<signed char>(__float2int_rn(v / s)));
      }
      if (lane == 0) sHs[r] = s;
    }
  } else {
    const int chunks = kb / 16;
    for (int i = tid; i < TR * chunks; i += THREADS) {
      const int r = i / chunks, cc = i % chunks, row = row0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < R)
        v = *reinterpret_cast<const uint4*>(
            static_cast<const unsigned char*>(h) + (size_t)row * ldh * 2 + cc * 16);
      *reinterpret_cast<uint4*>(sA + r * ld + cc * 16) = v;
    }
  }

  float m_run[4], s_run[4];  // rows wm*32 + mi*16 + half*8 + gid, idx mi*2+half
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG;
    s_run[i] = 0.0f;
  }

  const int mat = lane >> 3, mr = lane & 7;
  for (int vt = vt_begin; vt < vt_end; ++vt) {
    __syncthreads();  // previous tile fully consumed (and rows staged)
    const int n0 = vt * TV;
    if constexpr (MODE == kDequantBf16) {
      // int8 W^T rows, 16 values a chunk, to bf16(q * scale) in shared memory
      const int chunks = D / 16;
      for (int i = tid; i < TV * chunks; i += THREADS) {
        const int r = i / chunks, cc = i % chunks, n = n0 + r;
        uint4 q = make_uint4(0, 0, 0, 0);
        float sc = 0.0f;
        if (n < V) {
          q = *reinterpret_cast<const uint4*>(
              static_cast<const signed char*>(wt) + (size_t)n * D + cc * 16);
          sc = scale[n];
        }
        const uint32_t words[4] = {q.x, q.y, q.z, q.w};
        uint32_t w[8];  // 16 bf16, two to a word, in K order
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t word = words[e >> 1];
          const int b = (e & 1) * 2;
          const __nv_bfloat162 p = __floats2bfloat162_rn(
              s8_at(word, b) * sc, s8_at(word, b + 1) * sc);
          w[e] = *reinterpret_cast<const uint32_t*>(&p);
        }
        uint4* dst = reinterpret_cast<uint4*>(sB + r * ld + cc * 32);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
    } else {
      const int chunks = kb / 16;
      for (int i = tid; i < TV * chunks; i += THREADS) {
        const int r = i / chunks, cc = i % chunks, n = n0 + r;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (n < V)
          v = *reinterpret_cast<const uint4*>(
              static_cast<const unsigned char*>(wt) + (size_t)n * kb + cc * 16);
        *reinterpret_cast<uint4*>(sB + r * ld + cc * 16) = v;
      }
    }
    for (int i = tid; i < TV; i += THREADS) {
      const int n = n0 + i;
      sScale[i] = (S8 && n < V) ? scale[n] : 1.0f;
      sBias[i] = n < V ? bias[n] : 0.0f;
    }
    if constexpr (CAND) cand_table(sLo, sHi, cd, n0, TV, V);
    __syncthreads();

    Acc acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

    for (int kk = 0; kk < kb; kk += 32) {  // 32 bytes = one mma depth
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + (mat & 1) * 8 + mr;
        jlm::ldsm_x4(a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                sA + r * ld + kk + (mat >> 1) * 16);
      }
#pragma unroll
      for (int nj = 0; nj < 4; nj += 2) {
        const int n = wn * 32 + nj * 8 + (mat >> 1) * 8 + mr;
        jlm::ldsm_x4(b[nj][0], b[nj][1], b[nj + 1][0], b[nj + 1][1],
                sB + n * ld + kk + (mat & 1) * 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if constexpr (S8)
            jlm::mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
          else
            jlm::mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
        }
    }

    // ---- epilogue: logits in registers -> online (m, s) per row ----
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = wm * 32 + mi * 16 + half * 8 + gid;
        const float hs = S8 ? sHs[rl] : 1.0f;
        float x[8];
        float tmax = NEG;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = wn * 32 + ni * 8 + tig * 2 + e;
            const Acc av = acc[mi][ni][half * 2 + e];
            float v;
            if constexpr (S8)
              v = static_cast<float>(av) * hs * sScale[cl] + sBias[cl];
            else
              v = av + sBias[cl];
            if (n0 + cl >= V) v = -INFINITY;
            if constexpr (CAND) cand_store(cd, sLo, sHi, cl, row0 + rl, R, v);
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
  if (wn == 1 && tig == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = wm * 32 + (i >> 1) * 16 + (i & 1) * 8 + gid;
      sRed[rl] = m_run[i];
      sRed[TR + rl] = s_run[i];
    }
  }
  __syncthreads();
  if (wn == 0 && tig == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = wm * 32 + (i >> 1) * 16 + (i & 1) * 8 + gid;
      const int row = row0 + rl;
      float m = m_run[i], s = s_run[i];
      merge_ms(m, s, sRed[rl], sRed[TR + rl]);
      if (row < R) {
        m_part[(size_t)blockIdx.y * R + row] = m;
        s_part[(size_t)blockIdx.y * R + row] = s;
      }
    }
  }
}

// fp32 compute: h fp32 [R, ldh] (its slice), W^T fp32 [V, D] or int8 [V, D]
// with per-row (vocab) scales dequantized in shared memory (Q8).  Thread
// (ty, tx) of a 16 x 16 grid owns rows ty*4..ty*4+3 and columns
// tx*4..tx*4+3 of each 64 x 64 tile.
template <bool Q8, bool CAND>
__global__ void __launch_bounds__(THREADS)
proj_ms_f32_kernel(const float* __restrict__ h, int ldh,
                   const void* __restrict__ wt, const float* __restrict__ scale,
                   const float* __restrict__ bias, float* __restrict__ m_part,
                   float* __restrict__ s_part, int R, int D, int V,
                   int tiles_per_split, Cand cd) {
  __shared__ __align__(16) float sA[FK][FR];  // [k][row]
  __shared__ __align__(16) float sB[FK][FV];  // [k][col]
  __shared__ int sLo[CAND ? FV : 1], sHi[CAND ? FV : 1];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int row0 = blockIdx.x * FR;
  const int n_tiles = (V + FV - 1) / FV;
  const int vt_begin = blockIdx.y * tiles_per_split;
  const int vt_end = min(vt_begin + tiles_per_split, n_tiles);

  float m_run[4], s_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG;
    s_run[i] = 0.0f;
  }
  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int n0 = vt * FV;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < D; k0 += FK) {
      __syncthreads();  // previous stage consumed
      for (int i = tid; i < FR * FK / 4; i += THREADS) {
        const int r = i % FR, kq = i / FR, row = row0 + r;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < R)
          v = *reinterpret_cast<const float4*>(h + (size_t)row * ldh + k0 + 4 * kq);
        sA[4 * kq + 0][r] = v.x;
        sA[4 * kq + 1][r] = v.y;
        sA[4 * kq + 2][r] = v.z;
        sA[4 * kq + 3][r] = v.w;
      }
      for (int i = tid; i < FV * FK / 4; i += THREADS) {
        const int c = i % FV, kq = i / FV, n = n0 + c;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n < V) {
          const size_t off = (size_t)n * D + k0 + 4 * kq;
          if constexpr (Q8) {
            const char4 q = *reinterpret_cast<const char4*>(
                static_cast<const signed char*>(wt) + off);
            const float sc = scale[n];
            v = make_float4(static_cast<float>(q.x) * sc, static_cast<float>(q.y) * sc,
                            static_cast<float>(q.z) * sc, static_cast<float>(q.w) * sc);
          } else {
            v = *reinterpret_cast<const float4*>(static_cast<const float*>(wt) + off);
          }
        }
        sB[4 * kq + 0][c] = v.x;
        sB[4 * kq + 1][c] = v.y;
        sB[4 * kq + 2][c] = v.z;
        sB[4 * kq + 3][c] = v.w;
      }
      // between this chunk's two barriers: every thread has left the
      // previous tile's epilogue, which read the table
      if constexpr (CAND) {
        if (k0 == 0) cand_table(sLo, sHi, cd, n0, FV, V);
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < FK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&sA[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&sB[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    float bj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      bj[j] = n < V ? bias[n] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x[4], tmax = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = n0 + tx * 4 + j < V ? acc[i][j] + bj[j] : -INFINITY;
        if constexpr (CAND) cand_store(cd, sLo, sHi, tx * 4 + j, row0 + ty * 4 + i, R, x[j]);
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
      if (row < R) {
        m_part[(size_t)blockIdx.y * R + row] = m_run[i];
        s_part[(size_t)blockIdx.y * R + row] = s_run[i];
      }
    }
  }
}

// Second pass: merge the vocab splits (of every block) of each row.  Any
// output may be null; cand [R, C] raw candidate logits become
// raw - (m + log s).
__global__ void lse_merge_kernel(const float* __restrict__ m_part,
                                 const float* __restrict__ s_part,
                                 float* __restrict__ m_out,
                                 float* __restrict__ s_out,
                                 float* __restrict__ lse_out,
                                 float* __restrict__ cand, int C, int R,
                                 int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  float m = NEG;
  for (int k = 0; k < splits; ++k) m = fmaxf(m, m_part[(size_t)k * R + row]);
  float s = 0.0f;
  for (int k = 0; k < splits; ++k)
    s += s_part[(size_t)k * R + row] * expf(m_part[(size_t)k * R + row] - m);
  if (m_out) m_out[row] = m;
  if (s_out) s_out[row] = s;
  const float lse = m + logf(s);
  if (lse_out) lse_out[row] = lse;
  if (cand)
    for (int j = 0; j < C; ++j) cand[(size_t)row * C + j] -= lse;
}

template <int MODE, bool CAND>
cudaError_t launch_tc(const void* h, int ldh, int h_bf16, const void* wt,
                      const float* scale, const float* bias, float* m_part,
                      float* s_part, int R, int D, int V, int splits,
                      int tiles_per_split, const Cand& cd, cudaStream_t stream) {
  const size_t smem = smem_bytes(MODE, D, CAND);
  cudaError_t err = cudaFuncSetAttribute(
      proj_ms_kernel<MODE, CAND>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((R + TR - 1) / TR, splits);
  proj_ms_kernel<MODE, CAND><<<grid, THREADS, smem, stream>>>(
      h, ldh, h_bf16, wt, scale, bias, m_part, s_part, R, D, V, tiles_per_split, cd);
  return cudaGetLastError();
}

template <bool Q8, bool CAND>
cudaError_t launch_f32(const void* h, int ldh, const void* wt, const float* scale,
                       const float* bias, float* m_part, float* s_part, int R,
                       int D, int V, int splits, int tiles_per_split,
                       const Cand& cd, cudaStream_t stream) {
  dim3 grid((R + FR - 1) / FR, splits);
  proj_ms_f32_kernel<Q8, CAND><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(h), ldh, wt, scale, bias, m_part, s_part, R, D,
      V, tiles_per_split, cd);
  return cudaGetLastError();
}

template <bool CAND>
cudaError_t launch_mode(const void* h, int ldh, int h_bf16, const void* wt, int mode,
                        const float* scale, const float* bias, float* m_part,
                        float* s_part, int R, int D, int V, int splits,
                        int tiles_per_split, const Cand& cd, cudaStream_t st) {
  switch (mode) {
    case kBf16:
      return launch_tc<kBf16, CAND>(h, ldh, 1, wt, scale, bias, m_part, s_part, R, D,
                                    V, splits, tiles_per_split, cd, st);
    case kInt8Mxu:
      return launch_tc<kInt8Mxu, CAND>(h, ldh, h_bf16, wt, scale, bias, m_part, s_part,
                                       R, D, V, splits, tiles_per_split, cd, st);
    case kDequantBf16:
      return launch_tc<kDequantBf16, CAND>(h, ldh, 1, wt, scale, bias, m_part, s_part,
                                           R, D, V, splits, tiles_per_split, cd, st);
    case kFp32:
      return launch_f32<false, CAND>(h, ldh, wt, scale, bias, m_part, s_part, R, D, V,
                                     splits, tiles_per_split, cd, st);
    case kDequantFp32:
      return launch_f32<true, CAND>(h, ldh, wt, scale, bias, m_part, s_part, R, D, V,
                                    splits, tiles_per_split, cd, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One block of the head.  h: the block's first activation column; row
// stride ldh elements; bf16, or fp32 (fp32 modes; int8 mode takes either,
// h_bf16 says which).  wt [V, D] W^T: bf16 (mode 0), int8 (modes 1, 2, 4)
// or fp32 (mode 3); scale [V] (int8 modes); bias [V] fp32; m_part/s_part
// point at this block's first split of [splits_total, R] scratch.
// Candidate extraction when cand_ids is not null: cand_ids [C] sorted
// ascending, cand_slots [C] their columns in cand_out [R, C] fp32, id_base
// the global id of this block's column 0.
int jlm_project_block(const void* h, int ldh, int h_bf16, const void* wt,
                      int mode, const float* scale, const float* bias,
                      float* m_part, float* s_part, int R, int D, int V,
                      int splits, int tiles_per_split, const int* cand_ids,
                      const int* cand_slots, int C, int id_base, float* cand_out,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Cand cd{cand_ids, cand_slots, C, id_base, cand_out};
  if (cand_ids)
    return (int)launch_mode<true>(h, ldh, h_bf16, wt, mode, scale, bias, m_part, s_part,
                                  R, D, V, splits, tiles_per_split, cd, st);
  return (int)launch_mode<false>(h, ldh, h_bf16, wt, mode, scale, bias, m_part, s_part,
                                 R, D, V, splits, tiles_per_split, cd, st);
}

// Merge [splits, R] partials into m_out/s_out/lse_out [R] (each may be
// null); cand [R, C] (or null) goes from raw logits to log-probs.
int jlm_project_merge(const float* m_part, const float* s_part, float* m_out,
                      float* s_out, float* lse_out, float* cand, int C, int R,
                      int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lse_merge_kernel<<<(R + 255) / 256, 256, 0, st>>>(m_part, s_part, m_out, s_out,
                                                     lse_out, cand, C, R, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
