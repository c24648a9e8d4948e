// Vocab-tiled output projection with online logsumexp: per-row (m, s) or
// lse = m + log(s) of  logits = h @ W + b  over the full head.
//
// Replaces jlm_tpu/ops/project.py::_proj_kernel (LSE-only path, full head):
// the decode frame's normalizer, called once per frame on every beam row.
//
// Bound: compute.  At the main path's shapes (R = 20,480 beam rows,
// H = 512, V = 50,000) one call is 2*R*H*V = 1.05 TOP; the int8 head is
// 25.6 MB and stays in the 50 MB L2 while row blocks stream it, so device
// memory traffic is small.  Logits never leave registers.
//
// Design:
// - A block owns TR = 128 rows and loops over its share of the vocab in
//   tiles of TV = 64 columns (the TPU kernel's sequential vocab grid axis
//   becomes this loop).  The vocab is also split across blocks
//   (grid.y = splits) so that a small row count still fills the card; the
//   partial (m, s) of each split are merged by a second small kernel:
//   m_g = max_k m_k,  s_g = sum_k s_k * exp(m_k - m_g)  (project.py:436-440).
// - int8 mode (native int8 x int8 -> int32, ``int8_mxu``): each block
//   quantizes its rows once into shared memory exactly as project.py:83-89,
//   s = max(max|h|, 1e-30) / 127 (IEEE division), q = round-half-even(h / s),
//   then mma.sync m16n8k32 s8 accumulates exactly in int32 and the epilogue
//   rescales acc * s_row * scale_col + bias.  bf16 mode copies the rows and
//   runs mma.sync m16n8k16 with fp32 accumulation.
// - The head is read as its transposed copy W^T [V, H] (K contiguous), the
//   layout mma's col-major B operand wants; shared-memory rows are padded by
//   16 bytes so ldmatrix reads are free of bank conflicts.
// - 8 warps in a 4 x 2 grid, each a 32 x 32 tile of the block's 128 x 64
//   output tile.  Each thread keeps an online (m, s) for its 4 rows over its
//   columns; quads and the two column warps merge at the end.
// - The ragged vocab edge is masked (columns >= V contribute exp(-inf) = 0),
//   equivalent to the reference's -1e30 bias padding; m starts at -1e30.
// Simple first: no cp.async/TMA pipeline and no wgmma yet; two blocks share
// an SM in int8 mode so one block's loads overlap the other's math.
#include "common.cuh"

namespace {

constexpr int TR = 128;
constexpr int TV = 64;
constexpr int THREADS = 256;
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

size_t smem_bytes(bool int8, int H) {
  const int ld = H * (int8 ? 1 : 2) + 16;
  return (size_t)(TR + TV) * ld + (2 * TV + 3 * TR) * sizeof(float);
}

template <bool INT8>
__global__ void __launch_bounds__(THREADS, 2)
proj_ms_kernel(const void* __restrict__ h, int h_bf16,
               const void* __restrict__ wt, const float* __restrict__ scale,
               const float* __restrict__ bias, float* __restrict__ m_part,
               float* __restrict__ s_part, int R, int H, int V,
               int tiles_per_split) {
  using Acc = typename std::conditional<INT8, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kb = H * (INT8 ? 1 : 2);  // bytes per row
  const int ld = kb + 16;             // padded shared-memory row stride
  unsigned char* sA = smem;                              // [TR][ld]
  unsigned char* sB = sA + TR * ld;                      // [TV][ld]
  float* sScale = reinterpret_cast<float*>(sB + TV * ld);  // [TV]
  float* sBias = sScale + TV;                            // [TV]
  float* sHs = sBias + TV;                               // [TR] row scales
  float* sRed = sHs + TR;                                // [2][TR]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * TR;
  const int n_tiles = (V + TV - 1) / TV;
  const int vt_begin = blockIdx.y * tiles_per_split;
  const int vt_end = min(vt_begin + tiles_per_split, n_tiles);

  // ---- stage the block's activation rows ----
  if (INT8) {
    for (int r = warp; r < TR; r += THREADS / 32) {
      const int row = row0 + r;
      float amax = 0.0f;
      if (row < R)
        for (int k = lane; k < H; k += 32)
          amax = fmaxf(amax, fabsf(load_act(h, h_bf16, (size_t)row * H + k)));
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      const float s = fmaxf(amax, 1e-30f) / 127.0f;
      for (int k = lane; k < H; k += 32) {
        const float v = row < R ? load_act(h, h_bf16, (size_t)row * H + k) : 0.0f;
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
            static_cast<const unsigned char*>(h) + (size_t)row * kb + cc * 16);
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
    const int chunks = kb / 16;
    for (int i = tid; i < TV * chunks; i += THREADS) {
      const int r = i / chunks, cc = i % chunks, n = n0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (n < V)
        v = *reinterpret_cast<const uint4*>(
            static_cast<const unsigned char*>(wt) + (size_t)n * kb + cc * 16);
      *reinterpret_cast<uint4*>(sB + r * ld + cc * 16) = v;
    }
    for (int i = tid; i < TV; i += THREADS) {
      const int n = n0 + i;
      sScale[i] = (INT8 && n < V) ? scale[n] : 1.0f;
      sBias[i] = n < V ? bias[n] : 0.0f;
    }
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
          if constexpr (INT8)
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
        const float hs = INT8 ? sHs[rl] : 1.0f;
        float x[8];
        float tmax = NEG;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cl = wn * 32 + ni * 8 + tig * 2 + e;
            const Acc av = acc[mi][ni][half * 2 + e];
            float v;
            if constexpr (INT8)
              v = static_cast<float>(av) * hs * sScale[cl] + sBias[cl];
            else
              v = av + sBias[cl];
            if (n0 + cl >= V) v = -INFINITY;
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

// Second pass: merge the vocab splits of each row.  Any output may be null.
__global__ void lse_merge_kernel(const float* __restrict__ m_part,
                                 const float* __restrict__ s_part,
                                 float* __restrict__ m_out,
                                 float* __restrict__ s_out,
                                 float* __restrict__ lse_out, int R,
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
  if (lse_out) lse_out[row] = m + logf(s);
}

template <bool INT8>
cudaError_t launch(const void* h, int h_bf16, const void* wt,
                   const float* scale, const float* bias, float* m_part,
                   float* s_part, int R, int H, int V, int splits,
                   int tiles_per_split, cudaStream_t stream) {
  const size_t smem = smem_bytes(INT8, H);
  cudaError_t err = cudaFuncSetAttribute(
      proj_ms_kernel<INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((R + TR - 1) / TR, splits);
  proj_ms_kernel<INT8><<<grid, THREADS, smem, stream>>>(
      h, h_bf16, wt, scale, bias, m_part, s_part, R, H, V, tiles_per_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// h [R, H] (bf16, or fp32 when h_bf16 == 0 in int8 mode); wt [V, H] int8
// (w_int8) or bf16; scale [V] (int8 only); bias [V]; m_part/s_part
// [splits, R] scratch; m_out/s_out/lse_out [R] (each may be null).
int jlm_project_ms(const void* h, int h_bf16, const void* wt, int w_int8,
                   const float* scale, const float* bias, float* m_part,
                   float* s_part, float* m_out, float* s_out, float* lse_out,
                   int R, int H, int V, int splits, int tiles_per_split,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      w_int8 ? launch<true>(h, h_bf16, wt, scale, bias, m_part, s_part, R, H,
                            V, splits, tiles_per_split, st)
             : launch<false>(h, h_bf16, wt, scale, bias, m_part, s_part, R, H,
                             V, splits, tiles_per_split, st);
  if (err != cudaSuccess) return (int)err;
  lse_merge_kernel<<<(R + 255) / 256, 256, 0, st>>>(m_part, s_part, m_out,
                                                     s_out, lse_out, R, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
