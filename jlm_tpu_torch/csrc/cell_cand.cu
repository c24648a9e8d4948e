// Fused decode-frame row step: the LSTM cell and the per-sentence candidate
// dots in one launch,
//   z = x @ W[:E] + h @ W[E:] + b  (fp32 accumulate), gates i, j, f, o;
//   c' = sigmoid(f + forget_bias) * c + sigmoid(i) * tanh(j)
//   h' = sigmoid(o) * tanh(c')
//   cand[s] = h'[s] @ cols[s]^T + cbias[s]   (fp32 accumulate)
// with x, h, W, cols and h' in the compute dtype (bf16, or fp32), c bf16 or
// fp32, c' fp32; the dots read h' rounded to the compute dtype.
//
// Replaces jlm_tpu/ops/frame_step.py::_cell_cand_kernel (bf16 and fp32
// compute).
// The reference engine keeps the split cell + cand_dot frame (its kernel 9
// lost 5.28 to 5.00 ms/frame on the TPU); here it is reached through
// make_fused_frame_forward.
//
// Bound: device memory.  At the serving frame (S = 2,048 sentences of
// B = 10 rows, E = 256, H = 512, C1 = 65) the cell is 64 GFLOP and the
// candidate dots 1.4, against ~261 MB of x, h, c (bf16) in, c', h', the
// candidate logits out and the 136 MB of cols: ~0.078 ms at 3.35 TB/s.
// The candidate dots read h' from shared memory, so h' makes no
// device-memory round trip between the cell and the dots.
//
// Design:
// - The dots need whole h' rows of a sentence, so a block owns whole
//   sentences: G = 64 / B of them (6 at B = 10: 60 of its 64 row slots)
//   and all H units.  It loops over chunks of TJ = 64 units; for each it
//   computes the columns of those units in all four gates, streaming K
//   (x for k < E, then h) and W through shared memory in chunks of 32 --
//   the fused W (3 MB of bf16 at E = 256, H = 512) is far beyond shared
//   memory, so it streams from the L2 as in lstm_cell.cu.  mma.sync
//   m16n8k16 bf16 -> fp32; 8 warps in a 2 x 4 grid, a warp owns 32 rows x
//   (4 gates x 16 units), so each thread holds all four gates of its units
//   and the cell runs in registers (lstm_cell.cu's epilogue).
// - The epilogue writes c' (fp32) and h' (bf16) to device memory and h',
//   rounded to bf16 -- the value the split path's cand_dot reads -- into a
//   [64, H] shared-memory buffer (66 KB at H = 512).
// - Then cand_dot.cu's dot: each warp takes (sentence, candidate) pairs;
//   its lanes read the candidate's cols row once with coalesced vector
//   loads, keep B fp32 partial dots against h' in shared memory, and
//   reduce them with shuffles.
// - fp32 compute (the parity mode): exact fp32 FMAs on the CUDA cores, no
//   TF32, as lstm_cell.cu's fp32 kernel: per chunk of FJ = 16 units a
//   thread keeps 4 rows of one unit in all four gates; h' stays fp32, in a
//   [64, H] shared-memory buffer (132 KB at H = 512), and the same dots
//   read it.
// Simple first: one shared-memory stage per K chunk, no cp.async pipeline;
// the W chunks are read again by every block (342 at the serving frame).
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WM = 2, WN = 4;  // warp grid: rows x units
constexpr int TR = WM * 32;    // row slots of a block
constexpr int TJ = WN * 16;    // units per chunk
constexpr int KC = 32;
constexpr int LDA = KC + 8;      // bf16 per shared row of the x|h tile
constexpr int LDB = 4 * TJ + 8;  // bf16 per shared row of the W tile
constexpr int MAXB = 16;         // rows of a sentence the dot holds in registers
constexpr int FJ = 16;           // fp32 kernel: units per chunk

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// Four bf16 at p (8-byte aligned) as floats.
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

// Four fp32 at p (16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// The candidate dots of a block's ns sentences from h' in shared memory
// (sH [ns * B][ldh]): a warp per (sentence, candidate) pair; its lanes read
// the candidate's cols row once with vector loads, keep B partial dots
// against h', and reduce them with shuffles.
template <typename T>
__device__ __forceinline__ void cand_dots(const T* sH, int ldh, const T* __restrict__ cols,
                                          const float* __restrict__ cbias,
                                          float* __restrict__ cand_out, int s0, int ns,
                                          int B, int H, int C1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int pair = warp; pair < ns * C1; pair += THREADS / 32) {
    const int s = pair / C1, cj = pair % C1;
    const T* col = cols + ((size_t)(s0 + s) * C1 + cj) * H;
    const T* hs = sH + s * B * ldh;
    float acc[MAXB];
#pragma unroll
    for (int bb = 0; bb < MAXB; ++bb) acc[bb] = 0.0f;
    for (int k = lane * 4; k < H; k += 128) {
      float v[4];
      load4(col + k, v);
#pragma unroll
      for (int bb = 0; bb < MAXB; ++bb) {
        if (bb < B) {
          float hv[4];
          load4(hs + bb * ldh + k, hv);
          acc[bb] += v[0] * hv[0] + v[1] * hv[1] + v[2] * hv[2] + v[3] * hv[3];
        }
      }
    }
    const float bc = cbias[(size_t)(s0 + s) * C1 + cj];
#pragma unroll
    for (int bb = 0; bb < MAXB; ++bb) {
      if (bb < B) {
        float a = acc[bb];
        for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
        if (lane == 0) cand_out[((size_t)(s0 + s) * B + bb) * C1 + cj] = a + bc;
      }
    }
  }
}

size_t smem_bytes(int H) {
  return ((size_t)TR * LDA + (size_t)KC * LDB + (size_t)TR * (H + 8)) * sizeof(bf16);
}

template <typename CIn>
__global__ void __launch_bounds__(THREADS, 2)
cell_cand_kernel(const bf16* __restrict__ x, const bf16* __restrict__ h,
                 const CIn* __restrict__ c, const bf16* __restrict__ W,
                 const float* __restrict__ b, const bf16* __restrict__ cols,
                 const float* __restrict__ cbias, float* __restrict__ c_out,
                 bf16* __restrict__ h_out, float* __restrict__ cand_out, int S,
                 int B, int G, int E, int H, int C1, float forget_bias) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);  // [TR][LDA]     x|h chunk
  bf16* sB = sA + TR * LDA;                  // [KC][LDB]     W chunk, 4 gates
  bf16* sHc = sB + KC * LDB;                 // [TR][H + 8]   h' in bf16
  const int ldh = H + 8;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int gid = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;
  const int s0 = blockIdx.x * G;
  const int ns = min(G, S - s0);
  const int row0 = s0 * B, rows = ns * B;
  const int K = E + H, N4 = 4 * H;

  for (int j0 = 0; j0 < H; j0 += TJ) {
    float acc[2][8][4];  // [m tile][gate*2 + unit block][fragment]
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += KC) {
      __syncthreads();  // previous chunk consumed
      const bf16* src = k0 < E ? x : h;
      const int lds = k0 < E ? E : H;
      const int kc = k0 < E ? k0 : k0 - E;
      for (int i = tid; i < TR * (KC / 8); i += THREADS) {
        const int r = i / (KC / 8), cc = i % (KC / 8);
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < rows)
          v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * lds + kc + cc * 8);
        *reinterpret_cast<uint4*>(sA + r * LDA + cc * 8) = v;
      }
      for (int i = tid; i < KC * 4 * (TJ / 8); i += THREADS) {
        const int kr = i / (4 * (TJ / 8)), rest = i % (4 * (TJ / 8));
        const int g = rest / (TJ / 8), cc = rest % (TJ / 8);
        *reinterpret_cast<uint4*>(sB + kr * LDB + g * TJ + cc * 8) =
            *reinterpret_cast<const uint4*>(W + (size_t)(k0 + kr) * N4 + g * H + j0 + cc * 8);
      }
      __syncthreads();

#pragma unroll
      for (int ks = 0; ks < KC; ks += 16) {
        uint32_t a[2][4], bq[8][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm * 32 + mi * 16 + (mat & 1) * 8 + mr;
          jlm::ldsm_x4(a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                       sA + r * LDA + ks + (mat >> 1) * 8);
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) {  // n tiles 2g (units 0-7), 2g+1 (8-15)
          const int kr = ks + (mat & 1) * 8 + mr;
          const int col = g * TJ + wn * 16 + (mat >> 1) * 8;
          jlm::ldsm_x4_trans(bq[2 * g][0], bq[2 * g][1], bq[2 * g + 1][0],
                             bq[2 * g + 1][1], sB + kr * LDB + col);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 8; ++ni)
            jlm::mma_bf16(acc[mi][ni], a[mi], bq[ni][0], bq[ni][1]);
      }
    }

    // ---- gate epilogue in registers; h' also into shared memory ----
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = wm * 32 + mi * 16 + half * 8 + gid;
        if (rl >= rows) continue;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + wn * 16 + u * 8 + tig * 2 + e;
            const int f = half * 2 + e;
            const float zi = acc[mi][0 * 2 + u][f] + b[j];
            const float zj = acc[mi][1 * 2 + u][f] + b[H + j];
            const float zf = acc[mi][2 * 2 + u][f] + b[2 * H + j];
            const float zo = acc[mi][3 * 2 + u][f] + b[3 * H + j];
            const size_t idx = (size_t)(row0 + rl) * H + j;
            const float cn = jlm::sigmoidf(zf + forget_bias) * to_f(c[idx]) +
                             jlm::sigmoidf(zi) * tanhf(zj);
            const bf16 hn = __float2bfloat16(jlm::sigmoidf(zo) * tanhf(cn));
            c_out[idx] = cn;
            h_out[idx] = hn;
            sHc[rl * ldh + j] = hn;
          }
      }
  }
  __syncthreads();  // every unit of h' in shared memory
  cand_dots(sHc, ldh, cols, cbias, cand_out, s0, ns, B, H, C1);
}

size_t smem_f32_bytes(int H) {
  return ((size_t)KC * TR + (size_t)KC * 4 * FJ + (size_t)TR * (H + 4)) * sizeof(float);
}

// fp32 compute: x, h, W, cols fp32, h_out fp32.  Thread (ty, tx) of a 16 x
// 16 grid keeps rows ty*4..ty*4+3 of unit j0 + tx in all four gates.
template <typename CIn>
__global__ void __launch_bounds__(THREADS)
cell_cand_f32_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const CIn* __restrict__ c, const float* __restrict__ W,
                     const float* __restrict__ b, const float* __restrict__ cols,
                     const float* __restrict__ cbias, float* __restrict__ c_out,
                     float* __restrict__ h_out, float* __restrict__ cand_out, int S,
                     int B, int G, int E, int H, int C1, float forget_bias) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sA = reinterpret_cast<float*>(smem);  // [KC][TR]      x|h chunk, transposed
  float* sB = sA + KC * TR;                     // [KC][4 * FJ]  W chunk, 4 gates
  float* sH = sB + KC * 4 * FJ;                 // [TR][H + 4]   h'
  const int ldh = H + 4;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int s0 = blockIdx.x * G;
  const int ns = min(G, S - s0);
  const int row0 = s0 * B, rows = ns * B;
  const int K = E + H, N4 = 4 * H;

  for (int j0 = 0; j0 < H; j0 += FJ) {
    float acc[4][4];  // [row][gate]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[i][g] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += KC) {
      __syncthreads();  // previous chunk consumed
      const float* src = k0 < E ? x : h;
      const int lds = k0 < E ? E : H;
      const int kc = k0 < E ? k0 : k0 - E;
      for (int i = tid; i < TR * KC / 4; i += THREADS) {
        const int r = i % TR, kq = i / TR;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < rows)
          v = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * lds + kc + 4 * kq);
        sA[(4 * kq + 0) * TR + r] = v.x;
        sA[(4 * kq + 1) * TR + r] = v.y;
        sA[(4 * kq + 2) * TR + r] = v.z;
        sA[(4 * kq + 3) * TR + r] = v.w;
      }
      for (int i = tid; i < KC * 4 * (FJ / 4); i += THREADS) {
        const int kr = i / (4 * (FJ / 4)), rest = i % (4 * (FJ / 4));
        const int g = rest / (FJ / 4), cq = rest % (FJ / 4);
        *reinterpret_cast<float4*>(sB + kr * 4 * FJ + g * FJ + 4 * cq) =
            *reinterpret_cast<const float4*>(W + (size_t)(k0 + kr) * N4 + g * H + j0 + 4 * cq);
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(sA + k * TR + ty * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float bv = sB[k * 4 * FJ + g * FJ + tx];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][g] = fmaf(av[i], bv, acc[i][g]);
        }
      }
    }

    const int j = j0 + tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty * 4 + i;
      if (rl >= rows) continue;
      const size_t idx = (size_t)(row0 + rl) * H + j;
      const float cn = jlm::sigmoidf(acc[i][2] + b[2 * H + j] + forget_bias) * to_f(c[idx]) +
                       jlm::sigmoidf(acc[i][0] + b[j]) * tanhf(acc[i][1] + b[H + j]);
      const float hn = jlm::sigmoidf(acc[i][3] + b[3 * H + j]) * tanhf(cn);
      c_out[idx] = cn;
      h_out[idx] = hn;
      sH[rl * ldh + j] = hn;
    }
  }
  __syncthreads();  // every unit of h' in shared memory
  cand_dots(sH, ldh, cols, cbias, cand_out, s0, ns, B, H, C1);
}

template <typename CIn>
cudaError_t launch(const void* x, const void* h, const void* c, const void* W,
                   const float* b, const void* cols, const float* cbias,
                   float* c_out, void* h_out, float* cand_out, int S, int B, int E,
                   int H, int C1, int f32, float forget_bias, cudaStream_t stream) {
  const int G = TR / B, blocks = (S + G - 1) / G;
  cudaError_t err;
  if (f32) {
    const size_t smem = smem_f32_bytes(H);
    err = cudaFuncSetAttribute(cell_cand_f32_kernel<CIn>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cell_cand_f32_kernel<CIn><<<blocks, THREADS, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(h),
        static_cast<const CIn*>(c), static_cast<const float*>(W), b,
        static_cast<const float*>(cols), cbias, c_out, static_cast<float*>(h_out),
        cand_out, S, B, G, E, H, C1, forget_bias);
  } else {
    const size_t smem = smem_bytes(H);
    err = cudaFuncSetAttribute(cell_cand_kernel<CIn>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cell_cand_kernel<CIn><<<blocks, THREADS, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(h),
        static_cast<const CIn*>(c), static_cast<const bf16*>(W), b,
        static_cast<const bf16*>(cols), cbias, c_out, static_cast<bf16*>(h_out),
        cand_out, S, B, G, E, H, C1, forget_bias);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [S*B, E], h [S*B, H], W [E+H, 4H], cols [S, C1, H] and h_out [S*B, H]
// bf16, or fp32 when f32 (fp32 compute); c [S*B, H] fp32 (c_f32) or bf16;
// b [4H] and cbias [S, C1] fp32; c_out [S*B, H] and cand_out [S, B, C1]
// fp32.  B <= 16, E a multiple of 32, H a multiple of 64.
int jlm_cell_cand(const void* x, const void* h, const void* c, int c_f32,
                  const void* W, const float* b, const void* cols,
                  const float* cbias, float* c_out, void* h_out, float* cand_out,
                  int S, int B, int E, int H, int C1, int f32, float forget_bias,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > MAXB || E % KC || H % TJ) return (int)cudaErrorInvalidValue;
  if (c_f32)
    return (int)launch<float>(x, h, c, W, b, cols, cbias, c_out, h_out, cand_out, S, B,
                              E, H, C1, f32, forget_bias, st);
  return (int)launch<bf16>(x, h, c, W, b, cols, cbias, c_out, h_out, cand_out, S, B, E,
                           H, C1, f32, forget_bias, st);
}

}  // extern "C"
