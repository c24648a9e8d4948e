// Fused single-step LSTM cell for the decode frame:
//   z = x @ W[:E] + h @ W[E:] + b  (fp32 accumulate), gates i, j, f, o;
//   c' = sigmoid(f + forget_bias) * c + sigmoid(i) * tanh(j)
//   h' = sigmoid(o) * tanh(c')
//
// Replaces jlm_tpu/ops/lstm_cell.py::_cell_kernel (bf16 and fp32 compute).
// Called once per layer per frame on every beam row.
//
// Bound: at the main path's shapes (R = 20,480, E = 256, H = 512) the
// matmul is 2*R*(E+H)*4H = 64 GFLOP in bf16 against ~60 MB of x, h, c, c'
// and h' traffic, so the tensor cores bound it only once the gate
// pre-activations stay on chip; written to device memory, z alone would
// be 168 MB of fp32 per frame.
//
// Design:
// - A block owns TR = 128 rows and TJ = 32 hidden units, and computes the
//   columns of those units in ALL FOUR gates (j, H+j, 2H+j, 3H+j of W), so
//   the gate epilogue runs in registers and z never reaches device memory.
// - W is read in its own [E+H, 4H] layout; K streams through shared
//   memory in chunks of 32 (x for k < E, h after), and ldmatrix.trans
//   turns the [k][n] tile into mma's col-major B fragment.
// - 8 warps in a 4 x 2 grid; a warp computes 32 rows x (4 gates x 16
//   units) with mma.sync m16n8k16 bf16 -> fp32, so each thread holds all
//   four gates of its units and applies the cell directly.
// - c is read in its own dtype (bf16 or fp32); c' is written in c_out's
//   dtype and h' in bf16 (the compute dtype).
// - fp32 compute (the parity forward): exact fp32 FMAs on the CUDA cores,
//   no TF32.  A block owns FR = 64 rows and FJ = 16 units in all four
//   gates; K streams through shared memory in chunks of 32, the x|h tile
//   transposed; thread (ty, tx) of a 16 x 16 grid keeps rows ty*4..ty*4+3
//   of unit tx in all four gates, so the same register epilogue applies;
//   h' is fp32.  Bound at the fp32 parity run's shapes (R = 512 rows): 0.8
//   GFLOP against 67 TFLOP/s.
// Simple first: one shared-memory stage per K chunk, no cp.async pipeline.
#include "common.cuh"

namespace {

constexpr int TR = 128;
constexpr int TJ = 32;
constexpr int KC = 32;
constexpr int THREADS = 256;
constexpr int LDA = KC + 8;      // bf16 per shared row of the x|h tile (80 B)
constexpr int LDB = 4 * TJ + 8;  // bf16 per shared row of the W tile (272 B)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename CIn, typename COut>
__global__ void __launch_bounds__(THREADS, 2)
lstm_cell_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ h,
                 const CIn* __restrict__ c, const __nv_bfloat16* __restrict__ W,
                 const float* __restrict__ b, COut* __restrict__ c_out,
                 __nv_bfloat16* __restrict__ h_out, int R, int E, int H,
                 float forget_bias) {
  __shared__ __align__(16) __nv_bfloat16 sA[TR * LDA];
  __shared__ __align__(16) __nv_bfloat16 sB[KC * LDB];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int gid = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mr = lane & 7;
  const int row0 = blockIdx.x * TR, j0 = blockIdx.y * TJ;
  const int K = E + H, N4 = 4 * H;

  float acc[2][8][4];  // [m tile][gate*2 + unit block][fragment]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // previous chunk consumed
    const __nv_bfloat16* src = k0 < E ? x : h;
    const int lds = k0 < E ? E : H;
    const int kc = k0 < E ? k0 : k0 - E;
    for (int i = tid; i < TR * (KC / 8); i += THREADS) {
      const int r = i / (KC / 8), cc = i % (KC / 8), row = row0 + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < R)
        v = *reinterpret_cast<const uint4*>(src + (size_t)row * lds + kc + cc * 8);
      *reinterpret_cast<uint4*>(sA + r * LDA + cc * 8) = v;
    }
    for (int i = tid; i < KC * 4 * (TJ / 8); i += THREADS) {
      const int kr = i / (4 * (TJ / 8)), rest = i % (4 * (TJ / 8));
      const int g = rest / (TJ / 8), cc = rest % (TJ / 8);
      const uint4 v = *reinterpret_cast<const uint4*>(
          W + (size_t)(k0 + kr) * N4 + g * H + j0 + cc * 8);
      *reinterpret_cast<uint4*>(sB + kr * LDB + g * TJ + cc * 8) = v;
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      uint32_t a[2][4], b[8][2];
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
        jlm::ldsm_x4_trans(b[2 * g][0], b[2 * g][1], b[2 * g + 1][0],
                           b[2 * g + 1][1], sB + kr * LDB + col);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          jlm::mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }

  // ---- gate epilogue, all in registers ----
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wm * 32 + mi * 16 + half * 8 + gid;
      if (row >= R) continue;
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
          const size_t idx = (size_t)row * H + j;
          const float cn = jlm::sigmoidf(zf + forget_bias) * to_f(c[idx]) +
                           jlm::sigmoidf(zi) * tanhf(zj);
          store(c_out + idx, cn);
          store(h_out + idx, jlm::sigmoidf(zo) * tanhf(cn));
        }
    }
}

constexpr int FR = 64;
constexpr int FJ = 16;
constexpr int FK = 32;

// fp32 compute: x [R, E], h [R, H], W [E+H, 4H] fp32; h_out fp32.
template <typename CIn, typename COut>
__global__ void __launch_bounds__(THREADS)
lstm_cell_f32_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const CIn* __restrict__ c, const float* __restrict__ W,
                     const float* __restrict__ b, COut* __restrict__ c_out,
                     float* __restrict__ h_out, int R, int E, int H,
                     float forget_bias) {
  __shared__ __align__(16) float sA[FK][FR];      // [k][row] of x|h
  __shared__ __align__(16) float sB[FK][4 * FJ];  // [k][gate * FJ + unit]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int row0 = blockIdx.x * FR, j0 = blockIdx.y * FJ;
  const int K = E + H, N4 = 4 * H;

  float acc[4][4];  // [row][gate]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[i][g] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += FK) {
    __syncthreads();  // previous chunk consumed
    const float* src = k0 < E ? x : h;
    const int lds = k0 < E ? E : H;
    const int kc = k0 < E ? k0 : k0 - E;
    for (int i = tid; i < FR * FK / 4; i += THREADS) {
      const int r = i % FR, kq = i / FR, row = row0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < R)
        v = *reinterpret_cast<const float4*>(src + (size_t)row * lds + kc + 4 * kq);
      sA[4 * kq + 0][r] = v.x;
      sA[4 * kq + 1][r] = v.y;
      sA[4 * kq + 2][r] = v.z;
      sA[4 * kq + 3][r] = v.w;
    }
    for (int i = tid; i < FK * 4 * (FJ / 4); i += THREADS) {
      const int kr = i / (4 * (FJ / 4)), rest = i % (4 * (FJ / 4));
      const int g = rest / (FJ / 4), cq = rest % (FJ / 4);
      *reinterpret_cast<float4*>(&sB[kr][g * FJ + 4 * cq]) =
          *reinterpret_cast<const float4*>(W + (size_t)(k0 + kr) * N4 + g * H + j0 + 4 * cq);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < FK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&sA[k][ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float bv = sB[k][g * FJ + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][g] = fmaf(av[i], bv, acc[i][g]);
      }
    }
  }

  const int j = j0 + tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= R) continue;
    const size_t idx = (size_t)row * H + j;
    const float cn = jlm::sigmoidf(acc[i][2] + b[2 * H + j] + forget_bias) * to_f(c[idx]) +
                     jlm::sigmoidf(acc[i][0] + b[j]) * tanhf(acc[i][1] + b[H + j]);
    store(c_out + idx, cn);
    h_out[idx] = jlm::sigmoidf(acc[i][3] + b[3 * H + j]) * tanhf(cn);
  }
}

template <typename CIn, typename COut>
cudaError_t launch(const void* x, const void* h, const void* c, const void* W,
                   const float* b, void* c_out, void* h_out, int f32, int R,
                   int E, int H, float forget_bias, cudaStream_t stream) {
  if (f32) {
    dim3 grid((R + FR - 1) / FR, H / FJ);
    lstm_cell_f32_kernel<CIn, COut><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(h),
        static_cast<const CIn*>(c), static_cast<const float*>(W), b,
        static_cast<COut*>(c_out), static_cast<float*>(h_out), R, E, H,
        forget_bias);
  } else {
    dim3 grid((R + TR - 1) / TR, H / TJ);
    lstm_cell_kernel<CIn, COut><<<grid, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(h),
        static_cast<const CIn*>(c), static_cast<const __nv_bfloat16*>(W), b,
        static_cast<COut*>(c_out), static_cast<__nv_bfloat16*>(h_out), R, E, H,
        forget_bias);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [R, E], h [R, H], W [E+H, 4H] and h_out [R, H]: bf16, or fp32 when
// f32 (fp32 compute); c [R, H] fp32 (c_f32) or bf16; b [4H] fp32; c_out
// [R, H] fp32 (c_out_f32) or bf16.  E and H must be multiples of 32.
int jlm_lstm_cell(const void* x, const void* h, const void* c, int c_f32,
                  const void* W, const float* b, void* c_out, int c_out_f32,
                  void* h_out, int f32, int R, int E, int H, float forget_bias,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (c_f32 && c_out_f32)
    err = launch<float, float>(x, h, c, W, b, c_out, h_out, f32, R, E, H, forget_bias, st);
  else if (c_f32)
    err = launch<float, __nv_bfloat16>(x, h, c, W, b, c_out, h_out, f32, R, E, H,
                                       forget_bias, st);
  else if (c_out_f32)
    err = launch<__nv_bfloat16, float>(x, h, c, W, b, c_out, h_out, f32, R, E, H,
                                       forget_bias, st);
  else
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, h, c, W, b, c_out, h_out, f32, R, E,
                                               H, forget_bias, st);
  return (int)err;
}

}  // extern "C"
