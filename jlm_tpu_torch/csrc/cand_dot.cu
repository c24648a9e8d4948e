// Per-sentence candidate scoring:  out[s] = h3[s] @ cols[s]^T + bias[s],
// h3 [S, B, H], cols [S, C1, H] (bf16 or fp32), bias [S, C1] fp32,
// out [S, B, C1] fp32.
//
// Replaces jlm_tpu/ops/cand_dot.py::_cand_kernel.  Called once per frame.
//
// Bound: device memory.  At the main path's shapes (S = 2,048, B = 10,
// C1 = 65, H = 512) the work is only 1.4 GFLOP but the bf16 cols are
// 136 MB, read once per frame; everything else is small.
//
// Design: one block per sentence.  The block stages h3[s] (B x H) in shared
// memory as fp32, then each warp takes whole candidate columns: its lanes
// read one cols row with coalesced vector loads (each row is read exactly
// once), keep B fp32 partial dots, and reduce them across the warp with
// shuffles.  Accumulation is fp32 throughout.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAXB = 16;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
cand_dot_kernel(const T* __restrict__ h3, const T* __restrict__ cols,
                const float* __restrict__ bias, float* __restrict__ out, int B,
                int C1, int H) {
  extern __shared__ __align__(16) float sh[];  // [B][H]
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* hs = h3 + (size_t)s * B * H;
  for (int i = threadIdx.x; i < B * H; i += THREADS) sh[i] = to_f(hs[i]);
  __syncthreads();

  for (int c = warp; c < C1; c += THREADS / 32) {
    const T* col = cols + ((size_t)s * C1 + c) * H;
    float acc[MAXB];
#pragma unroll
    for (int bb = 0; bb < MAXB; ++bb) acc[bb] = 0.0f;
    for (int k = lane * 4; k < H; k += 128) {
      float v[4];
      load4(col + k, v);
#pragma unroll
      for (int bb = 0; bb < MAXB; ++bb) {
        if (bb < B) {
          const float4 hv = *reinterpret_cast<const float4*>(sh + bb * H + k);
          acc[bb] += v[0] * hv.x + v[1] * hv.y + v[2] * hv.z + v[3] * hv.w;
        }
      }
    }
    const float bc = bias[(size_t)s * C1 + c];
#pragma unroll
    for (int bb = 0; bb < MAXB; ++bb) {
      if (bb < B) {
        float a = acc[bb];
        for (int off = 16; off > 0; off >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        if (lane == 0) out[((size_t)s * B + bb) * C1 + c] = a + bc;
      }
    }
  }
}

}  // namespace

extern "C" {

// B <= 16 and H a multiple of 4; h3/cols fp32 (is_f32) or bf16.
int jlm_cand_dot(const void* h3, const void* cols, int is_f32,
                 const float* bias, float* out, int S, int B, int C1, int H,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)B * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        is_f32 ? (const void*)cand_dot_kernel<float>
               : (const void*)cand_dot_kernel<__nv_bfloat16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (is_f32)
    cand_dot_kernel<float><<<S, THREADS, smem, st>>>(
        static_cast<const float*>(h3), static_cast<const float*>(cols), bias,
        out, B, C1, H);
  else
    cand_dot_kernel<__nv_bfloat16><<<S, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(h3),
        static_cast<const __nv_bfloat16*>(cols), bias, out, B, C1, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
