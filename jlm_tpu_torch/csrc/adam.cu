// Adam's global-norm clip and update over every leaf of a parameter tree:
// one pass for the norm (sumsq_kernel), one for the update (adam_clip_kernel).
//
// Replaces no Pallas kernel: the reference's optimizer
// (jlm_tpu/train/trainer.py::make_optimizer, optax clip_by_global_norm then
// adam) is elementwise code that XLA fuses.  The port's plain version
// (train/optim.py: global_norm, clip_by_global_norm, _adam, the add) is one
// PyTorch pass over device memory for each product, quotient, square root
// and sum of every leaf: about 43 passes, ~172 bytes an element.
//
// Bound: device memory.  The update reads g, p, mu and nu and writes p, mu
// and nu (28 B an element); the norm reads g once more (4 B): 32 B an
// element.  The 50k training step's 40,024,912 fp32 elements move 1.281 GB,
// 0.382 ms at 3.35 TB/s.
//
// Design:
// - The wrapper (ops/adam.py) cuts every leaf into chunks of at most CHUNK
//   elements (a multiple of 4) and keeps the table of (leaf, start, count)
//   on the device, made once per set of leaf sizes.  The leaves' pointers
//   go by value in the launch's parameters, so a new gradient buffer every
//   step costs no copy, and the trainer's tree stays as it is (no flat
//   buffer, no views of one).
// - The pointers stay in the parameters' constant bank (__grid_constant__:
//   no per-thread copy where a chunk indexes them by its leaf).
// - Both kernels run a persistent grid (the blocks the SMs hold at once)
//   over the table: block b takes chunks b, b + grid, ...  A chunk whose
//   pointers are all 16-byte aligned moves in float4 loads and stores, its
//   last count % 4 elements one at a time; other chunks (slices of one
//   buffer, as the sharded and pipeline steps hand over) one at a time.
// - sumsq: fp32 squares summed in four accumulators a thread, then a
//   fixed tree a block, one partial a block; the last block to finish (a
//   ticket counter, which it resets) sums the partials in index order and
//   stores the square root.  No float atomics: a rerun gives the same bits.
// - adam_clip: per element what the plain version computes on the card,
//   in its order and with its roundings: each step an _rn intrinsic, so
//   that nvcc contracts nothing into an FMA; the scalars rounded to fp32 on
//   the host as PyTorch rounds a Python scalar; mu / bc1 and nu / bc2 as
//   products with the divisor's reciprocal (taken in double, rounded to
//   fp32), as PyTorch divides a CUDA tensor by a Python scalar
//   (ops/adam.py::adam_scalars); the norm read from device memory, so the
//   host never waits.  p, mu and nu are written in place.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEAVES = 96;  // pointers by value: 96 x 4 x 8 B of the 4 KB of parameters
constexpr int MAX_GRID = 4096;  // partials the wrapper's scratch holds

struct Chunk {  // a row of the wrapper's int64 [n, 3] table
  long long leaf, start, count;
};

struct NormLeaves {
  const float* g[MAX_LEAVES];
};

struct AdamLeaves {
  const float* g[MAX_LEAVES];
  float* p[MAX_LEAVES];
  float* mu[MAX_LEAVES];
  float* nu[MAX_LEAVES];
};

// fp32, as PyTorch rounds each Python scalar of the plain version
struct Scalars {
  float max_norm, b1, c1, b2, c2, inv_bc1, inv_bc2, eps, neg_lr;
};

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

// The block's sum, in thread 0: shuffles within each warp, then warp 0
// over the warps' sums; a fixed order.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[THREADS / 32];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[w] = v;
  __syncthreads();
  v = 0.f;
  if (w == 0) {
    v = lane < THREADS / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();  // warp_sums free for the next call
  return v;
}

__global__ void __launch_bounds__(THREADS)
    sumsq_kernel(const __grid_constant__ NormLeaves leaves, const Chunk* __restrict__ table,
                 int n_chunks, float* __restrict__ partials, unsigned* __restrict__ ticket,
                 float* __restrict__ norm) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk ch = table[c];
    const float* g = leaves.g[ch.leaf] + ch.start;
    const int n = static_cast<int>(ch.count);
    int i = 0;
    if (aligned16(g)) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      for (int k = threadIdx.x; k < n >> 2; k += THREADS) {
        const float4 v = __ldcs(g4 + k);
        s0 = fmaf(v.x, v.x, s0);
        s1 = fmaf(v.y, v.y, s1);
        s2 = fmaf(v.z, v.z, s2);
        s3 = fmaf(v.w, v.w, s3);
      }
      i = n & ~3;
    }
    for (i += threadIdx.x; i < n; i += THREADS) {
      const float v = __ldcs(g + i);
      s0 = fmaf(v, v, s0);
    }
  }
  const float s = block_sum((s0 + s1) + (s2 + s3));
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    __threadfence();  // the partial is visible before the ticket counts it
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  float t = 0.f;
  for (int k = threadIdx.x; k < static_cast<int>(gridDim.x); k += THREADS)
    t += __ldcg(partials + k);  // from L2: written by other SMs
  t = block_sum(t);
  if (threadIdx.x == 0) {
    *norm = __fsqrt_rn(t);
    *ticket = 0u;  // ready for the next launch
  }
}

// One element: the plain version's clip, moments and update.
__device__ __forceinline__ void adam_one(float g, float& p, float& m, float& v, bool keep,
                                         float norm, const Scalars& s) {
  if (!keep) g = __fmul_rn(__fdiv_rn(g, norm), s.max_norm);           // (g / norm) * max_norm
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(g, s.c1));              // mu*b1 + (1-b1)*g
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(g, g), s.c2));  // nu*b2 + (1-b2)*g*g
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv_bc2)), s.eps);
  p = __fadd_rn(p, __fmul_rn(__fdiv_rn(__fmul_rn(m, s.inv_bc1), den), s.neg_lr));
}

__global__ void __launch_bounds__(THREADS)
    adam_clip_kernel(const __grid_constant__ AdamLeaves leaves,
                     const Chunk* __restrict__ table, int n_chunks,
                     const float* __restrict__ norm_p, Scalars s) {
  const float norm = __ldg(norm_p);
  const bool keep = norm < s.max_norm;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk ch = table[c];
    const float* g = leaves.g[ch.leaf] + ch.start;
    float* p = leaves.p[ch.leaf] + ch.start;
    float* m = leaves.mu[ch.leaf] + ch.start;
    float* v = leaves.nu[ch.leaf] + ch.start;
    const int n = static_cast<int>(ch.count);
    int i = 0;
    if (aligned16(g) && aligned16(p) && aligned16(m) && aligned16(v)) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* p4 = reinterpret_cast<float4*>(p);
      float4* m4 = reinterpret_cast<float4*>(m);
      float4* v4 = reinterpret_cast<float4*>(v);
      for (int k = threadIdx.x; k < n >> 2; k += THREADS) {
        const float4 gk = __ldcs(g4 + k);
        float4 pk = __ldcs(p4 + k), mk = __ldcs(m4 + k), vk = __ldcs(v4 + k);
        adam_one(gk.x, pk.x, mk.x, vk.x, keep, norm, s);
        adam_one(gk.y, pk.y, mk.y, vk.y, keep, norm, s);
        adam_one(gk.z, pk.z, mk.z, vk.z, keep, norm, s);
        adam_one(gk.w, pk.w, mk.w, vk.w, keep, norm, s);
        __stcs(p4 + k, pk);
        __stcs(m4 + k, mk);
        __stcs(v4 + k, vk);
      }
      i = n & ~3;
    }
    for (i += threadIdx.x; i < n; i += THREADS) {
      float pk = p[i], mk = m[i], vk = v[i];
      adam_one(g[i], pk, mk, vk, keep, norm, s);
      p[i] = pk;
      m[i] = mk;
      v[i] = vk;
    }
  }
}

// One wave of persistent blocks (the blocks an SM holds, times the SMs),
// cached by device: the sums' order, and so their bits, follow the grid.
template <typename K>
cudaError_t wave(K kernel, int* cached_dev, int* cached_grid, int* grid) {
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev != *cached_dev) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0)) !=
        cudaSuccess)
      return err;
    *cached_dev = dev;
    *cached_grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  *grid = *cached_grid;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// g: n_leaves device pointers (a host array) of fp32 leaves; table: int64
// [n_chunks, 3] on the device; partials: MAX_GRID floats and ticket one
// zeroed unsigned of scratch (the ticket is left zeroed); norm: one float,
// sqrt of the sum of every leaf's squares.
int jlm_adam_sumsq(const void* const* g, int n_leaves, const void* table, int n_chunks,
                   float* partials, unsigned* ticket, float* norm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_leaves < 1 || n_leaves > MAX_LEAVES || n_chunks < 0) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return (int)cudaMemsetAsync(norm, 0, sizeof(float), st);
  static int cached_dev = -1, cached_grid = 0;
  int grid = 0;
  cudaError_t err = wave(sumsq_kernel, &cached_dev, &cached_grid, &grid);
  if (err != cudaSuccess) return (int)err;
  grid = grid < MAX_GRID ? grid : MAX_GRID;
  grid = grid < n_chunks ? grid : n_chunks;
  NormLeaves leaves;
  for (int i = 0; i < n_leaves; ++i) leaves.g[i] = static_cast<const float*>(g[i]);
  sumsq_kernel<<<grid, THREADS, 0, st>>>(leaves, static_cast<const Chunk*>(table), n_chunks,
                                         partials, ticket, norm);
  return (int)cudaGetLastError();
}

// g, p, mu, nu: n_leaves device pointers each (host arrays), leaf i of each
// of one size; table as above; norm: the global norm on the device.  The
// scalars as the plain version's fp32 roundings: max_norm, b1, 1 - b1, b2,
// 1 - b2, 1 / (1 - b1^count), 1 / (1 - b2^count), eps, -lr.
int jlm_adam_clip(const void* const* g, void* const* p, void* const* mu, void* const* nu,
                  int n_leaves, const void* table, int n_chunks, const float* norm,
                  float max_norm, float b1, float c1, float b2, float c2, float inv_bc1,
                  float inv_bc2, float eps, float neg_lr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_leaves < 1 || n_leaves > MAX_LEAVES || n_chunks < 0) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  static int cached_dev = -1, cached_grid = 0;
  int grid = 0;
  cudaError_t err = wave(adam_clip_kernel, &cached_dev, &cached_grid, &grid);
  if (err != cudaSuccess) return (int)err;
  grid = grid < n_chunks ? grid : n_chunks;
  AdamLeaves leaves;
  for (int i = 0; i < n_leaves; ++i) {
    leaves.g[i] = static_cast<const float*>(g[i]);
    leaves.p[i] = static_cast<float*>(p[i]);
    leaves.mu[i] = static_cast<float*>(mu[i]);
    leaves.nu[i] = static_cast<float*>(nu[i]);
  }
  const Scalars s{max_norm, b1, c1, b2, c2, inv_bc1, inv_bc2, eps, neg_lr};
  adam_clip_kernel<<<grid, THREADS, 0, st>>>(leaves, static_cast<const Chunk*>(table),
                                             n_chunks, norm, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
