// Per-sentence candidate scoring:  out[s] = h3[s] @ cols[s]^T + bias[s],
// h3 [S, B, H], cols [S, C1, H] (bf16 or fp32), bias [S, C1] fp32,
// out [S, B, C1] fp32, fp32 accumulation.
//
// Replaces jlm_tpu/ops/cand_dot.py::_cand_kernel.  Called once per frame.
//
// Bound: device memory.  At the main path's shapes (S = 2,048, B = 10,
// C1 = 65, H = 512, bf16) the work is 1.36 GFLOP against 163 MB: the cols
// (136.3 MB; each sentence's 66,560 B contiguous, read once a frame), h3
// (21 MB), bias and out (5.9 MB): 0.0487 ms at 3.35 TB/s.
//
// Design (the first port's kernel, one block a sentence staging h3 with
// scalar loads and a warp a column ending in shuffles, kept few bytes in
// flight and ran at ~3.3x the bound):
// - A persistent grid (the blocks one SM holds, times the SMs) walks the
//   sentences.  A sentence is one or more K chunks of at most 512 B a row;
//   each chunk (its C1 cols rows and its B h3 rows) arrives by bulk copies
//   (cp.async.bulk, one a row, issued by the producer warp's 32 lanes) into
//   a ring of stages paced by full/empty mbarriers, so the next sentence's
//   bytes are in flight while this one's product runs.  Two blocks share
//   an SM, each with two stages of half a sentence (plan_of).  A row lands at a
//   stride of its chunk + 16 bytes (an odd number of 16-byte units), so
//   ldmatrix's 8 rows fall in 8 different bank groups.
// - bf16: the product on the tensor cores, mma.sync m16n8k16 bf16 -> fp32:
//   A is the B <= 16 beam rows (rows past B read row B - 1: their sums are
//   never stored), B is cols^T in pairs of n8 tiles (ldmatrix x4), C1 = 65
//   in 5 pairs, columns past C1 likewise clamped and never stored.  Five
//   consumer warps take the pairs in turn (warp w: pairs w, w + 5, ...) and
//   keep their sums in registers over the sentence's chunks.  wgmma does
//   not fit: a sentence has 10 rows against wgmma's 64, and its B operand
//   differs per sentence.
// - fp32 (the parity mode): exact fp32 FMAs on the CUDA cores (no TF32);
//   a consumer thread keeps whole dots of one column with a group of beam
//   rows (C1 = 65, B = 10: 130 items of 5 rows on the 160 consumer
//   threads) over the chunk's K from shared memory, so no shuffle tail.
// - The epilogue adds the bias and stores each sum once, straight from the
//   registers.
// B <= 16 and C1 <= 256 a launch (the wrapper groups wider beams and
// candidate sets); H a multiple of 16 (bf16) or 4 (fp32).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int CONSUMERS = 5;                      // consumer warps (C1 = 65: a pair each)
constexpr int CT = 32 * CONSUMERS;                // consumer threads
constexpr int THREADS = CT + 32;                  // + the producer warp
constexpr int MAXB = 16;                          // beam rows: one m16 tile
constexpr int MAXC = 256;                         // candidate columns a launch
constexpr int MAX_PAIRS = (MAXC / 16 + CONSUMERS - 1) / CONSUMERS;  // n8-tile pairs a warp
constexpr int FITEMS = (MAXC + CT - 1) / CT;      // fp32: (column, row group) items a thread
constexpr int SMEM_MAX = 232448;                  // dynamic shared memory a block may use
constexpr int SMEM_TWO = 114000;                  // a block's share where two fit an SM
constexpr int MAX_STAGES = 8;
constexpr int MAX_CHUNK = 512;                    // bytes of K a row a stage

struct Plan {
  int chunk_bytes, chunk, n_chunks, lds, stage_bytes, stages, smem;
};

// The ring's shape: the widest chunk (up to 512 bytes a row, a multiple of
// 32) at which two stages of C1 + B rows fit in half an SM's shared memory
// (else in all of it): two blocks an SM, each with two stages of half a
// sentence at the serving frame.  Chip runs (PERF.md): one block with 5
// such stages, or with 2 stages of a whole sentence, left the memory idle
// while its consumer warps worked; two blocks an SM keep it busy.
Plan plan_of(int B, int C1, int H, int elem) {
  Plan p{};
  const int rows = C1 + B;
  int cb = ((H * elem + 31) / 32) * 32;
  if (cb > MAX_CHUNK) cb = MAX_CHUNK;
  for (int budget : {SMEM_TWO, SMEM_MAX})
  for (int c = cb; c >= 32; c -= 32) {
    const int lds = c + 16;
    const int stage = ((rows * lds + 127) / 128) * 128;
    int stages = (budget - 1024 - 2 * MAX_STAGES * 8) / stage;
    if (stages > MAX_STAGES) stages = MAX_STAGES;
    if (stages >= 2) {
      cb = c;
      p.chunk_bytes = cb;
      p.chunk = cb / elem;
      p.n_chunks = (H + p.chunk - 1) / p.chunk;
      p.lds = lds;
      p.stage_bytes = stage;
      p.stages = stages;
      p.smem = stages * stage + 2 * stages * 8 + 128;
      return p;
    }
  }
  return p;  // stages == 0: nothing fits
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
cand_dot_kernel(const T* __restrict__ h3, const T* __restrict__ cols,
                const float* __restrict__ bias, float* __restrict__ out, int S, int B,
                int C1, int H, Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.stages * p.stage_bytes);
  uint64_t* empty = full + p.stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  // this block's sentences: blockIdx.x, + gridDim.x, ...; items are chunks
  const int n_sent = blockIdx.x < S ? (S - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_items = n_sent * p.n_chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      jlm::mbar_init(&full[s], 1);
      jlm::mbar_init(&empty[s], CONSUMERS);
    }
    jlm::mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS) {
    // ---- producer: a bulk copy a row (C1 cols rows, then B h3 rows) ----
    for (int i = 0; i < n_items; ++i) {
      const int st = i % p.stages, s = blockIdx.x + (i / p.n_chunks) * gridDim.x;
      const int k0 = (i % p.n_chunks) * p.chunk;
      const int kk = min(p.chunk, H - k0);
      if (i >= p.stages) jlm::mbar_wait(&empty[st], ((i / p.stages) - 1) & 1);
      if (lane == 0) jlm::mbar_expect_tx(&full[st], (C1 + B) * kk * (int)sizeof(T));
      __syncwarp();
      unsigned char* stage = smem + st * p.stage_bytes;
      for (int r = lane; r < C1 + B; r += 32) {
        const T* src = r < C1 ? cols + ((size_t)s * C1 + r) * H + k0
                              : h3 + ((size_t)s * B + (r - C1)) * H + k0;
        jlm::bulk_load(stage + r * p.lds, src, kk * sizeof(T), &full[st]);
      }
    }
    return;
  }

  // ---- consumers ----
  const int ct = threadIdx.x;  // consumer thread, 0 .. CT - 1
  const int gid = lane >> 2, tig = lane & 3, mat = lane >> 3, mr = lane & 7;
  const int pairs = (C1 + 15) / 16;
  // fp32: item i = (column i % C1, row group i / C1) of RG groups of RB rows
  const int RG = max(1, min(B, CT / C1)), RB = (B + RG - 1) / RG;
  // bf16: [pair][k16 step parity][n8 tile][fragment]: two sums a tile, so
  // two mma chains run side by side
  float acc[MAX_PAIRS][2][2][4];
  float facc[FITEMS][MAXB];    // fp32: [item][row of its group]
  for (int i = 0; i < n_items; ++i) {
    const int st = i % p.stages, s = blockIdx.x + (i / p.n_chunks) * gridDim.x;
    const int chunk = i % p.n_chunks;
    const int kk = min(p.chunk, H - chunk * p.chunk);
    const unsigned char* stage = smem + st * p.stage_bytes;
    const unsigned char* hrow = stage + C1 * p.lds;  // beam row 0
    jlm::mbar_wait(&full[st], (i / p.stages) & 1);
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (chunk == 0) {
#pragma unroll
        for (int q = 0; q < MAX_PAIRS; ++q)
#pragma unroll
          for (int par = 0; par < 2; ++par)
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[q][par][n][e] = 0.0f;
      }
      const int arow = min((mat & 1) * 8 + mr, B - 1);
#pragma unroll 2
      for (int k0 = 0; k0 < kk; k0 += 32) {
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const int k = k0 + 16 * par;
          if (k < kk) {
            uint32_t a[4];
            jlm::ldsm_x4(a[0], a[1], a[2], a[3],
                         hrow + arow * p.lds + (k + (mat >> 1) * 8) * 2);
#pragma unroll
            for (int q = 0; q < MAX_PAIRS; ++q) {
              const int pr = warp + CONSUMERS * q;
              if (pr < pairs) {
                const int n = min(pr * 16 + (mat >> 1) * 8 + mr, C1 - 1);
                uint32_t b[4];
                jlm::ldsm_x4(b[0], b[1], b[2], b[3],
                             stage + n * p.lds + (k + (mat & 1) * 8) * 2);
                jlm::mma_bf16(acc[q][par][0], a, b[0], b[1]);
                jlm::mma_bf16(acc[q][par][1], a, b[2], b[3]);
              }
            }
          }
        }
      }
    } else {
      if (chunk == 0) {
#pragma unroll
        for (int q = 0; q < FITEMS; ++q)
#pragma unroll
          for (int r = 0; r < MAXB; ++r) facc[q][r] = 0.0f;
      }
#pragma unroll
      for (int q = 0; q < FITEMS; ++q) {
        const int item = ct + CT * q, c = item % C1, r0 = (item / C1) * RB;
        if (item < C1 * RG) {
          const float* cr = reinterpret_cast<const float*>(stage + c * p.lds);
#pragma unroll 2
          for (int k = 0; k < kk; k += 4) {
            const float4 w = *reinterpret_cast<const float4*>(cr + k);
#pragma unroll
            for (int r = 0; r < MAXB; ++r) {
              if (r < RB && r0 + r < B) {
                const float4 v =
                    *reinterpret_cast<const float4*>(hrow + (r0 + r) * p.lds + k * 4);
                facc[q][r] = fmaf(v.x, w.x, facc[q][r]);
                facc[q][r] = fmaf(v.y, w.y, facc[q][r]);
                facc[q][r] = fmaf(v.z, w.z, facc[q][r]);
                facc[q][r] = fmaf(v.w, w.w, facc[q][r]);
              }
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) jlm::mbar_arrive(&empty[st]);
    if (chunk + 1 < p.n_chunks) continue;

    // ---- epilogue: bias added, each sum stored once ----
    float* os = out + (size_t)s * B * C1;
    const float* bs = bias + (size_t)s * C1;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
      for (int q = 0; q < MAX_PAIRS; ++q) {
        const int pr = warp + CONSUMERS * q;
        if (pr >= pairs) continue;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = gid + 8 * (e >> 1), col = pr * 16 + n * 8 + 2 * tig + (e & 1);
            if (row < B && col < C1)
              os[row * C1 + col] = (acc[q][0][n][e] + acc[q][1][n][e]) + __ldg(bs + col);
          }
      }
    } else {
#pragma unroll
      for (int q = 0; q < FITEMS; ++q) {
        const int item = ct + CT * q, c = item % C1, r0 = (item / C1) * RB;
        if (item >= C1 * RG) continue;
        const float bc = __ldg(bs + c);
#pragma unroll
        for (int r = 0; r < MAXB; ++r)
          if (r < RB && r0 + r < B) os[(r0 + r) * C1 + c] = facc[q][r] + bc;
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* h3, const void* cols, const float* bias, float* out, int S,
                   int B, int C1, int H, cudaStream_t stream) {
  const Plan p = plan_of(B, C1, H, (int)sizeof(T));
  if (p.stages < 2) return cudaErrorInvalidValue;
  auto kernel = cand_dot_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  // all of the SM's 228 KB as shared memory, so that two blocks fit (left
  // to itself, CUDA may pick a split that holds one: ~0.10 ms, not ~0.067,
  // on the H100)
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  // one wave of persistent blocks: the blocks an SM holds at this ring's
  // size, times the SMs (cached by device and size)
  static int cached_dev = -1, cached_smem = -1, cached_grid = 0;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev != cached_dev || p.smem != cached_smem) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                             p.smem)) != cudaSuccess)
      return err;
    cached_dev = dev;
    cached_smem = p.smem;
    cached_grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int grid = S < cached_grid ? S : cached_grid;
  kernel<<<grid, THREADS, p.smem, stream>>>(static_cast<const T*>(h3),
                                            static_cast<const T*>(cols), bias, out, S, B, C1,
                                            H, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// h3 [S, B, H], cols [S, C1, H]: fp32 (is_f32) or bf16, 16-byte aligned;
// bias [S, C1] and out [S, B, C1] fp32.  1 <= B <= 16, 1 <= C1 <= 256, H a
// multiple of 16 (bf16) or 4 (fp32).
int jlm_cand_dot(const void* h3, const void* cols, int is_f32, const float* bias,
                 float* out, int S, int B, int C1, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > MAXB || C1 < 1 || C1 > MAXC || H < 1 || H % (is_f32 ? 4 : 16))
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  return (int)(is_f32 ? launch<float>(h3, cols, bias, out, S, B, C1, H, st)
                      : launch<__nv_bfloat16>(h3, cols, bias, out, S, B, C1, H, st));
}

}  // extern "C"
