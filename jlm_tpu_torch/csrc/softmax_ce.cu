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
// Layouts: h [N, D] row-major.  The bf16 kernels read W^T [V, Dp] bf16
// (D zero-padded to Dp), which the wrapper's one transposing cast a step
// (cast_wt_kernel) writes for the forward and the backward together; the
// fp32 kernels read W [D, V] as it is.  Columns >= V are masked (no p, no
// target), as the reference's -1e30 bias padding does; D must be a
// multiple of 128; V may be anything (W^T's rows past V read as zero
// through TMA: the bf16 forward's bias is -inf there, and in the bf16
// backward a column past V meets a zero row in the output product, and db
// stores only the first V).
//
// bf16 forward design (ce_fwd_bf16_kernel: wgmma + TMA, sm_90a), replacing
// jlm_tpu/ops/softmax_ce.py::_ce_fwd_kernel (an online logsumexp and the
// target logit over vocab tiles).
// - Bound: the products, 2 N D V operations (0.053 ms at N = 1,024, D =
//   512, V = 50,000 at 989 TFLOP/s); the L2's stream of W^T, once per row
//   block (51 MB there; 8 blocks of 128 rows: 410 MB, ~0.07 ms at ~5.8
//   TB/s); N V exponentials at 16 a clock an SM (~0.014 ms).
// - A block owns FT = 128 q rows (rows of h), 64 for each of two consumer
//   warpgroups, and walks the FT-row kv tiles (rows of W^T) of its vocab
//   split (grid.y); per tile each warpgroup forms its logits [64, 128]
//   with wgmma m64n128k16, both operands K-major from 128-byte-swizzled
//   TMA boxes of 128 rows x 64, each kv chunk read by both warpgroups:
//   twice the rows of the backward's blocks, half its stream of W^T.
// - Pipeline: the q chunks that fit stay resident (all of them at D <= 512,
//   128 KB); one producer thread keeps the kv chunks, and past the resident
//   ones the q chunks beside them, in flight through a ring of 16 KB slots,
//   each released by both warpgroups once the product past it completes;
//   a producer warp stages each tile's bias (-inf past V) in a small ring.
//   fwd_plan (ops/softmax_ce.py) picks the resident chunks and the slots:
//   eight and five at D = 512, two and eleven at D = 128, six and seven at
//   D = 1,024 (ten of K's sixteen q chunks stream: a deeper ring beat more
//   resident rows there).  The logits are formed once over all of D: the
//   forward has no D-wide output.
// - Two accumulators a warpgroup: tile t's first chunk is issued before
//   tile t - 1's epilogue runs, so the tensor cores work while the
//   special-function unit takes the exponentials.  Each tile ends with
//   its products retired and the epilogue has no divergent branch: else
//   ptxas serializes every wgmma (its warnings C7514, C7518) and the
//   overlap is lost.
// - Epilogue: each thread keeps an online (m, s) of its fragment's two
//   rows over its own columns (m in natural units; exp is 2^x of the
//   special-function unit on log2-unit arguments); the one thread holding
//   a row's target column stores t (a store, not a one-hot sum) at the
//   tile's end; the quads merge once at the end, and ms_merge_kernel
//   merges the vocab splits in split order (deterministic).
//
// bf16 backward design (ce_bwd_dh_kernel, ce_bwd_dw_kernel: wgmma + TMA,
// sm_90a).  Both are one kernel body, shaped like an attention forward
// with the softmax replaced by gp: a block owns 64 "q" rows, resident in
// shared memory, and walks 64-row "kv" tiles; per tile it forms the logits
// q . kv^T over D, turns them into gp in registers, and multiplies gp by
// the same kv tile into an output [64 q, slice of D] held in registers.
// - dh: q = rows of h, kv = rows of W^T (vocab columns), out = dh; the
//   vocab is split over grid.y into fp32 partials, summed in split order by
//   sum_splits_kernel (deterministic, no atomics).  N = 1,024 gives 16 row
//   blocks, so 8 splits fill the card.
// - dW: q = rows of W^T, kv = rows of h, out = dW^T, over every row tile;
//   db sums the fp32 gp beside it; each element of dW and db is written
//   once (782 vocab blocks at V = 50,000).
// - Why W^T: with both operands [rows, D] row-major, one TMA box of 64 rows
//   x 64 of K (128 bytes, 128-byte swizzle) serves both products: K-major
//   as the logits' B (n = kv, k = d) and MN-major as the output product's B
//   (k = kv, n = d), read with wgmma's transpose bit (legal for bf16;
//   hopper.cuh::smem_desc_mn).  With W as it is stored, dW's logits would
//   need an MN-major A and the two kernels two layouts; the transposing
//   cast costs what the plain cast did (one read of W, one bf16 write).
// - Warp roles: consumer warpgroups 0 and 1 each compute the logits [64 q,
//   64 kv] over half of K (2 of each chunk's 4 K steps: wgmma m64n64k16,
//   K-major; m64n32 halves of the kv rows read 1.5x the shared memory a
//   clock the SM serves), hand each other the partial sums of the other's
//   32 kv through shared memory, form gp of their 32 kv from the
//   accumulator fragment and write it as bf16 straight into the
//   128-byte-swizzled A operand of the output product, which both read;
//   each then accumulates half the slice's columns (m64nNWk16 with the
//   transposed B, NW = 256 at D = 512: a 64 x 512 fp32 tile is 256
//   registers a thread for one warpgroup, 128 for each of two).  Two named
//   barriers a tile: the exchange (which also shows both warpgroups'
//   previous output product complete, so gp is free) and gp's writes.
//   Warpgroup 2 produces: one thread the q rows and the pass chunks, one
//   the slice chunks, one warp each tile's kv terms (bias, or the rows' ga,
//   gb, lse, target) into shared memory beside them, so that no global
//   load waits in the epilogue.  exp is 2^x of the special-function unit
//   on arguments in log2 units.
// - Pipeline: the q rows load once.  A tile's kv rows arrive as 8 KB K
//   chunks: the slice's chunks into a slot of n_own (released when the
//   output product that reads them completes, which the next tile's first
//   logits group shows), any others into a ring of n_pass pass slots (each
//   released as the logits product past it completes).  The plan
//   (ops/softmax_ce.py::bwd_plan) picks the slots that fit: at D = 512 two
//   slots of a tile (64 KB each) beside the 64 KB of q rows and 24 KB of
//   gp and exchange, so a tile's loads overlap the previous tile's
//   products.
// - D > 512: the output is cut into slices of 512 (256, 128 where 512 does
//   not divide D) over grid.z (dh) or grid.y (dW), each slice recomputing
//   the logits over all of D: at D = 1,024 the logits are computed twice
//   per (q, kv) pair, 3 products' work for 2, as before.  Only the slice's
//   q chunks stay resident; each pass slot brings a q chunk beside its kv
//   chunk (the q rows kept whole would leave room for too few pass slots
//   to keep the L2 busy).
// - Traffic: the L2 streams W^T once per 64-row block for dh (16 x 51 MB
//   at N = 1,024, D = 512) and h once per 64-column block for dW (782 x 1
//   MB): at ~5.8 TB/s about 0.14 ms each, above the 0.106 ms the products
//   take at the bf16 peak; a 2-CTA cluster multicasting each kv chunk
//   halved that traffic and read no faster, so the tiles are bound by
//   their own latency (the epilogue's exponentials and the two barriers
//   leave the tensor cores idle), not by the L2.
// fp32 forward design (ce_fwd_f32_kernel; exact fp32 FMAs on the CUDA
// cores, no TF32 and no tensor-core instruction: the parity mode needs
// unrounded operands), replacing _ce_fwd_kernel in fp32.
// - Bound: operations, 2 N D V (0.78 ms at N = 1,024, D = 512, V = 50,000
//   at 67 TFLOP/s).  W (102 MB in fp32) comes from HBM about once: the row
//   blocks of a split walk the same W tiles together.
// - The main loop is the LSTM scan's fp32 GEMM (gemm_f32.cuh): 128 rows x
//   128 vocab columns a block tile, 8 x 8 a thread, K chunks of 16 through
//   two shared-memory stages, the next chunk's loads in flight under the
//   FMAs, one barrier a chunk, two blocks an SM.  h is its K-major A
//   (through registers, transposed and swizzled on the way in) and W its
//   [K][N] B, 16 bytes along V a copy, stored as it lies by cp.async: no
//   register holds it under the FMAs.  The fetch is unconditional, as in
//   the scan's loop: under a branch (c + 1 < total) the compiler placed it
//   after the chunk's FMAs, and the loads' latency showed every chunk
//   (NVIDIA H100 80GB HBM3, 700 W, 50 calls in a row at D = 512: 1.45 ms;
//   1.24 unconditional; 1.19 with W by cp.async, as the scan's GEMM alone
//   at the same shape; PERF.md).
// - The chunk stream runs across the tiles of the block's vocab split, so
//   a tile's epilogue (bias, mask past V, online (m, s) with accurate expf;
//   gemm_f32.cuh's lse_tile, shared with the fp32 head) runs under the next
//   tile's first loads; its callback stores t where a column equals the
//   row's target (the block's 128 targets in shared memory: the loop fills
//   the 128-register cap).  A row's target column lies in one tile of one
//   split, so one thread of the grid writes t: no atomics, and t of a
//   target outside [0, V) keeps the caller's 0.
// - Splits: ops/softmax_ce.py::fwd_plan_f32 fills one wave of 2 x 132
//   blocks (8 row blocks x 33 splits of 12 tiles at N = 1,024, V =
//   50,000); ms_merge_kernel merges them in split order (deterministic).
//
// fp32 backward design (ce_bwd_dh_f32_kernel<Q>, ce_bwd_dw_f32_kernel<Q>:
// one body, bwd_f32_body<DW, Q>; exact fp32 FMAs on the CUDA cores, no
// TF32 and no tensor-core instruction).
// - Bound: operations, 2 products of 2 N D V (1.56 ms at N = 1,024, D =
//   512, V = 50,000 at 67 TFLOP/s).
// - A block of 256 threads owns Q "q" rows (dh: rows of h; dW: vocabulary
//   columns) and walks tiles of KV = 8,192 / Q "kv" (dh: the vocabulary
//   columns of its split; dW: every row of h).  Per tile: (1) the logits
//   [Q x KV, as rows of h x columns] over all of D, 8 x 4 a thread, from K
//   chunks of 32 rows of h^T and of W, both [k][*] and copied as they lie
//   (float4 cp.async); (2) gp in fp32, unrounded, into shared memory; (3)
//   the output product into the q rows' [Q, slice of D] held in registers,
//   128 floats a thread (8 q x 16 columns, 0.19 floats read a FMA): dh[q][d]
//   += sum_kv gp[q][kv] W[d][kv] from chunks of 8 columns of W ([d][8],
//   read float4 along kv, the halves swapped on odd d / 4 so that a warp's
//   32 rows fall on 8 distinct bank quads), dW[d][q] += sum_kv h[kv][d]
//   gp[kv][q] from chunks of 8 rows of h (read float4 along d).  W (dh) or
//   h (dW) is read twice a tile, from the L2; the logits are formed once:
//   Q = 64 at D <= 512, 32 up to D = 1,024 (the output in registers caps Q
//   D at 32,768).  Past D = 1,024 the output is cut into slices of at most
//   1,024 over grid.z, each recomputing the logits.
// - Registers bound the design: the output's 128 and the logits' 32 a
//   thread leave room under 255 for the next k's operands (the loads are
//   written one step ahead), so one block of 8 warps an SM.  An 8 x 8
//   logits tile (0.25 floats a FMA against 0.375) left no room for that
//   prefetch and read slower on the H100; 512 threads at 128 registers
//   spilled (PERF.md).
// - One cp.async ring of 4 slots carries both kinds of chunk in one
//   sequence (1,024 FMAs a thread each); a slot's copies arrive on its
//   full barrier (cp.async.mbarrier.arrive), each warp releases it on its
//   empty barrier, and a thread refills the slot of the chunk before once
//   every warp has read it: warps run up to three chunks apart, meeting at
//   a block barrier only around gp, twice a tile.  h^T (the wrapper's
//   transposed copy, 2 MB at N = 1,024, D = 512) keeps the logits' A
//   operand a plain [k][row] copy; W is read in its own layout (padded to a
//   multiple of 4 columns only where V is not).
// - A tile's terms (bias; ga, gb, lse, target) ride with its first chunk
//   (4-byte cp.async); gp = ga exp(l + b - lse) + gb onehot(y) with expf.
//   dW's db: each thread sums its gp's 8 rows per column, the sums meet in
//   ty order at the next chunk, then over tiles in order (deterministic).
// - Grid: dh row blocks x vocab splits (one wave of one block an SM; the
//   splits' partials summed in split order by sum_splits_kernel); dW vocab
//   blocks, each walking every row tile.  The row blocks of one split
//   walk the same W tiles together, so W comes from HBM about once.
#include "common.cuh"
#include "gemm_f32.cuh"
#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr float NEG = -1e30f;

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
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

// ------------------------------------------------------ split merges

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

// ------------------------------------------------- backward (bf16): wgmma

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

constexpr int WG = 128;                // threads of a warpgroup
constexpr int CH = 64 * 128;           // a chunk: 64 rows x 64 bf16 of K, 8 KB
constexpr int MAX_OWN = 4, MAX_PASS = 8;
constexpr int SMEM_SMALL = (1 + 2 * MAX_OWN + 2 * MAX_PASS) * 8;  // the barriers
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory a block may use
constexpr float LOG2E = 1.4426950408889634f;

// The launch plan, made by ops/softmax_ce.py::bwd_plan: n_own slots of a
// tile's slice chunks, n_pass slots of its other chunks (each a kv chunk
// and the q chunk of the same K); the vocab tiles of a dh split.
struct BwdPlan {
  int n_own, n_pass, tiles_per_split;
};

// The slice's q chunks, the slots, gp, the logits' exchange (two chunks),
// each slice slot's kv terms, the barriers, and the 1,024 bytes that align
// the swizzled chunks.
size_t bwd_smem(int NW, const BwdPlan& p) {
  const int own = NW / 32;
  return 1024 + (size_t)(own + p.n_own * own + 2 * p.n_pass + 3) * CH + p.n_own * 4 * 64 * 4 +
         SMEM_SMALL;
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, the special-function unit's
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One backward kernel, written once for both: a block owns 64 "q" rows and
// a slice of 2 NW output columns, and walks 64-row "kv" tiles, each a K
// operand of the logits and then the B operand of the output product:
//   dh (DW false): q = rows of h, kv = vocabulary columns (rows of W^T),
//       out[q][d] = dh, summed over the split's vocab tiles;
//   dW (DW true):  q = vocabulary columns (rows of W^T), kv = rows of h,
//       out[q][d] = dW^T, summed over every row tile; db on the side.
// tm_q, tm_kv: tensor maps of the two bf16 operands, [rows, D] row-major,
// boxes of 64 rows x 64 (128 bytes, swizzled).  Warpgroups 0 and 1 consume
// (warpgroup g: the logits [64 q, 64 kv] over K steps 2 g and 2 g + 1 of
// every chunk, then gp of kv 32 g .. + 31, then the output's columns NW g
// .. + NW - 1 of the slice); warpgroup 2 produces (one thread the q chunks
// and the pass chunks, one the slice chunks, one warp the kv terms).
template <bool DW, int NW>
__device__ __forceinline__ void bwd_body(const CUtensorMap* tm_q, const CUtensorMap* tm_kv,
                                         const float* __restrict__ bias,
                                         const int* __restrict__ y,
                                         const float* __restrict__ ga,
                                         const float* __restrict__ gb,
                                         const float* __restrict__ lse,
                                         float* __restrict__ out, float* __restrict__ db,
                                         int N, int D, int V, int ldo, BwdPlan p) {
  constexpr int OWN = NW / 32;  // K chunks of a slice
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nd = D / 64, z = DW ? blockIdx.y : blockIdx.z, zc0 = z * OWN;
  unsigned char* qbuf = smem;                               // [OWN] the slice's q
  unsigned char* ownbuf = qbuf + OWN * CH;                  // [n_own][OWN] chunks
  unsigned char* passbuf = ownbuf + p.n_own * OWN * CH;     // [n_pass][kv, q] chunks
  unsigned char* gpbuf = passbuf + p.n_pass * 2 * CH;       // gp, 64 x 64 bf16
  float* xbuf = reinterpret_cast<float*>(gpbuf + CH);       // [2][16][WG] logits halves
  float* terms = xbuf + 2 * 16 * WG;                        // [n_own][4][64]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(terms + p.n_own * 4 * 64);
  uint64_t* own_full = qfull + 1;
  uint64_t* own_empty = own_full + MAX_OWN;
  uint64_t* pass_full = own_empty + MAX_OWN;
  uint64_t* pass_empty = pass_full + MAX_PASS;

  const int q0 = blockIdx.x * 64;
  const int kv_tiles = ((DW ? N : V) + 63) / 64;
  const int t_begin = DW ? 0 : blockIdx.y * p.tiles_per_split;
  const int nt = DW ? kv_tiles : min(p.tiles_per_split, kv_tiles - t_begin);
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    jlm::mbar_init(qfull, 1);
    for (int s = 0; s < MAX_OWN; ++s) {
      jlm::mbar_init(&own_full[s], 1 + 32);        // the TMA thread, the terms warp
      jlm::mbar_init(&own_empty[s], 2 * WG / 32);  // every consumer warp
    }
    for (int s = 0; s < MAX_PASS; ++s) {
      jlm::mbar_init(&pass_full[s], 1);
      jlm::mbar_init(&pass_empty[s], 2 * WG / 32);
    }
    jlm::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producers: one thread loads the q chunks once and then each
    // tile's pass chunks (the K chunks outside the slice), another each
    // tile's slice chunks, so that a slice slot refills as soon as it frees
    // (the consumers take a tile's pass chunks first), and one warp the kv
    // terms of each tile into its slice slot's share ----
    jlm::setmaxnreg_dec<40>();
    if (nt > 0 && threadIdx.x == 2 * WG) {
      jlm::prefetch_map(tm_q);
      jlm::prefetch_map(tm_kv);
      jlm::mbar_expect_tx(qfull, OWN * CH);
      for (int c = 0; c < OWN; ++c) jlm::tma_load(qbuf + c * CH, tm_q, qfull, (zc0 + c) * 64, q0);
      int pc = 0;
      for (int t = 0; t < nt; ++t) {
        const int kv0 = (t_begin + t) * 64;
        for (int dc = 0; dc < nd; ++dc) {
          if (dc >= zc0 && dc < zc0 + OWN) continue;
          const int s = pc % p.n_pass;
          if (pc >= p.n_pass) jlm::mbar_wait(&pass_empty[s], ((pc / p.n_pass) - 1) & 1);
          unsigned char* slot = passbuf + s * 2 * CH;
          jlm::mbar_expect_tx(&pass_full[s], 2 * CH);
          jlm::tma_load(slot, tm_kv, &pass_full[s], dc * 64, kv0);
          jlm::tma_load(slot + CH, tm_q, &pass_full[s], dc * 64, q0);
          ++pc;
        }
      }
    } else if (nt > 0 && threadIdx.x == 2 * WG + 32) {
      for (int t = 0; t < nt; ++t) {
        const int kv0 = (t_begin + t) * 64, s = t % p.n_own;
        if (t >= p.n_own) jlm::mbar_wait(&own_empty[s], ((t / p.n_own) - 1) & 1);
        jlm::mbar_expect_tx(&own_full[s], OWN * CH);
        for (int oc = 0; oc < OWN; ++oc)
          jlm::tma_load(ownbuf + (s * OWN + oc) * CH, tm_kv, &own_full[s], (zc0 + oc) * 64, kv0);
      }
    } else if (nt > 0 && threadIdx.x / 32 == 2 * WG / 32 + 2) {
      // (dh) the vocab columns' bias log2 e; (dW) the rows' ga, gb, lse
      // log2 e and target; zero (a target of -1) past V or N
      const int lane = threadIdx.x & 31;
      for (int t = 0; t < nt; ++t) {
        const int kv0 = (t_begin + t) * 64, s = t % p.n_own;
        if (t >= p.n_own) jlm::mbar_wait(&own_empty[s], ((t / p.n_own) - 1) & 1);
        float* tb = terms + s * 4 * 64;
        for (int c = lane; c < 64; c += 32) {
          const int kv = kv0 + c;
          if constexpr (DW) {
            const bool ok = kv < N;
            tb[c] = ok ? ga[kv] : 0.0f;
            tb[64 + c] = ok ? gb[kv] : 0.0f;
            tb[128 + c] = ok ? lse[kv] * LOG2E : 0.0f;
            tb[192 + c] = __int_as_float(ok ? y[kv] : -1);
          } else {
            tb[c] = kv < V ? bias[kv] * LOG2E : 0.0f;
          }
        }
        jlm::mbar_arrive(&own_full[s]);  // release: the consumers' wait sees the stores
      }
    }
    return;
  }

  // ---- consumers ----
  jlm::setmaxnreg_inc<232>();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3, tid = threadIdx.x % WG;
  const int qr = 16 * warp + lane / 4;  // + 8 i: the fragment's q rows
  const int cq = 2 * (lane & 3);        // + 8 j + e: its columns
  float oacc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) oacc[i] = 0.0f;
  float lacc[32] = {};
  float dbacc[2] = {0.0f, 0.0f};
  // the q rows' terms: (dh) target, ga, gb, lse log2 e of the rows; (dW) the
  // vocab columns' bias log2 e.  Rows past N (columns past V) read zero
  // from TMA and get zero terms, so their gp is 0 or, past V, meets the
  // zero rows of W^T; nothing of theirs is stored.
  int qy[2];
  float qga[2], qgb[2], q2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + qr + 8 * i;
    const bool ok = q < (DW ? V : N);
    qy[i] = !DW && ok ? y[q] : -1;
    qga[i] = !DW && ok ? ga[q] : 0.0f;
    qgb[i] = !DW && ok ? gb[q] : 0.0f;
    q2[i] = ok ? (DW ? bias[q] : lse[q]) * LOG2E : 0.0f;
  }
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) jlm::mbar_arrive(bar);
  };
  // descriptors of the operands' first bytes: an operand `b` bytes on is
  // d + b / 16 (the start address field; no carry below 256 KB)
  const uint64_t d_q = jlm::smem_desc(qbuf + 64 * wg);   // this warpgroup's K steps
  const uint64_t d_own = jlm::smem_desc(ownbuf + 64 * wg);
  const uint64_t d_pass = jlm::smem_desc(passbuf + 64 * wg);
  const uint64_t d_gp = jlm::smem_desc(gpbuf);
  const uint64_t d_out = jlm::smem_desc_mn(ownbuf + wg * (NW / 64) * CH, CH);
  if (nt > 0) jlm::mbar_wait(qfull, 0);

  int pc = 0;
  for (int t = 0; t < nt; ++t) {
    const int kv0 = (t_begin + t) * 64;
    // ---- logits [64 q, 64 kv], this warpgroup's half of K (2 of each
    // chunk's 4 K steps): the pass chunks, each released as the product
    // past it completes (the first completes out(t - 1) and frees tile
    // t - 1's slice chunks) ----
    int prev = -1;  // pass slot of the previous chunk
    for (int dc = 0; dc < nd; ++dc) {
      if (dc >= zc0 && dc < zc0 + OWN) continue;
      const int s = pc % p.n_pass;
      jlm::mbar_wait(&pass_full[s], (pc / p.n_pass) & 1);
      const uint32_t slot = s * 2 * CH;
      jlm::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 2; ++k)
        jlm::wgmma_bf16_n64(lacc, d_pass + ((slot + CH + 32 * k) >> 4),
                            d_pass + ((slot + 32 * k) >> 4), prev >= 0 || k > 0);
      jlm::wgmma_commit();
      jlm::fence_regs(lacc);
      jlm::wgmma_wait<1>();
      if (prev < 0) {
        if (t > 0) release(&own_empty[(t - 1) % p.n_own]);
      } else {
        release(&pass_empty[prev]);
      }
      prev = s;
      ++pc;
    }
    // ---- ... and the slice's chunks, kept for the output product ----
    const int so = t % p.n_own;
    jlm::mbar_wait(&own_full[so], (t / p.n_own) & 1);
    jlm::wgmma_fence();
#pragma unroll
    for (int oc = 0; oc < OWN; ++oc)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        jlm::wgmma_bf16_n64(lacc, d_q + ((oc * CH + 32 * k) >> 4),
                            d_own + (((so * OWN + oc) * CH + 32 * k) >> 4),
                            prev >= 0 || oc > 0 || k > 0);
    jlm::wgmma_commit();
    jlm::fence_regs(lacc);
    jlm::wgmma_wait<1>();
    if (prev < 0) {
      if (t > 0) release(&own_empty[(t - 1) % p.n_own]);
    } else {
      release(&pass_empty[prev]);
    }
    jlm::wgmma_wait<0>();
    jlm::fence_regs(lacc);

    // ---- the halves of K meet: each warpgroup hands the other its partial
    // logits of the other's 32 kv (the same fragment positions, thread by
    // thread); the barrier also shows both warpgroups' out(t - 1) complete,
    // so gp is free ----
    auto exchange = [&](auto half) {
      constexpr int G = decltype(half)::value;
      float* mine = xbuf + G * 16 * WG + tid;
#pragma unroll
      for (int k = 0; k < 16; ++k) mine[k * WG] = lacc[16 * (1 - G) + k];
      jlm::named_sync(1, 2 * WG);
      const float* theirs = xbuf + (1 - G) * 16 * WG + tid;
#pragma unroll
      for (int k = 0; k < 16; ++k) lacc[16 * G + k] += theirs[k * WG];
    };
    if (wg == 0)
      exchange(std::integral_constant<int, 0>());
    else
      exchange(std::integral_constant<int, 1>());

    // ---- gp = ga exp(l - lse) + gb onehot(y) of this warpgroup's 32 kv,
    // rounded to bf16 into the output product's A operand [64 q][64 kv]
    // (K-major, 128-byte swizzle; db sums the unrounded values).  exp is
    // 2^x from the special-function unit on arguments in log2 units (a few
    // ulp of fp32, far inside gp's bf16 rounding) ----
    const float* tb = terms + so * 4 * 64;  // the tile's kv terms
    auto epilogue = [&](auto half) {
      constexpr int G = decltype(half)::value;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int ql = qr + 8 * i;
          float g[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 32 * G + 8 * j + cq + e;
            const float l = lacc[16 * G + 4 * j + 2 * i + e];
            if constexpr (DW) {
              g[e] = tb[c] * ex2(fmaf(l, LOG2E, q2[i] - tb[128 + c])) +
                     (q0 + ql == __float_as_int(tb[192 + c]) ? tb[64 + c] : 0.0f);
              dbacc[i] += g[e];
            } else {
              g[e] = qga[i] * ex2(fmaf(l, LOG2E, tb[c] - q2[i])) +
                     (kv0 + c == qy[i] ? qgb[i] : 0.0f);
            }
          }
          *reinterpret_cast<uint32_t*>(gpbuf + ql * 128 + (((4 * G + j) ^ (ql & 7)) << 4) +
                                       4 * (lane & 3)) = pack_bf16(g[0], g[1]);
        }
    };
    if (wg == 0)
      epilogue(std::integral_constant<int, 0>());
    else
      epilogue(std::integral_constant<int, 1>());
    jlm::fence_proxy_async();  // the stores, before wgmma reads them
    jlm::named_sync(1, 2 * WG);

    // ---- out[64 q][this warpgroup's NW columns] += gp @ kv tile: B is the
    // slice chunks read MN-major (K = kv rows, N = columns of D) ----
    jlm::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      jlm::wgmma_bf16_tb<NW>(oacc, d_gp + ((32 * ks) >> 4),
                             d_out + ((so * OWN * CH + 2048 * ks) >> 4), 1);
    jlm::wgmma_commit();
    jlm::fence_regs(oacc);
  }
  jlm::wgmma_wait<0>();
  jlm::fence_regs(oacc);

  // ---- store: dh rows into the split's partial; dW^T's rows as dW's
  // columns (each 8 neighbouring vocab columns one 32-byte sector) ----
  const int col0 = z * 2 * NW + wg * NW;
  if constexpr (!DW) {
    float* o = out + (size_t)blockIdx.y * N * D;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + qr + 8 * i;
        if (row < N)
          *reinterpret_cast<float2*>(o + (size_t)row * D + col0 + 8 * j + cq) =
              make_float2(oacc[4 * j + 2 * i], oacc[4 * j + 2 * i + 1]);
      }
  } else {
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int v = q0 + qr + 8 * i;
        if (v < V) {
          out[(size_t)(col0 + 8 * j + cq) * ldo + v] = oacc[4 * j + 2 * i];
          out[(size_t)(col0 + 8 * j + cq + 1) * ldo + v] = oacc[4 * j + 2 * i + 1];
        }
      }
    if (z == 0) {  // db: the quad's lanes, then the two warpgroups' kv halves
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1)
          dbacc[i] += __shfl_xor_sync(0xffffffffu, dbacc[i], off);
      if ((lane & 3) == 0) {  // (xbuf is free: every exchange is read)
        xbuf[wg * 64 + qr] = dbacc[0];
        xbuf[wg * 64 + qr + 8] = dbacc[1];
      }
      jlm::named_sync(1, 2 * WG);
      if (threadIdx.x < 64 && q0 + threadIdx.x < V)
        db[q0 + threadIdx.x] = xbuf[threadIdx.x] + xbuf[64 + threadIdx.x];
    }
  }
}

// dh partials: tm_h over h [N, D], tm_wt over W^T [V, D]; grid row blocks x
// vocab splits x slices of D.
template <int NW>
__global__ void __launch_bounds__(3 * WG, 1)
ce_bwd_dh_kernel(const __grid_constant__ CUtensorMap tm_h,
                 const __grid_constant__ CUtensorMap tm_wt, const float* __restrict__ bias,
                 const int* __restrict__ y, const float* __restrict__ ga,
                 const float* __restrict__ gb, const float* __restrict__ lse,
                 float* __restrict__ dh_part, int N, int D, int V, BwdPlan p) {
  bwd_body<false, NW>(&tm_h, &tm_wt, bias, y, ga, gb, lse, dh_part, nullptr, N, D, V, D, p);
}

// dW [D, ldw] and db: grid vocab blocks x slices of D (slice 0 writes db).
template <int NW>
__global__ void __launch_bounds__(3 * WG, 1)
ce_bwd_dw_kernel(const __grid_constant__ CUtensorMap tm_wt,
                 const __grid_constant__ CUtensorMap tm_h, const float* __restrict__ bias,
                 const int* __restrict__ y, const float* __restrict__ ga,
                 const float* __restrict__ gb, const float* __restrict__ lse,
                 float* __restrict__ dW, float* __restrict__ db, int N, int D, int V, int ldw,
                 BwdPlan p) {
  bwd_body<true, NW>(&tm_wt, &tm_h, bias, y, ga, gb, lse, dW, db, N, D, V, ldw, p);
}

// Checks a plan against the kernel's rules (ops/softmax_ce.py::bwd_plan
// makes them so): a slice of 2 NW columns that divides D, 1-4 slice slots
// (2 or more where every chunk is the slice's: a slot frees only once the
// next tile's products are issued), 2-8 pass slots where there are pass
// chunks, and the shared memory within a block's.
bool bwd_plan_ok(int D, int NW, const BwdPlan& p) {
  const bool pass = D > 2 * NW;
  return D % (2 * NW) == 0 && p.n_own >= (pass ? 1 : 2) && p.n_own <= MAX_OWN &&
         (pass ? p.n_pass >= 2 : p.n_pass == 0) && p.n_pass <= MAX_PASS &&
         bwd_smem(NW, p) <= SMEM_LIMIT;
}

template <int NW>
cudaError_t launch_dh(const void* h, const void* wt, const float* bias, const int* y,
                      const float* ga, const float* gb, const float* lse, float* dh_part,
                      int N, int D, int V, int splits, const BwdPlan& p, cudaStream_t st) {
  CUtensorMap th, tw;
  if (!bwd_plan_ok(D, NW, p) || !jlm::tensor_map(&th, h, 2, N, D, D, 64, 64) ||
      !jlm::tensor_map(&tw, wt, 2, V, D, D, 64, 64))
    return cudaErrorInvalidValue;
  const size_t smem = bwd_smem(NW, p);
  cudaError_t err = set_smem(ce_bwd_dh_kernel<NW>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + 63) / 64, splits, D / (2 * NW));
  ce_bwd_dh_kernel<NW><<<grid, 3 * WG, smem, st>>>(th, tw, bias, y, ga, gb, lse, dh_part, N,
                                                   D, V, p);
  return cudaGetLastError();
}

template <int NW>
cudaError_t launch_dw(const void* h, const void* wt, const float* bias, const int* y,
                      const float* ga, const float* gb, const float* lse, float* dW,
                      float* db, int N, int D, int V, const BwdPlan& p, cudaStream_t st) {
  CUtensorMap th, tw;
  if (!bwd_plan_ok(D, NW, p) || !jlm::tensor_map(&th, h, 2, N, D, D, 64, 64) ||
      !jlm::tensor_map(&tw, wt, 2, V, D, D, 64, 64))
    return cudaErrorInvalidValue;
  const size_t smem = bwd_smem(NW, p);
  cudaError_t err = set_smem(ce_bwd_dw_kernel<NW>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((V + 63) / 64, D / (2 * NW));
  ce_bwd_dw_kernel<NW><<<grid, 3 * WG, smem, st>>>(tw, th, bias, y, ga, gb, lse, dW, db, N,
                                                   D, V, V, p);
  return cudaGetLastError();
}

// ------------------------------------------------- forward (bf16): wgmma

constexpr int FT = 128;              // q rows of a block; kv rows of a tile
constexpr int SUB = FT * 128;        // a slot: a K chunk of 128 rows x 64 bf16, 16 KB
constexpr int MAX_SUB = 12, NB = 4;  // ring slots at most; bias slots

// The launch plan, made by ops/softmax_ce.py::fwd_plan: the q chunks kept
// resident (the first n_res of K), the ring's slots, the vocab tiles of a
// split.
struct FwdPlan {
  int n_res, n_sub, tiles_per_split;
};

// The resident q chunks, the ring, the bias slots, the barriers, and the
// 1,024 bytes that align the swizzled chunks.
size_t fwd_smem(const FwdPlan& p) {
  return 1024 + (size_t)(p.n_res + p.n_sub) * SUB + NB * FT * 4 +
         (1 + 2 * MAX_SUB + 2 * NB) * 8;
}

// Checks a plan against the kernel's rules (fwd_plan makes them so): a
// slot for the chunk in flight and one for the next (two of each where q
// chunks stream beside kv chunks), the shared memory within a block's.
bool fwd_plan_ok(int D, const FwdPlan& p) {
  const int nd = D / 64;
  return D > 0 && D % 128 == 0 && p.n_res >= 0 && p.n_res <= nd &&
         p.n_sub >= (p.n_res < nd ? 4 : 2) && p.n_sub <= MAX_SUB && p.tiles_per_split > 0 &&
         fwd_smem(p) <= SMEM_LIMIT;
}

// Per-row partial (m, s) of the split's vocab tiles and the target logit:
// tm_q over h [N, D], tm_kv over W^T [V, D] (boxes of 128 rows x 64,
// swizzled); grid row blocks x vocab splits.  Warpgroups 0 and 1 consume
// (rows 64 g .. 64 g + 63 of the block), warpgroup 2 produces (one thread
// the chunks, one warp the bias).
__global__ void __launch_bounds__(3 * WG, 1)
ce_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_kv, const float* __restrict__ bias,
                   const int* __restrict__ y, float* __restrict__ m_part,
                   float* __restrict__ s_part, float* __restrict__ t_out, int N, int D, int V,
                   FwdPlan p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qbuf = smem;                                  // [n_res] resident q chunks
  unsigned char* ring = qbuf + p.n_res * SUB;                  // [n_sub] kv or q chunks
  float* tb = reinterpret_cast<float*>(ring + p.n_sub * SUB);  // [NB][FT] bias, -inf past V
  uint64_t* qfull = reinterpret_cast<uint64_t*>(tb + NB * FT);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + MAX_SUB;
  uint64_t* bfull = empty + MAX_SUB;
  uint64_t* bempty = bfull + NB;

  const int nd = D / 64, q0 = blockIdx.x * FT;
  const int t_begin = blockIdx.y * p.tiles_per_split;
  const int nt = min(p.tiles_per_split, (V + FT - 1) / FT - t_begin);
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    jlm::mbar_init(qfull, 1);
    for (int s = 0; s < MAX_SUB; ++s) {
      jlm::mbar_init(&full[s], 1);
      jlm::mbar_init(&empty[s], 2 * WG / 32);  // every consumer warp
    }
    for (int s = 0; s < NB; ++s) {
      jlm::mbar_init(&bfull[s], 32);  // the bias warp
      jlm::mbar_init(&bempty[s], 2 * WG / 32);
    }
    jlm::mbar_fence_init();
  }
  __syncthreads();
  if (nt <= 0) return;

  if (wg == 2) {
    // ---- producers: one thread the resident q chunks once, then each
    // tile's kv chunks (and, past the resident ones, the q chunk of the
    // same K) in order through the ring; one warp each tile's bias ----
    jlm::setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * WG) {
      jlm::prefetch_map(&tm_q);
      jlm::prefetch_map(&tm_kv);
      if (p.n_res > 0) {
        jlm::mbar_expect_tx(qfull, p.n_res * SUB);
        for (int c = 0; c < p.n_res; ++c)
          jlm::tma_load(qbuf + c * SUB, &tm_q, qfull, c * 64, q0);
      }
      int pos = 0;
      auto load = [&](const CUtensorMap* map, int col, int row) {
        const int s = pos % p.n_sub;
        if (pos >= p.n_sub) jlm::mbar_wait(&empty[s], ((pos / p.n_sub) - 1) & 1);
        jlm::mbar_expect_tx(&full[s], SUB);
        jlm::tma_load(ring + s * SUB, map, &full[s], col, row);
        ++pos;
      };
      for (int t = 0; t < nt; ++t)
        for (int dc = 0; dc < nd; ++dc) {
          load(&tm_kv, dc * 64, (t_begin + t) * FT);
          if (dc >= p.n_res) load(&tm_q, dc * 64, q0);
        }
    } else if (threadIdx.x / 32 == 2 * WG / 32 + 1) {
      const int lane = threadIdx.x & 31;
      for (int t = 0; t < nt; ++t) {
        const int kv0 = (t_begin + t) * FT, s = t % NB;
        if (t >= NB) jlm::mbar_wait(&bempty[s], ((t / NB) - 1) & 1);
        for (int c = lane; c < FT; c += 32)
          tb[s * FT + c] = kv0 + c < V ? bias[kv0 + c] : -INFINITY;
        jlm::mbar_arrive(&bfull[s]);  // release: the consumers' wait sees the stores
      }
    }
    return;
  }

  // ---- consumers ----
  jlm::setmaxnreg_inc<232>();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // + 8 i: the fragment's rows
  const int cq = 2 * (lane & 3);                         // + 8 j + e: its columns
  int qy[2];  // the rows' targets; -1 (no column) outside [0, V) and past N
  float m[2] = {NEG, NEG}, s[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const int yr = row < N ? y[row] : -1;
    qy[i] = (unsigned)yr < (unsigned)V ? yr : -1;
  }
  float acc[2][FT / 2];  // tile t's logits in acc[t % 2]
  // descriptors of the operands' first bytes (+ bytes / 16 further on):
  // this warpgroup's rows of a resident q chunk or of a q chunk in the
  // ring, and the kv rows of a ring slot
  const uint64_t d_q = jlm::smem_desc(qbuf + wg * 64 * 128);
  const uint64_t d_rq = jlm::smem_desc(ring + wg * 64 * 128);
  const uint64_t d_kv = jlm::smem_desc(ring);

  // ---- a tile's target logits, from its raw logits (nothing in flight):
  // the one thread that holds a row's target column stores it ----
  auto target = [&](float (&a)[FT / 2], int t) {
    const int kv0 = (t_begin + t) * FT, sb = t % NB;
    jlm::mbar_wait(&bfull[sb], (t / NB) & 1);
    const float* b = tb + sb * FT;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = qy[i] - kv0;  // the target's column in the tile
      if ((unsigned)c < (unsigned)FT && (c & 6) == cq) {
        float l = 0.0f;
#pragma unroll
        for (int j = 0; j < FT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * j + cq + e == c) l = a[4 * j + 2 * i + e];
        t_out[row0 + 8 * i] = l + b[c];
      }
    }
  };

  // ---- a tile's epilogue, with no branch that could diverge (ptxas then
  // serializes the wgmma in flight beside it): bias, online (m, s) of the
  // two rows over this thread's 32 columns ----
  auto epilogue = [&](float (&a)[FT / 2], int t) {
    const int sb = t % NB;  // (target(t) has waited for the tile's bias)
    const float* b = tb + sb * FT;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < FT / 8; ++j) {
      const float2 bj = *reinterpret_cast<const float2*>(b + 8 * j + cq);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[4 * j + 2 * i] += bj.x;
        a[4 * j + 2 * i + 1] += bj.y;
        mx[i] = fmaxf(mx[i], fmaxf(a[4 * j + 2 * i], a[4 * j + 2 * i + 1]));
      }
    }
    __syncwarp();
    if (lane == 0) jlm::mbar_arrive(&bempty[sb]);  // the tile's bias is read
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float ml = mx[i] * LOG2E;
      float sum = s[i] * ex2(fmaf(m[i], LOG2E, -ml));
#pragma unroll
      for (int j = 0; j < FT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) sum += ex2(fmaf(a[4 * j + 2 * i + e], LOG2E, -ml));
      s[i] = sum;
      m[i] = mx[i];
    }
  };

  // ---- chunk dc of a tile's logits into a: wait for its slots (a kv
  // chunk, and a q chunk past the resident ones), issue, commit ----
  int pos = 0;
  auto issue = [&](float (&a)[FT / 2], int dc, int& skv, int& sq) {
    skv = pos % p.n_sub;
    jlm::mbar_wait(&full[skv], (pos / p.n_sub) & 1);
    ++pos;
    sq = -1;
    uint64_t da = d_q + ((dc * SUB) >> 4);
    if (dc >= p.n_res) {
      sq = pos % p.n_sub;
      jlm::mbar_wait(&full[sq], (pos / p.n_sub) & 1);
      ++pos;
      da = d_rq + ((sq * SUB) >> 4);
    }
    const uint64_t db = d_kv + ((skv * SUB) >> 4);
    jlm::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)  // K steps of 16: 32 bytes on in the swizzled rows
      jlm::wgmma_bf16_n128(a, da + 2 * k, db + 2 * k, dc > 0 || k > 0);
    jlm::wgmma_commit();
    jlm::fence_regs(a);
  };
  auto release = [&](int skv, int sq) {
    __syncwarp();
    if (lane == 0) {
      jlm::mbar_arrive(&empty[skv]);
      if (sq >= 0) jlm::mbar_arrive(&empty[sq]);
    }
  };

  // ---- tile t into acc[P]: its first chunk issued, then (EPI) tile t - 1's
  // epilogue while that chunk runs, then the other chunks, each chunk's
  // slots released once the product past them completes; the tile ends
  // retired (no group in flight across tiles) with its targets stored ----
  auto tile = [&](auto par, auto epi, int t) {
    constexpr int P = decltype(par)::value;
    int pk, pq;  // the slots of the chunk before
    issue(acc[P], 0, pk, pq);
    if constexpr (decltype(epi)::value) epilogue(acc[1 - P], t - 1);
    for (int dc = 1; dc < nd; ++dc) {
      int skv, sq;
      issue(acc[P], dc, skv, sq);
      jlm::wgmma_wait<1>();
      release(pk, pq);
      pk = skv;
      pq = sq;
    }
    jlm::wgmma_wait<0>();
    jlm::fence_regs(acc[P]);
    release(pk, pq);
    target(acc[P], t);
  };

  if (p.n_res > 0) jlm::mbar_wait(qfull, 0);
  tile(std::integral_constant<int, 0>(), std::false_type(), 0);
  for (int t = 1; t < nt; t += 2) {
    tile(std::integral_constant<int, 1>(), std::true_type(), t);
    if (t + 1 < nt) tile(std::integral_constant<int, 0>(), std::true_type(), t + 1);
  }
  if ((nt - 1) & 1)
    epilogue(acc[1], nt - 1);
  else
    epilogue(acc[0], nt - 1);

  // ---- the quad's lanes merge; one lane a row stores the split's (m, s) ----
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[i], off);
      merge_ms(m[i], s[i], m2, s2);
    }
    const int row = row0 + 8 * i;
    if ((lane & 3) == 0 && row < N) {
      m_part[(size_t)blockIdx.y * N + row] = m[i];
      s_part[(size_t)blockIdx.y * N + row] = s[i];
    }
  }
}

// W [D, V] (fp32 or bf16) -> W^T bf16 [V, Dp], zero columns D .. Dp - 1: the
// step's one bf16 cast of W, for the forward and the backward, transposed
// in the same pass, in tiles of 64 x 64 through shared memory (rows read
// and written whole, 256 and 128 bytes).
template <typename T>
__global__ void __launch_bounds__(256)
cast_wt_kernel(const T* __restrict__ W, bf16* __restrict__ wt, int D, int V, int Dp) {
  __shared__ float tile[64][65];
  const int v0 = blockIdx.x * 64, d0 = blockIdx.y * 64;
  for (int i = threadIdx.x; i < 64 * 64; i += 256) {
    const int r = i / 64, c = i % 64, d = d0 + r, v = v0 + c;
    float x = 0.0f;
    if (d < D && v < V) {
      if constexpr (std::is_same<T, float>::value)
        x = W[(size_t)d * V + v];
      else
        x = __bfloat162float(W[(size_t)d * V + v]);
    }
    tile[r][c] = x;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * 32; i += 256) {
    const int r = i / 32, c = 2 * (i % 32), v = v0 + r;
    if (v < V)
      *reinterpret_cast<__nv_bfloat162*>(wt + (size_t)v * Dp + d0 + c) =
          __floats2bfloat162_rn(tile[c][r], tile[c + 1][r]);
  }
}

// ---------------------------------------------------------- fp32 compute

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The fp32 forward (design at the top): h [N, D] (D a multiple of 16), W
// [D, ldw] as it lies (zero past V up to ldw, a multiple of 4).  Grid: (row
// blocks of 128, vocab splits of tiles_per_split 128-column tiles).  The
// main loop is gemm_f32.cuh's: h the K-major A (through registers), W the
// [K][N] B (cp.async straight into its stage); the chunk stream runs
// across the split's tiles, so chunk c + 1's loads (the next tile's first
// where c is a tile's last) are in flight during chunk c's FMAs and the
// tile's epilogue, the online lse (lse_tile) whose callback stores the one
// logit of a row that its target names.
__global__ void __launch_bounds__(THREADS, 2)
ce_fwd_f32_kernel(const float* __restrict__ h, const float* __restrict__ W, int ldw,
                  const float* __restrict__ bias, const int* __restrict__ y,
                  float* __restrict__ m_part, float* __restrict__ s_part,
                  float* __restrict__ t_out, int N, int D, int V, int tiles_per_split) {
  using namespace jlm::gemm;
  extern __shared__ __align__(16) float fsm[];
  float* sA = fsm;                      // [2][TILE] h chunks, [k][row] swizzled
  float* sB = sA + 2 * TILE;            // [2][TILE] W chunks, [k][col] as they lie
  float* sL = sB + 2 * TILE;            // [LSE_FLOATS] the online lse's state
  int* sY = reinterpret_cast<int*>(sL + LSE_FLOATS);  // [BM] targets, -1 where none
  const int tid = threadIdx.x, ty = ty_of(tid), tx = tx_of(tid);
  const int m0 = blockIdx.x * BM;
  const int n_tiles = (V + BN - 1) / BN, vt0 = blockIdx.y * tiles_per_split;
  const int nt = max(0, min(vt0 + tiles_per_split, n_tiles) - vt0);
  const int nkc = D / BK, total = nt * nkc;

  float4 ra[2];
  // tile t's chunk kc: W's by cp.async into stage buf, h's into registers
  auto fetch = [&](int t, int kc, int buf) {
    const int k0 = kc * BK, n0 = (vt0 + t) * BN;
#pragma unroll
    for (int p = 0; p < 2; ++p)
      copy_kn(sB + buf * TILE, W, ldw, k0, D, D, n0, ldw, tid + THREADS * p);
    jlm::cp_async_commit();
#pragma unroll
    for (int p = 0; p < 2; ++p) ra[p] = kmajor_at(h, D, m0, N, k0, D, D, tid + THREADS * p);
  };
  auto put = [&](int buf) {  // h's registers into stage buf; W's copies landed
#pragma unroll
    for (int p = 0; p < 2; ++p) put_kmajor(sA + buf * TILE, tid + THREADS * p, ra[p]);
    jlm::cp_async_wait<0>();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  lse_init(sL, tid);
  if (tid < BM) {  // a target outside [0, V) matches no column, not even one past V
    const int row = m0 + tid, yr = row < N ? y[row] : -1;
    sY[tid] = yr >= 0 && yr < V ? yr : -1;
  }
  fetch(0, 0, 0);
  put(0);
  __syncthreads();
  for (int c = 0, t = 0, kc = 0; c < total; ++c) {
    const int buf = c & 1, t1 = kc + 1 == nkc ? t + 1 : t, kc1 = kc + 1 == nkc ? 0 : kc + 1;
    // unconditional, as in the scan's loop (past the split's last tile it
    // loads data no tile uses): a fetch under a branch was placed after
    // the FMAs, its loads' latency exposed every chunk
    fetch(t1, kc1, buf ^ 1);  // buf ^ 1 was last read in chunk c - 1
    chunk_fma<false>(acc, sA + buf * TILE, sB + buf * TILE, ty, tx);
    if (kc + 1 == nkc) {  // tile t's epilogue; one thread of the grid owns a row's target
      const int n0 = (vt0 + t) * BN;
      lse_tile(acc, sL, bias, n0, V, tid, tx, [&](int i, int j, float x) {
        const int r = row_of(ty, i);
        if (n0 + col_of(tx, j) == sY[r]) t_out[m0 + r] = x;
      });
    }
    put(buf ^ 1);
    __syncthreads();
    t = t1;
    kc = kc1;
  }
  lse_finish(sL, m_part, s_part, blockIdx.y, m0, N, tid, ty, tx);
}

// Dynamic shared memory of ce_fwd_f32_kernel: the two stages of both
// operands, the online lse's state and the block's targets.
constexpr int FWD_F32_SMEM = (4 * jlm::gemm::TILE + jlm::gemm::LSE_FLOATS + jlm::gemm::BM) * 4;

// ------------------------------------------------- backward (fp32): FMAs

namespace bf32 {
constexpr int THR = 256;       // threads of a block
constexpr int TILE = 8192;     // logits of a tile
constexpr int LR = 8, LC = 4;  // a thread's logits: rows x columns
constexpr int BK = 32;         // K chunk of the logits product
constexpr int BV = 8;          // kv chunk of the output product
constexpr int NS = 4;          // ring slots
constexpr int OUT = 32768;     // q rows x slice columns of the output
constexpr int NJ = OUT / 8 / THR;  // a thread's output columns for its 8 q rows
constexpr int SW = 1024;       // widest output slice
}  // namespace bf32

// A block of Q "q" rows (dh: rows of h; dW: vocabulary columns) walks tiles
// of KV "kv" (dh: vocabulary columns; dW: rows of h).  The logits tile is R
// rows of h x C vocabulary columns (Q x KV or KV x Q), its threads TY x TX
// of LR x LC, a warp WY x WX of them; the output product's threads are QG
// groups of 8 q rows x KG groups of the slice's columns.
template <bool DW, int Q>
struct Bf32 {
  static constexpr int KV = bf32::TILE / Q;
  static constexpr int R = DW ? KV : Q, C = DW ? Q : KV;
  static constexpr int TY = R / bf32::LR, TX = C / bf32::LC;
  static constexpr int WX = TX < 8 ? TX : 8, WY = 32 / WX;
  static constexpr int QG = Q / 8, KG = bf32::THR / QG;
  static_assert((TY / WY) * (TX / WX) == bf32::THR / 32, "the warps tile the logits");
  static_assert(KG * bf32::NJ * Q == bf32::OUT, "the threads tile the output");
  static_assert(KG % 8 == 0, "dh's W swizzle is the same for a thread's columns");
};

// Floats of a ring slot: a logits chunk (BK rows of h^T and of W) or an
// output chunk (dh: BV columns of W's slice rows; dW: BV rows of h's slice
// columns, each padded by 4 floats).
__host__ __device__ __forceinline__ int bf32_slot(int q, int sw) {
  const int a = bf32::BK * (q + bf32::TILE / q), b = bf32::BV * (sw + 4);
  return a > b ? a : b;
}

// Shared memory of a block: the ring's barriers and slots, gp [R][C], db's
// partial sums [TY][C] (dW), the tile's terms (bias of C columns; ga, gb,
// lse, target of R rows).
size_t bwd_f32_smem(bool dw, int q, int sw) {
  const int kv = bf32::TILE / q, r = dw ? kv : q, c = dw ? q : kv;
  return sizeof(float) * ((size_t)4 * bf32::NS + bf32::NS * bf32_slot(q, sw) + bf32::TILE +
                          (dw ? bf32::TILE / bf32::LR : 0) + 4 * r + c);
}

// One body for both fp32 backward kernels (see the file's header).  The
// block's chunks run as one sequence through an NS-slot cp.async ring: per
// tile, D / BK logits chunks (h^T rows and W rows, both [k][*]), then KV /
// BV output chunks (dh: W[slice][kv .. kv + BV), [k][BV], the float4 halves
// swapped on odd k / 4; dW: h[kv .. kv + BV)[slice]).
// hT is h transposed [D, ldh], W is [D, ldw] (both zero past N and V up to
// ldh and ldw, multiples of 4); out is dh_part [splits][N][D] or dW [D][V].
template <bool DW, int Q>
__device__ __forceinline__ void bwd_f32_body(
    const float* __restrict__ h, const float* __restrict__ hT, const float* __restrict__ W,
    const float* __restrict__ bias, const int* __restrict__ y, const float* __restrict__ ga,
    const float* __restrict__ gb, const float* __restrict__ lse, float* __restrict__ out,
    float* __restrict__ db, int N, int ldh, int D, int V, int ldw, int sw, int tiles_per_split) {
  using S = Bf32<DW, Q>;
  using namespace bf32;
  constexpr int R = S::R, C = S::C, KV = S::KV;
  extern __shared__ __align__(16) float smem_bf32[];
  const int slot = bf32_slot(Q, sw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_bf32);  // [NS] every thread's copies
  uint64_t* empty = full + NS;                              // [NS] every warp's reads
  float* ring = smem_bf32 + 4 * NS;
  float* gp = ring + NS * slot;               // [R][C]
  float* red = gp + TILE;                     // [TY][C] (dW)
  float* tbias = red + (DW ? TILE / LR : 0);  // [C]
  float* tga = tbias + C;                     // [R] each
  float* tgb = tga + R;
  float* tlse = tgb + R;
  int* tyy = reinterpret_cast<int*>(tlse + R);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = (warp % (S::TY / S::WY)) * S::WY + lane / S::WX;
  const int tx = (warp / (S::TY / S::WY)) * S::WX + lane % S::WX;
  const int qg = tid / S::KG, kg = tid % S::KG;
  const int k0 = blockIdx.z * sw, wz = min(sw, D - k0);  // the slice's columns of D
  const int ldc = wz + 4;                                // dW: a row of an output chunk
  const int q0 = blockIdx.x * Q;
  const int t0 = DW ? 0 : blockIdx.y * tiles_per_split;
  const int nt = DW ? (N + KV - 1) / KV : min(tiles_per_split, (V + KV - 1) / KV - t0);
  const int nl = D / BK, per = nl + KV / BV, total = max(nt, 0) * per;
  // tile t: its first row of h and first vocabulary column
  auto row0 = [&](int t) { return DW ? t * KV : q0; };
  auto col0 = [&](int t) { return DW ? q0 : (t0 + t) * KV; };

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      jlm::mbar_init(&full[i], THR);
      jlm::mbar_init(&empty[i], THR / 32);
    }
    jlm::mbar_fence_init();
  }
  __syncthreads();

  // dh's output chunk [k][BV]: float4 g of row k at g ^ swz(k), so that a
  // warp's 32 neighbouring rows of one g fall on 8 distinct bank quads
  auto swz = [](int k) { return (k / (32 / BV)) % (BV / 4); };

  // ---- chunk c's loads into its slot (and, with a tile's first chunk,
  // the tile's terms), arriving on the slot's full barrier as they land;
  // zeros past ldh, ldw, N and V ----
  int it = 0, ip = 0;  // the tile and chunk of the next chunk to issue
  auto issue = [&](int c) {
    if (c >= total) return;
    float* s = ring + (c % NS) * slot;
    const int t = it, p = ip, r0 = row0(t), c0 = col0(t);
    if (++ip == per) ip = 0, ++it;
    if (p < nl) {
      const int kb = p * BK;
#pragma unroll
      for (int it = 0; it < (BK * R / 4 + THR - 1) / THR; ++it) {
        const int i = tid + it * THR, kk = i / (R / 4), r = 4 * (i % (R / 4));
        const bool ok = r0 + r < ldh;
        if (i < BK * R / 4)
          jlm::cp_async16(s + kk * R + r, hT + (size_t)(kb + kk) * ldh + (ok ? r0 + r : 0), ok);
      }
      float* sb = s + BK * R;
#pragma unroll
      for (int it = 0; it < (BK * C / 4 + THR - 1) / THR; ++it) {
        const int i = tid + it * THR, kk = i / (C / 4), cc = 4 * (i % (C / 4));
        const bool ok = c0 + cc < ldw;
        if (i < BK * C / 4)
          jlm::cp_async16(sb + kk * C + cc, W + (size_t)(kb + kk) * ldw + (ok ? c0 + cc : 0),
                          ok);
      }
      if (p == 0) {
        for (int i = tid; i < C; i += THR)
          jlm::cp_async4(tbias + i, bias + (c0 + i < V ? c0 + i : 0), c0 + i < V);
        for (int i = tid; i < R; i += THR) {
          const bool ok = r0 + i < N;
          const int m = ok ? r0 + i : 0;
          jlm::cp_async4(tga + i, ga + m, ok);
          jlm::cp_async4(tgb + i, gb + m, ok);
          jlm::cp_async4(tlse + i, lse + m, ok);
          jlm::cp_async4(tyy + i, y + m, ok);
        }
      }
    } else if constexpr (!DW) {
      const int n0 = c0 + (p - nl) * BV;
      for (int i = tid; i < BV / 4 * wz; i += THR) {
        const int kk = i / (BV / 4), g = i % (BV / 4), n = n0 + 4 * g;
        const bool ok = n < ldw;
        jlm::cp_async16(s + kk * BV + 4 * (g ^ swz(kk)),
                        W + (size_t)(k0 + kk) * ldw + (ok ? n : 0), ok);
      }
    } else {
      const int m0 = r0 + (p - nl) * BV;
      for (int i = tid; i < BV / 4 * wz; i += THR) {
        const int mm = i % BV, k4 = 4 * (i / BV);
        const bool ok = m0 + mm < N;
        jlm::cp_async16(s + mm * ldc + k4, h + (size_t)(ok ? m0 + mm : 0) * D + k0 + k4, ok);
      }
    }
    jlm::cp_async_arrive(&full[c % NS]);
  };

  // the logits' rows and columns of the thread: 4 ty + (i % 4) + (i / 4) R / 2,
  // 4 tx + (j % 4) + (j / 4) C / 2
  auto lrow = [&](int i) { return (i / 4) * (R / 2) + 4 * ty + (i & 3); };
  auto lcol = [&](int j) { return (j / 4) * (C / 2) + 4 * tx + (j & 3); };
  float o[8][NJ];  // dh [8 q rows][NJ columns]; dW^T [8 q columns][NJ rows of D]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[i][j] = 0.0f;
  float acc[LR][LC];
  float dbacc = 0.0f;  // dW: db of column tid (tid < C)

  // Warps run up to NS - 1 chunks apart: a chunk waits for its slot's copies
  // (full), a slot is refilled once every warp has read it (empty), and only
  // gp meets a block barrier, twice a tile.
  for (int c = 0; c < NS - 1; ++c) issue(c);
  for (int c = 0, t = 0, p = 0; c < total; ++c, p = p + 1 == per ? 0 : p + 1, t += p == 0) {
    const float* s = ring + (c % NS) * slot;
    jlm::mbar_wait(&full[c % NS], (c / NS) & 1);
    if (p < nl) {
      // ---- logits += h^T chunk x W chunk, LR x LC a thread; the next k's
      // operands load under this k's FMAs ----
      if (p == 0) {
#pragma unroll
        for (int i = 0; i < LR; ++i)
#pragma unroll
          for (int j = 0; j < LC; ++j) acc[i][j] = 0.0f;
      }
      const float* sb = s + BK * R;
      float4 a[2][LR / 4], b[2][LC / 4];
      auto fetch = [&](int k, int buf) {
#pragma unroll
        for (int u = 0; u < LR / 4; ++u) a[buf][u] = ld4(s + k * R + u * (R / 2) + 4 * ty);
#pragma unroll
        for (int u = 0; u < LC / 4; ++u) b[buf][u] = ld4(sb + k * C + u * (C / 2) + 4 * tx);
      };
      fetch(0, 0);
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        if (k + 1 < BK) fetch(k + 1, (k + 1) & 1);
        const float* av = reinterpret_cast<const float*>(a[k & 1]);
        const float* bv = reinterpret_cast<const float*>(b[k & 1]);
#pragma unroll
        for (int i = 0; i < LR; ++i)
#pragma unroll
          for (int j = 0; j < LC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (p == nl - 1) {
        // ---- gp = ga exp(l + b - lse) + gb onehot(y), fp32, 0 past N and V,
        // into shared memory once every thread has read the last tile's;
        // dW: the column sums of the thread's rows ----
        __syncthreads();
        const int r0 = row0(t), c0 = col0(t);
        float dsum[LC] = {};
#pragma unroll
        for (int i = 0; i < LR; ++i) {
          const int r = lrow(i), m = r0 + r;
          const float ga_ = tga[r], gb_ = tgb[r], l = tlse[r];
          const int yr = tyy[r];
          float v[LC];
#pragma unroll
          for (int j = 0; j < LC; ++j) {
            const int cc = lcol(j), n = c0 + cc;
            v[j] = m < N && n < V ? ga_ * expf(acc[i][j] + tbias[cc] - l) + (n == yr ? gb_ : 0.0f)
                                  : 0.0f;
            if constexpr (DW) dsum[j] += v[j];
          }
#pragma unroll
          for (int u = 0; u < LC / 4; ++u)
            *reinterpret_cast<float4*>(gp + r * C + lcol(4 * u)) =
                make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]);
        }
        if constexpr (DW) {
#pragma unroll
          for (int u = 0; u < LC / 4; ++u)
            *reinterpret_cast<float4*>(red + ty * C + lcol(4 * u)) =
                make_float4(dsum[4 * u], dsum[4 * u + 1], dsum[4 * u + 2], dsum[4 * u + 3]);
        }
      }
    } else if constexpr (!DW) {
      // ---- dh[8 q][NJ columns] += gp[q][kv .. kv + 8) W[column][kv .. kv + 8):
      // gp read as a broadcast, W float4 along kv (a warp's 32 rows of a
      // step on 8 distinct bank quads).  Columns past the slice are
      // computed from the slot's other floats and never stored ----
      const int vb = (p - nl) * BV;
      if (p == nl) __syncthreads();  // gp is written
#pragma unroll
      for (int part = 0; part < BV / 4; ++part) {
        float4 g[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) g[i] = ld4(gp + (8 * qg + i) * C + vb + 4 * part);
        // swz(kg + KG j) is swz(kg): KG is a multiple of 8
        const float* wb = s + kg * BV + 4 * (part ^ swz(kg));
        float4 w[2];
        auto wat = [&](int j) { return ld4(wb + S::KG * BV * j); };
        w[0] = wat(0);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j + 1 < NJ) w[(j + 1) & 1] = wat(j + 1);
          const float4 x = w[j & 1];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            o[i][j] = fmaf(g[i].x, x.x, o[i][j]);
            o[i][j] = fmaf(g[i].y, x.y, o[i][j]);
            o[i][j] = fmaf(g[i].z, x.z, o[i][j]);
            o[i][j] = fmaf(g[i].w, x.w, o[i][j]);
          }
        }
      }
    } else {
      // ---- dW^T[8 q][NJ rows of D] += gp[kv][q] h[kv][rows of D], kv by kv;
      // the tile's first output chunk also sums db's partials in ty order.
      // Rows of D past the slice as in dh ----
      const int vb = (p - nl) * BV;
      if (p == nl) {
        __syncthreads();  // gp and db's partials are written
        if (tid < C) {
#pragma unroll 8
          for (int r = 0; r < S::TY; ++r) dbacc += red[r * C + tid];
        }
      }
#pragma unroll
      for (int mm = 0; mm < BV; ++mm) {
        const float4 g0 = ld4(gp + (vb + mm) * C + 8 * qg), g1 = ld4(gp + (vb + mm) * C + 8 * qg + 4);
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int j = 0; j < NJ / 4; ++j) {
          const float4 hv = ld4(s + mm * ldc + 4 * (kg + S::KG * j));
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            o[e][4 * j] = fmaf(gv[e], hv.x, o[e][4 * j]);
            o[e][4 * j + 1] = fmaf(gv[e], hv.y, o[e][4 * j + 1]);
            o[e][4 * j + 2] = fmaf(gv[e], hv.z, o[e][4 * j + 2]);
            o[e][4 * j + 3] = fmaf(gv[e], hv.w, o[e][4 * j + 3]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) jlm::mbar_arrive(&empty[c % NS]);
    // chunk c - 1's slot takes chunk c + NS - 1 once every warp has read it
    if (c >= 1 && c + NS - 1 < total) jlm::mbar_wait(&empty[(c - 1) % NS], ((c - 1) / NS) & 1);
    issue(c + NS - 1);
  }

  // ---- store: dh rows into the split's partial (a warp's 32 neighbouring
  // columns a store); dW^T's 8 vocabulary columns of each row of D as two
  // float4 where V allows; db by slice 0 ----
  if constexpr (!DW) {
    float* base = out + (size_t)blockIdx.y * N * D + k0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + 8 * qg + i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kk = kg + S::KG * j;
        if (row < N && kk < wz) base[(size_t)row * D + kk] = o[i][j];
      }
    }
  } else {
    const int n = q0 + 8 * qg;
    const bool vec = (V & 3) == 0 && n + 8 <= V;
#pragma unroll
    for (int j = 0; j < NJ / 4; ++j) {
      const int kk = 4 * (kg + S::KG * j);
      if (kk >= wz) continue;
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        float* row = out + (size_t)(k0 + kk + e4) * V + n;
        if (vec) {
          *reinterpret_cast<float4*>(row) =
              make_float4(o[0][4 * j + e4], o[1][4 * j + e4], o[2][4 * j + e4], o[3][4 * j + e4]);
          *reinterpret_cast<float4*>(row + 4) =
              make_float4(o[4][4 * j + e4], o[5][4 * j + e4], o[6][4 * j + e4], o[7][4 * j + e4]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (n + e < V) row[e] = o[e][4 * j + e4];
        }
      }
    }
    if (blockIdx.z == 0 && tid < C && q0 + tid < V) db[q0 + tid] = dbacc;
  }
}

#define BF32_PARAMS                                                                          \
  const float *__restrict__ h, const float *__restrict__ hT, const float *__restrict__ W,   \
      const float *__restrict__ bias, const int *__restrict__ y,                             \
      const float *__restrict__ ga, const float *__restrict__ gb,                            \
      const float *__restrict__ lse, float *__restrict__ out, float *__restrict__ db, int N, \
      int ldh, int D, int V, int ldw, int sw, int tiles_per_split
#define BF32_ARGS h, hT, W, bias, y, ga, gb, lse, out, db, N, ldh, D, V, ldw, sw, tiles_per_split

// dh partials [splits][N][D]: grid row blocks x vocab splits x slices of D.
template <int Q>
__global__ void __launch_bounds__(bf32::THR, 1) ce_bwd_dh_f32_kernel(BF32_PARAMS) {
  bwd_f32_body<false, Q>(BF32_ARGS);
}

// dW [D, V] and db [V]: grid vocab blocks x 1 x slices of D (slice 0 writes db).
template <int Q>
__global__ void __launch_bounds__(bf32::THR, 1) ce_bwd_dw_f32_kernel(BF32_PARAMS) {
  bwd_f32_body<true, Q>(BF32_ARGS);
}

using Bf32Kernel = void (*)(BF32_PARAMS);

template <bool DW>
Bf32Kernel bf32_kernel(int q) {
  switch (q) {
    case 32: return DW ? ce_bwd_dw_f32_kernel<32> : ce_bwd_dh_f32_kernel<32>;
    case 64: return DW ? ce_bwd_dw_f32_kernel<64> : ce_bwd_dh_f32_kernel<64>;
    case 128: return DW ? ce_bwd_dw_f32_kernel<128> : ce_bwd_dh_f32_kernel<128>;
    case 256: return DW ? ce_bwd_dw_f32_kernel<256> : ce_bwd_dh_f32_kernel<256>;
    default: return nullptr;
  }
}

// Checks the plan (ops/softmax_ce.py::bwd_plan_f32 makes it so) and launches:
// q rows a block, output slices of sw columns (a multiple of 128, q sw
// within the 128 accumulators a thread), ldh and ldw multiples of 4.
template <bool DW>
cudaError_t launch_bwd_f32(BF32_PARAMS, int q, int splits, cudaStream_t st) {
  const Bf32Kernel kernel = bf32_kernel<DW>(q);
  if (kernel == nullptr || D <= 0 || D % 128 || sw <= 0 || sw % 128 || sw > bf32::SW ||
      q * sw > bf32::OUT || ldh % 4 || ldh < N || ldw % 4 || ldw < V || splits < 1)
    return cudaErrorInvalidValue;
  const size_t smem = bwd_f32_smem(DW, q, sw);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((DW ? V : N) + q - 1) / q, splits, (D + sw - 1) / sw);
  kernel<<<grid, bf32::THR, smem, st>>>(BF32_ARGS);
  return cudaGetLastError();
}

cudaError_t sum_splits(const float* part, float* out, size_t count, int splits,
                       cudaStream_t st) {
  const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  sum_splits_kernel<<<blocks, 256, 0, st>>>(part, out, count, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32 compute: h [N, D] (D a multiple of 16) and W [D, ldw] fp32 (zero past
// V up to ldw, a multiple of 4; rows 16-byte aligned), bias [V] fp32, y [N]
// int32 (a target outside [0, V) matches no column); m_part/s_part [splits,
// N] scratch; m_out/s_out [N]; t_out [N] must be zeroed by the caller (rows
// whose target is in range get their logit written); the plan (splits,
// tiles_per_split) as ops/softmax_ce.py::fwd_plan_f32 makes it.
int jlm_ce_fwd_f32(const float* h, const float* W, const float* bias, const int* y,
                   float* m_part, float* s_part, float* m_out, float* s_out, float* t_out,
                   int N, int D, int V, int ldw, int splits, int tiles_per_split,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % jlm::gemm::BK || ldw % 4 || ldw < V || splits < 1 || tiles_per_split < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(ce_fwd_f32_kernel, FWD_F32_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + jlm::gemm::BM - 1) / jlm::gemm::BM, splits);
  ce_fwd_f32_kernel<<<grid, THREADS, FWD_F32_SMEM, st>>>(h, W, ldw, bias, y, m_part, s_part,
                                                         t_out, N, D, V, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ms_merge_kernel<<<(N + 255) / 256, 256, 0, st>>>(m_part, s_part, m_out, s_out, N, splits);
  return (int)cudaGetLastError();
}

// bf16 compute on wgmma: h [N, D] and wt = W^T [V, D] bf16 (D a multiple of
// 128, rows 16-byte aligned), the rest as jlm_ce_fwd_f32; the plan (n_res,
// n_sub, splits, tiles_per_split) as ops/softmax_ce.py::fwd_plan makes it.
int jlm_ce_fwd_bf16(const void* h, const void* wt, const float* bias, const int* y,
                    float* m_part, float* s_part, float* m_out, float* s_out, float* t_out,
                    int N, int D, int V, int n_res, int n_sub, int splits,
                    int tiles_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FwdPlan p{n_res, n_sub, tiles_per_split};
  CUtensorMap tq, tk;
  if (!fwd_plan_ok(D, p) || !jlm::tensor_map(&tq, h, 2, N, D, D, FT, 64) ||
      !jlm::tensor_map(&tk, wt, 2, V, D, D, FT, 64))
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(p);
  cudaError_t err = set_smem(ce_fwd_bf16_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + FT - 1) / FT, splits);
  ce_fwd_bf16_kernel<<<grid, 3 * WG, smem, st>>>(tq, tk, bias, y, m_part, s_part, t_out, N, D,
                                                 V, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ms_merge_kernel<<<(N + 255) / 256, 256, 0, st>>>(m_part, s_part, m_out, s_out, N, splits);
  return (int)cudaGetLastError();
}

// fp32 compute: hT = h^T [D, ldh] and W [D, ldw] fp32 (zero past N and V up
// to ldh and ldw, multiples of 4), bias [V], y [N] int32 (a target outside
// [0, V) matches no column), ga, gb, lse [N] fp32; the plan (q, sw, splits,
// tiles_per_split) as ops/softmax_ce.py::bwd_plan_f32 makes it.  dh_part
// [splits, N, D] fp32 (may equal dh when splits == 1), dh [N, D].
int jlm_ce_bwd_dh_f32(const float* hT, const float* W, const float* bias, const int* y,
                      const float* ga, const float* gb, const float* lse, float* dh_part,
                      float* dh, int N, int ldh, int D, int V, int ldw, int q, int sw,
                      int splits, int tiles_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      launch_bwd_f32<false>(nullptr, hT, W, bias, y, ga, gb, lse, dh_part, nullptr, N, ldh, D,
                            V, ldw, sw, tiles_per_split, q, splits, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)sum_splits(dh_part, dh, (size_t)N * D, splits, st);
}

// As jlm_ce_bwd_dh_f32, with h [N, D] itself too; dW [D, V] and db [V]
// fp32, each element written once.
int jlm_ce_bwd_dw_f32(const float* h, const float* hT, const float* W, const float* bias,
                      const int* y, const float* ga, const float* gb, const float* lse,
                      float* dW, float* db, int N, int ldh, int D, int V, int ldw, int q, int sw,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)launch_bwd_f32<true>(h, hT, W, bias, y, ga, gb, lse, dW, db, N, ldh, D, V, ldw, sw,
                                   0, q, 1, st);
}

// W [D, V] row-major, fp32 (w_bf16 = 0) or bf16 -> wt [V, Dp] bf16 (Dp a
// multiple of 64, >= D), zero past D.
int jlm_ce_cast_wt(const void* W, void* wt, int D, int V, int Dp, int w_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((V + 63) / 64, Dp / 64);
  if (w_bf16)
    cast_wt_kernel<bf16><<<grid, 256, 0, st>>>(static_cast<const bf16*>(W),
                                               static_cast<bf16*>(wt), D, V, Dp);
  else
    cast_wt_kernel<float><<<grid, 256, 0, st>>>(static_cast<const float*>(W),
                                                static_cast<bf16*>(wt), D, V, Dp);
  return (int)cudaGetLastError();
}

// bf16 compute on wgmma: h [N, D] and wt = W^T [V, D] bf16 (D a multiple of
// 2 sw, rows 16-byte aligned), bias [V], y [N] int32 (a target outside [0,
// V) matches no column), ga, gb, lse [N] fp32; the plan (sw: the slice
// width, 128, 256, 384 or 512; n_own, n_pass, tiles_per_split) as
// ops/softmax_ce.py::bwd_plan makes it.  dh_part [splits, N, D] fp32 (may
// equal dh when splits == 1), dh [N, D].
int jlm_ce_bwd_dh_bf16(const void* h, const void* wt, const float* bias, const int* y,
                       const float* ga, const float* gb, const float* lse, float* dh_part,
                       float* dh, int N, int D, int V, int sw, int n_own,
                       int n_pass, int splits, int tiles_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdPlan p{n_own, n_pass, tiles_per_split};
  const auto launch = sw == 128 ? launch_dh<64> : sw == 256 ? launch_dh<128>
                      : sw == 384 ? launch_dh<192> : sw == 512 ? launch_dh<256> : nullptr;
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      launch(h, wt, bias, y, ga, gb, lse, dh_part, N, D, V, splits, p, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)sum_splits(dh_part, dh, (size_t)N * D, splits, st);
}

// As jlm_ce_bwd_dh_bf16; dW [D, V] and db [V] fp32, each element written once.
int jlm_ce_bwd_dw_bf16(const void* h, const void* wt, const float* bias, const int* y,
                       const float* ga, const float* gb, const float* lse, float* dW,
                       float* db, int N, int D, int V, int sw, int n_own,
                       int n_pass, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdPlan p{n_own, n_pass, 0};
  const auto launch = sw == 128 ? launch_dw<64> : sw == 256 ? launch_dw<128>
                      : sw == 384 ? launch_dw<192> : sw == 512 ? launch_dw<256> : nullptr;
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch(h, wt, bias, y, ga, gb, lse, dW, db, N, D, V, p, st);
}

}  // extern "C"
