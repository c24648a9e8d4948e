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
// Hidden slices wider than KW = 512 in the fp32 backward: what a kernel
// keeps D-wide on chip (h rows and W tiles in shared memory, dh or dW in
// registers) is cut into K chunks of at most 512.  The logits accumulate
// over the chunks, each staged in turn; a D-wide output is split over the
// grid (dh over grid.z, dW over grid.y), each slice of at most 512
// recomputing the logits and taking its chunk last, so that the chunk left
// in shared memory is the one its product needs.  ce_fwd_f32 streams K in
// chunks of 32 at every D.
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

cudaError_t sum_splits(const float* part, float* out, size_t count, int splits,
                       cudaStream_t st) {
  const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  sum_splits_kernel<<<blocks, 256, 0, st>>>(part, out, count, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32 compute: h [N, D] and W [D, V] fp32, bias [V] fp32, y [N] int32 (a
// target outside [0, V) matches no column); m_part/s_part [splits, N]
// scratch; m_out/s_out [N]; t_out [N] must be zeroed by the caller (rows
// whose target is in range get their logit written).
int jlm_ce_fwd_f32(const float* h, const float* W, const float* bias, const int* y,
                   float* m_part, float* s_part, float* m_out, float* s_out, float* t_out,
                   int N, int D, int V, int splits, int tiles_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + G_R - 1) / G_R, splits);
  ce_fwd_f32_kernel<<<grid, THREADS, 0, st>>>(h, W, bias, y, m_part, s_part, t_out, N, D, V,
                                              tiles_per_split);
  cudaError_t err = cudaGetLastError();
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

// fp32 compute: h [N, D] and W [D, V] fp32, plus ga, gb, lse [N] fp32;
// dh_part [splits, N, D] fp32 scratch (may equal dh when splits == 1); dh
// [N, D] fp32.  The grid is row blocks x splits x the 512-wide slices of D.
int jlm_ce_bwd_dh_f32(const float* h, const float* W, const float* bias, const int* y,
                      const float* ga, const float* gb, const float* lse, float* dh_part,
                      float* dh, int N, int D, int V, int splits, int tiles_per_split,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = dh_f32_smem(D);
  cudaError_t err = set_smem(ce_bwd_dh_f32_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + GH_R - 1) / GH_R, splits, (D + KW - 1) / KW);
  ce_bwd_dh_f32_kernel<<<grid, THREADS, smem, st>>>(h, W, bias, y, ga, gb, lse, dh_part, N,
                                                    D, V, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)sum_splits(dh_part, dh, (size_t)N * D, splits, st);
}

// fp32 compute; dW [D, V] and db [V] fp32, each element written once.  The
// grid is column blocks x the 512-row slices of D.
int jlm_ce_bwd_dw_f32(const float* h, const float* W, const float* bias, const int* y,
                      const float* ga, const float* gb, const float* lse, float* dW,
                      float* db, int N, int D, int V, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = dw_f32_smem(D);
  cudaError_t err = set_smem(ce_bwd_dw_f32_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((V + GW_V - 1) / GW_V, (D + KW - 1) / KW);
  ce_bwd_dw_f32_kernel<<<grid, THREADS, smem, st>>>(h, W, bias, y, ga, gb, lse, dW, db, N, D,
                                                    V);
  return (int)cudaGetLastError();
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
