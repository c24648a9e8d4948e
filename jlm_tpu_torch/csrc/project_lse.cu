// Vocab-tiled output projection with online logsumexp: per-row (m, s) or
// lse = m + log(s) of  logits = h @ W + b  over a full head or over the
// blocks of a D-softmax head.
//
// Replaces jlm_tpu/ops/project.py::_proj_kernel: the LSE-only path (the
// decode frame's normalizer, called once per frame on every beam row, once
// per D-softmax block) and, with the CAND template flag, candidate
// extraction (project_candidates*: log softmax(h @ W + b)[:, cand]).
//
// Bound.  At the serving shapes (R = 20,480 beam rows) one call is
// 2*R*sum_k(d_k*s_k) operations: 1.05 TOP for the 50k full head (H = 512),
// 0.954 TOP for the 100k D-softmax head of BASELINE config 5 (blocks of
// 16,000 x 512, 34,000 x 256, 50,000 x 128), 0.53 and 0.48 ms at the int8
// peak.  The head (25.6 and 23.3 MB in int8) stays in the 50 MB L2, so
// device memory traffic is small.  Every logit also takes one exponential:
// R*V = 1.02e9 (50k) and 2.05e9 (config 5) of them, 0.245 and 0.49 ms at
// the SFU's 16 a clock per SM (132 SMs, 1,980 MHz) -- as much as the
// product at 50k, more at config 5, whose 50,000 x 128 block is bound by
// its exponentials alone.  Logits never leave registers.
//
// Launches: one per block of the head (a full head is one block), each
// writing its vocab splits' partial (m, s) into one shared [2, splits, R]
// buffer, and one merge launch that combines splits and blocks:
// m_g = max_k m_k,  s_g = sum_k s_k * exp(m_k - m_g)  (project.py:436-440).
//
// int8 x int8 -> int32 (``int8_mxu``, the serving mode): wgmma + TMA.
// - quantize_rows_kernel, one launch for every block of the head: each
//   row's activation slice of each block to int8 exactly as
//   project.py:83-89 over the BLOCK'S OWN SLICE of h: s = max(max|h|,
//   1e-30) / 127 (an IEEE division: no --use_fast_math), q =
//   __float2int_rn(h / s) (round half to even), zero columns up to the
//   slice's padded width dp (128, 256, 512 or 1,024, or past 1,024 a
//   multiple of 128; zeros change neither the scale nor the product).  The [R, sum dp] int8 buffer and the
//   [blocks, R] row scales are read by every vocab split, so a row is
//   quantized once a call, not once a split.
// - proj_int8_kernel, per block: a block owns BM = 256 rows (128 where dp
//   = 1,024), loaded once by TMA and kept in shared memory, and walks its
//   vocab split in tiles of BN = 64 columns (32 where dp = 1,024).  Four
//   consumer warpgroups (two where dp = 1,024), one m64 tile of rows each,
//   and one producer warpgroup: its first thread streams the W^T [V, dp]
//   tiles (the head's transposed copy: K-major, the only layout 8-bit
//   wgmma takes) through a ring of TMA stages, and its second warp writes
//   each tile's column parameters (scale, bias log2e, and for CAND the
//   candidate runs and biases) beside it; full/empty mbarriers pace the
//   ring.  Each consumer runs wgmma m64nBNk32 s8.s8.s32 from shared
//   memory, 128-byte swizzled, the dp / 32 k-steps unrolled.  Shared
//   memory at dp = 512: 256 x 512 B of rows (128 KB) + 3 stages of
//   64 x 512 B + 512 B (97.5 KB) of the 227 KB a block may use; the stages
//   are as many as fit (up to 8).  L2 traffic: each row block reads the
//   head once per call, R/256 = 80 times at 50k (2.0 GB; the mma.sync
//   kernel it replaces read it 160 times, 4.1 GB), plus its rows once a
//   split.
// - The consumers take turns on the tensor cores, in a ring of named
//   barriers: each issues its product of a tile once the one before it has
//   issued its own, waits for it, and runs its epilogue while the others'
//   products run -- three epilogues a scheduler hide each other's
//   latencies.  (Two accumulator sets a warpgroup, the next tile's
//   product under this tile's epilogue, made the compiler serialize the
//   wgmma groups; two warpgroups in turn left one epilogue warp a
//   scheduler, latency-bound and longer than the products.)
// - The epilogue works in log2 units: u = (float(acc) * s_row log2e) *
//   scale_col + bias log2e, exp(v - m) = 2^(u - m) on ex2.approx (2 ulp),
//   log2e folded into the row scale and the bias, not into the product;
//   the lse is within ~1e-6 of the reference's order of operations.  A
//   candidate's logit is recomputed in the reference's order (below), so
//   it equals the plain version's bit for bit.  Where dp <= 256, float(acc)
//   by an exact integer-add trick instead of the conversion instruction,
//   which shares the special-function unit with the exponentials.
// - What bounds it (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py cases):
//   at 50k the call takes ~1.06 ms against a 0.53 ms operations bound, and
//   the products with their loads alone, in this ring, ~0.79 ms: one m64
//   tile a turn leaves gaps on the tensor cores (two warpgroups issuing
//   two m64 tiles each ran them in 0.57 ms, but left their epilogues
//   exposed).  At config 5 (~1.6 ms against 0.49) the 50,000 x 128
//   block's exponentials and epilogue dominate.
// - Splits: grid.y splits the vocab so that the row blocks x splits fill
//   whole waves of the card (the wrapper's plan).
// - Past dp = 1,024 the resident rows no longer fit beside the W^T ring
//   (128 rows x 1,024 B already take 128 KB): the slice's quantized rows
//   stream with W^T in K chunks of 128 through proj_bf16_kernel's ring
//   (Q8: 128 rows and 256 columns a tile, wgmma m64n256k32 s8 into exact
//   int32 sums, this epilogue's logits converted in place).
//
// bf16 weights and int8 weights dequantized to bf16 (``int8_mxu=False``,
// project.py:114-119): wgmma + TMA as well (proj_bf16_kernel).
// - Bound at 50k (R = 20,480, dp = 512): 1.05 TOP at the bf16 peak, 1.06
//   ms.  The first port's mma.sync kernel took 6.1 ms: W^T tiles staged
//   synchronously, mma.sync (about half of the bf16 rate), its 160 row
//   blocks of 128 re-reading the 51.2 MB bf16 W^T from the L2 (8.2 GB a
//   call, ~1.4 ms at the L2's ~5.8 TB/s), and it stopped at dp = 576.
// - The design is the bf16 cell's (lstm_cell.cu): a block owns 128 rows
//   and walks its vocab split in tiles of 256 columns; per K chunk of 64
//   one TMA load brings h's 128 x 64 and one W^T's 256 x 64 (48 KB) into a
//   ring of 4 stages; two consumer warpgroups (64 rows each) run wgmma
//   m64n256k16 on every chunk (an m64n256 product reads 80 bytes of shared
//   memory a clock at the bf16 rate, under the 128 the SM serves; n64 tiles
//   would need all 128) and release a stage as the product past it
//   completes; the gate epilogue of the cell becomes the online lse (log2
//   units, bias log2e from a ring of column parameters that a producer
//   warp writes).  h is streamed with W^T, not kept resident, so any width
//   launches; the L2 traffic is W^T once per 128 rows plus h once per 256
//   columns: 12.3 GB a call at 50k.
// - Dequant: the int8 W^T chunk (16 KB, half the bytes) arrives by TMA;
//   two producer warps write bf16(q * scale_col), rounded once, 128-byte
//   swizzled, into the stage's bf16 chunk: the dequant precedes the
//   product, as in the reference, and is not a rescale after it.
// - Measured against a first design of this kernel (PERF.md):
//   256 resident rows' worth of 64-column tiles, m64n64, two warpgroups
//   taking tiles in turn and a 2-CTA cluster multicasting each W^T chunk
//   ran slower than the mma.sync kernel: its 8 KB chunks left a fixed cost
//   each (a wait for the chunk before last, a cross-CTA release) that the
//   one chunk in flight could not hide.
// - fp32 compute (fp32 weights, or int8 dequantized to fp32 on the way
//   into shared memory; proj_ms_f32_kernel): exact fp32 FMAs on the CUDA
//   cores -- TF32 would round the operands and break the parity mode.
//   Bound at the fp32 parity run's rows (R = 512): 2 R sum_k d_k s_k = 23.8
//   GFLOP at config 5's head, 26.2 at 50k, 0.356 and 0.391 ms at 67
//   TFLOP/s.  The main loop is the LSTM scan's fp32 GEMM (gemm_f32.cuh; h
//   is its K-major A, W^T its K-major B): 128 rows x 128 vocab columns a
//   block tile, 8 x 8 a thread, K chunks of 16 through two swizzled
//   shared-memory stages, the next chunk's loads in flight under the FMAs,
//   one barrier a chunk, two blocks an SM; the chunk stream runs across the
//   split's tiles, so a tile's epilogue (the bias, the mask past V, the
//   online (m, s) with accurate expf) runs under the next tile's first
//   loads.  The int8 W^T chunk arrives as 16 bytes along k a row and is
//   converted to q * scale (rounded once) on its way into shared memory.
//   The splits fill one wave of 2 x 132 blocks (ops/project.py's
//   block_splits).  What holds it (PERF.md §6): the loop's K-major B runs
//   at the scan's NK rate (~37 TFLOP/s, not the KN case's ~42), a 50,000
//   x 128 block's tiles are 8 chunks each beside a 72-exponential
//   epilogue, and the splits' whole tiles leave part of the wave idle
//   (config 5's 34,000 x 256 block: 216 of 264 blocks).
// The ragged vocab edge is masked (columns >= V contribute exp(-inf) = 0),
// equivalent to the reference's -1e30 bias padding; m starts at -1e30.
//
// Candidate extraction (CAND, off for the lse-only calls): the wrapper
// passes the candidate ids sorted (with their output slots).  Per vocab
// tile, a thread (in the int8 kernel, the producer's parameter warp)
// binary-searches, for each column, the run of candidates equal to that
// column's global id (id_base + n; a D-softmax block's columns are a
// range of global ids), and the epilogue stores each logit that a
// candidate asks for into its [R, C] slot: the same fp32 value the online
// lse takes, from the register that holds it (the int8 kernel recomputes
// it in the reference's rounding from the same accumulator).  A
// column lies in one tile of one split of one block, so each store is
// plain, with no atomics and no sum, and repeated ids get one store each.
// The merge launch turns the raw logits into raw - (m + log s); an id that
// no column matches keeps 0 (the caller zeroes the buffer) and gets -lse,
// as the reference's one-hot product gives it.
#include "common.cuh"
#include "gemm_f32.cuh"
#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

// Weight modes; the numbering is the wrapper's (ops/project.py).
enum Mode : int { kBf16 = 0, kInt8Mxu = 1, kDequantBf16 = 2, kFp32 = 3, kDequantFp32 = 4 };

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

// Byte b (0..3) of a little-endian word, as a signed int8 value.
__device__ __forceinline__ float s8_at(uint32_t word, int b) {
  return static_cast<float>(static_cast<signed char>((word >> (8 * b)) & 0xffu));
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

// Store logit v of row into every slot [lo, hi) that asks for its column.
__device__ __forceinline__ void cand_store(const Cand& cd, int lo, int hi, int row, int R,
                                           float v) {
  if (row >= R) return;
  for (int p = lo; p < hi; ++p) cd.out[(size_t)row * cd.C + cd.slots[p]] = v;
}

// fp32 compute: h fp32 [R, ldh] (its slice, read in place), W^T fp32 [V, D]
// or int8 [V, D] with per-row (vocab) scales, dequantized on the way into
// shared memory (Q8); D a multiple of 16.  Grid: (row blocks of 128, vocab
// splits).  The main loop is the scan GEMM's (gemm_f32.cuh; h is A, W^T the
// K-major B), and the chunk stream runs across the split's tiles: chunk c
// + 1's loads, the next tile's first where c is a tile's last, are in
// flight during chunk c's FMAs and the tile's epilogue.  The epilogue is
// gemm_f32.cuh's online lse (lse_tile), whose running (m, s) lives in
// shared memory.  CAND: a tile's candidate runs (cand_table) are written
// during the tile before it, into the other of two buffers, and the
// epilogue's per-logit callback stores the logits they ask for.
template <bool Q8, bool CAND>
__global__ void __launch_bounds__(THREADS, 2)
proj_ms_f32_kernel(const float* __restrict__ h, int ldh, const void* __restrict__ wt,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   float* __restrict__ m_part, float* __restrict__ s_part, int R, int D,
                   int V, int tiles_per_split, Cand cd) {
  using namespace jlm::gemm;
  extern __shared__ __align__(16) float fsm[];
  float* sA = fsm;                      // [2][TILE] h chunks, [k][row] swizzled
  float* sB = sA + 2 * TILE;            // [2][TILE] W^T chunks, [k][col] swizzled
  float* sL = sB + 2 * TILE;            // [LSE_FLOATS] the online lse's state
  int* sLo = reinterpret_cast<int*>(sL + LSE_FLOATS);  // [2][BN] candidate runs (CAND)
  int* sHi = sLo + 2 * BN;
  const int tid = threadIdx.x, ty = ty_of(tid), tx = tx_of(tid);
  const int m0 = blockIdx.x * BM;
  const int n_tiles = (V + BN - 1) / BN, vt0 = blockIdx.y * tiles_per_split;
  const int nt = max(0, min(vt0 + tiles_per_split, n_tiles) - vt0);
  const int nkc = (D + BK - 1) / BK, total = nt * nkc;
  const float* wf = static_cast<const float*>(wt);
  const signed char* w8 = static_cast<const signed char*>(wt);

  float4 ra[2], rb[2];
  uint4 rq;
  float rsc = 0.0f;
  auto fetch = [&](int t, int kc) {  // tile t's chunk kc into registers
    const int k0 = kc * BK, n0 = (vt0 + t) * BN;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int i = tid + THREADS * p;
      ra[p] = kmajor_at(h, ldh, m0, R, k0, D, D, i);
      if constexpr (!Q8) rb[p] = kmajor_at(wf, D, n0, V, k0, D, D, i);
    }
    if constexpr (Q8) {
      if (tid < BN) {  // row n of W^T: 16 int8 along k
        const int n = n0 + tid;
        rq = ldg16_at(w8 + (size_t)min(n, V - 1) * D + k0, n < V);
        rsc = n < V ? __ldg(scale + n) : 0.0f;
      }
    }
  };
  auto put = [&](int buf) {  // the registers into stage buf
    float* a = sA + buf * TILE;
    float* b = sB + buf * TILE;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int i = tid + THREADS * p;
      put_kmajor(a, i, ra[p]);
      if constexpr (!Q8) put_kmajor(b, i, rb[p]);
    }
    if constexpr (Q8) {
      if (tid < BN) {  // q * scale[n], rounded once to fp32, before the product
        const uint32_t words[4] = {rq.x, rq.y, rq.z, rq.w};
#pragma unroll
        for (int e = 0; e < BK; ++e) b[swz(e, tid)] = s8_at(words[e >> 2], e & 3) * rsc;
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  lse_init(sL, tid);
  if (total > 0) {
    fetch(0, 0);
    put(0);
    if constexpr (CAND) cand_table(sLo, sHi, cd, vt0 * BN, BN, V);
  }
  __syncthreads();
  for (int c = 0, t = 0, kc = 0; c < total; ++c) {
    const int buf = c & 1, t1 = kc + 1 == nkc ? t + 1 : t, kc1 = kc + 1 == nkc ? 0 : kc + 1;
    if (c + 1 < total) fetch(t1, kc1);
    if constexpr (CAND) {
      if (kc == 0 && t + 1 < nt)
        cand_table(sLo + ((t + 1) & 1) * BN, sHi + ((t + 1) & 1) * BN, cd, (vt0 + t + 1) * BN,
                   BN, V);
    }
    chunk_fma<true>(acc, sA + buf * TILE, sB + buf * TILE, ty, tx);
    if (kc + 1 == nkc) {  // tile t's epilogue
      const int* lo = sLo + (t & 1) * BN;
      const int* hi = sHi + (t & 1) * BN;
      lse_tile(acc, sL, bias, (vt0 + t) * BN, V, tid, tx, [&](int i, int j, float x) {
        if constexpr (CAND) {
          const int col = col_of(tx, j);
          cand_store(cd, lo[col], hi[col], m0 + row_of(ty, i), R, x);
        }
      });
    }
    if (c + 1 < total) put(buf ^ 1);  // buf ^ 1 was last read in chunk c - 1
    __syncthreads();
    t = t1;
    kc = kc1;
  }
  lse_finish(sL, m_part, s_part, blockIdx.y, m0, R, tid, ty, tx);
}

// Dynamic shared memory of proj_ms_f32_kernel: the two stages of both
// operands, the online lse's state, the candidate-run buffers.
constexpr int F32_SMEM = (4 * jlm::gemm::TILE + jlm::gemm::LSE_FLOATS + 4 * jlm::gemm::BN) * 4;

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

// ------------------------------------------------------------ int8 x int8

constexpr int QMAX_BLOCKS = 8;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr int MAX_STAGES = 8;
constexpr int WG_THREADS = 128;

struct QuantBlocks {
  int n;
  int off[QMAX_BLOCKS], d[QMAX_BLOCKS], dp[QMAX_BLOCKS], qcol[QMAX_BLOCKS];
};

// One warp per row, every block of the head: block k's slice h[row, off:
// off + d] to int8 q[row, qcol : qcol + dp] (zeros past d) with its row
// scale hs[k * R + row] (project.py:83-89).
__global__ void quantize_rows_kernel(const void* __restrict__ h, int ldh, int h_bf16, int R,
                                     QuantBlocks qb, signed char* __restrict__ q, int ldq,
                                     float* __restrict__ hs) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= R) return;
  for (int k = 0; k < qb.n; ++k) {
    const size_t base = (size_t)row * ldh + qb.off[k];
    const int d = qb.d[k];
    float amax = 0.0f;
    for (int i = lane; i < d; i += 32) amax = fmaxf(amax, fabsf(load_act(h, h_bf16, base + i)));
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = fmaxf(amax, 1e-30f) / 127.0f;
    signed char* qr = q + (size_t)row * ldq + qb.qcol[k];
    for (int i = lane; i < qb.dp[k]; i += 32) {
      const float v = i < d ? load_act(h, h_bf16, base + i) : 0.0f;
      qr[i] = static_cast<signed char>(__float2int_rn(v / s));
    }
    if (lane == 0) hs[(size_t)k * R + row] = s;
  }
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x on the special-function unit alone (one MUFU.EX2; 2 ulp).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// float(a), exactly: for |a| < 2^22 (SMALL) by the mantissa of 1.5 * 2^23
// (one integer and one float add, off the special-function unit that the
// conversion instruction shares with the exponentials), else by the
// conversion.
template <bool SMALL>
__device__ __forceinline__ float to_float(int a) {
  if constexpr (SMALL)
    return __int_as_float(a + 0x4B400000) - 12582912.0f;
  else
    return static_cast<float>(a);
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (BN == 64)
    jlm::wgmma_s8_n64(d, a, b, acc);
  else
    jlm::wgmma_s8_n32(d, a, b, acc);
}

// One vocab tile's product into acc: 4 NKA wgmma k32 steps of the
// warpgroup's m64 tile of the resident rows sa (BM = 64 NC rows) and the
// stage's W^T tile sb (each K-major, 128-byte rows of K in NKA regions),
// unrolled.
template <int BN, int NKA, int NC>
__device__ __forceinline__ void issue_tile(int (&acc)[BN / 2], const unsigned char* sa,
                                           const unsigned char* sb, int wg) {
  constexpr int BM = 64 * NC;
  jlm::fence_regs(acc);
  jlm::wgmma_fence();
  const unsigned char* a = sa + wg * 64 * 128;
#pragma unroll
  for (int ks = 0; ks < 4 * NKA; ++ks) {
    const int ka = ks >> 2, kb = (ks & 3) * 32;
    wgmma_s8<BN>(acc, jlm::smem_desc(a + ka * BM * 128 + kb),
                 jlm::smem_desc(sb + ka * BN * 128 + kb), ks > 0);
  }
  jlm::wgmma_commit();
}

// Column parameters of a vocab tile, per stage beside its W^T tile: scale
// [BN] and bias log2e [BN], and with CAND each column's candidate run
// lo [BN], hi [BN] (ints) and its bias [BN].  A column past V has scale 0
// and bias -inf: its logit is 0 * ... + -inf = -inf, its exponential 0,
// and its run is empty.
template <int BN, bool CAND>
__host__ __device__ constexpr int param_floats() { return (CAND ? 5 : 2) * BN; }

// A consumer warp is done with a stage.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) jlm::mbar_arrive(empty);
}

// The online logsumexp of one tile from acc: the thread's two rows of its
// warpgroup's m64 tile over its BN / 4 columns of the tile, prm the tile's
// column parameters, the stage (empty) released once they are read.  Each
// logit in log2 units, u = (float(acc) * rs) * scale_col + bias log2e with
// rs = s_row log2e (one FMUL and one FMA), m in log2 units, exp(v - m) as
// 2^(u - m): a few ulp from the reference's rounding of the logit, far
// inside the lse's 1e-4.  A logit that a candidate asks for (CAND) is
// computed again in the reference's order and rounding,
// ((float(acc) * s_row) * scale_col) + bias, with no contraction into an
// FMA, so that it equals the plain version's bit for bit (the int32
// product is exact).  Max and sum run as trees of 4 partials a row.
template <int BN, bool CAND, bool SMALL>
__device__ __forceinline__ void tile_epilogue(const int (&acc)[BN / 2], float (&m_run)[2],
                                              float (&s_run)[2], const float (&hsr)[2],
                                              const float (&rs)[2], const float* prm,
                                              uint64_t* empty, int row_first, int R,
                                              const Cand& cd, int lane) {
  constexpr int NJ = BN / 8, NX = 2 * NJ;  // the thread's columns of the tile
  const int* lo = reinterpret_cast<const int*>(prm + 2 * BN);
  const int* hi = lo + BN;
  const float* bias = prm + 4 * BN;
  float x[2][NX];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const float2 s2 = *reinterpret_cast<const float2*>(prm + col);
    const float2 b2 = *reinterpret_cast<const float2*>(prm + BN + col);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = to_float<SMALL>(acc[4 * j + 2 * i + e]);
        const float sc = e ? s2.y : s2.x;
        x[i][2 * j + e] = fmaf(a * rs[i], sc, e ? b2.y : b2.x);
        if constexpr (CAND) {
          if (lo[col + e] < hi[col + e])
            cand_store(cd, lo[col + e], hi[col + e], row_first + 8 * i, R,
                       __fadd_rn(__fmul_rn(__fmul_rn(a, hsr[i]), sc), bias[col + e]));
        }
      }
  }
  release(empty, lane);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx[4], sm[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) mx[p] = x[i][p];
#pragma unroll
    for (int q = 4; q < NX; ++q) mx[q & 3] = fmaxf(mx[q & 3], x[i][q]);
    const float m_new = fmaxf(m_run[i], fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3])));
#pragma unroll
    for (int p = 0; p < 4; ++p) sm[p] = 0.0f;
#pragma unroll
    for (int q = 0; q < NX; ++q) sm[q & 3] += ex2(x[i][q] - m_new);
    s_run[i] = s_run[i] * ex2(m_run[i] - m_new) + ((sm[0] + sm[1]) + (sm[2] + sm[3]));
    m_run[i] = m_new;
  }
}

// tm_a: the block's quantized rows [R, dp] int8 (dp = 128 NKA), boxes of
// BM = 64 NC rows x 128; tm_b: W^T [V, dp] int8, boxes of BN rows x 128.
// hs: the block's row scales [R].  stages: W^T tiles in the ring.  NC
// consumer warpgroups, one m64 tile of rows each, and one producer.
template <int NC, int BN, int NKA, bool CAND, bool SMALL>
__global__ void __launch_bounds__((NC + 1) * WG_THREADS, 1)
proj_int8_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b, const float* __restrict__ hs,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 float* __restrict__ m_part, float* __restrict__ s_part, int R, int V,
                 int tiles_per_split, int stages, Cand cd) {
  constexpr int BM = 64 * NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr int PF = param_floats<BN, CAND>();
  constexpr int a_bytes = NKA * BM * 128, b_bytes = NKA * BN * 128;
  unsigned char* sa = smem;
  unsigned char* sb = smem + a_bytes;
  float* sp = reinterpret_cast<float*>(sb + stages * b_bytes);  // [stages][PF]
  uint64_t* a_full = reinterpret_cast<uint64_t*>(sp + stages * PF);
  uint64_t* full = a_full + 1;
  uint64_t* empty = full + stages;
  const int row0 = blockIdx.x * BM;
  const int n_tiles = (V + BN - 1) / BN;
  const int vt_begin = blockIdx.y * tiles_per_split;
  const int nt = min(vt_begin + tiles_per_split, n_tiles) - vt_begin;
  const int wg = threadIdx.x / WG_THREADS;
  if (nt <= 0) return;  // (the wrapper's plan gives every split a tile)

  if (threadIdx.x == 0) {
    jlm::mbar_init(a_full, 1);
    for (int s = 0; s < stages; ++s) {
      jlm::mbar_init(&full[s], 1 + 32);  // the TMA thread and the parameter warp
      jlm::mbar_init(&empty[s], NC * WG_THREADS / 32);  // every consumer warp
    }
    jlm::mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {
    // ---- producer: the rows once, then the W^T tiles of the split (one
    // thread, TMA) and their column parameters (one warp) ----
    const int pt = threadIdx.x - NC * WG_THREADS;
    if (pt == 0) {
      jlm::prefetch_map(&tm_a);
      jlm::prefetch_map(&tm_b);
      jlm::mbar_expect_tx(a_full, a_bytes);
      for (int ka = 0; ka < NKA; ++ka)
        jlm::tma_load(sa + ka * BM * 128, &tm_a, a_full, ka * 128, row0);
      for (int t = 0; t < nt; ++t) {
        const int s = t % stages;
        if (t >= stages) jlm::mbar_wait(&empty[s], ((t / stages) - 1) & 1);
        jlm::mbar_expect_tx(&full[s], b_bytes);
        for (int ka = 0; ka < NKA; ++ka)
          jlm::tma_load(sb + s * b_bytes + ka * BN * 128, &tm_b, &full[s], ka * 128,
                        (vt_begin + t) * BN);
      }
    } else if (pt >= 32 && pt < 64) {
      for (int t = 0; t < nt; ++t) {
        const int s = t % stages;
        if (t >= stages) jlm::mbar_wait(&empty[s], ((t / stages) - 1) & 1);
        float* p = sp + s * PF;
        int* lo = reinterpret_cast<int*>(p + 2 * BN);
        for (int i = pt - 32; i < BN; i += 32) {
          const int n = (vt_begin + t) * BN + i;
          p[i] = n < V ? scale[n] : 0.0f;
          p[BN + i] = n < V ? bias[n] * LOG2E : -INFINITY;
          if constexpr (CAND) {
            lo[i] = n < V ? first_at_least(cd.ids, cd.C, cd.id_base + n) : 0;
            lo[BN + i] = n < V ? first_at_least(cd.ids, cd.C, cd.id_base + n + 1) : 0;
            p[4 * BN + i] = n < V ? bias[n] : 0.0f;
          }
        }
        jlm::mbar_arrive(&full[s]);  // release: the consumers' wait sees the stores
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows wg * 64 .. + 63 ----
    const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
    const int row_first = row0 + wg * 64 + warp * 16 + lane / 4;
    float m_run[2], s_run[2], hsr[2], rs[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_first + 8 * i;
      m_run[i] = NEG;
      s_run[i] = 0.0f;
      hsr[i] = row < R ? hs[row] : 1.0f;
      rs[i] = hsr[i] * LOG2E;
    }
    int acc[BN / 2];

    // The warpgroups take turns on the tensor cores, in order 0 .. NC - 1
    // (a ring of named barriers 1 .. NC): each issues tile t's product once
    // the one before it has issued its own, then waits for it and runs its
    // epilogue while the others' products run.
    jlm::mbar_wait(a_full, 0);
    for (int t = 0; t < nt; ++t) {
      const int s = t % stages;
      jlm::mbar_wait(&full[s], (t / stages) & 1);
      if (wg > 0 || t > 0) jlm::named_sync(1 + wg, 2 * WG_THREADS);
      issue_tile<BN, NKA, NC>(acc, sa, sb + s * b_bytes, wg);
      if (wg < NC - 1 || t + 1 < nt) jlm::named_arrive(1 + (wg + 1) % NC, 2 * WG_THREADS);
      jlm::wgmma_wait<0>();
      jlm::fence_regs(acc);
      tile_epilogue<BN, CAND, SMALL>(acc, m_run, s_run, hsr, rs, sp + s * PF, &empty[s],
                                     row_first, R, cd, lane);
    }

    // ---- merge the 4 lanes of each row's quad; store the split's (m, s) ----
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_run[i] *= LN2;  // back to natural units
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m_run[i], off);
        const float s2 = __shfl_xor_sync(0xffffffffu, s_run[i], off);
        merge_ms(m_run[i], s_run[i], m2, s2);
      }
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row_first + 8 * i;
        if (row < R) {
          m_part[(size_t)blockIdx.y * R + row] = m_run[i];
          s_part[(size_t)blockIdx.y * R + row] = s_run[i];
        }
      }
    }
  }
}

template <int NC, int BN, int NKA, bool CAND, bool SMALL>
cudaError_t launch_int8(const void* q, int ldq, int R, const void* wt, const float* scale,
                        const float* bias, const float* hs, float* m_part, float* s_part,
                        int V, int splits, int tiles_per_split, const Cand& cd,
                        cudaStream_t stream) {
  constexpr int BM = 64 * NC, dp = 128 * NKA;
  const int a_bytes = NKA * BM * 128;
  const int stage_bytes = NKA * BN * 128 + param_floats<BN, CAND>() * 4;
  const int fixed = a_bytes + 1024 + (1 + 2 * MAX_STAGES) * 8;
  const int fit = (SMEM_MAX - fixed) / stage_bytes;
  const int stages = fit < MAX_STAGES ? fit : MAX_STAGES;
  if (stages < 2) return cudaErrorInvalidValue;
  const int smem = a_bytes + stages * stage_bytes + (1 + 2 * stages) * 8 + 1024;
  CUtensorMap ta, tb;
  if (!jlm::tensor_map(&ta, q, 1, R, dp, ldq, BM, 128) ||
      !jlm::tensor_map(&tb, wt, 1, V, dp, dp, BN, 128))
    return cudaErrorInvalidValue;
  auto kernel = proj_int8_kernel<NC, BN, NKA, CAND, SMALL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((R + BM - 1) / BM, splits);
  kernel<<<grid, (NC + 1) * WG_THREADS, smem, stream>>>(ta, tb, hs, scale, bias, m_part,
                                                         s_part, R, V, tiles_per_split,
                                                         stages, cd);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16 x bf16

constexpr int BBM = 128;                   // rows per block: two consumer warpgroups
constexpr int BBN = 256;                   // vocab columns per tile: one m64n256k16 row
constexpr int BKB = 64;                    // K per stage: one 128-byte swizzle row of bf16
constexpr int A_CHUNK = BBM * BKB * 2;     // 16 KB of h
constexpr int B_CHUNK = BBN * BKB * 2;     // 32 KB of bf16 W^T
constexpr int Q_CHUNK = BBN * BKB;         // 16 KB of int8 W^T (dequant)
constexpr int PSLOTS = 2;                  // column-parameter ring, in tiles

// Column parameters of a tile: bias log2e [BBN] (-inf past V), with CAND
// each column's candidate run lo [BBN], hi [BBN] (ints) and its bias, and
// with Q8 (int8-MXU) the column scales [BBN] last (0 past V).
template <bool CAND, bool Q8 = false>
__host__ __device__ constexpr int bparam_floats() {
  return (CAND ? 4 : 1) * BBN + (Q8 ? BBN : 0);
}

template <bool DEQ>
__host__ __device__ constexpr int bf16_stages() { return DEQ ? 3 : 4; }

template <bool DEQ>
__host__ __device__ constexpr int bf16_stage_bytes() {
  return A_CHUNK + B_CHUNK + (DEQ ? Q_CHUNK : 0);
}

// The online logsumexp of a tile's logits u in log2 units (fragment
// layout d[4 j + 2 i + e]: row 16 warp + lane / 4 + 8 i, column 8 j +
// 2 (lane % 4) + e): m in log2 units, exp(v - m) as 2^(u - m); max and
// sum run as trees of 4 partials a row.  The logits may sit in int
// registers (the int8 tile's, converted in place: as_f reads them back).
__device__ __forceinline__ float as_f(float v) { return v; }
__device__ __forceinline__ float as_f(int v) { return __int_as_float(v); }

template <typename T>
__device__ __forceinline__ void tile_lse(const T (&acc)[BBN / 2], float (&m_run)[2],
                                         float (&s_run)[2]) {
  constexpr int NJ = BBN / 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx[4], sm[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) mx[p] = as_f(acc[2 * i + (p & 1) + 4 * (p >> 1)]);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        mx[(j & 1) * 2 + e] = fmaxf(mx[(j & 1) * 2 + e], as_f(acc[4 * j + 2 * i + e]));
    const float m_new = fmaxf(m_run[i], fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3])));
#pragma unroll
    for (int p = 0; p < 4; ++p) sm[p] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        sm[(j & 1) * 2 + e] += ex2(as_f(acc[4 * j + 2 * i + e]) - m_new);
    s_run[i] = s_run[i] * ex2(m_run[i] - m_new) + ((sm[0] + sm[1]) + (sm[2] + sm[3]));
    m_run[i] = m_new;
  }
}

// The online logsumexp of one tile from acc, the warpgroup's m64 x 256
// fragment (d[4 j + 2 i + e]: row 16 warp + lane / 4 + 8 i, column 8 j +
// 2 (lane % 4) + e): u = acc log2e + bias log2e (one FMA, in place), m in
// log2 units, exp(v - m) as 2^(u - m).  A logit that a candidate asks for
// (CAND) is stored as acc + bias, the value the lse takes.  Max and sum
// run as trees of 4 partials a row.
template <bool CAND>
__device__ __forceinline__ void bf16_epilogue(float (&acc)[BBN / 2], float (&m_run)[2],
                                              float (&s_run)[2], const float* prm,
                                              int row_first, int R, const Cand& cd,
                                              int lane) {
  constexpr int NJ = BBN / 8;
  const int* lo = reinterpret_cast<const int*>(prm + BBN);
  const int* hi = lo + BBN;
  const float* braw = prm + 3 * BBN;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const float2 b2 = *reinterpret_cast<const float2*>(prm + col);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = acc[4 * j + 2 * i + e];
        if constexpr (CAND) {
          if (lo[col + e] < hi[col + e])
            cand_store(cd, lo[col + e], hi[col + e], row_first + 8 * i, R,
                       __fadd_rn(v, braw[col + e]));
        }
        v = fmaf(v, LOG2E, e ? b2.y : b2.x);
      }
  }
  tile_lse(acc, m_run, s_run);
}

// The int8-MXU tile (Q8): its logits in log2 units from the exact int32
// sums as tile_epilogue forms them, u = (float(acc) * rs) * scale_col +
// bias log2e (rs = s_row log2e), each written over its sum (no second set
// of 128 registers), a candidate's logit in the reference's order and
// rounding, then the online logsumexp.
template <bool CAND>
__device__ __forceinline__ void q8_epilogue(int (&acc)[BBN / 2], float (&m_run)[2],
                                            float (&s_run)[2], const float (&hsr)[2],
                                            const float (&rs)[2], const float* prm,
                                            int row_first, int R, const Cand& cd, int lane) {
  constexpr int NJ = BBN / 8;
  const int* lo = reinterpret_cast<const int*>(prm + BBN);
  const int* hi = lo + BBN;
  const float* braw = prm + 3 * BBN;
  const float* scl = prm + (CAND ? 4 : 1) * BBN;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const float2 b2 = *reinterpret_cast<const float2*>(prm + col);
    const float2 s2 = *reinterpret_cast<const float2*>(scl + col);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = static_cast<float>(acc[4 * j + 2 * i + e]);
        const float sc = e ? s2.y : s2.x;
        if constexpr (CAND) {
          if (lo[col + e] < hi[col + e])
            cand_store(cd, lo[col + e], hi[col + e], row_first + 8 * i, R,
                       __fadd_rn(__fmul_rn(__fmul_rn(a, hsr[i]), sc), braw[col + e]));
        }
        acc[4 * j + 2 * i + e] = __float_as_int(fmaf(a * rs[i], sc, e ? b2.y : b2.x));
      }
  }
  tile_lse(acc, m_run, s_run);
}

// bf16 weights (DEQ false) or int8 weights dequantized to bf16 (DEQ).
// tm_a: the block's activation slice, bf16 [R, dp], boxes of 128 rows x
// 64; tm_b: W^T [V, dp], bf16 boxes of 256 rows x 64 (128-byte swizzle),
// or int8 boxes of 256 rows x 64 (unswizzled).  nkb: K chunks of 64.
// Warpgroups 0 and 1 consume (rows 64 wg .. + 63 of the block, over every
// tile), warpgroup 2 produces.
// Q8 (int8-MXU past dp = 1,024, where proj_int8_kernel's resident rows no
// longer fit): tm_a the block's quantized rows, int8 [R, dp], boxes of
// 128 rows x 128; tm_b W^T int8 [V, dp], boxes of 256 rows x 128, both
// 128-byte swizzled: a stage's chunks have the bf16 stage's bytes (128
// rows and 256 columns x 128 bytes of K), and a chunk is 4 wgmma
// m64n256k32 s8 steps into int32 sums (exact: |acc| <= dp 127^2 < 2^31
// for dp < 133,000); hs: the rows' scales.  The epilogue is the resident
// kernel's (q8_epilogue).
template <bool DEQ, bool CAND, bool Q8 = false>
__global__ void __launch_bounds__(3 * WG_THREADS, 1)
proj_bf16_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b, const float* __restrict__ scale,
                 const float* __restrict__ bias, const float* __restrict__ hs,
                 float* __restrict__ m_part, float* __restrict__ s_part, int R, int V,
                 int nkb, int tiles_per_split, Cand cd) {
  constexpr int STAGES = bf16_stages<DEQ>(), STAGE = bf16_stage_bytes<DEQ>();
  constexpr int PF = bparam_floats<CAND, Q8>();
  constexpr int KE = Q8 ? 128 : BKB;  // K elements of a chunk (128 bytes a row)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // stage s: h chunk [128][128 B], W^T chunk [256][128 B], (DEQ) int8 [256][64]
  float* sp = reinterpret_cast<float*>(smem + STAGES * STAGE);  // [PSLOTS][PF]
  uint64_t* full = reinterpret_cast<uint64_t*>(sp + PSLOTS * PF);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;  // the int8 chunk landed (DEQ)
  uint64_t* pfull = qfull + STAGES;
  uint64_t* pempty = pfull + PSLOTS;
  const int row0 = blockIdx.x * BBM;
  const int n_tiles = (V + BBN - 1) / BBN;
  const int vt_begin = blockIdx.y * tiles_per_split;
  const int nt = min(vt_begin + tiles_per_split, n_tiles) - vt_begin;
  const int wg = threadIdx.x / WG_THREADS;
  if (nt <= 0) return;  // (the wrapper's plan gives every split a tile)

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the TMA thread's bytes, and (DEQ) the 64 converter threads' stores
      jlm::mbar_init(&full[s], DEQ ? 1 + 64 : 1);
      jlm::mbar_init(&empty[s], 2 * WG_THREADS / 32);  // every consumer warp
      jlm::mbar_init(&qfull[s], 1);
    }
    for (int p = 0; p < PSLOTS; ++p) {
      jlm::mbar_init(&pfull[p], 32);
      jlm::mbar_init(&pempty[p], 2 * WG_THREADS / 32);
    }
    jlm::mbar_fence_init();
  }
  __syncthreads();

  const int n_chunks = nt * nkb;
  if (wg == 2) {
    // ---- producer: thread 0 the TMA loads, warp 1 the column parameters,
    // warps 2-3 (DEQ) the int8 -> bf16 conversion ----
    jlm::setmaxnreg_dec<40>();
    const int pt = threadIdx.x - 2 * WG_THREADS, pw = pt / 32, lane = pt & 31;
    if (pt == 0) {
      jlm::prefetch_map(&tm_a);
      jlm::prefetch_map(&tm_b);
      for (int i = 0; i < n_chunks; ++i) {
        const int s = i % STAGES, col = (i % nkb) * KE, vrow = (vt_begin + i / nkb) * BBN;
        unsigned char* st = smem + s * STAGE;
        if (i >= STAGES) jlm::mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        jlm::mbar_expect_tx(&full[s], DEQ ? A_CHUNK : A_CHUNK + B_CHUNK);
        jlm::tma_load(st, &tm_a, &full[s], col, row0);
        if constexpr (DEQ) {
          jlm::mbar_expect_tx(&qfull[s], Q_CHUNK);
          jlm::tma_load(st + A_CHUNK + B_CHUNK, &tm_b, &qfull[s], col, vrow);
        } else {
          jlm::tma_load(st + A_CHUNK, &tm_b, &full[s], col, vrow);
        }
      }
    } else if (pw == 1) {
      for (int t = 0; t < nt; ++t) {
        const int p = t % PSLOTS;
        if (t >= PSLOTS) jlm::mbar_wait(&pempty[p], ((t / PSLOTS) - 1) & 1);
        float* prm = sp + p * PF;
        int* lo = reinterpret_cast<int*>(prm + BBN);
        for (int c = lane; c < BBN; c += 32) {
          const int n = (vt_begin + t) * BBN + c;
          prm[c] = n < V ? bias[n] * LOG2E : -INFINITY;
          if constexpr (CAND) {
            lo[c] = n < V ? first_at_least(cd.ids, cd.C, cd.id_base + n) : 0;
            lo[BBN + c] = n < V ? first_at_least(cd.ids, cd.C, cd.id_base + n + 1) : 0;
            prm[3 * BBN + c] = n < V ? bias[n] : 0.0f;
          }
          if constexpr (Q8) prm[(CAND ? 4 : 1) * BBN + c] = n < V ? scale[n] : 0.0f;
        }
        jlm::mbar_arrive(&pfull[p]);  // release: the consumers' wait sees the stores
      }
    } else if (DEQ && pw >= 2) {
      // 64 threads; a chunk is 256 rows x 64 int8 = 1,024 pieces of 16:
      // thread q converts pieces q + 64 j (row p / 4, K 16 (p % 4) .. + 15)
      // to bf16(q8 * scale[row]) and stores them 128-byte swizzled into the
      // stage's W^T chunk, whose previous readers the TMA thread waited for
      const int q = pt - 64;
      for (int i = 0; i < n_chunks; ++i) {
        const int s = i % STAGES, vrow = (vt_begin + i / nkb) * BBN;
        unsigned char* st = smem + s * STAGE;
        jlm::mbar_wait(&qfull[s], (i / STAGES) & 1);
#pragma unroll 2
        for (int j = 0; j < BBN * 4 / 64; ++j) {
          const int piece = q + 64 * j, r = piece >> 2, k16 = piece & 3, n = vrow + r;
          const float sc = n < V ? __ldg(scale + n) : 0.0f;
          const uint4 w = *reinterpret_cast<const uint4*>(st + A_CHUNK + B_CHUNK + r * BKB +
                                                          k16 * 16);
          const uint32_t words[4] = {w.x, w.y, w.z, w.w};
          uint32_t o[8];  // 16 bf16, two to a word, in K order
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const uint32_t word = words[e >> 1];
            const int bsh = (e & 1) * 2;
            const __nv_bfloat162 pr = __floats2bfloat162_rn(s8_at(word, bsh) * sc,
                                                            s8_at(word, bsh + 1) * sc);
            o[e] = *reinterpret_cast<const uint32_t*>(&pr);
          }
          unsigned char* row_p = st + A_CHUNK + r * 128;
          const int c0 = (2 * k16) ^ (r & 7), c1 = (2 * k16 + 1) ^ (r & 7);
          *reinterpret_cast<uint4*>(row_p + c0 * 16) = make_uint4(o[0], o[1], o[2], o[3]);
          *reinterpret_cast<uint4*>(row_p + c1 * 16) = make_uint4(o[4], o[5], o[6], o[7]);
        }
        jlm::fence_proxy_async();  // the stores, before wgmma reads them
        jlm::mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg .. + 63 over every tile ----
    jlm::setmaxnreg_inc<232>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
    const int row_first = row0 + wg * 64 + warp * 16 + lane / 4;
    auto release = [&](int i) {  // the stage of chunk i
      __syncwarp();
      if (lane == 0) jlm::mbar_arrive(&empty[i % STAGES]);
    };
    float m_run[2] = {NEG, NEG}, s_run[2] = {0.0f, 0.0f};
    float hsr[2], rs[2];  // Q8: the rows' scales, and times log2e
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_first + 8 * i;
      hsr[i] = Q8 && row < R ? hs[row] : 1.0f;
      rs[i] = hsr[i] * LOG2E;
    }
    std::conditional_t<Q8, int, float> acc[BBN / 2];
    for (int t = 0; t < nt; ++t) {
      for (int kc = 0; kc < nkb; ++kc) {
        const int i = t * nkb + kc, s = i % STAGES;
        jlm::mbar_wait(&full[s], (i / STAGES) & 1);
        const unsigned char* a = smem + s * STAGE + wg * 64 * 128;
        const unsigned char* b = smem + s * STAGE + A_CHUNK;
        jlm::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // 32 bytes of K a step (16 bf16, 32 int8)
          if constexpr (Q8)
            jlm::wgmma_s8_n256(acc, jlm::smem_desc(a + k * 32), jlm::smem_desc(b + k * 32),
                               (kc | k) > 0);
          else
            jlm::wgmma_bf16_n256(acc, jlm::smem_desc(a + k * 32),
                                 jlm::smem_desc(b + k * 32), (kc | k) > 0);
        }
        jlm::wgmma_commit();
        if (kc > 0) {  // the previous chunk's group is done: release its stage
          jlm::wgmma_wait<1>();
          release(i - 1);
        }
      }
      jlm::wgmma_wait<0>();
      jlm::fence_regs(acc);
      release(t * nkb + nkb - 1);
      const int p = t % PSLOTS;
      jlm::mbar_wait(&pfull[p], (t / PSLOTS) & 1);
      if constexpr (Q8)
        q8_epilogue<CAND>(acc, m_run, s_run, hsr, rs, sp + p * PF, row_first, R, cd, lane);
      else
        bf16_epilogue<CAND>(acc, m_run, s_run, sp + p * PF, row_first, R, cd, lane);
      __syncwarp();
      if (lane == 0) jlm::mbar_arrive(&pempty[p]);
    }

    // ---- merge the 4 lanes of each row's quad; store the split's (m, s) ----
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_run[i] *= LN2;  // back to natural units
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m_run[i], off);
        const float s2 = __shfl_xor_sync(0xffffffffu, s_run[i], off);
        merge_ms(m_run[i], s_run[i], m2, s2);
      }
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row_first + 8 * i;
        if (row < R) {
          m_part[(size_t)blockIdx.y * R + row] = m_run[i];
          s_part[(size_t)blockIdx.y * R + row] = s_run[i];
        }
      }
    }
  }
}

// h: bf16 [R, dp] (row stride ldh), or (Q8) the quantized rows int8 [R,
// dp] (row stride ldh bytes, dp a multiple of 128) with their scales hs.
template <bool DEQ, bool CAND, bool Q8 = false>
cudaError_t launch_bf16(const void* h, int ldh, int R, int dp, const void* wt,
                        const float* scale, const float* bias, float* m_part,
                        float* s_part, int V, int splits, int tiles_per_split,
                        const Cand& cd, cudaStream_t stream, const float* hs = nullptr) {
  const int smem = bf16_stages<DEQ>() * (bf16_stage_bytes<DEQ>() + 3 * 8) +
                   PSLOTS * (bparam_floats<CAND, Q8>() * 4 + 2 * 8) + 1024;
  constexpr int KE = Q8 ? 128 : BKB;
  CUtensorMap ta, tb;
  if (!jlm::tensor_map(&ta, h, Q8 ? 1 : 2, R, dp, ldh, BBM, KE) ||
      !(DEQ ? jlm::tensor_map(&tb, wt, 1, V, dp, dp, BBN, BKB, false)
            : jlm::tensor_map(&tb, wt, Q8 ? 1 : 2, V, dp, dp, BBN, KE)))
    return cudaErrorInvalidValue;
  auto kernel = proj_bf16_kernel<DEQ, CAND, Q8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((R + BBM - 1) / BBM, splits);
  kernel<<<grid, 3 * WG_THREADS, smem, stream>>>(ta, tb, scale, bias, hs, m_part, s_part, R,
                                                 V, (dp + KE - 1) / KE, tiles_per_split, cd);
  return cudaGetLastError();
}

// ------------------------------------------------------------ other modes

template <bool Q8, bool CAND>
cudaError_t launch_f32(const void* h, int ldh, const void* wt, const float* scale,
                       const float* bias, float* m_part, float* s_part, int R,
                       int D, int V, int splits, int tiles_per_split,
                       const Cand& cd, cudaStream_t stream) {
  if (D % jlm::gemm::BK) return cudaErrorInvalidValue;
  auto kernel = proj_ms_f32_kernel<Q8, CAND>;
  static bool ready[64];  // the attribute is set once a device and instantiation
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F32_SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev] = true;
  }
  dim3 grid((R + jlm::gemm::BM - 1) / jlm::gemm::BM, splits);
  kernel<<<grid, THREADS, F32_SMEM, stream>>>(static_cast<const float*>(h), ldh, wt, scale,
                                              bias, m_part, s_part, R, D, V, tiles_per_split,
                                              cd);
  return cudaGetLastError();
}

template <bool CAND>
cudaError_t launch_mode(const void* h, int ldh, const void* wt, int mode, const float* scale,
                        const float* bias, float* m_part, float* s_part, int R, int D,
                        int V, int splits, int tiles_per_split, const Cand& cd,
                        cudaStream_t st) {
  switch (mode) {
    case kBf16:
      return launch_bf16<false, CAND>(h, ldh, R, D, wt, scale, bias, m_part, s_part, V,
                                      splits, tiles_per_split, cd, st);
    case kDequantBf16:
      return launch_bf16<true, CAND>(h, ldh, R, D, wt, scale, bias, m_part, s_part, V,
                                     splits, tiles_per_split, cd, st);
    case kFp32:
      return launch_f32<false, CAND>(h, ldh, wt, scale, bias, m_part, s_part, R, D, V,
                                     splits, tiles_per_split, cd, st);
    case kDequantFp32:
      return launch_f32<true, CAND>(h, ldh, wt, scale, bias, m_part, s_part, R, D, V,
                                    splits, tiles_per_split, cd, st);
    default:  // kInt8Mxu goes through jlm_project_int8
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Quantize every int8-MXU block's activation slice once: h [R, ldh] (bf16
// when h_bf16, else fp32); block k reads columns [off[k], off[k] + d[k])
// and writes q[:, qcol[k] : qcol[k] + dp[k]] (int8, row stride ldq bytes)
// and hs[k * R : (k + 1) * R] (fp32).  At most 8 blocks.
int jlm_project_quantize(const void* h, int ldh, int h_bf16, int R, int n, const int* off,
                         const int* d, const int* dp, const int* qcol, void* q, int ldq,
                         float* hs, void* stream) {
  if (n < 1 || n > QMAX_BLOCKS) return (int)cudaErrorInvalidValue;
  QuantBlocks qb;
  qb.n = n;
  for (int k = 0; k < n; ++k) {
    qb.off[k] = off[k];
    qb.d[k] = d[k];
    qb.dp[k] = dp[k];
    qb.qcol[k] = qcol[k];
  }
  quantize_rows_kernel<<<(R + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      h, ldh, h_bf16, R, qb, static_cast<signed char*>(q), ldq, hs);
  return (int)cudaGetLastError();
}

// One int8-MXU block: q [R, dp] int8 (row stride ldq bytes; dp 128, 256,
// 512 or 1,024, or past 1,024 a multiple of 128: the slice's width
// padded), wt [V, dp] int8 W^T, scale [V], bias [V], hs [R] its row
// scales; m_part/s_part and the candidate arguments as in
// jlm_project_block.  The rows stay resident up to dp = 1,024: dp <= 512
// takes 256-row blocks and 64-column tiles, dp = 1,024 128-row blocks and
// 32-column tiles; wider slices stream the rows in K chunks with W^T
// (128-row blocks, 256-column tiles).  The wrapper plans the splits with
// the same numbers.
int jlm_project_int8(const void* q, int ldq, int R, int dp, const void* wt,
                     const float* scale, const float* bias, const float* hs, float* m_part,
                     float* s_part, int V, int splits, int tiles_per_split,
                     const int* cand_ids, const int* cand_slots, int C, int id_base,
                     float* cand_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Cand cd{cand_ids, cand_slots, C, id_base, cand_out};
#define JLM_INT8(NC, BN, NKA, SMALL)                                                       \
  (int)(cand_ids ? launch_int8<NC, BN, NKA, true, SMALL>(q, ldq, R, wt, scale, bias, hs,     \
                                                         m_part, s_part, V, splits,          \
                                                         tiles_per_split, cd, st)            \
                 : launch_int8<NC, BN, NKA, false, SMALL>(q, ldq, R, wt, scale, bias, hs,    \
                                                          m_part, s_part, V, splits,         \
                                                          tiles_per_split, cd, st))
  // |acc| <= dp * 128 * 127 < 2^22 for dp <= 256: to_float's integer trick
  switch (dp) {
    case 128: return JLM_INT8(4, 64, 1, true);
    case 256: return JLM_INT8(4, 64, 2, true);
    case 512: return JLM_INT8(4, 64, 4, false);
    case 1024: return JLM_INT8(2, 32, 8, false);
    default: break;
  }
#undef JLM_INT8
  // wider: the rows streamed with W^T in K chunks of 128 (proj_bf16_kernel, Q8)
  if (dp <= 1024 || dp % 128) return (int)cudaErrorInvalidValue;
  return (int)(cand_ids ? launch_bf16<false, true, true>(q, ldq, R, dp, wt, scale, bias,
                                                          m_part, s_part, V, splits,
                                                          tiles_per_split, cd, st, hs)
                        : launch_bf16<false, false, true>(q, ldq, R, dp, wt, scale, bias,
                                                           m_part, s_part, V, splits,
                                                           tiles_per_split, cd, st, hs));
}

// One block of the head in the other modes.  h: the block's first
// activation column; row stride ldh elements; bf16 (modes 0, 2) or fp32
// (modes 3, 4).  wt [V, D] W^T: bf16 (mode 0), int8 (modes 2, 4) or fp32
// (mode 3); scale [V] (int8 modes); bias [V] fp32; m_part/s_part point at
// this block's first split of [splits_total, R] scratch.  Modes 0 and 2
// (the wgmma kernel: 128-row blocks, 256-column tiles, which the wrapper
// plans its splits with) take any D (h and W^T 16-byte aligned, rows of
// 16-byte multiples).  Candidate
// extraction when cand_ids is not null: cand_ids [C] sorted ascending,
// cand_slots [C] their columns in cand_out [R, C] fp32, id_base the global
// id of this block's column 0.
int jlm_project_block(const void* h, int ldh, const void* wt, int mode, const float* scale,
                      const float* bias, float* m_part, float* s_part, int R, int D, int V,
                      int splits, int tiles_per_split, const int* cand_ids,
                      const int* cand_slots, int C, int id_base, float* cand_out,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Cand cd{cand_ids, cand_slots, C, id_base, cand_out};
  if (cand_ids)
    return (int)launch_mode<true>(h, ldh, wt, mode, scale, bias, m_part, s_part, R, D, V,
                                  splits, tiles_per_split, cd, st);
  return (int)launch_mode<false>(h, ldh, wt, mode, scale, bias, m_part, s_part, R, D, V,
                                 splits, tiles_per_split, cd, st);
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
