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
// B = 10 rows, E = 256, H = 512, C1 = 65) the cell is 64 GFLOP (0.065 ms
// at the bf16 peak) and the candidate dots 1.4, against ~261 MB of x, h, c
// (bf16) in, c', h', the candidate logits out and the 136 MB of cols:
// ~0.078 ms at 3.35 TB/s.  h' makes no device-memory round trip between
// the cell and the dots.
//
// bf16 design (cell_cand_kernel; wgmma + TMA, sm_90a), the bf16 cell's
// main loop (lstm_cell.cu) with the candidate dots folded in:
// - Block (g, sb) owns unit group g (64 units) of G = 128 / B whole
//   sentences (12 at B = 10: 120 of 128 row slots): 8 x 171 = 1,368
//   blocks at the serving frame, the bf16 cell's 1,280 blocks' grain.
//   Warpgroups 0 and 1 (64 rows each) run wgmma m64n256k16 over K (x's
//   chunks, then h's) on the gate-tiled weight copy (cell_weight_tiles: a
//   group's 4 gates are one 256-row tile), fed by one producer thread's
//   TMA loads of x|h (128 rows x 64) and the weight copy (256 x 64) into a
//   ring of 4 stages of 48 KB, 128-byte swizzled; the gate epilogue runs in
//   registers (c prefetched during the product).
// - The candidate dot is a sum over units, so each unit group computes its
//   share: the epilogue also writes the group's h' (bf16, 128 rows x 64
//   units, 16 KB, swizzled as TMA swizzles) to shared memory; the group's
//   64 columns of its sentences' cols arrive through the same ring right
//   after the product's chunks (a TMA box of C1 rows x 64 a sentence, each
//   at a 1,024-byte aligned slot, 5 sentences a stage at C1 = 65); the
//   consumer warps take (sentence, pair of n8 tiles) units and run
//   cand_dot.cu's product, mma.sync m16n8k16 bf16 -> fp32 with ldmatrix on
//   both swizzled tiles, into the block's slice of a scratch buffer of
//   partial sums [sb][g][G B C1] (26 KB a block; no full-H h' buffer, and
//   h' never reaches device memory between the cell and the dots).
// - The last of a sentence block's groups to finish (a counter a sentence
//   block, left zeroed for the next launch) sums the groups' partials in
//   group order, so the sums come out the same every run, adds cbias and
//   stores the logits coalesced.
// - What holds it at ~1.03x the split pair (lstm_cell_step + cand_dot;
//   chip runs, PERF.md): the last block's sum over the groups (~0.018 ms
//   in all), each block's wait for its 100 KB of cols from device memory
//   after its product (~0.02-0.04), fp32 c' and the h' tile (the product
//   part alone ~0.17 ms against the bf16 cell's ~0.165).  Tried on the
//   H100 and dropped: one block of 12 sentences looping over the 8 groups
//   (171 blocks, two long waves: ~0.56 ms); clusters of the 8 group blocks
//   summing in distributed shared memory (their scheduling cost ~0.06 ms:
//   ~0.30); the cols prefetched into the L2 while the product runs (by TMA
//   or by the idle producer warps: ~0.02 ms slower each).
// - x and h need 16-byte rows (E, H multiples of 8); units past H have zero
//   weights and bias, so their c' and h' are 0 and cols' columns past H
//   (zero-filled by TMA) add nothing.  C1 <= 256 (one TMA box).
// - fp32 compute (the parity mode, cell_cand_f32_kernel): exact fp32 FMAs
//   on the CUDA cores, no TF32.  Bound at the fp32 parity run's frame (S =
//   64 sentences of B = 8 rows, E = 256, H = 512, C1 = 65): the cell's 1.6
//   GFLOP and the dots' 4.3 MFLOP at 67 TFLOP/s, 0.0245 ms; its 10 MB of
//   operands (8.5 MB of them cols) take 0.003 ms at 3.35 TB/s.  The design
//   is the fp32 cell's grid and body (cell_f32.cuh; lstm_cell.cu's note)
//   with the bf16 kernel's sum over unit groups: block (g, sb) owns unit
//   group g (32 units, 128 gate columns) of G = 64 / B whole sentences, 16
//   x 8 = 128 blocks at the parity frame (one an SM; the first design's
//   block owned every unit of its sentences: 8 blocks, 1.93 ms).  Its h'
//   (fp32, 64 x 32) goes to shared memory only; its 32 columns of its
//   sentences' cols arrive by cp.async into the ring the product has
//   freed, in pieces of up to PIECE (sentence, candidate) rows (903), the
//   first during the gate epilogue, so C1 is unbounded; its 32-unit share
//   of each dot goes to the scratch of partial sums, which the last group
//   block of the sentence block sums in group order, as above (no atomics
//   on values: the same logits every run).  What holds it: one call at the
//   parity frame is short enough that the wrapper's Python before the
//   launch (~0.06 ms: checks, four allocations, the ctypes call) is as
//   long as the device's time; 50 calls in a row read the host's time
//   (PERF.md §6).
#include "cell_f32.cuh"
#include "common.cuh"
#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using jlm::fast_sigmoid;
using jlm::fast_tanh;
using jlm::PairOf;
using jlm::store2;
using jlm::to_float2;

constexpr int MAXB = 16;       // rows of a sentence: one m16 tile of the dot

// bf16 kernel
constexpr int BM = 128;                 // row slots of a block (2 consumer warpgroups)
constexpr int UNITS = 64;               // hidden units a group
constexpr int BN = 4 * UNITS;           // gate columns a group
constexpr int WKC = 64;                 // K per stage (one 128-byte swizzle row)
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * WKC * 2;   // 16 KB of x|h
constexpr int STAGE_BYTES = A_BYTES + BN * WKC * 2;  // + 32 KB of W: 48 KB
constexpr int H_BYTES = BM * UNITS * 2;  // the group's h', 16 KB
constexpr int WG_THREADS = 128;
constexpr int MAX_C1 = 256;              // candidate rows of a sentence: one TMA box
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + H_BYTES + BN * 4 + 2 * STAGES * 8 + 16 +
                           1024;

// Byte offset of 16-byte piece `chunk` of row `row` in a 128-byte-swizzled
// tile of 128-byte rows (1,024-byte aligned): what a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B writes.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// tm_x: x [R, E], tm_h: h [R, H], boxes of 128 rows x 64; tm_w: the
// gate-tiled weight [4 Hp, Kp], boxes of 256 x 64; tm_cols: cols as [S C1,
// H], boxes of C1 rows x 64.  nx, nh: K chunks of x and of h; sps:
// sentences a cols stage holds, slot: their byte stride.  Grid: (unit
// group, sentence block).  scratch: [sentence blocks][unit groups][pstride]
// partial sums, pstride >= G B C1 a multiple of 4; done: a zeroed counter a
// sentence block, left zeroed.
template <typename CIn>
__global__ void __launch_bounds__(3 * WG_THREADS, 1)
cell_cand_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_h,
                 const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_cols, const CIn* __restrict__ c,
                 const float* __restrict__ b, const float* __restrict__ cbias,
                 float* __restrict__ c_out, bf16* __restrict__ h_out,
                 float* __restrict__ cand_out, float* __restrict__ scratch,
                 unsigned int* __restrict__ done, int pstride, int S, int B, int G, int C1,
                 int H, int nx, int nh, int sps, int slot, float forget_bias) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sH = smem + STAGES * STAGE_BYTES;      // [128][64] bf16, swizzled
  float* sb = reinterpret_cast<float*>(sH + H_BYTES);   // [gate][unit] biases
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + BN);
  uint64_t* empty = full + STAGES;
  int* last = reinterpret_cast<int*>(empty + STAGES);
  const int wg = threadIdx.x / WG_THREADS;
  const int ub = blockIdx.x, n_ub = gridDim.x;
  const int s0 = blockIdx.y * G, ns = min(G, S - s0);
  const int row0 = s0 * B, rows = ns * B, n_el = rows * C1;
  const int nk = nx + nh, n_cs = (ns + sps - 1) / sps;
  float* part = scratch + ((size_t)blockIdx.y * n_ub + ub) * pstride;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      jlm::mbar_init(&full[s], 1);
      jlm::mbar_init(&empty[s], 2 * WG_THREADS / 32);  // every consumer warp
    }
    jlm::mbar_fence_init();
  }
  __syncthreads();

  // Registers: the consumers' accumulators and epilogue take more than the
  // even share; the producer warpgroup gives up what they take, and both
  // return to the even share for the sum over unit groups.
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full: the K chunks of x|h
    // and W, then the sentences' cols columns ----
    jlm::setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * WG_THREADS) {
      jlm::prefetch_map(&tm_x);
      jlm::prefetch_map(&tm_h);
      jlm::prefetch_map(&tm_w);
      jlm::prefetch_map(&tm_cols);
      for (int i = 0; i < nk + n_cs; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) jlm::mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        unsigned char* a = smem + s * STAGE_BYTES;
        if (i < nk) {
          jlm::mbar_expect_tx(&full[s], STAGE_BYTES);
          if (i < nx)
            jlm::tma_load(a, &tm_x, &full[s], i * WKC, row0);
          else
            jlm::tma_load(a, &tm_h, &full[s], (i - nx) * WKC, row0);
          jlm::tma_load(a + A_BYTES, &tm_w, &full[s], i * WKC, ub * BN);
        } else {
          const int first = (i - nk) * sps, n = min(sps, ns - first);
          jlm::mbar_expect_tx(&full[s], n * C1 * 128);
          for (int q = 0; q < n; ++q)
            jlm::tma_load(a + q * slot, &tm_cols, &full[s], ub * UNITS, (s0 + first + q) * C1);
        }
      }
    }
    __syncwarp();
    jlm::setmaxnreg_inc<168>();
  } else {
    // ---- consumers: rows 64 wg .. + 63 of the block ----
    jlm::setmaxnreg_inc<232>();
    const int ct = threadIdx.x, lane = ct & 31, warp = (ct / 32) & 3, cw = ct / 32;
    const int gid = lane >> 2, tig = lane & 3, mat = lane >> 3, mr = lane & 7;
    const int pairs = (C1 + 15) / 16;
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) jlm::mbar_arrive(&empty[i % STAGES]);
    };
    {
      const int g = ct / UNITS, j = ub * UNITS + ct % UNITS;
      sb[ct] = j < H ? b[g * H + j] : 0.0f;
    }
    typename PairOf<CIn>::type cpre[2][UNITS / 8];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = wg * 64 + warp * 16 + gid + 8 * r;
#pragma unroll
      for (int jj = 0; jj < UNITS / 8; ++jj) {
        const int j = ub * UNITS + jj * 8 + 2 * tig;
        typename PairOf<CIn>::type v{};
        if (rl < rows && j < H)
          v = *reinterpret_cast<const typename PairOf<CIn>::type*>(
              c + (size_t)(row0 + rl) * H + j);
        cpre[r][jj] = v;
      }
    }
    // ---- the unit group's product (lstm_cell.cu's main loop) ----
    float acc[BN / 2];
    for (int kc = 0; kc < nk; ++kc) {
      const int s = kc % STAGES;
      jlm::mbar_wait(&full[s], (kc / STAGES) & 1);
      const unsigned char* a = smem + s * STAGE_BYTES + wg * 64 * 128;
      const unsigned char* w = smem + s * STAGE_BYTES + A_BYTES;
      jlm::wgmma_fence();
#pragma unroll
      for (int k = 0; k < WKC / 16; ++k)
        jlm::wgmma_bf16_n256(acc, jlm::smem_desc(a + k * 32), jlm::smem_desc(w + k * 32),
                             (kc | k) > 0);
      jlm::wgmma_commit();
      if (kc > 0) {  // the previous chunk's group is done: release its stage
        jlm::wgmma_wait<1>();
        release(kc - 1);
      }
    }
    jlm::wgmma_wait<0>();
    jlm::fence_regs(acc);
    release(nk - 1);
    jlm::named_sync(1, 2 * WG_THREADS);  // sb written

    // ---- gate epilogue in registers: c', h' out, h' into sH ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = wg * 64 + warp * 16 + gid + 8 * r;
#pragma unroll
      for (int jj = 0; jj < UNITS / 8; ++jj) {
        const int u = jj * 8 + 2 * tig, j = ub * UNITS + u;  // units j, j + 1
        const float2 cc = to_float2(cpre[r][jj]);
        float cn[2], hn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = 2 * r + e;
          const float zi = acc[4 * (0 * 8 + jj) + f] + sb[0 * UNITS + u + e];
          const float zj = acc[4 * (1 * 8 + jj) + f] + sb[1 * UNITS + u + e];
          const float zf = acc[4 * (2 * 8 + jj) + f] + sb[2 * UNITS + u + e];
          const float zo = acc[4 * (3 * 8 + jj) + f] + sb[3 * UNITS + u + e];
          cn[e] = fast_sigmoid(zf + forget_bias) * (e ? cc.y : cc.x) +
                  fast_sigmoid(zi) * fast_tanh(zj);
          hn[e] = fast_sigmoid(zo) * fast_tanh(cn[e]);
        }
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(hn[0], hn[1]);
        *reinterpret_cast<__nv_bfloat162*>(sH + swz(rl, jj) + 4 * tig) = h2;
        if (rl < rows && j < H) {
          const size_t idx = (size_t)(row0 + rl) * H + j;
          store2(c_out + idx, cn[0], cn[1]);
          *reinterpret_cast<__nv_bfloat162*>(h_out + idx) = h2;
        }
      }
    }
    jlm::named_sync(1, 2 * WG_THREADS);  // the group's h' is in sH

    // ---- the group's share of the candidate dots into scratch: consumer
    // warp cw takes units cw, cw + 8, ... of (sentence, pair of n8 tiles) ----
    for (int j = 0; j < n_cs; ++j) {
      const int i = nk + j, s = i % STAGES, fs = j * sps, n = min(sps, ns - fs);
      jlm::mbar_wait(&full[s], (i / STAGES) & 1);
      const unsigned char* st = smem + s * STAGE_BYTES;
      for (int unit = cw; unit < n * pairs; unit += 2 * WG_THREADS / 32) {
        const int q = unit / pairs, pr = unit % pairs, si = fs + q;
        const unsigned char* cs = st + q * slot;
        const int arow = min(si * B + (mat & 1) * 8 + mr, BM - 1);
        const int brow = min(pr * 16 + (mat >> 1) * 8 + mr, C1 - 1);
        float d[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < UNITS / 16; ++ks) {
          uint32_t a[4], bb[4];
          jlm::ldsm_x4(a[0], a[1], a[2], a[3], sH + swz(arow, 2 * ks + (mat >> 1)));
          jlm::ldsm_x4(bb[0], bb[1], bb[2], bb[3], cs + swz(brow, 2 * ks + (mat & 1)));
          jlm::mma_bf16(d[0], a, bb[0], bb[1]);
          jlm::mma_bf16(d[1], a, bb[2], bb[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = gid + 8 * (e >> 1), col = pr * 16 + nt * 8 + 2 * tig + (e & 1);
            if (row < B && col < C1) part[(si * B + row) * C1 + col] = d[nt][e];
          }
      }
      release(i);
    }
    jlm::setmaxnreg_dec<168>();
  }

  // ---- the last block of the sentence block to finish sums every unit
  // group's partials, in group order, adds cbias, stores the logits.  One
  // thread orders the block's partial sums before its count (the barrier
  // orders the other threads' before it), and the last block's reads after
  // its own ----
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *last = atomicAdd(done + blockIdx.y, 1u) == (unsigned)(n_ub - 1);
    if (*last) {
      done[blockIdx.y] = 0;  // zeroed again for the next launch
      __threadfence();
    }
  }
  __syncthreads();
  if (!*last) return;
  // float4s of the partials, two a thread and 8 groups a pass in flight
  // (the loads of a pass are independent; the adds stay in group order);
  // the lanes of a float4 past n_el are never stored
  const float4* parts = reinterpret_cast<const float4*>(scratch) +
                        (size_t)blockIdx.y * n_ub * (pstride / 4);
  float* out = cand_out + (size_t)row0 * C1;
  constexpr int T = 3 * WG_THREADS, QP = 8;
  const int n4 = (n_el + 3) / 4;
  for (int v0 = threadIdx.x; v0 < n4; v0 += 2 * T) {
    float4 v[2] = {};
    for (int q0 = 0; q0 < n_ub; q0 += QP) {
      float4 p[2][QP];
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int q = 0; q < QP; ++q)
          p[k][q] = q0 + q < n_ub && v0 + k * T < n4
                        ? __ldcg(parts + (size_t)(q0 + q) * (pstride / 4) + v0 + k * T)
                        : float4{};
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int q = 0; q < QP; ++q) {
          v[k].x += p[k][q].x;
          v[k].y += p[k][q].y;
          v[k].z += p[k][q].z;
          v[k].w += p[k][q].w;
        }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float vs[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int e = 4 * (v0 + k * T) + l;
        if (e < n_el)
          out[e] = vs[l] + __ldg(cbias + (size_t)s0 * C1 + (e / (B * C1)) * C1 + e % C1);
      }
    }
  }
}

// ---- fp32 compute: cell_cand_f32_kernel ----

constexpr int LDP = jlm::F32Tile::FJ + 4;  // floats a row of h' or of cols in shared memory
// cols rows a piece holds: the ring past the parts' sums and the block's h'
constexpr int PIECE = (jlm::F32Tile::MAIN - jlm::F32Tile::RED) / 4 / LDP - jlm::F32Tile::FR;

// x [R, E], h [R, H], W [E+H, 4H], cols [S, C1, H], h_out fp32.  Grid:
// (unit group of FJ = 32 units, sentence block of G = 64 / B sentences).
// The block's cell is the fp32 cell's body (cell_f32.cuh) on its rows and
// units; its h' (fp32) goes to shared memory only.  Its share of its
// sentences' dots reads cols[s, :, j0 : j0 + 32], which arrives by
// cp.async into the ring the product has freed, PIECE rows (sentence,
// candidate) at a time, the first piece during the gate epilogue; a
// thread takes (beam row, cols row) pairs, neighbouring threads
// neighbouring cols rows (padded rows: no bank conflict), and writes its
// 32-unit dot into the block's slice of scratch [sentence blocks][unit
// groups][pstride].  The last group block of a sentence block to finish
// (done: a zeroed counter a sentence block, left zeroed) sums the groups'
// partials in group order, adds cbias and stores the logits.
template <typename CIn>
__global__ void __launch_bounds__(jlm::F32Tile::THREADS, 1)
cell_cand_f32_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const CIn* __restrict__ c, const float* __restrict__ W,
                     const float* __restrict__ b, const float* __restrict__ cols,
                     const float* __restrict__ cbias, float* __restrict__ c_out,
                     float* __restrict__ h_out, float* __restrict__ cand_out,
                     float* __restrict__ scratch, unsigned int* __restrict__ done, int pstride,
                     int S, int B, int G, int E, int H, int C1, float forget_bias) {
  using T = jlm::F32Tile;
  constexpr int FJ = T::FJ, NT = T::THREADS;
  extern __shared__ __align__(16) float fsmem[];
  __shared__ int last;
  const int ug = blockIdx.x, n_ug = gridDim.x, j0 = ug * FJ;
  const int s0 = blockIdx.y * G, ns = min(G, S - s0);
  const int row0 = s0 * B, rows = ns * B, n_t = ns * C1, n_el = rows * C1;
  float* sHn = fsmem + T::RED / 4;  // [FR][LDP] the block's h'
  float* sCol = sHn + T::FR * LDP;  // [PIECE][LDP] cols rows t0 ..
  float* part = scratch + ((size_t)blockIdx.y * n_ug + ug) * pstride;
  const float* col0 = cols + (size_t)s0 * C1 * H + j0;  // the block's cols row t: s0 C1 + t
  auto fetch = [&](int t0) {  // one commit group
    const int n = min(PIECE, n_t - t0);
    for (int i = threadIdx.x; i < n * (FJ / 4); i += NT) {
      const int r = i / (FJ / 4), q = i % (FJ / 4);
      jlm::cp_async16(sCol + r * LDP + 4 * q, col0 + (size_t)(t0 + r) * H + 4 * q, true);
    }
    jlm::cp_async_commit();
  };
  jlm::cell_f32_block(fsmem, x, h, c, W, b, row0, row0 + rows, j0, E, H, forget_bias,
                      [&] { fetch(0); },
                      [&](int r, int u, size_t idx, float cn, float hn) {
                        c_out[idx] = cn;
                        h_out[idx] = hn;
                        sHn[r * LDP + u] = hn;
                      });

  // ---- the group's share of the dots: pair i of a piece is beam row
  // i / n of cols row t0 + i % n ----
  for (int t0 = 0; t0 < n_t; t0 += PIECE) {
    if (t0 > 0) {
      __syncthreads();  // the previous piece is read
      fetch(t0);
    }
    jlm::cp_async_wait<0>();
    __syncthreads();  // the piece and h' are in shared memory
    const int n = min(PIECE, n_t - t0);
    for (int i = threadIdx.x; i < n * B; i += NT) {
      const int bb = i / n, tt = i - bb * n, t = t0 + tt, s = t / C1, cj = t - s * C1;
      const float* hp = sHn + (s * B + bb) * LDP;
      const float* cp = sCol + tt * LDP;
      float d = 0.0f;
#pragma unroll
      for (int q = 0; q < FJ / 4; ++q) {
        const float4 hv = *reinterpret_cast<const float4*>(hp + 4 * q);
        const float4 cv = *reinterpret_cast<const float4*>(cp + 4 * q);
        d = fmaf(hv.x, cv.x, d);
        d = fmaf(hv.y, cv.y, d);
        d = fmaf(hv.z, cv.z, d);
        d = fmaf(hv.w, cv.w, d);
      }
      part[(s * B + bb) * C1 + cj] = d;
    }
  }

  // ---- the last group block of the sentence block to finish sums every
  // group's partials, in group order, adds cbias, stores the logits (as
  // cell_cand_kernel does) ----
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(done + blockIdx.y, 1u) == (unsigned)(n_ug - 1);
    if (last) {
      done[blockIdx.y] = 0;  // zeroed again for the next launch
      __threadfence();
    }
  }
  __syncthreads();
  if (!last) return;
  const float4* parts = reinterpret_cast<const float4*>(scratch) +
                        (size_t)blockIdx.y * n_ug * (pstride / 4);
  float* out = cand_out + (size_t)row0 * C1;
  constexpr int QP = 8;  // groups a pass, their loads in flight together
  const int n4 = (n_el + 3) / 4;
  for (int v0 = threadIdx.x; v0 < n4; v0 += 2 * NT) {
    float4 v[2] = {};
    for (int q0 = 0; q0 < n_ug; q0 += QP) {
      float4 p[2][QP];
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int q = 0; q < QP; ++q)
          p[k][q] = q0 + q < n_ug && v0 + k * NT < n4
                        ? __ldcg(parts + (size_t)(q0 + q) * (pstride / 4) + v0 + k * NT)
                        : float4{};
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int q = 0; q < QP; ++q) {
          v[k].x += p[k][q].x;
          v[k].y += p[k][q].y;
          v[k].z += p[k][q].z;
          v[k].w += p[k][q].w;
        }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float vs[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int e = 4 * (v0 + k * NT) + l;
        if (e < n_el)
          out[e] = vs[l] + __ldg(cbias + (size_t)s0 * C1 + (e / (B * C1)) * C1 + e % C1);
      }
    }
  }
}

template <typename CIn>
cudaError_t launch_bf16(const void* x, const void* h, const void* c, const void* w_tiles,
                        const float* b, const void* cols, const float* cbias, float* c_out,
                        void* h_out, float* cand_out, float* scratch, unsigned int* done,
                        int S, int B, int E, int H, int C1, float forget_bias,
                        cudaStream_t stream) {
  const int R = S * B, G = BM / B, pstride = (G * B * C1 + 3) / 4 * 4;
  const int nx = (E + WKC - 1) / WKC, nh = (H + WKC - 1) / WKC;
  const int n_ub = (H + UNITS - 1) / UNITS;
  const int slot = (C1 * 128 + 1023) / 1024 * 1024, sps = STAGE_BYTES / slot;
  CUtensorMap tx, th, tw, tc;
  if (!jlm::tensor_map(&tx, x, 2, R, E, E, BM, WKC) ||
      !jlm::tensor_map(&th, h, 2, R, H, H, BM, WKC) ||
      !jlm::tensor_map(&tw, w_tiles, 2, n_ub * BN, (nx + nh) * WKC, (nx + nh) * WKC, BN,
                       WKC) ||
      !jlm::tensor_map(&tc, cols, 2, S * C1, H, H, C1, WKC))
    return cudaErrorInvalidValue;
  auto kernel = cell_cand_kernel<CIn>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_ub, (S + G - 1) / G);
  kernel<<<grid, 3 * WG_THREADS, SMEM_BYTES, stream>>>(
      tx, th, tw, tc, static_cast<const CIn*>(c), b, cbias, c_out, static_cast<bf16*>(h_out),
      cand_out, scratch, done, pstride, S, B, G, C1, H, nx, nh, sps, slot, forget_bias);
  return cudaGetLastError();
}

template <typename CIn>
cudaError_t launch_f32(const void* x, const void* h, const void* c, const void* W,
                       const float* b, const void* cols, const float* cbias, float* c_out,
                       void* h_out, float* cand_out, float* scratch, unsigned int* done, int S,
                       int B, int E, int H, int C1, float forget_bias, cudaStream_t stream) {
  using T = jlm::F32Tile;
  const int G = T::FR / B, pstride = (G * B * C1 + 3) / 4 * 4;
  auto kernel = cell_cand_f32_kernel<CIn>;
  static bool ready[64];  // the attribute is set once a device and instantiation
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev] = true;
  }
  const dim3 grid(H / T::FJ, (S + G - 1) / G);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(h), static_cast<const CIn*>(c),
      static_cast<const float*>(W), b, static_cast<const float*>(cols), cbias, c_out,
      static_cast<float*>(h_out), cand_out, scratch, done, pstride, S, B, G, E, H, C1,
      forget_bias);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [S*B, E], h [S*B, H], cols [S, C1, H] and h_out [S*B, H]: bf16 (E, H
// multiples of 8, 16-byte aligned; W the gate-tiled copy [4 Hp, Kp] of
// ops/lstm_cell.py's cell_weight_tiles; C1 <= 256), or fp32 when f32 (fp32
// compute; W [E+H, 4H]; E and H multiples of 32); c [S*B, H] fp32 (c_f32)
// or bf16; b [4H] and cbias [S, C1] fp32; c_out [S*B, H] and cand_out [S,
// B, C1] fp32.  B <= 16.  scratch: fp32 [ceil(S / G), ceil(H / U), G B C1
// rounded up to a multiple of 4] with G = 128 / B, U = 64 (bf16) or G =
// 64 / B, U = 32 (fp32); done: ceil(S / G) zeroed counters, which the
// launch leaves zeroed.
int jlm_cell_cand(const void* x, const void* h, const void* c, int c_f32,
                  const void* W, const float* b, const void* cols,
                  const float* cbias, float* c_out, void* h_out, float* cand_out,
                  float* scratch, unsigned int* done, int S, int B, int E, int H, int C1,
                  int f32, float forget_bias, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > MAXB || C1 < 1) return (int)cudaErrorInvalidValue;
  if (f32 ? (E % jlm::F32Tile::FK || H % jlm::F32Tile::FJ)
          : (E % 8 || H % 8 || C1 > MAX_C1))
    return (int)cudaErrorInvalidValue;
  if (f32)
    return (int)(c_f32 ? launch_f32<float>(x, h, c, W, b, cols, cbias, c_out, h_out,
                                           cand_out, scratch, done, S, B, E, H, C1,
                                           forget_bias, st)
                       : launch_f32<bf16>(x, h, c, W, b, cols, cbias, c_out, h_out,
                                          cand_out, scratch, done, S, B, E, H, C1,
                                          forget_bias, st));
  return (int)(c_f32 ? launch_bf16<float>(x, h, c, W, b, cols, cbias, c_out, h_out,
                                          cand_out, scratch, done, S, B, E, H, C1,
                                          forget_bias, st)
                     : launch_bf16<bf16>(x, h, c, W, b, cols, cbias, c_out, h_out,
                                         cand_out, scratch, done, S, B, E, H, C1,
                                         forget_bias, st));
}

}  // extern "C"
