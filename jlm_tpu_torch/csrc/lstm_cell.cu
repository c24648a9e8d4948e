// Fused single-step LSTM cell for the decode frame:
//   z = x @ W[:E] + h @ W[E:] + b  (fp32 accumulate), gates i, j, f, o;
//   c' = sigmoid(f + forget_bias) * c + sigmoid(i) * tanh(j)
//   h' = sigmoid(o) * tanh(c')
//
// Replaces jlm_tpu/ops/lstm_cell.py::_cell_kernel (bf16 and fp32 compute).
// Called once per layer per frame on every beam row.
//
// Bound: at the main path's shapes (R = 20,480, E = 256, H = 512) the
// product is 2*R*(E+H)*4H = 64 GFLOP in bf16 (0.065 ms at 989 TFLOP/s)
// against ~60 MB of x, h, c, c' and h' (0.018 ms at 3.35 TB/s): the tensor
// cores bound it, once the gate pre-activations stay on chip (written to
// device memory, z alone would be 168 MB of fp32 per frame).
//
// bf16 design (wgmma + TMA, sm_90a):
// - A block owns BM = 128 rows and U = 64 hidden units and computes the
//   columns of those units in ALL FOUR gates: N = 4 x 64 = 256, so each
//   thread's wgmma accumulator fragment holds the same units in the four
//   gate segments of N and the gate epilogue runs in registers; z never
//   reaches memory.  Grid: ceil(H / 64) unit blocks x ceil(R / 128) row
//   tiles (8 x 160 at the main path), the unit blocks fastest, so the 8
//   blocks that read the same rows of x|h run together and the rows come
//   from device memory once.
// - The weight is read from its gate-tiled copy (``cell_weight_tiles`` in
//   ops/lstm_cell.py, made once by build_decode_head): [4 Hp, Kp] bf16,
//   K-major, row ub*256 + g*64 + u holding column g*H + ub*64 + u of W,
//   K = x's E columns padded to a multiple of 64, then h's H padded so.
//   Both operands are then K-major, the layout every wgmma takes.
// - 384 threads: warpgroups 0 and 1 consume (64 rows each, one
//   m64n256k16 per 16 of K, fp32 accumulators in registers), warpgroup 2
//   produces: one thread issues TMA loads of a 128 x 64 tile of x or h and
//   of the weight copy's 256 x 64 tile per K chunk into a ring of 4 stages
//   (48 KB each, 192 KB), 128-byte swizzled; full/empty mbarriers pace the
//   ring, and each consumer warp releases a stage when the wgmma group
//   that read it has completed (one group stays in flight).  TMA
//   zero-fills rows past R and columns past E or H.
// - The epilogue's operands are fetched before the product starts and
//   arrive during it: c into registers, the block's 4 x 64 biases into
//   shared memory.  sigmoid and tanh come from ex2.approx and rcp.approx
//   (a few fp32 ulp); every value is computed and only the stores are
//   masked, so the scheduler interleaves the units.
// - Traffic from the L2: each of the 1,280 blocks reads 128 x 768 x 2 B of
//   x|h and 256 x 768 x 2 B of W, 755 MB a call at the main path (the
//   mma.sync design it replaces read 1.0 GB).  A 2-block cluster
//   multicasting W cut that to 503 MB and ran slower on the H100 (0.256
//   against 0.215 ms), so blocks are not clustered.  What bounds it: the
//   loads alone take ~0.13 ms (the L2 at ~5.8 TB/s), loads and products
//   ~0.17 ms, the whole kernel ~0.22 ms -- a block's epilogue does not
//   overlap the next tile's product (one block an SM, not persistent).
// - c is read in its own dtype (bf16 or fp32); c' is written in c_out's
//   dtype and h' in bf16, two units a thread at a time.
// - fp32 compute (the parity forward): exact fp32 FMAs on the CUDA cores,
//   no TF32, accurate expf and tanhf in the epilogue; h' is fp32.  Bound at
//   the fp32 parity run's shapes (R = 512 rows): 1.6 GFLOP against 67
//   TFLOP/s, 0.024 ms.  A block owns 64 rows x 32 units (their 128 gate
//   columns; 128 blocks at R = 512, H = 512, one an SM) with 256 threads in
//   two K parts: part p takes K chunks p, p + 2, ... (32 of K each) through
//   a cp.async ring of its own (4 stages), its 128 threads meeting only at
//   a named barrier of their own, so the two parts drift apart and their
//   shared-memory reads spread out; a thread keeps 8 rows x 2 groups of 4
//   neighbouring columns (float4 reads of x|h over k and of W over the
//   columns).  The parts' sums meet in shared memory once, where every
//   thread takes cells of the gate epilogue; c's tile and the biases
//   arrive by cp.async with the first chunk.  The block-wide barrier the
//   parts shared before held the kernel back on the H100: other tile
//   shapes (rows, parts, columns a thread, K chunk, unrolling) behind it
//   did not move the time, a barrier for each part did (PERF.md §6).
#include "common.cuh"
#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BM = 128;                 // rows per block (2 consumer warpgroups)
constexpr int UNITS = 64;               // hidden units per block
constexpr int BN = 4 * UNITS;           // gate columns per block
constexpr int KC = 64;                  // K per stage (one 128-byte swizzle row)
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * KC * 2;    // 16 KB
constexpr int B_BYTES = BN * KC * 2;    // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int WG_THREADS = 128;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + BN * 4 + 1024;

using jlm::fast_sigmoid;
using jlm::fast_tanh;
using jlm::PairOf;
using jlm::store2;
using jlm::to_float2;

// tm_x: x [R, E], tm_h: h [R, H], both boxes of 128 rows x 64; tm_w: the
// gate-tiled weight [4 Hp, Kp], boxes of 256 rows x 64 (a block's four
// gates).  nx, nh: K chunks of x and of h.  Grid: unit blocks x row tiles.
template <typename CIn, typename COut>
__global__ void __launch_bounds__(3 * WG_THREADS, 1)
lstm_cell_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_h,
                       const __grid_constant__ CUtensorMap tm_w,
                       const CIn* __restrict__ c, const float* __restrict__ b,
                       COut* __restrict__ c_out, __nv_bfloat16* __restrict__ h_out,
                       int R, int H, int nx, int nh, float forget_bias) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  float* sbias = reinterpret_cast<float*>(empty + STAGES);  // [gate][unit] of the block
  const int wg = threadIdx.x / WG_THREADS;
  const int row0 = blockIdx.y * BM, ub = blockIdx.x;
  const int nk = nx + nh;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      jlm::mbar_init(&full[s], 1);
      jlm::mbar_init(&empty[s], 2 * WG_THREADS / 32);  // every consumer warp
    }
    jlm::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    jlm::setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * WG_THREADS) {
      jlm::prefetch_map(&tm_x);
      jlm::prefetch_map(&tm_h);
      jlm::prefetch_map(&tm_w);
      for (int kc = 0; kc < nk; ++kc) {
        const int s = kc % STAGES;
        if (kc >= STAGES) jlm::mbar_wait(&empty[s], ((kc / STAGES) - 1) & 1);
        unsigned char* a = smem + s * STAGE_BYTES;
        jlm::mbar_expect_tx(&full[s], STAGE_BYTES);  // A and W
        if (kc < nx)
          jlm::tma_load(a, &tm_x, &full[s], kc * KC, row0);
        else
          jlm::tma_load(a, &tm_h, &full[s], (kc - nx) * KC, row0);
        jlm::tma_load(a + A_BYTES, &tm_w, &full[s], kc * KC, ub * BN);
      }
    }
  } else {
    // ---- consumers: 64 rows x 256 gate columns each ----
    jlm::setmaxnreg_inc<232>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
    auto release = [&](int kc) {  // the stage of chunk kc
      __syncwarp();
      if (lane == 0) jlm::mbar_arrive(&empty[kc % STAGES]);
    };
    // The epilogue's operands, fetched while the product runs: the block's
    // bias into shared memory, the thread's pairs of c into registers.
    {
      const int g = threadIdx.x / UNITS, j = ub * UNITS + threadIdx.x % UNITS;
      sbias[threadIdx.x] = j < H ? b[g * H + j] : 0.0f;
    }
    typename PairOf<CIn>::type cpre[2][UNITS / 8];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + wg * 64 + warp * 16 + lane / 4 + 8 * i;
#pragma unroll
      for (int jj = 0; jj < UNITS / 8; ++jj) {
        const int j = ub * UNITS + jj * 8 + 2 * (lane & 3);
        typename PairOf<CIn>::type v{};
        if (row < R && j < H)
          v = *reinterpret_cast<const typename PairOf<CIn>::type*>(c + (size_t)row * H + j);
        cpre[i][jj] = v;
      }
    }
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int kc = 0; kc < nk; ++kc) {
      const int s = kc % STAGES;
      jlm::mbar_wait(&full[s], (kc / STAGES) & 1);
      const unsigned char* a = smem + s * STAGE_BYTES + wg * 64 * 128;
      const unsigned char* w = smem + s * STAGE_BYTES + A_BYTES;
      jlm::wgmma_fence();
#pragma unroll
      for (int k = 0; k < KC / 16; ++k)
        jlm::wgmma_bf16_n256(acc, jlm::smem_desc(a + k * 32), jlm::smem_desc(w + k * 32), 1);
      jlm::wgmma_commit();
      if (kc > 0) {  // the previous chunk's group is done: release its stage
        jlm::wgmma_wait<1>();
        release(kc - 1);
      }
    }
    jlm::wgmma_wait<0>();
    jlm::fence_regs(acc);
    release(nk - 1);
    jlm::named_sync(1, 2 * WG_THREADS);  // sbias written

    // ---- gate epilogue, all in registers: d[4 j + 2 i + e] is row
    // 16 warp + lane/4 + 8 i, column 8 j + 2 (lane % 4) + e; gate j / 8 ----
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + wg * 64 + warp * 16 + lane / 4 + 8 * i;
#pragma unroll
      for (int jj = 0; jj < UNITS / 8; ++jj) {
        const int u = jj * 8 + 2 * (lane & 3), j = ub * UNITS + u;  // units j, j + 1
        const float2 cc = to_float2(cpre[i][jj]);
        float cn[2], hn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = 2 * i + e;
          const float zi = acc[4 * (0 * 8 + jj) + f] + sbias[0 * UNITS + u + e];
          const float zj = acc[4 * (1 * 8 + jj) + f] + sbias[1 * UNITS + u + e];
          const float zf = acc[4 * (2 * 8 + jj) + f] + sbias[2 * UNITS + u + e];
          const float zo = acc[4 * (3 * 8 + jj) + f] + sbias[3 * UNITS + u + e];
          cn[e] = fast_sigmoid(zf + forget_bias) * (e ? cc.y : cc.x) +
                  fast_sigmoid(zi) * fast_tanh(zj);
          hn[e] = fast_sigmoid(zo) * fast_tanh(cn[e]);
        }
        if (row < R && j < H) {  // computed regardless, for the scheduler's sake
          const size_t idx = (size_t)row * H + j;
          store2(c_out + idx, cn[0], cn[1]);
          store2(h_out + idx, hn[0], hn[1]);
        }
      }
    }
  }
}

constexpr int FJ = 32;  // units per block of the fp32 kernel (x 4 gates: 128 columns)

using jlm::cp_async16;
using jlm::cp_async_commit;
using jlm::cp_async_wait;

// The fp32 kernel's shape: FR rows x FJ units (4 FJ gate columns) a
// block, K in chunks of FK, KS parts of FR / 8 x TX threads, part p taking
// chunks p, p + KS, ... through a ring of its own of PST stages; a thread
// keeps 8 rows x NG groups of 4 neighbouring columns, the groups 4 FJ / NG
// columns apart.
struct F32Tile {
  static constexpr int FR = 64, KS = 2, FK = 32, NG = 2, PST = 4;
  static constexpr int TX = FJ / NG;                  // threads across the columns
  static constexpr int GS = 4 * FJ / NG;              // columns between a thread's groups
  static constexpr int PART = FR / 8 * TX;            // threads of a part
  static constexpr int THREADS = KS * PART;
  static constexpr int LDA = FK + 4;                  // [row][k] stage row, padded
  static constexpr int A = FR * LDA;                  // floats of a stage's x|h tile
  static constexpr int B = FK * 4 * FJ;               // floats of a stage's W tile
  static constexpr int RING = KS * PST * (A + B) * 4;
  static constexpr int RED = KS * FR * 4 * FJ * 4;    // every part's sums, over the ring
  static constexpr int MAIN = RING > RED ? RING : RED;
  static constexpr int SMEM = MAIN + 4 * FJ * 4 + FR * FJ * 4;  // + biases, c (fp32 at most)
};

// Part threads t < T::PART issue chunk kc's loads into (sA, sB): x|h rows
// [row0, row0 + FR) x K [kc FK, +FK) as [row][k], and W's rows of that K
// for the block's FJ units in 4 gates as [k][gate][unit].
__device__ __forceinline__ void load_f32_chunk(float* sA, float* sB, const float* x,
                                               const float* h, const float* W, int kc, int t,
                                               int row0, int j0, int R, int E, int H) {
  using T = F32Tile;
  const int k0 = kc * T::FK;
  const float* src = k0 < E ? x : h;
  const int lds = k0 < E ? E : H, kx = k0 < E ? k0 : k0 - E;
  for (int i = t; i < T::FR * T::FK / 4; i += T::PART) {
    const int r = i / (T::FK / 4), q = i % (T::FK / 4), row = row0 + r;
    cp_async16(sA + r * T::LDA + 4 * q, src + (size_t)(row < R ? row : 0) * lds + kx + 4 * q,
               row < R);
  }
  for (int i = t; i < T::FK * FJ; i += T::PART) {
    const int kr = i / FJ, g = (i / (FJ / 4)) % 4, q = i % (FJ / 4);
    cp_async16(sB + (kr * 4 + g) * FJ + 4 * q,
               W + (size_t)(k0 + kr) * 4 * H + g * H + j0 + 4 * q, true);
  }
}

// fp32 compute: x [R, E], h [R, H], W [E+H, 4H] fp32; h_out fp32.  Thread
// (ty, tx) of part p keeps rows ty + FR/8 i (i < 8) over its part's
// chunks; a warp's ty read neighbouring rows (no bank conflict).  A part
// loads its own chunks and meets only its own threads at a named barrier,
// so the parts drift apart and their shared loads spread out.  The parts'
// sums meet in shared memory, where every thread then takes cells of the
// epilogue.
template <typename CIn, typename COut>
__global__ void __launch_bounds__(F32Tile::THREADS, 1)
lstm_cell_f32_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const CIn* __restrict__ c, const float* __restrict__ W,
                     const float* __restrict__ b, COut* __restrict__ c_out,
                     float* __restrict__ h_out, int R, int E, int H,
                     float forget_bias) {
  using T = F32Tile;
  extern __shared__ __align__(16) float fsmem[];
  constexpr int FR = T::FR, KS = T::KS, FK = T::FK, LDA = T::LDA, TY = FR / 8;
  constexpr int NG = T::NG, GS = T::GS, PST = T::PST;
  const int part = threadIdx.x / T::PART, t = threadIdx.x % T::PART;
  const int ty = t / T::TX, tx = t % T::TX;
  const int row0 = blockIdx.x * FR, j0 = blockIdx.y * FJ;
  const int nk = (E + H) / FK, nkp = part < nk ? (nk - part + KS - 1) / KS : 0;
  auto sA = [&](int i) { return fsmem + (part * PST + i % PST) * (T::A + T::B); };
  auto load = [&](int i) {  // the part's i-th chunk, one commit group
    if (i < nkp)
      load_f32_chunk(sA(i), sA(i) + T::A, x, h, W, part + i * KS, t, row0, j0, R, E, H);
    cp_async_commit();
  };
  float acc[8][NG][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.0f;
  // The epilogue's operands arrive with the first chunk: the block's 4 x FJ
  // biases and its FR x FJ tile of c (zeros past R).
  float* sbias = fsmem + T::MAIN / 4;
  CIn* sc = reinterpret_cast<CIn*>(sbias + 4 * FJ);
  {
    constexpr int CPR = FJ * sizeof(CIn) / 16;  // 16-byte pieces of a row of c
    for (int i = threadIdx.x; i < FR * CPR + FJ; i += T::THREADS) {
      if (i < FR * CPR) {
        const int r = i / CPR, q = i % CPR, row = row0 + r;
        cp_async16(reinterpret_cast<unsigned char*>(sc) + 16 * i,
                   reinterpret_cast<const unsigned char*>(
                       c + (size_t)(row < R ? row : 0) * H + j0) + 16 * q,
                   row < R);
      } else {
        const int g = (i - FR * CPR) / (FJ / 4), q = (i - FR * CPR) % (FJ / 4);
        cp_async16(sbias + g * FJ + 4 * q, b + g * H + j0 + 4 * q, true);
      }
    }
  }
  for (int i = 0; i < PST - 1; ++i) load(i);
  for (int i = 0; i < nkp; ++i) {
    cp_async_wait<PST - 2>();  // this thread's pieces of chunk i have landed
    // every piece of chunk i has landed, and chunk i - 1's stage is free
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + part), "n"(T::PART) : "memory");
    load(i + PST - 1);
    const float* a_t = sA(i) + ty * LDA;
    const float* b_t = sA(i) + T::A + 4 * tx;
#pragma unroll
    for (int k4 = 0; k4 < FK; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        a[r] = *reinterpret_cast<const float4*>(a_t + r * TY * LDA + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 w[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g)
          w[g] = *reinterpret_cast<const float4*>(b_t + (k4 + kk) * 4 * FJ + g * GS);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float av = kk == 0 ? a[r].x : kk == 1 ? a[r].y : kk == 2 ? a[r].z : a[r].w;
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            acc[r][g][0] = fmaf(av, w[g].x, acc[r][g][0]);
            acc[r][g][1] = fmaf(av, w[g].y, acc[r][g][1]);
            acc[r][g][2] = fmaf(av, w[g].z, acc[r][g][2]);
            acc[r][g][3] = fmaf(av, w[g].w, acc[r][g][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every part is done with the ring, and c and the biases have landed
  // every part's sums, [part][row][gate][unit], over the ring
  float* red = fsmem + part * FR * 4 * FJ;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
      *reinterpret_cast<float4*>(red + (ty + TY * i) * 4 * FJ + g * GS + 4 * tx) =
          make_float4(acc[i][g][0], acc[i][g][1], acc[i][g][2], acc[i][g][3]);
  __syncthreads();
  for (int cell = threadIdx.x; cell < FR * FJ; cell += T::THREADS) {
    const int r = cell / FJ, u = cell % FJ, row = row0 + r, j = j0 + u;
    if (row >= R) break;
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      z[g] = sbias[g * FJ + u];
#pragma unroll
      for (int p = 0; p < KS; ++p) z[g] += fsmem[((p * FR + r) * 4 + g) * FJ + u];
    }
    const size_t idx = (size_t)row * H + j;
    const float cn = jlm::sigmoidf(z[2] + forget_bias) * static_cast<float>(sc[cell]) +
                     jlm::sigmoidf(z[0]) * tanhf(z[1]);
    c_out[idx] = static_cast<COut>(cn);
    h_out[idx] = jlm::sigmoidf(z[3]) * tanhf(cn);
  }
}

template <typename CIn, typename COut>
cudaError_t launch_f32(const void* x, const void* h, const void* c, const void* W,
                       const float* b, void* c_out, void* h_out, int R, int E, int H,
                       float forget_bias, cudaStream_t stream) {
  using T = F32Tile;
  auto kernel = lstm_cell_f32_kernel<CIn, COut>;
  static bool ready[64];  // the attribute is set once a device and instantiation
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev] = true;
  }
  dim3 grid((R + T::FR - 1) / T::FR, H / FJ);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(h),
      static_cast<const CIn*>(c), static_cast<const float*>(W), b,
      static_cast<COut*>(c_out), static_cast<float*>(h_out), R, E, H, forget_bias);
  return cudaGetLastError();
}

template <typename CIn, typename COut>
cudaError_t launch_wgmma(const void* x, const void* h, const void* c, const void* w_tiles,
                         const float* b, void* c_out, void* h_out, int R, int E, int H,
                         float forget_bias, cudaStream_t stream) {
  const int nx = (E + KC - 1) / KC, nh = (H + KC - 1) / KC;
  const int units = (H + UNITS - 1) / UNITS;  // unit blocks (rows of 256 in w_tiles)
  CUtensorMap tx, th, tw;
  if (!jlm::tensor_map(&tx, x, 2, R, E, E, BM, KC) ||
      !jlm::tensor_map(&th, h, 2, R, H, H, BM, KC) ||
      !jlm::tensor_map(&tw, w_tiles, 2, units * BN, (nx + nh) * KC, (nx + nh) * KC, BN, KC))
    return cudaErrorInvalidValue;
  auto kernel = lstm_cell_wgmma_kernel<CIn, COut>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(units, (R + BM - 1) / BM);
  kernel<<<grid, 3 * WG_THREADS, SMEM_BYTES, stream>>>(
      tx, th, tw, static_cast<const CIn*>(c), b, static_cast<COut*>(c_out),
      static_cast<__nv_bfloat16*>(h_out), R, H, nx, nh, forget_bias);
  return cudaGetLastError();
}

// Dispatch on c's and c_out's dtypes.
template <template <typename, typename> class L, typename... Args>
cudaError_t by_c_dtypes(int c_f32, int c_out_f32, Args... args) {
  if (c_f32 && c_out_f32) return L<float, float>::run(args...);
  if (c_f32) return L<float, __nv_bfloat16>::run(args...);
  if (c_out_f32) return L<__nv_bfloat16, float>::run(args...);
  return L<__nv_bfloat16, __nv_bfloat16>::run(args...);
}

template <typename CIn, typename COut>
struct F32 {
  template <typename... Args>
  static cudaError_t run(Args... args) { return launch_f32<CIn, COut>(args...); }
};

template <typename CIn, typename COut>
struct Wgmma {
  template <typename... Args>
  static cudaError_t run(Args... args) { return launch_wgmma<CIn, COut>(args...); }
};

}  // namespace

extern "C" {

// fp32 compute: x [R, E], h [R, H], W [E+H, 4H], h_out [R, H] fp32; c
// [R, H] fp32 (c_f32) or bf16; b [4H] fp32; c_out [R, H] fp32 (c_out_f32)
// or bf16.  E and H must be multiples of 32.
int jlm_lstm_cell_f32(const void* x, const void* h, const void* c, int c_f32,
                      const void* W, const float* b, void* c_out, int c_out_f32,
                      void* h_out, int R, int E, int H, float forget_bias, void* stream) {
  return (int)by_c_dtypes<F32>(c_f32, c_out_f32, x, h, c, W, b, c_out, h_out, R, E, H,
                               forget_bias, static_cast<cudaStream_t>(stream));
}

// bf16 compute on wgmma: x [R, E], h [R, H] bf16 (16-byte aligned rows: E
// and H multiples of 8), w_tiles the gate-tiled weight [4 Hp, Kp] bf16
// (Hp = H and Kp = E + H, each rounded up to 64); h_out [R, H] bf16; c, b,
// c_out as above.
int jlm_lstm_cell_bf16(const void* x, const void* h, const void* c, int c_f32,
                       const void* w_tiles, const float* b, void* c_out, int c_out_f32,
                       void* h_out, int R, int E, int H, float forget_bias, void* stream) {
  return (int)by_c_dtypes<Wgmma>(c_f32, c_out_f32, x, h, c, w_tiles, b, c_out, h_out, R,
                                 E, H, forget_bias, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
