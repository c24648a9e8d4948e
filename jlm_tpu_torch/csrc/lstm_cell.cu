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
// - fp32 compute (the parity forward; the block body in cell_f32.cuh, which
//   the fused frame's fp32 kernel shares): exact fp32 FMAs on the CUDA
//   cores, no TF32, accurate expf and tanhf in the epilogue; h' is fp32.
//   Bound at the fp32 parity run's shapes (R = 512 rows): 1.6 GFLOP
//   against 67 TFLOP/s, 0.024 ms.  A block owns 64 rows x 32 units (their 128 gate
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
#include "cell_f32.cuh"
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

// fp32 compute: x [R, E], h [R, H], W [E+H, 4H] fp32; h_out fp32.  The
// block body (cell_f32.cuh) is the fused frame's too.
template <typename CIn, typename COut>
__global__ void __launch_bounds__(jlm::F32Tile::THREADS, 1)
lstm_cell_f32_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const CIn* __restrict__ c, const float* __restrict__ W,
                     const float* __restrict__ b, COut* __restrict__ c_out,
                     float* __restrict__ h_out, int R, int E, int H,
                     float forget_bias) {
  extern __shared__ __align__(16) float fsmem[];
  jlm::cell_f32_block(
      fsmem, x, h, c, W, b, blockIdx.x * jlm::F32Tile::FR, R, blockIdx.y * jlm::F32Tile::FJ,
      E, H, forget_bias, [] {},
      [&](int, int, size_t idx, float cn, float hn) {
        c_out[idx] = static_cast<COut>(cn);
        h_out[idx] = hn;
      });
}

template <typename CIn, typename COut>
cudaError_t launch_f32(const void* x, const void* h, const void* c, const void* W,
                       const float* b, void* c_out, void* h_out, int R, int E, int H,
                       float forget_bias, cudaStream_t stream) {
  using T = jlm::F32Tile;
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
  dim3 grid((R + T::FR - 1) / T::FR, H / T::FJ);
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
