// Fused LSTM over a BPTT window: the forward in one launch, the backward
// in three.
//
// Replaces jlm_tpu/ops/lstm_scan.py::_lstm_fwd_kernel and
// ::_lstm_bwd_kernel.  Gate order i, j, f, o over W [E+H, 4H]:
//   z = x_t Wx + h_{t-1} Wh + b
//   c_t = sigmoid(z_f + forget_bias) c_{t-1} + sigmoid(z_i) tanh(z_j)
//   h_t = sigmoid(z_o) tanh(c_t)
// The backward walks time in reverse, recomputes z from the saved
// (x_t, h_{t-1}), takes tanh(c_t) from the saved cs, carries (dc, dh) and
// writes dz [B,T,4H], dx [B,T,E], dc0 and dh0; dW and db are one GEMM and
// one sum outside (as in the reference).
//
// Bound: at the training shapes (B = T = 32, E = 256, H = 512) the forward
// is 2*B*T*(E+H)*4H = 3.2 GFLOP and the backward 6.4 GFLOP (recompute, dx,
// dh), in exact fp32 on the CUDA cores; the bytes are ~12 MB each way.  But
// the recurrence makes it latency-bound: step t needs all of h_{t-1}, so
// the window is T dependent steps of a [B, E+H] x [E+H, 4H] product.
//
// Forward design (simple first):
// - The TPU keeps all of W (6.3 MB fp32) in VMEM; one SM has 227 KB.  So
//   the hidden units are split into groups of 4 (H/4 "unit groups", 128 at
//   H = 512), and the blocks, launched cooperatively so that all are
//   co-resident, own the groups: block b the groups b, b + grid, ...  A
//   group's 16 gate columns of W are read as [k][unit*4 + gate], so each
//   thread sees all four gates of a unit.
// - Resident mode (where it fits, as at H = 512): one group a block, its
//   16 columns of W kept in shared memory for the whole window.
// - Streamed mode (where the resident blocks cannot all be co-resident, as
//   at H = E = 1,024: (E + H) x 16 x 4 B = 128 KB a block, 256 blocks
//   against 132 SMs; all of W, 33.5 MB fp32, is more than the card's
//   shared memory): W stays in device memory and the L2 (50 MB) and each
//   step reads its group's columns from there, in fp32 or, in bf16 mode,
//   from a bf16 copy the wrapper makes (16.8 MB, the same rounding the
//   resident mode applies on load).  Two blocks an SM; a block owns as many
//   groups as the co-resident grid leaves it.  At B = 32 a step then reads
//   W once (33.5 MB, ~6 us from the L2) for 0.54 GFLOP (~8 us at the fp32
//   peak): the product, not the stream, is the larger cost.
// - A grid-wide barrier after each step publishes h_t: every block reads
//   the whole h_{t-1} (from hs, through L2) for its product.
// - Per step and pass of 32 batch rows, [x_t; h_{t-1}] is staged in shared
//   memory transposed ([k][row], padded), one batch row per lane; the 8
//   warps split k and their partial sums are added in a fixed order, so the
//   result does not depend on scheduling.
// - bf16 mode rounds x, h, W (and dz, W in the backward's products) to bf16
//   before each product; products of bf16 values are exact in fp32, so it
//   is the reference's bf16-operand, fp32-accumulate product.
// - Data written by other blocks during the launch (hs, dz) is read with
//   __ldcg (L2, not the SM's L1).
//
// Backward design.  Of its 4 B T (E+H) 4H operations (34.4 GFLOP at
// B = T = 32, H = E = 1,024) only dh_{t-1} = dz_t Wh^T is recurrent: the
// gate recompute reads saved sequences and dx_t = dz_t Wx^T is read by no
// later step.  So three launches:
// 1. scan_gemm_kernel<KN> (fp32) or scan_gemm_bf16_kernel<KN>: Z = [x;
//    h_prev] W + b over all B T rows, written into the dz buffer (half the
//    operations, one large product);
// 2. scan_recur_kernel: the recurrence, cooperative, one grid barrier a
//    step.  A block owns NU hidden units and keeps their NU rows of Wh
//    (NU x 4H) in shared memory for the window where the whole grid fits
//    (128 KB fp32 at H = 1,024, NU = 8; else read from the L2 each step).
//    Step t: the block turns its units' 4 gate columns of Z_t into dz_t with
//    its carried (dc, dh) and writes them over Z_t; barrier; every block
//    reads all of dz_t (through the L2) and forms its units' dh_{t-1}.  The
//    carries live in the dc0 / dh0 outputs, each entry touched by its
//    block alone, so no batch is too large for shared memory.  Each step
//    writes its own t slice of dz, so one barrier a step is enough.  The
//    product is latency-bound (the dz reads from the L2 and the barrier,
//    not the ~4 us of FMAs a step at H = 1,024): each lane keeps PF reads
//    in flight, and the next step's saved operands load during the product.
// 3. scan_gemm_kernel<NK> or scan_gemm_bf16_kernel<NK>: dx = dz Wx^T over
//    all B T rows (a quarter).
// The fp32 GEMM is exact FMAs on the CUDA cores (no TF32): a block tile of
// 16 RM rows x 128 columns, 8 x RM a thread, K in chunks of 32 through a
// 4-stage cp.async ring.  The bf16 GEMM rounds both operands to bf16 on
// their way into shared memory and multiplies with mma.sync (fp32 sums).
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int U = 4;         // hidden units per group
constexpr int NC = 4 * U;    // gate columns per group
constexpr int RB = 32;       // batch rows per pass, one per lane
constexpr int KC = 256;      // k (forward) or dz columns (backward) per stage
constexpr int LDS = RB + 2;  // padded row of the transposed stage [k][row]: a
                             // warp's float4 stores (8 rows x 4 float4) and
                             // its row-per-lane reads are both conflict-free
constexpr int PER = RB * KC / 4 / THREADS;  // float4 of a stage per thread
constexpr size_t SMEM_MAX = 232448;

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16(v));
  return v;
}

size_t fwd_smem(int stream, int nvb, int B, int E, int H) {
  return sizeof(float) * ((stream ? 0 : (size_t)(E + H) * NC) + (size_t)WARPS * NC * RB +
                          (size_t)KC * LDS + (size_t)nvb * B * U);
}

// W as the forward reads it: resident mode, W [E+H, 4H] fp32 in device
// memory, copied once into shared memory as the group's 16 columns
// [k][u*4 + g]; streamed mode, W [E+H, 4H] in device memory (fp32, or bf16
// in bf16 mode), read per step.
template <bool BF16, bool STREAM>
struct Weights {
  using Src = typename std::conditional<STREAM && BF16, bf16, float>::type;
  const Src* w;     // device memory
  const float* sW;  // resident: the group's columns [K][NC]
  int H;

  // The 16 gate columns of group j0 at row k: out[u*4 + g].
  __device__ __forceinline__ void cols(int k, int j0, float (&out)[NC]) const {
    if constexpr (!STREAM) {
      const float4* p = reinterpret_cast<const float4*>(sW + (size_t)k * NC);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4 v = p[u];
        out[u * 4 + 0] = v.x; out[u * 4 + 1] = v.y; out[u * 4 + 2] = v.z; out[u * 4 + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 v = row4(k, g * H + j0);
#pragma unroll
        for (int u = 0; u < U; ++u) out[u * 4 + g] = u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
      }
    }
  }

  // Four neighbouring values W[row][c .. c + 3] (c % 4 == 0), as floats.
  __device__ __forceinline__ float4 row4(int row, int c) const {
    const size_t i = (size_t)row * 4 * H + c;
    if constexpr (std::is_same<Src, bf16>::value) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(w + i));
      return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                         __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
    } else {
      return __ldg(reinterpret_cast<const float4*>(w + i));
    }
  }
};

// Loads the group's 16 gate columns of W, [k][u*4 + g] = W[k][g*H + j0 + u].
template <bool BF16>
__device__ void load_gate_columns(float* sW, const float* __restrict__ W, int K,
                                  int H, int j0) {
  for (int i = threadIdx.x; i < K * NC; i += THREADS) {
    const int k = i / NC, u = (i % NC) / 4, g = i % 4;
    sW[i] = rnd<BF16>(W[(size_t)k * 4 * H + g * H + j0 + u]);
  }
}

// A stage is 32 rows x KC columns of a row-major source, moved as float4:
// a warp takes 8 rows x 4 float4 (64 contiguous bytes a row) per step of
// p, so float4 p of a thread is row r, columns 4q..4q+3 of the stage.
__device__ __forceinline__ void stage_slot(int p, int& r, int& q) {
  const int lane = threadIdx.x & 31, tile = (threadIdx.x >> 5) + WARPS * p;
  r = (tile % (RB / 8)) * 8 + (lane & 7);
  q = (tile / (RB / 8)) * 4 + (lane >> 3);
}

// Loads stage [k0, k0+kn) of [x_t; h_{t-1}] for rows r0.. into registers
// (issued together, so their latencies overlap).  E % 4 == 0, so a float4
// never straddles x and h.
__device__ __forceinline__ void load_xh(float4 (&v)[PER], const float* __restrict__ xs,
                                        const float* hp, size_t hp_stride, int r0,
                                        int t, int k0, int kn, int B, int T, int E) {
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    int r, q;
    stage_slot(p, r, q);
    const int row = r0 + r, k = k0 + 4 * q;
    v[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < B && 4 * q < kn)
      v[p] = k < E ? *reinterpret_cast<const float4*>(xs + ((size_t)row * T + t) * E + k)
                   : __ldcg(reinterpret_cast<const float4*>(
                         hp + (size_t)row * hp_stride + (k - E)));
  }
}

// Writes the registers to the stage transposed, [column][row], rounded.
template <bool BF16>
__device__ __forceinline__ void store_stage(float* sStage, const float4 (&v)[PER]) {
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    int r, q;
    stage_slot(p, r, q);
    float* d = sStage + 4 * q * LDS + r;
    d[0] = rnd<BF16>(v[p].x);
    d[LDS] = rnd<BF16>(v[p].y);
    d[2 * LDS] = rnd<BF16>(v[p].z);
    d[3 * LDS] = rnd<BF16>(v[p].w);
  }
}

// z[row][16 columns of group j0] for rows r0..r0+31 of step t, summed over
// warps into sRed[(w * NC + q) * RB + row - r0]; the caller reads sRed
// after the trailing __syncthreads.  The next stage's loads are in flight
// while the current one is multiplied.
template <bool BF16, bool STREAM>
__device__ void gate_product(const Weights<BF16, STREAM>& wts, int j0, float* sStage,
                             float* sRed, const float* __restrict__ xs, const float* hp,
                             size_t hp_stride, int r0, int t, int B, int T, int E, int K) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float acc[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) acc[q] = 0.0f;
  float4 next[PER];
  load_xh(next, xs, hp, hp_stride, r0, t, 0, min(KC, K), B, T, E);
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kn = min(KC, K - k0);
    __syncthreads();  // the previous stage (and sRed) consumed
    store_stage<BF16>(sStage, next);
    __syncthreads();
    if (k0 + KC < K)
      load_xh(next, xs, hp, hp_stride, r0, t, k0 + KC, min(KC, K - k0 - KC), B, T, E);
#pragma unroll 4
    for (int kk = warp; kk < kn; kk += WARPS) {
      const float v = sStage[kk * LDS + lane];
      float w[NC];
      wts.cols(k0 + kk, j0, w);
#pragma unroll
      for (int q = 0; q < NC; ++q) acc[q] = fmaf(v, w[q], acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < NC; ++q) sRed[(warp * NC + q) * RB + lane] = acc[q];
  __syncthreads();
}

// Gate pre-activation g of unit u, pass row r, without the bias.
__device__ __forceinline__ float gate_sum(const float* sRed, int r, int u, int g) {
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += sRed[(w * NC + u * 4 + g) * RB + r];
  return s;
}

// Wsrc: W [E+H, 4H] fp32, or in streamed bf16 mode its bf16 copy.  The
// block owns the unit groups blockIdx.x + i * gridDim.x (i < nvb).
template <bool BF16, bool STREAM>
__global__ void __launch_bounds__(THREADS, STREAM ? 2 : 1)
lstm_scan_fwd_kernel(const float* __restrict__ xs, const void* __restrict__ Wsrc,
                     const float* __restrict__ bias, const float* __restrict__ c0,
                     const float* __restrict__ h0, float* hs, float* cs,
                     float* c_T, float* h_T, int B, int T, int E, int H,
                     float forget_bias, int nvb) {
  extern __shared__ __align__(16) float smem[];
  const int K = E + H, G = H / U, tid = threadIdx.x;
  float* sW = smem;                                  // [K][NC] (resident mode)
  float* sRed = sW + (STREAM ? 0 : (size_t)K * NC);  // [WARPS][NC][RB]
  float* sStage = sRed + WARPS * NC * RB;            // [KC][LDS]
  float* sC = sStage + KC * LDS;                     // [nvb][B][U] cell carries
  cg::grid_group grid = cg::this_grid();
  const Weights<BF16, STREAM> wts{
      static_cast<const typename Weights<BF16, STREAM>::Src*>(Wsrc), sW, H};

  for (int i = 0; i < nvb; ++i) {
    const int j0 = (blockIdx.x + i * gridDim.x) * U;
    if (j0 >= H) break;
    if constexpr (!STREAM) load_gate_columns<BF16>(sW, static_cast<const float*>(Wsrc), K, H, j0);
    for (int e = tid; e < B * U; e += THREADS)
      sC[(size_t)i * B * U + e] = c0[(size_t)(e / U) * H + j0 + e % U];
  }
  const int u = tid / RB;  // the epilogue's unit

  for (int t = 0; t < T; ++t) {
    const float* hp = t == 0 ? h0 : hs + (size_t)(t - 1) * H;
    const size_t hp_stride = t == 0 ? (size_t)H : (size_t)T * H;
    for (int i = 0; i < nvb; ++i) {
      const int g = blockIdx.x + i * gridDim.x;
      if (g >= G) break;
      const int j0 = g * U, j = j0 + min(u, U - 1);
      const float bi = bias[j], bj = bias[H + j], bf = bias[2 * H + j], bo = bias[3 * H + j];
      for (int r0 = 0; r0 < B; r0 += RB) {
        gate_product<BF16, STREAM>(wts, j0, sStage, sRed, xs, hp, hp_stride, r0, t, B, T, E, K);
        const int r = tid % RB, row = r0 + r;
        if (tid < RB * U && row < B) {
          const float zi = gate_sum(sRed, r, u, 0) + bi;
          const float zj = gate_sum(sRed, r, u, 1) + bj;
          const float zf = gate_sum(sRed, r, u, 2) + bf;
          const float zo = gate_sum(sRed, r, u, 3) + bo;
          float& c = sC[((size_t)i * B + row) * U + u];
          const float cn = jlm::sigmoidf(zf + forget_bias) * c + jlm::sigmoidf(zi) * tanhf(zj);
          const float hn = jlm::sigmoidf(zo) * tanhf(cn);
          c = cn;
          const size_t o = ((size_t)row * T + t) * H + j;
          hs[o] = hn;
          cs[o] = cn;
          if (t == T - 1) {
            c_T[(size_t)row * H + j] = cn;
            h_T[(size_t)row * H + j] = hn;
          }
        }
      }
    }
    grid.sync();  // h_t is complete in every block
  }
}

// ---------------------------------------------------------------- backward

// 16 bytes global -> shared, asynchronously; zeros where !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(jlm::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool BF16>
__device__ __forceinline__ float4 rnd4(float4 v) {
  return make_float4(rnd<BF16>(v.x), rnd<BF16>(v.y), rnd<BF16>(v.z), rnd<BF16>(v.w));
}

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The GEMM C [M, N] = A [M, K] B (+ bias), A row-major; B [K][N] (KN: W as
// the gate recompute reads it) or [N][K] (Wx's rows as dx reads them).
// 256 threads as 16 x 16 (ty, tx); a block tile of BM = 16 RM rows x 128
// columns; thread (ty, tx) keeps rows ty + 16 i (i < RM) and 8 columns:
// 4 tx + {0..3} + {0, 64} (KN: two float4 reads a k) or tx + 16 j (NK: a
// float4 over k from each of 8 rows of B, conflict-free at the padded
// stride).  K in chunks of GK through a ring of GST stages.
namespace gemm {
constexpr int TX = 16, TY = 16, BN = 128, GK = 32, GST = 4;
constexpr int LDK = GK + 4;  // a [row][k] stage row, padded
template <bool KN, int RM>
struct Tile {
  static constexpr int BM = TY * RM;
  static constexpr int A = BM * LDK;                 // floats of a stage's A tile
  static constexpr int B = KN ? GK * BN : BN * LDK;  // floats of a stage's B tile
  static constexpr int SMEM = GST * (A + B) * 4;
};
}  // namespace gemm

// Issues chunk k0's copies of A (rows m0..) and B (columns n0..).
template <bool KN, int RM>
__device__ __forceinline__ void gemm_chunk(float* sA, float* sB, const float* A, int lda,
                                           const float* Bm, int ldb, int m0, int n0, int k0,
                                           int M, int N, int K) {
  using namespace gemm;
  using T = Tile<KN, RM>;
  for (int i = threadIdx.x; i < T::BM * (GK / 4); i += THREADS) {
    const int r = i / (GK / 4), q = i % (GK / 4), row = m0 + r, k = k0 + 4 * q;
    const bool ok = row < M && k < K;
    cp_async16(sA + r * LDK + 4 * q, ok ? A + (size_t)row * lda + k : A, ok);
  }
  for (int i = threadIdx.x; i < BN * (GK / 4); i += THREADS) {
    int n, k;
    float* d;
    if constexpr (KN) {
      const int kr = i / (BN / 4), q = i % (BN / 4);
      k = k0 + kr, n = n0 + 4 * q, d = sB + kr * BN + 4 * q;
    } else {
      const int c = i / (GK / 4), q = i % (GK / 4);
      n = n0 + c, k = k0 + 4 * q, d = sB + c * LDK + 4 * q;
    }
    const bool ok = n < N && k < K;
    cp_async16(d, ok ? Bm + (KN ? (size_t)k * ldb + n : (size_t)n * ldb + k) : Bm, ok);
  }
}

// fp32: exact FMAs.  K % 4 == 0, N % 4 == 0, lda and ldb multiples of 4
// (16-byte rows).
template <bool KN, int RM>
__global__ void __launch_bounds__(THREADS)
scan_gemm_kernel(const float* __restrict__ A, int lda, const float* __restrict__ Bm, int ldb,
                 const float* __restrict__ bias, float* __restrict__ C, int ldc, int M, int N,
                 int K) {
  using namespace gemm;
  using T = Tile<KN, RM>;
  extern __shared__ __align__(16) float gsm[];
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * BN;
  const int nk = (K + GK - 1) / GK;
  auto stage = [&](int s) { return gsm + (s % GST) * (T::A + T::B); };
  auto load = [&](int s) {  // chunk s, one commit group
    if (s < nk)
      gemm_chunk<KN, RM>(stage(s), stage(s) + T::A, A, lda, Bm, ldb, m0, n0, s * GK, M, N,
                         K);
    cp_async_commit();
  };
  float acc[RM][8];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;
  for (int s = 0; s < GST - 1; ++s) load(s);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<GST - 2>();  // this thread's pieces of chunk kt have landed
    __syncthreads();  // chunk kt is complete, and chunk kt - 1's stage is free
    load(kt + GST - 1);
    const float* a_t = stage(kt) + ty * LDK;
    const float* b_t = stage(kt) + T::A;
#pragma unroll
    for (int k4 = 0; k4 < GK; k4 += 4) {
      float4 a[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r)
        a[r] = *reinterpret_cast<const float4*>(a_t + r * TY * LDK + k4);
      if constexpr (KN) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 w0 = *reinterpret_cast<const float4*>(b_t + (k4 + kk) * BN + 4 * tx);
          const float4 w1 =
              *reinterpret_cast<const float4*>(b_t + (k4 + kk) * BN + 64 + 4 * tx);
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            const float av = part(a[r], kk);
            acc[r][0] = fmaf(av, w0.x, acc[r][0]);
            acc[r][1] = fmaf(av, w0.y, acc[r][1]);
            acc[r][2] = fmaf(av, w0.z, acc[r][2]);
            acc[r][3] = fmaf(av, w0.w, acc[r][3]);
            acc[r][4] = fmaf(av, w1.x, acc[r][4]);
            acc[r][5] = fmaf(av, w1.y, acc[r][5]);
            acc[r][6] = fmaf(av, w1.z, acc[r][6]);
            acc[r][7] = fmaf(av, w1.w, acc[r][7]);
          }
        }
      } else {
        float4 b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          b[j] = *reinterpret_cast<const float4*>(b_t + (tx + TX * j) * LDK + k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            const float av = part(a[r], kk);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(av, part(b[j], kk), acc[r][j]);
          }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = m0 + ty + TY * r;
    if (row >= M) break;
    float* c = C + (size_t)row * ldc;
    if constexpr (KN) {
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int n = n0 + 64 * g + 4 * tx;
        if (n < N) {
          float4 v = make_float4(acc[r][4 * g], acc[r][4 * g + 1], acc[r][4 * g + 2],
                                 acc[r][4 * g + 3]);
          if (bias) {
            const float4 bb = *reinterpret_cast<const float4*>(bias + n);
            v.x += bb.x, v.y += bb.y, v.z += bb.z, v.w += bb.w;
          }
          *reinterpret_cast<float4*>(c + n) = v;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + tx + TX * j;
        if (n < N) c[n] = acc[r][j] + (bias ? bias[n] : 0.0f);
      }
    }
  }
}

// bf16: A and B rounded to bf16 on their way into shared memory (global ->
// registers -> bf16 stores, the next chunk's loads in flight during the
// current chunk's products), then mma.sync m16n8k16 with fp32 sums.  A
// block tile of 128 x 128, K in chunks of 32, two buffers; 8 warps as 2 x 4,
// a warp 64 rows x 32 columns (4 x 4 m16n8 tiles).  A lies [m][k], B [n][k]
// (NK; ldmatrix) or [k][n] (KN; ldmatrix.trans); rows padded by 8 values
// (16 bytes), so the 8 row addresses of an ldmatrix hit 8 bank groups.
namespace mma {
constexpr int BM = 128, BN = 128, BK = 32, LDA = BK + 8, LDB_KN = BN + 8;
}

template <bool KN>
__device__ __forceinline__ void mma_fetch(float4 (&a)[4], float4 (&b)[4], const float* A,
                                          int lda, const float* Bm, int ldb, int m0, int n0,
                                          int k0, int M, int N, int K) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = threadIdx.x + THREADS * p, r = i / 8, k = k0 + 4 * (i % 8);
    a[p] = m0 + r < M && k < K ? __ldg(reinterpret_cast<const float4*>(
                                      A + (size_t)(m0 + r) * lda + k)) : zero;
    if constexpr (KN) {
      const int kr = k0 + i / 32, n = n0 + 4 * (i % 32);
      b[p] = kr < K && n < N ? __ldg(reinterpret_cast<const float4*>(Bm + (size_t)kr * ldb + n))
                             : zero;
    } else {
      b[p] = n0 + r < N && k < K ? __ldg(reinterpret_cast<const float4*>(
                                        Bm + (size_t)(n0 + r) * ldb + k)) : zero;
    }
  }
}

__device__ __forceinline__ void store_bf16x4(bf16* d, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(d) = u;
}

template <bool KN>
__global__ void __launch_bounds__(THREADS)
scan_gemm_bf16_kernel(const float* __restrict__ A, int lda, const float* __restrict__ Bm,
                      int ldb, const float* __restrict__ bias, float* __restrict__ C, int ldc,
                      int M, int N, int K) {
  using namespace mma;
  constexpr int SB = KN ? BK * LDB_KN : BN * LDA;  // values of a B buffer
  __shared__ __align__(16) bf16 sA[2][BM * LDA];
  __shared__ __align__(16) bf16 sB[2][SB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  float4 ra[4], rb[4];
  auto put = [&](int buf) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = tid + THREADS * p;
      store_bf16x4(&sA[buf][(i / 8) * LDA + 4 * (i % 8)], ra[p]);
      if constexpr (KN) store_bf16x4(&sB[buf][(i / 32) * LDB_KN + 4 * (i % 32)], rb[p]);
      else store_bf16x4(&sB[buf][(i / 8) * LDA + 4 * (i % 8)], rb[p]);
    }
  };
  mma_fetch<KN>(ra, rb, A, lda, Bm, ldb, m0, n0, 0, M, N, K);
  put(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) mma_fetch<KN>(ra, rb, A, lda, Bm, ldb, m0, n0, (kt + 1) * BK, M, N, K);
#pragma unroll
    for (int k16 = 0; k16 < BK; k16 += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        jlm::ldsm_x4(af[mi][0], af[mi][1], af[mi][2], af[mi][3],
                     &sA[buf][(wm * 64 + mi * 16 + (lane & 15)) * LDA + k16 + (lane >> 4) * 8]);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int nb = wn * 32 + p * 16;
        if constexpr (KN)
          jlm::ldsm_x4_trans(bfr[2 * p][0], bfr[2 * p][1], bfr[2 * p + 1][0], bfr[2 * p + 1][1],
                             &sB[buf][(k16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB_KN + nb +
                                      (lane >> 4) * 8]);
        else
          jlm::ldsm_x4(bfr[2 * p][0], bfr[2 * p][1], bfr[2 * p + 1][0], bfr[2 * p + 1][1],
                       &sB[buf][(nb + (lane & 7) + (lane >> 4) * 8) * LDA + k16 +
                                ((lane >> 3) & 1) * 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) jlm::mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
    if (kt + 1 < nk) {
      put(buf ^ 1);  // the other buffer was last read in chunk kt - 1, before the barrier
      __syncthreads();
    }
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mi * 16 + (lane >> 2) + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + 2 * (lane & 3);
        if (n >= N) continue;  // N % 4 == 0: n < N means n + 1 < N
        float2 v = make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        if (bias) v.x += bias[n], v.y += bias[n + 1];
        *reinterpret_cast<float2*>(C + (size_t)row * ldc + n) = v;
      }
    }
}

// In lane l, the warp's sum of v[l % V] (V a power of 2 up to 32): where
// the warp has more lanes than values, plain sums across the spare lanes,
// then a butterfly in which each step keeps half the values and sends the
// other half (31 shuffles at V = 32).  The order of the sums is fixed.
template <int V>
__device__ __forceinline__ float warp_sums(float (&v)[V]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o >= V; o >>= 1)
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
#pragma unroll
  for (int n = V; n > 1; n >>= 1) {
    const int o = n / 2;
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? v[i] : v[i + o];
      const float keep = up ? v[i + o] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  return v[0];
}

constexpr int RR = 4;  // batch rows of a warp's dh tile (RR rows x NU units)
constexpr int PF = 8;  // float4 columns of dz a lane has in flight

// Wh[j][c .. c + 3] as floats, from the block's resident rows (row u; bf16
// in bf16 mode) or from device memory (row j, rounded in bf16 mode).
template <bool BF16, bool RESIDENT>
__device__ __forceinline__ float4 wh4(const void* sWh, const float* Wh, int u, int j, int c,
                                     int H4) {
  if constexpr (RESIDENT && BF16) {
    const uint2 q = reinterpret_cast<const uint2*>(sWh)[((size_t)u * H4 + c) / 4];
    return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                       __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
  } else if constexpr (RESIDENT) {
    return reinterpret_cast<const float4*>(sWh)[((size_t)u * H4 + c) / 4];
  } else {
    return rnd4<BF16>(__ldg(reinterpret_cast<const float4*>(Wh + (size_t)j * H4 + c)));
  }
}

// Z [B,T,4H] the recomputed gates (bias included); dz [B,T,4H] (may be Z
// itself); Wh [H, 4H] fp32 (W's h rows).  In bf16 mode dz is also written
// rounded to bf16 into dzb [B,T,4H], which the product reads: half the
// bytes a step, and each step its own t slice, so no block overwrites what
// a slower one still reads.  The block owns the unit groups
// blockIdx.x + i * gridDim.x (i < nvb; resident mode: nvb = 1) of NU units;
// the carries dc, dh [B, H] start as d_cf, d_hf and end as dc0, dh0.
template <int NU, bool BF16, bool RESIDENT>
__global__ void __launch_bounds__(THREADS)
scan_recur_kernel(const float* Z, float* dz, bf16* dzb, const float* __restrict__ Wh,
                  const float* __restrict__ cs, const float* __restrict__ c0,
                  const float* __restrict__ d_hs, const float* __restrict__ d_cf,
                  const float* __restrict__ d_hf, float* dc, float* dh, int B, int T, int H,
                  float forget_bias, int nvb) {
  using Wt = typename std::conditional<BF16, bf16, float>::type;
  extern __shared__ __align__(16) unsigned char rsm[];
  Wt* sWh = reinterpret_cast<Wt*>(rsm);  // [NU][4H] (resident mode)
  const int H4 = 4 * H, G = H / NU, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  cg::grid_group grid = cg::this_grid();

  for (int i = 0; i < nvb; ++i) {
    const int g = blockIdx.x + i * gridDim.x;
    if (g >= G) break;
    const int j0 = g * NU;
    if constexpr (RESIDENT)
      for (int e = tid; e < NU * H4; e += THREADS) {
        const float w = Wh[(size_t)j0 * H4 + e];
        if constexpr (BF16) sWh[e] = __float2bfloat16(w);
        else sWh[e] = w;
      }
    for (int e = tid; e < B * NU; e += THREADS) {
      const size_t gi = (size_t)(e / NU) * H + j0 + e % NU;
      dc[gi] = d_cf[gi];
      dh[gi] = d_hf[gi];
    }
  }
  __syncthreads();

  // A step's saved operands of the gate grads (all but the carries), for
  // (row, unit j); in the one-group, one-pass case (B NU <= THREADS) they
  // are loaded for step t - 1 before step t's product, so their latency
  // hides behind it.
  struct GateIn {
    float zi, zj, zf, zo, c, cp, dhs;
  };
  auto gate_in = [&](int row, int j, int t) {
    const size_t zr = ((size_t)row * T + t) * H4, idx = ((size_t)row * T + t) * H + j;
    return GateIn{Z[zr + j], Z[zr + H + j], Z[zr + 2 * H + j], Z[zr + 3 * H + j], cs[idx],
                  t > 0 ? cs[idx - H] : c0[(size_t)row * H + j], d_hs[idx]};
  };
  const bool early = nvb == 1 && B * NU <= THREADS;
  GateIn next{};
  if (early && tid < B * NU) next = gate_in(tid / NU, blockIdx.x * NU + tid % NU, T - 1);

  for (int t = T - 1; t >= 0; --t) {
    // ---- dz_t of the own units' gate columns, over Z_t
    for (int i = 0; i < nvb; ++i) {
      const int g = blockIdx.x + i * gridDim.x;
      if (g >= G) break;
      for (int e = tid; e < B * NU; e += THREADS) {
        const int row = e / NU, j = g * NU + e % NU;
        const GateIn in = early ? next : gate_in(row, j, t);
        const size_t zr = ((size_t)row * T + t) * H4, gi = (size_t)row * H + j;
        const float si = jlm::sigmoidf(in.zi), tj = tanhf(in.zj);
        const float sf = jlm::sigmoidf(in.zf + forget_bias), so = jlm::sigmoidf(in.zo);
        const float tc = tanhf(in.c);
        const float dh_tot = in.dhs + __ldcg(dh + gi);
        const float dc_tot = dh_tot * so * (1.0f - tc * tc) + __ldcg(dc + gi);
        const float dzv[4] = {dc_tot * tj * si * (1.0f - si), dc_tot * si * (1.0f - tj * tj),
                              dc_tot * in.cp * sf * (1.0f - sf), dh_tot * tc * so * (1.0f - so)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dz[zr + q * H + j] = dzv[q];
          if constexpr (BF16) dzb[zr + q * H + j] = __float2bfloat16(dzv[q]);
        }
        __stcg(dc + gi, dc_tot * sf);
      }
    }
    grid.sync();  // dz_t is complete in every block
    if (early && t > 0 && tid < B * NU)
      next = gate_in(tid / NU, blockIdx.x * NU + tid % NU, t - 1);
    // ---- dh_{t-1} of the own units: dz_t Wh^T.  A warp takes RR rows at a
    // time, its lanes the float4 columns lane, lane + 32, ...: PF of them in
    // flight at once (all loads of a round issued before its products); the
    // lanes' partial sums meet in warp_sums.
    for (int i = 0; i < nvb; ++i) {
      const int g = blockIdx.x + i * gridDim.x;
      if (g >= G) break;
      const int j0 = g * NU;
      for (int r0 = warp * RR; r0 < B; r0 += WARPS * RR) {
        float acc[RR * NU];
#pragma unroll
        for (int v = 0; v < RR * NU; ++v) acc[v] = 0.0f;
        size_t zr[RR];
#pragma unroll
        for (int r = 0; r < RR; ++r)  // a row past B reads row B - 1 and is not stored
          zr[r] = ((size_t)min(r0 + r, B - 1) * T + t) * H4;
        for (int c0 = 4 * lane; c0 < H4; c0 += 128 * PF) {
          float4 d[PF][RR];
#pragma unroll
          for (int p = 0; p < PF; ++p) {
            const int c = c0 + 128 * p;
#pragma unroll
            for (int r = 0; r < RR; ++r) {
              if (c >= H4) {
                d[p][r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              } else if constexpr (BF16) {
                const uint2 q = __ldcg(reinterpret_cast<const uint2*>(dzb + zr[r] + c));
                d[p][r] = make_float4(__uint_as_float(q.x << 16),
                                      __uint_as_float(q.x & 0xffff0000u),
                                      __uint_as_float(q.y << 16),
                                      __uint_as_float(q.y & 0xffff0000u));
              } else {
                d[p][r] = __ldcg(reinterpret_cast<const float4*>(dz + zr[r] + c));
              }
            }
          }
#pragma unroll
          for (int p = 0; p < PF; ++p) {
            const int c = c0 + 128 * p;
            if (c >= H4) break;
#pragma unroll
            for (int u = 0; u < NU; ++u) {
              const float4 w = wh4<BF16, RESIDENT>(sWh, Wh, u, j0 + u, c, H4);
#pragma unroll
              for (int r = 0; r < RR; ++r)
                acc[r * NU + u] = fmaf(d[p][r].w, w.w, fmaf(d[p][r].z, w.z, fmaf(d[p][r].y, w.y,
                                       fmaf(d[p][r].x, w.x, acc[r * NU + u]))));
            }
          }
        }
        const float s = warp_sums<RR * NU>(acc);
        const int v = lane % (RR * NU), row = r0 + v / NU;
        if (lane < RR * NU && row < B) __stcg(dh + (size_t)row * H + j0 + v % NU, s);
      }
    }
    __syncthreads();  // the block's new dh carries are in place for the next step
  }
}

template <typename Kernel>
cudaError_t launch_coop(Kernel kernel, int grid, size_t smem, void** args,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename Kernel>
int max_blocks(Kernel kernel, size_t smem, int device) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

template <template <bool, bool> class K, typename... Args>
int by_mode(int bf16, int stream, Args... args) {
  if (bf16) return stream ? K<true, true>::run(args...) : K<true, false>::run(args...);
  return stream ? K<false, true>::run(args...) : K<false, false>::run(args...);
}

template <bool BF16, bool STREAM>
struct Occupancy {
  static int run(size_t smem, int device) {
    return max_blocks(lstm_scan_fwd_kernel<BF16, STREAM>, smem, device);
  }
};

template <bool BF16, bool STREAM>
struct Fwd {
  static int run(int grid, size_t smem, void** args, cudaStream_t st) {
    return (int)launch_coop(lstm_scan_fwd_kernel<BF16, STREAM>, grid, smem, args, st);
  }
};

template <bool KN, int RM>
int launch_gemm(const float* A, int lda, const float* Bm, int ldb, const float* bias,
                float* C, int ldc, int M, int N, int K, cudaStream_t st) {
  using T = gemm::Tile<KN, RM>;
  auto kernel = scan_gemm_kernel<KN, RM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + gemm::BN - 1) / gemm::BN, (M + T::BM - 1) / T::BM);
  kernel<<<grid, THREADS, T::SMEM, st>>>(A, lda, Bm, ldb, bias, C, ldc, M, N, K);
  return (int)cudaGetLastError();
}

template <bool KN>
int launch_gemm_bf16(const float* A, int lda, const float* Bm, int ldb, const float* bias,
                     float* C, int ldc, int M, int N, int K, cudaStream_t st) {
  const dim3 grid((N + mma::BN - 1) / mma::BN, (M + mma::BM - 1) / mma::BM);
  scan_gemm_bf16_kernel<KN><<<grid, THREADS, 0, st>>>(A, lda, Bm, ldb, bias, C, ldc, M, N, K);
  return (int)cudaGetLastError();
}

// scan_recur_kernel of one mode, and its dynamic shared memory.
template <int NU, bool BF16, bool RESIDENT>
struct Recur {
  static auto kernel() { return scan_recur_kernel<NU, BF16, RESIDENT>; }
  static size_t smem(int H) {
    return RESIDENT ? (size_t)NU * 4 * H * (BF16 ? sizeof(bf16) : sizeof(float)) : 0;
  }
};

// fn(Recur<nu, bf16, resident>{}) for nu 4 or 8.
template <typename F>
int by_recur(int nu, int bf16, int resident, F fn) {
  if (nu == 8) {
    if (bf16) return resident ? fn(Recur<8, true, true>{}) : fn(Recur<8, true, false>{});
    return resident ? fn(Recur<8, false, true>{}) : fn(Recur<8, false, false>{});
  }
  if (bf16) return resident ? fn(Recur<4, true, true>{}) : fn(Recur<4, true, false>{});
  return resident ? fn(Recur<4, false, true>{}) : fn(Recur<4, false, false>{});
}

}  // namespace

extern "C" {

// Co-resident blocks of the forward kernel in the resident (stream = 0) or
// streamed mode at these dims, each block owning nvb unit groups (0 if a
// block needs more shared memory than an SM has), or minus a CUDA error.
int jlm_lstm_scan_max_blocks(int stream, int bf16, int nvb, int B, int E, int H, int device) {
  const size_t smem = fwd_smem(stream, nvb, B, E, H);
  if (smem > SMEM_MAX) return 0;
  return by_mode<Occupancy>(bf16, stream, smem, device);
}

// xs [B,T,E], b [4H], c0/h0 [B,H], fp32; W [E+H,4H] fp32, or its bf16 copy
// in streamed bf16 mode; writes hs [B,T,H], cs [B,T,H], c_T, h_T [B,H].
// bf16 = 1 rounds the product operands to bf16.  H % 4 == 0; grid blocks
// of nvb unit groups each (resident mode: grid = H / 4, nvb = 1); the
// wrapper checks co-residency.
int jlm_lstm_scan_fwd(const float* xs, const void* W, const float* b,
                      const float* c0, const float* h0, float* hs, float* cs,
                      float* c_T, float* h_T, int B, int T, int E, int H,
                      float forget_bias, int bf16, int stream, int grid, int nvb,
                      void* st) {
  void* args[] = {&xs, &W, &b, &c0, &h0, &hs, &cs, &c_T, &h_T,
                  &B, &T, &E, &H, &forget_bias, &nvb};
  return by_mode<Fwd>(bf16, stream, grid, fwd_smem(stream, nvb, B, E, H), args,
                      static_cast<cudaStream_t>(st));
}

// C [M, N] (row stride ldc) = A [M, K] (row stride lda) B (+ bias [N] if
// not null), fp32.  kn = 1: B [K, N] (row stride ldb); kn = 0: B given as
// its transpose [N, K].  fp32 (exact FMAs): rm 8 (128-row block tiles)
// or 4 (64); bf16 = 1: A and B rounded to bf16, mma.sync (rm not read).
// K, N, lda, ldb multiples of 4.
int jlm_scan_gemm(const float* A, int lda, const float* Bm, int ldb, const float* bias,
                  float* C, int ldc, int M, int N, int K, int kn, int rm, int bf16, void* st) {
  auto s = static_cast<cudaStream_t>(st);
  if (bf16)
    return kn ? launch_gemm_bf16<true>(A, lda, Bm, ldb, bias, C, ldc, M, N, K, s)
              : launch_gemm_bf16<false>(A, lda, Bm, ldb, bias, C, ldc, M, N, K, s);
  if (kn)
    return rm == 8 ? launch_gemm<true, 8>(A, lda, Bm, ldb, bias, C, ldc, M, N, K, s)
                   : launch_gemm<true, 4>(A, lda, Bm, ldb, bias, C, ldc, M, N, K, s);
  return rm == 8 ? launch_gemm<false, 8>(A, lda, Bm, ldb, bias, C, ldc, M, N, K, s)
                 : launch_gemm<false, 4>(A, lda, Bm, ldb, bias, C, ldc, M, N, K, s);
}

// Co-resident blocks of scan_recur_kernel with nu (4 or 8) units a block,
// their Wh rows resident in shared memory or not (0 if a block needs more
// shared memory than an SM has), or minus a CUDA error.
int jlm_scan_recur_max_blocks(int resident, int bf16, int nu, int H, int device) {
  return by_recur(nu, bf16, resident, [&](auto r) {
    using R = decltype(r);
    return R::smem(H) > SMEM_MAX ? 0 : max_blocks(R::kernel(), R::smem(H), device);
  });
}

// Z [B,T,4H] the recomputed gates; writes dz [B,T,4H] (may be Z), in bf16
// mode also its bf16 copy dzb (scratch, [B,T,4H]), and the carries dc0,
// dh0 [B,H] from d_cf, d_hf; Wh [H,4H] fp32; cs, d_hs
// [B,T,H]; c0 [B,H].  grid blocks of nvb groups of nu units (resident:
// grid = H / nu, nvb = 1); the wrapper checks co-residency.
int jlm_scan_recur(const float* Z, float* dz, void* dzb, const float* Wh, const float* cs,
                   const float* c0, const float* d_hs, const float* d_cf, const float* d_hf,
                   float* dc0, float* dh0, int B, int T, int H, float forget_bias, int bf16,
                   int resident, int nu, int grid, int nvb, void* st) {
  void* args[] = {&Z, &dz, &dzb, &Wh, &cs, &c0, &d_hs, &d_cf, &d_hf, &dc0, &dh0,
                  &B, &T, &H, &forget_bias, &nvb};
  return by_recur(nu, bf16, resident, [&](auto r) {
    using R = decltype(r);
    return (int)launch_coop(R::kernel(), grid, R::smem(H), args, static_cast<cudaStream_t>(st));
  });
}

}  // extern "C"
