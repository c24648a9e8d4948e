// Fused LSTM over a BPTT window, forward and backward, one launch each.
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
// Design (simple first):
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
// - The backward has one barrier a step: after it, every block reads the
//   whole dz_t and forms dh_{t-1} for its own units from their 4 rows of Wh
//   (the carry never leaves the block) and dx_t for its groups' columns
//   e = group + m * (H/4) from those rows of Wx, in passes of 8 outputs
//   (resident mode: the rows in shared memory; streamed: from the L2).
// - bf16 mode rounds x, h, W (and dz, W in the backward's products) to bf16
//   before each product; products of bf16 values are exact in fp32, so it
//   is the reference's bf16-operand, fp32-accumulate product.
// - Data written by other blocks during the launch (hs, dz) is read with
//   __ldcg (L2, not the SM's L1).
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
constexpr int MAXO = 8;      // backward outputs per pass: dh units, then dx columns
constexpr size_t SMEM_MAX = 232448;

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16(v));
  return v;
}

// dx columns of unit group g: g, g + G, ... below E (G = H / 4 groups).
__host__ __device__ inline int dx_of(int g, int E, int G) { return g < E ? (E - g + G - 1) / G : 0; }

size_t fwd_smem(int stream, int nvb, int B, int E, int H) {
  return sizeof(float) * ((stream ? 0 : (size_t)(E + H) * NC) + (size_t)WARPS * NC * RB +
                          (size_t)KC * LDS + (size_t)nvb * B * U);
}

size_t bwd_smem(int stream, int nvb, int B, int E, int H) {
  const size_t rows = stream ? 0 : (size_t)(E + H) * NC + (size_t)(U + dx_of(0, E, H / U)) * 4 * H;
  return sizeof(float) * (rows + (size_t)WARPS * NC * RB + (size_t)KC * LDS +
                          2 * (size_t)nvb * B * U);
}

// W as the kernel reads it: resident mode, W [E+H, 4H] fp32 in device
// memory, copied once into shared memory as the group's 16 columns
// [k][u*4 + g] and its backward rows [o][4H]; streamed mode, W [E+H, 4H]
// in device memory (fp32, or bf16 in bf16 mode), read per step.
template <bool BF16, bool STREAM>
struct Weights {
  using Src = typename std::conditional<STREAM && BF16, bf16, float>::type;
  const Src* w;     // device memory
  const float* sW;  // resident: the group's columns [K][NC]
  const float* sWr; // resident: the group's backward rows [n_out][4H]
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

  // Backward output o of group j0 (o < U: Wh row of unit j0 + o; else the
  // Wx row of dx column e), four columns c .. c + 3.
  __device__ __forceinline__ float4 out_row(int o, int j0, int e, int E, int c) const {
    if constexpr (!STREAM) return *reinterpret_cast<const float4*>(sWr + (size_t)o * 4 * H + c);
    return row4(o < U ? E + j0 + o : e, c);
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

// Loads stage [c0, c0+cn) of dz_t (written by every block: through L2).
__device__ __forceinline__ void load_dz(float4 (&v)[PER], const float* dz, int r0,
                                        int t, int c0, int cn, int B, int T, int H4) {
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    int r, q;
    stage_slot(p, r, q);
    const int row = r0 + r;
    v[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < B && 4 * q < cn)
      v[p] = __ldcg(reinterpret_cast<const float4*>(
          dz + ((size_t)row * T + t) * H4 + c0 + 4 * q));
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
      static_cast<const typename Weights<BF16, STREAM>::Src*>(Wsrc), sW, nullptr, H};

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

template <bool BF16, bool STREAM>
__global__ void __launch_bounds__(THREADS, STREAM ? 2 : 1)
lstm_scan_bwd_kernel(const float* __restrict__ xs, const void* __restrict__ Wsrc,
                     const float* __restrict__ bias, const float* __restrict__ c0,
                     const float* __restrict__ h0, const float* __restrict__ hs,
                     const float* __restrict__ cs, const float* __restrict__ d_hs,
                     const float* __restrict__ d_cf, const float* __restrict__ d_hf,
                     float* dz, float* dx, float* dc0, float* dh0, int B, int T,
                     int E, int H, float forget_bias, int nvb) {
  extern __shared__ __align__(16) float smem[];
  const int K = E + H, H4 = 4 * H, G = H / U;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_rows = U + dx_of(0, E, G);  // resident backward rows of a group
  float* sW = smem;                                         // [K][NC]      (resident)
  float* sWr = sW + (STREAM ? 0 : (size_t)K * NC);          // [n_rows][4H] (resident):
                                                            // Wh rows, then Wx rows
  float* sRed = sWr + (STREAM ? 0 : (size_t)n_rows * H4);   // [WARPS][NC][RB]: phase 1;
                                                            // [WARPS][MAXO][RB]: phase 2
  float* sStage = sRed + WARPS * NC * RB;                   // [KC][LDS]
  float* sDc = sStage + KC * LDS;                           // [nvb][B][U] carries
  float* sDh = sDc + (size_t)nvb * B * U;
  cg::grid_group grid = cg::this_grid();
  const Weights<BF16, STREAM> wts{
      static_cast<const typename Weights<BF16, STREAM>::Src*>(Wsrc), sW, sWr, H};

  for (int i = 0; i < nvb; ++i) {
    const int g = blockIdx.x + i * gridDim.x;
    if (g >= G) break;
    const int j0 = g * U;
    if constexpr (!STREAM) {
      const float* W = static_cast<const float*>(Wsrc);
      load_gate_columns<BF16>(sW, W, K, H, j0);
      for (int e = tid; e < n_rows * H4; e += THREADS) {
        const int o = e / H4, c = e % H4;
        const int row = o < U ? E + j0 + o : g + (o - U) * G;  // W row
        sWr[e] = (o < U || row < E) ? rnd<BF16>(W[(size_t)row * H4 + c]) : 0.0f;
      }
    }
    for (int e = tid; e < B * U; e += THREADS) {
      const size_t gi = (size_t)(e / U) * H + j0 + e % U;
      sDc[(size_t)i * B * U + e] = d_cf[gi];
      sDh[(size_t)i * B * U + e] = d_hf[gi];
    }
  }
  const int u = tid / RB;  // phase 1's epilogue unit

  for (int t = T - 1; t >= 0; --t) {
    const float* hp = t == 0 ? h0 : hs + (size_t)(t - 1) * H;
    const size_t hp_stride = t == 0 ? (size_t)H : (size_t)T * H;
    // ---- phase 1: recompute the own gates, write the own columns of dz_t
    for (int i = 0; i < nvb; ++i) {
      const int g = blockIdx.x + i * gridDim.x;
      if (g >= G) break;
      const int j0 = g * U, j = j0 + min(u, U - 1);
      const float bi = bias[j], bj = bias[H + j], bf = bias[2 * H + j], bo = bias[3 * H + j];
      float* dcv = sDc + (size_t)i * B * U;
      const float* dhv = sDh + (size_t)i * B * U;
      for (int r0 = 0; r0 < B; r0 += RB) {
        const int r = tid % RB, row = r0 + r;
        const bool mine = tid < RB * U && row < B;
        const size_t idx = ((size_t)row * T + t) * H + j;
        float c_t = 0.0f, cp = 0.0f, dh_up = 0.0f;
        if (mine) {  // saved values, loaded before the product hides their latency
          c_t = cs[idx];
          cp = t > 0 ? cs[idx - H] : c0[(size_t)row * H + j];
          dh_up = d_hs[idx];
        }
        gate_product<BF16, STREAM>(wts, j0, sStage, sRed, xs, hp, hp_stride, r0, t, B, T, E,
                                   K);
        if (mine) {
          const float si = jlm::sigmoidf(gate_sum(sRed, r, u, 0) + bi);
          const float tj = tanhf(gate_sum(sRed, r, u, 1) + bj);
          const float sf = jlm::sigmoidf(gate_sum(sRed, r, u, 2) + bf + forget_bias);
          const float so = jlm::sigmoidf(gate_sum(sRed, r, u, 3) + bo);
          const float tc = tanhf(c_t);
          const float dh_tot = dh_up + dhv[row * U + u];
          const float dc_tot = dh_tot * so * (1.0f - tc * tc) + dcv[row * U + u];
          float* dzp = dz + ((size_t)row * T + t) * H4;
          dzp[j] = dc_tot * tj * si * (1.0f - si);
          dzp[H + j] = dc_tot * si * (1.0f - tj * tj);
          dzp[2 * H + j] = dc_tot * cp * sf * (1.0f - sf);
          dzp[3 * H + j] = dh_tot * tc * so * (1.0f - so);
          dcv[row * U + u] = dc_tot * sf;
        }
      }
    }
    grid.sync();  // dz_t is complete in every block
    // ---- phase 2: dh carry of the own units and dx_t of the own columns,
    // in passes of MAXO outputs
    for (int i = 0; i < nvb; ++i) {
      const int g = blockIdx.x + i * gridDim.x;
      if (g >= G) break;
      const int j0 = g * U, n_out = U + dx_of(g, E, G);
      float* dhv = sDh + (size_t)i * B * U;
      for (int o0 = 0; o0 < n_out; o0 += MAXO) {
        const int on = min(MAXO, n_out - o0);
        for (int r0 = 0; r0 < B; r0 += RB) {
          float acc[MAXO];
#pragma unroll
          for (int o = 0; o < MAXO; ++o) acc[o] = 0.0f;
          float4 next[PER];
          load_dz(next, dz, r0, t, 0, min(KC, H4), B, T, H4);
          for (int c0_ = 0; c0_ < H4; c0_ += KC) {
            const int cn = min(KC, H4 - c0_);
            __syncthreads();
            store_stage<BF16>(sStage, next);
            __syncthreads();
            if (c0_ + KC < H4) load_dz(next, dz, r0, t, c0_ + KC, min(KC, H4 - c0_ - KC), B, T, H4);
            for (int cc = warp * 4; cc < cn; cc += WARPS * 4) {  // 4H and KC: multiples of 4
              const float v0 = sStage[(cc + 0) * LDS + lane], v1 = sStage[(cc + 1) * LDS + lane];
              const float v2 = sStage[(cc + 2) * LDS + lane], v3 = sStage[(cc + 3) * LDS + lane];
#pragma unroll
              for (int o = 0; o < MAXO; ++o) {
                if (o < on) {
                  const int oo = o0 + o;
                  const float4 w = wts.out_row(oo, j0, g + (oo - U) * G, E, c0_ + cc);
                  acc[o] = fmaf(v0, w.x, fmaf(v1, w.y, fmaf(v2, w.z, fmaf(v3, w.w, acc[o]))));
                }
              }
            }
          }
#pragma unroll
          for (int o = 0; o < MAXO; ++o) sRed[(warp * MAXO + o) * RB + lane] = acc[o];
          __syncthreads();
          const int r = tid % RB, o = tid / RB, row = r0 + r;
          if (o < on && row < B) {
            float s = 0.0f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) s += sRed[(w * MAXO + o) * RB + r];
            const int oo = o0 + o;
            if (oo < U)
              dhv[row * U + oo] = s;
            else
              dx[((size_t)row * T + t) * E + g + (oo - U) * G] = s;
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = 0; i < nvb; ++i) {
    const int g = blockIdx.x + i * gridDim.x;
    if (g >= G) break;
    for (int e = tid; e < B * U; e += THREADS) {
      const size_t gi = (size_t)(e / U) * H + g * U + e % U;
      dc0[gi] = sDc[(size_t)i * B * U + e];
      dh0[gi] = sDh[(size_t)i * B * U + e];
    }
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
  static int run(int bwd, size_t smem, int device) {
    return bwd ? max_blocks(lstm_scan_bwd_kernel<BF16, STREAM>, smem, device)
               : max_blocks(lstm_scan_fwd_kernel<BF16, STREAM>, smem, device);
  }
};

template <bool BF16, bool STREAM>
struct Fwd {
  static int run(int grid, size_t smem, void** args, cudaStream_t st) {
    return (int)launch_coop(lstm_scan_fwd_kernel<BF16, STREAM>, grid, smem, args, st);
  }
};

template <bool BF16, bool STREAM>
struct Bwd {
  static int run(int grid, size_t smem, void** args, cudaStream_t st) {
    return (int)launch_coop(lstm_scan_bwd_kernel<BF16, STREAM>, grid, smem, args, st);
  }
};

}  // namespace

extern "C" {

// Co-resident blocks of the forward (bwd = 0) or backward kernel in the
// resident (stream = 0) or streamed mode at these dims, each block owning
// nvb unit groups (0 if a block needs more shared memory than an SM has),
// or minus a CUDA error.
int jlm_lstm_scan_max_blocks(int bwd, int stream, int bf16, int nvb, int B, int E, int H,
                             int device) {
  const size_t smem = bwd ? bwd_smem(stream, nvb, B, E, H) : fwd_smem(stream, nvb, B, E, H);
  if (smem > SMEM_MAX) return 0;
  return by_mode<Occupancy>(bf16, stream, bwd, smem, device);
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

// The forward's inputs and saved hs, cs, plus the upstream grads d_hs
// [B,T,H], d_cf, d_hf [B,H]; writes dz [B,T,4H], dx [B,T,E], dc0, dh0 [B,H].
int jlm_lstm_scan_bwd(const float* xs, const void* W, const float* b,
                      const float* c0, const float* h0, const float* hs,
                      const float* cs, const float* d_hs, const float* d_cf,
                      const float* d_hf, float* dz, float* dx, float* dc0,
                      float* dh0, int B, int T, int E, int H, float forget_bias,
                      int bf16, int stream, int grid, int nvb, void* st) {
  void* args[] = {&xs, &W, &b, &c0, &h0, &hs, &cs, &d_hs, &d_cf, &d_hf,
                  &dz, &dx, &dc0, &dh0, &B, &T, &E, &H, &forget_bias, &nvb};
  return by_mode<Bwd>(bf16, stream, grid, bwd_smem(stream, nvb, B, E, H), args,
                      static_cast<cudaStream_t>(st));
}

}  // extern "C"
