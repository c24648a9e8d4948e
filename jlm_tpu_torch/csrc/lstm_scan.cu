// Fused LSTM over a BPTT window: the forward and the backward, each as an
// input-side GEMM plus a cooperative recurrence.
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
// Bound: at B = T = 32, H = E = 1,024 the forward is 2 B T (E+H) 4H = 17.2
// GFLOP and the backward 34.4, in exact fp32 on the CUDA cores (no TF32);
// the bytes are tens of MB.  But step t needs all of h_{t-1} (forward) or
// dz_t (backward), so only the product with h (dz) is serial: the window is
// T dependent steps of a [B, H] x [H, 4H] product.  So each direction is
// split where the reference's arithmetic splits (z = x_t Wx + h_{t-1} Wh +
// b): what no later step reads is one large GEMM over all B T rows, off the
// serial path.
//
// Forward, two launches:
// 1. scan_gemm_kernel<KN> (fp32) or scan_gemm_bf16_kernel<KN>: Zx = xs Wx
//    over all B T rows (half the operations), Wx read in place (W's first
//    E rows);
// 2. scan_fwd_recur_kernel: cooperative, one grid barrier a step.  A block
//    owns NU hidden units and keeps their 4 NU gate columns of Wh (H x 4 NU)
//    in shared memory for the window where the whole grid fits (128 KB fp32
//    at H = 1,024, NU = 8; else read from the L2 each step).  Step t: every
//    block reads all of h_{t-1} (hs at t - 1, or h0; through the L2) in
//    stages of 32 rows x 256 k, transposed in shared memory; the 8 warps
//    take 32 k each, a lane 4 rows x one gate's NU columns, and the warps'
//    partial sums meet in shared memory in warp order (deterministic); then
//    z = (Zx_t + h_{t-1} Wh) + b, the reference's order, and the gate
//    epilogue writes hs and cs.  In bf16 mode (Wh resident) the product
//    runs on mma.sync: half the step time at H = 1,024, where the fp32
//    FMAs take about 8 of a step's 18 us.  The cell carry c_{t-1} is cs at t - 1 (or
//    c0), read by the thread that wrote it, so no carry lives in shared
//    memory and no batch is too large: batch rows go in tiles of 32.  The
//    epilogue's Zx_t and c_{t-1} loads are issued before the product.
//
// Backward, three launches:
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
//
// The fp32 GEMM (its main loop in gemm_f32.cuh, which the head's fp32
// kernel shares) is exact FMAs on the CUDA cores: block tiles of 128 x 128,
// 8 x 8 a thread, K in chunks of 16 staged through registers into two
// shared-memory buffers (K-major operands transposed on the way in), two
// blocks an SM, K split where the output's tiles would leave most SMs idle
// (a cooperative launch: the partial tiles summed in split order after a
// grid barrier, deterministic).  The bf16 GEMM rounds both operands to
// bf16 on their way into shared memory and multiplies with mma.sync (fp32
// sums).  bf16 mode rounds x, h, W (and dz, W in the backward's products)
// to bf16 before each product; products of bf16 values are exact in fp32,
// so it is the reference's bf16-operand, fp32-accumulate product.  Data
// written by other blocks during a launch (hs, dz) is read with __ldcg (L2,
// not the SM's L1).
#include "common.cuh"
#include "gemm_f32.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr size_t SMEM_MAX = 232448;

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16(v));
  return v;
}

template <bool BF16>
__device__ __forceinline__ float4 rnd4(float4 v) {
  return make_float4(rnd<BF16>(v.x), rnd<BF16>(v.y), rnd<BF16>(v.z), rnd<BF16>(v.w));
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// ldg4_at (gemm_f32.cuh) through the L2 only (ld.global.cg), for data that
// other blocks of the launch write.
__device__ __forceinline__ float4 ldcg4_at(const float* p, bool ok) {
  float4 v;
  asm volatile(
      "{\n\t.reg .pred q;\n\t"
      "setp.ne.b32 q, %5, 0;\n\t"
      "mov.b32 %0, 0;\n\tmov.b32 %1, 0;\n\tmov.b32 %2, 0;\n\tmov.b32 %3, 0;\n\t"
      "@q ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];\n\t}"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "r"((int)ok)
      : "memory");
  return v;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// ------------------------------------------------------------ fp32 GEMM

// C [M, N] = A [M, K] B (+ bias), A row-major (K-major); B [K][N] (KN: Wx
// as the input product reads it, W as the gate recompute does) or [N][K]
// (NK: Wx's rows as dx reads them), on gemm_f32.cuh's main loop (shared
// with the head's fp32 kernel; B [K][N] is stored as it lies: cp.async for
// it read 4-5% slower).  With K split (gridDim.z > 1, a cooperative launch
// whose blocks the card holds at once), block z takes K range [z kc, (z +
// 1) kc), writes its partial tile to ws [z][M][N], and after a grid
// barrier sums rows z R .. (z + 1) R - 1 of its tile (R = 128 / splits,
// rounded up) over the splits in split order (+ bias) into C: the same sum
// whichever block finished first.
template <bool KN, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 2)
scan_gemm_kernel(const float* __restrict__ A, int lda, const float* __restrict__ Bm, int ldb,
                 const float* __restrict__ bias, float* __restrict__ C, int ldc, int M, int N,
                 int K, int kc, float* ws) {
  using namespace jlm::gemm;
  __shared__ __align__(16) float sA[2][TILE];
  __shared__ __align__(16) float sB[2][TILE];
  const int tid = threadIdx.x, ty = ty_of(tid), tx = tx_of(tid);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * kc, ke = min(K, kb + kc);
  float4 ra[2], rb[2];
  auto fetch = [&](int k0) {  // chunk k0's operands into registers
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int i = tid + THREADS * p;
      ra[p] = kmajor_at(A, lda, m0, M, k0, ke, K, i);
      if constexpr (KN)
        rb[p] = kn_at(Bm, ldb, k0, ke, K, n0, N, i);
      else
        rb[p] = kmajor_at(Bm, ldb, n0, N, k0, ke, K, i);
    }
  };
  auto put = [&](int buf) {  // the registers into stage buf
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int i = tid + THREADS * p;
      put_kmajor(sA[buf], i, ra[p]);
      if constexpr (KN)
        put_kn(sB[buf], i, rb[p]);
      else
        put_kmajor(sB[buf], i, rb[p]);
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const int nk = (ke - kb + BK - 1) / BK;
  fetch(kb);
  put(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    fetch(kb + (kt + 1) * BK);  // unconditional: past ke it loads zeros
    chunk_fma<!KN>(acc, sA[buf], sB[buf], ty, tx);
    put(buf ^ 1);  // buf ^ 1 was last read in chunk kt - 1, before the barrier
    __syncthreads();
  }
  float* out = SPLIT ? ws + (size_t)blockIdx.z * M * N : C;
  const int ldo = SPLIT ? N : ldc;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + row_of(ty, i);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * h + 4 * tx;
      if (n >= N) continue;  // N % 4 == 0: n < N means n + 3 < N
      float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                             acc[i][4 * h + 3]);
      if (bias && !SPLIT) v = add4(v, ldg4(bias + n));
      *reinterpret_cast<float4*>(out + (size_t)row * ldo + n) = v;
    }
  }
  if constexpr (!SPLIT) return;
  cg::this_grid().sync();  // every split's partial tile is in ws
  const int splits = gridDim.z;
  const int R = (BM + splits - 1) / splits, r_end = min(BM, (int)(blockIdx.z + 1) * R);
  const size_t plane = (size_t)M * N;
  for (int e = (int)blockIdx.z * R * (BN / 4) + tid; e < r_end * (BN / 4); e += THREADS) {
    const int row = m0 + e / (BN / 4), n = n0 + 4 * (e % (BN / 4));
    if (row >= M || n >= N) continue;
    const float* p = ws + (size_t)row * N + n;
    float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    for (int z = 1; z < splits; ++z)
      v = add4(v, __ldcg(reinterpret_cast<const float4*>(p + z * plane)));
    if (bias) v = add4(v, ldg4(bias + n));
    *reinterpret_cast<float4*>(C + (size_t)row * ldc + n) = v;
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


// ---------------------------------------------------- forward recurrence

namespace fwd {
constexpr int RB = 32;         // batch rows of a tile
constexpr int KC = 256;        // k of a stage; each warp takes 32
constexpr int LDS = RB + 4;    // padded row of the [k][row] stage and of the
                               // [q][row] partials: float4 aligned
constexpr int LDH = KC + 8;    // bf16 mode: padded row of the [row][k] stage
// bf16 mode: padded row of the resident [q][k] columns of Wh (rows 16-byte
// aligned and 4 words apart mod 32: ldmatrix reads them conflict-free)
__host__ __device__ constexpr int ldw(int H) { return (H + 15) / 16 * 16 + 8; }
constexpr int PER = RB * KC / 4 / THREADS;  // float4 of a stage per thread
// floats of the stage buffer, which the warps' partials [WARPS][4 NU][LDS]
// reuse after the product
__host__ __device__ constexpr int stage_floats(int nu) {
  return KC * LDS > WARPS * 4 * nu * LDS ? KC * LDS : WARPS * 4 * nu * LDS;
}
}  // namespace fwd

// A stage is RB rows x KC columns of h, moved as float4: a warp takes 8
// rows x 4 float4 (64 contiguous bytes a row) per step of p, so float4 p of
// a thread is row r, columns 4q..4q+3 of the stage.
__device__ __forceinline__ void stage_slot(int p, int& r, int& q) {
  const int lane = threadIdx.x & 31, tile = (threadIdx.x >> 5) + WARPS * p;
  r = (tile % (fwd::RB / 8)) * 8 + (lane & 7);
  q = (tile / (fwd::RB / 8)) * 4 + (lane >> 3);
}

// The NU gate-g columns of the block's units at row k of Wh, as floats:
// from the resident [H][4 NU] copy (bf16 in bf16 mode) or from Wh [H, 4H]
// in device memory (rounded in bf16 mode).
template <int NU, bool BF16, bool RESIDENT>
__device__ __forceinline__ void wh_cols(const void* sW, const float* Wh, int k, int g, int j0,
                                        int H, float (&w)[NU]) {
  if constexpr (RESIDENT && BF16) {
    const uint2* p = reinterpret_cast<const uint2*>(
        static_cast<const bf16*>(sW) + ((size_t)k * 4 + g) * NU);
#pragma unroll
    for (int v = 0; v < NU / 4; ++v) {
      const uint2 q = p[v];
      w[4 * v] = __uint_as_float(q.x << 16), w[4 * v + 1] = __uint_as_float(q.x & 0xffff0000u);
      w[4 * v + 2] = __uint_as_float(q.y << 16), w[4 * v + 3] = __uint_as_float(q.y & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int v = 0; v < NU / 4; ++v) {
      const float4 q = RESIDENT ? reinterpret_cast<const float4*>(
                                      static_cast<const float*>(sW) + ((size_t)k * 4 + g) * NU)[v]
                                : rnd4<BF16>(ldg4(Wh + (size_t)k * 4 * H + g * H + j0 + 4 * v));
      w[4 * v] = q.x, w[4 * v + 1] = q.y, w[4 * v + 2] = q.z, w[4 * v + 3] = q.w;
    }
  }
}

// Zx [B,T,4H] = xs Wx (no bias); Wh [H, 4H] (W's h rows, row stride 4H);
// writes hs, cs [B,T,H], c_T, h_T [B,H].  The block owns the unit groups
// blockIdx.x + i * gridDim.x (i < nvb; resident mode: nvb = 1) of NU units,
// gate columns q = g NU + u.  In bf16 mode with Wh resident the product
// runs on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32 sums):
// the stage is kept [row][k] in bf16 and Wh's columns [q][k], a warp's 32
// k as two k16 steps over the tile's 2 x NQ / 8 m16n8 tiles; else exact
// fp32 FMAs, a lane 4 rows x one gate's NU columns.
template <int NU, bool BF16, bool RESIDENT>
__global__ void __launch_bounds__(THREADS)
scan_fwd_recur_kernel(const float* __restrict__ Zx, const float* __restrict__ Wh,
                      const float* __restrict__ bias, const float* __restrict__ c0,
                      const float* __restrict__ h0, float* hs, float* cs, float* c_T,
                      float* h_T, int B, int T, int H, float forget_bias, int nvb) {
  using namespace fwd;
  using Wt = typename std::conditional<BF16, bf16, float>::type;
  constexpr int NQ = 4 * NU;
  constexpr bool MMA = BF16 && RESIDENT;
  extern __shared__ __align__(16) unsigned char fsm[];
  float* sX = reinterpret_cast<float*>(fsm);  // [KC][LDS] stage, then [WARPS][NQ][LDS]
  bf16* sXb = reinterpret_cast<bf16*>(fsm);   // MMA: [RB][LDH] stage
  // resident: [H][NQ], or MMA: [NQ][ldw(H)] with zeros past H
  Wt* sW = reinterpret_cast<Wt*>(sX + stage_floats(NU));
  const int H4 = 4 * H, G = H / NU, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane & 7, lg = lane >> 3;     // product: rows 4 rg .. 4 rg + 3, gate lg
  const int eu = tid % NU, er = tid / NU;      // epilogue: unit eu of tile row er
  const int LDW = ldw(H);
  cg::grid_group grid = cg::this_grid();

  if constexpr (RESIDENT) {
    const int j0 = blockIdx.x * NU;
    for (int e = tid; e < H * NQ; e += THREADS) {
      const int k = e / NQ, q = e % NQ;
      const float w = Wh[(size_t)k * H4 + (q / NU) * H + j0 + q % NU];
      if constexpr (MMA) sW[q * LDW + k] = __float2bfloat16(w);
      else if constexpr (BF16) sW[e] = __float2bfloat16(w);
      else sW[e] = w;
    }
    if constexpr (MMA)
      for (int e = tid; e < NQ * (LDW - H); e += THREADS)
        sW[(e / (LDW - H)) * LDW + H + e % (LDW - H)] = __float2bfloat16(0.0f);
  }

  for (int t = 0; t < T; ++t) {
    const float* hp = t == 0 ? h0 : hs + (size_t)(t - 1) * H;
    const size_t hp_stride = t == 0 ? (size_t)H : (size_t)T * H;
    for (int i = 0; i < nvb; ++i) {
      const int g = blockIdx.x + i * gridDim.x;
      if (g >= G) break;
      const int j0 = g * NU, j = j0 + eu;
      for (int r0 = 0; r0 < B; r0 += RB) {
        // the epilogue's operands, in flight during the product
        const int row = r0 + er;
        const bool live = er < RB && row < B;
        float zx[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cp = 0.0f;
        if (live) {
          const size_t zr = ((size_t)row * T + t) * H4 + j;
#pragma unroll
          for (int q = 0; q < 4; ++q) zx[q] = __ldg(Zx + zr + q * H);
          cp = t == 0 ? c0[(size_t)row * H + j] : cs[((size_t)row * T + t - 1) * H + j];
        }
        // ---- h_{t-1} Wh for the tile's rows and the block's 4 NU columns
        float acc[4 * NU];  // FMA: [row][unit]; MMA: [m16 tile][m16n8 tile][fragment]
#pragma unroll
        for (int v = 0; v < 4 * NU; ++v) acc[v] = 0.0f;
        float4 nx[PER];
        auto load = [&](int k0) {
#pragma unroll
          for (int p = 0; p < PER; ++p) {
            int r, q;
            stage_slot(p, r, q);
            const int k = k0 + 4 * q;
            nx[p] = ldcg4_at(hp + min(r0 + r, B - 1) * hp_stride + min(k, H - 4),
                             r0 + r < B && k < H);
          }
        };
        load(0);
        for (int k0 = 0; k0 < H; k0 += KC) {
          __syncthreads();  // the previous stage (or tile's partials) consumed
#pragma unroll
          for (int p = 0; p < PER; ++p) {
            int r, q;
            stage_slot(p, r, q);
            if constexpr (MMA) {
              __nv_bfloat162 lo = __floats2bfloat162_rn(nx[p].x, nx[p].y);
              __nv_bfloat162 hi = __floats2bfloat162_rn(nx[p].z, nx[p].w);
              *reinterpret_cast<uint2*>(sXb + r * LDH + 4 * q) =
                  make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
            } else {
              float* d = sX + 4 * q * LDS + r;
              d[0] = rnd<BF16>(nx[p].x), d[LDS] = rnd<BF16>(nx[p].y);
              d[2 * LDS] = rnd<BF16>(nx[p].z), d[3 * LDS] = rnd<BF16>(nx[p].w);
            }
          }
          __syncthreads();
          load(k0 + KC);  // past H it loads zeros
          const int kw = warp * 32;
          if constexpr (MMA) {
            // k past H multiplies zeros of the stage by zeros of sW
            const int kend = min(KC, (H + 15) / 16 * 16 - k0);
            for (int k16 = kw; k16 < min(kw + 32, kend); k16 += 16) {
              uint32_t af[2][4], bfr[NQ / 8][2];
#pragma unroll
              for (int mi = 0; mi < 2; ++mi)
                jlm::ldsm_x4(af[mi][0], af[mi][1], af[mi][2], af[mi][3],
                             sXb + (mi * 16 + (lane & 15)) * LDH + k16 + (lane >> 4) * 8);
#pragma unroll
              for (int p = 0; p < NQ / 16; ++p)
                jlm::ldsm_x4(bfr[2 * p][0], bfr[2 * p][1], bfr[2 * p + 1][0], bfr[2 * p + 1][1],
                             reinterpret_cast<const bf16*>(sW) +
                                 (p * 16 + (lane & 7) + (lane >> 4) * 8) * LDW + k0 + k16 +
                                 ((lane >> 3) & 1) * 8);
#pragma unroll
              for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < NQ / 8; ++ni)
                  jlm::mma_bf16(*reinterpret_cast<float(*)[4]>(acc + (mi * NQ / 8 + ni) * 4),
                                af[mi], bfr[ni][0], bfr[ni][1]);
            }
          } else {
            const int kn = min(32, H - k0 - kw);
#pragma unroll 8
            for (int kk = 0; kk < kn; ++kk) {
              const float4 hv = *reinterpret_cast<const float4*>(sX + (kw + kk) * LDS + 4 * rg);
              float w[NU];
              wh_cols<NU, BF16, RESIDENT>(sW, Wh, k0 + kw + kk, lg, j0, H, w);
              const float h4[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
              for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int u = 0; u < NU; ++u) acc[r * NU + u] = fmaf(h4[r], w[u], acc[r * NU + u]);
            }
          }
        }
        __syncthreads();  // every warp is done with the last stage
        if constexpr (MMA) {
          // tile (mi, ni), fragment e: row mi 16 + lane / 4 + 8 (e / 2),
          // column ni 8 + 2 (lane % 4) + e % 2
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < NQ / 8; ++ni)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                sX[(warp * NQ + ni * 8 + 2 * (lane & 3) + (e & 1)) * LDS + mi * 16 + (lane >> 2) +
                   8 * (e >> 1)] = acc[(mi * NQ / 8 + ni) * 4 + e];
        } else {
#pragma unroll
          for (int u = 0; u < NU; ++u)
            *reinterpret_cast<float4*>(sX + (warp * NQ + lg * NU + u) * LDS + 4 * rg) =
                make_float4(acc[u], acc[NU + u], acc[2 * NU + u], acc[3 * NU + u]);
        }
        __syncthreads();
        // ---- z = (Zx_t + h_{t-1} Wh) + b, the warps' sums in warp order
        if (live) {
          float z[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float s = 0.0f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) s += sX[(w * NQ + q * NU + eu) * LDS + er];
            z[q] = (zx[q] + s) + bias[q * H + j];
          }
          const float cn = jlm::sigmoidf(z[2] + forget_bias) * cp + jlm::sigmoidf(z[0]) * tanhf(z[1]);
          const float hn = jlm::sigmoidf(z[3]) * tanhf(cn);
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

template <bool KN>
int launch_gemm(const float* A, int lda, const float* Bm, int ldb, const float* bias,
                float* C, int ldc, int M, int N, int K, int splits, int kc, float* ws,
                cudaStream_t st) {
  using namespace jlm::gemm;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  if (splits == 1) {
    scan_gemm_kernel<KN, false><<<grid, THREADS, 0, st>>>(A, lda, Bm, ldb, bias, C, ldc, M, N,
                                                         K, kc, ws);
    return (int)cudaGetLastError();
  }
  void* args[] = {&A, &lda, &Bm, &ldb, &bias, &C, &ldc, &M, &N, &K, &kc, &ws};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(scan_gemm_kernel<KN, true>), grid, dim3(THREADS), args, 0,
      st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool KN>
int launch_gemm_bf16(const float* A, int lda, const float* Bm, int ldb, const float* bias,
                     float* C, int ldc, int M, int N, int K, cudaStream_t st) {
  const dim3 grid((N + mma::BN - 1) / mma::BN, (M + mma::BM - 1) / mma::BM);
  scan_gemm_bf16_kernel<KN><<<grid, THREADS, 0, st>>>(A, lda, Bm, ldb, bias, C, ldc, M, N, K);
  return (int)cudaGetLastError();
}

// One of the two recurrences in one mode (FWD: scan_fwd_recur_kernel, its
// Wh columns resident; else scan_recur_kernel, its Wh rows resident), and
// its dynamic shared memory.
template <bool FWD, int NU, bool BF16, bool RESIDENT>
struct Recur {
  static auto kernel() {
    if constexpr (FWD) return scan_fwd_recur_kernel<NU, BF16, RESIDENT>;
    else return scan_recur_kernel<NU, BF16, RESIDENT>;
  }
  static size_t smem(int H) {
    const size_t w = !RESIDENT          ? 0
                     : FWD && BF16      ? (size_t)NU * 4 * fwd::ldw(H) * sizeof(bf16)
                                        : (size_t)NU * 4 * H * (BF16 ? sizeof(bf16) : sizeof(float));
    return w + (FWD ? sizeof(float) * fwd::stage_floats(NU) : 0);
  }
};

// fn(Recur<fwd, nu, bf16, resident>{}) for nu 4 or 8.
template <bool FWD, typename F>
int by_nu(int nu, int bf16, int resident, F fn) {
  if (nu == 8) {
    if (bf16) return resident ? fn(Recur<FWD, 8, true, true>{}) : fn(Recur<FWD, 8, true, false>{});
    return resident ? fn(Recur<FWD, 8, false, true>{}) : fn(Recur<FWD, 8, false, false>{});
  }
  if (bf16) return resident ? fn(Recur<FWD, 4, true, true>{}) : fn(Recur<FWD, 4, true, false>{});
  return resident ? fn(Recur<FWD, 4, false, true>{}) : fn(Recur<FWD, 4, false, false>{});
}

template <typename F>
int by_recur(int fwd, int nu, int bf16, int resident, F fn) {
  return fwd ? by_nu<true>(nu, bf16, resident, fn) : by_nu<false>(nu, bf16, resident, fn);
}

}  // namespace

extern "C" {

// C [M, N] (row stride ldc) = A [M, K] (row stride lda) B (+ bias [N] if
// not null), fp32.  kn = 1: B [K, N] (row stride ldb); kn = 0: B given as
// its transpose [N, K].  fp32 (exact FMAs): K in `splits` ranges of kc
// (a multiple of 16), each range's partial tile into ws [splits, M, N]
// (scratch; unread at splits = 1), then summed in range order into C
// (splits x the output's 128 x 128 tiles at most two an SM);
// bf16 = 1: A and B rounded to bf16, mma.sync (splits, kc, ws not read).
// K, N, lda, ldb multiples of 4.
int jlm_scan_gemm(const float* A, int lda, const float* Bm, int ldb, const float* bias,
                  float* C, int ldc, int M, int N, int K, int kn, int splits, int kc, float* ws,
                  int bf16, void* st) {
  auto s = static_cast<cudaStream_t>(st);
  if (bf16)
    return kn ? launch_gemm_bf16<true>(A, lda, Bm, ldb, bias, C, ldc, M, N, K, s)
              : launch_gemm_bf16<false>(A, lda, Bm, ldb, bias, C, ldc, M, N, K, s);
  return kn ? launch_gemm<true>(A, lda, Bm, ldb, bias, C, ldc, M, N, K, splits, kc, ws, s)
            : launch_gemm<false>(A, lda, Bm, ldb, bias, C, ldc, M, N, K, splits, kc, ws, s);
}

// Co-resident blocks of the forward (fwd = 1) or backward recurrence with
// nu (4 or 8) units a block, their Wh columns (rows) resident in shared
// memory or not (0 if a block needs more shared memory than an SM has), or
// minus a CUDA error.
int jlm_scan_recur_max_blocks(int fwd, int resident, int bf16, int nu, int H, int device) {
  return by_recur(fwd, nu, bf16, resident, [&](auto r) {
    using R = decltype(r);
    return R::smem(H) > SMEM_MAX ? 0 : max_blocks(R::kernel(), R::smem(H), device);
  });
}

// Zx [B,T,4H] = xs Wx; Wh [H,4H] fp32 (row stride 4H); b [4H]; c0, h0
// [B,H]; writes hs, cs [B,T,H], c_T, h_T [B,H].  grid blocks of nvb groups
// of nu units (resident: grid = H / nu, nvb = 1); the wrapper checks
// co-residency.
int jlm_scan_fwd_recur(const float* Zx, const float* Wh, const float* b, const float* c0,
                       const float* h0, float* hs, float* cs, float* c_T, float* h_T, int B,
                       int T, int H, float forget_bias, int bf16, int resident, int nu,
                       int grid, int nvb, void* st) {
  void* args[] = {&Zx, &Wh, &b, &c0, &h0, &hs, &cs, &c_T, &h_T,
                  &B, &T, &H, &forget_bias, &nvb};
  return by_nu<true>(nu, bf16, resident, [&](auto r) {
    using R = decltype(r);
    return (int)launch_coop(R::kernel(), grid, R::smem(H), args, static_cast<cudaStream_t>(st));
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
  return by_nu<false>(nu, bf16, resident, [&](auto r) {
    using R = decltype(r);
    return (int)launch_coop(R::kernel(), grid, R::smem(H), args, static_cast<cudaStream_t>(st));
  });
}

}  // extern "C"
