// Hopper building blocks shared by the wgmma + TMA kernels (lstm_cell.cu,
// project_lse.cu, cell_cand.cu, softmax_ce.cu) and the bulk-copy ring of
// cand_dot.cu:
// tensor maps for TMA, bulk copies, mbarriers, and wgmma's shared-memory
// descriptors and ordering fences.
//
// Every shared-memory operand here is K-major with the 128-byte swizzle
// (but smem_desc_mn's, the same bytes read with MN and K swapped):
// a tile row holds 128 bytes of K (64 bf16 or 128 int8 values), rows follow
// each other at 128 bytes, and the swizzle repeats every 8 rows (1,024
// bytes), which is what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes
// and what a descriptor of layout type 1 reads.  Tiles start 1,024-byte
// aligned; a K step inside the 128-byte row advances the descriptor's start
// address by the step's bytes.
//
// Tensor maps come from the driver's cuTensorMapEncodeTiled, reached
// through the runtime's cudaGetDriverEntryPoint (no -lcuda at link time),
// and are cached by (address, shape, box): the caching allocator hands the
// same addresses back frame after frame, so a decode encodes each map once.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace jlm {

// ---------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 2-D row-major tensor [rows, cols] of elem_bytes-wide elements (int8 or
// bf16) at ptr with a row stride of ld elements, read in boxes of
// box_rows x box_cols: with the 128-byte swizzle (swizzled, the default)
// box_cols * elem_bytes == 128, one swizzle row; unswizzled, the box lands
// as dense rows.  Elements past the tensor's edge read as zero.  Returns
// false if cuTensorMapEncodeTiled refuses the map (an address or stride
// not 16-byte aligned).
inline bool tensor_map(CUtensorMap* out, const void* ptr, int elem_bytes, int rows,
                       int cols, int ld, int box_rows, int box_cols, bool swizzled = true) {
  using Key = std::tuple<const void*, int, int, int, int, int, int, bool>;
  static std::map<Key, CUtensorMap> cache;
  static std::mutex mu;
  const Key key{ptr, elem_bytes, rows, cols, ld, box_rows, box_cols, swizzled};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return true;
  }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  CUtensorMap map;
  const CUresult r = encode(
      &map, elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzled ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, map);
  *out = map;
  return true;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: box at (col, row) of the map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// Bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from global to shared memory, completing on bar (no tensor map).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Order this thread's shared-memory stores before later reads of the same
// bytes by the async proxy (wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier id (1-15; 0 is __syncthreads') over count threads: sync
// waits for the count, arrive counts itself and goes on.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Descriptor of a K-major, 128-byte-swizzled operand starting at p (the
// tile's first row; p + k bytes for a K step inside the swizzle row).
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4)          // start address, 16-byte units
         | (uint64_t)1 << 16              // leading byte offset (unused here)
         | (uint64_t)(1024 >> 4) << 32    // stride byte offset: 8 rows
         | (uint64_t)1 << 62;             // 128-byte swizzle
}

// Descriptor of an MN-major, 128-byte-swizzled bf16 operand starting at p
// (for the _tb products of wgmma.cuh): a 128-byte row holds 64 MN elements
// and rows are consecutive K, 8 of them to a 1,024-byte swizzle atom (the
// stride byte offset), which is what a TMA box [K rows][64 elements] with
// CU_TENSOR_MAP_SWIZZLE_128B writes; the next 64 MN elements lie `mn_stride`
// bytes on (the leading byte offset).  A K step of 16 advances p by 2,048
// bytes.
__device__ __forceinline__ uint64_t smem_desc_mn(const void* p, uint32_t mn_stride) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4)                       // start address
         | (uint64_t)((mn_stride & 0x3FFFF) >> 4) << 16  // leading: next 64 of MN
         | (uint64_t)(1024 >> 4) << 32                  // stride: next 8 rows of K
         | (uint64_t)1 << 62;                           // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin the accumulator registers in place around wgmma issue and wait, so
// the compiler moves no read or write of them across (the registers of an
// in-flight wgmma must not be touched).
template <typename T, int N>
__device__ __forceinline__ void fence_regs(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<T, float>::value)
      asm volatile("" : "+f"(r[i])::"memory");
    else
      asm volatile("" : "+r"(r[i])::"memory");
  }
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace jlm
