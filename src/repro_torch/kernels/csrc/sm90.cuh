// Hopper (sm_90a) pieces shared by the kernels that stream tiles with TMA:
// mbarrier helpers, 4-d tensor-map loads, and the host-side tensor-map
// encoding (cuTensorMapEncodeTiled taken from the loaded libcuda.so.1).
//
// Included by flash_attention.cu, flash_attention_bwd.cu and flash_decode.cu,
// each built into its own library.  (No unnamed namespace here: nvcc's
// registration stub cannot tell it from the including file's own.)
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

namespace sm90 {

// which tensor-map dimension (1..3) holds the sequence, head and batch axis
struct MapAxes {
  int s, h, b;
};

// ---------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// bring a tensor map's descriptor into the cache ahead of its first copy
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a box at column d0, sequence row `row`, head `head`, batch `b`
__device__ __forceinline__ void tma_load_rows(uint32_t dst, const CUtensorMap* map,
                                              MapAxes ax, uint32_t bar, int d0, int row,
                                              int head, int b) {
  auto at = [&](int dim) { return ax.s == dim ? row : ax.h == dim ? head : b; };
  tma_load(dst, map, bar, d0, at(1), at(2), at(3));
}

// `bytes` contiguous bytes into shared memory, completing on `bar`: both
// addresses 16-byte aligned, `bytes` a multiple of 16
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------- host side
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda.so.1, not in the runtime: take it
// from the copy PyTorch has already loaded, so the library links against the
// runtime only
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

constexpr int kErrNoEncoder = 1001;    // cuTensorMapEncodeTiled not found
constexpr int kErrMisaligned = 1002;   // base or a stride not a multiple of 16 bytes
constexpr int kErrEncode = 1100;       // + the CUresult of a failed encode

// A 4-d tensor map over a [B, heads, S, D] operand of bf16 (elem 2) or f32
// (elem 4) with element strides st = (b, head, seq) and a unit D stride:
// dimension 0 is D, dimensions 1..3 the other axes in ascending stride order
// (size-1 axes last), boxes of 128 bytes of columns x `rows` sequence rows,
// 128-byte swizzle, zero fill out of bounds.
inline int make_map(CUtensorMap* map, MapAxes* axes, const void* ptr, int elem, int B,
                    int heads, int S, int D, const long long* st, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return kErrMisaligned;
  struct Axis {
    long long stride;
    int size, which;  // which: 0 seq, 1 head, 2 batch
  } ax[3] = {{st[2], S, 0}, {st[1], heads, 1}, {st[0], B, 2}};
  auto before = [](const Axis& x, const Axis& y) {
    if ((x.size == 1) != (y.size == 1)) return y.size == 1;
    return x.stride < y.stride;
  };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && before(ax[j], ax[j - 1]); --j) {
      const Axis tmp = ax[j];
      ax[j] = ax[j - 1];
      ax[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / elem), 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  long long prev = static_cast<long long>(elem) * D;  // bytes spanned by the axes below
  for (int i = 0; i < 3; ++i) {
    long long bytes = elem * ax[i].stride;
    if (ax[i].size == 1) bytes = (prev + 15) / 16 * 16;  // never stepped over
    if (bytes % 16 != 0 || bytes <= 0) return kErrMisaligned;
    dims[i + 1] = static_cast<cuuint64_t>(ax[i].size);
    strides[i] = static_cast<cuuint64_t>(bytes);
    prev = bytes * ax[i].size;
    if (ax[i].which == 0) {
      box[i + 1] = static_cast<cuuint32_t>(rows);
      axes->s = i + 1;
    } else if (ax[i].which == 1) {
      axes->h = i + 1;
    } else {
      axes->b = i + 1;
    }
  }
  const CUtensorMapDataType type =
      elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUresult r = encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

}  // namespace sm90
