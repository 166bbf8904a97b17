// GF(2) LT (fountain-code) encoding for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `lt_encode_pallas`
// (src/repro/kernels/lt_encode.py).  For encoded row r and word w:
//
//   out[r, w] = XOR_{t < dmax : valid[r, t]} payload[norm(neighbors[r, t]), w]
//
// with norm(i) = clamp(i < 0 ? i + K : i, 0, K - 1), the index rule of the
// reference's `payload[neighbors]` gather.  Invalid slots are never read.
// Words are uint32 bit patterns; XOR does not care about sign, so the
// wrapper hands them over as int32 tensors.
//
// Design: one block of 256 threads per (encoded row, tile of the row's
// words).  The block stages its row's neighbour indices, normalised, with
// -1 for an invalid slot, in shared memory (256 slots at a time, so any
// dmax works); every thread then walks the slots and XORs its own words of
// each valid source row into registers, and writes them once.  When P is a
// multiple of 4 and both buffers are 16-byte aligned a thread owns one
// 16-byte vector (a 4 KiB row is one block, one coalesced load per slot);
// otherwise it owns one 32-bit word.  Rows are independent, so the grid is
// (R, word tiles) and nothing is carried between blocks, unlike the TPU's
// sequential (8, 512) tiles.
//
// What bounds it: bytes.  Per encoded row it writes P words and reads
// dmax indices and mask bytes plus degree x P words of payload; the K x P
// payload is what must come from device memory once, and rows gathered
// again are served from the 50 MB L2 when the payload fits there.  The
// XORs (degree x P per row) are far below the card's integer rate.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void xor_into(uint4& acc, const uint4& v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

__device__ __forceinline__ void xor_into(uint32_t& acc, const uint32_t& v) { acc ^= v; }

template <typename V>
__device__ __forceinline__ V zero_value();

template <>
__device__ __forceinline__ uint4 zero_value<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

template <>
__device__ __forceinline__ uint32_t zero_value<uint32_t>() {
  return 0u;
}

// `width` is the row length in units of V (P / 4 for uint4, P for uint32).
template <typename V>
__global__ void lt_encode_kernel(const V* __restrict__ payload,
                                 const int32_t* __restrict__ neighbors,
                                 const uint8_t* __restrict__ valid,
                                 V* __restrict__ out, int K, int64_t width,
                                 int dmax) {
  __shared__ int32_t rows_s[kThreads];
  const int64_t r = blockIdx.x;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  const bool live = col < width;
  V acc = zero_value<V>();
  for (int base = 0; base < dmax; base += kThreads) {
    const int count = min(kThreads, dmax - base);
    if (threadIdx.x < count) {
      const int64_t slot = r * dmax + base + threadIdx.x;
      int32_t idx = neighbors[slot];
      if (idx < 0) idx += K;  // idx < 0 and K > 0: no overflow
      idx = min(max(idx, 0), K - 1);
      rows_s[threadIdx.x] = valid[slot] ? idx : -1;
    }
    __syncthreads();
    if (live) {
      for (int t = 0; t < count; ++t) {
        const int32_t src = rows_s[t];  // the same slot for the whole block
        if (src >= 0) xor_into(acc, payload[static_cast<int64_t>(src) * width + col]);
      }
    }
    __syncthreads();
  }
  if (live) out[r * width + col] = acc;
}

template <typename V>
int launch(const void* payload, const void* neighbors, const void* valid, void* out,
           int K, int64_t width, int R, int dmax, cudaStream_t stream) {
  const int64_t tiles = (width + kThreads - 1) / kThreads;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(R), static_cast<unsigned>(tiles));
  lt_encode_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(payload), static_cast<const int32_t*>(neighbors),
      static_cast<const uint8_t*>(valid), static_cast<V*>(out), K, width, dmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// payload int32[K, P], neighbors int32[R, dmax], valid uint8[R, dmax],
// out int32[R, P], all contiguous.  Returns the CUDA error code (0 = ok).
extern "C" int lt_encode_launch(const void* payload, const void* neighbors,
                                const void* valid, void* out, int K, long long P,
                                int R, int dmax, void* stream) {
  if (K < 1 || P < 1 || R < 1 || dmax < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(payload) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (P % 4 == 0 && aligned) {
    return launch<uint4>(payload, neighbors, valid, out, K, P / 4, R, dmax, s);
  }
  return launch<uint32_t>(payload, neighbors, valid, out, K, P, R, dmax, s);
}
