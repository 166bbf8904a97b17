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
// wrapper hands them over as int32 tensors.  XOR is exact, so any order of
// slots and rows gives the same bits.
//
// The coded cell: K = 8,192 payload rows of P = 1,024 words (33.5 MB),
// R = 13,139 encoded rows (53.8 MB of output), dmax 32, 55,502 valid slots
// (mean degree 4.224: degrees 1 / 2 / 3 / 4 occur 85 / 6,733 / 2,241 /
// 1,082 times, with a tail to 32), so 227 MB of payload rows are gathered,
// 2.54x the 89.4 MB that the bound counts (each payload row used, the
// output and the index arrays, once).
//
// Two routes; the wrapper picks one (`kernels/lt_encode.py` `plan`):
//
// * vector (P % 4 == 0, payload and output 16-byte aligned: the coded
//   cell).  One block of 256 threads per (encoded row, tile of 256
//   16-byte vectors: a 4 KiB row is one block).  Warp 0 compacts the row's
//   valid slots into a list of normalised source rows in shared memory
//   (256 slots at a time, so any dmax works); then every thread gathers its
//   vector of the listed rows four at a time, all four loads issued before
//   the first XOR, so a row of degree <= 4 (77% of the coded cell's) waits
//   for one memory round trip.  The gathers carry an L2::evict_last policy
//   (createpolicy) so the payload stays in L2 for the rows that gather it
//   again; the output is stored with an L2::evict_first policy so it
//   streams past L2.  No persisting-L2 window or other device-wide setting
//   is touched.  The hardware's block scheduler balances rows of degree 1
//   to 32 over the SMs.
// * word (any other P or alignment).  The same block per (row, tile of 256
//   words), one 32-bit word a thread, one gather at a time.
//
// The vector route replaced a first design of a persistent block per SM
// that streamed 4 KiB chunks through a 48-stage shared-memory ring with 1-D
// bulk copies (cp.async.bulk, one producer thread, rows from an atomic
// counter): at the coded shape it ran slower than the parent's one gather
// at a time (PERF.md has the times).  Eight gathers in flight a thread
// took more registers, so fewer blocks shared an SM, and ran slower than
// four.
//
// What bounds it: bytes.  The K x P payload must come from device memory
// once and the R x P output go back once; rows gathered again can be
// served from the 50 MB L2.  The XORs (degree x P per row) are far below
// the card's integer rate.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;  // gathers a thread issues before it XORs them

__device__ __forceinline__ int norm_index(int idx, int K) {
  if (idx < 0) idx += K;  // idx < 0 and K > 0: no overflow
  return min(max(idx, 0), K - 1);
}

__device__ __forceinline__ uint64_t l2_policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint4 load_hinted(const uint4* p, uint64_t policy) {
  uint4 v;
  asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(reinterpret_cast<uint64_t>(p)), "l"(policy));
  return v;
}

__device__ __forceinline__ void store_hinted(uint4* p, const uint4& v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(
                   reinterpret_cast<uint64_t>(p)),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(policy)
               : "memory");
}

__device__ __forceinline__ void xor_into(uint4& acc, const uint4& v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

// warp 0 lists the normalised sources of slots [base, base + len) of row r
// that are valid; returns how many (every thread, after the barrier)
__device__ __forceinline__ int list_sources(int32_t* src_s, int* count_s,
                                            const int32_t* __restrict__ neighbors,
                                            const uint8_t* __restrict__ valid, int64_t r,
                                            int dmax, int base, int len, int K) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int cnt = 0;
    for (int g = 0; g < len; g += 32) {
      const int t = g + lane;
      int ok = 0, src = 0;
      if (t < len) {
        const int64_t slot = r * dmax + base + t;
        ok = valid[slot];
        src = norm_index(neighbors[slot], K);
      }
      const unsigned m = __ballot_sync(0xffffffffu, ok != 0);
      if (ok) src_s[cnt + __popc(m & ((1u << lane) - 1u))] = src;
      cnt += __popc(m);
    }
    if (lane == 0) *count_s = cnt;
  }
  __syncthreads();
  return *count_s;
}

// ---------------------------------------------------------------- vector route
// `width` is the row length in 16-byte vectors (P / 4)
__global__ void __launch_bounds__(kThreads)
lt_encode_vectors(const uint4* __restrict__ payload, const int32_t* __restrict__ neighbors,
                  const uint8_t* __restrict__ valid, uint4* __restrict__ out, int K,
                  int64_t width, int dmax) {
  __shared__ int32_t src_s[kThreads];
  __shared__ int count_s;
  const int64_t r = blockIdx.x;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  const bool live = col < width;
  const uint64_t keep = l2_policy_evict_last();
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (int base = 0; base < dmax; base += kThreads) {
    const int cnt = list_sources(src_s, &count_s, neighbors, valid, r, dmax, base,
                                 min(kThreads, dmax - base), K);
    if (live) {
      for (int t0 = 0; t0 < cnt; t0 += kInFlight) {
        uint4 v[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (t0 + u < cnt) v[u] = load_hinted(payload + src_s[t0 + u] * width + col, keep);
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (t0 + u < cnt) xor_into(acc, v[u]);
        }
      }
    }
    __syncthreads();  // the list is read before the next chunk overwrites it
  }
  if (live) store_hinted(out + r * width + col, acc, l2_policy_evict_first());
}

// ------------------------------------------------------------------ word route
__global__ void __launch_bounds__(kThreads)
lt_encode_words(const uint32_t* __restrict__ payload, const int32_t* __restrict__ neighbors,
                const uint8_t* __restrict__ valid, uint32_t* __restrict__ out, int K, int64_t P,
                int dmax) {
  __shared__ int32_t src_s[kThreads];
  __shared__ int count_s;
  const int64_t r = blockIdx.x;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
  const bool live = col < P;
  uint32_t acc = 0u;
  for (int base = 0; base < dmax; base += kThreads) {
    const int cnt = list_sources(src_s, &count_s, neighbors, valid, r, dmax, base,
                                 min(kThreads, dmax - base), K);
    if (live) {
      for (int t = 0; t < cnt; ++t) acc ^= payload[static_cast<int64_t>(src_s[t]) * P + col];
    }
    __syncthreads();
  }
  if (live) out[r * P + col] = acc;
}

}  // namespace

// payload int32[K, P], neighbors int32[R, dmax], valid uint8[R, dmax],
// out int32[R, P], all contiguous; route 1 (vector) needs P % 4 == 0 and a
// 16-byte aligned payload and output, route 0 (word) takes anything.
// Returns the CUDA error code (0 = ok).
extern "C" int lt_encode_launch(const void* payload, const void* neighbors, const void* valid,
                                void* out, int K, long long P, int R, int dmax, int route,
                                void* stream) {
  if (K < 1 || P < 1 || R < 1 || dmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto nb = static_cast<const int32_t*>(neighbors);
  const auto ok = static_cast<const uint8_t*>(valid);
  if (route == 1) {
    const bool aligned = reinterpret_cast<uintptr_t>(payload) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (P % 4 != 0 || !aligned) return static_cast<int>(cudaErrorInvalidValue);
    const long long tiles = (P / 4 + kThreads - 1) / kThreads;
    if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    lt_encode_vectors<<<dim3(R, static_cast<unsigned>(tiles)), kThreads, 0, s>>>(
        static_cast<const uint4*>(payload), nb, ok, static_cast<uint4*>(out), K, P / 4, dmax);
  } else if (route == 0) {
    const long long tiles = (P + kThreads - 1) / kThreads;
    if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    lt_encode_words<<<dim3(R, static_cast<unsigned>(tiles)), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(payload), nb, ok, static_cast<uint32_t*>(out), K, P, dmax);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
