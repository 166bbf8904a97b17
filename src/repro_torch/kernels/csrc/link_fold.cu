// Ordered per-link sums of the shared fabric for Hopper (sm_90a).
//
// No Pallas kernel stands behind this one: the reference computes the sum
// with an XLA scatter-add (`_link_sum`, src/repro/net/topology.py), whose
// order of additions the port reproduces (`kernels/link_fold.py`).  For
// link l, with the entries crossing it listed in ascending flattened
// (hop, flow, path) order idx_l0 < idx_l1 < ...:
//
//   out[l] = ((base[l] + vals[idx_l0]) + vals[idx_l1]) + ...
//
// every add a float32 add rounded to nearest (`__fadd_rn`, never fused),
// and then `+ 0.0f` once more when the link has fewer entries than the
// deepest link: the plain version pads each link's list with reads of a
// zero, and x + 0 differs from x only at x = -0.
//
// What bounds it: the deepest link's chain of dependent adds, not memory.
// The order is fixed, so a link's sum is one serial chain of float adds
// (4 cycles each); the fabric's deepest links hold 8,192 entries (a 4,096
// flow incast into one leaf) or 32,768 (intra-pod traffic on a fat-tree's
// bypass link), against a few hundred kilobytes of input.  The design
// keeps the chain fed: one warp a link; the warp's 32 lanes load a chunk
// of 256 entries (indices coalesced, values gathered) into shared memory,
// and lane 0 folds the chunk in order.  The values of the next chunk and
// the indices of the one after are loaded before lane 0 starts its fold,
// so the memory round trips hide behind the adds.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                // links a block
constexpr int kPerLane = 8;              // entries a lane loads a chunk
constexpr int kChunk = 32 * kPerLane;    // entries a chunk

__global__ void __launch_bounds__(32 * kWarps)
link_fold_kernel(const float* __restrict__ vals, const int32_t* __restrict__ offsets,
                 const int32_t* __restrict__ index, const float* __restrict__ base,
                 float* __restrict__ out, int links, int depth) {
  __shared__ float stage[kWarps][kChunk];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int link = blockIdx.x * kWarps + warp;
  if (link >= links) return;  // the whole warp leaves together
  const int lo = offsets[link];
  const int count = offsets[link + 1] - lo;
  const int chunks = (count + kChunk - 1) / kChunk;
  float* s = stage[warp];
  int ix[kPerLane];
  float v[kPerLane];

#define LOAD_INDICES(c)                                                   \
  _Pragma("unroll") for (int u = 0; u < kPerLane; ++u) {                  \
    const int k = (c) * kChunk + u * 32 + lane;                           \
    ix[u] = k < count ? __ldg(index + lo + k) : -1;                       \
  }
#define LOAD_VALUES()                                                     \
  _Pragma("unroll") for (int u = 0; u < kPerLane; ++u) {                  \
    v[u] = ix[u] >= 0 ? __ldg(vals + ix[u]) : 0.0f;                       \
  }

  LOAD_INDICES(0)
  LOAD_VALUES()
  LOAD_INDICES(1)
  float acc = base[link];
  for (int c = 0; c < chunks; ++c) {
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) s[u * 32 + lane] = v[u];
    __syncwarp();
    if (c + 1 < chunks) {  // in flight while lane 0 folds chunk c
      LOAD_VALUES()
      LOAD_INDICES(c + 2)
    }
    if (lane == 0) {
      const int n = min(kChunk, count - c * kChunk);
      if (n == kChunk) {
#pragma unroll 32
        for (int i = 0; i < kChunk; ++i) acc = __fadd_rn(acc, s[i]);
      } else {
        for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, s[i]);
      }
    }
    __syncwarp();  // the chunk is read before the next one overwrites it
  }
#undef LOAD_INDICES
#undef LOAD_VALUES
  if (lane == 0) {
    if (count < depth) acc = __fadd_rn(acc, 0.0f);
    out[link] = acc;
  }
}

}  // namespace

// vals float32[N], offsets int32[links + 1] (offsets[0] = 0, ascending,
// offsets[links] <= the index's length), index int32[offsets[links]] with
// every entry in [0, N), base float32[links], out float32[links], all
// contiguous; depth = the largest count offsets[l + 1] - offsets[l].
// Returns the CUDA error code (0 = ok).
extern "C" int link_fold_launch(const void* vals, const void* offsets, const void* index,
                                const void* base, void* out, int links, int depth,
                                void* stream) {
  if (links < 1 || depth < 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((links + kWarps - 1) / kWarps);
  link_fold_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(index), static_cast<const float*>(base),
      static_cast<float*>(out), links, depth);
  return static_cast<int>(cudaGetLastError());
}
