// Batched Whack-a-Mole path selection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `spray_select_pallas`
// (src/repro/kernels/spray_select.py).  For row r and lane i:
//
//   key  = shuffle(counter[r, i]; sa[r], sb[r], ell, method)   (uint32)
//   out  = #{k < n : c[r, k] <= key}                            (int32)
//
// which is the smallest path whose inclusive cumulative count exceeds the
// key.  Rows generalise the TPU kernel's single profile: one row per flow,
// each with its own cumulative profile and seed pair.
//
// Design: one thread per decision.  The row's cumulative profile is
// staged in dynamic shared memory sized from n; each thread reverses its
// counter with __brev and counts the staged entries <= key without a
// branch.  The grid is (ceil(B / 256), R); the ragged last block masks
// itself.  A profile longer than kStaged entries (48 KB) is walked in
// passes of kStaged by a second kernel, whose idle threads stay to stage
// each pass: the one-pass kernel keeps the main path's short profiles
// (16 paths) free of the pass loop, whose few instructions a block show in
// the time of a launch-latency-bound kernel.  There is no float arithmetic
// here (so nothing can contract into an FMA); everything is uint32 and
// wraps mod 2^32 as the reference does.
//
// What bounds it: per decision it reads 4 bytes of counter and writes 4
// bytes of path, plus n*4 bytes of profile per row, and makes n compares.
// At 131,072 decisions and n <= 128 a launch moves about 1 MB, which is
// well under a microsecond of HBM time, so a launch is bound by launch
// latency, not by bytes or operations.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStaged = 12288;  // profile entries staged per pass: 48 KB

__device__ __forceinline__ uint32_t theta(uint32_t j, uint32_t mask, int ell) {
  return __brev(j & mask) >> (32 - ell);
}

__device__ __forceinline__ int32_t spray_key(const uint32_t* __restrict__ counters,
                                             const uint32_t* __restrict__ seeds, int row,
                                             int B, int i, int ell, int method) {
  const uint32_t mask = ell >= 32 ? 0xFFFFFFFFu : ((1u << ell) - 1u);
  const uint32_t j = counters[static_cast<int64_t>(row) * B + i];
  const uint32_t sa = seeds[2 * row];
  const uint32_t sb = seeds[2 * row + 1];
  uint32_t key;
  switch (method) {
    case 0:  // PLAIN
      key = theta(j, mask, ell);
      break;
    case 1:  // SHUFFLE_1
      key = theta((sa + j * sb) & mask, mask, ell);
      break;
    case 2:  // SHUFFLE_2
      key = (sa + sb * theta(j, mask, ell)) & mask;
      break;
    default: {  // COMBINED
      const uint32_t sa2 = theta(sa, mask, ell);
      const uint32_t sb2 = ((sb * 0x9E37u) | 1u) & mask;
      key = (sa2 + sb2 * theta((sa + j * sb) & mask, mask, ell)) & mask;
    }
  }
  return static_cast<int32_t>(key);
}

// n <= kStaged: the whole profile in shared memory at once
__global__ void spray_select_kernel(const uint32_t* __restrict__ counters,
                                    const int32_t* __restrict__ c,
                                    const uint32_t* __restrict__ seeds,
                                    int32_t* __restrict__ out, int B, int n,
                                    int ell, int method) {
  extern __shared__ int32_t c_s[];  // n entries
  const int row = blockIdx.y;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    c_s[k] = c[static_cast<int64_t>(row) * n + k];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int32_t key = spray_key(counters, seeds, row, B, i, ell, method);
  int32_t count = 0;
  for (int k = 0; k < n; ++k) {
    count += static_cast<int32_t>(c_s[k] <= key);
  }
  out[static_cast<int64_t>(row) * B + i] = count;
}

// n > kStaged: the profile in passes of kStaged entries
__global__ void spray_select_passes_kernel(const uint32_t* __restrict__ counters,
                                           const int32_t* __restrict__ c,
                                           const uint32_t* __restrict__ seeds,
                                           int32_t* __restrict__ out, int B, int n,
                                           int ell, int method) {
  extern __shared__ int32_t c_s[];  // kStaged entries
  const int row = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < B;
  const int32_t key = live ? spray_key(counters, seeds, row, B, i, ell, method) : 0;
  int32_t count = 0;
  for (int k0 = 0; k0 < n; k0 += kStaged) {
    const int len = min(kStaged, n - k0);
    __syncthreads();  // the previous pass's readers are done
    for (int k = threadIdx.x; k < len; k += blockDim.x) {
      c_s[k] = c[static_cast<int64_t>(row) * n + k0 + k];
    }
    __syncthreads();
    if (live) {
      for (int k = 0; k < len; ++k) count += static_cast<int32_t>(c_s[k] <= key);
    }
  }
  if (live) out[static_cast<int64_t>(row) * B + i] = count;
}

}  // namespace

extern "C" int spray_select_launch(const void* counters, const void* c,
                                   const void* seeds, void* out, int rows,
                                   int B, int n, int ell, int method,
                                   void* stream) {
  if (rows < 1 || rows > 65535 || B < 1 || n < 1 || ell < 1 || ell > 31 || method < 0 ||
      method > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((B + kThreads - 1) / kThreads, rows);
  const bool one_pass = n <= kStaged;
  auto kernel = one_pass ? spray_select_kernel : spray_select_passes_kernel;
  const size_t smem = sizeof(int32_t) * static_cast<size_t>(one_pass ? n : kStaged);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(counters), static_cast<const int32_t*>(c),
      static_cast<const uint32_t*>(seeds), static_cast<int32_t*>(out), B, n,
      ell, method);
  return static_cast<int>(cudaGetLastError());
}
