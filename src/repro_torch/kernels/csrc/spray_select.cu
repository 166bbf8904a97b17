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
// Design: one thread per decision.  The row's cumulative profile (n <= 128
// int32) is staged in shared memory once per block; each thread reverses
// its counter with __brev and counts the profile entries <= key without a
// branch.  The grid is (ceil(B / 256), R); the ragged last block masks
// itself.  There is no float arithmetic here (so nothing can contract into
// an FMA); everything is uint32 and wraps mod 2^32 as the reference does.
//
// What bounds it: per decision it reads 4 bytes of counter and writes 4
// bytes of path, plus n*4 bytes of profile per row.  At 131,072 decisions a
// launch moves about 1 MB, which is well under a microsecond of HBM time,
// so a launch is bound by launch latency, not by bytes or operations.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPaths = 128;

__device__ __forceinline__ uint32_t theta(uint32_t j, uint32_t mask, int ell) {
  return __brev(j & mask) >> (32 - ell);
}

__global__ void spray_select_kernel(const uint32_t* __restrict__ counters,
                                    const int32_t* __restrict__ c,
                                    const uint32_t* __restrict__ seeds,
                                    int32_t* __restrict__ out, int B, int n,
                                    int ell, int method) {
  __shared__ int32_t c_s[kMaxPaths];
  const int row = blockIdx.y;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    c_s[k] = c[static_cast<int64_t>(row) * n + k];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;

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
  const int32_t key_i = static_cast<int32_t>(key);
  int32_t count = 0;
  for (int k = 0; k < n; ++k) {
    count += static_cast<int32_t>(c_s[k] <= key_i);
  }
  out[static_cast<int64_t>(row) * B + i] = count;
}

}  // namespace

extern "C" int spray_select_launch(const void* counters, const void* c,
                                   const void* seeds, void* out, int rows,
                                   int B, int n, int ell, int method,
                                   void* stream) {
  if (rows < 1 || rows > 65535 || B < 1 || n < 1 || n > kMaxPaths || ell < 1 || ell > 31 ||
      method < 0 || method > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((B + kThreads - 1) / kThreads, rows);
  spray_select_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(counters), static_cast<const int32_t*>(c),
      static_cast<const uint32_t*>(seeds), static_cast<int32_t*>(out), B, n,
      ell, method);
  return static_cast<int>(cudaGetLastError());
}
