// Batched Whack-a-Mole path selection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `spray_select_pallas`
// (src/repro/kernels/spray_select.py).  For row r and lane i:
//
//   key  = shuffle(counter(r, i); sa[r], sb[r], ell, method)   (uint32)
//   out  = #{k < n : c[r, k] <= key}                            (int32)
//
// which is the smallest path whose inclusive cumulative count exceeds the
// key.  Rows generalise the TPU kernel's single profile: one row per flow,
// each with its own cumulative profile and seed pair.  The count stays a
// count (not a binary search): like the TPU kernel, it takes any c, sorted
// or not.
//
// The kernel reads its caller's tensors as they are, so that a call on the
// main path is one device operation: counters and seeds are int32 or int64
// (a dtype template; the low 32 bits are read), `sa` and `sb` are two
// strided [R] vectors (stride 0: one scalar for every row), and the
// counter is either read, `ctr[r * ctr_row + i * ctr_col]`, or formed from
// a row base, `(j[r] + i) mod 2^32` (lane_step 1, ctr_col 0), which is what
// the sender's WAM branch and `spray_paths` ask for.
//
// Design: one thread per decision, every launched thread live but those of
// the ragged last block.  The [R, B] decisions are flattened over a 1-D
// grid of 256-thread blocks, so a block covers 256 / B rows when B is small
// (the wide tick: 8 flows of 32 lanes, 512 blocks, one wave on 132 SMs) and
// part of one row when B is large (the router: 1 x 4,096, 16 blocks).  The
// profile is read in one of three instantiations, chosen at launch:
//   * n <= 32, n % 4 == 0 and 16-byte aligned rows (the wide tick's 16
//     paths): no shared memory and no barrier.  Each thread issues all
//     its row's int4 loads (the index clamped into the row rather than
//     guarded) before the key's arithmetic, so the decision waits for one
//     memory round trip; the lanes of a warp share one or two rows, so
//     each load is one address broadcast to the warp from L1.  Staging
//     through shared memory would add a store, a __syncthreads and a
//     second read to a kernel whose time is that round trip; a first
//     design with a guarded scalar load per entry ran slower.
//   * other profiles (the router's 64 replicas): the block's rows'
//     profiles (at most (B + 254) / B + 1 rows) are staged once in dynamic
//     shared memory, which the launch opts in to up to the card's limit
//     (232,448 bytes on an H100: 58,112 entries) with
//     cudaFuncSetAttribute; every thread then counts from its row's copy.
//     A 20,000-path profile runs in this one pass.
//   * only a block whose rows hold more entries than that runs the pass
//     instantiation, which stages each row in chunks; the other two
//     instantiations contain no pass loop.
// There is no float arithmetic (nothing can contract into an FMA); the key
// is uint32 and wraps mod 2^32 as the reference does.  No host
// synchronisation and no allocation: a launch can be captured in a CUDA
// graph.
//
// What bounds it: per decision it reads a counter (or, per row, a base)
// and writes 4 bytes, plus n * 4 bytes of profile per row, and makes n
// compares.  At the wide tick's 131,072 decisions that is about 1.3 MB:
// 0.0004 ms of HBM time, far under the time of one launch, so the kernel
// is bound by launch latency and one memory round trip.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDirect = 32;  // profiles this short are read from global memory

enum Mode { kRead = 0, kStaged = 1, kPasses = 2 };

struct Args {
  const void* ctr;  // counters [R, B] or row bases [R]
  long long ctr_row, ctr_col;
  unsigned lane_step;  // 1: counter = ctr[r] + i (mod 2^32); 0: counter = ctr[r, i]
  const int32_t* c;    // [R, n] with a unit column stride
  long long c_row;
  const void* sa;
  const void* sb;
  long long sa_row, sb_row;
  int32_t* out;  // [R, B], contiguous
  int R, B, n, ell, method;
  int chunk;  // kPasses: profile entries staged a pass
};

__device__ __forceinline__ uint32_t theta(uint32_t j, uint32_t mask, int ell) {
  return __brev(j & mask) >> (32 - ell);
}

template <typename T>
__device__ __forceinline__ uint32_t low32(const void* p, long long at) {
  return static_cast<uint32_t>(__ldg(static_cast<const T*>(p) + at));
}

template <typename CT, typename ST>
__device__ __forceinline__ int32_t spray_key(const Args& a, int r, int i) {
  const uint32_t mask = (1u << a.ell) - 1u;
  const uint32_t j = low32<CT>(a.ctr, r * a.ctr_row + i * a.ctr_col) + i * a.lane_step;
  const uint32_t sa = low32<ST>(a.sa, r * a.sa_row);
  const uint32_t sb = low32<ST>(a.sb, r * a.sb_row);
  uint32_t key;
  switch (a.method) {
    case 0:  // PLAIN
      key = theta(j, mask, a.ell);
      break;
    case 1:  // SHUFFLE_1
      key = theta((sa + j * sb) & mask, mask, a.ell);
      break;
    case 2:  // SHUFFLE_2
      key = (sa + sb * theta(j, mask, a.ell)) & mask;
      break;
    default: {  // COMBINED
      const uint32_t sa2 = theta(sa, mask, a.ell);
      const uint32_t sb2 = ((sb * 0x9E37u) | 1u) & mask;
      key = (sa2 + sb2 * theta((sa + j * sb) & mask, mask, a.ell)) & mask;
    }
  }
  return static_cast<int32_t>(key);
}

template <typename CT, typename ST, int M>
__global__ void __launch_bounds__(kThreads) spray_select_kernel(const __grid_constant__ Args a) {
  extern __shared__ int32_t c_s[];
  const unsigned total = static_cast<unsigned>(a.R) * static_cast<unsigned>(a.B);
  const unsigned t0 = blockIdx.x * kThreads;
  const unsigned t = t0 + threadIdx.x;
  const bool live = t < total;
  const int r = static_cast<int>(t / static_cast<unsigned>(a.B));
  const int i = static_cast<int>(t - static_cast<unsigned>(r) * a.B);
  if constexpr (M == kRead) {  // n <= 32, n % 4 == 0, 16-byte aligned rows
    if (!live) return;
    const int4* cr = reinterpret_cast<const int4*>(a.c + r * a.c_row);
    const int last = a.n / 4 - 1;
    int4 cv[kDirect / 4];
#pragma unroll
    for (int q = 0; q < kDirect / 4; ++q) cv[q] = __ldg(cr + min(q, last));  // no branch
    const int32_t key = spray_key<CT, ST>(a, r, i);
    int32_t count = 0;
#pragma unroll
    for (int q = 0; q < kDirect / 4; ++q) {
      const int32_t in = static_cast<int32_t>(q <= last);
      count += in * (static_cast<int32_t>(cv[q].x <= key) + static_cast<int32_t>(cv[q].y <= key) +
                     static_cast<int32_t>(cv[q].z <= key) + static_cast<int32_t>(cv[q].w <= key));
    }
    a.out[t] = count;
  } else {
    // the rows this block's decisions fall in
    const int r0 = static_cast<int>(t0 / static_cast<unsigned>(a.B));
    const int r1 = static_cast<int>((min(t0 + kThreads, total) - 1) / static_cast<unsigned>(a.B));
    const int32_t key = live ? spray_key<CT, ST>(a, r, i) : 0;
    int32_t count = 0;
    if constexpr (M == kStaged) {
      for (int rr = r0; rr <= r1; ++rr) {
        const int32_t* cr = a.c + rr * a.c_row;
        int32_t* dst = c_s + (rr - r0) * a.n;
        for (int k = threadIdx.x; k < a.n; k += kThreads) dst[k] = __ldg(cr + k);
      }
      __syncthreads();
      if (!live) return;
      const int32_t* cs = c_s + (r - r0) * a.n;
#pragma unroll 8
      for (int k = 0; k < a.n; ++k) count += static_cast<int32_t>(cs[k] <= key);
    } else {
      for (int rr = r0; rr <= r1; ++rr) {
        const int32_t* cr = a.c + rr * a.c_row;
        for (int k0 = 0; k0 < a.n; k0 += a.chunk) {
          const int len = min(a.chunk, a.n - k0);
          __syncthreads();  // the previous pass's readers are done
          for (int k = threadIdx.x; k < len; k += kThreads) c_s[k] = __ldg(cr + k0 + k);
          __syncthreads();
          if (live && r == rr) {
            for (int k = 0; k < len; ++k) count += static_cast<int32_t>(c_s[k] <= key);
          }
        }
      }
      if (!live) return;
    }
    a.out[t] = count;
  }
}

// the card's opt-in shared memory a block, read once a device
int smem_optin(int dev) {
  static int cached[64] = {};
  if (dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
      return 0;
    cached[dev] = v;
  }
  return cached[dev];
}

// lets kernel M of this instantiation take the card's opt-in shared memory
// (set once a device, so nothing but the launch happens in a graph capture)
template <typename CT, typename ST, int M>
cudaError_t allow_smem(int dev, int optin) {
  static int allowed[64] = {};
  if (allowed[dev] >= optin) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      spray_select_kernel<CT, ST, M>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) allowed[dev] = optin;
  return err;
}

template <typename CT, typename ST>
int launch(Args a, cudaStream_t stream) {
  const unsigned total = static_cast<unsigned>(a.R) * static_cast<unsigned>(a.B);
  const dim3 grid((total + kThreads - 1) / kThreads);
  if (a.n <= kDirect && a.n % 4 == 0 && a.c_row % 4 == 0 &&
      reinterpret_cast<uintptr_t>(a.c) % 16 == 0) {
    spray_select_kernel<CT, ST, kRead><<<grid, kThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int optin = smem_optin(dev);
  if (optin <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = min(static_cast<long long>(a.R), (a.B + 254LL) / a.B + 1);
  const long long staged = rows * a.n * static_cast<long long>(sizeof(int32_t));
  if (staged <= optin) {
    err = allow_smem<CT, ST, kStaged>(dev, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    spray_select_kernel<CT, ST, kStaged><<<grid, kThreads, staged, stream>>>(a);
  } else {
    err = allow_smem<CT, ST, kPasses>(dev, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    a.chunk = optin / static_cast<int>(sizeof(int32_t));
    spray_select_kernel<CT, ST, kPasses><<<grid, kThreads, optin, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ctr: counters [R, B] (lane_step 0) or row bases [R] (lane_step 1, ctr_col
// 0), int32 (ctr_i64 0) or int64; c: int32 [R, n], column stride 1; sa, sb:
// int32 (seeds_i64 0) or int64 with row strides (0: a scalar); out: int32
// [R, B], contiguous.  Strides are in elements.  Returns the CUDA error
// code (0 = ok).
extern "C" int spray_select_launch(const void* ctr, int ctr_i64, long long ctr_row,
                                   long long ctr_col, int lane_step, const void* c,
                                   long long c_row, const void* sa, const void* sb,
                                   int seeds_i64, long long sa_row, long long sb_row, void* out,
                                   int R, int B, int n, int ell, int method, void* stream) {
  if (R < 1 || B < 1 || n < 1 || ell < 1 || ell > 31 || method < 0 || method > 3 ||
      static_cast<long long>(R) * B > 0x7FFFFFFFLL || (lane_step != 0 && lane_step != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{ctr, ctr_row, ctr_col, static_cast<unsigned>(lane_step), static_cast<const int32_t*>(c),
         c_row, sa, sb, sa_row, sb_row, static_cast<int32_t*>(out), R, B, n, ell, method, 0};
  const auto s = static_cast<cudaStream_t>(stream);
  if (ctr_i64) {
    return seeds_i64 ? launch<long long, long long>(a, s) : launch<long long, int>(a, s);
  }
  return seeds_i64 ? launch<int, long long>(a, s) : launch<int, int>(a, s);
}
