// Single-token GQA flash decode over a KV cache for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_decode_pallas`
// (src/repro/kernels/flash_decode.py).  For batch b and query head h (kv
// head h / group), over cache slots j < kv_len[b]:
//
//   s(j) = (scale * q[b, h]) . k[b, j, h / group]
//   m    = max_j s(j)            (-1e30 when no slot is valid)
//   l    = sum_j exp(s(j) - m)
//   o    = sum_j exp(s(j) - m) v[b, j, h / group]      (un-normalised)
//
// all in f32, whatever the cache's type (f32 or bf16): the TPU kernel's
// partials, which the caller normalises or merges across shards.
//
// Design (simple first): the cache is split along its slots into
// `nsplit` ranges of `split_len` slots so that a decode batch, which has
// only B * KVH (b, kv head) pairs (32 at B 4, KVH 8), still fills the
// card's 132 SMs.  One block of 128 threads per (range, b, kv head) handles
// the `group` query heads of its kv head together: their scaled queries
// stay in shared memory, and each 64-slot tile of K and V is staged there
// as f32; the block scores every (head, slot) pair, updates each head's
// running (m, l) with one warp per head, and accumulates its heads'
// output columns in registers.  Slots past kv_len are masked as in the TPU
// kernel, and ranges that hold none leave (-1e30, 0, 0).  With one range
// the block writes (o, m, l) directly; otherwise a second kernel merges
// the ranges' partials into the single (o, m, l) over the whole cache with
// the algebra of `lse_combine`: m = max m_r, l = sum l_r exp(m_r - m),
// o = sum o_r exp(m_r - m).
//
// What bounds it on the card: bytes.  The cache (2 * B * Sk * KVH * D
// elements) is read once; the flops, 4 * B * H * Sk * D, are about one per
// byte of bf16 cache.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBK = 64;        // cache slots per tile
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

struct CacheStrides {
  long long b, s, h;  // element strides of a [B, Sk, KVH, D] cache; the D stride is 1
};

// NO * kThreads >= group * D output columns per block
template <typename T, int NO>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int32_t* __restrict__ kv_len,
                    float* __restrict__ o, float* __restrict__ m, float* __restrict__ l,
                    CacheStrides ks, CacheStrides vs, int B, int H, int KVH, int Sk, int D,
                    float scale, int split_len) {
  extern __shared__ float smem[];
  const int group = H / KVH;
  const int ld = D + 1;
  float* q_s = smem;                // [group][D], already scaled
  float* k_s = q_s + group * D;     // [kBK][ld]
  float* v_s = k_s + kBK * ld;      // [kBK][D]
  float* p_s = v_s + kBK * D;       // [group][kBK]
  float* m_s = p_s + group * kBK;   // [group] running max
  float* l_s = m_s + group;         // [group] running sum
  float* a_s = l_s + group;         // [group] this tile's rescale

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y / KVH;
  const int kvh = blockIdx.y - b * KVH;
  const int split = blockIdx.x;
  const int len = min(kv_len[b], Sk);
  const int s_begin = split * split_len;
  const int s_end = min(s_begin + split_len, len);
  const int GD = group * D;

  const T* qb = q + (static_cast<long long>(b) * H + kvh * group) * D;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  for (int e = tid; e < GD; e += kThreads) q_s[e] = to_float(qb[e]) * scale;
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kMasked;
    l_s[g] = 0.f;
  }

  float acc[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j] = 0.f;

  for (int t0 = s_begin; t0 < s_end; t0 += kBK) {
    __syncthreads();  // q_s / m_s written, or the previous tile's readers done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D;
      const int d = e - r * D;
      const int slot = t0 + r;
      const bool live = slot < s_end;
      k_s[r * ld + d] = live ? to_float(kb[slot * ks.s + d]) : 0.f;
      v_s[r * D + d] = live ? to_float(vb[slot * vs.s + d]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < group * kBK; e += kThreads) {
      const int g = e / kBK;
      const int r = e - g * kBK;
      const float* qg = q_s + g * D;
      const float* kr = k_s + r * ld;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kr[d], dot);
      p_s[e] = t0 + r < s_end ? dot : kMasked;
    }
    __syncthreads();
    for (int g = warp; g < group; g += kWarps) {
      float* pg = p_s + g * kBK;
      float mx = kMasked;
      for (int r = lane; r < kBK; r += 32) mx = fmaxf(mx, pg[r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < kBK; r += 32) {
        const float p = t0 + r < s_end ? expf(pg[r] - m_new) : 0.f;
        pg[r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int idx = tid + j * kThreads;
      if (idx < GD) {
        const int g = idx / D;
        const int d = idx - g * D;
        const float* pg = p_s + g * kBK;
        float a = acc[j] * a_s[g];
#pragma unroll 8
        for (int r = 0; r < kBK; ++r) a = fmaf(pg[r], v_s[r * D + d], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();  // m_s / l_s final

  const long long row0 = (static_cast<long long>(split) * B + b) * H + kvh * group;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int idx = tid + j * kThreads;
    if (idx < GD) o[row0 * D + idx] = acc[j];
  }
  for (int g = tid; g < group; g += kThreads) {
    m[row0 + g] = m_s[g];
    l[row0 + g] = l_s[g];
  }
}

// one block per (b, h) row: merge nsplit partials [nsplit][rows][...]
__global__ void combine_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
                               const float* __restrict__ l_part, float* __restrict__ o,
                               float* __restrict__ m, float* __restrict__ l, int rows, int D,
                               int nsplit) {
  const int row = blockIdx.x;
  float mx = kMasked;
  for (int r = 0; r < nsplit; ++r) mx = fmaxf(mx, m_part[static_cast<long long>(r) * rows + row]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < nsplit; ++r) {
      const long long pr = static_cast<long long>(r) * rows + row;
      acc = fmaf(o_part[pr * D + d], expf(m_part[pr] - mx), acc);
    }
    o[static_cast<long long>(row) * D + d] = acc;
  }
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int r = 0; r < nsplit; ++r) {
      const long long pr = static_cast<long long>(r) * rows + row;
      sum = fmaf(l_part[pr], expf(m_part[pr] - mx), sum);
    }
    m[row] = mx;
    l[row] = sum;
  }
}

size_t smem_bytes(int group, int D) {
  return sizeof(float) * (static_cast<size_t>(group) * D + static_cast<size_t>(kBK) * (D + 1) +
                          static_cast<size_t>(kBK) * D + static_cast<size_t>(group) * kBK +
                          3 * static_cast<size_t>(group));
}

template <typename T, int NO>
int launch(const void* q, const void* k, const void* v, const void* kv_len, float* o, float* m,
           float* l, const long long* st, int B, int H, int KVH, int Sk, int D, float scale,
           int nsplit, int split_len, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KVH, D);
  auto kernel = flash_decode_kernel<T, NO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const CacheStrides ks{st[0], st[1], st[2]}, vs{st[3], st[4], st[5]};
  dim3 grid(static_cast<unsigned>(nsplit), static_cast<unsigned>(B * KVH));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(kv_len), o, m, l, ks, vs, B, H, KVH, Sk, D, scale, split_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* kv_len, float* o,
             float* m, float* l, const long long* st, int B, int H, int KVH, int Sk, int D,
             float scale, int nsplit, int split_len, cudaStream_t s) {
  const int gd = (H / KVH) * D;
  if (gd <= 2 * kThreads)
    return launch<T, 2>(q, k, v, kv_len, o, m, l, st, B, H, KVH, Sk, D, scale, nsplit, split_len, s);
  if (gd <= 8 * kThreads)
    return launch<T, 8>(q, k, v, kv_len, o, m, l, st, B, H, KVH, Sk, D, scale, nsplit, split_len, s);
  return launch<T, 32>(q, k, v, kv_len, o, m, l, st, B, H, KVH, Sk, D, scale, nsplit, split_len, s);
}

}  // namespace

// q [B, H, D] contiguous; k and v [B, Sk, KVH, D] with element strides
// (b, slot, head) in `strides` (k then v: 6 values, host memory) and a unit
// D stride; f32 (dtype 0) or bf16 (dtype 1).  kv_len int32[B].  Outputs
// o f32[B, H, D], m and l f32[B, H], contiguous.  With nsplit > 1, `work`
// holds nsplit * B * H * (D + 2) floats of partials.  Returns the CUDA
// error code (0 = ok).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* kv_len, void* o, void* m, void* l, void* work,
                                   int dtype, int B, int H, int KVH, int Sk, int D,
                                   const long long* strides, float scale, int nsplit,
                                   int split_len, void* stream) {
  const int group = KVH > 0 ? H / KVH : 0;
  if (B < 1 || H < 1 || KVH < 1 || H % KVH != 0 || group > 16 || Sk < 1 || D < 1 || D > 256 ||
      nsplit < 1 || split_len < 1 || B * KVH > 65535 ||
      static_cast<long long>(nsplit) * split_len < Sk || (nsplit > 1 && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  float* o_out = static_cast<float*>(o);
  float* m_out = static_cast<float*>(m);
  float* l_out = static_cast<float*>(l);
  const long long rows = static_cast<long long>(B) * H;
  if (nsplit > 1) {  // partials first, merged below
    o_out = static_cast<float*>(work);
    m_out = o_out + nsplit * rows * D;
    l_out = m_out + nsplit * rows;
  }
  int err;
  if (dtype == 0) {
    err = dispatch<float>(q, k, v, kv_len, o_out, m_out, l_out, strides, B, H, KVH, Sk, D, scale,
                          nsplit, split_len, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(q, k, v, kv_len, o_out, m_out, l_out, strides, B, H, KVH, Sk, D,
                                  scale, nsplit, split_len, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0 || nsplit == 1) return err;
  combine_kernel<<<static_cast<unsigned>(rows), kThreads, 0, s>>>(
      o_out, m_out, l_out, static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l),
      static_cast<int>(rows), D, nsplit);
  return static_cast<int>(cudaGetLastError());
}
